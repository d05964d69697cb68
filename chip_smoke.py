#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``mixstage_tpu_torch``) on one CUDA card.

Drives the port's two main paths end to end at the full width of the
flagship model — ``JointLateClusterSoftStyle4_G`` with 8 clusters, 8
speakers, 256 channels, style_dim 10 and 96 pose features, on 64-frame
clips of 128 mel bins at batch 32 — with random weights drawn from
``--seed``: serving (phases 1-6), GAN training (phases 7-9) and the int8
serving tier with the streaming and waveform endpoints (phases 10-14), the
bf16 tier, serving and GAN training (phases 15-17), the int8 tier on the
bf16 model (phases 18-19), the host lifecycle through the CLIs
(phase 20), the serving entry points on its checkpoints (phase 21), the
rest of the train steps (phase 22), text input, ``-optim_separate``
and the Disentangle losses (phase 23), the parallel layouts (phase
24), the two ends of the lifecycle (phase 25: rendering, JAX
checkpoints, data preparation), the long tail (phase 26: orbax
checkpoints, the C++ window gatherer, the other layers, centered RMSprop,
text preprocessing) and BERT (phase 27: ``bert`` and ``tokens``
preprocessing on the card, a K3-trained ``text/bert`` lifecycle,
``-audio_lowering``, ``-fused_decoder`` without the mixture decoder):

1. device: the card's name and power limit from ``nvidia-smi``;
2. build: every CUDA kernel from the checkout's sources, one ``nvcc`` per
   source, all started together;
3. kernels: K1's f32 mode (``wgmma``: six bf16 products of three-term
   bf16 splits of both operands) against its plain PyTorch version on the
   card, on weights packed once as the serving function packs them, at
   every shape the main path launches it at (bs32 and one clip of 64
   frames, the server's 128-frame bucket) and at T=4096 (max |err| / max
   |ref| ≤ 1e-4); the registers and spills of its f32-mode instances and
   ptxas's advisories on them;
4. model: one serving call launches K1's f32 mode exactly twice, on
   weights packed when the serving function was built (no call packs
   them), and its pose stays within 1% (mean |diff| / mean |pose|) of the
   plain path and of the unfolded eval forward;
5. server: concurrent JSON and npz ``/v1/pose`` requests through the HTTP
   micro-batcher, ``/healthz`` (backend cuda) and ``/stats``;
6. timings: p50 latency of one 64-frame clip, bs32 frames/s, each K1 shape
   and its plain version (CUDA events), with the card's name and power
   limit beside them;
7. training kernels: the registers, spills and ptxas advisories of K3's
   f32-mode GEMM instances (``wgmma``: six bf16 products of three-term
   bf16 splits of both operands); K3-fwd (out, cs, mu, var at max |err| /
   max |ref| ≤ 1e-4) and K3-bwd (every gradient at relative Frobenius
   error ≤ 1e-4; dcb, 0 analytically, below 1e-4·max |dbeta|) against
   their plain versions at bs32 × 64 and at a ragged B=3, T=50;
8. training steps through ``StepFactory``: one fused G step (K3 launched
   exactly once each way) against the unfused one from the same state
   (total loss rtol 1e-4, params atol 2·lr, BN statistics 1e-4 of each
   leaf's scale, G's Adam mu — its gradients — per module at relative
   Frobenius ``MOMENT_TOL``, logged beside the gap of the 3xTF32 route
   K3 ran before, ``MU_GAP_TF32X3``), a D step, and
   ``make_scan_train_step(8)``
   with seeded coins (finite losses, K3 launched once each way per G
   step);
9. training timings (CUDA events): G step, D step and the k-step driver's
   mean step, fused and unfused in four ABBA turns each; train pose
   frames/s; K3-fwd and K3-bwd (six bf16 products on ``wgmma``) against
   their bounds and plain versions;
10. int8 and chain kernels: the registers, spills and ptxas advisories of
    K4's seven ``wgmma`` s8 instances; K4 against ``decoder_int8_plain`` at
    every shape the int8 path launches it at (bs32 × 64, one 64-frame clip,
    the bs32 128-frame bucket) and at B=1 T=4096 and a ragged B=3 T=50,
    with weights quantized from seeded folded weights (no element differs:
    K4's integer MMA sums are exact and it rounds as its plain version
    does); K2 (the chain mode of K1's ``wgmma`` kernel, six bf16 products
    of three-term splits, on weights packed once by ``pack_chain_bf16``)
    against ``chain_plain`` at every K2 shape (max |err| / max |ref| ≤
    1e-4), and the registers, spills and ptxas advisories of its f32-mode
    instances;
11. int8 serving: ``build_serving_fn(model, quantize_int8=True, calib=...)``
    at bs32 launches K1 once and K4 once, its pose is finite, drifts from
    the f32 kernel route by (1e-4, 0.10), and is within K4's envelope of
    the plain int8 route;
12. int8 server: ``/v1/pose`` requests through an int8 server equal the
    direct call at the server's batch size element for element, and so does
    a streaming session over HTTP against ``StreamingSession`` over the
    direct serving function;
13. waveform: the on-card log-mel frontend against the numpy
    ``log_mel_400`` (max |diff| ≤ 1e-3), and a ``/v1/pose_from_waveform``
    request on a full-width 64-mel generator against the direct call
    (max |diff| / mean |pose| ≤ 1e-5);
14. timings (CUDA events): K4 and K2 beside their bounds and plain
    versions, K2 with weights packed once and packed per call; the bs32
    int8 call against the f32 one in ABBA turns;
15. bf16 kernels: K1's bf16 mode (bf16 features, f32 weights split in
    three bf16 terms, ``wgmma``) at every K1 shape, under the bf16 rule
    (below), within one bf16 ULP of max |plain| and with at most 20% of
    its elements differing from its plain version (45% for the seven
    rounded layers of the classifier chain, ``k1_bf16_share``); K3-fwd
    and K3-bwd's bf16 mode (``wgmma`` GEMM passes) at bs32 × 64 and the
    ragged B=3 T=50 under the bf16 rule, out and cs also within one bf16
    ULP of max |plain| and ``K3_BF16_SHARE`` of their elements differing;
    the registers and spills of K3's bf16 GEMM instances and ptxas's
    advisories on them;
16. bf16 entry points: a bf16 serving call at bs32 launches K1's bf16 mode
    exactly twice on weights packed when the serving function was built
    (no packing per call) and drifts ≤ 1% from the f32 kernel route; bf16
    ``/v1/pose`` requests through the HTTP server equal the direct call at
    the server's batch size; a fused bf16 G step (K3's bf16 mode launched
    once each way) and the unfused bf16 G step from the same state, each
    against the f32 G step under the bf16 rule (pose, total loss, G's Adam
    mu per module); a bf16 D step and ``make_scan_train_step(8)`` with
    seeded coins, finite;
17. bf16 timings (CUDA events, ABBA turns against f32): the bs32 serving
    call, the clip p50, the G, D and k-step driver's step, and each
    bf16-mode kernel beside its bound and plain version;
18. K4's bf16-feature mode against ``decoder_int8_plain`` on the same bf16
    features at every K4 shape (no element differs: a bf16 feature widens
    to f32 exactly), K2's bf16 mode (three exact bf16 products on
    ``wgmma``) against ``chain_plain``'s at every K2 shape under the bf16
    rule, within one bf16 ULP of max |plain| and with at most 20% of its
    elements differing; each timed beside its bound and plain version (K2
    with weights packed once and per call), K4-bf16 against K4's f32 mode
    in ABBA turns;
19. the int8 tier on the bf16 model: one bs32 call of
    ``build_serving_fn(model16, quantize_int8=True, calib=...)`` launches
    K1's bf16 mode once and K4's bf16 mode once, drifts from the f32
    kernel route by (1e-4, 0.10), and its kernel and plain routes drift
    alike (the bf16 rule); ``/v1/pose`` requests and a 150-frame stream
    through a server over it equal the direct calls at the server's batch
    size; the call timed against the int8 call on the f32 model in ABBA
    turns, with its device busy time, launches and idle share
    (``torch.profiler``);
20. the lifecycle, in f32 and then bf16: synthetic PATS data (8 speakers,
    3 intervals of 25 s each), ``cli.train``'s ``main(argv)`` (the flagship
    at full width, ``-gan 1 -loss L1Loss -batch_size 32 -fused_decoder 1``,
    two short epochs, ``-profile_dir``) then ``cli.sample`` from its
    checkpoint with style transfer; K3 launched once each way per G step
    and nowhere else, in the run's mode, its ``wgmma_gemm_kernel`` and
    ``pack_kernel`` in the first epoch's ``torch.profiler`` trace; finite
    losses in ``PREFIX_res.json``, every ``PREFIX_*`` file, a
    ``keypoints_style`` file per interval, the weights ``cli.sample``
    restored equal to the trained ones bit for bit, one sampled interval's
    keypoints equal to a direct eval step on its batch; the trainer's
    steps per second and the train and sample wall times.  Where the
    machine has no ``h5py`` the phase says so and its h5 files go through a
    stand-in (numpy archives behind h5py's ``File`` API);
21. the serving entry points on phase 20's f32 and bf16 checkpoints and
    data (the same stand-in h5py): ``cli.serve``'s ``build`` on ``-load``
    of each, plain and with ``-serve_int8 1`` (8 pooled calibration
    windows), each answering a JSON and an npz ``/v1/pose`` request and a
    150-frame stream over HTTP equal to ``build_serving_fn`` on the
    restored model called at the server's batch (within 1e-6 of max
    |pose|; int8 bit for bit), with the kernels' counters set to 0 just
    before the requests and read just after: K1 twice a batch (f32), K1's
    bf16 mode twice (bf16), K1 once and K4 once (int8), K1-bf16 once and
    K4-bf16 once (int8 on the bf16 model); the int8 tiers' drift from f32
    serving within ``INT8_DRIFT``; the f32 checkpoint read as a
    ``log_mel_400`` model (a 64-mel stream appended to the data) for one
    ``/v1/pose_from_waveform`` request against the direct waveform call;
    ``cli.export`` of the f32 checkpoint with both variants, whose
    ``kernel`` program ``load_serving`` picks on the card (within 1e-5
    relative Frobenius of the direct K1 call, K1 twice) and whose ``plain``
    program, moved to the card, stays within 1e-6 of the plain route (K1
    not launched); ``cli.serve -export_dir`` with no checkpoint and ``h5py``
    blocked, its responses equal to the kernel program's; timings: the p50
    of a 64-frame clip over HTTP in each mode and the bs32 calls of both
    programs against the direct functions in ABBA turns;
22. the rest of the train steps, through ``StepFactory`` at full width
    with seeded ``rng``s: (a) the weighted GAN with the joint D (2-class
    D on velocity ⊕ the 128 mels), f32: a fused G step (K3 once each way)
    against the unfused one from one state by phase 9's contract, ``W``
    of shape (32,) in [0.1, 10] and equal in both, a D step (no K3);
    (b) the same in bf16, fused against unfused by the bf16 rule, each
    against (a)'s f32 step; (c) the non-GAN Mix-StAGE step, fused against
    unfused by phase 9's contract, and ``make_scan_train_step(8)``
    without a GAN against 8 per-step calls at lr 1e-6 (totals within
    1e-3, params within 8 × 2·lr); (d) one fused G step each under AdamW, SGD
    (momentum 0.9), RMSprop and Adam with a bf16 ``mu``, and each
    optimizer's update on given gradients (global norm below the clip's
    1) on the card against the same update on the CPU (max |diff| / max
    |ref| ≤ 1e-6; the bf16 ``mu`` bit for bit); (e) pose noise 0.01 and dropout 0.1, unfused: a mask's
    kept share within 5 binomial sigma of 0.9 and its kept elements x /
    (1 - p) exactly, one seed twice within 1e-6 and another seed apart,
    ``-fused_decoder`` refused with p > 0 and at float64; (f)
    ``Speech2Gesture_G`` G and D steps finite, ``StyleClassifier_G``'s
    loss falling over 20 steps on one batch; timings (CUDA events, ABBA):
    the weighted + joint fused G step against the plain fused G step,
    the non-GAN step, each optimizer's G step; (g) the lifecycle on
    synthetic data through the same stand-in h5py: ``cli.train -model
    StyleClassifier_G -speaker ["all"]``, then ``-gan 1 -weighted 3 -joint
    1 -noise 0.01 -optim AdamW -fused_decoder 1 -pretrained_model_weights
    <its checkpoint>`` (the style IS in ``PREFIX_res.json``), ``-gan 0
    -fused_decoder 1`` and ``cli.sample`` on it.  K3 launched once each
    way per fused G or non-GAN step, counted over the phase
    (``steps_rest_launches``);
23. text and the rest of ROADMAP item 4, through ``StepFactory`` and the
    CLIs at full width: (a) audio + ``text/w2v`` (300 channels through
    the text encoder, fused with the audio by ``concat_encoder``): a fused
    G step against the unfused one from one state by phase 9's contract,
    the bf16 fused and unfused G steps by the bf16 rule against the f32
    step, a D step of the joint D on 96 + 128 + 300 = 524 channels; (b) a
    ``text/bert``-width stream (768): a fused G step, finite; (c)
    ``-optim_separate`` 1e-5 at lr 1e-4: after one fused G step the text
    encoder moved by at most 1e-5 and the rest by at most 1e-4 (each more
    than half of it), and the card's update on given gradients (global
    norm below the clip's 1) against the CPU's within 1e-6, each group
    with its own count; (d) a Disentangle generator registered here (the
    Mix-StAGE generator emitting the 11 internal losses, weighted by the
    ``style_losses`` it gets): fused and unfused G steps and a D step,
    each total equal to the sum of its named losses (the fused step runs
    the backbone, which emits none, as in the JAX package), the D step
    leaving G as it was, ``make_scan_train_step(4)`` carrying the 11 extra
    keys; timings (CUDA events, ABBA): the text fused G step against the
    audio-only one, and each one's device busy time, launches and idle
    share (``torch.profiler``); (e) the lifecycle on synthetic PATS with ``text/w2v``,
    a ``text/meta`` word table and a seeded ``text/pos`` stream (the same
    stand-in h5py): ``cli.train -modalities [pose, audio, text/w2v]
    -optim_separate 1e-5 -fused_decoder 1``, a ``-pos 1`` run whose labels
    are the ``text/pos`` classes, and ``cli.sample`` on the first.  K3
    launched once each way per fused G step, counted over the phase
    (``text_launches``);
24. the parallel layouts: (a) K3 at a data rank's bs16 and at 4, 2 and 1
    groups against its plain versions, K3-fwd with a one-rank exchange
    hook bit for bit with K3-fwd without one, and a fused G step through
    the world-1 layout launching K3 once each way; (b) two ranks, child
    processes of this script (``--child parallel``, each with a timeout),
    sharing the one card over gloo (NCCL takes one rank a device), which
    collectives gloo runs on CUDA tensors, then data parallel at bs32 × 64
    (16 rows a rank, BatchNorm's and K3's statistics over both): the fused
    f32 G step and, from the same start, the D step against the one-rank
    steps (losses rtol 1e-4, params 2·lr, BN statistics 1e-4 of scale,
    Adam mu ``MOMENT_TOL_DP``), the unfused float64 G step (Adam mu
    ``F64_MU_TOL``), the fused bf16 G step (pose and mu by the bf16 rule,
    the total within one bf16 ULP); (c) a 1 × 2 data × expert fused G step
    (K3 at 4 groups a rank) against the one-rank step; K3 launched once
    each way a G step on each rank (``parallel_launches_per_rank``); (d)
    serving on ``["cuda:0"] * 2`` at bs32 × 64: batch (K1) and int8 batch
    (K1 + K4) bit for bit with the one-device call on each device's rows,
    batch and expert (K1 at 4 groups a device) within 1e-4 and int8 within
    the int8 route's mean of one whole-batch call, time at B=1 T=4096 over
    2 shards within 1e-4; K1 and K4 launches per device
    (``parallel_launches_per_device``); (e) a rank's DP G step time beside
    one rank's and the serving calls' (two processes sharing one card: no
    scaling measurement);
25. the two ends of the lifecycle at full width: (a) the skeleton
    rasteriser (host C++, built by g++ at first use) on 64 frames of 52
    joints, prediction beside ground truth (480 x 960), equal to its numpy
    plain version frame for frame, each one's ms a frame on the host CPU
    (named), its GIF decoding (PIL, else the port's reader) to the
    palette's frames, captions and an MJPEG + PCM AVI where PIL exists;
    (b) ``cli.train -fused_decoder 1 -render 1`` (8 speakers x 3 synthetic
    intervals of 8 s): K3 once each way a G step, 10 GIFs and
    ``videos.html``, one interval re-rasterised equal to its plain version
    and to its GIF; (c) ``cli.render -load`` of it with a render list:
    prediction beside ground truth and the ``render_eval*`` pass, nothing
    new with ``-clean_render 0``; (d) a flax-msgpack ``PREFIX_weights.p``
    of its weights (``to_flax_state`` and the port's ``packb``) restoring
    them bit for bit, ``cli.serve -load`` of it in f32 (K1 twice a batch)
    and ``-serve_int8 1`` (K1 and K4 once) answering bit for bit with the
    direct call, ``cli.sample -load`` of it writing (b)'s keypoints bit for
    bit; (e) ``cli.preprocess`` (pose data, normalize, the OpenPose-YAML
    confidence branch; audio only where ``soundfile`` exists) on a raw
    tree and ``cli.delete_keys``; each sub-phase's seconds and the
    phase's.
26. the long tail: (a) the C++ window gatherer built by g++ and its
    ZNorm on a bs32 x 64 batch, equal to their numpy versions, both timed;
    (b) ``cli.train -fused_decoder 1 -ckpt_backend orbax -save_optim 1``
    (K3 once each way a G step) writing ``PREFIX_weights.orbax``, its
    write and read timed, a resume from it at the saved step bit for bit,
    ``cli.serve -load`` of it in f32 (K1 twice a batch) and
    ``-serve_int8 1`` (K1 and K4 once) answering bit for bit with the
    direct call, ``cli.sample -load`` of it writing the trainer's
    keypoints bit for bit; (c) ``PoseDecoder`` and ``StyleDecoder`` at
    full width, card against CPU (eval, train, running statistics, max
    |diff| / max |ref| ≤ 1e-4); (d) a fused G step with centered,
    bias-corrected RMSprop (K3 once each way) and two more updates, card
    against CPU (≤ 1e-6); (e) ``cli.preprocess`` of text, not aligned
    then aligned, every method (BERT on the card; ``text/tokens`` the ids
    of each interval's subwords); (f) ``tests/orbax_fixture/ocdbt``
    (JAX's orbax, OCDBT, zstd) against its checksums;
27. BERT from local files: ``bert-base-uncased`` from the hub cache, or,
    where the cache holds none, a seeded one at its full size (12 layers,
    768 wide, 30522 entries, the synthetic transcripts' words and pieces
    among them) written under ``build/`` before ``transformers`` is
    imported, the hub kept offline; (a) ``BertEmbedder`` on the card
    against the CPU (subword states and word means, max |diff| / max
    |ref| ≤ 1e-4), load times and ms per interval on both; (b)
    ``cli.preprocess -preprocess_methods '["bert", "tokens"]'`` on 2
    speakers x 2 intervals on the card against a CPU rerun
    (``text/bert`` within 1e-4, ``text/tokens`` and ``text/meta``
    equal); (c) ``cli.preprocess`` of 8 speakers x 3 intervals of 8 s,
    then ``cli.train`` on ``text/bert`` with ``-fused_decoder 1`` (K3
    once each way a G step) and ``cli.sample``; (d) ``cli.train
    -audio_lowering tpu`` (K3 once each way a G step) and ``-model
    Speech2Gesture_G -fused_decoder 1`` (K3 0 times).

The bf16 rule: no bf16 output is held element-wise to another bf16 output
(two valid roundings differ about as much as either differs from the
truth); the kernel's output P and its plain version's Q each drift from
the float32 truth R (the same function in float32 on the same inputs),
drift = mean |O - R| / mean |R| (relative Frobenius error for gradients),
and |drift(P) - drift(Q)| ≤ 0.10 drift(Q) + 1e-3.

Each kernel's bound is the least time the card could take for its work,
whatever route the kernel runs: K1, K2 and K3 at the dense bf16 rate with
6 MMAs per multiply-add (the 3xTF32 bound of their earlier routes, 3 MMAs
at the TF32 rate, beside each as ``tf32x3_bound_ms``; K2's and K3's f32 FMA
bound as ``ffma_bound_ms``), K4 at the int8 tensor-core rate; in bf16 mode
K1 and K2 at the dense bf16 rate with 3 MMAs per multiply-add (bf16
activations times f32 weights split in three bf16 terms; the 2xTF32 bound
of K1's and K2's earlier routes beside it as ``tf32x2_bound_ms``, K2's FMA
bound as ``ffma_bound_ms``), K3 at the dense bf16 rate, K4 at its f32
mode's rate with 2-byte features;
``mma`` names the inner product, ``mode`` the dtype mode.

It prints one JSON line of kernels, the ``nvidia-smi`` line, and last the
device line ``{"ok": true, "device": {...}}``.  Any failed check exits
nonzero; without a CUDA device it exits nonzero before printing a result.

    python3 chip_smoke.py [--seed 0] [--out results.json]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import re
import shutil
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

import numpy as np

# published peaks of one H100 SXM (NVIDIA data sheet): f32 outside the
# tensor cores, dense tensor-core rates, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12     # the 3xTF32 (2xTF32) bounds of earlier routes
PEAK_BF16_FLOPS = 989e12     # K1, K2, K3: 6 bf16 MMAs a multiply-add (bf16
#                              modes: K1 and K2 3, K3 1)
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES = 3.35e12
KERNEL_TOL = 1e-4            # max |kernel - plain| / max |plain|
DRIFT_TOL = 0.01             # the serving path's BN-fold drift contract
WAVE_TOL = 1e-5              # served waveform pose against the direct call
# the int8 kernel route against the plain int8 route, as fractions of mean
# |plain|: K1's float rounding moves the mixture weights and the features,
# and a requantized LSB it flips amplifies through later layers
# (tests/test_pallas.py:306-309)
INT8_MEAN_TOL, INT8_MAX_TOL = 1e-3, 1e-2
INT8_DRIFT = (1e-4, 0.10)    # int8 tier against f32 serving (test_pallas:160)
# fused vs unfused G step: Adam mu per module.  Float32 rounding flips a few
# of the ≈17M leaky units of the decoder that lie within ~1e-6 of 0, and
# the flips move the gradients upstream of them (8.2e-4 of gen.style_emb
# at --seed 0 on an H100; tests/test_torch_port_train_steps.py says why);
# a wrong gradient moves a module by O(1).
MOMENT_TOL = 3e-3
# a data-parallel step against the one-rank step (phase 24): there every
# layer sums its statistics in another order and cuDNN picks its
# algorithms by the rank's batch, so leaky units flip throughout the
# backbone, not only in the decoder (5.4e-3 of gen.classify_cluster at
# --seed 0 on an H100), while in float64 the two steps' moments agree to
# 1e-9 (the float64 check below; 2e-14 on the CPU,
# tests/test_torch_port_parallel_steps.py): rounding amplified
MOMENT_TOL_DP = 1e-2
F64_MU_TOL = 1e-9
# the largest of those gaps with K3 on its 3xTF32 mma.sync route at --seed
# 0 (NVIDIA H100 80GB HBM3, 700 W; PERF.md), the yardstick of its wgmma
# route's
MU_GAP_TF32X3 = 2.372e-4
# the bf16 rule: |drift(kernel) - drift(plain)| <= BF16_REL drift(plain) +
# BF16_ABS, each drift taken from the float32 truth
BF16_REL, BF16_ABS = 0.10, 1e-3
# K1's and K2's bf16 modes against their plain versions: both round the
# same f32 sums at the same points, so they differ by at most one bf16 ULP
# of max |out|, and only where two summation orders fall on either side of
# a rounding boundary and the flip spreads through later layers (K2's
# wgmma chain mode: 1.21-2.58% of the elements at the three-layer shapes
# below, 5.64% at the four-layer "deep", --seed 0 on an H100; its FFMA
# kernel before it 1.3-3.0% and 6.1%).  A kernel that skips one layer's
# rounding differs in 40-58% of them (tests/test_torch_port_cuda.py on
# such a copy of the FFMA K2).
BF16_ULPS, BF16_SHARE = 1.0, 0.20
# K1's classifier chain (L = 5) rounds seven layers, and there the flips
# that two valid summation orders start saturate: K1-bf16's parent (2xTF32
# mma.sync) differed from the plain version in 27.9-32.7% of the elements
# at the classifier shapes (this script), this kernel in up to 37.5%, and
# the bf16 rule passes a copy that rounds its last hidden layer toward
# zero, which differs in 62-71% (tools/k1_variants.py --mode bf16; NVIDIA H100
# 80GB HBM3, 700 W; PERF.md).  Chains of up to three hidden layers (the
# decoder, L = 3) keep BF16_SHARE.
K1_BF16_SHARE_DEEP = 0.45
# K3-fwd's bf16 mode against its plain version: out and cs within one bf16
# ULP of max |plain|, and a share of differing elements at most the limit
# below.  cs is one conv of bf16 inputs, rounded twice; out follows four
# BatchNorm + leaky layers, where the flips of two valid summation orders
# spread (K3-bf16's parent, mma.sync m16n8k16, differed in up to 7.50% of
# cs and 50.69% of out at the shapes this script and the card tests run,
# the wgmma kernel in up to 7.51% and 48.54%; NVIDIA H100 80GB HBM3, 700 W;
# tools/k3_probe.py, tools/k3_variants.py).  A copy that skips
# the rounding of the sum before the bias add passes the bf16 rule and
# differs in 59.6% of cs and 80.4% of out (tools/k3_variants.py's
# no-round; 60% and 81% in the kernel's sums emulated on the CPU,
# tests/test_torch_port_k3_bf16_wgmma.py).
K3_BF16_SHARE = {"out": 0.65, "cs": 0.20}


def k1_bf16_share(layers: int) -> float:
    """K1-bf16's limit on the share of elements differing from its plain
    version, for a chain of ``layers`` hidden layers."""
    return BF16_SHARE if layers <= 3 else K1_BF16_SHARE_DEEP

# the flagship model (bench.py:205-213) and its serving and training shapes
MODEL = dict(num_clusters=8, num_speakers=8, in_channels=256, style_dim=10,
             out_feats=96)
B, T, MEL = 32, 64, 128
C0, C = MODEL["in_channels"] + MODEL["style_dim"], MODEL["in_channels"]
K1_SHAPES = {   # name: (B, T, G, L, F); every shape the main path launches
    "decoder": (B, T, 8, 3, 96),             # full batches of 64 frames
    "classifier": (B, T, 1, 5, 8),
    "decoder_B1": (1, T, 8, 3, 96),          # one clip (8-frame tiles)
    "classifier_B1": (1, T, 1, 5, 8),
    "decoder_T128": (B, 128, 8, 3, 96),      # the server's 128-frame bucket
    "classifier_T128": (B, 128, 1, 5, 8),
    "decoder_T4096": (1, 4096, 8, 3, 96),    # the server's largest bucket
    "classifier_T4096": (1, 4096, 1, 5, 8),
}
K4_SHAPES = {   # name: (B, T); every shape the int8 path launches, and more
    "bs32": (B, T), "B1": (1, T), "T128": (B, 128), "T4096": (1, 4096),
    "ragged": (3, 50)}
K2_SHAPES = {   # name: (B, T, G, C, L)
    "main": (B, T, 8, 256, 3), "small": (4, 64, 4, 128, 3),
    "ragged": (3, 50, 8, 256, 3),
    "deep": (2, 130, 1, 256, 4),     # four layers: bf16 flips spread most
    "T128": (B, 128, 8, 256, 3)}     # 64-frame tiles of 72-row layers
MEL_WAVE = 64                # audio/log_mel_400


# the training configuration of bench.py:205-249 (in_channels 256 is the
# generator's default)
TRAIN_CFG = dict(model="JointLateClusterSoftStyle4_G", gan=True,
                 criterion="L1Loss", num_clusters=8, num_speakers=8)
F_POSE, LAYERS = MODEL["out_feats"], 4
SCAN_K = 8
K3_RAGGED = (3, 50)          # K3 alone at a ragged shape: the sequence ends
# phase 20: the lifecycle's data (25 s intervals) and its -debug per dtype
# (2 epochs of debug + 1 train steps each)
LIFE_INTERVALS = 3
LIFE_STEPS = {"float32": 8, "bfloat16": 4}
LIFE_FILES = {"args.args", "res.json", "weights.p", "log.log", "name.name",
              "metrics.json", "cummMetrics.json", "histogram.json",
              "style.pkl"}
TIMING_TURNS = 4             # timed turns of each decoder, in ABBA order
# phase 22: pose noise, dropout and the classifier's steps
NOISE, P_DROP = 0.01, 0.1
CLF_STEPS = 20
SCAN_LR = 1e-6               # the k-step driver against per-step calls
TEXT_LR = 1e-5               # phase 23's -optim_separate


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def k1_work(b, t, g, layers, f, act_bytes=4):
    """(flops, bytes) of one K1 call: every multiply-add of the chain, and
    each input read once and the output written once (f32 weights; the
    features and logits of ``act_bytes``: 4 in f32 mode, 2 in bf16)."""
    flops = 2 * b * t * g * (3 * C0 * C + layers * 3 * C * C + C * f)
    weights = (g * 3 * C0 * C + layers * g * 3 * C * C
               + g * (layers + 1) * C + g * C * f + g * f)
    return flops, 4 * weights + act_bytes * (b * t * C0 + b * t * g * f)


def k3_work(b, t, g, f, elem=4):
    """(flops, bytes) of K3-fwd and of K3-bwd, each input read once and
    each output written once: x, the weights, out, cs and dout of ``elem``
    bytes (4 in f32 mode, 2 in bf16), mu, var and every gradient f32.  The
    backward does the forward's multiply-adds twice: dW and d(input) of
    every conv and of the head."""
    n = b * t
    flops = 2 * n * g * (3 * C0 * C + (LAYERS - 1) * 3 * C * C + C * f)
    params = g * 3 * C0 * C + (LAYERS - 1) * g * 3 * C * C + g * C * f
    vec = g * LAYERS * C                     # one (G, 4, C) array
    fwd = (elem * (n * C0 + params + 3 * vec + g * f  # x, w, cb/γ/β, bl
                   + g * n * f + LAYERS * g * n * C)  # out, cs
           + 4 * 2 * vec)                             # mu/var
    bwd = (elem * (g * n * f + n * C0 + LAYERS * g * n * C + params
                   + 2 * vec)                         # dout, x, cs, w, γ/β
           + 4 * (2 * vec                             # stats
                  + n * C0 + params + 3 * vec + g * f))  # dx, dW, dcb.., dbl
    return (flops, fwd), (2 * flops, bwd)


def k4_work(b, t, g, layers, f, x_bytes=4):
    """(int8 operations, bytes) of one K4 call: 2 per multiply-add of the
    chain; the int8 weights, the input (``x_bytes`` a feature: 4 in f32
    mode, 2 in the bf16-feature mode), the f32 scales, multipliers and
    biases read once and the f32 output written once."""
    macs = 3 * C0 * C + layers * 3 * C * C + C * f
    f32 = (C0 + g * C + layers * g * C + 2 * g * (layers + 1) * C
           + 2 * g * f + b * t * g * f)
    return 2 * b * t * g * macs, g * macs + 4 * f32 + x_bytes * b * t * C0


def k2_work(b, t, g, c, layers, act_bytes=4):
    """(flops, bytes) of one K2 call, each input read once: activations of
    ``act_bytes`` (4 in f32 mode, 2 in bf16), f32 weights and biases."""
    return (2 * b * t * g * layers * 3 * c * c,
            act_bytes * 2 * b * t * g * c
            + 4 * (layers * g * 3 * c * c + layers * g * c))


def k2_timings(torch, smi, tag, rec, a, packed, g, act_bytes):
    """K2 at one shape (CUDA events): with the weights ``packed`` once and
    packed per call, its plain version, and its bound on its route (six
    bf16 products a multiply-add in the f32 mode, ``act_bytes`` 4; three in
    the bf16 mode, 2), the bounds of its earlier routes (3xTF32 or 2xTF32,
    f32 FMA) beside it; into ``rec``."""
    from mixstage_tpu_torch.ops.cuda.fused_conv import (
        chain_plain, fused_grouped_conv_chain)

    rec["ms"] = cuda_ms(torch, lambda: fused_grouped_conv_chain(
        *a, groups=g, packed=packed))
    rec["ms_packing_per_call"] = cuda_ms(
        torch, lambda: fused_grouped_conv_chain(*a, groups=g))
    rec["plain_ms"] = cuda_ms(torch, lambda: chain_plain(*a, groups=g))
    sh = rec["shape"]
    flops, nbytes = k2_work(sh["B"], sh["T"], g, sh["C"], sh["L"], act_bytes)
    mmas, tf32_mmas = (6, 3) if act_bytes == 4 else (3, 2)
    rec["bound_ms"], rec["bound_by"] = bound_ms(mmas * flops, nbytes,
                                                PEAK_BF16_FLOPS)
    old = f"tf32x{tf32_mmas}_bound_ms"
    rec[old] = bound_ms(tf32_mmas * flops, nbytes, PEAK_TF32_FLOPS)[0]
    rec["ffma_bound_ms"] = bound_ms(flops, nbytes)[0]
    log(f"[timing] {smi}: {tag}: {rec['ms']:.4f} ms "
        f"({flops / (rec['ms'] / 1e3) / 1e12:.2f} TFLOP/s of f32 work) on "
        f"weights packed once, {rec['ms_packing_per_call']:.4f} ms packing "
        f"them per call; plain {rec['plain_ms']:.4f} ms; bound "
        f"{rec['bound_ms']:.4f} ms by {rec['bound_by']} ({mmas} bf16 MMAs a "
        f"multiply-add at the dense bf16 rate; {old[:6]} bound "
        f"{rec[old]:.4f} ms, f32 FMA bound {rec['ffma_bound_ms']:.4f} ms; "
        f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")


def bound_ms(flops, nbytes, peak=PEAK_F32_FLOPS):
    """(least ms on the card, what bounds it): ``flops`` at ``peak`` or
    ``nbytes`` at the HBM rate, whichever takes longer."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def int8_errors(out, ref):
    """(mean |diff|, max |diff|) / mean |ref|, max |diff|, and the count of
    differing elements."""
    err, scale = (out - ref).abs(), float(ref.abs().mean())
    return (float(err.mean()) / scale, float(err.max()) / scale,
            float(err.max()), int((err > 0).sum()))


def kernel_name(mangled: str) -> str:
    """``wgmma_gemm_kernel<2, 1, 96, float, 3>`` from an Itanium-mangled
    kernel name: the last part of its nested name and its template
    arguments (integers, booleans, ``float`` and named types such as
    ``__nv_bfloat16``)."""
    i, parts = (3 if mangled.startswith("_ZN") else 2), []
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        parts.append(mangled[j:j + int(mangled[i:j])])
        i = j + int(mangled[i:j])
    name = parts[-1] if parts else mangled
    rest, args = mangled[i:], []
    if rest.startswith("I"):         # template arguments, up to their E
        j = 1
        while j < len(rest) and rest[j] != "E":
            m = re.match(r"Li(-?\d+)E|Lb([01])E|f|(\d+)", rest[j:])
            if not m:
                break
            if m.group(1) is not None:
                args.append(m.group(1))
                j += m.end()
            elif m.group(2) is not None:
                args.append("true" if m.group(2) == "1" else "false")
                j += m.end()
            elif m.group(0) == "f":
                args.append("float")
                j += 1
            else:
                n = int(m.group(3))
                args.append(rest[j + m.end():j + m.end() + n])
                j += m.end() + n
        if args:
            name += "<" + ", ".join(args) + ">"
    return name


def ptxas_summary(compiler_log: str):
    """[(kernel, registers, spill store bytes, spill load bytes)] of each
    entry function in an ``nvcc -Xptxas -v`` log."""
    out, name, spill = [], None, (0, 0)
    for line in compiler_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = kernel_name(m.group(1)), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), *spill))
            name = None
    return out


def trace(torch, fn, calls: int = 5) -> dict:
    """Device kernels, busy time (union of kernel intervals), host wall
    time and the device's idle share of it, per call of ``fn``, from
    ``calls`` calls under ``torch.profiler`` after 3 warm-up calls."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans, kernels = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        k = kernels.setdefault(e.name, [0, 0.0])
        k[0] += 1
        k[1] += (end - start) / 1e3
    busy_us, edge = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > edge:
            busy_us += end - max(start, edge)
            edge = end
    busy_ms = busy_us / 1e3 / calls
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                idle_share=(1 - busy_ms / wall_ms) if wall_ms else None,
                launches_per_call=sum(c for c, _ in kernels.values()) / calls,
                kernels=[dict(name=n, launches_per_call=c / calls,
                              ms_per_call=ms / calls) for n, (c, ms) in top])


def cuda_ms(torch, fn, reps: int = 20, warmup: int = 3,
            queued: bool = False) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls.  With
    ``queued`` the calls are enqueued while the card sleeps (about 10 ms)
    before the first event, so they run without host gaps between them:
    the device time of a kernel whose host call takes longer than it."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if queued:
        torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_folded(torch, gen, b, t, g, layers, f, device):
    def draw(*shape, scale):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    return (draw(b, t, C0, scale=1.0),
            draw(g, 3, C0, C, scale=(3 * C0) ** -0.5),
            draw(layers, g, 3, C, C, scale=(3 * C) ** -0.5),
            draw(g, layers + 1, C, scale=0.1),
            draw(g, C, f, scale=C ** -0.5),
            draw(g, f, scale=0.1))


def random_train(torch, gen, b, t, device, g=MODEL["num_clusters"]):
    """Seeded K3 inputs at the flagship widths, ``g`` groups: x (b, t,
    C0) and the decoder's packed parameters (``train_decoder.py``'s
    layout)."""

    def draw(*shape, scale, shift=0.0):
        return (torch.randn(*shape, generator=gen) * scale + shift).to(device)

    return (draw(b, t, C0, scale=1.0),
            draw(g, 3, C0, C, scale=(3 * C0) ** -0.5),
            draw(LAYERS - 1, g, 3, C, C, scale=(3 * C) ** -0.5),
            draw(g, LAYERS, C, scale=0.1),
            draw(g, LAYERS, C, scale=0.2, shift=1.0),
            draw(g, LAYERS, C, scale=0.1),
            draw(g, C, F_POSE, scale=C ** -0.5),
            draw(g, 1, F_POSE, scale=0.1))


def train_batch(rng, b, t, k=None):
    """A synthetic GAN-train batch (``k`` stacked ones with a leading axis):
    audio windows, poses, cluster labels and one speaker id per clip."""
    lead = () if k is None else (k,)
    style = rng.integers(0, MODEL["num_speakers"], size=lead + (b, 1))
    return {"x": (rng.normal(size=lead + (b, t, MEL)).astype(np.float32),),
            "y": rng.normal(size=lead + (b, t, F_POSE)).astype(np.float32),
            "labels": rng.integers(0, MODEL["num_clusters"],
                                   size=lead + (b, t)),
            "style": np.repeat(style, t, axis=-1)}


def rel_fro(a, b) -> float:
    return float((a - b).double().norm() / b.double().norm().clamp_min(1e-30))


def drift(out, truth, frobenius=False) -> float:
    """mean |out - truth| / mean |truth| (relative Frobenius error for a
    gradient), in float64."""
    if frobenius:
        return rel_fro(out, truth)
    d = (out.double() - truth.double()).abs().mean()
    return float(d / truth.double().abs().mean())


def bf16_rule(p, q, truth, frobenius=False):
    """(drift(p), drift(q), whether |drift(p) - drift(q)| <= BF16_REL *
    drift(q) + BF16_ABS)."""
    dp, dq = drift(p, truth, frobenius), drift(q, truth, frobenius)
    return dp, dq, abs(dp - dq) <= BF16_REL * dq + BF16_ABS


def bf16_ulps(torch, p, q):
    """(max |p - q| in bf16 ULPs at the scale of max |q|, the share of
    elements where p and q differ)."""
    p, q = p.float(), q.float()
    top = q.abs().max().reshape(1)
    ulp = float(torch.ldexp(torch.ones_like(top), torch.frexp(top)[1] - 8))
    return float((p - q).abs().max()) / ulp, float((p != q).float().mean())


def check_k3(torch, td, name, args, seed):
    """K3-fwd and K3-bwd against their plain versions on ``args``; returns
    (max abs error of the forward's outputs, of the backward's, the
    forward's outputs, dout)."""
    out = td.decoder_train_fwd(*args)
    ref = td.decoder_train_fwd_plain(*args)
    torch.cuda.synchronize()
    worst = 0.0
    for what, got, want in zip(("out", "cs", "mu", "var"), out, ref):
        check(bool(torch.isfinite(got).all()), f"K3-fwd {name} {what}")
        abs_err = float((got - want).abs().max())
        worst = max(worst, abs_err)
        rel = abs_err / float(want.abs().max())
        check(rel <= KERNEL_TOL, f"K3-fwd {name} {what}: {rel:.3e}")
    fwd_err, worst, g = worst, 0.0, out[0].shape[0]
    dout = torch.randn(out[0].shape, generator=torch.Generator().manual_seed(
        seed)).to(out[0].device)
    x, w0, wc, _, gamma, beta, wl, _ = args
    bwd_args = (dout, x, out[1], out[2], out[3], w0, wc, gamma, beta, wl)
    got = td.decoder_train_bwd(*bwd_args)
    want = td.decoder_train_bwd_plain(*bwd_args)
    torch.cuda.synchronize()
    errs = {}
    names = ("dx", "dw0", "dwc", "dcb", "dgamma", "dbeta", "dwl", "dbl")
    for what, a, b in zip(names, got, want):
        check(bool(torch.isfinite(a).all()), f"K3-bwd {name} {what}")
        worst = max(worst, float((a - b).abs().max()))
        if what == "dcb":                    # 0 analytically: float noise
            bound = KERNEL_TOL * float(want[5].abs().max())
            errs[what] = float(a.abs().max())
            check(errs[what] < bound and float(b.abs().max()) < bound,
                  f"K3-bwd {name} dcb {errs[what]:.3e} not below {bound:.3e}")
        else:
            errs[what] = rel_fro(a, b)
            check(errs[what] <= KERNEL_TOL,
                  f"K3-bwd {name} {what}: {errs[what]:.3e}")
    log(f"[train-kernel] K3 {name} B={x.shape[0]} T={x.shape[1]} G={g} "
        f"C0={x.shape[2]} C={w0.shape[-1]} F={wl.shape[-1]}: fwd max|err|/"
        f"max|ref| ≤ {KERNEL_TOL:g}; bwd rel. Frobenius "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items() if k != "dcb")
        + f"; |dcb| {errs['dcb']:.2e}; max|err| fwd {fwd_err:.3e}, bwd "
        f"{worst:.3e}")
    return fwd_err, worst, out, dout


def leaves(module):
    """Parameters and buffers of ``module`` by name."""
    return {**dict(module.named_parameters()), **dict(module.named_buffers())}


def g_moment_gaps(s0, s1):
    """The G optimizer's Adam mu after one step (0.1 × the clipped
    gradient), fused (s1) against unfused (s0), module by module
    (``gen.unet``, ``gen.decoder0``, ``psenc.stack``, ...): the relative
    Frobenius error of the module's leaves taken together.  The conv biases
    before a train BN, 0 analytically, apart: their largest |diff| over the
    largest |mu| of the tree.  Returns ({module: gap}, bias gap)."""
    num, den, bias, scale = {}, {}, 0.0, 0.0
    for name, a, b in zip(s0.g_opt.names, s0.g_opt.slots()["mu"],
                          s1.g_opt.slots()["mu"]):
        d = (b - a).double()
        scale = max(scale, float(a.abs().max()))
        if name.endswith("conv.bias"):
            bias = max(bias, float(d.abs().max()))
            continue
        m = ".".join(name.split(".")[:2])
        num[m] = num.get(m, 0.0) + float(d.square().sum())
        den[m] = den.get(m, 0.0) + float(a.double().square().sum())
    return ({m: (num[m] / max(den[m], 1e-60)) ** 0.5 for m in num},
            bias / scale)


def compare_states(torch, s0, s1, lr, mu_tol=MOMENT_TOL,
                   label="fused vs unfused G step"):
    """Fused (s1) against unfused (s0) G side after one G step: params at
    atol 2·lr (+1e-6), BN running statistics at 1e-4 of each leaf's scale,
    G's Adam mu (``g_moment_gaps``) at ``mu_tol`` per module and the
    pre-BN biases at 1e-4 of the tree's scale.  Returns (max param diff,
    max normalised stat diff, {module: mu gap}, bias gap)."""
    p_err = s_err = 0.0
    for m0, m1 in ((s0.gen, s1.gen), (s0.psenc, s1.psenc),
                   (s0.disc, s1.disc)):
        if m0 is None:                   # a model family without the module
            continue
        a, b = leaves(m0), leaves(m1)
        for k in a:
            d = float((a[k] - b[k]).detach().abs().max())
            if k.endswith(("running_mean", "running_var")):
                s_err = max(s_err, d / max(float(a[k].abs().max()), 1e-30))
            else:
                p_err = max(p_err, d)
    gaps, bias = g_moment_gaps(s0, s1)
    log(f"[train] {label}, Adam mu per module (relative Frobenius): " + ", ".join(f"{m} {g:.2e}" for m, g in sorted(
            gaps.items(), key=lambda kv: -kv[1]))
        + f"; pre-BN conv biases {bias:.2e} of max |mu|")
    check(p_err <= 2 * lr + 1e-6, f"{label}: params differ by {p_err:.3e}")
    check(s_err <= KERNEL_TOL, f"{label}: BN stats differ by {s_err:.3e}")
    worst = max(gaps, key=gaps.get)
    check(gaps[worst] <= mu_tol, f"{label}: Adam mu of {worst} differs by "
          f"{gaps[worst]:.3e} (tol {mu_tol:g})")
    check(bias <= KERNEL_TOL, f"{label}: pre-BN bias mu {bias:.3e}")
    return p_err, s_err, gaps, bias


def serve_over_http(serve_fn, rng, jobs, stream_style=None):
    """``jobs`` [(kind "json" or "npz", frames, style id)] as ``/v1/pose``
    requests through an HTTP server over ``serve_fn`` (batch B) and, with
    ``stream_style``, one 150-frame ``/v1/stream…`` session (chunks of 40,
    hop 32), each against ``serve_fn`` called directly at the server's
    batch size with the request tiled as the batcher pads it: int8 turns
    the float differences of batch-size dependent convolution algorithms
    into flipped LSBs, so only the same batch shape can be held to
    equality.  Returns (differing elements of the responses, their max
    |diff|, differing elements of the stream or None, the server's
    ``/stats``)."""
    from mixstage_tpu_torch.serving import (DynamicBatcher, PoseClient,
                                            PoseService, start_http_server)
    from mixstage_tpu_torch.streaming import session_over_serving_fn

    S, F = MODEL["num_speakers"], MODEL["out_feats"]
    onehot = np.eye(S, dtype=np.float32)

    def direct(a, sty):
        """``serve_fn`` on a batch of one, run as the batcher runs it."""
        out = serve_fn(np.repeat(a, B, axis=0), np.repeat(sty, B, axis=0))
        return out[:1].cpu().numpy()

    batcher = DynamicBatcher(serve_fn, batch_size=B, max_wait_ms=5.0)
    service = PoseService(batcher, backend=serve_fn.device.type,
                          num_styles=S, mel_bins=MEL)
    server = start_http_server(service, port=0, host="127.0.0.1")
    ndiff, worst, stream_diff = 0, 0.0, None
    try:
        client = PoseClient(f"http://127.0.0.1:{server.server_address[1]}",
                            timeout_s=300)
        for kind_, n, sty in jobs:
            a = rng.normal(size=(n, MEL)).astype(np.float32)
            got = (client.pose if kind_ == "npz" else client.pose_json)(
                a, style=sty)
            bucket = 64 if n <= 64 else 128
            padded = np.concatenate([a, np.repeat(a[-1:], bucket - n, 0)])
            want = direct(padded[None], onehot[[sty]])[0, :n]
            check(got.shape == (n, F), f"{kind_} response {got.shape}")
            ndiff += int(np.count_nonzero(got != want))
            worst = max(worst, float(np.abs(got - want).max()))
        if stream_style is not None:
            x = rng.normal(size=(150, MEL)).astype(np.float32)
            stream = client.stream(style=stream_style, hop=32)
            pieces = [stream.feed(x[i:i + 40]) for i in range(0, 150, 40)]
            pieces.append(stream.finish())
            got = np.concatenate([q for q in pieces if q.size])
            sess = session_over_serving_fn(direct, onehot[stream_style],
                                           hop=32)
            want = np.concatenate([q for q in (sess.feed(x), sess.finish())
                                   if q.size])
            check(got.shape == (150, F), f"streamed pose {got.shape}")
            stream_diff = int(np.count_nonzero(got != want))
        stats = client.stats()
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
    return ndiff, worst, stream_diff, stats


def int8_phases(torch, args, device, smi, model, audio, styles, pose32,
                results):
    """Phases 10-14: K4 and K2 against their plain versions, the int8
    serving path through the entry points and the HTTP server (streaming
    included), the waveform endpoint, and their timings.  Returns the
    kernels-line entries of K4 and K2."""
    from mixstage_tpu_torch.data.audio import log_mel_400, log_mel_spectrogram
    from mixstage_tpu_torch.models import JointLateClusterSoftStyle4_G
    from mixstage_tpu_torch.models.layers import reset_parameters_
    from mixstage_tpu_torch.ops.cuda import quant as q8
    from mixstage_tpu_torch.ops.cuda.fused_conv import (
        chain_plain, chain_tile_frames, fused_grouped_conv_chain,
        fused_mixstage_decoder, pack_chain_bf16)
    from mixstage_tpu_torch.serve import (build_serving_fn,
                                          build_waveform_serving_fn)
    from mixstage_tpu_torch.serving import (DynamicBatcher, PoseClient,
                                            PoseService, start_http_server)

    G, L, F = MODEL["num_clusters"], 3, MODEL["out_feats"]
    S = MODEL["num_speakers"]

    # 10. int8 and chain kernels against their plain versions ------------
    # K4's wgmma instances (one per width N): registers, spills, and
    # ptxas's advisories (a wgmma it serialises says so)
    k4_ptxas = results["ptxas"]["decoder_int8"]
    inst = [k for k in k4_ptxas["kernels"]
            if k[0].startswith("decoder_int8_kernel")]
    check(len(inst) == 7, f"{len(inst)} decoder_int8_kernel instances "
          f"built, expected 7")
    for kernel, regs, stores, loads in inst:
        log(f"[kernel] K4 {kernel}: {regs} registers, {stores} B spill "
            f"stores, {loads} B spill loads")
    log(f"[kernel] K4 ptxas advisories: "
        f"{k4_ptxas['advisories'] or 'none'}")
    qgen = torch.Generator().manual_seed(args.seed + 9)
    _, w0, wc, biases, wl, bl = random_folded(torch, qgen, 1, 1, G, L, F,
                                              device)
    calib_x = torch.randn(B, T, C0, generator=qgen).to(device)
    qfd = q8.pack_decoder_int8(q8.quantize_folded_decoder(
        dict(w0=w0, wc=wc, biases=biases, w_logits=wl, b_logits=bl),
        calib_x))
    k4_shapes = {}
    for name, (b, t) in K4_SHAPES.items():
        x = torch.randn(b, t, C0, generator=qgen).to(device)
        out = q8.fused_mixstage_decoder_int8(x, qfd, groups=G)
        ref = q8.decoder_int8_plain(x, qfd, G)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"K4 {name}: non-finite")
        mean_rel, max_rel, abs_err, ndiff = int8_errors(out, ref)
        tile = q8.device_tile_frames(b, t, C0, C, L, F, G, device)
        log(f"[kernel] fused_mixstage_decoder_int8 {name} B={b} T={t} G={G} "
            f"C0={C0} C={C} L={L} F={F} (tile {tile} frames, "
            f"{G * b * -(-t // tile)} CTAs): {ndiff} of {out.numel()} "
            f"elements differ from the plain version (tol 0); "
            f"mean|err|/mean|ref| {mean_rel:.3e}, max {max_rel:.3e}")
        check(ndiff == 0, f"K4 {name}: {ndiff} elements differ from the "
              f"plain version, which it matches bit for bit by design")
        k4_shapes[name] = dict(shape=dict(B=b, T=t, G=G, C0=C0, C=C, L=L,
                                          F=F), tile=tile, max_abs_err=abs_err,
                               mean_rel_err=mean_rel, max_rel_err=max_rel,
                               differing=ndiff, args=x)
    # K2: the chain mode's f32 instances (terms 3, chain true)
    for kernel, regs, stores, loads in results["ptxas"][
            "fused_decoder_wgmma"]["kernels"]:
        if kernel.startswith("decoder_kernel") and \
                kernel.endswith(", 3, true>"):
            log(f"[kernel] K2 f32 mode {kernel}: {regs} registers, {stores} "
                f"B spill stores, {loads} B spill loads")
    k2_shapes = {}
    for name, (b, t, g, c, layers) in K2_SHAPES.items():
        a = (torch.randn(b, t, g * c, generator=qgen).to(device),
             (torch.randn(layers, g, 3, c, c, generator=qgen)
              * (3 * c) ** -0.5).to(device),
             (torch.randn(layers, g * c, generator=qgen) * 0.1).to(device))
        packed = pack_chain_bf16(a[1])
        out = fused_grouped_conv_chain(*a, groups=g, packed=packed)
        ref = chain_plain(*a, groups=g)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"K2 {name}: non-finite")
        abs_err = float((out - ref).abs().max())
        rel_err = abs_err / float(ref.abs().max())
        tile = chain_tile_frames(b, t, c, layers, g, device)
        log(f"[kernel] fused_grouped_conv_chain {name} B={b} T={t} G={g} "
            f"C={c} L={layers} (tile {tile} frames, {g * b * -(-t // tile)} "
            f"CTAs): max|err| {abs_err:.3e}, /max|ref| {rel_err:.3e} (tol "
            f"{KERNEL_TOL:g})")
        check(rel_err <= KERNEL_TOL, f"K2 {name} disagrees with its plain "
              f"version: {rel_err:.3e}")
        k2_shapes[name] = dict(shape=dict(B=b, T=t, G=g, C=c, L=layers),
                               tile=tile, max_abs_err=abs_err,
                               max_rel_err=rel_err, args=(a, packed))

    # 11. int8 serving through the entry points ----------------------------
    rng = np.random.default_rng(args.seed + 11)
    calib = (rng.normal(size=(B, T, MEL)).astype(np.float32),
             rng.integers(0, S, size=B).astype(np.int32))
    serve8 = build_serving_fn(model, quantize_int8=True, calib=calib)
    plain8 = build_serving_fn(model, use_kernel=False, quantize_int8=True,
                              calib=calib)
    check(serve8.device.type == "cuda" and serve8.use_kernel,
          "int8 serving device")

    def counts():
        return (fused_mixstage_decoder.launches,
                q8.fused_mixstage_decoder_int8.launches,
                fused_grouped_conv_chain.launches)

    fused_mixstage_decoder.launches = 0              # int8 path starts
    q8.fused_mixstage_decoder_int8.launches = 0
    fused_grouped_conv_chain.launches = 0
    pose8 = serve8(audio, styles)
    torch.cuda.synchronize()
    check(counts() == (1, 1, 0), f"one int8 serving call launched (K1, K4, "
          f"K2) {counts()} times, expected (1, 1, 0)")
    check(tuple(pose8.shape) == (B, T, F), f"int8 pose {tuple(pose8.shape)}")
    check(bool(torch.isfinite(pose8).all()), "non-finite int8 pose")
    pose8_plain = plain8(audio, styles)
    drift = float((pose8 - pose32).abs().mean() / pose32.abs().mean())
    mean_rel, max_rel, _, ndiff = int8_errors(pose8, pose8_plain)
    log(f"[int8] full width bs{B} T{T}: K1+K4 route vs plain int8 route: "
        f"{ndiff} of {pose8.numel()} elements differ, mean {mean_rel:.3e}, "
        f"max {max_rel:.3e}; drift vs the f32 kernel route {drift:.4e} "
        f"(envelope {INT8_DRIFT})")
    check(mean_rel <= INT8_MEAN_TOL and max_rel <= INT8_MAX_TOL,
          "int8 kernel route outside K4's envelope of the plain route")
    check(INT8_DRIFT[0] < drift < INT8_DRIFT[1], "int8 drift out of envelope")
    results["int8"] = dict(drift_vs_f32=drift, vs_plain_mean=mean_rel,
                           vs_plain_max=max_rel, vs_plain_differing=ndiff)

    # 12. int8 server: /v1/pose and a streaming session -------------------
    jobs = [("npz", 64, 2), ("json", 64, 5), ("npz", 100, 7)]
    ndiff, worst, stream_diff, stats = serve_over_http(serve8, rng, jobs,
                                                       stream_style=3)
    log(f"[int8-server] {len(jobs)} /v1/pose requests (npz, json; 64 and"
        f" 100 frames) vs the direct call at batch {B}: {ndiff} elements "
        f"differ, max|diff|/mean|pose| {worst / float(pose8.abs().mean()):.3e}"
        f" (tol 0); streaming session over HTTP (150 frames in chunks of "
        f"40, hop 32) vs StreamingSession over the direct serving fn: "
        f"{stream_diff} elements differ (tol 0); stats requests="
        f"{stats['requests']} batches={stats['batches']} "
        f"streams={stats['streams']}")
    check(ndiff == 0, "int8 served pose differs from direct")
    check(stream_diff == 0, "streamed pose differs")
    check(stats["streams"] == 0, "the finished stream is still live")
    launches = counts()                              # int8 path ends
    check(launches[0] == launches[1] and launches[1] >= 1 + stats["batches"],
          f"(K1, K4) launches over the int8 path {launches[:2]}: expected "
          f"one each per int8 serving call")
    check(launches[2] == 0, f"K2 launched {launches[2]} times over the int8 "
          f"path, which does not call it")
    log(f"[int8] (K1, K4, K2) launches over the int8 path (phases 11-12): "
        f"{launches}")

    # 13. waveform endpoint on a 64-mel generator --------------------------
    model64 = JointLateClusterSoftStyle4_G(**MODEL)
    reset_parameters_(model64, torch.Generator().manual_seed(args.seed + 12),
                      random_bn_stats=True)
    wave_fn = build_waveform_serving_fn(model64)
    wav = (0.1 * rng.normal(size=(2, wave_fn.n_samples))).astype(np.float32)
    with torch.inference_mode():
        mel_dev = log_mel_spectrogram(torch.as_tensor(wav, device=device))
    torch.cuda.synchronize()
    mel_err = max(float(np.abs(mel_dev[i].cpu().numpy()
                               - log_mel_400(wav[i].astype(np.float64)))
                        .max())
                  for i in range(2))
    log(f"[waveform] on-card log-mel frontend (f32, cuFFT) vs numpy "
        f"log_mel_400 (float64): max|diff| {mel_err:.3e} (tol 1e-3)")
    check(mel_err <= 1e-3, "on-card frontend differs from log_mel_400")
    wave_batcher = DynamicBatcher(wave_fn, batch_size=4, max_wait_ms=5.0)
    mel_batcher = DynamicBatcher(build_serving_fn(model64), batch_size=4)
    service = PoseService(mel_batcher, backend="cuda", num_styles=S,
                          mel_bins=MEL_WAVE, waveform_batcher=wave_batcher)
    server = start_http_server(service, port=0, host="127.0.0.1")
    k1_before = fused_mixstage_decoder.launches
    try:
        client = PoseClient(f"http://127.0.0.1:{server.server_address[1]}",
                            timeout_s=300)
        got = client.pose_from_waveform(wav[0], style=4)
        want = wave_fn(np.repeat(wav[:1], 4, axis=0),
                       np.repeat(np.eye(S, dtype=np.float32)[[4]], 4, axis=0)
                       )[0].cpu().numpy()
    finally:
        server.shutdown()
        server.server_close()
        wave_batcher.close()
        mel_batcher.close()
    wave_err = float(np.abs(got - want).max()) / float(np.abs(want).mean())
    log(f"[waveform] /v1/pose_from_waveform ({wave_fn.n_samples} samples, "
        f"64 mel bins, full width) -> pose {got.shape}; vs the direct call "
        f"max|diff|/mean|pose| {wave_err:.3e} (tol {WAVE_TOL:g}); K1 "
        f"launches {fused_mixstage_decoder.launches - k1_before}")
    check(got.shape == (64, F) and bool(np.isfinite(got).all()),
          f"waveform pose {got.shape}")
    check(wave_err <= WAVE_TOL, "waveform served pose differs from direct")
    results["waveform"] = dict(frontend_max_abs=mel_err, served_err=wave_err)

    # 14. timings ----------------------------------------------------------
    for name, rec in k4_shapes.items():
        x = rec.pop("args")
        rec["ms"] = cuda_ms(torch, lambda: q8.fused_mixstage_decoder_int8(
            x, qfd, groups=G))
        rec["plain_ms"] = cuda_ms(torch, lambda: q8.decoder_int8_plain(
            x, qfd, G), reps=5)
        sh = rec["shape"]
        ops, nbytes = k4_work(sh["B"], sh["T"], G, L, F)
        rec["bound_ms"], rec["bound_by"] = bound_ms(ops, nbytes, PEAK_INT8_OPS)
        rec["tops"] = ops / (rec["ms"] / 1e3) / 1e12
        log(f"[timing] {smi}: K4 {name}: {rec['ms']:.4f} ms "
            f"({rec['tops']:.2f} TOP/s int8), plain {rec['plain_ms']:.4f} "
            f"ms, bound {rec['bound_ms']:.4f} ms by {rec['bound_by']} "
            f"({ops / 1e9:.2f} G int8 ops, {nbytes / 1e6:.2f} MB)")
    for name, rec in k2_shapes.items():
        (a, packed), g = rec.pop("args"), rec["shape"]["G"]
        k2_timings(torch, smi, f"K2 {name}", rec, a, packed, g, act_bytes=4)
    audio_dev = torch.as_tensor(audio, device=device)
    styles_dev = torch.as_tensor(styles, device=device)
    serve32 = build_serving_fn(model)
    calls = {"f32": serve32, "int8": serve8}
    turns = {name: [] for name in calls}
    for name in ["f32", "int8", "int8", "f32"]:
        turns[name].append(cuda_ms(torch, lambda: calls[name](
            audio_dev, styles_dev), reps=20))
    call_t = {name: float(np.mean(v)) for name, v in turns.items()}
    log(f"[timing] {smi}: bs{B} serving call, ABBA turns: f32 "
        f"{call_t['f32']:.3f} ms ({B * T / call_t['f32'] * 1e3:.1f} pose "
        f"frames/s; turns {turns['f32']}), int8 {call_t['int8']:.3f} ms "
        f"({B * T / call_t['int8'] * 1e3:.1f} frames/s; turns "
        f"{turns['int8']})")
    results["int8"]["timing"] = dict(
        call_ms=call_t, turns=turns,
        frames_per_s={k: B * T / v * 1e3 for k, v in call_t.items()})
    results["k4_shapes"], results["k2_shapes"] = k4_shapes, k2_shapes

    main4, main2 = k4_shapes["bs32"], k2_shapes["main"]
    k4 = {"name": "fused_mixstage_decoder_int8", "route": "cuda",
          "source": "mixstage_tpu_torch/ops/cuda/csrc/decoder_int8.cu",
          "replaces": "mixstage_tpu/ops/pallas/quant.py:266",
          "launches": launches[1],
          "max_abs_err": max(r["max_abs_err"] for r in k4_shapes.values()),
          "ms": main4["ms"], "plain_ms": main4["plain_ms"],
          "bound_ms": main4["bound_ms"], "bound_by": main4["bound_by"],
          # no single PyTorch call computes the int8 conv chain
          "library_ms": None, "mma": "wgmma-s8"}
    k2 = {"name": "fused_grouped_conv_chain", "route": "cuda",
          "source": "mixstage_tpu_torch/ops/cuda/csrc/fused_decoder_wgmma.cu",
          "replaces": "mixstage_tpu/ops/pallas/fused_conv.py:75",
          # a public op: no path of the package calls it
          "launches": launches[2],
          "max_abs_err": max(r["max_abs_err"] for r in k2_shapes.values()),
          "ms": main2["ms"], "plain_ms": main2["plain_ms"],
          "bound_ms": main2["bound_ms"], "bound_by": main2["bound_by"],
          "library_ms": None, "mma": "wgmma",
          "ms_packing_per_call": main2["ms_packing_per_call"],
          "tf32x3_bound_ms": main2["tf32x3_bound_ms"],
          "ffma_bound_ms": main2["ffma_bound_ms"]}
    return k4, k2


def bf16_phases(torch, args, device, smi, model, audio, styles, pose32,
                serve32, results):
    """Phases 15-17: the bf16 modes of K1 and K3 against their plain
    versions, the bf16 serving and training paths through the entry points
    and the HTTP server, and their timings against f32.  Returns the
    kernels-line entries of K1-bf16, K3-fwd-bf16 and K3-bwd-bf16."""
    from mixstage_tpu_torch.models import JointLateClusterSoftStyle4_G
    from mixstage_tpu_torch.ops.cuda import fused_conv as fc
    from mixstage_tpu_torch.ops.cuda import train_decoder as td
    from mixstage_tpu_torch.ops.cuda.fused_conv import (
        device_tile_frames, fused_mixstage_decoder,
        fused_mixstage_decoder_plain, pack_decoder_bf16)
    from mixstage_tpu_torch.serve import build_serving_fn
    from mixstage_tpu_torch.train import StepConfig, StepFactory

    bf16 = torch.bfloat16
    S, F = MODEL["num_speakers"], MODEL["out_feats"]

    # 15. bf16 kernels against their plain versions ------------------------
    gen = torch.Generator().manual_seed(args.seed + 13)
    k1_16 = {}
    for name, (b, t, g, layers, f) in K1_SHAPES.items():
        x, *w = random_folded(torch, gen, b, t, g, layers, f, device)
        x16 = x.bfloat16()
        with torch.no_grad():
            out = fused_mixstage_decoder(x16, *w, groups=g)
            ref = fused_mixstage_decoder_plain(x16, *w, groups=g)
            truth = fused_mixstage_decoder_plain(x16.float(), *w, groups=g)
        torch.cuda.synchronize()
        check(out.dtype == bf16 and bool(torch.isfinite(out).all()),
              f"K1-bf16 {name}: dtype {out.dtype} or non-finite")
        dp, dq, ok = bf16_rule(out, ref, truth)
        ulps, share = bf16_ulps(torch, out, ref)
        abs_err = float((out.float() - ref.float()).abs().max())
        tile = device_tile_frames(b, t, C0, C, layers, f, g, device, 2)
        log(f"[bf16-kernel] fused_mixstage_decoder bf16 {name} B={b} T={t} "
            f"G={g} L={layers} F={f} (tile {tile}): drift from f32 kernel "
            f"{dp:.4e}, plain {dq:.4e} (bf16 rule: {'ok' if ok else 'FAIL'}"
            f"); max|diff| {abs_err:.3e} = {ulps:.2f} bf16 ULPs of max|out|,"
            f" {share:.2%} of elements differ")
        check(ok, f"K1-bf16 {name} breaks the bf16 rule: {dp:.4e} vs "
              f"{dq:.4e}")
        check(ulps <= BF16_ULPS and share <= k1_bf16_share(layers),
              f"K1-bf16 {name}: {ulps:.2f} bf16 ULPs of max |plain| (limit "
              f"{BF16_ULPS:g}), {share:.2%} of elements differ (limit "
              f"{k1_bf16_share(layers):.0%})")
        k1_16[name] = dict(shape=dict(B=b, T=t, G=g, L=layers, F=f),
                           tile=tile, drift=dp, plain_drift=dq,
                           max_ulps=ulps, differing=share,
                           max_abs_err=abs_err, args=(x16, *w))
    x16, *w = k1_16["decoder"]["args"]
    with torch.no_grad():
        coarse = fused_mixstage_decoder_plain(
            x16, *(t.bfloat16().float() for t in w), groups=8)
        truth = fused_mixstage_decoder_plain(x16.float(), *w, groups=8)
    dc, dq = drift(coarse, truth), k1_16["decoder"]["plain_drift"]
    log(f"[bf16-kernel] for comparison, the decoder with its weights "
        f"rounded to bf16 (another function) drifts {dc:.4e} (bf16 rule "
        f"against the plain bf16 mode: "
        f"{'ok' if abs(dc - dq) <= BF16_REL * dq + BF16_ABS else 'fails'})")
    # K3's bf16 GEMM (wgmma): its instances' registers and spills, and
    # ptxas's advisories (a wgmma it serialises says so)
    k3_ptxas = results["ptxas"]["train_decoder"]
    wg = [k for k in k3_ptxas["kernels"]
          if k[0].startswith("wgmma_gemm_kernel") and k[0].endswith(", 1>")]
    check(len(wg) == 12, f"{len(wg)} bf16-mode wgmma_gemm_kernel instances "
          f"built, expected 12")
    for kernel, regs, stores, loads in wg:
        log(f"[bf16-kernel] K3 bf16 GEMM {kernel}: {regs} registers, "
            f"{stores} B spill stores, {loads} B spill loads")
    log(f"[bf16-kernel] K3 ptxas advisories: "
        f"{k3_ptxas['advisories'] or 'none'}")
    kgen = torch.Generator().manual_seed(args.seed + 14)
    k3_16 = {}
    names = ("dx", "dw0", "dwc", "dcb", "dgamma", "dbeta", "dwl", "dbl")
    for name, (b_, t_) in (("bs32", (B, T)), ("ragged", K3_RAGGED)):
        a32 = tuple(v.bfloat16().float()
                    for v in random_train(torch, kgen, b_, t_, device))
        a16 = tuple(v.bfloat16() for v in a32)
        fwd = td.decoder_train_fwd(*a16)
        ref = td.decoder_train_fwd_plain(*a16)
        truth = td.decoder_train_fwd_plain(*a32)
        torch.cuda.synchronize()
        report, worst_f, shares = [], 0.0, {}
        for what, p_, q_, r_ in zip(("out", "cs", "mu", "var"), fwd, ref,
                                    truth):
            check(p_.dtype == q_.dtype and bool(torch.isfinite(p_).all()),
                  f"K3-fwd-bf16 {name} {what}")
            dp, dq, ok = bf16_rule(p_, q_, r_)
            worst_f = max(worst_f, float((p_.float() - q_.float()).abs()
                                         .max()))
            report.append(f"{what} {dp:.3e}/{dq:.3e}")
            check(ok, f"K3-fwd-bf16 {name} {what} breaks the bf16 rule: "
                  f"{dp:.4e} vs {dq:.4e}")
            if p_.dtype == bf16:     # out, cs: ULPs and the differing share
                ulps, share = bf16_ulps(torch, p_, q_)
                shares[what] = (ulps, share)
                report[-1] += f" ({ulps:.2f} ULPs of max, {share:.2%} differ)"
                check(ulps <= BF16_ULPS and share <= K3_BF16_SHARE[what],
                      f"K3-fwd-bf16 {name} {what}: {ulps:.2f} bf16 ULPs of "
                      f"max |plain| (limit {BF16_ULPS:g}), {share:.2%} of "
                      f"elements differ (limit {K3_BF16_SHARE[what]:.0%})")
        dout = torch.randn(ref[0].shape, generator=torch.Generator()
                           .manual_seed(args.seed + 15)).to(device).bfloat16()
        x, w0, wc, _, gamma, beta, wl, _ = a16
        bwd_args = (dout, x, ref[1], ref[2], ref[3], w0, wc, gamma, beta, wl)
        got = td.decoder_train_bwd(*bwd_args)
        want = td.decoder_train_bwd_plain(*bwd_args)
        x, w0, wc, _, gamma, beta, wl, _ = a32
        true = td.decoder_train_bwd_plain(dout.float(), x, *truth[1:], w0,
                                          wc, gamma, beta, wl)
        torch.cuda.synchronize()
        worst_b = 0.0
        for what, p_, q_, r_ in zip(names, got, want, true):
            check(p_.dtype == torch.float32 and bool(torch.isfinite(p_).all()),
                  f"K3-bwd-bf16 {name} {what}")
            worst_b = max(worst_b, float((p_ - q_).abs().max()))
            if what == "dcb":                # 0 analytically: float noise
                bound = KERNEL_TOL * float(want[5].abs().max())
                check(float(p_.abs().max()) < bound and
                      float(q_.abs().max()) < bound,
                      f"K3-bwd-bf16 {name} dcb not below {bound:.3e}")
                continue
            dp, dq, ok = bf16_rule(p_, q_, r_, frobenius=True)
            report.append(f"{what} {dp:.3e}/{dq:.3e}")
            check(ok, f"K3-bwd-bf16 {name} {what} breaks the bf16 rule: "
                  f"{dp:.4e} vs {dq:.4e}")
        log(f"[bf16-kernel] K3 bf16 {name} B={b_} T={t_}: drift from f32 "
            f"kernel/plain " + ", ".join(report) + f" (bf16 rule: ok); "
            f"max|err| vs plain fwd {worst_f:.3e}, bwd {worst_b:.3e}")
        k3_16[name] = dict(fwd_err=worst_f, bwd_err=worst_b, fwd_args=a16,
                           bwd_args=bwd_args, shares=shares)

    # 16. bf16 entry points --------------------------------------------------
    model16 = JointLateClusterSoftStyle4_G(**MODEL, dtype=bf16)
    model16.load_state_dict(model.state_dict())
    serve16 = build_serving_fn(model16)
    check(serve16.dtype == bf16 and serve16.use_kernel, "bf16 serving fn")
    packs = []                   # K1-bf16's weights are packed at build time
    fc.pack_decoder_bf16 = lambda fd: packs.append(fd) or \
        pack_decoder_bf16(fd)
    fused_mixstage_decoder.launches = 0              # bf16 serving starts
    fused_mixstage_decoder.launches_bf16 = 0
    pose16 = serve16(audio, styles)
    torch.cuda.synchronize()
    counts = (fused_mixstage_decoder.launches,
              fused_mixstage_decoder.launches_bf16)
    check(counts == (2, 2), f"one bf16 serving call launched K1 (all, "
          f"bf16 mode) {counts} times, expected (2, 2)")
    check(pose16.dtype == torch.float32 and tuple(pose16.shape) == (B, T, F)
          and bool(torch.isfinite(pose16).all()), "bf16 pose")
    drift16 = drift(pose16, pose32)
    log(f"[bf16] full width bs{B} T{T} serving: K1 launches (all, bf16) "
        f"{counts}; drift from the f32 kernel route {drift16:.4e} "
        f"(contract {DRIFT_TOL:g})")
    check(drift16 <= DRIFT_TOL, "bf16 serving outside the 1% contract")
    rng = np.random.default_rng(args.seed + 16)
    jobs = [("json", 64, 1), ("npz", 64, 6), ("npz", 100, 3)]
    ndiff, worst, _, stats = serve_over_http(serve16, rng, jobs)
    launches16 = (fused_mixstage_decoder.launches,
                  fused_mixstage_decoder.launches_bf16)  # bf16 serving ends
    fc.pack_decoder_bf16 = pack_decoder_bf16
    check(not packs, f"the bf16 serving path packed K1-bf16's weights "
          f"{len(packs)} times after the serving function was built")
    log(f"[bf16-server] {len(jobs)} /v1/pose requests (json, npz; 64 and 100"
        f" frames) vs the direct call at batch {B}: {ndiff} elements differ "
        f"(max|diff| {worst:.3e}; tol 0); K1 launches over the bf16 serving "
        f"path (all, bf16 mode) {launches16}, none packing its weights")
    check(ndiff == 0, "bf16 served pose differs from the direct call")
    check(launches16[0] == launches16[1] ==
          2 * (1 + stats["batches"] + len(jobs)),
          f"K1 launches {launches16} over the bf16 serving path: expected "
          f"two bf16-mode launches per serving call")

    trng = np.random.default_rng(args.seed + 17)
    batch = train_batch(trng, B, T)
    facs = {"f32": StepFactory(StepConfig(**TRAIN_CFG)),
            "unfused": StepFactory(StepConfig(**TRAIN_CFG, dtype=bf16)),
            "fused": StepFactory(StepConfig(**TRAIN_CFG, dtype=bf16,
                                            fused_decoder=True))}

    def k3_counts():
        return (td.decoder_train_fwd.launches_bf16,
                td.decoder_train_bwd.launches_bf16)

    td.decoder_train_fwd.launches = td.decoder_train_bwd.launches = 0
    td.decoder_train_fwd.launches_bf16 = 0          # bf16 training starts
    td.decoder_train_bwd.launches_bf16 = 0
    g_out = {}
    for name, fac in facs.items():
        before = k3_counts()
        g_out[name] = fac.make_steps()["g"](fac.init(seed=args.seed + 7),
                                            batch)
        torch.cuda.synchronize()
        want = tuple(c + (name == "fused") for c in before)
        check(k3_counts() == want, f"{name} G step: K3 bf16 launches "
              f"{k3_counts()}, expected {want}")
    (r_state, r_loss, r_pose), (q_state, q_loss, q_pose) = (
        g_out["f32"], g_out["unfused"])
    train16 = {}
    for name in ("fused", "unfused"):
        p_state, p_loss, p_pose = g_out[name]
        check(p_pose.dtype == bf16 and all(
            v.dtype == torch.float32 and bool(torch.isfinite(v).all())
            for v in p_loss.values()), f"{name} bf16 G step outputs")
        rep = {"pose": drift(p_pose, r_pose),
               "total": drift(p_loss["total"], r_loss["total"])}
        gaps, _ = g_moment_gaps(r_state, p_state)
        rep.update({f"mu {m}": v for m, v in gaps.items()})
        train16[name] = rep
    fails = []
    for key, dq in train16["unfused"].items():
        dp = train16["fused"][key]
        if abs(dp - dq) > BF16_REL * dq + BF16_ABS:
            fails.append(key)
    log(f"[bf16-train] full width G step bs{B} T{T}, drift from the f32 G "
        f"step, fused (K3 bf16) / unfused: "
        + ", ".join(f"{k} {train16['fused'][k]:.4e}/{v:.4e}"
                    for k, v in train16["unfused"].items())
        + f"; K3 bf16 launches {k3_counts()}")
    check(not fails, f"fused bf16 G step breaks the bf16 rule against the "
          f"unfused one on {fails}")
    fused16 = facs["fused"]
    s16 = g_out["fused"][0]
    s16, l_d, _ = fused16.make_steps()["d"](s16, batch)
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(v).all()) for v in l_d.values()),
          "bf16 D step losses not finite")
    coins = np.random.default_rng(args.seed + 8).random(SCAN_K) < \
        fused16.cfg.d_prob
    n_g = int((~coins).sum())
    stacked = train_batch(trng, B, T, k=SCAN_K)
    s16, l_scan, poses = fused16.make_scan_train_step(SCAN_K)(s16, stacked,
                                                              coins)
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(v).all()) for v in l_scan.values())
          and poses.dtype == bf16, "bf16 k-step driver outputs")
    k3_16_launches = k3_counts()                    # bf16 training ends
    check(k3_16_launches == (1 + n_g, 1 + n_g),
          f"K3 bf16 launches {k3_16_launches} over the bf16 training path, "
          f"expected one each per fused G step ({1 + n_g})")
    log(f"[bf16-train] D step and make_scan_train_step({SCAN_K}) with coins "
        f"{''.join('D' if c else 'G' for c in coins)}: losses finite (last "
        f"total {float(l_scan['total'][-1]):.5f}); K3 bf16 launches over the "
        f"bf16 training path {k3_16_launches}")

    # 17. bf16 timings -----------------------------------------------------
    audio_dev = torch.as_tensor(audio, device=device)
    styles_dev = torch.as_tensor(styles, device=device)
    calls = {"f32": serve32, "bf16": serve16}
    for fn in calls.values():          # first calls of a shape pick cuDNN
        for _ in range(20):            # algorithms: keep them out of turns
            fn(audio_dev, styles_dev)
    turns = {name: [] for name in calls}
    for name in ["f32", "bf16", "bf16", "f32"]:
        turns[name].append(cuda_ms(torch, lambda: calls[name](
            audio_dev, styles_dev), reps=20))
    call_t = {k: float(np.mean(v)) for k, v in turns.items()}
    clip, clip_style = audio[:1], styles[:1]
    p50 = {name: [] for name in calls}
    for name in ["f32", "bf16", "bf16", "f32"]:
        lat = []
        for i in range(30):
            t0 = time.perf_counter()
            calls[name](clip, clip_style).cpu()
            if i >= 5:
                lat.append((time.perf_counter() - t0) * 1e3)
        p50[name].append(float(np.percentile(lat, 50)))
    log(f"[timing] {smi}: bs{B} serving call, ABBA turns: f32 "
        f"{call_t['f32']:.3f} ms ({B * T / call_t['f32'] * 1e3:.1f} pose "
        f"frames/s; turns {turns['f32']}), bf16 {call_t['bf16']:.3f} ms "
        f"({B * T / call_t['bf16'] * 1e3:.1f} frames/s; turns "
        f"{turns['bf16']}); clip p50 (host in, host out) f32 {p50['f32']} "
        f"ms, bf16 {p50['bf16']} ms")
    dbatch = {k: (tuple(torch.as_tensor(a, device=device) for a in v)
                  if k == "x" else torch.as_tensor(v, device=device))
              for k, v in batch.items()}
    dstacked = {k: (tuple(torch.as_tensor(a, device=device) for a in v)
                    if k == "x" else torch.as_tensor(v, device=device))
                for k, v in stacked.items()}
    tfacs = {"f32": StepFactory(StepConfig(**TRAIN_CFG, fused_decoder=True)),
             "bf16": fused16}
    tstates = {"f32": tfacs["f32"].init(seed=args.seed + 7), "bf16": s16}
    tturns = {name: dict(g=[], d=[], scan=[]) for name in tfacs}
    for name, fac in tfacs.items():    # warm-up outside the turns
        for _ in range(3):
            fac.make_steps()["g"](tstates[name], dbatch)
            fac.make_steps()["d"](tstates[name], dbatch)
    for name in ["f32", "bf16", "bf16", "f32"]:
        fac, st = tfacs[name], tstates[name]
        steps, run_k = fac.make_steps(), fac.make_scan_train_step(SCAN_K)
        rec = tturns[name]
        rec["g"].append(cuda_ms(torch, lambda: steps["g"](st, dbatch),
                                reps=10))
        rec["d"].append(cuda_ms(torch, lambda: steps["d"](st, dbatch),
                                reps=10))
        rec["scan"].append(cuda_ms(torch, lambda: run_k(st, dstacked, coins),
                                   reps=3, warmup=1) / SCAN_K)
    train_t = {}
    for name, rec in tturns.items():
        mean = {k: float(np.mean(v)) for k, v in rec.items()}
        train_t[name] = dict(g_step_ms=mean["g"], d_step_ms=mean["d"],
                             scan_step_ms=mean["scan"],
                             frames_per_s=B * T / (mean["scan"] / 1e3),
                             turns=rec)
        log(f"[timing] {smi}: training, fused decoder, {name}, bs{B} T{T}, "
            f"ABBA turns: G step {mean['g']:.3f} ms {rec['g']}, D step "
            f"{mean['d']:.3f} ms {rec['d']}, make_scan_train_step({SCAN_K}) "
            f"mean step {mean['scan']:.3f} ms {rec['scan']} = "
            f"{train_t[name]['frames_per_s']:.1f} train pose frames/s")
    entries = []
    main_shapes = ("decoder", "classifier")
    for s_ in main_shapes:
        rec = k1_16[s_]
        a = rec.pop("args")
        g = rec["shape"]["G"]
        packed = pack_decoder_bf16(dict(w0=a[1], wc=a[2], w_logits=a[4]))
        with torch.no_grad():            # weights packed once, as served
            rec["ms"] = cuda_ms(torch, lambda: fused_mixstage_decoder(
                *a, groups=g, packed=packed))
            rec["plain_ms"] = cuda_ms(
                torch, lambda: fused_mixstage_decoder_plain(*a, groups=g),
                reps=5)
        sh = rec["shape"]
        rec["flops"], rec["bytes"] = k1_work(sh["B"], sh["T"], g, sh["L"],
                                             sh["F"], act_bytes=2)
    for rec in k1_16.values():
        rec.pop("args", None)
    flops = sum(k1_16[s_]["flops"] for s_ in main_shapes)
    nbytes = sum(k1_16[s_]["bytes"] for s_ in main_shapes)
    bms, by = bound_ms(3 * flops, nbytes, PEAK_BF16_FLOPS)
    tf32x2_ms, _ = bound_ms(2 * flops, nbytes, PEAK_TF32_FLOPS)
    ms = sum(k1_16[s_]["ms"] for s_ in main_shapes)
    plain_ms = sum(k1_16[s_]["plain_ms"] for s_ in main_shapes)
    for s_ in main_shapes:
        rec = k1_16[s_]
        rec["bound_ms"] = bound_ms(3 * rec["flops"], rec["bytes"],
                                   PEAK_BF16_FLOPS)[0]
    log(f"[timing] {smi}: K1 bf16 mode per bs{B} call (decoder "
        f"{k1_16['decoder']['ms']:.4f}, bound "
        f"{k1_16['decoder']['bound_ms']:.4f} + classifier "
        f"{k1_16['classifier']['ms']:.4f}, bound "
        f"{k1_16['classifier']['bound_ms']:.4f}): {ms:.4f} ms "
        f"({flops / (ms / 1e3) / 1e12:.2f} TFLOP/s of f32-equivalent work), "
        f"plain {plain_ms:.4f} ms, bound {bms:.4f} ms by {by} (3 bf16 MMAs "
        f"a multiply-add; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB); "
        f"2xTF32 bound {tf32x2_ms:.4f} ms")
    entries.append({
        "name": "fused_mixstage_decoder_bf16", "mode": "bf16",
        "route": "cuda",
        "source": "mixstage_tpu_torch/ops/cuda/csrc/fused_decoder_wgmma.cu",
        "replaces": "mixstage_tpu/ops/pallas/fused_conv.py:179",
        "launches": launches16[1],
        "max_abs_err": max(r["max_abs_err"] for r in k1_16.values()),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
        "library_ms": None, "mma": "wgmma-bf16x3",
        "tf32x2_bound_ms": tf32x2_ms,
        "max_ulps": max(r["max_ulps"] for r in k1_16.values()),
        "max_differing": max(r["differing"] for r in k1_16.values())})
    (f_flops, f_bytes), (b_flops, b_bytes) = k3_work(
        B, T, MODEL["num_clusters"], F_POSE, elem=2)
    main = k3_16["bs32"]
    for name, fn, plain_fn, args_, flops, nbytes, line, err, count in (
            ("decoder_train_fwd", td.decoder_train_fwd,
             td.decoder_train_fwd_plain, main["fwd_args"], f_flops, f_bytes,
             126, max(r["fwd_err"] for r in k3_16.values()),
             k3_16_launches[0]),
            ("decoder_train_bwd", td.decoder_train_bwd,
             td.decoder_train_bwd_plain, main["bwd_args"], b_flops, b_bytes,
             284, max(r["bwd_err"] for r in k3_16.values()),
             k3_16_launches[1])):
        ms = cuda_ms(torch, lambda: fn(*args_), reps=10)
        plain_ms = cuda_ms(torch, lambda: plain_fn(*args_), reps=5)
        bms, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
        log(f"[timing] {smi}: K3 {name} bf16 mode bs{B}: {ms:.4f} ms "
            f"({flops / (ms / 1e3) / 1e12:.2f} TFLOP/s), plain "
            f"{plain_ms:.4f} ms, bound {bms:.4f} ms by {by} (dense bf16 "
            f"tensor cores; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
        entries.append({
            "name": f"{name}_bf16", "mode": "bf16", "route": "cuda",
            "source": "mixstage_tpu_torch/ops/cuda/csrc/train_decoder.cu",
            "replaces": f"mixstage_tpu/ops/pallas/train_decoder.py:{line}",
            "launches": count, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None, "mma": "wgmma-bf16"})
    for rec in k3_16.values():
        rec.pop("fwd_args")
        rec.pop("bwd_args")
    results["bf16"] = dict(
        k1=k1_16, k3=k3_16, serving_drift=drift16, serving_launches=counts,
        server_differing=ndiff, train_drift=train16,
        k3_launches=k3_16_launches, coins=coins.tolist(),
        timing=dict(call_ms=call_t, turns=turns, clip_p50_ms=p50,
                    frames_per_s={k: B * T / v * 1e3
                                  for k, v in call_t.items()},
                    train=train_t))
    return entries


def install_h5py_stand_in() -> None:
    """Make ``import h5py`` give a stand-in holding each "h5" file as a
    numpy archive (``np.savez``) behind the part of h5py's ``File`` API the
    port's data layer calls: open in "r" / "a", ``key in``, ``[key][()]``,
    ``create_dataset``, ``del``, ``close`` and the context manager; a key
    names its groups too.  For a machine without h5py only: the lifecycle
    then runs, but no real HDF5 file is read or written."""
    import types

    class Dataset:
        def __init__(self, arr):
            self._arr = arr
            self.shape, self.dtype = arr.shape, arr.dtype

        def __getitem__(self, index):
            return self._arr[index]

    class File:
        def __init__(self, name, mode="r"):
            self.name, self.mode, self._dirty = str(name), mode, False
            self._data = {}
            if os.path.exists(self.name):
                with np.load(self.name, allow_pickle=False) as z:
                    self._data = {k: z[k] for k in z.files}
            elif mode == "r":
                raise FileNotFoundError(self.name)
            else:
                self._dirty = True

        def __contains__(self, key):
            key = key.strip("/")
            return key in self._data or any(k.startswith(key + "/")
                                            for k in self._data)

        def __getitem__(self, key):
            return Dataset(self._data[key.strip("/")])

        def __delitem__(self, key):
            key = key.strip("/")
            for k in [k for k in self._data
                      if k == key or k.startswith(key + "/")]:
                del self._data[k]
            self._dirty = True

        def create_dataset(self, key, data):
            arr = np.asarray(data)
            self._data[key.strip("/")] = (arr.astype(str)
                                          if arr.dtype == object else arr)
            self._dirty = True

        def close(self):
            if self._dirty and self.mode != "r":
                with open(self.name, "wb") as f:
                    np.savez(f, **self._data)
            self._dirty = False

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            self.close()

    mod = types.ModuleType("h5py")
    mod.File, mod.Dataset = File, Dataset
    mod.special_dtype = lambda vlen=None: object
    sys.modules["h5py"] = mod


def lifecycle_phase(torch, args, smi, results):
    """Phase 20: ``cli.train`` → checkpoint → ``cli.sample`` (style
    transfer) at full width, with the training decoder on K3, in f32 and
    bf16.  Returns K3's launches on this path per mode, (fwd, bwd), and
    the experiments phase 21 serves: each mode's weights file, the data
    and the phase's directory (the caller removes it)."""
    import importlib.util
    import shutil
    from pathlib import Path

    if importlib.util.find_spec("h5py") is None:
        log("[lifecycle] h5py: not installed on this machine; the PATS h5 "
            "files of this phase go through chip_smoke's stand-in (numpy "
            "archives behind h5py's File API): the lifecycle runs, real "
            "HDF5 I/O is not exercised here")
        install_h5py_stand_in()
        results["lifecycle_h5py"] = "stand-in"
    from mixstage_tpu_torch.bookkeeping import weights_of
    from mixstage_tpu_torch.cli import sample as cli_sample
    from mixstage_tpu_torch.cli import train as cli_train
    from mixstage_tpu_torch.data.common import SPEAKERS
    from mixstage_tpu_torch.data.dataset import DataLoader
    from mixstage_tpu_torch.data.hdf5 import HDF5
    from mixstage_tpu_torch.data.synthetic import make_synthetic_dataset
    from mixstage_tpu_torch.ops.bucketing import next_pow2, pad_repeat_last
    from mixstage_tpu_torch.ops.cuda import train_decoder as td
    from mixstage_tpu_torch.train.trainer import Trainer

    root = Path(__file__).resolve().parent / "build" / "lifecycle"
    shutil.rmtree(root, ignore_errors=True)
    data = str(root / "data")
    speakers = SPEAKERS[:MODEL["num_speakers"]]
    t0 = time.perf_counter()
    make_synthetic_dataset(data, speakers, LIFE_INTERVALS,
                           seed=11212 + args.seed)
    log(f"[lifecycle] synthetic PATS data: {len(speakers)} speakers x "
        f"{LIFE_INTERVALS} intervals of 25 s in "
        f"{time.perf_counter() - t0:.1f} s")
    # the trainers cli.train and cli.sample build, and their wall times
    seen = {"train": [], "sample": []}
    orig = {name: getattr(Trainer, name) for name in seen}

    def keep(name):
        def run(self, exp_num):
            t = time.perf_counter()
            orig[name](self, exp_num)
            seen[name].append((self, time.perf_counter() - t))
        return run

    out, launches, ckpts = {}, {}, {}
    for dtype, steps in LIFE_STEPS.items():
        save = str(root / f"save_{dtype}")
        prof = root / f"profile_{dtype}"
        argv = ["-path2data", data, "-speaker", json.dumps(speakers),
                "-model", "JointLateClusterSoftStyle4_G", "-gan", "1",
                "-loss", "L1Loss", "-num_clusters",
                str(MODEL["num_clusters"]), "-batch_size", str(B),
                "-fused_decoder", "1", "-num_epochs", "2", "-window_hop",
                "5", "-debug", str(steps), "-num_iters", "2", "-save_dir",
                save, "-exp", "1", "-seed", str(11212 + args.seed),
                "-dtype", dtype, "-profile_dir", str(prof)]
        for name in seen:
            seen[name].clear()
            setattr(Trainer, name, keep(name))
        try:
            td.decoder_train_fwd.launches = 0     # lifecycle path starts
            td.decoder_train_bwd.launches = 0
            td.decoder_train_fwd.launches_bf16 = 0
            td.decoder_train_bwd.launches_bf16 = 0
            t = time.perf_counter()
            cli_train.main(argv)
            torch.cuda.synchronize()
            cli_wall = time.perf_counter() - t
            k3 = (td.decoder_train_fwd.launches,    # lifecycle path ends
                  td.decoder_train_bwd.launches)
            k3_bf16 = (td.decoder_train_fwd.launches_bf16,
                       td.decoder_train_bwd.launches_bf16)
            trainer, train_s = seen["train"][0]
            _, final_sample_s = seen["sample"][0]
            weights = trainer.book.name("weights", "p", save)
            ckpts[dtype] = weights
            t = time.perf_counter()
            cli_sample.main(["-load", weights, "-path2data", data])
            torch.cuda.synchronize()
            sample_wall = time.perf_counter() - t
            sampler, sample_s = seen["sample"][1]
        finally:
            for name, fn in orig.items():
                setattr(Trainer, name, fn)
        g_steps = trainer.state.g_step
        check(g_steps > 0, f"[{dtype}] the lifecycle ran no G step")
        check(k3 == (g_steps, g_steps) and k3_bf16 == (
            k3 if dtype == "bfloat16" else (0, 0)),
            f"[{dtype}] K3 launches (all, bf16 mode) {k3}, {k3_bf16} over "
            f"the lifecycle, expected one each way per G step ({g_steps}) "
            f"in the {dtype} mode")
        check(trainer.step_cfg.fused_decoder and
              trainer.device.type == "cuda" and
              trainer.step_cfg.dtype == getattr(torch, dtype),
              f"[{dtype}] trainer config")
        # K3's kernels under torch.profiler (-profile_dir, first epoch)
        traces = sorted(prof.glob("*.json"))
        check(len(traces) == 1, f"[{dtype}] {len(traces)} profiler traces")
        with open(traces[0]) as f:
            events = json.load(f)["traceEvents"]
        names = [e["name"] for e in events if e.get("cat") == "kernel"]
        prof_k3 = {k: sum(k in n for n in names)
                   for k in ("wgmma_gemm_kernel", "pack_kernel")}
        check(all(v > 0 for v in prof_k3.values()),
              f"[{dtype}] K3 kernels under torch.profiler: {prof_k3}")
        # the experiment's files, its losses
        prefix = trainer.book.name.prefix
        files = {f[len(prefix) + 1:] for f in os.listdir(save)
                 if f.startswith(prefix + "_")}
        check(LIFE_FILES <= files, f"[{dtype}] PREFIX files {sorted(files)}")
        with open(trainer.book.name("res", "json", save)) as f:
            res = json.load(f)
        for key in ("train", "dev", "test"):
            check(bool(np.isfinite(res[key]).all()),
                  f"[{dtype}] {key} losses {res[key]}")
        kp_style = sorted((Path(sampler.dir_name) / "keypoints_style")
                          .rglob("*.h5"))
        check(len(kp_style) == len(speakers) * LIFE_INTERVALS,
              f"[{dtype}] {len(kp_style)} style-transfer keypoint files")
        # cli.sample restored the trained weights, bit for bit
        w_train, w_sample = weights_of(trainer.state), weights_of(
            sampler.state)
        check(all(torch.equal(v, w_sample[m][k])
                  for m in w_train for k, v in w_train[m].items()),
              f"[{dtype}] cli.sample's weights differ from the trained ones")
        # one sampled interval against a direct eval step on its batch
        md = sampler.data.datasets["test"].datasets[0]
        batch = next(iter(DataLoader(md, batch_size=len(md))))
        sb, y_, ins = sampler.get_processed_batch(batch)
        pad = next_pow2(len(md))

        def flat(v):
            v = pad_repeat_last(np.asarray(v), pad)
            return v.reshape(1, -1, *v.shape[2:])
        fb = {k: tuple(flat(a) for a in v) if k == "x" else flat(v)
              for k, v in sb.items()}
        _, pose, _ = sampler.steps["eval"](sampler.state, fb,
                                           sample_flag=True)
        y_cap = pose.float().cpu().numpy().astype(np.float64).reshape(
            pad, y_.shape[1], -1)[:len(md)]
        want = sampler.calculate_metrics(y_cap, y_, "same", insert=ins,
                                         style=sb["style"])
        iid = batch["meta"]["interval_id"][0]
        got = HDF5.load_array(
            str(Path(sampler.dir_name) / "keypoints" / "test"
                / sampler.data.getSpeaker(iid) / f"{iid}.h5"), "pose/data")
        check(got.shape == want.shape and bool(np.array_equal(got, want)),
              f"[{dtype}] interval {iid}'s sampled keypoints differ from a "
              f"direct eval step: max |diff| "
              f"{float(np.abs(got - want).max()):.3e}")
        sps = res["train_steps_per_sec"]
        log(f"[lifecycle] {dtype}: cli.train (fused decoder, {B}-window "
            f"batches, 2 epochs of {steps + 1} steps, -debug {steps}) + "
            f"cli.sample: K3 launches (fwd, bwd) {k3} = {g_steps} G steps "
            f"(bf16 mode {k3_bf16}); under torch.profiler in epoch 0 "
            f"{prof_k3}; losses finite; PREFIX files "
            f"{sorted(LIFE_FILES)} present; {len(kp_style)} style-transfer"
            f" keypoint files; cli.sample's weights equal the trained ones "
            f"bit for bit; interval {iid}'s keypoints equal a direct eval "
            f"step")
        log(f"[lifecycle] {smi}: {dtype}: train_steps_per_sec "
            f"{sps[0]:.3f} (epoch 0, profiled), {sps[1]:.3f} (epoch 1); "
            f"Trainer.train {train_s:.2f} s, its final Trainer.sample "
            f"{final_sample_s:.2f} s, cli.train {cli_wall:.2f} s in all "
            f"(the k-means fit, ZNorm and model set-up included); "
            f"cli.sample {sample_wall:.2f} s (Trainer.sample "
            f"{sample_s:.2f} s: {len(speakers) * LIFE_INTERVALS} intervals"
            f" x 2 styles)")
        launches[dtype] = k3
        out[dtype] = dict(k3_launches=k3, g_steps=g_steps,
                          profiled_k3=prof_k3, steps_per_sec=sps,
                          train_s=train_s, final_sample_s=final_sample_s,
                          cli_train_s=cli_wall, cli_sample_s=sample_wall,
                          sample_s=sample_s,
                          res={k: res[k] for k in ("train", "dev", "test")})
    results["lifecycle"] = out
    return launches, dict(ckpts, data=data, root=root)


def serving_cli_phase(torch, args, smi, results, exps) -> dict:
    """Phase 21: the serving entry points on phase 20's experiments (the
    flagship at full width, f32 and bf16 checkpoints, the same data through
    the same stand-in h5py where the machine has none): ``cli.serve``'s
    ``build`` on ``-load`` (f32, bf16, ``-serve_int8 1`` on both, a
    ``log_mel_400`` view of the f32 checkpoint for the waveform endpoint),
    ``cli.export`` with both variants and ``cli.serve -export_dir``.
    Returns the launches of K1, K1-bf16, K4 and K4-bf16 over the phase's
    servers and the artifact, by kernel name."""
    from mixstage_tpu_torch.cli import export as cli_export
    from mixstage_tpu_torch.cli import serve as cli_serve
    from mixstage_tpu_torch.config import (_typed_flag_names,
                                           config_from_dict, get_args_perm)
    from mixstage_tpu_torch.data.synthetic import append_log_mel_400
    from mixstage_tpu_torch.export import load_serving
    from mixstage_tpu_torch.models import JointLateClusterSoftStyle4_G
    from mixstage_tpu_torch.ops.cuda.fused_conv import \
        fused_mixstage_decoder as k1
    from mixstage_tpu_torch.ops.cuda.quant import \
        fused_mixstage_decoder_int8 as k4
    from mixstage_tpu_torch.serve import (build_serving_fn,
                                          build_waveform_serving_fn)
    from mixstage_tpu_torch.serving import PoseClient
    from mixstage_tpu_torch.streaming import session_over_serving_fn
    from mixstage_tpu_torch.train.trainer import Trainer

    data, root = exps["data"], exps["root"]
    S = MODEL["num_speakers"]
    onehot = np.eye(S, dtype=np.float32)
    rng = np.random.default_rng(args.seed + 21)
    soft = rng.dirichlet(np.ones(S)).astype(np.float32)
    modal400 = ["-modalities", '["pose/data", "audio/log_mel_400"]']

    def cli_args(argv):
        """A ``Config`` as ``argparse_n_loop`` hands it to a CLI's loop."""
        _, perms = get_args_perm(argv)
        cfg = config_from_dict(perms[0])
        cfg.typed_flags = _typed_flag_names(argv)
        return cfg

    def restored(weights, *extra):
        return Trainer(cli_args(["-load", weights, "-path2data", data,
                                 *extra]),
                       ["exp", "cpk", "speaker", "model", "note"],
                       {"window_hop": 0, "render": 0})

    def tiled(fn, a, rows):
        """``fn`` on one request, run as the batcher runs it: tiled to the
        server's batch."""
        out = fn(np.repeat(a[None], B, axis=0),
                 np.repeat(rows[None], B, axis=0))
        return out[0].float().cpu().numpy()

    def drive(tag, argv, mel=MEL, frames=(64, 100), wave_n=0, p50=True):
        """A server from ``cli.serve``'s ``build`` on port 0, its kernel
        counters set to 0 just before its requests and read just after:
        a JSON request (id), an npz one (soft row), a 150-frame stream
        (hop 32), a waveform request of ``wave_n`` samples, and the p50 of
        50 npz 64-frame clips after 10 warm-up ones."""
        server, batchers = cli_serve.build(cli_args(
            [*argv, "-serve_port", "0"]))
        reqs = [("json", rng.normal(size=(frames[0], mel)), 3),
                ("npz", rng.normal(size=(frames[-1], mel)), soft)]
        stream_x = rng.normal(size=(150, mel)).astype(np.float32)
        wav = (0.1 * rng.normal(size=wave_n)).astype(np.float32)
        try:
            client = PoseClient(
                f"http://127.0.0.1:{server.server_address[1]}",
                timeout_s=600)
            for b in batchers:
                b.batches = 0
            k1.launches = k1.launches_bf16 = 0          # this path starts
            k4.launches = k4.launches_bf16 = 0
            got = [(client.pose if kind == "npz" else client.pose_json)(
                a.astype(np.float32), style=sty) for kind, a, sty in reqs]
            stream = client.stream(style=5, hop=32)
            parts = [stream.feed(stream_x[i:i + 40])
                     for i in range(0, 150, 40)]
            parts.append(stream.finish())
            got_stream = np.concatenate([q for q in parts if q.size])
            got_wav = (client.pose_from_waveform(wav, style=2)
                       if wave_n else None)
            lat = []
            clip = rng.normal(size=(64, mel)).astype(np.float32)
            for i in range(60 if p50 else 0):
                t0 = time.perf_counter()
                client.pose(clip, style=1)
                if i >= 10:
                    lat.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            n = (k1.launches, k1.launches_bf16, k4.launches,
                 k4.launches_bf16)                         # this path ends
            batches = [b.batches for b in batchers]
            health = client.health()
        finally:
            server.shutdown()
            server.server_close()
            for b in batchers:
                b.close()
        check(health["backend"] == "cuda" and health["batch_size"] == B,
              f"[{tag}] healthz {health}")
        return dict(reqs=reqs, got=got, stream_x=stream_x,
                    got_stream=got_stream, wav=wav, got_wav=got_wav,
                    counts=n, batches=batches,
                    p50=float(np.percentile(lat, 50)) if lat else None)

    def served_errors(tag, run, fn, tol):
        """max |served - direct| / max |direct| over the JSON, npz and
        stream responses, ``fn`` called directly at the server's batch;
        held to ``tol`` (0: bit for bit)."""
        errs = []
        for (kind, a, sty), got in zip(run["reqs"], run["got"]):
            n = a.shape[0]
            bucket = 64 if n <= 64 else 128
            a = a.astype(np.float32)
            padded = np.concatenate([a, np.repeat(a[-1:], bucket - n, 0)])
            rows = onehot[sty] if np.ndim(sty) == 0 else sty
            want = tiled(fn, padded, rows)[:n]
            check(got.shape == want.shape, f"[{tag}] {kind} {got.shape}")
            errs.append(float(np.abs(got - want).max())
                        / float(np.abs(want).max()))
        sess = session_over_serving_fn(
            lambda w, s: tiled(fn, w[0], s[0])[None], onehot[5], hop=32)
        want = np.concatenate([q for q in (sess.feed(run["stream_x"]),
                                           sess.finish()) if q.size])
        check(run["got_stream"].shape == want.shape,
              f"[{tag}] stream {run['got_stream'].shape}")
        errs.append(float(np.abs(run["got_stream"] - want).max())
                    / float(np.abs(want).max()))
        check(max(errs) <= tol, f"[{tag}] served poses differ from the "
              f"direct call: {errs} (tol {tol:g})")
        return errs

    out, served = {}, {}
    w32, w16 = exps["float32"], exps["bfloat16"]
    tr32, tr16 = restored(w32), restored(w16)
    model32, model16 = tr32.state.gen, tr16.state.gen
    check(model16.dtype == torch.bfloat16, "bf16 checkpoint's dtype")
    direct = {"f32": build_serving_fn(model32),
              "bf16": build_serving_fn(model16),
              "int8": build_serving_fn(
                  model32, quantize_int8=True,
                  calib=cli_serve._calib_windows(tr32, 8)),
              "int8_bf16": build_serving_fn(
                  model16, quantize_int8=True,
                  calib=cli_serve._calib_windows(tr16, 8))}
    # the f32 truth of the bf16 checkpoint's weights, for the int8-bf16 drift
    model16_f32 = JointLateClusterSoftStyle4_G(**MODEL)
    model16_f32.load_state_dict(model16.state_dict())
    truth = {"int8": direct["f32"], "int8_bf16": build_serving_fn(
        model16_f32)}
    modes = {  # mode: (argv, expected (K1, K1-bf16, K4, K4-bf16) per batch)
        "f32": (["-load", w32, "-path2data", data], (2, 0, 0, 0)),
        "bf16": (["-load", w16, "-path2data", data], (2, 2, 0, 0)),
        "int8": (["-load", w32, "-path2data", data, "-serve_int8", "1"],
                 (1, 0, 1, 0)),
        "int8_bf16": (["-load", w16, "-path2data", data, "-serve_int8", "1"],
                      (1, 1, 1, 1))}
    t_phase = time.perf_counter()
    for mode, (argv, per_batch) in modes.items():
        run = drive(mode, argv)
        nb = run["batches"][0]
        want_n = tuple(k * nb for k in per_batch)
        check(run["counts"] == want_n, f"[{mode}] launches (K1, K1-bf16, "
              f"K4, K4-bf16) {run['counts']} over {nb} batches, expected "
              f"{want_n}")
        tol = 0.0 if mode.startswith("int8") else 1e-6
        errs = served_errors(mode, run, direct[mode], tol)
        rec = dict(counts=run["counts"], batches=nb, served_errs=errs,
                   clip_p50_ms=run["p50"])
        msg = ""
        if mode in truth:
            a = rng.normal(size=(B, T, MEL)).astype(np.float32)
            ids = rng.integers(0, S, size=B)
            d = drift(direct[mode](a, ids), truth[mode](a, ids))
            check(INT8_DRIFT[0] < d < INT8_DRIFT[1],
                  f"[{mode}] drift from f32 {d:.3e} outside {INT8_DRIFT}")
            rec["drift_vs_f32"] = d
            msg = f"; drift from f32 serving {d:.4e} (in {INT8_DRIFT})"
        log(f"[serve-cli] {mode}: cli.serve -load ({B}-clip batches): "
            f"JSON + npz + 150-frame stream equal the direct call at bs{B}: "
            f"max|diff|/max|pose| {max(errs):.3e} (tol {tol:g}); launches "
            f"(K1, K1-bf16, K4, K4-bf16) {run['counts']} over {nb} "
            f"batches{msg}")
        out[mode] = rec

    # the waveform endpoint: the f32 checkpoint read as a log_mel_400 model
    # (its generator is mel-agnostic), on a 64-mel view of the same data
    append_log_mel_400(data, seed=args.seed + 21)
    wave_fn = build_waveform_serving_fn(model32)
    run = drive("waveform", ["-load", w32, "-path2data", data, *modal400],
                mel=MEL_WAVE, frames=(64,), wave_n=wave_fn.n_samples + 800,
                p50=False)
    nb = sum(run["batches"])
    check(len(run["batches"]) == 2 and run["counts"] == (2 * nb, 0, 0, 0),
          f"[waveform] batches {run['batches']}, launches {run['counts']}")
    errs = served_errors("waveform", dict(run, reqs=run["reqs"][:1],
                                          got=run["got"][:1]),
                         direct["f32"], 1e-6)
    want = tiled(wave_fn, run["wav"], onehot[2])
    wave_err = float(np.abs(run["got_wav"] - want).max()) \
        / float(np.abs(want).max())
    check(wave_err <= 1e-6, f"[waveform] served {wave_err:.3e}")
    log(f"[serve-cli] waveform: cli.serve -load on audio/log_mel_400: "
        f"/v1/pose_from_waveform ({run['wav'].shape[0]} samples) equals the "
        f"direct call: max|diff|/max|pose| {wave_err:.3e}; mel requests "
        f"{max(errs):.3e}; K1 launches {run['counts'][0]} over {nb} batches")
    out["waveform"] = dict(counts=run["counts"], batches=nb,
                           served_err=wave_err)

    # cli.export (both variants, on the card) → load_serving → -export_dir
    art = str(root / "artifact")
    t0 = time.perf_counter()
    cli_export.loop(cli_args(["-load", w32, "-path2data", data,
                              "-export_dir", art, "-export_variants",
                              "plain,kernel"]), 0)
    export_s = time.perf_counter() - t0
    h5py_mod = sys.modules.get("h5py")
    sys.modules["h5py"] = None          # the artifact needs no data
    try:
        fk, fp = load_serving(art), load_serving(art, prefer="plain")
        check(fk.variant == "kernel" and fp.variant == "plain" and
              fk.device.type == fp.device.type == "cuda", "artifact variants")
        a = rng.normal(size=(B, T, MEL)).astype(np.float32)
        ids = rng.integers(0, S, size=B)
        k1.launches = 0                               # kernel variant starts
        pose_k = fk(a, ids)
        torch.cuda.synchronize()
        n_kernel = k1.launches                        # kernel variant ends
        k1.launches = 0                               # plain variant starts
        pose_p = fp(a, ids)
        torch.cuda.synchronize()
        n_plain = k1.launches                         # plain variant ends
        check(n_kernel == 2 and n_plain == 0, f"K1 launches under the "
              f"kernel / plain programs {n_kernel} / {n_plain}, expected "
              f"2 / 0")
        plain32 = build_serving_fn(model32, use_kernel=False)
        err_k = rel_fro(pose_k, direct["f32"](a, ids))
        ref_p = plain32(a, ids)
        err_p = float((pose_p - ref_p).abs().max() / ref_p.abs().max())
        check(err_k <= 1e-5 and err_p <= 1e-6, f"artifact against the "
              f"direct calls: kernel {err_k:.3e} (tol 1e-5, relative "
              f"Frobenius), plain {err_p:.3e} (tol 1e-6 of max |pose|)")
        log(f"[serve-cli] cli.export (plain, kernel) in {export_s:.1f} s; "
            f"load_serving picks {fk.variant} on the card; bs{B}: kernel "
            f"program vs the direct K1 call {err_k:.3e} relative Frobenius "
            f"(K1 launches {n_kernel}), plain program (moved to the card) "
            f"vs the plain route {err_p:.3e} of max |pose| (K1 launches "
            f"{n_plain})")
        run = drive("export_dir", ["-export_dir", art], frames=(64,))
        nb = run["batches"][0]
        check(run["counts"] == (2 * nb, 0, 0, 0),
              f"[export_dir] launches {run['counts']} over {nb} batches")
        errs = served_errors("export_dir", run, fk, 1e-6)
        log(f"[serve-cli] export_dir: cli.serve -export_dir (no checkpoint, "
            f"no data, h5py blocked): JSON + npz + stream equal the kernel "
            f"program at bs{B}: {max(errs):.3e}; K1 launches "
            f"{run['counts'][0]} over {nb} batches")
        out["export_dir"] = dict(counts=run["counts"], batches=nb,
                                 served_errs=errs, clip_p50_ms=run["p50"])
        n_artifact = n_kernel + run["counts"][0]
        # bs32 calls in turns (ABBA): the artifact's programs against the
        # direct functions
        a_dev = torch.as_tensor(a, device="cuda")
        i_dev = torch.as_tensor(ids, device="cuda")
        pairs = {"kernel": (lambda: fk(a_dev, i_dev),
                            lambda: direct["f32"](a_dev, i_dev)),
                 "plain": (lambda: fp(a_dev, i_dev),
                           lambda: plain32(a_dev, i_dev))}
        call_ms = {}
        for name, (fa, fb) in pairs.items():
            ta, tb = [], []
            for turn in range(TIMING_TURNS):
                order = (fa, fb) if turn % 2 == 0 else (fb, fa)
                for f in order:
                    (ta if f is fa else tb).append(cuda_ms(torch, f,
                                                           reps=10))
            call_ms[name] = (float(np.mean(ta)), float(np.mean(tb)))
    finally:
        sys.modules["h5py"] = h5py_mod
    out["artifact"] = dict(export_s=export_s, kernel_err=err_k,
                           plain_err=err_p, k1_kernel=n_kernel,
                           k1_plain=n_plain, call_ms=call_ms)
    p50s = {m: out[m]["clip_p50_ms"] for m in (*modes, "export_dir")}
    log(f"[serve-cli] {smi}: p50 of one 64-frame clip over HTTP (npz, "
        f"cli.serve, 5 ms gather window) "
        + ", ".join(f"{m} {v:.3f} ms" for m, v in p50s.items()))
    log(f"[serve-cli] {smi}: bs{B} call, in turns (CUDA events, "
        f"{TIMING_TURNS} ABBA turns of 10): kernel program "
        f"{call_ms['kernel'][0]:.4f} ms against the direct K1 call "
        f"{call_ms['kernel'][1]:.4f} ms; plain program "
        f"{call_ms['plain'][0]:.4f} ms against the plain route "
        f"{call_ms['plain'][1]:.4f} ms; phase 21 in "
        f"{time.perf_counter() - t_phase:.1f} s")
    results["serving_cli"] = out
    served["fused_mixstage_decoder"] = sum(
        out[m]["counts"][0] - out[m]["counts"][1]
        for m in ("f32", "int8", "waveform")) + n_artifact
    served["fused_mixstage_decoder_bf16"] = sum(
        out[m]["counts"][1] for m in ("bf16", "int8_bf16"))
    served["fused_mixstage_decoder_int8"] = out["int8"]["counts"][2]
    served["fused_mixstage_decoder_int8_bf16"] = out["int8_bf16"]["counts"][3]
    log(f"[serve-cli] launches over phase 21 (servers and the artifact): "
        f"{served}")
    return served


def int8_bf16_phases(torch, args, device, smi, model, audio, styles,
                     pose32, results):
    """Phases 18-19: the bf16 modes of K4 (bf16 features) and K2 against
    their plain versions and timed, then the int8 tier on a bf16 model
    through the entry points and the HTTP server (streaming included),
    timed against the int8 tier on the f32 model.  Returns the kernels-line
    entries of K4-bf16 and K2-bf16."""
    from mixstage_tpu_torch.models import JointLateClusterSoftStyle4_G
    from mixstage_tpu_torch.ops.cuda import quant as q8
    from mixstage_tpu_torch.ops.cuda.fused_conv import (
        chain_plain, fused_grouped_conv_chain, fused_mixstage_decoder,
        pack_chain_bf16)
    from mixstage_tpu_torch.serve import build_serving_fn

    bf16 = torch.bfloat16
    G, L, F = MODEL["num_clusters"], 3, MODEL["out_feats"]
    S = MODEL["num_speakers"]
    k4, k2 = q8.fused_mixstage_decoder_int8, fused_grouped_conv_chain

    # 18. K4's bf16-feature mode and K2's bf16 mode -------------------------
    gen = torch.Generator().manual_seed(args.seed + 18)
    _, w0, wc, biases, wl, bl = random_folded(torch, gen, 1, 1, G, L, F,
                                              device)
    qfd = q8.pack_decoder_int8(q8.quantize_folded_decoder(
        dict(w0=w0, wc=wc, biases=biases, w_logits=wl, b_logits=bl),
        torch.randn(B, T, C0, generator=gen).to(device).bfloat16()))
    k4_16 = {}
    for name, (b, t) in K4_SHAPES.items():
        x = torch.randn(b, t, C0, generator=gen).to(device).bfloat16()
        out = k4(x, qfd, groups=G)
        ref = q8.decoder_int8_plain(x, qfd, G)
        torch.cuda.synchronize()
        check(out.dtype == torch.float32 and bool(torch.isfinite(out).all()),
              f"K4-bf16 {name}: dtype {out.dtype} or non-finite")
        mean_rel, max_rel, abs_err, ndiff = int8_errors(out, ref)
        log(f"[bf16-kernel] fused_mixstage_decoder_int8 bf16 features {name}"
            f" B={b} T={t} G={G} C0={C0} C={C} L={L} F={F}: {ndiff} of "
            f"{out.numel()} elements differ from the plain version (tol 0);"
            f" mean|err|/mean|ref| {mean_rel:.3e}")
        check(ndiff == 0, f"K4-bf16 {name}: {ndiff} elements differ from "
              f"the plain version (a bf16 feature widens exactly)")
        k4_16[name] = dict(shape=dict(B=b, T=t, G=G, C0=C0, C=C, L=L, F=F),
                           max_abs_err=abs_err, differing=ndiff, args=x)
    k2_16 = {}
    for name, (b, t, g, c, layers) in K2_SHAPES.items():
        a = (torch.randn(b, t, g * c, generator=gen).to(device).bfloat16(),
             (torch.randn(layers, g, 3, c, c, generator=gen)
              * (3 * c) ** -0.5).to(device),
             (torch.randn(layers, g * c, generator=gen) * 0.1).to(device))
        packed = pack_chain_bf16(a[1])
        out = k2(*a, groups=g, packed=packed)
        ref = chain_plain(*a, groups=g)
        truth = chain_plain(a[0].float(), *a[1:], groups=g)
        torch.cuda.synchronize()
        check(out.dtype == bf16 and bool(torch.isfinite(out).all()),
              f"K2-bf16 {name}: dtype {out.dtype} or non-finite")
        dp, dq, ok = bf16_rule(out, ref, truth)
        ulps, share = bf16_ulps(torch, out, ref)
        abs_err = float((out.float() - ref.float()).abs().max())
        log(f"[bf16-kernel] fused_grouped_conv_chain bf16 {name} B={b} T={t}"
            f" G={g} C={c} L={layers}: drift from f32 {dp:.4e}, plain "
            f"{dq:.4e} (bf16 rule: {'ok' if ok else 'FAIL'}); max|diff| "
            f"{abs_err:.3e} = {ulps:.2f} bf16 ULPs of max|out|, {share:.2%} "
            f"of elements differ")
        check(ok, f"K2-bf16 {name} breaks the bf16 rule: {dp:.4e} vs "
              f"{dq:.4e}")
        check(ulps <= BF16_ULPS and share <= BF16_SHARE,
              f"K2-bf16 {name}: {ulps:.2f} bf16 ULPs, {share:.2%} of elements"
              f" differ from the plain version (limits {BF16_ULPS}, "
              f"{BF16_SHARE:.0%}: a rounding skipped or added)")
        k2_16[name] = dict(shape=dict(B=b, T=t, G=g, C=c, L=layers),
                           drift=dp, plain_drift=dq, max_ulps=ulps,
                           differing=share, max_abs_err=abs_err,
                           args=(a, packed))
    x16 = k4_16["bs32"]["args"]
    x32 = x16.float()
    modes = {"f32": lambda: k4(x32, qfd, groups=G),
             "bf16": lambda: k4(x16, qfd, groups=G)}
    k4_turns = {m: [] for m in modes}
    for m in ["f32", "bf16", "bf16", "f32"]:
        k4_turns[m].append(cuda_ms(torch, modes[m], reps=50))
    for name, rec in k4_16.items():
        x = rec.pop("args")
        rec["ms"] = (float(np.mean(k4_turns["bf16"])) if name == "bs32"
                     else cuda_ms(torch, lambda: k4(x, qfd, groups=G)))
        rec["plain_ms"] = cuda_ms(torch, lambda: q8.decoder_int8_plain(
            x, qfd, G), reps=5)
        sh = rec["shape"]
        ops, nbytes = k4_work(sh["B"], sh["T"], G, L, F, x_bytes=2)
        rec["bound_ms"], rec["bound_by"] = bound_ms(ops, nbytes, PEAK_INT8_OPS)
        log(f"[timing] {smi}: K4-bf16 {name}: {rec['ms']:.4f} ms "
            f"({ops / (rec['ms'] / 1e3) / 1e12:.2f} TOP/s int8), plain "
            f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms by "
            f"{rec['bound_by']} "
            f"({ops / 1e9:.2f} G int8 ops, {nbytes / 1e6:.2f} MB)")
    log(f"[timing] {smi}: K4 bs{B} x {T}, ABBA turns: f32 features "
        f"{np.mean(k4_turns['f32']):.4f} ms {k4_turns['f32']}, bf16 "
        f"features {np.mean(k4_turns['bf16']):.4f} ms {k4_turns['bf16']}")
    for name, rec in k2_16.items():
        (a, packed), g = rec.pop("args"), rec["shape"]["G"]
        k2_timings(torch, smi, f"K2-bf16 {name}", rec, a, packed, g,
                   act_bytes=2)

    # 19. the int8 tier on a bf16 model -------------------------------------
    model16 = JointLateClusterSoftStyle4_G(**MODEL, dtype=bf16)
    model16.load_state_dict(model.state_dict())
    rng = np.random.default_rng(args.seed + 19)
    calib = (rng.normal(size=(B, T, MEL)).astype(np.float32),
             rng.integers(0, S, size=B).astype(np.int32))
    serve816 = build_serving_fn(model16, quantize_int8=True, calib=calib)
    plain816 = build_serving_fn(model16, use_kernel=False,
                                quantize_int8=True, calib=calib)
    check(serve816.dtype == bf16 and serve816.use_kernel and
          serve816.quantize_int8, "int8-bf16 serving fn")

    def counts():
        return (fused_mixstage_decoder.launches,
                fused_mixstage_decoder.launches_bf16, k4.launches,
                k4.launches_bf16, k2.launches, k2.launches_bf16)

    for fn in (fused_mixstage_decoder, k4, k2):      # int8-bf16 path starts
        fn.launches = fn.launches_bf16 = 0
    pose = serve816(audio, styles)
    torch.cuda.synchronize()
    check(counts() == (1, 1, 1, 1, 0, 0), f"one int8-bf16 serving call "
          f"launched (K1, K1-bf16, K4, K4-bf16, K2, K2-bf16) {counts()} "
          f"times, expected (1, 1, 1, 1, 0, 0)")
    check(pose.dtype == torch.float32 and tuple(pose.shape) == (B, T, F)
          and bool(torch.isfinite(pose).all()), "int8-bf16 pose")
    pose_plain = plain816(audio, styles)
    d_k, d_p, ok = bf16_rule(pose, pose_plain, pose32)
    mean_rel, max_rel, _, ndiff = int8_errors(pose, pose_plain)
    log(f"[int8-bf16] full width bs{B} T{T}: drift from the f32 kernel route:"
        f" K1-bf16+K4-bf16 route {d_k:.4e}, plain int8-bf16 route {d_p:.4e}"
        f" (envelope {INT8_DRIFT}; bf16 rule: {'ok' if ok else 'FAIL'}); "
        f"the routes differ in {ndiff} of {pose.numel()} elements, mean "
        f"{mean_rel:.3e}, max {max_rel:.3e} of mean|plain|")
    check(INT8_DRIFT[0] < d_k < INT8_DRIFT[1],
          "int8-bf16 drift out of envelope")
    check(ok, f"int8-bf16 kernel route breaks the bf16 rule against the "
          f"plain route: {d_k:.4e} vs {d_p:.4e}")
    jobs = [("json", 64, 2), ("npz", 64, 5), ("npz", 100, 1)]
    served_diff, _, stream_diff, stats = serve_over_http(
        serve816, rng, jobs, stream_style=6)
    launches = counts()                              # int8-bf16 path ends
    log(f"[int8-bf16-server] {len(jobs)} /v1/pose requests (json, npz; 64 "
        f"and 100 frames): {served_diff} elements differ from the direct "
        f"call at batch {B}; a 150-frame stream over HTTP (chunks of 40, "
        f"hop 32): {stream_diff} differ from StreamingSession over the "
        f"direct call (tol 0); stats requests={stats['requests']} "
        f"batches={stats['batches']} streams={stats['streams']}; (K1, "
        f"K1-bf16, K4, K4-bf16, K2, K2-bf16) launches over the int8-bf16 "
        f"path {launches}")
    check(served_diff == 0, "int8-bf16 served pose differs from direct")
    check(stream_diff == 0, "int8-bf16 streamed pose differs from direct")
    check(stats["streams"] == 0, "the finished stream is still live")
    check(launches[0] == launches[1] == launches[2] == launches[3] and
          launches[3] >= 1 + stats["batches"] and launches[4:] == (0, 0),
          f"launches {launches} over the int8-bf16 path: expected one K1 "
          f"and one K4 launch, both bf16 mode, per serving call and no K2")

    audio_dev = torch.as_tensor(audio, device=device)
    styles_dev = torch.as_tensor(styles, device=device)
    calls = {"int8-f32": build_serving_fn(model, quantize_int8=True,
                                          calib=calib),
             "int8-bf16": serve816}
    for fn in calls.values():          # first calls of a shape pick cuDNN
        for _ in range(20):            # algorithms: keep them out of turns
            fn(audio_dev, styles_dev)
    turns = {name: [] for name in calls}
    for name in ["int8-f32", "int8-bf16", "int8-bf16", "int8-f32"]:
        turns[name].append(cuda_ms(torch, lambda: calls[name](
            audio_dev, styles_dev), reps=20))
    call_t = {k: float(np.mean(v)) for k, v in turns.items()}
    prof = {}
    for name, fn in calls.items():
        prof[name] = trace(torch, lambda: fn(audio_dev, styles_dev))
        top = ", ".join(f"{k['ms_per_call']:.4f} ms x"
                        f"{k['launches_per_call']:g} {kernel_name(k['name'])}"
                        for k in prof[name]["kernels"][:3])
        log(f"[profile] {smi}: {name} bs{B} serving call: device busy "
            f"{prof[name]['device_busy_ms']:.4f} ms, wall "
            f"{prof[name]['wall_ms']:.4f} ms, idle share "
            f"{prof[name]['idle_share']:.3f}, "
            f"{prof[name]['launches_per_call']:g} launches; top: {top}")
    log(f"[timing] {smi}: bs{B} int8 serving call, ABBA turns: f32 model "
        f"{call_t['int8-f32']:.3f} ms ({B * T / call_t['int8-f32'] * 1e3:.1f}"
        f" pose frames/s; turns {turns['int8-f32']}), bf16 model "
        f"{call_t['int8-bf16']:.3f} ms "
        f"({B * T / call_t['int8-bf16'] * 1e3:.1f} frames/s; turns "
        f"{turns['int8-bf16']})")
    for p_ in prof.values():
        p_["kernels"] = p_["kernels"][:8]
    results["int8_bf16"] = dict(
        k4=k4_16, k2=k2_16, k4_turns=k4_turns, drift_kernel=d_k,
        drift_plain=d_p, routes_differing=ndiff, served_differing=served_diff,
        stream_differing=stream_diff, launches=launches,
        timing=dict(call_ms=call_t, turns=turns, profile=prof,
                    frames_per_s={k: B * T / v * 1e3
                                  for k, v in call_t.items()}))
    main4, main2 = k4_16["bs32"], k2_16["main"]
    return [
        {"name": "fused_mixstage_decoder_int8_bf16", "mode": "bf16",
         "route": "cuda",
         "source": "mixstage_tpu_torch/ops/cuda/csrc/decoder_int8.cu",
         "replaces": "mixstage_tpu/ops/pallas/quant.py:266",
         "launches": launches[3],
         "max_abs_err": max(r["max_abs_err"] for r in k4_16.values()),
         "ms": main4["ms"], "plain_ms": main4["plain_ms"],
         "bound_ms": main4["bound_ms"], "bound_by": main4["bound_by"],
         "library_ms": None, "mma": "wgmma-s8"},
        {"name": "fused_grouped_conv_chain_bf16", "mode": "bf16",
         "route": "cuda",
         "source": "mixstage_tpu_torch/ops/cuda/csrc/fused_decoder_wgmma.cu",
         "replaces": "mixstage_tpu/ops/pallas/fused_conv.py:75",
         # a public op: no path of the package calls it
         "launches": launches[5],
         "max_abs_err": max(r["max_abs_err"] for r in k2_16.values()),
         "ms": main2["ms"], "plain_ms": main2["plain_ms"],
         "bound_ms": main2["bound_ms"], "bound_by": main2["bound_by"],
         "library_ms": None, "mma": "wgmma",
         "ms_packing_per_call": main2["ms_packing_per_call"],
         "tf32x2_bound_ms": main2["tf32x2_bound_ms"],
         "ffma_bound_ms": main2["ffma_bound_ms"],
         "max_ulps": max(r["max_ulps"] for r in k2_16.values())}]


def steps_rest_phase(torch, args, device, smi, results) -> dict:
    """Phase 22: the rest of the train steps at full width, through
    ``StepFactory`` and the CLIs.  Returns K3's launches over the phase per
    mode, {"float32": (fwd, bwd), "bfloat16": (fwd, bwd)}."""
    import shutil
    from pathlib import Path

    from mixstage_tpu_torch.cli import sample as cli_sample
    from mixstage_tpu_torch.cli import train as cli_train
    from mixstage_tpu_torch.data.common import SPEAKERS
    from mixstage_tpu_torch.data.synthetic import make_synthetic_dataset
    from mixstage_tpu_torch.models.layers import dropout, dropout_rng
    from mixstage_tpu_torch.ops.cuda import train_decoder as td
    from mixstage_tpu_torch.train import StepConfig, StepFactory
    from mixstage_tpu_torch.train.trainer import Trainer

    bf16 = torch.bfloat16
    out: dict = {}
    counters = (td.decoder_train_fwd, td.decoder_train_bwd)
    for c in counters:                               # phase 22 starts
        c.launches = c.launches_bf16 = 0
    fused_g = {"float32": 0, "bfloat16": 0}          # fused G-type steps

    def k3():
        return (tuple(c.launches - c.launches_bf16 for c in counters),
                tuple(c.launches_bf16 for c in counters))

    def expect(what):
        got = k3()
        want = ((fused_g["float32"],) * 2, (fused_g["bfloat16"],) * 2)
        check(got == want, f"{what}: K3 launches (f32, bf16 mode) {got}, "
              f"expected {want}")

    def finite(losses, what):
        check(all(bool(torch.isfinite(v).all()) for v in losses.values()),
              f"{what}: losses not finite")

    def on_device(tree):
        return {k: (tuple(torch.as_tensor(a, device=device) for a in v)
                    if k == "x" else torch.as_tensor(v, device=device))
                for k, v in tree.items()}

    trng = np.random.default_rng(args.seed + 40)
    batch = train_batch(trng, B, T)
    seed = args.seed + 41
    WJ = dict(TRAIN_CFG, weighted=True, joint=True)

    # (a) weighted + joint GAN, f32: fused against unfused from one state -
    fused = StepFactory(StepConfig(**WJ, fused_decoder=True))
    unfused = StepFactory(StepConfig(**WJ))
    lr = fused.cfg.lr
    s_f, l_f, pose_f = fused.make_steps()["g"](fused.init(seed=seed), batch,
                                               seed)
    torch.cuda.synchronize()
    fused_g["float32"] += 1
    expect("weighted + joint fused G step")
    s_u, l_u, pose_u = unfused.make_steps()["g"](unfused.init(seed=seed),
                                                 batch, seed)
    torch.cuda.synchronize()
    expect("weighted + joint unfused G step")
    finite(l_f, "weighted + joint G step")
    W = l_f["W"]
    check(tuple(W.shape) == (B,) and bool((W >= 0.1).all())
          and bool((W <= 10).all()), f"W {W.tolist()}")
    check(bool(torch.allclose(W, l_u["W"], rtol=1e-6)),
          "W of the fused and unfused G steps differ")
    tot_f, tot_u = float(l_f["total"]), float(l_u["total"])
    check(abs(tot_f - tot_u) <= KERNEL_TOL * abs(tot_u),
          f"weighted + joint G step total fused {tot_f} vs unfused {tot_u}")
    p_err, s_err, gaps, bias = compare_states(torch, s_u, s_f, lr)
    s_f, l_d, _ = fused.make_steps()["d"](s_f, batch, seed + 1)
    torch.cuda.synchronize()
    finite(l_d, "weighted + joint D step")
    expect("weighted + joint D step")
    log(f"[steps-rest] weighted + joint GAN (D on velocity ⊕ 128 mels, 2 "
        f"classes) bs{B} T{T}: W in [{float(W.min()):.4f}, "
        f"{float(W.max()):.4f}]; total fused {tot_f:.6f} vs unfused "
        f"{tot_u:.6f}; params max|diff| {p_err:.3e} (tol {2 * lr:g}); BN "
        f"stats {s_err:.3e}; Adam mu max module gap "
        f"{max(gaps.values()):.3e} (tol {MOMENT_TOL:g}); D step finite; "
        f"K3 {k3()}")
    out["weighted_joint"] = dict(total_fused=tot_f, total_unfused=tot_u,
                                 param_diff=p_err, stat_diff=s_err,
                                 mu_gap=max(gaps.values()),
                                 W=W.tolist())

    # (b) the same at bf16, each against the f32 unfused G step -------------
    facs16 = {"unfused": StepFactory(StepConfig(**WJ, dtype=bf16)),
              "fused": StepFactory(StepConfig(**WJ, dtype=bf16,
                                              fused_decoder=True))}
    rep16 = {}
    for name, fac in facs16.items():
        st, ls, ps = fac.make_steps()["g"](fac.init(seed=seed), batch, seed)
        torch.cuda.synchronize()
        fused_g["bfloat16"] += name == "fused"
        expect(f"weighted + joint {name} bf16 G step")
        finite(ls, f"weighted + joint {name} bf16 G step")
        check(ps.dtype == bf16, "bf16 pose dtype")
        rep = {"pose": drift(ps, pose_u),
               "total": drift(ls["total"], l_u["total"])}
        mu, _ = g_moment_gaps(s_u, st)
        rep.update({f"mu {m}": v for m, v in mu.items()})
        rep16[name] = rep
    fails = [k for k, dq in rep16["unfused"].items()
             if abs(rep16["fused"][k] - dq) > BF16_REL * dq + BF16_ABS]
    log(f"[steps-rest] weighted + joint bf16 G step, drift from the f32 G "
        f"step, fused (K3 bf16) / unfused: "
        + ", ".join(f"{k} {rep16['fused'][k]:.4e}/{v:.4e}"
                    for k, v in rep16["unfused"].items()) + f"; K3 {k3()}")
    check(not fails, f"weighted + joint fused bf16 G step breaks the bf16 "
          f"rule on {fails}")
    out["weighted_joint_bf16"] = rep16

    # (c) the non-GAN Mix-StAGE step, fused against unfused; the k-step
    # driver against per-step calls -------------------------------------------
    NG = dict(TRAIN_CFG, gan=False)
    ng_f = StepFactory(StepConfig(**NG, fused_decoder=True))
    ng_u = StepFactory(StepConfig(**NG))
    check(sorted(ng_f.make_steps()) == ["eval", "train"], "non-GAN steps")
    n_f, ln_f, _ = ng_f.make_steps()["train"](ng_f.init(seed=seed), batch,
                                              seed)
    torch.cuda.synchronize()
    fused_g["float32"] += 1
    expect("non-GAN fused step")
    n_u, ln_u, _ = ng_u.make_steps()["train"](ng_u.init(seed=seed), batch,
                                              seed)
    torch.cuda.synchronize()
    expect("non-GAN unfused step")
    finite(ln_f, "non-GAN step")
    check(n_f.disc is None and "G_gan" not in ln_f, "non-GAN state")
    t_f, t_u = float(ln_f["total"]), float(ln_u["total"])
    check(abs(t_f - t_u) <= KERNEL_TOL * abs(t_u),
          f"non-GAN step total fused {t_f} vs unfused {t_u}")
    np_err, ns_err, n_gaps, _ = compare_states(torch, n_u, n_f, lr)
    # the k-step driver against per-step calls at lr 1e-6, as the CPU tests
    # run their drivers: the card's weight-gradient reductions are not
    # bitwise reproducible, and at 1e-4 the flips they seed move the later
    # losses by up to 4.7e-3 (--seed 0, NVIDIA H100 80GB HBM3, 700 W;
    # PERF.md)
    ng_k = StepFactory(StepConfig(**NG, fused_decoder=True, lr=SCAN_LR))
    stacked = train_batch(trng, B, T, k=SCAN_K)
    rngs = list(range(SCAN_K))
    s_scan, l_scan, poses = ng_k.make_scan_train_step(SCAN_K)(
        ng_k.init(seed=seed), stacked, np.zeros(SCAN_K, bool), rngs)
    torch.cuda.synchronize()
    fused_g["float32"] += SCAN_K
    expect(f"non-GAN make_scan_train_step({SCAN_K})")
    s_seq, loss_gaps = ng_k.init(seed=seed), []
    for i in range(SCAN_K):
        s_seq, l_i, _ = ng_k.make_steps()["train"](
            s_seq, {k: (tuple(a[i] for a in v) if k == "x" else v[i])
                    for k, v in stacked.items()}, rngs[i])
        loss_gaps.append(abs(float(l_i["total"]) - float(
            l_scan["total"][i])) / abs(float(l_i["total"])))
    torch.cuda.synchronize()
    fused_g["float32"] += SCAN_K
    expect("non-GAN per-step calls")
    worst_loss = max(loss_gaps)
    worst_param = max(float((a - b).abs().max()) for a, b in zip(
        s_scan.g_opt.params, s_seq.g_opt.params))
    log(f"[steps-rest] non-GAN Mix-StAGE step bs{B} T{T}: total fused "
        f"{t_f:.6f} vs unfused {t_u:.6f}; params {np_err:.3e}, BN stats "
        f"{ns_err:.3e}, Adam mu max module gap {max(n_gaps.values()):.3e}; "
        f"make_scan_train_step({SCAN_K}) against {SCAN_K} per-step calls "
        f"at lr {SCAN_LR:g}: totals within "
        + ", ".join(f"{g:.2e}" for g in loss_gaps) + " (relative), params "
        f"within {worst_param:.3e} (tol {SCAN_K * 2 * SCAN_LR:g}); K3 "
        f"{k3()}")
    check(worst_loss <= 1e-3 and
          worst_param <= SCAN_K * 2 * SCAN_LR + 1e-6,
          "the non-GAN k-step driver departs from its per-step calls")
    out["non_gan"] = dict(total_fused=t_f, total_unfused=t_u,
                          param_diff=np_err, stat_diff=ns_err,
                          mu_gap=max(n_gaps.values()),
                          scan_vs_steps_loss=worst_loss,
                          scan_vs_steps_param=worst_param)

    # (d) the other optimizers: a fused G step each, and the card's update
    # on given gradients against the CPU's -----------------------------------
    optims = {"AdamW": dict(optim="AdamW"),
              "SGD_momentum": dict(optim="SGD",
                                   optim_kwargs=(("momentum", 0.9),)),
              "RMSprop": dict(optim="RMSprop"),
              "Adam_mu_bf16": dict(optim_mu_dtype="bfloat16")}
    opt_rep = {}
    ggen = torch.Generator().manual_seed(seed + 2)
    for name, kw in optims.items():
        fac = StepFactory(StepConfig(**TRAIN_CFG, fused_decoder=True, **kw))
        st, ls, _ = fac.make_steps()["g"](fac.init(seed=seed), batch, seed)
        torch.cuda.synchronize()
        fused_g["float32"] += 1
        expect(f"{name} fused G step")
        finite(ls, f"{name} G step")
        opt = st.g_opt
        cpu = fac.g_tx([(n, p.detach().cpu().clone())
                        for n, p in zip(opt.names, opt.params)])
        for slot, tensors in opt.slots().items():
            for dst, src in zip(getattr(cpu, slot), tensors):
                dst.copy_(src.cpu())
        cpu.count = opt.count
        # gradients whose global norm is below the clip's 1, which keeps
        # them as they are: the update rule alone, not the two devices'
        # float32 sums over the ~3e7 elements of the norm (AdamW's mu
        # 1.5e-5 apart at a norm of ~50, where the clip scales by 1 /
        # norm; --seed 0, NVIDIA H100 80GB HBM3, 700 W; PERF.md)
        grads = [torch.randn(p.shape, generator=ggen) * 1e-5
                 for p in cpu.params]
        norm = float(torch.stack([g.double().norm() for g in grads]).norm())
        check(norm < cpu.MAX_NORM, f"{name}: gradient norm {norm}")
        opt.step([g.to(device) for g in grads])
        cpu.step(grads)
        torch.cuda.synchronize()
        err = {"params": max(
            float((a.cpu() - b).abs().max()) / max(float(b.abs().max()),
                                                   1e-30)
            for a, b in zip(opt.params, cpu.params))}
        for slot, tensors in opt.slots().items():
            if slot == "mu" and opt.mu_dtype is not None:
                err["mu_bf16_equal"] = all(
                    torch.equal(a.cpu(), b) for a, b in zip(tensors, cpu.mu))
                check(tensors[0].dtype == bf16 and err["mu_bf16_equal"],
                      f"{name}: the card's bf16 mu differs from the CPU's")
                continue
            err[slot] = max(
                float((a.cpu() - b).abs().max()) / max(float(b.abs().max()),
                                                       1e-30)
                for a, b in zip(tensors, getattr(cpu, slot)))
        worst = max(v for k, v in err.items() if k != "mu_bf16_equal")
        check(worst <= 1e-6, f"{name}: the card's update differs from the "
              f"CPU's by {err}")
        opt_rep[name] = dict(update_err=err, factory=fac, state=st)
        log(f"[steps-rest] {name}: fused G step finite; the card's update on "
            f"given gradients (global norm {norm:.4f}) against the CPU's "
            f"(max |diff| / max |ref|): "
            + ", ".join(f"{k} {v}" for k, v in err.items()))
    expect("the optimizers' steps and timings")
    out["optimizers"] = opt_rep

    # (e) pose noise and dropout, unfused ----------------------------------
    x = torch.randn(B * T * C * 8, device=device,
                    generator=torch.Generator(device=device).manual_seed(seed))
    with dropout_rng(torch.Generator(device=device).manual_seed(seed + 3)):
        dropped = dropout(x, P_DROP, training=True)
    kept = dropped != 0
    share = float(kept.float().mean())
    sigma = (P_DROP * (1 - P_DROP) / x.numel()) ** 0.5
    check(abs(share - (1 - P_DROP)) <= 5 * sigma,
          f"dropout kept share {share} (5 sigma {5 * sigma:.2e})")
    keep_prob = float(torch.tensor(1 - P_DROP, dtype=torch.float32))
    check(torch.equal(dropped[kept], x[kept] / keep_prob),
          "dropout's kept elements are not x / (1 - p)")
    nd = StepFactory(StepConfig(**TRAIN_CFG, noise=NOISE, p_dropout=P_DROP))
    totals = []
    for rng in (5, 5, 6):
        _, ls, _ = nd.make_steps()["g"](nd.init(seed=seed), batch, rng)
        finite(ls, "noise + dropout G step")
        totals.append(float(ls["total"]))
    _, ls, _ = nd.make_steps()["d"](nd.init(seed=seed), batch, 7)
    finite(ls, "noise + dropout D step")
    torch.cuda.synchronize()
    expect("noise + dropout steps")
    same, other = (abs(totals[1] - totals[0]) / abs(totals[0]),
                   abs(totals[2] - totals[0]) / abs(totals[0]))
    check(same <= 1e-6 and other > 1e-4,
          f"noise + dropout G steps: one seed twice {totals[:2]}, another "
          f"{totals[2]}")
    for bad, why in ((dict(fused_decoder=True, p_dropout=P_DROP), "p > 0"),
                     (dict(fused_decoder=True, dtype=torch.float64),
                      "float64")):
        try:
            StepFactory(StepConfig(**TRAIN_CFG, **bad))
        except NotImplementedError as e:
            log(f"[steps-rest] -fused_decoder with {why} refused on the "
                f"card: {e}")
        else:
            check(False, f"-fused_decoder with {why} was not refused")
    log(f"[steps-rest] dropout {P_DROP} on {x.numel()} elements: kept share "
        f"{share:.6f} ({abs(share - 1 + P_DROP) / sigma:.2f} binomial "
        f"sigma from {1 - P_DROP}), kept values x / (1 - p) exactly; noise "
        f"{NOISE} + dropout G step totals: seed 5 twice {totals[0]:.7f}, "
        f"{totals[1]:.7f} (relative diff {same:.2e}), seed 6 "
        f"{totals[2]:.7f} ({other:.2e})")
    out["noise_dropout"] = dict(kept_share=share, sigma=sigma, totals=totals)

    # (f) Speech2Gesture_G and StyleClassifier_G -----------------------------
    s2g = StepFactory(StepConfig(model="Speech2Gesture_G", gan=True,
                                 criterion="L1Loss", out_feats=F_POSE))
    st = s2g.init(seed=seed)
    st, lg, pg = s2g.make_steps()["g"](st, batch, seed)
    st, ld, _ = s2g.make_steps()["d"](st, batch, seed + 1)
    torch.cuda.synchronize()
    finite(lg, "Speech2Gesture_G G step")
    finite(ld, "Speech2Gesture_G D step")
    check(tuple(pg.shape) == (B, T, F_POSE), "Speech2Gesture_G pose shape")
    clf = StepFactory(StepConfig(model="StyleClassifier_G", gan=False,
                                 out_feats=F_POSE,
                                 num_speakers=MODEL["num_speakers"]))
    st = clf.init(seed=seed)
    clf_losses = []
    for i in range(CLF_STEPS):
        st, lc, logits = clf.make_steps()["train"](st, batch, i)
        clf_losses.append(float(lc["total"]))
    expect("Speech2Gesture_G and StyleClassifier_G steps")
    check(clf_losses[-1] < clf_losses[0] and all(np.isfinite(clf_losses)),
          f"StyleClassifier_G loss over {CLF_STEPS} steps: {clf_losses}")
    log(f"[steps-rest] Speech2Gesture_G GAN: G total "
        f"{float(lg['total']):.5f}, D total {float(ld['total']):.5f}; "
        f"StyleClassifier_G over {CLF_STEPS} steps on one batch: loss "
        f"{clf_losses[0]:.5f} → {clf_losses[-1]:.5f}, accuracy "
        f"{float(lc['acc']):.4f}")
    out["speech2gesture"] = dict(g_total=float(lg["total"]),
                                 d_total=float(ld["total"]))
    out["classifier_losses"] = clf_losses

    # timings (CUDA events): the weighted + joint fused G step against the
    # plain fused G step (its extra cost: D's eval forward for W), the
    # non-GAN step --------------------------------------------------------------
    plain_f = StepFactory(StepConfig(**TRAIN_CFG, fused_decoder=True))
    dbatch = on_device(batch)
    timed = {"weighted_joint": (fused, fused.init(seed=seed), "g"),
             "plain": (plain_f, plain_f.init(seed=seed), "g"),
             "non_gan": (ng_f, ng_f.init(seed=seed), "train")}
    timed.update({name: (rec.pop("factory"), rec.pop("state"), "g")
                  for name, rec in opt_rep.items()})
    order = list(timed)
    turns = {name: [] for name in timed}
    for name in order + order[::-1]:             # ABBA over all of them
        fac, st, kind = timed[name]
        steps = fac.make_steps()
        turns[name].append(cuda_ms(torch, lambda: steps[kind](st, dbatch),
                                   reps=10))
        fused_g["float32"] += 10 + 3
    expect("the timed steps")
    mean = {k: float(np.mean(v)) for k, v in turns.items()}
    for name, rec in opt_rep.items():
        rec["g_step_ms"] = mean[name]
    log(f"[timing] {smi}: phase 22 fused steps bs{B} T{T}, mean of 2 ABBA "
        f"turns (all seven steps in one ABBA order): weighted + joint G step {mean['weighted_joint']:.3f} ms "
        f"(turns {turns['weighted_joint']}), plain G step "
        f"{mean['plain']:.3f} ms (turns {turns['plain']}), extra "
        f"{mean['weighted_joint'] - mean['plain']:+.3f} ms; non-GAN step "
        f"{mean['non_gan']:.3f} ms (turns {turns['non_gan']})")
    log(f"[timing] {smi}: phase 22 fused G step per optimizer, mean of 2 "
        f"ABBA turns (the plain G step is Adam's): "
        + ", ".join(f"{k} {mean[k]:.3f} ms (turns {turns[k]})"
                    for k in opt_rep))
    out["timing"] = dict(mean, turns=turns)

    # (g) the lifecycle: a classifier, then a weighted joint run with its IS
    # metric, a non-GAN run, and cli.sample -----------------------------------
    import importlib.util

    if "h5py" not in sys.modules and importlib.util.find_spec("h5py") is None:
        log("[steps-rest] h5py: not installed on this machine; this phase's "
            "PATS h5 files go through chip_smoke's stand-in")
        install_h5py_stand_in()
    root = Path(__file__).resolve().parent / "build" / "steps_rest"
    shutil.rmtree(root, ignore_errors=True)
    data = str(root / "data")
    speakers = SPEAKERS[:MODEL["num_speakers"]]
    make_synthetic_dataset(data, speakers, LIFE_INTERVALS,
                           seed=11212 + args.seed)
    seen = []
    orig_train = Trainer.train

    def keep(self, exp_num):
        orig_train(self, exp_num)
        seen.append(self)

    common = ["-path2data", data, "-loss", "L1Loss", "-batch_size", str(B),
              "-window_hop", "5", "-num_iters", "1", "-exp", "1", "-seed",
              str(11212 + args.seed)]
    runs = {
        "classifier": ["-speaker", json.dumps(["all"]), "-model",
                       "StyleClassifier_G", "-gan", "0", "-num_epochs", "1",
                       "-debug", "2"],
        "weighted_joint": ["-speaker", json.dumps(speakers), "-model",
                           "JointLateClusterSoftStyle4_G", "-gan", "1",
                           "-weighted", "3", "-joint", "1", "-noise",
                           str(NOISE), "-optim", "AdamW", "-fused_decoder",
                           "1", "-num_clusters", str(MODEL["num_clusters"]),
                           "-num_epochs", "2", "-debug", "2"],
        "non_gan": ["-speaker", json.dumps(speakers), "-model",
                    "JointLateClusterSoftStyle4_G", "-gan", "0",
                    "-fused_decoder", "1", "-num_clusters",
                    str(MODEL["num_clusters"]), "-num_epochs", "1",
                    "-debug", "2"]}
    life = {}
    Trainer.train = keep
    try:
        for name, argv in runs.items():
            save = str(root / f"save_{name}")
            if name == "weighted_joint":
                argv = argv + ["-pretrained_model_weights",
                               life["classifier"]["weights"]]
            t = time.perf_counter()
            cli_train.main(common + argv + ["-save_dir", save])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            tr = seen[-1]
            if tr.step_cfg.fused_decoder:
                fused_g["float32"] += tr.state.g_step
            expect(f"cli.train {name}")
            weights = tr.book.name("weights", "p", save)
            with open(tr.book.name("res", "json", save)) as f:
                res = json.load(f)
            for key in ("train", "dev", "test"):
                check(bool(np.isfinite(res[key]).all()),
                      f"cli.train {name}: {key} losses {res[key]}")
            life[name] = dict(weights=weights, wall_s=wall,
                              g_steps=tr.state.g_step,
                              res_keys=sorted(res))
            if name == "classifier":
                check({"train_acc", "dev_acc", "test_acc"} <= set(res) and
                      sorted(torch.load(weights, weights_only=True)) ==
                      ["gen"], "cli.train StyleClassifier_G: accuracy and "
                      "a gen-only checkpoint")
            if name == "weighted_joint":
                check(tr.IS is not None and all(
                    np.isfinite(res[f"{k}_style_IS"]).all()
                    for k in ("train", "dev", "test")),
                      "the weighted joint run reports no IS metric")
                check(tr.step_cfg.weighted and tr.step_cfg.joint and
                      tr.step_cfg.noise == NOISE and
                      tr.step_cfg.optim == "AdamW", "weighted run config")
                life[name]["style_IS"] = res["train_style_IS"]
            log(f"[steps-rest] cli.train {name}: {wall:.2f} s, "
                f"{tr.state.g_step} G-type steps, losses finite; K3 "
                f"{k3()}")
        t = time.perf_counter()
        cli_sample.main(["-load", life["non_gan"]["weights"], "-path2data",
                         data])
        torch.cuda.synchronize()
        life["sample_wall_s"] = time.perf_counter() - t
        expect("cli.sample")
    finally:
        Trainer.train = orig_train
        shutil.rmtree(root, ignore_errors=True)
    log(f"[steps-rest] lifecycle: cli.train -model StyleClassifier_G, then "
        f"-gan 1 -weighted 3 -joint 1 -noise {NOISE} -optim AdamW "
        f"-fused_decoder 1 -pretrained_model_weights <it> (train_style_IS "
        f"{life['weighted_joint']['style_IS']}), -gan 0 -fused_decoder 1, "
        f"cli.sample of the last ({life['sample_wall_s']:.2f} s)")
    out["lifecycle"] = life
    launches = dict(zip(("float32", "bfloat16"), k3()))   # phase 22 ends
    log(f"[steps-rest] K3 launches over phase 22 (fwd, bwd): f32 mode "
        f"{launches['float32']}, bf16 mode {launches['bfloat16']}")
    out["k3_launches"] = launches
    results["steps_rest"] = out
    return launches


def text_batch(rng, b, t, width, k=None):
    """``train_batch`` with a text stream of ``width`` channels after the
    audio (the 15-fps text windows align with the pose frames)."""
    batch = train_batch(rng, b, t, k)
    lead = () if k is None else (k,)
    text = rng.normal(size=lead + (b, t, width)).astype(np.float32)
    return dict(batch, x=batch["x"] + (text,))


def disentangle_generator():
    """A Disentangle generator for the plumbing (a port of
    ``tests/test_disentangle.py:36-59``): the Mix-StAGE generator emitting
    the Disentangle trainer's internal losses, each weighted by the
    ``style_losses`` keyword the steps forward."""
    import torch

    from mixstage_tpu_torch.models import JointLateClusterSoftStyle4_G
    from mixstage_tpu_torch.models.registry import \
        DISENTANGLE_INTERNAL_LOSSES

    class JointLateClusterSoftStyleDisentangle9_G(
            JointLateClusterSoftStyle4_G):
        def __init__(self, style_losses=(), **kw):
            super().__init__(**kw)
            self.style_losses = dict(style_losses)

        def forward(self, x_list, y, style_weights, input_modalities=(
                "audio/log_mel_512",), use_pose_input=False,
                time_steps=None):
            out = super().forward(x_list, y, style_weights,
                                  input_modalities, use_pose_input,
                                  time_steps)
            pose, score = out["pose"], out["labels_score"]
            losses = {}
            for i, name in enumerate(DISENTANGLE_INTERNAL_LOSSES):
                if name == "H":
                    p = torch.softmax(score, dim=-1)
                    losses["H"] = -(p * torch.log(p + 1e-8)).sum(-1).mean()
                else:
                    losses[name] = (self.style_losses.get(name, 1.0)
                                    * pose.abs().mean() * (i + 1) / 100.0)
            out["internal_losses"] = losses
            return out

    return JointLateClusterSoftStyleDisentangle9_G


def text_phase(torch, args, device, smi, results) -> dict:
    """Phase 23: text input streams, ``-optim_separate`` and the
    Disentangle losses at full width, through ``StepFactory`` and the
    CLIs.  Returns K3's launches over the phase per mode,
    {"float32": (fwd, bwd), "bfloat16": (fwd, bwd)}."""
    import importlib.util
    import shutil
    from pathlib import Path

    from mixstage_tpu_torch.cli import sample as cli_sample
    from mixstage_tpu_torch.cli import train as cli_train
    from mixstage_tpu_torch.data.common import SPEAKERS
    from mixstage_tpu_torch.data.hdf5 import HDF5
    from mixstage_tpu_torch.data.synthetic import make_synthetic_dataset
    from mixstage_tpu_torch.data.text import write_text_meta
    from mixstage_tpu_torch.models.registry import (
        DISENTANGLE_INTERNAL_LOSSES, MODEL_REGISTRY, register_model)
    from mixstage_tpu_torch.models.speech2gesture import Speech2Gesture_D
    from mixstage_tpu_torch.ops.cuda import train_decoder as td
    from mixstage_tpu_torch.train import StepConfig, StepFactory
    from mixstage_tpu_torch.train.state import SeparateTextOptimizer
    from mixstage_tpu_torch.train.trainer import Trainer

    bf16 = torch.bfloat16
    out: dict = {}
    counters = (td.decoder_train_fwd, td.decoder_train_bwd)
    for c in counters:                               # phase 23 starts
        c.launches = c.launches_bf16 = 0
    fused_g = {"float32": 0, "bfloat16": 0}          # fused G-type steps

    def k3():
        return (tuple(c.launches - c.launches_bf16 for c in counters),
                tuple(c.launches_bf16 for c in counters))

    def expect(what):
        got = k3()
        want = ((fused_g["float32"],) * 2, (fused_g["bfloat16"],) * 2)
        check(got == want, f"{what}: K3 launches (f32, bf16 mode) {got}, "
              f"expected {want}")

    def finite(losses, what):
        check(all(bool(torch.isfinite(v).all()) for v in losses.values()),
              f"{what}: losses not finite")

    def g_step(fac, batch, seed, what, st=None):
        st, ls, pose = fac.make_steps()["g"](
            fac.init(seed=seed) if st is None else st, batch, seed)
        torch.cuda.synchronize()
        fused_g["bfloat16" if fac.cfg.dtype == bf16 else "float32"] += \
            bool(fac.cfg.fused_decoder)
        expect(what)
        finite(ls, what)
        return st, ls, pose

    trng = np.random.default_rng(args.seed + 50)
    seed = args.seed + 51
    W2V = ("audio/log_mel_512", "text/w2v")
    TXT = dict(TRAIN_CFG, input_modalities=W2V, text_channels=300)
    batch = text_batch(trng, B, T, 300)

    # (a) audio + text/w2v: fused against unfused from one state (f32),
    # bf16 by the bf16 rule, the joint D on 96 + 128 + 300 channels ---------
    fused = StepFactory(StepConfig(**TXT, fused_decoder=True))
    unfused = StepFactory(StepConfig(**TXT))
    lr = fused.cfg.lr
    s_f, l_f, pose_f = g_step(fused, batch, seed, "text fused G step")
    s_u, l_u, pose_u = g_step(unfused, batch, seed, "text unfused G step")
    width = s_f.gen.text_encoder.stack.conv0.conv.weight.shape[1]
    check(width == 300, f"text encoder width {width}")
    tot_f, tot_u = float(l_f["total"]), float(l_u["total"])
    check(abs(tot_f - tot_u) <= KERNEL_TOL * abs(tot_u),
          f"text G step total fused {tot_f} vs unfused {tot_u}")
    p_err, s_err, gaps, _ = compare_states(torch, s_u, s_f, lr)
    rep16 = {}
    for name, fused16 in (("unfused", False), ("fused", True)):
        fac = StepFactory(StepConfig(**TXT, dtype=bf16,
                                     fused_decoder=fused16))
        st, ls, ps = g_step(fac, batch, seed, f"text {name} bf16 G step")
        check(ps.dtype == bf16, "bf16 pose dtype")
        rep = {"pose": drift(ps, pose_u),
               "total": drift(ls["total"], l_u["total"])}
        mu, _ = g_moment_gaps(s_u, st)
        rep.update({f"mu {m}": v for m, v in mu.items()})
        rep16[name] = rep
    fails = [k for k, dq in rep16["unfused"].items()
             if abs(rep16["fused"][k] - dq) > BF16_REL * dq + BF16_ABS]
    check(not fails, f"text fused bf16 G step breaks the bf16 rule on "
          f"{fails}")
    joint = StepFactory(StepConfig(**TXT, joint=True, fused_decoder=True))
    check(joint.d_in_channels() == F_POSE + MEL + 300,
          f"joint D width {joint.d_in_channels()}")
    s_j, l_jd, _ = joint.make_steps()["d"](joint.init(seed=seed), batch,
                                           seed + 1)
    torch.cuda.synchronize()
    finite(l_jd, "text joint D step")
    expect("text joint D step")
    d_width = s_j.disc.conv1.weight.shape[1]
    check(d_width == F_POSE + MEL + 300, f"joint D conv1 width {d_width}")
    log(f"[text] audio + text/w2v (300) bs{B} T{T}: G total fused "
        f"{tot_f:.6f} vs unfused {tot_u:.6f}; params max|diff| {p_err:.3e} "
        f"(tol {2 * lr:g}); BN stats {s_err:.3e}; Adam mu max module gap "
        f"{max(gaps.values()):.3e} (gen.text_encoder "
        f"{gaps['gen.text_encoder']:.3e}; tol {MOMENT_TOL:g}); bf16 drift "
        f"from the f32 step fused/unfused: "
        + ", ".join(f"{k} {rep16['fused'][k]:.4e}/{v:.4e}"
                    for k, v in rep16["unfused"].items()
                    if not k.startswith("mu ") or "text" in k)
        + f"; joint D ({d_width} channels) step total "
        f"{float(l_jd['total']):.5f}; K3 {k3()}")
    out["w2v"] = dict(total_fused=tot_f, total_unfused=tot_u,
                      param_diff=p_err, stat_diff=s_err,
                      mu_gap=max(gaps.values()),
                      mu_gap_text=gaps["gen.text_encoder"], bf16=rep16,
                      joint_d_total=float(l_jd["total"]))

    # (b) a text/bert-width stream (768) ------------------------------------
    bert = StepFactory(StepConfig(**dict(TXT, input_modalities=(
        "audio/log_mel_512", "text/bert"), text_channels=768),
        fused_decoder=True))
    st, l_b, _ = g_step(bert, text_batch(trng, B, T, 768), seed,
                        "text/bert fused G step")
    check(st.gen.text_encoder.stack.conv0.conv.weight.shape[1] == 768,
          "text/bert encoder width")
    log(f"[text] audio + text/bert (768): fused G step total "
        f"{float(l_b['total']):.5f}, finite; K3 {k3()}")
    out["bert_total"] = float(l_b["total"])

    # (c) -optim_separate: lr 1e-4, the text encoder at 1e-5 -----------------
    sep = StepFactory(StepConfig(**TXT, fused_decoder=True,
                                 optim_separate=TEXT_LR))
    st0 = sep.init(seed=seed)
    before = [p.detach().clone() for p in st0.g_opt.params]
    st, l_s, _ = g_step(sep, batch, seed, "-optim_separate fused G step",
                        st=st0)
    opt = st.g_opt
    check(isinstance(opt, SeparateTextOptimizer), "optimizer groups")
    moved = {"text": 0.0, "rest": 0.0}
    for name, p, p0 in zip(opt.names, opt.params, before):
        g = "text" if ".text_encoder." in name else "rest"
        # the step, less the float32 rounding of p0 + step (an ULP of p0)
        step = (p - p0).abs() - p0.abs() * 2.0 ** -23
        moved[g] = max(moved[g], float(step.max()))
    # Adam's first update moves a leaf by at most its rate (|mu_hat| /
    # (sqrt(nu_hat) + eps) ≤ 1), and nearly by it where |g| ≫ eps
    check(0.5 * TEXT_LR < moved["text"] <= TEXT_LR * (1 + 1e-4),
          f"text encoder moved {moved['text']}, not at {TEXT_LR}")
    check(0.5 * lr < moved["rest"] <= lr * (1 + 1e-4),
          f"the rest moved {moved['rest']}, not at {lr}")
    cpu = sep.g_tx([(n, p.detach().cpu().clone())
                    for n, p in zip(opt.names, opt.params)])
    for slot, tensors in opt.slots().items():
        for dst, src in zip(cpu.slots()[slot], tensors):
            dst.copy_(src.cpu())
    cpu.count = opt.count
    ggen = torch.Generator().manual_seed(seed + 2)
    grads = [torch.randn(p.shape, generator=ggen) * 1e-5 for p in cpu.params]
    norm = float(torch.stack([g.double().norm() for g in grads]).norm())
    check(norm < cpu.MAX_NORM, f"-optim_separate: gradient norm {norm}")
    opt.step([g.to(device) for g in grads])
    cpu.step(grads)
    torch.cuda.synchronize()
    err = {"params": max(
        float((a.cpu() - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        for a, b in zip(opt.params, cpu.params))}
    for slot, tensors in opt.slots().items():
        err[slot] = max(
            float((a.cpu() - b).abs().max()) / max(float(b.abs().max()),
                                                   1e-30)
            for a, b in zip(tensors, cpu.slots()[slot]))
    check(max(err.values()) <= 1e-6, f"-optim_separate: the card's update "
          f"differs from the CPU's by {err}")
    check(opt.groups["text"].count == opt.groups["rest"].count == 2,
          "-optim_separate group counts")
    log(f"[text] -optim_separate {TEXT_LR:g} (lr {lr:g}): after one fused G "
        f"step the text encoder moved ≤ {moved['text']:.4e}, the rest ≤ "
        f"{moved['rest']:.4e}; {len(opt.groups['text'].params)} text and "
        f"{len(opt.groups['rest'].params)} other leaves; the card's update "
        f"on given gradients (global norm {norm:.4f}) against the CPU's "
        f"(max |diff| / max |ref|): "
        + ", ".join(f"{k} {v:.2e}" for k, v in err.items()))
    out["optim_separate"] = dict(moved=moved, update_err=err)

    # (d) a Disentangle generator ------------------------------------------
    name = "JointLateClusterSoftStyleDisentangle9_G"
    register_model(name, disentangle_generator())
    register_model(name[:-1] + "D", Speech2Gesture_D)
    weights = {k: 1.0 for k in DISENTANGLE_INTERNAL_LOSSES if k != "H"}
    weights["content_+"] = 2.0
    try:
        DIS = dict(TRAIN_CFG, model=name,
                   style_losses=tuple(sorted(weights.items())))
        dis_f = StepFactory(StepConfig(**DIS, fused_decoder=True))
        dis_u = StepFactory(StepConfig(**DIS))
        abatch = train_batch(trng, B, T)
        base_g = ["pose", "G_gan", "label", "id_in", "id_out"]
        sums = {}
        st, lg_f, _ = g_step(dis_f, abatch, seed, "Disentangle fused G step")
        check(not set(DISENTANGLE_INTERNAL_LOSSES) & set(lg_f),
              "the fused G step (the backbone) emitted internal losses")
        sums["g_fused"] = (float(lg_f["total"]),
                           sum(float(lg_f[k]) for k in base_g))
        st_u, lg_u, _ = g_step(dis_u, abatch, seed,
                               "Disentangle unfused G step")
        check(dict(st_u.gen.style_losses) == weights,
              "style_losses did not reach the model")
        sums["g_unfused"] = (float(lg_u["total"]), sum(
            float(lg_u[k]) for k in base_g + DISENTANGLE_INTERNAL_LOSSES))
        check(abs(float(lg_u["content_+"]) - float(lg_u["content_-"]))
              <= 1e-5 * abs(float(lg_u["content_-"])),
              "style_losses weight of content_+")
        g0 = [p.detach().clone() for p in st.g_opt.params]
        st, ld, _ = dis_f.make_steps()["d"](st, abatch, seed + 1)
        torch.cuda.synchronize()
        expect("Disentangle D step")
        finite(ld, "Disentangle D step")
        sums["d"] = (float(ld["total"]), sum(
            float(ld[k]) for k in ["real_D", "fake_D", "label", "id_in",
                                   "id_out"] + DISENTANGLE_INTERNAL_LOSSES))
        check(all(torch.equal(a, b) for a, b in zip(g0, st.g_opt.params)),
              "the D step moved G")
        for what, (total, parts) in sums.items():
            check(abs(total - parts) <= 1e-5 * abs(parts),
                  f"Disentangle {what}: total {total} vs its parts {parts}")
        k = 4
        coins = np.array([True, False, True, False])
        s_scan, l_scan, _ = dis_f.make_scan_train_step(k)(
            dis_f.init(seed=seed), train_batch(trng, B, T, k=k), coins,
            list(range(k)))
        torch.cuda.synchronize()
        fused_g["float32"] += int((~coins).sum())
        expect(f"Disentangle make_scan_train_step({k})")
        extra = sorted(set(l_scan) - {"pose", "G_gan", "real_D", "fake_D",
                                      "total", "label", "id_in", "id_out"})
        check(extra == sorted(DISENTANGLE_INTERNAL_LOSSES) and all(
            tuple(l_scan[n].shape) == (k,) and
            bool(torch.isfinite(l_scan[n]).all()) for n in extra),
            f"the k-step driver's Disentangle keys {extra}")
        check(all(float(l_scan["H"][i]) > 0 for i in np.flatnonzero(coins)),
              "the scan's D steps carry no internal losses")
    finally:
        MODEL_REGISTRY.pop(name, None)
        MODEL_REGISTRY.pop(name[:-1] + "D", None)
    log(f"[text] Disentangle generator (11 internal losses, content_+ "
        f"weighted 2): totals against their named parts "
        + ", ".join(f"{w} {t:.6f}/{p:.6f}" for w, (t, p) in sums.items())
        + f" (the fused G step runs the backbone, which emits none, as in "
        f"the JAX package); make_scan_train_step({k}) carries "
        f"{len(extra)} extra keys; K3 {k3()}")
    out["disentangle"] = dict(sums=sums, scan_keys=extra)

    # timings (CUDA events, ABBA): the text fused G step against phase 9's
    # audio-only fused G step ------------------------------------------------
    audio = StepFactory(StepConfig(**TRAIN_CFG, fused_decoder=True))
    timed = {"text": (fused, fused.init(seed=seed), batch),
             "audio": (audio, audio.init(seed=seed),
                       dict(batch, x=batch["x"][:1]))}
    turns = {name: [] for name in timed}
    calls = {}
    for name, (fac, st, b) in timed.items():
        db = {k: (tuple(torch.as_tensor(a, device=device) for a in v)
                  if k == "x" else torch.as_tensor(v, device=device))
              for k, v in b.items()}
        calls[name] = partial(fac.make_steps()["g"], st, db)
    for name in ("text", "audio", "audio", "text"):
        turns[name].append(cuda_ms(torch, calls[name], reps=10))
        fused_g["float32"] += 10 + 3
    # the device's side of it: busy time and launches per step
    # (torch.profiler; 3 warm-up, 5 timed and 5 traced calls each)
    traced = {name: trace(torch, fn) for name, fn in calls.items()}
    fused_g["float32"] += 2 * 13
    expect("the timed steps")
    mean = {k: float(np.mean(v)) for k, v in turns.items()}
    busy = {k: v["device_busy_ms"] for k, v in traced.items()}
    launches = {k: v["launches_per_call"] for k, v in traced.items()}
    log(f"[timing] {smi}: phase 23 fused G step bs{B} T{T}, 2 ABBA turns of "
        f"10: audio + text/w2v {mean['text']:.3f} ms (turns "
        f"{turns['text']}), audio only {mean['audio']:.3f} ms (turns "
        f"{turns['audio']}); the text stream adds "
        f"{mean['text'] - mean['audio']:+.3f} ms; device busy "
        f"{busy['text']:.4f} against {busy['audio']:.4f} ms a step "
        f"({busy['text'] - busy['audio']:+.4f}), {launches['text']:.0f} "
        f"against {launches['audio']:.0f} launches, idle share "
        f"{traced['text']['idle_share']:.3f} / "
        f"{traced['audio']['idle_share']:.3f} (torch.profiler)")
    out["timing"] = dict(mean, turns=turns, busy_ms=busy,
                         launches_per_step=launches,
                         idle_share={k: v["idle_share"]
                                     for k, v in traced.items()})

    # (e) the lifecycle on synthetic PATS with text ----------------------------
    if "h5py" not in sys.modules and importlib.util.find_spec("h5py") is None:
        log("[text] h5py: not installed on this machine; this phase's PATS "
            "h5 files go through chip_smoke's stand-in")
        install_h5py_stand_in()
    root = Path(__file__).resolve().parent / "build" / "text"
    shutil.rmtree(root, ignore_errors=True)
    data = str(root / "data")
    speakers = SPEAKERS[:MODEL["num_speakers"]]
    make_synthetic_dataset(data, speakers, LIFE_INTERVALS, with_text=True,
                           seed=11212 + args.seed)
    wrng = np.random.default_rng(args.seed + 52)
    for h5path in sorted((Path(data) / "processed").glob("*/*.h5")):
        n = HDF5.load_array(str(h5path), "pose/data").shape[0]
        starts = np.arange(0, n, 7)
        write_text_meta(h5path, {
            "Word": [f"w{int(i)}" for i in wrng.integers(0, 50, len(starts))],
            "start_frame": starts,
            "end_frame": np.minimum(starts + 7, n)})
        # POS classes below the cluster count (-pos labels)
        HDF5.append(h5path, "text/pos",
                    wrng.integers(0, MODEL["num_clusters"], n).astype(float))
    seen = []
    orig_train = Trainer.train

    def keep(self, exp_num):
        orig_train(self, exp_num)
        seen.append(self)

    common = ["-path2data", data, "-speaker", json.dumps(speakers),
              "-model", "JointLateClusterSoftStyle4_G", "-gan", "1",
              "-loss", "L1Loss", "-fused_decoder", "1", "-num_clusters",
              str(MODEL["num_clusters"]), "-batch_size", str(B),
              "-window_hop", "5", "-num_epochs", "1", "-debug", "2",
              "-exp", "1", "-seed", str(11212 + args.seed)]
    runs = {
        "w2v": ["-modalities", json.dumps(["pose/data", "audio/log_mel_512",
                                           "text/w2v"]),
                "-fs_new", "[15,15,15]", "-optim_separate", str(TEXT_LR)],
        "pos": ["-modalities", json.dumps(["pose/data", "audio/log_mel_512",
                                           "text/w2v", "text/pos"]),
                "-input_modalities", json.dumps(list(W2V)),
                "-fs_new", "[15,15,15,15]", "-pos", "1"]}
    life = {}
    Trainer.train = keep
    try:
        for name, argv in runs.items():
            save = str(root / f"save_{name}")
            t = time.perf_counter()
            cli_train.main(common + argv + ["-save_dir", save])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            tr = seen[-1]
            fused_g["float32"] += tr.state.g_step
            expect(f"cli.train {name}")
            with open(tr.book.name("res", "json", save)) as f:
                res = json.load(f)
            for key in ("train", "dev", "test"):
                check(bool(np.isfinite(res[key]).all()),
                      f"cli.train {name}: {key} losses {res[key]}")
            check(tr.step_cfg.text_channels == 300 and
                  tr.step_cfg.input_modalities == W2V, f"{name} config")
            check(tr.data.datasets["train"].datasets[0].text_df is not None,
                  f"{name}: text/meta not read")
            life[name] = dict(weights=tr.book.name("weights", "p", save),
                              wall_s=wall, g_steps=tr.state.g_step)
            if name == "w2v":
                check(isinstance(tr.state.g_opt, SeparateTextOptimizer) and
                      tr.state.g_opt.groups["text"].lr == TEXT_LR,
                      "cli.train -optim_separate")
            else:
                batch0 = next(tr.data_train.iter_all(batch_size=2))
                step_batch = tr.get_processed_batch(batch0)[0]
                check(np.array_equal(step_batch["labels"], np.asarray(
                    batch0["text/pos"], np.int64)),
                      "-pos: the labels are not the text/pos classes")
            log(f"[text] cli.train {name}: {wall:.2f} s, "
                f"{tr.state.g_step} G steps, losses finite; K3 {k3()}")
        t = time.perf_counter()
        cli_sample.main(["-load", life["w2v"]["weights"], "-path2data",
                         data])
        torch.cuda.synchronize()
        life["sample_wall_s"] = time.perf_counter() - t
        expect("cli.sample")
    finally:
        Trainer.train = orig_train
        shutil.rmtree(root, ignore_errors=True)
    log(f"[text] lifecycle: cli.train audio + text/w2v -optim_separate "
        f"{TEXT_LR:g} -fused_decoder 1 ({life['w2v']['wall_s']:.2f} s), "
        f"-pos 1 on a text/pos stream ({life['pos']['wall_s']:.2f} s), "
        f"cli.sample of the first ({life['sample_wall_s']:.2f} s)")
    out["lifecycle"] = life
    launches = dict(zip(("float32", "bfloat16"), k3()))   # phase 23 ends
    log(f"[text] K3 launches over phase 23 (fwd, bwd): f32 mode "
        f"{launches['float32']}, bf16 mode {launches['bfloat16']}")
    out["k3_launches"] = launches
    results["text"] = out
    return launches


# phase 24: the parallel layouts (two ranks share the one card over gloo)
PAR_WORLD = 2
PAR_TIMEOUT_S = 300          # each child process of phase 24
PAR_T_LONG = 4096            # the time partition's clip


def state_snapshot(state):
    """CPU copies of a train state's module state dicts and G's Adam mu."""
    out = {n: {k: v.detach().cpu().clone() for k, v in
               getattr(state, n).state_dict().items()}
           for n in ("gen", "psenc", "disc") if getattr(state, n) is not None}
    out["mu"] = [t.detach().cpu().clone() for t in state.g_opt.slots()["mu"]]
    return out


def state_from(factory, seed, snap):
    """A train state of ``factory`` carrying a ``state_snapshot``."""
    state = factory.init(seed=seed)
    for n in ("gen", "psenc", "disc"):
        if n in snap:
            getattr(state, n).load_state_dict(snap[n])
    for t, v in zip(state.g_opt.slots()["mu"], snap["mu"]):
        t.copy_(v.to(t.device))
    return state


def parallel_child(args) -> int:
    """One rank of phase 24 (started by ``parallel_phase``): (b) the fused
    f32 G and D steps and the fused bf16 G step, data parallel over the
    ranks, bs32 split 16 rows a rank, and the G step's time; (c) the fused
    G step on a 1 x 2 data x expert layout (K3 at 4 groups a rank).  Writes
    its outputs to ``out_<rank>.pt`` and prints one ``CHILD {json}`` line:
    its checks, its K3 launches per step and which collectives gloo ran on
    CUDA tensors."""
    import torch
    import torch.distributed as dist

    from mixstage_tpu_torch.device import resolve_device
    from mixstage_tpu_torch.ops.cuda import train_decoder as td
    from mixstage_tpu_torch.parallel import mesh, multihost
    from mixstage_tpu_torch.train import StepConfig, StepFactory

    work, rank, world = Path(args.workdir), args.rank, args.world
    multihost.setup(init_method=f"file://{work / 'store'}",
                    world_size=world, rank=rank, device_type="cuda",
                    timeout_s=PAR_TIMEOUT_S - 60)
    device = resolve_device(multihost.local_device("cuda"))
    report = {"rank": rank, "backend": dist.get_backend(),
              "device": str(device)}
    probe = {}
    for name, fn in (
            ("all_reduce", lambda t: dist.all_reduce(t)),
            ("broadcast", lambda t: dist.broadcast(t, 0)),
            ("all_gather", lambda t: dist.all_gather(
                [torch.empty_like(t) for _ in range(world)], t)),
            ("reduce_scatter", lambda t: dist.reduce_scatter(
                torch.empty_like(t), [t.clone() for _ in range(world)]))):
        try:
            fn(torch.ones(4, device=device))
            torch.cuda.synchronize()
            probe[name] = "ok"
        except Exception as e:          # noqa: BLE001 - reported
            probe[name] = type(e).__name__
    report["gloo_cuda"] = probe

    def k3():
        """K3's launches by mode: [fwd f32, bwd f32, fwd bf16, bwd bf16]
        (``launches`` counts both modes)."""
        f16, b16 = (td.decoder_train_fwd.launches_bf16,
                    td.decoder_train_bwd.launches_bf16)
        return [td.decoder_train_fwd.launches - f16,
                td.decoder_train_bwd.launches - b16, f16, b16]

    def zero():
        td.decoder_train_fwd.launches = td.decoder_train_bwd.launches = 0
        td.decoder_train_fwd.launches_bf16 = 0
        td.decoder_train_bwd.launches_bf16 = 0

    lay = mesh.make_mesh(world)
    batch = train_batch(np.random.default_rng(args.seed + 60), B, T)
    seed = args.seed + 61
    out = {}
    fused = StepFactory(StepConfig(**TRAIN_CFG, fused_decoder=True),
                        device=device, layout=lay)
    steps = fused.make_steps()
    state = mesh.replicate_state(fused.init(seed=seed), lay)
    zero()                                          # the DP path starts
    state, losses, pose = steps["g"](state, batch)
    torch.cuda.synchronize()
    report["k3_g"] = k3()
    out["g"] = dict(losses={k: v.cpu() for k, v in losses.items()},
                    pose=pose.cpu(), state=state_snapshot(state))
    # the D step from the same start (after a G step D would see G's
    # update, whose rounding flips it carries)
    s_d = mesh.replicate_state(fused.init(seed=seed), lay)
    s_d, losses, _ = steps["d"](s_d, batch)
    torch.cuda.synchronize()
    report["k3_d"] = [a - b for a, b in zip(k3(), report["k3_g"])]
    out["d"] = dict(losses={k: v.cpu() for k, v in losses.items()},
                    state=state_snapshot(s_d))
    del s_d
    f16 = StepFactory(StepConfig(**TRAIN_CFG, fused_decoder=True,
                                 dtype=torch.bfloat16), device=device,
                      layout=lay)
    s16 = mesh.replicate_state(f16.init(seed=seed), lay)
    before = k3()
    s16, l16, p16 = f16.make_steps()["g"](s16, batch)
    torch.cuda.synchronize()
    report["k3_g_bf16"] = [a - b for a, b in zip(k3(), before)]
    out["g_bf16"] = dict(total=l16["total"].cpu(), pose=p16.float().cpu(),
                         mu=[t.detach().cpu().clone()
                             for t in s16.g_opt.slots()["mu"]])
    # float64, unfused (K3 has no float64 mode): no leaky unit flips, so
    # the moments agree with the one-rank step's to rounding
    f64 = StepFactory(StepConfig(**TRAIN_CFG, dtype=torch.float64),
                      device=device, layout=lay)
    s64 = mesh.replicate_state(f64.init(seed=seed), lay)
    s64, l64, _ = f64.make_steps()["g"](s64, batch)
    out["g_f64"] = dict(total=l64["total"].cpu(),
                        mu=[t.detach().cpu().clone()
                            for t in s64.g_opt.slots()["mu"]])
    del s64
    # (c) a 1 x world data x expert layout: every rank the whole batch,
    # its share of the experts
    lay_ep = mesh.make_mesh_2d(1, world)
    fep = StepFactory(StepConfig(**TRAIN_CFG, fused_decoder=True),
                      device=device, layout=lay_ep)
    sep = mesh.replicate_state(fep.init(seed=seed), lay_ep)
    mesh.shard_state_mixture(sep, lay_ep)
    before = k3()
    sep, lep, pep = fep.make_steps()["g"](sep, batch)
    torch.cuda.synchronize()
    report["k3_g_ep"] = [a - b for a, b in zip(k3(), before)]
    report["ep_groups"] = sep.gen.decoder_groups
    out["g_ep"] = dict(losses={k: v.cpu() for k, v in lep.items()},
                       pose=pep.cpu(), start=sep.gen.expert_parallel[1],
                       state=state_snapshot(sep))
    report["k3_path"] = k3()                        # the DP path ends
    # (e) the DP G step's time on this rank (both ranks on the one card)
    dbatch = {k: (tuple(torch.as_tensor(a, device=device) for a in v)
                  if k == "x" else torch.as_tensor(v, device=device))
              for k, v in batch.items()}
    report["g_step_ms"] = cuda_ms(torch, lambda: steps["g"](state, dbatch),
                                  reps=10)
    torch.save(out, work / f"out_{rank}.pt")
    multihost.teardown()
    print("CHILD " + json.dumps(report), flush=True)
    return 0


def run_children(args, work: Path):
    """Start phase 24's ``PAR_WORLD`` ranks, each with a timeout; returns
    their ``CHILD`` reports and outputs.  A child that fails fails the
    phase."""
    import torch

    env = {k: v for k, v in os.environ.items() if k not in (
        "RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
        "MASTER_ADDR", "MASTER_PORT")}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--seed",
         str(args.seed), "--child", "parallel", "--rank", str(r), "--world",
         str(PAR_WORLD), "--workdir", str(work)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(PAR_WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=PAR_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    reports = []
    for r, (p, text) in enumerate(zip(procs, outs)):
        lines = [ln for ln in text.splitlines() if ln.startswith("CHILD ")]
        if p.returncode != 0 or len(lines) != 1:
            log(text[-4000:])
            check(False, f"phase 24 rank {r} failed (rc {p.returncode})")
        reports.append(json.loads(lines[0][len("CHILD "):]))
    return reports, [torch.load(work / f"out_{r}.pt", weights_only=False)
                     for r in range(PAR_WORLD)]


def parallel_phase(torch, args, device, smi, model, audio, styles, serve,
                   plain, results) -> dict:
    """Phase 24: the parallel layouts.  (a) one rank through the layout
    code; K3 at the shapes the layouts give it; (b)-(c) two ranks sharing
    the one card over gloo (``run_children``) against the one-rank steps;
    (d) the serving partitions over ``["cuda:0"] * 2``; (e) timings.
    Returns the launches for the kernels line."""
    from mixstage_tpu_torch.ops.cuda import fused_conv as fcv
    from mixstage_tpu_torch.ops.cuda import quant as q8
    from mixstage_tpu_torch.ops.cuda import train_decoder as td
    from mixstage_tpu_torch.parallel import mesh
    from mixstage_tpu_torch.serve import build_serving_fn, time_halo
    from mixstage_tpu_torch.train import StepConfig, StepFactory

    t_phase = time.perf_counter()
    rec = {}
    # (a) K3 at the layouts' shapes: a data rank's 16 rows, and 4, 2 and 1
    # groups (expert layouts of 2, 4 and 8 ranks); the exchange hook on the
    # card changes nothing at one rank
    kgen = torch.Generator().manual_seed(args.seed + 62)
    for name, b, g in (("dp16", B // PAR_WORLD, 8), ("G4", B, 4),
                       ("G2", B, 2), ("G1", B, 1)):
        check_k3(torch, td, name, random_train(torch, kgen, b, T, device,
                                               g=g), args.seed + 63)
    a = random_train(torch, kgen, B // PAR_WORLD, T, device)
    base = td.decoder_train_fwd(*a)
    calls = []

    def hook(stats, rows):
        calls.append(rows)
        return rows

    hooked = td.decoder_train_fwd(*a, exchange=hook)
    torch.cuda.synchronize()
    check(len(calls) == 4 and all(bool(torch.equal(p, q))
                                  for p, q in zip(base, hooked)),
          f"K3-fwd with a one-rank exchange hook ({len(calls)} calls) "
          f"differs from K3-fwd without one")
    log(f"[parallel] K3 at a data rank's bs{B // PAR_WORLD} and at 4, 2, 1 "
        f"groups against its plain versions: ok; a one-rank exchange hook "
        f"(called {len(calls)} times a forward, between the stages) leaves "
        f"K3-fwd bit for bit")
    lay = mesh.make_mesh(0)
    check((lay.world, lay.dp, lay.mp) == (1, 1, 1), f"world-1 layout {lay}")
    seed = args.seed + 61
    batch = train_batch(np.random.default_rng(args.seed + 60), B, T)
    one = StepFactory(StepConfig(**TRAIN_CFG, fused_decoder=True),
                      layout=lay)
    td.decoder_train_fwd.launches = td.decoder_train_bwd.launches = 0
    s1 = one.init(seed=seed)
    s1, l1, p1 = one.make_steps()["g"](s1, batch)
    torch.cuda.synchronize()
    k3_one = (td.decoder_train_fwd.launches, td.decoder_train_bwd.launches)
    check(k3_one == (1, 1), f"the world-1 layout's fused G step launched "
          f"K3 {k3_one} times, expected (1, 1)")
    log(f"[parallel] (a) {lay}: fused G step, K3 launches (fwd, bwd) "
        f"{k3_one}, as one card's")

    # (b), (c): two ranks on the one card
    work = Path(__file__).resolve().parent / "build" / "parallel"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    try:
        reports, outs = run_children(args, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rec["children_s"] = time.perf_counter() - t0
    for r, rep in enumerate(reports):
        check(rep["backend"] == "gloo", f"rank {r} backend {rep['backend']}")
        check(rep["k3_g"] == [1, 1, 0, 0] and rep["k3_d"] == [0, 0, 0, 0]
              and rep["k3_g_bf16"] == [0, 0, 1, 1]
              and rep["k3_g_ep"] == [1, 1, 0, 0] and rep["ep_groups"] == 4,
              f"rank {r} K3 launches: G {rep['k3_g']}, D {rep['k3_d']}, "
              f"bf16 G {rep['k3_g_bf16']}, EP G {rep['k3_g_ep']} at "
              f"{rep['ep_groups']} groups")
    log(f"[parallel] two ranks on {reports[0]['device']} over gloo (they "
        f"share the one card: NCCL takes one rank a device): collectives "
        f"gloo ran on CUDA tensors {reports[0]['gloo_cuda']}; K3 launches "
        f"per rank (fwd, bwd, fwd-bf16, bwd-bf16) over the DP and EP path "
        f"{[rep['k3_path'] for rep in reports]}; children "
        f"{rec['children_s']:.1f} s")
    rec["gloo_cuda"] = reports[0]["gloo_cuda"]
    lr = one.cfg.lr

    def close_losses(got, want, tol, what):
        for k, v in want.items():
            a, b = got[k].double(), v.detach().cpu().double()
            if b.dim():
                check(bool(torch.equal(a, b)) or
                      float((a - b).abs().max()) <= tol * float(
                          b.abs().max()), f"{what} {k}")
                continue
            check(abs(float(a) - float(b)) <= tol * abs(float(b)) + 1e-6,
                  f"{what} loss {k}: {float(a)} vs {float(b)}")

    for r, o in enumerate(outs):
        close_losses(o["g"]["losses"], l1, KERNEL_TOL, f"rank {r} DP G")
        pose_drift = float((o["g"]["pose"] - p1.cpu()).abs().mean()
                           / p1.abs().mean().cpu())
        p_err, s_err, gaps, _ = compare_states(
            torch, s1, state_from(one, seed, o["g"]["state"]), lr,
            MOMENT_TOL_DP, f"rank {r}: DP against one-rank G step")
        log(f"[parallel] (b) rank {r}: DP fused f32 G step (16 rows a rank, "
            f"BN and K3 statistics over both) vs one rank on the 32 rows: "
            f"total {float(o['g']['losses']['total']):.6f} vs "
            f"{float(l1['total']):.6f}, params max|diff| {p_err:.3e}, BN "
            f"stats {s_err:.3e} of scale, Adam mu max module gap "
            f"{max(gaps.values()):.3e}, pose mean drift {pose_drift:.3e}")
    # (c) the 1 x 2 expert layout against the one-rank step
    for r, o in enumerate(outs):
        ep = o["g_ep"]
        close_losses(ep["losses"], l1, KERNEL_TOL, f"rank {r} EP G")
        gl, start = MODEL["num_clusters"] // PAR_WORLD, ep["start"]
        check(start == r * gl, f"rank {r} holds experts from {start}")
        worst = 0.0
        for n in ("gen", "psenc"):
            for k, v in getattr(s1, n).state_dict().items():
                v = v.detach().cpu()
                if n == "gen" and mesh.is_expert_leaf(k):
                    w = v.shape[0] // MODEL["num_clusters"]
                    v = v[start * w:(start + gl) * w]
                got = ep["state"][n][k]
                check(got.shape == v.shape, f"EP {n}.{k} shape")
                if "running_" in k:
                    check(float((got - v).abs().max()) <= KERNEL_TOL *
                          max(float(v.abs().max()), 1e-30),
                          f"rank {r} EP {n}.{k} statistics")
                else:
                    worst = max(worst, float((got - v).abs().max()))
        check(worst <= 2 * lr + 1e-6, f"rank {r} EP params differ by "
              f"{worst:.3e}")
        log(f"[parallel] (c) rank {r}: dp1 x ep2 fused G step (experts "
            f"{start}-{start + gl - 1}, K3 at {gl} groups) vs one rank: "
            f"total {float(ep['losses']['total']):.6f} vs "
            f"{float(l1['total']):.6f}, params (replicated and its experts) "
            f"max|diff| {worst:.3e} (tol 2·lr)")

    s1d, l1d, _ = one.make_steps()["d"](one.init(seed=seed), batch)
    for r, o in enumerate(outs):
        close_losses(o["d"]["losses"], l1d, KERNEL_TOL, f"rank {r} DP D")
        got = o["d"]["state"]["disc"]
        for k, v in s1d.disc.state_dict().items():
            d = float((got[k] - v.detach().cpu()).abs().max())
            if "running_" in k:
                check(d <= KERNEL_TOL * max(float(v.abs().max()), 1e-30),
                      f"rank {r} DP D step: D's {k}")
            else:
                check(d <= 2 * lr + 1e-6, f"rank {r} DP D step: D's {k} "
                      f"differs by {d:.3e}")
    log(f"[parallel] (b) DP D step from the same start: losses within rtol "
        f"{KERNEL_TOL:g} (fake_D {float(outs[0]['d']['losses']['fake_D']):.6f}"
        f" vs {float(l1d['fake_D']):.6f}), D's params within 2·lr, its BN "
        f"stats within {KERNEL_TOL:g} of scale on both ranks")
    # the float64 DP G step (unfused) against the one-rank one
    f64 = StepFactory(StepConfig(**TRAIN_CFG, dtype=torch.float64),
                      layout=lay)
    s64, l64, _ = f64.make_steps()["g"](f64.init(seed=seed), batch)
    for r, o in enumerate(outs):
        gaps64, _ = g_moment_gaps(s64, state_from(f64, seed,
                                                  {"mu": o["g_f64"]["mu"]}))
        worst = max(gaps64, key=gaps64.get)
        rel = abs(float(o["g_f64"]["total"]) - float(l64["total"])) / \
            abs(float(l64["total"]))
        log(f"[parallel] (b) rank {r}: DP float64 G step (unfused) vs one "
            f"rank: total {rel:.3e} relative, Adam mu worst module {worst} "
            f"{gaps64[worst]:.3e} (tol {F64_MU_TOL:g})")
        check(gaps64[worst] <= F64_MU_TOL and rel <= F64_MU_TOL,
              f"rank {r} float64 DP G step: mu {gaps64[worst]:.3e}, total "
              f"{rel:.3e}")
    del s64
    # the bf16 DP G step by the bf16 rule: its drift from the f32 one-rank
    # step against the one-rank bf16 step's
    f16 = StepFactory(StepConfig(**TRAIN_CFG, fused_decoder=True,
                                 dtype=torch.bfloat16), layout=lay)
    s16, l16, p16 = f16.make_steps()["g"](f16.init(seed=seed), batch)
    truth = one.make_steps()["g"](one.init(seed=seed), batch)
    r_state, r_loss, r_pose = truth
    # the tensors (pose, mu a module) by the bf16 rule; the total is one
    # number whose terms were each rounded to bf16 once (the means of the
    # pose and GAN criteria), and two valid summation orders land on either
    # side of a rounding boundary (the rule's drifts 1.27e-3 against
    # 4.50e-3 at --seed 0 on an H100): it is held within one bf16 ULP of
    # its magnitude instead
    q_rep = {"pose": drift(p16, r_pose)}
    q_rep.update({f"mu {m}": v for m, v in
                  g_moment_gaps(r_state, s16)[0].items()})
    q_total = float(l16["total"])
    total_ulp = 2.0 ** (np.floor(np.log2(abs(q_total))) - 7)
    for r, o in enumerate(outs):
        snap = o["g_bf16"]
        p_state = state_from(f16, seed, {"mu": snap["mu"]})
        p_rep = {"pose": drift(snap["pose"].to(device), r_pose)}
        p_rep.update({f"mu {m}": v for m, v in
                      g_moment_gaps(r_state, p_state)[0].items()})
        fails = [k for k, dq in q_rep.items()
                 if abs(p_rep[k] - dq) > BF16_REL * dq + BF16_ABS]
        total_gap = abs(float(snap["total"]) - q_total)
        log(f"[parallel] (b) rank {r}: DP fused bf16 G step vs the one-rank "
            f"bf16 step, drift from the f32 step: pose {p_rep['pose']:.4e} "
            f"vs {q_rep['pose']:.4e}, mu worst module "
            f"{max(v for k, v in p_rep.items() if k.startswith('mu')):.4e}"
            f"; bf16 rule fails: {fails or 'none'}; total "
            f"{float(snap['total']):.6f} vs {q_total:.6f} (f32 "
            f"{float(r_loss['total']):.6f}), {total_gap:.4e} apart (one bf16 "
            f"ULP {total_ulp:g})")
        check(not fails and total_gap <= total_ulp,
              f"rank {r} DP bf16 G step: the bf16 rule fails on {fails}, "
              f"total {total_gap:.4e} from the one-rank step's")
    # (d) serving over ["cuda:0"] * 2, against one device
    devs = ["cuda:0"] * PAR_WORLD
    rng = np.random.default_rng(args.seed + 64)
    calib = (rng.normal(size=(B, T, MEL)).astype(np.float32),
             rng.integers(0, MODEL["num_speakers"], size=B).astype(np.int32))
    fns = {"batch": build_serving_fn(model, devices=devs),
           "expert": build_serving_fn(model, devices=devs,
                                      partition="expert"),
           "int8": build_serving_fn(model, devices=devs, quantize_int8=True,
                                    calib=calib),
           "time": build_serving_fn(model, devices=devs, partition="time")}
    one8 = build_serving_fn(model, quantize_int8=True, calib=calib)
    long_audio = rng.normal(size=(1, PAR_T_LONG, MEL)).astype(np.float32)
    long_style = styles[:1]
    refs = {"batch": serve(audio, styles), "expert": serve(audio, styles),
            "int8": one8(audio, styles),
            "time": plain(long_audio, long_style)}
    # cuDNN picks its algorithms by the batch's shape, so a device's share
    # is held bit for bit against the one-device call on the same rows
    half = B // PAR_WORLD
    shares = {name: torch.cat([fn(audio[i:i + half], styles[i:i + half])
                               for i in range(0, B, half)])
              for name, fn in (("batch", serve), ("int8", one8))}
    torch.cuda.synchronize()
    fcv.fused_mixstage_decoder.launches = 0         # serving path starts
    q8.fused_mixstage_decoder_int8.launches = 0
    got, serve_launches = {}, {}
    for name, fn in fns.items():
        before = (fcv.fused_mixstage_decoder.launches,
                  q8.fused_mixstage_decoder_int8.launches)
        got[name] = fn(long_audio, long_style) if name == "time" \
            else fn(audio, styles)
        torch.cuda.synchronize()
        serve_launches[name] = [
            (fcv.fused_mixstage_decoder.launches - before[0]) / PAR_WORLD,
            (q8.fused_mixstage_decoder_int8.launches - before[1])
            / PAR_WORLD]
    k1_par = fcv.fused_mixstage_decoder.launches     # serving path ends
    k4_par = q8.fused_mixstage_decoder_int8.launches
    want = {"batch": [2, 0], "expert": [2, 0], "int8": [1, 1],
            "time": [0, 0]}
    check(serve_launches == want, f"serving launches per device (K1, K4) "
          f"{serve_launches}, expected {want}")
    errs, ndiff = {}, {}
    for name, share in shares.items():
        ndiff[name] = int((got[name] != share).sum())
        check(ndiff[name] == 0, f"{name} partition: {ndiff[name]} elements "
              f"differ from the one-device call on each device's rows")
    for name in fns:
        out, ref = got[name], refs[name]
        check(tuple(out.shape) == tuple(ref.shape) and
              bool(torch.isfinite(out).all()), f"{name} serving pose")
        if name == "int8":
            # against the whole batch in one call, where cuDNN's other
            # algorithms move the features and the int8 tier amplifies a
            # flipped LSB: the mean at the int8-route limit, the max logged
            mean_e, max_e, _, _ = int8_errors(out, ref)
            errs[name] = (mean_e, max_e)
            check(mean_e <= INT8_MEAN_TOL, f"int8 batch partition vs one "
                  f"device: mean {mean_e:.3e}")
        else:
            errs[name] = float((out - ref).abs().max() / ref.abs().max())
            check(errs[name] <= KERNEL_TOL, f"{name} partition vs one "
                  f"device: {errs[name]:.3e}")
    log(f"[parallel] (d) serving on {devs} (one card twice): batch (K1) "
        f"and int8 batch (K1 + K4) against the one-device call on each "
        f"device's rows: {ndiff['batch']} and {ndiff['int8']} elements "
        f"differ; against one call on the whole batch: batch "
        f"{errs['batch']:.3e}, expert (K1 at "
        f"{MODEL['num_clusters'] // PAR_WORLD} groups a device) "
        f"{errs['expert']:.3e} (max|diff|/max|ref|, tol {KERNEL_TOL:g}); "
        f"int8 batch (K1 + K4) mean {errs['int8'][0]:.3e} (tol "
        f"{INT8_MEAN_TOL:g}) / max {errs['int8'][1]:.3e} of mean|ref|; "
        f"time B=1 T={PAR_T_LONG} over "
        f"{PAR_WORLD} shards (plain route, halo {time_halo(model)} "
        f"frames) {errs['time']:.3e}; launches per device (K1, K4) "
        f"{serve_launches}")

    # (e) timings
    audio_dev = torch.as_tensor(audio, device=device)
    styles_dev = torch.as_tensor(styles, device=device)
    call_ms = {name: cuda_ms(torch, lambda f=fn: f(audio_dev, styles_dev),
                             reps=10)
               for name, fn in fns.items() if name != "time"}
    call_ms["one"] = cuda_ms(torch, lambda: serve(audio_dev, styles_dev),
                             reps=10)
    dbatch = {k: (tuple(torch.as_tensor(a_, device=device) for a_ in v)
                  if k == "x" else torch.as_tensor(v, device=device))
              for k, v in batch.items()}
    steps1 = one.make_steps()
    one_ms = cuda_ms(torch, lambda: steps1["g"](s1d, dbatch), reps=10)
    rec.update(dict(dp_g_step_ms=[rep["g_step_ms"] for rep in reports],
                    one_rank_g_step_ms=one_ms, serving_ms=call_ms,
                    serving_errors=errs, serving_launches=serve_launches))
    log(f"[timing] {smi}: phase 24 fused f32 G step bs{B} T{T}, CUDA "
        f"events, mean of 10: two ranks sharing this one card over gloo "
        f"(not a scaling measurement) "
        + ", ".join(f"rank {r} {rep['g_step_ms']:.3f} ms"
                    for r, rep in enumerate(reports))
        + f"; one rank {one_ms:.3f} ms")
    log(f"[timing] {smi}: phase 24 bs{B} serving call, mean of 10: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in call_ms.items())
        + " (two devices are the one card)")
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[parallel] phase 24 in {rec['phase_s']:.1f} s")
    results["parallel"] = rec
    return {"k3_per_rank": [rep["k3_path"] for rep in reports],
            "k1": k1_par, "k4": k4_par,
            "per_device": serve_launches}


# phase 25: the two ends of the lifecycle (rendering, JAX checkpoints,
# data preparation)
ENDS_INTERVAL_S = 8.0        # phase 25's synthetic intervals: 120 frames
ENDS_STEPS = 2               # its cli.train's -debug (3 G or D steps)
ENDS_RENDER_LIST = 3         # intervals cli.render renders
RASTER_FRAMES = 64           # (a): prediction beside ground truth


def cli_config(argv):
    """A ``Config`` as ``argparse_n_loop`` hands it to a CLI's loop: the
    flags typed on the command line kept over a restored checkpoint's."""
    from mixstage_tpu_torch.config import (_typed_flag_names,
                                           config_from_dict, get_args_perm)

    _, perms = get_args_perm(argv)
    cfg = config_from_dict(perms[0])
    cfg.typed_flags = _typed_flag_names(argv)
    return cfg


def host_cpu() -> str:
    """The host CPU's model name (``/proc/cpuinfo``, else ``lscpu``), its
    architecture and logical core count."""
    import platform

    name = None
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.lower().startswith("model name"):
                    name = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    if not name and shutil.which("lscpu"):
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=30).stdout
        name = next((ln.split(":", 1)[1].strip() for ln in out.splitlines()
                     if ln.lower().startswith("model name")), None)
    return (f"{name or 'model not reported'} ({platform.machine()}), "
            f"{os.cpu_count()} logical cores")


def palette_frames(raster, frames):
    """``frames`` through the GIF palette (each colour's nearest entry),
    what a GIF of them decodes to."""
    pal = raster.gif_palette().astype(np.int64)
    keys = ((frames[..., 0].astype(np.uint32) << 16)
            | (frames[..., 1].astype(np.uint32) << 8) | frames[..., 2])
    present = np.zeros(1 << 24, bool)
    present[keys.reshape(-1)] = True
    colors = np.flatnonzero(present)
    lut = np.zeros((1 << 24, 3), np.uint8)
    for i in range(0, len(colors), 8192):        # bounded memory
        c = colors[i:i + 8192]
        rgb = np.stack([c >> 16, (c >> 8) & 255, c & 255], -1)
        lut[c] = pal[((rgb[:, None, :] - pal) ** 2).sum(-1).argmin(-1)]
    return lut[keys]


def decode_gif_frames(raster, data: bytes):
    """A GIF's frames, by PIL where it is installed, else by the port's own
    reader; returns (frames, reader)."""
    try:
        import io

        from PIL import Image, ImageSequence
    except ImportError:
        return np.stack(raster.decode_gif(data)), "the port's reader"
    with Image.open(io.BytesIO(data)) as im:
        return np.stack([np.asarray(f.convert("RGB"))
                         for f in ImageSequence.Iterator(im)]), "PIL"


def lifecycle_ends_phase(torch, args, smi, results) -> dict:
    """Phase 25: the two ends of the lifecycle at full width.  (a) the
    rasteriser (host C++) against its numpy plain version, the GIF
    encoder; (b) ``cli.train -fused_decoder 1 -render 1`` (K3) and its
    videos; (c) ``cli.render -load`` of that experiment; (d) a JAX-format
    (flax msgpack) checkpoint of its weights served by ``cli.serve -load``
    (K1; K1 and K4 with ``-serve_int8 1``) and sampled by ``cli.sample``;
    (e) ``cli.preprocess`` and ``cli.delete_keys`` on a raw tree.  Returns
    the launches of K3 (fwd, bwd) over (b) and of K1 and K4 over (d)'s
    servers."""
    import importlib.util
    import shutil
    from pathlib import Path

    if "h5py" not in sys.modules and importlib.util.find_spec("h5py") is None:
        install_h5py_stand_in()
    stand_in = not hasattr(sys.modules.get("h5py") or __import__("h5py"),
                           "__version__")
    from mixstage_tpu_torch.animation import raster
    from mixstage_tpu_torch.bookkeeping import weights_of
    from mixstage_tpu_torch.cli import delete_keys as cli_delete
    from mixstage_tpu_torch.cli import preprocess as cli_pre
    from mixstage_tpu_torch.cli import render as cli_render
    from mixstage_tpu_torch.cli import sample as cli_sample
    from mixstage_tpu_torch.cli import serve as cli_serve
    from mixstage_tpu_torch.cli import train as cli_train
    from mixstage_tpu_torch.data.common import SPEAKERS
    from mixstage_tpu_torch.data.hdf5 import HDF5
    from mixstage_tpu_torch.data.skeleton import PARENTS
    from mixstage_tpu_torch.data.synthetic import make_synthetic_dataset
    from mixstage_tpu_torch.interop.flax_msgpack import packb, unpackb
    from mixstage_tpu_torch.interop.weights import to_flax_state
    from mixstage_tpu_torch.ops.cuda import train_decoder as td
    from mixstage_tpu_torch.ops.cuda.fused_conv import \
        fused_mixstage_decoder as k1
    from mixstage_tpu_torch.ops.cuda.quant import \
        fused_mixstage_decoder_int8 as k4
    from mixstage_tpu_torch.serve import build_serving_fn
    from mixstage_tpu_torch.serving import PoseClient
    from mixstage_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    secs, rec = {}, {}
    root = Path(__file__).resolve().parent / "build" / "lifecycle_ends"
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(args.seed + 25)
    cpu = host_cpu()
    log(f"[ends] host: {cpu}; h5 files "
        f"{'through the stand-in h5py' if stand_in else 'by h5py'}")
    extras = {m: importlib.util.find_spec(m) is not None
              for m in ("PIL", "matplotlib", "soundfile")}
    log(f"[ends] optional host libraries: "
        + ", ".join(f"{m} {'present' if v else 'absent'}"
                    for m, v in extras.items())
        + f"; ffmpeg {'present' if shutil.which('ffmpeg') else 'absent'}")

    # (a) the rasteriser ---------------------------------------------------
    t = time.perf_counter()
    lib_path = raster.build(force=True)
    build_s = time.perf_counter() - t
    walk = np.cumsum(rng.normal(size=(2, RASTER_FRAMES, 2, 52)), 1) * 25 \
        + rng.normal(size=(2, 1, 2, 52)) * 120
    pred, gt = walk[0], walk[1]
    raster.rasterize([pred[:2], gt[:2]], PARENTS)             # warm
    t = time.perf_counter()
    frames = raster.rasterize([pred, gt], PARENTS)
    cpp_ms = (time.perf_counter() - t) * 1e3 / RASTER_FRAMES
    t = time.perf_counter()
    plain = raster.rasterize_plain([pred, gt], PARENTS)
    plain_ms = (time.perf_counter() - t) * 1e3 / RASTER_FRAMES
    differ = float((frames != plain).any(-1).mean())
    check(frames.shape == (RASTER_FRAMES, 480, 960, 3) and differ == 0.0,
          f"[ends] rasteriser {frames.shape} differs from its plain version "
          f"at {differ:.3e} of the pixels")
    t = time.perf_counter()
    gif = raster.encode_gif(frames, max(2, round(100 / 15))) + b"\x3b"
    gif_ms = (time.perf_counter() - t) * 1e3 / RASTER_FRAMES
    decoded, reader = decode_gif_frames(raster, gif)
    check(decoded.shape == frames.shape and bool(np.array_equal(
        decoded, palette_frames(raster, frames))),
        f"[ends] the GIF ({reader}) does not decode to the palette's frames")
    ran = {}
    if extras["PIL"]:             # captions and the AVI writer need PIL
        from mixstage_tpu_torch.animation import aviwriter
        from mixstage_tpu_torch.data.common import Table

        words = Table({"Word": ["gestures", "carry", "style"],
                       "start_frame": [0, 20, 40],
                       "end_frame": [20, 40, RASTER_FRAMES]})
        capt = raster.overlay_captions(frames, words)
        strip = capt[:, frames.shape[1]:]
        check(capt.shape[1] == frames.shape[1] + raster.CAPTION_H and
              bool((strip < 128).any()) and
              bool(np.array_equal(capt[:, :frames.shape[1]], frames)),
              "[ends] captions")
        avi = root / "clip.avi"
        root.mkdir(parents=True, exist_ok=True)
        pcm = (rng.normal(size=16000 * RASTER_FRAMES // 15) * 3000).astype(
            np.int16)
        w = aviwriter.AviWriter(str(avi), fps=15)
        w.add(capt)
        w.set_audio(pcm, 16000)
        w.close()
        parsed = aviwriter.parse_avi(str(avi))
        check(len(parsed["frames"]) == RASTER_FRAMES and
              parsed["pcm"] == pcm.tobytes(), "[ends] AVI")
        ran["captions"] = ran["AVI"] = "ran (PIL present)"
    else:
        ran["captions"] = ran["AVI"] = "not run (PIL absent)"
    secs["a"] = time.perf_counter() - t_phase
    log(f"[ends] (a) {smi}: rasteriser library {lib_path.name} built by g++ "
        f"in {build_s:.2f} s; {RASTER_FRAMES} frames of 52 joints, "
        f"prediction beside ground truth (480 x 960): C++ "
        f"{cpp_ms:.3f} ms a frame, numpy plain version {plain_ms:.3f} ms a "
        f"frame, equal frames; GIF encoder {gif_ms:.3f} ms a frame "
        f"({len(gif)} bytes), decoded by {reader} to the palette's frames; "
        f"host {cpu}")
    rec["raster"] = dict(build_s=build_s, cpp_ms_per_frame=cpp_ms,
                         plain_ms_per_frame=plain_ms,
                         gif_ms_per_frame=gif_ms, gif_bytes=len(gif),
                         reader=reader, cpu=cpu)

    # (b) cli.train -fused_decoder 1 -render 1 ------------------------------
    t_b = time.perf_counter()
    data = str(root / "data")
    speakers = SPEAKERS[:MODEL["num_speakers"]]
    make_synthetic_dataset(data, speakers, LIFE_INTERVALS,
                           interval_seconds=ENDS_INTERVAL_S,
                           seed=11212 + args.seed)
    save = str(root / "save")
    argv = ["-path2data", data, "-speaker", json.dumps(speakers),
            "-model", "JointLateClusterSoftStyle4_G", "-gan", "1",
            "-loss", "L1Loss", "-num_clusters", str(MODEL["num_clusters"]),
            "-batch_size", str(B), "-fused_decoder", "1", "-num_epochs", "1",
            "-window_hop", "5", "-debug", str(ENDS_STEPS), "-num_iters", "2",
            "-save_dir", save, "-exp", "1", "-seed",
            str(11212 + args.seed), "-render", "1"]
    seen = {"train": [], "sample": []}
    orig = {name: getattr(Trainer, name) for name in seen}

    def keep(name):
        def run(self, exp_num):
            orig[name](self, exp_num)
            seen[name].append(self)
        return run
    for name in seen:
        setattr(Trainer, name, keep(name))
    try:
        td.decoder_train_fwd.launches = 0          # -render 1 path starts
        td.decoder_train_bwd.launches = 0
        cli_train.main(argv)
        torch.cuda.synchronize()
        k3 = (td.decoder_train_fwd.launches,       # -render 1 path ends
              td.decoder_train_bwd.launches)
    finally:
        for name, fn in orig.items():
            setattr(Trainer, name, fn)
    trainer, sampler = seen["train"][0], seen["sample"][-1]
    g_steps = trainer.state.g_step
    check(g_steps > 0 and k3 == (g_steps, g_steps),
          f"[ends] K3 launches {k3} over cli.train -render 1, expected one "
          f"each way per G step ({g_steps})")
    exp_dir = Path(sampler.dir_name)
    kp_files = [f for d in sorted(exp_dir.glob("keypoints*"))
                for f in sorted(d.rglob("*.h5"))]
    gifs = sorted(exp_dir.glob("render*/*/*/*.gif"))
    check(len(kp_files) == 2 * len(speakers) * LIFE_INTERVALS and
          len(gifs) == min(10, len(kp_files)) and
          (exp_dir / "videos.html").exists(),
          f"[ends] -render 1 wrote {len(gifs)} GIFs for {len(kp_files)} "
          f"keypoint files, videos.html "
          f"{(exp_dir / 'videos.html').exists()}")
    first = kp_files[0]
    y = HDF5.load_array(str(first), "pose/data").reshape(-1, 2, 52)
    sub = first.parent.parent.parent.name.replace("keypoints", "render")
    rendered = (exp_dir / sub / first.parent.parent.name / first.parent.name
                / f"{first.stem}.gif")
    cpp_frames = raster.rasterize(y, PARENTS)
    plain_frames = raster.rasterize_plain(y, PARENTS)
    got, reader = decode_gif_frames(raster, rendered.read_bytes())
    check(bool(np.array_equal(cpp_frames, plain_frames)) and
          got.shape == cpp_frames.shape and
          bool(np.array_equal(got, palette_frames(raster, cpp_frames))),
          f"[ends] {rendered.name}: the C++ frames, their plain version and "
          f"the GIF disagree")
    secs["b"] = time.perf_counter() - t_b
    log(f"[ends] (b) cli.train -fused_decoder 1 -render 1 (flagship at full "
        f"width, {B}-window batches, -debug {ENDS_STEPS}, "
        f"{len(speakers)} speakers x {LIFE_INTERVALS} intervals of "
        f"{ENDS_INTERVAL_S:g} s): K3 launches (fwd, bwd) {k3} = {g_steps} G "
        f"steps; {len(gifs)} GIFs for {len(kp_files)} keypoint files "
        f"(at most 10) and videos.html; interval {first.stem} "
        f"({y.shape[0]} frames) re-rasterised: C++ = plain version, its GIF "
        f"({reader}) = the palette's frames")
    rec["render_train"] = dict(k3_launches=k3, g_steps=g_steps,
                               gifs=len(gifs), keypoint_files=len(kp_files))

    # (c) cli.render -load ------------------------------------------------
    t_c = time.perf_counter()
    weights = trainer.book.name("weights", "p", save)
    for d in exp_dir.glob("render*"):
        shutil.rmtree(d)
    ids = sorted({f.stem for f in kp_files})[:ENDS_RENDER_LIST]
    listing = root / "render_list.txt"
    listing.write_text("\n".join(ids))
    render_argv = ["-load", weights, "-path2data", data, "-render", "1",
                   "-render_list", str(listing)]
    cli_render.main(render_argv)
    written = {p: p.stat().st_mtime_ns
               for p in exp_dir.glob("render*/*/*/*.gif")}
    want = set()
    for f in kp_files:
        if f.stem in ids:
            sub = f.parent.parent.parent.name.replace("keypoints", "")
            split, spk = f.parent.parent.name, f.parent.name
            for kind in ("render", "render_eval"):
                want.add(exp_dir / (kind + sub) / split / spk
                         / f"{f.stem}.gif")
    check(set(written) == want,
          f"[ends] cli.render wrote {sorted(p.name for p in written)}, "
          f"expected {len(want)} files")
    cli_render.main([*render_argv, "-clean_render", "0"])
    again = {p: p.stat().st_mtime_ns
             for p in exp_dir.glob("render*/*/*/*.gif")}
    check(again == written,
          "[ends] cli.render -clean_render 0 wrote files again")
    secs["c"] = time.perf_counter() - t_c
    log(f"[ends] (c) cli.render -load -render 1 -render_list ({len(ids)} "
        f"intervals): {len(written)} GIFs, prediction beside ground truth "
        f"under render*/ and alone under render_eval*/ for keypoints/ and "
        f"keypoints_style/; -clean_render 0 again: nothing new")

    # (d) a JAX checkpoint served and sampled -----------------------------
    t_d = time.perf_counter()
    prefix = sampler.book.name.prefix
    jax_dir = root / "jax_exp"
    jax_dir.mkdir()
    flax = {m: to_flax_state(getattr(sampler.state, m))
            for m in ("gen", "psenc", "disc")}
    blob = packb({"g_params": {m: flax[m][0] for m in ("gen", "psenc")},
                  "g_state": {m: flax[m][1] for m in ("gen", "psenc")},
                  "d_params": flax["disc"][0], "d_state": flax["disc"][1]})
    jax_weights = jax_dir / f"{prefix}_weights.p"
    jax_weights.write_bytes(blob)
    shutil.copy(Path(save) / f"{prefix}_args.args",
                jax_dir / f"{prefix}_args.args")
    check(sorted(unpackb(blob)) == ["d_params", "d_state", "g_params",
                                    "g_state"], "[ends] packb's tree")
    restored = Trainer(cli_config(["-load", str(jax_weights), "-path2data",
                                   data]),
                       ["exp", "cpk", "speaker", "model", "note"],
                       {"window_hop": 0, "render": 0})
    w_ref, w_jax = weights_of(sampler.state), weights_of(restored.state)
    check(all(torch.equal(v, w_jax[m][k]) for m in w_ref
              for k, v in w_ref[m].items()),
          "[ends] the JAX-format checkpoint does not restore the weights "
          "bit for bit")
    model = restored.state.gen
    S = MODEL["num_speakers"]
    onehot = np.eye(S, dtype=np.float32)
    soft = rng.dirichlet(np.ones(S)).astype(np.float32)
    direct = {"f32": build_serving_fn(model),
              "int8": build_serving_fn(model, quantize_int8=True,
                                       calib=cli_serve._calib_windows(
                                           restored, 8))}
    modes = {"f32": ([], (2, 0)), "int8": (["-serve_int8", "1"], (1, 1))}
    served, errs = {}, {}
    for mode, (extra, per_batch) in modes.items():
        server, batchers = cli_serve.build(cli_config(
            ["-load", str(jax_weights), "-path2data", data, "-serve_port",
             "0", *extra]))
        reqs = [("json", rng.normal(size=(64, MEL)).astype(np.float32), 1),
                ("npz", rng.normal(size=(100, MEL)).astype(np.float32),
                 soft)]
        try:
            client = PoseClient(
                f"http://127.0.0.1:{server.server_address[1]}",
                timeout_s=600)
            for b in batchers:
                b.batches = 0
            k1.launches = k4.launches = 0          # this server's path starts
            got = [(client.pose if kind == "npz" else client.pose_json)(
                a, style=sty) for kind, a, sty in reqs]
            torch.cuda.synchronize()
            n = (k1.launches, k4.launches)         # this server's path ends
            nb = sum(b.batches for b in batchers)
        finally:
            server.shutdown()
            server.server_close()
            for b in batchers:
                b.close()
        check(n == tuple(c * nb for c in per_batch),
              f"[ends] {mode}: (K1, K4) launches {n} over {nb} batches")
        served[mode] = n
        worst = 0.0
        for (kind, a, sty), pose in zip(reqs, got):
            bucket = 64 if a.shape[0] <= 64 else 128
            padded = np.concatenate(
                [a, np.repeat(a[-1:], bucket - a.shape[0], 0)])
            rows = onehot[sty] if np.ndim(sty) == 0 else sty
            want_pose = direct[mode](np.repeat(padded[None], B, axis=0),
                                     np.repeat(rows[None], B, axis=0))
            want_pose = want_pose[0].float().cpu().numpy()[:a.shape[0]]
            check(pose.shape == want_pose.shape, f"[ends] {mode} {kind}")
            worst = max(worst, float(np.abs(pose - want_pose).max()))
        errs[mode] = worst
        check(worst == 0.0, f"[ends] {mode}: served poses differ from the "
              f"direct call by {worst:.3e}")
    sample_dir = root / "jax_sample"
    cli_sample.main(["-load", str(jax_weights), "-path2data", data,
                     "-save_dir", str(sample_dir)])
    ours = sorted((sample_dir / prefix).glob("keypoints*/*/*/*.h5"))
    same = all(np.array_equal(
        HDF5.load_array(str(f), "pose/data"),
        HDF5.load_array(str(exp_dir / f.relative_to(sample_dir / prefix)),
                        "pose/data")) for f in ours)
    check(len(ours) == len(kp_files) and same,
          f"[ends] cli.sample of the JAX checkpoint: {len(ours)} keypoint "
          f"files, equal to (b)'s {same}")
    secs["d"] = time.perf_counter() - t_d
    log(f"[ends] (d) a flax-msgpack PREFIX_weights.p ({len(blob)} bytes, "
        f"packb of to_flax_state) restores the weights bit for bit; "
        f"cli.serve -load of it: f32 and -serve_int8 1 answers (JSON, npz) "
        f"equal the direct call at bs{B}, max|diff| f32 {errs['f32']:.3e}, "
        f"int8 {errs['int8']:.3e}; (K1, K4) launches f32 {served['f32']}, "
        f"int8 {served['int8']}; cli.sample of it: {len(ours)} keypoint "
        f"files equal to (b)'s bit for bit")
    rec["jax_checkpoint"] = dict(bytes=len(blob), errors=errs,
                                 launches=served)

    # (e) cli.preprocess and cli.delete_keys -------------------------------
    t_e = time.perf_counter()
    raw = root / "raw"
    pre_speakers = speakers[:2]
    make_synthetic_dataset(str(raw), pre_speakers, 2, interval_seconds=2.0,
                           with_raw_keypoints=True, with_raw_audio=True,
                           seed=args.seed)
    shutil.rmtree(raw / "processed")
    common = ["-path2data", str(raw), "-path2outdata", str(raw),
              "-speaker", json.dumps(pre_speakers)]
    for method in ("data", "normalize", "confidence"):
        cli_pre.main([*common, "-modalities", '["pose"]',
                      "-preprocess_methods", f'["{method}"]'])
    files = sorted((raw / "processed").rglob("*.h5"))
    keys = ("pose/data", "pose/normalize", "pose/confidence")
    ok = len(files) == 2 * len(pre_speakers) and all(
        HDF5.isDatasetInFile(str(f), k) and
        HDF5.load_array(str(f), k).shape == (31, 104)
        for f in files for k in keys)
    check(ok, f"[ends] cli.preprocess pose: {len(files)} files without "
          f"{keys} of (31, 104)")
    if extras["soundfile"]:
        for wav in (raw / "raw").rglob("*.wav"):
            shutil.copy(wav, wav.with_suffix(".mp3"))   # read by content
        cli_pre.main([*common, "-modalities", '["audio"]',
                      "-preprocess_methods", '["log_mel_512"]'])
        audio_ok = all(HDF5.isDatasetInFile(str(f), "audio/log_mel_512")
                       for f in files)
        check(audio_ok, "[ends] cli.preprocess audio: no audio/log_mel_512")
        audio = "ran (soundfile present): audio/log_mel_512 in every file"
    else:
        audio = "not run (soundfile absent)"
    ran["audio preprocessing"] = audio
    cli_delete.main([*common, "-modalities", '["pose"]',
                     "-preprocess_methods", '["normalize"]'])
    check(all(not HDF5.isDatasetInFile(str(f), "pose/normalize") and
              HDF5.isDatasetInFile(str(f), "pose/data") for f in files),
          "[ends] cli.delete_keys left pose/normalize")
    secs["e"] = time.perf_counter() - t_e
    log(f"[ends] (e) cli.preprocess on a raw tree ({len(pre_speakers)} "
        f"speakers x 2 intervals of 2 s, txt frames and OpenPose YAML "
        f"dumps): pose data, normalize and confidence (the YAML branch) in "
        f"every file; audio {audio}; cli.delete_keys removed "
        f"pose/normalize")
    log("[ends] optional paths: " + "; ".join(f"{k} {v}"
                                             for k, v in ran.items()))
    shutil.rmtree(root, ignore_errors=True)
    total = time.perf_counter() - t_phase
    log(f"[ends] sub-phase seconds: " + ", ".join(
        f"({k}) {v:.1f} s" for k, v in secs.items()))
    log(f"[ends] phase 25 in {total:.1f} s")
    rec.update(seconds=secs, total_s=total, optional=ran)
    results["lifecycle_ends"] = rec
    return {"k3": k3, "k1": served["f32"][0] + served["int8"][0],
            "k4": served["int8"][1]}


# phase 26: the long tail (the C++ gatherer, orbax checkpoints, the other
# layers, centered RMSprop, text preprocessing)
GATHER_REPS = 200            # (a): timed bs32 x 64 gathers per route
ORBAX_REPS = 3               # (b): timed writes and reads of the checkpoint
RMS_KW = (("centered", True), ("bias_correction", True),
          ("initial_scale", 0.1))
FIXTURE = Path(__file__).resolve().parent / "tests" / "orbax_fixture"


def _ms_per_call(fn, reps):
    fn()                                              # warm
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t) * 1e3 / reps


def long_tail_phase(torch, args, device, smi, results) -> dict:
    """Phase 26: what the last slice ported, at full width.  (a) the C++
    window gatherer (g++ build, a bs32 x 64 pose and audio batch and its
    ZNorm, bit for bit with the numpy versions, both timed); (b)
    ``cli.train -fused_decoder 1 -ckpt_backend orbax -save_optim 1`` (K3)
    writing ``PREFIX_weights.orbax``, the write and read timed, a resume
    from it at the saved step bit for bit, ``cli.serve -load`` of it in
    f32 (K1) and ``-serve_int8 1`` (K1, K4) answering bit for bit with the
    direct call, ``cli.sample -load`` of it writing the trainer's
    keypoints bit for bit; (c) ``PoseDecoder`` (8 groups x (256 + 10))
    and ``StyleDecoder`` (10 groups x 256) at bs32 x 64 on the card
    against the CPU; (d) a fused G step with centered, bias-corrected
    RMSprop (K3) and the card's update against the CPU's; (e)
    ``cli.preprocess`` of text, not aligned then aligned; (f) the
    committed OCDBT directory JAX's orbax wrote, against its checksums.
    Returns the launches of K3 (fwd, bwd) over (b) and (d), of K1 and K4
    over (b)'s servers."""
    import copy
    import hashlib
    import importlib.util
    import warnings

    if "h5py" not in sys.modules and importlib.util.find_spec("h5py") is None:
        install_h5py_stand_in()
    from mixstage_tpu_torch.bookkeeping import read_checkpoint
    from mixstage_tpu_torch.cli import preprocess as cli_pre
    from mixstage_tpu_torch.cli import sample as cli_sample
    from mixstage_tpu_torch.cli import serve as cli_serve
    from mixstage_tpu_torch.cli import train as cli_train
    from mixstage_tpu_torch.data import native
    from mixstage_tpu_torch.data import text as ptext
    from mixstage_tpu_torch.data.common import SPEAKERS
    from mixstage_tpu_torch.data.hdf5 import HDF5
    from mixstage_tpu_torch.data.synthetic import make_synthetic_dataset
    from mixstage_tpu_torch.interop import orbax
    from mixstage_tpu_torch.interop.weights import full_tree_of
    from mixstage_tpu_torch.models.layers import (PoseDecoder, StyleDecoder,
                                                  reset_parameters_)
    from mixstage_tpu_torch.ops.cuda import train_decoder as td
    from mixstage_tpu_torch.ops.cuda.fused_conv import \
        fused_mixstage_decoder as k1
    from mixstage_tpu_torch.ops.cuda.quant import \
        fused_mixstage_decoder_int8 as k4
    from mixstage_tpu_torch.serve import build_serving_fn
    from mixstage_tpu_torch.serving import PoseClient
    from mixstage_tpu_torch.train import StepConfig, StepFactory
    from mixstage_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    secs, rec = {}, {}
    root = Path(__file__).resolve().parent / "build" / "long_tail"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    rng = np.random.default_rng(args.seed + 26)
    cpu = host_cpu()

    # (a) the C++ window gatherer ----------------------------------------
    t = time.perf_counter()
    lib = native.build(force=True)
    build_s = time.perf_counter() - t
    pose = rng.normal(size=(375, 104)) * 50        # a 25 s interval, 15 fps
    audio = rng.normal(size=(2225, MEL))           # its log-mel, ~89 fps
    starts = np.sort(rng.integers(0, 375 - T, size=B))
    a_starts = starts * 6                          # stride round(89 / 15)
    mean, var = pose.mean(0), pose.var(0)
    mask = [0, 7, 8, 9]

    def batch(gather):
        return gather(pose, starts, T, 1), gather(audio, a_starts, T, 6)
    got, want = batch(native.gather_windows), batch(
        native.gather_windows_plain)
    check(all(np.array_equal(g, w) for g, w in zip(got, want)) and
          got[0].shape == (B, T, 104) and got[1].shape == (B, T, MEL),
          "[tail] the gatherer differs from its numpy version")
    zm = native.znorm_mask(got[0], mean, var, mask)
    zf = native.znorm_f32(got[1], audio.mean(0), audio.var(0))
    check(np.array_equal(zm, native.znorm_mask_plain(got[0], mean, var, mask))
          and np.array_equal(zf, native.znorm_f32_plain(
              got[1], audio.mean(0), audio.var(0))),
          "[tail] the library's ZNorm differs from its numpy version")
    gms = {name: _ms_per_call(lambda: batch(fn), GATHER_REPS)
           for name, fn in (("cpp", native.gather_windows),
                            ("numpy", native.gather_windows_plain))}
    zms = {"cpp": _ms_per_call(lambda: native.znorm_mask(
                got[0], mean, var, mask), GATHER_REPS),
           "numpy": _ms_per_call(lambda: native.znorm_mask_plain(
                got[0], mean, var, mask), GATHER_REPS)}
    secs["a"] = time.perf_counter() - t_phase
    log(f"[tail] (a) {smi}: gatherer {lib.name} built by g++ in "
        f"{build_s:.2f} s; a bs{B} x {T} batch (pose 104 + audio {MEL} "
        f"wide, stride 1 and 6) gathers in {gms['cpp']:.4f} ms (numpy "
        f"{gms['numpy']:.4f} ms), its pose ZNorm + joint mask in "
        f"{zms['cpp']:.4f} ms (numpy {zms['numpy']:.4f} ms), equal "
        f"arrays; host {cpu}")
    rec["gatherer"] = dict(build_s=build_s, gather_ms=gms, znorm_ms=zms,
                           cpu=cpu)

    # (b) cli.train -ckpt_backend orbax, then serve, sample, resume --------
    t_b = time.perf_counter()
    data = str(root / "data")
    speakers = SPEAKERS[:MODEL["num_speakers"]]
    make_synthetic_dataset(data, speakers, LIFE_INTERVALS,
                           interval_seconds=ENDS_INTERVAL_S,
                           seed=11212 + args.seed)
    save = str(root / "save")
    argv = ["-path2data", data, "-speaker", json.dumps(speakers),
            "-model", "JointLateClusterSoftStyle4_G", "-gan", "1",
            "-loss", "L1Loss", "-num_clusters", str(MODEL["num_clusters"]),
            "-batch_size", str(B), "-fused_decoder", "1", "-num_epochs", "1",
            "-window_hop", "5", "-debug", str(ENDS_STEPS), "-num_iters", "2",
            "-save_dir", save, "-exp", "1", "-seed", str(11212 + args.seed),
            "-ckpt_backend", "orbax", "-save_optim", "1"]
    seen = {"train": [], "sample": []}
    orig = {name: getattr(Trainer, name) for name in seen}

    def keep(name):
        def run(self, exp_num):
            orig[name](self, exp_num)
            seen[name].append(self)
        return run
    for name in seen:
        setattr(Trainer, name, keep(name))
    try:
        td.decoder_train_fwd.launches = 0          # -ckpt_backend orbax
        td.decoder_train_bwd.launches = 0          # path starts
        cli_train.main(argv)
        torch.cuda.synchronize()
        k3 = (td.decoder_train_fwd.launches,       # path ends
              td.decoder_train_bwd.launches)
    finally:
        for name, fn in orig.items():
            setattr(Trainer, name, fn)
    trainer, sampler = seen["train"][0], seen["sample"][-1]
    g_steps = trainer.state.g_step
    check(g_steps > 0 and k3 == (g_steps, g_steps),
          f"[tail] K3 launches {k3} over cli.train -ckpt_backend orbax, "
          f"expected one each way per G step ({g_steps})")
    opath = trainer.book._orbax_path()
    meta = json.loads((Path(opath) / "_METADATA").read_text())
    nbytes = sum(f.stat().st_size for f in Path(opath).rglob("*")
                 if f.is_file())
    check(os.path.isdir(opath) and meta["use_ocdbt"] is False and
          not os.path.exists(trainer.book.name("weights", "p", save)),
          f"[tail] {opath}: not the port's orbax directory")
    tree = read_checkpoint(opath)[1]
    write_s, read_s = [], []
    for i in range(ORBAX_REPS):
        t = time.perf_counter()
        orbax.write_directory(str(root / f"timed_{i}.orbax"),
                              full_tree_of(trainer.state))
        write_s.append(time.perf_counter() - t)
        t = time.perf_counter()
        read_checkpoint(opath)
        read_s.append(time.perf_counter() - t)
    resumed = Trainer(cli_config(["-load", opath, "-path2data", data,
                                  "-save_optim", "1"]),
                      ["exp", "cpk", "speaker", "model", "note"],
                      {"window_hop": 0, "render": 0})
    # the resumed state, written and read back, against the directory
    stored = {n: (a, d) for n, a, d in orbax.array_leaves(tree)}
    orbax.write_directory(str(root / "resumed.orbax"),
                          full_tree_of(resumed.state))
    mine = {n: (a, d) for n, a, d in orbax.array_leaves(
        read_checkpoint(str(root / "resumed.orbax"))[1])}
    timed = {n for n, _, _ in orbax.array_leaves(
        read_checkpoint(str(root / "timed_0.orbax"))[1])}
    same = sorted(mine) == sorted(stored) == sorted(timed) and all(
        mine[n][1] == stored[n][1] and np.array_equal(mine[n][0],
                                                      stored[n][0])
        for n in stored)
    counters = {k: int(stored[f"train.counters.{k}"][0])
                for k in ("step", "g_step", "lambda_step",
                          "curriculum_step")}
    check(same and counters["step"] > 0 and
          counters == {k: getattr(resumed.state, k) for k in counters},
          f"[tail] the resume from {Path(opath).name} differs from the "
          f"checkpoint (counters {counters})")
    model = resumed.state.gen
    S = MODEL["num_speakers"]
    onehot = np.eye(S, dtype=np.float32)
    soft = rng.dirichlet(np.ones(S)).astype(np.float32)
    direct = {"f32": build_serving_fn(model),
              "int8": build_serving_fn(model, quantize_int8=True,
                                       calib=cli_serve._calib_windows(
                                           resumed, 8))}
    modes = {"f32": ([], (2, 0)), "int8": (["-serve_int8", "1"], (1, 1))}
    served, errs = {}, {}
    for mode, (extra, per_batch) in modes.items():
        server, batchers = cli_serve.build(cli_config(
            ["-load", opath, "-path2data", data, "-serve_port", "0",
             *extra]))
        reqs = [("json", rng.normal(size=(64, MEL)).astype(np.float32), 1),
                ("npz", rng.normal(size=(100, MEL)).astype(np.float32),
                 soft)]
        try:
            client = PoseClient(
                f"http://127.0.0.1:{server.server_address[1]}",
                timeout_s=600)
            for b in batchers:
                b.batches = 0
            k1.launches = k4.launches = 0          # this server's path starts
            poses = [(client.pose if kind == "npz" else client.pose_json)(
                a, style=sty) for kind, a, sty in reqs]
            torch.cuda.synchronize()
            n = (k1.launches, k4.launches)         # this server's path ends
            nb = sum(b.batches for b in batchers)
        finally:
            server.shutdown()
            server.server_close()
            for b in batchers:
                b.close()
        check(n == tuple(c * nb for c in per_batch),
              f"[tail] {mode}: (K1, K4) launches {n} over {nb} batches")
        served[mode] = n
        worst = 0.0
        for (kind, a, sty), got_pose in zip(reqs, poses):
            bucket = 64 if a.shape[0] <= 64 else 128
            padded = np.concatenate(
                [a, np.repeat(a[-1:], bucket - a.shape[0], 0)])
            rows = onehot[sty] if np.ndim(sty) == 0 else sty
            want_pose = direct[mode](np.repeat(padded[None], B, axis=0),
                                     np.repeat(rows[None], B, axis=0))
            want_pose = want_pose[0].float().cpu().numpy()[:a.shape[0]]
            check(got_pose.shape == want_pose.shape, f"[tail] {mode} {kind}")
            worst = max(worst, float(np.abs(got_pose - want_pose).max()))
        errs[mode] = worst
        check(worst == 0.0, f"[tail] {mode}: served poses differ from the "
              f"direct call by {worst:.3e}")
    exp_dir = Path(sampler.dir_name)
    kp_files = [f for d in sorted(exp_dir.glob("keypoints*"))
                for f in sorted(d.rglob("*.h5"))]
    sample_dir = root / "sample"
    cli_sample.main(["-load", opath, "-path2data", data, "-save_dir",
                     str(sample_dir)])
    prefix = sampler.book.name.prefix
    ours = sorted((sample_dir / prefix).glob("keypoints*/*/*/*.h5"))
    same_kp = all(np.array_equal(
        HDF5.load_array(str(f), "pose/data"),
        HDF5.load_array(str(exp_dir / f.relative_to(sample_dir / prefix)),
                        "pose/data")) for f in ours)
    check(len(ours) == len(kp_files) == 2 * len(speakers) * LIFE_INTERVALS
          and same_kp, f"[tail] cli.sample of the orbax directory: "
          f"{len(ours)} keypoint files, equal to the trainer's {same_kp}")
    secs["b"] = time.perf_counter() - t_b
    w_ms, r_ms = float(np.mean(write_s)), float(np.mean(read_s))
    log(f"[tail] (b) cli.train -fused_decoder 1 -ckpt_backend orbax "
        f"-save_optim 1 (flagship at full width, {B}-window batches, -debug "
        f"{ENDS_STEPS}): K3 launches (fwd, bwd) {k3} = {g_steps} G steps; "
        f"{Path(opath).name}: {len(stored)} arrays, {nbytes} bytes, plain "
        f"layout; write {w_ms:.3f} s, read {r_ms:.3f} s (mean of "
        f"{ORBAX_REPS}: {', '.join(f'{x:.3f}' for x in write_s)} / "
        f"{', '.join(f'{x:.3f}' for x in read_s)}); resumed at step "
        f"{counters['step']} (g_step {counters['g_step']}) bit for bit; "
        f"cli.serve -load: served poses max|diff| f32 {errs['f32']:.3e}, "
        f"int8 {errs['int8']:.3e}; (K1, K4) launches f32 {served['f32']}, "
        f"int8 {served['int8']}; cli.sample: {len(ours)} keypoint files "
        f"equal to the trainer's; host {cpu}")
    rec["orbax"] = dict(k3_launches=k3, g_steps=g_steps, bytes=nbytes,
                        arrays=len(stored), write_s=write_s, read_s=read_s,
                        counters=counters, errors=errs, launches=served)
    del resumed, direct, trainer, sampler, model
    torch.cuda.empty_cache()

    # (c) the other layers at full width, card against CPU ------------------
    t_c = time.perf_counter()
    G = MODEL["num_clusters"]
    layer_err = {}
    for name, layer, width, groups in (
            ("PoseDecoder", PoseDecoder(C, MODEL["style_dim"], G, F_POSE),
             G * C0, G),
            ("StyleDecoder", StyleDecoder(C, 10, F_POSE), 10 * C, 10)):
        reset_parameters_(layer, torch.Generator().manual_seed(args.seed + 9),
                          random_bn_stats=True)
        x = torch.randn(B, T, width,
                        generator=torch.Generator().manual_seed(args.seed))
        card = copy.deepcopy(layer).to(device)
        errs_l = {}
        for train in (False, True):
            layer.train(train)
            card.train(train)
            with torch.no_grad():
                want = layer(x)
                got = card(x.to(device)).cpu()
            errs_l["train" if train else "eval"] = float(
                (got - want).abs().max() / want.abs().max())
        stats = max(float((a.cpu() - b).abs().max() / b.abs().max())
                    for a, b in zip(card.buffers(), layer.buffers())
                    if b.dtype.is_floating_point)
        errs_l["running_stats"] = stats
        check(tuple(got.shape) == (B, T, groups * F_POSE) and
              max(errs_l.values()) <= KERNEL_TOL,
              f"[tail] {name} on the card against the CPU: {errs_l}")
        layer_err[name] = errs_l
    secs["c"] = time.perf_counter() - t_c
    log(f"[tail] (c) PoseDecoder (8 groups x (256 + 10)) and StyleDecoder "
        f"(10 groups x 256) at bs{B} x {T}, card against CPU (max |diff| / "
        f"max |ref|, tol {KERNEL_TOL:g}): "
        + "; ".join(f"{n} " + ", ".join(f"{k} {v:.3e}" for k, v in e.items())
                    for n, e in layer_err.items()))
    rec["layers"] = layer_err

    # (d) centered, bias-corrected RMSprop ---------------------------------
    t_d = time.perf_counter()
    fac = StepFactory(StepConfig(**TRAIN_CFG, fused_decoder=True,
                                 optim="RMSprop", optim_kwargs=RMS_KW))
    tb = train_batch(np.random.default_rng(args.seed + 27), B, T)
    td.decoder_train_fwd.launches = 0               # RMSprop step starts
    td.decoder_train_bwd.launches = 0
    st, ls, _ = fac.make_steps()["g"](fac.init(seed=args.seed + 27), tb,
                                      args.seed)
    torch.cuda.synchronize()
    k3_rms = (td.decoder_train_fwd.launches,        # RMSprop step ends
              td.decoder_train_bwd.launches)
    check(k3_rms == (1, 1) and all(bool(torch.isfinite(v).all())
                                   for v in ls.values()),
          f"[tail] the RMSprop G step: K3 {k3_rms}, losses finite")
    opt = st.g_opt
    check(opt.centered and opt.bias_correction and opt.count == 1 and
          sorted(opt.slots()) == ["mu", "nu"], "[tail] RMSprop's state")
    cpu_opt = fac.g_tx([(n, p.detach().cpu().clone())
                        for n, p in zip(opt.names, opt.params)])
    for slot, tensors in opt.slots().items():
        for dst, src in zip(getattr(cpu_opt, slot), tensors):
            dst.copy_(src.cpu())
    cpu_opt.count = opt.count
    ggen = torch.Generator().manual_seed(args.seed + 28)
    for _ in range(2):           # counts 2 and 3: the correction moves
        grads = [torch.randn(p.shape, generator=ggen) * 1e-5
                 for p in cpu_opt.params]
        opt.step([g.to(device) for g in grads])
        cpu_opt.step(grads)
    torch.cuda.synchronize()
    rms_err = {"params": max(
        float((a.detach().cpu() - b).abs().max())
        / max(float(b.abs().max()), 1e-30)
        for a, b in zip(opt.params, cpu_opt.params))}
    for slot, tensors in opt.slots().items():
        rms_err[slot] = max(
            float((a.cpu() - b).abs().max()) / max(float(b.abs().max()),
                                                   1e-30)
            for a, b in zip(tensors, getattr(cpu_opt, slot)))
    check(max(rms_err.values()) <= 1e-6 and opt.count == cpu_opt.count == 3,
          f"[tail] the card's RMSprop update differs from the CPU's: "
          f"{rms_err}")
    secs["d"] = time.perf_counter() - t_d
    log(f"[tail] (d) centered, bias-corrected RMSprop (initial scale 0.1): "
        f"fused G step finite, K3 {k3_rms}; two more updates on given "
        f"gradients, card against CPU (max |diff| / max |ref|): "
        + ", ".join(f"{k} {v:.3e}" for k, v in rms_err.items()))
    rec["rmsprop"] = dict(k3_launches=k3_rms, update_err=rms_err)
    del st, opt, cpu_opt, fac

    # (e) cli.preprocess of text ---------------------------------------------
    t_e = time.perf_counter()
    raw = root / "text"
    text_speakers = speakers[:2]
    make_synthetic_dataset(str(raw), text_speakers, 2, interval_seconds=5.0,
                           with_raw_transcripts=True, seed=args.seed)
    methods = ["w2v", "pos", "tokens", "bert"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        common = ["-modalities", '["text"]', "-path2data", str(raw),
                  "-path2outdata", str(raw), "-speaker",
                  json.dumps(text_speakers)]
        cli_pre.main([*common, "-preprocess_methods", json.dumps(methods),
                      "-text_aligned", "0"])
        files = sorted((raw / "processed").rglob("*.h5"))
        words = [len(HDF5.load_array(str(f), "text/meta/Word"))
                 for f in files]
        for f in files:          # the aligned path from the written meta
            h5 = HDF5.h5_open(str(f), "a")
            HDF5.del_dataset(h5, "text/w2v")
            h5.close()
        cli_pre.main([*common, "-preprocess_methods", '["w2v"]',
                      "-text_aligned", "1"])
        tokenizer = ptext.BertSentenceBatching().tokenizer
    check(tokenizer is not None, f"[tail] BERT's tokenizer did not load "
          f"from {hub_cache()}")
    widths = {"w2v": 300, "bert": 768}
    ok = len(files) == 2 * len(text_speakers) and min(words) > 1
    for f in files:
        frames = HDF5.load_array(str(f), "pose/data").shape[0]
        for m in methods:
            a = HDF5.load_array(str(f), f"text/{m}")
            ok &= a.shape == ((frames, widths[m]) if m in widths
                              else (frames,))
            if m == "tokens":    # the ids of the interval's subwords
                said = " ".join(str(w) for w in HDF5.load_array(
                    str(f), "text/meta/Word")).lower()
                vocab = set(tokenizer.convert_tokens_to_ids(
                    tokenizer.tokenize(said)))
                ok &= set(np.unique(a).astype(int)) - {0} <= vocab
            if m == "bert":
                ok &= bool(np.abs(a).max() > 0)
    check(ok, f"[tail] cli.preprocess text: {len(files)} files, words "
          f"{words}, streams {methods}")
    secs["e"] = time.perf_counter() - t_e
    log(f"[tail] (e) cli.preprocess -modalities text on "
        f"{len(text_speakers)} speakers x 2 intervals of 5 s with raw "
        f"transcripts: -text_aligned 0 wrote text/meta ({words} words) and "
        f"{methods} (BERT on the card, token ids of each interval's "
        f"subwords), -text_aligned 1 rewrote text/w2v from text/meta")
    rec["text"] = dict(words=words, methods=methods)

    # (f) the committed OCDBT directory JAX's orbax wrote ---------------------
    t_f = time.perf_counter()
    want = json.loads((FIXTURE / "checksums.json").read_text())
    fixture = orbax.read_directory(str(FIXTURE / "ocdbt"))
    got = {name: {"sha256": hashlib.sha256(a.tobytes()).hexdigest(),
                  "dtype": dtype, "shape": list(a.shape)}
           for name, a, dtype in orbax.array_leaves(fixture)}
    check(got == want, "[tail] the OCDBT fixture differs from its "
          "checksums")
    secs["f"] = time.perf_counter() - t_f
    log(f"[tail] (f) tests/orbax_fixture/ocdbt (JAX's orbax, OCDBT, zstd; "
        f"libzstd {orbax.libzstd()._name}): {len(got)} arrays equal their "
        f"SHA-256 checksums")
    shutil.rmtree(root, ignore_errors=True)
    total = time.perf_counter() - t_phase
    log(f"[tail] sub-phase seconds: " + ", ".join(
        f"({k}) {v:.1f} s" for k, v in secs.items()))
    log(f"[tail] phase 26 in {total:.1f} s")
    rec.update(seconds=secs, total_s=total)
    results["long_tail"] = rec
    return {"k3": (k3[0] + k3_rms[0], k3[1] + k3_rms[1]),
            "k1": served["f32"][0] + served["int8"][0],
            "k4": served["int8"][1]}


# phase 27: BERT from local files (bert and tokens preprocessing on the
# card, a K3-trained text/bert lifecycle), -audio_lowering and
# -fused_decoder without the mixture decoder
BERT_REPO = "models--bert-base-uncased"
BERT_TOL = 1e-4              # card against CPU, max |diff| / max |ref|
BERT_WORDS = 50              # an interval's words: 25 s, one every 0.5 s
BERT_REPS = (20, 5)          # timed calls on the card, on the CPU
# the synthetic transcripts' words (data/synthetic.py), some as ## pieces
# ("louder" and "matters" are left out: [UNK]), for the seeded vocabulary
SEEDED_PIECES = ["the", "gest", "##ure", "speaks", "than", "words", "and",
                 "style", "un", "##believ", "##able", "punct", "##uation"]


def hub_cache() -> Path:
    """The hub cache ``transformers`` reads, by huggingface_hub's rules:
    ``HF_HUB_CACHE``, else ``HF_HOME/hub``, else
    ``$XDG_CACHE_HOME/huggingface/hub`` (``~/.cache`` by default)."""
    if os.environ.get("HF_HUB_CACHE"):
        return Path(os.environ["HF_HUB_CACHE"])
    home = os.environ.get("HF_HOME") or os.path.join(
        os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache")),
        "huggingface")
    return Path(home) / "hub"


def write_seeded_bert(hub: Path, seed: int) -> None:
    """A ``bert-base-uncased`` snapshot at the model's full size (its
    config: 12 layers, 768 wide, 30522 entries) with weights drawn from
    ``seed`` and a vocabulary of ``SEEDED_PIECES`` (the rest unused
    entries), in the hub cache's layout."""
    import torch
    from transformers import BertConfig, BertModel

    repo = hub / BERT_REPO
    shutil.rmtree(repo, ignore_errors=True)
    rev = f"{seed:040d}"
    snap = repo / "snapshots" / rev
    snap.mkdir(parents=True)
    (repo / "refs").mkdir()
    (repo / "refs" / "main").write_text(rev)
    cfg = BertConfig()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        BertModel(cfg).save_pretrained(snap)
    vocab = (["[PAD]"] + [f"[unused{i}]" for i in range(99)]
             + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"] + SEEDED_PIECES)
    vocab += [f"[unused{i}]" for i in range(99, 99 + cfg.vocab_size
                                            - len(vocab))]
    (snap / "vocab.txt").write_text("\n".join(vocab) + "\n")
    (snap / "tokenizer_config.json").write_text(json.dumps(
        {"do_lower_case": True, "model_max_length": 512}))


def bert_source(seed: int) -> dict:
    """Where ``bert-base-uncased`` comes from in phases 26 (e) and 27: the
    hub cache where it holds a snapshot, else a seeded one at full size
    (``write_seeded_bert``) under ``build/``, the hub pointed at it.  Runs
    before ``transformers`` is imported (the hub reads its variables once,
    at import), and keeps it offline: nothing is requested from the
    network."""
    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")
    os.environ.setdefault("USE_TF", "0")
    cache = hub_cache()
    if list((cache / BERT_REPO / "snapshots").glob("*/config.json")):
        return dict(cache=str(cache), installed=True)
    seeded = Path(__file__).resolve().parent / "build" / "hf_bert" / "hub"
    os.environ["HF_HUB_CACHE"] = str(seeded)
    t = time.perf_counter()
    write_seeded_bert(seeded, seed)
    return dict(cache=str(seeded), installed=False, absent_from=str(cache),
                absent_listing=sorted(os.listdir(cache))
                if cache.is_dir() else None,
                write_s=time.perf_counter() - t)


def bert_phase(torch, args, device, smi, results, bert) -> dict:
    """Phase 27: BERT at full size from local files (``bert_source``).
    (a) ``BertEmbedder`` on the card against ``device="cpu"`` on an
    interval's words: subword hidden states and word means within
    ``BERT_TOL``; load times and ms per interval on both; (b)
    ``cli.preprocess -preprocess_methods '["bert", "tokens"]'`` on 2
    speakers x 2 intervals on the card against a CPU rerun: ``text/bert``
    within ``BERT_TOL``, ``text/meta`` and ``text/tokens`` equal; (c) the
    flagship's ``cli.train`` on ``text/bert`` that BERT wrote (8 speakers x
    3 intervals of 8 s) with ``-fused_decoder 1`` (K3 once each way a G
    step), then ``cli.sample``; (d) ``cli.train -audio_lowering tpu``
    (K3 once each way a G step) and ``-model Speech2Gesture_G
    -fused_decoder 1`` (K3 0 times).  Returns K3's launches (fwd, bwd)
    over (c) and (d)."""
    import importlib.util
    import warnings
    from functools import partial

    if "h5py" not in sys.modules and importlib.util.find_spec("h5py") is None:
        install_h5py_stand_in()
    from mixstage_tpu_torch.cli import preprocess as cli_pre
    from mixstage_tpu_torch.cli import sample as cli_sample
    from mixstage_tpu_torch.cli import train as cli_train
    from mixstage_tpu_torch.config import argparse_n_loop
    from mixstage_tpu_torch.data import text as ptext
    from mixstage_tpu_torch.data.common import SPEAKERS
    from mixstage_tpu_torch.data.hdf5 import HDF5
    from mixstage_tpu_torch.data.synthetic import make_synthetic_dataset
    from mixstage_tpu_torch.ops.cuda import train_decoder as td
    from mixstage_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    secs, rec = {}, dict(bert)
    root = Path(__file__).resolve().parent / "build" / "bert"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    held = bert.get("absent_listing")
    where = (f"bert-base-uncased from {bert['cache']} (the machine's files)"
             if bert["installed"] else
             f"{bert['absent_from']} holds no bert-base-uncased ("
             + (f"it holds {held}" if held is not None else "no such "
                "directory") + f"): a seeded one at full size written to "
             f"{bert['cache']} in {bert['write_s']:.1f} s")
    log(f"[bert] {where}")
    cpu = host_cpu()

    # (a) BertEmbedder, card against CPU ---------------------------------
    t = time.perf_counter()
    card = ptext.BertEmbedder()
    torch.cuda.synchronize()
    load = {"card": time.perf_counter() - t}
    check(card.model is not None,
          f"[bert] BERT did not load from {bert['cache']}")
    t = time.perf_counter()
    host = ptext.BertEmbedder("cpu")
    load["cpu"] = time.perf_counter() - t
    config = card.model.config
    check(card.device.type == "cuda" and
          next(card.model.parameters()).is_cuda and
          (config.num_hidden_layers, config.hidden_size) == (12, 768),
          f"[bert] the model: {config.num_hidden_layers} layers, "
          f"{config.hidden_size} wide, on {card.device}")
    wrng = np.random.default_rng(args.seed + 27)
    pool = SEEDED_PIECES[:2] + ["gesture", "speaks", "louder", "than",
                                "words", "and", "style", "matters",
                                "unbelievable", "punctuation"]
    words = [pool[int(i)] for i in wrng.integers(0, len(pool), BERT_WORDS)]
    (hc, tc), (hp, tp) = card.subword_embed(words), host.subword_embed(words)
    errs = {"subwords": float(np.abs(hc - hp).max() / np.abs(hp).max())}
    wc, wp = card(words), host(words)
    errs["word_means"] = float(np.abs(wc - wp).max() / np.abs(wp).max())
    check(tc == tp and hc.shape == (len(tc), 768) and hc.dtype == np.float32
          and wc.shape == (BERT_WORDS, 768) and
          max(errs.values()) <= BERT_TOL,
          f"[bert] BertEmbedder on the card against the CPU: {errs}")
    ms = {"card": _ms_per_call(lambda: card.subword_embed(words),
                               BERT_REPS[0]),
          "cpu": _ms_per_call(lambda: host.subword_embed(words),
                              BERT_REPS[1])}
    secs["a"] = time.perf_counter() - t_phase
    log(f"[bert] (a) {smi}: BertEmbedder loaded in {load['card']:.2f} s "
        f"(card), {load['cpu']:.2f} s (CPU); an interval's {BERT_WORDS} "
        f"words ({len(tc)} subwords) in {ms['card']:.3f} ms on the card, "
        f"{ms['cpu']:.3f} ms on the CPU (host {cpu}; tokenizing and the "
        f"copy back included); card against CPU (max |diff| / max |ref|, "
        f"tol {BERT_TOL:g}): subword states {errs['subwords']:.3e}, word "
        f"means {errs['word_means']:.3e}")
    rec.update(load_s=load, ms_per_interval=ms, subwords=len(tc),
               card_vs_cpu=errs, cpu=cpu)
    del card, host
    torch.cuda.empty_cache()

    # (b) cli.preprocess bert + tokens, card against a CPU rerun ----------
    t_b = time.perf_counter()
    speakers = SPEAKERS[:MODEL["num_speakers"]]
    small = root / "small"
    make_synthetic_dataset(str(small), speakers[:2], 2, interval_seconds=5.0,
                           with_raw_transcripts=True, seed=args.seed + 27)
    shutil.copytree(small, root / "small_cpu")
    argv = ["-modalities", '["text"]', "-speaker", json.dumps(speakers[:2]),
            "-preprocess_methods", '["bert", "tokens"]', "-text_aligned",
            "0"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t = time.perf_counter()
        cli_pre.main(argv + ["-path2data", str(small), "-path2outdata",
                             str(small)])
        pre_s = {"card": time.perf_counter() - t}
        t = time.perf_counter()
        argparse_n_loop(partial(cli_pre.loop, device="cpu"), argv + [
            "-path2data", str(root / "small_cpu"), "-path2outdata",
            str(root / "small_cpu")])
        pre_s["cpu"] = time.perf_counter() - t
    files = sorted((small / "processed").rglob("*.h5"))
    stream_err, same = 0.0, len(files) == 4
    for f in files:
        g = root / "small_cpu" / f.relative_to(small)
        got, want = (HDF5.load_array(str(x), "text/bert") for x in (f, g))
        stream_err = max(stream_err, float(np.abs(got - want).max()
                                           / np.abs(want).max()))
        same &= got.shape[1] == 768 and all(
            np.array_equal(HDF5.load_array(str(f), k),
                           HDF5.load_array(str(g), k))
            for k in ("text/tokens", "text/meta/start_frame",
                      "text/meta/end_frame"))
    check(same and stream_err <= BERT_TOL,
          f"[bert] cli.preprocess on the card against the CPU: text/bert "
          f"{stream_err:.3e}, the rest equal {same}")
    secs["b"] = time.perf_counter() - t_b
    log(f"[bert] (b) cli.preprocess bert + tokens, 2 speakers x 2 intervals "
        f"of 5 s: card {pre_s['card']:.2f} s, CPU {pre_s['cpu']:.2f} s (each "
        f"loading BERT); text/bert card against CPU {stream_err:.3e} (tol "
        f"{BERT_TOL:g}), text/tokens and text/meta equal")
    rec.update(preprocess_s=pre_s, stream_err=stream_err)

    # (c) the text/bert lifecycle through K3 --------------------------------
    t_c = time.perf_counter()
    data = str(root / "data")
    make_synthetic_dataset(data, speakers, LIFE_INTERVALS,
                           interval_seconds=ENDS_INTERVAL_S,
                           with_raw_transcripts=True, seed=11212 + args.seed)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t = time.perf_counter()
        cli_pre.main(["-modalities", '["text"]', "-speaker",
                      json.dumps(speakers), "-preprocess_methods",
                      '["bert", "tokens"]', "-text_aligned", "0",
                      "-path2data", data, "-path2outdata", data])
        torch.cuda.synchronize()
        pre_s["card_all"] = time.perf_counter() - t
    n_files = len(list((Path(data) / "processed").rglob("*.h5")))
    seen = []
    orig_train = Trainer.train

    def keep(self, exp_num):
        orig_train(self, exp_num)
        seen.append(self)

    def train(extra, save):
        td.decoder_train_fwd.launches = 0          # this cli.train starts
        td.decoder_train_bwd.launches = 0
        t = time.perf_counter()
        cli_train.main(
            ["-path2data", data, "-speaker", json.dumps(speakers),
             "-gan", "1", "-loss", "L1Loss", "-batch_size", str(B),
             "-num_epochs", "1", "-window_hop", "5", "-debug",
             str(ENDS_STEPS), "-num_iters", "2", "-save_dir", str(save),
             "-exp", "1", "-seed", str(11212 + args.seed), *extra])
        torch.cuda.synchronize()
        k3 = (td.decoder_train_fwd.launches,       # this cli.train ends
              td.decoder_train_bwd.launches)
        tr = seen[-1]
        with open(tr.book.name("res", "json", str(save))) as f:
            res = json.load(f)
        check(all(bool(np.isfinite(res[k]).all())
                  for k in ("train", "dev", "test")),
              f"[bert] cli.train {extra}: losses not finite")
        return tr, k3, time.perf_counter() - t

    mixstage = ["-model", "JointLateClusterSoftStyle4_G", "-num_clusters",
                str(MODEL["num_clusters"]), "-fused_decoder", "1"]
    runs = {}
    Trainer.train = keep
    try:
        tr, k3, wall = train(mixstage + [
            "-modalities", json.dumps(["pose/data", "audio/log_mel_512",
                                       "text/bert"]),
            "-fs_new", "[15,15,15]"], root / "save_bert")
        g = tr.state.g_step
        check(g > 0 and k3 == (g, g) and tr.step_cfg.text_channels == 768
              and "text/bert" in tr.step_cfg.input_modalities and
              tr.data.datasets["train"].datasets[0].text_df is not None,
              f"[bert] cli.train on text/bert: K3 {k3} over {g} G steps, "
              f"text channels {tr.step_cfg.text_channels}")
        runs["text_bert"] = dict(k3=k3, g_steps=g, wall_s=wall)
        weights = tr.book.name("weights", "p", str(root / "save_bert"))
        t = time.perf_counter()
        cli_sample.main(["-load", weights, "-path2data", data, "-save_dir",
                         str(root / "sample")])
        torch.cuda.synchronize()
        sample_s = time.perf_counter() - t
        kp = list((root / "sample").rglob("keypoints*/*/*/*.h5"))
        check(len(kp) == 2 * len(speakers) * LIFE_INTERVALS and all(
            np.isfinite(HDF5.load_array(str(f), "pose/data")).all()
            for f in kp), f"[bert] cli.sample: {len(kp)} keypoint files")
        secs["c"] = time.perf_counter() - t_c

        # (d) -audio_lowering tpu; -fused_decoder 1 on Speech2Gesture_G ------
        t_d = time.perf_counter()
        tr, k3, wall = train(mixstage + ["-audio_lowering", "tpu"],
                             root / "save_lowering")
        g = tr.state.g_step
        check(g > 0 and k3 == (g, g) and
              tr.step_cfg.audio_lowering == "tpu",
              f"[bert] cli.train -audio_lowering tpu: K3 {k3} over {g} G "
              f"steps")
        runs["audio_lowering_tpu"] = dict(k3=k3, g_steps=g, wall_s=wall)
        tr, k3_s2g, wall = train(["-model", "Speech2Gesture_G",
                                  "-fused_decoder", "1"], root / "save_s2g")
        g = tr.state.g_step
        check(g > 0 and k3_s2g == (0, 0) and tr.step_cfg.fused_decoder,
              f"[bert] cli.train Speech2Gesture_G -fused_decoder 1: K3 "
              f"{k3_s2g} over {g} G steps, expected none")
        runs["speech2gesture_fused_flag"] = dict(k3=k3_s2g, g_steps=g,
                                                 wall_s=wall)
        secs["d"] = time.perf_counter() - t_d
    finally:
        Trainer.train = orig_train
    log(f"[bert] (c) cli.preprocess bert + tokens on {n_files} intervals of "
        f"{ENDS_INTERVAL_S:g} s on the card in {pre_s['card_all']:.2f} s; "
        f"cli.train audio + text/bert -fused_decoder 1 (flagship, full "
        f"width, -debug {ENDS_STEPS}) in {runs['text_bert']['wall_s']:.2f} "
        f"s: K3 launches (fwd, bwd) {runs['text_bert']['k3']} = "
        f"{runs['text_bert']['g_steps']} G steps; cli.sample {len(kp)} "
        f"keypoint files in {sample_s:.2f} s")
    log(f"[bert] (d) cli.train -audio_lowering tpu: K3 "
        f"{runs['audio_lowering_tpu']['k3']} = "
        f"{runs['audio_lowering_tpu']['g_steps']} G steps; "
        f"Speech2Gesture_G -fused_decoder 1: K3 "
        f"{runs['speech2gesture_fused_flag']['k3']} over "
        f"{runs['speech2gesture_fused_flag']['g_steps']} G steps (the flag "
        f"ignored, as JAX ignores it)")
    rec.update(runs=runs, sample_s=sample_s, seconds=secs)
    shutil.rmtree(root, ignore_errors=True)
    total = time.perf_counter() - t_phase
    log(f"[bert] sub-phase seconds: " + ", ".join(
        f"({k}) {v:.1f} s" for k, v in secs.items()))
    log(f"[bert] phase 27 in {total:.1f} s")
    rec["total_s"] = total
    results["bert"] = rec
    return {"k3": tuple(sum(r["k3"][i] for r in runs.values())
                        for i in range(2))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    # one rank of phase 24, started by the script itself
    ap.add_argument("--child", choices=("parallel",), default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--workdir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if args.child:
        return parallel_child(args)
    bert = bert_source(args.seed + 27)   # before transformers is imported

    from mixstage_tpu_torch import resolve_device
    from mixstage_tpu_torch.models import JointLateClusterSoftStyle4_G
    from mixstage_tpu_torch.models.layers import reset_parameters_
    from mixstage_tpu_torch.ops.cuda import build
    from mixstage_tpu_torch.ops.cuda import fused_conv as fc
    from mixstage_tpu_torch.ops.cuda.fused_conv import (
        device_tile_frames, fused_mixstage_decoder,
        fused_mixstage_decoder_plain, pack_decoder_bf16)
    from mixstage_tpu_torch.serve import build_serving_fn, style_weights
    from mixstage_tpu_torch.serving import (DynamicBatcher, PoseClient,
                                            PoseService, start_http_server)

    results: dict = {}
    t_script = time.perf_counter()

    # 1. device ------------------------------------------------------------
    device = resolve_device()            # cuda, TF32 off (device.py)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {smi}")
    log(f"[device] {kind} x{torch.cuda.device_count()}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}; python "
        f"{sys.version.split()[0]}")
    results["card"] = smi

    # 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build_all(force=True)
    results["build_s"] = time.perf_counter() - t0
    results["ptxas"] = {}
    for name, (sec, compiler_log) in built.items():
        log(f"[build] {name}: {sec:.1f} s  ({build.library_path(name).name})")
        kernels = ptxas_summary(compiler_log)
        for kernel, regs, stores, loads in kernels:
            log(f"[build]   {kernel}: {regs} registers, {stores} bytes spill "
                f"stores, {loads} bytes spill loads")
        results["ptxas"][name] = dict(kernels=kernels, advisories=[
            ln.strip() for ln in compiler_log.splitlines()
            if "Potential Performance Loss" in ln])
    log(f"[build] all kernels in {results['build_s']:.1f} s")

    # 3. kernels against their plain versions ------------------------------
    gen = torch.Generator().manual_seed(args.seed)
    per_shape = {}
    # K1's instances (N, terms, chain): the f32 decoder mode's (terms 3)
    # registers, spills and ptxas's advisories (a wgmma it serialises says
    # so); K2's chain instances in phase 10
    k1_ptxas = results["ptxas"]["fused_decoder_wgmma"]
    inst = [k for k in k1_ptxas["kernels"]
            if k[0].startswith("decoder_kernel")]
    check(len(inst) == 20, f"{len(inst)} decoder_kernel instances built, "
          f"expected 20 (5 widths x 2 modes x decoder and chain)")
    for kernel, regs, stores, loads in inst:
        if kernel.endswith(", 3, false>"):
            log(f"[kernel] K1 f32 mode {kernel}: {regs} registers, {stores} "
                f"B spill stores, {loads} B spill loads")
    log(f"[kernel] K1 ptxas advisories: {k1_ptxas['advisories'] or 'none'}")
    for name, (b, t, g, layers, f) in K1_SHAPES.items():
        a = random_folded(torch, gen, b, t, g, layers, f, device)
        packed = pack_decoder_bf16(dict(w0=a[1], wc=a[2], w_logits=a[4]))
        with torch.no_grad():
            out = fused_mixstage_decoder(*a, groups=g, packed=packed)
            ref = fused_mixstage_decoder_plain(*a, groups=g)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"K1 {name}: non-finite")
        abs_err = float((out - ref).abs().max())
        rel_err = abs_err / float(ref.abs().max())
        tile = device_tile_frames(b, t, C0, C, layers, f, g, device)
        log(f"[kernel] fused_mixstage_decoder {name} B={b} T={t} G={g} "
            f"C0={C0} C={C} L={layers} F={f} (tile {tile} frames, "
            f"{g * b * -(-t // tile)} CTAs): max|err| {abs_err:.3e}, "
            f"/max|ref| {rel_err:.3e} (tol {KERNEL_TOL:g})")
        check(rel_err <= KERNEL_TOL, f"K1 {name} disagrees with its plain "
              f"version: {rel_err:.3e}")
        per_shape[name] = dict(shape=dict(B=b, T=t, G=g, C0=C0, C=C, L=layers,
                                          F=f), tile=tile, max_abs_err=abs_err,
                               max_rel_err=rel_err, args=(a, packed))

    # 4. model: the main path through the entry points ---------------------
    model = JointLateClusterSoftStyle4_G(**MODEL)
    reset_parameters_(model, torch.Generator().manual_seed(args.seed + 1),
                      random_bn_stats=True)
    serve = build_serving_fn(model)                  # the card, K1 on
    plain = build_serving_fn(model, use_kernel=False)
    check(serve.device.type == "cuda" and serve.use_kernel, "serving device")
    rng = np.random.default_rng(args.seed + 2)
    audio = rng.normal(size=(B, T, MEL)).astype(np.float32)
    styles = rng.integers(0, MODEL["num_speakers"], size=B).astype(np.int32)

    packs = []                   # K1's weights are packed at build time
    fc.pack_decoder_bf16 = lambda fd: packs.append(fd) or \
        pack_decoder_bf16(fd)
    fused_mixstage_decoder.launches = 0              # main path starts
    fused_mixstage_decoder.launches_bf16 = 0
    pose = serve(audio, styles)
    torch.cuda.synchronize()
    counts = (fused_mixstage_decoder.launches,
              fused_mixstage_decoder.launches_bf16)
    check(counts == (2, 0), f"one serving call launched K1 (all, bf16 mode)"
          f" {counts} times, expected (2, 0)")
    pose_plain = plain(audio, styles)
    with torch.inference_mode():
        sw = style_weights(styles, MODEL["num_speakers"], device)
        pose_eval = model([torch.as_tensor(audio, device=device)], None,
                          sw[:, None, :].expand(B, T, -1))["pose"]
    check(tuple(pose.shape) == (B, T, MODEL["out_feats"]),
          f"pose shape {tuple(pose.shape)}")
    check(bool(torch.isfinite(pose).all()), "non-finite pose")
    scale = float(pose_plain.abs().mean())
    drift = float((pose - pose_plain).abs().mean()) / scale
    drift_max = float((pose - pose_plain).abs().max()) / scale
    drift_eval = float((pose - pose_eval).abs().mean()) / scale
    log(f"[model] full width bs{B} T{T}: pose {tuple(pose.shape)}, "
        f"mean|pose| {scale:.4e}; K1 path vs plain path: mean drift "
        f"{drift:.3e}, max {drift_max:.3e}; vs unfolded eval forward: "
        f"mean drift {drift_eval:.3e} (contract {DRIFT_TOL:g})")
    check(drift <= DRIFT_TOL and drift_eval <= DRIFT_TOL,
          "serving pose outside the 1% drift contract")
    results["model"] = dict(drift_vs_plain=drift, max_drift_vs_plain=drift_max,
                            drift_vs_eval=drift_eval, mean_abs_pose=scale)

    # 5. server ------------------------------------------------------------
    batcher = DynamicBatcher(serve, batch_size=B, max_wait_ms=5.0)
    service = PoseService(batcher, backend=serve.device.type,
                          num_styles=MODEL["num_speakers"], mel_bins=MEL)
    server = start_http_server(service, port=0, host="127.0.0.1")
    try:
        client = PoseClient(f"http://127.0.0.1:{server.server_address[1]}",
                            timeout_s=300)
        jobs = [("json", 64, 0), ("json", 64, 3), ("json", 64, 7),
                ("npz", 64, 1), ("npz", 64, 5),
                ("npz", 64, np.full(8, 0.125, np.float32)), ("npz", 100, 2)]
        reqs = [(kind_, rng.normal(size=(n, MEL)).astype(np.float32), sty)
                for kind_, n, sty in jobs]

        def send(req):
            kind_, a, sty = req
            return (client.pose_json if kind_ == "json" else client.pose)(
                a, style=sty)

        with concurrent.futures.ThreadPoolExecutor(len(reqs)) as pool:
            poses = list(pool.map(send, reqs))
        for (kind_, a, sty), p in zip(reqs, poses):
            check(p.shape == (a.shape[0], MODEL["out_feats"]),
                  f"{kind_} response shape {p.shape}")
            check(bool(np.isfinite(p).all()), f"{kind_} response not finite")
        # a response equals the same clip served directly
        direct = serve(reqs[0][1][None], np.array([0], np.int32))[0].cpu()
        served_err = float(np.abs(poses[0] - direct.numpy()).max()) / scale
        health, stats = client.health(), client.stats()
        log(f"[server] {len(reqs)} concurrent /v1/pose requests "
            f"(json+npz, 64 and 100 frames): ok; vs direct call max|diff|/"
            f"mean|pose| {served_err:.2e}; healthz {health}; stats "
            f"requests={stats['requests']} batches={stats['batches']} "
            f"occupancy={stats['mean_occupancy']}")
        check(served_err <= DRIFT_TOL, "served pose differs from direct call")
        check(health["backend"] == "cuda", "healthz backend is not cuda")
        check(stats["requests"] == len(reqs), f"stats {stats}")
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
    launches = fused_mixstage_decoder.launches       # main path ends
    fc.pack_decoder_bf16 = pack_decoder_bf16
    check(launches == 2 * (2 + stats["batches"]) and
          fused_mixstage_decoder.launches_bf16 == 0,
          f"K1 launches {launches} over the main path, expected "
          f"2 per serving call, all in the f32 mode")
    check(not packs, f"the serving path packed K1's weights {len(packs)} "
          f"times after the serving function was built")
    log(f"[server] K1 launches over the main path (model + server phases): "
        f"{launches}, all in the f32 mode, none packing its weights")

    # 6. timings -------------------------------------------------------------
    clip, clip_style = audio[:1], styles[:1]
    lat = []
    for i in range(60):
        t0 = time.perf_counter()
        serve(clip, clip_style).cpu()
        if i >= 10:
            lat.append((time.perf_counter() - t0) * 1e3)
    p50 = float(np.percentile(lat, 50))
    audio_dev = torch.as_tensor(audio, device=device)
    styles_dev = torch.as_tensor(styles, device=device)
    call_ms = cuda_ms(torch, lambda: serve(audio_dev, styles_dev), reps=20)
    plain_call_ms = cuda_ms(torch, lambda: plain(audio_dev, styles_dev),
                            reps=20)
    with torch.inference_mode():
        sw_dev = style_weights(styles_dev, MODEL["num_speakers"], device)
        sw_dev = sw_dev[:, None, :].expand(B, T, -1)
        feats_ms = cuda_ms(torch, lambda: model.features([audio_dev], None,
                                                         sw_dev), reps=20)
    fps = B * T / (call_ms / 1e3)
    log(f"[timing] {smi}: p50 latency of one {T}-frame clip (host array in,"
        f" host array out) {p50:.3f} ms; bs{B} serving call {call_ms:.3f} ms"
        f" = {fps:.1f} pose frames/s (plain path {plain_call_ms:.3f} ms); "
        f"features (audio encoder + UNet + style) {feats_ms:.3f} ms")
    for name, rec in per_shape.items():
        (a, packed), g = rec.pop("args"), rec["shape"]["G"]
        with torch.no_grad():            # weights packed once, as served
            rec["ms"] = cuda_ms(torch, lambda: fused_mixstage_decoder(
                *a, groups=g, packed=packed))
            rec["plain_ms"] = cuda_ms(
                torch, lambda: fused_mixstage_decoder_plain(*a, groups=g))
        s = rec["shape"]
        flops, nbytes = k1_work(s["B"], s["T"], g, s["L"], s["F"])
        rec["bound_ms"], rec["bound_by"] = bound_ms(6 * flops, nbytes,
                                                    PEAK_BF16_FLOPS)
        rec["ffma_bound_ms"] = bound_ms(flops, nbytes)[0]
        rec["flops"], rec["bytes"] = flops, nbytes
        rec["tflops"] = flops / (rec["ms"] / 1e3) / 1e12
        log(f"[timing] {smi}: K1 {name}: {rec['ms']:.4f} ms "
            f"({rec['tflops']:.2f} TFLOP/s of f32 work), plain "
            f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms by "
            f"{rec['bound_by']} (6 bf16 MMAs a multiply-add; f32 FMA bound "
            f"{rec['ffma_bound_ms']:.4f} ms; {flops / 1e9:.2f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB)")
    results["timing"] = dict(clip_p50_ms=p50, bs32_call_ms=call_ms,
                             bs32_frames_per_s=fps,
                             plain_bs32_call_ms=plain_call_ms,
                             features_ms=feats_ms)

    main_shapes = ("decoder", "classifier")
    call_flops = sum(per_shape[s]["flops"] for s in main_shapes)
    call_bytes = sum(per_shape[s]["bytes"] for s in main_shapes)
    call_bound_ms, call_bound_by = bound_ms(6 * call_flops, call_bytes,
                                            PEAK_BF16_FLOPS)
    k1 = {
        "name": "fused_mixstage_decoder", "route": "cuda",
        "source": "mixstage_tpu_torch/ops/cuda/csrc/fused_decoder_wgmma.cu",
        "replaces": "mixstage_tpu/ops/pallas/fused_conv.py:179",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in per_shape.values()),
        # per serving call at bs32: the classifier launch + the decoder one
        "ms": sum(per_shape[s]["ms"] for s in main_shapes),
        "plain_ms": sum(per_shape[s]["plain_ms"] for s in main_shapes),
        "bound_ms": call_bound_ms,
        "bound_by": call_bound_by,
        "library_ms": None,
        "mma": "wgmma-bf16x6",
        "tf32x3_bound_ms": bound_ms(3 * call_flops, call_bytes,
                                    PEAK_TF32_FLOPS)[0],
        "ffma_bound_ms": bound_ms(call_flops, call_bytes)[0],
        "shapes": per_shape,
    }

    # 7. training kernels against their plain versions ---------------------
    from mixstage_tpu_torch.ops.cuda import train_decoder as td
    from mixstage_tpu_torch.train import StepConfig, StepFactory

    # K3's f32-mode GEMM instances (wgmma_gemm_kernel<..., 3>): registers,
    # spills and ptxas's advisories (a wgmma it serialises says so)
    k3_ptxas = results["ptxas"]["train_decoder"]
    wg = [k for k in k3_ptxas["kernels"]
          if k[0].startswith("wgmma_gemm_kernel") and k[0].endswith(", 3>")]
    check(len(wg) == 12, f"{len(wg)} f32-mode wgmma_gemm_kernel instances "
          f"built, expected 12")
    for kernel, regs, stores, loads in wg:
        log(f"[train-kernel] K3 f32 GEMM {kernel}: {regs} registers, "
            f"{stores} B spill stores, {loads} B spill loads")
    log(f"[train-kernel] K3 ptxas advisories: "
        f"{k3_ptxas['advisories'] or 'none'}")
    kgen = torch.Generator().manual_seed(args.seed + 3)
    k3_main = random_train(torch, kgen, B, T, device)
    fwd_err, bwd_err, fwd_out, dout = check_k3(torch, td, "bs32", k3_main,
                                               args.seed + 4)
    for b_, t_ in (K3_RAGGED,):                  # ragged: the sequence ends
        e_f, e_b, _, _ = check_k3(torch, td, "ragged",
                                  random_train(torch, kgen, b_, t_, device),
                                  args.seed + 5)
        fwd_err, bwd_err = max(fwd_err, e_f), max(bwd_err, e_b)

    # 8. training: the main path through StepFactory -----------------------
    fused = StepFactory(StepConfig(**TRAIN_CFG, fused_decoder=True))
    unfused = StepFactory(StepConfig(**TRAIN_CFG))
    check(fused.device.type == "cuda", "StepFactory device")
    lr = fused.cfg.lr
    trng = np.random.default_rng(args.seed + 6)
    batch = train_batch(trng, B, T)
    s_fused = fused.init(seed=args.seed + 7)
    s_plain = unfused.init(seed=args.seed + 7)

    def k3_counts():
        return (td.decoder_train_fwd.launches, td.decoder_train_bwd.launches)

    td.decoder_train_fwd.launches = 0               # training path starts
    td.decoder_train_bwd.launches = 0
    s_fused, l_fused, pose_f = fused.make_steps()["g"](s_fused, batch)
    torch.cuda.synchronize()
    check(k3_counts() == (1, 1), f"one fused G step launched K3 "
          f"{k3_counts()} times, expected (1, 1)")
    s_plain, l_plain, pose_u = unfused.make_steps()["g"](s_plain, batch)
    torch.cuda.synchronize()
    check(k3_counts() == (1, 1), "the unfused G step launched K3")
    for k, v in l_fused.items():
        check(bool(torch.isfinite(v).all()), f"G step loss {k} not finite")
    tot_f, tot_u = float(l_fused["total"]), float(l_plain["total"])
    check(abs(tot_f - tot_u) <= KERNEL_TOL * abs(tot_u),
          f"fused G step total {tot_f} vs unfused {tot_u}")
    p_err, s_err, mu_gaps, bias_gap = compare_states(torch, s_plain, s_fused,
                                                     lr)
    pose_drift = float((pose_f - pose_u).abs().mean() / pose_u.abs().mean())
    log(f"[train] full width G step bs{B} T{T}: total loss fused "
        f"{tot_f:.6f} vs unfused {tot_u:.6f}; params max|diff| {p_err:.3e} "
        f"(tol 2·lr = {2 * lr:g}); BN stats max diff / scale {s_err:.3e}; "
        f"Adam mu max module gap {max(mu_gaps.values()):.3e} (tol "
        f"{MOMENT_TOL:g}; the 3xTF32 route's {MU_GAP_TF32X3:.3e}); pose "
        f"mean drift {pose_drift:.3e}; K3 launches "
        f"{k3_counts()}")
    s_fused, l_d, _ = fused.make_steps()["d"](s_fused, batch)
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(v).all()) for v in l_d.values()),
          "D step losses not finite")
    check(k3_counts() == (1, 1), "the D step launched K3")
    coins = np.random.default_rng(args.seed + 8).random(SCAN_K) < \
        fused.cfg.d_prob
    n_g = int((~coins).sum())
    check(n_g > 0, "the seeded coins hold no G step")
    stacked = train_batch(trng, B, T, k=SCAN_K)
    scan = fused.make_scan_train_step(SCAN_K)
    s_fused, l_scan, poses = scan(s_fused, stacked, coins)
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(v).all()) for v in l_scan.values()),
          "k-step driver losses not finite")
    check(tuple(poses.shape) == (SCAN_K, B, T, F_POSE), "k-step poses")
    k3_launches = k3_counts()                       # training path ends
    check(k3_launches == (1 + n_g, 1 + n_g),
          f"K3 launches {k3_launches} over the training path, expected one "
          f"each per G step ({1 + n_g})")
    log(f"[train] D step and make_scan_train_step({SCAN_K}) with coins "
        f"{''.join('D' if c else 'G' for c in coins)}: losses finite "
        f"(last total {float(l_scan['total'][-1]):.5f}); K3 launches over "
        f"the training path (fwd, bwd) {k3_launches}, {2 * (1 + n_g)} = 2 x "
        f"{1 + n_g} G steps")

    # 9. training timings ----------------------------------------------------
    def on_device(tree):
        return {k: (tuple(torch.as_tensor(a, device=device) for a in v)
                    if k == "x" else torch.as_tensor(v, device=device))
                for k, v in tree.items()}

    dbatch, dstacked = on_device(batch), on_device(stacked)
    # fused and unfused in turns, ABBA, so that the host's drift over the
    # phase falls on both alike
    facs = {"fused": (fused, s_fused), "unfused": (unfused, s_plain)}
    turns = {name: dict(g=[], d=[], scan=[]) for name in facs}
    for name in ["fused", "unfused", "unfused", "fused"] * (TIMING_TURNS // 2):
        fac, st = facs[name]
        steps, run_k = fac.make_steps(), fac.make_scan_train_step(SCAN_K)
        rec = turns[name]
        rec["g"].append(cuda_ms(torch, lambda: steps["g"](st, dbatch),
                                reps=10))
        rec["d"].append(cuda_ms(torch, lambda: steps["d"](st, dbatch),
                                reps=10))
        rec["scan"].append(cuda_ms(torch, lambda: run_k(st, dstacked, coins),
                                   reps=3, warmup=1) / SCAN_K)
    train_t = {}
    for name, rec in turns.items():
        mean = {k: float(np.mean(v)) for k, v in rec.items()}
        train_t[name] = dict(g_step_ms=mean["g"], d_step_ms=mean["d"],
                             scan_step_ms=mean["scan"],
                             frames_per_s=B * T / (mean["scan"] / 1e3),
                             turns=rec)
        log(f"[timing] {smi}: training ({name} decoder) bs{B} T{T}, mean of "
            f"{TIMING_TURNS} turns (min-max): G step {mean['g']:.3f} ms "
            f"({min(rec['g']):.3f}-{max(rec['g']):.3f}), D step "
            f"{mean['d']:.3f} ms ({min(rec['d']):.3f}-{max(rec['d']):.3f}), "
            f"make_scan_train_step({SCAN_K}) mean step {mean['scan']:.3f} ms "
            f"({min(rec['scan']):.3f}-{max(rec['scan']):.3f}) = "
            f"{train_t[name]['frames_per_s']:.1f} train pose frames/s")
    for what in ("g", "scan"):
        gaps = [f - u for f, u in zip(turns["fused"][what],
                                      turns["unfused"][what])]
        log(f"[timing] {smi}: {what} step fused - unfused, turn by turn: "
            + ", ".join(f"{g:+.3f}" for g in gaps)
            + f" ms (mean {np.mean(gaps):+.3f})")
    x, w0, wc, _, gamma, beta, wl, _ = k3_main
    bwd_args = (dout, x, fwd_out[1], fwd_out[2], fwd_out[3], w0, wc, gamma,
                beta, wl)
    (f_flops, f_bytes), (b_flops, b_bytes) = k3_work(B, T,
                                                     MODEL["num_clusters"],
                                                     F_POSE)
    k3 = []
    for name, fn, plain_fn, args_, flops, nbytes, line, err, count in (
            ("decoder_train_fwd", td.decoder_train_fwd,
             td.decoder_train_fwd_plain, k3_main, f_flops, f_bytes, 126,
             fwd_err, k3_launches[0]),
            ("decoder_train_bwd", td.decoder_train_bwd,
             td.decoder_train_bwd_plain, bwd_args, b_flops, b_bytes, 284,
             bwd_err, k3_launches[1])):
        ms = cuda_ms(torch, lambda: fn(*args_), reps=10)
        plain_ms = cuda_ms(torch, lambda: plain_fn(*args_), reps=5)
        bms, by = bound_ms(6 * flops, nbytes, PEAK_BF16_FLOPS)
        tf32x3_ms = bound_ms(3 * flops, nbytes, PEAK_TF32_FLOPS)[0]
        ffma_ms = bound_ms(flops, nbytes)[0]
        log(f"[timing] {smi}: K3 {name} bs{B}: {ms:.4f} ms "
            f"({flops / (ms / 1e3) / 1e12:.2f} TFLOP/s of f32 work), plain "
            f"{plain_ms:.4f} ms, bound {bms:.4f} ms by {by} (six bf16 "
            f"products at the dense bf16 rate; 3xTF32 bound {tf32x3_ms:.4f}"
            f" ms, f32 FMA bound {ffma_ms:.4f} ms; {flops / 1e9:.2f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB)")
        k3.append({
            "name": name, "route": "cuda",
            "source": "mixstage_tpu_torch/ops/cuda/csrc/train_decoder.cu",
            "replaces": f"mixstage_tpu/ops/pallas/train_decoder.py:{line}",
            "launches": count, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            # no single PyTorch call computes the train-mode conv + BN chain
            "library_ms": None, "mma": "bf16x6",
            "tf32x3_bound_ms": tf32x3_ms, "ffma_bound_ms": ffma_ms})
    results["train"] = dict(total_fused=tot_f, total_unfused=tot_u,
                            param_diff=p_err, stat_diff=s_err,
                            mu_gaps=mu_gaps, mu_bias_gap=bias_gap,
                            pose_drift=pose_drift, timing=train_t,
                            coins=coins.tolist(), k3_launches=k3_launches)
    k4, k2 = int8_phases(torch, args, device, smi, model, audio, styles,
                         pose, results)
    k16 = bf16_phases(torch, args, device, smi, model, audio, styles, pose,
                      serve, results)
    k8_16 = int8_bf16_phases(torch, args, device, smi, model, audio, styles,
                             pose, results)
    life, exps = lifecycle_phase(torch, args, smi, results)
    try:
        served = serving_cli_phase(torch, args, smi, results, exps)
    finally:
        shutil.rmtree(exps["root"], ignore_errors=True)
    rest = steps_rest_phase(torch, args, device, smi, results)
    text = text_phase(torch, args, device, smi, results)
    par = parallel_phase(torch, args, device, smi, model, audio, styles,
                         serve, plain, results)
    ends = lifecycle_ends_phase(torch, args, smi, results)
    tail = long_tail_phase(torch, args, device, smi, results)
    lm = bert_phase(torch, args, device, smi, results, bert)
    for kern in [k1] + k16 + [k4] + k8_16:
        if kern["name"] in served:
            kern["serving_cli_launches"] = served[kern["name"]]
    for kern in k3 + k16:
        for i, which in enumerate(("fwd", "bwd")):
            if kern["name"].startswith(f"decoder_train_{which}"):
                mode = "bfloat16" if kern["name"].endswith("_bf16") \
                    else "float32"
                kern["lifecycle_launches"] = life[mode][i]
                kern["steps_rest_launches"] = rest[mode][i]
                kern["text_launches"] = text[mode][i]
    # phase 24: K3 per rank (fwd, bwd, fwd-bf16, bwd-bf16), K1 and K4 per
    # device of the serving partitions
    k1["parallel_launches"] = par["k1"]
    k1["parallel_launches_per_device"] = par["per_device"]
    k4["parallel_launches"] = par["k4"]
    for kern in k3 + k16:
        for i, which in enumerate(("fwd", "bwd")):
            if kern["name"].startswith(f"decoder_train_{which}"):
                j = i + (2 if kern["name"].endswith("_bf16") else 0)
                kern["parallel_launches_per_rank"] = [
                    counts[j] for counts in par["k3_per_rank"]]
    # phase 25: K3 over cli.train -render 1, K1 and K4 over the servers of
    # the JAX-format checkpoint
    k1["lifecycle_ends_launches"] = ends["k1"]
    k4["lifecycle_ends_launches"] = ends["k4"]
    for i, kern in enumerate(k3):
        kern["lifecycle_ends_launches"] = ends["k3"][i]
    # phase 26: K3 over cli.train -ckpt_backend orbax and the RMSprop G
    # step, K1 and K4 over the servers of the orbax checkpoint
    k1["long_tail_launches"] = tail["k1"]
    k4["long_tail_launches"] = tail["k4"]
    for i, kern in enumerate(k3):
        kern["long_tail_launches"] = tail["k3"][i]
    # phase 27: K3 over cli.train on text/bert and -audio_lowering tpu (none
    # over Speech2Gesture_G -fused_decoder 1)
    for i, kern in enumerate(k3):
        kern["bert_launches"] = lm["k3"][i]
    for kern in [k1] + k3 + [k4]:
        kern["mode"] = "f32" if kern is not k4 else "int8"
    k2["mode"] = "f32"
    kernels = [k1] + k3 + [k4, k2] + k16 + k8_16
    results["kernels"] = kernels
    results["script_s"] = time.perf_counter() - t_script
    log(f"[done] {smi}: chip_smoke.py in {results['script_s']:.1f} s, the "
        f"kernels' build included")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps({"kernels": [{k: v for k, v in kern.items()
                                   if k != "shapes"} for kern in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
