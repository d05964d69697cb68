#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``mixstage_tpu_torch``) on one CUDA card.

Drives the port's two main paths end to end at the full width of the
flagship model — ``JointLateClusterSoftStyle4_G`` with 8 clusters, 8
speakers, 256 channels, style_dim 10 and 96 pose features, on 64-frame
clips of 128 mel bins at batch 32 — with random weights drawn from
``--seed``: serving (phases 1-6), GAN training (phases 7-9) and the int8
serving tier with the streaming and waveform endpoints (phases 10-14), the
bf16 tier, serving and GAN training (phases 15-17), and the int8 tier on the
bf16 model (phases 18-19):

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
    does); K2
    against ``chain_plain`` at (32, 64, G=8, C=256, L=3), (4, 64, 4, 128,
    3) and a ragged B=3 T=50 (max |err| / max |ref| ≤ 1e-4);
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
    versions; the bs32 int8 call against the f32 one in ABBA turns;
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
    to f32 exactly), K2's bf16 mode against ``chain_plain``'s at every K2
    shape under the bf16 rule (ULPs beside it); each timed beside its
    bound and plain version, K4-bf16 against K4's f32 mode in ABBA turns;
19. the int8 tier on the bf16 model: one bs32 call of
    ``build_serving_fn(model16, quantize_int8=True, calib=...)`` launches
    K1's bf16 mode once and K4's bf16 mode once, drifts from the f32
    kernel route by (1e-4, 0.10), and its kernel and plain routes drift
    alike (the bf16 rule); ``/v1/pose`` requests and a 150-frame stream
    through a server over it equal the direct calls at the server's batch
    size; the call timed against the int8 call on the f32 model in ABBA
    turns, with its device busy time, launches and idle share
    (``torch.profiler``).

The bf16 rule: no bf16 output is held element-wise to another bf16 output
(two valid roundings differ about as much as either differs from the
truth); the kernel's output P and its plain version's Q each drift from
the float32 truth R (the same function in float32 on the same inputs),
drift = mean |O - R| / mean |R| (relative Frobenius error for gradients),
and |drift(P) - drift(Q)| ≤ 0.10 drift(Q) + 1e-3.

Each kernel's bound is the least time the card could take for its work,
whatever route the kernel runs: K1 and K3 at the dense bf16 rate with 6
MMAs per multiply-add (the 3xTF32 bound of their earlier routes, 3 MMAs at
the TF32 rate, beside each as ``tf32x3_bound_ms``; K3's f32 FMA bound as
``ffma_bound_ms``), K2 at the TF32 tensor-core rate (3 MMAs per
multiply-add; ``ffma_bound_ms`` beside), K4 at the int8 tensor-core rate;
in bf16 mode K1 at
the dense bf16 rate with 3 MMAs per multiply-add (bf16 activations times
f32 weights split in three bf16 terms; the 2xTF32 bound of its earlier
route beside it as ``tf32x2_bound_ms``), K2 at the TF32 rate with 2 MMAs
per multiply-add (``ffma_bound_ms`` beside), K3 at the dense bf16 rate,
K4 at its f32 mode's rate with 2-byte features;
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
import re
import subprocess
import sys
import time

import numpy as np

# published peaks of one H100 SXM (NVIDIA data sheet): f32 outside the
# tensor cores, dense tensor-core rates, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12     # K2: 3 TF32 MMAs a multiply-add
PEAK_BF16_FLOPS = 989e12     # K1, K3: 6 bf16 MMAs a multiply-add (bf16
#                              modes: K1 3, K3 1)
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
# a rounding boundary and the flip spreads through later layers (K2:
# 1.3-3.0% of the elements at the three-layer shapes below, 6.1% at the
# four-layer "deep", --seed 0 on an H100).  A kernel that skips one layer's
# rounding differs in 40-58% of them (tests/test_torch_port_cuda.py on
# such a copy of K2).
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
    "deep": (2, 130, 1, 256, 4)}     # four layers: bf16 flips spread most
MEL_WAVE = 64                # audio/log_mel_400


# the training configuration of bench.py:205-249 (in_channels 256 is the
# generator's default)
TRAIN_CFG = dict(model="JointLateClusterSoftStyle4_G", gan=True,
                 criterion="L1Loss", num_clusters=8, num_speakers=8)
F_POSE, LAYERS = MODEL["out_feats"], 4
SCAN_K = 8
K3_RAGGED = (3, 50)          # K3 alone at a ragged shape: the sequence ends
TIMING_TURNS = 4             # timed turns of each decoder, in ABBA order


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
    arguments (integers, ``float`` and named types such as
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
            m = re.match(r"Li(-?\d+)E|f|(\d+)", rest[j:])
            if not m:
                break
            if m.group(1) is not None:
                args.append(m.group(1))
                j += m.end()
            elif m.group(0) == "f":
                args.append("float")
                j += 1
            else:
                n = int(m.group(2))
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


def random_train(torch, gen, b, t, device):
    """Seeded K3 inputs at the flagship widths: x (b, t, C0) and the
    decoder's packed parameters (``train_decoder.py``'s layout)."""
    g = MODEL["num_clusters"]

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
    for name, a, b in zip(s0.g_opt.names, s0.g_opt.mu, s1.g_opt.mu):
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


def compare_states(torch, s0, s1, lr):
    """Fused (s1) against unfused (s0) G side after one G step: params at
    atol 2·lr (+1e-6), BN running statistics at 1e-4 of each leaf's scale,
    G's Adam mu (``g_moment_gaps``) at ``MOMENT_TOL`` per module and the
    pre-BN biases at 1e-4 of the tree's scale.  Returns (max param diff,
    max normalised stat diff, {module: mu gap}, bias gap)."""
    p_err = s_err = 0.0
    for m0, m1 in ((s0.gen, s1.gen), (s0.psenc, s1.psenc),
                   (s0.disc, s1.disc)):
        a, b = leaves(m0), leaves(m1)
        for k in a:
            d = float((a[k] - b[k]).detach().abs().max())
            if k.endswith(("running_mean", "running_var")):
                s_err = max(s_err, d / max(float(a[k].abs().max()), 1e-30))
            else:
                p_err = max(p_err, d)
    gaps, bias = g_moment_gaps(s0, s1)
    log("[train] fused vs unfused G step, Adam mu per module (relative "
        "Frobenius): " + ", ".join(f"{m} {g:.2e}" for m, g in sorted(
            gaps.items(), key=lambda kv: -kv[1]))
        + f"; pre-BN conv biases {bias:.2e} of max |mu|")
    check(p_err <= 2 * lr + 1e-6, f"fused G step params differ by {p_err:.3e}")
    check(s_err <= KERNEL_TOL, f"fused G step BN stats differ by {s_err:.3e}")
    worst = max(gaps, key=gaps.get)
    check(gaps[worst] <= MOMENT_TOL, f"fused G step Adam mu of {worst} "
          f"differs by {gaps[worst]:.3e} (tol {MOMENT_TOL:g})")
    check(bias <= KERNEL_TOL, f"fused G step pre-BN bias mu {bias:.3e}")
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
        chain_plain, fused_grouped_conv_chain, fused_mixstage_decoder)
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
    k2_shapes = {}
    for name, (b, t, g, c, layers) in K2_SHAPES.items():
        a = (torch.randn(b, t, g * c, generator=qgen).to(device),
             (torch.randn(layers, g, 3, c, c, generator=qgen)
              * (3 * c) ** -0.5).to(device),
             (torch.randn(layers, g * c, generator=qgen) * 0.1).to(device))
        out = fused_grouped_conv_chain(*a, groups=g)
        ref = chain_plain(*a, groups=g)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"K2 {name}: non-finite")
        abs_err = float((out - ref).abs().max())
        rel_err = abs_err / float(ref.abs().max())
        log(f"[kernel] fused_grouped_conv_chain {name} B={b} T={t} G={g} "
            f"C={c} L={layers}: max|err| {abs_err:.3e}, /max|ref| "
            f"{rel_err:.3e} (tol {KERNEL_TOL:g})")
        check(rel_err <= KERNEL_TOL, f"K2 {name} disagrees with its plain "
              f"version: {rel_err:.3e}")
        k2_shapes[name] = dict(shape=dict(B=b, T=t, G=g, C=c, L=layers),
                               max_abs_err=abs_err, max_rel_err=rel_err,
                               args=a)

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
        a, g = rec.pop("args"), rec["shape"]["G"]
        rec["ms"] = cuda_ms(torch, lambda: fused_grouped_conv_chain(
            *a, groups=g))
        rec["plain_ms"] = cuda_ms(torch, lambda: chain_plain(*a, groups=g))
        sh = rec["shape"]
        flops, nbytes = k2_work(sh["B"], sh["T"], g, sh["C"], sh["L"])
        rec["bound_ms"], rec["bound_by"] = bound_ms(3 * flops, nbytes,
                                                    PEAK_TF32_FLOPS)
        rec["ffma_bound_ms"] = bound_ms(flops, nbytes)[0]
        log(f"[timing] {smi}: K2 {name}: {rec['ms']:.4f} ms "
            f"({flops / (rec['ms'] / 1e3) / 1e12:.2f} TFLOP/s f32), plain "
            f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms by "
            f"{rec['bound_by']} (3 TF32 MMAs a multiply-add; f32 FMA bound "
            f"{rec['ffma_bound_ms']:.4f} ms; {flops / 1e9:.2f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB)")
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
          "source": "mixstage_tpu_torch/ops/cuda/csrc/conv_chain.cu",
          "replaces": "mixstage_tpu/ops/pallas/fused_conv.py:75",
          # a public op: no path of the package calls it
          "launches": launches[2],
          "max_abs_err": max(r["max_abs_err"] for r in k2_shapes.values()),
          "ms": main2["ms"], "plain_ms": main2["plain_ms"],
          "bound_ms": main2["bound_ms"], "bound_by": main2["bound_by"],
          "library_ms": None, "mma": "ffma",
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
        chain_plain, fused_grouped_conv_chain, fused_mixstage_decoder)
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
        out = k2(*a, groups=g)
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
                           differing=share, max_abs_err=abs_err, args=a)
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
        a, g = rec.pop("args"), rec["shape"]["G"]
        rec["ms"] = cuda_ms(torch, lambda: k2(*a, groups=g))
        rec["plain_ms"] = cuda_ms(torch, lambda: chain_plain(*a, groups=g))
        sh = rec["shape"]
        flops, nbytes = k2_work(sh["B"], sh["T"], g, sh["C"], sh["L"],
                                act_bytes=2)
        rec["bound_ms"], rec["bound_by"] = bound_ms(2 * flops, nbytes,
                                                    PEAK_TF32_FLOPS)
        rec["ffma_bound_ms"] = bound_ms(flops, nbytes)[0]
        log(f"[timing] {smi}: K2-bf16 {name}: {rec['ms']:.4f} ms "
            f"({flops / (rec['ms'] / 1e3) / 1e12:.2f} TFLOP/s), plain "
            f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms by "
            f"{rec['bound_by']} (2 TF32 MMAs a multiply-add; f32 FMA bound "
            f"{rec['ffma_bound_ms']:.4f} ms; {flops / 1e9:.2f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB)")

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
         "source": "mixstage_tpu_torch/ops/cuda/csrc/conv_chain.cu",
         "replaces": "mixstage_tpu/ops/pallas/fused_conv.py:75",
         # a public op: no path of the package calls it
         "launches": launches[5],
         "max_abs_err": max(r["max_abs_err"] for r in k2_16.values()),
         "ms": main2["ms"], "plain_ms": main2["plain_ms"],
         "bound_ms": main2["bound_ms"], "bound_by": main2["bound_by"],
         "library_ms": None, "mma": "ffma",
         "ffma_bound_ms": main2["ffma_bound_ms"],
         "max_ulps": max(r["max_ulps"] for r in k2_16.values())}]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2

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
    # K1's instances (N, terms): the f32 mode's (terms 3) registers, spills
    # and ptxas's advisories (a wgmma it serialises says so)
    k1_ptxas = results["ptxas"]["fused_decoder_wgmma"]
    inst = [k for k in k1_ptxas["kernels"]
            if k[0].startswith("decoder_kernel")]
    check(len(inst) == 10, f"{len(inst)} decoder_kernel instances built, "
          f"expected 10 (5 widths x 2 modes)")
    for kernel, regs, stores, loads in inst:
        if kernel.endswith(", 3>"):
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
    for kern in [k1] + k3 + [k4]:
        kern["mode"] = "f32" if kern is not k4 else "int8"
    k2["mode"] = "f32"
    kernels = [k1] + k3 + [k4, k2] + k16 + k8_16
    results["kernels"] = kernels
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
