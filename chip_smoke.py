#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``mixstage_tpu_torch``) on one CUDA card.

Drives the port's two main paths end to end at the full width of the
flagship model — ``JointLateClusterSoftStyle4_G`` with 8 clusters, 8
speakers, 256 channels, style_dim 10 and 96 pose features, on 64-frame
clips of 128 mel bins at batch 32 — with random weights drawn from
``--seed``: serving (phases 1-6), GAN training (phases 7-9) and the int8
serving tier with the streaming and waveform endpoints (phases 10-14):

1. device: the card's name and power limit from ``nvidia-smi``;
2. build: every CUDA kernel from the checkout's sources, one ``nvcc`` per
   source, all started together;
3. kernels: K1 (3xTF32 on the tensor cores) against its plain PyTorch
   version on the card, at every shape the main path launches it at (bs32
   and one clip of 64 frames, the server's 128-frame bucket) and at T=4096
   (max |err| / max |ref| ≤ 1e-4);
4. model: one serving call launches K1 exactly twice, and its pose stays
   within 1% (mean |diff| / mean |pose|) of the plain path and of the
   unfolded eval forward;
5. server: concurrent JSON and npz ``/v1/pose`` requests through the HTTP
   micro-batcher, ``/healthz`` (backend cuda) and ``/stats``;
6. timings: p50 latency of one 64-frame clip, bs32 frames/s, each K1 shape
   and its plain version (CUDA events), with the card's name and power
   limit beside them;
7. training kernels: K3-fwd (out, cs, mu, var at max |err| / max |ref| ≤
   1e-4) and K3-bwd (every gradient at relative Frobenius error ≤ 1e-4;
   dcb, 0 analytically, below 1e-4·max |dbeta|) against their plain
   versions at bs32 × 64 and at a ragged B=3, T=50;
8. training steps through ``StepFactory``: one fused G step (K3 launched
   exactly once each way) against the unfused one from the same state
   (total loss rtol 1e-4, params atol 2·lr, BN statistics 1e-4 of each
   leaf's scale, G's Adam mu — its gradients — per module at relative
   Frobenius ``MOMENT_TOL``), a D step, and ``make_scan_train_step(8)``
   with seeded coins (finite losses, K3 launched once each way per G
   step);
9. training timings (CUDA events): G step, D step and the k-step driver's
   mean step, fused and unfused in four ABBA turns each; train pose
   frames/s; K3-fwd and K3-bwd (3xTF32 on the tensor cores) against their
   bounds and plain versions;
10. int8 and chain kernels: K4 against ``decoder_int8_plain`` at every shape
    the int8 path launches it at (bs32 × 64, one 64-frame clip, the bs32
    128-frame bucket) and at B=1 T=4096 and a ragged B=3 T=50, with weights
    quantized from seeded folded weights (no element differs: K4's integer
    MMA sums are exact and it rounds as its plain version does); K2
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
    versions; the bs32 int8 call against the f32 one in ABBA turns.

Each kernel's bound is that of its route: K1 and K3 at the TF32
tensor-core rate (3 MMAs per multiply-add; the f32 FMA bound beside it as
``ffma_bound_ms``), K4 at the int8 tensor-core rate, K2 at the f32 FMA
rate; ``mma`` names the inner product.

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
PEAK_TF32_FLOPS = 495e12     # K1's and K3's route: 3 TF32 MMAs a multiply-add
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
    "ragged": (3, 50, 8, 256, 3)}
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


def k1_work(b, t, g, layers, f):
    """(flops, bytes) of one K1 call: every multiply-add of the chain, and
    each input read once and the output written once (f32)."""
    flops = 2 * b * t * g * (3 * C0 * C + layers * 3 * C * C + C * f)
    elems = (b * t * C0 + g * 3 * C0 * C + layers * g * 3 * C * C
             + g * (layers + 1) * C + g * C * f + g * f + b * t * g * f)
    return flops, 4 * elems


def k3_work(b, t, g, f):
    """(flops, bytes) of K3-fwd and of K3-bwd (f32, each input read once
    and each output written once).  The backward does the forward's
    multiply-adds twice: dW and d(input) of every conv and of the head."""
    n = b * t
    flops = 2 * n * g * (3 * C0 * C + (LAYERS - 1) * 3 * C * C + C * f)
    params = g * 3 * C0 * C + (LAYERS - 1) * g * 3 * C * C + g * C * f
    vec = g * LAYERS * C                     # one (G, 4, C) array
    fwd = (n * C0 + params + 3 * vec + g * f           # x, weights, cb/γ/β, bl
           + g * n * f + LAYERS * g * n * C + 2 * vec)  # out, cs, mu/var
    bwd = (g * n * f + n * C0 + LAYERS * g * n * C + 2 * vec + params
           + 2 * vec                                   # dout, x, cs, stats, γ/β
           + n * C0 + params + 3 * vec + g * f)        # dx, dW, dcb/dγ/dβ, dbl
    return (flops, 4 * fwd), (2 * flops, 4 * bwd)


def k4_work(b, t, g, layers, f):
    """(int8 operations, bytes) of one K4 call: 2 per multiply-add of the
    chain; the int8 weights, the f32 input, scales, multipliers and biases
    read once and the f32 output written once."""
    macs = 3 * C0 * C + layers * 3 * C * C + C * f
    f32 = (b * t * C0 + C0 + g * C + layers * g * C + 2 * g * (layers + 1) * C
           + 2 * g * f + b * t * g * f)
    return 2 * b * t * g * macs, g * macs + 4 * f32


def k2_work(b, t, g, c, layers):
    """(flops, bytes) of one K2 call (f32, each input read once)."""
    return (2 * b * t * g * layers * 3 * c * c,
            4 * (2 * b * t * g * c + layers * g * 3 * c * c + layers * g * c))


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
    """``gemm_kernel<1, 64, 64>`` from an Itanium-mangled kernel name: the
    last part of its nested name and its integer template arguments."""
    i, parts = (3 if mangled.startswith("_ZN") else 2), []
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        parts.append(mangled[j:j + int(mangled[i:j])])
        i = j + int(mangled[i:j])
    name = parts[-1] if parts else mangled
    targs = re.match(r"I((?:Li-?\d+E)+)E", mangled[i:])
    if targs:
        name += "<" + ", ".join(re.findall(r"Li(-?\d+)E", targs.group(1))) \
            + ">"
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


def cuda_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
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
    from mixstage_tpu_torch.streaming import session_over_serving_fn

    G, L, F = MODEL["num_clusters"], 3, MODEL["out_feats"]
    S = MODEL["num_speakers"]

    # 10. int8 and chain kernels against their plain versions ------------
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
    # The direct calls run at the batcher's batch size, the request tiled as
    # the batcher pads it: int8 turns float differences of batch-size
    # dependent convolution algorithms into flipped LSBs, so only the same
    # batch shape can be held to equality.
    scale = float(pose8.abs().mean())

    def direct8(a, sty):
        """``serve8`` on a batch of one, run as the batcher runs it."""
        out = serve8(np.repeat(a, B, axis=0), np.repeat(sty, B, axis=0))
        return out[:1].cpu().numpy()

    def served_err(got, want):
        """max |diff| / mean |pose|, and the count of differing elements."""
        return (float(np.abs(got - want).max()) / scale,
                int(np.count_nonzero(got != want)))

    batcher = DynamicBatcher(serve8, batch_size=B, max_wait_ms=5.0)
    service = PoseService(batcher, backend=serve8.device.type, num_styles=S,
                          mel_bins=MEL)
    server = start_http_server(service, port=0, host="127.0.0.1")
    onehot = np.eye(S, dtype=np.float32)
    try:
        client = PoseClient(f"http://127.0.0.1:{server.server_address[1]}",
                            timeout_s=300)
        jobs = [("npz", 64, 2), ("json", 64, 5), ("npz", 100, 7)]
        worst, ndiff = 0.0, 0
        for kind_, n, sty in jobs:
            a = rng.normal(size=(n, MEL)).astype(np.float32)
            got = (client.pose if kind_ == "npz" else client.pose_json)(
                a, style=sty)
            bucket = 64 if n <= 64 else 128
            padded = np.concatenate([a, np.repeat(a[-1:], bucket - n, 0)])
            want = direct8(padded[None], onehot[[sty]])[0, :n]
            check(got.shape == (n, F), f"int8 {kind_} response {got.shape}")
            err, n_diff = served_err(got, want)
            worst, ndiff = max(worst, err), ndiff + n_diff
        log(f"[int8-server] {len(jobs)} /v1/pose requests (npz, json; 64 and"
            f" 100 frames) vs the direct call at batch {B}: {ndiff} elements "
            f"differ, max|diff|/mean|pose| {worst:.3e} (tol 0)")
        check(ndiff == 0, "int8 served pose differs from direct")
        x = rng.normal(size=(150, MEL)).astype(np.float32)
        stream = client.stream(style=3, hop=32)
        pieces = [stream.feed(x[i:i + 40]) for i in range(0, 150, 40)]
        pieces.append(stream.finish())
        got = np.concatenate([q for q in pieces if q.size])
        sess = session_over_serving_fn(direct8, onehot[3], hop=32)
        want = np.concatenate([q for q in (sess.feed(x), sess.finish())
                               if q.size])
        check(got.shape == (150, F), f"streamed pose {got.shape}")
        stream_err, stream_diff = served_err(got, want)
        stats = client.stats()
        log(f"[int8-server] streaming session over HTTP (150 frames in "
            f"chunks of 40, hop 32) vs StreamingSession over the direct "
            f"serving fn at batch {B}: {stream_diff} elements differ, "
            f"max|diff|/mean|pose| {stream_err:.3e} (tol 0); stats "
            f"requests={stats['requests']} batches={stats['batches']} "
            f"streams={stats['streams']}")
        check(stream_diff == 0, "streamed pose differs")
        check(stats["streams"] == 0, "the finished stream is still live")
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
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
                       np.repeat(onehot[[4]], 4, axis=0))[0].cpu().numpy()
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
        rec["bound_ms"], rec["bound_by"] = bound_ms(flops, nbytes)
        log(f"[timing] {smi}: K2 {name}: {rec['ms']:.4f} ms "
            f"({flops / (rec['ms'] / 1e3) / 1e12:.2f} TFLOP/s f32), plain "
            f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms by "
            f"{rec['bound_by']} ({flops / 1e9:.2f} GFLOP, "
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
          "library_ms": None, "mma": "s8"}
    k2 = {"name": "fused_grouped_conv_chain", "route": "cuda",
          "source": "mixstage_tpu_torch/ops/cuda/csrc/fused_decoder.cu",
          "replaces": "mixstage_tpu/ops/pallas/fused_conv.py:75",
          # a public op: no path of the package calls it
          "launches": launches[2],
          "max_abs_err": max(r["max_abs_err"] for r in k2_shapes.values()),
          "ms": main2["ms"], "plain_ms": main2["plain_ms"],
          "bound_ms": main2["bound_ms"], "bound_by": main2["bound_by"],
          "library_ms": None, "mma": "ffma"}
    return k4, k2


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
    from mixstage_tpu_torch.ops.cuda.fused_conv import (
        device_tile_frames, fused_mixstage_decoder,
        fused_mixstage_decoder_plain)
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
    for name, (sec, compiler_log) in built.items():
        log(f"[build] {name}: {sec:.1f} s  ({build.library_path(name).name})")
        for kernel, regs, stores, loads in ptxas_summary(compiler_log):
            log(f"[build]   {kernel}: {regs} registers, {stores} bytes spill "
                f"stores, {loads} bytes spill loads")
    log(f"[build] all kernels in {results['build_s']:.1f} s")

    # 3. kernels against their plain versions ------------------------------
    gen = torch.Generator().manual_seed(args.seed)
    per_shape = {}
    for name, (b, t, g, layers, f) in K1_SHAPES.items():
        a = random_folded(torch, gen, b, t, g, layers, f, device)
        with torch.no_grad():
            out = fused_mixstage_decoder(*a, groups=g)
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
                               max_rel_err=rel_err, args=a)

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

    fused_mixstage_decoder.launches = 0              # main path starts
    pose = serve(audio, styles)
    torch.cuda.synchronize()
    check(fused_mixstage_decoder.launches == 2,
          f"one serving call launched K1 {fused_mixstage_decoder.launches} "
          f"times, expected 2")
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
    check(launches == 2 * (2 + stats["batches"]),
          f"K1 launches {launches} over the main path, expected "
          f"2 per serving call")
    log(f"[server] K1 launches over the main path (model + server phases): "
        f"{launches}")

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
        a, g = rec.pop("args"), rec["shape"]["G"]
        with torch.no_grad():
            rec["ms"] = cuda_ms(torch, lambda: fused_mixstage_decoder(
                *a, groups=g))
            rec["plain_ms"] = cuda_ms(torch, lambda: fused_mixstage_decoder_plain(
                *a, groups=g))
        s = rec["shape"]
        flops, nbytes = k1_work(s["B"], s["T"], g, s["L"], s["F"])
        rec["bound_ms"], rec["bound_by"] = bound_ms(3 * flops, nbytes,
                                                    PEAK_TF32_FLOPS)
        rec["ffma_bound_ms"] = bound_ms(flops, nbytes)[0]
        rec["flops"], rec["bytes"] = flops, nbytes
        rec["tflops"] = flops / (rec["ms"] / 1e3) / 1e12
        log(f"[timing] {smi}: K1 {name}: {rec['ms']:.4f} ms "
            f"({rec['tflops']:.2f} TFLOP/s of f32 work), plain "
            f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms by "
            f"{rec['bound_by']} (3xTF32 tensor cores; f32 FMA bound "
            f"{rec['ffma_bound_ms']:.4f} ms; {flops / 1e9:.2f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB)")
    results["timing"] = dict(clip_p50_ms=p50, bs32_call_ms=call_ms,
                             bs32_frames_per_s=fps,
                             plain_bs32_call_ms=plain_call_ms,
                             features_ms=feats_ms)

    main_shapes = ("decoder", "classifier")
    call_flops = sum(per_shape[s]["flops"] for s in main_shapes)
    call_bytes = sum(per_shape[s]["bytes"] for s in main_shapes)
    call_bound_ms, call_bound_by = bound_ms(3 * call_flops, call_bytes,
                                            PEAK_TF32_FLOPS)
    k1 = {
        "name": "fused_mixstage_decoder", "route": "cuda",
        "source": "mixstage_tpu_torch/ops/cuda/csrc/fused_decoder.cu",
        "replaces": "mixstage_tpu/ops/pallas/fused_conv.py:179",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in per_shape.values()),
        # per serving call at bs32: the classifier launch + the decoder one
        "ms": sum(per_shape[s]["ms"] for s in main_shapes),
        "plain_ms": sum(per_shape[s]["plain_ms"] for s in main_shapes),
        "bound_ms": call_bound_ms,
        "bound_by": call_bound_by,
        "library_ms": None,
        "mma": "3xtf32",
        "ffma_bound_ms": bound_ms(call_flops, call_bytes)[0],
        "shapes": per_shape,
    }

    # 7. training kernels against their plain versions ---------------------
    from mixstage_tpu_torch.ops.cuda import train_decoder as td
    from mixstage_tpu_torch.train import StepConfig, StepFactory

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
        f"{MOMENT_TOL:g}); pose mean drift {pose_drift:.3e}; K3 launches "
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
        bms, by = bound_ms(3 * flops, nbytes, PEAK_TF32_FLOPS)
        ffma_ms = bound_ms(flops, nbytes)[0]
        log(f"[timing] {smi}: K3 {name} bs{B}: {ms:.4f} ms "
            f"({flops / (ms / 1e3) / 1e12:.2f} TFLOP/s of f32 work), plain "
            f"{plain_ms:.4f} ms, bound {bms:.4f} ms by {by} (3xTF32 tensor "
            f"cores; f32 FMA bound {ffma_ms:.4f} ms; {flops / 1e9:.2f} "
            f"GFLOP, {nbytes / 1e6:.1f} MB)")
        k3.append({
            "name": name, "route": "cuda",
            "source": "mixstage_tpu_torch/ops/cuda/csrc/train_decoder.cu",
            "replaces": f"mixstage_tpu/ops/pallas/train_decoder.py:{line}",
            "launches": count, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            # no single PyTorch call computes the train-mode conv + BN chain
            "library_ms": None, "mma": "3xtf32", "ffma_bound_ms": ffma_ms})
    results["train"] = dict(total_fused=tot_f, total_unfused=tot_u,
                            param_diff=p_err, stat_diff=s_err,
                            mu_gaps=mu_gaps, mu_bias_gap=bias_gap,
                            pose_drift=pose_drift, timing=train_t,
                            coins=coins.tolist(), k3_launches=k3_launches)
    k4, k2 = int8_phases(torch, args, device, smi, model, audio, styles,
                         pose, results)
    kernels = [k1] + k3 + [k4, k2]
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
