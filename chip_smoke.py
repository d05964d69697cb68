#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``mixstage_tpu_torch``) on one CUDA card.

Drives the port's two main paths end to end at the full width of the
flagship model — ``JointLateClusterSoftStyle4_G`` with 8 clusters, 8
speakers, 256 channels, style_dim 10 and 96 pose features, on 64-frame
clips of 128 mel bins at batch 32 — with random weights drawn from
``--seed``: serving (phases 1-6) and GAN training (phases 7-9):

1. device: the card's name and power limit from ``nvidia-smi``;
2. build: every CUDA kernel from the checkout's sources, one ``nvcc`` per
   source, all started together;
3. kernels: each kernel against its plain PyTorch version on the card, at
   every shape the main path launches it at (bs32 and one clip of 64
   frames, the server's 128-frame bucket) and at T=4096
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
   frames/s; K3-fwd and K3-bwd against their bounds and plain versions.

It prints one JSON line of kernels, the ``nvidia-smi`` line, and last the
device line ``{"ok": true, "device": {...}}``.  Any failed check exits
nonzero; without a CUDA device it exits nonzero before printing a result.

    python3 chip_smoke.py [--seed 0] [--out results.json]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import subprocess
import sys
import time

import numpy as np

# published peaks of one H100 SXM (NVIDIA data sheet): f32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
KERNEL_TOL = 1e-4            # max |kernel - plain| / max |plain|
DRIFT_TOL = 0.01             # the serving path's BN-fold drift contract
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


# the training configuration of bench.py:205-249 (in_channels 256 is the
# generator's default)
TRAIN_CFG = dict(model="JointLateClusterSoftStyle4_G", gan=True,
                 criterion="L1Loss", num_clusters=8, num_speakers=8)
F_POSE, LAYERS = MODEL["out_feats"], 4
SCAN_K = 8
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


def bound_ms(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


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
        for line in compiler_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
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
        tile = device_tile_frames(b, t, C0, C, layers, g, device)
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
        rec["bound_ms"], rec["bound_by"] = bound_ms(flops, nbytes)
        rec["flops"], rec["bytes"] = flops, nbytes
        rec["tflops"] = flops / (rec["ms"] / 1e3) / 1e12
        log(f"[timing] {smi}: K1 {name}: {rec['ms']:.4f} ms "
            f"({rec['tflops']:.2f} TFLOP/s f32), plain {rec['plain_ms']:.4f} "
            f"ms, bound {rec['bound_ms']:.4f} ms by {rec['bound_by']} "
            f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
    results["timing"] = dict(clip_p50_ms=p50, bs32_call_ms=call_ms,
                             bs32_frames_per_s=fps,
                             plain_bs32_call_ms=plain_call_ms,
                             features_ms=feats_ms)

    main_shapes = ("decoder", "classifier")
    call_bound_ms, call_bound_by = bound_ms(
        sum(per_shape[s]["flops"] for s in main_shapes),
        sum(per_shape[s]["bytes"] for s in main_shapes))
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
        "shapes": per_shape,
    }

    # 7. training kernels against their plain versions ---------------------
    from mixstage_tpu_torch.ops.cuda import train_decoder as td
    from mixstage_tpu_torch.train import StepConfig, StepFactory

    kgen = torch.Generator().manual_seed(args.seed + 3)

    def k3_args(b, t):
        g = MODEL["num_clusters"]

        def draw(*shape, scale, shift=0.0):
            return (torch.randn(*shape, generator=kgen) * scale
                    + shift).to(device)

        return (draw(b, t, C0, scale=1.0),
                draw(g, 3, C0, C, scale=(3 * C0) ** -0.5),
                draw(LAYERS - 1, g, 3, C, C, scale=(3 * C) ** -0.5),
                draw(g, LAYERS, C, scale=0.1),
                draw(g, LAYERS, C, scale=0.2, shift=1.0),
                draw(g, LAYERS, C, scale=0.1),
                draw(g, C, F_POSE, scale=C ** -0.5),
                draw(g, 1, F_POSE, scale=0.1))

    k3_main = k3_args(B, T)
    fwd_err, bwd_err, fwd_out, dout = check_k3(torch, td, "bs32", k3_main,
                                               args.seed + 4)
    for b_, t_ in ((3, 50),):                    # ragged: the sequence ends
        e_f, e_b, _, _ = check_k3(torch, td, "ragged",
                                  k3_args(b_, t_), args.seed + 5)
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
        bms, by = bound_ms(flops, nbytes)
        log(f"[timing] {smi}: K3 {name} bs{B}: {ms:.4f} ms "
            f"({flops / (ms / 1e3) / 1e12:.2f} TFLOP/s f32), plain "
            f"{plain_ms:.4f} ms, bound {bms:.4f} ms by {by} "
            f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
        k3.append({
            "name": name, "route": "cuda",
            "source": "mixstage_tpu_torch/ops/cuda/csrc/train_decoder.cu",
            "replaces": f"mixstage_tpu/ops/pallas/train_decoder.py:{line}",
            "launches": count, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            # no single PyTorch call computes the train-mode conv + BN chain
            "library_ms": None})
    results["train"] = dict(total_fused=tot_f, total_unfused=tot_u,
                            param_diff=p_err, stat_diff=s_err,
                            mu_gaps=mu_gaps, mu_bias_gap=bias_gap,
                            pose_drift=pose_drift, timing=train_t,
                            coins=coins.tolist(), k3_launches=k3_launches)
    results["kernels"] = [k1] + k3
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps({"kernels": [{k: v for k, v in kern.items()
                                   if k != "shapes"} for kern in [k1] + k3]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
