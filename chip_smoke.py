#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``mixstage_tpu_torch``) on one CUDA card.

Drives the port's serving path end to end at the full width of the flagship
model — ``JointLateClusterSoftStyle4_G`` with 8 clusters, 8 speakers, 256
channels, style_dim 10 and 96 pose features, on 64-frame clips of 128 mel
bins at batch 32 — with random weights drawn from ``--seed``:

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
   limit beside them.

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

# the flagship model (bench.py:205-213) and its serving shapes
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
    results["kernels"] = [k1]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps({"kernels": [k1]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
