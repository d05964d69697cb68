#!/usr/bin/env python3
"""Trace kernel K1 and its plain PyTorch version on one CUDA card.

For each shape (bs32 classifier chain, and the decoder and classifier at
the server's 4096-frame bucket) it runs K1 and the plain version
(``fused_mixstage_decoder_plain``: cuDNN convolutions and matmuls) five
times each under ``torch.profiler`` and prints, per version: the device
kernels with their launch count and device time per call, the device busy
time per call (union of kernel intervals), the host's wall time per call,
and the device's idle share of that wall time.  It does the same for one
bs32 serving call of the full-width flagship model, f32 and int8 (K1's
classifier launch, then K4).

    python3 tools/profile_k1.py [--seed 0] [--out profile.json]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (C, C0, MEL, MODEL, B, T, k1_work,  # noqa: E402
                        random_folded)
from mixstage_tpu_torch import resolve_device  # noqa: E402
from mixstage_tpu_torch.models import JointLateClusterSoftStyle4_G  # noqa: E402
from mixstage_tpu_torch.models.layers import reset_parameters_  # noqa: E402
from mixstage_tpu_torch.ops.cuda.fused_conv import (  # noqa: E402
    device_tile_frames, fused_mixstage_decoder, fused_mixstage_decoder_plain)
from mixstage_tpu_torch.serve import build_serving_fn  # noqa: E402

SHAPES = {   # name: (B, T, G, L, F)
    "classifier": (B, T, 1, 5, 8),
    "decoder_T4096": (1, 4096, 8, 3, 96),
    "classifier_T4096": (1, 4096, 1, 5, 8),
}
CALLS = 5


def trace(fn) -> dict:
    """Device kernels, busy time and idle share of ``CALLS`` calls of fn."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / CALLS
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    spans, kernels = [], {}
    for e in p.events():
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
    busy_ms = busy_us / 1e3 / CALLS
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                idle_share=(1 - busy_ms / wall_ms) if wall_ms else None,
                kernels=[dict(name=n, launches_per_call=c / CALLS,
                              ms_per_call=ms / CALLS) for n, (c, ms) in top])


def report(label: str, rec: dict, flops: float = 0.0) -> None:
    rate = (f", {flops / (rec['device_busy_ms'] / 1e3) / 1e12:.2f} TFLOP/s "
            f"f32 over busy time" if flops and rec["device_busy_ms"] else "")
    print(f"[profile] {label}: wall {rec['wall_ms']:.4f} ms/call, device "
          f"busy {rec['device_busy_ms']:.4f} ms/call, idle share "
          f"{rec['idle_share']:.3f}{rate}", flush=True)
    for k in rec["kernels"][:6]:
        print(f"[profile]   {k['ms_per_call']:.4f} ms x"
              f"{k['launches_per_call']:g}  {k['name'][:110]}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = resolve_device()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[profile] {smi}; torch {torch.__version__}", flush=True)
    gen = torch.Generator().manual_seed(args.seed)
    out = {"card": smi}
    with torch.inference_mode():
        for name, (b, t, g, layers, f) in SHAPES.items():
            a = random_folded(torch, gen, b, t, g, layers, f, device)
            flops, _ = k1_work(b, t, g, layers, f)
            tile = device_tile_frames(b, t, C0, C, layers, g, device)
            k1 = trace(lambda: fused_mixstage_decoder(*a, groups=g))
            plain = trace(lambda: fused_mixstage_decoder_plain(*a, groups=g))
            report(f"{name} K1 (tile {tile})", k1, flops)
            report(f"{name} plain", plain, flops)
            out[name] = dict(tile=tile, flops=flops, k1=k1, plain=plain)

        model = JointLateClusterSoftStyle4_G(**MODEL)
        reset_parameters_(model, torch.Generator().manual_seed(args.seed + 1),
                          random_bn_stats=True)
        serve = build_serving_fn(model)
        audio = torch.randn(B, T, MEL, generator=gen).to(device)
        styles = torch.randint(0, MODEL["num_speakers"], (B,),
                               generator=gen).to(device)
        out["serving_bs32"] = trace(lambda: serve(audio, styles))
        report(f"serving call bs{B} T{T}", out["serving_bs32"])
        calib = (torch.randn(B, T, MEL, generator=gen),
                 torch.randint(0, MODEL["num_speakers"], (B,), generator=gen))
        serve8 = build_serving_fn(model, quantize_int8=True, calib=calib)
        out["serving_int8_bs32"] = trace(lambda: serve8(audio, styles))
        report(f"int8 serving call bs{B} T{T}", out["serving_int8_bs32"])
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    print(f"[profile] done ({smi})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
