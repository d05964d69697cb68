#!/usr/bin/env python3
"""K3 on one CUDA card: its bf16 mode's accuracy against its plain version at
every card-test shape, and a library yardstick for its GEMM shapes.

For each shape of ``tests/test_torch_port_cuda.py::K3_SHAPES`` and the
flagship bs32 x 64 and ragged B=3 T=50 shapes, it runs K3-fwd's bf16 mode
and its plain version on the card-test inputs and prints, for ``out`` and
``cs``, max |kernel - plain| in bf16 ULPs of max |plain| and the share of
elements that differ (the card tests hold the kernel to limits set from
these).  Then it times ``torch.bmm`` in bf16 (CUDA events) on K3's GEMMs at
bs32 x 64 written as im2col products, 8 groups each: the convs (2048 x 816
or 768) @ (816 or 768 x 256), the logits 2048 x 256 @ 256 x 96, and the
weight gradient (768 x 2048) @ (2048 x 256).  The yardstick is on no path
of the port.

``--trace`` instead traces K3-fwd and K3-bwd in the mode of ``--dtype``
(bfloat16 by default, or float32) at bs32 x 64 and the ragged B=3 T=50
(torch.profiler): busy time, launches, and the time of each kernel per
call.

    python3 tools/k3_probe.py [--skip-shapes] [--trace]
                              [--dtype bfloat16|float32]
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from chip_smoke import (B, K3_RAGGED, T, bf16_ulps, cuda_ms,  # noqa: E402
                        random_train, trace)
from mixstage_tpu_torch import resolve_device  # noqa: E402
from mixstage_tpu_torch.ops.cuda import train_decoder as td  # noqa: E402
from test_torch_port_cuda import K3_SHAPES, _train_args  # noqa: E402

# (B, T, G, C0, C, F): the card tests' shapes, then the main path's
SHAPES = list(K3_SHAPES) + [(32, 64, 8, 266, 256, 96), (3, 50, 8, 266, 256, 96)]
# name: (batch of groups, M, K, N) of an im2col product at bs32 x 64
GEMMS = {"conv layer 0": (8, 2048, 816, 256), "conv": (8, 2048, 768, 256),
         "logits": (8, 2048, 256, 96), "dW": (8, 768, 2048, 256)}


def accuracy(device) -> None:
    for shape in SHAPES:
        B, T, G, C0, C, F = shape
        a16 = tuple(t.bfloat16() for t in _train_args(B, T, G, C0, C, F,
                                                      device))
        got = td.decoder_train_fwd(*a16)
        ref = td.decoder_train_fwd_plain(*a16)
        torch.cuda.synchronize()
        parts = []
        for name, p, q in zip(("out", "cs"), got, ref):
            ulps, share = bf16_ulps(torch, p, q)
            parts.append(f"{name} {ulps:.2f} ULPs, {share:.2%} differ")
        print(f"[probe] K3-fwd bf16 {shape}: " + "; ".join(parts),
              flush=True)


def yardstick(device) -> None:
    gen = torch.Generator().manual_seed(0)
    for name, (g, m, k, n) in GEMMS.items():
        a = torch.randn(g, m, k, generator=gen).to(device).bfloat16()
        b = torch.randn(g, k, n, generator=gen).to(device).bfloat16()
        ms = cuda_ms(torch, lambda: torch.bmm(a, b), reps=50, warmup=5)
        flop = 2.0 * g * m * k * n
        print(f"[probe] torch.bmm bf16 {name} {g} x ({m} x {k}) @ ({k} x "
              f"{n}): {ms:.4f} ms, {flop / ms / 1e9:.1f} TFLOP/s",
              flush=True)


def kernels(device, dtype) -> None:
    """K3-fwd and K3-bwd in the mode of ``dtype`` at bs32 x 64 and the
    ragged shape under torch.profiler: device busy time and each kernel's
    time per call."""
    gen = torch.Generator().manual_seed(0)
    tag = "-bf16" if dtype == torch.bfloat16 else ""
    for shape, (b, t) in (("bs32", (B, T)), ("ragged", K3_RAGGED)):
        a = tuple(v.to(dtype)
                  for v in random_train(torch, gen, b, t, device))
        x, w0, wc, _, gamma, beta, wl, _ = a
        _, cs, mu, var = td.decoder_train_fwd(*a)
        dout = torch.randn(w0.shape[0], b, t, wl.shape[-1],
                           generator=gen).to(device).to(dtype)
        bwd = (dout, x, cs, mu, var, w0, wc, gamma, beta, wl)
        for way, fn in (("fwd", lambda: td.decoder_train_fwd(*a)),
                        ("bwd", lambda: td.decoder_train_bwd(*bwd))):
            rec = trace(torch, fn, 10)
            print(f"[probe] K3-{way}{tag} {shape}: busy "
                  f"{rec['device_busy_ms']:.4f} ms, wall {rec['wall_ms']:.4f}"
                  f" ms, {rec['launches_per_call']:g} launches", flush=True)
            for k in rec["kernels"][:16]:
                print(f"[probe]   {k['ms_per_call']:.4f} ms x"
                      f"{k['launches_per_call']:g}  {k['name'][:100]}",
                      flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--skip-shapes", action="store_true",
                    help="no accuracy shares")
    ap.add_argument("--trace", action="store_true",
                    help="also trace K3's kernels, no yardstick")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16", help="the mode --trace traces")
    args = ap.parse_args(argv)
    device = resolve_device()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[probe] {smi}; torch {torch.__version__}", flush=True)
    with torch.no_grad():
        if not args.skip_shapes:
            accuracy(device)
        if args.trace:
            kernels(device, getattr(torch, args.dtype))
        else:
            yardstick(device)
    print(f"[probe] done ({smi})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
