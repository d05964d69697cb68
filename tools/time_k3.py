#!/usr/bin/env python3
"""Times K3's wrappers (``decoder_train_fwd`` and ``decoder_train_bwd``,
f32 and bf16 modes) at the flagship's bs32 x 64 shape (G = 8, C0 = 266,
C = 256, F = 96) with CUDA events, one rank (no statistics exchange), and
prints one JSON line with the card's name and power limit.

Run it from two checkouts in turns (parent, change, change, parent) in one
call on the card to compare two versions of K3, e.g. the staged C entry
points of the data-parallel exchange against the undivided ones:

    python3 tools/time_k3.py --label change
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import B, T, cuda_ms, random_train  # noqa: E402
from mixstage_tpu_torch import resolve_device  # noqa: E402
from mixstage_tpu_torch.ops.cuda import train_decoder as td  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator().manual_seed(args.seed)
    out = {"label": args.label, "card": smi, "shape": [B, T], "ms": {}}
    for mode, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        a = tuple(t.to(dt) for t in random_train(torch, gen, B, T, device))
        fwd = td.decoder_train_fwd(*a)
        dout = torch.randn(fwd[0].shape, generator=gen).to(device, dt)
        x, w0, wc, _, gamma, beta, wl, _ = a
        bwd = (dout, x, fwd[1], fwd[2], fwd[3], w0, wc, gamma, beta, wl)
        out["ms"][f"fwd_{mode}"] = cuda_ms(
            torch, lambda: td.decoder_train_fwd(*a), reps=args.reps)
        out["ms"][f"bwd_{mode}"] = cuda_ms(
            torch, lambda: td.decoder_train_bwd(*bwd), reps=args.reps)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
