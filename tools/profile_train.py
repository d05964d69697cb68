#!/usr/bin/env python3
"""Trace the full-width GAN train steps of the port on one CUDA card.

Builds the flagship training configuration of ``chip_smoke.py`` (batch 32,
64 frames, random weights from ``--seed``) and runs, five times each under
``torch.profiler``: the G step with the fused decoder (K3), the G step
with the plain decoder, and the D step.  For each it prints the host's wall
time per step, the device busy time per step (union of kernel intervals),
the device's idle share of the wall time, the share of busy time spent in
K3's kernels (split into its GEMM passes and its column passes), and the
device kernels that take the most time.  ``--dtype bfloat16`` traces the
same steps at the bf16 compute dtype (K3's bf16 mode in the fused G step).

    python3 tools/profile_train.py [--seed 0] [--dtype float32|bfloat16]
                                   [--out profile.json]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import TRAIN_CFG, B, T, train_batch  # noqa: E402
from mixstage_tpu_torch.train import StepConfig, StepFactory  # noqa: E402
from tools.profile_k1 import report, trace  # noqa: E402

# the kernels of csrc/train_decoder.cu: the GEMM passes (f32: 3xTF32
# mma.sync; bf16: the wgmma GEMM of csrc/train_gemm_bf16.cuh, the packing
# of its operand images and the sum of its split-K partials) and the column
# passes (bf16: the image-writing ones too)
K3_GEMM = ("gemm_kernel<", "wgmma_gemm_kernel<", "pack_kernel",
           "split_sum_kernel")
K3_COLUMN = ("bn_stats_kernel", "bn_act_kernel", "bn_act_img_kernel",
             "bn_bwd_sums_kernel", "bn_bwd_dc_kernel", "bn_bwd_dc_img_kernel",
             "col_sum_kernel", "reduce_splits_kernel", "group_sum_kernel")


def k3_ms(rec, names) -> float:
    """Device ms per step of the kernels of csrc/train_decoder.cu whose
    names hold one of ``names``."""
    return sum(k["ms_per_call"] for k in rec["kernels"]
               if any(f"::{n}" in k["name"] for n in names))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dtype = getattr(torch, args.dtype)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[profile] {smi}; torch {torch.__version__}; {args.dtype}",
          flush=True)
    batch = train_batch(np.random.default_rng(args.seed), B, T)
    out = {"card": smi, "dtype": args.dtype}
    for name, fused, step in (("G step, fused decoder", True, "g"),
                              ("G step, plain decoder", False, "g"),
                              ("D step", True, "d")):
        factory = StepFactory(StepConfig(**TRAIN_CFG, fused_decoder=fused,
                                         dtype=dtype))
        state = factory.init(seed=args.seed + 1)
        device = factory.device
        dbatch = {k: (tuple(torch.as_tensor(a, device=device) for a in v)
                      if k == "x" else torch.as_tensor(v, device=device))
                  for k, v in batch.items()}
        fn = factory.make_steps()[step]
        rec = trace(torch, lambda: fn(state, dbatch))
        gemm_ms, col_ms = k3_ms(rec, K3_GEMM), k3_ms(rec, K3_COLUMN)
        rec.update(k3_ms=gemm_ms + col_ms, k3_gemm_ms=gemm_ms,
                   k3_column_ms=col_ms)
        report(f"{name} {args.dtype} bs{B} T{T}", rec)
        print(f"[profile]   K3 kernels {gemm_ms + col_ms:.4f} ms/step "
              f"({(gemm_ms + col_ms) / rec['device_busy_ms']:.3f} of busy "
              f"time): GEMM passes {gemm_ms:.4f} ms, column passes "
              f"{col_ms:.4f} ms; "
              f"{sum(k['launches_per_call'] for k in rec['kernels']):g} "
              f"kernel launches per step", flush=True)
        out[name] = rec
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    print(f"[profile] done ({smi})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
