"""Readings that the limits of a cell's correctness check are set from.

    python3 -m bench_port.tools.calibrate --workload <name> \\
        --seeds 1,2,...,12 --controls 101,102,103 [--seconds 1] \\
        [--out readings.json]

On the card, in one process:

* the lower readings: for each of ``--seeds`` and ``--controls`` a run
  of the cell's own loop (set-up, a window of ``--seconds``, no result
  line) and its numbers against the reference;
* the control: the reference itself put in the program's place,
  computed in TF32 (the precision just below the configurations' float32
  with TF32 off), on each of ``--controls``; for training over set-up's
  first call and, resumed from the program's state before it, over the
  run's compared window call;
* the faults that a cell can have, planted in the reference put in the
  program's place: for training, half of each batch left out (the mean
  taken over the rest); for serving, an answer handed to another request
  (each pose compared with its neighbour's reference).  A training step
  that returns its state unchanged reads 1 on ``change_gap`` and
  ``window_change_gap`` by their definition and needs no run.

Prints one JSON object of every reading (and writes it to ``--out``).
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

import numpy as np
import torch

from bench_port.loops import serve as serve_loop
from bench_port.loops import train as train_loop
from bench_port.harness import checks, data
from bench_port.harness.spec import ROOT, Cell, load_manifest
from bench_port.reference.steps import ReferenceTrainer


class HalfBatchTrainer(ReferenceTrainer):
    """The reference with half of each batch left out."""

    def run(self, batches, coins):
        half = [{k: v[: v.shape[0] // 2] for k, v in b.items()}
                for b in batches]
        return super().run(half, coins)




def train_controls(cell, seed, device, out):
    """The control and the faults in the program's place, over set-up's
    first call and over the run's compared window call."""
    cfg, tr = cell.config, cell.traffic
    coins, call = out["first_coins"], out["window_call"]
    ref, rl = train_loop.reference_first_call(cfg, tr, seed, device, coins)
    wref, wl, wafter = train_loop.reference_window_call(cfg, tr, seed,
                                                        device, call)
    result = {}
    for name, kw in (("tf32", {"tf32": True}),
                     ("half_batch", {"trainer_cls": HalfBatchTrainer})):
        _, cl = train_loop.reference_first_call(cfg, tr, seed, device,
                                                coins, **kw)
        detail = {}
        nums = train_loop.numbers(ref, rl, cl["losses"], cl, detail)
        _, closs, cafter = train_loop.reference_window_call(
            cfg, tr, seed, device, call, **kw)
        nums.update(train_loop.window_numbers(
            wref, wl, wafter, {**call, "losses": closs, "after": cafter},
            detail))
        result[name], result[name + "_detail"] = nums, detail
    result["state_unchanged"] = {"change_gap": 1.0, "window_change_gap": 1.0}
    return result


def serve_controls(cell, seed, device, out=None):
    cfg, tr = cell.config, cell.traffic
    if tr["loop"] == "serve":
        audio, style = serve_loop.inputs(cfg, tr, seed, device)
    else:
        pool = data.clips(cfg, tr, seed, device)
        B = tr["batch"]
        n = tr["pool"] // B
        audio = pool["audio"][: n * B].reshape(n, B, *pool["audio"].shape[1:])
        style = pool["style"][: n * B].reshape(n, B)
    ref = serve_loop.reference_poses(cfg, seed, device, audio, style)
    tf32 = serve_loop.reference_poses(cfg, seed, device, audio, style,
                                        tf32=True)
    return {"tf32": {"pose_err": max(checks.rel_fro(c, r)
                                     for c, r in zip(tf32, ref))},
            "wrong_request": {"pose_err": max(
                checks.rel_fro(np.roll(r, 1, axis=0), r) for r in ref)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = Cell(load_manifest(ROOT), args.workload, ROOT)
    loop = importlib.import_module(
        f"bench_port.loops.{cell.traffic['loop']}")
    result = {"workload": args.workload, "device":
              torch.cuda.get_device_name(device), "seeds": {},
              "controls": {}}
    controls = [int(s) for s in args.controls.split(",") if s]
    for seed in [int(s) for s in args.seeds.split(",") if s] + controls:
        out = loop.run(cell, seed, args.seconds, False, device)
        if cell.traffic["loop"] == "train":
            detail = {}
            nums = train_loop.compare(cell.config, cell.traffic, seed,
                                      device, out, detail)
            nums["detail"] = detail
        else:
            nums = out["check"]()
        nums["metrics"] = out["metrics"]
        result["seeds"][seed] = nums
        print(f"[calibrate] seed {seed}: {json.dumps(nums)}", flush=True)
        if seed in controls:
            ctl = train_controls if cell.traffic["loop"] == "train" \
                else serve_controls
            result["controls"][seed] = ctl(cell, seed, device, out)
            print(f"[calibrate] control {seed}: "
                  f"{json.dumps(result['controls'][seed])}", flush=True)
        del out
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
