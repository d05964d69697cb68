"""The open-loop cell's knee: its loop at a list of fixed rates.

    python3 -m bench_port.tools.sweep --workload mixstage8.serve.open.f32 \\
        --rates 500,1000,1500 --seconds 10 --seed 7 [--out sweep.json]

On the card, in one process: at each rate one timed window (p50, p95,
failed share) and one traced window (batch occupancy, device idle
share), each with its own set-up.  The knee is the highest rate whose
requests all get answered without a growing backlog; the cell's traffic
file carries a rate below it as a number.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from bench_port.loops import open_loop
from bench_port.harness.spec import ROOT, Cell, load_manifest, read_per_layer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = Cell(load_manifest(ROOT), args.workload, ROOT)
    rows = []
    for rate in [float(r) for r in args.rates.split(",")]:
        cell.traffic = {**cell.traffic, "rate": rate}
        timed = open_loop.run(cell, args.seed, args.seconds, False, device)
        traced = open_loop.run(cell, args.seed, args.seconds, True, device)
        reading = {**traced["reading"], "loop": "open_loop",
                   "config": cell.config, "traffic": cell.traffic}
        row = {"rate": rate, **timed["metrics"],
               "failed_share": timed["failed"] / timed["attempted"],
               **{k: v["value"] for k, v in
                  read_per_layer(cell, reading).items()}}
        rows.append(row)
        print(f"[sweep] {json.dumps(row)}", flush=True)
        torch.cuda.empty_cache()
    result = {"workload": args.workload,
              "device": torch.cuda.get_device_name(device), "rows": rows}
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
