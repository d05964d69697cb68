"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 -m bench_port.run --workload <name> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

Runs on the CUDA card of the machine it is started on (it exits non-zero,
with no result, when there is none or fewer than the cell asks for).  With
``--trace 0`` it measures the cell's end-to-end metrics over a window of
``--seconds``; with ``--trace 1`` it traces a shorter window under
``torch.profiler`` and reports the cell's per-layer metrics, the device's
busy time and a breakdown.  Either way it then checks what the window
produced against the plain reference (``bench_port/reference``), prints
each compared number beside its limit as the last lines of standard
error, and prints the result as one JSON line, last on standard output.

Build and kernel caches stay in the checkout (``build/``): the port's
``nvcc`` libraries in ``build/torch_kernels``, and the directories this
sets for Triton and PyTorch extensions.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
os.environ["USE_FLAX"] = "0"        # keep transformers from loading JAX
os.environ["USE_TF"] = "0"
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["OMP_NUM_THREADS"] = "1"     # one process, few threads: the
os.environ["MKL_NUM_THREADS"] = "1"     # host's other cores stay free


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bench_port.harness.spec import Cell, load_manifest

    cell = Cell(load_manifest(ROOT), args.workload, ROOT)
    import torch

    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"[bench] {args.workload} needs {cell.chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import mixstage_tpu_torch
    from bench_port.harness.runner import execute, forbidden_modules

    if ROOT not in Path(mixstage_tpu_torch.__file__).resolve().parents:
        print(f"[bench] the program was found outside this checkout "
              f"({mixstage_tpu_torch.__file__})", file=sys.stderr)
        return 2
    if args.seed < 0:
        raise SystemExit("--seed must be a non-negative whole number")
    result = execute(cell, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0), T_START)
    found = forbidden_modules()
    if found:
        print(f"[bench] refused: the process loaded {found}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"[bench] check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"[bench] correct {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
