"""One run of one cell: set-up, the window (timed or traced), the check
against the reference, and the result line.

The traffic file names its loop (``bench_port/loops/<loop>.py``),
whose ``run(cell, seed, seconds, trace, device)`` builds the system,
records when set-up ended, runs the window and returns the end-to-end
numbers (or the trace's reading), the work attempted and failed, the
memory peak and a ``check`` to call once the program is freed.
"""

from __future__ import annotations

import gc
import importlib
import sys

import torch

from bench_port.harness.checks import verdict
from bench_port.harness.spec import Cell, read_per_layer
from bench_port.harness.trace import breakdown

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "mixstage_tpu")


def forbidden_modules():
    """The forbidden top-level names among the loaded modules (each
    module's name up to its first dot, compared whole)."""
    loaded = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(loaded.intersection(FORBIDDEN))


def device_info(device, out: dict) -> dict:
    if device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1}
    else:
        info = {"platform": device.type, "kind": device.type, "count": 1}
    info["memory_peak_bytes"] = int(out.get("memory_peak_bytes", 0))
    return info


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device,
            t_start: float) -> dict:
    loop = importlib.import_module(
        f"bench_port.loops.{cell.traffic['loop']}")
    out = loop.run(cell, seed, seconds, trace, device)
    setup_s = out["setup_end"] - t_start
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    correct, checks = verdict(out["check"](), cell.limits)
    dev = device_info(device, out)
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"])}
    if trace:
        reading = {**out["reading"], "loop": cell.traffic["loop"],
                   "config": cell.config, "traffic": cell.traffic}
        result["metrics"] = read_per_layer(cell, reading)
        dev["busy_s"] = reading["busy_s"]
        dev["window_s"] = reading["window_s"]
        result["device"] = dev
        result["breakdown"] = breakdown(reading)
    else:
        values = {**out["metrics"], "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.end_to_end()}
        result["device"] = dev
    result["checks"] = checks
    return result
