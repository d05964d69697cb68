"""Runs the multi-rank tests' child processes (``_torch_port_parallel_child.py``).

Each rank is a process of its own that imports the port and not JAX: the
parent test writes what the children need into a work directory (a JSON
spec, numpy archives of weights and inputs), starts ``world`` ranks that
meet through a ``file://`` store in that directory (no port to race for
between test workers), and reads each rank's results back from
``out_<rank>.npz``.  Every child has its own timeout and is killed, if it
still runs, when the call returns.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
CHILD = Path(__file__).resolve().parent / "_torch_port_parallel_child.py"
CHILD_TIMEOUT_S = 120


def flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested dict of arrays as {"a/b/leaf": array}."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def run_ranks(mode: str, workdir, world: int, spec: dict,
              arrays: Dict[str, np.ndarray] = None,
              timeout_s: float = CHILD_TIMEOUT_S) -> List[Dict]:
    """Run ``mode`` on ``world`` ranks; returns each rank's results (the
    arrays of its ``out_<rank>.npz``).  A child that fails, or outlives
    ``timeout_s``, fails the call with its output."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    (workdir / "spec.json").write_text(json.dumps(spec))
    if arrays is not None:
        np.savez(workdir / "in.npz", **arrays)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + (os.pathsep + env["PYTHONPATH"]
                                     if env.get("PYTHONPATH") else "")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
              "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, str(CHILD), mode, str(workdir), str(rank),
         str(world)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(world)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout_s)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, \
            f"{mode} rank {rank} failed (rc={p.returncode}):\n{out[-6000:]}"
        assert f"CHILD_OK {mode} {rank}" in out, out[-6000:]
    results = []
    for rank in range(world):
        with np.load(workdir / f"out_{rank}.npz", allow_pickle=False) as z:
            results.append({k: z[k] for k in z.files})
    return results
