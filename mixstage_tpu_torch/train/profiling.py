"""Step timing and tracing (the port's copy of
``mixstage_tpu/train/profiling.py``).

* ``StepTimer``: per-step wall-time percentiles and throughput, reported
  into the epoch metrics dict;
* ``trace``: ``torch.profiler`` around a bounded window of steps (the first
  train epoch under ``-profile_dir``), written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np


class StepTimer:
    """Wall-clock stats for train steps (the card runs asynchronously: a
    step whose loss the host reads has finished; otherwise the time is the
    dispatch's)."""

    def __init__(self, name: str = "step"):
        self.name = name
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is not None:
            self.times.append(time.perf_counter() - self._t0)
            self._t0 = None

    def summary(self, prefix: str = "") -> Dict[str, float]:
        if not self.times:
            return {}
        t = np.asarray(self.times)
        return {f"{prefix}{self.name}_ms_p50": float(np.median(t) * 1e3),
                f"{prefix}{self.name}_ms_p99": float(np.percentile(t, 99) * 1e3),
                f"{prefix}{self.name}_per_sec": float(1.0 / np.mean(t))}


@contextlib.contextmanager
def trace(profile_dir: Optional[str]):
    """``torch.profiler`` over the block, CPU and (when present) CUDA
    activity, written to ``profile_dir/trace_<pid>_<time>.json`` for
    chrome://tracing or Perfetto; no-op without a directory."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    import torch

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        profile_dir, f"trace_{os.getpid()}_{int(time.time())}.json"))
