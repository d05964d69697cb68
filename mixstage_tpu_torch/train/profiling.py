"""Step timing and tracing (the port's copy of
``mixstage_tpu/train/profiling.py``, with spans of its own).

* ``StepTimer``: per-step wall-time percentiles and throughput, reported
  into the epoch metrics dict;
* ``trace``: ``torch.profiler`` around a bounded window of steps (the first
  train epoch under ``-profile_dir``), written as a Chrome trace;
* ``span`` / ``record``: the program's spans (the train steps' forward,
  backward and update, the serving call and its backbone, the
  micro-batcher's gather, service and queue wait).  They are taken only
  while a ``torch.profiler`` trace is on (``enabled()``): then a span is a
  range named ``mixstage.<name>`` on the profiler's clock, and, once
  closed, a ``Span`` in memory (``records()``).  With no profiler on, a
  span is one flag read and a shared no-op context.

A range is a ``RecordFunction`` of the function scope
(``torch._C._profiler._RecordFunctionFast``, ≈1 µs), not
``record_function``'s user annotation (≈12 µs), which the profiler copies
onto the device's timeline over the kernels it launched, where a
reduction of the trace would take it for device work.  ``torch.profiler``
records the ranges of the thread that started it (and of the threads it
hands work to, such as autograd's; all threads with the experimental
``profile_all_threads``); the records in memory come from every thread.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

PREFIX = "mixstage."
MAX_RECORDS = 1 << 18       # the newest are kept (a record is ~0.2 KB)
_range = torch._C._profiler._RecordFunctionFast


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

    @contextlib.contextmanager
    def measure(self):
        """Time the block as one step."""
        self.start()
        try:
            yield
        finally:
            self.stop()

    def reset(self):
        self.times = []

    def summary(self, prefix: str = "") -> Dict[str, float]:
        if not self.times:
            return {}
        t = np.asarray(self.times)
        return {f"{prefix}{self.name}_ms_p50": float(np.median(t) * 1e3),
                f"{prefix}{self.name}_ms_p99": float(np.percentile(t, 99) * 1e3),
                f"{prefix}{self.name}_per_sec": float(1.0 / np.mean(t))}


class Span(NamedTuple):
    """One closed span: its name (without ``PREFIX``), its id, the id of
    the span open around it on the same thread (None at the top), the
    thread (``threading.get_ident()``), its ends (``time.perf_counter()``
    seconds) and the ids it was given (e.g. ``batch``)."""
    name: str
    id: int
    parent: Optional[int]
    thread: int
    start: float
    end: float
    ids: dict


_lock = threading.Lock()
_records: "collections.deque[Span]" = collections.deque(maxlen=MAX_RECORDS)
_next_id = itertools.count(1)
_open = threading.local()           # .stack: ids of the thread's open spans


def enabled() -> bool:
    """Whether a ``torch.profiler`` trace is on in this process (the one
    place that reads the profiler's private flag)."""
    return _autograd_profiler._is_profiler_enabled


def _stack() -> list:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


def _append(rec: Span) -> None:
    with _lock:
        _records.append(rec)


class _Noop:
    """The span taken with no profiler on: does nothing, shared."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note(self, **ids) -> None:
        pass


_NOOP = _Noop()


class _Span:
    def __init__(self, name: str, ids: dict):
        self.name, self.ids = name, ids

    def note(self, **ids) -> None:
        """Add ids known only as the span closes (a batch's size)."""
        self.ids.update(ids)

    def __enter__(self):
        stack = _stack()
        self._range = _range(PREFIX + self.name)
        self._range.__enter__()
        self._parent = stack[-1] if stack else None
        self._id = next(_next_id)
        stack.append(self._id)
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        _stack().pop()
        self._range.__exit__(*exc)
        _append(Span(self.name, self._id, self._parent, threading.get_ident(),
                     self._start, end, self.ids))
        return False


def span(name: str, **ids):
    """A context over one piece of the program's work: with a profiler on,
    a range ``mixstage.<name>`` and, once closed, a record; otherwise a
    shared no-op.  ``as s`` gives an object whose ``note(**ids)`` adds ids
    before the span closes."""
    if not enabled():
        return _NOOP
    return _Span(name, ids)


def record(name: str, start: float, end: float, **ids) -> None:
    """A record whose ends were stamped elsewhere (``perf_counter``
    seconds), under the span open on this thread; only with a profiler
    on, and no range in the trace."""
    if not enabled():
        return
    stack = _stack()
    _append(Span(name, next(_next_id), stack[-1] if stack else None,
                 threading.get_ident(), start, end, ids))


def records() -> List[Span]:
    """The records taken since the last ``reset()``, oldest first (at most
    ``MAX_RECORDS``, the newest)."""
    with _lock:
        return list(_records)


def reset() -> None:
    with _lock:
        _records.clear()


@contextlib.contextmanager
def trace(profile_dir: Optional[str]):
    """``torch.profiler`` over the block, CPU and (when present) CUDA
    activity, written to ``profile_dir/trace_<pid>_<time>.json`` for
    chrome://tracing or Perfetto; no-op without a directory.  The records
    of earlier spans are dropped first, so ``records()`` then holds the
    block's spans."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    reset()
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        profile_dir, f"trace_{os.getpid()}_{int(time.time())}.json"))
