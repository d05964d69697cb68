"""Reduce a ``torch.profiler`` trace of the traced window to numbers.

* busy: the union of every device interval (kernels, copies, sets), so
  overlapping streams count once;
* kernels: device seconds and launches by kernel name (copies and sets
  are listed, not counted as launches);
* idle gaps: each stretch of the window in which the device ran nothing,
  named by the benchmark's host span (``span``) that covers most of it
  (``window`` where none does), summed by name.

The host spans are ``record_function`` ranges opened by the benchmark's
own files around each call into a layer; their names start with
``bench.``.  A range's device-side annotation is not device work and is
skipped.
"""

from __future__ import annotations

import contextlib
import gc
import heapq
import re
from typing import Dict, List, Tuple

import torch

PREFIX = "bench."
_COPY = re.compile(r"^(Memcpy|Memset)")


def span(name: str):
    """A host span of the benchmark (a no-op outside a profiler)."""
    return torch.profiler.record_function(PREFIX + name)


@contextlib.contextmanager
def profiled():
    """``torch.profiler`` over host and device, with the interpreter's
    garbage collector off: the profiler's own objects would otherwise
    set off collections of up to a second that untraced runs never see."""
    from torch.profiler import ProfilerActivity, profile

    enabled = gc.isenabled()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        gc.disable()
        try:
            yield prof
        finally:
            if enabled:
                gc.enable()


def short_name(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)",
                                                 "{anon}")
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out)[:160]


def _union(intervals: List[Tuple[float, float]]):
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce(prof) -> dict:
    """busy_s, kernels ([short name, launches, seconds], longest first),
    launches, idle gaps by host span, and the traced window: the span
    ``window`` that the loop opens around the traced work."""
    dev, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.name.startswith(PREFIX):
            if e.device_type != cuda:
                host.append((start, end, e.name[len(PREFIX):]))
        elif e.device_type == cuda:
            dev.append((start, end, e.name))
    windows = [(s, e) for s, e, n in host if n == "window"]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} window spans")
    (w0, w1), = windows
    host = [h for h in host if h[2] != "window"]
    kernels: Dict[str, List[float]] = {}
    for s, e, name in dev:
        k = kernels.setdefault(short_name(name), [0, 0.0])
        k[0] += 1
        k[1] += (e - s) / 1e6
    busy = _union([(max(s, w0), min(e, w1)) for s, e, _ in dev
                   if e > w0 and s < w1])
    gaps, edge = [], w0
    for s, e in busy:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    if w1 > edge:
        gaps.append((edge, w1))
    by_span: Dict[str, float] = {}
    host.sort()
    active: List[Tuple[float, int]] = []          # (end, index into host)
    nxt = 0
    for s, e in gaps:                             # gaps come in order
        while nxt < len(host) and host[nxt][0] < e:
            heapq.heappush(active, (host[nxt][1], nxt))
            nxt += 1
        while active and active[0][0] <= s:
            heapq.heappop(active)
        best, cover = "window", 0.0
        for he, i in active:
            c = min(e, he) - max(s, host[i][0])
            if c > cover:
                best, cover = host[i][2], c
        by_span[best] = by_span.get(best, 0.0) + (e - s) / 1e6
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    return {
        "busy_s": sum(e - s for s, e in busy) / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "kernels": [[n, c, sec] for n, (c, sec) in top],
        "launches": sum(c for n, (c, _) in kernels.items()
                        if not _COPY.match(n)),
        "idle_gaps": sorted(([n, s] for n, s in by_span.items()),
                            key=lambda x: -x[1]),
    }


def breakdown(reading: dict) -> dict:
    return {"device_ops": [[n, s] for n, _, s in reading["kernels"][:10]],
            "idle_gaps": reading["idle_gaps"][:10]}


def kernel_seconds(reading: dict, pattern: str) -> Tuple[int, float]:
    """(launches, device seconds) of the kernels whose short name matches
    ``pattern`` (a regular expression, searched)."""
    rx = re.compile(pattern)
    hits = [(c, s) for n, c, s in reading["kernels"] if rx.search(n)]
    return sum(c for c, _ in hits), sum(s for _, s in hits)
