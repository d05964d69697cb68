"""Single clips, open loop, through the port's micro-batcher in process.

Set-up builds the serving function from the seed's weights and the
``DynamicBatcher`` that ``cli.serve -batch_size <batch>`` builds (its
gather window, queue bound and (any, mel) input shape), makes a pool of
seeded clips with a target speaker each (sent as one-hot style rows, as
the HTTP layer sends a known speaker), warms both up, and starts the
sender (``loops/sender.py``), a process of its own on a core of its own.
In the window the sender keeps the schedule (``harness/data.py``: Poisson
arrivals at the traffic's fixed rate), writing each request's index to a
pipe when it falls due; this process's main thread reads the pipe and
submits each request, as a front door's thread would, and the batcher's
worker serves them.  Each request is timed from when it was due to when
its pose is on the host.  A request refused (``Overloaded``) or
never answered (a minute past the window's end) is ``failed``; one answered
late is late, and its latency counts the wait.  ``clip_p50_ms`` and
``clip_p95_ms`` are over every answered request of the window.

Correctness: a seeded sample of the schedule's requests keeps its pose,
compared after the window with the plain reference's pose of that
request's own clip and speaker (``pose_err``, the worst one): a result
handed to the wrong request fails.
"""

from __future__ import annotations

import gc
import os
import struct
import subprocess
import sys
import threading
import time
from concurrent.futures import TimeoutError as FuturesTimeout

import numpy as np
import torch

from bench_port.loops import sender
from bench_port.loops.serve import reference_poses
from bench_port.harness import checks, data, program, weights
from bench_port.harness.spec import ROOT
from bench_port.harness.trace import profiled, reduce, span

ANSWER_WAIT_S = 60.0


class _GcPauses:
    """Counts the interpreter's garbage collections and the longest one
    (they stop every thread, the batcher's worker too)."""

    def __init__(self):
        self.count, self.longest, self._t = 0, 0.0, 0.0
        gc.callbacks.append(self._cb)

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.count += 1
            self.longest = max(self.longest, time.perf_counter() - self._t)

    def close(self):
        gc.callbacks.remove(self._cb)


def _traced(fn):
    def call(audio, style):
        with span("serve_call"):
            return fn(audio, style)
    return call


class _Sender:
    """The sender process, started at set-up; ``start(due)`` waits until it
    is ready, hands it the schedule and the window's start, and
    ``indices()`` yields each request's index as it falls due."""

    LEAD_S = 0.05           # time for the sender to read the schedule

    def __init__(self):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "bench_port.loops.sender"],
            cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE)

    def start(self, due: np.ndarray) -> float:
        ready = os.read(self.proc.stdout.fileno(), len(sender.READY))
        if ready != sender.READY:
            raise RuntimeError("the open loop's sender did not start")
        t0 = time.perf_counter() + self.LEAD_S
        due = np.ascontiguousarray(due, dtype="<f8")
        self.proc.stdin.write(struct.pack("<dQ", t0, len(due)) +
                              due.tobytes())
        self.proc.stdin.close()
        return t0

    def indices(self):
        fd, rest = self.proc.stdout.fileno(), b""
        while True:
            with span("recv"):
                chunk = os.read(fd, 1 << 16)
            if not chunk:
                break
            rest += chunk
            cut = len(rest) - len(rest) % 4
            yield from np.frombuffer(rest[:cut], dtype="<u4").tolist()
            rest = rest[cut:]

    def close(self) -> None:
        if self.proc.stdin and not self.proc.stdin.closed:
            self.proc.stdin.close()
        if self.proc.poll() is None:
            self.proc.kill()
        rc = self.proc.wait()
        self.proc.stdout.close()
        if rc not in (0, -9):
            raise RuntimeError(f"the open loop's sender exited with {rc}")


def _start(sender, schedule) -> float:
    """Hand the sender the schedule; wait for the window's start, and
    return it."""
    t0 = sender.start(schedule["due"])
    time.sleep(max(t0 - time.perf_counter(), 0.0))
    return t0


def _drive(batcher, sender, t0, pool, rows, schedule, keep):
    """Submit the schedule's requests as the sender hands them over from
    ``t0`` on.  Returns the latencies (ms) of the answered requests, the failed count, the
    sampled requests' poses {request: pose} and the sampled requests that
    were accepted.  Only the sampled requests' futures are held; the
    others are counted by their callbacks."""
    from mixstage_tpu_torch.serving.server import Overloaded

    due, clip = schedule["due"], schedule["clip"]
    n = len(due)
    done = np.full(n, np.nan)
    kept, accepted = {}, set()
    lock, idle = threading.Lock(), threading.Condition()
    outstanding = [0]

    def callback(i):
        def cb(fut):
            ok = fut.exception() is None
            if ok:
                done[i] = time.perf_counter()
                if i in keep:
                    with lock:
                        kept[i] = fut.result()
            with idle:
                outstanding[0] -= 1
                idle.notify_all()
        return cb

    for i in sender.indices():
        c = clip[i]
        with span("submit"):
            try:
                fut = batcher.submit(pool["audio"][c],
                                     rows[pool["style"][c]])
            except Overloaded:
                continue
            with idle:
                outstanding[0] += 1
            if i in keep:
                accepted.add(i)
            fut.add_done_callback(callback(i))
    with span("wait"), idle:
        idle.wait_for(lambda: outstanding[0] == 0, timeout=ANSWER_WAIT_S)
    answered = np.flatnonzero(np.isfinite(done))
    lat = (done[answered] - (t0 + due[answered])) * 1e3
    with lock:
        kept = dict(kept)
    return lat, n - len(answered), kept, accepted


def run(cell, seed: int, seconds: float, trace: bool, device) -> dict:
    from mixstage_tpu_torch.serving.server import DynamicBatcher

    cfg, tr = cell.config, cell.traffic
    fn = program.serving_fn(cfg, weights.make(cfg, seed, device), device,
                            tr)
    pool = data.clips(cfg, tr, seed, device)
    rows = np.eye(cfg["num_speakers"], dtype=np.float32)
    B = tr["batch"]
    for i in range(tr["warm_calls"]):
        idx = np.arange(i * B, (i + 1) * B) % tr["pool"]
        fn(pool["audio"][idx], rows[pool["style"][idx]]).cpu().numpy()
    batcher = DynamicBatcher(_traced(fn), batch_size=B,
                             max_wait_ms=tr["max_wait_ms"],
                             input_shape=(None, cfg["mel_bins"]),
                             max_queue=tr["max_queue"])
    sender = _Sender()
    try:
        for start in range(0, tr["warm_requests"], B):
            warm = [batcher.submit(pool["audio"][i % tr["pool"]],
                                   rows[pool["style"][i % tr["pool"]]])
                    for i in range(start, start + B)]
            for f in warm:
                f.result(timeout=ANSWER_WAIT_S)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        setup_end = time.perf_counter()
        length = tr["trace_seconds"] if trace else seconds
        schedule = data.open_loop_schedule(tr, length, seed)
        n = len(schedule["due"])
        keep = set(data.sample(seed, n, tr["keep_requests"]))
        before = batcher.stats()
        pauses = _GcPauses()
        out = {"setup_end": setup_end}
        if trace:
            with profiled() as prof:
                t0 = _start(sender, schedule)
                with span("window"):
                    lat, failed, kept, accepted = _drive(
                        batcher, sender, t0, pool, rows, schedule, keep)
                    window = time.perf_counter() - t0
            out["reading"] = reduce(prof)
        else:
            t0 = _start(sender, schedule)
            lat, failed, kept, accepted = _drive(
                batcher, sender, t0, pool, rows, schedule, keep)
            window = time.perf_counter() - t0
            if len(lat) == 0:
                raise RuntimeError("no request of the window was answered")
            p50, p95 = np.percentile(lat, [50, 95])
            out["metrics"] = {"clip_p50_ms": float(p50),
                              "clip_p95_ms": float(p95)}
        after = batcher.stats()
        pauses.close()
    finally:
        batcher.close()
        sender.close()
    batches = after["batches"] - before["batches"]
    if trace:
        out["reading"]["counters"] = {
            "requests": after["requests"] - before["requests"],
            "batches": batches, "batch": B}
    print(f"[bench] open loop: {n} requests due, {failed} failed, "
          f"{batches} batches; {pauses.count} garbage collections, the "
          f"longest {pauses.longest * 1e3:.3f} ms", file=sys.stderr)
    out["attempted"], out["failed"] = n, failed
    out["window_s"] = window
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    del fn, batcher
    items = sorted(kept.items())
    out["check"] = lambda: {"pose_err": _worst(cfg, seed, device, pool,
                                               schedule, items, accepted)}
    return out


def _worst(cfg, seed, device, pool, schedule, items, accepted) -> float:
    """The worst relative error of the kept requests' poses against the
    reference pose of each one's own clip and speaker; inf when a sampled
    request that was accepted never got its pose (one refused with
    ``Overloaded`` is failed, not wrong)."""
    if len(items) < len(accepted):
        return float("inf")
    clips = np.array([schedule["clip"][i] for i, _ in items])
    chunks = [clips[s:s + 32] for s in range(0, len(clips), 32)]
    refs = reference_poses(cfg, seed, device,
                           [pool["audio"][c] for c in chunks],
                           [pool["style"][c] for c in chunks])
    refs = [r for chunk in refs for r in chunk]
    return max(checks.rel_fro(p, r) for (_, p), r in zip(items, refs))
