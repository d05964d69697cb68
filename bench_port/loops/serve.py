"""Offline batched serving through ``build_serving_fn``, one caller, calls
back to back.

Set-up builds the serving function from the seed's weights (BatchNorm
folded, K1's weights packed) and makes ``batches`` distinct batches of
``batch`` clips on the host (log-mel audio and a target speaker each),
then warms the call up.  The window cycles through the batches: host
numpy in, the call, the pose copied back to host numpy.
``serve_frames_per_s`` is batch × frames of every call completed in the
window, over the window.

Correctness: a sample of the window's calls drawn from the seed
(reservoir sampling, so every call is as likely) keeps its pose; after
the window the plain reference's eval forward (running statistics, no
folding) runs on each kept call's own inputs, and ``pose_err`` is the
worst kept call's relative Frobenius error.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bench_port.harness import checks, data, program, weights
from bench_port.harness.seeds import rng
from bench_port.harness.trace import profiled, reduce, span
from bench_port.reference.models import build


def inputs(cfg, tr, seed, device):
    """(audio, style) host arrays of every batch: (n, B, T, mel), (n, B)."""
    n, B = tr["batches"], tr["batch"]
    pool = data.clips(cfg, {**tr, "pool": n * B}, seed, device)
    return (pool["audio"].reshape(n, B, tr["frames"], cfg["mel_bins"]),
            pool["style"].reshape(n, B))


def run(cell, seed: int, seconds: float, trace: bool, device) -> dict:
    cfg, tr = cell.config, cell.traffic
    fn = program.serving_fn(cfg, weights.make(cfg, seed, device), device,
                            tr)
    audio, style = inputs(cfg, tr, seed, device)
    n, B, T = tr["batches"], tr["batch"], tr["frames"]
    for i in range(tr["warm_calls"]):
        fn(audio[i % n], style[i % n]).cpu().numpy()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_end = time.perf_counter()

    keep_rng, kept, calls = rng(seed, "sample"), [], 0

    def one_call():
        nonlocal calls
        i = calls % n
        with span("serve_call"):
            pose = fn(audio[i], style[i])
        with span("copy_out"):
            host = pose.cpu().numpy()
        # reservoir sampling: each call is kept with the same chance
        if len(kept) < tr["keep_calls"]:
            kept.append((i, host))
        else:
            j = int(keep_rng.integers(0, calls + 1))
            if j < tr["keep_calls"]:
                kept[j] = (i, host)
        calls += 1

    out = {"setup_end": setup_end}
    if trace:
        with profiled() as prof:
            t0 = time.perf_counter()
            with span("window"):
                for _ in range(tr["trace_calls"]):
                    one_call()
            window = time.perf_counter() - t0
        out["reading"] = reduce(prof)
        out["reading"]["counters"] = {"calls": calls, "batch": B,
                                      "frames": T}
    else:
        t0 = time.perf_counter()
        while True:
            one_call()
            window = time.perf_counter() - t0
            if window >= seconds:
                break
        out["metrics"] = {"serve_frames_per_s": calls * B * T / window}
    out["attempted"], out["failed"] = calls, 0
    out["window_s"] = window
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    del fn
    out["check"] = lambda: {"pose_err": worst_error(
        cfg, seed, device, [(audio[i], style[i], p) for i, p in kept])}
    return out


@torch.no_grad()
def reference_poses(cfg, seed, device, audio, style, tf32=False):
    """The plain reference generator's eval pose of each (B, T, mel) audio
    batch and (B,) target speakers, on the seed's weights."""
    gen = build(cfg)[0].to(device).eval()
    gen.load_state_dict(weights.part(weights.make(cfg, seed, device),
                                     "gen"))
    out = []
    with checks.precision(tf32):
        for a, s in zip(audio, style):
            a = torch.as_tensor(a, device=device)
            w = torch.nn.functional.one_hot(
                torch.as_tensor(s, device=device).long(),
                cfg["num_speakers"]).float()
            out.append(gen(a, w[:, None].expand(-1, a.shape[1], -1))[0]
                       .cpu().numpy())
    return out


def worst_error(cfg, seed, device, items) -> float:
    """The worst relative Frobenius error of the (audio, style, pose)
    items against the reference, each batch computed once."""
    uniq = {}
    for a, s, _ in items:
        uniq.setdefault((a.ctypes.data, s.ctypes.data), (a, s))
    keys = list(uniq)
    refs = dict(zip(keys, reference_poses(
        cfg, seed, device, [uniq[k][0] for k in keys],
        [uniq[k][1] for k in keys])))
    return max(checks.rel_fro(np.asarray(p),
                              refs[(a.ctypes.data, s.ctypes.data)])
               for a, s, p in items)
