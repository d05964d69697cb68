"""The one generator of inputs and schedules, driven by a traffic file's
parameters and ``--seed``.

Every seed gets the same amount of work: the same batch shapes, the same
count of G and D steps in every k-step call (a fixed set of coins that
opens with a G and then a D step, the rest in a seeded order), and for an
open loop the same set of inter-arrival gaps (the exponential
distribution's quantiles at the traffic's rate) in a seeded order.  What the seed changes is the content: audio, poses, labels,
speakers, which gap comes when and which clip a request carries.
"""

from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np
import torch

from bench_port.harness.seeds import generator, rng


def train_batches(cfg: dict, traffic: dict, seed: int, device
                  ) -> Dict[str, torch.Tensor]:
    """``batches`` stacked batches of B clips × T frames, on the device:
    log-mel audio (k, B, T, mel), poses (k, B, T, F), per-frame cluster
    labels (k, B, T) over ``num_clusters``, and per-frame speaker ids
    (k, B, T): each batch holds B / S clips of every speaker, interleaved
    as the class-alternating sampler draws them, from a seeded offset."""
    k, B, T = traffic["batches"], traffic["batch"], traffic["frames"]
    S, mel = cfg["num_speakers"], cfg["mel_bins"]
    g = generator(seed, "data", device)
    audio = torch.randn((k, B, T, mel), generator=g, device=device)
    pose = torch.randn((k, B, T, cfg["out_feats"]), generator=g,
                       device=device)
    labels = torch.randint(0, cfg.get("num_clusters") or 1, (k, B, T),
                           generator=g, device=device)
    offset = torch.randint(0, S, (k, 1), generator=g, device=device)
    ids = (torch.arange(B, device=device)[None] + offset) % S
    style = ids[:, :, None].expand(k, B, T).contiguous()
    return {"audio": audio, "y": pose, "labels": labels, "style": style}


def coin_stream(cfg: dict, traffic: dict, seed: int) -> Iterator[np.ndarray]:
    """Each call's (k,) booleans in turn, True = a D step, from one seeded
    stream: a call holds round(k · r / (r + 1)) D steps at the
    configuration's ``dg_iter_ratio`` r, and opens with a G step and then
    a D step (so the first three steps take both optimizers' updates); the
    other k - 2 come in a seeded order."""
    k = traffic["steps_per_call"]
    r = float(cfg["dg_iter_ratio"])
    n_d = int(round(k * r / (r + 1.0)))
    if not 1 <= n_d <= k - 1:
        raise ValueError(f"a call of {k} steps at dg_iter_ratio {r} needs "
                         "at least one G and one D step")
    base = np.array([True] * (n_d - 1) + [False] * (k - 1 - n_d))
    r = rng(seed, "schedule")
    while True:
        yield np.concatenate([[False, True], r.permutation(base)])


def clips(cfg: dict, traffic: dict, seed: int, device) -> Dict[str, object]:
    """``pool`` seeded clips (pool, T, mel) float32 and target speakers
    (pool,) int64 on the host, made on the device."""
    g = generator(seed, "data", device)
    n, T = traffic["pool"], traffic["frames"]
    audio = torch.randn((n, T, cfg["mel_bins"]), generator=g, device=device)
    style = torch.randint(0, cfg["num_speakers"], (n,), generator=g,
                          device=device)
    return {"audio": audio.cpu().numpy(), "style": style.cpu().numpy()}


def open_loop_schedule(traffic: dict, seconds: float, seed: int
                       ) -> Dict[str, np.ndarray]:
    """Due times (s from the window's start) of the Poisson arrivals at
    ``rate`` over ``seconds``, and each request's clip.  The gaps are the
    n quantiles (i + 0.5) / n of the exponential distribution, so they
    sum to n / rate whatever the seed, in a seeded order."""
    rate = float(traffic["rate"])
    n = int(round(rate * seconds))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    r = rng(seed, "schedule")
    due = np.concatenate([[0.0], np.cumsum(r.permutation(gaps))[:-1]])
    return {"due": due, "clip": r.integers(0, traffic["pool"], size=n)}


def sample(seed: int, n: int, k: int) -> List[int]:
    """k of range(n), drawn from the seed (all of them when n ≤ k)."""
    if n <= k:
        return list(range(n))
    return sorted(rng(seed, "sample").choice(n, size=k,
                                             replace=False).tolist())
