"""Everything a run draws comes from ``--seed``: the weights, the data and
the schedule, each from its own stream of ``numpy.random.SeedSequence``.
A seed may be any non-negative whole number (beyond 32 bits).
"""

from __future__ import annotations

import numpy as np
import torch

STREAMS = ("weights", "data", "schedule", "sample")


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed of ``stream`` derived from the run's ``seed``."""
    child = np.random.SeedSequence(
        [int(seed) & (2 ** 64 - 1), STREAMS.index(stream)])
    return int(child.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, stream))


def rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, stream))
