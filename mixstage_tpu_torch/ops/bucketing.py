"""Pow-2 padded-length bucketing (the port's own copy of
``mixstage_tpu/ops/bucketing.py:29-62``).

Serving pads any-length requests up to the next power-of-two multiple of
the model's window, repeating the last frame (the streaming edge
treatment), and trims the pose back to the true length.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def next_pow2(n: int, floor: int = 1) -> int:
    """Smallest value of floor, 2·floor, 4·floor, … that is ≥ n."""
    if n < 1:
        raise ValueError(f"length must be >= 1, got {n}")
    bucket = max(int(floor), 1)
    while bucket < n:
        bucket *= 2
    return bucket


def pad_repeat_last(arr: np.ndarray, target: int) -> np.ndarray:
    """Pad ``arr`` along axis 0 to ``target`` rows by repeating the last
    row (no-op when already long enough)."""
    n = arr.shape[0]
    if target <= n:
        return arr
    return np.concatenate([arr, np.repeat(arr[-1:], target - n, axis=0)])


def pow2_pad(arr: np.ndarray, floor: int = 1
             ) -> Tuple[np.ndarray, Optional[int]]:
    """``(padded, true_len)``; ``true_len`` is None when no padding
    happened (the caller skips the trim)."""
    n = arr.shape[0]
    bucket = next_pow2(n, floor)
    if bucket == n:
        return arr, None
    return pad_repeat_last(arr, bucket), n
