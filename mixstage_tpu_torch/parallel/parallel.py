"""Host-side thread-pool map for IO fan-out (the port's copy of
``mixstage_tpu/parallel/parallel.py``, on ``concurrent.futures`` where the
JAX package uses joblib's thread backend)."""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor


def parallel(fn, n_jobs, *args):
    """``[fn(*a) for a in zip(*args)]``, run on ``n_jobs`` threads (-1: one
    a CPU, 0: one), results in input order."""
    workers = (os.cpu_count() or 1) if n_jobs == -1 else max(n_jobs, 1)
    with ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(fn, *args))


def get_parallel_list(x_list, n):
    """``x_list`` in consecutive lists of ``n`` (the last may be
    shorter)."""
    sublist = []
    for i, x in enumerate(x_list):
        sublist.append(x)
        if (i + 1) % n == 0:
            yield sublist
            sublist = []
    if sublist:
        yield sublist


def get_tensor_items(x):
    """A batch as a list of host scalars (``.item()`` of each element that
    has one), None for None."""
    if x is None:
        return None
    return [item.item() if hasattr(item, "item") else item for item in x]
