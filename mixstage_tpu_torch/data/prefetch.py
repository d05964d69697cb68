"""Order-preserving batch prefetcher (the port's copy of
``mixstage_tpu/data/prefetch.py``).

The host-side batch preparation (ZNorm, joint masking, k-means labels)
runs in a background thread, or an order-preserving thread pool, a few
batches ahead of the train step, so the card does not wait on the host
between steps.  Batches come out in input order for any worker count.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator


class _Sentinel:
    pass


_DONE = _Sentinel()


def prefetch(iterable: Iterable, prepare: Callable, depth: int = 2,
             workers: int = 1) -> Iterator:
    """Yield ``prepare(item)`` for items of ``iterable``, prepared ``depth``
    items ahead in a daemon thread.  Exceptions propagate to the consumer.

    ``workers > 1`` prepares batches in an order-preserving thread pool —
    h5py reads and the numpy transform math release the GIL, so the
    pipeline's throughput scales with workers (``-num_workers``).  Results
    are yielded strictly in input order, so training dynamics are identical
    for any worker count.
    """
    if workers > 1:
        return _prefetch_pool(iterable, prepare, depth, workers)
    return _prefetch_thread(iterable, prepare, depth)


def _prefetch_pool(iterable, prepare, depth, workers) -> Iterator:
    from concurrent.futures import ThreadPoolExecutor

    def gen():
        from collections import deque

        with ThreadPoolExecutor(max_workers=workers) as ex:
            futs: deque = deque()
            it = iter(iterable)
            exhausted = False
            while True:
                while not exhausted and len(futs) < depth + workers:
                    try:
                        futs.append(ex.submit(prepare, next(it)))
                    except StopIteration:
                        exhausted = True
                if not futs:
                    return
                yield futs.popleft().result()  # raises the worker's exception

    return gen()


def _prefetch_thread(iterable, prepare, depth) -> Iterator:
    q: "queue.Queue" = queue.Queue(maxsize=depth)

    def worker():
        try:
            for item in iterable:
                q.put(prepare(item))
        except BaseException as e:  # noqa: BLE001 - forwarded to consumer
            q.put(e)
        finally:
            q.put(_DONE)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        out = q.get()
        if out is _DONE:
            return
        if isinstance(out, BaseException):
            raise out
        yield out
