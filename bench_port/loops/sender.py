"""The open loop's sender: a process of its own that writes each
request's index to its standard output when the request falls due, so
that the schedule is kept outside the interpreter that serves it.

    python3 -m bench_port.loops.sender

Writes ``READY`` (four bytes) to its standard output once it has
started, then reads from standard input the window's start (a ``time.perf_counter``
reading, which every process of the machine shares: the monotonic clock)
as a little-endian float64, the count of requests as a uint64, and their
due times (s from the start, ascending) as float64; writes the indices as little-endian uint32, each
as soon as it is due, and exits when all are written.
"""

from __future__ import annotations

import os
import struct
import sys
import time

import numpy as np

READY = b"\xff\xff\xff\xff"


def main() -> int:
    out = sys.stdout.buffer.fileno()
    os.write(out, READY)
    src = sys.stdin.buffer
    start, n = struct.unpack("<dQ", src.read(16))
    due = np.frombuffer(src.read(8 * n), dtype="<f8")
    i = 0
    while i < n:
        now = time.perf_counter() - start
        if due[i] > now:
            time.sleep(due[i] - now)
            continue
        j = int(np.searchsorted(due, now, side="right"))
        os.write(out, np.arange(i, j, dtype="<u4").tobytes())
        i = j
    return 0


if __name__ == "__main__":
    sys.exit(main())
