"""``serve_graph_share`` in the open loop: the share of the traced
window's serving calls (the micro-batcher's batches) that ran as a CUDA
graph replay, in %."""

from bench_port.metrics.serve_graph_share import share


def read(r):
    return share(r, "open_loop")
