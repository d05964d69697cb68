"""Clips per device batch of the micro-batcher over the traced window:
the batcher's own counters (``DynamicBatcher.stats()``: requests and
batches), read before and after the window."""


def read(r):
    c = r.get("counters", {})
    if r["loop"] != "open_loop" or not c.get("batches"):
        return None
    return c["requests"] / c["batches"]
