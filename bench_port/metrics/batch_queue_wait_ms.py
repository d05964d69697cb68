"""A request's wait in the micro-batcher's queue, from ``submit`` to the
worker taking it into a batch: the mean of the program's
``batcher.queue_wait`` records over the traced window
(``mixstage_tpu_torch/train/profiling.py``).  None where the program
records none."""


def read(r):
    if r["loop"] != "open_loop":
        return None
    from mixstage_tpu_torch.train import profiling

    records = getattr(profiling, "records", None)
    waits = [s.end - s.start for s in (records() if records else [])
             if s.name == "batcher.queue_wait"]
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
