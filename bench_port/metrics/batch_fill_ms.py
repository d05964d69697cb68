"""The micro-batcher's gather of a batch, from the worker holding its
first request to the batch's close (full, or at the gather window's
end): the mean of the program's ``batcher.gather`` spans over the traced
window (``mixstage_tpu_torch/train/profiling.py``).  None where the
program records none."""


def read(r):
    if r["loop"] != "open_loop":
        return None
    from mixstage_tpu_torch.train import profiling

    records = getattr(profiling, "records", None)
    fills = [s.end - s.start for s in (records() if records else [])
             if s.name == "batcher.gather"]
    if not fills:
        return None
    return 1e3 * sum(fills) / len(fills)
