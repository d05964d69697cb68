"""The micro-batcher's service of a batch, from its close until every
request's future is set: stacking and padding, the serving call, the
pose's copy to the host and the scatter.  The mean of the program's
``batcher.service`` spans over the traced window
(``mixstage_tpu_torch/train/profiling.py``).  None where the program
records none."""


def read(r):
    if r["loop"] != "open_loop":
        return None
    from mixstage_tpu_torch.train import profiling

    records = getattr(profiling, "records", None)
    services = [s.end - s.start for s in (records() if records else [])
                if s.name == "batcher.service"]
    if not services:
        return None
    return 1e3 * sum(services) / len(services)
