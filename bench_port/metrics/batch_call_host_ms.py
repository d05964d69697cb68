"""The serving call's host time behind the micro-batcher, to set beside a
closed-loop call: the program's ``serve.call`` spans inside a
``batcher.service`` span over the traced window
(``mixstage_tpu_torch/train/profiling.py``), summed, over the batches
served.  None where the program records no spans."""


def read(r):
    if r["loop"] != "open_loop":
        return None
    from mixstage_tpu_torch.train import profiling

    records = getattr(profiling, "records", None)
    spans = records() if records else []
    by_id = {s.id: s for s in spans}
    services = {s.id for s in spans if s.name == "batcher.service"}
    if not services:
        return None

    def served(s):
        while s is not None and s.parent is not None:
            if s.parent in services:
                return True
            s = by_id.get(s.parent)
        return False

    return 1e3 * sum(s.end - s.start for s in spans
                     if s.name == "serve.call" and served(s)) / len(services)
