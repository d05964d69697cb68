"""Share of the traced window's train steps that ran as a CUDA graph
replay: the program's ``train.g_step`` and ``train.d_step`` spans
(``mixstage_tpu_torch/train/profiling.py``) whose id ``graph`` is 1, over
those that carry the id, in %.  None where the program records no step
span with that id."""


def read(r):
    if r["loop"] != "train":
        return None
    from mixstage_tpu_torch.train import profiling

    records = getattr(profiling, "records", None)
    graph = [s.ids["graph"] for s in (records() if records else [])
             if s.name in ("train.g_step", "train.d_step")
             and "graph" in getattr(s, "ids", {})]
    if not graph:
        return None
    return 100.0 * sum(g == 1 for g in graph) / len(graph)
