"""Share of the traced serving window's calls that ran as a CUDA graph
replay: the program's ``serve.call`` spans
(``mixstage_tpu_torch/train/profiling.py``) whose id ``graph`` is 1, over
those that carry the id, in %.  None where the program records no
``serve.call`` span with that id.  ``share`` is also the open loop's
reader (``serve_graph_share.open.py``)."""


def share(r, loop):
    """The share in the cell of ``loop``; None in any other."""
    if r["loop"] != loop:
        return None
    from mixstage_tpu_torch.train import profiling

    records = getattr(profiling, "records", None)
    graph = [s.ids["graph"] for s in (records() if records else [])
             if s.name == "serve.call" and "graph" in getattr(s, "ids", {})]
    if not graph:
        return None
    return 100.0 * sum(g == 1 for g in graph) / len(graph)


def read(r):
    return share(r, "serve")
