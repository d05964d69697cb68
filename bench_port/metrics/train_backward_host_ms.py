"""Host time a train step spends in its backward (``torch.autograd.grad``
of the step's total): the program's ``train.backward`` spans over the
traced window (``mixstage_tpu_torch/train/profiling.py``), summed, over
the steps traced (its ``train.g_step`` and ``train.d_step`` spans).  None
where the program records no spans."""


def read(r):
    if r["loop"] != "train":
        return None
    from mixstage_tpu_torch.train import profiling

    records = getattr(profiling, "records", None)
    spans = records() if records else []
    steps = sum(s.name in ("train.g_step", "train.d_step") for s in spans)
    if not steps:
        return None
    return 1e3 * sum(s.end - s.start for s in spans
                     if s.name == "train.backward") / steps
