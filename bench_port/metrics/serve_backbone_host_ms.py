"""Host time a serving call spends in its backbone (the audio encoder,
UNet and style table that give the features): the program's
``serve.features`` spans over the traced window
(``mixstage_tpu_torch/train/profiling.py``), summed, over its
``serve.call`` spans.  None where the program records no spans."""


def read(r):
    if r["loop"] != "serve":
        return None
    from mixstage_tpu_torch.train import profiling

    records = getattr(profiling, "records", None)
    spans = records() if records else []
    calls = sum(s.name == "serve.call" for s in spans)
    if not calls:
        return None
    return 1e3 * sum(s.end - s.start for s in spans
                     if s.name == "serve.features") / calls
