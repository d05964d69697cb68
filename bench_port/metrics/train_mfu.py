"""The whole train step's share of the card's peak: the model FLOPs of
the steps traced (G or D step by its coin, counted from the
configuration's shapes, ``harness/work.py``) over the traced window at
the dense bf16 peak (989 TFLOP/s)."""

from bench_port.harness.work import PEAK_BF16_FLOPS, train_step_flops


def read(r):
    c = r.get("counters", {})
    if r["loop"] != "train" or not c.get("steps"):
        return None
    f = train_step_flops(r["config"], c["batch"], c["frames"])
    flops = c["g_steps"] * f["g"] + c["d_steps"] * f["d"]
    return 100.0 * flops / (r["window_s"] * PEAK_BF16_FLOPS)
