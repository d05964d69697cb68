"""The whole serving call's share of the card's peak: the generator's
forward FLOPs (counted from the configuration's shapes) of every call
traced, over the traced window at the dense bf16 peak (989 TFLOP/s)."""

from bench_port.harness.work import PEAK_BF16_FLOPS, serve_call_flops


def read(r):
    c = r.get("counters", {})
    if r["loop"] != "serve" or not c.get("calls"):
        return None
    flops = serve_call_flops(r["config"], c["batch"], c["frames"])
    return 100.0 * flops * c["calls"] / (r["window_s"] * PEAK_BF16_FLOPS)
