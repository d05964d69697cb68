"""Device busy time per train step (G or D, k-step call): the union of
every device interval of the traced window over the steps traced."""


def read(r):
    steps = r.get("counters", {}).get("steps")
    if not steps or r["loop"] != "train":
        return None
    return r["busy_s"] / steps * 1e3
