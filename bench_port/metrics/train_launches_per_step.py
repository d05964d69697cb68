"""Kernel launches per train step: the traced window's kernels (copies
and sets left out) over the steps traced."""


def read(r):
    steps = r.get("counters", {}).get("steps")
    if not steps or r["loop"] != "train":
        return None
    return r["launches"] / steps
