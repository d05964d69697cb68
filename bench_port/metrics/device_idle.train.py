"""The device's idle share of the traced training window:
1 - busy / window."""


def read(r):
    if r["loop"] != "train" or r["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - r["busy_s"] / r["window_s"])
