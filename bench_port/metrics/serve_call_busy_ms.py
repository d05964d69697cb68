"""Device busy time per bs32 serving call: the union of every device
interval of the traced window over the calls traced."""


def read(r):
    calls = r.get("counters", {}).get("calls")
    if r["loop"] != "serve" or not calls:
        return None
    return r["busy_s"] / calls * 1e3
