"""K1's share of its roofline in the serving call: the least time an
H100 needs for its two launches a call (the mixture decoder, G = M, and
the cluster classifier's chain, G = 1: float32 work once at the dense
bf16 peak, or bytes at the HBM rate), over the device time of K1's
kernel (``decoder_kernel`` of ``csrc/fused_decoder_wgmma.cu``).  Nothing
when K1 did not run."""

from bench_port.harness.trace import kernel_seconds
from bench_port.harness.work import bound_s, k1_shapes


def read(r):
    c = r.get("counters", {})
    if r["loop"] != "serve" or not c.get("calls"):
        return None
    launches, seconds = kernel_seconds(r, r"(^|::)decoder_kernel<")
    if not launches or seconds <= 0:
        return None
    bound = sum(bound_s(w["flops"], w["bytes"])
                for w in k1_shapes(r["config"], c["batch"], c["frames"]))
    return 100.0 * bound * c["calls"] / seconds
