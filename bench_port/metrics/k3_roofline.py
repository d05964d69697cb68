"""K3's share of its roofline: the least time an H100 needs for the
training decoder's forward and backward of every G step traced (its
float32 work once at the dense bf16 peak, or its bytes at the HBM rate),
over the device time of every kernel of K3's library
(``csrc/train_decoder.cu`` with ``csrc/train_gemm_bf16.cuh``).  Nothing
when no K3 kernel ran."""

from bench_port.harness.trace import kernel_seconds
from bench_port.harness.work import bound_s, k3_shapes

K3_KERNELS = (r"(^|::)(wgmma_gemm_kernel|pack_kernel|split_sum_kernel|"
              r"bn_stats_kernel|bn_act_img_kernel|bn_bwd_sums_kernel|"
              r"bn_bwd_dc_img_kernel|col_sum_kernel|reduce_splits_kernel|"
              r"stats_reduce_kernel|group_sum_kernel)\b")


def read(r):
    c = r.get("counters", {})
    if r["loop"] != "train" or not c.get("g_steps"):
        return None
    launches, seconds = kernel_seconds(r, K3_KERNELS)
    if not launches or seconds <= 0:
        return None
    w = k3_shapes(r["config"], c["batch"], c["frames"])
    return 100.0 * bound_s(w["flops"], w["bytes"]) * c["g_steps"] / seconds
