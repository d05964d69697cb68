// K2 for NVIDIA Hopper (sm_90a): the grouped conv chain on the CUDA cores.
//
// mixstage_conv_chain_f32 replaces the TPU kernel
// mixstage_tpu/ops/pallas/fused_conv.py::fused_grouped_conv_chain (body
// _chain_kernel): L layers of grouped k=3 'same' conv + bias + leaky over
// (B, T, G*C),
//
//   h = leaky(conv3(h, w[l, g]) + biases[l, g*C:(g+1)*C])   l < L, per group
//
// where conv3 is a k=3 'same' conv with zero padding at each sequence's own
// two ends: K1 (fused_decoder_wgmma.cu) without its layer 0 and logits.
// It keeps the first FFMA plan on the CUDA cores (routine `layer`): one CTA
// per (time tile, sequence, group), the group's C channels resident in
// shared memory across all L layers (a halo of L frames on each side is
// recomputed by the neighbouring tile; rows outside [0, T) stay zero, the
// per-sequence zero padding), weights streamed from L2 with coalesced
// loads and kRows frames of one output channel per thread.  At (32, 64,
// G=8, C=256, L=3) it does ~19.3 GFLOP against ~52.5 MB, bound by
// operations (~0.29 ms at the f32 FMA rate).  No path of the port calls it
// (a public op, as in the JAX package).
//
// Its bf16 mode (mixstage_conv_chain_bf16) is the TPU kernel's
// dtype=bfloat16 function: bf16 activations, f32 weights and biases, f32
// sums of the exact products, the f32 bias and leaky (slope f32(0.2), not
// the bf16-rounded slope of flax's layers), each layer's output rounded to
// bf16 (_chain_kernel's astype(x_ref.dtype)).  It is the same FFMA routine
// templated on the activation type: the tile stays f32 in shared memory,
// holding bf16 values, so only the loads, the rounding of each layer's
// output and the stores differ.  ~35.7 MB at the serving shape; still bound
// by operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "launch_common.cuh"

namespace {

using mixstage::card;
using mixstage::round4;

__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.f ? v : slope * v;
}

// An activation of type A (float, or __nv_bfloat16 in bf16 mode) from f32,
// rounded to nearest even.
template <class A>
__device__ __forceinline__ A to_act(float v) {
  if constexpr (std::is_same_v<A, float>) {
    return v;
  } else {
    return __float2bfloat16_rn(v);
  }
}

// An activation as f32 (exact).
__device__ __forceinline__ float act_f32(float v) { return v; }
__device__ __forceinline__ float act_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 16 rows per thread at one 512-thread CTA per SM (128 registers) was the
// fastest register block at the bs32 serving shapes when this was tuned.
constexpr int kThreads = 512;
constexpr int kMinBlocks = 1;         // CTAs per SM: allows 128 registers
constexpr int kRows = 16;             // frames per thread pass (register block)
constexpr int kUnrollCi = 2;

// One k=3 'same' conv layer producing tile rows [lo, hi).  `in` is the tile
// in shared memory (row stride `stride` floats, row r <-> time t_first + r);
// output row r reads input rows r - 1 .. r + 1.  It writes leaky(acc) to
// the shared tile `out`, as an activation of type A (rounded to bf16 in bf16
// mode) held in f32.  w is (3, cin, cout) with cout fastest.
template <class A>
__device__ __forceinline__ void layer(
    const float* in, int stride, int cin, const float* __restrict__ w,
    const float* __restrict__ bias, int cout, int lo, int hi, float* out,
    int out_stride, float slope) {
  const int rows = hi - lo;
  if (rows <= 0) return;
  const int nchunks = (rows + kRows - 1) / kRows;
  const int cin4 = cin & ~3;
  for (int item = threadIdx.x; item < cout * nchunks; item += blockDim.x) {
    const int c = item % cout;
    const int r0 = lo + (item / cout) * kRows;
    float acc[kRows];
    int roff[kRows];
    const float b = __ldg(bias + c);
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      acc[j] = b;
      // rows past hi recompute row hi-1 (never stored): no reads past the tile
      roff[j] = min(r0 + j, hi - 1) * stride;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float* wk = w + (size_t)k * cin * cout + c;
      const float* ink = in + (k - 1) * stride;
#pragma unroll kUnrollCi
      for (int ci = 0; ci < cin4; ci += 4) {
        const float w0 = __ldg(wk + (size_t)ci * cout);
        const float w1 = __ldg(wk + (size_t)(ci + 1) * cout);
        const float w2 = __ldg(wk + (size_t)(ci + 2) * cout);
        const float w3 = __ldg(wk + (size_t)(ci + 3) * cout);
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const float4 v = *reinterpret_cast<const float4*>(ink + roff[j] + ci);
          acc[j] = fmaf(v.x, w0, acc[j]);
          acc[j] = fmaf(v.y, w1, acc[j]);
          acc[j] = fmaf(v.z, w2, acc[j]);
          acc[j] = fmaf(v.w, w3, acc[j]);
        }
      }
      for (int ci = cin4; ci < cin; ++ci) {
        const float wv = __ldg(wk + (size_t)ci * cout);
#pragma unroll
        for (int j = 0; j < kRows; ++j) acc[j] = fmaf(ink[roff[j] + ci], wv, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int r = r0 + j;
      if (r < hi)
        out[r * out_stride + c] = act_f32(to_act<A>(leaky(acc[j], slope)));
    }
  }
}

// The chain for activations of type A (float: f32 mode; __nv_bfloat16:
// bf16 mode); weights and biases are f32 either way.
template <class A>
__global__ void __launch_bounds__(kThreads, kMinBlocks) conv_chain_kernel(
    const A* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ biases, A* __restrict__ out, int T, int C,
    int L, int G, int tile_t, int stride, float slope) {
  extern __shared__ __align__(16) float smem[];
  const int halo = L;
  const int nr = tile_t + 2 * halo;
  const int b = blockIdx.y, g = blockIdx.z;
  const int t_first = blockIdx.x * tile_t - halo;
  const int v_lo = max(0, -t_first);
  const int v_hi = min(nr, T - t_first);
  const int GC = G * C;
  float* buf[2] = {smem, smem + (size_t)nr * stride};

  // zero both buffers and load group g's channels of sequence b
  const A* xb = x + (size_t)b * T * GC + (size_t)g * C;
  for (int i = threadIdx.x; i < nr * stride; i += blockDim.x) {
    const int r = i / stride, ch = i - r * stride;
    const bool valid = r >= v_lo && r < v_hi && ch < C;
    buf[0][i] =
        valid ? act_f32(__ldg(xb + (size_t)(t_first + r) * GC + ch)) : 0.f;
    buf[1][i] = 0.f;
  }
  __syncthreads();
  // layer l (0-based) reads rows [l, nr - l) of buf[l & 1]
  for (int l = 0; l < L; ++l) {
    layer<A>(buf[l & 1], stride, C, w + ((size_t)l * G + g) * 3 * C * C,
          biases + (size_t)l * GC + (size_t)g * C, C, max(l + 1, v_lo),
          min(nr - l - 1, v_hi), buf[(l + 1) & 1], stride, slope);
    __syncthreads();
  }
  // the tile's own rows [halo, halo + tile_t) to out[b, t, g*C:(g+1)*C]
  const float* last = buf[L & 1];
  const int lo = max(halo, v_lo), hi = min(halo + tile_t, v_hi);
  A* ob = out + (size_t)b * T * GC + (size_t)g * C;
  for (int i = threadIdx.x; i < (hi - lo) * C; i += blockDim.x) {
    const int r = lo + i / C, c = i % C;
    ob[(size_t)(t_first + r) * GC + c] = to_act<A>(last[r * stride + c]);
  }
}

// K2's shared memory: two buffers of tile_t + 2L rows, each round4(C)
// floats (float4-aligned).
inline size_t chain_smem_bytes(int C, int L, int tile_t) {
  return 2 * (size_t)(tile_t + 2 * L) * round4(C) * sizeof(float);
}

int chain_tile(int B, int T, int C, int L, int G, int sm_count,
               size_t smem_limit) {
  return mixstage::fill_tile(64, B, T, G, sm_count, [=](int t) {
    return chain_smem_bytes(C, L, t) <= smem_limit;
  });
}

template <class A>
int launch_chain(const A* x, const float* w, const float* biases, A* out,
                 int B, int T, int C, int L, int G, float slope,
                 void* stream) {
  if (B <= 0 || T <= 0 || C <= 0 || L < 0 || G <= 0 || B > 65535 ||
      G > 65535)
    return (int)cudaErrorInvalidValue;
  int sms, smem_limit;
  cudaError_t err = card(&sms, &smem_limit);
  if (err != cudaSuccess) return (int)err;
  const int tile_t = chain_tile(B, T, C, L, G, sms, smem_limit);
  if (tile_t == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = chain_smem_bytes(C, L, tile_t);
  err = cudaFuncSetAttribute(conv_chain_kernel<A>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + tile_t - 1) / tile_t, B, G);
  conv_chain_kernel<A><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, w, biases, out, T, C, L, G, tile_t, round4(C), slope);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The grouped conv chain on `stream` on the current device, with
// mixstage::fill_tile's time tile (halo L); returns the cudaError_t of the
// launch (cudaErrorInvalidValue for a bad shape or one whose smallest tile
// does not fit shared memory).  Device pointers to contiguous float32
// arrays: x (B, T, G*C); w (L, G, 3, C, C); biases (L, G*C);
// out (B, T, G*C).
int mixstage_conv_chain_f32(const float* x, const float* w,
                            const float* biases, float* out, int B, int T,
                            int C, int L, int G, float slope, void* stream) {
  return launch_chain<float>(x, w, biases, out, B, T, C, L, G, slope, stream);
}

// bf16 mode: as mixstage_conv_chain_f32 with x and out (B, T, G*C)
// contiguous bfloat16; w and biases stay float32.
int mixstage_conv_chain_bf16(const __nv_bfloat16* x, const float* w,
                             const float* biases, __nv_bfloat16* out, int B,
                             int T, int C, int L, int G, float slope,
                             void* stream) {
  return launch_chain<__nv_bfloat16>(x, w, biases, out, B, T, C, L, G, slope,
                                     stream);
}

const char* mixstage_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
