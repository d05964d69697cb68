// Fused BN-folded Mix-StAGE mixture decoder for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel mixstage_tpu/ops/pallas/fused_conv.py::
// fused_mixstage_decoder (body _decoder_kernel).  Per group g it computes
//
//   h  = leaky(conv3(x, w0[g]) + biases[g, 0])                  C0 -> C
//   h  = leaky(conv3(h, wc[l, g]) + biases[g, l + 1])  l < L    C  -> C
//   out[:, :, g*F:(g+1)*F] = h @ w_logits[g] + b_logits[g]      C  -> F
//
// where conv3 is a k=3 'same' conv with zero padding at each sequence's own
// two ends.  The serving path calls it twice: the mixture decoder
// (G=8, C0=266, C=256, L=3, F=96) and the cluster-classifier chain
// (G=1, C0=266, C=256, L=5, F=8).
//
// What bounds it: ~27 GFLOP of f32 multiply-adds per bs32 decoder call
// against ~26 MB of weights and ~9 MB of activations in and out, so on the
// card's f32 FMA rate it is bound by operations, not by HBM bytes.  What the
// TPU kernel keeps out of memory, this keeps out of memory too: one CTA
// owns a (time tile, sequence, group) block and holds the tile's activations
// in shared memory across all L + 2 layers, so no intermediate layer touches
// HBM.  Each k=3 layer needs one more frame on each side, so a tile of TT
// output frames loads TT + 2(L+1) input frames (a halo, recomputed by the
// neighbouring tile); rows outside [0, T) stay zero in every layer, which is
// the per-sequence zero padding.  Weights stream from L2 with coalesced
// loads (output channel fastest, as stored); each thread register-blocks
// kRows frames of one output channel, so every weight load feeds kRows FMAs
// and every shared-memory float4 load feeds 4.  f32 FMA accumulation.
// Tensor cores (wgmma) and TMA are left to a later version.
//
// The second entry point, mixstage_conv_chain_f32, replaces the TPU kernel
// mixstage_tpu/ops/pallas/fused_conv.py::fused_grouped_conv_chain (body
// _chain_kernel): L layers of grouped k=3 'same' conv + bias + leaky over
// (B, T, G*C), i.e. the decoder above without layer 0 and the logits.  The
// same plan: one CTA per (time tile, sequence, group), the group's C
// channels resident in shared memory across all L layers, the tile's own
// rows of the last layer stored to global memory in the (B, T, G*C) layout.
// At (32, 64, G=8, C=256, L=3) it does ~19.3 GFLOP against ~52.5 MB, so it
// is bound by operations too (~0.29 ms at the f32 FMA rate).

#include <cuda_runtime.h>

#include "launch_common.cuh"

namespace {

using mixstage::card;
using mixstage::round4;

// 16 rows per thread at one 512-thread CTA per SM (128 registers) was the
// fastest register block at the bs32 serving shapes when this was tuned.
constexpr int kThreads = 512;
constexpr int kMinBlocks = 1;         // CTAs per SM: allows 128 registers
constexpr int kRows = 16;             // frames per thread pass (register block)
constexpr int kUnrollCi = 2;

__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.f ? v : slope * v;
}

// One KT-tap layer (KT = 3: 'same' conv; KT = 1: the 1x1 logits) producing
// tile rows [lo, hi).  `in` is the tile in shared memory (row stride
// `stride` floats, row r <-> time t_first + r); output row r reads input rows
// r - KT/2 .. r + KT/2.  Hidden layers write leaky(acc) to the shared tile
// `out`; the logits layer writes acc to global row t of `out` (row stride
// out_stride).  w is (KT, cin, cout) with cout fastest.
template <int KT, bool kLogits>
__device__ __forceinline__ void layer(
    const float* in, int stride, int cin, const float* __restrict__ w,
    const float* __restrict__ bias, int cout, int lo, int hi, float* out,
    int out_stride, int t_first, float slope) {
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
    for (int k = 0; k < KT; ++k) {
      const float* wk = w + (size_t)k * cin * cout + c;
      const float* ink = in + (k - KT / 2) * stride;
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
      if (r < hi) {
        if (kLogits) {
          out[(size_t)(t_first + r) * out_stride + c] = acc[j];
        } else {
          out[r * out_stride + c] = leaky(acc[j], slope);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) fused_decoder_kernel(
    const float* __restrict__ x, const float* __restrict__ w0,
    const float* __restrict__ wc, const float* __restrict__ biases,
    const float* __restrict__ wl, const float* __restrict__ bl,
    float* __restrict__ out, int T, int C0, int C, int L, int F, int G,
    int tile_t, int stride, float slope) {
  extern __shared__ __align__(16) float smem[];
  const int halo = L + 1;
  const int nr = tile_t + 2 * halo;         // tile rows incl. both halos
  const int b = blockIdx.y, g = blockIdx.z;
  const int t_first = blockIdx.x * tile_t - halo;   // time of tile row 0
  // rows holding t in [0, T); the rest stay zero: the 'same' zero padding
  const int v_lo = max(0, -t_first);
  const int v_hi = min(nr, T - t_first);
  float* buf[2] = {smem, smem + (size_t)nr * stride};

  // zero both buffers and load the input rows (channels < C0) of sequence b
  const float* xb = x + (size_t)b * T * C0;
  for (int i = threadIdx.x; i < nr * stride; i += blockDim.x) {
    const int r = i / stride, ch = i - r * stride;
    const bool valid = r >= v_lo && r < v_hi && ch < C0;
    buf[0][i] = valid ? __ldg(xb + (size_t)(t_first + r) * C0 + ch) : 0.f;
    buf[1][i] = 0.f;
  }
  __syncthreads();

  const int nb = L + 1;                     // folded biases per group
  // layer 0: buf0 (C0 wide) -> buf1; layer l reads rows [l, nr - l)
  layer<3, false>(buf[0], stride, C0, w0 + (size_t)g * 3 * C0 * C,
                  biases + (size_t)g * nb * C, C, max(1, v_lo),
                  min(nr - 1, v_hi), buf[1], stride, t_first, slope);
  __syncthreads();
  for (int l = 1; l <= L; ++l) {
    layer<3, false>(buf[l & 1], stride, C,
                    wc + ((size_t)(l - 1) * G + g) * 3 * C * C,
                    biases + ((size_t)g * nb + l) * C, C, max(l + 1, v_lo),
                    min(nr - l - 1, v_hi), buf[(l + 1) & 1], stride, t_first,
                    slope);
    __syncthreads();
  }
  // 1x1 logits of the tile's own rows [halo, halo + tile_t) into
  // out[b, t, g*F:(g+1)*F]
  layer<1, true>(buf[(L + 1) & 1], stride, C, wl + (size_t)g * C * F,
                 bl + (size_t)g * F, F, max(halo, v_lo),
                 min(halo + tile_t, v_hi), out + (size_t)b * T * G * F + g * F,
                 G * F, t_first, slope);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) conv_chain_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ biases, float* __restrict__ out, int T, int C,
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
  const float* xb = x + (size_t)b * T * GC + (size_t)g * C;
  for (int i = threadIdx.x; i < nr * stride; i += blockDim.x) {
    const int r = i / stride, ch = i - r * stride;
    const bool valid = r >= v_lo && r < v_hi && ch < C;
    buf[0][i] = valid ? __ldg(xb + (size_t)(t_first + r) * GC + ch) : 0.f;
    buf[1][i] = 0.f;
  }
  __syncthreads();
  // layer l (0-based) reads rows [l, nr - l) of buf[l & 1]
  for (int l = 0; l < L; ++l) {
    layer<3, false>(buf[l & 1], stride, C,
                    w + ((size_t)l * G + g) * 3 * C * C,
                    biases + (size_t)l * GC + (size_t)g * C, C,
                    max(l + 1, v_lo), min(nr - l - 1, v_hi),
                    buf[(l + 1) & 1], stride, t_first, slope);
    __syncthreads();
  }
  // the tile's own rows [halo, halo + tile_t) to out[b, t, g*C:(g+1)*C]
  const float* last = buf[L & 1];
  const int lo = max(halo, v_lo), hi = min(halo + tile_t, v_hi);
  float* ob = out + (size_t)b * T * GC + (size_t)g * C;
  for (int i = threadIdx.x; i < (hi - lo) * C; i += blockDim.x) {
    const int r = lo + i / C, c = i % C;
    ob[(size_t)(t_first + r) * GC + c] = last[r * stride + c];
  }
}

// The shared-memory layout of one CTA: two buffers of tile_t + 2*halo rows
// (halo = one frame per k=3 layer), each row `stride` floats (float4-aligned,
// wide enough for every layer's input).
inline int row_stride(int C0, int C) {
  return round4(C0) > round4(C) ? round4(C0) : round4(C);
}

inline size_t smem_bytes(int stride, int halo, int tile_t) {
  return 2 * (size_t)(tile_t + 2 * halo) * stride * sizeof(float);
}

// mixstage::pick_tile from 64 output frames per CTA.
int pick_tile(int B, int T, int G, int stride, int halo, int sm_count,
              size_t smem_limit) {
  return mixstage::pick_tile(64, B, T, G, sm_count, smem_limit, [=](int t) {
    return smem_bytes(stride, halo, t);
  });
}

}  // namespace

extern "C" {

// Output frames per CTA of the decoder on a card of `sm_count` SMs with
// `smem_limit` bytes of dynamic shared memory per CTA (pick_tile's rule);
// 0 when not even the 8-frame tile fits.
int mixstage_fused_decoder_tile(int B, int T, int C0, int C, int L, int G,
                                int sm_count, size_t smem_limit) {
  return pick_tile(B, T, G, row_stride(C0, C), L + 1, sm_count, smem_limit);
}

// Launch on `stream` on the current device, with the time tile chosen by
// mixstage_fused_decoder_tile for that device; returns the cudaError_t of
// the launch (0 = success; cudaErrorInvalidValue for a bad shape or one
// whose smallest tile does not fit shared memory).  All pointers are device
// pointers to contiguous float32 arrays:
//   x (B, T, C0); w0 (G, 3, C0, C); wc (L, G, 3, C, C); biases (G, L+1, C);
//   wl (G, C, F); bl (G, F); out (B, T, G*F).
int mixstage_fused_decoder_f32(const float* x, const float* w0,
                               const float* wc, const float* biases,
                               const float* wl, const float* bl, float* out,
                               int B, int T, int C0, int C, int L, int F,
                               int G, float slope, void* stream) {
  if (B <= 0 || T <= 0 || C0 <= 0 || C <= 0 || L < 0 || F <= 0 || G <= 0 ||
      B > 65535 || G > 65535)
    return (int)cudaErrorInvalidValue;
  int sms, smem_limit;
  cudaError_t err = card(&sms, &smem_limit);
  if (err != cudaSuccess) return (int)err;
  const int tile_t =
      mixstage_fused_decoder_tile(B, T, C0, C, L, G, sms, smem_limit);
  if (tile_t == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(row_stride(C0, C), L + 1, tile_t);
  err = cudaFuncSetAttribute(fused_decoder_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + tile_t - 1) / tile_t, B, G);
  fused_decoder_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, w0, wc, biases, wl, bl, out, T, C0, C, L, F, G, tile_t,
      row_stride(C0, C), slope);
  return (int)cudaGetLastError();
}

// The grouped conv chain on `stream` on the current device, with
// pick_tile's time tile (halo L); returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a bad shape or one whose smallest tile does not
// fit shared memory).  Device pointers to
// contiguous float32 arrays: x (B, T, G*C); w (L, G, 3, C, C);
// biases (L, G*C); out (B, T, G*C).
int mixstage_conv_chain_f32(const float* x, const float* w,
                            const float* biases, float* out, int B, int T,
                            int C, int L, int G, float slope, void* stream) {
  if (B <= 0 || T <= 0 || C <= 0 || L < 0 || G <= 0 || B > 65535 ||
      G > 65535)
    return (int)cudaErrorInvalidValue;
  int sms, smem_limit;
  cudaError_t err = card(&sms, &smem_limit);
  if (err != cudaSuccess) return (int)err;
  const int tile_t = pick_tile(B, T, G, round4(C), L, sms, smem_limit);
  if (tile_t == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(round4(C), L, tile_t);
  err = cudaFuncSetAttribute(conv_chain_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + tile_t - 1) / tile_t, B, G);
  conv_chain_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, w, biases, out, T, C, L, G, tile_t, round4(C), slope);
  return (int)cudaGetLastError();
}

const char* mixstage_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
