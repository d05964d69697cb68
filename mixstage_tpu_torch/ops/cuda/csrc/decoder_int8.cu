// Int8 BN-folded Mix-StAGE mixture decoder for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel mixstage_tpu/ops/pallas/quant.py::
// fused_mixstage_decoder_int8 (body _decoder_kernel_int8).  Per group g:
//
//   q  = clip(round(x / s_in), +-127)                      f32 -> int8, C0
//   for each of the L + 1 k=3 'same' layers (layer 0: C0 -> C, then C -> C):
//     acc = conv3(q, w8)                                  int8 x int8 -> int32
//     y   = leaky(f32(acc) * mult + bias)
//     q   = clip(round(y * rq), +-127)                    per-channel requant
//   out[:, :, g*F:(g+1)*F] = f32(q @ wl8) * ml + b_logits  (1x1 logits, f32)
//
// Exact integers: |acc| <= 3 * 266 * 127^2 < 2^24 at the serving widths, so
// the int32 sums cannot overflow and their conversion to f32 is exact; the
// order of the sums does not matter.  The f32 epilogue rounds op by op as
// the plain version does (decoder_int8_plain): __fmul_rn / __fadd_rn keep
// nvcc from contracting a*b + c into an FMA (one ulp there flips a
// requantized LSB), __fdiv_rn quantizes the input, rintf rounds half to
// even like torch.round and jnp.round.  These intrinsics stay local to this
// file; the f32 kernels keep their FMAs.
//
// What bounds it: ~26.8 G int8 operations per bs32 decoder call against
// ~6.6 MB of int8 weights and ~8.5 MB of f32 activations in and out, so on
// the card's int8 tensor-core rate it is bound by operations (~0.014 ms).
// This first version keeps K1's plan (fused_decoder.cu) and runs on the
// CUDA cores: one CTA owns a (time tile, sequence, group) block and holds
// the tile's int8 activations in shared memory across all L + 2 layers, so
// no intermediate layer touches HBM; rows outside [0, T) stay zero, which is
// the per-sequence zero padding.  An int8 tile holds 4x the frames of K1's
// f32 tile in the same shared memory.  A row is stored as 32-bit words of
// four consecutive channels, the operand of __dp4a (four int8 products
// summed into an s32 accumulator); the weights come packed the same way
// (ops/cuda/quant.py::pack_decoder_int8, output channel fastest), so each
// thread register-blocks kRows frames of one output channel: every weight
// word feeds kRows dp4a and every 16-byte shared-memory load feeds 4.
// Tensor-core int8 MMA (mma.sync / wgmma) and TMA are left to a later
// version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_common.cuh"

namespace {

using mixstage::round4;

constexpr int kThreads = 512;
constexpr int kRows = 16;             // frames per thread pass (register block)
constexpr int kMaxTile = 128;         // output frames per CTA at most

__device__ __forceinline__ int quant8(float v) {   // clip(round(v), +-127)
  return (int)fminf(fmaxf(rintf(v), -127.f), 127.f);
}

// One KT-tap int8 layer (KT = 3: 'same' conv; KT = 1: the 1x1 logits)
// producing tile rows [lo, hi).  `in` is the int8 tile as words of four
// channels (row stride `stride` words, row r <-> time t_first + r); output
// row r reads input rows r - KT/2 .. r + KT/2.  w is (KT, cinw, cout) words
// with cout fastest.  Hidden layers write the requantized int8 activations
// to the shared tile `out` (row stride out_stride bytes); the logits layer
// writes f32 to global row t of `out` (row stride out_stride floats).
template <int KT, bool kLogits>
__device__ __forceinline__ void layer8(
    const int* in, int stride, int cinw, const int* __restrict__ w,
    const float* __restrict__ mult, const float* __restrict__ bias,
    const float* __restrict__ rq, int cout, int lo, int hi, void* out,
    int out_stride, int t_first, float slope) {
  const int rows = hi - lo;
  if (rows <= 0) return;
  const int nchunks = (rows + kRows - 1) / kRows;
  const int cin4 = cinw & ~3;
  for (int item = threadIdx.x; item < cout * nchunks; item += blockDim.x) {
    const int c = item % cout;
    const int r0 = lo + (item / cout) * kRows;
    int acc[kRows];
    int roff[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      acc[j] = 0;
      // rows past hi recompute row hi-1 (never stored): no reads past the tile
      roff[j] = min(r0 + j, hi - 1) * stride;
    }
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      const int* wk = w + (size_t)k * cinw * cout + c;
      const int* ink = in + (k - KT / 2) * stride;
#pragma unroll 2
      for (int ci = 0; ci < cin4; ci += 4) {
        const int w0 = __ldg(wk + (size_t)ci * cout);
        const int w1 = __ldg(wk + (size_t)(ci + 1) * cout);
        const int w2 = __ldg(wk + (size_t)(ci + 2) * cout);
        const int w3 = __ldg(wk + (size_t)(ci + 3) * cout);
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const int4 v = *reinterpret_cast<const int4*>(ink + roff[j] + ci);
          acc[j] = __dp4a(v.x, w0, acc[j]);
          acc[j] = __dp4a(v.y, w1, acc[j]);
          acc[j] = __dp4a(v.z, w2, acc[j]);
          acc[j] = __dp4a(v.w, w3, acc[j]);
        }
      }
      for (int ci = cin4; ci < cinw; ++ci) {
        const int wv = __ldg(wk + (size_t)ci * cout);
#pragma unroll
        for (int j = 0; j < kRows; ++j)
          acc[j] = __dp4a(ink[roff[j] + ci], wv, acc[j]);
      }
    }
    const float m = __ldg(mult + c), b = __ldg(bias + c);
    const float r = kLogits ? 0.f : __ldg(rq + c);
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int row = r0 + j;
      if (row < hi) {
        float y = __fadd_rn(__fmul_rn(__int2float_rn(acc[j]), m), b);
        if (kLogits) {
          static_cast<float*>(out)[(size_t)(t_first + row) * out_stride + c] =
              y;
        } else {
          y = y >= 0.f ? y : __fmul_rn(slope, y);
          static_cast<int8_t*>(out)[row * out_stride + c] =
              (int8_t)quant8(__fmul_rn(y, r));
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) decoder_int8_kernel(
    const float* __restrict__ x, const float* __restrict__ s_in,
    const int* __restrict__ w0, const int* __restrict__ wc,
    const int* __restrict__ wl, const float* __restrict__ m0,
    const float* __restrict__ mc, const float* __restrict__ ml,
    const float* __restrict__ rq, const float* __restrict__ biases,
    const float* __restrict__ bl, float* __restrict__ out, int T, int C0,
    int C, int L, int F, int G, int tile_t, int stride, float slope) {
  extern __shared__ __align__(16) int smem[];
  const int halo = L + 1;
  const int nr = tile_t + 2 * halo;         // tile rows incl. both halos
  const int b = blockIdx.y, g = blockIdx.z;
  const int t_first = blockIdx.x * tile_t - halo;   // time of tile row 0
  // rows holding t in [0, T); the rest stay zero: the 'same' zero padding
  const int v_lo = max(0, -t_first);
  const int v_hi = min(nr, T - t_first);
  const int c0w = (C0 + 3) / 4, cw = (C + 3) / 4;
  int* buf[2] = {smem, smem + (size_t)nr * stride};

  // zero both buffers; quantize the input rows of sequence b into buf0, four
  // channels to a word (channel 4i+e in byte e)
  const float* xb = x + (size_t)b * T * C0;
  for (int i = threadIdx.x; i < nr * stride; i += blockDim.x) {
    const int r = i / stride, wd = i - r * stride;
    unsigned word = 0;
    if (r >= v_lo && r < v_hi && wd < c0w) {
      const float* xr = xb + (size_t)(t_first + r) * C0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ch = 4 * wd + e;
        if (ch < C0) {
          const int q = quant8(__fdiv_rn(__ldg(xr + ch), __ldg(s_in + ch)));
          word |= ((unsigned)q & 0xffu) << (8 * e);
        }
      }
    }
    buf[0][i] = (int)word;
    buf[1][i] = 0;
  }
  __syncthreads();

  const int nb = L + 1;                     // layers with a bias, per group
  const int stride_b = 4 * stride;          // row stride in bytes
  // layer 0: buf0 (C0 wide) -> buf1; layer l reads rows [l, nr - l)
  layer8<3, false>(buf[0], stride, c0w, w0 + (size_t)g * 3 * c0w * C,
                   m0 + (size_t)g * C, biases + (size_t)g * nb * C,
                   rq + (size_t)g * nb * C, C, max(1, v_lo),
                   min(nr - 1, v_hi), buf[1], stride_b, t_first, slope);
  __syncthreads();
  for (int l = 1; l <= L; ++l) {
    layer8<3, false>(buf[l & 1], stride, cw,
                     wc + ((size_t)(l - 1) * G + g) * 3 * cw * C,
                     mc + ((size_t)(l - 1) * G + g) * C,
                     biases + ((size_t)g * nb + l) * C,
                     rq + ((size_t)g * nb + l) * C, C, max(l + 1, v_lo),
                     min(nr - l - 1, v_hi), buf[(l + 1) & 1], stride_b,
                     t_first, slope);
    __syncthreads();
  }
  // 1x1 logits of the tile's own rows [halo, halo + tile_t) into
  // out[b, t, g*F:(g+1)*F]
  layer8<1, true>(buf[(L + 1) & 1], stride, cw, wl + (size_t)g * cw * F,
                  ml + (size_t)g * F, bl + (size_t)g * F, nullptr, F,
                  max(halo, v_lo), min(halo + tile_t, v_hi),
                  out + (size_t)b * T * G * F + (size_t)g * F, G * F, t_first,
                  slope);
}

// The shared-memory layout of one CTA: two buffers of tile_t + 2(L+1) rows,
// each row `row_words` 32-bit words of four int8 channels (a multiple of 4
// words, so 16-byte loads stay aligned; wide enough for C0 and C).
inline int row_words(int C0, int C) {
  const int a = round4((C0 + 3) / 4), b = round4((C + 3) / 4);
  return a > b ? a : b;
}

inline size_t smem_bytes(int C0, int C, int L, int tile_t) {
  return 2 * (size_t)(tile_t + 2 * (L + 1)) * row_words(C0, C) * sizeof(int);
}

}  // namespace

extern "C" {

// Output frames per CTA on a card of `sm_count` SMs with `smem_limit` bytes
// of dynamic shared memory per CTA: mixstage::pick_tile from kMaxTile.
// Returns 0 when not even the 8-frame tile fits.
int mixstage_decoder_int8_tile(int B, int T, int C0, int C, int L, int G,
                               int sm_count, size_t smem_limit) {
  return mixstage::pick_tile(kMaxTile, B, T, G, sm_count, smem_limit,
                             [=](int t) { return smem_bytes(C0, C, L, t); });
}

// Launch on `stream` on the current device, with the time tile chosen by
// mixstage_decoder_int8_tile for that device; returns the cudaError_t of the
// launch (0 = success; cudaErrorInvalidValue for a bad shape or one whose
// smallest tile does not fit shared memory).  All pointers are device
// pointers to contiguous arrays:
//   x (B, T, C0) f32; s_in (C0,) f32 input scales;
//   w0 (G, 3, ceil(C0/4), C), wc (L, G, 3, ceil(C/4), C), wl (G, ceil(C/4), F)
//   int32 words of four int8 input channels (channel 4i+e in byte e);
//   m0 (G, C), mc (L, G, C), ml (G, F) f32 dequant multipliers;
//   rq (G, L+1, C) f32 requant reciprocals; biases (G, L+1, C), bl (G, F);
//   out (B, T, G*F) f32.
int mixstage_decoder_int8(const float* x, const float* s_in, const int* w0,
                          const int* wc, const int* wl, const float* m0,
                          const float* mc, const float* ml, const float* rq,
                          const float* biases, const float* bl, float* out,
                          int B, int T, int C0, int C, int L, int F, int G,
                          float slope, void* stream) {
  if (B <= 0 || T <= 0 || C0 <= 0 || C <= 0 || L < 0 || F <= 0 || G <= 0 ||
      B > 65535 || G > 65535)
    return (int)cudaErrorInvalidValue;
  int sms, smem_limit;
  cudaError_t err = mixstage::card(&sms, &smem_limit);
  if (err != cudaSuccess) return (int)err;
  const int tile_t =
      mixstage_decoder_int8_tile(B, T, C0, C, L, G, sms, smem_limit);
  if (tile_t == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(C0, C, L, tile_t);
  err = cudaFuncSetAttribute(decoder_int8_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + tile_t - 1) / tile_t, B, G);
  decoder_int8_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, s_in, w0, wc, wl, m0, mc, ml, rq, biases, bl, out, T, C0, C, L, F,
      G, tile_t, row_words(C0, C), slope);
  return (int)cudaGetLastError();
}

const char* mixstage_decoder_int8_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
