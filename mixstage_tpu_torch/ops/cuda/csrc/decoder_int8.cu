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
// It runs on the int8 tensor cores (mma.sync.m16n8k32 s8 x s8 -> s32),
// with K1's plan (fused_decoder.cu): one CTA owns a (time tile, sequence,
// group) block and holds the tile's int8 activations in shared memory
// across all L + 2 layers, so no intermediate layer touches HBM; rows
// outside [0, T) stay zero, which is the per-sequence zero padding.  A row
// is stored as 32-bit words of four consecutive channels, which is the
// A-fragment layout of the s8 MMA; the weights come packed the same way
// (ops/cuda/quant.py::pack_decoder_int8, output channel fastest), which is
// its B-fragment layout, and reach shared memory in chunks of 16 words
// (64 channels) through a ring of 3 cp.async stages (tensor_core.cuh), so
// each weight word leaves L2 once per CTA and feeds every row of the tile.
// K is padded to 8 words (32 channels) with zero weights.  16 warps: each
// owns 32 output columns and every other 16-row m-tile of the layer, its B
// fragments loaded once per k-step for all of them.  The k-step is
// compiled for each count of live m-tiles, so the MMAs run without a
// branch between them.
//
// bf16-feature mode (mixstage_decoder_int8_bf16): the TPU kernel also takes
// the bfloat16 features of a bf16 model, and quantize_input promotes them:
// x / s_in is bf16 / f32, an f32 division of the exactly widened value.
// Only the input stage differs: each feature is loaded as one 2-byte value
// (a row of C0 = 266 bf16 values is 532 bytes, so row starts are only 4-byte
// aligned and no wider load is safe), widened exactly, then __fdiv_rn and
// quant8 as in the f32 mode.  The MMAs, the epilogue and the f32 logits
// are the same code.  It moves ~1.1 MB less input at bs32 and stays bound
// by operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_common.cuh"
#include "tensor_core.cuh"

namespace {

using mixstage::round8;

constexpr int kWarpsN = 8;            // each owns 32 output columns
constexpr int kWarpsM = 2;            // and every other 16-row m-tile
constexpr int kThreads = 32 * kWarpsN * kWarpsM;
constexpr int kMTiles = 4;            // m-tiles per warp at most
constexpr int kMaxRows = 16 * kMTiles * kWarpsM;
constexpr int kStages = 3;            // chunks in the weight ring
constexpr int kChunkRows = 16;        // k rows (words) per chunk
constexpr int kMaxTile = 64;          // output frames per CTA at most
// the weight staging's cost per CTA in row-passes (launch_common.cuh)
constexpr int kWeightRows = 64;

__device__ __forceinline__ int quant8(float v) {   // clip(round(v), +-127)
  return (int)fminf(fmaxf(rintf(v), -127.f), 127.f);
}

// A feature as f32: the f32 value, or the bf16 value widened (exact).
__device__ __forceinline__ float feature(const float* p) { return __ldg(p); }
__device__ __forceinline__ float feature(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// One k-step (8 words: 32 input channels) of a warp's NM m-tiles x 4
// n-tiles.  `a` points at the warp's A word (row 0 of its first m-tile,
// word k0 + t), arow[i][h] are the row offsets (words) of m-tile i's
// fragment rows g + 8h; `b` points at the warp's B word (k row t, column
// n0 + g) in the staged chunk, row stride ws.  Without kFullN only the
// first nt n-tiles are live.
template <int NM, bool kFullN>
__device__ __forceinline__ void kstep_s8(int (&acc)[kMTiles][4][4],
                                         const uint32_t* a,
                                         const int (&arow)[kMTiles][2],
                                         const uint32_t* b, int ws, int nt) {
  uint32_t bf[4][2], af[NM][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (kFullN || j < nt) {
      bf[j][0] = b[8 * j];
      bf[j][1] = b[8 * j + 4 * ws];
    }
  }
#pragma unroll
  for (int i = 0; i < NM; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) af[i][e] = a[arow[i][e & 1] + 4 * (e >> 1)];
#pragma unroll
  for (int i = 0; i < NM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (kFullN || j < nt) mixstage::mma_s8(acc[i][j], af[i], bf[j]);
}

// kstep_s8<nm, kFullN> for a runtime nm in [1, NM].
template <int NM, bool kFullN>
__device__ __forceinline__ void kstep_s8_n(int nm, int (&acc)[kMTiles][4][4],
                                           const uint32_t* a,
                                           const int (&arow)[kMTiles][2],
                                           const uint32_t* b, int ws, int nt) {
  if (nm == NM) {
    kstep_s8<NM, kFullN>(acc, a, arow, b, ws, nt);
  } else if constexpr (NM > 1) {
    kstep_s8_n<NM - 1, kFullN>(nm, acc, a, arow, b, ws, nt);
  }
}

// One KT-tap int8 layer (KT = 3: 'same' conv; KT = 1: the 1x1 logits)
// producing tile rows [lo, hi) (at most kMaxRows).  `in` is the int8 tile
// as words of four channels (row stride `stride` words, row r <-> time
// t_first + r); output row r reads input rows r - KT/2 .. r + KT/2.  w is
// (KT, cinw, cout) words with cout fastest.  Hidden layers write the
// requantized int8 activations to the shared tile `out` (row stride
// out_stride bytes); the logits layer writes f32 to global row t of `out`
// (row stride out_stride floats).  `ring` holds kStages chunks of `slot`
// words.  Warp (wn, wm) computes columns [32 wn, 32 wn + 32) of m-tiles
// wm, wm + 2, ...  Every thread of the CTA calls it (it synchronises).
template <int KT, bool kLogits>
__device__ __forceinline__ void layer8(
    const uint32_t* in, int stride, int cinw, const int* __restrict__ w,
    const float* __restrict__ mult, const float* __restrict__ bias,
    const float* __restrict__ rq, int cout, int lo, int hi, void* out,
    int out_stride, int t_first, float slope, uint32_t* ring, int slot) {
  const int rows = hi - lo;
  if (rows <= 0) return;                  // the same for the whole CTA
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int warp = threadIdx.x >> 5;
  const int n0 = 32 * (warp % kWarpsN), wm = warp / kWarpsN;
  const int kpad = round8(cinw);
  const int kchunks = (kpad + kChunkRows - 1) / kChunkRows;
  const int nchunks = KT * kchunks;
  const int ws = mixstage::weight_stride(cout);
  // this warp's m-tiles wm + kWarpsM * i, i < nm, and n-tiles j < nt
  const int nm = min(kMTiles, ((rows + 15) / 16 - wm + kWarpsM - 1) / kWarpsM);
  const int nt = min(4, (cout - n0 + 7) / 8);
  const bool live = nm > 0 && nt > 0;
  // rows past hi recompute row hi - 1 (never stored): no load leaves the tile
  const int r0 = lo + 16 * wm + g;
  int arow[kMTiles][2];
#pragma unroll
  for (int i = 0; i < kMTiles; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      arow[i][h] = (min(r0 + 16 * kWarpsM * i + 8 * h, hi - 1) - r0) * stride;
  int acc[kMTiles][4][4];
#pragma unroll
  for (int i = 0; i < kMTiles; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  auto stage = [&](int c) {               // chunk c: tap c / kchunks
    if (c < nchunks) {
      const int tap = c / kchunks;
      mixstage::stage_chunk<kChunkRows>(
          ring + (c % kStages) * slot, ws,
          reinterpret_cast<const uint32_t*>(w + (size_t)tap * cinw * cout),
          cinw, cout, (c - tap * kchunks) * kChunkRows);
    }
    mixstage::cp_async_commit();          // an empty group keeps the count
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) stage(s);
  for (int c = 0; c < nchunks; ++c) {
    mixstage::cp_async_wait<kStages - 2>();   // chunk c has landed ...
    __syncthreads();            // ... for every thread; chunk c-1 is done
    stage(c + kStages - 1);     // into chunk c-1's slot
    if (!live) continue;
    const int tap = c / kchunks, kc = (c - tap * kchunks) * kChunkRows;
    const uint32_t* a = in + (r0 + tap - KT / 2) * stride + t;
    const uint32_t* b = ring + (c % kStages) * slot + t * ws + n0 + g;
#pragma unroll
    for (int ks = 0; ks < kChunkRows; ks += 8) {
      const int k0 = kc + ks;
      if (k0 >= kpad) break;
      if (nt == 4)
        kstep_s8_n<kMTiles, true>(nm, acc, a + k0, arow, b + ks * ws, ws, nt);
      else
        kstep_s8_n<kMTiles, false>(nm, acc, a + k0, arow, b + ks * ws, ws,
                                   nt);
    }
  }
  mixstage::cp_async_wait<0>();           // only empty groups are left
  if (!live) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = n0 + 8 * j + 2 * t + (e & 1);
      if (c >= cout) continue;
      const float m = __ldg(mult + c), bc = __ldg(bias + c);
      const float r = kLogits ? 0.f : __ldg(rq + c);
#pragma unroll
      for (int i = 0; i < kMTiles; ++i) {
        const int row = r0 + 16 * kWarpsM * i + 8 * (e >> 1);
        if (i >= nm || row >= hi) continue;
        float y = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j][e]), m), bc);
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

// X: the feature type (float, or __nv_bfloat16 in the bf16-feature mode).
template <class X>
__global__ void __launch_bounds__(kThreads, 1) decoder_int8_kernel(
    const X* __restrict__ x, const float* __restrict__ s_in,
    const int* __restrict__ w0, const int* __restrict__ wc,
    const int* __restrict__ wl, const float* __restrict__ m0,
    const float* __restrict__ mc, const float* __restrict__ ml,
    const float* __restrict__ rq, const float* __restrict__ biases,
    const float* __restrict__ bl, float* __restrict__ out, int T, int C0,
    int C, int L, int F, int G, int tile_t, int stride, int slot,
    float slope) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int halo = L + 1;
  const int nr = tile_t + 2 * halo;         // tile rows incl. both halos
  const int b = blockIdx.y, g = blockIdx.z;
  const int t_first = blockIdx.x * tile_t - halo;   // time of tile row 0
  // rows holding t in [0, T); the rest stay zero: the 'same' zero padding
  const int v_lo = max(0, -t_first);
  const int v_hi = min(nr, T - t_first);
  const int c0w = (C0 + 3) / 4, cw = (C + 3) / 4;
  uint32_t* buf[2] = {smem, smem + (size_t)nr * stride};
  uint32_t* ring = smem + 2 * (size_t)nr * stride;

  // zero both buffers; quantize the input rows of sequence b into buf0, four
  // channels to a word (channel 4i+e in byte e), one warp per row
  const X* xb = x + (size_t)b * T * C0;
  for (int r = threadIdx.x >> 5; r < nr; r += blockDim.x >> 5) {
    const bool valid = r >= v_lo && r < v_hi;
    const X* xr = xb + (size_t)(t_first + r) * C0;
    for (int wd = threadIdx.x & 31; wd < stride; wd += 32) {
      unsigned word = 0;
      if (valid && wd < c0w) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ch = 4 * wd + e;
          if (ch < C0) {
            const int q = quant8(__fdiv_rn(feature(xr + ch), __ldg(s_in + ch)));
            word |= ((unsigned)q & 0xffu) << (8 * e);
          }
        }
      }
      buf[0][r * stride + wd] = word;
      buf[1][r * stride + wd] = 0;
    }
  }
  __syncthreads();

  const int nb = L + 1;                     // layers with a bias, per group
  const int stride_b = 4 * stride;          // row stride in bytes
  // layer 0: buf0 (C0 wide) -> buf1; layer l reads rows [l, nr - l)
  layer8<3, false>(buf[0], stride, c0w, w0 + (size_t)g * 3 * c0w * C,
                   m0 + (size_t)g * C, biases + (size_t)g * nb * C,
                   rq + (size_t)g * nb * C, C, max(1, v_lo),
                   min(nr - 1, v_hi), buf[1], stride_b, t_first, slope, ring,
                   slot);
  __syncthreads();
  for (int l = 1; l <= L; ++l) {
    layer8<3, false>(buf[l & 1], stride, cw,
                     wc + ((size_t)(l - 1) * G + g) * 3 * cw * C,
                     mc + ((size_t)(l - 1) * G + g) * C,
                     biases + ((size_t)g * nb + l) * C,
                     rq + ((size_t)g * nb + l) * C, C, max(l + 1, v_lo),
                     min(nr - l - 1, v_hi), buf[(l + 1) & 1], stride_b,
                     t_first, slope, ring, slot);
    __syncthreads();
  }
  // 1x1 logits of the tile's own rows [halo, halo + tile_t) into
  // out[b, t, g*F:(g+1)*F]
  layer8<1, true>(buf[(L + 1) & 1], stride, cw, wl + (size_t)g * cw * F,
                  ml + (size_t)g * F, bl + (size_t)g * F, nullptr, F,
                  max(halo, v_lo), min(halo + tile_t, v_hi),
                  out + (size_t)b * T * G * F + (size_t)g * F, G * F, t_first,
                  slope, ring, slot);
}

// The shared memory of one CTA: two buffers of tile_t + 2(L+1) rows (row
// stride act_stride of the wider of C0 and C in words of four int8
// channels), then the weight ring.
struct Layout {
  int stride, slot;
  Layout(int C0, int C, int F)
      : stride(mixstage::act_stride((C0 > C ? C0 + 3 : C + 3) / 4)),
        slot(kChunkRows * mixstage::weight_stride(C > F ? C : F)) {}
  size_t bytes(int L, int tile_t) const {
    return (2 * (size_t)(tile_t + 2 * (L + 1)) * stride +
            (size_t)kStages * slot) * sizeof(uint32_t);
  }
};

int pick_tile(int B, int T, int C0, int C, int L, int F, int G, int sm_count,
              size_t smem_limit) {
  const Layout lay(C0, C, F);
  return mixstage::cost_tile(
      kMaxTile, B, T, G, L + 1, L + 1, 16 * kWarpsM, kWeightRows, sm_count,
      [&](int t) {
        return t + 2 * L <= kMaxRows && lay.bytes(L, t) <= smem_limit;
      });
}

}  // namespace

extern "C" {

// Output frames per CTA on a card of `sm_count` SMs with `smem_limit` bytes
// of dynamic shared memory per CTA (the rule mixstage::cost_tile); 0 when
// no tile fits.
int mixstage_decoder_int8_tile(int B, int T, int C0, int C, int L, int F,
                               int G, int sm_count, size_t smem_limit) {
  return pick_tile(B, T, C0, C, L, F, G, sm_count, smem_limit);
}

}  // extern "C"

namespace {

template <class X>
int launch(const X* x, const float* s_in, const int* w0, const int* wc,
           const int* wl, const float* m0, const float* mc, const float* ml,
           const float* rq, const float* biases, const float* bl, float* out,
           int B, int T, int C0, int C, int L, int F, int G, float slope,
           int tile_t, void* stream) {
  if (B <= 0 || T <= 0 || C0 <= 0 || C <= 0 || L < 0 || F <= 0 || G <= 0 ||
      B > 65535 || G > 65535 || C > 32 * kWarpsN || F > 32 * kWarpsN ||
      tile_t < 0)
    return (int)cudaErrorInvalidValue;
  int sms, smem_limit;
  cudaError_t err = mixstage::card(&sms, &smem_limit);
  if (err != cudaSuccess) return (int)err;
  if (tile_t == 0) tile_t = pick_tile(B, T, C0, C, L, F, G, sms, smem_limit);
  const Layout lay(C0, C, F);
  if (tile_t == 0 || tile_t + 2 * L > kMaxRows ||
      lay.bytes(L, tile_t) > (size_t)smem_limit)
    return (int)cudaErrorInvalidValue;
  const size_t smem = lay.bytes(L, tile_t);
  err = cudaFuncSetAttribute(decoder_int8_kernel<X>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + tile_t - 1) / tile_t, B, G);
  decoder_int8_kernel<X><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, s_in, w0, wc, wl, m0, mc, ml, rq, biases, bl, out, T, C0, C, L, F,
      G, tile_t, lay.stride, lay.slot, slope);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream` on the current device with `tile_t` output frames per
// CTA (0: mixstage_decoder_int8_tile's choice for that device); returns the
// cudaError_t of the launch (0 = success; cudaErrorInvalidValue for a bad
// shape, or a tile whose rows or shared memory do not fit).  All pointers
// are device pointers to contiguous arrays:
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
                          float slope, int tile_t, void* stream) {
  return launch<float>(x, s_in, w0, wc, wl, m0, mc, ml, rq, biases, bl, out,
                       B, T, C0, C, L, F, G, slope, tile_t, stream);
}

// bf16-feature mode: as mixstage_decoder_int8 with x (B, T, C0) contiguous
// bfloat16; everything else, out included, as there.
int mixstage_decoder_int8_bf16(const __nv_bfloat16* x, const float* s_in,
                               const int* w0, const int* wc, const int* wl,
                               const float* m0, const float* mc,
                               const float* ml, const float* rq,
                               const float* biases, const float* bl,
                               float* out, int B, int T, int C0, int C, int L,
                               int F, int G, float slope, int tile_t,
                               void* stream) {
  return launch<__nv_bfloat16>(x, s_in, w0, wc, wl, m0, mc, ml, rq, biases,
                               bl, out, B, T, C0, C, L, F, G, slope, tile_t,
                               stream);
}

const char* mixstage_decoder_int8_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
