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
// What bounds it: ~27 GFLOP per bs32 decoder call against ~26 MB of
// weights and ~9 MB of activations in and out.  It runs on the tensor cores
// in 3xTF32: each f32 operand v is split into hi = tf32(v) and
// lo = tf32(v - hi), and a product is taken as a_lo*b_hi + a_hi*b_lo +
// a_hi*b_hi (the small terms first) with f32 accumulation, which keeps
// about 21 bits of each product: f32 accuracy for these 800-term sums, at 3
// MMAs per multiply-add.  So it is bound by operations at a third of the
// card's TF32 rate (~0.16 ms for the bs32 decoder).
//
// The plan.  One CTA owns a (time tile, sequence, group) block and holds
// the tile's activations in shared memory across all L + 2 layers, so no
// intermediate layer touches HBM.  Each k=3 layer needs one more frame on
// each side, so a tile of TT output frames loads TT + 2(L+1) input frames
// (a halo, recomputed by the neighbouring tile); rows outside [0, T) stay
// zero in every layer, which is the per-sequence zero padding.  Each layer
// is one GEMM per tap (M = tile rows, N = C_out, K = C_in, padded to a
// multiple of 8 with zero weights) on mma.sync.m16n8k8: 8 warps, each
// owning 32 output columns and every 16-row m-tile of the layer, so each
// warp splits its B fragments once per k-step for up to 5 m-tiles; the
// k-step is compiled for each count of live m-tiles, so its MMAs run
// without a branch between them, the small-term passes first.  The
// weights reach shared memory in chunks of 32 k-rows through a ring of 2
// cp.async stages (tensor_core.cuh): chunk k + 1 is in flight while chunk k
// is multiplied, and each weight element leaves L2 once per CTA and feeds
// every row of the tile.  (16 warps on every other m-tile with 16-row
// chunks in 3 stages ran slower at every serving shape on an H100: more
// barriers and B splits per MMA, and register spills.)
// Row strides of 4 mod 8 words (activations) and
// 8 mod 16 words (weights) keep the fragment loads free of bank conflicts.
// The operands are split when a fragment is loaded from shared memory.
// (K1's bf16 mode is its own kernel, fused_decoder_bf16.cu.)
//
// The second entry point, mixstage_conv_chain_f32, replaces the TPU kernel
// mixstage_tpu/ops/pallas/fused_conv.py::fused_grouped_conv_chain (body
// _chain_kernel): L layers of grouped k=3 'same' conv + bias + leaky over
// (B, T, G*C), i.e. the decoder above without layer 0 and the logits.  It
// keeps the first FFMA plan on the CUDA cores (routine `layer`): one CTA
// per (time tile, sequence, group), the group's C channels resident in
// shared memory across all L layers, weights streamed from L2 with
// coalesced loads and kRows frames of one output channel per thread.  At
// (32, 64, G=8, C=256, L=3) it does ~19.3 GFLOP against ~52.5 MB, bound by
// operations (~0.29 ms at the f32 FMA rate).
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
#include "tensor_core.cuh"

namespace {

using mixstage::card;
using mixstage::round4;
using mixstage::round8;

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

// ---------------------------------------------------------------------------
// K1: the decoder on the tensor cores (3xTF32)
// ---------------------------------------------------------------------------

constexpr int kWarpsN = 8;                // each owns 32 output columns
constexpr int kWarpsM = 1;                // and every 16-row m-tile
constexpr int kTcThreads = 32 * kWarpsN * kWarpsM;
constexpr int kMTiles = 5;                // m-tiles per warp at most
constexpr int kMaxRows = 16 * kMTiles * kWarpsM;
constexpr int kStages = 2;                // chunks in the weight ring
constexpr int kChunkRows = 32;            // k rows (channels) per chunk
constexpr int kMaxTile = 64;
// the weight staging's cost per CTA in row-passes (launch_common.cuh)
constexpr int kWeightRows = 64;

// One k-step (8 input channels) of a warp's NM m-tiles x 4 n-tiles in
// 3xTF32.  `a` points at the warp's A element (row 0 of its first m-tile,
// column k0 + t), its m-tiles kWarpsM * 16 rows apart; arow[i][h] are the
// row offsets (floats) of m-tile i's fragment rows g + 8h.  `b` points at the
// warp's B element (k row t, column n0 + g) in the staged chunk, row
// stride ws.  Without kFullN only the first nt n-tiles are live.
template <int NM, bool kFullN>
__device__ __forceinline__ void kstep_tf32(float (&acc)[kMTiles][4][4],
                                           const float* a,
                                           const int (&arow)[kMTiles][2],
                                           const float* b, int ws, int nt) {
  uint32_t bh[4][2], bl[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (kFullN || j < nt) {
      mixstage::split_tf32(b[8 * j], bh[j][0], bl[j][0]);
      mixstage::split_tf32(b[8 * j + 4 * ws], bh[j][1], bl[j][1]);
    }
  }
  uint32_t ah[NM][4], al[NM][4];
#pragma unroll
  for (int i = 0; i < NM; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      mixstage::split_tf32(a[arow[i][e & 1] + 4 * (e >> 1)], ah[i][e],
                           al[i][e]);
  // the small terms first; each pass is 4 * NM independent MMAs
#pragma unroll
  for (int pass = 0; pass < 3; ++pass)
#pragma unroll
    for (int i = 0; i < NM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (kFullN || j < nt)
          mixstage::mma_tf32(acc[i][j], pass == 0 ? al[i] : ah[i],
                             pass == 1 ? bl[j] : bh[j]);
}

// kstep_tf32<nm, kFullN> for a runtime nm in [1, NM].
template <int NM, bool kFullN>
__device__ __forceinline__ void kstep_tf32_n(int nm,
                                             float (&acc)[kMTiles][4][4],
                                             const float* a,
                                             const int (&arow)[kMTiles][2],
                                             const float* b, int ws, int nt) {
  if (nm == NM) {
    kstep_tf32<NM, kFullN>(acc, a, arow, b, ws, nt);
  } else if constexpr (NM > 1) {
    kstep_tf32_n<NM - 1, kFullN>(nm, acc, a, arow, b, ws, nt);
  }
}

// One KT-tap layer (KT = 3: 'same' conv; KT = 1: the 1x1 logits) producing
// tile rows [lo, hi) (at most kMaxRows).  `in` is the tile in shared memory
// (row stride `stride` floats, row r <-> time t_first + r, columns >= cin
// finite); output row r reads input rows r - KT/2 .. r + KT/2.  w is (KT,
// cin, cout) with cout fastest.  Hidden layers write leaky(acc + bias) to
// the shared tile `out`; the logits layer writes acc + bias to global row t
// of `out` (row stride out_stride).  `ring` holds kStages chunks of `slot`
// words.  Warp (wn, wm) computes columns [32 wn, 32 wn + 32) of m-tiles
// wm, wm + kWarpsM, ...  Every thread of the CTA calls it (it synchronises).
template <int KT, bool kLogits>
__device__ __forceinline__ void layer_tc(
    const float* in, int stride, int cin, const float* __restrict__ w,
    const float* __restrict__ bias, int cout, int lo, int hi, float* out,
    int out_stride, int t_first, float slope, uint32_t* ring, int slot) {
  const int rows = hi - lo;
  if (rows <= 0) return;                  // the same for the whole CTA
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int warp = threadIdx.x >> 5;
  const int n0 = 32 * (warp % kWarpsN), wm = warp / kWarpsN;
  const int kpad = round8(cin);
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
  float acc[kMTiles][4][4];
#pragma unroll
  for (int i = 0; i < kMTiles; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  auto stage = [&](int c) {               // chunk c: tap c / kchunks
    if (c < nchunks) {
      const int tap = c / kchunks;
      mixstage::stage_chunk<kChunkRows>(
          ring + (c % kStages) * slot, ws,
          reinterpret_cast<const uint32_t*>(w + (size_t)tap * cin * cout),
          cin, cout, (c - tap * kchunks) * kChunkRows);
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
    const float* wsl = reinterpret_cast<const float*>(ring + (c % kStages) *
                                                      slot);
    const float* a = in + (r0 + tap - KT / 2) * stride + t;
    const float* b = wsl + t * ws + n0 + g;
#pragma unroll
    for (int ks = 0; ks < kChunkRows; ks += 8) {
      const int k0 = kc + ks;
      if (k0 >= kpad) break;
      const float* ak = a + k0;
      const float* bk = b + ks * ws;
      if (nt == 4)
        kstep_tf32_n<kMTiles, true>(nm, acc, ak, arow, bk, ws, nt);
      else
        kstep_tf32_n<kMTiles, false>(nm, acc, ak, arow, bk, ws, nt);
    }
  }
  mixstage::cp_async_wait<0>();           // only empty groups are left
  if (!live) return;
#pragma unroll
  for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + 16 * kWarpsM * i + 8 * (e >> 1);
        const int c = n0 + 8 * j + 2 * t + (e & 1);
        if (i < nm && r < hi && c < cout) {
          const float v = acc[i][j][e] + __ldg(bias + c);
          if (kLogits) {
            out[(size_t)(t_first + r) * out_stride + c] = v;
          } else {
            out[r * out_stride + c] = leaky(v, slope);
          }
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kTcThreads, 1) fused_decoder_kernel(
    const float* __restrict__ x, const float* __restrict__ w0,
    const float* __restrict__ wc, const float* __restrict__ biases,
    const float* __restrict__ wl, const float* __restrict__ bl,
    float* __restrict__ out, int T, int C0, int C, int L, int F, int G,
    int tile_t, int stride, int slot, float slope) {
  extern __shared__ __align__(16) float smem[];
  const int halo = L + 1;
  const int nr = tile_t + 2 * halo;         // tile rows incl. both halos
  const int b = blockIdx.y, g = blockIdx.z;
  const int t_first = blockIdx.x * tile_t - halo;   // time of tile row 0
  // rows holding t in [0, T); the rest stay zero: the 'same' zero padding
  const int v_lo = max(0, -t_first);
  const int v_hi = min(nr, T - t_first);
  float* buf[2] = {smem, smem + (size_t)nr * stride};
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem + 2 * (size_t)nr * stride);

  // zero both buffers and load the input rows (channels < C0) of sequence
  // b, one warp per row
  const float* xb = x + (size_t)b * T * C0;
  for (int r = threadIdx.x >> 5; r < nr; r += blockDim.x >> 5) {
    const bool valid = r >= v_lo && r < v_hi;
    for (int ch = threadIdx.x & 31; ch < stride; ch += 32) {
      buf[0][r * stride + ch] =
          valid && ch < C0 ? __ldg(xb + (size_t)(t_first + r) * C0 + ch) : 0.f;
      buf[1][r * stride + ch] = 0.f;
    }
  }
  __syncthreads();

  const int nb = L + 1;                     // folded biases per group
  // layer 0: buf0 (C0 wide) -> buf1; layer l reads rows [l, nr - l)
  layer_tc<3, false>(buf[0], stride, C0, w0 + (size_t)g * 3 * C0 * C,
                     biases + (size_t)g * nb * C, C, max(1, v_lo),
                     min(nr - 1, v_hi), buf[1], stride, t_first, slope, ring,
                     slot);
  __syncthreads();
  for (int l = 1; l <= L; ++l) {
    layer_tc<3, false>(buf[l & 1], stride, C,
                       wc + ((size_t)(l - 1) * G + g) * 3 * C * C,
                       biases + ((size_t)g * nb + l) * C, C, max(l + 1, v_lo),
                       min(nr - l - 1, v_hi), buf[(l + 1) & 1], stride,
                       t_first, slope, ring, slot);
    __syncthreads();
  }
  // 1x1 logits of the tile's own rows [halo, halo + tile_t) into
  // out[b, t, g*F:(g+1)*F]
  layer_tc<1, true>(buf[(L + 1) & 1], stride, C, wl + (size_t)g * C * F,
                    bl + (size_t)g * F, F, max(halo, v_lo),
                    min(halo + tile_t, v_hi),
                    out + (size_t)b * T * G * F + g * F, G * F, t_first, slope,
                    ring, slot);
}

// K1's shared memory: two activation buffers of tile_t + 2(L+1) rows (row
// stride act_stride(max(C0, C)) floats), then the weight ring of f32
// chunks.
struct TcLayout {
  int stride, slot;
  TcLayout(int C0, int C, int F)
      : stride(mixstage::act_stride(C0 > C ? C0 : C)),
        slot(kChunkRows * mixstage::weight_stride(C > F ? C : F)) {}
  size_t bytes(int L, int tile_t) const {
    return (2 * (size_t)(tile_t + 2 * (L + 1)) * stride +
            (size_t)kStages * slot) * sizeof(float);
  }
};

// A tile fits when its layers' rows fit the warps' m-tiles (layer 0
// computes tile_t + 2L rows) and its buffers fit shared memory.
int tc_tile(int B, int T, int C0, int C, int L, int F, int G, int sm_count,
            size_t smem_limit) {
  const TcLayout lay(C0, C, F);
  return mixstage::cost_tile(
      kMaxTile, B, T, G, L + 1, L + 1, 16 * kWarpsM, kWeightRows, sm_count,
      [&](int t) {
        return t + 2 * L <= kMaxRows && lay.bytes(L, t) <= smem_limit;
      });
}

// ---------------------------------------------------------------------------
// K2: the grouped conv chain on the CUDA cores (FFMA)
// ---------------------------------------------------------------------------

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

}  // namespace

extern "C" {

// Output frames per CTA of the decoder on a card of `sm_count` SMs with
// `smem_limit` bytes of dynamic shared memory per CTA (the rule
// mixstage::cost_tile); 0 when no tile fits.
int mixstage_fused_decoder_tile(int B, int T, int C0, int C, int L, int F,
                                int G, int sm_count, size_t smem_limit) {
  return tc_tile(B, T, C0, C, L, F, G, sm_count, smem_limit);
}

}  // extern "C"

namespace {

int launch_decoder(const float* x, const float* w0, const float* wc,
                   const float* biases, const float* wl, const float* bl,
                   float* out, int B, int T, int C0, int C, int L, int F,
                   int G, float slope, int tile_t, void* stream) {
  if (B <= 0 || T <= 0 || C0 <= 0 || C <= 0 || L < 0 || F <= 0 || G <= 0 ||
      B > 65535 || G > 65535 || C > 32 * kWarpsN || F > 32 * kWarpsN ||
      tile_t < 0)
    return (int)cudaErrorInvalidValue;
  int sms, smem_limit;
  cudaError_t err = card(&sms, &smem_limit);
  if (err != cudaSuccess) return (int)err;
  if (tile_t == 0) tile_t = tc_tile(B, T, C0, C, L, F, G, sms, smem_limit);
  const TcLayout lay(C0, C, F);
  if (tile_t == 0 || tile_t + 2 * L > kMaxRows ||
      lay.bytes(L, tile_t) > (size_t)smem_limit)
    return (int)cudaErrorInvalidValue;
  const size_t smem = lay.bytes(L, tile_t);
  err = cudaFuncSetAttribute(fused_decoder_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + tile_t - 1) / tile_t, B, G);
  fused_decoder_kernel<<<grid, kTcThreads, smem, (cudaStream_t)stream>>>(
      x, w0, wc, biases, wl, bl, out, T, C0, C, L, F, G, tile_t, lay.stride,
      lay.slot, slope);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream` on the current device with `tile_t` output frames per
// CTA (0: mixstage_fused_decoder_tile's choice for that device); returns
// the cudaError_t of the launch (0 = success; cudaErrorInvalidValue for a
// bad shape, or a tile whose rows or shared memory do not fit).  All
// pointers are device pointers to contiguous float32 arrays:
//   x (B, T, C0); w0 (G, 3, C0, C); wc (L, G, 3, C, C); biases (G, L+1, C);
//   wl (G, C, F); bl (G, F); out (B, T, G*F).
int mixstage_fused_decoder_f32(const float* x, const float* w0,
                               const float* wc, const float* biases,
                               const float* wl, const float* bl, float* out,
                               int B, int T, int C0, int C, int L, int F,
                               int G, float slope, int tile_t, void* stream) {
  return launch_decoder(x, w0, wc, biases, wl, bl, out, B, T, C0, C, L, F,
                        G, slope, tile_t, stream);
}

}  // extern "C"

namespace {

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
