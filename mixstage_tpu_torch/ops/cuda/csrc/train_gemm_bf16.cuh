// K3's GEMM passes for Hopper (sm_90a), both modes: the conv, transposed
// conv and per-tap weight gradient of the training decoder (train_decoder.cu)
// on wgmma, fed by bulk asynchronous copies into an mbarrier ring by a
// warp-specialised producer.
//
// Replaces the GEMMs of the TPU kernels
// mixstage_tpu/ops/pallas/train_decoder.py::_fwd_call (the conv taps of
// _conv3_acc and the logits) and ::_bwd_call (dW, d(input), the head), at
// dtype=bfloat16 and at float32.  Per group g (blockIdx.z), with frames f =
// b*T + t:
//   kConv : out[f, n] = sum_{k, j} a[b, t + (k - 1), j] * w[k, j, n]
//   kConvT: out[f, j] = sum_{k, n} a[b, t - (k - 1), n] * w[k, j, n]
//   kDW   : out[k, j, n] = sum_f a[b, t + (k - 1), j] * d[f, n]
// (one tap, k = 1, for the logits and the head), taps that leave their own
// sequence reading zero.
//
// Two modes, one template parameter kTerms: the bf16 terms each operand
// element is held as.
// * bf16 mode (kTerms 1): bf16 operands, one exact bf16 product each.
// * f32 mode (kTerms 3): every f32 operand element v is held as three bf16
//   terms that sum to it exactly, v1 = bf16(v), v2 = bf16(v - v1), v3 =
//   bf16(v - v1 - v2) (8 + 8 + 8 significant bits cover f32's 24; each
//   difference is exact in f32), and a product a*w is taken as the six
//   bf16 products a1w1 + (a1w2 + a2w1) + (a1w3 + a2w2 + a3w1), each exact
//   in f32, the small ones first.  The three left out (a2w3, a3w2, a3w3)
//   are at most ~3 * 2^-24 of |a w|.  A term is one more image: each
//   operand's three term images lie a fixed stride apart in global memory
//   and one image apart in a ring slot, so a term is a descriptor moved by
//   one image (the same geometry as K1's f32 mode, fused_decoder_wgmma.cu).
//   Six bf16 passes at 989 TFLOP/s take as long as 3xTF32 at 495, and bf16
//   keeps the MN-major operands (imm-trans) that TF32 wgmma does not have.
//
// Padded rows.  Every operand indexed by frames is kept in padded-row
// coordinates: p = 1 + b * (T + 1) + t, with a zero row at p = 0 and one
// after each sequence (t = T).  A tap is then a shift by one padded row,
// and a shift never crosses into another sequence: it reads a zero row.
// kConv / kConvT compute output rows in padded rows (the zero rows' outputs
// are not stored); kDW reduces over padded rows (d is zero there).
//
// Images.  Each operand lives in global memory as an image (three in the
// f32 mode, one per term) laid out like the ring's shared-memory image of
// it, [channel / 8][row][8 channels] of 16-byte lines, zero-padded to whole
// tiles and chunks (see "Images" below): the pack kernels write those of
// x, dout and the weights, the column passes of train_decoder.cu write h's
// and dc's.  So a chunk's operands are a few contiguous runs, each one
// cp.async.bulk that the copy engine completes on the stage's full
// mbarrier, whatever the widths (C0 = 266, odd F): no copy of the ring
// needs the producer's threads.  In shared memory the 8 rows of a wgmma
// core matrix are 8 consecutive lines, so one image serves both majors
// (wgmma.cuh): read K-major when its channels are the reduction (the
// conv's activations, kConvT's weights) and MN-major (imm-trans 1) when
// its rows are (the conv's weights, both kDW operands).  Rows of one
// channel group are contiguous, so a descriptor moved by 16 bytes is the
// operand shifted by one row: the three taps of a conv read one activation
// image (M-shifted, conv) or one image of a (K-shifted, kDW) at -16, 0 and
// +16 bytes.
//
// The pipeline.  A CTA is three warpgroups: two consumers, each issuing
// m64nNk16 wgmmas on a 64 x kN block of the CTA's tile (side by side in M
// for the 128 x 128 tile, in N for the 64-row ones), and a producer warp
// whose lanes issue each chunk's bulk copies after one expect-tx arrival.
// Consumers wait on the full barrier, issue the chunk's wgmmas as one
// committed straight-line group (no branch around a wgmma: ptxas
// serialises them behind divergent paths), wait for it, add it to the
// accumulator, and release the stage on its empty mbarrier.  A chunk is
// kKC reduced channels by every tap (conv modes) or kKC padded rows (kDW):
// 64 and 128 in the bf16 mode, 16 and 32 in the f32 mode, whose three-term
// chunks take 3x the bytes (a 128 x 128 conv chunk of 64 channels would
// be 197 KB, one stage): at these depths every tile keeps two stages or
// more (Tile::kStages).  In the f32 mode the activation operands (A, and
// kDW's B) arrive by one 5-D tensor copy a chunk (cp.async.bulk.tensor:
// every channel group and term), and a kDW tile holds all three taps'
// accumulators, so each chunk is streamed once for the three taps, not
// once a tap (kTilesAllTaps; that halved the f32 backward's L2 traffic,
// PERF.md).  The kernel is persistent: one CTA an SM, each
// walking its share of the tiles, so the producer fills the ring with the
// next tile's chunks while the consumers store the last one's.  A first
// version staged the operands from their frame layouts with cp.async by
// the producer warpgroup's 128 threads: the copies alone then took 89% of
// the kernel's time (tools/k3_variants.py), and more producer threads
// left ptxas compiling the whole kernel to fewer registers.
//
// Accuracy.  Each bf16 product is exact in f32, but the tensor cores'
// accumulation truncates, so each chunk's wgmmas sum into a zeroed partial
// (scale-d 0 on the first) added to the f32 accumulator: a partial covers
// 192 (bf16 conv, 3 taps), 64 (1 tap) or 128 (kDW) products; in the f32
// mode 48, 16 or 32 six-product terms.  (Summed straight into one
// accumulator, 3xTF32 products drifted 2.82e-5 over a 6144-deep sum: enough
// to flip leaky units near 0.)  The epilogue keeps K3's rounding points:
// in the bf16 mode kConv rounds the sum to bf16 before the bias
// (round_acc) and the sum again, the logits are acc + bias rounded; kConvT
// and kDW, and every pass of the f32 mode, store f32.
//
// Split-K.  kDW's reduction runs over all B*T frames while its output is
// only taps x C_in x C_out a group, too few tiles to fill 132 SMs at small
// C.  Its padded rows may be split into S ranges (each range its own
// tiles), each writing an f32 partial; split_sum_kernel adds them in split
// order, so two launches give the same bits.  The plan (tile and S) comes
// from plan(): waves of CTAs times a CTA's chunks at the tensor-core rate
// (six products a multiply-add in the f32 mode) plus its fixed cost, plus
// the partials' traffic (at ~29 bytes a clock an SM, L2's bandwidth spread
// over 132 SMs).
//
// What bounds it: at bs32 the GEMM passes do 26.8 (forward) and 53.7
// (backward) GFLOP, 0.027 and 0.054 ms at the dense bf16 rate in the bf16
// mode, six times that (0.163 and 0.326 ms) in the f32 mode.  Every tile
// streams its group's weights (or both kDW operands) from L2: a 64 x 256
// bf16 conv chunk is 107 KB for 3.1 M multiply-adds, so the ring's stages
// wait on L2 (~40 GB/s an SM when all SMs pull) rather than on the tensor
// cores; the conv passes reach ~240 TFLOP/s (PERF.md).  A three-term chunk
// holds 3x the bytes for 6x the products, twice the tensor-core work per
// byte streamed; the f32 mode's conv passes run at about half the bf16
// peak in six-product work, still bound by the stream (tools/k3_variants.py:
// without the copies its backward takes half the time, without the MMAs
// nearly all of it).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma.cuh"

namespace mixstage {
namespace k3 {

using bf16 = __nv_bfloat16;

enum Mode { kConv = 0, kConvT = 1, kDW = 2 };

// v stored as T (bf16: rounded to nearest even).
template <class T>
__device__ __forceinline__ T to(float v) {
  if constexpr (sizeof(T) == 4) {
    return v;
  } else {
    return __float2bfloat16_rn(v);
  }
}

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(bf16 v) {
  return __bfloat162float(v);
}

// The three bf16 terms of v (v1 = bf16(v), v2 = bf16(v - v1), v3 =
// bf16(v - v1 - v2)), which sum to it exactly: fused_conv.py::split_bf16x3.
__device__ __forceinline__ void split3(float v, bf16 (&t)[3]) {
  t[0] = __float2bfloat16_rn(v);
  const float r = v - __bfloat162float(t[0]);
  t[1] = __float2bfloat16_rn(r);
  t[2] = __float2bfloat16_rn(r - __bfloat162float(t[1]));
}

// The mode whose operand elements are kTerms bf16 terms: its element type
// in frame layout (bf16, or f32 split into three terms).
template <int kTerms>
using Elem = std::conditional_t<kTerms == 1, bf16, float>;

// ---------------------------------------------------------------------------
// the wgmma GEMM
// ---------------------------------------------------------------------------

constexpr int kSmemBudget = 232448;   // opt-in shared memory per CTA (H100)
constexpr int kBarBytes = 256;        // the ring's mbarriers (<= 16 stages)
constexpr int kMaxStages = 8;
// Two consumer warpgroups and one producer warpgroup.  Registers: 384
// threads launch with 168 each, and setmaxnreg moves them within that:
// 128 x 56 + 256 x 224 = 384 x 168.  (ptxas compiles the whole kernel to
// the launch bound: more producer threads leave the consumers' wgmma
// accumulators spilling, tools/k3_variants.py.)
constexpr int kProducerThreads = 128;
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 32 * kConsumerWarps + kProducerThreads;
constexpr int kMaxSplitK = 4;         // kDW's reduction splits, at most

// Images.  Every operand reaches the GEMM as an image in global memory,
// written by the pack kernels below (or, for the activations K3 computes,
// by its column passes), laid out as the ring's shared-memory images so
// that a chunk's copies are a few contiguous bulk copies:
//   activations (frames x C): [channel / 8][image row q][8], q = p + 1 for
//     padded row p (q = 0, the rows after each sequence and every row past
//     the last are zero), act_rows(B, T) rows, act_groups(C) channel groups
//     (zero past C);
//   kConv weights w (taps, K, N): [tap][chunk][n / 8][kc rows of K][8],
//     chunks of K and N padded with zeros to w_conv_groups(N) groups;
//   kConvT weights w (taps, J, K): [tap][chunk][k / 8 in the chunk][J rows
//     padded to w_convt_rows(J)][8].
// kc is the mode's conv chunk depth (Depth<kTerms>::kConv).  In the f32
// mode each group of an operand holds its three term images one after
// another ([group][term][image]).  The padding covers every tile and
// chunk, so every copy is whole.
constexpr int kKCConv = 64, kKCDW = 128;    // reduction depth of a chunk
constexpr int kKCConvF32 = 16, kKCDWF32 = 32;   // the same, f32 mode
constexpr int kRowAlign = 128;              // image rows: a multiple + 2
constexpr int kColAlign = 128;              // channels / N padded to this

// A mode's chunk depths: conv modes (reduced channels, every tap) and kDW
// (padded rows).
template <int kTerms>
struct Depth {
  static constexpr int kConv = kTerms == 1 ? kKCConv : kKCConvF32;
  static constexpr int kDW = kTerms == 1 ? kKCDW : kKCDWF32;
};

__host__ __device__ inline long long round_up(long long n, long long m) {
  return (n + m - 1) / m * m;
}
// padded rows p < 1 + B (T + 1); image rows cover every tile's halo
__host__ __device__ inline int padded_rows(int B, int T) {
  return 1 + B * (T + 1);
}
__host__ __device__ inline int act_rows(int B, int T) {
  return (int)round_up(padded_rows(B, T), kRowAlign) + 2;
}
__host__ __device__ inline int act_groups(int C) {
  return (int)(round_up(C, kColAlign) / 8);
}
__host__ __device__ inline int w_chunks(int K, int kc) {
  return (K + kc - 1) / kc;
}
__host__ __device__ inline int w_conv_groups(int N) {
  return (int)(round_up(N, kColAlign) / 8);
}
__host__ __device__ inline int w_convt_rows(int J) {
  return (int)round_up(J, kColAlign);
}
// elements of one group's images
__host__ __device__ inline long long act_elems(int B, int T, int C) {
  return (long long)act_groups(C) * act_rows(B, T) * 8;
}
__host__ __device__ inline long long w_conv_elems(int taps, int K, int N,
                                                  int kc) {
  return (long long)taps * w_chunks(K, kc) * w_conv_groups(N) * kc * 8;
}
__host__ __device__ inline long long w_convt_elems(int taps, int J, int K,
                                                   int kc) {
  return (long long)taps * w_chunks(K, kc) * kc * w_convt_rows(J);
}

// One launch: the operands of a group are offset by blockIdx.z's group;
// in the f32 mode term u of an operand by u times its term stride.
struct Params {
  const bf16* a; long long a_g, a_t;  // A: an activation image
  const bf16* b; long long b_g, b_t;  // B: a weight image (kDW: dc's)
  const void* bias; long long bias_g; // kConv only (may be null), Elem
  void* out; long long out_g;         // bf16 (bf16 kConv) or f32
  float* part;                        // kDW with splits > 1: (S, G, taps *
                                      // M, N) f32 partials
  int M;       // kConv / kConvT: padded rows; kDW: C_in (J)
  int N;       // output columns
  int K;       // kConv / kConvT: reduced channels; kDW: padded rows
  int taps, sign, T, B, groups, round_acc;
  int splits, chunks_per_split;       // kDW: S, chunks of one split
};

// The f32 mode's tensor maps (cp.async.bulk.tensor): A's image (every
// mode) and kDW's B (dc's image), each a dense 5-dimensional tensor {8
// elements, image rows, channel groups, terms, groups} whose box is a
// chunk's whole operand, every channel group and term in one copy.  (One
// bulk copy per channel group and term took ~66 clocks each, ~100 of them
// a weight-gradient chunk: the copies, not the MMAs, bounded the backward,
// tools/k3_variants.py.)  The bf16 mode keeps its bulk copies and passes
// NoMaps.
struct NoMaps {};
struct alignas(64) Maps {
  CUtensorMap a, b;
};
template <int kTerms>
using MapsOf = std::conditional_t<kTerms == 1, NoMaps, Maps>;

// The frame of padded row p (see the top), or -1 for a zero row.
__host__ __device__ __forceinline__ long long frame_of(int p, int T, int B) {
  const int q = p - 1;
  if (q < 0) return -1;
  const int b = q / (T + 1), t = q - b * (T + 1);
  return t < T && b < B ? (long long)b * T + t : -1;
}

// The shared-memory plan of one instance: kWM consumer warpgroups along M
// (2: a 128-row tile, each warpgroup 64 rows by all kN columns; 1: a
// 64-row tile, the warpgroups side by side in N), wgmma width kN, kTerms
// images of each operand.  A slot holds A's term images, then B's (each
// term all its taps).
template <int kMode, int kWM, int kN, int kTerms>
struct Tile {
  static constexpr int kBM = 64 * kWM;
  static constexpr int kBN = kN * (2 / kWM);
  static constexpr bool kW = kMode == kDW;
  // kDW in the f32 mode: a CTA holds every tap's accumulator, so each
  // chunk's operands serve all three taps (kTilesAllTaps)
  static constexpr bool kAllTaps = kW && kTerms == 3;
  static constexpr int kKC =                      // reduction of a chunk
      kW ? Depth<kTerms>::kDW : Depth<kTerms>::kConv;
  static constexpr int kBImages = kW ? 1 : 3;     // B images (taps) a chunk
  // A: [channel / 8][row][8]; conv modes: the chunk's kKC channels of
  // kBM + 2 image rows (a halo row each side); kDW: kBM channels of
  // kKC + 2 image rows
  static constexpr int kARows = kW ? kKC + 2 : kBM + 2;
  static constexpr int kAGroups = kW ? kBM / 8 : kKC / 8;
  static constexpr int kAGroupBytes = kARows * 16;
  static constexpr int kABytes = kAGroups * kAGroupBytes;
  // B (per tap): kConv, kDW [n / 8][reduction row][8]; kConvT [reduced
  // channel / 8][n][8]
  static constexpr int kBRows = kMode == kConvT ? kBN : kKC;
  static constexpr int kBGroups = kMode == kConvT ? kKC / 8 : kBN / 8;
  static constexpr int kBGroupBytes = kBRows * 16;
  static constexpr int kBTapBytes = kBGroups * kBGroupBytes;
  static constexpr int kBTermBytes = kBImages * kBTapBytes;
  static constexpr int kSlot =
      (kTerms * (kABytes + kBTermBytes) + 127) / 128 * 128;
  static constexpr int kStagesFit = (kSmemBudget - kBarBytes) / kSlot;
  static constexpr int kStages =
      kStagesFit < kMaxStages ? kStagesFit : kMaxStages;
  static constexpr size_t kSmem = kBarBytes + (size_t)kStages * kSlot;
  static_assert(kStages >= 2, "a ring needs two stages");
};

// The instances: (kWM, kN) -> tiles 128 x 128, 64 x 256, 64 x 192, 64 x 96.
constexpr int kTiles[][2] = {{2, 128}, {1, 128}, {1, 96}, {1, 48}};
// The f32 mode's weight gradient, whose CTAs hold three accumulators (one
// a tap) of 64 x kN a warpgroup: 128 x 64, 64 x 128, 64 x 96, 128 x 48.
// Each tile of the other instances streams its chunk once for each tap,
// and the f32 mode's backward was bound by that L2 traffic
// (tools/k3_variants.py: no copies 0.83 ms, no MMAs 1.48, both 1.68).
constexpr int kTilesAllTaps[][2] = {{2, 64}, {1, 64}, {1, 48}, {2, 48}};
constexpr int kNumTiles = 4;

constexpr bool all_taps(int mode, int terms) {
  return mode == kDW && terms == 3;
}
constexpr int tile_wm(bool all, int t) {
  return all ? kTilesAllTaps[t][0] : kTiles[t][0];
}
constexpr int tile_n(bool all, int t) {
  return all ? kTilesAllTaps[t][1] : kTiles[t][1];
}

// Copy i of chunk c (rows from m0, columns from n0) of one term: the A
// image's channel groups into `aimg`, then each tap's B image (kConvT: per
// reduced channel group) into `bimg`; chunk_copies() of them a term,
// completing their bytes on `bar`.
template <int kMode, class Tl>
__device__ __forceinline__ int chunk_copies(int taps) {
  if constexpr (kMode == kDW) return Tl::kAGroups + Tl::kBGroups;
  if constexpr (kMode == kConv) return Tl::kAGroups + taps;
  return Tl::kAGroups + taps * Tl::kBGroups;
}

template <int kMode, class Tl>
__device__ __forceinline__ void chunk_copy(const Params& p, const bf16* a,
                                           const bf16* b,
                                           unsigned char* aimg,
                                           unsigned char* bimg, int c,
                                           int m0, int n0, int i,
                                           uint64_t* bar) {
  const bf16* src;
  unsigned char* dst;
  uint32_t bytes;
  const int rows = act_rows(p.B, p.T);
  if (i < Tl::kAGroups) {                     // A: one channel group
    const int r0 = kMode == kDW ? c * Tl::kKC : m0;
    const int cg = (kMode == kDW ? m0 : c * Tl::kKC) / 8 + i;
    src = a + ((long long)cg * rows + r0) * 8;
    dst = aimg + i * Tl::kAGroupBytes;
    bytes = Tl::kAGroupBytes;
  } else {
    const int j = i - Tl::kAGroups;
    if constexpr (kMode == kDW) {             // dc: one n group, kKC rows
      src = b + ((long long)(n0 / 8 + j) * rows + c * Tl::kKC + 1) * 8;
      dst = bimg + j * Tl::kBGroupBytes;
      bytes = Tl::kBGroupBytes;
    } else if constexpr (kMode == kConv) {    // tap j's [n / 8][kKC][8]
      src = b + (((long long)j * w_chunks(p.K, Tl::kKC) + c) *
                     w_conv_groups(p.N) + n0 / 8) * Tl::kKC * 8;
      dst = bimg + j * Tl::kBTapBytes;
      bytes = Tl::kBTapBytes;
    } else {                                  // tap k, reduced group cg
      const int k = j / Tl::kBGroups, cg = j - k * Tl::kBGroups;
      src = b + ((((long long)k * w_chunks(p.K, Tl::kKC) + c) *
                      Tl::kBGroups + cg) * w_convt_rows(p.N) + n0) * 8;
      dst = bimg + k * Tl::kBTapBytes + cg * Tl::kBGroupBytes;
      bytes = Tl::kBGroupBytes;
    }
  }
  sm90::bulk_copy(dst, src, bytes, bar);
}

// One chunk's wgmmas for this consumer warpgroup as one committed group:
// for each of NT taps and each 16-deep step of the chunk, part (+)= A * B,
// the first zeroing part.  a / b: the descriptors' start addresses for
// tap 0, step 0; a_tap / b_tap their moves per tap, a_kk / b_kk per step.
template <int kN, int TA, int TB, int NT, int KS>
__device__ __forceinline__ void mma_chunk(float (&part)[kN / 2], uint32_t a,
                                          uint32_t b, int a_tap, int b_tap,
                                          int a_kk, int b_kk, uint32_t lbo_a,
                                          uint32_t sbo_a, uint32_t lbo_b,
                                          uint32_t sbo_b) {
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) sm90::fence_operand(part[i]);
  sm90::wgmma_fence();
#pragma unroll
  for (int k = 0; k < NT; ++k)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      sm90::WgmmaT<kN>::template mma<TA, TB>(
          part,
          sm90::matrix_desc(a + k * a_tap + kk * a_kk, lbo_a, sbo_a),
          sm90::matrix_desc(b + k * b_tap + kk * b_kk, lbo_b, sbo_b),
          (k > 0 || kk > 0) ? 1 : 0);
  sm90::wgmma_commit();
}

// mma_chunk in the f32 mode: the six products A_i B_j (i + j <= 2) of each
// tap and step, by levels i + j from 2 down to 0 (the small products
// first), as one committed group; the operands' terms lie a_term / b_term
// bytes apart.
template <int kN, int TA, int TB, int NT, int KS>
__device__ __forceinline__ void mma_chunk6(float (&part)[kN / 2], uint32_t a,
                                           uint32_t b, int a_tap, int b_tap,
                                           int a_kk, int b_kk,
                                           uint32_t a_term, uint32_t b_term,
                                           uint32_t lbo_a, uint32_t sbo_a,
                                           uint32_t lbo_b, uint32_t sbo_b) {
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) sm90::fence_operand(part[i]);
  sm90::wgmma_fence();
#pragma unroll
  for (int lv = 2; lv >= 0; --lv)
#pragma unroll
    for (int k = 0; k < NT; ++k)
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int i = 0; i <= lv; ++i)
          sm90::WgmmaT<kN>::template mma<TA, TB>(
              part,
              sm90::matrix_desc(a + i * a_term + k * a_tap + kk * a_kk,
                                lbo_a, sbo_a),
              sm90::matrix_desc(b + (lv - i) * b_term + k * b_tap +
                                    kk * b_kk,
                                lbo_b, sbo_b),
              (lv < 2 || k > 0 || kk > 0 || i > 0) ? 1 : 0);
  sm90::wgmma_commit();
}

// Tile t of a launch: columns fastest, then rows, (kDW) taps and splits,
// then groups, so that the CTAs at work at one time share a group's
// weights in L2.
struct TileId {
  int m0, n0, grp, split, tap, c_begin, nchunks;
};

template <int kMode, class Tl>
__device__ __forceinline__ TileId tile_id(const Params& p, int t) {
  const int nt = (p.N + Tl::kBN - 1) / Tl::kBN;
  const int mt = (p.M + Tl::kBM - 1) / Tl::kBM;
  TileId id;
  const int ni = t % nt;
  t /= nt;
  const int mi = t % mt;
  t /= mt;
  id.tap = id.split = 0;
  if constexpr (kMode == kDW) {
    if constexpr (!Tl::kAllTaps) {
      id.tap = t % p.taps;
      t /= p.taps;
    }
    id.split = t % p.splits;
    t /= p.splits;
  }
  id.grp = t;
  id.m0 = mi * Tl::kBM;
  id.n0 = ni * Tl::kBN;
  const int all = (p.K + Tl::kKC - 1) / Tl::kKC;
  id.c_begin = id.split * p.chunks_per_split;
  const int c_end = min(all, id.c_begin + p.chunks_per_split);
  id.nchunks = c_end > id.c_begin ? c_end - id.c_begin : 0;
  return id;
}

// The epilogue of a tile, tap `tap`'s accumulator (kDW; 0 else): register
// 4 j + e of the m64nNk16 accumulator is (row 16 w + lane / 4 + 8 (e / 2),
// column 8 j + 2 (lane % 4) + e % 2); the two columns of a pair go out in
// one store where N is even.
template <int kMode, int kWM, int kN, class O, int kTerms>
__device__ __forceinline__ void store_tile(const Params& p, const TileId& id,
                                           const float (&acc)[kN / 2],
                                           int tap, int warp, int lane) {
  const int wg = warp >> 2, w4 = warp & 3;
  const int wm = kWM == 2 ? wg : 0, wn = kWM == 2 ? 0 : wg;
  const bool pairs = (p.N & 1) == 0;
  const int nb = id.n0 + wn * kN + 2 * (lane & 3);
  O* out = static_cast<O*>(p.out) + id.grp * p.out_g;
  const Elem<kTerms>* bias =
      p.bias ? static_cast<const Elem<kTerms>*>(p.bias) + id.grp * p.bias_g
             : nullptr;
  if (kMode == kDW && p.splits > 1) {
    out = reinterpret_cast<O*>(p.part) +
          ((long long)id.split * p.groups + id.grp) * p.taps * p.M * p.N;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = id.m0 + 64 * wm + 16 * w4 + (lane >> 2) + 8 * h;
    long long row;                   // output row, -1: none
    if constexpr (kMode == kDW) {
      row = r < p.M ? (long long)tap * p.M + r : -1;
    } else {
      row = r < p.M ? frame_of(r, p.T, p.B) : -1;
    }
    if (row < 0) continue;
    O* orow = out + row * p.N;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const int n = nb + 8 * j;
      if (n >= p.N) continue;
      float v[2] = {acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]};
      if constexpr (kMode == kConv) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (kTerms == 1 && p.round_acc)
            v[e] = __bfloat162float(__float2bfloat16_rn(v[e]));
          if (n + e < p.N) v[e] += bias ? as_float(bias[n + e]) : 0.f;
        }
      }
      if (pairs) {                   // n even, N even: n + 1 < N
        if constexpr (sizeof(O) == 4) {
          *reinterpret_cast<float2*>(orow + n) = make_float2(v[0], v[1]);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(orow + n) =
              __floats2bfloat162_rn(v[0], v[1]);
        }
      } else {
        orow[n] = to<O>(v[0]);
        if (n + 1 < p.N) orow[n + 1] = to<O>(v[1]);
      }
    }
  }
}

// Persistent: CTA blockIdx.x takes tiles blockIdx.x, + gridDim.x, ... of
// the launch's `tiles`; the producer runs on into the next tile's chunks
// while the consumers store the last one's.
template <int kMode, int kWM, int kN, class O, int kTerms>
__global__ void __launch_bounds__(kThreads, 1) wgmma_gemm_kernel(
    Params p, int tiles, const __grid_constant__ MapsOf<kTerms> maps) {
  using Tl = Tile<kMode, kWM, kN, kTerms>;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + Tl::kStages;
  unsigned char* ring = smem + kBarBytes;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < Tl::kStages; ++s) {
      sm90::mbar_init(&full[s], 1);   // the producer's expect-tx arrival
      sm90::mbar_init(&empty[s], kConsumerWarps);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  int s = 0;                          // the ring's stage and phase
  uint32_t ph = 0;
  if (warp >= kConsumerWarps) {
    // ---- producer: one warp, its lanes sharing a chunk's bulk copies
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (warp != kConsumerWarps) return;
    const int copies = chunk_copies<kMode, Tl>(p.taps);   // a term
    const uint32_t bytes =
        kTerms * (Tl::kABytes + (kMode == kDW ? 1 : p.taps) * Tl::kBTapBytes);
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const TileId id = tile_id<kMode, Tl>(p, t);
      const bf16* a = p.a + id.grp * p.a_g;
      const bf16* b = p.b + id.grp * p.b_g;
      for (int c = 0; c < id.nchunks; ++c) {
        sm90::mbar_wait(&empty[s], ph ^ 1);     // round 0 passes at once
        if (lane == 0) sm90::mbar_arrive_expect_tx(&full[s], bytes);
        __syncwarp();
        unsigned char* slot = ring + (size_t)s * Tl::kSlot;
        if constexpr (kTerms == 1) {
          for (int i = lane; i < copies; i += 32)
            chunk_copy<kMode, Tl>(p, a, b, slot, slot + Tl::kABytes,
                                  id.c_begin + c, id.m0, id.n0, i, &full[s]);
        } else {
          // A's (and kDW's B's) terms and channel groups: one tensor copy
          // each; the weights' term images (conv modes): bulk copies
          const int cc = id.c_begin + c, ga = p.a_g ? id.grp : 0;
          if (lane == 0) {
            if constexpr (kMode == kDW) {
              sm90::tensor_copy5(slot, &maps.a, 0, cc * Tl::kKC, id.m0 / 8,
                                 0, ga, &full[s]);
            } else {
              sm90::tensor_copy5(slot, &maps.a, 0, id.m0, cc * Tl::kKC / 8,
                                 0, ga, &full[s]);
            }
          }
          if constexpr (kMode == kDW) {
            if (lane == 1)
              sm90::tensor_copy5(slot + kTerms * Tl::kABytes, &maps.b, 0,
                                 cc * Tl::kKC + 1, id.n0 / 8, 0, id.grp,
                                 &full[s]);
          } else {
            const int nb = copies - Tl::kAGroups;   // B copies of a term
            for (int i = lane; i < kTerms * nb; i += 32) {
              const int u = i / nb;
              chunk_copy<kMode, Tl>(
                  p, a, b + u * p.b_t, slot,
                  slot + kTerms * Tl::kABytes + u * Tl::kBTermBytes, cc,
                  id.m0, id.n0, Tl::kAGroups + i - u * nb, &full[s]);
            }
          }
        }
        if (++s == Tl::kStages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers
  sm90::setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp >> 2;
  const int wm = kWM == 2 ? wg : 0, wn = kWM == 2 ? 0 : wg;
  // descriptor geometry (bytes) of this warpgroup's operands in a slot
  constexpr bool kW = kMode == kDW;
  constexpr int TA = kW ? 1 : 0, TB = kMode == kConvT ? 0 : 1;
  constexpr int KS = Tl::kKC / 16;
  // A: conv modes K-major (a 16-deep step is two channel groups), rows
  // shifted by the tap; kDW MN-major, the reduction (rows) shifted by the
  // tap
  const uint32_t lbo_a = kW ? 128 : Tl::kAGroupBytes;
  const uint32_t sbo_a = kW ? Tl::kAGroupBytes : 128;
  const int a_kk = kW ? 16 * 16 : 2 * Tl::kAGroupBytes;
  int a_off = (64 * wm + 1) * 16, a_tap = 0;
  if (!kW && p.taps == 3) {
    a_off -= p.sign * 16;                       // tap 0 reads row - sign
    a_tap = p.sign * 16;
  }
  // B: kConv, kDW MN-major [n / 8][row][8]; kConvT K-major [k / 8][n][8]
  const uint32_t lbo_b = TB ? 128 : Tl::kBGroupBytes;
  const uint32_t sbo_b = TB ? Tl::kBGroupBytes : 128;
  const int b_kk = TB ? 16 * 16 : 2 * Tl::kBGroupBytes;
  const int b_off = TB ? wn * (kN / 8) * Tl::kBGroupBytes : wn * kN * 16;
  const int b_tap = Tl::kBTapBytes;
  const bool three = !kW && p.taps == 3;

  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const TileId id = tile_id<kMode, Tl>(p, t);
    if constexpr (Tl::kAllTaps) {
      // every tap's accumulator: a chunk's three taps in turn, on two
      // partials, so that one tap's wgmmas run while the last one's
      // partial is added
      float acc[3][kN / 2], pa[kN / 2], pb[kN / 2];
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int i = 0; i < kN / 2; ++i) acc[k][i] = 0.f;
      auto add = [](float (&a)[kN / 2], float (&q)[kN / 2]) {
#pragma unroll
        for (int i = 0; i < kN / 2; ++i) {
          sm90::fence_operand(q[i]);
          a[i] += q[i];
        }
      };
      for (int c = 0; c < id.nchunks; ++c) {
        sm90::mbar_wait(&full[s], ph);
        const uint32_t slot = sm90::smem_u32(ring + (size_t)s * Tl::kSlot);
        // tap k reads A's rows from k (one tap: from 1)
        const uint32_t a0 = slot + 8 * wm * Tl::kAGroupBytes;
        const uint32_t b0 = slot + kTerms * Tl::kABytes + b_off;
        if (p.taps == 3) {
          mma_chunk6<kN, TA, TB, 1, KS>(pa, a0, b0, 0, 0, a_kk, b_kk,
                                        Tl::kABytes, Tl::kBTermBytes,
                                        lbo_a, sbo_a, lbo_b, sbo_b);
          mma_chunk6<kN, TA, TB, 1, KS>(pb, a0 + 16, b0, 0, 0, a_kk, b_kk,
                                        Tl::kABytes, Tl::kBTermBytes,
                                        lbo_a, sbo_a, lbo_b, sbo_b);
          sm90::wgmma_wait<1>();
          add(acc[0], pa);
          mma_chunk6<kN, TA, TB, 1, KS>(pa, a0 + 32, b0, 0, 0, a_kk, b_kk,
                                        Tl::kABytes, Tl::kBTermBytes,
                                        lbo_a, sbo_a, lbo_b, sbo_b);
          sm90::wgmma_wait<1>();
          add(acc[1], pb);
          sm90::wgmma_wait<0>();
          add(acc[2], pa);
        } else {
          mma_chunk6<kN, TA, TB, 1, KS>(pa, a0 + 16, b0, 0, 0, a_kk, b_kk,
                                        Tl::kABytes, Tl::kBTermBytes,
                                        lbo_a, sbo_a, lbo_b, sbo_b);
          sm90::wgmma_wait<0>();
          add(acc[0], pa);
        }
        if (lane == 0) sm90::mbar_arrive(&empty[s]);
        if (++s == Tl::kStages) {
          s = 0;
          ph ^= 1;
        }
      }
      store_tile<kMode, kWM, kN, O, kTerms>(p, id, acc[0], 0, warp, lane);
      if (p.taps == 3) {
        store_tile<kMode, kWM, kN, O, kTerms>(p, id, acc[1], 1, warp, lane);
        store_tile<kMode, kWM, kN, O, kTerms>(p, id, acc[2], 2, warp, lane);
      }
      continue;
    }
    if constexpr (kW)       // the reduction shifted by the tile's tap
      a_off = 8 * wm * Tl::kAGroupBytes + (p.taps == 3 ? id.tap : 1) * 16;
    float acc[kN / 2], part[kN / 2];
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;
    for (int c = 0; c < id.nchunks; ++c) {
      sm90::mbar_wait(&full[s], ph);
      const uint32_t slot = sm90::smem_u32(ring + (size_t)s * Tl::kSlot);
      const uint32_t a0 = slot + a_off;
      const uint32_t b0 = slot + kTerms * Tl::kABytes + b_off;
      if constexpr (kTerms == 1) {
        if (three) {
          mma_chunk<kN, TA, TB, 3, KS>(part, a0, b0, a_tap, b_tap, a_kk,
                                       b_kk, lbo_a, sbo_a, lbo_b, sbo_b);
        } else {
          mma_chunk<kN, TA, TB, 1, KS>(part, a0, b0, a_tap, b_tap, a_kk,
                                       b_kk, lbo_a, sbo_a, lbo_b, sbo_b);
        }
      } else {
        if (three) {
          mma_chunk6<kN, TA, TB, 3, KS>(part, a0, b0, a_tap, b_tap, a_kk,
                                        b_kk, Tl::kABytes, Tl::kBTermBytes,
                                        lbo_a, sbo_a, lbo_b, sbo_b);
        } else {
          mma_chunk6<kN, TA, TB, 1, KS>(part, a0, b0, a_tap, b_tap, a_kk,
                                        b_kk, Tl::kABytes, Tl::kBTermBytes,
                                        lbo_a, sbo_a, lbo_b, sbo_b);
        }
      }
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) {
        sm90::fence_operand(part[i]);
        acc[i] += part[i];
      }
      if (lane == 0) sm90::mbar_arrive(&empty[s]);
      if (++s == Tl::kStages) {
        s = 0;
        ph ^= 1;
      }
    }

    store_tile<kMode, kWM, kN, O, kTerms>(p, id, acc, id.tap, warp, lane);
  }
}

// out[g * out_g + i] = sum over the S splits of part[(s * G + g) * n + i],
// in split order (kDW's partials).
__global__ void split_sum_kernel(const float* __restrict__ part, int S,
                                 int G, long long n, float* __restrict__ out,
                                 long long out_g) {
  const long long total = (long long)G * n;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long g = i / n, r = i - g * n;
    float v = 0.f;
    for (int s = 0; s < S; ++s) v += __ldg(part + s * total + i);
    out[g * out_g + r] = v;
  }
}

// ---------------------------------------------------------------------------
// the images
// ---------------------------------------------------------------------------

// 8 values of `row` from column col, zero past `width` or where `ok` is
// false, as one 16-byte line (one 16-byte load where `vec`: the row's
// lines are 16-byte aligned and width a multiple of 8).
__device__ __forceinline__ uint4 line_of(const bf16* row, int col, int width,
                                         bool ok, bool vec) {
  if (vec) {
    return ok && col < width ? *reinterpret_cast<const uint4*>(row + col)
                             : make_uint4(0, 0, 0, 0);
  }
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int c = col + 2 * e;
    const uint32_t lo = ok && c < width ? __bfloat16_as_ushort(row[c]) : 0;
    const uint32_t hi =
        ok && c + 1 < width ? __bfloat16_as_ushort(row[c + 1]) : 0;
    w[e] = lo | hi << 16;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 8 f32 values of `row` from column col, zero past `width` or where `ok`
// is false (two 16-byte loads where `vec`: the row's lines are 16-byte
// aligned and width a multiple of 8).
__device__ __forceinline__ void vals_of(const float* row, int col, int width,
                                        bool ok, bool vec, float (&v)[8]) {
  if (vec) {
    const bool in = ok && col < width;
    const float4 lo = in ? *reinterpret_cast<const float4*>(row + col)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 hi = in ? *reinterpret_cast<const float4*>(row + col + 4)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = ok && col + e < width ? row[col + e] : 0.f;
}

// The three term lines of 8 f32 values (split3 of each).
__device__ __forceinline__ void term_lines(const float (&v)[8],
                                           uint4 (&line)[3]) {
  uint32_t w[3][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    bf16 lo[3], hi[3];
    split3(v[2 * e], lo);
    split3(v[2 * e + 1], hi);
#pragma unroll
    for (int u = 0; u < 3; ++u)
      w[u][e] = (uint32_t)__bfloat16_as_ushort(lo[u]) |
                (uint32_t)__bfloat16_as_ushort(hi[u]) << 16;
  }
#pragma unroll
  for (int u = 0; u < 3; ++u)
    line[u] = make_uint4(w[u][0], w[u][1], w[u][2], w[u][3]);
}

// One image pack_kernel writes, `groups` groups of `lines` 16-byte lines
// (in the f32 mode each group's three term images, `lines` lines each):
//   kPackAct: the activation image of (frames x K) matrices src (group
//     stride src_g elements; 0: one matrix for every group);
//   kPackPad: the zeros of an activation image of K channels that a column
//     pass fills (its padding rows, and every line holding a channel past
//     K: the pass writes the channels below K later);
//   kPackConv: the kConv image of w (taps, K, N);
//   kPackConvT: the kConvT image of w (taps, N, K).
enum PackKind { kPackAct = 0, kPackPad = 1, kPackConv = 2, kPackConvT = 3 };

// S: the sources' element type (bf16, or f32 split into three terms).
template <class S>
struct PackJob {
  const S* src;
  long long src_g;
  bf16* img;
  long long lines, first;  // lines a group (a term); the first global line
  int kind, K, N;
  bool vec;                // src rows read a 16-byte line at a time
};

constexpr int kMaxPackJobs = 8;
template <class S>
struct PackJobs {
  PackJob<S> job[kMaxPackJobs];
  int n, B, T;
  long long total;
};

// Every line of every job, one line a thread (grid-stride): the images the
// GEMMs of the mode of kTerms terms read, written in one launch.
template <class S, int kTerms>
__global__ void pack_kernel(PackJobs<S> jobs) {
  constexpr int kc = Depth<kTerms>::kConv;
  for (long long l = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       l < jobs.total; l += (long long)gridDim.x * blockDim.x) {
    int j = 0;
    while (j + 1 < jobs.n && l >= jobs.job[j + 1].first) ++j;
    const PackJob<S>& jb = jobs.job[j];
    const long long local = l - jb.first, g = local / jb.lines;
    const int r0 = (int)(local - g * jb.lines);
    int r = r0;
    const S* row = nullptr;        // the line's source row; null: zeros
    int col = 0, width = 0;
    bool ok = false;
    if (jb.kind == kPackAct || jb.kind == kPackPad) {
      const int rows = act_rows(jobs.B, jobs.T), cg = r / rows;
      const long long f = frame_of(r - cg * rows - 1, jobs.T, jobs.B);
      if (jb.kind == kPackPad) {
        if (f >= 0 && 8 * cg + 8 <= jb.K) continue;   // the pass's line
      } else {
        row = jb.src + g * jb.src_g + (f < 0 ? 0 : f) * jb.K;
        col = 8 * cg;
        width = jb.K;
        ok = f >= 0;
      }
    } else if (jb.kind == kPackConv) {   // r = ((k nc + c) ng + n8) kc + i
      const int nc = w_chunks(jb.K, kc), ng = w_conv_groups(jb.N);
      const int i = r % kc;
      r /= kc;
      const int n8 = r % ng;
      r /= ng;
      const int c = r % nc, k = r / nc, kr = c * kc + i;
      ok = kr < jb.K;
      row = jb.src + g * jb.src_g + ((long long)k * jb.K + (ok ? kr : 0)) *
                                        jb.N;
      col = 8 * n8;
      width = jb.N;
    } else {                       // r = ((k nc + c) kc / 8 + g8) J + j
      const int nc = w_chunks(jb.K, kc), jr = w_convt_rows(jb.N);
      const int jj = r % jr;
      r /= jr;
      const int g8 = r % (kc / 8);
      r /= kc / 8;
      const int c = r % nc, k = r / nc;
      ok = jj < jb.N;
      row = jb.src + g * jb.src_g + ((long long)k * jb.N + (ok ? jj : 0)) *
                                        jb.K;
      col = c * kc + 8 * g8;
      width = jb.K;
    }
    if constexpr (kTerms == 1) {
      *reinterpret_cast<uint4*>(jb.img + local * 8) =
          row ? line_of(row, col, width, ok, jb.vec) : make_uint4(0, 0, 0, 0);
    } else {
      uint4 t[3] = {make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0),
                    make_uint4(0, 0, 0, 0)};
      if (row) {
        float v[8];
        vals_of(row, col, width, ok, jb.vec, v);
        term_lines(v, t);
      }
#pragma unroll
      for (int u = 0; u < 3; ++u)
        *reinterpret_cast<uint4*>(
            jb.img + ((g * kTerms + u) * jb.lines + r0) * 8) = t[u];
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// A chunk's time on an SM, for plan(): its tensor-core clocks at the dense
// bf16 rate (~2048 multiply-adds a clock an SM; six bf16 products a
// multiply-add in the f32 mode) plus ~200 for its barriers.
template <int kMode, int kWM, int kN, int kTerms>
struct Cost {
  using Tl = Tile<kMode, kWM, kN, kTerms>;
  static constexpr int kProducts = kTerms == 1 ? 1 : 6;
  static long long chunk_clks(int taps) {
    const int t = kMode == kDW && !Tl::kAllTaps ? 1 : taps;
    return (long long)t * kProducts * Tl::kKC * Tl::kBM * Tl::kBN / 2048 +
           200;
  }
};

// A CTA's fixed clocks: its launch, its ring's first fill, its epilogue.
constexpr long long kCtaClks = 3000;

// Forced plan (tools/profile_k1.py --sweep), both modes: tile index >= 0
// and splits > 0 override plan()'s choice.
inline int& forced_tile() {
  static int t = -1;
  return t;
}
inline int& forced_splits() {
  static int s = 0;
  return s;
}

template <int kMode, int kWM, int kN, int kTerms>
long long plan_cost(const Params& p, int sms, int splits) {
  using Tl = Tile<kMode, kWM, kN, kTerms>;
  const long long mt = (p.M + Tl::kBM - 1) / Tl::kBM;
  const long long nt = (p.N + Tl::kBN - 1) / Tl::kBN;
  const int nch = (p.K + Tl::kKC - 1) / Tl::kKC;
  const int per = (nch + splits - 1) / splits;
  const long long ctas =
      mt * nt * p.groups *
      (kMode == kDW ? (Tl::kAllTaps ? 1LL : p.taps) * splits : 1);
  const long long waves = (ctas + sms - 1) / sms;
  long long cost =
      waves *
      (per * Cost<kMode, kWM, kN, kTerms>::chunk_clks(p.taps) + kCtaClks);
  if (splits > 1)      // partials written and read back, over the card
    cost += (long long)(splits + 1) * p.groups * p.taps * p.M * p.N * 4 /
                (29LL * sms) + kCtaClks;
  return cost;
}

// Whether a tile's columns stay inside the images (padded to kColAlign).
inline bool tile_fits(int tile, int N, bool all) {
  const int bn = tile_n(all, tile) * (2 / tile_wm(all, tile));
  return round_up(N, bn) <= round_up(N, kColAlign);
}

template <int kMode, int kTerms>
long long plan_cost_at(int tile, const Params& p, int sms, int splits) {
  constexpr bool A = all_taps(kMode, kTerms);
  switch (tile) {
    case 0:
      return plan_cost<kMode, tile_wm(A, 0), tile_n(A, 0), kTerms>(p, sms,
                                                                   splits);
    case 1:
      return plan_cost<kMode, tile_wm(A, 1), tile_n(A, 1), kTerms>(p, sms,
                                                                   splits);
    case 2:
      return plan_cost<kMode, tile_wm(A, 2), tile_n(A, 2), kTerms>(p, sms,
                                                                   splits);
    default:
      return plan_cost<kMode, tile_wm(A, 3), tile_n(A, 3), kTerms>(p, sms,
                                                                   splits);
  }
}

// The tile (index into kTiles, or kTilesAllTaps for the f32 mode's kDW)
// and splits of the least estimated cost; ties go to the lower index and
// fewer splits.
template <int kMode, int kTerms>
void plan(const Params& p, int sms, int* tile, int* splits) {
  constexpr bool A = all_taps(kMode, kTerms);
  long long best = -1;
  for (int t = 0; t < kNumTiles; ++t) {
    if (!tile_fits(t, p.N, A)) continue;
    const int kc = kMode == kDW ? 64 : 32;
    const int nch = (p.K + kc - 1) / kc;
    const int smax = kMode == kDW ? (nch < kMaxSplitK ? nch : kMaxSplitK)
                                  : 1;
    for (int s = 1; s <= smax; ++s) {
      const long long c = plan_cost_at<kMode, kTerms>(t, p, sms, s);
      if (best < 0 || c < best) {
        best = c;
        *tile = t;
        *splits = s;
      }
    }
  }
  if (forced_tile() >= 0 && tile_fits(forced_tile(), p.N, A))
    *tile = forced_tile();
  if (kMode == kDW && forced_splits() > 0) *splits = forced_splits();
}

// cuTensorMapEncodeTiled, looked up at run time (no link to libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                         cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      f = nullptr;
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// The tensor map of an activation image set: `groups` channel groups of
// `rows` image rows, terms `t` elements apart, groups `g` apart (0: one
// image for all `G` groups); the box {8, box_rows, box_groups, 3, 1}.
inline cudaError_t image_map(CUtensorMap* map, const bf16* img, int rows,
                             int groups, long long t, long long g, int G,
                             int box_rows, int box_groups) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dim[5] = {8, (cuuint64_t)rows, (cuuint64_t)groups, 3,
                             (cuuint64_t)(g ? G : 1)};
  const cuuint64_t stride[4] = {16, (cuuint64_t)rows * 16,
                                (cuuint64_t)t * 2,
                                (cuuint64_t)(g ? g : 3 * t) * 2};
  const cuuint32_t box[5] = {8, (cuuint32_t)box_rows,
                             (cuuint32_t)box_groups, 3, 1};
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5,
                const_cast<bf16*>(img), dim, stride, box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// A launch's tensor maps (the f32 mode; the bf16 mode has none).
template <int kMode, class Tl, int kTerms>
cudaError_t make_maps(const Params& p, MapsOf<kTerms>* maps) {
  if constexpr (kTerms == 1) {
    return cudaSuccess;
  } else {
    const int rows = act_rows(p.B, p.T);
    if constexpr (kMode == kDW) {
      const cudaError_t err =
          image_map(&maps->a, p.a, rows, act_groups(p.M), p.a_t, p.a_g,
                    p.groups, Tl::kKC + 2, Tl::kBM / 8);
      if (err != cudaSuccess) return err;
      return image_map(&maps->b, p.b, rows, act_groups(p.N), p.b_t, p.b_g,
                       p.groups, Tl::kKC, Tl::kBN / 8);
    } else {
      return image_map(&maps->a, p.a, rows, act_groups(p.K), p.a_t, p.a_g,
                       p.groups, Tl::kBM + 2, Tl::kKC / 8);
    }
  }
}

template <int kMode, int kWM, int kN, class O, int kTerms>
cudaError_t launch_tile(Params p, int sms, cudaStream_t stream) {
  using Tl = Tile<kMode, kWM, kN, kTerms>;
  const int nch = (p.K + Tl::kKC - 1) / Tl::kKC;
  p.chunks_per_split = (nch + p.splits - 1) / p.splits;
  const long long tiles =
      (long long)((p.M + Tl::kBM - 1) / Tl::kBM) *
      ((p.N + Tl::kBN - 1) / Tl::kBN) * p.groups *
      (kMode == kDW ? (Tl::kAllTaps ? 1LL : p.taps) * p.splits : 1);
  if (tiles > (1LL << 31) - 1) return cudaErrorInvalidValue;
  auto kernel = wgmma_gemm_kernel<kMode, kWM, kN, O, kTerms>;
  // the shared-memory opt-in, once per device (a CUDA call per launch
  // costs the host more than a small launch takes on the card)
  static unsigned long long opted = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !(opted >> dev & 1)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tl::kSmem);
    if (err != cudaSuccess) return err;
    if (dev < 64) opted |= 1ULL << dev;
  }
  MapsOf<kTerms> maps{};
  err = make_maps<kMode, Tl, kTerms>(p, &maps);
  if (err != cudaSuccess) return err;
  const int grid = (int)(tiles < sms ? tiles : sms);
  kernel<<<grid, kThreads, Tl::kSmem, stream>>>(p, (int)tiles, maps);
  return cudaGetLastError();
}

// Launch the GEMM pass p (p.splits set by the caller for kDW), then, for
// kDW with splits > 1, the fixed-order sum of its partials into p.out.
template <int kMode, class O, int kTerms>
cudaError_t launch(Params p, int tile, int sms, cudaStream_t stream) {
  constexpr bool A = all_taps(kMode, kTerms);
  if (tile < 0 || tile >= kNumTiles || !tile_fits(tile, p.N, A) ||
      p.splits < 1 || p.splits > kMaxSplitK)
    return cudaErrorInvalidValue;
  cudaError_t err;
  switch (tile) {
    case 0:
      err = launch_tile<kMode, tile_wm(A, 0), tile_n(A, 0), O, kTerms>(
          p, sms, stream);
      break;
    case 1:
      err = launch_tile<kMode, tile_wm(A, 1), tile_n(A, 1), O, kTerms>(
          p, sms, stream);
      break;
    case 2:
      err = launch_tile<kMode, tile_wm(A, 2), tile_n(A, 2), O, kTerms>(
          p, sms, stream);
      break;
    default:
      err = launch_tile<kMode, tile_wm(A, 3), tile_n(A, 3), O, kTerms>(
          p, sms, stream);
  }
  if (err != cudaSuccess || kMode != kDW || p.splits == 1) return err;
  const long long n = (long long)p.taps * p.M * p.N;
  const long long blocks = (p.groups * n + 255) / 256;
  split_sum_kernel<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0,
                     stream>>>(p.part, p.splits, p.groups, n,
                               static_cast<float*>(p.out), p.out_g);
  return cudaGetLastError();
}

// Whether rows of `width` elements from `p`, groups `g` elements apart,
// are read a 16-byte line (bf16) or two (f32) at a time.
template <class S>
inline bool vec_rows(const S* p, long long g, int width) {
  return width % 8 == 0 && g * (long long)sizeof(S) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The images of one launch of pack_kernel<S, kTerms>, added job by job.
template <class S, int kTerms>
struct Packer {
  static constexpr int kc = Depth<kTerms>::kConv;
  PackJobs<S> jobs{};
  Packer(int B, int T) {
    jobs.B = B;
    jobs.T = T;
  }
  void add(int kind, const S* src, long long src_g, int K, int N, int taps,
           int groups, bf16* img) {
    PackJob<S>& j = jobs.job[jobs.n++];
    j.src = src;
    j.src_g = src_g;
    j.img = img;
    j.kind = kind;
    j.K = K;
    j.N = N;
    const bool act = kind == kPackAct || kind == kPackPad;
    j.lines = (act ? act_elems(jobs.B, jobs.T, K)
                   : kind == kPackConv ? w_conv_elems(taps, K, N, kc)
                                       : w_convt_elems(taps, N, K, kc)) / 8;
    j.vec = src && vec_rows(src, src_g, kind == kPackConvT || act ? K : N);
    j.first = jobs.total;
    jobs.total += j.lines * groups;
  }
  cudaError_t launch(cudaStream_t stream) {
    const long long blocks = (jobs.total + 255) / 256;
    pack_kernel<S, kTerms>
        <<<(int)(blocks < 8192 ? blocks : 8192), 256, 0, stream>>>(jobs);
    return cudaGetLastError();
  }
};

}  // namespace k3
}  // namespace mixstage
