// K3's bf16 GEMM passes for Hopper (sm_90a): the conv, transposed conv and
// per-tap weight gradient of the training decoder's bf16 mode
// (train_decoder.cu's *_bf16 entry points) on wgmma, fed by bulk
// asynchronous copies into an mbarrier ring by a warp-specialised producer.
//
// Replaces, in the bf16 mode, the GEMMs of the TPU kernels
// mixstage_tpu/ops/pallas/train_decoder.py::_fwd_call (the conv taps of
// _conv3_acc and the logits) and ::_bwd_call (dW, d(input), the head).
// Per group g (blockIdx.z), with frames f = b*T + t:
//   kConv : out[f, n] = sum_{k, j} a[b, t + (k - 1), j] * w[k, j, n]
//   kConvT: out[f, j] = sum_{k, n} a[b, t - (k - 1), n] * w[k, j, n]
//   kDW   : out[k, j, n] = sum_f a[b, t + (k - 1), j] * d[f, n]
// (one tap, k = 1, for the logits and the head), taps that leave their own
// sequence reading zero.
//
// Padded rows.  Every operand indexed by frames is kept in padded-row
// coordinates: p = 1 + b * (T + 1) + t, with a zero row at p = 0 and one
// after each sequence (t = T).  A tap is then a shift by one padded row,
// and a shift never crosses into another sequence: it reads a zero row.
// kConv / kConvT compute output rows in padded rows (the zero rows' outputs
// are not stored); kDW reduces over padded rows (d is zero there).
//
// Images.  Each operand lives in global memory as an image laid out like
// the ring's shared-memory image of it, [channel / 8][row][8 channels] of
// 16-byte lines, zero-padded to whole tiles and chunks (see "Images"
// below): the pack kernels write those of x, dout and the weights, the
// column passes of train_decoder.cu write h's and dc's.  So a chunk's
// operands are a few contiguous runs, each one cp.async.bulk that the copy
// engine completes on the stage's full mbarrier, whatever the widths (C0 =
// 266, odd F): no copy of the ring needs the producer's threads.  In
// shared memory the 8 rows of a wgmma core matrix are 8 consecutive
// lines, so one image serves both majors (wgmma.cuh): read K-major when
// its channels are the reduction (the conv's activations, kConvT's
// weights) and MN-major (imm-trans 1) when its rows are (the conv's
// weights, both kDW operands).  Rows of one channel group are contiguous,
// so a descriptor moved by 16 bytes is the operand shifted by one row: the
// three taps of a conv read one activation image (M-shifted, conv) or one
// image of a (K-shifted, kDW) at -16, 0 and +16 bytes.
//
// The pipeline.  A CTA is three warpgroups: two consumers, each issuing
// m64nNk16 wgmmas on a 64 x kN block of the CTA's tile (side by side in M
// for the 128 x 128 tile, in N for the 64-row ones), and a producer warp
// whose lanes issue each chunk's bulk copies after one expect-tx arrival.
// Consumers wait on the full barrier, issue the chunk's wgmmas as one
// committed straight-line group (no branch around a wgmma: ptxas
// serialises them behind divergent paths), wait for it, add it to the
// accumulator, and release the stage on its empty mbarrier.  A chunk is
// 64 reduced channels by every tap (conv modes; 192-deep for the 3 taps)
// or 128 padded rows (kDW).  The kernel is persistent: one CTA an SM, each
// walking its share of the tiles, so the producer fills the ring with the
// next tile's chunks while the consumers store the last one's.  A first
// version staged the operands from their frame layouts with cp.async by
// the producer warpgroup's 128 threads: the copies alone then took 89% of
// the kernel's time (tools/k3_bf16_variants.py), and more producer threads
// left ptxas compiling the whole kernel to fewer registers.
//
// Accuracy.  Each bf16 product is exact in f32, but the tensor cores'
// accumulation truncates, so each chunk's wgmmas sum into a zeroed partial
// (scale-d 0 on the first) added to the f32 accumulator: a partial covers
// 192 (conv, 3 taps), 64 (1 tap) or 128 (kDW) products.  The epilogue keeps
// K3's rounding points: kConv rounds the sum to bf16 before the bias
// (round_acc) and the sum again; the logits are acc + bias rounded; kConvT
// and kDW store f32.
//
// Split-K.  kDW's reduction runs over all B*T frames while its output is
// only taps x C_in x C_out a group, too few tiles to fill 132 SMs at small
// C.  Its padded rows may be split into S ranges (each range its own
// tiles), each writing an f32 partial; split_sum_kernel adds them in split
// order, so two launches give the same bits.  The plan (tile and S) comes
// from plan(): waves of CTAs times a CTA's chunks at the tensor-core rate
// plus its fixed cost, plus the partials' traffic (at ~29 bytes a clock an
// SM, L2's bandwidth spread over 132 SMs).
//
// What bounds it: at bs32 the GEMM passes do 26.8 (forward) and 53.7
// (backward) GFLOP, 0.027 and 0.054 ms at the dense bf16 rate.  Every tile
// streams its group's weights (or both kDW operands) from L2: a 64 x 256
// conv chunk is 107 KB for 3.1 M multiply-adds, so the ring's two stages
// wait on L2 (~40 GB/s an SM when all SMs pull) rather than on the tensor
// cores; the conv passes reach ~240 TFLOP/s (PERF.md).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"
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
// accumulators spilling, tools/k3_bf16_variants.py.)
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
//   kConv weights w (taps, K, N): [tap][chunk][n / 8][kKC rows of K][8],
//     chunks of K and N padded with zeros to w_conv_groups(N) groups;
//   kConvT weights w (taps, J, K): [tap][chunk][k / 8 in the chunk][J rows
//     padded to w_convt_rows(J)][8].
// The padding covers every tile and chunk, so every copy is whole.
constexpr int kKCConv = 64, kKCDW = 128;    // reduction depth of a chunk
constexpr int kRowAlign = 128;              // image rows: a multiple + 2
constexpr int kColAlign = 128;              // channels / N padded to this

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
__host__ __device__ inline int w_chunks(int K) {
  return (K + kKCConv - 1) / kKCConv;
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
__host__ __device__ inline long long w_conv_elems(int taps, int K, int N) {
  return (long long)taps * w_chunks(K) * w_conv_groups(N) * kKCConv * 8;
}
__host__ __device__ inline long long w_convt_elems(int taps, int J,
                                                   int K) {
  return (long long)taps * w_chunks(K) * kKCConv * w_convt_rows(J);
}

// One launch: the operands of a group are offset by blockIdx.z's group.
struct Params {
  const bf16* a; long long a_g;       // A: an activation image
  const bf16* b; long long b_g;       // B: a weight image (kDW: dc's)
  const bf16* bias; long long bias_g; // kConv only (may be null)
  void* out; long long out_g;         // bf16 (kConv) or f32
  float* part;                        // kDW with splits > 1: (S, G, taps *
                                      // M, N) f32 partials
  int M;       // kConv / kConvT: padded rows; kDW: C_in (J)
  int N;       // output columns
  int K;       // kConv / kConvT: reduced channels; kDW: padded rows
  int taps, sign, T, B, groups, round_acc;
  int splits, chunks_per_split;       // kDW: S, chunks of one split
};

// The frame of padded row p (see the top), or -1 for a zero row.
__host__ __device__ __forceinline__ long long frame_of(int p, int T, int B) {
  const int q = p - 1;
  if (q < 0) return -1;
  const int b = q / (T + 1), t = q - b * (T + 1);
  return t < T && b < B ? (long long)b * T + t : -1;
}

// The shared-memory plan of one instance: kWM consumer warpgroups along M
// (2: a 128-row tile, each warpgroup 64 rows by all kN columns; 1: a
// 64-row tile, the warpgroups side by side in N), wgmma width kN.
template <int kMode, int kWM, int kN>
struct Tile {
  static constexpr int kBM = 64 * kWM;
  static constexpr int kBN = kN * (2 / kWM);
  static constexpr bool kW = kMode == kDW;
  static constexpr int kKC = kW ? kKCDW : kKCConv; // reduction of a chunk
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
  static constexpr int kSlot =
      (kABytes + kBImages * kBTapBytes + 127) / 128 * 128;
  static constexpr int kStagesFit = (kSmemBudget - kBarBytes) / kSlot;
  static constexpr int kStages =
      kStagesFit < kMaxStages ? kStagesFit : kMaxStages;
  static constexpr size_t kSmem = kBarBytes + (size_t)kStages * kSlot;
  static_assert(kStages >= 2, "a ring needs two stages");
};

// The instances: (kWM, kN) -> tiles 128 x 128, 64 x 256, 64 x 192, 64 x 96.
constexpr int kTiles[][2] = {{2, 128}, {1, 128}, {1, 96}, {1, 48}};
constexpr int kNumTiles = 4;

// Copy i of chunk c (rows from m0, columns from n0) into `slot`: the
// A image's channel groups, then each tap's B image (kConvT: per reduced
// channel group); chunk_copies() of them, completing their bytes on `bar`.
template <int kMode, class Tl>
__device__ __forceinline__ int chunk_copies(int taps) {
  if constexpr (kMode == kDW) return Tl::kAGroups + Tl::kBGroups;
  if constexpr (kMode == kConv) return Tl::kAGroups + taps;
  return Tl::kAGroups + taps * Tl::kBGroups;
}

template <int kMode, class Tl>
__device__ __forceinline__ void chunk_copy(const Params& p, const bf16* a,
                                           const bf16* b,
                                           unsigned char* slot, int c,
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
    dst = slot + i * Tl::kAGroupBytes;
    bytes = Tl::kAGroupBytes;
  } else {
    const int j = i - Tl::kAGroups;
    unsigned char* bimg = slot + Tl::kABytes;
    if constexpr (kMode == kDW) {             // dc: one n group, kKC rows
      src = b + ((long long)(n0 / 8 + j) * rows + c * Tl::kKC + 1) * 8;
      dst = bimg + j * Tl::kBGroupBytes;
      bytes = Tl::kBGroupBytes;
    } else if constexpr (kMode == kConv) {    // tap j's [n / 8][kKC][8]
      src = b + (((long long)j * w_chunks(p.K) + c) * w_conv_groups(p.N) +
                 n0 / 8) * Tl::kKC * 8;
      dst = bimg + j * Tl::kBTapBytes;
      bytes = Tl::kBTapBytes;
    } else {                                  // tap k, reduced group cg
      const int k = j / Tl::kBGroups, cg = j - k * Tl::kBGroups;
      src = b + ((((long long)k * w_chunks(p.K) + c) * Tl::kBGroups + cg) *
                     w_convt_rows(p.N) + n0) * 8;
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
    id.tap = t % p.taps;
    t /= p.taps;
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

// Persistent: CTA blockIdx.x takes tiles blockIdx.x, + gridDim.x, ... of
// the launch's `tiles`; the producer runs on into the next tile's chunks
// while the consumers store the last one's.
template <int kMode, int kWM, int kN, class O>
__global__ void __launch_bounds__(kThreads, 1) wgmma_gemm_kernel(Params p,
                                                                 int tiles) {
  using Tl = Tile<kMode, kWM, kN>;
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
    const int copies = chunk_copies<kMode, Tl>(p.taps);
    const uint32_t bytes =
        Tl::kABytes + (kMode == kDW ? 1 : p.taps) * Tl::kBTapBytes;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const TileId id = tile_id<kMode, Tl>(p, t);
      const bf16* a = p.a + id.grp * p.a_g;
      const bf16* b = p.b + id.grp * p.b_g;
      for (int c = 0; c < id.nchunks; ++c) {
        sm90::mbar_wait(&empty[s], ph ^ 1);     // round 0 passes at once
        if (lane == 0) sm90::mbar_arrive_expect_tx(&full[s], bytes);
        __syncwarp();
        for (int i = lane; i < copies; i += 32)
          chunk_copy<kMode, Tl>(p, a, b, ring + (size_t)s * Tl::kSlot,
                                id.c_begin + c, id.m0, id.n0, i, &full[s]);
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
  const int w4 = warp & 3;
  const bool pairs = (p.N & 1) == 0;

  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const TileId id = tile_id<kMode, Tl>(p, t);
    if constexpr (kW)       // the reduction shifted by the tile's tap
      a_off = 8 * wm * Tl::kAGroupBytes + (p.taps == 3 ? id.tap : 1) * 16;
    float acc[kN / 2], part[kN / 2];
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;
    for (int c = 0; c < id.nchunks; ++c) {
      sm90::mbar_wait(&full[s], ph);
      const uint32_t slot = sm90::smem_u32(ring + (size_t)s * Tl::kSlot);
      const uint32_t a0 = slot + a_off, b0 = slot + Tl::kABytes + b_off;
      if (three) {
        mma_chunk<kN, TA, TB, 3, KS>(part, a0, b0, a_tap, b_tap, a_kk, b_kk,
                                     lbo_a, sbo_a, lbo_b, sbo_b);
      } else {
        mma_chunk<kN, TA, TB, 1, KS>(part, a0, b0, a_tap, b_tap, a_kk, b_kk,
                                     lbo_a, sbo_a, lbo_b, sbo_b);
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

    // ---- epilogue: register 4 j + e of the m64nNk16 accumulator is (row
    // 16 w + lane / 4 + 8 (e / 2), column 8 j + 2 (lane % 4) + e % 2); the
    // two columns of a pair go out in one store where N is even
    const int nb = id.n0 + wn * kN + 2 * (lane & 3);
    O* out = static_cast<O*>(p.out) + id.grp * p.out_g;
    const bf16* bias = p.bias ? p.bias + id.grp * p.bias_g : nullptr;
    if (kW && p.splits > 1) {
      out = reinterpret_cast<O*>(p.part) +
            ((long long)id.split * p.groups + id.grp) * p.taps * p.M * p.N;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = id.m0 + 64 * wm + 16 * w4 + (lane >> 2) + 8 * h;
      long long row;                     // output row, -1: none
      if constexpr (kW) {
        row = r < p.M ? (long long)id.tap * p.M + r : -1;
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
            if (p.round_acc)
              v[e] = __bfloat162float(__float2bfloat16_rn(v[e]));
            if (n + e < p.N)
              v[e] += bias ? __bfloat162float(bias[n + e]) : 0.f;
          }
        }
        if (pairs) {                     // n even, N even: n + 1 < N
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

// One image pack_kernel writes, `groups` groups of `lines` 16-byte lines:
//   kPackAct: the activation image of (frames x K) matrices src (group
//     stride src_g elements; 0: one matrix for every group);
//   kPackPad: the zeros of an activation image of K channels that a column
//     pass fills (its padding rows, and every line holding a channel past
//     K: the pass writes the channels below K later);
//   kPackConv: the kConv image of w (taps, K, N);
//   kPackConvT: the kConvT image of w (taps, N, K).
enum PackKind { kPackAct = 0, kPackPad = 1, kPackConv = 2, kPackConvT = 3 };

struct PackJob {
  const bf16* src;
  long long src_g;
  bf16* img;
  long long lines, first;  // lines a group; the job's first global line
  int kind, K, N;
  bool vec;                // src rows read a 16-byte line at a time
};

constexpr int kMaxPackJobs = 8;
struct PackJobs {
  PackJob job[kMaxPackJobs];
  int n, B, T;
  long long total;
};

// Every line of every job, one line a thread (grid-stride): the images the
// bf16 mode's GEMMs read, written in one launch.
__global__ void pack_kernel(PackJobs jobs) {
  for (long long l = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       l < jobs.total; l += (long long)gridDim.x * blockDim.x) {
    int j = 0;
    while (j + 1 < jobs.n && l >= jobs.job[j + 1].first) ++j;
    const PackJob& jb = jobs.job[j];
    const long long local = l - jb.first, g = local / jb.lines;
    int r = (int)(local - g * jb.lines);
    uint4 line;
    if (jb.kind == kPackAct || jb.kind == kPackPad) {
      const int rows = act_rows(jobs.B, jobs.T), cg = r / rows;
      const long long f = frame_of(r - cg * rows - 1, jobs.T, jobs.B);
      if (jb.kind == kPackPad) {
        if (f >= 0 && 8 * cg + 8 <= jb.K) continue;   // the pass's line
        line = make_uint4(0, 0, 0, 0);
      } else {
        line = line_of(jb.src + g * jb.src_g + (f < 0 ? 0 : f) * jb.K,
                       8 * cg, jb.K, f >= 0, jb.vec);
      }
    } else if (jb.kind == kPackConv) {   // r = ((k nc + c) ng + n8) KC + i
      const int nc = w_chunks(jb.K), ng = w_conv_groups(jb.N);
      const int i = r % kKCConv;
      r /= kKCConv;
      const int n8 = r % ng;
      r /= ng;
      const int c = r % nc, k = r / nc, row = c * kKCConv + i;
      const bool ok = row < jb.K;
      line = line_of(
          jb.src + g * jb.src_g + ((long long)k * jb.K + (ok ? row : 0)) * jb.N,
          8 * n8, jb.N, ok, jb.vec);
    } else {                       // r = ((k nc + c) KC / 8 + g8) J + j
      const int nc = w_chunks(jb.K), jr = w_convt_rows(jb.N);
      const int jj = r % jr;
      r /= jr;
      const int g8 = r % (kKCConv / 8);
      r /= kKCConv / 8;
      const int c = r % nc, k = r / nc;
      const bool ok = jj < jb.N;
      line = line_of(
          jb.src + g * jb.src_g + ((long long)k * jb.N + (ok ? jj : 0)) * jb.K,
          c * kKCConv + 8 * g8, jb.K, ok, jb.vec);
    }
    *reinterpret_cast<uint4*>(jb.img + local * 8) = line;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// A chunk's time on an SM, for plan(): its tensor-core clocks at the dense
// bf16 rate (~2048 multiply-adds a clock an SM) plus ~200 for its barriers.
template <int kMode, int kWM, int kN>
struct Cost {
  using Tl = Tile<kMode, kWM, kN>;
  static long long chunk_clks(int taps) {
    const int t = kMode == kDW ? 1 : taps;
    return (long long)t * Tl::kKC * Tl::kBM * Tl::kBN / 2048 + 200;
  }
};

// A CTA's fixed clocks: its launch, its ring's first fill, its epilogue.
constexpr long long kCtaClks = 3000;

// Forced plan (tools/profile_k1.py --sweep): tile index >= 0 and splits >
// 0 override plan()'s choice.
inline int& forced_tile() {
  static int t = -1;
  return t;
}
inline int& forced_splits() {
  static int s = 0;
  return s;
}

template <int kMode, int kWM, int kN>
long long plan_cost(const Params& p, int sms, int splits) {
  using Tl = Tile<kMode, kWM, kN>;
  const long long mt = (p.M + Tl::kBM - 1) / Tl::kBM;
  const long long nt = (p.N + Tl::kBN - 1) / Tl::kBN;
  const int nch = (p.K + Tl::kKC - 1) / Tl::kKC;
  const int per = (nch + splits - 1) / splits;
  const long long ctas =
      mt * nt * p.groups * (kMode == kDW ? (long long)p.taps * splits : 1);
  const long long waves = (ctas + sms - 1) / sms;
  long long cost =
      waves * (per * Cost<kMode, kWM, kN>::chunk_clks(p.taps) + kCtaClks);
  if (splits > 1)      // partials written and read back, over the card
    cost += (long long)(splits + 1) * p.groups * p.taps * p.M * p.N * 4 /
                (29LL * sms) + kCtaClks;
  return cost;
}

// Whether a tile's columns stay inside the images (padded to kColAlign).
inline bool tile_fits(int tile, int N) {
  const int bn = kTiles[tile][1] * (2 / kTiles[tile][0]);
  return round_up(N, bn) <= round_up(N, kColAlign);
}

template <int kMode>
long long plan_cost_at(int tile, const Params& p, int sms, int splits) {
  switch (tile) {
    case 0: return plan_cost<kMode, 2, 128>(p, sms, splits);
    case 1: return plan_cost<kMode, 1, 128>(p, sms, splits);
    case 2: return plan_cost<kMode, 1, 96>(p, sms, splits);
    default: return plan_cost<kMode, 1, 48>(p, sms, splits);
  }
}

// The tile (index into kTiles) and splits of the least estimated cost;
// ties go to the lower index and fewer splits.
template <int kMode>
void plan(const Params& p, int sms, int* tile, int* splits) {
  long long best = -1;
  for (int t = 0; t < kNumTiles; ++t) {
    if (!tile_fits(t, p.N)) continue;
    const int kc = kMode == kDW ? 64 : 32;
    const int nch = (p.K + kc - 1) / kc;
    const int smax = kMode == kDW ? (nch < kMaxSplitK ? nch : kMaxSplitK)
                                  : 1;
    for (int s = 1; s <= smax; ++s) {
      const long long c = plan_cost_at<kMode>(t, p, sms, s);
      if (best < 0 || c < best) {
        best = c;
        *tile = t;
        *splits = s;
      }
    }
  }
  if (forced_tile() >= 0 && tile_fits(forced_tile(), p.N))
    *tile = forced_tile();
  if (kMode == kDW && forced_splits() > 0) *splits = forced_splits();
}

template <int kMode, int kWM, int kN, class O>
cudaError_t launch_tile(Params p, int sms, cudaStream_t stream) {
  using Tl = Tile<kMode, kWM, kN>;
  const int nch = (p.K + Tl::kKC - 1) / Tl::kKC;
  p.chunks_per_split = (nch + p.splits - 1) / p.splits;
  const long long tiles =
      (long long)((p.M + Tl::kBM - 1) / Tl::kBM) *
      ((p.N + Tl::kBN - 1) / Tl::kBN) * p.groups *
      (kMode == kDW ? (long long)p.taps * p.splits : 1);
  if (tiles > (1LL << 31) - 1) return cudaErrorInvalidValue;
  auto kernel = wgmma_gemm_kernel<kMode, kWM, kN, O>;
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
  const int grid = (int)(tiles < sms ? tiles : sms);
  kernel<<<grid, kThreads, Tl::kSmem, stream>>>(p, (int)tiles);
  return cudaGetLastError();
}

// Launch the GEMM pass p (p.splits set by the caller for kDW), then, for
// kDW with splits > 1, the fixed-order sum of its partials into p.out.
template <int kMode, class O>
cudaError_t launch(Params p, int tile, int sms, cudaStream_t stream) {
  if (tile < 0 || tile >= kNumTiles || !tile_fits(tile, p.N) ||
      p.splits < 1 || p.splits > kMaxSplitK)
    return cudaErrorInvalidValue;
  cudaError_t err;
  switch (tile) {
    case 0: err = launch_tile<kMode, 2, 128, O>(p, sms, stream); break;
    case 1: err = launch_tile<kMode, 1, 128, O>(p, sms, stream); break;
    case 2: err = launch_tile<kMode, 1, 96, O>(p, sms, stream); break;
    default: err = launch_tile<kMode, 1, 48, O>(p, sms, stream); break;
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
// are read a 16-byte line at a time.
inline bool vec_rows(const bf16* p, long long g, int width) {
  return width % 8 == 0 && g % 8 == 0 &&
         reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The images of one launch of pack_kernel, added job by job.
struct Packer {
  PackJobs jobs{};
  Packer(int B, int T) {
    jobs.B = B;
    jobs.T = T;
  }
  void add(int kind, const bf16* src, long long src_g, int K, int N,
           int taps, int groups, bf16* img) {
    PackJob& j = jobs.job[jobs.n++];
    j.src = src;
    j.src_g = src_g;
    j.img = img;
    j.kind = kind;
    j.K = K;
    j.N = N;
    const bool act = kind == kPackAct || kind == kPackPad;
    j.lines = (act ? act_elems(jobs.B, jobs.T, K)
                   : kind == kPackConv ? w_conv_elems(taps, K, N)
                                       : w_convt_elems(taps, N, K)) / 8;
    j.vec = src && vec_rows(src, src_g, kind == kPackConvT || act ? K : N);
    j.first = jobs.total;
    jobs.total += j.lines * groups;
  }
  cudaError_t launch(cudaStream_t stream) {
    const long long blocks = (jobs.total + 255) / 256;
    pack_kernel<<<(int)(blocks < 8192 ? blocks : 8192), 256, 0, stream>>>(
        jobs);
    return cudaGetLastError();
  }
};

}  // namespace k3
}  // namespace mixstage
