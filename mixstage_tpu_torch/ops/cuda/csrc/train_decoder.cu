// Mix-StAGE mixture decoder, TRAINING forward and backward, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernels of mixstage_tpu/ops/pallas/train_decoder.py:
// _fwd_call (body _fwd_kernel / _fwd_group) and _bwd_call (body
// _bwd_kernel).  Per group g of G, with the input x shared by all groups:
//
//   c_l = conv3(h_{l-1}, w_l[g]) + cb[g, l]          h_{-1} = x (C0 wide)
//   mu_l, var_l = mean(c_l), mean(c_l^2) - mu_l^2    over all B*T rows, f32
//   h_l = leaky((c_l - mu_l) * rsqrt(var_l + eps) * gamma + beta)   l < 4
//   out[g] = h_3 @ wl[g] + bl[g]
//
// conv3 is a k=3 'same' conv with zero padding at each sequence's own two
// ends.  The forward saves c_l (cs) and mu/var; the backward recomputes h_l
// from them and walks back: the logits head (dwl, dbl, dh), then per layer
// leaky', dgamma, dbeta, the train-mode BN backward, dcb, the per-tap dW
// and d(input) with the taps shifted back; dx is summed over the groups.
//
// What bounds it: at the flagship bs32 shape (B*T = 2048 rows, G = 8,
// C0 = 266, C = 256, F = 96) the forward is 26.8 GFLOP and the backward
// 53.7 GFLOP of f32 multiply-adds against ~100-130 MB of HBM traffic.  The
// products run on the tensor cores in 3xTF32 (each f32 operand split into
// hi = tf32(v) and lo = tf32(v - hi); a product is lo*hi + hi*lo + hi*hi
// with f32 accumulation), so both are bound by
// operations at a third of the card's TF32 rate: 0.16 ms forward and 0.33
// ms backward on an H100 SXM.  The tensor cores' accumulation truncates:
// summed straight into one accumulator, a 2048- or 6144-deep product
// drifted by ~2e-5 of its size, enough to flip leaky units that lie near
// 0, so each 32-deep chunk's MMAs sum into a zeroed partial that is added
// to the accumulator in f32 (the gradients then sit ~1e-6 from the f32
// plain version's).  The TPU kernel holds a whole group's
// (B*T, C) layer in VMEM, which BatchNorm's batch statistics need; a
// Hopper CTA has 227 KB of shared memory and one such layer is 2 MB, so
// here the work is split into passes over device memory (L2 holds most of
// it at this size):
//   * GEMM passes (gemm_kernel): one kernel serves the three operand shapes
//     of the chain: the conv (rows = B*T frames, reduction over tap x input
//     channel, taps shifted inside each sequence and zero at its ends), the
//     transposed conv of the backward's d(input) (taps shifted back), and
//     the per-tap dW (rows = tap x input channel, reduction over the
//     frames).  Each tap's reduction is padded to a multiple of 8 with
//     zeros (C0 = 266 -> 272).  A CTA computes a 128x128, 128x64 or 64x64
//     output tile (the rule pick_tile: waves of CTAs times the tile's
//     area and its operand traffic), each warp a 32x32 block of
//     mma.sync.m16n8k8 fragments; both operands reach shared memory in
//     32-deep chunks through a 4-stage cp.async ring (tensor_core.cuh),
//     16-byte copies where rows allow, 4-byte ones else (C0 = 266), zeros
//     from a copy of size 0 for a tap that leaves its sequence and at every
//     ragged edge.  dW's A operand (frames x channels in memory) is staged
//     as it lies and read transposed: a row stride of 8 mod 32 words puts
//     those fragment loads on 32 distinct banks, as 4 mod 8 does for the
//     row-major ones.  Layer 0's dx sums the G groups: each group writes
//     its own partial and group_sum_kernel adds them in a fixed order.
//   * Column passes (BatchNorm's statistics and backward, the bias
//     gradients): each CTA owns 32 channels of one group over a split of
//     at most ~128 rows (up to 32 splits), writes per-split partial sums,
//     and the next pass reduces them over the splits in a fixed order, so
//     the card fills (1024 CTAs at bs32) and the results are the same from
//     run to run.  They also write the activation h_l that the next GEMM
//     reads, so the GEMMs load plain operands.
// Fusing the column passes into the GEMMs' prologues and epilogues is left
// to a later version.
//
// bf16 mode (the *_bf16 entry points): the TPU kernels' dtype=bfloat16
// function.  x, every weight, out, cs and dout are bf16; the GEMM passes
// run on wgmma (train_gemm_bf16.cuh: operands laid out in global memory
// as the images the ring holds, streamed by bulk copies into an mbarrier
// ring by a producer warp, exact bf16 products, f32 partials of a fixed
// depth, kDW's reduction split over the frames where that fills the card).
// One pack_kernel launch writes the images of x, dout and the weights; the
// bf16 column passes (bn_act_img_kernel, bn_bwd_dc_img_kernel) write the
// activations h and dc straight into theirs.  The forward rounds each
// conv's f32 sum to bf16 before the bias add and the sum again (flax's
// nn.Conv), stores cs in bf16, computes BatchNorm and leaky in f32 and
// rounds the activation; the logits are acc + bias rounded.  The backward
// reads the bf16 cs, rounds each recomputed activation and dc to bf16
// before they feed a product, keeps dh and every gradient in f32, and sums
// dcb before dc is rounded, as _bwd_kernel does.  At the bs32 shape it is
// bound by operations at the dense bf16 rate (0.027 ms forward and 0.054
// ms backward on an H100 SXM).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "launch_common.cuh"
#include "tensor_core.cuh"
#include "train_gemm_bf16.cuh"

namespace {

using mixstage::round8;
using mixstage::k3::bf16;
using mixstage::k3::kConv;
using mixstage::k3::kConvT;
using mixstage::k3::kDW;
using mixstage::k3::to;

constexpr int kL = 4;                 // conv layers
constexpr float kEps = 1e-5f, kSlope = 0.2f;
constexpr int kBK = 32;               // reduction depth of a staged chunk
constexpr int kStages = 4;            // chunks in the cp.async ring
constexpr int kColW = 32, kColLanes = 8;   // column pass: 32 channels x 8
constexpr int kSplitRows = 128;       // rows of a column-pass CTA, about
constexpr int kMaxSplits = 32;

// How a staged vector (16 bytes: 4 f32 or 8 bf16 values) is copied: one
// 16-byte cp.async, four 4-byte ones, or (bf16 rows of an odd width) value
// by value through registers.
enum Copy { kCopy2B = 0, kCopy4B = 1, kCopy16B = 2 };

// One f32 GEMM pass of gemm_kernel (element pointers untyped).
struct Gemm {
  const void* a; long long a_g;       // operand A, per-group stride
  const void* b; long long b_g;       // operand B, per-group stride
  const void* bias; long long bias_g;   // may be null
  void* out; long long out_g;
  int M, N, R;        // output rows (kDW: taps * Jp), columns, reduction
  int J, Jp, taps, T, sign;   // J: width of the time-shifted operand,
                              // Jp = round8(J) its padded tap width
  int copy_a, copy_b; // Copy modes of A / B
};

__device__ __forceinline__ float leaky(float v) {
  return v >= 0.f ? v : kSlope * v;
}

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(__ldg(p));
}

// Shared-memory layout of one mode and tile for elements E (float).  A is
// staged row-major (frame rows, kBK reduction columns) except for kDW,
// where it is staged as it lies, frames x output rows; B is staged
// reduction-major except for kConvT, whose weights are read transposed and
// staged n-major.  Row strides 4 mod 8 words (row-major) and 8 mod 32
// (transposed) put a warp's fragment loads on 32 distinct banks.
template <int kMode, int BM, int BN, class E>
struct Tile {
  static constexpr int kThreads = BM * BN / 32;    // a 32x32 block per warp
  static constexpr int kWarpsN = BN / 32;
  static constexpr bool kAT = kMode == kDW;
  static constexpr bool kBT = kMode == kConvT;
  static constexpr int kV = 16 / sizeof(E);        // elements per vector
  static constexpr int kVecs = kBK / kV;           // vectors per chunk row
  static constexpr int kPad = sizeof(E) == 4 ? 4 : 8;
  static constexpr int kAStride = kAT ? BM + 8 : kBK + kPad;
  static constexpr int kBStride = kBT ? kBK + kPad : BN + 8;
  static constexpr int kAElems = (kAT ? kBK : BM) * kAStride;
  static constexpr int kBElems = (kBT ? BN : kBK) * kBStride;
  static constexpr int kStageElems = kAElems + kBElems;
  static constexpr size_t kSmem = (size_t)kStages * kStageElems * sizeof(E);
  // vectors of one chunk each thread stages
  static constexpr int kQuadsA = BM * kBK / kV / kThreads;
  static constexpr int kQuadsB = BN * kBK / kV / kThreads;
};

// Position r = tap * Jp + j in a padded tap-by-channel reduction.
struct TapPos {
  int k, j;
  __device__ void init(int r, int Jp) {
    k = r / Jp;
    j = r - k * Jp;
  }
  __device__ void advance(int Jp) {
    j += kBK;
    while (j >= Jp) {
      j -= Jp;
      ++k;
    }
  }
};

// Copy the vector dst[0..kV) = src[0..kV) where `ok`, else zeros, by the
// Copy mode `mode`: 16 bytes at once (the vector is all in or all out and
// 16-byte aligned), 4-byte pieces of which only those below `lim` (the
// elements left in the row) copy and the rest write zeros, or (kCopy2B)
// value by value.
template <class E>
__device__ __forceinline__ void copy_vec(E* dst, const E* src, bool ok,
                                         int lim, int mode, const E* dummy) {
  constexpr int kV = 16 / sizeof(E), kPer = 4 / sizeof(E);
  if (mode == kCopy16B) {
    mixstage::cp_async16(dst, ok ? src : dummy, ok ? 16 : 0);
  } else if (sizeof(E) == 4 || mode == kCopy4B) {
#pragma unroll
    for (int e = 0; e < kV / kPer; ++e) {
      const bool oke = ok && e * kPer < lim;
      mixstage::cp_async4(dst + e * kPer, oke ? src + e * kPer : dummy,
                          oke ? 4 : 0);
    }
  } else {
#pragma unroll
    for (int e = 0; e < kV; ++e) dst[e] = ok && e < lim ? src[e] : to<E>(0.f);
  }
}

// The GEMM pass out[grp] = A[grp] @ B[grp] (+ bias) for group blockIdx.z:
//   kConv : A[m; k, j] = a[b, t + (k - taps/2), j] (m = b*T + t, frames),
//           B[k, j; n] = b[k][j][n]
//   kConvT: A as kConv with the taps shifted back (sign -1),
//           B[k, j; n] = b[k][n][j] (the weights transposed)
//   kDW   : A[k, j; r] = a[b, t + (k - taps/2), j] (r = b*T + t, frames;
//           output row m = k * Jp + j), B[r; n] = b[r][n]
// Taps that leave their own sequence, padded channels j >= J and every
// index past the matrices read 0.  f32 operands and output, 3xTF32 MMAs
// (the bf16 mode runs train_gemm_bf16.cuh's wgmma GEMM instead).
template <int kMode, int BM, int BN>
__global__ void __launch_bounds__(BM * BN / 32, 16384 / (BM * BN))
gemm_kernel(Gemm p) {
  using E = float;
  using O = float;
  using Tl = Tile<kMode, BM, BN, E>;
  constexpr int kThreads = Tl::kThreads, kV = Tl::kV, kVecs = Tl::kVecs;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* smem = reinterpret_cast<E*>(smem_raw);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN, grp = blockIdx.z;
  const E* a = static_cast<const E*>(p.a) + grp * p.a_g;
  const E* b = static_cast<const E*>(p.b) + grp * p.b_g;
  const int copy_a = p.copy_a, copy_b = p.copy_b;
  const int half = p.taps / 2;

  // ---- A's staging positions
  // kConv / kConvT: vector q of the chunk's 32 reduction columns, rows
  // tid / kVecs + i * (kThreads / kVecs).  kDW: vector of output rows m
  // (fixed), frame rows tid / (BM / kV) + i * (kThreads / (BM / kV)) of
  // the chunk.
  int a_row[Tl::kQuadsA], a_t[Tl::kQuadsA], a_base[Tl::kQuadsA];
  bool a_ok[Tl::kQuadsA];
  TapPos apos{0, 0};
  int dw_k = 0, dw_j = 0;
  bool dw_ok = false;
  if constexpr (kMode != kDW) {
    apos.init(kV * (tid % kVecs), p.Jp);
#pragma unroll
    for (int i = 0; i < Tl::kQuadsA; ++i) {
      a_row[i] = tid / kVecs + i * (kThreads / kVecs);
      const int m = m0 + a_row[i];
      a_ok[i] = m < p.M;
      const int bb = a_ok[i] ? m / p.T : 0;
      a_t[i] = m - bb * p.T;
      a_base[i] = bb * p.T;
    }
  } else {
    const int m = m0 + kV * (tid % (BM / kV));
    dw_k = m / p.Jp;
    dw_j = m - dw_k * p.Jp;
    dw_ok = m < p.M && dw_j < p.J;
#pragma unroll
    for (int i = 0; i < Tl::kQuadsA; ++i) {
      a_row[i] = tid / (BM / kV) + i * (kThreads / (BM / kV));  // frame r
      const int bb = a_row[i] / p.T;
      a_base[i] = bb;                                // sequence b
      a_t[i] = a_row[i] - bb * p.T;                  // frame t
    }
  }
  // ---- B's staging positions
  // kConv / kDW: vector of columns n, reduction rows tid / (BN / kV) +
  // i * (kThreads / (BN / kV)).  kConvT: vector q of reduction columns
  // (A's), n rows tid / kVecs + i * (kThreads / kVecs).
  int b_row[Tl::kQuadsB];
  TapPos bpos[Tl::kQuadsB];
  const int b_col = kV * (tid % (BN / kV));
#pragma unroll
  for (int i = 0; i < Tl::kQuadsB; ++i) {
    if constexpr (kMode == kConvT) {
      b_row[i] = tid / kVecs + i * (kThreads / kVecs);
    } else {
      b_row[i] = tid / (BN / kV) + i * (kThreads / (BN / kV));
      if constexpr (kMode == kConv) bpos[i].init(b_row[i], p.Jp);
    }
  }
  int r_chunk = 0;          // first reduction index of the next chunk staged

  const int nchunks = (p.R + kBK - 1) / kBK;
  auto stage = [&](int c) {
    if (c < nchunks) {
      E* As = smem + (c % kStages) * Tl::kStageElems;
      E* Bs = As + Tl::kAElems;
      if constexpr (kMode != kDW) {
        const int q = kV * (tid % kVecs);
        const bool rok = r_chunk + q < p.R && apos.j < p.J;
        const int shift = p.sign * (apos.k - half);
        const E* src = a + apos.j;
#pragma unroll
        for (int i = 0; i < Tl::kQuadsA; ++i) {
          const int tt = a_t[i] + shift;
          const bool ok = rok && a_ok[i] && tt >= 0 && tt < p.T;
          copy_vec(As + a_row[i] * Tl::kAStride + q,
                   src + (long long)(a_base[i] + tt) * p.J, ok,
                   p.J - apos.j, copy_a, a);
        }
        if constexpr (kMode == kConvT) {
          const E* wsrc = b + (long long)apos.k * p.N * p.J + apos.j;
#pragma unroll
          for (int i = 0; i < Tl::kQuadsB; ++i) {
            const int n = n0 + b_row[i];
            copy_vec(Bs + b_row[i] * Tl::kBStride + q,
                     wsrc + (long long)n * p.J, rok && n < p.N,
                     p.J - apos.j, copy_b, b);
          }
        }
        apos.advance(p.Jp);
      } else {
        const int col = kV * (tid % (BM / kV));
        const int shift = dw_k - half;
        const E* src = a + dw_j;
#pragma unroll
        for (int i = 0; i < Tl::kQuadsA; ++i) {
          const int tt = a_t[i] + shift;
          const bool ok = dw_ok && r_chunk + a_row[i] < p.R && tt >= 0 &&
                          tt < p.T;
          copy_vec(As + a_row[i] * Tl::kAStride + col,
                   src + ((long long)a_base[i] * p.T + tt) * p.J, ok,
                   p.J - dw_j, copy_a, a);
          a_t[i] += kBK;                     // the frame kBK rows on
          while (a_t[i] >= p.T) {
            a_t[i] -= p.T;
            ++a_base[i];
          }
        }
      }
      if constexpr (kMode != kConvT) {
        const int n = n0 + b_col;
#pragma unroll
        for (int i = 0; i < Tl::kQuadsB; ++i) {
          const int r = r_chunk + b_row[i];
          bool ok = r < p.R && n < p.N;
          long long row = r;
          if constexpr (kMode == kConv) {
            ok = ok && bpos[i].j < p.J;
            row = (long long)bpos[i].k * p.J + bpos[i].j;
            bpos[i].advance(p.Jp);
          }
          copy_vec(Bs + b_row[i] * Tl::kBStride + b_col, b + row * p.N + n,
                   ok, p.N - n, copy_b, b);
        }
      }
      r_chunk += kBK;
    }
    mixstage::cp_async_commit();          // an empty group keeps the count
  };

  // ---- the warp's 32x32 block: m-fragments i < 2, n-fragments j < 4
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int warp = tid >> 5;
  const int wm = 32 * (warp / Tl::kWarpsN), wn = 32 * (warp % Tl::kWarpsN);
  const bool live = m0 + wm < p.M && n0 + wn < p.N;
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) stage(s);
  for (int c = 0; c < nchunks; ++c) {
    mixstage::cp_async_wait<kStages - 2>();   // chunk c has landed ...
    __syncthreads();            // ... for every thread; chunk c-1 is done
    stage(c + kStages - 1);     // into chunk c-1's slot
    if (!live) continue;
    const E* As = smem + (c % kStages) * Tl::kStageElems;
    const E* Bs = As + Tl::kAElems;
    // the chunk's products sum into a zeroed partial, added to acc in f32:
    // an MMA's accumulation truncates, and into acc every truncation would
    // lose up to an ulp of acc (a bias over a 6144-deep sum); into the
    // partial it loses an ulp of a 32-deep sum
    float part[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 8) {
      uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = wm + 16 * i + g + 8 * (e & 1);
          const int k = ks + t + 4 * (e >> 1);
          const float v = Tl::kAT ? As[k * Tl::kAStride + m]
                                  : As[m * Tl::kAStride + k];
          mixstage::split_tf32(v, ah[i][e], al[i][e]);
        }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = wn + 8 * j + g;
          const int k = ks + t + 4 * e;
          const float v = Tl::kBT ? Bs[n * Tl::kBStride + k]
                                  : Bs[k * Tl::kBStride + n];
          mixstage::split_tf32(v, bh[j][e], bl[j][e]);
        }
      // the small terms first; each pass is 8 independent MMAs
#pragma unroll
      for (int pass = 0; pass < 3; ++pass)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mixstage::mma_tf32(part[i][j], pass == 0 ? al[i] : ah[i],
                               pass == 1 ? bl[j] : bh[j]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }
  mixstage::cp_async_wait<0>();           // only empty groups are left
  if (!live) return;

  O* out = static_cast<O*>(p.out) + grp * p.out_g;
  const E* bias =
      p.bias ? static_cast<const E*>(p.bias) + grp * p.bias_g : nullptr;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + 16 * i + g + 8 * h;
      if (m >= p.M) continue;
      long long row = m;
      if constexpr (kMode == kDW) {         // m = k * Jp + j -> (k, j)
        const int k = m / p.Jp, j = m - k * p.Jp;
        if (j >= p.J) continue;
        row = (long long)k * p.J + j;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + 8 * j + 2 * t + e;
          if (n < p.N) {
            const float v = acc[i][j][2 * h + e];
            out[row * p.N + n] = to<O>(v + (bias ? ld(bias + n) : 0.f));
          }
        }
    }
}

// ---------------------------------------------------------------------------
// column passes (E: the type of c, h, dc and dout; sums in f32)
// ---------------------------------------------------------------------------

// Sum of the 8 row lanes of a column, in a fixed order, into every lane.
__device__ __forceinline__ float lane_sum(float (*s)[kColW], float v) {
  s[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < kColLanes; ++i) total += s[i][threadIdx.x];
  __syncthreads();
  return total;
}

// Rows [lo, hi) of this CTA's split (blockIdx.z of gridDim.z).
__device__ __forceinline__ void split_rows(int rows, int& lo, int& hi) {
  const int per = (rows + gridDim.z - 1) / gridDim.z;
  lo = blockIdx.z * per;
  hi = min(rows, lo + per);
}

// Partial sums: part[((q * S + s) * G + g) * width + ch] for quantity q,
// split s of S = gridDim.z, group g of G = gridDim.y.
__device__ __forceinline__ float* part_at(float* part, int q, int width) {
  return part + (((long long)q * gridDim.z + blockIdx.z) * gridDim.y +
                 blockIdx.y) * width;
}

// Quantity q of channel ch, group blockIdx.y, summed over the splits in a
// fixed order.
__device__ __forceinline__ float splits_sum(const float* part, int q,
                                            int width, int ch) {
  float total = 0.f;
  for (int s = 0; s < (int)gridDim.z; ++s)
    total += __ldg(part + (((long long)q * gridDim.z + s) * gridDim.y +
                           blockIdx.y) * width + ch);
  return total;
}

// Where the bf16 mode's activations h and dc go: the GEMM's activation
// image (train_gemm_bf16.cuh), groups `g` elements apart, `rows` image
// rows a channel group; frame n = b T + t is image row 2 + b (T + 1) + t.
struct ActImg {
  long long g;
  int rows, T;
};

__device__ __forceinline__ long long img_at(ActImg im, int g, int n,
                                            int ch) {
  const int b = n / im.T, t = n - b * im.T;
  return g * im.g +
         ((long long)(ch >> 3) * im.rows + 2 + b * (im.T + 1) + t) * 8 +
         (ch & 7);
}

// Per-layer parameters of group g: mu/var (f32) and gamma/beta (E) are
// (G, 4, C) arrays, already offset to the layer.
template <class E>
struct LayerParams {
  const float* mu; const float* var; const E* gamma; const E* beta;
};

// BatchNorm statistics of one layer, split by rows: for 32 columns of group
// blockIdx.y over this split's rows, sum c and c^2 into part (q = 0, 1).
// c is (G, rows, C).
template <class E>
__global__ void __launch_bounds__(kColW * kColLanes) bn_stats_kernel(
    const E* __restrict__ c, float* part, int rows, int C) {
  __shared__ float s[kColLanes][kColW];
  const int ch = blockIdx.x * kColW + threadIdx.x;
  const bool live = ch < C;
  const long long goff = (long long)blockIdx.y * rows * C;
  int lo, hi;
  split_rows(rows, lo, hi);
  float a = 0.f, q = 0.f;
  if (live)
    for (int n = lo + threadIdx.y; n < hi; n += kColLanes) {
      const float v = ld(c + goff + (long long)n * C + ch);
      a += v;
      q += v * v;
    }
  a = lane_sum(s, a);
  q = lane_sum(s, q);
  if (live && threadIdx.y == 0) {
    part_at(part, 0, C)[ch] = a;
    part_at(part, 1, C)[ch] = q;
  }
}

// h = leaky(BN(c)) over this split's rows of 32 columns of group
// blockIdx.y.  With `part`, the statistics are bn_stats_kernel's sums
// (written to mu_out / var_out by split 0); else lp.mu / lp.var.
template <class E>
__global__ void __launch_bounds__(kColW * kColLanes) bn_act_kernel(
    const E* __restrict__ c, LayerParams<E> lp, const float* part,
    float* mu_out, float* var_out, E* __restrict__ h, int rows, int C) {
  const int ch = blockIdx.x * kColW + threadIdx.x, g = blockIdx.y;
  if (ch >= C) return;
  const int pidx = g * kL * C + ch;
  float mu, var;
  if (part) {
    mu = splits_sum(part, 0, C, ch) / rows;
    var = splits_sum(part, 1, C, ch) / rows - mu * mu;
    if (blockIdx.z == 0 && threadIdx.y == 0) {
      mu_out[pidx] = mu;
      var_out[pidx] = var;
    }
  } else {
    mu = __ldg(lp.mu + pidx);
    var = __ldg(lp.var + pidx);
  }
  const float inv = 1.f / sqrtf(var + kEps);
  const float ga = ld(lp.gamma + pidx), be = ld(lp.beta + pidx);
  const long long goff = (long long)g * rows * C;
  int lo, hi;
  split_rows(rows, lo, hi);
  for (int n = lo + threadIdx.y; n < hi; n += kColLanes) {
    const long long i = goff + (long long)n * C + ch;
    h[i] = to<E>(leaky((ld(c + i) - mu) * inv * ga + be));
  }
}

template <class E>
struct BnCoef {
  float mu, inv, ga, be;
  __device__ BnCoef(LayerParams<E> lp, int pidx)
      : mu(__ldg(lp.mu + pidx)),
        inv(1.f / sqrtf(__ldg(lp.var + pidx) + kEps)),
        ga(ld(lp.gamma + pidx)),
        be(ld(lp.beta + pidx)) {}
};

// BatchNorm + leaky backward, first pass: over this split's rows of 32
// columns of group blockIdx.y, sum dpre = leaky'(pre) * dh (q = 0) and
// dpre * xhat (q = 1) into part.
template <class E>
__global__ void __launch_bounds__(kColW * kColLanes) bn_bwd_sums_kernel(
    const E* __restrict__ c, const float* __restrict__ dh,
    LayerParams<E> lp, float* part, int rows, int C) {
  __shared__ float s[kColLanes][kColW];
  const int ch = blockIdx.x * kColW + threadIdx.x;
  const bool live = ch < C;
  const long long goff = (long long)blockIdx.y * rows * C;
  int lo, hi;
  split_rows(rows, lo, hi);
  float sdb = 0.f, sdg = 0.f;
  if (live) {
    const BnCoef<E> k(lp, blockIdx.y * kL * C + ch);
    for (int n = lo + threadIdx.y; n < hi; n += kColLanes) {
      const long long i = goff + (long long)n * C + ch;
      const float xhat = (ld(c + i) - k.mu) * k.inv;
      const float d = __ldg(dh + i);
      const float dpre = xhat * k.ga + k.be >= 0.f ? d : kSlope * d;
      sdb += dpre;
      sdg += dpre * xhat;
    }
  }
  sdb = lane_sum(s, sdb);
  sdg = lane_sum(s, sdg);
  if (live && threadIdx.y == 0) {
    part_at(part, 0, C)[ch] = sdb;
    part_at(part, 1, C)[ch] = sdg;
  }
}

// BatchNorm + leaky backward, second pass: dbeta, dgamma from the first
// pass's sums (split 0 writes them), then dc = inv * (dxhat - mean(dxhat)
// - xhat * mean(dxhat * xhat)) over this split's rows, and the split's sum
// of dc (before dc is stored as E) into part (q = 2).  With h_prev, also
// h_prev = leaky(BN(c_prev)) over the same rows: the previous layer's
// activation, which the dW pass reads next.
template <class E>
__global__ void __launch_bounds__(kColW * kColLanes) bn_bwd_dc_kernel(
    const E* __restrict__ c, const float* __restrict__ dh,
    E* __restrict__ dc, LayerParams<E> lp, float* part, float* dgamma,
    float* dbeta, int rows, int C, const E* __restrict__ c_prev,
    LayerParams<E> lp_prev, E* __restrict__ h_prev) {
  __shared__ float s[kColLanes][kColW];
  const int ch = blockIdx.x * kColW + threadIdx.x;
  const bool live = ch < C;
  const int pidx = blockIdx.y * kL * C + ch;
  const long long goff = (long long)blockIdx.y * rows * C;
  int lo, hi;
  split_rows(rows, lo, hi);
  float scb = 0.f;
  if (live) {
    const BnCoef<E> k(lp, pidx);
    const float sdb = splits_sum(part, 0, C, ch);
    const float sdg = splits_sum(part, 1, C, ch);
    if (blockIdx.z == 0 && threadIdx.y == 0) {
      dbeta[pidx] = sdb;
      dgamma[pidx] = sdg;
    }
    const float mean_dx = k.ga * sdb / rows;      // mean(dpre * gamma)
    const float mean_dxx = k.ga * sdg / rows;     // mean(dpre * gamma * xhat)
    for (int n = lo + threadIdx.y; n < hi; n += kColLanes) {
      const long long i = goff + (long long)n * C + ch;
      const float xhat = (ld(c + i) - k.mu) * k.inv;
      const float d = __ldg(dh + i);
      const float dpre = xhat * k.ga + k.be >= 0.f ? d : kSlope * d;
      const float v = k.inv * (dpre * k.ga - mean_dx - xhat * mean_dxx);
      dc[i] = to<E>(v);
      scb += v;
    }
    if (h_prev) {
      const BnCoef<E> kp(lp_prev, pidx);
      for (int n = lo + threadIdx.y; n < hi; n += kColLanes) {
        const long long i = goff + (long long)n * C + ch;
        h_prev[i] = to<E>(leaky((ld(c_prev + i) - kp.mu) * kp.inv * kp.ga +
                                kp.be));
      }
    }
  }
  scb = lane_sum(s, scb);
  if (live && threadIdx.y == 0) part_at(part, 2, C)[ch] = scb;
}

// ---------------------------------------------------------------------------
// bf16 mode: the column passes that write the GEMMs' activation images
// ---------------------------------------------------------------------------

// A CTA of kImgThreads owns 32 channels (kColW) of group blockIdx.y over
// the rows of split blockIdx.z; thread (warp w, lane l) takes the 8
// channels 8 (l % 4) of them and rows lo + 8 w + l / 4, + kImgRows, ...: a
// warp reads 8 rows x 64 contiguous bytes of its frame-layout inputs and
// writes 4 runs of 8 consecutive 16-byte image lines.
constexpr int kImgThreads = 256;
constexpr int kImgRows = kImgThreads / 4;

// 8 bf16 values of `p` from channel ch (zero at and past C) as floats.
__device__ __forceinline__ void load8(const bf16* p, int ch, int C,
                                      float (&v)[8]) {
  if ((C & 7) == 0) {
    const uint4 u = *reinterpret_cast<const uint4*>(p + ch);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[2 * e] = __uint_as_float(w[e] << 16);
      v[2 * e + 1] = __uint_as_float(w[e] & 0xFFFF0000u);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = ch + e < C ? __bfloat162float(p[ch + e]) : 0.f;
  }
}

// The image line of 8 values, rounded to bf16 (zero at and past C).
__device__ __forceinline__ void store8(bf16* line, int ch, int C,
                                       const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t lo = ch + 2 * e < C
        ? __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * e])) : 0u;
    const uint32_t hi = ch + 2 * e + 1 < C
        ? __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * e + 1])) : 0u;
    w[e] = lo | hi << 16;
  }
  *reinterpret_cast<uint4*>(line) = make_uint4(w[0], w[1], w[2], w[3]);
}

// bn_act_kernel's function in bf16 mode, h written as the image `im`.
__global__ void __launch_bounds__(kImgThreads) bn_act_img_kernel(
    const bf16* __restrict__ c, LayerParams<bf16> lp, const float* part,
    float* mu_out, float* var_out, bf16* __restrict__ h, int rows, int C,
    ActImg im) {
  __shared__ float4 coef[kColW];          // mu, inv, gamma, beta
  const int g = blockIdx.y, t = threadIdx.x;
  if (t < kColW) {
    const int ch = blockIdx.x * kColW + t;
    float4 k = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ch < C) {
      const int pidx = g * kL * C + ch;
      float mu, var;
      if (part) {
        mu = splits_sum(part, 0, C, ch) / rows;
        var = splits_sum(part, 1, C, ch) / rows - mu * mu;
        if (blockIdx.z == 0) {
          mu_out[pidx] = mu;
          var_out[pidx] = var;
        }
      } else {
        mu = __ldg(lp.mu + pidx);
        var = __ldg(lp.var + pidx);
      }
      k = make_float4(mu, 1.f / sqrtf(var + kEps), ld(lp.gamma + pidx),
                      ld(lp.beta + pidx));
    }
    coef[t] = k;
  }
  __syncthreads();
  const int lane = t & 31, gi = lane & 3;
  const int ch = blockIdx.x * kColW + 8 * gi;
  if (ch >= C) return;
  int lo, hi;
  split_rows(rows, lo, hi);
  const long long goff = (long long)g * rows * C;
  for (int n = lo + (t >> 5) * 8 + (lane >> 2); n < hi; n += kImgRows) {
    float v[8];
    load8(c + goff + (long long)n * C, ch, C, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float4 k = coef[8 * gi + e];
      v[e] = leaky((v[e] - k.x) * k.y * k.z + k.w);
    }
    store8(h + img_at(im, g, n, ch), ch, C, v);
  }
}

// bn_bwd_dc_kernel's function in bf16 mode, dc and h_prev written as the
// images `im`; the split's dc sums (dcb) reduced over the CTA's threads in
// a fixed order.
__global__ void __launch_bounds__(kImgThreads) bn_bwd_dc_img_kernel(
    const bf16* __restrict__ c, const float* __restrict__ dh,
    bf16* __restrict__ dc, LayerParams<bf16> lp, float* part, float* dgamma,
    float* dbeta, int rows, int C, const bf16* __restrict__ c_prev,
    LayerParams<bf16> lp_prev, bf16* __restrict__ h_prev, ActImg im) {
  __shared__ float4 coef[kColW], coefp[kColW];   // mu, inv, gamma, beta
  __shared__ float2 means[kColW];                // mean_dx, mean_dxx
  __shared__ float red[kImgThreads / 32][kColW];
  const int g = blockIdx.y, t = threadIdx.x;
  if (t < kColW) {
    const int ch = blockIdx.x * kColW + t;
    float4 k = make_float4(0.f, 0.f, 0.f, 0.f), kp = k;
    float2 m = make_float2(0.f, 0.f);
    if (ch < C) {
      const int pidx = g * kL * C + ch;
      const BnCoef<bf16> b(lp, pidx);
      const float sdb = splits_sum(part, 0, C, ch);
      const float sdg = splits_sum(part, 1, C, ch);
      if (blockIdx.z == 0) {
        dbeta[pidx] = sdb;
        dgamma[pidx] = sdg;
      }
      k = make_float4(b.mu, b.inv, b.ga, b.be);
      m = make_float2(b.ga * sdb / rows, b.ga * sdg / rows);
      if (h_prev) {
        const BnCoef<bf16> bp(lp_prev, pidx);
        kp = make_float4(bp.mu, bp.inv, bp.ga, bp.be);
      }
    }
    coef[t] = k;
    coefp[t] = kp;
    means[t] = m;
  }
  __syncthreads();
  const int lane = t & 31, warp = t >> 5, gi = lane & 3;
  const int ch = blockIdx.x * kColW + 8 * gi;
  int lo, hi;
  split_rows(rows, lo, hi);
  const long long goff = (long long)g * rows * C;
  float scb[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (ch < C) {
    for (int n = lo + warp * 8 + (lane >> 2); n < hi; n += kImgRows) {
      const long long i = goff + (long long)n * C;
      float x[8], v[8], d8[8];
      load8(c + i, ch, C, x);
      if ((C & 3) == 0 && ch + 8 <= C) {
        const float4* d4 = reinterpret_cast<const float4*>(dh + i + ch);
        const float4 lo = __ldg(d4), hi = __ldg(d4 + 1);
        d8[0] = lo.x; d8[1] = lo.y; d8[2] = lo.z; d8[3] = lo.w;
        d8[4] = hi.x; d8[5] = hi.y; d8[6] = hi.z; d8[7] = hi.w;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          d8[e] = ch + e < C ? __ldg(dh + i + ch + e) : 0.f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float4 k = coef[8 * gi + e];
        const float2 m = means[8 * gi + e];
        const float xhat = (x[e] - k.x) * k.y;
        const float d = d8[e];
        const float dpre = xhat * k.z + k.w >= 0.f ? d : kSlope * d;
        v[e] = ch + e < C ? k.y * (dpre * k.z - m.x - xhat * m.y) : 0.f;
        scb[e] += v[e];
      }
      store8(dc + img_at(im, g, n, ch), ch, C, v);
    }
    if (h_prev) {
      for (int n = lo + warp * 8 + (lane >> 2); n < hi; n += kImgRows) {
        float v[8];
        load8(c_prev + goff + (long long)n * C, ch, C, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float4 k = coefp[8 * gi + e];
          v[e] = leaky((v[e] - k.x) * k.y * k.z + k.w);
        }
        store8(h_prev + img_at(im, g, n, ch), ch, C, v);
      }
    }
  }
  // dcb: the lanes of one channel group (lane % 4) in a fixed order, then
  // the warps in order
#pragma unroll
  for (int e = 0; e < 8; ++e) {
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
      scb[e] += __shfl_xor_sync(0xffffffffu, scb[e], off);
  }
  if (lane < 4) {
#pragma unroll
    for (int e = 0; e < 8; ++e) red[warp][8 * lane + e] = scb[e];
  }
  __syncthreads();
  if (t < kColW && blockIdx.x * kColW + t < C) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kImgThreads / 32; ++w) total += red[w][t];
    part_at(part, 2, C)[blockIdx.x * kColW + t] = total;
  }
}

// The split's column sums of a (G, rows, F) into part (q = 2): the logits'
// bias gradient.
template <class E>
__global__ void __launch_bounds__(kColW * kColLanes) col_sum_kernel(
    const E* __restrict__ a, float* part, int rows, int F) {
  __shared__ float s[kColLanes][kColW];
  const int f = blockIdx.x * kColW + threadIdx.x;
  int lo, hi;
  split_rows(rows, lo, hi);
  float acc = 0.f;
  if (f < F)
    for (int n = lo + threadIdx.y; n < hi; n += kColLanes)
      acc += ld(a + ((long long)blockIdx.y * rows + n) * F + f);
  acc = lane_sum(s, acc);
  if (f < F && threadIdx.y == 0) part_at(part, 2, F)[f] = acc;
}

// out[g * out_g + ch] = sum over the S splits of quantity 2 of part (G
// groups of `width` channels), in split order.
__global__ void reduce_splits_kernel(const float* __restrict__ part, int S,
                                     int G, int width, float* out,
                                     int out_g) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= G * width) return;
  const int g = i / width, ch = i - g * width;
  float total = 0.f;
  for (int s = 0; s < S; ++s)
    total += __ldg(part + ((2LL * S + s) * G + g) * width + ch);
  out[(long long)g * out_g + ch] = total;
}

// out[i] = sum over the G groups of part[g * n + i], in group order.
__global__ void group_sum_kernel(const float* __restrict__ part, int G,
                                 long long n, float* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float total = 0.f;
    for (int g = 0; g < G; ++g) total += __ldg(part + g * n + i);
    out[i] = total;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// The GEMM tile: of 128x128, 128x64 and 64x64 (index 0, 1, 2), the one
// with the least estimated time, ceil(CTAs / SMs) x (its area + its
// operand rows' share, 8 * (BM + BN)): the CTAs of one SM share its
// tensor cores, so a wave's cost is the area its SMs cover; the larger
// tile wins a tie (fewer operand loads per product).
int pick_tile(int M, int N, int groups, int sms) {
  static const int kTiles[3][2] = {{128, 128}, {128, 64}, {64, 64}};
  int best = 0;
  long long best_cost = 0;
  for (int i = 0; i < 3; ++i) {
    const int bm = kTiles[i][0], bn = kTiles[i][1];
    const long long ctas =
        (long long)((M + bm - 1) / bm) * ((N + bn - 1) / bn) * groups;
    const long long cost =
        (ctas + sms - 1) / sms * ((long long)bm * bn + 8 * (bm + bn));
    if (i == 0 || cost < best_cost) {
      best = i;
      best_cost = cost;
    }
  }
  return best;
}

template <int kMode, int BM, int BN>
cudaError_t launch_gemm(const Gemm& p, int groups, cudaStream_t stream) {
  using Tl = Tile<kMode, BM, BN, float>;
  const cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<kMode, BM, BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tl::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, groups);
  gemm_kernel<kMode, BM, BN><<<grid, Tl::kThreads, Tl::kSmem, stream>>>(p);
  return cudaGetLastError();
}

// One f32 GEMM pass at pick_tile's tile.
template <int kMode>
cudaError_t gemm(const Gemm& p, int groups, int sms, cudaStream_t stream) {
  switch (pick_tile(p.M, p.N, groups, sms)) {
    case 0: return launch_gemm<kMode, 128, 128>(p, groups, stream);
    case 1: return launch_gemm<kMode, 128, 64>(p, groups, stream);
    default: return launch_gemm<kMode, 64, 64>(p, groups, stream);
  }
}

// How rows of `row_elems` elements E from `base`, groups `group_stride`
// elements apart, can be staged: 16-byte copies need every row start
// 16-byte aligned, 4-byte ones 4-byte aligned; else value by value.
template <class E>
int copy_mode(const E* base, long long group_stride, int row_elems) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(base);
  const long long row = (long long)row_elems * sizeof(E);
  const long long grp = group_stride * (long long)sizeof(E);
  if (row % 16 == 0 && grp % 16 == 0 && addr % 16 == 0) return kCopy16B;
  if (row % 4 == 0 && grp % 4 == 0 && addr % 4 == 0) return kCopy4B;
  return kCopy2B;
}

// A conv (kConv) or transposed conv (kConvT, sign -1) over `rows` frames:
// J input channels (kConvT: the layer's output channels), `cols` outputs.
template <class E>
Gemm conv(int mode, const E* a, long long a_g, const E* w, long long w_g,
          const E* bias, long long bias_g, void* out, long long out_g,
          int rows, int cols, int J, int taps, int T, int sign) {
  const int Jp = round8(J);
  return Gemm{a, a_g, w, w_g, bias, bias_g, out, out_g, rows, cols,
              taps * Jp, J, Jp, taps, T, sign, copy_mode(a, a_g, J),
              copy_mode(w, w_g, mode == kConv ? cols : J)};
}

// The per-tap weight gradient: out (taps, J, cols) = the time-shifted a
// (rows frames x J)^T @ d (rows x cols).
template <class E>
Gemm dweight(const E* a, long long a_g, const E* d, long long d_g,
             float* out, long long out_g, int rows, int cols, int J,
             int taps, int T) {
  const int Jp = round8(J);
  return Gemm{a, a_g, d, d_g, nullptr, 0, out, out_g, taps * Jp, cols, rows,
              J, Jp, taps, T, 1, copy_mode(a, a_g, J),
              copy_mode(d, d_g, cols)};
}

int splits(int rows) {
  const int s = (rows + kSplitRows - 1) / kSplitRows;
  return s < 1 ? 1 : (s > kMaxSplits ? kMaxSplits : s);
}

dim3 col_grid(int C, int G, int S) {
  return dim3((C + kColW - 1) / kColW, G, S);
}
const dim3 kColBlock(kColW, kColLanes);

bool bad_dims(int B, int T, int C0, int C, int F, int G) {
  return B <= 0 || T <= 0 || C0 <= 0 || C <= 0 || F <= 0 || G <= 0 ||
         G > 65535 || (long long)B * T > 64LL * 65535 || C0 > (1 << 20) ||
         C > (1 << 20) || F > (1 << 20);
}

// The bf16 mode's scratch, in bytes from its start (each region 256-byte
// aligned): the activation images of h (the activation the next GEMM
// reads), dc, x and dout, the weight images of w0, wc and wl (kConv ones
// in the forward, kConvT ones in the backward; train_gemm_bf16.cuh), then
// f32: the column passes' partial sums, the weight gradients' split-K
// partials and layer 0's per-group dx partials.
struct Bf16Scratch {
  long long h, dc, x, dout, w0, wc, wl, part, dw_part, dx_part, bytes;
  Bf16Scratch(int B, int T, int C0, int C, int F, int G) {
    namespace k3 = mixstage::k3;
    auto max = [](long long a, long long b) { return a > b ? a : b; };
    long long at = 0;
    auto take = [&](long long n) {
      const long long o = at;
      at += (n + 255) / 256 * 256;
      return o;
    };
    const long long width = C > F ? C : F;
    const long long conv = 3LL * (C > C0 ? C : C0) * C;
    h = take(2 * G * k3::act_elems(B, T, C));
    dc = take(2 * G * k3::act_elems(B, T, C));
    x = take(2 * k3::act_elems(B, T, C0));
    dout = take(2 * G * k3::act_elems(B, T, F));
    w0 = take(2 * G * max(k3::w_conv_elems(3, C0, C),
                          k3::w_convt_elems(3, C0, C)));
    wc = take(2 * 3 * G * max(k3::w_conv_elems(3, C, C),
                              k3::w_convt_elems(3, C, C)));
    wl = take(2 * G * max(k3::w_conv_elems(1, C, F),
                          k3::w_convt_elems(1, C, F)));
    part = take(4 * 3LL * kMaxSplits * G * width);
    dw_part = take(4LL * k3::kMaxSplitK * G * max(conv, (long long)C * F));
    dx_part = take(4LL * G * B * T * C0);
    bytes = at;
  }
};

// Floats of the scratch `h` both entry points take: f32 mode, one (G,
// B*T, max(C, C0)) activation (or layer 0's per-group dx partials) and the
// column passes' partial sums; bf16 mode, Bf16Scratch.
long long scratch_floats(int B, int T, int C0, int C, int F, int G) {
  const long long width = C > F ? C : F;
  const long long f32 = (long long)G * B * T * (C > C0 ? C : C0) +
                        3LL * kMaxSplits * G * width;
  const long long bf16 = (Bf16Scratch(B, T, C0, C, F, G).bytes + 3) / 4;
  return f32 > bf16 ? f32 : bf16;
}

#define MIXSTAGE_CHECK(expr)                        \
  do {                                              \
    const cudaError_t err_ = (expr);                \
    if (err_ != cudaSuccess) return (int)err_;      \
  } while (0)

// K3 forward, f32 mode (E = float); see the entry points.
template <class E>
int forward(const E* x, const E* w0, const E* wc, const E* cb,
            const E* gamma, const E* beta, const E* wl, const E* bl, E* out,
            E* cs, float* mu, float* var, float* scratch, int B, int T,
            int C0, int C, int F, int G, void* stream_) {
  if (bad_dims(B, T, C0, C, F, G)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_;
  int sms, smem_limit;
  MIXSTAGE_CHECK(mixstage::card(&sms, &smem_limit));
  const int N = B * T, S = splits(N);
  const long long act = (long long)N * C;
  E* h = reinterpret_cast<E*>(scratch);
  float* part = scratch + (long long)G * N * (C > C0 ? C : C0);
  for (int l = 0; l < kL; ++l) {
    const int cin = l == 0 ? C0 : C;
    const E* w = l == 0 ? w0 : wc + (long long)(l - 1) * G * 3 * C * C;
    E* c = cs + l * G * act;
    MIXSTAGE_CHECK((gemm<kConv>(
        conv(kConv, l == 0 ? x : h, l == 0 ? 0 : act, w, 3LL * cin * C,
             cb + l * C, kL * C, c, act, N, C, cin, 3, T, 1),
        G, sms, stream)));
    bn_stats_kernel<E><<<col_grid(C, G, S), kColBlock, 0, stream>>>(
        c, part, N, C);
    MIXSTAGE_CHECK(cudaGetLastError());
    const LayerParams<E> lp{nullptr, nullptr, gamma + l * C, beta + l * C};
    bn_act_kernel<E><<<col_grid(C, G, S), kColBlock, 0, stream>>>(
        c, lp, part, mu + l * C, var + l * C, h, N, C);
    MIXSTAGE_CHECK(cudaGetLastError());
  }
  MIXSTAGE_CHECK((gemm<kConv>(
      conv(kConv, h, act, wl, (long long)C * F, bl, F, out, (long long)N * F,
           N, F, C, 1, T, 1),
      G, sms, stream)));
  return 0;
}

// K3 backward, f32 mode (E = float); see the entry points.
template <class E>
int backward(const E* dout, const E* x, const E* cs, const float* mu,
             const float* var, const E* w0, const E* wc, const E* gamma,
             const E* beta, const E* wl, float* dx, float* dw0, float* dwc,
             float* dcb, float* dgamma, float* dbeta, float* dwl, float* dbl,
             float* scratch, float* dh, E* dc, int B, int T, int C0, int C,
             int F, int G, void* stream_) {
  if (bad_dims(B, T, C0, C, F, G)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_;
  int sms, smem_limit;
  MIXSTAGE_CHECK(mixstage::card(&sms, &smem_limit));
  const int N = B * T, S = splits(N);
  const long long act = (long long)N * C;
  E* h = reinterpret_cast<E*>(scratch);
  float* part = scratch + (long long)G * N * (C > C0 ? C : C0);
  auto params = [&](int l) {
    return LayerParams<E>{mu + l * C, var + l * C, gamma + l * C,
                          beta + l * C};
  };
  const int red_threads = 256;
  auto reduce = [&](int width, float* o, int out_g) {
    reduce_splits_kernel<<<(G * width + red_threads - 1) / red_threads,
                           red_threads, 0, stream>>>(part, S, G, width, o,
                                                     out_g);
    return cudaGetLastError();
  };
  // logits head: h3, dwl = h3^T dout, dbl = sum dout, dh = dout wl^T
  bn_act_kernel<E><<<col_grid(C, G, S), kColBlock, 0, stream>>>(
      cs + (kL - 1) * G * act, params(kL - 1), nullptr, nullptr, nullptr, h,
      N, C);
  MIXSTAGE_CHECK(cudaGetLastError());
  MIXSTAGE_CHECK((gemm<kDW>(
      dweight(h, act, dout, (long long)N * F, dwl, (long long)C * F, N, F, C,
              1, T),
      G, sms, stream)));
  col_sum_kernel<E><<<col_grid(F, G, S), kColBlock, 0, stream>>>(dout, part,
                                                                 N, F);
  MIXSTAGE_CHECK(cudaGetLastError());
  MIXSTAGE_CHECK(reduce(F, dbl, F));
  MIXSTAGE_CHECK((gemm<kConvT>(
      conv(kConvT, dout, (long long)N * F, wl, (long long)C * F,
           (const E*)nullptr, 0, dh, act, N, C, F, 1, T, 1),
      G, sms, stream)));
  for (int l = kL - 1; l >= 0; --l) {
    const E* c = cs + l * G * act;
    bn_bwd_sums_kernel<E><<<col_grid(C, G, S), kColBlock, 0, stream>>>(
        c, dh, params(l), part, N, C);
    MIXSTAGE_CHECK(cudaGetLastError());
    // with the layer's input h_{l-1}, recomputed (l > 0)
    bn_bwd_dc_kernel<E><<<col_grid(C, G, S), kColBlock, 0, stream>>>(
        c, dh, dc, params(l), part, dgamma + l * C, dbeta + l * C, N, C,
        l > 0 ? cs + (l - 1) * G * act : nullptr, params(l > 0 ? l - 1 : 0),
        l > 0 ? h : nullptr);
    MIXSTAGE_CHECK(cudaGetLastError());
    MIXSTAGE_CHECK(reduce(C, dcb + l * C, kL * C));
    const int cin = l == 0 ? C0 : C;
    const long long wsz = 3LL * cin * C;
    float* dw = l == 0 ? dw0 : dwc + (long long)(l - 1) * G * wsz;
    const E* w = l == 0 ? w0 : wc + (long long)(l - 1) * G * wsz;
    MIXSTAGE_CHECK((gemm<kDW>(
        dweight(l == 0 ? x : h, l == 0 ? 0 : act, dc, act, dw, wsz, N, C,
                cin, 3, T),
        G, sms, stream)));
    // d(input): taps shifted back; layer 0 writes one dx partial per group
    // into the scratch (free by now) and sums them in group order
    if (l > 0) {
      MIXSTAGE_CHECK((gemm<kConvT>(
          conv(kConvT, dc, act, w, wsz, (const E*)nullptr, 0, dh, act, N, C,
               C, 3, T, -1),
          G, sms, stream)));
    } else {
      const long long nx = (long long)N * C0;
      MIXSTAGE_CHECK((gemm<kConvT>(
          conv(kConvT, dc, act, w, wsz, (const E*)nullptr, 0, scratch, nx, N,
               C0, C, 3, T, -1),
          G, sms, stream)));
      const long long blocks = (nx + 255) / 256;
      group_sum_kernel<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0,
                         stream>>>(scratch, G, nx, dx);
      MIXSTAGE_CHECK(cudaGetLastError());
    }
  }
  return 0;
}

// One bf16 GEMM pass at k3::plan's tile and (kDW) splits.
template <int kMode, class O>
cudaError_t wgmma_pass(mixstage::k3::Params p, int sms,
                       cudaStream_t stream) {
  int tile = 0, splits = 1;
  mixstage::k3::plan<kMode>(p, sms, &tile, &splits);
  p.splits = splits;
  return mixstage::k3::launch<kMode, O>(p, tile, sms, stream);
}

// A bf16 GEMM pass over G groups of B x T frames; see k3::Params.
mixstage::k3::Params wgmma_params(const bf16* a, long long a_g,
                                  const bf16* b, long long b_g, void* out,
                                  long long out_g, int M, int N, int K,
                                  int taps, int sign, int B, int T, int G) {
  mixstage::k3::Params p{};
  p.a = a;
  p.a_g = a_g;
  p.b = b;
  p.b_g = b_g;
  p.out = out;
  p.out_g = out_g;
  p.M = M;
  p.N = N;
  p.K = K;
  p.taps = taps;
  p.sign = sign;
  p.T = T;
  p.B = B;
  p.groups = G;
  p.splits = 1;
  return p;
}

// K3 forward, bf16 mode; see the entry points.  The GEMMs read images:
// x's and the weights' packed first (one pack_kernel launch, which also
// zeroes h's padding), h's written by bn_act_kernel.
int forward_bf16(const bf16* x, const bf16* w0, const bf16* wc,
                 const bf16* cb, const bf16* gamma, const bf16* beta,
                 const bf16* wl, const bf16* bl, bf16* out, bf16* cs,
                 float* mu, float* var, float* scratch, int B, int T, int C0,
                 int C, int F, int G, void* stream_) {
  namespace k3 = mixstage::k3;
  if (bad_dims(B, T, C0, C, F, G)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_;
  int sms, smem_limit;
  MIXSTAGE_CHECK(mixstage::card(&sms, &smem_limit));
  const int N = B * T, S = splits(N), P = k3::padded_rows(B, T);
  const long long act = (long long)N * C;
  const Bf16Scratch at(B, T, C0, C, F, G);
  unsigned char* base = reinterpret_cast<unsigned char*>(scratch);
  bf16* h = reinterpret_cast<bf16*>(base + at.h);
  bf16* xi = reinterpret_cast<bf16*>(base + at.x);
  bf16* w0i = reinterpret_cast<bf16*>(base + at.w0);
  bf16* wci = reinterpret_cast<bf16*>(base + at.wc);
  bf16* wli = reinterpret_cast<bf16*>(base + at.wl);
  float* part = reinterpret_cast<float*>(base + at.part);
  const long long hg = k3::act_elems(B, T, C);
  const ActImg im{hg, k3::act_rows(B, T), T};
  const long long w0g = k3::w_conv_elems(3, C0, C);
  const long long wcg = k3::w_conv_elems(3, C, C);
  const long long wlg = k3::w_conv_elems(1, C, F);
  k3::Packer pk(B, T);
  pk.add(k3::kPackAct, x, 0, C0, 0, 0, 1, xi);
  pk.add(k3::kPackConv, w0, 3LL * C0 * C, C0, C, 3, G, w0i);
  pk.add(k3::kPackConv, wc, 3LL * C * C, C, C, 3, 3 * G, wci);
  pk.add(k3::kPackConv, wl, (long long)C * F, C, F, 1, G, wli);
  pk.add(k3::kPackPad, nullptr, 0, C, 0, 0, G, h);
  MIXSTAGE_CHECK(pk.launch(stream));
  for (int l = 0; l < kL; ++l) {
    bf16* c = cs + l * G * act;
    k3::Params p = wgmma_params(
        l == 0 ? xi : h, l == 0 ? 0 : hg,
        l == 0 ? w0i : wci + (long long)(l - 1) * G * wcg,
        l == 0 ? w0g : wcg, c, act, P, C, l == 0 ? C0 : C, 3, 1, B, T, G);
    p.bias = cb + l * C;
    p.bias_g = kL * C;
    p.round_acc = 1;
    MIXSTAGE_CHECK((wgmma_pass<k3::kConv, bf16>(p, sms, stream)));
    bn_stats_kernel<bf16><<<col_grid(C, G, S), kColBlock, 0, stream>>>(
        c, part, N, C);
    MIXSTAGE_CHECK(cudaGetLastError());
    const LayerParams<bf16> lp{nullptr, nullptr, gamma + l * C,
                               beta + l * C};
    bn_act_img_kernel<<<col_grid(C, G, S), kImgThreads, 0, stream>>>(
        c, lp, part, mu + l * C, var + l * C, h, N, C, im);
    MIXSTAGE_CHECK(cudaGetLastError());
  }
  k3::Params p = wgmma_params(h, hg, wli, wlg, out, (long long)N * F, P, F,
                              C, 1, 1, B, T, G);
  p.bias = bl;
  p.bias_g = F;
  return (int)wgmma_pass<k3::kConv, bf16>(p, sms, stream);
}

// K3 backward, bf16 mode; see the entry points.  As forward_bf16: x's,
// dout's and the weights' images packed first (kConvT ones), h's and dc's
// written by the column passes.
int backward_bf16(const bf16* dout, const bf16* x, const bf16* cs,
                  const float* mu, const float* var, const bf16* w0,
                  const bf16* wc, const bf16* gamma, const bf16* beta,
                  const bf16* wl, float* dx, float* dw0, float* dwc,
                  float* dcb, float* dgamma, float* dbeta, float* dwl,
                  float* dbl, float* scratch, float* dh, int B, int T,
                  int C0, int C, int F, int G, void* stream_) {
  namespace k3 = mixstage::k3;
  if (bad_dims(B, T, C0, C, F, G)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_;
  int sms, smem_limit;
  MIXSTAGE_CHECK(mixstage::card(&sms, &smem_limit));
  const int N = B * T, S = splits(N), P = k3::padded_rows(B, T);
  const long long act = (long long)N * C;
  const Bf16Scratch at(B, T, C0, C, F, G);
  unsigned char* base = reinterpret_cast<unsigned char*>(scratch);
  bf16* h = reinterpret_cast<bf16*>(base + at.h);
  bf16* dc = reinterpret_cast<bf16*>(base + at.dc);
  bf16* xi = reinterpret_cast<bf16*>(base + at.x);
  bf16* doi = reinterpret_cast<bf16*>(base + at.dout);
  bf16* w0i = reinterpret_cast<bf16*>(base + at.w0);
  bf16* wci = reinterpret_cast<bf16*>(base + at.wc);
  bf16* wli = reinterpret_cast<bf16*>(base + at.wl);
  float* part = reinterpret_cast<float*>(base + at.part);
  float* dw_part = reinterpret_cast<float*>(base + at.dw_part);
  float* dx_part = reinterpret_cast<float*>(base + at.dx_part);
  const long long hg = k3::act_elems(B, T, C);
  const ActImg im{hg, k3::act_rows(B, T), T};
  const long long w0g = k3::w_convt_elems(3, C0, C);
  const long long wcg = k3::w_convt_elems(3, C, C);
  const long long wlg = k3::w_convt_elems(1, C, F);
  // kConvT images: w (taps, N = the layer's input channels, K = its output
  // channels, reduced)
  k3::Packer pk(B, T);
  pk.add(k3::kPackAct, x, 0, C0, 0, 0, 1, xi);
  pk.add(k3::kPackAct, dout, (long long)N * F, F, 0, 0, G, doi);
  pk.add(k3::kPackConvT, w0, 3LL * C0 * C, C, C0, 3, G, w0i);
  pk.add(k3::kPackConvT, wc, 3LL * C * C, C, C, 3, 3 * G, wci);
  pk.add(k3::kPackConvT, wl, (long long)C * F, F, C, 1, G, wli);
  pk.add(k3::kPackPad, nullptr, 0, C, 0, 0, G, h);
  pk.add(k3::kPackPad, nullptr, 0, C, 0, 0, G, dc);
  MIXSTAGE_CHECK(pk.launch(stream));
  auto params = [&](int l) {
    return LayerParams<bf16>{mu + l * C, var + l * C, gamma + l * C,
                             beta + l * C};
  };
  const int red_threads = 256;
  auto reduce = [&](int width, float* o, int out_g) {
    reduce_splits_kernel<<<(G * width + red_threads - 1) / red_threads,
                           red_threads, 0, stream>>>(part, S, G, width, o,
                                                     out_g);
    return cudaGetLastError();
  };
  // logits head: h3, dwl = h3^T dout, dbl = sum dout, dh = dout wl^T
  bn_act_img_kernel<<<col_grid(C, G, S), kImgThreads, 0, stream>>>(
      cs + (kL - 1) * G * act, params(kL - 1), nullptr, nullptr, nullptr, h,
      N, C, im);
  MIXSTAGE_CHECK(cudaGetLastError());
  k3::Params p = wgmma_params(h, hg, doi, k3::act_elems(B, T, F), dwl,
                              (long long)C * F, C, F, P, 1, 1, B, T, G);
  p.part = dw_part;
  MIXSTAGE_CHECK((wgmma_pass<k3::kDW, float>(p, sms, stream)));
  col_sum_kernel<bf16><<<col_grid(F, G, S), kColBlock, 0, stream>>>(
      dout, part, N, F);
  MIXSTAGE_CHECK(cudaGetLastError());
  MIXSTAGE_CHECK(reduce(F, dbl, F));
  MIXSTAGE_CHECK((wgmma_pass<k3::kConvT, float>(
      wgmma_params(doi, k3::act_elems(B, T, F), wli, wlg, dh, act, P, C, F,
                   1, -1, B, T, G),
      sms, stream)));
  for (int l = kL - 1; l >= 0; --l) {
    const bf16* c = cs + l * G * act;
    bn_bwd_sums_kernel<bf16><<<col_grid(C, G, S), kColBlock, 0, stream>>>(
        c, dh, params(l), part, N, C);
    MIXSTAGE_CHECK(cudaGetLastError());
    // with the layer's input h_{l-1}, recomputed (l > 0)
    bn_bwd_dc_img_kernel<<<col_grid(C, G, S), kImgThreads, 0, stream>>>(
        c, dh, dc, params(l), part, dgamma + l * C, dbeta + l * C, N, C,
        l > 0 ? cs + (l - 1) * G * act : nullptr, params(l > 0 ? l - 1 : 0),
        l > 0 ? h : nullptr, im);
    MIXSTAGE_CHECK(cudaGetLastError());
    MIXSTAGE_CHECK(reduce(C, dcb + l * C, kL * C));
    const int cin = l == 0 ? C0 : C;
    const long long wsz = 3LL * cin * C;
    float* dw = l == 0 ? dw0 : dwc + (long long)(l - 1) * G * wsz;
    p = wgmma_params(l == 0 ? xi : h, l == 0 ? 0 : hg, dc, hg, dw, wsz, cin,
                     C, P, 3, 1, B, T, G);
    p.part = dw_part;
    MIXSTAGE_CHECK((wgmma_pass<k3::kDW, float>(p, sms, stream)));
    // d(input): taps shifted back; layer 0 writes one dx partial per group
    // and sums them in group order
    const long long nx = (long long)N * C0;
    MIXSTAGE_CHECK((wgmma_pass<k3::kConvT, float>(
        wgmma_params(dc, hg,
                     l == 0 ? w0i : wci + (long long)(l - 1) * G * wcg,
                     l == 0 ? w0g : wcg, l > 0 ? (void*)dh : (void*)dx_part,
                     l > 0 ? act : nx, P, cin, C, 3, -1, B, T, G),
        sms, stream)));
    if (l == 0) {
      const long long blocks = (nx + 255) / 256;
      group_sum_kernel<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0,
                         stream>>>(dx_part, G, nx, dx);
      MIXSTAGE_CHECK(cudaGetLastError());
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// Floats of the scratch array `h` of the entry points below.
long long mixstage_train_decoder_scratch_floats(int B, int T, int C0, int C,
                                                int F, int G) {
  return scratch_floats(B, T, C0, C, F, G);
}

// K3 forward on `stream`; returns the first cudaError_t (0 = success).
// All pointers are device pointers to contiguous float32 arrays:
//   x (B,T,C0); w0 (G,3,C0,C); wc (3,G,3,C,C); cb, gamma, beta (G,4,C);
//   wl (G,C,F); bl (G,1,F) -> out (G,B,T,F); cs (4,G,B,T,C); mu, var
//   (G,4,C); h is scratch of mixstage_train_decoder_scratch_floats floats.
int mixstage_train_decoder_fwd_f32(
    const float* x, const float* w0, const float* wc, const float* cb,
    const float* gamma, const float* beta, const float* wl, const float* bl,
    float* out, float* cs, float* mu, float* var, float* h, int B, int T,
    int C0, int C, int F, int G, void* stream) {
  return forward<float>(x, w0, wc, cb, gamma, beta, wl, bl, out, cs, mu, var,
                        h, B, T, C0, C, F, G, stream);
}

// The bf16 mode of the forward: as mixstage_train_decoder_fwd_f32 with x,
// every weight, out and cs bfloat16; mu, var and h float32.
int mixstage_train_decoder_fwd_bf16(
    const bf16* x, const bf16* w0, const bf16* wc, const bf16* cb,
    const bf16* gamma, const bf16* beta, const bf16* wl, const bf16* bl,
    bf16* out, bf16* cs, float* mu, float* var, float* h, int B, int T,
    int C0, int C, int F, int G, void* stream) {
  return forward_bf16(x, w0, wc, cb, gamma, beta, wl, bl, out, cs, mu, var,
                      h, B, T, C0, C, F, G, stream);
}

// K3 backward on `stream`; returns the first cudaError_t (0 = success).
// Inputs as for the forward plus dout (G,B,T,F) and the forward's cs, mu,
// var; outputs dx (B,T,C0) summed over the groups, dw0 (G,3,C0,C), dwc
// (3,G,3,C,C), dcb, dgamma, dbeta (G,4,C), dwl (G,C,F), dbl (G,1,F).
// h is scratch as for the forward; dh, dc (G,B,T,C) are scratch.
int mixstage_train_decoder_bwd_f32(
    const float* dout, const float* x, const float* cs, const float* mu,
    const float* var, const float* w0, const float* wc, const float* gamma,
    const float* beta, const float* wl, float* dx, float* dw0, float* dwc,
    float* dcb, float* dgamma, float* dbeta, float* dwl, float* dbl,
    float* h, float* dh, float* dc, int B, int T, int C0, int C, int F,
    int G, void* stream) {
  return backward<float>(dout, x, cs, mu, var, w0, wc, gamma, beta, wl, dx,
                         dw0, dwc, dcb, dgamma, dbeta, dwl, dbl, h, dh, dc,
                         B, T, C0, C, F, G, stream);
}

// The bf16 mode of the backward: dout, x, cs and the weights bfloat16;
// mu, var, every gradient, h and dh float32; dc is not used (the scratch
// h holds dc's image).
int mixstage_train_decoder_bwd_bf16(
    const bf16* dout, const bf16* x, const bf16* cs, const float* mu,
    const float* var, const bf16* w0, const bf16* wc, const bf16* gamma,
    const bf16* beta, const bf16* wl, float* dx, float* dw0, float* dwc,
    float* dcb, float* dgamma, float* dbeta, float* dwl, float* dbl,
    float* h, float* dh, bf16* dc, int B, int T, int C0, int C, int F,
    int G, void* stream) {
  (void)dc;      // the bf16 mode keeps dc as an image in h
  return backward_bf16(dout, x, cs, mu, var, w0, wc, gamma, beta, wl, dx,
                       dw0, dwc, dcb, dgamma, dbeta, dwl, dbl, h, dh, B, T,
                       C0, C, F, G, stream);
}

// The bf16 mode's GEMM plan (train_gemm_bf16.cuh) of one pass on a card of
// `sms` SMs: mode 0 (conv), 1 (transposed conv) or 2 (per-tap dW) over
// B x T frames, J reduced channels (dW: the output rows' channels), N
// output columns, `taps` taps, G groups; writes the tile (0: 128 x 128, 1:
// 64 x 256, 2: 64 x 192, 3: 64 x 96) and dW's splits of the frames.
void mixstage_train_decoder_bf16_plan(int mode, int B, int T, int J, int N,
                                      int taps, int G, int sms, int* tile,
                                      int* splits) {
  mixstage::k3::Params p{};
  const int rows = 1 + B * (T + 1);
  p.M = mode == kDW ? J : rows;
  p.K = mode == kDW ? rows : J;
  p.N = N;
  p.taps = taps;
  p.groups = G;
  switch (mode) {
    case kConv: mixstage::k3::plan<kConv>(p, sms, tile, splits); break;
    case kConvT: mixstage::k3::plan<kConvT>(p, sms, tile, splits); break;
    default: mixstage::k3::plan<kDW>(p, sms, tile, splits); break;
  }
}

// Force every later bf16 GEMM pass in this process onto `tile` (as above;
// -1: the plan's) and every dW pass onto `splits` (0: the plan's); for
// tools/profile_k1.py --sweep.
void mixstage_train_decoder_bf16_force(int tile, int splits) {
  mixstage::k3::forced_tile() = tile;
  mixstage::k3::forced_splits() = splits;
}

const char* mixstage_train_decoder_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
