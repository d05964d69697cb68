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
// with f32 accumulation, as K1 in fused_decoder.cu), so both are bound by
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
// wgmma, TMA and fusing the column passes into the GEMMs' prologues and
// epilogues are left to later versions.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_common.cuh"
#include "tensor_core.cuh"

namespace {

using mixstage::round8;

constexpr int kL = 4;                 // conv layers
constexpr float kEps = 1e-5f, kSlope = 0.2f;
constexpr int kBK = 32;               // reduction depth of a staged chunk
constexpr int kStages = 4;            // chunks in the cp.async ring
constexpr int kColW = 32, kColLanes = 8;   // column pass: 32 channels x 8
constexpr int kSplitRows = 128;       // rows of a column-pass CTA, about
constexpr int kMaxSplits = 32;

enum Mode { kConv = 0, kConvT = 1, kDW = 2 };

struct Gemm {
  const float* a; long long a_g;      // operand A, per-group stride
  const float* b; long long b_g;      // operand B, per-group stride
  const float* bias; long long bias_g;   // may be null
  float* out; long long out_g;
  int M, N, R;        // output rows (kDW: taps * Jp), columns, reduction
  int J, Jp, taps, T, sign;   // J: width of the time-shifted operand,
                              // Jp = round8(J) its padded tap width
  int vec_a, vec_b;   // 16-byte copies allowed for A / B
};

__device__ __forceinline__ float leaky(float v) {
  return v >= 0.f ? v : kSlope * v;
}

// Shared-memory layout of one mode and tile.  A is staged row-major (frame
// rows, kBK reduction columns; stride 4 mod 8 words) except for kDW, where
// it is staged as it lies, frames x output rows (stride 8 mod 32); B is
// staged reduction-major (stride 8 mod 32) except for kConvT, whose
// weights are read transposed and staged n-major (stride 4 mod 8).  Each
// way the fragment loads of a warp hit 32 distinct banks.
template <int kMode, int BM, int BN>
struct Tile {
  static constexpr int kThreads = BM * BN / 32;    // a 32x32 block per warp
  static constexpr int kWarpsN = BN / 32;
  static constexpr bool kAT = kMode == kDW;
  static constexpr bool kBT = kMode == kConvT;
  static constexpr int kAStride = kAT ? BM + 8 : kBK + 4;
  static constexpr int kBStride = kBT ? kBK + 4 : BN + 8;
  static constexpr int kAWords = (kAT ? kBK : BM) * kAStride;
  static constexpr int kBWords = (kBT ? BN : kBK) * kBStride;
  static constexpr int kStageWords = kAWords + kBWords;
  static constexpr size_t kSmem = (size_t)kStages * kStageWords * 4;
  // quads (4 consecutive words) of one chunk each thread stages
  static constexpr int kQuadsA = BM * kBK / 4 / kThreads;
  static constexpr int kQuadsB = BN * kBK / 4 / kThreads;
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

// Copy the quad dst[0..3] = src[0..3] where `ok`, else zeros: one 16-byte
// copy when `vec` (the quad is all in or all out and 16-byte aligned), else
// four 4-byte ones, of which only the first `lim` (the words left in the
// row; 4 or more: all) copy and the rest write zeros.
__device__ __forceinline__ void copy_quad(float* dst, const float* src,
                                          bool ok, int lim, bool vec,
                                          const float* dummy) {
  if (vec) {
    mixstage::cp_async16(dst, ok ? src : dummy, ok ? 16 : 0);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool oke = ok && e < lim;
      mixstage::cp_async4(dst + e, oke ? src + e : dummy, oke ? 4 : 0);
    }
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
// index past the matrices read 0.
template <int kMode, int BM, int BN>
__global__ void __launch_bounds__(BM * BN / 32, 16384 / (BM * BN))
gemm_kernel(Gemm p) {
  using Tl = Tile<kMode, BM, BN>;
  constexpr int kThreads = Tl::kThreads;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN, grp = blockIdx.z;
  const float* a = p.a + grp * p.a_g;
  const float* b = p.b + grp * p.b_g;
  const bool vec_a = p.vec_a, vec_b = p.vec_b;
  const int half = p.taps / 2;

  // ---- A's staging positions
  // kConv / kConvT: quad q of the chunk's 32 reduction columns, rows
  // tid / 8 + i * (kThreads / 8).  kDW: quad of output rows m (fixed),
  // frame rows tid / (BM / 4) + i * (BN / 8) of the chunk.
  int a_row[Tl::kQuadsA], a_t[Tl::kQuadsA], a_base[Tl::kQuadsA];
  bool a_ok[Tl::kQuadsA];
  TapPos apos{0, 0};
  int dw_k = 0, dw_j = 0;
  bool dw_ok = false;
  if constexpr (kMode != kDW) {
    apos.init(4 * (tid & 7), p.Jp);
#pragma unroll
    for (int i = 0; i < Tl::kQuadsA; ++i) {
      a_row[i] = (tid >> 3) + i * (kThreads / 8);
      const int m = m0 + a_row[i];
      a_ok[i] = m < p.M;
      const int bb = a_ok[i] ? m / p.T : 0;
      a_t[i] = m - bb * p.T;
      a_base[i] = bb * p.T;
    }
  } else {
    const int m = m0 + 4 * (tid % (BM / 4));
    dw_k = m / p.Jp;
    dw_j = m - dw_k * p.Jp;
    dw_ok = m < p.M && dw_j < p.J;
#pragma unroll
    for (int i = 0; i < Tl::kQuadsA; ++i) {
      a_row[i] = tid / (BM / 4) + i * (BN / 8);     // frame r of chunk 0
      const int bb = a_row[i] / p.T;
      a_base[i] = bb;                                // sequence b
      a_t[i] = a_row[i] - bb * p.T;                  // frame t
    }
  }
  // ---- B's staging positions
  // kConv / kDW: quad of columns n, reduction rows tid / (BN / 4) +
  // i * (BM / 8).  kConvT: quad q of reduction columns (A's), n rows
  // tid / 8 + i * (kThreads / 8).
  int b_row[Tl::kQuadsB];
  TapPos bpos[Tl::kQuadsB];
  const int b_col = 4 * (tid % (BN / 4));
#pragma unroll
  for (int i = 0; i < Tl::kQuadsB; ++i) {
    if constexpr (kMode == kConvT) {
      b_row[i] = (tid >> 3) + i * (kThreads / 8);
    } else {
      b_row[i] = tid / (BN / 4) + i * (BM / 8);
      if constexpr (kMode == kConv) bpos[i].init(b_row[i], p.Jp);
    }
  }
  int r_chunk = 0;          // first reduction index of the next chunk staged

  const int nchunks = (p.R + kBK - 1) / kBK;
  auto stage = [&](int c) {
    if (c < nchunks) {
      float* As = smem + (c % kStages) * Tl::kStageWords;
      float* Bs = As + Tl::kAWords;
      if constexpr (kMode != kDW) {
        const int q = 4 * (tid & 7);
        const bool rok = r_chunk + q < p.R && apos.j < p.J;
        const int shift = p.sign * (apos.k - half);
        const float* src = a + apos.j;
#pragma unroll
        for (int i = 0; i < Tl::kQuadsA; ++i) {
          const int tt = a_t[i] + shift;
          const bool ok = rok && a_ok[i] && tt >= 0 && tt < p.T;
          copy_quad(As + a_row[i] * Tl::kAStride + q,
                    src + (long long)(a_base[i] + tt) * p.J, ok,
                    p.J - apos.j, vec_a, a);
        }
        if constexpr (kMode == kConvT) {
          const float* wsrc = b + (long long)apos.k * p.N * p.J + apos.j;
#pragma unroll
          for (int i = 0; i < Tl::kQuadsB; ++i) {
            const int n = n0 + b_row[i];
            copy_quad(Bs + b_row[i] * Tl::kBStride + q,
                      wsrc + (long long)n * p.J, rok && n < p.N,
                      p.J - apos.j, vec_b, b);
          }
        }
        apos.advance(p.Jp);
      } else {
        const int col = 4 * (tid % (BM / 4));
        const int shift = dw_k - half;
        const float* src = a + dw_j;
#pragma unroll
        for (int i = 0; i < Tl::kQuadsA; ++i) {
          const int tt = a_t[i] + shift;
          const bool ok = dw_ok && r_chunk + a_row[i] < p.R && tt >= 0 &&
                          tt < p.T;
          copy_quad(As + a_row[i] * Tl::kAStride + col,
                    src + ((long long)a_base[i] * p.T + tt) * p.J, ok,
                    p.J - dw_j, vec_a, a);
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
          copy_quad(Bs + b_row[i] * Tl::kBStride + b_col,
                    b + row * p.N + n, ok, p.N - n, vec_b, b);
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
    const float* As = smem + (c % kStages) * Tl::kStageWords;
    const float* Bs = As + Tl::kAWords;
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

  float* out = p.out + grp * p.out_g;
  const float* bias = p.bias ? p.bias + grp * p.bias_g : nullptr;
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
          if (n < p.N)
            out[row * p.N + n] =
                acc[i][j][2 * h + e] + (bias ? __ldg(bias + n) : 0.f);
        }
    }
}

// ---------------------------------------------------------------------------
// column passes
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

// Per-layer parameters of group g: mu/var/gamma/beta are (G, 4, C) arrays,
// already offset to the layer.
struct LayerParams {
  const float* mu; const float* var; const float* gamma; const float* beta;
};

// BatchNorm statistics of one layer, split by rows: for 32 columns of group
// blockIdx.y over this split's rows, sum c and c^2 into part (q = 0, 1).
// c is (G, rows, C).
__global__ void __launch_bounds__(kColW * kColLanes) bn_stats_kernel(
    const float* __restrict__ c, float* part, int rows, int C) {
  __shared__ float s[kColLanes][kColW];
  const int ch = blockIdx.x * kColW + threadIdx.x;
  const bool live = ch < C;
  const long long goff = (long long)blockIdx.y * rows * C;
  int lo, hi;
  split_rows(rows, lo, hi);
  float a = 0.f, q = 0.f;
  if (live)
    for (int n = lo + threadIdx.y; n < hi; n += kColLanes) {
      const float v = __ldg(c + goff + (long long)n * C + ch);
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
__global__ void __launch_bounds__(kColW * kColLanes) bn_act_kernel(
    const float* __restrict__ c, LayerParams lp, const float* part,
    float* mu_out, float* var_out, float* __restrict__ h, int rows, int C) {
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
  const float ga = __ldg(lp.gamma + pidx), be = __ldg(lp.beta + pidx);
  const long long goff = (long long)g * rows * C;
  int lo, hi;
  split_rows(rows, lo, hi);
  for (int n = lo + threadIdx.y; n < hi; n += kColLanes) {
    const long long i = goff + (long long)n * C + ch;
    h[i] = leaky((__ldg(c + i) - mu) * inv * ga + be);
  }
}

struct BnCoef {
  float mu, inv, ga, be;
  __device__ BnCoef(LayerParams lp, int pidx)
      : mu(__ldg(lp.mu + pidx)),
        inv(1.f / sqrtf(__ldg(lp.var + pidx) + kEps)),
        ga(__ldg(lp.gamma + pidx)),
        be(__ldg(lp.beta + pidx)) {}
};

// BatchNorm + leaky backward, first pass: over this split's rows of 32
// columns of group blockIdx.y, sum dpre = leaky'(pre) * dh (q = 0) and
// dpre * xhat (q = 1) into part.
__global__ void __launch_bounds__(kColW * kColLanes) bn_bwd_sums_kernel(
    const float* __restrict__ c, const float* __restrict__ dh,
    LayerParams lp, float* part, int rows, int C) {
  __shared__ float s[kColLanes][kColW];
  const int ch = blockIdx.x * kColW + threadIdx.x;
  const bool live = ch < C;
  const long long goff = (long long)blockIdx.y * rows * C;
  int lo, hi;
  split_rows(rows, lo, hi);
  float sdb = 0.f, sdg = 0.f;
  if (live) {
    const BnCoef k(lp, blockIdx.y * kL * C + ch);
    for (int n = lo + threadIdx.y; n < hi; n += kColLanes) {
      const long long i = goff + (long long)n * C + ch;
      const float xhat = (__ldg(c + i) - k.mu) * k.inv;
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
// of dc into part (q = 2).  With h_prev, also h_prev = leaky(BN(c_prev))
// over the same rows: the previous layer's activation, which the dW pass
// reads next.
__global__ void __launch_bounds__(kColW * kColLanes) bn_bwd_dc_kernel(
    const float* __restrict__ c, const float* __restrict__ dh,
    float* __restrict__ dc, LayerParams lp, float* part, float* dgamma,
    float* dbeta, int rows, int C, const float* __restrict__ c_prev,
    LayerParams lp_prev, float* __restrict__ h_prev) {
  __shared__ float s[kColLanes][kColW];
  const int ch = blockIdx.x * kColW + threadIdx.x;
  const bool live = ch < C;
  const int pidx = blockIdx.y * kL * C + ch;
  const long long goff = (long long)blockIdx.y * rows * C;
  int lo, hi;
  split_rows(rows, lo, hi);
  float scb = 0.f;
  if (live) {
    const BnCoef k(lp, pidx);
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
      const float xhat = (__ldg(c + i) - k.mu) * k.inv;
      const float d = __ldg(dh + i);
      const float dpre = xhat * k.ga + k.be >= 0.f ? d : kSlope * d;
      const float v = k.inv * (dpre * k.ga - mean_dx - xhat * mean_dxx);
      dc[i] = v;
      scb += v;
    }
    if (h_prev) {
      const BnCoef kp(lp_prev, pidx);
      for (int n = lo + threadIdx.y; n < hi; n += kColLanes) {
        const long long i = goff + (long long)n * C + ch;
        h_prev[i] = leaky((__ldg(c_prev + i) - kp.mu) * kp.inv * kp.ga +
                          kp.be);
      }
    }
  }
  scb = lane_sum(s, scb);
  if (live && threadIdx.y == 0) part_at(part, 2, C)[ch] = scb;
}

// The split's column sums of a (G, rows, F) into part (q = 2): the logits'
// bias gradient.
__global__ void __launch_bounds__(kColW * kColLanes) col_sum_kernel(
    const float* __restrict__ a, float* part, int rows, int F) {
  __shared__ float s[kColLanes][kColW];
  const int f = blockIdx.x * kColW + threadIdx.x;
  int lo, hi;
  split_rows(rows, lo, hi);
  float acc = 0.f;
  if (f < F)
    for (int n = lo + threadIdx.y; n < hi; n += kColLanes)
      acc += __ldg(a + ((long long)blockIdx.y * rows + n) * F + f);
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
  using Tl = Tile<kMode, BM, BN>;
  const cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<kMode, BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Tl::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, groups);
  gemm_kernel<kMode, BM, BN><<<grid, Tl::kThreads, Tl::kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <int kMode>
cudaError_t gemm(const Gemm& p, int groups, int sms, cudaStream_t stream) {
  switch (pick_tile(p.M, p.N, groups, sms)) {
    case 0: return launch_gemm<kMode, 128, 128>(p, groups, stream);
    case 1: return launch_gemm<kMode, 128, 64>(p, groups, stream);
    default: return launch_gemm<kMode, 64, 64>(p, groups, stream);
  }
}

// 16-byte copies need rows of a multiple of 4 words from 16-byte aligned
// bases, in every group.
bool vec_ok(const float* base, long long group_stride, int row_words) {
  return row_words % 4 == 0 && group_stride % 4 == 0 &&
         (reinterpret_cast<uintptr_t>(base) & 15) == 0;
}

// A conv (kConv) or transposed conv (kConvT, sign -1) over `rows` frames:
// J input channels (kConvT: the layer's output channels), `cols` outputs.
Gemm conv(int mode, const float* a, long long a_g, const float* w,
          long long w_g, const float* bias, long long bias_g, float* out,
          long long out_g, int rows, int cols, int J, int taps, int T,
          int sign) {
  const int Jp = round8(J);
  return Gemm{a, a_g, w, w_g, bias, bias_g, out, out_g, rows, cols,
              taps * Jp, J, Jp, taps, T, sign, vec_ok(a, a_g, J),
              vec_ok(w, w_g, mode == kConv ? cols : J)};
}

// The per-tap weight gradient: out (taps, J, cols) = the time-shifted a
// (rows frames x J)^T @ d (rows x cols).
Gemm dweight(const float* a, long long a_g, const float* d, long long d_g,
             float* out, long long out_g, int rows, int cols, int J,
             int taps, int T) {
  const int Jp = round8(J);
  return Gemm{a, a_g, d, d_g, nullptr, 0, out, out_g, taps * Jp, cols, rows,
              J, Jp, taps, T, 1, vec_ok(a, a_g, J), vec_ok(d, d_g, cols)};
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

// Floats of the scratch `h` both entry points take: one (G, B*T,
// max(C, C0)) activation (or layer 0's per-group dx partials) and the
// column passes' partial sums.
long long scratch_floats(int B, int T, int C0, int C, int F, int G) {
  const long long width = C > F ? C : F;
  return (long long)G * B * T * (C > C0 ? C : C0) +
         3LL * kMaxSplits * G * width;
}

#define MIXSTAGE_CHECK(expr)                        \
  do {                                              \
    const cudaError_t err_ = (expr);                \
    if (err_ != cudaSuccess) return (int)err_;      \
  } while (0)

}  // namespace

extern "C" {

// Floats of the scratch array `h` of the two entry points below.
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
    int C0, int C, int F, int G, void* stream_) {
  if (bad_dims(B, T, C0, C, F, G)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_;
  int sms, smem_limit;
  MIXSTAGE_CHECK(mixstage::card(&sms, &smem_limit));
  const int N = B * T, S = splits(N);
  const long long act = (long long)N * C;
  float* part = h + (long long)G * N * (C > C0 ? C : C0);
  for (int l = 0; l < kL; ++l) {
    const int cin = l == 0 ? C0 : C;
    const float* w = l == 0 ? w0 : wc + (long long)(l - 1) * G * 3 * C * C;
    float* c = cs + l * G * act;
    MIXSTAGE_CHECK(gemm<kConv>(
        conv(kConv, l == 0 ? x : h, l == 0 ? 0 : act, w, 3LL * cin * C,
             cb + l * C, kL * C, c, act, N, C, cin, 3, T, 1),
        G, sms, stream));
    bn_stats_kernel<<<col_grid(C, G, S), kColBlock, 0, stream>>>(c, part, N,
                                                                 C);
    MIXSTAGE_CHECK(cudaGetLastError());
    const LayerParams lp{nullptr, nullptr, gamma + l * C, beta + l * C};
    bn_act_kernel<<<col_grid(C, G, S), kColBlock, 0, stream>>>(
        c, lp, part, mu + l * C, var + l * C, h, N, C);
    MIXSTAGE_CHECK(cudaGetLastError());
  }
  MIXSTAGE_CHECK(gemm<kConv>(conv(kConv, h, act, wl, (long long)C * F, bl, F,
                                  out, (long long)N * F, N, F, C, 1, T, 1),
                             G, sms, stream));
  return 0;
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
    int G, void* stream_) {
  if (bad_dims(B, T, C0, C, F, G)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_;
  int sms, smem_limit;
  MIXSTAGE_CHECK(mixstage::card(&sms, &smem_limit));
  const int N = B * T, S = splits(N);
  const long long act = (long long)N * C;
  float* part = h + (long long)G * N * (C > C0 ? C : C0);
  auto params = [&](int l) {
    return LayerParams{mu + l * C, var + l * C, gamma + l * C, beta + l * C};
  };
  const int red_threads = 256;
  auto reduce = [&](int width, float* o, int out_g) {
    reduce_splits_kernel<<<(G * width + red_threads - 1) / red_threads,
                           red_threads, 0, stream>>>(part, S, G, width, o,
                                                     out_g);
    return cudaGetLastError();
  };
  // logits head: h3, dwl = h3^T dout, dbl = sum dout, dh = dout wl^T
  bn_act_kernel<<<col_grid(C, G, S), kColBlock, 0, stream>>>(
      cs + (kL - 1) * G * act, params(kL - 1), nullptr, nullptr, nullptr, h,
      N, C);
  MIXSTAGE_CHECK(cudaGetLastError());
  MIXSTAGE_CHECK(gemm<kDW>(dweight(h, act, dout, (long long)N * F, dwl,
                                   (long long)C * F, N, F, C, 1, T),
                           G, sms, stream));
  col_sum_kernel<<<col_grid(F, G, S), kColBlock, 0, stream>>>(dout, part, N,
                                                              F);
  MIXSTAGE_CHECK(cudaGetLastError());
  MIXSTAGE_CHECK(reduce(F, dbl, F));
  MIXSTAGE_CHECK(gemm<kConvT>(conv(kConvT, dout, (long long)N * F, wl,
                                   (long long)C * F, nullptr, 0, dh, act, N,
                                   C, F, 1, T, 1),
                              G, sms, stream));
  for (int l = kL - 1; l >= 0; --l) {
    const float* c = cs + l * G * act;
    bn_bwd_sums_kernel<<<col_grid(C, G, S), kColBlock, 0, stream>>>(
        c, dh, params(l), part, N, C);
    MIXSTAGE_CHECK(cudaGetLastError());
    // with the layer's input h_{l-1}, recomputed (l > 0)
    bn_bwd_dc_kernel<<<col_grid(C, G, S), kColBlock, 0, stream>>>(
        c, dh, dc, params(l), part, dgamma + l * C, dbeta + l * C, N, C,
        l > 0 ? cs + (l - 1) * G * act : nullptr, params(l > 0 ? l - 1 : 0),
        l > 0 ? h : nullptr);
    MIXSTAGE_CHECK(cudaGetLastError());
    MIXSTAGE_CHECK(reduce(C, dcb + l * C, kL * C));
    const int cin = l == 0 ? C0 : C;
    const long long wsz = 3LL * cin * C;
    float* dw = l == 0 ? dw0 : dwc + (long long)(l - 1) * G * wsz;
    const float* w = l == 0 ? w0 : wc + (long long)(l - 1) * G * wsz;
    MIXSTAGE_CHECK(gemm<kDW>(dweight(l == 0 ? x : h, l == 0 ? 0 : act, dc,
                                     act, dw, wsz, N, C, cin, 3, T),
                             G, sms, stream));
    // d(input): taps shifted back; layer 0 writes one dx partial per group
    // into h (free by now) and sums them in group order
    if (l > 0) {
      MIXSTAGE_CHECK(gemm<kConvT>(conv(kConvT, dc, act, w, wsz, nullptr, 0,
                                       dh, act, N, C, C, 3, T, -1),
                                  G, sms, stream));
    } else {
      const long long nx = (long long)N * C0;
      MIXSTAGE_CHECK(gemm<kConvT>(conv(kConvT, dc, act, w, wsz, nullptr, 0,
                                       h, nx, N, C0, C, 3, T, -1),
                                  G, sms, stream));
      const long long blocks = (nx + 255) / 256;
      group_sum_kernel<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0,
                         stream>>>(h, G, nx, dx);
      MIXSTAGE_CHECK(cudaGetLastError());
    }
  }
  return 0;
}

const char* mixstage_train_decoder_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
