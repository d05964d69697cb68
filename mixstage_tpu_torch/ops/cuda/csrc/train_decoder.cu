// Mix-StAGE mixture decoder, TRAINING forward and backward, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernels of mixstage_tpu/ops/pallas/train_decoder.py:
// _fwd_call (body _fwd_kernel / _fwd_group) and _bwd_call (body
// _bwd_kernel).  Per group g of G, with the input x shared by all groups:
//
//   c_l = conv3(h_{l-1}, w_l[g]) + cb[g, l]          h_{-1} = x (C0 wide)
//   mu_l, var_l = mean(c_l), mean(c_l^2) - mu_l^2    over all B*T rows
//                 (of every rank's batch under data parallelism), f32
//   h_l = leaky((c_l - mu_l) * rsqrt(var_l + eps) * gamma + beta)   l < 4
//   out[g] = h_3 @ wl[g] + bl[g]
//
// conv3 is a k=3 'same' conv with zero padding at each sequence's own two
// ends.  The forward saves c_l (cs) and mu/var; the backward recomputes h_l
// from them and walks back: the logits head (dwl, dbl, dh), then per layer
// leaky', dgamma, dbeta, the train-mode BN backward, dcb, the per-tap dW
// and d(input) with the taps shifted back; dx is summed over the groups.
//
// Two modes, one code path (forward<E>, backward<E>): f32 (E = float, the
// *_f32 entry points) and bf16 (E = bf16, *_bf16: the TPU kernels'
// dtype=bfloat16 function).  The TPU kernel holds a whole group's (B*T, C)
// layer in VMEM, which BatchNorm's batch statistics need; a Hopper CTA has
// 227 KB of shared memory and one such layer is 1-2 MB, so here the work
// is split into passes over device memory (L2 holds most of it at this
// size):
//   * GEMM passes (train_gemm_bf16.cuh): a persistent wgmma GEMM per
//     operand shape (the conv, the transposed conv of the backward's
//     d(input), the per-tap dW) on operands laid out in global memory as
//     the images its ring holds, streamed by bulk copies into an mbarrier
//     ring by a producer warp, f32 partials of a fixed depth, kDW's
//     reduction split over the frames where that fills the card.  One
//     pack_kernel launch per call writes the images of x, dout and the
//     weights (kConv ones in the forward, kConvT ones in the backward);
//     the image-writing column passes (bn_act_img_kernel,
//     bn_bwd_dc_img_kernel) write the activations h and dc straight into
//     theirs.  In the f32 mode every image holds each element as three
//     exact bf16 terms and every product is six bf16 products (the split
//     and its error: train_gemm_bf16.cuh); in the bf16 mode one term, one
//     product.  Layer 0's dx sums the G groups: each group writes its own
//     partial and group_sum_kernel adds them in a fixed order.
//   * Column passes (BatchNorm's statistics and backward, the bias
//     gradients): each CTA owns 32 channels of one group over a split of
//     at most ~128 rows (up to 32 splits), writes per-split partial sums,
//     and the next pass reduces them over the splits in a fixed order, so
//     the card fills (1024 CTAs at bs32) and the results are the same from
//     run to run.
// Fusing the column passes into the GEMMs' prologues and epilogues is left
// to a later version.
//
// Data parallelism.  BatchNorm's statistics are those of the data group's
// global batch, so each call is cut into stages at the statistics: the
// forward's conv pass writes each layer's local (G, 2, C) sums of c and
// c^2 (stats_reduce_kernel), the caller sums them over the ranks, and the
// next stage normalises with them; the backward does the same with the
// sums of dpre and dpre * xhat behind its two column means.  The gradients
// stay local (the caller averages them).  With one rank the sums are the
// local ones, reduced in the order the undivided kernel reduced them.
//
// Rounding.  The f32 mode stores f32 everywhere: cs, out, dh and every
// gradient; its products are f32-accurate (the six-product split).  The
// bf16 mode: x, every weight, out, cs and dout are bf16; the forward rounds
// each conv's f32 sum to bf16 before the bias add and the sum again (flax's
// nn.Conv), stores cs in bf16, computes BatchNorm and leaky in f32 and
// rounds the activation; the logits are acc + bias rounded.  Its backward
// reads the bf16 cs, rounds each recomputed activation and dc to bf16
// before they feed a product, keeps dh and every gradient in f32, and sums
// dcb before dc is rounded, as _bwd_kernel does.
//
// What bounds it: at the flagship bs32 shape (B*T = 2048 rows, G = 8,
// C0 = 266, C = 256, F = 96) the forward is 26.8 GFLOP and the backward
// 53.7 GFLOP of multiply-adds against ~100-130 MB of HBM traffic (f32),
// bound by operations: 0.16 / 0.33 ms as six bf16 products at the dense
// bf16 rate (f32 mode; the 3xTF32 route it replaced had the same bound at
// the TF32 rate), 0.027 / 0.054 ms as one (bf16 mode), on an H100 SXM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_common.cuh"
#include "train_gemm_bf16.cuh"

namespace {

using mixstage::k3::bf16;
using mixstage::k3::kConv;
using mixstage::k3::kConvT;
using mixstage::k3::kDW;

constexpr int kL = 4;                 // conv layers
constexpr float kEps = 1e-5f, kSlope = 0.2f;
constexpr int kColW = 32, kColLanes = 8;   // column pass: 32 channels x 8
constexpr int kSplitRows = 128;       // rows of a column-pass CTA, about
constexpr int kMaxSplits = 32;

// The bf16 terms of a mode's elements E: 3 for f32, 1 for bf16.
template <class E>
constexpr int kTermsOf = sizeof(E) == 4 ? 3 : 1;

__device__ __forceinline__ float leaky(float v) {
  return v >= 0.f ? v : kSlope * v;
}

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(__ldg(p));
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

// Where the activations h and dc go: the GEMM's activation image
// (train_gemm_bf16.cuh), groups `g` elements apart, terms (f32 mode) `t`
// apart, `rows` image rows a channel group; frame n = b T + t is image row
// 2 + b (T + 1) + t.
struct ActImg {
  long long g, t;
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

// ---------------------------------------------------------------------------
// the column passes that write the GEMMs' activation images
// ---------------------------------------------------------------------------

// A CTA of kImgThreads owns 32 channels (kColW) of group blockIdx.y over
// the rows of split blockIdx.z; thread (warp w, lane l) takes the 8
// channels 8 (l % 4) of them and rows lo + 8 w + l / 4, + kImgRows, ...: a
// warp reads 8 rows x 64 (f32: 128) contiguous bytes of its frame-layout
// inputs and writes 4 runs of 8 consecutive 16-byte image lines (a term).
constexpr int kImgThreads = 256;
constexpr int kImgRows = kImgThreads / 4;

// 8 values of `p` from channel ch (zero at and past C) as floats.
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

__device__ __forceinline__ void load8(const float* p, int ch, int C,
                                      float (&v)[8]) {
  if ((C & 7) == 0) {
    const float4 lo = *reinterpret_cast<const float4*>(p + ch);
    const float4 hi = *reinterpret_cast<const float4*>(p + ch + 4);
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = ch + e < C ? p[ch + e] : 0.f;
  }
}

// The image line of 8 values (zero at and past C) in the mode of kTerms
// terms: rounded to bf16 (1), or the three exact bf16 terms of each, term
// u's line `term` elements after `line` (3).
template <int kTerms>
__device__ __forceinline__ void store8(bf16* line, long long term, int ch,
                                       int C, const float (&v)[8]) {
  if constexpr (kTerms == 1) {
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
  } else {
    float z[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) z[e] = ch + e < C ? v[e] : 0.f;
    uint4 t[3];
    mixstage::k3::term_lines(z, t);
#pragma unroll
    for (int u = 0; u < 3; ++u)
      *reinterpret_cast<uint4*>(line + u * term) = t[u];
  }
}

// h = leaky(BN(c)) over this split's rows of 32 columns of group
// blockIdx.y, written as the image `im` (c is (G, rows, C)).  With
// `stats`, the statistics are the layer's (G, 2, C) sums of c and c^2
// over `count` rows (stats_reduce_kernel's, summed over the data group by
// the caller between the stages; written to mu_out / var_out by split 0);
// else lp.mu / lp.var.
template <class E>
__global__ void __launch_bounds__(kImgThreads) bn_act_img_kernel(
    const E* __restrict__ c, LayerParams<E> lp, const float* stats,
    float count, float* mu_out, float* var_out, bf16* __restrict__ h,
    int rows, int C, ActImg im) {
  __shared__ float4 coef[kColW];          // mu, inv, gamma, beta
  const int g = blockIdx.y, t = threadIdx.x;
  if (t < kColW) {
    const int ch = blockIdx.x * kColW + t;
    float4 k = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ch < C) {
      const int pidx = g * kL * C + ch;
      float mu, var;
      if (stats) {
        mu = __ldg(stats + (2LL * g) * C + ch) / count;
        var = __ldg(stats + (2LL * g + 1) * C + ch) / count - mu * mu;
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
    store8<kTermsOf<E>>(h + img_at(im, g, n, ch), im.t, ch, C, v);
  }
}

// BatchNorm + leaky backward, second pass: dc = inv * (dxhat -
// mean(dxhat) - xhat * mean(dxhat * xhat)) over this split's rows, the
// means from the layer's (G, 2, C) sums of dpre and dpre * xhat over
// `count` rows (stats_reduce_kernel's, summed over the data group by the
// caller between the stages), written as the image `im`, and the split's
// sum of dc (before dc is rounded or split) into part (q = 2), reduced
// over the CTA's threads in a fixed order.  With h_prev, also h_prev =
// leaky(BN(c_prev)) over the same rows, as the image `im`: the previous
// layer's activation, which the dW pass reads next.
template <class E>
__global__ void __launch_bounds__(kImgThreads) bn_bwd_dc_img_kernel(
    const E* __restrict__ c, const float* __restrict__ dh,
    bf16* __restrict__ dc, LayerParams<E> lp, float* part,
    const float* __restrict__ stats, float count, int rows, int C,
    const E* __restrict__ c_prev, LayerParams<E> lp_prev,
    bf16* __restrict__ h_prev, ActImg im) {
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
      const BnCoef<E> b(lp, pidx);
      const float sdb = __ldg(stats + (2LL * g) * C + ch);
      const float sdg = __ldg(stats + (2LL * g + 1) * C + ch);
      k = make_float4(b.mu, b.inv, b.ga, b.be);
      m = make_float2(b.ga * sdb / count, b.ga * sdg / count);
      if (h_prev) {
        const BnCoef<E> bp(lp_prev, pidx);
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
      store8<kTermsOf<E>>(dc + img_at(im, g, n, ch), im.t, ch, C, v);
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
        store8<kTermsOf<E>>(h_prev + img_at(im, g, n, ch), im.t, ch, C,
                                  v);
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

// The exchange buffer of one layer: stats[(2 g + q) C + ch] = the sum
// over the S splits of quantity q (0, 1) of part, in split order; with
// q0 / q1, also written there ((G, 4, C) arrays offset to the layer: the
// backward's local dbeta and dgamma).
__global__ void stats_reduce_kernel(const float* __restrict__ part, int S,
                                    int G, int C, float* stats, float* q0,
                                    float* q1) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= G * C) return;
  const int g = i / C, ch = i - g * C;
  float total[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    float acc = 0.f;
    for (int s = 0; s < S; ++s)
      acc += __ldg(part + (((long long)q * S + s) * G + g) * C + ch);
    total[q] = acc;
    stats[(2LL * g + q) * C + ch] = acc;
  }
  if (q0) {
    q0[(long long)g * kL * C + ch] = total[0];
    q1[(long long)g * kL * C + ch] = total[1];
  }
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

// The scratch of the mode of `terms` bf16 terms, in bytes from its start
// (each region 256-byte aligned): the activation images of h (the
// activation the next GEMM reads), dc, x and dout, the weight images of
// w0, wc and wl (kConv ones in the forward, kConvT ones in the backward;
// train_gemm_bf16.cuh), each `terms` images a group, then f32: the column
// passes' partial sums, the weight gradients' split-K partials, layer
// 0's per-group dx partials and the (kL, G, 2, C) statistics of the
// monolithic entry points.
struct ImgScratch {
  long long h, dc, x, dout, w0, wc, wl, part, dw_part, dx_part, stats, bytes;
  ImgScratch(int B, int T, int C0, int C, int F, int G, int terms) {
    namespace k3 = mixstage::k3;
    auto max = [](long long a, long long b) { return a > b ? a : b; };
    long long at = 0;
    auto take = [&](long long n) {
      const long long o = at;
      at += (n + 255) / 256 * 256;
      return o;
    };
    const int kc = terms == 1 ? k3::kKCConv : k3::kKCConvF32;
    const long long img = 2LL * terms;        // bytes of an element's terms
    const long long width = C > F ? C : F;
    const long long conv = 3LL * (C > C0 ? C : C0) * C;
    h = take(img * G * k3::act_elems(B, T, C));
    dc = take(img * G * k3::act_elems(B, T, C));
    x = take(img * k3::act_elems(B, T, C0));
    dout = take(img * G * k3::act_elems(B, T, F));
    w0 = take(img * G * max(k3::w_conv_elems(3, C0, C, kc),
                            k3::w_convt_elems(3, C0, C, kc)));
    wc = take(img * 3 * G * max(k3::w_conv_elems(3, C, C, kc),
                                k3::w_convt_elems(3, C, C, kc)));
    wl = take(img * G * max(k3::w_conv_elems(1, C, F, kc),
                            k3::w_convt_elems(1, C, F, kc)));
    part = take(4 * 3LL * kMaxSplits * G * width);
    dw_part = take(4LL * k3::kMaxSplitK * G * max(conv, (long long)C * F));
    dx_part = take(4LL * G * B * T * C0);
    stats = take(4LL * kL * 2 * G * C);
    bytes = at;
  }
};

// Floats of the scratch `h` both entry points take, in either mode.
long long scratch_floats(int B, int T, int C0, int C, int F, int G) {
  const long long f32 = ImgScratch(B, T, C0, C, F, G, 3).bytes;
  const long long bf16 = ImgScratch(B, T, C0, C, F, G, 1).bytes;
  return ((f32 > bf16 ? f32 : bf16) + 3) / 4;
}

#define MIXSTAGE_CHECK(expr)                        \
  do {                                              \
    const cudaError_t err_ = (expr);                \
    if (err_ != cudaSuccess) return (int)err_;      \
  } while (0)

// One GEMM pass at k3::plan's tile and (kDW) splits.
template <int kMode, class O, int kTerms>
cudaError_t wgmma_pass(mixstage::k3::Params p, int sms,
                       cudaStream_t stream) {
  int tile = 0, splits = 1;
  mixstage::k3::plan<kMode, kTerms>(p, sms, &tile, &splits);
  p.splits = splits;
  return mixstage::k3::launch<kMode, O, kTerms>(p, tile, sms, stream);
}

// An image operand: its start, and its group and term strides (elements).
struct Img {
  const bf16* p;
  long long g, t;
};

// A GEMM pass over G groups of B x T frames; see k3::Params.
mixstage::k3::Params wgmma_params(Img a, Img b, void* out, long long out_g,
                                  int M, int N, int K, int taps, int sign,
                                  int B, int T, int G) {
  mixstage::k3::Params p{};
  p.a = a.p;
  p.a_g = a.g;
  p.a_t = a.t;
  p.b = b.p;
  p.b_g = b.g;
  p.b_t = b.t;
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

// The stages of a call (the Python wrapper runs them one by one and sums
// each layer's statistics over the data group between two of them; the
// monolithic entry points run them back to back).  The forward's stage s:
// s = 0 packs; s > 0 normalises layer s-1 with its summed statistics
// (stats + (s-1) G 2 C over rows_total rows) and writes its activation; s
// < kL runs layer s's conv and writes its local (G, 2, C) sums of c and
// c^2 to stats + s G 2 C; s = kL runs the logits.  The backward's stage s:
// s = 0 packs and runs the logits head; s > 0 runs layer l = kL - s from
// its summed (G, 2, C) sums of dpre and dpre * xhat (stats + l G 2 C) to
// its dW and d(input); s < kL writes layer kL-1-s's local sums there (and
// its dbeta, dgamma).
constexpr int kStages = kL + 1;

// A stage's launches share these: the card, the scratch's regions, the
// layer images' geometry.
template <class E>
struct Ctx {
  static constexpr int kT = kTermsOf<E>;
  int sms = 0, N, S, P;
  long long act, hg;
  ImgScratch at;
  unsigned char* base;
  ActImg im;
  Ctx(float* scratch, int B, int T, int C0, int C, int F, int G)
      : N(B * T),
        S(splits(B * T)),
        P(mixstage::k3::padded_rows(B, T)),
        act((long long)B * T * C),
        hg(mixstage::k3::act_elems(B, T, C)),
        at(B, T, C0, C, F, G, kT),
        base(reinterpret_cast<unsigned char*>(scratch)),
        im{kT * hg, hg, mixstage::k3::act_rows(B, T), T} {}
  template <class U>
  U* region(long long off) const {
    return reinterpret_cast<U*>(base + off);
  }
  cudaError_t card() {
    int smem_limit;
    return mixstage::card(&sms, &smem_limit);
  }
};

// One forward stage in the mode of E (float: f32, bf16: bf16); see above.
// The GEMMs read images: x's and the weights' packed at stage 0 (one
// pack_kernel launch, which also zeroes h's padding), h's written by
// bn_act_img_kernel.
template <class E>
int forward_stage(int stage, const E* x, const E* w0, const E* wc,
                  const E* cb, const E* gamma, const E* beta, const E* wl,
                  const E* bl, E* out, E* cs, float* mu, float* var,
                  float* scratch, float* stats, float rows_total, int B,
                  int T, int C0, int C, int F, int G, void* stream_) {
  namespace k3 = mixstage::k3;
  using Cx = Ctx<E>;
  constexpr int kT = Cx::kT, kc = k3::Depth<kT>::kConv;
  if (bad_dims(B, T, C0, C, F, G) || stage < 0 || stage >= kStages ||
      !(rows_total > 0.f))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_;
  Cx cx(scratch, B, T, C0, C, F, G);
  MIXSTAGE_CHECK(cx.card());
  const int N = cx.N, S = cx.S, P = cx.P;
  const long long act = cx.act, hg = cx.hg;
  bf16* h = cx.template region<bf16>(cx.at.h);
  bf16* xi = cx.template region<bf16>(cx.at.x);
  bf16* w0i = cx.template region<bf16>(cx.at.w0);
  bf16* wci = cx.template region<bf16>(cx.at.wc);
  bf16* wli = cx.template region<bf16>(cx.at.wl);
  float* part = cx.template region<float>(cx.at.part);
  const long long w0g = k3::w_conv_elems(3, C0, C, kc);
  const long long wcg = k3::w_conv_elems(3, C, C, kc);
  const long long wlg = k3::w_conv_elems(1, C, F, kc);
  const Img hs{h, kT * hg, hg};
  const long long sl = 2LL * G * C;              // stats of a layer
  if (stage == 0) {
    k3::Packer<E, kT> pk(B, T);
    pk.add(k3::kPackAct, x, 0, C0, 0, 0, 1, xi);
    pk.add(k3::kPackConv, w0, 3LL * C0 * C, C0, C, 3, G, w0i);
    pk.add(k3::kPackConv, wc, 3LL * C * C, C, C, 3, 3 * G, wci);
    pk.add(k3::kPackConv, wl, (long long)C * F, C, F, 1, G, wli);
    pk.add(k3::kPackPad, nullptr, 0, C, 0, 0, G, h);
    MIXSTAGE_CHECK(pk.launch(stream));
  } else {
    const int l = stage - 1;
    const LayerParams<E> lp{nullptr, nullptr, gamma + l * C, beta + l * C};
    bn_act_img_kernel<E><<<col_grid(C, G, S), kImgThreads, 0, stream>>>(
        cs + l * G * act, lp, stats + l * sl, rows_total, mu + l * C,
        var + l * C, h, N, C, cx.im);
    MIXSTAGE_CHECK(cudaGetLastError());
  }
  if (stage < kL) {
    const int l = stage;
    E* c = cs + l * G * act;
    const Img a = l == 0 ? Img{xi, 0, k3::act_elems(B, T, C0)} : hs;
    const Img w = l == 0 ? Img{w0i, kT * w0g, w0g}
                         : Img{wci + (l - 1) * G * kT * wcg, kT * wcg, wcg};
    k3::Params p = wgmma_params(a, w, c, act, P, C, l == 0 ? C0 : C, 3, 1, B,
                                T, G);
    p.bias = cb + l * C;
    p.bias_g = kL * C;
    p.round_acc = kT == 1;
    MIXSTAGE_CHECK((wgmma_pass<k3::kConv, E, kT>(p, cx.sms, stream)));
    bn_stats_kernel<E><<<col_grid(C, G, S), kColBlock, 0, stream>>>(
        c, part, N, C);
    MIXSTAGE_CHECK(cudaGetLastError());
    stats_reduce_kernel<<<(G * C + 255) / 256, 256, 0, stream>>>(
        part, S, G, C, stats + l * sl, nullptr, nullptr);
    return (int)cudaGetLastError();
  }
  k3::Params p = wgmma_params(hs, Img{wli, kT * wlg, wlg}, out,
                              (long long)N * F, P, F, C, 1, 1, B, T, G);
  p.bias = bl;
  p.bias_g = F;
  return (int)wgmma_pass<k3::kConv, E, kT>(p, cx.sms, stream);
}

// One backward stage in the mode of E; see above.  As forward_stage: x's,
// dout's and the weights' images packed at stage 0 (kConvT ones), h's and
// dc's written by the column passes.
template <class E>
int backward_stage(int stage, const E* dout, const E* x, const E* cs,
                   const float* mu, const float* var, const E* w0,
                   const E* wc, const E* gamma, const E* beta, const E* wl,
                   float* dx, float* dw0, float* dwc, float* dcb,
                   float* dgamma, float* dbeta, float* dwl, float* dbl,
                   float* scratch, float* dh, float* stats, float rows_total,
                   int B, int T, int C0, int C, int F, int G, void* stream_) {
  namespace k3 = mixstage::k3;
  using Cx = Ctx<E>;
  constexpr int kT = Cx::kT, kc = k3::Depth<kT>::kConv;
  if (bad_dims(B, T, C0, C, F, G) || stage < 0 || stage >= kStages ||
      !(rows_total > 0.f))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_;
  Cx cx(scratch, B, T, C0, C, F, G);
  MIXSTAGE_CHECK(cx.card());
  const int N = cx.N, S = cx.S, P = cx.P, sms = cx.sms;
  const long long act = cx.act, hg = cx.hg;
  bf16* h = cx.template region<bf16>(cx.at.h);
  bf16* dc = cx.template region<bf16>(cx.at.dc);
  bf16* xi = cx.template region<bf16>(cx.at.x);
  bf16* doi = cx.template region<bf16>(cx.at.dout);
  bf16* w0i = cx.template region<bf16>(cx.at.w0);
  bf16* wci = cx.template region<bf16>(cx.at.wc);
  bf16* wli = cx.template region<bf16>(cx.at.wl);
  float* part = cx.template region<float>(cx.at.part);
  float* dw_part = cx.template region<float>(cx.at.dw_part);
  float* dx_part = cx.template region<float>(cx.at.dx_part);
  const long long fg = k3::act_elems(B, T, F);
  const ActImg im = cx.im;
  const long long w0g = k3::w_convt_elems(3, C0, C, kc);
  const long long wcg = k3::w_convt_elems(3, C, C, kc);
  const long long wlg = k3::w_convt_elems(1, C, F, kc);
  const Img hs{h, kT * hg, hg}, dcs{dc, kT * hg, hg};
  const Img dos{doi, kT * fg, fg};
  const long long sl = 2LL * G * C;              // stats of a layer
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
  // the local sums of layer l's BN backward: dpre and dpre * xhat, into
  // its stats and its dbeta, dgamma
  auto sums = [&](int l) {
    bn_bwd_sums_kernel<E><<<col_grid(C, G, S), kColBlock, 0, stream>>>(
        cs + l * G * act, dh, params(l), part, N, C);
    MIXSTAGE_CHECK(cudaGetLastError());
    stats_reduce_kernel<<<(G * C + 255) / 256, 256, 0, stream>>>(
        part, S, G, C, stats + l * sl, dbeta + l * C, dgamma + l * C);
    return (int)cudaGetLastError();
  };
  if (stage == 0) {
    // kConvT images: w (taps, N = the layer's input channels, K = its
    // output channels, reduced)
    k3::Packer<E, kT> pk(B, T);
    pk.add(k3::kPackAct, x, 0, C0, 0, 0, 1, xi);
    pk.add(k3::kPackAct, dout, (long long)N * F, F, 0, 0, G, doi);
    pk.add(k3::kPackConvT, w0, 3LL * C0 * C, C, C0, 3, G, w0i);
    pk.add(k3::kPackConvT, wc, 3LL * C * C, C, C, 3, 3 * G, wci);
    pk.add(k3::kPackConvT, wl, (long long)C * F, F, C, 1, G, wli);
    pk.add(k3::kPackPad, nullptr, 0, C, 0, 0, G, h);
    pk.add(k3::kPackPad, nullptr, 0, C, 0, 0, G, dc);
    MIXSTAGE_CHECK(pk.launch(stream));
    // logits head: h3, dwl = h3^T dout, dbl = sum dout, dh = dout wl^T
    bn_act_img_kernel<E><<<col_grid(C, G, S), kImgThreads, 0, stream>>>(
        cs + (kL - 1) * G * act, params(kL - 1), nullptr, 0.f, nullptr,
        nullptr, h, N, C, im);
    MIXSTAGE_CHECK(cudaGetLastError());
    k3::Params p = wgmma_params(hs, dos, dwl, (long long)C * F, C, F, P, 1,
                                1, B, T, G);
    p.part = dw_part;
    MIXSTAGE_CHECK((wgmma_pass<k3::kDW, float, kT>(p, sms, stream)));
    col_sum_kernel<E><<<col_grid(F, G, S), kColBlock, 0, stream>>>(
        dout, part, N, F);
    MIXSTAGE_CHECK(cudaGetLastError());
    MIXSTAGE_CHECK(reduce(F, dbl, F));
    MIXSTAGE_CHECK((wgmma_pass<k3::kConvT, float, kT>(
        wgmma_params(dos, Img{wli, kT * wlg, wlg}, dh, act, P, C, F, 1, -1,
                     B, T, G),
        sms, stream)));
    return sums(kL - 1);
  }
  const int l = kL - stage;
  const E* c = cs + l * G * act;
  // with the layer's input h_{l-1}, recomputed (l > 0)
  bn_bwd_dc_img_kernel<E><<<col_grid(C, G, S), kImgThreads, 0, stream>>>(
      c, dh, dc, params(l), part, stats + l * sl, rows_total, N, C,
      l > 0 ? cs + (l - 1) * G * act : nullptr, params(l > 0 ? l - 1 : 0),
      l > 0 ? h : nullptr, im);
  MIXSTAGE_CHECK(cudaGetLastError());
  MIXSTAGE_CHECK(reduce(C, dcb + l * C, kL * C));
  const int cin = l == 0 ? C0 : C;
  const long long wsz = 3LL * cin * C;
  float* dw = l == 0 ? dw0 : dwc + (long long)(l - 1) * G * wsz;
  const Img a = l == 0 ? Img{xi, 0, k3::act_elems(B, T, C0)} : hs;
  k3::Params p = wgmma_params(a, dcs, dw, wsz, cin, C, P, 3, 1, B, T, G);
  p.part = dw_part;
  MIXSTAGE_CHECK((wgmma_pass<k3::kDW, float, kT>(p, sms, stream)));
  // d(input): taps shifted back; layer 0 writes one dx partial per group
  // and sums them in group order
  const long long nx = (long long)N * C0;
  const Img w = l == 0 ? Img{w0i, kT * w0g, w0g}
                       : Img{wci + (l - 1) * G * kT * wcg, kT * wcg, wcg};
  MIXSTAGE_CHECK((wgmma_pass<k3::kConvT, float, kT>(
      wgmma_params(dcs, w, l > 0 ? (void*)dh : (void*)dx_part,
                   l > 0 ? act : nx, P, cin, C, 3, -1, B, T, G),
      sms, stream)));
  if (l > 0) return sums(l - 1);
  const long long blocks = (nx + 255) / 256;
  group_sum_kernel<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0,
                     stream>>>(dx_part, G, nx, dx);
  return (int)cudaGetLastError();
}

// Every stage of a call back to back, with the local statistics (one
// rank's batch): the scratch's own stats region.
template <class E>
int forward(const E* x, const E* w0, const E* wc, const E* cb,
            const E* gamma, const E* beta, const E* wl, const E* bl, E* out,
            E* cs, float* mu, float* var, float* scratch, int B, int T,
            int C0, int C, int F, int G, void* stream) {
  if (bad_dims(B, T, C0, C, F, G)) return (int)cudaErrorInvalidValue;
  float* stats = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(scratch) +
      ImgScratch(B, T, C0, C, F, G, kTermsOf<E>).stats);
  for (int s = 0; s < kStages; ++s) {
    const int err = forward_stage<E>(s, x, w0, wc, cb, gamma, beta, wl, bl,
                                     out, cs, mu, var, scratch, stats,
                                     (float)B * T, B, T, C0, C, F, G,
                                     stream);
    if (err) return err;
  }
  return 0;
}

template <class E>
int backward(const E* dout, const E* x, const E* cs, const float* mu,
             const float* var, const E* w0, const E* wc, const E* gamma,
             const E* beta, const E* wl, float* dx, float* dw0, float* dwc,
             float* dcb, float* dgamma, float* dbeta, float* dwl, float* dbl,
             float* scratch, float* dh, int B, int T, int C0, int C, int F,
             int G, void* stream) {
  if (bad_dims(B, T, C0, C, F, G)) return (int)cudaErrorInvalidValue;
  float* stats = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(scratch) +
      ImgScratch(B, T, C0, C, F, G, kTermsOf<E>).stats);
  for (int s = 0; s < kStages; ++s) {
    const int err = backward_stage<E>(
        s, dout, x, cs, mu, var, w0, wc, gamma, beta, wl, dx, dw0, dwc, dcb,
        dgamma, dbeta, dwl, dbl, scratch, dh, stats, (float)B * T, B, T, C0,
        C, F, G, stream);
    if (err) return err;
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
  return forward<bf16>(x, w0, wc, cb, gamma, beta, wl, bl, out, cs, mu, var,
                       h, B, T, C0, C, F, G, stream);
}

// K3 backward on `stream`; returns the first cudaError_t (0 = success).
// Inputs as for the forward plus dout (G,B,T,F) and the forward's cs, mu,
// var; outputs dx (B,T,C0) summed over the groups, dw0 (G,3,C0,C), dwc
// (3,G,3,C,C), dcb, dgamma, dbeta (G,4,C), dwl (G,C,F), dbl (G,1,F).
// h is scratch as for the forward (it also holds dc's image); dh
// (G,B,T,C) is scratch.
int mixstage_train_decoder_bwd_f32(
    const float* dout, const float* x, const float* cs, const float* mu,
    const float* var, const float* w0, const float* wc, const float* gamma,
    const float* beta, const float* wl, float* dx, float* dw0, float* dwc,
    float* dcb, float* dgamma, float* dbeta, float* dwl, float* dbl,
    float* h, float* dh, int B, int T, int C0, int C, int F, int G,
    void* stream) {
  return backward<float>(dout, x, cs, mu, var, w0, wc, gamma, beta, wl, dx,
                         dw0, dwc, dcb, dgamma, dbeta, dwl, dbl, h, dh, B, T,
                         C0, C, F, G, stream);
}

// The bf16 mode of the backward: dout, x, cs and the weights bfloat16;
// mu, var, every gradient, h and dh float32.
int mixstage_train_decoder_bwd_bf16(
    const bf16* dout, const bf16* x, const bf16* cs, const float* mu,
    const float* var, const bf16* w0, const bf16* wc, const bf16* gamma,
    const bf16* beta, const bf16* wl, float* dx, float* dw0, float* dwc,
    float* dcb, float* dgamma, float* dbeta, float* dwl, float* dbl,
    float* h, float* dh, int B, int T, int C0, int C, int F, int G,
    void* stream) {
  return backward<bf16>(dout, x, cs, mu, var, w0, wc, gamma, beta, wl, dx,
                        dw0, dwc, dcb, dgamma, dbeta, dwl, dbl, h, dh, B, T,
                        C0, C, F, G, stream);
}

// One stage of the forward (0 <= stage <= 4; see forward_stage): as
// mixstage_train_decoder_fwd_f32, plus stats, the (4, G, 2, C) float32
// exchange buffer (stage s < 4 writes layer s's local sums of c and c^2;
// stage s > 0 normalises layer s-1 by its entries over rows_total rows).
int mixstage_train_decoder_fwd_stage_f32(
    int stage, const float* x, const float* w0, const float* wc,
    const float* cb, const float* gamma, const float* beta, const float* wl,
    const float* bl, float* out, float* cs, float* mu, float* var, float* h,
    float* stats, float rows_total, int B, int T, int C0, int C, int F,
    int G, void* stream) {
  return forward_stage<float>(stage, x, w0, wc, cb, gamma, beta, wl, bl, out,
                              cs, mu, var, h, stats, rows_total, B, T, C0, C,
                              F, G, stream);
}

int mixstage_train_decoder_fwd_stage_bf16(
    int stage, const bf16* x, const bf16* w0, const bf16* wc, const bf16* cb,
    const bf16* gamma, const bf16* beta, const bf16* wl, const bf16* bl,
    bf16* out, bf16* cs, float* mu, float* var, float* h, float* stats,
    float rows_total, int B, int T, int C0, int C, int F, int G,
    void* stream) {
  return forward_stage<bf16>(stage, x, w0, wc, cb, gamma, beta, wl, bl, out,
                             cs, mu, var, h, stats, rows_total, B, T, C0, C,
                             F, G, stream);
}

// One stage of the backward (see backward_stage): as
// mixstage_train_decoder_bwd_f32, plus stats (stage s < 4 writes layer
// 3-s's local sums of dpre and dpre * xhat; stage s > 0 takes layer 4-s's
// means from its entries over rows_total rows).
int mixstage_train_decoder_bwd_stage_f32(
    int stage, const float* dout, const float* x, const float* cs,
    const float* mu, const float* var, const float* w0, const float* wc,
    const float* gamma, const float* beta, const float* wl, float* dx,
    float* dw0, float* dwc, float* dcb, float* dgamma, float* dbeta,
    float* dwl, float* dbl, float* h, float* dh, float* stats,
    float rows_total, int B, int T, int C0, int C, int F, int G,
    void* stream) {
  return backward_stage<float>(stage, dout, x, cs, mu, var, w0, wc, gamma,
                               beta, wl, dx, dw0, dwc, dcb, dgamma, dbeta,
                               dwl, dbl, h, dh, stats, rows_total, B, T, C0,
                               C, F, G, stream);
}

int mixstage_train_decoder_bwd_stage_bf16(
    int stage, const bf16* dout, const bf16* x, const bf16* cs,
    const float* mu, const float* var, const bf16* w0, const bf16* wc,
    const bf16* gamma, const bf16* beta, const bf16* wl, float* dx,
    float* dw0, float* dwc, float* dcb, float* dgamma, float* dbeta,
    float* dwl, float* dbl, float* h, float* dh, float* stats,
    float rows_total, int B, int T, int C0, int C, int F, int G,
    void* stream) {
  return backward_stage<bf16>(stage, dout, x, cs, mu, var, w0, wc, gamma,
                              beta, wl, dx, dw0, dwc, dcb, dgamma, dbeta,
                              dwl, dbl, h, dh, stats, rows_total, B, T, C0,
                              C, F, G, stream);
}

// The GEMM plan (train_gemm_bf16.cuh) of one pass on a card of `sms` SMs,
// in the mode of `terms` bf16 terms (1: bf16, 3: f32): mode 0 (conv), 1
// (transposed conv) or 2 (per-tap dW) over B x T frames, J reduced
// channels (dW: the output rows' channels), N output columns, `taps` taps,
// G groups; writes the tile (0: 128 x 128, 1: 64 x 256, 2: 64 x 192, 3:
// 64 x 96) and dW's splits of the frames.
void mixstage_train_decoder_plan(int mode, int terms, int B, int T, int J,
                                 int N, int taps, int G, int sms, int* tile,
                                 int* splits) {
  namespace k3 = mixstage::k3;
  k3::Params p{};
  const int rows = 1 + B * (T + 1);
  p.M = mode == kDW ? J : rows;
  p.K = mode == kDW ? rows : J;
  p.N = N;
  p.taps = taps;
  p.groups = G;
  const bool f32 = terms == 3;
  switch (mode) {
    case kConv:
      f32 ? k3::plan<kConv, 3>(p, sms, tile, splits)
          : k3::plan<kConv, 1>(p, sms, tile, splits);
      break;
    case kConvT:
      f32 ? k3::plan<kConvT, 3>(p, sms, tile, splits)
          : k3::plan<kConvT, 1>(p, sms, tile, splits);
      break;
    default:
      f32 ? k3::plan<kDW, 3>(p, sms, tile, splits)
          : k3::plan<kDW, 1>(p, sms, tile, splits);
      break;
  }
}

// Force every later GEMM pass in this process, in either mode, onto `tile`
// (as above; -1: the plan's) and every dW pass onto `splits` (0: the
// plan's); for tools/profile_k1.py --sweep.
void mixstage_train_decoder_force(int tile, int splits) {
  mixstage::k3::forced_tile() = tile;
  mixstage::k3::forced_splits() = splits;
}

const char* mixstage_train_decoder_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
