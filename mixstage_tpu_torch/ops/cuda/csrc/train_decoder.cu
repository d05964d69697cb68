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
// 53.7 GFLOP of f32 multiply-adds against ~100-130 MB of HBM traffic, so on
// the card's f32 rate both are bound by operations.  The TPU kernel holds a
// whole group's (B*T, C) layer in VMEM, which BatchNorm's batch statistics
// need; a Hopper CTA has 227 KB of shared memory and one such layer is 2 MB,
// so here the work is split into passes over device memory (L2 holds most
// of it at this size):
//   * GEMM passes (gemm_kernel): each CTA computes a 64x64 output tile,
//     16 reduction steps at a time through shared memory, with a 4x4
//     register block per thread; the next 16 steps' global loads are in
//     flight during the current FMAs, and the loaders keep running indices
//     instead of dividing per element.  The three shapes of the chain are
//     one kernel: the conv (rows = B*T frames,
//     reduction over tap x input channel, taps shifted inside each sequence
//     and zero at its ends), the transposed conv of the backward's d(input)
//     (taps shifted back; for layer 0 the reduction also runs over the G
//     groups, so dx is summed in a fixed order without atomics), and the
//     per-tap dW (rows = tap x input channel, reduction over B*T: a split
//     over the output tiles only, one CTA per tile, so no second pass).
//   * Column passes (bn_act_kernel, bn_bwd_kernel, col_sum_kernel): one CTA
//     owns 32 channels of one group over all B*T rows, so BatchNorm's batch
//     reductions (forward statistics; dgamma, dbeta and the two means of
//     the BN backward) finish inside the CTA in a fixed order: the results
//     are the same from run to run.  They also write the activation h_l
//     that the next GEMM reads, so the GEMMs load plain operands.
// f32 FMA on CUDA cores; tensor cores (wgmma), TMA and fusing the column
// passes into the GEMMs' prologues and epilogues are left to later versions.

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 16, kThreads = 256;
constexpr int kPad = 4;               // keeps float4 rows 16-byte aligned
constexpr int kL = 4;                 // conv layers
constexpr float kEps = 1e-5f, kSlope = 0.2f;
constexpr int kColW = 32, kColLanes = 8;   // column pass: 32 channels x 8

enum Mode { kConv = 0, kConvT = 1, kDW = 2 };

struct Gemm {
  const float* a; long long a_g;      // operand A, per-group stride
  const float* b; long long b_g;      // operand B, per-group stride
  const float* bias; long long bias_g;   // may be null
  float* out; long long out_g;
  int M, N, R;        // output rows, output columns, reduction length
  int J, taps, T, sign;  // J: width of the time-shifted operand
  int gsum;           // groups summed into one output (grid.z == 1), else 1
};

__device__ __forceinline__ float leaky(float v) {
  return v >= 0.f ? v : kSlope * v;
}

constexpr int kSlots = kBM * kBK / kThreads;   // elements of A and of B a
                                               // thread loads per chunk

// Position in a reduction over (group, tap, channel): r = (gs * taps + k) *
// J + j, advanced by one chunk without dividing.
struct TapIter {
  int gs, k, j;
  __device__ void init(int r, int J, int taps) {
    const int per = taps * J;
    gs = r / per;
    const int rem = r - gs * per;
    k = rem / J;
    j = rem - k * J;
  }
  __device__ void advance(int J, int taps) {
    j += kBK;
    while (j >= J) {
      j -= J;
      if (++k == taps) { k = 0; ++gs; }
    }
  }
};

// Position in a reduction over frames: r = b * T + t.
struct RowIter {
  int b, t;
  __device__ void init(int r, int T) { b = r / T; t = r - b * T; }
  __device__ void advance(int T) {
    t += kBK;
    while (t >= T) { t -= T; ++b; }
  }
};

// Each loader holds the positions of the elements its thread loads, works
// out their addresses once per chunk from running indices, returns 0
// outside the matrices and for a tap that leaves its own sequence, and
// walks the operand's contiguous index fastest across the threads.

// A of kConv / kConvT: row m = frame, r = (group, tap, channel); element =
// a[grp][b, t + sign*(k - taps/2), j].  Thread: r = tid % 16, rows
// tid / 16 + 16 i.
struct LoadShiftedRows {
  TapIter it;
  int r, t[kSlots], row0[kSlots];
  bool ok[kSlots];
  __device__ void init(const Gemm& p, int m0) {
    r = threadIdx.x % kBK;
    it.init(r, p.J, p.taps);
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int m = m0 + threadIdx.x / kBK + i * (kThreads / kBK);
      ok[i] = m < p.M;
      const int b = m / p.T;
      t[i] = m - b * p.T;
      row0[i] = b * p.T;
    }
  }
  __device__ void fetch(const Gemm& p, int grp0, float* v) const {
    const bool rok = r < p.R;
    const int shift = p.sign * (it.k - p.taps / 2);
    const float* a = p.a + (grp0 + it.gs) * p.a_g + it.j;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int tt = t[i] + shift;
      v[i] = rok && ok[i] && tt >= 0 && tt < p.T
                 ? __ldg(a + (long long)(row0[i] + tt) * p.J)
                 : 0.f;
    }
  }
  __device__ void store(const float* v, float (*s)[kBM + kPad]) const {
#pragma unroll
    for (int i = 0; i < kSlots; ++i)
      s[threadIdx.x % kBK][threadIdx.x / kBK + i * (kThreads / kBK)] = v[i];
  }
  __device__ void advance(const Gemm& p) {
    r += kBK;
    it.advance(p.J, p.taps);
  }
};

// A of kDW: row m = (tap, channel), r = frame; element =
// a[grp][b, t + k - taps/2, j].  Thread: m = tid % 64, r = tid / 64 + 4 i.
struct LoadShiftedCols {
  RowIter it[kSlots];
  int r[kSlots], shift, j;
  bool ok;
  __device__ void init(const Gemm& p, int m0) {
    const int m = m0 + threadIdx.x % kBM;
    ok = m < p.M;
    const int k = ok ? m / p.J : 0;
    j = ok ? m - k * p.J : 0;
    shift = k - p.taps / 2;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      r[i] = threadIdx.x / kBM + i * (kThreads / kBM);
      it[i].init(r[i], p.T);
    }
  }
  __device__ void fetch(const Gemm& p, int grp0, float* v) const {
    const float* a = p.a + grp0 * p.a_g + j;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int tt = it[i].t + shift;
      v[i] = ok && r[i] < p.R && tt >= 0 && tt < p.T
                 ? __ldg(a + ((long long)it[i].b * p.T + tt) * p.J)
                 : 0.f;
    }
  }
  __device__ void store(const float* v, float (*s)[kBM + kPad]) const {
#pragma unroll
    for (int i = 0; i < kSlots; ++i)
      s[threadIdx.x / kBM + i * (kThreads / kBM)][threadIdx.x % kBM] = v[i];
  }
  __device__ void advance(const Gemm& p) {
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      r[i] += kBK;
      it[i].advance(p.T);
    }
  }
};

// B of kConv: the weights w[grp][k][j][n] at r = (group, tap, channel).
// Thread: n = tid % 64, r = tid / 64 + 4 i.
struct LoadTaps {
  TapIter it[kSlots];
  int r[kSlots], n;
  bool ok;
  __device__ void init(const Gemm& p, int n0) {
    n = n0 + threadIdx.x % kBN;
    ok = n < p.N;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      r[i] = threadIdx.x / kBN + i * (kThreads / kBN);
      it[i].init(r[i], p.J, p.taps);
    }
  }
  __device__ void fetch(const Gemm& p, int grp0, float* v) const {
#pragma unroll
    for (int i = 0; i < kSlots; ++i)
      v[i] = ok && r[i] < p.R
                 ? __ldg(p.b + (grp0 + it[i].gs) * p.b_g +
                         ((long long)it[i].k * p.J + it[i].j) * p.N + n)
                 : 0.f;
  }
  __device__ void store(const float* v, float (*s)[kBN + kPad]) const {
#pragma unroll
    for (int i = 0; i < kSlots; ++i)
      s[threadIdx.x / kBN + i * (kThreads / kBN)][threadIdx.x % kBN] = v[i];
  }
  __device__ void advance(const Gemm& p) {
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      r[i] += kBK;
      it[i].advance(p.J, p.taps);
    }
  }
};

// B of kConvT: the weights transposed, w[grp][k][n][j] at r = (group, tap,
// channel j).  Thread: r = tid % 16, n = tid / 16 + 16 i.
struct LoadTapsT {
  TapIter it;
  int r, n[kSlots];
  __device__ void init(const Gemm& p, int n0) {
    r = threadIdx.x % kBK;
    it.init(r, p.J, p.taps);
#pragma unroll
    for (int i = 0; i < kSlots; ++i)
      n[i] = n0 + threadIdx.x / kBK + i * (kThreads / kBK);
  }
  __device__ void fetch(const Gemm& p, int grp0, float* v) const {
    const float* w = p.b + (grp0 + it.gs) * p.b_g + it.j;
#pragma unroll
    for (int i = 0; i < kSlots; ++i)
      v[i] = r < p.R && n[i] < p.N
                 ? __ldg(w + ((long long)it.k * p.N + n[i]) * p.J)
                 : 0.f;
  }
  __device__ void store(const float* v, float (*s)[kBN + kPad]) const {
#pragma unroll
    for (int i = 0; i < kSlots; ++i)
      s[threadIdx.x % kBK][threadIdx.x / kBK + i * (kThreads / kBK)] = v[i];
  }
  __device__ void advance(const Gemm& p) {
    r += kBK;
    it.advance(p.J, p.taps);
  }
};

// B of kDW: rows of d[grp] (frames x N).  Thread: n = tid % 64,
// r = tid / 64 + 4 i.
struct LoadRows {
  int r[kSlots], n;
  bool ok;
  __device__ void init(const Gemm& p, int n0) {
    n = n0 + threadIdx.x % kBN;
    ok = n < p.N;
#pragma unroll
    for (int i = 0; i < kSlots; ++i)
      r[i] = threadIdx.x / kBN + i * (kThreads / kBN);
  }
  __device__ void fetch(const Gemm& p, int grp0, float* v) const {
    const float* d = p.b + grp0 * p.b_g + n;
#pragma unroll
    for (int i = 0; i < kSlots; ++i)
      v[i] = ok && r[i] < p.R ? __ldg(d + (long long)r[i] * p.N) : 0.f;
  }
  __device__ void store(const float* v, float (*s)[kBN + kPad]) const {
#pragma unroll
    for (int i = 0; i < kSlots; ++i)
      s[threadIdx.x / kBN + i * (kThreads / kBN)][threadIdx.x % kBN] = v[i];
  }
  __device__ void advance(const Gemm&) {
#pragma unroll
    for (int i = 0; i < kSlots; ++i) r[i] += kBK;
  }
};

template <int kMode> struct Loaders;
template <> struct Loaders<kConv> { using A = LoadShiftedRows; using B = LoadTaps; };
template <> struct Loaders<kConvT> { using A = LoadShiftedRows; using B = LoadTapsT; };
template <> struct Loaders<kDW> { using A = LoadShiftedCols; using B = LoadRows; };

template <int kMode>
__global__ void __launch_bounds__(kThreads) gemm_kernel(Gemm p) {
  __shared__ __align__(16) float As[kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[kBK][kBN + kPad];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int grp0 = blockIdx.z * p.gsum;
  typename Loaders<kMode>::A la;
  typename Loaders<kMode>::B lb;
  la.init(p, m0);
  lb.init(p, n0);
  float va[kSlots], vb[kSlots];
  la.fetch(p, grp0, va);
  lb.fetch(p, grp0, vb);
  float acc[4][4] = {};

  for (int r0 = 0; r0 < p.R; r0 += kBK) {
    la.store(va, As);
    lb.store(vb, Bs);
    __syncthreads();
    if (r0 + kBK < p.R) {     // the next chunk's loads fly during the FMAs
      la.advance(p);
      lb.advance(p);
      la.fetch(p, grp0, va);
      lb.fetch(p, grp0, vb);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = p.out + blockIdx.z * p.out_g;
  const float* bias = p.bias ? p.bias + blockIdx.z * p.bias_g : nullptr;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < p.N)
        out[(long long)m * p.N + n] = acc[i][j] + (bias ? __ldg(bias + n) : 0.f);
    }
  }
}

// Sum of the 8 row lanes of a column, in a fixed order, into lane 0.
__device__ __forceinline__ float lane_sum(float (*s)[kColW], float v) {
  s[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < kColLanes; ++i) total += s[i][threadIdx.x];
  __syncthreads();
  return total;
}

// Per-layer parameters of group g: mu/var/gamma/beta are (G, 4, C) arrays,
// already offset to the layer.
struct LayerParams {
  const float* mu; const float* var; const float* gamma; const float* beta;
};

// BatchNorm forward of one layer over columns [32*blockIdx.x, +32) of group
// blockIdx.y: with stats_out, the batch mean and biased variance of c
// (written to mu_out/var_out); else the given ones.  Then, if h is not null,
// h = leaky(BN(c)).  c and h are (G, rows, C).
__global__ void __launch_bounds__(kColW * kColLanes) bn_act_kernel(
    const float* __restrict__ c, LayerParams lp, float* mu_out,
    float* var_out, float* __restrict__ h, int rows, int C) {
  __shared__ float s[kColLanes][kColW];
  const int ch = blockIdx.x * kColW + threadIdx.x, g = blockIdx.y;
  const bool live = ch < C;
  const long long goff = (long long)g * rows * C;
  const int pidx = g * kL * C + ch;
  float mu = 0.f, var = 0.f;
  if (mu_out) {
    float a = 0.f, q = 0.f;
    if (live)
      for (int n = threadIdx.y; n < rows; n += kColLanes) {
        const float v = __ldg(c + goff + (long long)n * C + ch);
        a += v;
        q += v * v;
      }
    a = lane_sum(s, a);
    q = lane_sum(s, q);
    mu = a / rows;
    var = q / rows - mu * mu;
    if (live && threadIdx.y == 0) {
      mu_out[pidx] = mu;
      var_out[pidx] = var;
    }
  } else if (live) {
    mu = __ldg(lp.mu + pidx);
    var = __ldg(lp.var + pidx);
  }
  if (!h || !live) return;
  const float inv = 1.f / sqrtf(var + kEps);
  const float ga = __ldg(lp.gamma + pidx), be = __ldg(lp.beta + pidx);
  for (int n = threadIdx.y; n < rows; n += kColLanes) {
    const long long i = goff + (long long)n * C + ch;
    h[i] = leaky((__ldg(c + i) - mu) * inv * ga + be);
  }
}

// BatchNorm + leaky backward of one layer over 32 columns of one group:
// from c, the stats and dh = d(layer output), write dc = d(conv output) and
// the column sums dgamma, dbeta, dcb (each (G, 4, C), offset to the layer).
__global__ void __launch_bounds__(kColW * kColLanes) bn_bwd_kernel(
    const float* __restrict__ c, const float* __restrict__ dh,
    float* __restrict__ dc, LayerParams lp, float* dgamma, float* dbeta,
    float* dcb, int rows, int C) {
  __shared__ float s[kColLanes][kColW];
  const int ch = blockIdx.x * kColW + threadIdx.x, g = blockIdx.y;
  const bool live = ch < C;
  const long long goff = (long long)g * rows * C;
  const int pidx = g * kL * C + ch;
  float mu = 0.f, inv = 0.f, ga = 0.f, be = 0.f;
  if (live) {
    mu = __ldg(lp.mu + pidx);
    inv = 1.f / sqrtf(__ldg(lp.var + pidx) + kEps);
    ga = __ldg(lp.gamma + pidx);
    be = __ldg(lp.beta + pidx);
  }
  float sdb = 0.f, sdg = 0.f, sdx = 0.f, sdxx = 0.f;
  if (live)
    for (int n = threadIdx.y; n < rows; n += kColLanes) {
      const long long i = goff + (long long)n * C + ch;
      const float xhat = (__ldg(c + i) - mu) * inv;
      const float d = __ldg(dh + i);
      const float dpre = xhat * ga + be >= 0.f ? d : kSlope * d;
      const float dxhat = dpre * ga;
      sdb += dpre;
      sdg += dpre * xhat;
      sdx += dxhat;
      sdxx += dxhat * xhat;
    }
  sdb = lane_sum(s, sdb);
  sdg = lane_sum(s, sdg);
  const float mean_dx = lane_sum(s, sdx) / rows;
  const float mean_dxx = lane_sum(s, sdxx) / rows;
  float scb = 0.f;
  if (live)
    for (int n = threadIdx.y; n < rows; n += kColLanes) {
      const long long i = goff + (long long)n * C + ch;
      const float xhat = (__ldg(c + i) - mu) * inv;
      const float d = __ldg(dh + i);
      const float dpre = xhat * ga + be >= 0.f ? d : kSlope * d;
      const float v = inv * (dpre * ga - mean_dx - xhat * mean_dxx);
      dc[i] = v;
      scb += v;
    }
  scb = lane_sum(s, scb);
  if (live && threadIdx.y == 0) {
    dbeta[pidx] = sdb;
    dgamma[pidx] = sdg;
    dcb[pidx] = scb;
  }
}

// out[g, f] = sum over rows of a[g, row, f]: the logits' bias gradient.
__global__ void __launch_bounds__(kColW * kColLanes) col_sum_kernel(
    const float* __restrict__ a, float* __restrict__ out, int rows, int F) {
  __shared__ float s[kColLanes][kColW];
  const int f = blockIdx.x * kColW + threadIdx.x, g = blockIdx.y;
  float acc = 0.f;
  if (f < F)
    for (int n = threadIdx.y; n < rows; n += kColLanes)
      acc += __ldg(a + ((long long)g * rows + n) * F + f);
  acc = lane_sum(s, acc);
  if (f < F && threadIdx.y == 0) out[g * F + f] = acc;
}

template <int kMode>
cudaError_t gemm(const Gemm& p, int groups, cudaStream_t stream) {
  const dim3 grid((p.N + kBN - 1) / kBN, (p.M + kBM - 1) / kBM, groups);
  gemm_kernel<kMode><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

Gemm conv(const float* a, long long a_g, const float* w, long long w_g,
          const float* bias, long long bias_g, float* out, long long out_g,
          int rows, int cols, int J, int taps, int T, int sign, int gsum) {
  return Gemm{a, a_g, w, w_g, bias, bias_g, out, out_g, rows, cols,
              gsum * taps * J, J, taps, T, sign, gsum};
}

Gemm dweight(const float* a, long long a_g, const float* d, long long d_g,
             float* out, long long out_g, int rows, int cols, int J,
             int taps, int T) {
  return Gemm{a, a_g, d, d_g, nullptr, 0, out, out_g, taps * J, cols, rows,
              J, taps, T, 1, 1};
}

dim3 col_grid(int C, int G) { return dim3((C + kColW - 1) / kColW, G); }
const dim3 kColBlock(kColW, kColLanes);

bool bad_dims(int B, int T, int C0, int C, int F, int G) {
  return B <= 0 || T <= 0 || C0 <= 0 || C <= 0 || F <= 0 || G <= 0 ||
         G > 65535 || (long long)B * T > (1 << 30);
}

#define MIXSTAGE_CHECK(expr)                        \
  do {                                              \
    const cudaError_t err_ = (expr);                \
    if (err_ != cudaSuccess) return (int)err_;      \
  } while (0)

}  // namespace

extern "C" {

// K3 forward on `stream`; returns the first cudaError_t (0 = success).
// All pointers are device pointers to contiguous float32 arrays:
//   x (B,T,C0); w0 (G,3,C0,C); wc (3,G,3,C,C); cb, gamma, beta (G,4,C);
//   wl (G,C,F); bl (G,1,F) -> out (G,B,T,F); cs (4,G,B,T,C); mu, var
//   (G,4,C); h (G,B,T,C) is scratch.
int mixstage_train_decoder_fwd_f32(
    const float* x, const float* w0, const float* wc, const float* cb,
    const float* gamma, const float* beta, const float* wl, const float* bl,
    float* out, float* cs, float* mu, float* var, float* h, int B, int T,
    int C0, int C, int F, int G, void* stream_) {
  if (bad_dims(B, T, C0, C, F, G)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_;
  const int N = B * T;
  const long long act = (long long)N * C;
  for (int l = 0; l < kL; ++l) {
    const int cin = l == 0 ? C0 : C;
    const float* w = l == 0 ? w0 : wc + (long long)(l - 1) * G * 3 * C * C;
    float* c = cs + l * G * act;
    MIXSTAGE_CHECK(gemm<kConv>(
        conv(l == 0 ? x : h, l == 0 ? 0 : act, w, 3LL * cin * C, cb + l * C,
             kL * C, c, act, N, C, cin, 3, T, 1, 1), G, stream));
    const LayerParams lp{nullptr, nullptr, gamma + l * C, beta + l * C};
    bn_act_kernel<<<col_grid(C, G), kColBlock, 0, stream>>>(
        c, lp, mu + l * C, var + l * C, h, N, C);
    MIXSTAGE_CHECK(cudaGetLastError());
  }
  MIXSTAGE_CHECK(gemm<kConv>(conv(h, act, wl, (long long)C * F, bl, F, out,
                                  (long long)N * F, N, F, C, 1, T, 1, 1),
                             G, stream));
  return 0;
}

// K3 backward on `stream`; returns the first cudaError_t (0 = success).
// Inputs as for the forward plus dout (G,B,T,F) and the forward's cs, mu,
// var; outputs dx (B,T,C0) summed over the groups, dw0 (G,3,C0,C), dwc
// (3,G,3,C,C), dcb, dgamma, dbeta (G,4,C), dwl (G,C,F), dbl (G,1,F).
// h, dh, dc (G,B,T,C) are scratch.
int mixstage_train_decoder_bwd_f32(
    const float* dout, const float* x, const float* cs, const float* mu,
    const float* var, const float* w0, const float* wc, const float* gamma,
    const float* beta, const float* wl, float* dx, float* dw0, float* dwc,
    float* dcb, float* dgamma, float* dbeta, float* dwl, float* dbl,
    float* h, float* dh, float* dc, int B, int T, int C0, int C, int F,
    int G, void* stream_) {
  if (bad_dims(B, T, C0, C, F, G)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_;
  const int N = B * T;
  const long long act = (long long)N * C;
  auto params = [&](int l) {
    return LayerParams{mu + l * C, var + l * C, gamma + l * C, beta + l * C};
  };
  // logits head: h3, dwl = h3^T dout, dbl = sum dout, dh = dout wl^T
  bn_act_kernel<<<col_grid(C, G), kColBlock, 0, stream>>>(
      cs + (kL - 1) * G * act, params(kL - 1), nullptr, nullptr, h, N, C);
  MIXSTAGE_CHECK(cudaGetLastError());
  MIXSTAGE_CHECK(gemm<kDW>(dweight(h, act, dout, (long long)N * F, dwl,
                                   (long long)C * F, N, F, C, 1, T),
                           G, stream));
  col_sum_kernel<<<col_grid(F, G), kColBlock, 0, stream>>>(dout, dbl, N, F);
  MIXSTAGE_CHECK(cudaGetLastError());
  MIXSTAGE_CHECK(gemm<kConvT>(conv(dout, (long long)N * F, wl,
                                   (long long)C * F, nullptr, 0, dh, act, N,
                                   C, F, 1, T, 1, 1),
                              G, stream));
  for (int l = kL - 1; l >= 0; --l) {
    const LayerParams lp = params(l);
    bn_bwd_kernel<<<col_grid(C, G), kColBlock, 0, stream>>>(
        cs + l * G * act, dh, dc, lp, dgamma + l * C, dbeta + l * C,
        dcb + l * C, N, C);
    MIXSTAGE_CHECK(cudaGetLastError());
    const int cin = l == 0 ? C0 : C;
    if (l > 0) {               // the layer's input h_{l-1}, recomputed
      bn_act_kernel<<<col_grid(C, G), kColBlock, 0, stream>>>(
          cs + (l - 1) * G * act, params(l - 1), nullptr, nullptr, h, N, C);
      MIXSTAGE_CHECK(cudaGetLastError());
    }
    const long long wsz = 3LL * cin * C;
    float* dw = l == 0 ? dw0 : dwc + (long long)(l - 1) * G * wsz;
    const float* w = l == 0 ? w0 : wc + (long long)(l - 1) * G * wsz;
    MIXSTAGE_CHECK(gemm<kDW>(dweight(l == 0 ? x : h, l == 0 ? 0 : act, dc,
                                     act, dw, wsz, N, C, cin, 3, T),
                             G, stream));
    // d(input): taps shifted back; layer 0 sums the groups into dx
    if (l > 0) {
      MIXSTAGE_CHECK(gemm<kConvT>(conv(dc, act, w, wsz, nullptr, 0, dh, act,
                                       N, C, C, 3, T, -1, 1),
                                  G, stream));
    } else {
      MIXSTAGE_CHECK(gemm<kConvT>(conv(dc, act, w, wsz, nullptr, 0, dx, 0, N,
                                       C0, C, 3, T, -1, G),
                                  1, stream));
    }
  }
  return 0;
}

const char* mixstage_train_decoder_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
