// K1's bf16 mode for NVIDIA Hopper (sm_90a): the BN-folded Mix-StAGE
// mixture decoder on bf16 features with f32 (BN-folded) weights.
//
// Replaces the TPU kernel mixstage_tpu/ops/pallas/fused_conv.py::
// fused_mixstage_decoder at dtype=bfloat16 (body _decoder_kernel): per group
// g, jnp.dot(bf16 x, f32 w, preferred_element_type=f32) per tap, f32 bias
// and leaky, each layer's output and the logits rounded to bf16:
//
//   h = bf16(leaky(conv3(x, w0[g]) + biases[g, 0]))                C0 -> C
//   h = bf16(leaky(conv3(h, wc[l, g]) + biases[g, l + 1]))  l < L   C  -> C
//   out[:, :, g*F:(g+1)*F] = bf16(h @ w_logits[g] + b_logits[g])    C  -> F
//
// conv3 is a k=3 'same' conv with zero padding at each sequence's own two
// ends.  The serving path calls it twice: the mixture decoder (G=8, C0=266,
// C=256, L=3, F=96) and the cluster-classifier chain (G=1, L=5, F=8).
//
// Exact products at the bf16 tensor-core rate.  A bf16 activation times an
// f32 weight w is exactly x*w1 + x*w2 + x*w3 with w1 = bf16(w), w2 =
// bf16(w - w1), w3 = w - w1 - w2, all three bf16 (8 + 8 + 8 significant
// bits cover f32's 24; barring underflow below 2^-126), and each product
// of two bf16 values is exact in f32.  The split is done once, on the
// host, when the serving function is built (fused_conv.py::
// pack_decoder_bf16), so the kernel runs three bf16 wgmma passes per
// product at 989 TFLOP/s and splits nothing.  It is bound by operations:
// 3 x 31.7 GFLOP per bs32 serving call (decoder + classifier) = 0.096 ms.
//
// The plan.  One CTA owns a (time tile, sequence, group) block and keeps
// the tile's activations in shared memory across all L + 2 layers (a halo
// of L + 1 frames on each side is recomputed by the neighbouring tile;
// rows outside [0, T) stay zero: the per-sequence zero padding).  Each
// layer is a transposed GEMM per tap, D^T[c_out, rows] = W^T[c_out, c_in]
// X^T[c_in, rows], on wgmma m64nNk16: A (M = 64 output channels per
// consumer warpgroup) is a chunk of packed weight terms, B (N rows) the
// activation tile.  N is the kernel instance's (16, 32, 48, 64 or 72: the
// narrowest that covers the tile's widest layer, tile + 2L rows and never
// more than T), so every wgmma has one shape and the accumulators fit the
// registers.  Both operands live in shared memory K-major without swizzle
// (wgmma.cuh): activations as [channel / 8][row][8 channels], so the three
// taps of a k=3 conv are one B descriptor moved by one 16-byte row; the
// weights as the host packed them, chunk by chunk in exactly the image
// wgmma reads: per tap and 16 input channels, [term][channel-half][c_out
// (padded to 64)][8].
//
// A warp-specialised pipeline.  One thread of a producer warpgroup streams
// the chunks (all layers in order) into a ring of kStages shared-memory
// stages, one cp.async.bulk copy per chunk completing on the stage's full
// mbarrier; the four consumer warpgroups (one per 64 output channels) wait
// on a group of kGroupChunks chunks (64 input channels), issue its 3 x 4
// wgmmas (each chunk's small terms first) as one straight-line committed
// group, wait for it, and release its stages on their empty mbarriers.
// The tensor cores' f32 accumulation truncates, so each group sums into a
// zeroed partial (wgmma's scale-d = 0) added to the accumulator in f32, as
// K3 does.  No branch surrounds the wgmmas (ptxas serialises wgmmas behind
// a divergent path): a warpgroup past c_out multiplies m-block 0 again and
// stores nothing.  The epilogue (bias, leaky, bf16 rounding) writes the
// next layer's tile into the other buffer in the same layout; the logits
// go to global memory.  The producer runs ahead across layer boundaries,
// so the next layer's weights are in flight during each epilogue.  It is a
// whole warpgroup so that setmaxnreg can hand its registers to the
// consumers: 112 each, for N of accumulator and partial.
//
// What bounds it (NVIDIA H100, PERF.md, tools/k1_bf16_variants.py): the
// consumers.  With no weight copies the bs32 decoder still takes 95% of
// its time; the weight stream alone takes 54%.  Both operands come from
// shared memory, 4 KB per m64n64k16: at the tensor cores' full rate 128
// bytes a cycle, all that shared memory delivers (the likely bound; not
// measured, there is no ncu on the card's machine).
//
// No thread-block clusters.  CTAs of one group on neighbouring sequences
// sharing each chunk's copy from L2 (cp.async.bulk .multicast::cluster,
// every consumer warp releasing a stage in every CTA of its cluster) ran
// slower at every shape and cluster size measured, the weight stream alone
// included: the stream is not what bounds this kernel, and a cluster's
// CTAs wait for each other at every stage.  Nor double-buffered partials
// (a group issued before the one before it is waited for): three
// accumulator sets spill past 112 registers.  The time tile follows
// launch_common.cuh::cost_tile in 8-row passes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_common.cuh"
#include "wgmma.cuh"

namespace {

using mixstage::card;
namespace sm90 = mixstage::sm90;

constexpr int kConsumerWGs = 4;             // one per 64 output channels
constexpr int kConsumerWarps = 4 * kConsumerWGs;
constexpr int kConsumerThreads = 32 * kConsumerWarps;
constexpr int kThreads = kConsumerThreads + 128;  // + the producer warpgroup
// registers per thread: 5 x 128 threads launch with 96 each (61,440), and
// setmaxnreg only moves registers within that allocation: the producer
// warpgroup drops to 24, the consumers rise to 112 (128 x 24 + 512 x 112 =
// 60,416; 40 and 112 would need 62,464 and never get them)
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 112;
constexpr int kMaxCout = 64 * kConsumerWGs;
constexpr int kStages = 6;                  // weight chunks in the ring
constexpr int kGroupChunks = 4;             // chunks per zeroed partial
constexpr int kMaxTile = 64;
constexpr int kMaxN = 72;                   // the widest instance (rows)
constexpr int kBarBytes = 128;              // the ring's mbarriers
// the weight streaming's cost per CTA in 8-row passes (cost_tile)
constexpr int kWeightRows = 64;

__host__ __device__ inline int round16(int n) { return (n + 15) & ~15; }
__host__ __device__ inline int round64(int n) { return (n + 63) & ~63; }

// Bytes of one packed chunk: 3 terms x 16 input channels x c_out padded to
// 64, bf16.
__host__ __device__ inline int chunk_bytes(int cout) {
  return 96 * round64(cout);
}

__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.f ? v : slope * v;
}

// The 3 x NC wgmmas of a group of NC chunks as one committed group, in
// straight-line code from the fence to the commit (so they pipeline):
// chunk c's terms w3, w2, w1 (the small terms first) times its B into d,
// which the first one zeroes.  a[c] is the address of chunk c's A (term 0)
// for this warpgroup, b[c] of its B; the terms lie term_bytes apart.
template <int N, int NC>
__device__ __forceinline__ void mma_group(float (&d)[N / 2],
                                          const uint32_t (&a)[kGroupChunks],
                                          const uint32_t (&b)[kGroupChunks],
                                          uint32_t term_bytes, uint32_t lbo_a,
                                          uint32_t lbo_b) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) sm90::fence_operand(d[i]);
  sm90::wgmma_fence();
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const uint64_t db = sm90::matrix_desc(b[c], lbo_b, 128);
#pragma unroll
    for (int t = 2; t >= 0; --t)
      sm90::wgmma_bf16<N>(
          d, sm90::matrix_desc(a[c] + t * term_bytes, lbo_a, 128), db,
          (c > 0 || t < 2) ? 1 : 0);
  }
  sm90::wgmma_commit();
}

// mma_group<N, nc> for a runtime nc in [1, NC] (a layer's last group may
// hold fewer chunks).
template <int N, int NC>
__device__ __forceinline__ void mma_group_n(int nc, float (&d)[N / 2],
                                            const uint32_t (&a)[kGroupChunks],
                                            const uint32_t (&b)[kGroupChunks],
                                            uint32_t term_bytes,
                                            uint32_t lbo_a, uint32_t lbo_b) {
  if (nc == NC) {
    mma_group<N, NC>(d, a, b, term_bytes, lbo_a, lbo_b);
  } else if constexpr (NC > 1) {
    mma_group_n<N, NC - 1>(nc, d, a, b, term_bytes, lbo_a, lbo_b);
  }
}

// Layer l of the chain (0: C0 -> C, 1..L: C -> C, L + 1: the logits).
struct Layer {
  int cin, cout, taps, nk;                  // nk: 16-channel chunks per tap
  __host__ __device__ Layer(int l, int C0, int C, int L, int F)
      : cin(l == 0 ? C0 : C), cout(l == L + 1 ? F : C),
        taps(l == L + 1 ? 1 : 3), nk((cin + 15) / 16) {}
  __host__ __device__ int chunks() const { return taps * nk; }
};

// Elements (bf16) of one group's packed weights: every layer's chunks.
inline long long group_elems(int C0, int C, int L, int F) {
  long long n = 0;
  for (int l = 0; l <= L + 1; ++l) {
    const Layer ly(l, C0, C, L, F);
    n += (long long)ly.chunks() * chunk_bytes(ly.cout) / 2;
  }
  return n;
}

// N: the rows (B's columns) of every wgmma, at least any layer's rows.
// 512 consumer threads (4 warpgroups) and a producer warpgroup.
template <int N>
__global__ void __launch_bounds__(kThreads, 1) decoder_bf16_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wp,
    const float* __restrict__ biases, const float* __restrict__ bl,
    __nv_bfloat16* __restrict__ out, int T, int C0, int C, int L, int F,
    int G, int tile_t, int nrows, int kp, int slot, long long gstride,
    float slope) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  unsigned char* ring = smem + kBarBytes;
  __nv_bfloat16* buf0 =
      reinterpret_cast<__nv_bfloat16*>(ring + (size_t)kStages * slot);
  __nv_bfloat16* buf1 = buf0 + (size_t)kp * nrows;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int halo = L + 1, nr = tile_t + 2 * halo;
  const int b = blockIdx.y, g = blockIdx.z;
  const int t_first = blockIdx.x * tile_t - halo;   // time of tile row 0
  // rows holding t in [0, T); the rest stay zero: the 'same' zero padding
  const int v_lo = max(0, -t_first);
  const int v_hi = min(nr, T - t_first);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kConsumerWarps);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();        // the barriers exist before any thread uses them

  if (warp >= kConsumerWarps) {
    // ---- producer: every chunk of every layer, in the consumers' order
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (warp == kConsumerWarps && lane == 0) {
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>(wp + (size_t)g * gstride);
      int s = 0;
      uint32_t ph = 0;
      for (int l = 0; l <= L + 1; ++l) {
        const Layer ly(l, C0, C, L, F);
        const uint32_t bytes = chunk_bytes(ly.cout);
        for (int c = 0; c < ly.chunks(); ++c) {
          sm90::mbar_wait(&empty[s], ph ^ 1);   // round 0 passes at once
          sm90::mbar_arrive_expect_tx(&full[s], bytes);
          sm90::bulk_copy(ring + (size_t)s * slot, src, bytes, &full[s]);
          src += bytes;
          if (++s == kStages) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: zero both tiles, load the input rows of sequence b
    sm90::setmaxnreg_inc<kConsumerRegs>();
    const int nvec = 2 * kp / 8 * nrows;               // 16-byte lines
    uint4* z = reinterpret_cast<uint4*>(buf0);
    for (int i = tid; i < nvec; i += kConsumerThreads)
      z[i] = make_uint4(0, 0, 0, 0);
    sm90::named_barrier(1, kConsumerThreads);
    const __nv_bfloat16* xb = x + (size_t)b * T * C0;
    for (int i = tid; i < (v_hi - v_lo) * C0; i += kConsumerThreads) {
      const int r = v_lo + i / C0, ch = i - (r - v_lo) * C0;
      buf0[((size_t)(ch >> 3) * nrows + r) * 8 + (ch & 7)] =
          xb[(size_t)(t_first + r) * C0 + ch];
    }
    sm90::fence_proxy_async();
    sm90::named_barrier(1, kConsumerThreads);

    const int wg = warp >> 2, w4 = warp & 3;
    const uint32_t line = 16;                          // bytes a row
    const uint32_t lbo_b = (uint32_t)nrows * line;     // next 8 channels
    int s = 0;
    uint32_t ph = 0;
    float acc[N / 2], part[N / 2];
    for (int l = 0; l <= L + 1; ++l) {
      const bool logits = l == L + 1;
      const Layer ly(l, C0, C, L, F);
      const int mp = round64(ly.cout);
      // rows [lo, hi) of this layer's output (layer l reads [l, nr - l)),
      // computed as the N rows from lo
      const int lo = logits ? max(halo, v_lo) : max(l + 1, v_lo);
      const int hi =
          logits ? min(halo + tile_t, v_hi) : min(nr - l - 1, v_hi);
      const __nv_bfloat16* in = (l & 1) ? buf1 : buf0;
      __nv_bfloat16* nxt = (l & 1) ? buf0 : buf1;
      // B of tap 0: rows lo - 1 .. (k=3), lo .. (the 1x1 logits)
      const uint32_t b_addr =
          sm90::smem_u32(in) + (uint32_t)(lo - ly.taps / 2) * line;
      // a warpgroup past c_out multiplies m-block 0 again
      const int mb = wg * 64 < mp ? wg : 0;
      const uint32_t a_addr = sm90::smem_u32(ring) + (uint32_t)mb * 64 * line;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
      const int n = ly.chunks();
      for (int c0 = 0; c0 < n; c0 += kGroupChunks) {
        const int nc = min(kGroupChunks, n - c0);
        const int s0 = s;
        // wait for the group's chunks; their A and B addresses
        uint32_t a[kGroupChunks], bb[kGroupChunks];
#pragma unroll
        for (int i = 0; i < kGroupChunks; ++i) {
          if (i < nc) {
            const int c = c0 + i, tap = c / ly.nk, kc = c - tap * ly.nk;
            sm90::mbar_wait(&full[s], ph);
            a[i] = a_addr + (uint32_t)s * slot;
            bb[i] = b_addr + (uint32_t)(2 * kc * nrows + tap) * line;
            if (++s == kStages) {
              s = 0;
              ph ^= 1;
            }
          }
        }
        mma_group_n<N, kGroupChunks>(nc, part, a, bb, 2 * mp * line,
                                     mp * line, lbo_b);
        sm90::wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < N / 2; ++i) {
          sm90::fence_operand(part[i]);
          acc[i] += part[i];
        }
        // this warp is done with the group's stages
        if (lane == 0) {
          int st = s0;
          for (int i = 0; i < nc; ++i) {
            sm90::mbar_arrive(&empty[st]);
            if (++st == kStages) st = 0;
          }
        }
      }
      // epilogue: bias, leaky (hidden layers), rounding to bf16
      if (wg * 64 < ly.cout) {
        const float* bias = logits ? bl + (size_t)g * F
                                   : biases + ((size_t)g * (L + 1) + l) * C;
        const int m0 = wg * 64 + 16 * w4 + (lane >> 2);
        const int r0 = lo + 2 * (lane & 3);
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int m = m0 + 8 * (e >> 1), r = r0 + 8 * j + (e & 1);
            if (m < ly.cout && r < hi) {
              const float v = acc[4 * j + e] + __ldg(bias + m);
              if (logits) {
                out[((size_t)b * T + (t_first + r)) * G * F + (size_t)g * F +
                    m] = __float2bfloat16_rn(v);
              } else {
                nxt[((size_t)(m >> 3) * nrows + r) * 8 + (m & 7)] =
                    __float2bfloat16_rn(leaky(v, slope));
              }
            }
          }
        }
      }
      if (!logits) {
        sm90::fence_proxy_async();
        sm90::named_barrier(1, kConsumerThreads);
      }
    }
  }
}

// The kernel instances: wgmma widths N (rows), narrowest first.
constexpr int kWidths[] = {16, 32, 48, 64, kMaxN};
using Kernel = decltype(&decoder_bf16_kernel<kMaxN>);
constexpr Kernel kKernels[] = {decoder_bf16_kernel<16>,
                               decoder_bf16_kernel<32>,
                               decoder_bf16_kernel<48>,
                               decoder_bf16_kernel<64>,
                               decoder_bf16_kernel<kMaxN>};
constexpr int kInstances = sizeof(kWidths) / sizeof(kWidths[0]);

// A launch's instance and shared memory for tiles of tile_t frames.  Layer
// 0 computes the most rows, tile_t + 2L and never more than T; the
// instance is the narrowest N that covers them (inst = -1: none).  The
// shared memory holds the barriers, the weight ring and two activation
// tiles of kp channels by nrows rows: the tile's tile_t + 2(L + 1) rows,
// or, if more, the L + 2 + N that a layer's N rows from its first row (at
// most row L + 1) read with their taps.
struct Plan {
  int inst = -1, nrows = 0, kp, slot;
  size_t bytes = 0;
  Plan(int T, int C0, int C, int L, int F, int tile_t)
      : kp(round16(C0 > C ? C0 : C)), slot(chunk_bytes(C > F ? C : F)) {
    const int rows = tile_t + 2 * L < T ? tile_t + 2 * L : T;
    for (int i = kInstances - 1; i >= 0 && tile_t > 0; --i)
      if (rows <= kWidths[i]) inst = i;
    if (inst < 0) return;
    nrows = tile_t + 2 * (L + 1);
    if (nrows < L + 2 + kWidths[inst]) nrows = L + 2 + kWidths[inst];
    bytes = kBarBytes + (size_t)kStages * slot +
            2 * (size_t)kp * nrows * sizeof(__nv_bfloat16);
  }
  bool fits(size_t smem_limit) const {
    return inst >= 0 && bytes <= smem_limit;
  }
};

int pick_tile(int B, int T, int C0, int C, int L, int F, int G, int sm_count,
              size_t smem_limit) {
  return mixstage::cost_tile(
      kMaxTile, B, T, G, L + 1, L + 1, 8, kWeightRows, sm_count, [&](int t) {
        return Plan(T, C0, C, L, F, t).fits(smem_limit);
      });
}

int launch(const __nv_bfloat16* x, const __nv_bfloat16* wp,
           const float* biases, const float* bl, __nv_bfloat16* out, int B,
           int T, int C0, int C, int L, int F, int G, float slope, int tile_t,
           long long gstride, void* stream) {
  if (B <= 0 || T <= 0 || C0 <= 0 || C <= 0 || L < 0 || F <= 0 || G <= 0 ||
      B > 65535 || G > 65535 || C > kMaxCout || F > kMaxCout || tile_t < 0 ||
      gstride != group_elems(C0, C, L, F))
    return (int)cudaErrorInvalidValue;
  int sms, smem_limit;
  cudaError_t err = card(&sms, &smem_limit);
  if (err != cudaSuccess) return (int)err;
  if (tile_t == 0) tile_t = pick_tile(B, T, C0, C, L, F, G, sms, smem_limit);
  const Plan plan(T, C0, C, L, F, tile_t);
  if (!plan.fits(smem_limit)) return (int)cudaErrorInvalidValue;
  const Kernel kernel = kKernels[plan.inst];
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)plan.bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + tile_t - 1) / tile_t, B, G);
  kernel<<<grid, kThreads, plan.bytes, (cudaStream_t)stream>>>(
      x, wp, biases, bl, out, T, C0, C, L, F, G, tile_t, plan.nrows, plan.kp,
      plan.slot, gstride, slope);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Output frames per CTA on a card of `sm_count` SMs with `smem_limit`
// bytes of shared memory per CTA (launch_common.cuh::cost_tile); 0 when no
// tile fits.
int mixstage_fused_decoder_bf16_tile(int B, int T, int C0, int C, int L,
                                     int F, int G, int sm_count,
                                     size_t smem_limit) {
  return pick_tile(B, T, C0, C, L, F, G, sm_count, smem_limit);
}

// Launch on `stream` on the current device with `tile_t` output frames per
// CTA (0: mixstage_fused_decoder_bf16_tile's choice for that device);
// returns the cudaError_t of the launch (cudaErrorInvalidValue for a bad
// shape, a packed size other than group_elems, or a tile that does not
// fit).
// Device pointers to contiguous arrays: x (B, T, C0) bf16; wp (G,
// gstride) bf16 in pack_decoder_bf16's layout (for each layer 0..L+1, each
// tap and each 16 input channels, a chunk [3 terms][2 halves of 8
// channels][round64(c_out)][8]), 16-byte aligned; biases (G, L+1, C) and bl
// (G, F) f32; out (B, T, G*F) bf16.
int mixstage_fused_decoder_bf16(const __nv_bfloat16* x,
                                const __nv_bfloat16* wp, const float* biases,
                                const float* bl, __nv_bfloat16* out, int B,
                                int T, int C0, int C, int L, int F, int G,
                                float slope, int tile_t, long long gstride,
                                void* stream) {
  return launch(x, wp, biases, bl, out, B, T, C0, C, L, F, G, slope, tile_t,
                gstride, stream);
}

const char* mixstage_fused_decoder_bf16_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
