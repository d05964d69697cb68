// K1 for NVIDIA Hopper (sm_90a), both modes: the BN-folded Mix-StAGE
// mixture decoder on float32 or bf16 features with f32 (BN-folded)
// weights.
//
// Replaces the TPU kernel mixstage_tpu/ops/pallas/fused_conv.py::
// fused_mixstage_decoder (body _decoder_kernel) at dtype=float32 and at
// dtype=bfloat16 (jnp.dot(bf16 x, f32 w, preferred_element_type=f32) per
// tap).  Per group g, with f32 bias and leaky:
//
//   h = act(leaky(conv3(x, w0[g]) + biases[g, 0]))                C0 -> C
//   h = act(leaky(conv3(h, wc[l, g]) + biases[g, l + 1]))  l < L   C  -> C
//   out[:, :, g*F:(g+1)*F] = act(h @ w_logits[g] + b_logits[g])    C  -> F
//
// act() is the identity in the f32 mode and rounds to bf16 in the bf16
// mode.  conv3 is a k=3 'same' conv with zero padding at each sequence's
// own two ends.  The serving path calls it twice: the mixture decoder (G=8,
// C0=266, C=256, L=3, F=96) and the cluster-classifier chain (G=1, L=5,
// F=8).
//
// K2, the chain mode (decoder_kernel<N, KX, true>), replaces the TPU
// kernel mixstage_tpu/ops/pallas/fused_conv.py::fused_grouped_conv_chain
// (body _chain_kernel) in both of its modes: K1 without layer 0 and the
// logits.  Per group g of x (B, T, G*C), for l < L:
//
//   h = act(leaky(conv3(h, w[l, g]) + biases[l, g*C:(g+1)*C]))      C -> C
//
// and out[:, :, g*C:(g+1)*C] = h in x's dtype.  It runs the decoder mode's
// code with the chain's layers counted: group g reads its own C channels of
// x at row stride G*C, the halo is L frames, the biases are indexed in
// their (L, G*C) layout, and the last layer's epilogue (bias, leaky, the
// mode's rounding) stores to out where the decoder's logits store.  A
// chain of no layers copies x.  At (32, 64, G=8, C=256, L=3) it does 19.33
// GFLOP: 6 x that at 989 TFLOP/s = 0.117 ms (f32 mode), 3 x = 0.059 ms
// (bf16 mode), both bound by operations.  No path of the port calls it (a
// public op, as in the JAX package).
//
// Exact products at the bf16 tensor-core rate.  Each f32 weight w is split
// once, on the host, when the serving function is built (fused_conv.py::
// pack_decoder_bf16), into three bf16 terms that sum to it exactly: w1 =
// bf16(w), w2 = bf16(w - w1), w3 = w - w1 - w2 (8 + 8 + 8 significant bits
// cover f32's 24).  Each product of two bf16 values is exact in f32.
// * bf16 mode: a feature x times w is exactly x*w1 + x*w2 + x*w3, three
//   bf16 wgmma passes (3 x 31.7 GFLOP per bs32 serving call, decoder +
//   classifier, at 989 TFLOP/s = 0.096 ms).
// * f32 mode: the features are split the same way, x = x1 + x2 + x3, as
//   the consumer threads stage the input and as each epilogue writes the
//   next layer, and x*w is taken as six bf16 products,
//     x1w1 + (x1w2 + x2w1) + (x1w3 + x2w2 + x3w1),
//   run small terms first.  The three products left out (x2w3, x3w2,
//   x3w3) are at most ~3 * 2^-24 of |x w|.  A third term below bf16's
//   normal range (|v| < 2^-110 or so) loses bits: an error below 2^-110
//   absolute, far below the 1e-4 of max |plain| the kernel is held to.
//   Six bf16 passes per product (6 x 31.7 GFLOP at 989 TFLOP/s = 0.192
//   ms a bs32 serving call, the 3xTF32 bound of the mma.sync kernel it
//   replaced).
// Either way the kernel is bound by operations.
//
// The plan.  One CTA owns a (time tile, sequence, group) block and keeps
// the tile's activations in shared memory across all L + 2 layers (a halo
// of L + 1 frames on each side, one per k=3 layer, is recomputed by the
// neighbouring tile; rows outside [0, T) stay zero: the per-sequence zero
// padding).  Each
// layer is a transposed GEMM per tap, D^T[c_out, rows] = W^T[c_out, c_in]
// X^T[c_in, rows], on wgmma m64nNk16: A (M = 64 output channels per
// consumer warpgroup) is a chunk of packed weight terms, B (N rows) the
// activation tile.  N is the kernel instance's (16, 32, 48, 64 or 72: the
// narrowest that covers the tile's widest layer, tile + 2L rows and never
// more than T), so every wgmma has one shape and the accumulators fit the
// registers.  Both operands live in shared memory K-major without swizzle
// (wgmma.cuh): activations as [term][channel / 8][row][8 channels] (one
// term in the bf16 mode, three in the f32 mode), so the three taps of a
// k=3 conv are one B descriptor moved by one 16-byte row and a term is
// the descriptor moved by one term's image; the weights as the host
// packed them, chunk by chunk in exactly the image wgmma reads: per tap
// and 16 input channels, [term][channel-half][c_out (padded to 64)][8].
//
// Shared memory.  The bf16 mode writes each layer's output into the other
// of two activation buffers.  Three-term images take 6 bytes an element,
// and two of them do not fit beside the weight ring at the widest tile
// (72 rows x 272 channels: 2 x 117.5 KB), so the f32 mode rewrites one
// buffer in place: each layer's whole output lies in the consumer
// warpgroups' accumulators before any epilogue writes, and a named
// barrier after the layer's last wgmma wait makes the write safe.  The
// ring gets the rest, kStages stages at most and 2 at least (the bf16
// mode: always kStages).
//
// A warp-specialised pipeline.  One thread of a producer warpgroup streams
// the chunks (all layers in order) into the ring, one cp.async.bulk copy
// per chunk completing on the stage's full mbarrier; the four consumer
// warpgroups (one per 64 output channels) wait on a group of up to
// kGroupChunks chunks (two fewer than the ring's stages, so that two
// chunks stay in flight while a group's wgmmas run), issue its 3 (bf16) or
// 6 (f32) wgmmas a chunk, each chunk's small products first, as one
// straight-line committed group, wait for it, and release its stages on
// their empty mbarriers.  The tensor cores' f32 accumulation truncates, so
// each group sums into a zeroed partial (wgmma's scale-d = 0) added to the
// accumulator in f32, as K3 does.  No branch surrounds the wgmmas (ptxas
// serialises wgmmas behind a divergent path): a warpgroup past c_out
// multiplies m-block 0 again and stores nothing.  The epilogue (bias,
// leaky, the bf16 rounding or the three-term split) writes the next
// layer's tile in the same layout; the logits go to global memory.  The
// producer runs ahead across layer boundaries, so the next layer's weights
// are in flight during each epilogue.  It is a whole warpgroup so that
// setmaxnreg can hand its registers to the consumers: 112 each, for N of
// accumulator and partial.
//
// What bounds it (NVIDIA H100, PERF.md, tools/k1_variants.py): the
// consumers.  In the bf16 mode, with no weight copies the bs32 decoder
// still takes 95% of its time; the weight stream alone takes 54%.  Both
// operands come from shared memory, 4 KB per m64n64k16: at the tensor
// cores' full rate 128 bytes a cycle, all that shared memory delivers (the
// likely bound; not measured, there is no ncu on the card's machine).
// The f32 mode issues twice the wgmmas on the same weight stream.
//
// No thread-block clusters.  CTAs of one group on neighbouring sequences
// sharing each chunk's copy from L2 (cp.async.bulk .multicast::cluster)
// ran slower at every shape and cluster size measured in the bf16 mode:
// the stream is not what bounds this kernel, and a cluster's CTAs wait for
// each other at every stage.  Nor double-buffered partials (a group issued
// before the one before it is waited for): three accumulator sets spill
// past 112 registers.  The time tile follows launch_common.cuh::cost_tile
// in 8-row passes.

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
constexpr int kStages = 6;                  // weight chunks in the ring, most
constexpr int kMinStages = 2;               // and least
constexpr int kGroupChunks = 4;             // chunks per zeroed partial, most
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

// Activation buffers of the mode whose features are `terms` bf16 terms:
// the bf16 mode (1) writes each layer into the other of two, the f32 mode
// (3) rewrites one in place.
__host__ __device__ constexpr int buffers(int terms) {
  return terms == 1 ? 2 : 1;
}

// A mode's feature type (x and out): KX = 3, float32; KX = 1, bf16.
template <int KX>
struct Feature {
  using T = float;
  static __device__ __forceinline__ float of(float v) { return v; }
};

template <>
struct Feature<1> {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ __nv_bfloat16 of(float v) {
    return __float2bfloat16_rn(v);
  }
};

__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.f ? v : slope * v;
}

// A feature into an activation image at p, its terms `term` elements
// apart: a bf16 one as it is; an f32 one as the three bf16 terms of
// split_bf16x3 (v1 = bf16(v), v2 = bf16(v - v1), v3 = bf16(v - v1 - v2),
// each difference exact in f32), which sum to it exactly.
__device__ __forceinline__ void put_terms(__nv_bfloat16* p, size_t,
                                          __nv_bfloat16 v) {
  *p = v;
}

__device__ __forceinline__ void put_terms(__nv_bfloat16* p, size_t term,
                                          float v) {
  const __nv_bfloat16 v1 = __float2bfloat16_rn(v);
  const float r = v - __bfloat162float(v1);
  const __nv_bfloat16 v2 = __float2bfloat16_rn(r);
  p[0] = v1;
  p[term] = v2;
  p[2 * term] = __float2bfloat16_rn(r - __bfloat162float(v2));
}

// The wgmmas of a group of NC chunks as one committed group, in
// straight-line code from the fence to the commit (so they pipeline):
// chunk c's products x_i w_j (i < KX activation terms, j < 3 weight terms,
// i + j <= 2; in the order of i + j from 2 down to 0: the small products
// first) into d, which the first one zeroes.  a[c] is the address of chunk
// c's A (weight term 0) for this warpgroup, b[c] of its B (activation term
// 0); the weight terms lie term_a bytes apart, the activation terms
// term_b.
template <int N, int NC, int KX>
__device__ __forceinline__ void mma_group(float (&d)[N / 2],
                                          const uint32_t (&a)[kGroupChunks],
                                          const uint32_t (&b)[kGroupChunks],
                                          uint32_t term_a, uint32_t term_b,
                                          uint32_t lbo_a, uint32_t lbo_b) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) sm90::fence_operand(d[i]);
  sm90::wgmma_fence();
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int k = 2; k >= 0; --k) {
#pragma unroll
      for (int i = 0; i < KX && i <= k; ++i)
        sm90::wgmma_bf16<N>(
            d, sm90::matrix_desc(a[c] + (k - i) * term_a, lbo_a, 128),
            sm90::matrix_desc(b[c] + i * term_b, lbo_b, 128),
            (c > 0 || k < 2 || i > 0) ? 1 : 0);
    }
  }
  sm90::wgmma_commit();
}

// mma_group<N, nc, KX> for a runtime nc in [1, NC] (a group may hold fewer
// chunks: a layer's last, or all of them where the ring is short).
template <int N, int NC, int KX>
__device__ __forceinline__ void mma_group_n(int nc, float (&d)[N / 2],
                                            const uint32_t (&a)[kGroupChunks],
                                            const uint32_t (&b)[kGroupChunks],
                                            uint32_t term_a, uint32_t term_b,
                                            uint32_t lbo_a, uint32_t lbo_b) {
  if (nc == NC) {
    mma_group<N, NC, KX>(d, a, b, term_a, term_b, lbo_a, lbo_b);
  } else if constexpr (NC > 1) {
    mma_group_n<N, NC - 1, KX>(nc, d, a, b, term_a, term_b, lbo_a, lbo_b);
  }
}

// Layer l of the decoder (0: C0 -> C, 1..L: C -> C, L + 1: the logits);
// the chain mode runs its layers 0..L-1 with C0 = C.
struct Layer {
  int cin, cout, taps, nk;                  // nk: 16-channel chunks per tap
  __host__ __device__ Layer(int l, int C0, int C, int L, int F)
      : cin(l == 0 ? C0 : C), cout(l == L + 1 ? F : C),
        taps(l == L + 1 ? 1 : 3), nk((cin + 15) / 16) {}
  __host__ __device__ int chunks() const { return taps * nk; }
};

// The k=3 layers of a decoder (layer 0 and L chain layers) or a chain (L),
// so the halo of frames a tile recomputes on each side.
__host__ __device__ inline int k3_layers(bool chain, int L) {
  return chain ? L : L + 1;
}

// The index of the last layer, the one that stores to out: the decoder's
// logits, or the chain's last k=3 layer.
__host__ __device__ inline int last_layer(bool chain, int L) {
  return chain ? L - 1 : L + 1;
}

// Elements (bf16) of one group's packed weights: every layer's chunks.
inline long long group_elems(int C0, int C, int L, int F, bool chain) {
  long long n = 0;
  for (int l = 0; l <= last_layer(chain, L); ++l) {
    const Layer ly(l, C0, C, L, F);
    n += (long long)ly.chunks() * chunk_bytes(ly.cout) / 2;
  }
  return n;
}

// N: the rows (B's columns) of every wgmma, at least any layer's rows; KX:
// the features' bf16 terms (1: the bf16 mode, 3: the f32 mode); kChain:
// K2's chain of L layers (C0 = F = C; biases (L, G*C); x and out (B, T,
// G*C); bl unused) instead of K1's decoder.  512 consumer threads (4
// warpgroups) and a producer warpgroup.
template <int N, int KX, bool kChain>
__global__ void __launch_bounds__(kThreads, 1) decoder_kernel(
    const typename Feature<KX>::T* __restrict__ x,
    const __nv_bfloat16* __restrict__ wp, const float* __restrict__ biases,
    const float* __restrict__ bl, typename Feature<KX>::T* __restrict__ out,
    int T, int C0, int C, int L, int F, int G, int tile_t, int nrows, int kp,
    int slot, int stages, int group, long long gstride, float slope) {
  if (kChain && L == 0) {       // a chain of no layers: out = x
    const int t0 = blockIdx.x * tile_t, n = min(tile_t, T - t0) * C;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const size_t at = ((size_t)blockIdx.y * T + t0 + i / C) * G * C +
                        (size_t)blockIdx.z * C + i % C;
      out[at] = x[at];
    }
    return;
  }
  extern __shared__ __align__(128) unsigned char smem[];
  // the bf16 mode's ring is fixed at compile time, kStages stages and
  // groups of kGroupChunks (its plan fits only with them): about 2% faster
  // at the classifier's shapes than the same values read at run time
  // (tools/k1_variants.py --mode bf16)
  if (KX == 1) {
    stages = kStages;
    group = kGroupChunks;
  }
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  unsigned char* ring = smem + kBarBytes;
  // each buffer holds KX term images of `term` elements; in place (f32
  // mode) the two are one
  const size_t term = (size_t)kp * nrows;
  __nv_bfloat16* buf0 =
      reinterpret_cast<__nv_bfloat16*>(ring + (size_t)stages * slot);
  __nv_bfloat16* buf1 = buf0 + (buffers(KX) - 1) * KX * term;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int halo = k3_layers(kChain, L), nr = tile_t + 2 * halo;
  const int last = last_layer(kChain, L);
  const int b = blockIdx.y, g = blockIdx.z;
  const int t_first = blockIdx.x * tile_t - halo;   // time of tile row 0
  // rows holding t in [0, T); the rest stay zero: the 'same' zero padding
  const int v_lo = max(0, -t_first);
  const int v_hi = min(nr, T - t_first);
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
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
      for (int l = 0; l <= last; ++l) {
        const Layer ly(l, C0, C, L, F);
        const uint32_t bytes = chunk_bytes(ly.cout);
        for (int c = 0; c < ly.chunks(); ++c) {
          sm90::mbar_wait(&empty[s], ph ^ 1);   // round 0 passes at once
          sm90::mbar_arrive_expect_tx(&full[s], bytes);
          sm90::bulk_copy(ring + (size_t)s * slot, src, bytes, &full[s]);
          src += bytes;
          if (++s == stages) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: zero the tiles, load the input rows of sequence b
    sm90::setmaxnreg_inc<kConsumerRegs>();
    const int nvec = buffers(KX) * KX * kp / 8 * nrows;   // 16-byte lines
    uint4* z = reinterpret_cast<uint4*>(buf0);
    for (int i = tid; i < nvec; i += kConsumerThreads)
      z[i] = make_uint4(0, 0, 0, 0);
    sm90::named_barrier(1, kConsumerThreads);
    // the chain's group g reads its own C0 = C channels of x (B, T, G*C)
    const size_t xrow = kChain ? (size_t)G * C0 : C0;
    const typename Feature<KX>::T* xb =
        x + (size_t)b * T * xrow + (kChain ? (size_t)g * C0 : 0);
    for (int i = tid; i < (v_hi - v_lo) * C0; i += kConsumerThreads) {
      const int r = v_lo + i / C0, ch = i - (r - v_lo) * C0;
      put_terms(buf0 + ((size_t)(ch >> 3) * nrows + r) * 8 + (ch & 7), term,
                xb[(size_t)(t_first + r) * xrow + ch]);
    }
    sm90::fence_proxy_async();
    sm90::named_barrier(1, kConsumerThreads);

    const int wg = warp >> 2, w4 = warp & 3;
    const uint32_t line = 16;                          // bytes a row
    const uint32_t lbo_b = (uint32_t)nrows * line;     // next 8 channels
    const uint32_t term_b = (uint32_t)(term * sizeof(__nv_bfloat16));
    int s = 0;
    uint32_t ph = 0;
    float acc[N / 2], part[N / 2];
    for (int l = 0; l <= last; ++l) {
      const bool logits = !kChain && l == last;
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
      for (int c0 = 0; c0 < n; c0 += group) {
        const int nc = min(group, n - c0);
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
            if (++s == stages) {
              s = 0;
              ph ^= 1;
            }
          }
        }
        mma_group_n<N, kGroupChunks, KX>(nc, part, a, bb, 2 * mp * line,
                                         term_b, mp * line, lbo_b);
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
            if (++st == stages) st = 0;
          }
        }
      }
      // in place: every warpgroup's wgmmas have read the layer's input
      // before any epilogue overwrites it
      if (buffers(KX) == 1 && l != last)
        sm90::named_barrier(1, kConsumerThreads);
      // epilogue: bias, leaky (k=3 layers), the mode's feature; the last
      // layer to out (B, T, G*F), the chain's at F = C
      if (wg * 64 < ly.cout) {
        const float* bias =
            logits   ? bl + (size_t)g * F
            : kChain ? biases + ((size_t)l * G + g) * C
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
              if (l == last) {
                out[((size_t)b * T + (t_first + r)) * G * F + (size_t)g * F +
                    m] = Feature<KX>::of(kChain ? leaky(v, slope) : v);
              } else {
                put_terms(nxt + ((size_t)(m >> 3) * nrows + r) * 8 + (m & 7),
                          term, Feature<KX>::of(leaky(v, slope)));
              }
            }
          }
        }
      }
      if (l != last) {
        sm90::fence_proxy_async();
        sm90::named_barrier(1, kConsumerThreads);
      }
    }
  }
}

// The kernel instances of a mode: wgmma widths N (rows), narrowest first.
constexpr int kWidths[] = {16, 32, 48, 64, kMaxN};
constexpr int kInstances = sizeof(kWidths) / sizeof(kWidths[0]);

template <int KX, bool kChain>
using Kernel = decltype(&decoder_kernel<kMaxN, KX, kChain>);

template <int KX, bool kChain>
Kernel<KX, kChain> instance(int i) {
  constexpr Kernel<KX, kChain> kernels[kInstances] = {
      decoder_kernel<16, KX, kChain>, decoder_kernel<32, KX, kChain>,
      decoder_kernel<48, KX, kChain>, decoder_kernel<64, KX, kChain>,
      decoder_kernel<kMaxN, KX, kChain>};
  return kernels[i];
}

// A launch's instance and shared memory for tiles of tile_t frames, in the
// mode whose features are `terms` bf16 terms, with a halo of `halo` frames
// (k3_layers: L + 1 for the decoder, L for the chain), on a card with
// `smem_limit` bytes a CTA.  Layer 0 computes the most rows, tile_t +
// 2(halo - 1) and never more than T; the instance is the narrowest N that
// covers them (inst = -1: none).  The shared memory holds the barriers, the
// activation buffers of kp channels by nrows rows (the tile's tile_t +
// 2 halo rows, or, if more, the halo + 1 + N that a layer's N rows from its
// first row, at most row halo, read with their taps) and a weight ring of
// as many stages as the rest holds, kStages at most; it fits with
// kMinStages or more (the bf16 mode: kStages).  Each zeroed partial sums
// `group` chunks, two fewer than the stages (1 at least).
struct Plan {
  int inst = -1, nrows = 0, kp, slot, stages = 0, group = 0;
  size_t bytes = 0;
  Plan(int terms, int T, int C0, int C, int halo, int F, int tile_t,
       size_t smem_limit)
      : kp(round16(C0 > C ? C0 : C)), slot(chunk_bytes(C > F ? C : F)) {
    const int rows =
        tile_t + 2 * (halo - 1) < T ? tile_t + 2 * (halo - 1) : T;
    for (int i = kInstances - 1; i >= 0 && tile_t > 0; --i)
      if (rows <= kWidths[i]) inst = i;
    if (inst < 0) return;
    nrows = tile_t + 2 * halo;
    if (nrows < halo + 1 + kWidths[inst]) nrows = halo + 1 + kWidths[inst];
    const size_t fixed = kBarBytes + (size_t)buffers(terms) * terms * kp *
                                         nrows * sizeof(__nv_bfloat16);
    const int least = terms == 1 ? kStages : kMinStages;
    if (fixed + (size_t)least * slot > smem_limit) return;
    const size_t room = (smem_limit - fixed) / slot;
    stages = room < (size_t)kStages ? (int)room : kStages;
    group = stages - 2 < 1 ? 1
            : stages - 2 > kGroupChunks ? kGroupChunks : stages - 2;
    bytes = fixed + (size_t)stages * slot;
  }
  bool fits() const { return stages >= kMinStages; }
};

int pick_tile(int terms, int B, int T, int C0, int C, int halo, int F, int G,
              int sm_count, size_t smem_limit) {
  return mixstage::cost_tile(
      kMaxTile, B, T, G, halo, halo, 8, kWeightRows, sm_count, [&](int t) {
        return Plan(terms, T, C0, C, halo, F, t, smem_limit).fits();
      });
}

// K1 (kChain false) or K2 (true: C0 = F = C, L the chain's layers, bl
// unused) in the mode of KX.
template <int KX, bool kChain>
int launch(const typename Feature<KX>::T* x, const __nv_bfloat16* wp,
           const float* biases, const float* bl,
           typename Feature<KX>::T* out, int B, int T, int C0, int C, int L,
           int F, int G, float slope, int tile_t, long long gstride,
           void* stream) {
  if (B <= 0 || T <= 0 || C0 <= 0 || C <= 0 || L < 0 || F <= 0 || G <= 0 ||
      B > 65535 || G > 65535 || C > kMaxCout || F > kMaxCout || tile_t < 0 ||
      gstride != group_elems(C0, C, L, F, kChain))
    return (int)cudaErrorInvalidValue;
  int sms, smem_limit;
  cudaError_t err = card(&sms, &smem_limit);
  if (err != cudaSuccess) return (int)err;
  const int halo = k3_layers(kChain, L);
  if (tile_t == 0)
    tile_t = pick_tile(KX, B, T, C0, C, halo, F, G, sms, smem_limit);
  const Plan plan(KX, T, C0, C, halo, F, tile_t, smem_limit);
  if (!plan.fits()) return (int)cudaErrorInvalidValue;
  const Kernel<KX, kChain> kernel = instance<KX, kChain>(plan.inst);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)plan.bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + tile_t - 1) / tile_t, B, G);
  kernel<<<grid, kThreads, plan.bytes, (cudaStream_t)stream>>>(
      x, wp, biases, bl, out, T, C0, C, L, F, G, tile_t, plan.nrows, plan.kp,
      plan.slot, plan.stages, plan.group, gstride, slope);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Output frames per CTA of the f32 (bf16) mode on a card of `sm_count` SMs
// with `smem_limit` bytes of shared memory per CTA (launch_common.cuh::
// cost_tile); 0 when no tile fits.
int mixstage_fused_decoder_f32_tile(int B, int T, int C0, int C, int L,
                                    int F, int G, int sm_count,
                                    size_t smem_limit) {
  return pick_tile(3, B, T, C0, C, k3_layers(false, L), F, G, sm_count,
                   smem_limit);
}

int mixstage_fused_decoder_bf16_tile(int B, int T, int C0, int C, int L,
                                     int F, int G, int sm_count,
                                     size_t smem_limit) {
  return pick_tile(1, B, T, C0, C, k3_layers(false, L), F, G, sm_count,
                   smem_limit);
}

// Launch the f32 mode on `stream` on the current device with `tile_t`
// output frames per CTA (0: mixstage_fused_decoder_f32_tile's choice for
// that device); returns the cudaError_t of the launch (cudaErrorInvalidValue
// for a bad shape, a packed size other than group_elems, or a tile that
// does not fit).  Device pointers to contiguous arrays: x (B, T, C0) f32;
// wp (G, gstride) bf16 in pack_decoder_bf16's layout (for each layer
// 0..L+1, each tap and each 16 input channels, a chunk [3 terms][2 halves
// of 8 channels][round64(c_out)][8]), 16-byte aligned; biases (G, L+1, C)
// and bl (G, F) f32; out (B, T, G*F) f32.
int mixstage_fused_decoder_f32(const float* x, const __nv_bfloat16* wp,
                               const float* biases, const float* bl,
                               float* out, int B, int T, int C0, int C,
                               int L, int F, int G, float slope, int tile_t,
                               long long gstride, void* stream) {
  return launch<3, false>(x, wp, biases, bl, out, B, T, C0, C, L, F, G,
                          slope, tile_t, gstride, stream);
}

// The bf16 mode: as mixstage_fused_decoder_f32 with x (B, T, C0) and out
// (B, T, G*F) bf16 (mixstage_fused_decoder_bf16_tile's tile for 0).
int mixstage_fused_decoder_bf16(const __nv_bfloat16* x,
                                const __nv_bfloat16* wp, const float* biases,
                                const float* bl, __nv_bfloat16* out, int B,
                                int T, int C0, int C, int L, int F, int G,
                                float slope, int tile_t, long long gstride,
                                void* stream) {
  return launch<1, false>(x, wp, biases, bl, out, B, T, C0, C, L, F, G,
                          slope, tile_t, gstride, stream);
}

// K2's time tile in the f32 (bf16) mode: as mixstage_fused_decoder_f32_tile
// for a chain of L layers of C channels in G groups.
int mixstage_conv_chain_f32_tile(int B, int T, int C, int L, int G,
                                 int sm_count, size_t smem_limit) {
  return pick_tile(3, B, T, C, C, k3_layers(true, L), C, G, sm_count,
                   smem_limit);
}

int mixstage_conv_chain_bf16_tile(int B, int T, int C, int L, int G,
                                  int sm_count, size_t smem_limit) {
  return pick_tile(1, B, T, C, C, k3_layers(true, L), C, G, sm_count,
                   smem_limit);
}

// Launch K2's f32 mode, the grouped conv chain, as
// mixstage_fused_decoder_f32 launches K1 (tile_t 0: the _tile query's
// choice; the same error codes).  Device pointers to contiguous arrays: x
// and out (B, T, G*C) f32; wp (G, gstride) bf16 in pack_chain_bf16's layout
// (pack_decoder_bf16's chunks of the L chain layers), 16-byte aligned;
// biases (L, G*C) f32.
int mixstage_conv_chain_f32(const float* x, const __nv_bfloat16* wp,
                            const float* biases, float* out, int B, int T,
                            int C, int L, int G, float slope, int tile_t,
                            long long gstride, void* stream) {
  return launch<3, true>(x, wp, biases, nullptr, out, B, T, C, C, L, C, G,
                         slope, tile_t, gstride, stream);
}

// K2's bf16 mode: as mixstage_conv_chain_f32 with x and out bf16.
int mixstage_conv_chain_bf16(const __nv_bfloat16* x, const __nv_bfloat16* wp,
                             const float* biases, __nv_bfloat16* out, int B,
                             int T, int C, int L, int G, float slope,
                             int tile_t, long long gstride, void* stream) {
  return launch<1, true>(x, wp, biases, nullptr, out, B, T, C, C, L, C, G,
                         slope, tile_t, gstride, stream);
}

const char* mixstage_fused_decoder_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
