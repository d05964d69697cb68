// K4: the int8 BN-folded Mix-StAGE mixture decoder for NVIDIA Hopper
// (sm_90a), on f32 features or the bf16 features of a bf16 model.
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
// even like torch.round and jnp.round.  In the bf16-feature mode
// (mixstage_decoder_int8_bf16; quantize_input promotes bf16 / f32) each
// feature is loaded as one 2-byte value (a row of C0 = 266 bf16 values is
// 532 bytes, so rows are only 4-byte aligned), widened exactly, then
// divided and quantized as in the f32 mode; nothing else differs, and the
// logits are f32 in both modes.
//
// What bounds it: 26.83 G int8 operations per bs32 decoder call (G = 8,
// C0 = 266, C = 256, L = 3, F = 96) against 6.6 MB of int8 weights and
// 8.5 MB of f32 activations in and out: bound by operations at the card's
// 1,979 TOP/s int8 rate, 0.0136 ms.  Only wgmma reaches that rate on
// Hopper; the mma.sync kernel this one replaces ran at 6.4% of it.
//
// The plan.  One CTA owns a (time tile, sequence, group) block and keeps
// the tile's int8 activations in shared memory across all L + 2 layers (a
// halo of L + 1 frames on each side is recomputed by the neighbouring
// tile; rows outside [0, T) stay zero: the per-sequence 'same' padding).
// Each layer is a transposed GEMM per tap, D^T[c_out, rows] = W^T[c_out,
// c_in] X^T[c_in, rows], on wgmma m64nNk32 s8 with exact s32 sums: A (M =
// 64 output channels per consumer warpgroup) is a chunk of 32 input
// channels of one tap's weights, B (N rows) the activation tile.  8-bit
// wgmma has no transpose, so both operands are K-major without swizzle
// (wgmma.cuh): activations as [channel / 16][row][16 bytes], so the three
// taps of a k=3 conv are one B descriptor moved by -16, 0, +16 bytes; the
// weights as ops/cuda/quant.py::pack_decoder_int8 packs them once, when
// the serving function is built, chunk by chunk in exactly the image
// wgmma reads: per (layer, group, tap, 32 input channels) [2 halves of 16
// channels][c_out padded to 64][16 bytes], zero past c_in and c_out.  N is
// the kernel instance's (kWidths): the narrowest that covers the tile's
// widest layer, tile + 2L rows and never more than T, so every wgmma has
// one shape.  C0 = 266 is read as 288 channels of zero weights past 266.
//
// A warp-specialised pipeline.  One thread of a producer warpgroup streams
// every chunk of every layer, in order, into a ring of kStages
// shared-memory stages of kGroupChunks chunks each, one cp.async.bulk copy
// per stage (a group's chunks lie one after the other in the image)
// completing on the stage's full mbarrier; it runs ahead across layer
// boundaries, so the next layer's weights are in flight during each
// epilogue.  Four consumer warpgroups (one per 64 output channels; C, F <=
// 256) wait on a stage, issue its wgmmas as one straight-line committed
// group (ptxas serialises wgmmas behind a divergent path: a warpgroup past
// c_out multiplies m-block 0 again and stores nothing), and release each
// stage on its empty mbarrier once the group after it is issued and it has
// completed (wgmma.wait_group 1).  The s32 sums are
// exact, so there are no partials: one accumulator set serves a layer,
// zeroed by its first wgmma (scale-d 0).  The epilogue (dequantize, bias,
// leaky, requantize; op for op as above) writes the next layer's image
// into the other buffer, then a proxy fence and a barrier of the consumers
// hand it to the next layer's wgmmas; the logits go to global memory in
// f32.  The producer is a whole warpgroup so that setmaxnreg can hand its
// registers to the consumers.  The time tile and N follow the cost rule of
// pick_tile below.
//
// What the measurements found (NVIDIA H100 80GB HBM3, 700 W; bs32 x 64;
// tools/k4_variants.py, PERF.md section 6).  The mma.sync kernel
// before this one (0.2129 ms) lost 11% without its MMAs (their fragment
// loads kept), 29% without its weight copies, 37% without both, nothing
// without its epilogue stores: its fragment loads, barriers and fixed
// costs bound it.  This kernel's first version, one bulk copy and one
// handshake per 32-channel chunk (0.1235 ms), lost nothing without its
// copies and 37% without its MMAs: it paid per chunk, so a stage now
// holds a group of four chunks, one copy and one handshake for each
// (0.0932 ms).  Its epilogue then cost 39% and its input stage 17%: both
// rounded through rintf and float-to-int conversions, which quant8 now
// does with adds (0.0855 ms), and the input stage now has its loads in
// flight together, off the critical path.  What is left is about a third
// each: the wgmmas (both operands from shared memory), the epilogues, and
// fixed costs (the launch, the ring's first fill, a barrier a layer), in
// series within a CTA; the byte-wide stores of the epilogue cost nothing
// measurable.

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
// registers per thread: 5 x 128 threads launch with 96 each, and
// setmaxnreg moves them within that allocation (as fused_decoder_wgmma.cu)
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 112;
constexpr int kMaxCout = 64 * kConsumerWGs;
constexpr int kChunkK = 32;                 // input channels per chunk
constexpr int kGroupChunks = 4;             // chunks per stage and group
constexpr int kStages = 4;                  // groups in the ring, at most
constexpr int kMaxTile = 64;
constexpr int kInputBatch = 4;              // input words a thread loads at once
constexpr int kBarBytes = 2 * 8 * kStages;  // the ring's mbarriers
// the cost rule's fixed cost of a CTA (input stage, pipeline fill), in
// rows of N
constexpr int kFixedRows = 16;

__host__ __device__ inline int round32(int n) { return (n + 31) & ~31; }
__host__ __device__ inline int round64(int n) { return (n + 63) & ~63; }

// Bytes of one packed chunk: 32 input channels x c_out padded to 64.
__host__ __device__ inline int chunk_bytes(int cout) {
  return kChunkK * round64(cout);
}

// Byte of channel m, row r in an activation image of nrows rows.
__device__ __forceinline__ int act_byte(int m, int r, int nrows) {
  return ((m >> 4) * nrows + r) * 16 + (m & 15);
}

// clip(round(v), +-127), rounding half to even: clamped first (the same
// result for every v; NaN gives -127 either way), then rounded by adding
// 1.5 * 2^23, whose float has an ulp of 1, and read back from its low
// bits: two full-rate adds where rintf and a float-to-int conversion would
// each take the SM's quarter-rate conversion unit.
__device__ __forceinline__ int quant8(float v) {
  const float c = fminf(fmaxf(v, -127.f), 127.f);
  return __float_as_int(__fadd_rn(c, 12582912.f)) - 0x4B400000;
}

// Feature i of x as f32: the f32 value, or the bf16 value widened (exact).
__device__ __forceinline__ float feature(const void* x, size_t i, bool bf16) {
  return bf16 ? __bfloat162float(
                    __ldg(static_cast<const __nv_bfloat16*>(x) + i))
              : __ldg(static_cast<const float*>(x) + i);
}

// Layer l of the chain (0: C0 -> C, 1..L: C -> C, L + 1: the logits).
struct Layer {
  int cin, cout, taps, nk;                  // nk: 32-channel chunks per tap
  __host__ __device__ Layer(int l, int C0, int C, int L, int F)
      : cin(l == 0 ? C0 : C), cout(l == L + 1 ? F : C),
        taps(l == L + 1 ? 1 : 3), nk((cin + kChunkK - 1) / kChunkK) {}
  __host__ __device__ int chunks() const { return taps * nk; }
  __host__ __device__ size_t bytes() const {  // one group's image
    return (size_t)chunks() * chunk_bytes(cout);
  }
};

// The NC wgmmas of a group of NC chunks as one committed group, in
// straight-line code from the fence to the commit: chunk c's A (a[c], this
// warpgroup's 64 rows of its image) times its B (b[c]) into d; the
// layer's first wgmma (first) zeroes d.
template <int N, int NC>
__device__ __forceinline__ void mma_group(int (&d)[N / 2],
                                          const uint32_t (&a)[kGroupChunks],
                                          const uint32_t (&b)[kGroupChunks],
                                          bool first, uint32_t lbo_a,
                                          uint32_t lbo_b) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) sm90::fence_operand(d[i]);
  sm90::wgmma_fence();
#pragma unroll
  for (int c = 0; c < NC; ++c)
    sm90::wgmma_s8<N>(d, sm90::matrix_desc(a[c], lbo_a, 128),
                      sm90::matrix_desc(b[c], lbo_b, 128),
                      (c > 0 || !first) ? 1 : 0);
  sm90::wgmma_commit();
}

// mma_group<N, nc> for a runtime nc in [1, NC] (a layer's last group may
// hold fewer chunks).
template <int N, int NC>
__device__ __forceinline__ void mma_group_n(int nc, int (&d)[N / 2],
                                            const uint32_t (&a)[kGroupChunks],
                                            const uint32_t (&b)[kGroupChunks],
                                            bool first, uint32_t lbo_a,
                                            uint32_t lbo_b) {
  if (nc == NC) {
    mma_group<N, NC>(d, a, b, first, lbo_a, lbo_b);
  } else if constexpr (NC > 1) {
    mma_group_n<N, NC - 1>(nc, d, a, b, first, lbo_a, lbo_b);
  }
}

// N: the rows (B's columns) of every wgmma, at least any layer's rows.
// 512 consumer threads (4 warpgroups) and a producer warpgroup.  x is f32,
// or bf16 where x_bf16.
template <int N>
__global__ void __launch_bounds__(kThreads, 1) decoder_int8_kernel(
    const void* __restrict__ x, int x_bf16, const float* __restrict__ s_in,
    const int8_t* __restrict__ w0, const int8_t* __restrict__ wc,
    const int8_t* __restrict__ wl, const float* __restrict__ m0,
    const float* __restrict__ mc, const float* __restrict__ ml,
    const float* __restrict__ rq, const float* __restrict__ biases,
    const float* __restrict__ bl, float* __restrict__ out, int T, int C0,
    int C, int L, int F, int G, int tile_t, int nrows, int kp0, int stage,
    int nstages, float slope) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  unsigned char* ring = smem + kBarBytes;
  int8_t* buf0 = reinterpret_cast<int8_t*>(ring + (size_t)nstages * stage);
  int8_t* buf1 = buf0 + (size_t)kp0 * nrows;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int halo = L + 1, nr = tile_t + 2 * halo;
  const int b = blockIdx.y, g = blockIdx.z;
  const int t_first = blockIdx.x * tile_t - halo;   // time of tile row 0
  // rows holding t in [0, T); the rest stay zero: the 'same' zero padding
  const int v_lo = max(0, -t_first);
  const int v_hi = min(nr, T - t_first);
  if (tid == 0) {
    for (int s = 0; s < nstages; ++s) {
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
      int s = 0;
      uint32_t ph = 0;
      for (int l = 0; l <= L + 1; ++l) {
        const Layer ly(l, C0, C, L, F);
        const int8_t* src = l == 0 ? w0 + g * ly.bytes()
                            : l <= L
                                ? wc + ((size_t)(l - 1) * G + g) * ly.bytes()
                                : wl + g * ly.bytes();
        // a group's chunks lie one after the other in the image
        for (int c0 = 0; c0 < ly.chunks(); c0 += kGroupChunks) {
          const uint32_t bytes =
              min(kGroupChunks, ly.chunks() - c0) * chunk_bytes(ly.cout);
          sm90::mbar_wait(&empty[s], ph ^ 1);   // round 0 passes at once
          sm90::mbar_arrive_expect_tx(&full[s], bytes);
          sm90::bulk_copy(ring + (size_t)s * stage, src, bytes, &full[s]);
          src += bytes;
          if (++s == nstages) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: zero buf1; quantize the input rows of sequence b into
  // buf0, four channels to a 32-bit word (zero outside [v_lo, v_hi) and
  // past C0); nrows is odd, so the 16-byte lines of one row's channel
  // slices fall on distinct banks
  sm90::setmaxnreg_inc<kConsumerRegs>();
  {
    uint4* z = reinterpret_cast<uint4*>(buf1);
    const int nz = round32(C) * nrows / 16;
    for (int i = tid; i < nz; i += kConsumerThreads)
      z[i] = make_uint4(0, 0, 0, 0);
    // kInputBatch words a thread, their loads all in flight before the
    // first division; a feature outside the sequence or past C0 is 0 / 1
    const int nw = kp0 / 4, items = nrows * nw;   // words of a row, in all
    for (int i0 = tid; i0 < items; i0 += kInputBatch * kConsumerThreads) {
      float v[kInputBatch][4], sc[kInputBatch][4];
#pragma unroll
      for (int k = 0; k < kInputBatch; ++k) {
        const int i = i0 + k * kConsumerThreads;
        const int r = i / nw, wd = i - r * nw;
        const bool live = i < items && r >= v_lo && r < v_hi;
        const size_t row = ((size_t)b * T + (t_first + r)) * C0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ch = 4 * wd + e;
          const bool ok = live && ch < C0;
          v[k][e] = ok ? feature(x, row + ch, x_bf16) : 0.f;
          sc[k][e] = ok ? __ldg(s_in + ch) : 1.f;
        }
      }
#pragma unroll
      for (int k = 0; k < kInputBatch; ++k) {
        const int i = i0 + k * kConsumerThreads;
        if (i < items) {
          const int r = i / nw, wd = i - r * nw;
          uint32_t word = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            word |= ((uint32_t)quant8(__fdiv_rn(v[k][e], sc[k][e])) & 0xffu)
                    << (8 * e);
          *reinterpret_cast<uint32_t*>(buf0 + act_byte(4 * wd, r, nrows)) =
              word;
        }
      }
    }
  }
  sm90::fence_proxy_async();
  sm90::named_barrier(1, kConsumerThreads);

  const int wg = warp >> 2, w4 = warp & 3;
  const uint32_t lbo_b = (uint32_t)nrows * 16;       // next 16 channels
  int s = 0;
  uint32_t ph = 0;
  int acc[N / 2];
  for (int l = 0; l <= L + 1; ++l) {
    const bool logits = l == L + 1;
    const Layer ly(l, C0, C, L, F);
    const int mp = round64(ly.cout);
    // rows [lo, hi) of this layer's output (layer l reads [l, nr - l)),
    // computed as the N rows from lo
    const int lo = logits ? max(halo, v_lo) : max(l + 1, v_lo);
    const int hi = logits ? min(halo + tile_t, v_hi) : min(nr - l - 1, v_hi);
    const int8_t* in = (l & 1) ? buf1 : buf0;
    int8_t* nxt = (l & 1) ? buf0 : buf1;
    // B of tap 0: rows lo - 1 .. (k=3), lo .. (the 1x1 logits)
    const uint32_t b_addr =
        sm90::smem_u32(in) + (uint32_t)(lo - ly.taps / 2) * 16;
    // a warpgroup past c_out multiplies m-block 0 again
    const int mb = wg * 64 < mp ? wg : 0;
    const uint32_t a_addr = sm90::smem_u32(ring) + (uint32_t)mb * 64 * 16;
    // the epilogue's dequant multipliers, biases and requant reciprocals of
    // this thread's two channels, loaded while the MMAs run
    const int ch0 = wg * 64 + 16 * w4 + (lane >> 2);
    float mu[2], bi[2], rr[2];
    {
      const float* mult = l == 0   ? m0 + (size_t)g * C
                          : logits ? ml + (size_t)g * F
                                   : mc + ((size_t)(l - 1) * G + g) * C;
      const float* bias = logits ? bl + (size_t)g * F
                                 : biases + ((size_t)g * (L + 1) + l) * C;
      const float* req = rq + ((size_t)g * (L + 1) + l) * C;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = ch0 + 8 * h;
        const bool ok = m < ly.cout;
        mu[h] = ok ? __ldg(mult + m) : 0.f;
        bi[h] = ok ? __ldg(bias + m) : 0.f;
        rr[h] = ok && !logits ? __ldg(req + m) : 0.f;
      }
    }
    const int n = ly.chunks();
    const uint32_t cbytes = chunk_bytes(ly.cout);
    int tap = 0, kc = 0, s_prev = -1;
    for (int c0 = 0; c0 < n; c0 += kGroupChunks) {
      const int nc = min(kGroupChunks, n - c0);
      // wait for the group's stage; its chunks' A and B addresses
      sm90::mbar_wait(&full[s], ph);
      uint32_t a[kGroupChunks], bb[kGroupChunks];
#pragma unroll
      for (int i = 0; i < kGroupChunks; ++i) {
        a[i] = a_addr + (uint32_t)s * stage + i * cbytes;
        bb[i] = b_addr + (uint32_t)(2 * kc * nrows + tap) * 16;
        if (++kc == ly.nk) {
          kc = 0;
          ++tap;
        }
      }
      mma_group_n<N, kGroupChunks>(nc, acc, a, bb, c0 == 0, mp * 16,
                                   lbo_b);
      // the group before this one has completed: this warp releases its
      // stage
      sm90::wgmma_wait<1>();
      if (s_prev >= 0 && lane == 0) sm90::mbar_arrive(&empty[s_prev]);
      s_prev = s;
      if (++s == nstages) {
        s = 0;
        ph ^= 1;
      }
    }
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < N / 2; ++i) sm90::fence_operand(acc[i]);
    if (s_prev >= 0 && lane == 0) sm90::mbar_arrive(&empty[s_prev]);

    // epilogue, op for op as decoder_int8_plain: register 4j + e holds
    // channel ch0 + 8 (e / 2), row r0 + 8j + e % 2 (wgmma.cuh)
    if (wg * 64 < ly.cout) {
      const int r0 = lo + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, m = ch0 + 8 * h, r = r0 + 8 * j + (e & 1);
          if (m < ly.cout && r < hi) {
            float y = __fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j + e]),
                                          mu[h]), bi[h]);
            if (logits) {
              out[((size_t)b * T + (t_first + r)) * G * F + (size_t)g * F +
                  m] = y;
            } else {
              y = y >= 0.f ? y : __fmul_rn(slope, y);
              const int q = quant8(__fmul_rn(y, rr[h]));
              nxt[act_byte(m, r, nrows)] = (int8_t)q;
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

// The kernel instances: wgmma widths N (rows), narrowest first.
constexpr int kWidths[] = {16, 24, 32, 48, 64, 80, 128};
using Kernel = decltype(&decoder_int8_kernel<16>);
constexpr Kernel kKernels[] = {
    decoder_int8_kernel<16>, decoder_int8_kernel<24>,
    decoder_int8_kernel<32>, decoder_int8_kernel<48>,
    decoder_int8_kernel<64>, decoder_int8_kernel<80>,
    decoder_int8_kernel<128>};
constexpr int kInstances = sizeof(kWidths) / sizeof(kWidths[0]);

// A launch's instance and shared memory for tiles of tile_t frames.  Layer
// 0 computes the most rows, tile_t + 2L and never more than T; the
// instance is the narrowest N that covers them (inst = -1: none).  The
// shared memory holds the barriers, the weight ring and two activation
// images of nrows rows: buf0 of kp0 channels (the input, C0, and every
// other hidden layer), buf1 of round32(C); nrows is the tile's tile_t +
// 2(L + 1) rows or, if more, the L + 2 + N that a layer's N rows from its
// first row (at most row L + 1) read with their taps, made odd.  The ring
// has kStages stages, or as few as 2 where the images need the room (a
// wide C0, a deep chain), so the widths the mma.sync kernel before it took
// still fit.
struct Plan {
  int inst = -1, nrows = 0, kp0, kp1, stage, nstages = kStages;
  size_t bytes = 0;
  Plan(int T, int C0, int C, int L, int F, int tile_t, size_t smem_limit)
      : kp0(round32(C0 > C ? C0 : C)), kp1(round32(C)),
        stage(kGroupChunks * chunk_bytes(C > F ? C : F)) {
    const int rows = tile_t + 2 * L < T ? tile_t + 2 * L : T;
    for (int i = kInstances - 1; i >= 0 && tile_t > 0; --i)
      if (rows <= kWidths[i]) inst = i;
    if (inst < 0) return;
    nrows = tile_t + 2 * (L + 1);
    if (nrows < L + 2 + kWidths[inst]) nrows = L + 2 + kWidths[inst];
    nrows |= 1;
    const size_t images = (size_t)(kp0 + kp1) * nrows;
    while (nstages > 2 &&
           kBarBytes + (size_t)nstages * stage + images > smem_limit)
      --nstages;
    bytes = kBarBytes + (size_t)nstages * stage + images;
  }
  bool fits(size_t smem_limit) const {
    return inst >= 0 && bytes <= smem_limit;
  }
};

// The time tile: of the tiles 8, 16, 32, 64 that fit and half of which
// does not already cover T, the one with the least estimated time, waves
// of CTAs (ceil(G B ceil(T / tile) / sm_count)) times a CTA's cost, which
// is kFixedRows + N rows (every layer computes N rows); ties go to the
// smaller tile.  0 when none fits.  At bs32 x 64 (G = 8) it picks 64 (256
// CTAs, two waves on 132 SMs, N = 64: of layer 0's 70 rows only T = 64
// exist); one 64-frame clip 8 (64 CTAs, one wave, N = 16); the ragged
// B=3 T=50 16 (96 CTAs, one wave, N = 24).
int pick_tile(int B, int T, int C0, int C, int L, int F, int G, int sm_count,
              size_t smem_limit) {
  int best = 0;
  long long best_cost = 0;
  for (int tile = 8; tile <= kMaxTile; tile *= 2) {
    if (tile > 8 && tile / 2 >= T) continue;
    const Plan plan(T, C0, C, L, F, tile, smem_limit);
    if (!plan.fits(smem_limit)) continue;
    const long long ctas = (long long)G * B * ((T + tile - 1) / tile);
    const long long cost = (ctas + sm_count - 1) / sm_count *
                           (kFixedRows + kWidths[plan.inst]);
    if (best == 0 || cost < best_cost) {
      best = tile;
      best_cost = cost;
    }
  }
  return best;
}

int launch(const void* x, bool bf16, const float* s_in, const int8_t* w0,
           const int8_t* wc, const int8_t* wl, const float* m0,
           const float* mc, const float* ml, const float* rq,
           const float* biases, const float* bl, float* out, int B, int T,
           int C0, int C, int L, int F, int G, float slope, int tile_t,
           void* stream) {
  // bulk copies read 16-byte aligned chunks
  const bool aligned = ((uintptr_t)w0 | (L > 0 ? (uintptr_t)wc : 0) |
                        (uintptr_t)wl) % 16 == 0;
  if (B <= 0 || T <= 0 || C0 <= 0 || C <= 0 || L < 0 || F <= 0 || G <= 0 ||
      B > 65535 || G > 65535 || C > kMaxCout || F > kMaxCout || tile_t < 0 ||
      !aligned)
    return (int)cudaErrorInvalidValue;
  int sms, smem_limit;
  cudaError_t err = card(&sms, &smem_limit);
  if (err != cudaSuccess) return (int)err;
  if (tile_t == 0) tile_t = pick_tile(B, T, C0, C, L, F, G, sms, smem_limit);
  const Plan plan(T, C0, C, L, F, tile_t, smem_limit);
  if (!plan.fits(smem_limit)) return (int)cudaErrorInvalidValue;
  const Kernel kernel = kKernels[plan.inst];
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)plan.bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + tile_t - 1) / tile_t, B, G);
  kernel<<<grid, kThreads, plan.bytes, (cudaStream_t)stream>>>(
      x, bf16 ? 1 : 0, s_in, w0, wc, wl, m0, mc, ml, rq, biases, bl, out, T,
      C0, C, L, F, G, tile_t, plan.nrows, plan.kp0, plan.stage, plan.nstages,
      slope);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Output frames per CTA on a card of `sm_count` SMs with `smem_limit` bytes
// of dynamic shared memory per CTA (pick_tile's rule); 0 when no tile fits.
int mixstage_decoder_int8_tile(int B, int T, int C0, int C, int L, int F,
                               int G, int sm_count, size_t smem_limit) {
  return pick_tile(B, T, C0, C, L, F, G, sm_count, smem_limit);
}

// The wgmma width N (rows) of a launch with tiles of tile_t frames at T
// frames and L chain layers; 0 when no instance covers its rows.
int mixstage_decoder_int8_width(int T, int L, int tile_t) {
  const Plan plan(T, 1, 1, L, 1, tile_t, (size_t)-1);
  return plan.inst < 0 ? 0 : kWidths[plan.inst];
}

// Launch on `stream` on the current device with `tile_t` output frames per
// CTA (0: mixstage_decoder_int8_tile's choice for that device); returns the
// cudaError_t of the launch (0 = success; cudaErrorInvalidValue for a bad
// shape, an image not 16-byte aligned, or a tile that does not fit).  All
// pointers are device pointers to contiguous arrays:
//   x (B, T, C0) f32; s_in (C0,) f32 input scales;
//   w0 (G, 3, n0, 2, c64, 16), wc (L, G, 3, n, 2, c64, 16), wl (G, n, 2,
//   f64, 16) int8 images (pack_decoder_int8): per tap and 32 input
//   channels (n0 = ceil(C0 / 32), n = ceil(C / 32)), two halves of 16
//   channels, each output channel (padded to c64 = round64(C), f64 =
//   round64(F)) a 16-byte line of its weights, zero past C0, C and F;
//   m0 (G, C), mc (L, G, C), ml (G, F) f32 dequant multipliers;
//   rq (G, L+1, C) f32 requant reciprocals; biases (G, L+1, C), bl (G, F);
//   out (B, T, G*F) f32.
int mixstage_decoder_int8(const float* x, const float* s_in,
                          const int8_t* w0, const int8_t* wc,
                          const int8_t* wl, const float* m0, const float* mc,
                          const float* ml, const float* rq,
                          const float* biases, const float* bl, float* out,
                          int B, int T, int C0, int C, int L, int F, int G,
                          float slope, int tile_t, void* stream) {
  return launch(x, false, s_in, w0, wc, wl, m0, mc, ml, rq, biases, bl, out,
                B, T, C0, C, L, F, G, slope, tile_t, stream);
}

// bf16-feature mode: as mixstage_decoder_int8 with x (B, T, C0) contiguous
// bfloat16; everything else, out included, as there.
int mixstage_decoder_int8_bf16(const __nv_bfloat16* x, const float* s_in,
                               const int8_t* w0, const int8_t* wc,
                               const int8_t* wl, const float* m0,
                               const float* mc, const float* ml,
                               const float* rq, const float* biases,
                               const float* bl, float* out, int B, int T,
                               int C0, int C, int L, int F, int G,
                               float slope, int tile_t, void* stream) {
  return launch(x, true, s_in, w0, wc, wl, m0, mc, ml, rq, biases, bl, out,
                B, T, C0, C, L, F, G, slope, tile_t, stream);
}

const char* mixstage_decoder_int8_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
