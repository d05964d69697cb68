// Device helpers of the mma.sync kernel K3 in its f32 mode
// (train_decoder.cu): the cp.async copies that stage its operands, and the
// warp-level mma.sync / ldmatrix instructions.
//
// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32 and mma.m16n8k16 .bf16),
// with g = lane / 4 and t = lane % 4, in 32-bit words (one tf32 value or
// two bf16 values of consecutive k):
//   A (16 x 8 words, row-major):  a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)
//                                 a3 (g+8, t+4)
//   B (8 words x 8, k-major):     b0 (t, g)  b1 (t+4, g)
//   C (16 x 8, f32):              c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)
//                                 c3 (g+8, 2t+1)
// For bf16, ldmatrix.x4 loads four 8 x 8 blocks of 16-bit values whose
// eight rows (16 bytes each) lanes 8i .. 8i+7 address: without .trans,
// lane (g, t) gets elements (g, 2t), (g, 2t+1) of each block, which are
// a0..a3 of a row-major A (blocks: rows 0-7 / 8-15 x k 0-7 / 8-15) and b0,
// b1 of an n-major B; with .trans it gets (2t, g), (2t+1, g), which are the
// fragments of a k-major B or of an A stored k-major.  A row stride of 4
// mod 8 words puts the eight rows of a block on distinct bank quads.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mixstage {

__host__ __device__ inline int round8(int n) { return (n + 7) & ~7; }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Copy `bytes` (0 or the full size: 0 writes zeros) from global to shared
// memory without passing through registers.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// v rounded to tf32 (10 mantissa bits, to nearest, ties away from zero),
// as the bits of an f32 whose low 13 bits are 0.
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// The 3xTF32 split: v = hi + lo (exactly up to lo's own rounding).
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(__fsub_rn(v, __uint_as_float(hi)));
}

// d += a (16x8 tf32) * b (8x8 tf32), f32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a (16x16 bf16) * b (16x8 bf16), f32 accumulation; each product of
// two bf16 values is exact in f32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8x8 blocks of 16-bit values from shared memory; `row` is this
// lane's row address (lanes 8i .. 8i+7: the rows of block i).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// ldmatrix_x4 with .trans: each block transposed.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

}  // namespace mixstage
