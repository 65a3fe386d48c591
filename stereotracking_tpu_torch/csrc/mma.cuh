// Warp-level tensor-core and copy primitives (inline PTX, sm_80+): the
// bf16 m16n8k16 product with float32 accumulation, ldmatrix, cp.async.
// Used by the stem (stem.cu) and the stage chain (mma_chain.cuh) of stages
// 1-3.
//
// m16n8k16 fragments, g = lane / 4, t = lane % 4, two bf16 per register
// (the lower k or column in the low half):
//   A (16 x 16, row-major): a0 (row g, k 2t..2t+1), a1 (row g + 8, same k),
//                           a2 (row g, k 2t+8..), a3 (row g + 8, k 2t+8..)
//   B (16 x 8):             b0 (k 2t..2t+1, column g), b1 (k 2t+8.., col g)
//   C (16 x 8, float32):    c0, c1 (row g, columns 2t, 2t+1), c2, c3 (row
//                           g + 8, same columns)
#pragma once

#include "common.cuh"

namespace st_mma {

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and register i of each lane holds its part of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The same, each matrix transposed: from a row-major (k, n) tile it gives
// the B fragments of the m16n8k16 product.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy to shared memory; src_bytes = 0 writes zeros
// (src must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ConvBNAct tail as st_act (folded BN and SiLU in float32, one bf16
// rounding) with the special-function unit's exponential and reciprocal
// (__expf, __fdividef): relative error of order 1e-6 where the float32
// value is below 2^126 in magnitude, far below bf16's half ulp (2^-9), so a
// result differs from st_act's by at most one bf16 ulp, and only where the
// float32 value lies that close to a rounding boundary.  It takes two SFU
// operations per output against st_act's IEEE division and exponential.
__device__ __forceinline__ bf16 act_fast(float acc, float scale, float bias) {
  const float y = fmaf(acc, scale, bias);
  return __float2bfloat16_rn(__fdividef(y, 1.0f + __expf(-y)));
}

__device__ __forceinline__ uint32_t pack_bf16x2(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ bf16 lo_bf16(uint32_t v) {
  return __ushort_as_bfloat16(static_cast<unsigned short>(v & 0xffffu));
}

__device__ __forceinline__ bf16 hi_bf16(uint32_t v) {
  return __ushort_as_bfloat16(static_cast<unsigned short>(v >> 16));
}

}  // namespace st_mma
