// Warp-level tensor-core helpers shared by the decode-attention kernels
// (decode_attn2.cu, decode_wide.cu) and the wide-head flash kernel
// (flash_wide.cu): the m16n8k16 bf16 product with f32 sums, exact bf16
// pairs from int8 and offset-8 int4 codes, bf16 packing, byte gathers,
// ldmatrix and cp.async.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pq_hopper.cuh"

namespace pq {

// c[16 x 8] += A[16 x 16] B[16 x 8]: bf16 in, f32 sums (row.col fragments)
__device__ __forceinline__ void mma16816(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// int8 codes in bytes 0 and 2 of w -> bf16x2 (low half: byte 0), exactly:
// (128 + low 7 bits) - (128, or 256 when the sign bit is set)
__device__ __forceinline__ uint32_t s8_pair(uint32_t w) {
  return bf16x2_sub((w & 0x007F007Fu) | 0x43004300u,
                    (w & 0x00800080u) | 0x43004300u);
}

// offset-8 nibbles in bits 0-3 of bytes 0 and 2 of w -> bf16x2, exactly
__device__ __forceinline__ uint32_t u4_pair(uint32_t w) {
  return bf16x2_sub((w & 0x000F000Fu) | 0x43004300u, 0x43084308u);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// byte j of a into bytes 0 and 1, byte j of b into bytes 2 and 3
__device__ __forceinline__ uint32_t gather(uint32_t a, uint32_t b, int j) {
  return __byte_perm(a, b, j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// 16 bytes, or 16 zero bytes where !on (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool on) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(on ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every cp.async group of this thread but the newest n has landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// four 8 x 8 bf16 matrices, rows at the addresses of lanes 8i .. 8i + 7;
// `trans` hands each thread a column pair instead of a row pair
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

}  // namespace pq
