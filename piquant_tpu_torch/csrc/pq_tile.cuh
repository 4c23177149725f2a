// Device helpers shared by the tensor-core GEMM kernels (qmatmul_a8.cu,
// qmatmul_ragged.cu): cp.async staging and the 4x4 byte transpose that
// turns N-contiguous packed weight words into K-contiguous mma operands.
#pragma once

#include <stdint.h>

namespace pq {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool live) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int bytes = live ? 16 : 0;   // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// r[i] holds row i's bytes of 4 columns; afterwards r[j] holds column j's
// bytes of the 4 rows (byte i = row i).
__device__ __forceinline__ void transpose4(uint32_t (&r)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  r[0] = __byte_perm(t0, t2, 0x5410);
  r[1] = __byte_perm(t0, t2, 0x7632);
  r[2] = __byte_perm(t1, t3, 0x5410);
  r[3] = __byte_perm(t1, t3, 0x7632);
}

}  // namespace pq
