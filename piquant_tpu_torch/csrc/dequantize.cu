// pq_dequantize: affine codes (packed for the sub-byte types) -> f32 / bf16,
// with the SET or the ADD store.
//
// Replaces piquant_tpu/ops/pallas/dequantize.py::_direct_kernel (:39; calls
// :56, :64: u8 / i8 / u16 / i16 codes) and ::_mxu_unpack_kernel (:76; calls
// :116, :124: uint4 / int4 / uint2 bytes back to wire order, int4
// sign-extended): one kernel templated on the code width.  The TPU
// interleaved its field planes with a matrix product on the MXU; here a
// thread shifts the fields out of its own bytes.
//
//   v = (code - zp) * scale        (difference exact in int32, __fmul_rn)
//   SET: out = round_T(v)
//   ADD: out = round_T(out + round_T(v))     (sum in f32, __fadd_rn)
//
// ADD rounds the addend to the output type before the sum, as the jnp
// reference does (for bf16 the Pallas kernel added in f32 and rounded once;
// the port follows the reference the tests compare with).  ADD is in place:
// the accumulator is the output pointer, read and written in one pass.
//
// Bound on the H100: bytes.  u8 -> f32 SET moves 5 bytes per element, ADD
// 9 (the accumulator is read too); at numel 27,264,000 and 3.35 TB/s that is
// 0.0407 ms and 0.0732 ms.  The card's own streams set the practical line:
// on an H100 `fill_` (writes only) and `copy_` stream a little faster
// than `torch.dequantize` moves this mix (1 byte read, 4 written).  Design: a
// warp takes 32 x kUnroll consecutive groups of 4 elements, a lane its
// groups 32 apart, so every load and store instruction of the warp is
// coalesced (a group's codes are 4 bytes of u8 codes, 2 of uint4; its
// output one 16-byte f32 store); each thread issues the loads of all its
// groups (codes, and for ADD the accumulator) before it converts, and the
// write-once output (and ADD's accumulator read) carries the streaming,
// evict-first hint (.cs).  One such chunk a block's warp, the grid as
// large as the call: on an H100, a persistent grid (blocks = SMs x
// resident blocks) and a ring of bulk copies into shared memory both ran
// slower at numel 27,264,000.  The elements past the last whole group, and a
// buffer that is not 16-byte aligned (a view into a larger tensor), take
// element-wise accesses, reading only the bytes the packed buffer has.

#include <type_traits>

#include "pq_quant.cuh"

namespace {

using pq::kElems;

// The codes of chunk c (8 elements, cnt of them live; zero past cnt),
// reading only the bytes the buffer has.
template <int BITS>
__device__ __forceinline__ void load_codes(const uint8_t* __restrict__ q,
                                           int64_t c, int cnt, int is_signed,
                                           int code[kElems]) {
  if constexpr (BITS == 8 || BITS == 16) {
    using C = typename std::conditional<BITS == 8, uint8_t, uint16_t>::type;
    const C* p = reinterpret_cast<const C*>(q) + c * 8;
#pragma unroll
    for (int k = 0; k < kElems; ++k) {
      const C v = k < cnt ? p[k] : 0;
      code[k] = !is_signed ? (int)v
                : BITS == 8 ? (int)(int8_t)v : (int)(int16_t)v;
    }
  } else {
    constexpr int PER = 8 / BITS;
    constexpr int MASK = (1 << BITS) - 1;
    constexpr int HALF = 1 << (BITS - 1);
    const uint8_t* p = q + c * (kElems / PER);
    uint32_t w = 0;
    const int nb = (cnt + PER - 1) / PER;
    for (int j = 0; j < nb; ++j) w |= (uint32_t)p[j] << (8 * j);
#pragma unroll
    for (int k = 0; k < kElems; ++k) {
      const int f = (int)((w >> (BITS * k)) & MASK);
      code[k] = is_signed ? (f ^ HALF) - HALF : f;
    }
  }
}

constexpr int kUnroll = 2;         // groups of 4 elements a thread

// Chunk c (8 elements, cnt of them live) element-wise from global memory.
template <int BITS, typename TOut>
__device__ __forceinline__ void chunk_global(const uint8_t* __restrict__ q,
                                             TOut* __restrict__ out,
                                             int64_t n, int64_t c, float scale,
                                             int zp, int is_signed, int add) {
  const int64_t i = c * kElems;
  const int cnt = n - i < kElems ? (int)(n - i) : kElems;
  int code[kElems];
  load_codes<BITS>(q, c, cnt, is_signed, code);
  float v[kElems];
#pragma unroll
  for (int k = 0; k < kElems; ++k) v[k] = pq::dequant1(code[k], zp, scale);
  if (add) {
    float old[kElems];
    pq::load8<TOut, false>(out, i, cnt, old);
    pq::add_rounded<TOut>(old, v);
  }
  pq::store8<TOut, false>(out, i, cnt, v);
}

// The 4 * BITS code bits of group gi (elements 4 gi .. 4 gi + 3), streaming.
template <int BITS>
__device__ __forceinline__ uint64_t load_group(const uint8_t* q, int64_t gi) {
  if constexpr (BITS == 16) {
    uint32_t lo, hi;
    asm volatile("ld.global.cs.v2.u32 {%0, %1}, [%2];\n"
                 : "=r"(lo), "=r"(hi) : "l"(q + 8 * gi));
    return ((uint64_t)hi << 32) | lo;
  } else if constexpr (BITS == 8) {
    uint32_t w;
    asm volatile("ld.global.cs.u32 %0, [%1];\n" : "=r"(w) : "l"(q + 4 * gi));
    return w;
  } else {
    unsigned short w;
    if constexpr (BITS == 4)
      asm volatile("ld.global.cs.u16 %0, [%1];\n" : "=h"(w) : "l"(q + 2 * gi));
    else
      asm volatile("ld.global.cs.u8 %0, [%1];\n" : "=h"(w) : "l"(q + gi));
    return w;
  }
}

// The 4 codes of a group's bits, in wire order.
template <int BITS>
__device__ __forceinline__ void codes4(uint64_t w, int is_signed,
                                       int code[4]) {
  constexpr uint64_t MASK = (1ull << BITS) - 1;
  constexpr int HALF = 1 << (BITS - 1);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int f = (int)((w >> (BITS * k)) & MASK);
    code[k] = is_signed ? (f ^ HALF) - HALF : f;
  }
}

// Four outputs (16 or 8 bytes) with the streaming store, and ADD's read of
// them.
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  asm volatile("st.global.cs.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3])
               : "memory");
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  asm volatile("st.global.cs.v2.b32 [%0], {%1, %2};\n" ::"l"(p),
               "r"(*reinterpret_cast<const uint32_t*>(&lo)),
               "r"(*reinterpret_cast<const uint32_t*>(&hi))
               : "memory");
}

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  asm volatile("ld.global.cs.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3]) : "l"(p));
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  uint32_t lo, hi;
  asm volatile("ld.global.cs.v2.b32 {%0, %1}, [%2];\n"
               : "=r"(lo), "=r"(hi) : "l"(p));
  v[0] = __uint_as_float(lo << 16);
  v[1] = __uint_as_float(lo & 0xFFFF0000u);
  v[2] = __uint_as_float(hi << 16);
  v[3] = __uint_as_float(hi & 0xFFFF0000u);
}

// A 16-byte aligned call: warp w of block b takes groups
// (8 b + w) 32 kUnroll .. + 32 kUnroll, a lane its kUnroll groups 32
// apart; block 0 then the elements past the last whole group.
template <int BITS, typename TOut>
__global__ void __launch_bounds__(pq::kThreads)
dequantize_groups(const uint8_t* __restrict__ q, TOut* __restrict__ out,
                  int64_t n, pq::Affine a, int is_signed, int add) {
  const float scale = pq::load_scale(a);
  const int zp = pq::load_zp(a);
  const int64_t groups = n / 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t base =
      ((int64_t)blockIdx.x * (pq::kThreads / 32) + warp) * 32 * kUnroll + lane;
  uint64_t w[kUnroll];
  float old[kUnroll][4];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {      // every load in flight first
    const int64_t gi = base + 32 * u;
    if (gi < groups) {
      w[u] = load_group<BITS>(q, gi);
      if (add) load4(out + 4 * gi, old[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t gi = base + 32 * u;
    if (gi >= groups) break;
    int code[4];
    codes4<BITS>(w[u], is_signed, code);
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = pq::dequant1(code[k], zp, scale);
      // ADD: round_T(acc + round_T(v)), as pq::add_rounded
      if (add) v[k] = __fadd_rn(old[u][k], pq::to_f32(pq::from_f32<TOut>(v[k])));
    }
    store4(out + 4 * gi, v);
  }
  if (blockIdx.x == 0 && threadIdx.x < n - groups * 4) {
    const int64_t e = groups * 4 + threadIdx.x;   // at most 3 such elements
    int code;
    if constexpr (BITS == 16) {
      const uint16_t h = reinterpret_cast<const uint16_t*>(q)[e];
      code = is_signed ? (int)(int16_t)h : (int)h;
    } else {
      constexpr int PER = 8 / BITS, MASK = (1 << BITS) - 1, HALF = 1 << (BITS - 1);
      const int f = (q[e / PER] >> (BITS * (e % PER))) & MASK;
      code = is_signed ? (f ^ HALF) - HALF : f;
    }
    float v = pq::dequant1(code, zp, scale);
    if (add) v = __fadd_rn(pq::to_f32(out[e]), pq::to_f32(pq::from_f32<TOut>(v)));
    out[e] = pq::from_f32<TOut>(v);
  }
}

// A buffer that is not 16-byte aligned: one chunk a thread, element-wise.
template <int BITS, typename TOut>
__global__ void __launch_bounds__(pq::kThreads)
dequantize_unaligned(const uint8_t* __restrict__ q, TOut* __restrict__ out,
                     int64_t n, pq::Affine a, int is_signed, int add) {
  const float scale = pq::load_scale(a);
  const int zp = pq::load_zp(a);
  const int64_t chunks = (n + kElems - 1) / kElems;
  for (int64_t c = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; c < chunks;
       c += (int64_t)gridDim.x * blockDim.x)
    chunk_global<BITS, TOut>(q, out, n, c, scale, zp, is_signed, add);
}

template <int BITS, typename TOut>
cudaError_t launch(const void* q, void* out, int64_t n, const pq::Affine& a,
                   int is_signed, int add, cudaStream_t st) {
  const uint8_t* qi = static_cast<const uint8_t*>(q);
  TOut* o = static_cast<TOut*>(out);
  if (!pq::aligned16(q) || !pq::aligned16(out)) {
    dequantize_unaligned<BITS, TOut>
        <<<pq::grid_for((n + kElems - 1) / kElems), pq::kThreads, 0, st>>>(
            qi, o, n, a, is_signed, add);
    return cudaGetLastError();
  }
  const int64_t per = (int64_t)pq::kThreads * kUnroll;   // groups a block
  const int64_t blocks = (n / 4 + per - 1) / per;
  dequantize_groups<BITS, TOut>
      <<<(unsigned)(blocks > 0 ? blocks : 1), pq::kThreads, 0, st>>>(
          qi, o, n, a, is_signed, add);
  return cudaGetLastError();
}

template <typename TOut>
cudaError_t by_bits(int bits, const void* q, void* out, int64_t n,
                    const pq::Affine& a, int is_signed, int add,
                    cudaStream_t st) {
  switch (bits) {
    case 2: return launch<2, TOut>(q, out, n, a, is_signed, add, st);
    case 4: return launch<4, TOut>(q, out, n, a, is_signed, add, st);
    case 8: return launch<8, TOut>(q, out, n, a, is_signed, add, st);
    case 16: return launch<16, TOut>(q, out, n, a, is_signed, add, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: [n] codes of 1 or 2 bytes (bits 8, 16) or [ceil(n * bits / 8)] packed
// bytes (bits 4, 2) -> out [n] f32 (bf16 if out_bf16); add != 0 adds into
// out in place.  Scale and zero point as in pq_quantize.
extern "C" int pq_dequantize(const void* q, void* out, int64_t n, int bits,
                             int is_signed, int out_bf16,
                             const void* scale_ptr, float scale_val,
                             const void* zp_ptr, int zp_val, int add,
                             void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const pq::Affine a{static_cast<const float*>(scale_ptr), scale_val,
                     static_cast<const int*>(zp_ptr), zp_val};
  const cudaError_t err =
      out_bf16 ? by_bits<__nv_bfloat16>(bits, q, out, n, a, is_signed, add, st)
               : by_bits<float>(bits, q, out, n, a, is_signed, add, st);
  return (int)err;
}
