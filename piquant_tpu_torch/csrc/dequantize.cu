// pq_dequantize: affine codes (packed for the sub-byte types) -> f32 / bf16,
// with the SET or the ADD store.
//
// Replaces piquant_tpu/ops/pallas/dequantize.py::_direct_kernel (u8 / i8 /
// u16 / i16 codes) and ::_mxu_unpack_kernel (uint4 / int4 / uint2 bytes back
// to wire order, int4 sign-extended): one kernel templated on the code
// width.  The TPU interleaved its field planes with a matrix product on the
// MXU; here a thread shifts the fields out of its own bytes.
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
// 0.0407 ms and 0.0732 ms.  Design: each thread owns 8 consecutive elements
// per step, loads their codes in one load (8, 16, 4 or 2 bytes) and stores
// (ADD: also loads) its outputs with 16-byte accesses; the last chunk of a
// ragged n reads only the bytes the packed buffer has.  A misaligned buffer
// (a view into a larger tensor) takes the same kernel with element-wise
// accesses (VEC = false).

#include "pq_quant.cuh"

namespace {

using pq::kElems;

template <int BITS, bool VEC>
__device__ __forceinline__ void load_codes(const uint8_t* __restrict__ q,
                                           int64_t c, int cnt, int is_signed,
                                           int code[kElems]) {
  const bool full = VEC && cnt == kElems;
  if constexpr (BITS == 8) {
    const uint8_t* p = q + c * 8;
    uint8_t b[kElems];
    if (full) {
      const uint2 w = *reinterpret_cast<const uint2*>(p);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        b[k] = (uint8_t)(w.x >> (8 * k));
        b[4 + k] = (uint8_t)(w.y >> (8 * k));
      }
    } else {
#pragma unroll
      for (int k = 0; k < kElems; ++k) b[k] = k < cnt ? p[k] : 0;
    }
#pragma unroll
    for (int k = 0; k < kElems; ++k)
      code[k] = is_signed ? (int)(int8_t)b[k] : (int)b[k];
  } else if constexpr (BITS == 16) {
    const uint16_t* p = reinterpret_cast<const uint16_t*>(q) + c * 8;
    uint16_t h[kElems];
    if (full) {
      const uint4 w = *reinterpret_cast<const uint4*>(p);
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        h[2 * k] = (uint16_t)ws[k];
        h[2 * k + 1] = (uint16_t)(ws[k] >> 16);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kElems; ++k) h[k] = k < cnt ? p[k] : 0;
    }
#pragma unroll
    for (int k = 0; k < kElems; ++k)
      code[k] = is_signed ? (int)(int16_t)h[k] : (int)h[k];
  } else {
    constexpr int PER = 8 / BITS;
    constexpr int NB = kElems / PER;
    constexpr int MASK = (1 << BITS) - 1;
    constexpr int HALF = 1 << (BITS - 1);
    const uint8_t* p = q + c * NB;
    uint32_t w = 0;
    if (full) {
      if constexpr (NB == 4) {
        w = *reinterpret_cast<const uint32_t*>(p);
      } else {
        w = *reinterpret_cast<const uint16_t*>(p);
      }
    } else {
      const int nb = (cnt + PER - 1) / PER;
      for (int j = 0; j < nb; ++j) w |= (uint32_t)p[j] << (8 * j);
    }
#pragma unroll
    for (int k = 0; k < kElems; ++k) {
      const int f = (int)((w >> (BITS * k)) & MASK);
      code[k] = is_signed ? (f ^ HALF) - HALF : f;
    }
  }
}

template <int BITS, typename TOut, bool VEC>
__global__ void __launch_bounds__(pq::kThreads)
dequantize_kernel(const uint8_t* __restrict__ q, TOut* __restrict__ out,
                  int64_t n, pq::Affine a, int is_signed, int add) {
  const float scale = pq::load_scale(a);
  const int zp = pq::load_zp(a);
  const int64_t chunks = (n + kElems - 1) / kElems;
  for (int64_t c = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; c < chunks;
       c += (int64_t)gridDim.x * blockDim.x) {
    const int64_t i = c * kElems;
    const int cnt = n - i < kElems ? (int)(n - i) : kElems;
    int code[kElems];
    load_codes<BITS, VEC>(q, c, cnt, is_signed, code);
    float v[kElems];
#pragma unroll
    for (int k = 0; k < kElems; ++k) v[k] = pq::dequant1(code[k], zp, scale);
    if (add) {
      float old[kElems];
      pq::load8<TOut, VEC>(out, i, cnt, old);
      pq::add_rounded<TOut>(old, v);
    }
    pq::store8<TOut, VEC>(out, i, cnt, v);
  }
}

template <int BITS, typename TOut>
cudaError_t launch(const void* q, void* out, int64_t n, const pq::Affine& a,
                   int is_signed, int add, cudaStream_t st) {
  const unsigned grid = pq::grid_for((n + kElems - 1) / kElems);
  const uint8_t* qi = static_cast<const uint8_t*>(q);
  TOut* o = static_cast<TOut*>(out);
  if (pq::aligned16(q) && pq::aligned16(out)) {
    dequantize_kernel<BITS, TOut, true><<<grid, pq::kThreads, 0, st>>>(
        qi, o, n, a, is_signed, add);
  } else {
    dequantize_kernel<BITS, TOut, false><<<grid, pq::kThreads, 0, st>>>(
        qi, o, n, a, is_signed, add);
  }
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
