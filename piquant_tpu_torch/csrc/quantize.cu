// pq_quantize: float (f32 / bf16) -> affine quantized codes, packed for the
// sub-byte types.
//
// Replaces piquant_tpu/ops/pallas/quantize.py::_direct_kernel (u8 / i8 /
// u16 / i16 codes stored directly) and ::_mxu_pack_kernel (uint4 / int4
// two per byte, uint2 four per byte, LSB-first): one kernel templated on the
// code width.  The TPU packed its fields with a selection-matrix product on
// the MXU; here a thread masks and shifts its fields into whole bytes.
//
//   code = clamp(int32(round(x * (1/scale))) + zp, qmin, qmax)
//
// with round half away from zero (or stochastic: trunc + sign when a hashed
// uniform falls below the fraction), the steps of pq_quant.cuh.
//
// Bound on the H100: bytes.  f32 -> u8 moves 5 bytes per element (4 read,
// 1 written), f32 -> uint4 4.5, bf16 -> u8 3; at numel 27,264,000 and
// 3.35 TB/s that is 0.0407 ms for f32 -> u8.  A few dozen ALU operations
// per element are far below the card's rate.  Design:
//   * each thread quantizes 8 consecutive elements per step: one (bf16) or
//     two (f32) 16-byte loads, and one store of its whole output bytes
//     (8 B for 8-bit codes, 16 B for 16-bit, 4 B for uint4, 2 B for uint2),
//     so a packed byte is never shared between threads;
//   * the last chunk of a ragged n quantizes only its valid elements and
//     leaves the fields past n zero, which is the tail mask of the wire
//     format;
//   * a misaligned input (a slice of a larger tensor) takes the same kernel
//     with element-wise loads and stores (VEC = false).

#include "pq_quant.cuh"

namespace {

using pq::kElems;

template <int BITS, bool VEC>
__device__ __forceinline__ void store_codes(uint8_t* __restrict__ out,
                                            int64_t c, int cnt,
                                            const int code[kElems]) {
  const bool full = VEC && cnt == kElems;
  if constexpr (BITS == 8) {
    uint8_t* o = out + c * 8;
    if (full) {
      uint2 w;
      w.x = (code[0] & 255) | (code[1] & 255) << 8 | (code[2] & 255) << 16 |
            (uint32_t)(code[3] & 255) << 24;
      w.y = (code[4] & 255) | (code[5] & 255) << 8 | (code[6] & 255) << 16 |
            (uint32_t)(code[7] & 255) << 24;
      *reinterpret_cast<uint2*>(o) = w;
    } else {
      for (int k = 0; k < cnt; ++k) o[k] = (uint8_t)code[k];
    }
  } else if constexpr (BITS == 16) {
    uint16_t* o = reinterpret_cast<uint16_t*>(out) + c * 8;
    if (full) {
      uint4 w;
      w.x = (code[0] & 0xffff) | (uint32_t)(code[1] & 0xffff) << 16;
      w.y = (code[2] & 0xffff) | (uint32_t)(code[3] & 0xffff) << 16;
      w.z = (code[4] & 0xffff) | (uint32_t)(code[5] & 0xffff) << 16;
      w.w = (code[6] & 0xffff) | (uint32_t)(code[7] & 0xffff) << 16;
      *reinterpret_cast<uint4*>(o) = w;
    } else {
      for (int k = 0; k < cnt; ++k) o[k] = (uint16_t)code[k];
    }
  } else {
    // sub-byte: PER codes per byte, the first in the low bits; the codes
    // past cnt are 0, so the unused bits of a tail byte stay zero
    constexpr int PER = 8 / BITS;
    constexpr int NB = kElems / PER;  // bytes of a full chunk
    constexpr int MASK = (1 << BITS) - 1;
    uint32_t w = 0;
#pragma unroll
    for (int k = 0; k < kElems; ++k)
      w |= (uint32_t)(code[k] & MASK) << (BITS * k);
    uint8_t* o = out + c * NB;
    if (full) {
      if constexpr (NB == 4) {
        *reinterpret_cast<uint32_t*>(o) = w;
      } else {
        *reinterpret_cast<uint16_t*>(o) = (uint16_t)w;
      }
    } else {
      const int nb = (cnt + PER - 1) / PER;
      for (int j = 0; j < nb; ++j) o[j] = (uint8_t)(w >> (8 * j));
    }
  }
}

template <typename TIn, int BITS, bool VEC>
__global__ void __launch_bounds__(pq::kThreads)
quantize_kernel(const TIn* __restrict__ x, uint8_t* __restrict__ out,
                int64_t n, pq::Affine a, int is_signed, int stochastic,
                uint64_t seed) {
  const pq::QuantArgs q = pq::quant_args(a, BITS, is_signed, stochastic, seed);
  const int64_t chunks = (n + kElems - 1) / kElems;
  for (int64_t c = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; c < chunks;
       c += (int64_t)gridDim.x * blockDim.x) {
    const int64_t i = c * kElems;
    const int cnt = n - i < kElems ? (int)(n - i) : kElems;
    float v[kElems];
    pq::load8<TIn, VEC>(x, i, cnt, v);
    int code[kElems];
#pragma unroll
    for (int k = 0; k < kElems; ++k)
      code[k] = k < cnt ? pq::quant1(v[k], q, i + k) : 0;
    store_codes<BITS, VEC>(out, c, cnt, code);
  }
}

template <typename TIn, int BITS>
cudaError_t launch(const void* x, void* out, int64_t n, const pq::Affine& a,
                   int is_signed, int stochastic, uint64_t seed,
                   cudaStream_t st) {
  const unsigned grid = pq::grid_for((n + kElems - 1) / kElems);
  const TIn* xi = static_cast<const TIn*>(x);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (pq::aligned16(x) && pq::aligned16(out)) {
    quantize_kernel<TIn, BITS, true><<<grid, pq::kThreads, 0, st>>>(
        xi, o, n, a, is_signed, stochastic, seed);
  } else {
    quantize_kernel<TIn, BITS, false><<<grid, pq::kThreads, 0, st>>>(
        xi, o, n, a, is_signed, stochastic, seed);
  }
  return cudaGetLastError();
}

template <typename TIn>
cudaError_t by_bits(int bits, const void* x, void* out, int64_t n,
                    const pq::Affine& a, int is_signed, int stochastic,
                    uint64_t seed, cudaStream_t st) {
  switch (bits) {
    case 2: return launch<TIn, 2>(x, out, n, a, is_signed, stochastic, seed, st);
    case 4: return launch<TIn, 4>(x, out, n, a, is_signed, stochastic, seed, st);
    case 8: return launch<TIn, 8>(x, out, n, a, is_signed, stochastic, seed, st);
    case 16: return launch<TIn, 16>(x, out, n, a, is_signed, stochastic, seed, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x [n] f32 (bf16 if in_bf16) -> out: [n] codes of 1 or 2 bytes (bits 8,
// 16) or [ceil(n * bits / 8)] packed bytes (bits 4, 2).  The scale and zero
// point come from scale_ptr (f32) / zp_ptr (int32) on the device when those
// are non-null, else from scale_val / zp_val.
extern "C" int pq_quantize(const void* x, void* out, int64_t n, int in_bf16,
                           int bits, int is_signed, const void* scale_ptr,
                           float scale_val, const void* zp_ptr, int zp_val,
                           int stochastic, uint64_t seed, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const pq::Affine a{static_cast<const float*>(scale_ptr), scale_val,
                     static_cast<const int*>(zp_ptr), zp_val};
  const cudaError_t err =
      in_bf16 ? by_bits<__nv_bfloat16>(bits, x, out, n, a, is_signed,
                                       stochastic, seed, st)
              : by_bits<float>(bits, x, out, n, a, is_signed, stochastic,
                               seed, st);
  return (int)err;
}
