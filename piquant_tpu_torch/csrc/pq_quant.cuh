// Shared device code of the library-core kernels (quantize.cu,
// dequantize.cu, requantize.cu): the quantize and dequantize steps, the
// stochastic-rounding hash, and 8-element vector loads and stores.
//
// Every step is bit-exact with the plain versions in
// piquant_tpu_torch/ops/reference.py, so the rounding is spelled out:
//   * __fmul_rn / __fadd_rn / __fsub_rn keep nvcc from contracting a
//     multiply and an add into an FMA (it does so by default, and a fused
//     x * inv + 0.5 moves codes at half-code ties);
//   * nearest is trunc(r + (r >= 0 ? 0.5 : -0.5)), not roundf: the f32 add
//     rounds 0.49999997 + 0.5 up to 1.0, and the reference keeps that;
//   * the float -> int32 cast saturates and sends NaN to 0 (the PTX cvt
//     does both; NaN is also tested explicitly), and the zero point is
//     added with int32 wraparound, as XLA does;
//   * 1/scale is __frcp_rn, the IEEE-rounded reciprocal, which equals
//     numpy's float32 1/scale, so a device-resident scale needs no readback.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pq {

constexpr int kThreads = 256;
constexpr int kElems = 8;  // elements per thread and step

// --------------------------------------------------------------------------
// scalars
// --------------------------------------------------------------------------

// scale and zero point: read from the device when the pointer is set (a
// tensor the caller holds on the card), else the host value
struct Affine {
  const float* scale_ptr;
  float scale_val;
  const int* zp_ptr;
  int zp_val;
};

struct QuantArgs {
  float inv;
  int zp;
  int qmin;
  int qmax;
  int stochastic;
  uint32_t k0, k1;  // seed halves
};

__device__ __forceinline__ float load_scale(const Affine& a) {
  return a.scale_ptr ? *a.scale_ptr : a.scale_val;
}

__device__ __forceinline__ int load_zp(const Affine& a) {
  return a.zp_ptr ? *a.zp_ptr : a.zp_val;
}

__device__ __forceinline__ QuantArgs quant_args(const Affine& a, int bits,
                                                int is_signed, int stochastic,
                                                uint64_t seed) {
  QuantArgs q;
  q.inv = __frcp_rn(load_scale(a));
  q.zp = load_zp(a);
  q.qmin = is_signed ? -(1 << (bits - 1)) : 0;
  q.qmax = is_signed ? (1 << (bits - 1)) - 1 : (int)((1u << bits) - 1u);
  q.stochastic = stochastic;
  q.k0 = (uint32_t)seed;
  q.k1 = (uint32_t)(seed >> 32);
  return q;
}

// --------------------------------------------------------------------------
// the quantize step
// --------------------------------------------------------------------------

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352dU;
  x ^= x >> 15;
  x *= 0x846ca68bU;
  x ^= x >> 16;
  return x;
}

// uniform in [0, 1) with 23 bits, from (seed, element index)
__device__ __forceinline__ float uniform(int64_t i, uint32_t k0, uint32_t k1) {
  const uint32_t lo = (uint32_t)i, hi = (uint32_t)((uint64_t)i >> 32);
  const uint32_t h = mix32(mix32(lo ^ k0) + (k1 ^ hi));
  return (float)(h >> 9) * (1.0f / 8388608.0f);
}

__device__ __forceinline__ int quant1(float x, const QuantArgs& q, int64_t i) {
  const float r = __fmul_rn(x, q.inv);
  float rounded;
  if (q.stochastic) {
    const float t = truncf(r);
    const float frac = fabsf(__fsub_rn(r, t));
    rounded = uniform(i, q.k0, q.k1) < frac
                  ? __fadd_rn(t, r < 0.f ? -1.f : 1.f) : t;
  } else {
    rounded = truncf(__fadd_rn(r, r >= 0.f ? 0.5f : -0.5f));
  }
  const int c = rounded != rounded ? 0 : __float2int_rz(rounded);
  const int v = (int)((unsigned)c + (unsigned)q.zp);
  return min(max(v, q.qmin), q.qmax);
}

// (code - zp) * scale, the difference exact in int32 (wrapping, as the
// plain version's int32 subtraction, for a zero point far outside the codes)
__device__ __forceinline__ float dequant1(int code, int zp, float scale) {
  return __fmul_rn(__int2float_rn((int)((unsigned)code - (unsigned)zp)),
                   scale);
}

// --------------------------------------------------------------------------
// 8-element loads and stores of f32 / bf16
// --------------------------------------------------------------------------

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// x[i .. i + cnt), zero past cnt; 16-byte loads when VEC and cnt == 8
template <typename T, bool VEC>
__device__ __forceinline__ void load8(const T* __restrict__ x, int64_t i,
                                      int cnt, float v[kElems]) {
  if (VEC && cnt == kElems) {
    if constexpr (sizeof(T) == 4) {
      const float4 a = *reinterpret_cast<const float4*>(x + i);
      const float4 b = *reinterpret_cast<const float4*>(x + i + 4);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
      const uint4 a = *reinterpret_cast<const uint4*>(x + i);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(h[k]);
        v[2 * k] = f.x;
        v[2 * k + 1] = f.y;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kElems; ++k) v[k] = k < cnt ? to_f32(x[i + k]) : 0.f;
  }
}

// out[i .. i + cnt) = v, rounded to T
template <typename T, bool VEC>
__device__ __forceinline__ void store8(T* __restrict__ out, int64_t i, int cnt,
                                       const float v[kElems]) {
  if (VEC && cnt == kElems) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(out + i) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(out + i + 4) =
          make_float4(v[4], v[5], v[6], v[7]);
    } else {
      uint4 a;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
      *reinterpret_cast<uint4*>(out + i) = a;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kElems; ++k)
      if (k < cnt) out[i + k] = from_f32<T>(v[k]);
  }
}

// ADD: out = out + round_T(v), with the sum in f32 and rounded to T again
// (the jnp reference's order: for bf16 the addend is rounded to bf16
// first; for f32 the first rounding is the identity)
template <typename T>
__device__ __forceinline__ void add_rounded(const float old[kElems],
                                            float v[kElems]) {
#pragma unroll
  for (int k = 0; k < kElems; ++k)
    v[k] = __fadd_rn(old[k], to_f32(from_f32<T>(v[k])));
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// blocks for `chunks` 8-element chunks, one chunk per thread (grid-stride
// beyond 2^20 blocks)
inline unsigned grid_for(int64_t chunks) {
  const int64_t b = (chunks + kThreads - 1) / kThreads;
  return (unsigned)(b < (1 << 20) ? (b > 0 ? b : 1) : (1 << 20));
}

}  // namespace pq
