// pq_requantize: fused quantize -> dequantize (fake-quant) of f32 / bf16,
// with the SET or the ADD store.
//
// Replaces piquant_tpu/ops/pallas/requantize.py::_requant_kernel.  The codes
// never leave registers, so one kernel serves every code type of <= 16 bits
// (the range is a runtime qmin / qmax) and no packing is needed:
//
//   code = clamp(int32(round(x * (1/scale))) + zp, qmin, qmax)
//   v    = (code - zp) * scale
//   SET: out = round_T(v);  ADD: out = round_T(out + round_T(v))
//
// with the steps of pq_quant.cuh (the quantize step of pq_quantize and the
// dequantize step of pq_dequantize, bit for bit).  ADD is in place: the
// accumulator is the output pointer, and it may be x itself.
//
// Bound on the H100: bytes.  f32 SET moves 8 bytes per element (4 read, 4
// written), ADD 12; at numel 27,264,000 and 3.35 TB/s that is 0.0651 ms
// for SET.  Design: 8 consecutive elements per thread and step with
// 16-byte loads and stores; element-wise accesses (VEC = false) for a
// misaligned buffer or the ragged last chunk.

#include "pq_quant.cuh"

namespace {

using pq::kElems;

// no __restrict__ on x and out: an in-place call passes the same buffer
template <typename T, bool VEC>
__global__ void __launch_bounds__(pq::kThreads)
requantize_kernel(const T* x, T* out, int64_t n, pq::Affine a, int bits,
                  int is_signed, int stochastic, uint64_t seed, int add) {
  const pq::QuantArgs q = pq::quant_args(a, bits, is_signed, stochastic, seed);
  const float scale = pq::load_scale(a);
  const int64_t chunks = (n + kElems - 1) / kElems;
  for (int64_t c = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; c < chunks;
       c += (int64_t)gridDim.x * blockDim.x) {
    const int64_t i = c * kElems;
    const int cnt = n - i < kElems ? (int)(n - i) : kElems;
    float v[kElems];
    pq::load8<T, VEC>(x, i, cnt, v);
#pragma unroll
    for (int k = 0; k < kElems; ++k)
      v[k] = pq::dequant1(pq::quant1(v[k], q, i + k), q.zp, scale);
    if (add) {
      float old[kElems];
      pq::load8<T, VEC>(out, i, cnt, old);
      pq::add_rounded<T>(old, v);
    }
    pq::store8<T, VEC>(out, i, cnt, v);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* out, int64_t n, const pq::Affine& a,
                   int bits, int is_signed, int stochastic, uint64_t seed,
                   int add, cudaStream_t st) {
  if (bits < 2 || bits > 16) return cudaErrorInvalidValue;
  const unsigned grid = pq::grid_for((n + kElems - 1) / kElems);
  const T* xi = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  if (pq::aligned16(x) && pq::aligned16(out)) {
    requantize_kernel<T, true><<<grid, pq::kThreads, 0, st>>>(
        xi, o, n, a, bits, is_signed, stochastic, seed, add);
  } else {
    requantize_kernel<T, false><<<grid, pq::kThreads, 0, st>>>(
        xi, o, n, a, bits, is_signed, stochastic, seed, add);
  }
  return cudaGetLastError();
}

}  // namespace

// x [n] f32 (bf16 if is_bf16) -> out [n] of the same type; add != 0 adds
// into out in place.  Code range from (bits, is_signed), bits <= 16; scale
// and zero point as in pq_quantize.
extern "C" int pq_requantize(const void* x, void* out, int64_t n, int is_bf16,
                             int bits, int is_signed, const void* scale_ptr,
                             float scale_val, const void* zp_ptr, int zp_val,
                             int stochastic, uint64_t seed, int add,
                             void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const pq::Affine a{static_cast<const float*>(scale_ptr), scale_val,
                     static_cast<const int*>(zp_ptr), zp_val};
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(x, out, n, a, bits, is_signed,
                                      stochastic, seed, add, st)
              : launch<float>(x, out, n, a, bits, is_signed, stochastic, seed,
                              add, st);
  return (int)err;
}
