// pq_minmax: the global (min, max) of an f32 / bf16 vector in one read of
// it, for compute_quant_params.
//
// Replaces piquant_tpu/ops/pallas/minmax.py::_minmax_kernel.  The TPU walked
// its grid in order and carried the running (min, max) in an SMEM cell from
// one step to the next; blocks on Hopper run in no order, so:
//   * pass 1: a grid of at most 4 blocks per SM walks the vector with a
//     grid-stride loop (16-byte loads), reduces in registers, then across
//     the warp (shuffles) and the block (shared memory), and writes one
//     (min, max) partial per block;
//   * pass 2: one block reduces the partials in a fixed order.
// No atomics, so the result is deterministic.  A NaN anywhere gives NaN for
// both, as jnp.min / jnp.max and torch.amin / amax do: fminf / fmaxf drop
// NaN, so every thread also keeps a NaN flag.  The finish, scale and zero
// point from (min, max), is a few torch ops on the two-element result
// (ops/reference.py::params_from_min_max), with no host sync.
//
// Bound on the H100: bytes, 4 per f32 element read once; at numel
// 27,264,000 and 3.35 TB/s that is 0.0326 ms.

#include <math.h>

#include "pq_quant.cuh"

namespace {

using pq::kElems;
constexpr int kWarps = pq::kThreads / 32;

struct MinMax {
  float lo, hi;
  int nan;
};

__device__ __forceinline__ void take(MinMax& m, float v) {
  m.nan |= v != v;
  m.lo = fminf(m.lo, v);
  m.hi = fmaxf(m.hi, v);
}

__device__ __forceinline__ void merge(MinMax& m, const MinMax& o) {
  m.nan |= o.nan;
  m.lo = fminf(m.lo, o.lo);
  m.hi = fmaxf(m.hi, o.hi);
}

// the block's (min, max) into thread 0
__device__ MinMax block_reduce(MinMax m) {
  __shared__ MinMax part[kWarps];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    MinMax o;
    o.lo = __shfl_xor_sync(0xffffffffu, m.lo, off);
    o.hi = __shfl_xor_sync(0xffffffffu, m.hi, off);
    o.nan = __shfl_xor_sync(0xffffffffu, m.nan, off);
    merge(m, o);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) part[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < kWarps; ++w) merge(m, part[w]);
  return m;
}

__device__ __forceinline__ void store_result(float* out,
                                             const MinMax& m) {
  out[0] = m.nan ? NAN : m.lo;
  out[1] = m.nan ? NAN : m.hi;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(pq::kThreads)
minmax_partial(const T* __restrict__ x, int64_t n, float* __restrict__ part) {
  MinMax m{INFINITY, -INFINITY, 0};
  const int64_t chunks = (n + kElems - 1) / kElems;
  for (int64_t c = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; c < chunks;
       c += (int64_t)gridDim.x * blockDim.x) {
    const int64_t i = c * kElems;
    const int cnt = n - i < kElems ? (int)(n - i) : kElems;
    float v[kElems];
    pq::load8<T, VEC>(x, i, cnt, v);
#pragma unroll
    for (int k = 0; k < kElems; ++k)
      if (k < cnt) take(m, v[k]);
  }
  m = block_reduce(m);
  if (threadIdx.x == 0) store_result(part + 2 * blockIdx.x, m);
}

__global__ void __launch_bounds__(pq::kThreads)
minmax_final(const float* __restrict__ part, int blocks,
             float* __restrict__ out) {
  MinMax m{INFINITY, -INFINITY, 0};
  for (int b = threadIdx.x; b < blocks; b += blockDim.x) {
    take(m, part[2 * b]);
    take(m, part[2 * b + 1]);
  }
  m = block_reduce(m);
  if (threadIdx.x == 0) store_result(out, m);
}

template <typename T>
cudaError_t launch(const void* x, float* part, float* out, int64_t n,
                   int blocks, cudaStream_t st) {
  const T* xi = static_cast<const T*>(x);
  if (pq::aligned16(x)) {
    minmax_partial<T, true><<<blocks, pq::kThreads, 0, st>>>(xi, n, part);
  } else {
    minmax_partial<T, false><<<blocks, pq::kThreads, 0, st>>>(xi, n, part);
  }
  minmax_final<<<1, pq::kThreads, 0, st>>>(part, blocks, out);
  return cudaGetLastError();
}

}  // namespace

// x [n] f32 (bf16 if in_bf16), n > 0 -> out [2] f32 = (min, max); part is
// [2 * blocks] f32 scratch, one (min, max) per block of pass 1.
extern "C" int pq_minmax(const void* x, void* part, void* out, int64_t n,
                         int in_bf16, int blocks, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  float* o = static_cast<float*>(out);
  const cudaError_t err =
      in_bf16 ? launch<__nv_bfloat16>(x, p, o, n, blocks, st)
              : launch<float>(x, p, o, n, blocks, st);
  return (int)err;
}
