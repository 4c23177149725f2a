// w4_gemv: INT4 weight-only matmul for decode-sized M (M <= 64).
//
// Replaces piquant_tpu/ops/pallas/qmatmul.py::_w4_kernel and
// ::_w4_kernel_ksplit (one function here: on Hopper the K split is a loop
// inside the block plus a split over blocks, not a second kernel).
//
//   out[m, n] = (sum_{k<K/2} x[m, k] * lo[k, n] + x[m, k + K/2] * hi[k, n])
//               * scale[n] - xsum[m] * (zp[n] * scale[n])
//
// with lo/hi the nibbles of the split-half bytes w[K/2, N] (uint8, N
// contiguous).  The zero point is never subtracted from the codes: it
// folds in as the rank-1 term, exactly as the TPU kernel does, and the
// products accumulate in f32.
//
// Bound on the H100: the weight stream, K*N/2 bytes per call (x, scales
// and the output are < 1% of it at the Llama-3-8B shapes).  Design:
//   * each warp reads one packed row of 128 columns per step (32 lanes x
//     4 bytes: one fully used 128-byte line), both nibbles expanded in
//     registers, x broadcast from shared memory as (x_lo, x_hi) pairs;
//   * the 8 warps of a block walk interleaved rows of one K range, so a
//     block streams a contiguous slab of the weight;
//   * at N = 4096 / 1024 one block per 128 columns gives only 32 / 8
//     blocks for 132 SMs, so K is also split over blocks (ksplit, chosen by
//     the wrapper for ~4 blocks per SM) and a second pass sums the f32
//     partials in a fixed order: deterministic, no atomics;
//   * M is tiled by 8 rows per block (decode batch 8 = one tile).
// The arithmetic runs on the CUDA cores (2 FMAs per code and x row), which
// at M = 8 costs about as much as the stream itself; tensor-core products
// are the next step for this kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;      // output columns per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMT = 8;          // x rows per block
constexpr int kMaxRows = 512;   // packed K rows per block (x staging bound)

__device__ __forceinline__ void store_out(void* out, size_t i, float v,
                                          int out_bf16) {
  if (out_bf16) {
    reinterpret_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(v);
  } else {
    reinterpret_cast<float*>(out)[i] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
w4_gemv_partial(const __nv_bfloat16* __restrict__ x,
                const uint8_t* __restrict__ w,
                const float* __restrict__ scale,
                const int* __restrict__ zp,
                const float* __restrict__ xsum,
                void* __restrict__ out,
                float* __restrict__ partial,   // null: write `out` directly
                int m, int k, int n, int rows_per_split, int out_bf16) {
  __shared__ __align__(16) float smem[kMaxRows * kMT * 2];
  float2* xs = reinterpret_cast<float2*>(smem);   // [rows][kMT]

  const int kh = k / 2;
  const int col0 = blockIdx.x * kCols;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * kMT;
  const int r0 = split * rows_per_split;
  const int nrows = min(r0 + rows_per_split, kh) - r0;

  // stage (x[m, k], x[m, k + K/2]) for this block's rows, zero past M
  for (int i = threadIdx.x; i < nrows * kMT; i += kThreads) {
    const int mi = i / nrows, r = i % nrows;
    float2 v = make_float2(0.f, 0.f);
    if (m0 + mi < m) {
      const __nv_bfloat16* xr = x + (size_t)(m0 + mi) * k + r0 + r;
      v = make_float2(__bfloat162float(xr[0]), __bfloat162float(xr[kh]));
    }
    xs[r * kMT + mi] = v;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint8_t* wp = w + (size_t)r0 * n + col0 + lane * 4;
  float acc[kMT][4];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[mi][c] = 0.f;

  constexpr int kUnroll = 4;
  for (int rb = warp; rb < nrows; rb += kWarps * kUnroll) {
    uint32_t word[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {   // all loads first: 4 in flight
      const int r = rb + u * kWarps;
      word[u] = r < nrows
                    ? __ldg(reinterpret_cast<const uint32_t*>(wp + (size_t)r * n))
                    : 0u;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = rb + u * kWarps;
      if (r >= nrows) break;
      float lo[4], hi[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t byte = (word[u] >> (8 * c)) & 0xffu;
        lo[c] = (float)(byte & 15u);
        hi[c] = (float)(byte >> 4);
      }
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi) {
        const float2 xv = xs[r * kMT + mi];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[mi][c] = fmaf(xv.x, lo[c], acc[mi][c]);
          acc[mi][c] = fmaf(xv.y, hi[c], acc[mi][c]);
        }
      }
    }
  }

  // sum the 8 warps' row subsets through shared memory
  __syncthreads();
  float* red = smem;   // [kWarps][kMT][kCols]
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
    *reinterpret_cast<float4*>(&red[(warp * kMT + mi) * kCols + lane * 4]) =
        make_float4(acc[mi][0], acc[mi][1], acc[mi][2], acc[mi][3]);
  __syncthreads();
  for (int i = threadIdx.x; i < kMT * kCols; i += kThreads) {
    const int mi = i / kCols, cc = i % kCols;
    const int row = m0 + mi, col = col0 + cc;
    if (row >= m) continue;
    float s = 0.f;
#pragma unroll
    for (int wv = 0; wv < kWarps; ++wv) s += red[(wv * kMT + mi) * kCols + cc];
    if (partial != nullptr) {
      partial[((size_t)split * m + row) * n + col] = s;
    } else {
      const float sc = scale[col];
      const float zs = (float)zp[col] * sc;
      store_out(out, (size_t)row * n + col, s * sc - xsum[row] * zs, out_bf16);
    }
  }
}

__global__ void w4_gemv_reduce(const float* __restrict__ partial,
                               const float* __restrict__ scale,
                               const int* __restrict__ zp,
                               const float* __restrict__ xsum,
                               void* __restrict__ out,
                               int m, int n, int ksplit, int out_bf16) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m * n) return;
  const int row = i / n, col = i % n;
  float s = 0.f;
  for (int sp = 0; sp < ksplit; ++sp) s += partial[(size_t)sp * m * n + i];
  const float sc = scale[col];
  const float zs = (float)zp[col] * sc;
  store_out(out, i, s * sc - xsum[row] * zs, out_bf16);
}

}  // namespace

// x [m, k] bf16, w [k/2, n] u8, scale [n] f32, zp [n] i32, xsum [m] f32,
// out [m, n] (bf16 if out_bf16 else f32), partial [ksplit, m, n] f32 scratch
// (unused when ksplit == 1).  Needs n % 128 == 0, k % 256 == 0 and
// rows_per_split <= 512 with ksplit * rows_per_split >= k / 2.
extern "C" int pq_w4_gemv(const void* x, const void* w, const void* scale,
                          const void* zp, const void* xsum, void* out,
                          void* partial, int m, int k, int n, int ksplit,
                          int rows_per_split, int out_bf16, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  dim3 grid(n / kCols, ksplit, (m + kMT - 1) / kMT);
  w4_gemv_partial<<<grid, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(scale), static_cast<const int*>(zp),
      static_cast<const float*>(xsum), out,
      ksplit > 1 ? static_cast<float*>(partial) : nullptr, m, k, n,
      rows_per_split, out_bf16);
  if (ksplit > 1) {
    const int total = m * n;
    w4_gemv_reduce<<<(total + 255) / 256, 256, 0, st>>>(
        static_cast<const float*>(partial), static_cast<const float*>(scale),
        static_cast<const int*>(zp), static_cast<const float*>(xsum), out, m,
        n, ksplit, out_bf16);
  }
  return (int)cudaGetLastError();
}
