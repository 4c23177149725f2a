// Activation-quantized (int8 x) matmul: one kernel template, three entry
// points, each replacing TPU kernels of piquant_tpu/ops/pallas/qmatmul.py:
//
//   pq_w4a8  _w4a8_kernel + _w4a8_kernel_ksplit  INT4 split-half, 2 codes a byte
//   pq_w8a8  _w8a8_kernel                         INT8, 1 code a byte (u8 ^ 0x80)
//   pq_w2a8  _w2a8_kernel                         INT2 split-quarter, 4 codes a byte
//   pq_wq_ragged_a8  _wq_ragged_a8_kernel        INT4 / INT2 expert stacks
//
// (The K split of _w4a8_kernel_ksplit is the loop over K inside the block
// plus, where the output tiles are few, a split over blocks.)  The ragged
// MoE form takes rows sorted by expert in 128-row blocks: block row i
// multiplies by expert block_expert[i] of a stack [E, k/P, n] with scale /
// zs [E, n], so a block only offsets its weight and side pointers (the
// TPU kernel's DMA elision across same-expert blocks is left to L2).
//
// xq [m, k] int8 (per-token quantized activations), xs [m] f32 their
// scales, w [k/P, n] uint8 (n contiguous; byte row r holds code row
// r + p*k/P in bits [p*8/P, (p+1)*8/P)), scale / zs [n] f32, xsum [m] f32
// the row sums of xq:
//   acc[m, n] = sum_p sum_r xq[m, p*k/P + r] * code_p(w[r, n])   (int32, exact)
//   out[m, n] = (f32(acc) * scale[n] - xsum[m] * zs[n]) * xs[m]
// with code = c for INT4 / INT2 and c - 128 for INT8 (zs = (zp - 128) s
// then), the TPU kernels' epilogue in their order.  It is applied with
// __fmul_rn / __fsub_rn so no FMA contraction changes a bit: the kernel
// and its plain version (ops/cuda/qmatmul.py) agree bit for bit.
//
// Bound on the H100: at prefill M (>= 256) the int8 operations, 2 M N K at
// 1,979 TOP/s, which the TPU kernels fed to the MXU's int8 path; at decode
// M (<= 64) the weight stream, k n / P bytes.  Design, right and simple
// first:
//   * the int8 tensor cores through mma.sync.m16n8k32.s8.s8.s32; a block
//     computes a (16, 64 or 128) x 128 output tile with 4 or 8 warps, each
//     warp 16-64 rows x 32 columns;
//   * both mma operands must be K-contiguous and the weight is stored with
//     N contiguous (byte-identical to the reference, no repacked copy), so
//     the kernel transposes while it unpacks: a step stages 32 packed rows
//     x 128 columns of w and the matching x columns of every plane in
//     shared memory with cp.async (double buffered), and each thread turns
//     four 4-byte words of w (4 k rows x 4 columns) into its B fragments
//     with a 4x4 byte transpose (__byte_perm); the P codes of each byte are
//     then one shift and mask of the transposed word.  The 4 columns a
//     thread reads are the 4 n8 tiles' column g (column 4g + j of the
//     warp's 32 is column g of tile j), so its accumulators hold 8
//     contiguous output columns and the epilogue stores 16 or 32 bytes;
//   * the w tile's 16-byte chunks are XOR-swizzled by k row / 4 and the x
//     rows padded by 16 bytes, so fragment reads hit 32 distinct banks;
//   * K is split over blocks when the output tiles are fewer than a wave
//     (decode M: fewer than four blocks an SM); the int32 partials are
//     summed in a second pass (exact in any order), no atomics.
// Tensor-core rate at prefill M and the weight stream at decode M are the
// next steps (wgmma, deeper cp.async / TMA pipelines).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pq_tile.cuh"

namespace {

using namespace pq;

constexpr int kCols = 128;   // output columns per block
constexpr int kWarpsN = 4;   // warps across the columns, 32 columns each
constexpr int kRowsK = 32;   // packed rows per pipeline step

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Plane p's 4 codes of a word of 4 packed bytes, as 4 int8 values.
template <int P>
__device__ __forceinline__ uint32_t plane(uint32_t w, int p) {
  if constexpr (P == 1) {
    return w ^ 0x80808080u;                       // u8 -> s8: c - 128
  } else if constexpr (P == 2) {
    return (w >> (4 * p)) & 0x0f0f0f0fu;
  } else {
    return (w >> (2 * p)) & 0x03030303u;
  }
}

__device__ __forceinline__ float epilogue(int acc, float s, float zs,
                                          float xsum, float xs) {
  return __fmul_rn(__fsub_rn(__fmul_rn(__int2float_rn(acc), s),
                             __fmul_rn(xsum, zs)),
                   xs);
}

// Stage the step of packed rows r0 .. r0 + 31: the weight tile (each
// 16-byte chunk's column XOR-swizzled by (row / 4) % 4) and, per plane p,
// the x columns p * k/P + r0 .. + 31 of the tile's rows (zero past m).
template <int P, int kBM, int kThreads>
__device__ __forceinline__ void load_step(uint8_t* w_dst, uint8_t* x_dst,
                                          const uint8_t* __restrict__ w,
                                          const int8_t* __restrict__ xq,
                                          int r0, int n0, int m0, int m,
                                          int k, int n) {
  constexpr int kXPitch = 32 * P + 16;
  const int rows = k / P;
  for (int c = threadIdx.x; c < kRowsK * kCols / 16; c += kThreads) {
    const int row = c / (kCols / 16), col = (c % (kCols / 16)) * 16;
    cp_async16(w_dst + row * kCols + (col ^ (((row >> 2) & 3) << 5)),
               w + (size_t)(r0 + row) * n + n0 + col, true);
  }
  for (int c = threadIdx.x; c < kBM * 2 * P; c += kThreads) {
    const int row = c / (2 * P), q = c % (2 * P);
    const int p = q / 2, half = q % 2;
    const bool live = m0 + row < m;
    const int8_t* src =
        live ? xq + (size_t)(m0 + row) * k + (size_t)p * rows + r0 + half * 16
             : xq;
    cp_async16(x_dst + row * kXPitch + p * 32 + half * 16, src, live);
  }
}

// Two blocks an SM (at most 128 registers a thread for the 256-thread
// tiles): one block of 8 warps leaves the tensor cores idle while it waits
// on its cp.async stage.
template <int P, int WM, int MT>
__global__ void __launch_bounds__(WM * kWarpsN * 32, 2)
a8_gemm(const int8_t* __restrict__ xq, const float* __restrict__ xs,
        const uint8_t* __restrict__ w, const float* __restrict__ scale,
        const float* __restrict__ zs, const float* __restrict__ xsum,
        const int* __restrict__ block_expert,   // null: one weight
        void* __restrict__ out,
        int* __restrict__ partial,          // null: write `out` directly
        int m, int k, int n, int rows_per_split, int out_bf16) {
  constexpr int kThreads = WM * kWarpsN * 32;
  constexpr int kBM = WM * MT * 16;         // output rows per block
  constexpr int kXPitch = 32 * P + 16;      // bytes of a staged x row
  __shared__ __align__(16) uint8_t x_s[2][kBM * kXPitch];
  __shared__ __align__(16) uint8_t w_s[2][kRowsK * kCols];

  const int rows = k / P;                   // packed rows of the weight
  const int n0 = blockIdx.x * kCols;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * kBM;
  const int r_begin = split * rows_per_split;
  const int r_end = min(r_begin + rows_per_split, rows);
  const int steps = (r_end - r_begin) / kRowsK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp / kWarpsN) * MT * 16;   // the warp's rows in the tile
  const int wn0 = (warp % kWarpsN) * 32;        // and its columns
  if (block_expert != nullptr) {   // ragged: the row block's expert (kBM = 128)
    const size_t e = block_expert[blockIdx.z];
    w += e * rows * n;
    scale += e * n;
    zs += e * n;
  }

  int acc[MT][4][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0;

  load_step<P, kBM, kThreads>(w_s[0], x_s[0], w, xq, r_begin, n0, m0, m, k,
                              n);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps)
      load_step<P, kBM, kThreads>(w_s[(s + 1) & 1], x_s[(s + 1) & 1], w, xq,
                                  r_begin + (s + 1) * kRowsK, n0, m0, m, k, n);
    cp_async_commit();                      // (an empty group at the end)
    cp_async_wait1();                       // step s has landed
    __syncthreads();
    const uint8_t* ws = w_s[s & 1];
    const uint8_t* xsm = x_s[s & 1];

    // B: k rows 4t .. 4t+3 (h = 0) and 16 + 4t .. (h = 1) of the warp's
    // columns 4g .. 4g+3, transposed so bw[h][j] is column 4g + j
    uint32_t bw[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = h * 16 + t * 4 + i;   // (row / 4) % 4 == t
        bw[h][i] = *reinterpret_cast<const uint32_t*>(
            ws + row * kCols + ((wn0 + 4 * g) ^ (t << 5)));
      }
      transpose4(bw[h]);
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      uint32_t b[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 4; ++j) b[h][j] = plane<P>(bw[h][j], p);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const uint8_t* a =
            xsm + (wm0 + mi * 16 + g) * kXPitch + p * 32 + t * 4;
        const uint32_t a0 = *reinterpret_cast<const uint32_t*>(a);
        const uint32_t a1 = *reinterpret_cast<const uint32_t*>(a + 8 * kXPitch);
        const uint32_t a2 = *reinterpret_cast<const uint32_t*>(a + 16);
        const uint32_t a3 =
            *reinterpret_cast<const uint32_t*>(a + 8 * kXPitch + 16);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_s8(acc[mi][j], a0, a1, a2, a3, b[0][j], b[1][j]);
      }
    }
    __syncthreads();                        // before step s + 2 refills it
  }

  // thread (g, t) holds rows g and g + 8 of each m16 tile at the 8
  // contiguous columns wn0 + 8t .. + 7 (tile j's columns 2t, 2t + 1 are
  // physical 8t + j and 8t + 4 + j)
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = m0 + wm0 + mi * 16 + g + hr * 8;
      if (row >= m) continue;
      const int col = n0 + wn0 + 8 * t;
      int v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = acc[mi][j][2 * hr];
        v[4 + j] = acc[mi][j][2 * hr + 1];
      }
      if (partial != nullptr) {
        int* dst = partial + ((size_t)split * m + row) * n + col;
        *reinterpret_cast<int4*>(dst) = make_int4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<int4*>(dst + 4) = make_int4(v[4], v[5], v[6], v[7]);
        continue;
      }
      const float xr = xs[row], sr = xsum[row];
      float y[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        y[e] = epilogue(v[e], __ldg(scale + col + e), __ldg(zs + col + e), sr,
                        xr);
      const size_t o = (size_t)row * n + col;
      if (out_bf16) {
        uint32_t hv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const __nv_bfloat162 h2 = __floats2bfloat162_rn(y[2 * q], y[2 * q + 1]);
          hv[q] = *reinterpret_cast<const uint32_t*>(&h2);
        }
        *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + o) =
            make_uint4(hv[0], hv[1], hv[2], hv[3]);
      } else {
        float* dst = static_cast<float*>(out) + o;
        *reinterpret_cast<float4*>(dst) = make_float4(y[0], y[1], y[2], y[3]);
        *reinterpret_cast<float4*>(dst + 4) =
            make_float4(y[4], y[5], y[6], y[7]);
      }
    }
  }
}

// Second pass of a K split: the int32 partials summed, then the epilogue.
__global__ void a8_reduce(const int* __restrict__ partial,
                          const float* __restrict__ xs,
                          const float* __restrict__ scale,
                          const float* __restrict__ zs,
                          const float* __restrict__ xsum,
                          void* __restrict__ out, int m, int n, int ksplit,
                          int out_bf16) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)m * n;
  if (i >= total) return;
  const int row = (int)(i / n), col = (int)(i % n);
  int acc = 0;
  for (int sp = 0; sp < ksplit; ++sp) acc += partial[sp * total + i];
  const float y = epilogue(acc, scale[col], zs[col], xsum[row], xs[row]);
  if (out_bf16) {
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(y);
  } else {
    static_cast<float*>(out)[i] = y;
  }
}

template <int P, int WM, int MT>
int launch_tile(const void* xq, const void* xs, const void* w,
                const void* scale, const void* zs, const void* xsum,
                const void* block_expert, void* out, void* partial, int m,
                int k, int n, int ksplit, int rows_per_split, int out_bf16,
                cudaStream_t st) {
  constexpr int kBM = WM * MT * 16;
  const dim3 grid(n / kCols, ksplit, (m + kBM - 1) / kBM);
  a8_gemm<P, WM, MT><<<grid, WM * kWarpsN * 32, 0, st>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
      static_cast<const uint8_t*>(w), static_cast<const float*>(scale),
      static_cast<const float*>(zs), static_cast<const float*>(xsum),
      static_cast<const int*>(block_expert), out,
      ksplit > 1 ? static_cast<int*>(partial) : nullptr, m, k, n,
      rows_per_split, out_bf16);
  if (ksplit > 1) {
    const size_t total = (size_t)m * n;
    a8_reduce<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
        static_cast<const int*>(partial), static_cast<const float*>(xs),
        static_cast<const float*>(scale), static_cast<const float*>(zs),
        static_cast<const float*>(xsum), out, m, n, ksplit, out_bf16);
  }
  return (int)cudaGetLastError();
}

template <int P>
int launch(const void* xq, const void* xs, const void* w, const void* scale,
           const void* zs, const void* xsum, void* out, void* partial, int m,
           int k, int n, int bm, int ksplit, int rows_per_split, int out_bf16,
           void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (bm) {
    case 16:
      return launch_tile<P, 1, 1>(xq, xs, w, scale, zs, xsum, nullptr, out,
                                  partial, m,
                                  k, n, ksplit, rows_per_split, out_bf16, st);
    case 64:
      return launch_tile<P, 1, 4>(xq, xs, w, scale, zs, xsum, nullptr, out,
                                  partial, m,
                                  k, n, ksplit, rows_per_split, out_bf16, st);
    case 128:
      return launch_tile<P, 2, 4>(xq, xs, w, scale, zs, xsum, nullptr, out,
                                  partial, m,
                                  k, n, ksplit, rows_per_split, out_bf16, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// xq [m, k] int8, xs [m] f32, w [k/P, n] u8, scale [n] f32, zs [n] f32,
// xsum [m] f32, out [m, n] (bf16 if out_bf16 else f32), partial [ksplit, m,
// n] int32 scratch (unused when ksplit == 1); bm the output rows per block
// (16, 64 or 128).  Needs n % 128 == 0, k % 256 == 0, 16-byte aligned
// operands, rows_per_split a multiple of 32 and ksplit * rows_per_split >=
// k / P.
#define PQ_A8_ENTRY(NAME, P)                                                 \
  extern "C" int NAME(const void* xq, const void* xs, const void* w,         \
                      const void* scale, const void* zs, const void* xsum,   \
                      void* out, void* partial, int m, int k, int n, int bm, \
                      int ksplit, int rows_per_split, int out_bf16,          \
                      void* stream) {                                        \
    return launch<P>(xq, xs, w, scale, zs, xsum, out, partial, m, k, n, bm,  \
                     ksplit, rows_per_split, out_bf16, stream);              \
  }

PQ_A8_ENTRY(pq_w4a8, 2)
PQ_A8_ENTRY(pq_w8a8, 1)
PQ_A8_ENTRY(pq_w2a8, 4)

// The ragged form: xq [m, k] int8 rows sorted by expert, m a multiple of
// 128, block_expert [m / 128] int32, w [E, k/P, n] u8 (P = 2 or 4), scale /
// zs [E, n] f32, xs / xsum [m] f32; 128-row tiles, no K split.
extern "C" int pq_wq_ragged_a8(const void* xq, const void* xs, const void* w,
                               const void* scale, const void* zs,
                               const void* xsum, const void* block_expert,
                               void* out, int m, int k, int n, int planes,
                               int out_bf16, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (block_expert == nullptr || m % 128) return (int)cudaErrorInvalidValue;
  switch (planes) {
    case 2:
      return launch_tile<2, 2, 4>(xq, xs, w, scale, zs, xsum, block_expert,
                                  out, nullptr, m, k, n, 1, k / 2, out_bf16,
                                  st);
    case 4:
      return launch_tile<4, 2, 4>(xq, xs, w, scale, zs, xsum, block_expert,
                                  out, nullptr, m, k, n, 1, k / 4, out_bf16,
                                  st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
