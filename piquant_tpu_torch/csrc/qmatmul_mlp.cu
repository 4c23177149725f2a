// mlp_fused: the gated MLP at decode M in one launch,
//   y = (act(x . w1) * (x . w3)) . w2,   act = SiLU or GELU (tanh form),
// channelwise INT4 split-half weights with the fused [w1 | w3] matrix.
//
// Replaces piquant_tpu/ops/pallas/qmatmul.py::_mlp_fused_kernel.  What it
// computes, step for step:
//   phase A, hidden column j (gate j, up i_ff + j of w13):
//     acc = x[:, :K/2] . lo(w13[:, j]) + x[:, K/2:] . hi(w13[:, j])  (f32)
//     g = acc * s13[j] - xsum * (zp13[j] * s13[j]),  u likewise,
//     h[:, j] = bf16(act(g) * u);
//   phase B, per split of the w2 packed rows r in [r0, r1):
//     part = (h[:, r] . lo(w2[r]) + h[:, r + i_ff/2] . hi(w2[r])) * s2
//            - hsum * (zp2 * s2),
//     hsum the f32 sum of the split's h values of both planes, so the zero
//     point folds per split (exact in real arithmetic for any split);
//   y = the parts summed in split order, in f32, rounded once to the
//     output type.  (The TPU kernel adds each chunk into the output in the
//     output dtype; here the sum is f32 and rounds once.)
// xsum is the f32 row sum of the bf16 x, as the TPU kernel is given it.
//
// Bound on the H100: the two code streams, (K/2) * 2 i_ff + (i_ff/2) * N
// bytes (88 MB at Llama-3-8B's K 4096, i_ff 14336, N 4096), plus the f32
// scales and zero points; x, h and y are a few hundred KB at decode M.
// Design: ONE cooperative launch of a grid that fits on the card at once
// (cudaLaunchCooperativeKernel), whose blocks walk four stages separated by
// grid-wide barriers:
//   A1  tiles of 8 rows x 128 w13 columns over a split of the K/2 packed
//       rows -> f32 partial sums [ksa, M, 2 i_ff] (the loop of the GEMV
//       template in qmatmul_gemv.cu: a warp reads one 128-byte line of a
//       packed row, expands both nibbles in registers, takes x from shared
//       memory; 8 rows in flight a warp);
//   A2  each (row, hidden column): the partials summed in split order, the
//       fold, the activation, h in bf16 to a global [M, i_ff] scratch
//       (229 KB at M 8: it stays in L2);
//   B1  tiles of 8 rows x 128 w2 columns over a split of the i_ff/2 packed
//       rows of w2, the split's hsum and fold -> f32 parts [ksb, M, N];
//   B2  each output: the parts summed in split order, rounded once.
// Every sum has a fixed order: the kernel is deterministic, with no atomics
// and no memset.  The splits give about four work tiles an SM in A1 and B1.
// h and the partials are written and read inside the launch, so they are
// read with plain (coherent) loads, never through the read-only path.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCols = 128;      // output columns per tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMT = 8;          // x rows per tile
constexpr int kStage = 8192;    // shared floats: x chunks, then the reduction
constexpr int kUnroll = 8;      // packed rows a warp has in flight
constexpr int kChunkRows = kStage / (kMT * 2);   // packed rows a staged chunk

struct MlpArgs {
  const __nv_bfloat16* x;   // [m, k]
  const uint8_t* w13;       // [k/2, 2 i_ff]
  const float* s13;         // [2 i_ff]
  const int* zp13;          // [2 i_ff]
  const uint8_t* w2;        // [i_ff/2, n]
  const float* s2;          // [n]
  const int* zp2;           // [n]
  const float* xsum;        // [m]
  void* out;                // [m, n] bf16 or f32
  float* part_a;            // [ksa, m, 2 i_ff]
  __nv_bfloat16* h;         // [m, i_ff]
  float* part_b;            // [ksb, m, n]
  int m, k, i_ff, n;
  int ksa, rows_a;          // K/2 packed rows split ksa ways, rows_a each
  int ksb, rows_b;          // i_ff/2 packed rows of w2 split ksb ways
  int gelu, out_bf16;
};

__device__ __forceinline__ float act_fn(float g, int gelu) {
  if (gelu) {
    // jax.nn.gelu(approximate=True): 0.5 g (1 + tanh(sqrt(2/pi) (g + 0.044715 g^3)))
    const float c = 0.7978845608028654f;
    return 0.5f * g * (1.f + tanhf(c * (g + 0.044715f * g * g * g)));
  }
  return g / (1.f + expf(-g));    // SiLU
}

// Sums of one tile: rows m0 .. m0+7 (zero past m) of the split-half
// product over packed rows [r0, r1) and columns col0 .. col0+127:
//   sum_r x[row, r] lo(w[r, col]) + x[row, r + kh] hi(w[r, col]),
// x with row stride ldx.  Calls emit(mi, cc, sum) for each of the 8 x 128
// sums, every thread for its own (mi, cc).  Uses the whole block and
// `smem`; it may be called again by the same block.
template <typename Emit>
__device__ __forceinline__ void tile_sums(const __nv_bfloat16* x, int ldx,
                                          int kh, const uint8_t* __restrict__ w,
                                          int n, int r0, int r1, int col0,
                                          int m0, int m, float* smem,
                                          Emit emit) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = col0 + lane * 4;
  float acc[kMT][4];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[mi][c] = 0.f;

  for (int c0 = r0; c0 < r1; c0 += kChunkRows) {
    const int nrows = min(c0 + kChunkRows, r1) - c0;
    __syncthreads();                      // smem is free to overwrite
    for (int i = threadIdx.x; i < nrows * kMT; i += kThreads) {
      const int mi = i / nrows, r = i % nrows;
      float* dst = smem + (r * kMT + mi) * 2;
      float lo = 0.f, hi = 0.f;
      if (m0 + mi < m) {
        const __nv_bfloat16* xr = x + (size_t)(m0 + mi) * ldx + c0 + r;
        lo = __bfloat162float(xr[0]);
        hi = __bfloat162float(xr[kh]);
      }
      dst[0] = lo;
      dst[1] = hi;
    }
    __syncthreads();

    const uint8_t* wp = w + (size_t)c0 * n + col;
    auto fetch = [&](int r) {
      return r < nrows ? __ldg(reinterpret_cast<const uint32_t*>(
                             wp + (size_t)r * n))
                       : 0u;
    };
    uint32_t next[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) next[u] = fetch(warp + u * kWarps);
    for (int rb = warp; rb < nrows; rb += kWarps * kUnroll) {
      uint32_t word[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {   // the next rows load meanwhile
        word[u] = next[u];
        next[u] = fetch(rb + (kUnroll + u) * kWarps);
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
          const float2 xv =
              *reinterpret_cast<const float2*>(smem + (r * kMT + mi) * 2);
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[mi][c] = fmaf(xv.y, hi[c], fmaf(xv.x, lo[c], acc[mi][c]));
        }
      }
    }
  }

  // the 8 warps' row subsets, summed through shared memory in warp order
  __syncthreads();
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
    *reinterpret_cast<float4*>(&smem[(warp * kMT + mi) * kCols + lane * 4]) =
        make_float4(acc[mi][0], acc[mi][1], acc[mi][2], acc[mi][3]);
  __syncthreads();
  for (int i = threadIdx.x; i < kMT * kCols; i += kThreads) {
    const int mi = i / kCols, cc = i % kCols;
    float s = 0.f;
#pragma unroll
    for (int wv = 0; wv < kWarps; ++wv) s += smem[(wv * kMT + mi) * kCols + cc];
    emit(mi, cc, s);
  }
}

__global__ void __launch_bounds__(kThreads)
mlp_fused_kernel(const MlpArgs a) {
  __shared__ __align__(16) float smem[kStage];
  __shared__ float hsum[kMT];
  cg::grid_group grid = cg::this_grid();
  const int mt = (a.m + kMT - 1) / kMT;
  const int n2 = 2 * a.i_ff;
  const int kh = a.k / 2, ih = a.i_ff / 2;

  // ---- A1: w13 partial sums -------------------------------------------
  {
    const int ct = n2 / kCols;
    const int items = mt * ct * a.ksa;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int s = it % a.ksa, c = (it / a.ksa) % ct, t = it / (a.ksa * ct);
      const int r0 = s * a.rows_a, r1 = min(r0 + a.rows_a, kh);
      const int m0 = t * kMT;
      float* dst = a.part_a + (size_t)s * a.m * n2;
      tile_sums(a.x, a.k, kh, a.w13, n2, r0, r1, c * kCols, m0, a.m, smem,
                [&](int mi, int cc, float v) {
                  if (m0 + mi < a.m)
                    dst[(size_t)(m0 + mi) * n2 + c * kCols + cc] = v;
                });
    }
  }
  grid.sync();

  // ---- A2: fold, activation, h ----------------------------------------
  {
    const size_t total = (size_t)a.m * a.i_ff;
    for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < total;
         i += (size_t)gridDim.x * kThreads) {
      const int row = (int)(i / a.i_ff), j = (int)(i % a.i_ff);
      float g = 0.f, u = 0.f;
      for (int s = 0; s < a.ksa; ++s) {
        const float* p = a.part_a + ((size_t)s * a.m + row) * n2;
        g += p[j];
        u += p[a.i_ff + j];
      }
      const float sg = a.s13[j], su = a.s13[a.i_ff + j];
      const float xs = a.xsum[row];
      g = g * sg - xs * ((float)a.zp13[j] * sg);
      u = u * su - xs * ((float)a.zp13[a.i_ff + j] * su);
      a.h[i] = __float2bfloat16(act_fn(g, a.gelu) * u);
    }
  }
  grid.sync();

  // ---- B1: w2 parts, folded per split ---------------------------------
  {
    const int ct = a.n / kCols;
    const int items = mt * ct * a.ksb;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int s = it % a.ksb, c = (it / a.ksb) % ct, t = it / (a.ksb * ct);
      const int r0 = s * a.rows_b, r1 = min(r0 + a.rows_b, ih);
      const int m0 = t * kMT;
      // the split's h sum of each row, warp `mi` for row m0 + mi, in a
      // fixed order (lane stride, then the shuffle tree)
      {
        float hs = 0.f;
        if (m0 + warp < a.m) {
          const __nv_bfloat16* hr = a.h + (size_t)(m0 + warp) * a.i_ff;
          for (int r = r0 + lane; r < r1; r += 32)
            hs += __bfloat162float(hr[r]) + __bfloat162float(hr[r + ih]);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          hs += __shfl_xor_sync(0xffffffffu, hs, o);
        if (lane == 0) hsum[warp] = hs;   // read after tile_sums' barriers
      }
      float* dst = a.part_b + (size_t)s * a.m * a.n;
      tile_sums(a.h, a.i_ff, ih, a.w2, a.n, r0, r1, c * kCols, m0, a.m, smem,
                [&](int mi, int cc, float v) {
                  const int col = c * kCols + cc;
                  if (m0 + mi < a.m) {
                    const float sc = a.s2[col];
                    dst[(size_t)(m0 + mi) * a.n + col] =
                        v * sc - hsum[mi] * ((float)a.zp2[col] * sc);
                  }
                });
      __syncthreads();                    // hsum is rewritten next item
    }
  }
  grid.sync();

  // ---- B2: the parts in split order, one rounding ---------------------
  {
    const size_t total = (size_t)a.m * a.n;
    for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < total;
         i += (size_t)gridDim.x * kThreads) {
      float y = 0.f;
      for (int s = 0; s < a.ksb; ++s) y += a.part_b[(size_t)s * total + i];
      if (a.out_bf16) {
        reinterpret_cast<__nv_bfloat16*>(a.out)[i] = __float2bfloat16(y);
      } else {
        reinterpret_cast<float*>(a.out)[i] = y;
      }
    }
  }
}

}  // namespace

// x [m, k] bf16; w13 [k/2, 2 i_ff] u8 split-half codes of [w1 | w3], s13 /
// zp13 [2 i_ff] f32 / int32; w2 [i_ff/2, n] u8, s2 / zp2 [n]; xsum [m] f32;
// out [m, n] (bf16 if out_bf16 else f32); scratch part_a [ksa, m, 2 i_ff]
// f32, h [m, i_ff] bf16, part_b [ksb, m, n] f32.  Needs k % 256 == 0,
// i_ff % 256 == 0, n % 128 == 0, 16-byte aligned operands, ksa * rows_a >=
// k / 2 and ksb * rows_b >= i_ff / 2.  The grid is as many blocks as fit
// on the card at once (at most 4 an SM), launched cooperatively.  Returns
// cudaGetLastError() or the launch's error.
extern "C" int pq_mlp_fused(const void* x, const void* w13, const void* s13,
                            const void* zp13, const void* w2, const void* s2,
                            const void* zp2, const void* xsum, void* out,
                            void* part_a, void* h, void* part_b, int m, int k,
                            int i_ff, int n, int ksa, int rows_a, int ksb,
                            int rows_b, int gelu, int out_bf16,
                            void* stream) {
  MlpArgs a{static_cast<const __nv_bfloat16*>(x),
            static_cast<const uint8_t*>(w13), static_cast<const float*>(s13),
            static_cast<const int*>(zp13), static_cast<const uint8_t*>(w2),
            static_cast<const float*>(s2), static_cast<const int*>(zp2),
            static_cast<const float*>(xsum), out,
            static_cast<float*>(part_a), static_cast<__nv_bfloat16*>(h),
            static_cast<float*>(part_b), m, k, i_ff, n, ksa, rows_a, ksb,
            rows_b, gelu, out_bf16};
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mlp_fused_kernel, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int blocks = sms * (per_sm < 4 ? per_sm : 4);
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)mlp_fused_kernel,
                                  dim3(blocks), dim3(kThreads), args, 0,
                                  reinterpret_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
