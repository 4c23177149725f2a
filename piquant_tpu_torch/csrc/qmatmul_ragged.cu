// Ragged (megablocks-style) MoE expert GEMMs with bf16 activations, two
// entry points replacing TPU kernels of piquant_tpu/ops/pallas/qmatmul.py:
//
//   pq_wq_ragged          _wq_ragged_kernel          channelwise INT2/INT4/INT8 stacks
//   pq_wq_ragged_grouped  _wq_ragged_grouped_kernel  grouped INT2/INT4/INT8 stacks
//
// (the int8-activation form, _wq_ragged_a8_kernel, is qmatmul_a8.cu's
// template with the same expert lookup).
//
// x [m, k] bf16 holds the (token, expert) assignments sorted by expert, m =
// 128 nb, and row block i multiplies by expert e = block_expert[i] of the
// stack w [E, k/P, n] uint8 (n contiguous; byte row r holds code row r +
// p k/P in bits [p 8/P, (p+1) 8/P), P = 4 INT2, 2 INT4, 1 INT8):
//   channelwise, scale / zs [E, n] f32 (zs = zp scale), xsum [m] f32:
//     acc = sum_p x[:, p k/P + r] code_p(w[e, r, :])   (bf16 operands, f32 sums)
//     out = acc scale[e] - xsum zs[e]                  (the rank-1 zero-point fold)
//   grouped, scale / zp [E, k/gs, n] f32 / int32 (group of code row = row / gs):
//     wd  = bf16((code - zp) bf16(scale))              (one rounding, as the TPU kernel)
//     out = x @ wd                                     (f32 sums, no fold)
// Every block computes, the padding blocks past the last expert's end too
// (their rows are zero and their outputs are never gathered).
//
// Bound on the H100: at prefill (m of a few thousand rows) the bf16
// operations, 2 m n k at 989 TFLOP/s, which the TPU kernels fed to the MXU;
// a whole stack is read once per column tile from L2.  Design, right and
// simple first (qmatmul_a8.cu's structure, with bf16 operands):
//   * grid (n / 128, m / 128): a block reads block_expert[blockIdx.y] and
//     offsets its weight and side pointers by the expert (the TPU kernel's
//     DMA elision across same-expert blocks is left to L2);
//   * the bf16 tensor cores through mma.sync.m16n8k16 with f32
//     accumulation; 8 warps of 64 rows x 32 columns;
//   * a pipeline step stages 32 packed rows x 128 columns of w and the
//     matching 32 x columns of every plane with cp.async, double buffered
//     in dynamic shared memory (x rows padded by 32 bytes: the 8-byte
//     fragment loads of a half-warp hit distinct banks);
//   * the k order inside one 16-deep mma is free as long as A and B agree:
//     lane (g, t)'s mma k {2t, 2t+1, 2t+8, 2t+9} is actual k {4t .. 4t+3},
//     so its A fragment is one 8-byte load of x per row and its B fragment
//     the transposed weight word of qmatmul_a8.cu (4 k rows of one column);
//   * codes to bf16 exactly: INT2 / INT4 codes c as the bf16 bits 0x4300 | c
//     (128 + c) minus 128; INT8 codes through f32, (2^23 + c) - 2^23, whose
//     top half is bf16(c);
//   * grouped: the 32 rows of a step lie in one group when gs % 32 == 0
//     (one scale and zero point per column and plane a step); other group
//     sizes look them up per row.
// Tensor-core rate (wgmma, TMA, deeper pipelines) is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pq_tile.cuh"

namespace {

using namespace pq;

constexpr int kBM = 128;      // rows per block = the routing block
constexpr int kCols = 128;    // output columns per block
constexpr int kRowsK = 32;    // packed rows per pipeline step
constexpr int kWarpsN = 4;    // warps across the columns, 32 columns each
constexpr int kMT = 4;        // m16 tiles a warp (64 rows)
constexpr int kThreads = 256;

enum Mode { kChannel = 0, kGroupStep = 1, kGroupRow = 2 };

template <int P>   // bytes of a staged x row
__host__ __device__ constexpr int x_pitch() { return 64 * P + 32; }

template <int P>   // bytes of one pipeline stage (w tile, then x tile)
__host__ __device__ constexpr int stage_bytes() {
  return kRowsK * kCols + kBM * x_pitch<P>();
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Plane p of a word of 4 packed bytes: 4 unsigned codes, one a byte.
template <int P>
__device__ __forceinline__ uint32_t plane_codes(uint32_t w, int p) {
  if constexpr (P == 1) {
    return w;
  } else if constexpr (P == 2) {
    return (w >> (4 * p)) & 0x0f0f0f0fu;
  } else {
    return (w >> (2 * p)) & 0x03030303u;
  }
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Codes of bytes 2 half and 2 half + 1 of c as a bf16 pair (low = first).
template <int P>
__device__ __forceinline__ uint32_t code_pair(uint32_t c, int half) {
  if constexpr (P == 1) {
    const uint32_t c0 = (c >> (16 * half)) & 0xffu;
    const uint32_t c1 = (c >> (16 * half + 8)) & 0xffu;
    const float f0 = __uint_as_float(0x4b000000u | c0) - 8388608.0f;
    const float f1 = __uint_as_float(0x4b000000u | c1) - 8388608.0f;
    return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  } else {
    const uint32_t v = __byte_perm(c, 0x43434343u, half ? 0x4342 : 0x4140);
    return bf16x2_bits(__hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                               __float2bfloat162_rn(128.0f)));
  }
}

// (code - z) * s of bytes 2 half and 2 half + 1 of c, each rounded once to
// bf16 (the product of an integer below 2^8 and a bf16 is exact in f32).
__device__ __forceinline__ uint32_t deq_pair(uint32_t c, int half, float z0,
                                             float s0, float z1, float s1) {
  const float c0 = (float)((c >> (16 * half)) & 0xffu);
  const float c1 = (float)((c >> (16 * half + 8)) & 0xffu);
  return bf16x2_bits(__floats2bfloat162_rn(__fmul_rn(c0 - z0, s0),
                                           __fmul_rn(c1 - z1, s1)));
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Stage the step of packed rows r0 .. r0 + 31: the weight tile (each
// 16-byte chunk's column XOR-swizzled by (row / 4) % 4) and, per plane p,
// the x columns p k/P + r0 .. + 31 of the block's 128 rows.
template <int P>
__device__ __forceinline__ void load_step(uint8_t* w_dst, uint8_t* x_dst,
                                          const uint8_t* __restrict__ w,
                                          const uint16_t* __restrict__ x,
                                          int r0, int n0, int m0, int k,
                                          int n) {
  const int rows = k / P;
  for (int c = threadIdx.x; c < kRowsK * kCols / 16; c += kThreads) {
    const int row = c / (kCols / 16), col = (c % (kCols / 16)) * 16;
    cp_async16(w_dst + row * kCols + (col ^ (((row >> 2) & 3) << 5)),
               w + (size_t)(r0 + row) * n + n0 + col, true);
  }
  for (int c = threadIdx.x; c < kBM * 4 * P; c += kThreads) {
    const int row = c / (4 * P), q = c % (4 * P);
    const int p = q / 4, part = q % 4;
    cp_async16(x_dst + row * x_pitch<P>() + p * 64 + part * 16,
               x + (size_t)(m0 + row) * k + (size_t)p * rows + r0 + part * 8,
               true);
  }
}

template <int P, int kMode>
__global__ void __launch_bounds__(kThreads)
ragged_gemm(const uint16_t* __restrict__ x, const uint8_t* __restrict__ w,
            const float* __restrict__ scale,
            const void* __restrict__ side,      // zs [E, n] f32 or zp [E, G, n] i32
            const float* __restrict__ xsum,     // channelwise only
            const int* __restrict__ block_expert, void* __restrict__ out,
            int m, int k, int n, int gs, int out_bf16) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int kXPitch = x_pitch<P>();
  uint8_t* const w_s[2] = {smem, smem + stage_bytes<P>()};
  uint8_t* const x_s[2] = {smem + kRowsK * kCols,
                           smem + stage_bytes<P>() + kRowsK * kCols};

  const int rows = k / P;                   // packed rows of a weight
  const int n0 = blockIdx.x * kCols;
  const int m0 = blockIdx.y * kBM;
  const int steps = rows / kRowsK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp / kWarpsN) * kMT * 16;  // the warp's rows in the tile
  const int wn0 = (warp % kWarpsN) * 32;        // and its columns
  const int col0 = n0 + wn0 + 4 * g;            // column of transposed word 0
  const int groups = kMode == kChannel ? 1 : k / gs;
  const int gp = kMode == kChannel ? 0 : rows / gs;   // groups a plane

  // the row block's expert
  const size_t e = block_expert[blockIdx.y];
  w += e * rows * n;
  scale += e * groups * n;
  const float* zs = static_cast<const float*>(side) + e * n;
  const int* zp = static_cast<const int*>(side) + e * groups * n;

  float acc[kMT][4][4];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][j][q] = 0.0f;

  load_step<P>(w_s[0], x_s[0], w, x, 0, n0, m0, k, n);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    const int r0 = s * kRowsK;
    if (s + 1 < steps)
      load_step<P>(w_s[(s + 1) & 1], x_s[(s + 1) & 1], w, x, r0 + kRowsK, n0,
                   m0, k, n);
    cp_async_commit();                      // (an empty group at the end)
    cp_async_wait1();                       // step s has landed
    __syncthreads();
    const uint8_t* ws = w_s[s & 1];
    const uint8_t* xsm = x_s[s & 1];

    // k rows 16h + 4t .. + 3 of the warp's columns 4g .. 4g + 3,
    // transposed so bw[h][j] is column 4g + j
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
      // one group per column for the whole step (kGroupStep)
      float zc[4], sc[4];
      if constexpr (kMode == kGroupStep) {
        const size_t gi = (size_t)(p * gp + r0 / gs) * n + col0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          zc[j] = (float)__ldg(zp + gi + j);
          sc[j] = bf16_round(__ldg(scale + gi + j));
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t b[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t c = plane_codes<P>(bw[h][j], p);
          if constexpr (kMode == kChannel) {
            b[j][0] = code_pair<P>(c, 0);
            b[j][1] = code_pair<P>(c, 1);
          } else if constexpr (kMode == kGroupStep) {
            b[j][0] = deq_pair(c, 0, zc[j], sc[j], zc[j], sc[j]);
            b[j][1] = deq_pair(c, 1, zc[j], sc[j], zc[j], sc[j]);
          } else {
            float zr[4], sr[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int grp = p * gp + (r0 + 16 * h + 4 * t + i) / gs;
              const size_t gi = (size_t)grp * n + col0 + j;
              zr[i] = (float)__ldg(zp + gi);
              sr[i] = bf16_round(__ldg(scale + gi));
            }
            b[j][0] = deq_pair(c, 0, zr[0], sr[0], zr[1], sr[1]);
            b[j][1] = deq_pair(c, 1, zr[2], sr[2], zr[3], sr[3]);
          }
        }
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi) {
          const uint8_t* a = xsm + (wm0 + mi * 16 + g) * kXPitch +
                             (p * 32 + 16 * h + 4 * t) * 2;
          const uint2 lo = *reinterpret_cast<const uint2*>(a);
          const uint2 hi = *reinterpret_cast<const uint2*>(a + 8 * kXPitch);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_bf16(acc[mi][j], lo.x, hi.x, lo.y, hi.y, b[j][0], b[j][1]);
        }
      }
    }
    __syncthreads();                        // before step s + 2 refills it
  }

  // thread (g, t) holds rows g and g + 8 of each m16 tile at the 8
  // contiguous columns wn0 + 8t .. + 7 (tile j's columns 2t, 2t + 1 are
  // physical 8t + j and 8t + 4 + j)
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = m0 + wm0 + mi * 16 + g + hr * 8;
      const int col = n0 + wn0 + 8 * t;
      float y[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        y[j] = acc[mi][j][2 * hr];
        y[4 + j] = acc[mi][j][2 * hr + 1];
      }
      if constexpr (kMode == kChannel) {
        const float xr = xsum[row];
#pragma unroll
        for (int q = 0; q < 8; ++q)
          y[q] = __fsub_rn(__fmul_rn(y[q], __ldg(scale + col + q)),
                           __fmul_rn(xr, __ldg(zs + col + q)));
      }
      const size_t o = (size_t)row * n + col;
      if (out_bf16) {
        uint32_t hv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          hv[q] = bf16x2_bits(__floats2bfloat162_rn(y[2 * q], y[2 * q + 1]));
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

template <int P, int kMode>
int launch(const void* x, const void* w, const void* scale, const void* side,
           const void* xsum, const void* block_expert, void* out, int m,
           int k, int n, int gs, int out_bf16, void* stream) {
  constexpr int kSmem = 2 * stage_bytes<P>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      ragged_gemm<P, kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(n / kCols, m / kBM);
  ragged_gemm<P, kMode><<<grid, kThreads, kSmem,
                          reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(scale), side,
      static_cast<const float*>(xsum), static_cast<const int*>(block_expert),
      out, m, k, n, gs, out_bf16);
  return (int)cudaGetLastError();
}

bool shape_ok(int m, int k, int n, int planes) {
  return m > 0 && m % kBM == 0 && n % kCols == 0 && planes > 0 &&
         k % planes == 0 && (k / planes) % kRowsK == 0;
}

}  // namespace

// x [m, k] bf16, w [E, k/P, n] u8, scale / zs [E, n] f32, xsum [m] f32,
// block_expert [m / 128] int32, out [m, n] (bf16 if out_bf16 else f32).
// Needs m % 128 == 0, n % 128 == 0, (k / P) % 32 == 0, 16-byte aligned
// operands.
extern "C" int pq_wq_ragged(const void* x, const void* w, const void* scale,
                            const void* zs, const void* xsum,
                            const void* block_expert, void* out, int m, int k,
                            int n, int planes, int out_bf16, void* stream) {
  if (!shape_ok(m, k, n, planes)) return (int)cudaErrorInvalidValue;
  switch (planes) {
    case 1:
      return launch<1, kChannel>(x, w, scale, zs, xsum, block_expert, out, m,
                                 k, n, 0, out_bf16, stream);
    case 2:
      return launch<2, kChannel>(x, w, scale, zs, xsum, block_expert, out, m,
                                 k, n, 0, out_bf16, stream);
    case 4:
      return launch<4, kChannel>(x, w, scale, zs, xsum, block_expert, out, m,
                                 k, n, 0, out_bf16, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// As pq_wq_ragged with scale [E, k/gs, n] f32 and zp [E, k/gs, n] int32;
// gs divides k / P.
extern "C" int pq_wq_ragged_grouped(const void* x, const void* w,
                                    const void* scale, const void* zp,
                                    const void* block_expert, void* out, int m,
                                    int k, int n, int planes, int gs,
                                    int out_bf16, void* stream) {
  if (!shape_ok(m, k, n, planes) || gs <= 0 || (k / planes) % gs)
    return (int)cudaErrorInvalidValue;
  const bool step = gs % kRowsK == 0;
#define PQ_GROUPED(P)                                                        \
  return step ? launch<P, kGroupStep>(x, w, scale, zp, nullptr, block_expert, \
                                      out, m, k, n, gs, out_bf16, stream)    \
              : launch<P, kGroupRow>(x, w, scale, zp, nullptr, block_expert,  \
                                     out, m, k, n, gs, out_bf16, stream)
  switch (planes) {
    case 1:
      PQ_GROUPED(1);
    case 2:
      PQ_GROUPED(2);
    case 4:
      PQ_GROUPED(4);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PQ_GROUPED
}
