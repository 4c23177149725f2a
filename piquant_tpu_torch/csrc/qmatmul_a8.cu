// Activation-quantized (int8 x) matmul: one kernel template, four entry
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
// zs [E, n], and the row blocks at or past live_blocks[0] (the routing's
// p_end[-1] / 128, on the device) hold only padding: they write their zero
// tile and return.
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
// Bound on the H100: at prefill M (> 64) the int8 operations, 2 M N K at
// 1,979 TOP/s, which the TPU kernels fed to the MXU's int8 path; at decode
// M (<= 64) the weight stream, k n / P bytes.
//
// Decode tiles (M <= 64: 16 or 64 rows a block): mma.sync.m16n8k32.s8.s8
// .s32, 4 warps of 32 columns, a two-stage cp.async pipeline of 32 packed
// rows x 128 columns; each thread turns four 4-byte words of w (4 k rows x
// 4 columns) into its B fragments with a 4x4 byte transpose (__byte_perm),
// the P codes of a byte then one shift and mask; the w chunks XOR-swizzled
// by k row / 4 and the x rows padded by 16 bytes, so fragment reads hit 32
// distinct banks; K split over blocks when there are fewer than four
// blocks an SM, the int32 partials summed by a second pass (a8_reduce).
// These tiles stream the weight and beat torch.matmul on the bf16 weight
// 1.4-2.7x; they are kept as they were.
//
// Prefill tiles (M > 64), against what held the mma.sync design at 21-23%
// of the int8 peak:
//   * the tensor cores through s8 wgmma (sm_90a) with the operands
//     swapped: 8-bit wgmma takes both operands K-major and the weight is
//     stored N-contiguous (byte-identical to the reference, no repacked
//     copy), so a block computes the transpose of its tile, out^T[n, m] =
//     codes^T xq^T, with m64nNk32.s32.s8.s8.  A (the codes) is built in
//     registers by each thread from the packed bytes in shared memory
//     (conflict-free: half the threads read their 4 rows in another
//     order), the 4x4 byte transpose (or, at 2 columns a thread, a 2x4
//     one) and one shift and mask (XOR at INT8) a word; never stored back,
//     so no proxy fence.  The order of weight columns inside an m64 tile is free (the
//     epilogue undoes it): a thread's transposed columns feed its rows g
//     and g + 8 of one or two m64 tiles with no shuffle.  B (xq) is read by
//     the tensor cores from shared memory, K-major, swizzled to its box's
//     width (128, 64 or 32 bytes at P = 1, 2, 4), one TMA box a plane at
//     column p k/P + r0;
//   * a TMA ring of 4-8 stages (as many as 227 KB hold), each of 128 / P
//     packed rows: four k32 steps at every P (INT8 one stage step before).
//     Thread 0 issues the loads, the first S stages up front and stage s -
//     1 + S once every warp has released stage s - 1's slot; the
//     warpgroup builds the next k32 step's A fragments while the current
//     wgmmas run (two fragment buffers, wgmma.wait_group 1).  Every branch
//     of the main loop is uniform in the warpgroup (ptxas serializes
//     in-flight wgmmas across a branch it cannot prove uniform), and a
//     warpgroup without columns computes on stale shared memory and stores
//     nothing;
//   * 256 threads, two consumer warpgroups, 128 s32 sums a thread and up
//     to 255 registers: a block is 256 weight columns x 128 tokens (each
//     warpgroup two m64 tiles, m64n128k32, 32-bit word reads) or 128
//     columns x 256 tokens (one m64 tile, m64n256k32, 16-bit reads), the
//     host's choice (ops/cuda/qmatmul.py::a8_prefill_bm: the second above
//     M 128, which unpacks half the codes a product, but for INT2 at K >
//     8192, where its stages of 32-byte x rows stream 1.5x the bytes); the
//     ragged form takes the first, whose 128 tokens are a routing block;
//   * K split when the tiles fill less than a wave, chosen on the host
//     (ops/cuda/qmatmul.py::a8_split) in whole stages; each split writes
//     its int32 sums and a8_reduce adds them (exact in any order).  The
//     other form, the last split of a tile to finish adding the others'
//     sums behind an int32 ticket in the same launch, ran slower at every
//     split count of an N 1024 sweep on an H100 (one block reads every
//     partial of its tile);
//   * the epilogue on the transposed fragment: the per-token and
//     per-column factors are loaded before the main loop and staged in
//     shared memory after it; a thread holds 2 or 4 contiguous columns of
//     each of its tokens, stored as one 8- or 16-byte (f32) or 4- or
//     8-byte (bf16) write a row, whole 32-byte sectors a warp.  Staging
//     the output tile through shared memory for 16-byte row stores made
//     the epilogue slower on an H100 (tools/a8_timeline.py), so it is not
//     done.  Rows past m are never stored (TMA fills x past m with zeros);
//   * the ragged form skips padding blocks (above); its grid is expert-
//     major with the row blocks fastest, so the resident blocks share one
//     expert's weight through L2.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pq_hopper.cuh"
#include "pq_tile.cuh"

namespace {

using namespace pq;

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

// ---------------------------------------------------------------------------
// decode tiles: mma.sync
// ---------------------------------------------------------------------------

constexpr int kCols = 128;   // output columns per block
constexpr int kWarpsN = 4;   // warps across the columns, 32 columns each
constexpr int kRowsK = 32;   // packed rows per pipeline step
constexpr int kSmallThreads = kWarpsN * 32;

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Stage the step of packed rows r0 .. r0 + 31: the weight tile (each
// 16-byte chunk's column XOR-swizzled by (row / 4) % 4) and, per plane p,
// the x columns p * k/P + r0 .. + 31 of the tile's rows (zero past m).
template <int P, int kBM>
__device__ __forceinline__ void load_step(uint8_t* w_dst, uint8_t* x_dst,
                                          const uint8_t* __restrict__ w,
                                          const int8_t* __restrict__ xq,
                                          int r0, int n0, int m0, int m,
                                          int k, int n) {
  constexpr int kXPitch = 32 * P + 16;
  const int rows = k / P;
  for (int c = threadIdx.x; c < kRowsK * kCols / 16; c += kSmallThreads) {
    const int row = c / (kCols / 16), col = (c % (kCols / 16)) * 16;
    cp_async16(w_dst + row * kCols + (col ^ (((row >> 2) & 3) << 5)),
               w + (size_t)(r0 + row) * n + n0 + col, true);
  }
  for (int c = threadIdx.x; c < kBM * 2 * P; c += kSmallThreads) {
    const int row = c / (2 * P), q = c % (2 * P);
    const int p = q / 2, half = q % 2;
    const bool live = m0 + row < m;
    const int8_t* src =
        live ? xq + (size_t)(m0 + row) * k + (size_t)p * rows + r0 + half * 16
             : xq;
    cp_async16(x_dst + row * kXPitch + p * 32 + half * 16, src, live);
  }
}

// A (16 MT) x 128 output tile with 4 warps, each MT m16 tiles x 32
// columns.  Two blocks an SM.
template <int P, int MT>
__global__ void __launch_bounds__(kSmallThreads, 2)
a8_gemm(const int8_t* __restrict__ xq, const float* __restrict__ xs,
        const uint8_t* __restrict__ w, const float* __restrict__ scale,
        const float* __restrict__ zs, const float* __restrict__ xsum,
        void* __restrict__ out,
        int* __restrict__ partial,          // null: write `out` directly
        int m, int k, int n, int rows_per_split, int out_bf16) {
  constexpr int kBM = MT * 16;              // output rows per block
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
  const int wn0 = warp * 32;                // the warp's columns

  int acc[MT][4][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0;

  load_step<P, kBM>(w_s[0], x_s[0], w, xq, r_begin, n0, m0, m, k, n);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps)
      load_step<P, kBM>(w_s[(s + 1) & 1], x_s[(s + 1) & 1], w, xq,
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
        const uint8_t* a = xsm + (mi * 16 + g) * kXPitch + p * 32 + t * 4;
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
      const int row = m0 + mi * 16 + g + hr * 8;
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

// ---------------------------------------------------------------------------
// prefill tiles: s8 wgmma fed by a TMA ring
// ---------------------------------------------------------------------------

constexpr int kSmemMax = 232448;   // a block's shared memory
constexpr int kThreads = 256;      // two consumer warpgroups
constexpr int kBox = 128;          // weight columns a TMA box (128-byte rows)

// MT m64 tiles a warpgroup: 128 MT weight columns x 256 / MT tokens a
// block; a stage of R = 128 / P packed rows (four k32 steps).
template <int P, int MT>
struct Cfg {
  static constexpr int R = 128 / P;
  static constexpr int kCols = 128 * MT;
  static constexpr int kBN = 256 / MT;          // tokens a block (wgmma N)
  static constexpr int kWBox = R * kBox;
  static constexpr int kW = MT * kWBox;         // the stage's weight boxes
  static constexpr int kX = kBN * R;            // one plane's x box
  static constexpr int kStage = kW + P * kX;
  static constexpr int kFit = (kSmemMax - 1024 - 256) / kStage;
  static constexpr int S = kFit < 8 ? kFit : 8;  // ring stages
  // 1 KB to align the ring, the ring, barriers
  static constexpr int kSmem = 1024 + S * kStage + 2 * S * 8;
};

// Descriptor of x's box (K-major, R-byte rows) under its swizzle.
template <int P>
__device__ __forceinline__ uint64_t x_desc(uint32_t addr) {
  if constexpr (P == 1) {
    return desc_sw128(addr);
  } else if constexpr (P == 2) {
    return desc_sw64(addr);
  } else {
    return desc_sw32(addr);
  }
}

template <int P, int MT>
__global__ void __launch_bounds__(kThreads, 1)
a8_wgmma(const __grid_constant__ CUtensorMap x_map,   // [m, k] int8
         const __grid_constant__ CUtensorMap w_map,   // [E, k/P, n] u8
         const float* __restrict__ xs, const float* __restrict__ scale,
         const float* __restrict__ zs, const float* __restrict__ xsum,
         const int* __restrict__ block_expert,   // null: one weight
         const int* __restrict__ live_blocks,    // [1] or null: all live
         void* __restrict__ out,
         int* __restrict__ partial,              // [ksplit, m, n]; null: no split
         int m, int k, int n, int split_stages, int out_bf16) {
  using C = Cfg<P, MT>;
  constexpr int R = C::R, S = C::S, kBN = C::kBN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + S * C::kStage);
  uint64_t* const empty = full + S;

  const int rows = k / P;                   // packed rows of a weight
  const int m0 = blockIdx.x * kBN;
  const int n0 = blockIdx.y * C::kCols;
  const int split = blockIdx.z;
  const int first = split * split_stages;   // the split's first stage
  const int steps = min(split_stages, k / 128 - first);
  // MT 2: the block's second weight box has columns (n % 256 may be 128)
  const bool two = MT == 1 || n0 + kBox < n;

  if (live_blocks && (int)blockIdx.x >= __ldg(live_blocks)) {
    // padding only: the zero tile
    const int esz = out_bf16 ? 2 : 4;
    const int chunks = (two ? C::kCols : kBox) * esz / 16;   // a row's
    uint8_t* o = static_cast<uint8_t*>(out) + ((size_t)m0 * n + n0) * esz;
    for (int i = threadIdx.x; i < kBN * chunks; i += kThreads)
      if (m0 + i / chunks < m)
        *reinterpret_cast<uint4*>(o + (size_t)(i / chunks) * n * esz +
                                  (i % chunks) * 16) = make_uint4(0, 0, 0, 0);
    return;
  }
  const int e = block_expert ? __ldg(block_expert + blockIdx.x) : 0;
  if (block_expert) {
    scale += (size_t)e * n;
    zs += (size_t)e * n;
  }
  // The epilogue's per-token and per-column factors, one of each a thread,
  // loaded now (their latency under the main loop) and staged in shared
  // memory after it: read row by row from global memory they made the
  // epilogue wait on each load (tools/a8_timeline.py on an H100 showed it
  // longer than the ring's first fill and the epilogue as it is together).
  const int tid = threadIdx.x;
  const bool tok = tid < kBN && m0 + tid < m;
  const bool chan = tid < C::kCols && n0 + tid < n;
  const float xs_t = tok ? __ldg(xs + m0 + tid) : 0.0f;
  const float xsum_t = tok ? __ldg(xsum + m0 + tid) : 0.0f;
  const float scale_t = chan ? __ldg(scale + n0 + tid) : 0.0f;
  const float zs_t = chan ? __ldg(zs + n0 + tid) : 0.0f;

  // The TMA loads of the split's stage s into its ring slot, issued where
  // `on` (one thread).
  auto load_stage = [&](int s, bool on) {
    const int slot = s % S;
    uint8_t* st = smem + slot * C::kStage;
    const int r0 = (first + s) * R;
    mbar_arrive_tx(&full[slot], (two ? MT : 1) * C::kWBox + P * C::kX, on);
    tma_load_3d(st, &w_map, &full[slot], n0, r0, e, on);
    if constexpr (MT == 2)
      tma_load_3d(st + C::kWBox, &w_map, &full[slot], n0 + kBox, r0, e,
                  on && two);
#pragma unroll
    for (int p = 0; p < P; ++p)
      tma_load_2d(st + C::kW + p * C::kX, &x_map, &full[slot], p * rows + r0,
                  m0, on);
  };

  // thread 0 issues the loads: the first S stages now, then stage s - 1 +
  // S once every warp has released stage s - 1's slot
  const bool leader = threadIdx.x == 0;
  if (leader) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);               // the leader's arrival
      mbar_init(&empty[s], kThreads / 32);  // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < S && s < steps; ++s) load_stage(s, true);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const bool cols_live = MT == 1 || wg == 0 || two;   // uniform in the warpgroup
  // The thread's weight columns in the box it reads.  MT 2: box wg,
  // columns col .. col + 3 (col = 32 warp + 4g), column col + 2 mt + c
  // being m64 tile mt's row g + 8c; MT 1: box 0, columns col, col + 1 (col
  // = 64 wg + 16 warp + 2g), column col + c its row g + 8c.  A thread
  // reads k rows 4t .. 4t + 3 (+ 16) of a step: threads t and t + 2 would
  // read rows 8 apart, in the same banks under the 128-byte swizzle
  // (16-byte chunk ^= row % 8), so threads t >= 2 read them in the order
  // 2, 3, 0, 1 (register i holds row 4t + (i ^ rot)) and their byte
  // permutes put the rows back in order: each load of a warp hits 32
  // distinct banks.  off[i]: register i's row and column offset.
  const int box = MT == 2 ? wg : 0;
  const int col = MT == 2 ? 32 * warp + 4 * g : 64 * wg + 16 * warp + 2 * g;
  const int rot = t & 2;
  const uint32_t sel_lo = rot ? 0x1054 : 0x5410;
  const uint32_t sel_hi = rot ? 0x3276 : 0x7632;
  int off[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * t + (i ^ rot);
    off[i] = r * kBox + ((((col >> 4) ^ (r & 7)) << 4) + (col & 15));
  }

  int acc[MT][kBN / 2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[mt][i] = 0;

  // cw[2 MT h + j]: column j's bytes (of the thread's 2 MT) at packed rows
  // 32 jj + 16 h + 4t .. + 3 of the stage in slot st (byte i = row + i):
  // the 4x4 (MT 2) or 2x4 (MT 1) byte transpose of the loaded words
  uint32_t cw[4 * MT];
  auto load_words = [&](const uint8_t* st, int jj) {
    const uint8_t* ws = st + box * C::kWBox + 32 * jj * kBox;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t r[4];
      if constexpr (MT == 2) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          r[i] = *reinterpret_cast<const uint32_t*>(ws + 16 * h * kBox +
                                                    off[i]);
        const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
        const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
        const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
        const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
        cw[4 * h] = __byte_perm(t0, t2, sel_lo);
        cw[4 * h + 1] = __byte_perm(t0, t2, sel_hi);
        cw[4 * h + 2] = __byte_perm(t1, t3, sel_lo);
        cw[4 * h + 3] = __byte_perm(t1, t3, sel_hi);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          r[i] = *reinterpret_cast<const uint16_t*>(ws + 16 * h * kBox +
                                                    off[i]);
        const uint32_t lo = __byte_perm(r[0], r[1], 0x5140);
        const uint32_t hi = __byte_perm(r[2], r[3], 0x5140);
        cw[2 * h] = __byte_perm(lo, hi, sel_lo);
        cw[2 * h + 1] = __byte_perm(lo, hi, sel_hi);
      }
    }
  };
  // plane p's A fragments of the loaded words
  auto build = [&](uint32_t (&f)[MT][4], int p) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      f[mt][0] = plane<P>(cw[2 * mt], p);
      f[mt][1] = plane<P>(cw[2 * mt + 1], p);
      f[mt][2] = plane<P>(cw[2 * MT + 2 * mt], p);
      f[mt][3] = plane<P>(cw[2 * MT + 2 * mt + 1], p);
    }
  };
  // the wgmmas of k32 step (jj, p) against slot st's x box of plane p, one
  // group
  auto issue = [&](const uint32_t (&f)[MT][4], const uint8_t* st, int jj,
                   int p) {
    wgmma_fence();
    const uint64_t d = x_desc<P>(smem_u32(st + C::kW + p * C::kX) + 32 * jj);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) wgmma_s8<kBN>(acc[mt], f[mt], d);
    wgmma_commit();
  };

  // A stage's k32 steps q = 0 .. 3 are (rows 32 (q / P) .., plane q % P).
  // Two fragment buffers: even steps in f0, odd in f1; each step's
  // fragments are built while the step before it is in the tensor cores,
  // and a buffer is rebuilt only after the wgmmas that read it are waited
  // on.  Every branch below is uniform in the block.
  uint32_t f0[MT][4], f1[MT][4];
  const uint8_t* st = smem;
  mbar_wait(&full[0], 0);
  load_words(st, 0);
  build(f0, 0);
  issue(f0, st, 0, 0);
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int q = 1; q < 4; ++q) {
      if (q % P == 0) load_words(st, q / P);
      if (q & 1) {
        build(f1, q % P);
        issue(f1, st, q / P, q % P);
      } else {
        build(f0, q % P);
        issue(f0, st, q / P, q % P);
      }
      wgmma_wait<1>();                      // step q - 1 done
    }
    if (s + 1 < steps) {
      const int next = (s + 1) % S;
      mbar_wait(&full[next], ((s + 1) / S) & 1);
      st = smem + next * C::kStage;
      load_words(st, 0);
      build(f0, 0);
      issue(f0, st, 0, 0);
      wgmma_wait<1>();                      // stage s read
    } else {
      wgmma_wait<0>();
    }
    __syncwarp();
    mbar_arrive(&empty[s % S], lane == 0);  // one arrival a warp
    if (s >= 1 && s - 1 + S < steps) {
      // refill the slot of stage s - 1 once every warp has released it
      mbar_wait(&empty[(s - 1) % S], ((s - 1) / S) & 1);
      load_stage(s - 1 + S, leader);
    }
  }
  wgmma_wait<0>();                          // (provably) nothing in flight

  // acc[mt][4i + 2c + h]: column cbase + 2 mt + c, token m0 + 8i + 2t + h
  constexpr int kV = 2 * MT;                // a thread's contiguous columns
  const int cbase = n0 + box * kBox + col;
  if (partial != nullptr) {
    // K split: this split's int32 sums, for a8_reduce
    if (!cols_live) return;
#pragma unroll
    for (int i = 0; i < kBN / 8; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + 8 * i + 2 * t + h;
        if (row >= m) continue;
        int* dst = partial + ((size_t)split * m + row) * n + cbase;
        if constexpr (MT == 2) {
          *reinterpret_cast<int4*>(dst) =
              make_int4(acc[0][4 * i + h], acc[0][4 * i + 2 + h],
                        acc[1][4 * i + h], acc[1][4 * i + 2 + h]);
        } else {
          *reinterpret_cast<int2*>(dst) =
              make_int2(acc[0][4 * i + h], acc[0][4 * i + 2 + h]);
        }
      }
    }
    return;
  }
  // the ring is free once every warp is past its last wgmma: ep holds xs,
  // xsum of the block's tokens, then scale, zs of its columns
  float* const ep = reinterpret_cast<float*>(smem);
  __syncthreads();
  if (tid < kBN) {
    ep[tid] = xs_t;
    ep[kBN + tid] = xsum_t;
  }
  if (tid < C::kCols) {
    ep[2 * kBN + tid] = scale_t;
    ep[2 * kBN + C::kCols + tid] = zs_t;
  }
  __syncthreads();
  if (!cols_live) return;

  float sc[kV], zz[kV];
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    sc[j] = ep[2 * kBN + cbase - n0 + j];
    zz[j] = ep[2 * kBN + C::kCols + cbase - n0 + j];
  }
#pragma unroll
  for (int i = 0; i < kBN / 8; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + 8 * i + 2 * t + h;
      if (row >= m) continue;
      const float xr = ep[row - m0], sr = ep[kBN + row - m0];
      float y[kV];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          y[2 * mt + c] = epilogue(acc[mt][4 * i + 2 * c + h], sc[2 * mt + c],
                                   zz[2 * mt + c], sr, xr);
      const size_t o = (size_t)row * n + cbase;
      if (out_bf16) {
        uint32_t hv[kV / 2];
#pragma unroll
        for (int q = 0; q < kV / 2; ++q) {
          const __nv_bfloat162 h2 =
              __floats2bfloat162_rn(y[2 * q], y[2 * q + 1]);
          hv[q] = *reinterpret_cast<const uint32_t*>(&h2);
        }
        __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(out) + o;
        if constexpr (MT == 2) {
          *reinterpret_cast<uint2*>(dst) = make_uint2(hv[0], hv[1]);
        } else {
          *reinterpret_cast<uint32_t*>(dst) = hv[0];
        }
      } else {
        float* dst = static_cast<float*>(out) + o;
        if constexpr (MT == 2) {
          *reinterpret_cast<float4*>(dst) = make_float4(y[0], y[1], y[2], y[3]);
        } else {
          *reinterpret_cast<float2*>(dst) = make_float2(y[0], y[1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <int P, int MT>
int launch_small(const void* xq, const void* xs, const void* w,
                 const void* scale, const void* zs, const void* xsum,
                 void* out, void* partial, int m, int k, int n, int ksplit,
                 int rows_per_split, int out_bf16, cudaStream_t st) {
  constexpr int kBM = MT * 16;
  const dim3 grid(n / kCols, ksplit, (m + kBM - 1) / kBM);
  a8_gemm<P, MT><<<grid, kSmallThreads, 0, st>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
      static_cast<const uint8_t*>(w), static_cast<const float*>(scale),
      static_cast<const float*>(zs), static_cast<const float*>(xsum), out,
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

// The wgmma tile over n_experts weights of [k/P, n] (1: a dense weight),
// ksplit splits of split_stages stages, their partials summed by
// a8_reduce.
template <int P, int MT>
int launch_wgmma(const void* xq, const void* xs, const void* w,
                 const void* scale, const void* zs, const void* xsum,
                 const void* block_expert, const void* live_blocks,
                 void* out, void* partial, int m, int k, int n,
                 int n_experts, int ksplit, int split_stages, int out_bf16,
                 cudaStream_t st) {
  using C = Cfg<P, MT>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      a8_wgmma<P, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  constexpr CUtensorMapSwizzle kXSwizzle =
      P == 1 ? CU_TENSOR_MAP_SWIZZLE_128B
             : P == 2 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap xm, wm;
  const uint64_t xd[2] = {(uint64_t)k, (uint64_t)m};
  const uint32_t xb[2] = {C::R, C::kBN};
  const uint64_t wd[3] = {(uint64_t)n, (uint64_t)(k / P),
                          (uint64_t)n_experts};
  const uint32_t wb[3] = {kBox, C::R, 1};
  if (!encode(&xm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 2, xq, xd, xb,
              kXSwizzle) ||
      !encode(&wm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 3, w, wd, wb,
              CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((m + C::kBN - 1) / C::kBN, (n + C::kCols - 1) / C::kCols,
                  ksplit);
  int* part = ksplit > 1 ? static_cast<int*>(partial) : nullptr;
  a8_wgmma<P, MT><<<grid, kThreads, C::kSmem, st>>>(
      xm, wm, static_cast<const float*>(xs), static_cast<const float*>(scale),
      static_cast<const float*>(zs), static_cast<const float*>(xsum),
      static_cast<const int*>(block_expert),
      static_cast<const int*>(live_blocks), out, part, m, k, n, split_stages,
      out_bf16);
  if (part != nullptr) {
    const size_t total = (size_t)m * n;
    a8_reduce<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
        part, static_cast<const float*>(xs), static_cast<const float*>(scale),
        static_cast<const float*>(zs), static_cast<const float*>(xsum), out,
        m, n, ksplit, out_bf16);
  }
  return (int)cudaGetLastError();
}

template <int P>
int launch(const void* xq, const void* xs, const void* w, const void* scale,
           const void* zs, const void* xsum, void* out, void* partial,
           int m, int k, int n, int bm, int ksplit, int rows_per_split,
           int out_bf16, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int stage_rows = 128 / P;
  switch (bm) {
    case 16:
      return launch_small<P, 1>(xq, xs, w, scale, zs, xsum, out, partial, m,
                                k, n, ksplit, rows_per_split, out_bf16, st);
    case 64:
      return launch_small<P, 4>(xq, xs, w, scale, zs, xsum, out, partial, m,
                                k, n, ksplit, rows_per_split, out_bf16, st);
    case 128:
    case 256:
      if (rows_per_split % stage_rows) return (int)cudaErrorInvalidValue;
      return bm == 128
                 ? launch_wgmma<P, 2>(xq, xs, w, scale, zs, xsum, nullptr,
                                      nullptr, out, partial, m, k, n, 1,
                                      ksplit, rows_per_split / stage_rows,
                                      out_bf16, st)
                 : launch_wgmma<P, 1>(xq, xs, w, scale, zs, xsum, nullptr,
                                      nullptr, out, partial, m, k, n, 1,
                                      ksplit, rows_per_split / stage_rows,
                                      out_bf16, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename Kernel>
int attributes(Kernel kernel, int smem, int stages, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = smem < 0 ? (int)a.sharedSizeBytes : smem;
  out[3] = stages;
  return (int)err;
}

template <int P>
int attributes_of(int bm, int* out) {
  switch (bm) {
    case 16:
      return attributes(a8_gemm<P, 1>, -1, 2, out);
    case 64:
      return attributes(a8_gemm<P, 4>, -1, 2, out);
    case 128:
      return attributes(a8_wgmma<P, 2>, Cfg<P, 2>::kSmem, Cfg<P, 2>::S, out);
    case 256:
      return attributes(a8_wgmma<P, 1>, Cfg<P, 1>::kSmem, Cfg<P, 1>::S, out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// xq [m, k] int8, xs [m] f32, w [k/P, n] u8, scale [n] f32, zs [n] f32,
// xsum [m] f32, out [m, n] (bf16 if out_bf16 else f32), partial [ksplit, m,
// n] int32 scratch (unused when ksplit == 1); bm the tokens a block: 16 or
// 64 (mma.sync, 128 columns), 128 (wgmma, 256 columns) or 256 (wgmma, 128
// columns).  Needs n
// % 128 == 0, k % 256 == 0, 16-byte aligned operands, rows_per_split a
// multiple of 32 (bm 16, 64) or of 128 / P (bm 128, 256) and ksplit *
// rows_per_split >= k / P.
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
// 128, block_expert [m / 128] int32, live_blocks [1] int32 (or null: every
// block live), w [E, k/P, n] u8 (P = 2 or 4), scale / zs [E, n] f32, xs /
// xsum [m] f32; 128-token tiles of 256 columns, no K split.
extern "C" int pq_wq_ragged_a8(const void* xq, const void* xs, const void* w,
                               const void* scale, const void* zs,
                               const void* xsum, const void* block_expert,
                               const void* live_blocks, void* out, int m,
                               int k, int n, int n_experts, int planes,
                               int out_bf16, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (block_expert == nullptr || m % 128 || n % 128 || k % 256 ||
      n_experts <= 0)
    return (int)cudaErrorInvalidValue;
  switch (planes) {
    case 2:
      return launch_wgmma<2, 2>(xq, xs, w, scale, zs, xsum, block_expert,
                                live_blocks, out, nullptr, m, k, n,
                                n_experts, 1, k / 128, out_bf16, st);
    case 4:
      return launch_wgmma<4, 2>(xq, xs, w, scale, zs, xsum, block_expert,
                                live_blocks, out, nullptr, m, k, n,
                                n_experts, 1, k / 128, out_bf16, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Registers, local (spill) bytes, shared memory (dynamic for the wgmma
// tiles, static for the mma.sync ones) and ring stages of the instance
// (planes, bm as the entries take it) into out[4].
extern "C" int pq_a8_attributes(int planes, int bm, int* out) {
  switch (planes) {
    case 1:
      return attributes_of<1>(bm, out);
    case 2:
      return attributes_of<2>(bm, out);
    case 4:
      return attributes_of<4>(bm, out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
