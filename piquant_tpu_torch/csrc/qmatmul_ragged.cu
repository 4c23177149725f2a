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
// Row blocks at or past live_blocks[0] (the routing's p_end[-1] / 128, on
// the device) hold only padding: they write their zero tile and return.
//
// Bound on the H100: the bf16 operations at 989 TFLOP/s, which the TPU
// kernels fed to the MXU.  Strictly, 2 A k n for the A routed assignments;
// the kernel's own floor is the live rows' (each expert's rows rounded up to
// 128), 2 live k n.  A Mixtral layer (w1, w3, w2; 1024 tokens, top 2 of 8)
// does ~0.9 TFLOP on its live rows.  The first design (mma.sync.m16n8k16,
// a two-stage cp.async pipeline of 32 packed rows, dequantization in f32 by
// both row halves of a tile, every m/128 block computed, column tiles
// fastest) took 5.7793 ms a Mixtral INT4 layer (INT2 5.2794, INT8 7.7321;
// Qwen3-30B-A3B 1.3098) and 9.0343 ms at INT4-g128 (INT2-g32 10.0263),
// 12-19% of the bf16 peak.  This one:
//   * tensor cores through wgmma (sm_90a) with the operands swapped: a
//     block computes the transpose of its tile, out^T[n, m] = w_e^T x^T, so
//     the dequantized weight is wgmma's A operand, built in registers by
//     each thread straight from the packed bytes in shared memory (never
//     stored back, no proxy fence), and x, the only bf16 operand, is B,
//     read by the tensor cores from shared memory, K-major, 64-byte
//     swizzled.  A block covers 256 weight columns of one 128-row block:
//     two warpgroups own 128 columns each, two m64n128k16 a k16 step, 128
//     f32 sums a thread.  The block's 256 threads are all consumers, so a
//     thread may hold 255 registers: a ninth (producer) warp puts three
//     warps on one SM sub-partition and caps every thread at 168, which
//     ptxas does not lift for a setmaxnreg branch (the first attempt at
//     this width spilled and serialized its wgmmas);
//   * a ring of 4-8 stages (as many as 227 KB hold) of 32 packed rows, its
//     TMA loads (cp.async.bulk.tensor and mbarriers; the maps built by
//     cuTensorMapEncodeTiled, fetched with cudaGetDriverEntryPointByVersion,
//     passed as __grid_constant__) issued by thread 0: the first S stages
//     up front, then the slot of stage s - 1 as soon as all eight warps
//     have released it.  The weight tile is two 3-D [E, k/P, n] boxes of
//     32 x 128 bytes, 128-byte swizzled, x one 32 x 128 box per plane at
//     column p k/P + r0.  A stage is 8 KB + P 8 KB (+ P 4 KB of grouped
//     side streams): 4 x 56 KB at INT2 grouped;
//   * dequantization once, by the warpgroup that owns the columns, and out
//     of the tensor cores' way: each warpgroup builds the fragments of the
//     next k16 step while the wgmmas of the current one run (two fragment
//     buffers, wgmma.wait_group 1 before a buffer is rebuilt).  A thread
//     holds weight columns 2c, 2c + 1 of each M-tile (the M rows g, g + 8
//     of its fragment; the column order inside a tile is free, the
//     epilogue undoes it) and reads them as 16-bit words, conflict-free
//     under the swizzle; INT2 / INT4 codes become bf16 as the bits 0x43cc
//     (128 + c), then one __hsub2 (channelwise: of 128; grouped: of 128 +
//     zp, itself the bits 0x43zz) and, grouped, one __hmul2 by bf16(scale):
//     the difference of two integers below 2^8 is exact in bf16 and its
//     product with a bf16 exact in f32, so the one rounding of __hmul2
//     gives the TPU kernel's bits.  INT8 codes go through f32 ((2^23 + c) -
//     2^23, whose top half is bf16(c)).  The grouped scale and zero point
//     of each (plane, k16 step) arrive in the stage by TMA, once a stage
//     (once a plane where gs % 32 == 0); a group size that is not a
//     multiple of 16 (a k16 step would straddle groups) reads them per
//     element instead.  ptxas serializes wgmmas that are in flight across
//     a branch it cannot prove uniform in the warpgroup, so every branch
//     of the main loop is uniform: the barrier spin lives in one asm
//     block, TMA issues and arrivals are predicated, and a warpgroup
//     without columns computes on stale shared memory and stores nothing;
//   * no work on padding blocks (above); the grid is (m/128, n/256) with
//     the row blocks fastest, so the resident blocks are mostly one
//     expert's row blocks of a few column tiles and share its weight tile
//     through L2, as the TPU kernel's (j, i) grid streams it once.
// What holds it back (on an H100): the ring alone, with neither
// dequantization nor wgmmas, takes two thirds of the INT4 w1 time,
// streaming its stages from L2 at ~4.6 TB/s; x, re-read for every column
// tile, is two thirds of those bytes.  Sharing x between two column tiles
// (a cluster of two blocks, each multicasting half of every x box) halved
// that traffic but coupled the blocks at every stage and ran 1.5x slower.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pq_hopper.cuh"

namespace {

using namespace pq;

constexpr int kBM = 128;      // rows per block = the routing block (wgmma N)
constexpr int kCols = 256;    // weight columns per block
constexpr int kHalf = 128;    // a consumer warpgroup's columns (2 x wgmma M)
constexpr int kRowsK = 32;    // packed rows per stage: two k16 steps a plane
constexpr int kThreads = 256; // two warpgroups (8 warps: 255 registers a thread)
constexpr int kSmemMax = 232448;            // a block's shared memory

enum Mode { kChannel = 0, kGroupStep = 1, kGroupRow = 2 };

constexpr int kWBox = kRowsK * kHalf;       // one weight box, 128-byte swizzle
constexpr int kWBytes = 2 * kWBox;          // the tile's two boxes
constexpr int kXBytes = kBM * kRowsK * 2;   // one plane's x box, 64-byte swizzle
constexpr int kSideBox = kCols * 4;         // one group's scale (or zp) row

template <int P, int kMode>   // (plane, k16 step) x (scale row, zp row)
__host__ __device__ constexpr int side_bytes() {
  return kMode == kGroupStep ? P * 2 * 2 * kSideBox : 0;
}

template <int P, int kMode>
__host__ __device__ constexpr int stage_bytes() {
  return kWBytes + P * kXBytes + side_bytes<P, kMode>();
}

template <int P, int kMode>   // as many stages as fit, at most 8
__host__ __device__ constexpr int n_stages() {
  const int fit = (kSmemMax - 1024 - 16 * 8) / stage_bytes<P, kMode>();
  return fit < 8 ? fit : 8;
}

template <int P, int kMode>   // 1 KB to align the ring, the ring, barriers
__host__ __device__ constexpr int smem_bytes() {
  return 1024 + n_stages<P, kMode>() * stage_bytes<P, kMode>() +
         2 * n_stages<P, kMode>() * 8;
}

// ---------------------------------------------------------------------------
// codes to bf16
// ---------------------------------------------------------------------------

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

__device__ __forceinline__ __nv_bfloat162 as_bf16x2(uint32_t v) {
  return *reinterpret_cast<const __nv_bfloat162*>(&v);
}

// The codes of bytes b and b + 2 of c (b = 0 or 1) as a bf16 pair (low =
// byte b), biased: 128 + code for P = 2, 4 (codes below 2^7, the bits
// 0x43cc), the code itself for P = 1.
template <int P>
__device__ __forceinline__ uint32_t code_pair(uint32_t c, int b) {
  if constexpr (P == 1) {
    const float f0 =
        __uint_as_float(__byte_perm(c, 0x4b000000u, b ? 0x7441 : 0x7440)) -
        8388608.0f;
    const float f1 =
        __uint_as_float(__byte_perm(c, 0x4b000000u, b ? 0x7443 : 0x7442)) -
        8388608.0f;
    return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  } else {
    return __byte_perm(c, 0x43434343u, b ? 0x4341 : 0x4240);
  }
}

// The bias code_pair leaves on a code.
template <int P>
__host__ __device__ constexpr int code_bias() { return P == 1 ? 0 : 128; }

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// The TMA loads of stage s into its ring slot, issued where `on` (one
// thread).
template <int P, int kMode>
__device__ __forceinline__ void load_stage(
    uint8_t* smem, uint64_t* full, const CUtensorMap* x_map,
    const CUtensorMap* w_map, const CUtensorMap* s_map,
    const CUtensorMap* z_map, int s, int e, int m0, int n0, bool two,
    int rows, int gs, int gp, int sides, bool on) {
  constexpr int S = n_stages<P, kMode>();
  const int slot = s % S;
  uint8_t* st = smem + slot * stage_bytes<P, kMode>();
  const int r0 = s * kRowsK;
  mbar_arrive_tx(&full[slot],
                 (two ? 2 : 1) * kWBox + P * kXBytes +
                     sides * P * 2 * kSideBox,
                 on);
  tma_load_3d(st, w_map, &full[slot], n0, r0, e, on);
  tma_load_3d(st + kWBox, w_map, &full[slot], n0 + kHalf, r0, e, on && two);
#pragma unroll
  for (int p = 0; p < P; ++p)
    tma_load_2d(st + kWBytes + p * kXBytes, x_map, &full[slot],
                p * rows + r0, m0, on);
  if constexpr (kMode == kGroupStep) {
    uint8_t* sd = st + kWBytes + P * kXBytes;
    for (int p = 0; p < P; ++p) {
      for (int j = 0; j < sides; ++j) {
        const int grp = p * gp + (r0 + 16 * j) / gs;
        tma_load_3d(sd + (2 * p + j) * kSideBox, s_map, &full[slot], n0, grp,
                    e, on);
        tma_load_3d(sd + (2 * P + 2 * p + j) * kSideBox, z_map, &full[slot],
                    n0, grp, e, on);
      }
    }
  }
}

template <int P, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
ragged_gemm(const __grid_constant__ CUtensorMap x_map,   // [m, k] bf16
            const __grid_constant__ CUtensorMap w_map,   // [E, k/P, n] u8
            const __grid_constant__ CUtensorMap s_map,   // [E, G, n] f32
            const __grid_constant__ CUtensorMap z_map,   // [E, G, n] i32
            const float* __restrict__ scale,
            const void* __restrict__ side,      // zs [E, n] f32 or zp [E, G, n] i32
            const float* __restrict__ xsum,     // channelwise only
            const int* __restrict__ block_expert,
            const int* __restrict__ live_blocks,  // [1] or null: all live
            void* __restrict__ out, int k, int n, int gs, int out_bf16) {
  constexpr int S = n_stages<P, kMode>();
  constexpr int kStage = stage_bytes<P, kMode>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + S * kStage);
  uint64_t* const empty = full + S;

  const int rows = k / P;                   // packed rows of a weight
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kCols;
  const bool two = n0 + kHalf < n;          // the second half has columns
  const int steps = rows / kRowsK;
  const int gp = kMode == kChannel ? 0 : rows / gs;   // groups a plane
  const bool per_step = gs % 32 != 0;       // a group for each k16 step
  const int sides = kMode == kGroupStep ? (per_step ? 2 : 1) : 0;

  if (live_blocks && (int)blockIdx.x >= __ldg(live_blocks)) {
    // padding only: the zero tile
    const int esz = out_bf16 ? 2 : 4;
    const int chunks = (two ? kCols : kHalf) * esz / 16;   // a row's
    uint8_t* o = static_cast<uint8_t*>(out) + ((size_t)m0 * n + n0) * esz;
    for (int i = threadIdx.x; i < kBM * chunks; i += kThreads)
      *reinterpret_cast<uint4*>(o + (size_t)(i / chunks) * n * esz +
                                (i % chunks) * 16) = make_uint4(0, 0, 0, 0);
    return;
  }
  const int e = __ldg(block_expert + blockIdx.x);
  // thread 0 issues the loads: the first S stages now, then stage s - 1 +
  // S once every warp has released stage s - 1's slot
  const bool leader = threadIdx.x == 0;
  if (leader) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);               // the leader's arrival
      mbar_init(&empty[s], kThreads / 32);  // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < S && s < steps; ++s)
      load_stage<P, kMode>(smem, full, &x_map, &w_map, &s_map, &z_map, s, e,
                           m0, n0, two, rows, gs, gp, sides, true);
  }
  __syncthreads();

  // warpgroup wg owns tile columns [128 wg, 128 wg + 128)
  const int wg = threadIdx.x / 128;
  const bool cols_live = wg == 0 || two;    // uniform in the warpgroup
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // M-tile mt's fragment rows g and g + 8 are tile columns col(mt) and
  // col(mt) + 1, byte 2g of chunk 4 mt + warp of the warpgroup's box row;
  // offsets under the 128-byte swizzle for rows r with r % 8 = 2t and
  // 2t + 1 (the thread's rows 16j + 2t (+8) and 16j + 2t + 1 (+8))
  int off0[2], off1[2], col[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int chunk = 4 * mt + warp;
    off0[mt] = ((chunk ^ (2 * t)) << 4) + 2 * g;
    off1[mt] = ((chunk ^ (2 * t + 1)) << 4) + 2 * g;
    col[mt] = kHalf * wg + 64 * mt + 16 * warp + 2 * g;
  }

  float acc[2][64];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[mt][i] = 0.0f;

  // v[mt][j][h]: bytes (c, row), (c + 1, row), (c, row + 1), (c + 1, row +
  // 1) at c = col(mt), row = 16j + 2t + 8h of the stage in slot `st`
  uint32_t v[2][2][2];
  auto load_v = [&](const uint8_t* st) {
    const uint8_t* ws = st + kWBox * wg;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * j + 2 * t + 8 * h;
          const uint32_t lo = *reinterpret_cast<const uint16_t*>(
              ws + r * kHalf + off0[mt]);
          const uint32_t hi = *reinterpret_cast<const uint16_t*>(
              ws + (r + 1) * kHalf + off1[mt]);
          v[mt][j][h] = lo | (hi << 16);
        }
  };

  // The A fragments of k16 step j of stage s (slot st), every plane and
  // M-tile: f[p][mt] = a0 (c, rows 2t, 2t+1), a1 (c+1, ..), a2 (c, rows
  // 2t+8, 2t+9), a3 (c+1, ..).
  auto build = [&](uint32_t (&f)[P][2][4], const uint8_t* st, int s, int j) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const uint32_t clo = plane_codes<P>(v[mt][j][0], p);
        const uint32_t chi = plane_codes<P>(v[mt][j][1], p);
        const uint32_t q[4] = {code_pair<P>(clo, 0), code_pair<P>(clo, 1),
                               code_pair<P>(chi, 0), code_pair<P>(chi, 1)};
        if constexpr (kMode == kChannel) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            f[p][mt][i] = P == 1 ? q[i]
                                 : bf16x2_bits(__hsub2(
                                       as_bf16x2(q[i]),
                                       __float2bfloat162_rn(128.0f)));
        } else if constexpr (kMode == kGroupStep) {
          // (scale, bias + zp) of columns c, c + 1 as duplicated pairs
          const int js = per_step ? j : 0;
          const uint8_t* sd = st + kWBytes + P * kXBytes + col[mt] * 4;
          const float2 sc =
              *reinterpret_cast<const float2*>(sd + (2 * p + js) * kSideBox);
          const int2 zc = *reinterpret_cast<const int2*>(
              sd + (2 * P + 2 * p + js) * kSideBox);
          const uint32_t sp[2] = {
              bf16x2_bits(__floats2bfloat162_rn(sc.x, sc.x)),
              bf16x2_bits(__floats2bfloat162_rn(sc.y, sc.y))};
          uint32_t zq[2];
          if constexpr (P == 1) {
            zq[0] = bf16x2_bits(__float2bfloat162_rn((float)zc.x));
            zq[1] = bf16x2_bits(__float2bfloat162_rn((float)zc.y));
          } else {   // 128 + zp as the bits 0x43zz (zp < 2^7), twice
            zq[0] = __byte_perm(zc.x, 0x43434343u, 0x4040);
            zq[1] = __byte_perm(zc.y, 0x43434343u, 0x4040);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
            f[p][mt][i] = bf16x2_bits(
                __hmul2(__hsub2(as_bf16x2(q[i]), as_bf16x2(zq[i & 1])),
                        as_bf16x2(sp[i & 1])));
        } else {
          // a group size off the k16 steps: each element's own group
          const float* sc = scale + (size_t)e * (P * gp) * n + n0;
          const int* zp = static_cast<const int*>(side) +
                          (size_t)e * (P * gp) * n + n0;
          const int rb = s * kRowsK + 16 * j + 2 * t;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int c = col[mt] + (i & 1);
            const int r = rb + 8 * (i >> 1);
            const size_t g0 = (size_t)(p * gp + r / gs) * n + c;
            const size_t g1 = (size_t)(p * gp + (r + 1) / gs) * n + c;
            const __nv_bfloat162 cv = as_bf16x2(q[i]);
            const float b = (float)code_bias<P>();
            const float d0 = __low2float(cv) - b - (float)__ldg(zp + g0);
            const float d1 = __high2float(cv) - b - (float)__ldg(zp + g1);
            f[p][mt][i] = bf16x2_bits(__floats2bfloat162_rn(
                __fmul_rn(d0, bf16_round(__ldg(sc + g0))),
                __fmul_rn(d1, bf16_round(__ldg(sc + g1)))));
          }
        }
      }
    }
  };

  // wgmmas of k16 step j against the x boxes of slot st, one group
  auto issue = [&](const uint32_t (&f)[P][2][4], const uint8_t* st, int j) {
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const uint64_t d =
          desc_sw64(smem_u32(st + kWBytes + p * kXBytes) + 32 * j);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) wgmma_rs(acc[mt], f[p][mt], d);
    }
    wgmma_commit();
  };

  // Two fragment buffers: k16 step 0 of a stage in f0, step 1 in f1.  Each
  // step's fragments are built while the step before it is in the tensor
  // cores, and a buffer is rebuilt only after the wgmmas that read it are
  // waited on.
  uint32_t f0[P][2][4], f1[P][2][4];
  // every branch below is uniform in the block: a warpgroup without
  // columns (the second of an odd multiple of 128) computes on stale shared
  // memory and stores nothing
  const uint8_t* st = smem;
  mbar_wait(&full[0], 0);
  load_v(st);
  build(f0, st, 0, 0);
  issue(f0, st, 0);
  for (int s = 0; s < steps; ++s) {
    // in flight: k16 step (s, 0)
    build(f1, st, s, 1);
    issue(f1, st, 1);
    wgmma_wait<1>();                        // (s, 0) done: f0 is free
    if (s + 1 < steps) {
      const int next = (s + 1) % S;
      mbar_wait(&full[next], ((s + 1) / S) & 1);
      st = smem + next * kStage;
      load_v(st);
      build(f0, st, s + 1, 0);
      issue(f0, st, 0);
      wgmma_wait<1>();                      // (s, 1) done: slot s is read
    } else {
      wgmma_wait<0>();
    }
    __syncwarp();
    mbar_arrive(&empty[s % S], lane == 0);  // one arrival a warp
    if (s >= 1 && s - 1 + S < steps) {
      // refill the slot of stage s - 1 once every warp has released it
      mbar_wait(&empty[(s - 1) % S], ((s - 1) / S) & 1);
      load_stage<P, kMode>(smem, full, &x_map, &w_map, &s_map, &z_map,
                           s - 1 + S, e, m0, n0, two, rows, gs, gp, sides,
                           leader);
    }
  }
  wgmma_wait<0>();                          // (provably) nothing in flight
  if (!cols_live) return;

  // acc[mt][4i + q]: column col(mt) + (q >> 1), routing row 8i + 2t + (q & 1)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    float sc[2] = {1.0f, 1.0f}, zs[2] = {0.0f, 0.0f};
    if constexpr (kMode == kChannel) {
      const size_t o = (size_t)e * n + n0 + col[mt];
      sc[0] = __ldg(scale + o);
      sc[1] = __ldg(scale + o + 1);
      zs[0] = __ldg(static_cast<const float*>(side) + o);
      zs[1] = __ldg(static_cast<const float*>(side) + o + 1);
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + 8 * i + 2 * t + h;
        float y0 = acc[mt][4 * i + h], y1 = acc[mt][4 * i + 2 + h];
        if constexpr (kMode == kChannel) {
          const float xr = __ldg(xsum + row);
          y0 = __fsub_rn(__fmul_rn(y0, sc[0]), __fmul_rn(xr, zs[0]));
          y1 = __fsub_rn(__fmul_rn(y1, sc[1]), __fmul_rn(xr, zs[1]));
        }
        const size_t o = (size_t)row * n + n0 + col[mt];
        if (out_bf16) {
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(out) + o) =
              __floats2bfloat162_rn(y0, y1);
        } else {
          *reinterpret_cast<float2*>(static_cast<float*>(out) + o) =
              make_float2(y0, y1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <int P, int kMode>
int launch(const void* x, const void* w, const void* scale, const void* side,
           const void* xsum, const void* block_expert,
           const void* live_blocks, void* out, int m, int k, int n,
           int n_experts, int gs, int out_bf16, void* stream) {
  constexpr int kSmem = smem_bytes<P, kMode>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      ragged_gemm<P, kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const int rows = k / P;
  CUtensorMap xm, wm, sm, zm;
  const uint64_t xd[2] = {(uint64_t)k, (uint64_t)m};
  const uint32_t xb[2] = {kRowsK, kBM};
  const uint64_t wd[3] = {(uint64_t)n, (uint64_t)rows, (uint64_t)n_experts};
  const uint32_t wb[3] = {kHalf, kRowsK, 1};
  bool ok = encode(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 2, x, xd, xb,
                   CU_TENSOR_MAP_SWIZZLE_64B) &&
            encode(&wm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 3, w, wd, wb,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  sm = wm;
  zm = wm;
  if (kMode == kGroupStep) {
    const uint64_t sd[3] = {(uint64_t)n, (uint64_t)(k / gs),
                            (uint64_t)n_experts};
    const uint32_t sb[3] = {kCols, 1, 1};
    ok = ok &&
         encode(&sm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, 3, scale, sd, sb,
                CU_TENSOR_MAP_SWIZZLE_NONE) &&
         encode(&zm, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, 3, side, sd, sb,
                CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  const dim3 grid(m / kBM, (n + kCols - 1) / kCols);
  ragged_gemm<P, kMode><<<grid, kThreads, kSmem,
                          reinterpret_cast<cudaStream_t>(stream)>>>(
      xm, wm, sm, zm, static_cast<const float*>(scale), side,
      static_cast<const float*>(xsum), static_cast<const int*>(block_expert),
      static_cast<const int*>(live_blocks), out, k, n, gs, out_bf16);
  return (int)cudaGetLastError();
}

template <int P, int kMode>
int attributes(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, ragged_gemm<P, kMode>);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = smem_bytes<P, kMode>();
  out[3] = n_stages<P, kMode>();
  return (int)err;
}

bool shape_ok(int m, int k, int n, int planes, int n_experts) {
  return m > 0 && m % kBM == 0 && n % kHalf == 0 && planes > 0 &&
         n_experts > 0 && k % planes == 0 && (k / planes) % kRowsK == 0 &&
         n / kCols < 65535;
}

}  // namespace

// x [m, k] bf16, w [E, k/P, n] u8, scale / zs [E, n] f32, xsum [m] f32,
// block_expert [m / 128] int32, live_blocks [1] int32 (or null: every block
// live), out [m, n] (bf16 if out_bf16 else f32).  Needs m % 128 == 0, n %
// 128 == 0, (k / P) % 32 == 0, 16-byte aligned operands.
extern "C" int pq_wq_ragged(const void* x, const void* w, const void* scale,
                            const void* zs, const void* xsum,
                            const void* block_expert, const void* live_blocks,
                            void* out, int m, int k, int n, int n_experts,
                            int planes, int out_bf16, void* stream) {
  if (!shape_ok(m, k, n, planes, n_experts)) return (int)cudaErrorInvalidValue;
#define PQ_CHANNEL(P)                                                        \
  return launch<P, kChannel>(x, w, scale, zs, xsum, block_expert,            \
                             live_blocks, out, m, k, n, n_experts, 0,        \
                             out_bf16, stream)
  switch (planes) {
    case 1:
      PQ_CHANNEL(1);
    case 2:
      PQ_CHANNEL(2);
    case 4:
      PQ_CHANNEL(4);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PQ_CHANNEL
}

// As pq_wq_ragged with scale [E, k/gs, n] f32 and zp [E, k/gs, n] int32;
// gs divides k / P.
extern "C" int pq_wq_ragged_grouped(const void* x, const void* w,
                                    const void* scale, const void* zp,
                                    const void* block_expert,
                                    const void* live_blocks, void* out, int m,
                                    int k, int n, int n_experts, int planes,
                                    int gs, int out_bf16, void* stream) {
  if (!shape_ok(m, k, n, planes, n_experts) || gs <= 0 ||
      (k / planes) % gs)
    return (int)cudaErrorInvalidValue;
  const bool step = gs % 16 == 0;
#define PQ_GROUPED(P)                                                        \
  return step ? launch<P, kGroupStep>(x, w, scale, zp, nullptr, block_expert, \
                                      live_blocks, out, m, k, n, n_experts,  \
                                      gs, out_bf16, stream)                  \
              : launch<P, kGroupRow>(x, w, scale, zp, nullptr, block_expert,  \
                                     live_blocks, out, m, k, n, n_experts,   \
                                     gs, out_bf16, stream)
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

// Registers, local bytes, dynamic shared memory and stages of the instance
// (planes, mode: 0 channelwise, 1 grouped by k16 step, 2 grouped by row)
// into out[4].
extern "C" int pq_ragged_attributes(int planes, int mode, int* out) {
#define PQ_ATTR(P)                                           \
  return mode == kChannel     ? attributes<P, kChannel>(out)   \
         : mode == kGroupStep ? attributes<P, kGroupStep>(out) \
                              : attributes<P, kGroupRow>(out)
  switch (planes) {
    case 1:
      PQ_ATTR(1);
    case 2:
      PQ_ATTR(2);
    case 4:
      PQ_ATTR(4);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PQ_ATTR
}
