// Weight-only quantized matmul for decode-sized M (M <= 64): one kernel
// template, six entry points, each replacing TPU kernels of
// piquant_tpu/ops/pallas/qmatmul.py:
//
//   pq_w4_gemv   _w4_kernel + _w4_kernel_ksplit   INT4 split-half, channelwise
//   pq_w8_gemv   _w8_kernel                       INT8, channelwise (lm_head)
//   pq_w2_gemv   _w2_kernel                       INT2 split-quarter, channelwise
//   pq_wg_gemv   _wg_chunk_kernel (bf16 / int8 x) grouped INT2 / INT4
//   pq_w4g_gemv  _w4_grouped_kernel               grouped INT4, W4A16 numerics
//   pq_nf4_gemv  _nf4_kernel                      NF4 codebook, channelwise or grouped
//
// (On Hopper a K split is a loop inside the block plus a split over the
// blocks of a cluster, so _w4_kernel_ksplit needs no kernel of its own.)
//
// The weight w [K/P, N] (uint8, N contiguous) packs P = 1, 2 or 4 codes a
// byte: byte row r holds code row r + p*K/P in bits [p*8/P, (p+1)*8/P).
//
// What each form computes (the plain versions in ops/cuda/qmatmul.py):
//   channelwise: out[m, n] = (sum_k x[m, k] c[k, n]) * scale[n]
//                            - xsum[m] * (zp[n] * scale[n]),
//     the zero point folded as the rank-1 term, as the TPU kernels do; xsum
//     (the row sums of x) is the caller's, or summed here from the x the
//     block stages.  INT8 multiplies c - 128 (the ^ 0x80 fold of
//     qmatmul_a8.cu) and folds (zp - 128) * scale instead.
//   chunk (row 18): per group, the raw-code product scaled after the
//     product by the group's bf16 scale s, minus xg * (z * s), xg the
//     group's sum of x; the int8-x form takes exact int32 products and
//     group sums and scales the f32 result by the row's scale xs[m].  The
//     side streams are read in the chunk-major order the TPU kernel
//     streams them in (group (p, j) at (j / ch) * P * ch + p * ch + j % ch).
//   w4a16 (row 17): w = bf16((c - bf16 z) * bf16 s), then bf16 products;
//     scale f32 and zp int32 in natural group order.
//   NF4: a code indexes the 16-entry table rounded to bf16; channelwise the
//     sum is scaled by scale[n] at the end, grouped w = bf16(lut[c] * bf16 s).
//
// Bound on the H100: the weight stream, K*N/P bytes, plus the side streams
// of grouped weights; at M = 8 every form is ~30x under the line where the
// tensor cores would be the limit, so what counts is how few instructions
// turn a packed byte into operands, and keeping enough bytes in flight.
// Design:
//   * the products on the tensor cores with the operands swapped: the
//     weight columns are the 16-row A operand of mma.sync.m16n8k16 (bf16 in,
//     f32 sums) built in registers, the tokens the n8 B operand (one n8 tile
//     per 8 rows of M, all M <= 64 rows in one block, so a call reads the
//     weight once at any M).  The int8-x chunk form uses m16n8k32.s8 on the
//     raw codes (exact int32 sums per 32-row unit).
//   * a register pairs rows r and r + 1 of one plane (the k order inside a
//     step is free), so x is read straight from its staged row, and one
//     __byte_perm of two row words lines up two columns' byte pairs.  A code
//     becomes its operand without a conversion: a lop3 puts it into the
//     mantissa of 128.0 (0x4300) and one bf16x2 subtract, or an FMA by a
//     power of two for INT2's planes 1-3 (their bits sit 2 or 4 places up),
//     gives the exact value; INT8 takes the s8 pair trick of decode_attn2.cu
//     on c ^ 0x80.  NF4 builds the table indices of four columns with two
//     lop3s a plane and looks both rows up at once in a 256-entry bf16x2
//     table in shared memory, one copy a lane (conflict-free).  The int8-x
//     form transposes 4 row words into column words.
//   * the order of the columns inside an m16 tile is free: tile j of a lane
//     takes its columns 2j and 2j + 1, so each lane holds 16 (8, 4)
//     contiguous columns of its tokens, read from a 128-byte row by 8 lanes
//     and stored contiguously in the epilogue.
//   * group sums of x (chunk) and row sums (channelwise without the
//     caller's xsum) come from one more mma whose A is all ones.
//   * a TMA ring of 2-6 stages: one thread issues, per stage, the weight box
//     (128 columns x R packed rows, 128-byte swizzle), each plane's x boxes
//     (tokens past m arrive as zeros) and the side rows of the groups the
//     stage touches, onto the slot's full mbarrier; each warp releases the
//     slot on its empty mbarrier, and the thread refills a slot after its
//     own next stage, so no block-wide barrier runs per stage.  (Issuing x
//     as bulk copies a token held every stage at the issuing warp's pace,
//     1.4 us a stage at M = 8; cp.async capped a block near 17 GB/s.)
//   * 8 warps: 128 / CW across the columns, 8 / (128 / CW) along K, one or
//     two 16-row blocks (or a 32-row unit of one plane) a warp a stage: CW =
//     128 for the light forms at M <= 16 (R = 256 rows a stage at M <= 8,
//     128 at M <= 16), 64 for the per-group forms there (two blocks an SM
//     at M <= 8) and for all at M <= 32 (R = 64), 32 above (R = 32).
//   * K split over the blocks of a thread-block cluster (<= 8), chosen on
//     the host (ops/cuda/qmatmul.py::gemv_split) as the largest split whose
//     grid the card holds at once (cudaOccupancyMaxActiveClusters: at one
//     block an SM, 66 clusters of 2 but only 30 of 4 and 15 of 8): each block
//     adds its warps' sums in order in shared memory, then each block of
//     the cluster reads its share of the tile from every block's shared
//     memory (distributed shared memory) in split order and writes the
//     output: deterministic, no global partials and no second launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pq_gemv.cuh"
#include "pq_hopper.cuh"
#include "pq_tile.cuh"

namespace {

using namespace pq::gemv;   // the tile geometry and loop helpers
using pq::mbar_arrive;
using pq::mbar_arrive_tx;
using pq::mbar_init;
using pq::mbar_wait;
using pq::tma_load_2d;
using pq::transpose4;

constexpr int kThreads = 256;       // 8 warps
constexpr int kMaxStages = 6;
constexpr int kLutBytes = 256 * 32 * 4;   // NF4: 256 entries x 32 lanes

// NF4_CODEBOOK of piquant_tpu/quant/linear.py, as f32
__constant__ float kNF4Table[16] = {
    -1.0f, -0.6961928009986877f, -0.5250730514526367f, -0.39491748809814453f,
    -0.28444138169288635f, -0.18477343022823334f, -0.09105003625154495f, 0.0f,
    0.07958029955625534f, 0.16093020141124725f, 0.24611230194568634f,
    0.33791524171829224f, 0.44070982933044434f, 0.5626170039176941f,
    0.7229568362236023f, 1.0f};

// Blocks an SM an instance is built for: two for the per-group forms at
// M <= 8 (<= 128 registers, ~110 KB), one for the rest.
constexpr int min_blocks(int mt, bool light) {
  return mt == 1 && !light ? 2 : 1;
}

// Shared memory of one instance at group size gs (host and device agree):
// 1 KB of barriers, then the ring (slots 1 KB aligned for the 128-byte
// swizzle), the block's sums over the ring after the loop, the NF4 table.
struct Layout {
  int w, x, side_row, ng, side, slot, stages, lut, total;
};

template <int P, int MODE, bool XI8, int MT>
__host__ __device__ inline Layout layout(int gs) {
  using T = Tile<MODE, MT>;
  Layout L;
  L.w = T::R * kCols;
  L.x = P * T::XT * T::R * (XI8 ? 1 : 2);   // swizzled boxes, see xaddr
  L.side_row = MODE == kChunk ? 3 * kCols
               : MODE == kW4A16 ? 8 * kCols
               : MODE == kNF4G  ? 4 * kCols : 0;
  // groups of one plane a stage of R rows can touch
  L.ng = L.side_row == 0 ? 0
         : gs % T::R == 0 ? 1
         : T::R % gs == 0 ? T::R / gs : T::R / gs + 2;
  L.side = P * L.ng * L.side_row;
  L.slot = (L.w + L.x + L.side + 1023) / 1024 * 1024;
  const bool lut = MODE == kNF4 || MODE == kNF4G;
  const int budget = (min_blocks(MT, T::kLight) == 2 ? 111 : 221) * 1024 -
                     2048 - (lut ? kLutBytes : 0);
  const int s = budget / L.slot;
  L.stages = s < 2 ? 2 : s > kMaxStages ? kMaxStages : s;
  const int ring = L.stages * L.slot;
  // the warps' sums [KW][XT][128] and row sums [KW][XT], then the block's
  const int red = (T::KW + 1) * T::XT * (kCols + 1) * 4;
  L.lut = ring > red ? ring : red;
  L.total = 2048 + L.lut + (lut ? kLutBytes : 0);  // + 1 KB to align
  return L;
}

// ---------------------------------------------------------------------------
// device helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t bf16_pair(float v) {   // (v, v) in bf16
  const __nv_bfloat162 h = __floats2bfloat162_rn(v, v);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_ones_s8(int (&s)[2], const uint32_t (&b)[2]) {
  int d2, d3;
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%6,%6,%6,%6}, {%4,%5}, {%0,%1,%0,%1};\n"
      : "+r"(s[0]), "+r"(s[1]), "=r"(d2), "=r"(d3)
      : "r"(b[0]), "r"(b[1]), "r"(0x01010101u));
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The same barrier without ordering this thread's memory operations: for
// the last one, which only keeps shared memory alive until every block of
// the cluster has read it (their reads feed stores issued before arrival).
__device__ __forceinline__ void cluster_sync_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n"
               "barrier.cluster.wait.aligned;\n" ::: "memory");
}

// 16 bytes at `addr` (a shared-space address) of cluster block `rank`
__device__ __forceinline__ float4 ld_cluster(uint32_t addr, int rank) {
  uint32_t ra;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(ra) : "r"(addr), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0,%1,%2,%3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(ra)
               : "memory");
  return v;
}

__device__ __forceinline__ float ld_cluster1(uint32_t addr, int rank) {
  uint32_t ra;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(ra) : "r"(addr), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(ra)
               : "memory");
  return v;
}

// NF4: the table index words of rows r (word a) and r + 1 (word b): byte c
// of index<Q> is (plane Q code of row r + 1) << 4 | (that of row r) for
// column c, two instructions for four columns.
__device__ __forceinline__ uint32_t nf4_index(uint32_t a, uint32_t b, int q) {
  uint32_t r;
  if (q == 0) {             // (a & 0x0f..) | ((b << 4) & 0xf0..)
    asm("lop3.b32 %0, %1, %2, %3, 0xac;\n"
        : "=r"(r) : "r"(0x0F0F0F0Fu), "r"(b << 4), "r"(a));
  } else {                  // ((a >> 4) & 0x0f..) | (b & 0xf0..)
    asm("lop3.b32 %0, %1, %2, %3, 0xac;\n"
        : "=r"(r) : "r"(0x0F0F0F0Fu), "r"(b), "r"(a >> 4));
  }
  return r;
}

// The bf16x2 pair of byte C of an index word through the shared table, this
// lane's copy at `lut` (entry i = (lut[i & 15], lut[i >> 4]) at byte 128 i).
__device__ __forceinline__ uint32_t nf4_pair(uint32_t u, int c,
                                             const uint8_t* lut) {
  const uint32_t off = (c < 1 ? u << (7 - 8 * c) : u >> (8 * c - 7)) & 0x7F80u;
  return *reinterpret_cast<const uint32_t*>(lut + off);
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------


template <int P, int MODE, bool XI8, int MT>
__global__ void __launch_bounds__(kThreads, min_blocks(MT, Tile<MODE, MT>::kLight))
gemv_tc(const __grid_constant__ CUtensorMap w_map,   // [k/P, n] u8
        const __grid_constant__ CUtensorMap x_map,   // [m, k] bf16 or int8
        const __grid_constant__ CUtensorMap s_map,   // grouped: scales
        const __grid_constant__ CUtensorMap z_map,   // chunk / w4a16: zps
        const float* __restrict__ scale,    // channelwise / NF4: [n]
        const int* __restrict__ zp,         // channelwise: [n]
        const float* __restrict__ xsum,     // channelwise: [m], or null
        const float* __restrict__ xs,       // int8 x: row scales [m]
        int gs, int ch, void* __restrict__ out, int m, int k, int n,
        int rows_per_split, int out_bf16) {
  using T = Tile<MODE, MT>;
  constexpr int R = T::R, KW = T::KW, NT = T::NT, CB = T::CB, XT = T::XT;
  constexpr int NQ = P == 4 ? 4 : P;        // sub-planes (planes) a byte
  constexpr bool kLut = MODE == kNF4 || MODE == kNF4G;
  constexpr bool kPre = MODE == kW4A16 || MODE == kNF4G;   // scaled before
  constexpr int kXB = XI8 ? 1 : 2;
  constexpr int XIN = R * kXB < 128 ? R * kXB : 128;   // x box row bytes
  constexpr int NB = R * kXB / XIN;                      // x boxes a plane
  const Layout L = layout<P, MODE, XI8, MT>(gs);
  // 1 KB aligned for the 128-byte swizzle; indexing the shared array (not a
  // pointer cast through an integer) keeps the reads shared-memory loads
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const smem =
      smem_raw + ((1024 - (pq::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* const empty = full + kMaxStages;
  uint8_t* const ring = smem + 1024;        // slots, then red, then the table

  const int rows = k / P;                   // packed rows (rows of a plane)
  const int n0 = blockIdx.x * kCols;
  const int ks = gridDim.y, split = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(r_begin + rows_per_split, rows);
  const int nst = (r_end - r_begin + R - 1) / R;
  const int S = L.stages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wc = warp % T::WN, kw = warp / T::WN;
  const int cl = wc * T::CW + g * CB;       // the lane's first column
  const int gp = L.ng ? rows / gs : 1;      // groups of a plane
  const int mx = min(m, XT);                // live tokens
  const bool own_xsum = MODE == kChannel && xsum == nullptr;

  if constexpr (kLut) {
    uint32_t* lut = reinterpret_cast<uint32_t*>(ring + L.lut);
    for (int i = threadIdx.x; i < 256 * 32; i += kThreads) {
      const int e = i >> 5;
      const __nv_bfloat162 h = __floats2bfloat162_rn(kNF4Table[e & 15],
                                                     kNF4Table[e >> 4]);
      lut[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
  }
  // Stage st into its slot, issued by one thread: the weight box, each
  // plane's x boxes (tokens past m arrive as zeros) and the side rows of the
  // groups the stage touches, all by TMA onto the slot's full barrier.
  auto issue = [&](int st) {
    const int slot = st % S;
    uint8_t* base = ring + slot * L.slot;
    const int r0 = r_begin + st * R;
    const int j0 = L.ng ? r0 / gs : 0;
    const int nside = L.ng ? max(0, min(L.ng, gp - j0)) : 0;
    constexpr int kSideBytes = MODE == kChunk ? 3 * kCols
                               : MODE == kW4A16 ? 8 * kCols : 4 * kCols;
    mbar_arrive_tx(&full[slot], L.w + L.x + P * nside * kSideBytes, true);
    tma_load_2d(base, &w_map, &full[slot], n0, r0, true);
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int b = 0; b < NB; ++b)
        tma_load_2d(base + L.w + (p * NB + b) * XT * XIN, &x_map, &full[slot],
                    p * rows + r0 + b * (XIN / kXB), 0, true);
    if constexpr (MODE == kChunk || MODE == kW4A16 || MODE == kNF4G) {
      for (int i = 0; i < P * nside; ++i) {
        const int p = i / nside, jj = i % nside, j = j0 + jj;
        uint8_t* dst = base + L.w + L.x + (p * L.ng + jj) * L.side_row;
        const int e = MODE == kChunk ? (j / ch) * (P * ch) + p * ch + j % ch
                                     : p * gp + j;
        tma_load_2d(dst, &s_map, &full[slot], n0, e, true);
        if constexpr (MODE != kNF4G)
          tma_load_2d(dst + (MODE == kChunk ? 2 : 4) * kCols, &z_map,
                      &full[slot], n0, e, true);
      }
    }
  };

  if (threadIdx.x == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&w_map) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&x_map) : "memory");
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);                  // the issuing lane's arrival
      mbar_init(&empty[i], kThreads / 32);     // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int st = 0; st < S && st < nst; ++st) issue(st);

  float acc[NT][MT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][i][e] = 0.f;
  float xacc[MT][2];                        // channelwise: row sums of x
#pragma unroll
  for (int i = 0; i < MT; ++i) xacc[i][0] = xacc[i][1] = 0.f;
  // pre-scaled forms: the bf16x2 constants of the lane's columns for the
  // group `cur[q]` of each plane
  uint32_t zc[kPre ? NQ : 1][CB], sc[kPre ? NQ : 1][CB];
  int cur[kPre ? NQ : 1];
#pragma unroll
  for (int q = 0; q < (kPre ? NQ : 1); ++q) cur[q] = -1;
  const uint8_t* lut_lane = ring + L.lut + lane * 4;

  for (int st = 0; st < nst; ++st) {
    mbar_wait(&full[st % S], (st / S) & 1);
    const uint8_t* ws = ring + (st % S) * L.slot;
    const uint8_t* xsm = ws + L.w;
    const uint8_t* side = xsm + L.x;
    const int r0 = r_begin + st * R;        // the stage's first plane row
    const int live_rows = min(R, r_end - r0);
    if constexpr (MODE != kChunk) {
      // one block of 16 rows a warp: k16 step rows 2t, 2t + 1 (half 0) and
      // 8 + 2t, 9 + 2t (half 1) of each plane
#pragma unroll
      for (int rb = 16 * kw; rb < live_rows; rb += 16 * KW) {
        uint32_t pr[2][CB / 4][2];          // [half][word][cols 0,2 | 1,3]
        {
          uint32_t wv[4][CB / 4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            load_row<CB>(wv[i], wrow(ws, rb + 2 * t + (i & 1) + 8 * (i >> 1), cl));
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int d = 0; d < CB / 4; ++d)
#pragma unroll
              for (int e = 0; e < 2; ++e)   // NF4: plane e's index word
                pr[h][d][e] = kLut ? nf4_index(wv[2 * h][d], wv[2 * h + 1][d], e)
                              : __byte_perm(wv[2 * h][d], wv[2 * h + 1][d],
                                            e ? 0x7531 : 0x6420);
        }
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          uint32_t b[MT][2];
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            const int e = (rb + 2 * t) * 2;
            b[i][0] = *reinterpret_cast<const uint32_t*>(
                xaddr<XIN, NB, XT>(xsm, q, 8 * i + g, e));
            b[i][1] = *reinterpret_cast<const uint32_t*>(
                xaddr<XIN, NB, XT>(xsm, q, 8 * i + g, e + 16));
            if (MODE == kChannel && own_xsum) mma_ones_bf16(xacc[i], b[i]);
          }
          uint32_t a[NT][4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if constexpr (kPre) {
              const int j = (r0 + rb + 8 * h) / gs;
              if (j != cur[q]) {              // warp-uniform
                cur[q] = j;
                const uint8_t* sr =
                    side + (q * L.ng + j - r0 / gs) * L.side_row + cl * 4;
#pragma unroll
                for (int c = 0; c < CB; c += 4) {
                  const float4 sv = *reinterpret_cast<const float4*>(sr + c * 4);
                  sc[q][c] = bf16_pair(sv.x);
                  sc[q][c + 1] = bf16_pair(sv.y);
                  sc[q][c + 2] = bf16_pair(sv.z);
                  sc[q][c + 3] = bf16_pair(sv.w);
                  if constexpr (MODE == kW4A16) {
                    const int4 zv =
                        *reinterpret_cast<const int4*>(sr + 512 + c * 4);
                    zc[q][c] = bf16_pair(128.f + __bfloat162float(
                                                     __int2bfloat16_rn(zv.x)));
                    zc[q][c + 1] = bf16_pair(128.f + __bfloat162float(
                                                         __int2bfloat16_rn(zv.y)));
                    zc[q][c + 2] = bf16_pair(128.f + __bfloat162float(
                                                         __int2bfloat16_rn(zv.z)));
                    zc[q][c + 3] = bf16_pair(128.f + __bfloat162float(
                                                         __int2bfloat16_rn(zv.w)));
                  }
                }
              }
            }
#pragma unroll
            for (int d = 0; d < CB / 4; ++d)
#pragma unroll
              for (int s2 = 0; s2 < 2; ++s2) {
                const int j = 2 * d + s2;     // tile j: lane columns 2j, 2j + 1
                if (j >= NT) continue;
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const uint32_t v = pr[h][d][e] >> (8 * s2);
                  const int c = 2 * j + e;
                  uint32_t o;
                  if constexpr (kLut) {   // byte 2 s2 + e of plane q's word
                    o = nf4_pair(pr[h][d][q], 2 * s2 + e, lut_lane);
                    if constexpr (MODE == kNF4G) o = bf2_mul(o, sc[q][c]);
                  } else if constexpr (MODE == kW4A16) {
                    o = bf2_mul(bf2_sub(lop_or(q ? v >> 4 : v, 0x000F000Fu,
                                               0x43004300u),
                                        zc[q][c]),
                                sc[q][c]);
                  } else if constexpr (P == 4) {
                    o = q == 0 ? code_pair<4, 0>(v)
                        : q == 1 ? code_pair<4, 1>(v)
                        : q == 2 ? code_pair<4, 2>(v) : code_pair<4, 3>(v);
                  } else {
                    o = q ? code_pair<P, 1>(v) : code_pair<P, 0>(v);
                  }
                  a[j][2 * h + e] = o;
                }
              }
          }
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int i = 0; i < MT; ++i) mma_bf16(acc[j][i], a[j], b[i]);
        }
      }
    } else {
      // chunk: 32-row units of one plane (one group's share), each folded
      // after its product; a warp takes unit kw % UPS and the planes p with
      // p % 2 == kw / UPS
      constexpr int UPS = R / 32;
      const int u = kw % UPS, par = kw / UPS;
      if (32 * u < live_rows) {
        uint32_t cw[2][CB / 4][4];   // XI8: column words; else pair words
        {
          uint32_t wv[8][CB / 4];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            // int8 x: threads t >= 2 read their 4 rows rotated by 2 (banks)
            const int row = XI8 ? 32 * u + 4 * t + ((i & 3) ^ (t & 2)) +
                                      16 * (i >> 2)
                                : 32 * u + 16 * (i >> 2) + 2 * t + (i & 1) +
                                      8 * ((i >> 1) & 1);
            load_row<CB>(wv[i], wrow(ws, row, cl));
          }
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int d = 0; d < CB / 4; ++d) {
              if constexpr (XI8) {          // rows 4t.. (h 0), 16 + 4t.. (h 1)
                const bool rot = t & 2;       // undo the rotation
                uint32_t r4[4] = {rot ? wv[4 * h + 2][d] : wv[4 * h][d],
                                  rot ? wv[4 * h + 3][d] : wv[4 * h + 1][d],
                                  rot ? wv[4 * h][d] : wv[4 * h + 2][d],
                                  rot ? wv[4 * h + 1][d] : wv[4 * h + 3][d]};
                transpose4(r4);
#pragma unroll
                for (int e = 0; e < 4; ++e) cw[h][d][e] = r4[e];
              } else {                      // k16 step h: halves 0 and 1
#pragma unroll
                for (int hf = 0; hf < 2; ++hf) {
                  cw[h][d][2 * hf] = __byte_perm(wv[4 * h + 2 * hf][d],
                                                 wv[4 * h + 2 * hf + 1][d], 0x6420);
                  cw[h][d][2 * hf + 1] = __byte_perm(wv[4 * h + 2 * hf][d],
                                                     wv[4 * h + 2 * hf + 1][d],
                                                     0x7531);
                }
              }
            }
        }
#pragma unroll
        for (int p = 0; p < P; ++p) {
          if ((p & 1) != par) continue;       // warp-uniform
          float ua[NT][MT][4];
          float xg[MT][2];
          if constexpr (XI8) {
            int ia[NT][MT][4];
            int ig[MT][2];
#pragma unroll
            for (int i = 0; i < MT; ++i) {
              ig[i][0] = ig[i][1] = 0;
#pragma unroll
              for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) ia[j][i][e] = 0;
            }
            constexpr uint32_t kMask = P == 2 ? 0x0F0F0F0Fu : 0x03030303u;
            uint32_t a[NT][4];
#pragma unroll
            for (int d = 0; d < CB / 4; ++d)
#pragma unroll
              for (int s2 = 0; s2 < 2; ++s2) {
                const int j = 2 * d + s2;
                if (j >= NT) continue;
#pragma unroll
                for (int e = 0; e < 4; ++e)   // a0 cA h0, a1 cB h0, a2 cA h1, a3 cB h1
                  a[j][e] = (cw[e >> 1][d][2 * s2 + (e & 1)] >> ((8 / P) * p)) & kMask;
              }
#pragma unroll
            for (int i = 0; i < MT; ++i) {
              const int e = 32 * u + 4 * t;
              const uint32_t b[2] = {
                  *reinterpret_cast<const uint32_t*>(
                      xaddr<XIN, NB, XT>(xsm, p, 8 * i + g, e)),
                  *reinterpret_cast<const uint32_t*>(
                      xaddr<XIN, NB, XT>(xsm, p, 8 * i + g, e + 16))};
              mma_ones_s8(ig[i], b);
#pragma unroll
              for (int j = 0; j < NT; ++j) mma_s8(ia[j][i], a[j], b);
            }
#pragma unroll
            for (int i = 0; i < MT; ++i) {
              xg[i][0] = (float)ig[i][0];
              xg[i][1] = (float)ig[i][1];
#pragma unroll
              for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) ua[j][i][e] = (float)ia[j][i][e];
            }
          } else {
#pragma unroll
            for (int i = 0; i < MT; ++i) {
              xg[i][0] = xg[i][1] = 0.f;
#pragma unroll
              for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) ua[j][i][e] = 0.f;
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {     // the unit's two k16 steps
              uint32_t a[NT][4];
#pragma unroll
              for (int d = 0; d < CB / 4; ++d)
#pragma unroll
                for (int s2 = 0; s2 < 2; ++s2) {
                  const int j = 2 * d + s2;
                  if (j >= NT) continue;
#pragma unroll
                  for (int e = 0; e < 4; ++e) {
                    const uint32_t v = cw[h][d][e] >> (8 * s2);
                    a[j][e] = P == 2 ? (p ? code_pair<2, 1>(v) : code_pair<2, 0>(v))
                              : p == 0 ? code_pair<4, 0>(v)
                              : p == 1 ? code_pair<4, 1>(v)
                              : p == 2 ? code_pair<4, 2>(v) : code_pair<4, 3>(v);
                  }
                }
#pragma unroll
              for (int i = 0; i < MT; ++i) {
                const int e = (32 * u + 16 * h + 2 * t) * 2;
                const uint32_t b[2] = {
                    *reinterpret_cast<const uint32_t*>(
                        xaddr<XIN, NB, XT>(xsm, p, 8 * i + g, e)),
                    *reinterpret_cast<const uint32_t*>(
                        xaddr<XIN, NB, XT>(xsm, p, 8 * i + g, e + 16))};
                mma_ones_bf16(xg[i], b);
#pragma unroll
                for (int j = 0; j < NT; ++j) mma_bf16(ua[j][i], a[j], b);
              }
            }
          }
          // fold: acc += ua * s - xg * (z * s), group (p, j) of the unit
          const int jg = (r0 + 32 * u) / gs;
          const uint8_t* sr = side + (p * L.ng + jg - r0 / gs) * L.side_row;
          float sv[CB], zs[CB];
#pragma unroll
          for (int c = 0; c < CB; c += 4) {
            const uint2 s4 = *reinterpret_cast<const uint2*>(sr + (cl + c) * 2);
            const uint32_t z4 = *reinterpret_cast<const uint32_t*>(sr + 256 + cl + c);
            const uint32_t sb[4] = {s4.x << 16, s4.x & 0xFFFF0000u, s4.y << 16,
                                    s4.y & 0xFFFF0000u};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              sv[c + e] = __uint_as_float(sb[e]);
              zs[c + e] = (float)(signed char)((z4 >> (8 * e)) & 0xFFu) * sv[c + e];
            }
          }
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int i = 0; i < MT; ++i)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int c = 2 * j + (e >> 1);
                acc[j][i][e] = fmaf(ua[j][i][e], sv[c], acc[j][i][e]) -
                               xg[i][e & 1] * zs[c];
              }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st % S], true);
    // thread 0 refills the slot of stage st - 1 once every warp released it
    // (after its own stage st, so it seldom waits)
    if (threadIdx.x == 0 && st > 0 && st - 1 + S < nst) {
      mbar_wait(&empty[(st - 1) % S], ((st - 1) / S) & 1);
      issue(st - 1 + S);
    }
  }
  // the warps' sums, in k-warp order, into red [XT][128] (and the row sums
  // into redx [XT]) over the drained ring; then the split blocks' sums, in
  // split order
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  // each warp's sums into part[kw] [XT][128] (row sums into partx[kw]),
  // then one pass adds them in k-warp order: the block's sums
  float* part = reinterpret_cast<float*>(ring);
  float* partx = part + KW * XT * kCols;
  float* red = partx + KW * XT;            // [XT][128], then redx [XT]
  float* redx = red + XT * kCols;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float* d = part + (kw * XT + 8 * i + 2 * t + hr) * kCols + cl;
#pragma unroll
      for (int c = 0; c < CB; c += 4)
        *reinterpret_cast<float4*>(d + c) =
            make_float4(acc[c / 2][i][hr], acc[c / 2][i][2 + hr],
                        acc[c / 2 + 1][i][hr], acc[c / 2 + 1][i][2 + hr]);
      if (own_xsum && wc == 0 && g == 0)
        partx[kw * XT + 8 * i + 2 * t + hr] = xacc[i][hr];
    }
  __syncthreads();
  auto block_sum = [&](int tok, int c4, float& xsv) {
    float4 v = *reinterpret_cast<const float4*>(part + tok * kCols + c4);
    xsv = own_xsum ? partx[tok] : 0.f;
#pragma unroll
    for (int kk = 1; kk < KW; ++kk) {
      const float4 o =
          *reinterpret_cast<const float4*>(part + (kk * XT + tok) * kCols + c4);
      v.x += o.x; v.y += o.y; v.z += o.z; v.w += o.w;
      if (own_xsum) xsv += partx[kk * XT + tok];
    }
    return v;
  };
  const int quads = m * (kCols / 4);
  if (ks > 1) {   // the block's sums for its cluster, then every block's
    for (int qi = threadIdx.x; qi < quads; qi += kThreads) {
      const int tok = qi / (kCols / 4), c4 = (qi % (kCols / 4)) * 4;
      float xsv;
      *reinterpret_cast<float4*>(red + tok * kCols + c4) = block_sum(tok, c4, xsv);
      if (c4 == 0) redx[tok] = xsv;
    }
    cluster_sync();
  }
  const int q0 = split * quads / ks, q1 = (split + 1) * quads / ks;
  const uint32_t red_s = pq::smem_u32(red);
  for (int qi = q0 + threadIdx.x; qi < q1; qi += kThreads) {
    const int tok = qi / (kCols / 4), c4 = (qi % (kCols / 4)) * 4;
    float4 v;
    float xsv = 0.f;
    if (ks == 1) {
      v = block_sum(tok, c4, xsv);
    } else {
      v = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int r = 0; r < ks; ++r) {
        const float4 o = ld_cluster(red_s + (tok * kCols + c4) * 4, r);
        v.x += o.x; v.y += o.y; v.z += o.z; v.w += o.w;
        if (own_xsum) xsv += ld_cluster1(red_s + (XT * kCols + tok) * 4, r);
      }
    }
    float y[4] = {v.x, v.y, v.z, v.w};
    const int col = n0 + c4;
    if constexpr (MODE == kChannel) {
      if (!own_xsum) xsv = xsum[tok];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float s = scale[col + e];
        const float z = P == 1 ? (float)(zp[col + e] - 128) : (float)zp[col + e];
        y[e] = y[e] * s - xsv * (z * s);
      }
    } else if constexpr (MODE == kNF4) {
#pragma unroll
      for (int e = 0; e < 4; ++e) y[e] *= scale[col + e];
    } else if constexpr (XI8) {
      const float r = xs[tok];
#pragma unroll
      for (int e = 0; e < 4; ++e) y[e] = __fmul_rn(y[e], r);
    }
    const size_t o = (size_t)tok * n + col;
    if (out_bf16) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(y[0], y[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(y[2], y[3]);
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + o) =
          make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                     *reinterpret_cast<const uint32_t*>(&hi));
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(out) + o) =
          make_float4(y[0], y[1], y[2], y[3]);
    }
  }
  if (ks > 1) cluster_sync_relaxed();       // no block leaves while read
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

struct Args {
  const void *x, *w, *scale, *zp, *xsum, *side_s, *side_z, *xs;
  int gs, ch;
  void* out;
  int m, k, n, ksplit, rows_per_split, out_bf16;
  cudaStream_t stream;
};

template <int P, int MODE, bool XI8, int MT>
cudaLaunchConfig_t config(int n, int ksplit, int gs, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n / kCols, ksplit, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = layout<P, MODE, XI8, MT>(gs).total;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = ksplit;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = ksplit > 1 ? 1 : 0;
  return cfg;
}

template <int P, int MODE, bool XI8, int MT>
cudaError_t prepare() {
  static const cudaError_t e = cudaFuncSetAttribute(
      gemv_tc<P, MODE, XI8, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      232448);
  return e;
}

// The tensor maps of a launch: the weight in boxes of 128 columns x R rows
// (128-byte swizzle), x in boxes of XIN bytes x 8 MT tokens (the swizzle of
// that width; rows past m read as zeros), the side streams a group row of
// 128 columns at a time.
template <int P, int MODE, bool XI8, int MT>
bool maps(const Args& a, CUtensorMap* m4) {
  using pq::encode;
  constexpr int R = Tile<MODE, MT>::R, XB = XI8 ? 1 : 2;
  constexpr int XIN = R * XB < 128 ? R * XB : 128;
  const uint64_t wd[2] = {(uint64_t)a.n, (uint64_t)(a.k / P)};
  const uint32_t wb[2] = {kCols, R};
  const uint64_t xd[2] = {(uint64_t)a.k, (uint64_t)a.m};
  const uint32_t xb[2] = {XIN / XB, 8 * MT};
  if (!encode(&m4[0], CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 2, a.w, wd, wb,
              CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&m4[1], XI8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
              XB, 2, a.x, xd, xb,
              XIN == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
              : XIN == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                          : CU_TENSOR_MAP_SWIZZLE_32B))
    return false;
  m4[2] = m4[3] = m4[0];
  if constexpr (MODE == kChunk || MODE == kW4A16 || MODE == kNF4G) {
    const uint64_t sd[2] = {(uint64_t)a.n, (uint64_t)(a.k / a.gs)};
    const uint32_t sb[2] = {kCols, 1};
    constexpr bool kChunkSide = MODE == kChunk;
    if (!encode(&m4[2], kChunkSide ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                   : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                kChunkSide ? 2 : 4, 2, a.side_s, sd, sb,
                CU_TENSOR_MAP_SWIZZLE_NONE))
      return false;
    if (MODE != kNF4G &&
        !encode(&m4[3], kChunkSide ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                   : CU_TENSOR_MAP_DATA_TYPE_INT32,
                kChunkSide ? 1 : 4, 2, a.side_z, sd, sb,
                CU_TENSOR_MAP_SWIZZLE_NONE))
      return false;
  }
  return true;
}

template <int P, int MODE, bool XI8, int MT>
int launch_mt(const Args& a) {
  // splits of whole stages that cover the k / P packed rows once
  const long rows = a.k / P, per = a.rows_per_split;
  if (per <= 0 || per % Tile<MODE, MT>::R || a.ksplit * per < rows ||
      (a.ksplit - 1) * per >= rows)
    return (int)cudaErrorInvalidValue;
  const cudaError_t set = prepare<P, MODE, XI8, MT>();
  if (set != cudaSuccess) return (int)set;
  CUtensorMap m4[4];
  if (!maps<P, MODE, XI8, MT>(a, m4)) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      config<P, MODE, XI8, MT>(a.n, a.ksplit, a.gs, a.stream, attr);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, gemv_tc<P, MODE, XI8, MT>, m4[0], m4[1], m4[2], m4[3],
      static_cast<const float*>(a.scale), static_cast<const int*>(a.zp),
      static_cast<const float*>(a.xsum), static_cast<const float*>(a.xs),
      a.gs, a.ch, a.out, a.m, a.k, a.n, a.rows_per_split, a.out_bf16);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

int n8_tiles(int m) { return m <= 8 ? 1 : m <= 16 ? 2 : m <= 32 ? 4 : 8; }

template <int P, int MODE, bool XI8 = false>
int launch(const Args& a) {
  if (a.m < 1 || a.m > 64 || a.n % kCols || a.ksplit < 1 || a.ksplit > 8)
    return (int)cudaErrorInvalidValue;
  switch (n8_tiles(a.m)) {
    case 1: return launch_mt<P, MODE, XI8, 1>(a);
    case 2: return launch_mt<P, MODE, XI8, 2>(a);
    case 4: return launch_mt<P, MODE, XI8, 4>(a);
    default: return launch_mt<P, MODE, XI8, 8>(a);
  }
}

// Registers, local bytes, shared memory and stages at group size gs; with
// ks > 0, out[4] the clusters of ks blocks that fit on the card at once;
// out[5] the packed rows a stage.
template <int P, int MODE, bool XI8, int MT>
int attributes_mt(int gs, int ks, int* out) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, gemv_tc<P, MODE, XI8, MT>);
  if (e != cudaSuccess) return (int)e;
  const Layout L = layout<P, MODE, XI8, MT>(gs);
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = L.total;
  out[3] = L.stages;
  out[4] = 0;
  out[5] = Tile<MODE, MT>::R;
  if (ks > 0) {
    if ((e = prepare<P, MODE, XI8, MT>()) != cudaSuccess) return (int)e;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg =
        config<P, MODE, XI8, MT>(kCols * 8, ks, gs, nullptr, attr);
    cfg.numAttrs = 1;
    e = cudaOccupancyMaxActiveClusters(&out[4], gemv_tc<P, MODE, XI8, MT>,
                                       &cfg);
  }
  return (int)e;
}

template <int P, int MODE, bool XI8 = false>
int attributes(int mt, int gs, int ks, int* out) {
  switch (mt) {
    case 1: return attributes_mt<P, MODE, XI8, 1>(gs, ks, out);
    case 2: return attributes_mt<P, MODE, XI8, 2>(gs, ks, out);
    case 4: return attributes_mt<P, MODE, XI8, 4>(gs, ks, out);
    default: return attributes_mt<P, MODE, XI8, 8>(gs, ks, out);
  }
}

}  // namespace

// Channelwise: x [m, k] bf16, w [k/P, n] u8, scale [n] f32, zp [n] i32,
// xsum [m] f32 or null (then summed in the kernel), out [m, n] (bf16 if
// out_bf16 else f32).  Needs n % 128 == 0, k % 256 == 0 (k % 512 for
// INT2), 16-byte aligned operands, ksplit <= 8 and rows_per_split a
// multiple of the stage (pq_gemv_attributes' out[5]) with ksplit splits
// covering the k / P packed rows (ops/cuda/qmatmul.py::gemv_split).
#define PQ_CHANNEL_ENTRY(NAME, P)                                             \
  extern "C" int NAME(const void* x, const void* w, const void* scale,        \
                      const void* zp, const void* xsum, void* out, int m,     \
                      int k, int n, int ksplit, int rows_per_split,           \
                      int out_bf16, void* stream) {                           \
    return launch<P, kChannel>(Args{x, w, scale, zp, xsum, nullptr, nullptr,  \
                                    nullptr, 1, 1, out, m, k, n, ksplit,      \
                                    rows_per_split, out_bf16,                 \
                                    reinterpret_cast<cudaStream_t>(stream)}); \
  }

PQ_CHANNEL_ENTRY(pq_w4_gemv, 2)
PQ_CHANNEL_ENTRY(pq_w8_gemv, 1)
PQ_CHANNEL_ENTRY(pq_w2_gemv, 4)

// Grouped, chunk form: s_chunk [k/gs, n] bf16 and z_chunk [k/gs, n] int8 in
// chunk-major order with chunk factor ch; planes 2 (INT4) or 4 (INT2);
// (k / planes) % gs == 0 and gs % 32 == 0.  x is bf16 when xs is null,
// else int8 codes with row scales xs [m] f32.
extern "C" int pq_wg_gemv(const void* x, const void* w, const void* s_chunk,
                          const void* z_chunk, const void* xs, void* out,
                          int m, int k, int n, int gs, int ch, int planes,
                          int ksplit, int rows_per_split, int out_bf16,
                          void* stream) {
  const Args a{x, w, nullptr, nullptr, nullptr, s_chunk, z_chunk, xs, gs, ch,
               out, m, k, n, ksplit, rows_per_split, out_bf16,
               reinterpret_cast<cudaStream_t>(stream)};
  if (gs % 32) return (int)cudaErrorInvalidValue;
  if (planes == 4)
    return xs ? launch<4, kChunk, true>(a) : launch<4, kChunk>(a);
  if (planes == 2)
    return xs ? launch<2, kChunk, true>(a) : launch<2, kChunk>(a);
  return (int)cudaErrorInvalidValue;
}

// Grouped INT4, W4A16 form: scale [k/gs, n] f32 and zp [k/gs, n] int32 in
// natural group order (the lo plane's groups, then the hi plane's);
// gs % 8 == 0.
extern "C" int pq_w4g_gemv(const void* x, const void* w, const void* scale,
                           const void* zp, void* out, int m, int k, int n,
                           int gs, int ksplit, int rows_per_split,
                           int out_bf16, void* stream) {
  if (gs % 8) return (int)cudaErrorInvalidValue;
  return launch<2, kW4A16>(Args{x, w, nullptr, nullptr, nullptr, scale, zp,
                                nullptr, gs, 1, out, m, k, n, ksplit,
                                rows_per_split, out_bf16,
                                reinterpret_cast<cudaStream_t>(stream)});
}

// NF4, x [m, k] bf16, w [k/2, n] u8 split-half codes: channelwise (gs 0)
// with scale [n] f32, or grouped with scale [k/gs, n] f32 in natural group
// order ((k/2) % gs == 0, gs % 8 == 0).
extern "C" int pq_nf4_gemv(const void* x, const void* w, const void* scale,
                           void* out, int m, int k, int n, int gs, int ksplit,
                           int rows_per_split, int out_bf16, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (gs == 0)
    return launch<2, kNF4>(Args{x, w, scale, nullptr, nullptr, nullptr,
                                nullptr, nullptr, 1, 1, out, m, k, n, ksplit,
                                rows_per_split, out_bf16, st});
  if (gs % 8) return (int)cudaErrorInvalidValue;
  return launch<2, kNF4G>(Args{x, w, nullptr, nullptr, nullptr, scale,
                               nullptr, nullptr, gs, 1, out, m, k, n, ksplit,
                               rows_per_split, out_bf16, st});
}

// Registers, local (spill) bytes, dynamic shared memory at group size gs
// and ring stages of one instance (out[0..3]), with ks > 0 the clusters
// of ks blocks the card holds at once (out[4]), and the packed rows a
// stage (out[5], the unit of rows_per_split): form 0 INT8, 1 INT4, 2 INT2
// channelwise, 3 / 4 INT4 / INT2 chunk, 5 / 6 their int8-x forms, 7 W4A16,
// 8 NF4, 9 NF4 grouped (ops/cuda/qmatmul.py::GEMV_FORMS); mt the n8 token
// tiles (1, 2, 4, 8).
extern "C" int pq_gemv_attributes(int form, int mt, int gs, int ks, int* out) {
  switch (form) {
    case 0: return attributes<1, kChannel>(mt, gs, ks, out);
    case 1: return attributes<2, kChannel>(mt, gs, ks, out);
    case 2: return attributes<4, kChannel>(mt, gs, ks, out);
    case 3: return attributes<2, kChunk>(mt, gs, ks, out);
    case 4: return attributes<4, kChunk>(mt, gs, ks, out);
    case 5: return attributes<2, kChunk, true>(mt, gs, ks, out);
    case 6: return attributes<4, kChunk, true>(mt, gs, ks, out);
    case 7: return attributes<2, kW4A16>(mt, gs, ks, out);
    case 8: return attributes<2, kNF4>(mt, gs, ks, out);
    case 9: return attributes<2, kNF4G>(mt, gs, ks, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
