// decode_attn2: flash-decode over the stacked INT8 (kv8) or pair-packed
// INT4 (kv4) KV cache, and the first flash-decode kernel's function (V1).
//
// Replaces piquant_tpu/ops/pallas/decode_attn2.py::_kernel in both forms
// and piquant_tpu/ops/pallas/attention.py::_decode_attn_kernel (V1).  For
// every (batch row b, kv head h) the kv8 / kv4 forms return the
// UNNORMALIZED flash state over the live cache window start[b] <= p < pos[b]:
//   m   = max_p s_p,   l = sum_p exp(s_p - m),
//   acc = sum_p bf16(exp(s_p - m) * vs_p) * v_codes[p],
//   s_p = (q . k_codes[p]) * (ks_p * sm_scale)
// for the rep query heads of h at once.  A row with no live position gets
// the TPU kernel's sentinel: m = -1e30, l = 0, acc = 0 (a -inf would turn
// the caller's fold with the current token into NaN).  V1 reads one
// layer's kv8 cache [B, Hkv, S, D] (layer 0 of a stack of one), attends
// 0 <= p <= pos[b] (the current token is in the cache) and returns the
// NORMALIZED context acc / l.
//
// Bound on the H100: the live K/V code bytes and their f32 scales (q and
// the outputs are a few KB); about 2 rep operations a code byte, far below
// the tensor cores' ~295 a byte.  Design:
//   * both products on the tensor cores (mma.sync m16n8k16, bf16 in, f32
//     sums).  The codes are exact in bf16 (kv8 -128..127 from 0x4300 | low
//     7 bits minus 0x4300 | sign bit; kv4 0x4300 | nibble minus 136), so a
//     code costs ~2 integer operations and no rep-fold FMAs.  S^T = Q K^T
//     puts the rep heads on M (padded to 16: the upper 8 rows are zero) and
//     16 positions on N: each thread's scores are then the B fragment of
//     O^T = V^T P^T (dims on M, rep heads on N, 16 positions on K).  A k16
//     step takes a thread's 4 consecutive bytes of a K row as k-slots (2t,
//     2t+1, 2t+8, 2t+9) = dims (d0, d0+2, d0+1, d0+3), and q is loaded in
//     the same order (a sum over dims ignores their order); kv4's bytes give
//     a low-nibble k16 step (dims j..) and a high one (dims j + D/2..).  V's
//     k-slots are positions, so its bytes are gathered across 2 rows with
//     one __byte_perm a register;
//   * two passes a split, D / 32 warps a block: the scores of all its
//     tiles (pass 1, each warp 16 or 8 positions of a tile) into shared
//     memory, then P = bf16(exp(s - m) vs) at the split's own maximum, then
//     O (pass 2, each warp 32 dims over all 64 positions of a tile), so no
//     running rescale and no fold of the warps' O;
//   * a grid of (B * Hkv, splits): the wrapper splits S into at most 8
//     splits of whole 64-position tiles (decode_attn2.py::split_tiles, from
//     S alone: no pos is read on the host); a split with no live position
//     returns at once;
//   * bytes in flight: a ring of up to 96 KB of 64-position K tiles, then V
//     tiles (16 KB a tile at D 256 kv8), filled by plain bulk copies of the
//     live rows (a tile of one (layer, b, h) slab is one contiguous run, in
//     both forms) on an mbarrier a stage; the split's live scales come in
//     up front, one 4-byte cp.async each;
//   * one launch a call: a row whose window lies in one split writes its
//     result directly.  Otherwise each split writes an f32 partial, takes a
//     ticket (an int32 atomic per (b, h)), and the split that takes the
//     last ticket merges all partials in split order (identical bits on
//     every call and graph replay) and resets the ticket to 0;
//   * REP is a runtime count: a block holds at most 8 rep heads (the live
//     N columns of one n8 tile of O^T), so a GQA rep above 8 takes its
//     heads in groups of 8, a group index in the grid's x: (B * Hkv *
//     ceil(rep / 8), splits).  Each group re-reads its kv head's codes
//     (from L2 after the first), has its own ticket and merges its own
//     rows of the partials.  One instance per D (128, 256) and form (kv8,
//     kv4, V1), six in all.
// The probabilities are rounded to bf16 at each split's maximum, as the TPU
// kernel rounds them at its 512-position chunk's running maximum (the same
// function within those roundings).
//
// kv4 (quant/kv_cache.py): codes [L, B, Hkv, S/2, D] uint8, where row t
// holds position 2t's D/2 bytes then position 2t+1's, so position p is the
// D/2 bytes at p * D/2 of its slab; byte j holds dim j in its low nibble
// and dim j + D/2 in its high one, each plus 8; scales [L, B, Hkv, 2, S/2]
// with position p at [p % 2, p / 2].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pq_hopper.cuh"

namespace {

constexpr int kTile = 64;        // cache positions a ring stage holds
constexpr int kMaxStages = 8;
constexpr int kRingBytes = 98304;   // the ring's K or V tiles in flight
constexpr int kMaxTps = 16;         // tiles a split (its scores: 2 KB each)
constexpr int kMaxSmem = 232448;
constexpr float kNegInf = -1e30f;

struct Args {
  const __nv_bfloat16* q;    // [B, Hkv, rep, D]
  const uint8_t* kc;         // [L, B, Hkv, S, D] int8 / [L, B, Hkv, S/2, D] u8
  const float* ks;           // [L, B, Hkv, S] / [L, B, Hkv, 2, S/2]
  const uint8_t* vc;
  const float* vs;
  const int* pos;            // [B]
  const int* start;          // [B]
  float* acc;                // [B, Hkv, rep, D] (V1: the context)
  float* m;                  // [B, Hkv, rep]
  float* l;
  float* part_acc;           // [B, Hkv, nsplit, rep, D]
  float* part_ml;            // [B, Hkv, nsplit, rep, 2]
  int* tickets;              // [B * Hkv * groups], zero between calls
  int layer, nb, nh, rep, s_len, tps, nstage, region;
  float sm_scale;
};

template <bool KV4, int D>
struct Form {
  static constexpr int kRow = KV4 ? D / 2 : D;     // code bytes a position
  static constexpr int kTileBytes = kTile * kRow;
  static constexpr int kSteps = D / 16;            // k16 steps of Q K^T
  static constexpr int kWarps = D / 32;   // a block: D threads
  static constexpr int kThreads = D;
  static constexpr int kNt = 8 / kWarps;  // n8 tiles of scores a warp a tile
  static constexpr int kOut4 = 2;         // float4s of 8 heads x D a thread
};

__device__ __forceinline__ void mma16816(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// int8 codes in bytes 0 and 2 of w -> bf16x2 (low half: byte 0), exactly:
// (128 + low 7 bits) - (128, or 256 when the sign bit is set)
__device__ __forceinline__ uint32_t s8_pair(uint32_t w) {
  return bf16x2_sub((w & 0x007F007Fu) | 0x43004300u,
                    (w & 0x00800080u) | 0x43004300u);
}

// offset-8 nibbles in bits 0-3 of bytes 0 and 2 of w -> bf16x2, exactly
__device__ __forceinline__ uint32_t u4_pair(uint32_t w) {
  return bf16x2_sub((w & 0x000F000Fu) | 0x43004300u, 0x43084308u);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// byte j of a into bytes 0 and 1, byte j of b into bytes 2 and 3
__device__ __forceinline__ uint32_t gather(uint32_t a, uint32_t b, int j) {
  return __byte_perm(a, b, j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   pq::smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <bool KV4>
__device__ __forceinline__ size_t scale_at(int p, int s_len) {
  if constexpr (KV4) return (size_t)(p & 1) * (s_len / 2) + (p >> 1);
  return (size_t)p;
}

// First of the 4 dims (d0, d0+2 | d0+1, d0+3) of k16 step kk for thread t.
template <bool KV4, int D>
__device__ __forceinline__ int q_dim(int kk, int t) {
  if constexpr (KV4)
    return 64 * (kk >> 3) + 16 * t + 4 * ((kk >> 1) & 3) + (kk & 1) * (D / 2);
  return 64 * (kk >> 2) + 16 * t + 4 * (kk & 3);
}


template <bool KV4, int D, bool V1>
__global__ void __launch_bounds__(D, D == 128 ? 4 : 2)
decode_attn2_kernel(const Args a) {
  using F = Form<KV4, D>;
  constexpr int kWarps = F::kWarps, kThreads = F::kThreads, kNt = F::kNt;
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int split = blockIdx.y, nsplit = gridDim.y;
  // the block's rep heads: group grp of kv head row bh, heads r0 .. r0+rep-1
  const int ngrp = (a.rep + 7) / 8;
  const int bh = blockIdx.x / ngrp, grp = blockIdx.x % ngrp;
  const int r0 = 8 * grp, rep = min(8, a.rep - r0), nrep = a.rep;
  const int b = bh / a.nh;
  const int span = a.tps * kTile;
  const int lo = V1 ? 0 : max(a.start[b], 0);
  const int hi = min(V1 ? a.pos[b] + 1 : a.pos[b], a.s_len);
  const int first = lo / span;
  const int nlive = hi > lo ? (hi - 1) / span - first + 1 : 0;
  const int n4 = rep * D / 4;   // float4s of the group's rep x D result
  const size_t row0 = (size_t)bh * nrep + r0;   // its first head's row
  if (nlive == 0) {             // no live position: split 0 writes the sentinel
    if (split == 0) {
      for (int i = tid; i < n4; i += kThreads)
        reinterpret_cast<float4*>(a.acc)[row0 * (D / 4) + i] =
            make_float4(0.f, 0.f, 0.f, 0.f);
      if (!V1 && tid < rep) {
        a.m[row0 + tid] = kNegInf;
        a.l[row0 + tid] = 0.f;
      }
    }
    return;
  }
  const int p_lo = max(lo, split * span), p_hi = min(hi, (split + 1) * span);
  if (p_lo >= p_hi) return;     // dead split
  const int t_first = p_lo / kTile;
  const int ntile = (p_hi - 1) / kTile - t_first + 1;
  const int nst = min(a.nstage, 2 * ntile);

  // [region: the code ring, later the merge] [sco: tps x 8 n8 tiles x 32
  // lanes x 2 scores, then their P] [sks, svs: tps x 64 scales each]
  // [bars: nstage] [sml: warps x 8 rows x (m, l)] [fin: 8 x (m, l)] [flag]
  uint8_t* ring = smem;
  float* sco = reinterpret_cast<float*>(smem + a.region);
  float* sks = sco + a.tps * 512;
  float* svs = sks + a.tps * kTile;
  uint64_t* bar = reinterpret_cast<uint64_t*>(svs + a.tps * kTile);
  float* sml = reinterpret_cast<float*>(bar + a.nstage);
  float* fin = sml + kWarps * 16;
  int* flag = reinterpret_cast<int*>(fin + 16);

  const int s_len = a.s_len;
  const size_t lbh = (size_t)a.layer * a.nb * a.nh + bh;
  const uint8_t* kslab = a.kc + lbh * s_len * F::kRow;
  const uint8_t* vslab = a.vc + lbh * s_len * F::kRow;
  const float* kss = a.ks + lbh * s_len;
  const float* vss = a.vs + lbh * s_len;

  if (tid == 0) {
    for (int s = 0; s < nst; ++s) pq::mbar_init(&bar[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Load L of the block (K tiles 0 .. ntile-1, then V tiles) into stage
  // L % nst: the tile's live rows by one bulk copy.
  auto fetch = [&](int L) {
    if (tid == 0) {
      const int s = L % nst;
      const bool is_v = L >= ntile;
      const int p0 = (t_first + (is_v ? L - ntile : L)) * kTile;
      const int r0 = max(p_lo - p0, 0), r1 = min(p_hi - p0, kTile);
      const uint32_t n = (uint32_t)(r1 - r0) * F::kRow;
      pq::mbar_arrive_tx(&bar[s], n, true);
      pq::bulk_load(ring + s * F::kTileBytes + r0 * F::kRow,
                    (is_v ? vslab : kslab) + (size_t)(p0 + r0) * F::kRow, n,
                    &bar[s]);
    }
  };
  for (int L = 0; L < nst; ++L) fetch(L);
  // the split's live K and V scales, one cp.async each
  for (int j = tid; j < 2 * ntile * kTile; j += kThreads) {
    const int is_v = j >= ntile * kTile;
    const int jj = is_v ? j - ntile * kTile : j;
    const int p = t_first * kTile + jj;
    if (p >= p_lo && p < p_hi)
      cp_async4((is_v ? svs : sks) + jj,
                (is_v ? vss : kss) + scale_at<KV4>(p, s_len));
  }
  auto wait = [&](int L) {
    pq::mbar_wait(&bar[L % nst], (uint32_t)((L / nst) & 1));
  };
  // once every warp is done with load L's stage, refill it with L + nst
  auto refill = [&](int L) {
    if (L + nst < 2 * ntile) {
      __syncthreads();
      fetch(L + nst);
    }
  };

  // ---- pass 1: scores S^T[rep][positions] of the split's tiles into
  // shared memory; warp w takes the n8 tiles n = w kNt + nt of each tile,
  // where thread (g, t) holds row g at positions 8n + 2t + e
  float mx = kNegInf;
  {
    // q as the A operand of S^T (rows >= rep zero), in the K bytes' order
    uint32_t qa[F::kSteps][2];
    const __nv_bfloat16* qrow = a.q + (row0 + g) * D;
#pragma unroll
    for (int kk = 0; kk < F::kSteps; ++kk) {
      uint2 v = make_uint2(0u, 0u);
      if (g < rep)
        v = *reinterpret_cast<const uint2*>(qrow + q_dim<KV4, D>(kk, t));
      qa[kk][0] = __byte_perm(v.x, v.y, 0x5410);   // dims d0, d0+2
      qa[kk][1] = __byte_perm(v.x, v.y, 0x7632);   // dims d0+1, d0+3
    }
    cp_async_wait_all();
    __syncthreads();             // the scales have landed
    for (int i = 0; i < ntile; ++i) {
      wait(i);
      const uint8_t* kt = ring + (i % nst) * F::kTileBytes;
      const int p0 = (t_first + i) * kTile;
      float sacc[kNt][2][4];   // [n8 tile][chain][fragment]
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[nt][h][e] = 0.f;
      if constexpr (!KV4) {
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          uint4 kw[kNt];
#pragma unroll
          for (int nt = 0; nt < kNt; ++nt)
            kw[nt] = *reinterpret_cast<const uint4*>(
                kt + (8 * (w * kNt + nt) + g) * D + 64 * c + 16 * t);
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
#pragma unroll
            for (int nt = 0; nt < kNt; ++nt) {
              const uint32_t x = word(kw[nt], ii);
              mma16816(sacc[nt][ii & 1], qa[4 * c + ii][0], 0u,
                       qa[4 * c + ii][1], 0u, s8_pair(x), s8_pair(x >> 8));
            }
        }
      } else {
#pragma unroll
        for (int c = 0; c < D / 128; ++c) {
          uint4 kw[kNt];
#pragma unroll
          for (int nt = 0; nt < kNt; ++nt)
            kw[nt] = *reinterpret_cast<const uint4*>(
                kt + (8 * (w * kNt + nt) + g) * (D / 2) + 64 * c + 16 * t);
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int nt = 0; nt < kNt; ++nt) {
                const uint32_t x = word(kw[nt], ii) >> (4 * h);
                const int kk = 8 * c + 2 * ii + h;
                mma16816(sacc[nt][h], qa[kk][0], 0u, qa[kk][1], 0u,
                         u4_pair(x), u4_pair(x >> 8));
              }
        }
      }
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        const int n = w * kNt + nt, pl = 8 * n + 2 * t;
        const float2 k2 =
            *reinterpret_cast<const float2*>(sks + i * kTile + pl);
        float sc[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int p = p0 + pl + e;
          const float dot = sacc[nt][0][e] + sacc[nt][1][e];
          sc[e] = p >= p_lo && p < p_hi
                      ? dot * ((e ? k2.y : k2.x) * a.sm_scale)
                      : kNegInf;
          mx = fmaxf(mx, sc[e]);
        }
        reinterpret_cast<float2*>(sco)[(i * 8 + n) * 32 + lane] =
            make_float2(sc[0], sc[1]);
      }
      refill(i);
    }
  }
  // the split's maximum of row g: over t, then over the warps
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  if (t == 0) sml[(w * 8 + g) * 2] = mx;
  __syncthreads();
  float m_blk = kNegInf;
#pragma unroll
  for (int v = 0; v < kWarps; ++v) m_blk = fmaxf(m_blk, sml[(v * 8 + g) * 2]);

  // ---- P = bf16(exp(s - m) * vs) at the split's maximum, in place of
  // each thread's scores: n8 tile n's are the k-slots 2t, 2t+1 (n even) or
  // 2t+8, 2t+9 (n odd) of the k16 step over positions 16 (n / 2) ..
  float l_run = 0.f;
  for (int i = 0; i < ntile; ++i) {
    const int p0 = (t_first + i) * kTile;
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      const int n = w * kNt + nt, slot = (i * 8 + n) * 32 + lane;
      const float2 s2 = reinterpret_cast<const float2*>(sco)[slot];
      float pv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int pl = 8 * n + 2 * t + e;
        const bool live = p0 + pl >= p_lo && p0 + pl < p_hi;
        const float pr = live ? __expf((e ? s2.y : s2.x) - m_blk) : 0.f;
        l_run += pr;
        pv[e] = live ? pr * svs[i * kTile + pl] : 0.f;
      }
      reinterpret_cast<uint32_t*>(sco)[slot * 2] = pack_bf16(pv[0], pv[1]);
    }
  }
  __syncthreads();

  // ---- pass 2: O^T[dims][rep] += V^T[dims][64 positions] P^T; warp w
  // takes the tile's 64 positions (4 k16 steps) for 32 dims (kv4: 16 bytes
  // of each position), thread t's k-slots being positions 16kk + (2t, 2t+1
  // | 2t+8, 2t+9); m-tile mt holds the dims of byte 2mt (row g) and 2mt+1
  // (row g+8) of the thread's 4 bytes (kv8), or the low (row g) and high
  // (row g+8) nibble of byte mt of its 2 (kv4)
  constexpr int kBytes = KV4 ? 2 : 4;   // a thread's bytes a row
  constexpr int kMt = 2;
  float o[kMt][4];
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[mt][e] = 0.f;
  const int col = w * (F::kRow / kWarps) + kBytes * g;
  for (int i = 0; i < ntile; ++i) {
    const int L = ntile + i;
    wait(L);
    const uint8_t* vt = ring + (L % nst) * F::kTileBytes + col;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t* pk = reinterpret_cast<const uint32_t*>(sco);
      const uint2 bp = make_uint2(pk[((i * 8 + 2 * kk) * 32 + lane) * 2],
                                  pk[((i * 8 + 2 * kk + 1) * 32 + lane) * 2]);
      // rows 16kk + 2t + (0, 1, 8, 9)
      const uint8_t* vr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        vr[r] = vt + (16 * kk + 2 * t + (r & 1) + 8 * (r >> 1)) * F::kRow;
      {
        uint32_t vw[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          vw[r] = kBytes == 4 ? *reinterpret_cast<const uint32_t*>(vr[r])
                              : *reinterpret_cast<const uint16_t*>(vr[r]);
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt) {
          if constexpr (!KV4) {
            mma16816(o[mt], s8_pair(gather(vw[0], vw[1], 2 * mt)),
                     s8_pair(gather(vw[0], vw[1], 2 * mt + 1)),
                     s8_pair(gather(vw[2], vw[3], 2 * mt)),
                     s8_pair(gather(vw[2], vw[3], 2 * mt + 1)), bp.x, bp.y);
          } else {
            const uint32_t x01 = gather(vw[0], vw[1], mt);
            const uint32_t x23 = gather(vw[2], vw[3], mt);
            mma16816(o[mt], u4_pair(x01), u4_pair(x01 >> 4), u4_pair(x23),
                     u4_pair(x23 >> 4), bp.x, bp.y);
          }
        }
      }
    }
    refill(L);
  }

  // ---- the split's l (sums in a fixed order), then its result: each
  // warp's dims straight from its registers
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 1);
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 2);
  if (t == 0) sml[(w * 8 + g) * 2 + 1] = l_run;
  __syncthreads();
  if (tid < rep) {
    float mm = kNegInf, ll = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      mm = fmaxf(mm, sml[(v * 8 + tid) * 2]);
      ll += sml[(v * 8 + tid) * 2 + 1];
    }
    fin[tid * 2] = mm;
    fin[tid * 2 + 1] = ll;
  }
  __syncthreads();
  const size_t part = (size_t)bh * nsplit + split;
  float* dst = nlive > 1 ? a.part_acc + (part * nrep + r0) * D
                         : a.acc + row0 * D;
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int r = 2 * t + (x & 1);
      if (r < rep) {
        const int d = KV4 ? col + mt + (x >> 1) * (D / 2) : col + 2 * mt + (x >> 1);
        dst[r * D + d] = V1 && nlive == 1 ? o[mt][x] / fin[r * 2 + 1]
                                          : o[mt][x];
      }
    }
  if (nlive == 1) {
    if (!V1 && tid < rep) {
      a.m[row0 + tid] = fin[tid * 2];
      a.l[row0 + tid] = fin[tid * 2 + 1];
    }
    return;
  }

  // ---- partial (m, l), ticket (one a group); the last split merges the
  // group's rows of them in split order
  if (tid < rep)
    reinterpret_cast<float2*>(a.part_ml)[part * nrep + r0 + tid] =
        make_float2(fin[tid * 2], fin[tid * 2 + 1]);
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(a.tickets + blockIdx.x, 1) == nlive - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  float* msl = reinterpret_cast<float*>(smem);   // [nlive][rep][2]
  float* wgt = msl + 2 * nlive * rep;             // [nlive][rep]
  const size_t part0 = (size_t)bh * nsplit + first;
  for (int i = tid; i < 2 * nlive * rep; i += kThreads)
    msl[i] = __ldcg(a.part_ml + ((part0 + i / (2 * rep)) * nrep + r0) * 2 +
                    i % (2 * rep));
  __syncthreads();
  if (tid < rep) {
    float mm = kNegInf, ll = 0.f;
    for (int s = 0; s < nlive; ++s) mm = fmaxf(mm, msl[(s * rep + tid) * 2]);
    for (int s = 0; s < nlive; ++s) {
      const float e = __expf(msl[(s * rep + tid) * 2] - mm);
      wgt[s * rep + tid] = e;
      ll += msl[(s * rep + tid) * 2 + 1] * e;
    }
    fin[tid * 2] = mm;
    fin[tid * 2 + 1] = ll;
  }
  __syncthreads();
  // thread tid owns float4s tid + 128 k of the rep x D result; 16 float4
  // loads in flight at a time, summed in split order
  constexpr int kSplits = 8;
  const float4* pacc = reinterpret_cast<const float4*>(a.part_acc);
  float4 out[F::kOut4];
#pragma unroll
  for (int k = 0; k < F::kOut4; ++k) out[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = 0; s0 < nlive; s0 += kSplits) {
    float4 xs[kSplits][F::kOut4];
#pragma unroll
    for (int u = 0; u < kSplits; ++u)
#pragma unroll
      for (int k = 0; k < F::kOut4; ++k) {
        const int i4 = tid + kThreads * k;
        xs[u][k] = s0 + u < nlive && i4 < n4
                       ? __ldcg(pacc + ((part0 + s0 + u) * nrep + r0) *
                                           (D / 4) + i4)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
    for (int u = 0; u < kSplits; ++u)
#pragma unroll
      for (int k = 0; k < F::kOut4; ++k) {
        const int i4 = tid + kThreads * k;
        if (s0 + u < nlive && i4 < n4) {
          const float e = wgt[(s0 + u) * rep + (4 * i4) / D];
          out[k].x += xs[u][k].x * e;
          out[k].y += xs[u][k].y * e;
          out[k].z += xs[u][k].z * e;
          out[k].w += xs[u][k].w * e;
        }
      }
  }
  if (tid == 0) a.tickets[blockIdx.x] = 0;
#pragma unroll
  for (int k = 0; k < F::kOut4; ++k) {
    const int i4 = tid + kThreads * k;
    if (i4 < n4) {
      float4 v = out[k];
      if (V1) {
        const float ll = fin[((4 * i4) / D) * 2 + 1];
        v = make_float4(v.x / ll, v.y / ll, v.z / ll, v.w / ll);
      }
      reinterpret_cast<float4*>(a.acc)[row0 * (D / 4) + i4] = v;
    }
  }
  if (!V1 && tid < rep) {
    a.m[row0 + tid] = fin[tid * 2];
    a.l[row0 + tid] = fin[tid * 2 + 1];
  }
}

int n_splits(int s_len, int tps) {
  const int tiles = (s_len + kTile - 1) / kTile;
  return (tiles + tps - 1) / tps;
}

// Dynamic shared memory of a launch; sets a.nstage and a.region.
template <bool KV4, int D>
size_t smem_bytes(Args& a, int nsplit) {
  using F = Form<KV4, D>;
  int st = kRingBytes / F::kTileBytes;
  if (st > kMaxStages) st = kMaxStages;
  if (st > 2 * a.tps) st = 2 * a.tps;
  a.nstage = st;
  size_t region = (size_t)st * F::kTileBytes;
  const size_t merge = (size_t)12 * nsplit * (a.rep < 8 ? a.rep : 8);
                                                // 3 x nsplit x a group's rep
  if (merge > region) region = merge;
  region = (region + 127) & ~(size_t)127;
  a.region = (int)region;
  return region + (size_t)a.tps * (2048 + 2 * kTile * 4) + (size_t)st * 8 +
         (F::kWarps * 16 + 16) * 4 + 16;
}

template <bool KV4, int D, bool V1>
int launch(Args a, cudaStream_t st) {
  const int nsplit = n_splits(a.s_len, a.tps);
  const size_t smem = smem_bytes<KV4, D>(a, nsplit);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_attn2_kernel<KV4, D, V1>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  decode_attn2_kernel<KV4, D, V1>
      <<<dim3(a.nb * a.nh * ((a.rep + 7) / 8), nsplit), Form<KV4, D>::kThreads,
         smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <bool KV4, bool V1>
int dispatch(const Args& a, int d, void* stream) {
  if (a.rep < 1 || a.tps < 1 || a.tps > kMaxTps || a.s_len < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (d == 128) return launch<KV4, 128, V1>(a, st);
  if (d == 256) return launch<KV4, 256, V1>(a, st);
  return (int)cudaErrorInvalidValue;
}

Args make_args(const void* q, const void* kc, const void* ks, const void* vc,
               const void* vs, const void* pos, const void* start, void* acc,
               void* m, void* l, void* part_acc, void* part_ml, void* tickets,
               int layer, int nb, int nh, int rep, int s_len, int tps,
               float sm_scale) {
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.kc = static_cast<const uint8_t*>(kc);
  a.ks = static_cast<const float*>(ks);
  a.vc = static_cast<const uint8_t*>(vc);
  a.vs = static_cast<const float*>(vs);
  a.pos = static_cast<const int*>(pos);
  a.start = static_cast<const int*>(start);
  a.acc = static_cast<float*>(acc);
  a.m = static_cast<float*>(m);
  a.l = static_cast<float*>(l);
  a.part_acc = static_cast<float*>(part_acc);
  a.part_ml = static_cast<float*>(part_ml);
  a.tickets = static_cast<int*>(tickets);
  a.layer = layer;
  a.nb = nb;
  a.nh = nh;
  a.rep = rep;
  a.s_len = s_len;
  a.tps = tps;
  a.nstage = 0;
  a.region = 0;
  a.sm_scale = sm_scale;
  return a;
}

template <bool KV4, int D, bool V1>
int attributes(int* out) {
  cudaFuncAttributes fa;
  const cudaError_t err =
      cudaFuncGetAttributes(&fa, decode_attn2_kernel<KV4, D, V1>);
  Args a = make_args(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                     nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                     nullptr, 0, 1, 1, 8, 2048, kMaxTps, 1.f);
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)smem_bytes<KV4, D>(a, n_splits(a.s_len, a.tps));
  out[3] = a.nstage;
  return (int)err;
}

}  // namespace

// q [B,H,rep,D] bf16; k/v codes [L,B,H,S,D] int8; k/v scales [L,B,H,S] f32;
// pos/start [B] int32; outputs acc [B,H,rep,D], m/l [B,H,rep] f32; scratch
// part_acc [B,H,nsplit,rep,D] and part_ml [B,H,nsplit,rep,2] f32 with
// nsplit = ceil(ceil(S/64) / tps), tickets [B*H*ceil(rep/8)] int32 zeroed
// before the first call (every call leaves them zero); tps: 64-position
// tiles a split, 1 to 16.  D must be 128 or 256, rep 1 or more.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for an unsupported D, rep or
// tps.
extern "C" int pq_decode_attn2(const void* q, const void* kc, const void* ks,
                               const void* vc, const void* vs, const void* pos,
                               const void* start, void* acc, void* m, void* l,
                               void* part_acc, void* part_ml, void* tickets,
                               int layer, int nb, int nh, int rep, int s_len,
                               int d, int tps, float sm_scale, void* stream) {
  return dispatch<false, false>(
      make_args(q, kc, ks, vc, vs, pos, start, acc, m, l, part_acc, part_ml,
                tickets, layer, nb, nh, rep, s_len, tps, sm_scale),
      d, stream);
}

// As pq_decode_attn2 over the kv4 cache: k/v codes [L,B,H,S/2,D] uint8
// (pair-packed), k/v scales [L,B,H,2,S/2] f32; s_len (even) in positions.
extern "C" int pq_decode_attn2_kv4(const void* q, const void* kc,
                                   const void* ks, const void* vc,
                                   const void* vs, const void* pos,
                                   const void* start, void* acc, void* m,
                                   void* l, void* part_acc, void* part_ml,
                                   void* tickets, int layer, int nb, int nh,
                                   int rep, int s_len, int d, int tps,
                                   float sm_scale, void* stream) {
  return dispatch<true, false>(
      make_args(q, kc, ks, vc, vs, pos, start, acc, m, l, part_acc, part_ml,
                tickets, layer, nb, nh, rep, s_len, tps, sm_scale),
      d, stream);
}

// The first flash-decode kernel's function (V1): q [B,H,rep,D] bf16, one
// layer's kv8 cache, codes [B,H,S,D] int8 and scales [B,H,S] f32, pos [B]
// int32 (positions 0 .. pos inclusive attend) -> ctx [B,H,rep,D] f32, the
// normalized context; scratch and tickets as pq_decode_attn2's.
extern "C" int pq_decode_attn(const void* q, const void* kc, const void* ks,
                              const void* vc, const void* vs, const void* pos,
                              void* ctx, void* part_acc, void* part_ml,
                              void* tickets, int nb, int nh, int rep,
                              int s_len, int d, int tps, float sm_scale,
                              void* stream) {
  return dispatch<false, true>(
      make_args(q, kc, ks, vc, vs, pos, pos, ctx, nullptr, nullptr, part_acc,
                part_ml, tickets, 0, nb, nh, rep, s_len, tps, sm_scale),
      d, stream);
}

// Registers, local (spill) bytes, dynamic shared memory (rep 8, S 2048,
// 16 tiles a split: the most) and ring stages of the instance for head dim
// d and form (0 kv8, 1 kv4, 2 V1) into out[4].
extern "C" int pq_decode_attn2_attributes(int d, int form, int* out) {
  if (d == 128) {
    if (form == 0) return attributes<false, 128, false>(out);
    if (form == 1) return attributes<true, 128, false>(out);
    if (form == 2) return attributes<false, 128, true>(out);
  }
  if (d == 256) {
    if (form == 0) return attributes<false, 256, false>(out);
    if (form == 1) return attributes<true, 256, false>(out);
    if (form == 2) return attributes<false, 256, true>(out);
  }
  return (int)cudaErrorInvalidValue;
}
