// decode_wide: decode_attn2.cu's three forms (the kv8 and kv4 flash-decode
// state over the stacked cache, and the V1 context over one layer's kv8
// cache) at head_dims of 384 to 1024 (multiples of 128).
//
// Replaces piquant_tpu/ops/pallas/decode_attn2.py::_kernel (kv8 and kv4)
// and piquant_tpu/ops/pallas/attention.py::_decode_attn_kernel (V1) at the
// head_dims that decode_attn2.cu's instances (128, 256) do not take; the
// reference's kernels take any multiple of 128.  The function, the
// sentinel of a row with no live position, the kv4 pair-packed layout, the
// splits of whole 64-position tiles, the tickets and the in-launch merge
// in split order are decode_attn2.cu's (its header comment); only the
// tiling differs, since that kernel's block of D threads, its D / 32 warps
// sharing 8 n8 tiles of scores and its q held in 2 x D / 16 registers a
// thread do not scale past D 256:
//   * a block of 256 threads (8 warps) at every D, one instance for each
//     form (kv8, kv4, V1) with D a runtime count;
//   * q of the block's up to 8 rep heads in shared memory, already in the
//     A-fragment order of each k16 step (a 256-byte uint2 row a step, 16 D
//     bytes in all), read once a tile by each warp;
//   * pass 1: warp w takes positions 8w .. 8w + 7 of each 64-position tile
//     (one n8 tile of S^T = Q K^T) and loops over all D / 16 k16 steps, 4
//     (kv8) or 8 (kv4: both nibbles) from each 16-byte load of a K row;
//   * pass 2: warp w owns D / 8 contiguous dims, D / 128 m16 tiles of
//     O^T = V^T P^T, and loops over them for each k16 step of positions:
//     a thread's 2 bytes (kv8: dims d, d + 1) or 1 byte (kv4: dims j and j
//     + D / 2) of each of its 4 position rows make one tile's A fragment,
//     so O takes at most 8 x 4 f32 registers a thread at D 1024;
//   * the K / V ring holds up to 128 KB of 64-position tiles (at least 2
//     stages: 64 KB a tile at D 1024 kv8); a split's scores and scales as
//     in decode_attn2.cu: 184.6 KB of shared memory at D 1024, rep 8, 16
//     tiles a split, so one block an SM.
// Bound on the H100: the live K / V code and scale bytes, as at D 128 (q
// and the outputs are a few KB); about 2 rep operations a code byte, far
// below the tensor cores' ~295 a byte.  At L 8, B 8, Hkv 2, rep 4, S 2048
// (every position live), kv8: 0.0276 ms at D 512 against a 0.0101 bound,
// 0.0392 against 0.0202 at D 1024 (chip_smoke.py phase 20; H100 80GB
// HBM3, 700 W).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pq_decode.cuh"
#include "pq_hopper.cuh"
#include "pq_mma.cuh"

namespace {

using namespace pq;

constexpr int kTile = kDecodeTile;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinD = 384;
constexpr int kMaxD = 1024;
constexpr int kMaxMt = kMaxD / 128;  // m16 tiles of O^T a warp
constexpr int kMaxStages = 8;
constexpr int kRingBytes = 131072;   // the ring's K or V tiles in flight
constexpr int kMaxTps = kDecodeMaxTps;
constexpr int kMaxSmem = 232448;
constexpr float kNegInf = -1e30f;

using Args = DecodeArgs;

// First of the 4 dims (d0, d0+2 | d0+1, d0+3) of k16 step kk for thread t:
// the dims of the thread's 4 K bytes (decode_attn2.cu's q_dim at D = d).
template <bool KV4>
__device__ __forceinline__ int q_dim(int kk, int t, int d) {
  if constexpr (KV4)
    return 64 * (kk >> 3) + 16 * t + 4 * ((kk >> 1) & 3) + (kk & 1) * (d / 2);
  return 64 * (kk >> 2) + 16 * t + 4 * (kk & 3);
}

template <bool KV4, bool V1>
__global__ void __launch_bounds__(kThreads, 1)
decode_wide_kernel(const Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int D = a.d;
  const int row_bytes = KV4 ? D / 2 : D;   // code bytes a position
  const int tile_bytes = kTile * row_bytes;
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

  // [region: the code ring, later the merge] [qf: D / 16 k16 steps x 32
  // lanes x uint2] [sco: tps x 8 n8 tiles x 32 lanes x 2 scores, then their
  // P] [sks, svs: tps x 64 scales each] [bars: nstage] [sml: warps x 8 rows
  // x (m, l)] [fin: 8 x (m, l)] [flag]
  uint8_t* ring = smem;
  uint2* qf = reinterpret_cast<uint2*>(smem + a.region);
  float* sco = reinterpret_cast<float*>(qf + (D / 16) * 32);
  float* sks = sco + a.tps * 512;
  float* svs = sks + a.tps * kTile;
  uint64_t* bar = reinterpret_cast<uint64_t*>(svs + a.tps * kTile);
  float* sml = reinterpret_cast<float*>(bar + a.nstage);
  float* fin = sml + kWarps * 16;
  int* flag = reinterpret_cast<int*>(fin + 16);

  const int s_len = a.s_len;
  const size_t lbh = (size_t)a.layer * a.nb * a.nh + bh;
  const uint8_t* kslab = a.kc + lbh * s_len * row_bytes;
  const uint8_t* vslab = a.vc + lbh * s_len * row_bytes;
  const float* kss = a.ks + lbh * s_len;
  const float* vss = a.vs + lbh * s_len;

  if (tid == 0) {
    for (int s = 0; s < nst; ++s) mbar_init(&bar[s], 1);
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
      const int q0 = max(p_lo - p0, 0), q1 = min(p_hi - p0, kTile);
      const uint32_t n = (uint32_t)(q1 - q0) * row_bytes;
      mbar_arrive_tx(&bar[s], n, true);
      bulk_load(ring + (size_t)s * tile_bytes + q0 * row_bytes,
                (is_v ? vslab : kslab) + (size_t)(p0 + q0) * row_bytes, n,
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
  // q as the A operand of S^T (rows >= rep zero) in the K bytes' order:
  // entry kk * 32 + lane holds lane (g, t)'s dims d0, d0+2 | d0+1, d0+3
  for (int i = tid; i < (D / 16) * 32; i += kThreads) {
    const int kk = i >> 5, gg = (i >> 2) & 7, tt = i & 3;
    uint2 v = make_uint2(0u, 0u);
    if (gg < rep)
      v = *reinterpret_cast<const uint2*>(a.q + (row0 + gg) * D +
                                          q_dim<KV4>(kk, tt, D));
    qf[i] = make_uint2(__byte_perm(v.x, v.y, 0x5410),
                       __byte_perm(v.x, v.y, 0x7632));
  }
  auto wait = [&](int L) {
    mbar_wait(&bar[L % nst], (uint32_t)((L / nst) & 1));
  };
  // once every warp is done with load L's stage, refill it with L + nst
  auto refill = [&](int L) {
    if (L + nst < 2 * ntile) {
      __syncthreads();
      fetch(L + nst);
    }
  };
  cp_async_wait_all();
  __syncthreads();             // the scales and q have landed

  // ---- pass 1: scores S^T[rep][positions] of the split's tiles into
  // shared memory; warp w takes n8 tile w (positions 8w .. 8w + 7) of each
  // tile, where thread (g, t) holds row g at positions 8w + 2t + e
  float mx = kNegInf;
  for (int i = 0; i < ntile; ++i) {
    wait(i);
    const uint8_t* kt = ring + (size_t)(i % nst) * tile_bytes +
                        (8 * w + g) * row_bytes + 16 * t;
    const int p0 = (t_first + i) * kTile;
    float sacc[2][4];   // [chain][fragment]
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[h][e] = 0.f;
    if constexpr (!KV4) {
#pragma unroll 2
      for (int c = 0; c < D / 64; ++c) {
        const uint4 kw = *reinterpret_cast<const uint4*>(kt + 64 * c);
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const uint2 qa = qf[(4 * c + ii) * 32 + lane];
          const uint32_t x = word(kw, ii);
          mma16816(sacc[ii & 1], qa.x, 0u, qa.y, 0u, s8_pair(x),
                   s8_pair(x >> 8));
        }
      }
    } else {
#pragma unroll 2
      for (int c = 0; c < D / 128; ++c) {
        const uint4 kw = *reinterpret_cast<const uint4*>(kt + 64 * c);
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint2 qa = qf[(8 * c + 2 * ii + h) * 32 + lane];
            const uint32_t x = word(kw, ii) >> (4 * h);
            mma16816(sacc[h], qa.x, 0u, qa.y, 0u, u4_pair(x),
                     u4_pair(x >> 8));
          }
      }
    }
    const int pl = 8 * w + 2 * t;
    const float2 k2 = *reinterpret_cast<const float2*>(sks + i * kTile + pl);
    float sc[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int p = p0 + pl + e;
      const float dot = sacc[0][e] + sacc[1][e];
      sc[e] = p >= p_lo && p < p_hi
                  ? dot * ((e ? k2.y : k2.x) * a.sm_scale)
                  : kNegInf;
      mx = fmaxf(mx, sc[e]);
    }
    reinterpret_cast<float2*>(sco)[(i * 8 + w) * 32 + lane] =
        make_float2(sc[0], sc[1]);
    refill(i);
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
    const int slot = (i * 8 + w) * 32 + lane;
    const float2 s2 = reinterpret_cast<const float2*>(sco)[slot];
    float pv[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int pl = 8 * w + 2 * t + e;
      const bool live = p0 + pl >= p_lo && p0 + pl < p_hi;
      const float pr = live ? __expf((e ? s2.y : s2.x) - m_blk) : 0.f;
      l_run += pr;
      pv[e] = live ? pr * svs[i * kTile + pl] : 0.f;
    }
    reinterpret_cast<uint32_t*>(sco)[slot * 2] = pack_bf16(pv[0], pv[1]);
  }
  __syncthreads();

  // ---- pass 2: O^T[dims][rep] += V^T[dims][64 positions] P^T; warp w
  // owns D / 128 m16 tiles of dims, thread t's k-slots being positions
  // 16kk + (2t, 2t+1 | 2t+8, 2t+9).  m-tile j: rows g and g+8 are dims
  // col + 16j and col + 16j + 1 (kv8: the thread's 2 bytes), or the low and
  // high nibble of byte col + 8j (kv4: dims j' and j' + D / 2)
  const int nmt = D / 128;
  const int col = KV4 ? w * (D / 16) + g : w * (D / 8) + 2 * g;
  float o[kMaxMt][4];
#pragma unroll
  for (int j = 0; j < kMaxMt; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  for (int i = 0; i < ntile; ++i) {
    const int L = ntile + i;
    wait(L);
    const uint8_t* vt = ring + (size_t)(L % nst) * tile_bytes + col;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t* pk = reinterpret_cast<const uint32_t*>(sco);
      const uint32_t b0 = pk[((i * 8 + 2 * kk) * 32 + lane) * 2];
      const uint32_t b1 = pk[((i * 8 + 2 * kk + 1) * 32 + lane) * 2];
      // rows 16kk + 2t + (0, 1, 8, 9)
      const uint8_t* vr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        vr[r] = vt + (16 * kk + 2 * t + (r & 1) + 8 * (r >> 1)) * row_bytes;
#pragma unroll
      for (int j = 0; j < kMaxMt; ++j) {
        if (j < nmt) {
          uint32_t vw[4];
          if constexpr (!KV4) {
#pragma unroll
            for (int r = 0; r < 4; ++r)
              vw[r] = *reinterpret_cast<const uint16_t*>(vr[r] + 16 * j);
            mma16816(o[j], s8_pair(gather(vw[0], vw[1], 0)),
                     s8_pair(gather(vw[0], vw[1], 1)),
                     s8_pair(gather(vw[2], vw[3], 0)),
                     s8_pair(gather(vw[2], vw[3], 1)), b0, b1);
          } else {
#pragma unroll
            for (int r = 0; r < 4; ++r) vw[r] = vr[r][8 * j];
            const uint32_t x01 = gather(vw[0], vw[1], 0);
            const uint32_t x23 = gather(vw[2], vw[3], 0);
            mma16816(o[j], u4_pair(x01), u4_pair(x01 >> 4), u4_pair(x23),
                     u4_pair(x23 >> 4), b0, b1);
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
  for (int j = 0; j < kMaxMt; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int r = 2 * t + (x & 1);
      if (j < nmt && r < rep) {
        const int d = KV4 ? col + 8 * j + (x >> 1) * (D / 2)
                          : col + 16 * j + (x >> 1);
        dst[r * D + d] = V1 && nlive == 1 ? o[j][x] / fin[r * 2 + 1]
                                          : o[j][x];
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
  // thread tid owns float4s tid + 256 k of the rep x D result, summed in
  // split order
  const float4* pacc = reinterpret_cast<const float4*>(a.part_acc);
  for (int i4 = tid; i4 < n4; i4 += kThreads) {
    const int r = (4 * i4) / D;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < nlive; ++s) {
      const float4 x = __ldcg(pacc + ((part0 + s) * nrep + r0) * (D / 4) + i4);
      const float e = wgt[s * rep + r];
      v.x += x.x * e;
      v.y += x.y * e;
      v.z += x.z * e;
      v.w += x.w * e;
    }
    if (V1) {
      const float ll = fin[r * 2 + 1];
      v = make_float4(v.x / ll, v.y / ll, v.z / ll, v.w / ll);
    }
    reinterpret_cast<float4*>(a.acc)[row0 * (D / 4) + i4] = v;
  }
  if (tid == 0) a.tickets[blockIdx.x] = 0;
  if (!V1 && tid < rep) {
    a.m[row0 + tid] = fin[tid * 2];
    a.l[row0 + tid] = fin[tid * 2 + 1];
  }
}

// Dynamic shared memory of a launch; sets a.nstage and a.region.
size_t smem_bytes(Args& a, bool kv4, int nsplit) {
  const int tile = kTile * (kv4 ? a.d / 2 : a.d);
  int st = kRingBytes / tile;
  if (st > kMaxStages) st = kMaxStages;
  if (st > 2 * a.tps) st = 2 * a.tps;
  a.nstage = st;
  size_t region = (size_t)st * tile;
  const size_t merge = (size_t)12 * nsplit * (a.rep < 8 ? a.rep : 8);
                                                // 3 x nsplit x a group's rep
  if (merge > region) region = merge;
  region = (region + 127) & ~(size_t)127;
  a.region = (int)region;
  return region + (size_t)16 * a.d + (size_t)a.tps * (2048 + 2 * kTile * 4) +
         (size_t)st * 8 + (kWarps * 16 + 16) * 4 + 16;
}

template <bool KV4, bool V1>
int launch(Args a, void* stream) {
  if (a.rep < 1 || a.tps < 1 || a.tps > kMaxTps || a.s_len < 1 ||
      a.d % 128 || a.d < kMinD || a.d > kMaxD)
    return (int)cudaErrorInvalidValue;
  const int nsplit = decode_splits(a.s_len, a.tps);
  const size_t smem = smem_bytes(a, KV4, nsplit);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_wide_kernel<KV4, V1>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  decode_wide_kernel<KV4, V1>
      <<<dim3(a.nb * a.nh * ((a.rep + 7) / 8), nsplit), kThreads, smem,
         reinterpret_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

template <bool KV4, bool V1>
int attributes(int d, int* out) {
  cudaFuncAttributes fa;
  const cudaError_t err =
      cudaFuncGetAttributes(&fa, decode_wide_kernel<KV4, V1>);
  Args a = decode_args(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                       nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                       nullptr, 0, 1, 1, 8, 2048, d, kMaxTps, 1.f);
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)smem_bytes(a, KV4, decode_splits(a.s_len, a.tps));
  out[3] = a.nstage;
  return (int)err;
}

}  // namespace

// As pq_decode_attn2 (decode_attn2.cu) at head_dim d of 384 to 1024, a
// multiple of 128: q [B,H,rep,D] bf16; k/v codes [L,B,H,S,D] int8; k/v
// scales [L,B,H,S] f32; pos/start [B] int32; outputs acc [B,H,rep,D], m/l
// [B,H,rep] f32; scratch part_acc [B,H,nsplit,rep,D] and part_ml
// [B,H,nsplit,rep,2] f32, tickets [B*H*ceil(rep/8)] int32 zeroed.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for an unsupported D, rep
// or tps.
extern "C" int pq_decode_attn2_wide(const void* q, const void* kc,
                                    const void* ks, const void* vc,
                                    const void* vs, const void* pos,
                                    const void* start, void* acc, void* m,
                                    void* l, void* part_acc, void* part_ml,
                                    void* tickets, int layer, int nb, int nh,
                                    int rep, int s_len, int d, int tps,
                                    float sm_scale, void* stream) {
  return launch<false, false>(
      decode_args(q, kc, ks, vc, vs, pos, start, acc, m, l, part_acc,
                  part_ml, tickets, layer, nb, nh, rep, s_len, d, tps,
                  sm_scale),
      stream);
}

// As pq_decode_attn2_kv4 at head_dim d of 384 to 1024.
extern "C" int pq_decode_attn2_kv4_wide(const void* q, const void* kc,
                                        const void* ks, const void* vc,
                                        const void* vs, const void* pos,
                                        const void* start, void* acc,
                                        void* m, void* l, void* part_acc,
                                        void* part_ml, void* tickets,
                                        int layer, int nb, int nh, int rep,
                                        int s_len, int d, int tps,
                                        float sm_scale, void* stream) {
  return launch<true, false>(
      decode_args(q, kc, ks, vc, vs, pos, start, acc, m, l, part_acc,
                  part_ml, tickets, layer, nb, nh, rep, s_len, d, tps,
                  sm_scale),
      stream);
}

// As pq_decode_attn (the V1 context) at head_dim d of 384 to 1024.
extern "C" int pq_decode_attn_wide(const void* q, const void* kc,
                                   const void* ks, const void* vc,
                                   const void* vs, const void* pos, void* ctx,
                                   void* part_acc, void* part_ml,
                                   void* tickets, int nb, int nh, int rep,
                                   int s_len, int d, int tps, float sm_scale,
                                   void* stream) {
  return launch<false, true>(
      decode_args(q, kc, ks, vc, vs, pos, pos, ctx, nullptr, nullptr,
                  part_acc, part_ml, tickets, 0, nb, nh, rep, s_len, d, tps,
                  sm_scale),
      stream);
}

// Registers, local (spill) bytes, dynamic shared memory and ring stages of
// the instance for form (0 kv8, 1 kv4, 2 V1) at head_dim d (rep 8, S 2048,
// 16 tiles a split: the most) into out[4].
extern "C" int pq_decode_wide_attributes(int d, int form, int* out) {
  if (d % 128 || d < kMinD || d > kMaxD) return (int)cudaErrorInvalidValue;
  if (form == 0) return attributes<false, false>(d, out);
  if (form == 1) return attributes<true, false>(d, out);
  if (form == 2) return attributes<false, true>(d, out);
  return (int)cudaErrorInvalidValue;
}
