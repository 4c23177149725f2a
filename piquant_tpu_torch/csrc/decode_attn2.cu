// decode_attn2: flash-decode over the stacked INT8 (kv8) or pair-packed
// INT4 (kv4) KV cache.
//
// Replaces piquant_tpu/ops/pallas/decode_attn2.py::_kernel in both forms.
// For every (batch row b, kv head h) it returns the UNNORMALIZED flash state
// over the live cache window start[b] <= p < pos[b]:
//   m   = max_p s_p,   l = sum_p exp(s_p - m),
//   acc = sum_p bf16(exp(s_p - m) * vs_p) * v_codes[p],
//   s_p = (q . k_codes[p]) * (ks_p * sm_scale)
// for the rep query heads of h at once.  A row with no live position gets
// the same sentinel as the TPU kernel: m = -1e30, l = 0, acc = 0 (a -inf
// would turn the caller's fold with the current token into NaN).
//
// Bound on the H100: the live K/V code bytes plus their f32 scales (the
// cache is int8; q and the outputs are a few KB).  Design:
//   * the cache is the STACKED buffer [L, B, Hkv, S, D] and the layer is a
//     pointer offset, so no per-layer copy is ever made;
//   * the grid is (B * Hkv, S / 256): each block takes one 256-position
//     chunk of one (b, h) and returns at once if the chunk holds no live
//     position, so dead chunks cost no reads;
//   * the rep query heads share every K/V load: a group of D / 16 lanes
//     reads one cache row, 16 dims a lane (kv8: 16 bytes; kv4: 8 bytes),
//     and forms all rep dots, so a lane holds the same registers at head
//     dim 128 (8 lanes a row, 4 rows a warp) and 256 (16 lanes, 2 rows a
//     warp); REP and D are template arguments, instantiated for every rep
//     from 1 to 8 at D 128 and 256 (the 4 warps take the chunk softmax's
//     rows r, r + 4, ..., so an odd REP leaves some warps a row fewer; the
//     scores and the warp reduction take REP KB + 4 REP D / 256 KB of
//     static shared memory: 40 KB at REP 8, D 256);
//   * per-chunk (m, l, acc) partials are merged by a second small kernel
//     that reads only the live chunks.
// Products: bf16 q times int8 codes (exact) with f32 sums, probabilities
// scaled by the V scale and rounded to bf16 before the PV sum, as the TPU
// kernel does.
//
// kv4 (quant/kv_cache.py): codes [L, B, Hkv, S/2, D] uint8, where row t
// holds position 2t's D/2 bytes then position 2t+1's, and byte j of a
// position holds dim j in its low nibble and dim j + D/2 in its high one,
// each plus 8; scales [L, B, Hkv, 2, S/2] with position p at [p % 2, p / 2].
// A position is half the bytes of kv8: each of the D / 16 lanes on a row
// reads 8 bytes (dims 8g .. 8g+7 and D/2+8g .. D/2+8g+7) and subtracts the
// offset in registers, so the code values are the exact integers (c - 8)
// the TPU kernel folds in as -8 sum(q) and -8 sum(pv).  Everything else is
// the kv8 kernel.
//
// V1 (pq_decode_attn) replaces piquant_tpu/ops/pallas/attention.py::
// _decode_attn_kernel, the first flash-decode kernel: one layer's kv8 cache
// [B, Hkv, S, D] (a stacked cache of one layer: layer 0), every position
// 0 <= p <= pos[b] live (the current token is already in the cache), and
// the NORMALIZED context acc / l.  The chunk kernel runs with start 0 and
// the inclusive end; the merge divides.  The TPU kernel walks 512-position
// chunks in order with an online softmax; here the 256-position chunks run
// in parallel and the merge rescales them, so the probabilities are rounded
// to bf16 against other running maxima (the same function within those
// roundings).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 256;               // cache positions per block
constexpr int kThreads = 128;             // 4 warps
constexpr float kNegInf = -1e30f;

// Lanes on one cache row (16 dims each), position groups in flight, and the
// positions each group takes of a chunk, at head dim D.
template <int D>
struct Geom {
  static constexpr int kLanes = D / 16;
  static constexpr int kGroups = kThreads / kLanes;
  static constexpr int kPerGroup = kChunk / kGroups;
};

__device__ __forceinline__ void codes16(const int8_t* p, float* out) {
  const int4 raw = *reinterpret_cast<const int4*>(p);
  const int words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[i * 4 + j] = (float)(int8_t)((words[i] >> (8 * j)) & 0xff);
}

// kv4: 8 bytes of one position -> out[0..7] the low nibbles (dims 8g..),
// out[8..15] the high ones (dims D/2+8g..), each minus the offset 8.
__device__ __forceinline__ void nibbles16(const uint8_t* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const uint32_t words[2] = {raw.x, raw.y};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t byte = (words[i] >> (8 * j)) & 0xffu;
      out[i * 4 + j] = (float)((int)(byte & 15u) - 8);
      out[8 + i * 4 + j] = (float)((int)(byte >> 4) - 8);
    }
}

// Head dim of element j (0..15) of lane group slice g (0..D/16-1).
template <bool KV4, int D>
__device__ __forceinline__ int dim_of(int g, int j) {
  if constexpr (KV4) return j < 8 ? g * 8 + j : D / 2 + g * 8 + (j - 8);
  return g * 16 + j;
}

// Element offset of position p's codes for lane group slice g, and of its
// scale, within one (layer, b, h) of the stacked cache (s_len positions).
template <bool KV4, int D>
__device__ __forceinline__ size_t code_at(int p, int g) {
  if constexpr (KV4) return (size_t)(p / 2) * D + (p % 2) * (D / 2) + g * 8;
  return (size_t)p * D + g * 16;
}

template <bool KV4>
__device__ __forceinline__ size_t scale_at(int p, int s_len) {
  if constexpr (KV4) return (size_t)(p % 2) * (s_len / 2) + p / 2;
  return (size_t)p;
}

template <bool KV4>
__device__ __forceinline__ void load16(const void* base, size_t off,
                                       float* out) {
  if constexpr (KV4) {
    nibbles16(static_cast<const uint8_t*>(base) + off, out);
  } else {
    codes16(static_cast<const int8_t*>(base) + off, out);
  }
}

template <int REP, bool KV4, int D, bool V1>
__global__ void __launch_bounds__(kThreads)
decode_attn2_chunk(const __nv_bfloat16* __restrict__ q,   // [B,H,REP,D]
                   const void* __restrict__ kc,   // [L,B,H,S,D] / [L,B,H,S/2,D]
                   const float* __restrict__ ks,  // [L,B,H,S] / [L,B,H,2,S/2]
                   const void* __restrict__ vc,
                   const float* __restrict__ vs,
                   const int* __restrict__ pos,           // [B]
                   const int* __restrict__ start,         // [B]
                   float* __restrict__ part_acc,          // [B,H,nsplit,REP,D]
                   float* __restrict__ part_ml,           // [B,H,nsplit,REP,2]
                   int layer, int nb, int nh, int s_len, float sm_scale) {
  __shared__ float sc[REP][kChunk];
  __shared__ float red[4][REP][D];
  constexpr int kLanes = Geom<D>::kLanes, kGroups = Geom<D>::kGroups;
  constexpr int kPerGroup = Geom<D>::kPerGroup;
  __shared__ float row_m[REP];

  const int bh = blockIdx.x;
  const int b = bh / nh;
  const int split = blockIdx.y;
  const int nsplit = gridDim.y;
  const int c0 = split * kChunk;
  // V1: positions 0 .. pos inclusive
  const int lo = V1 ? c0 : max(start[b], c0);
  const int hi = min(min(V1 ? pos[b] + 1 : pos[b], s_len), c0 + kChunk);
  if (lo >= hi) return;   // dead chunk: the merge kernel skips it

  // (layer, b, h) slab: s_len positions of codes (D bytes each for kv8,
  // D / 2 for kv4) and s_len scales
  const size_t lbh = (size_t)layer * nb * nh + bh;
  const size_t code0 = lbh * s_len * (KV4 ? D / 2 : D);
  const size_t scale0 = lbh * s_len;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gl = lane % kLanes;                          // 16-dim slice
  const int grp = warp * (32 / kLanes) + lane / kLanes;  // position group

  // ---- scores: s[r][p] for the live positions of the chunk ------------
  {
    float qf[REP][16];
#pragma unroll
    for (int r = 0; r < REP; ++r)
#pragma unroll
      for (int j = 0; j < 16; ++j)
        qf[r][j] = __bfloat162float(
            q[((size_t)bh * REP + r) * D + dim_of<KV4, D>(gl, j)]);
#pragma unroll 4
    for (int i = 0; i < kPerGroup; ++i) {
      const int p = c0 + grp + kGroups * i;
      const bool live = p >= lo && p < hi;
      float dot[REP];
#pragma unroll
      for (int r = 0; r < REP; ++r) dot[r] = 0.f;
      if (live) {
        float kf[16];
        load16<KV4>(kc, code0 + code_at<KV4, D>(p, gl), kf);
#pragma unroll
        for (int r = 0; r < REP; ++r)
#pragma unroll
          for (int j = 0; j < 16; ++j) dot[r] = fmaf(qf[r][j], kf[j], dot[r]);
      }
#pragma unroll
      for (int r = 0; r < REP; ++r)
#pragma unroll
        for (int off = kLanes / 2; off > 0; off >>= 1)
          dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], off);
      if (gl == 0) {
        const float kscale =
            live ? ks[scale0 + scale_at<KV4>(p, s_len)] * sm_scale : 0.f;
#pragma unroll
        for (int r = 0; r < REP; ++r)
          sc[r][p - c0] = live ? dot[r] * kscale : kNegInf;
      }
    }
  }
  __syncthreads();

  // ---- chunk softmax: m, l, and bf16(p * vs) in place of the scores ----
  for (int r = warp; r < REP; r += 4) {
    float mx = kNegInf;
    for (int j = lane; j < kChunk; j += 32) mx = fmaxf(mx, sc[r][j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int j = lane; j < kChunk; j += 32) {
      const int p = c0 + j;
      const bool live = p >= lo && p < hi;
      const float e = live ? expf(sc[r][j] - mx) : 0.f;
      sum += e;
      sc[r][j] = live ? __bfloat162float(__float2bfloat16(
                            e * vs[scale0 + scale_at<KV4>(p, s_len)]))
                      : 0.f;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      row_m[r] = mx;
      float* ml = part_ml + (((size_t)bh * nsplit + split) * REP + r) * 2;
      ml[0] = mx;
      ml[1] = sum;
    }
  }
  __syncthreads();

  // ---- PV: acc[r][d] = sum_p pv[r][p] * v_codes[p][d] ------------------
  float acc[REP][16];
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[r][j] = 0.f;
#pragma unroll 4
  for (int i = 0; i < kPerGroup; ++i) {
    const int p = c0 + grp + kGroups * i;
    if (p < lo || p >= hi) continue;
    float vf[16];
    load16<KV4>(vc, code0 + code_at<KV4, D>(p, gl), vf);
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float pv = sc[r][p - c0];
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[r][j] = fmaf(pv, vf[j], acc[r][j]);
    }
  }
  // the groups of a warp hold the same dims: fold them by shuffles, then
  // the 4 warps through shared memory
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int off = kLanes; off < 32; off <<= 1)
        acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], off);
  if (lane < kLanes) {
#pragma unroll
    for (int r = 0; r < REP; ++r)
#pragma unroll
      for (int j = 0; j < 16; ++j) red[warp][r][dim_of<KV4, D>(gl, j)] = acc[r][j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < REP * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const float s = red[0][r][d] + red[1][r][d] + red[2][r][d] + red[3][r][d];
    part_acc[(((size_t)bh * nsplit + split) * REP + r) * D + d] = s;
  }
}

// Merge the live chunks of each (b, h): one block per (b, h), one thread
// per head dim.  V1 writes the normalized context acc / l into `acc` and
// no m or l.
template <int REP, int D, bool V1>
__global__ void decode_attn2_merge(const float* __restrict__ part_acc,
                                   const float* __restrict__ part_ml,
                                   const int* __restrict__ pos,
                                   const int* __restrict__ start,
                                   float* __restrict__ acc,   // [B,H,REP,D]
                                   float* __restrict__ m_out, // [B,H,REP]
                                   float* __restrict__ l_out,
                                   int nh, int nsplit, int s_len) {
  const int bh = blockIdx.x;
  const int b = bh / nh;
  const int d = threadIdx.x;
  const int lo = V1 ? 0 : start[b];
  const int hi = min(V1 ? pos[b] + 1 : pos[b], s_len);
  for (int r = 0; r < REP; ++r) {
    float m = kNegInf;
    for (int sp = 0; sp < nsplit; ++sp) {
      const int c0 = sp * kChunk;
      if (max(lo, c0) >= min(hi, c0 + kChunk)) continue;
      m = fmaxf(m, part_ml[(((size_t)bh * nsplit + sp) * REP + r) * 2]);
    }
    float l = 0.f, a = 0.f;
    for (int sp = 0; sp < nsplit; ++sp) {
      const int c0 = sp * kChunk;
      if (max(lo, c0) >= min(hi, c0 + kChunk)) continue;
      const size_t i = ((size_t)bh * nsplit + sp) * REP + r;
      const float e = expf(part_ml[i * 2] - m);
      l += part_ml[i * 2 + 1] * e;
      a += part_acc[i * D + d] * e;
    }
    if (V1) {
      acc[((size_t)bh * REP + r) * D + d] = a / l;
      continue;
    }
    acc[((size_t)bh * REP + r) * D + d] = a;
    if (d == 0) {
      m_out[(size_t)bh * REP + r] = m;
      l_out[(size_t)bh * REP + r] = l;
    }
  }
}

template <int REP, bool KV4, int D, bool V1>
void launch(const void* q, const void* kc, const void* ks, const void* vc,
            const void* vs, const void* pos, const void* start, void* acc,
            void* m, void* l, void* part_acc, void* part_ml, int layer,
            int nb, int nh, int s_len, float sm_scale, cudaStream_t st) {
  const int nsplit = (s_len + kChunk - 1) / kChunk;
  decode_attn2_chunk<REP, KV4, D, V1><<<dim3(nb * nh, nsplit), kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), kc,
      static_cast<const float*>(ks), vc,
      static_cast<const float*>(vs), static_cast<const int*>(pos),
      static_cast<const int*>(start), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), layer, nb, nh, s_len, sm_scale);
  decode_attn2_merge<REP, D, V1><<<nb * nh, D, 0, st>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<const int*>(pos), static_cast<const int*>(start),
      static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l),
      nh, nsplit, s_len);
}

template <bool KV4, int D, bool V1>
int dispatch(const void* q, const void* kc, const void* ks, const void* vc,
             const void* vs, const void* pos, const void* start, void* acc,
             void* m, void* l, void* part_acc, void* part_ml, int layer,
             int nb, int nh, int rep, int s_len, float sm_scale,
             cudaStream_t st) {
  switch (rep) {
    case 1: launch<1, KV4, D, V1>(q, kc, ks, vc, vs, pos, start, acc, m, l, part_acc, part_ml, layer, nb, nh, s_len, sm_scale, st); break;
    case 2: launch<2, KV4, D, V1>(q, kc, ks, vc, vs, pos, start, acc, m, l, part_acc, part_ml, layer, nb, nh, s_len, sm_scale, st); break;
    case 3: launch<3, KV4, D, V1>(q, kc, ks, vc, vs, pos, start, acc, m, l, part_acc, part_ml, layer, nb, nh, s_len, sm_scale, st); break;
    case 4: launch<4, KV4, D, V1>(q, kc, ks, vc, vs, pos, start, acc, m, l, part_acc, part_ml, layer, nb, nh, s_len, sm_scale, st); break;
    case 5: launch<5, KV4, D, V1>(q, kc, ks, vc, vs, pos, start, acc, m, l, part_acc, part_ml, layer, nb, nh, s_len, sm_scale, st); break;
    case 6: launch<6, KV4, D, V1>(q, kc, ks, vc, vs, pos, start, acc, m, l, part_acc, part_ml, layer, nb, nh, s_len, sm_scale, st); break;
    case 7: launch<7, KV4, D, V1>(q, kc, ks, vc, vs, pos, start, acc, m, l, part_acc, part_ml, layer, nb, nh, s_len, sm_scale, st); break;
    case 8: launch<8, KV4, D, V1>(q, kc, ks, vc, vs, pos, start, acc, m, l, part_acc, part_ml, layer, nb, nh, s_len, sm_scale, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <bool KV4, bool V1>
int dispatch_d(const void* q, const void* kc, const void* ks, const void* vc,
               const void* vs, const void* pos, const void* start, void* acc,
               void* m, void* l, void* part_acc, void* part_ml, int layer,
               int nb, int nh, int rep, int s_len, int d, float sm_scale,
               void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (d == 128)
    return dispatch<KV4, 128, V1>(q, kc, ks, vc, vs, pos, start, acc, m, l,
                              part_acc, part_ml, layer, nb, nh, rep, s_len,
                              sm_scale, st);
  if (d == 256)
    return dispatch<KV4, 256, V1>(q, kc, ks, vc, vs, pos, start, acc, m, l,
                              part_acc, part_ml, layer, nb, nh, rep, s_len,
                              sm_scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q [B,H,rep,D] bf16; k/v codes [L,B,H,S,D] int8; k/v scales [L,B,H,S] f32;
// pos/start [B] int32; outputs acc [B,H,rep,D], m/l [B,H,rep] f32; scratch
// part_acc [B,H,ceil(S/256),rep,D], part_ml [B,H,ceil(S/256),rep,2].  D must
// be 128 or 256, rep 1 to 8.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for an unsupported D or rep.
extern "C" int pq_decode_attn2(const void* q, const void* kc, const void* ks,
                               const void* vc, const void* vs, const void* pos,
                               const void* start, void* acc, void* m, void* l,
                               void* part_acc, void* part_ml, int layer,
                               int nb, int nh, int rep, int s_len, int d,
                               float sm_scale, void* stream) {
  return dispatch_d<false, false>(q, kc, ks, vc, vs, pos, start, acc, m, l, part_acc,
                           part_ml, layer, nb, nh, rep, s_len, d, sm_scale,
                           stream);
}

// As pq_decode_attn2 over the kv4 cache: k/v codes [L,B,H,S/2,D] uint8
// (pair-packed), k/v scales [L,B,H,2,S/2] f32; s_len (even) in positions.
extern "C" int pq_decode_attn2_kv4(const void* q, const void* kc,
                                   const void* ks, const void* vc,
                                   const void* vs, const void* pos,
                                   const void* start, void* acc, void* m,
                                   void* l, void* part_acc, void* part_ml,
                                   int layer, int nb, int nh, int rep,
                                   int s_len, int d, float sm_scale,
                                   void* stream) {
  return dispatch_d<true, false>(q, kc, ks, vc, vs, pos, start, acc, m, l, part_acc,
                          part_ml, layer, nb, nh, rep, s_len, d, sm_scale,
                          stream);
}

// The first flash-decode kernel's function (V1): q [B,H,rep,D] bf16, one
// layer's kv8 cache, codes [B,H,S,D] int8 and scales [B,H,S] f32, pos [B]
// int32 (positions 0 .. pos inclusive attend) -> ctx [B,H,rep,D] f32, the
// normalized context; scratch part_acc / part_ml as pq_decode_attn2's.
// D 128 or 256, rep 1 to 8.
extern "C" int pq_decode_attn(const void* q, const void* kc, const void* ks,
                              const void* vc, const void* vs, const void* pos,
                              void* ctx, void* part_acc, void* part_ml,
                              int nb, int nh, int rep, int s_len, int d,
                              float sm_scale, void* stream) {
  return dispatch_d<false, true>(q, kc, ks, vc, vs, pos, pos, ctx, nullptr,
                                 nullptr, part_acc, part_ml, 0, nb, nh, rep,
                                 s_len, d, sm_scale, stream);
}
