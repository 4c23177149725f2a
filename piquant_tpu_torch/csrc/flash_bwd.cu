// flash_bwd: the backward of flash prefill attention (csrc/flash.cu) under
// the causal mask, the sliding window and Llama-4's chunk, at head_dim 128
// and any GQA rep, in three kernels:
//   (a) flash_bwd_delta: dO rounded to bf16 for the products, and delta[i]
//       = sum_d dO[i, d] O[i, d] in f32 of that rounded dO for each query
//       row (as the shipped kernel's di and dP read one dO: the rounding
//       then moves dP - delta by dO's error . (v[j] - O[i]), where the
//       part of v common to the keys cancels);
//   (b) flash_bwd_dkv: dK and dV of one (b, kv head, 64-key tile) a block,
//       summed over the rep query heads of the kv head in the block;
//   (c) flash_bwd_dq: dQ of one (b, query head, 64-row tile) a block.
//
// Replaces the backward of the JAX-shipped TPU flash kernel that
// piquant_tpu/ops/flash_prefill.py:105 calls for plain causal masks: the
// custom_vjp of jax/experimental/pallas/ops/tpu/flash_attention.py (:204,
// defvjp :318), whose _flash_attention_bwd_dkv (:941, pallas_call :1121)
// and _flash_attention_bwd_dq (:1287, pallas_call :1456) these follow.
// The reference repeats K/V to the query heads and lets the repeat's VJP
// sum dK / dV over them; (b) sums the rep heads itself, in a fixed order
// and with no atomics, so the gradients are deterministic.
//
// With s[i, j] = q[i] . k[j] * scale and lse[i] the forward's row
// log-sum-exp of s (flash.cu's lse output), on the live pairs (the mask
// the forward applies: start(i) <= j <= i, start(i) 0 causally, i - (w -
// 1) under a window w, ((p0 + i) / C) C - p0 under a chunk C):
//   P = exp(s - lse[i]) (0 off the live pairs), recomputed from Q and K
//   dV[j] = sum_i P[i, j] dO[i]               bf16 P and dO, f32 sums
//   dP[i, j] = dO[i] . v[j]                    bf16 dO, f32 sums
//   dS = P (dP - delta[i])                     f32
//   dK[j] = scale sum_i dS[i, j] q[i]          bf16 dS, f32 sums
//   dQ[i] = scale sum_j dS[i, j] k[j]          bf16 dS, f32 sums
// the shipped kernel's recipe (bf16 operands, f32 accumulation, P from
// the saved statistics).  dQ, dK, dV are written in f32.
//
// Bound on the H100: five T^2 products (S, dP, dV, dK, dQ: 10 D operations
// a live pair) at the 989 TFLOP/s bf16 peak against the forward's two,
// 0.174 ms at B 8, Hkv 8, rep 4, T 1024; (b) recomputes S and dP, (c)
// recomputes them again (seven products).  The design is the simple one:
// warp-level m16n8k16 MMA (mma.sync) on ldmatrix fragments of 64 x 128
// bf16 tiles in shared memory under a 16-byte XOR swizzle (conflict-free
// ldmatrix), four warps of 16 rows a block, a two-stage cp.async ring of
// the walked tiles, every element masked by the same predicates as the
// forward.  wgmma and TMA are later work.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pq_mma.cuh"

namespace {

using namespace pq;

constexpr int D = 128;
constexpr int kTile = 64;                    // rows of a tile (keys or queries)
constexpr int kThreads = 128;                // four warps of 16 rows
constexpr int kRowBytes = D * 2;
constexpr int kTileBytes = kTile * kRowBytes;  // 16 KB
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kCausal = 0, kWindow = 1, kChunk = 2;
// (b): K, V, two stages of Q and dO, two of lse and delta; (c): Q, dO, two
// stages of K and V
constexpr int kDkvSmem = 6 * kTileBytes + 4 * kTile * 4;
constexpr int kDqSmem = 6 * kTileBytes;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// byte offset of 16-byte chunk c of row r in a tile: the chunk index XOR
// the row's low 3 bits, so the 8 rows an ldmatrix reads hit 8 bank groups
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * kRowBytes + ((c ^ (r & 7)) << 4);
}

// rows row0 .. row0 + 63 of a [rows, D] bf16 matrix into a tile, zeros
// past `rows` (cp.async, one commit group of the caller's)
__device__ __forceinline__ void load_tile(uint8_t* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int rows) {
  for (int i = threadIdx.x; i < kTile * 16; i += kThreads) {
    const int r = i >> 4, c = i & 15;
    const bool on = row0 + r < rows;
    cp_async16(dst + swz(r, c), src + (size_t)(on ? row0 + r : 0) * D + c * 8,
               on);
  }
}

// the A fragment of rows r0 .. r0 + 15, columns 16 kk .. 16 kk + 15
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], uint32_t tile,
                                       int r0, int kk, int lane) {
  ldsm_x4(a, tile + swz(r0 + (lane & 15), 2 * kk + (lane >> 4)));
}

// B fragments of the n8 tiles n0 and n0 + 8 where the tile's rows are N
// and its columns K (columns 16 kk ..): b[0..1] for n0, b[2..3] for n0 + 8
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], uint32_t tile,
                                       int n0, int kk, int lane) {
  const int m = lane >> 3, r = lane & 7;
  ldsm_x4(b, tile + swz(n0 + r + 8 * (m >> 1), 2 * kk + (m & 1)));
}

// B fragments where the tile's rows are K (rows 16 kk ..) and its columns N:
// the n8 tiles of 16-byte chunks c and c + 1
__device__ __forceinline__ void frag_bt(uint32_t (&b)[4], uint32_t tile,
                                        int kk, int c, int lane) {
  const int m = lane >> 3, r = lane & 7;
  ldsm_x4_trans(b, tile + swz(16 * kk + r + 8 * (m & 1), c + (m >> 1)));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  mma16816(c, a[0], a[1], a[2], a[3], b0, b1);
}

// accumulator n8 tiles 2 kk and 2 kk + 1 (16 columns) as the A fragment of
// the k16 step kk of the next product, rounded to bf16
__device__ __forceinline__ void acc_as_a(uint32_t (&a)[4],
                                         const float (&x)[8][4], int kk) {
  a[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
  a[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
  a[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
  a[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
}

// The forward's mask: key j is live for query i when start(i) <= j <= i < t.
struct Mask {
  int mode, window, chunk, p0, t;
  __device__ __forceinline__ int start(int i) const {
    if (mode == kWindow) return i - (window - 1);
    if (mode == kChunk) return (p0 + i) / chunk * chunk - p0;
    return 0;
  }
  __device__ __forceinline__ bool live(int i, int j) const {
    return i < t && j <= i && j >= start(i);
  }
};

// S = A B^T and dP = A' B'^T of a warp's 16 rows against a tile's 64 rows:
// a, a2 the warp's row tiles, b, b2 the walked tiles (rows N, columns K)
__device__ __forceinline__ void two_products(float (&s)[8][4],
                                             float (&dp)[8][4], uint32_t a_t,
                                             uint32_t a2_t, uint32_t b_t,
                                             uint32_t b2_t, int r0,
                                             int lane) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4], a2[4];
    frag_a(a, a_t, r0, kk, lane);
    frag_a(a2, a2_t, r0, kk, lane);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      frag_b(b, b_t, 16 * np, kk, lane);
      mma(s[2 * np], a, b[0], b[1]);
      mma(s[2 * np + 1], a, b[2], b[3]);
      frag_b(b, b2_t, 16 * np, kk, lane);
      mma(dp[2 * np], a2, b[0], b[1]);
      mma(dp[2 * np + 1], a2, b[2], b[3]);
    }
  }
}

// (a): one warp a row of D = 128 values, four a lane
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const float* __restrict__ o,
                       const float* __restrict__ dout,
                       float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dob, int64_t rows) {
  const int64_t r = (int64_t)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const float4 a = reinterpret_cast<const float4*>(o + r * D)[lane];
  const float4 b = reinterpret_cast<const float4*>(dout + r * D)[lane];
  const uint2 bb = make_uint2(pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
  const float2 b01 = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&bb.x));
  const float2 b23 = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&bb.y));
  float s = a.x * b01.x + a.y * b01.y + a.z * b23.x + a.w * b23.y;
  reinterpret_cast<uint2*>(dob + r * D)[lane] = bb;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[r] = s;
}

// (b): block (key tile x, kv head row y = b * nh + h).  Warp w owns keys
// j0 + 16 w .. + 15 and computes S^T = K Q^T and dP^T = V dO^T (rows keys,
// columns the tile's queries), so P^T and dS^T sit in its registers as the
// A fragments of dV += P^T dO and dK += dS^T Q.  It walks the rep heads of
// the kv head and, for each, the query tiles from the diagonal to the last
// query that sees a key of the tile.
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dob,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv,
                     const int* __restrict__ pos0, int nh, int rep, int t,
                     int mode, int window, int chunk, float sm_scale) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* const ks = smem;
  uint8_t* const vs = ks + kTileBytes;
  uint8_t* const qs = vs + kTileBytes;            // two stages
  uint8_t* const os = qs + 2 * kTileBytes;        // two stages of dO
  float* const ls = reinterpret_cast<float*>(os + 2 * kTileBytes);
  float* const dls = ls + 2 * kTile;
  const int bh = blockIdx.y, j0 = blockIdx.x * kTile;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const Mask mk{mode, window, chunk,
                mode == kChunk ? __ldg(pos0 + bh / nh) : 0, t};
  // the queries that see a key of the tile: from its first key to the
  // last key's last query
  const int jl = min(t, j0 + kTile) - 1;
  int i_end = t;
  if (mode == kWindow) i_end = min(t, jl + window);
  if (mode == kChunk)
    i_end = min(t, ((mk.p0 + jl) / chunk + 1) * chunk - mk.p0);
  const int qt0 = blockIdx.x, nqt = (i_end + kTile - 1) / kTile - qt0;
  const int iters = nqt * rep;
  const size_t kv = (size_t)bh * t;

  auto load = [&](int it, int st) {
    const int i0 = (qt0 + it % nqt) * kTile;
    const size_t row = ((size_t)bh * rep + it / nqt) * t;
    load_tile(qs + st * kTileBytes, q + row * D, i0, t);
    load_tile(os + st * kTileBytes, dob + row * D, i0, t);
    const int x = threadIdx.x & (kTile - 1);
    const int i = min(i0 + x, t - 1);     // rows past t are masked
    if (threadIdx.x < kTile) cp_async4(ls + st * kTile + x, lse + row + i);
    else cp_async4(dls + st * kTile + x, delta + row + i);
  };
  load_tile(ks, k + kv * D, j0, t);
  load_tile(vs, v + kv * D, j0, t);
  load(0, 0);
  cp_async_commit();

  float dka[16][4], dva[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  const float scale_l2 = sm_scale * kLog2e;
  const uint32_t kt = smem_u32(ks), vt = smem_u32(vs);

  for (int it = 0; it < iters; ++it) {
    const int st = it & 1;
    if (it + 1 < iters) load(it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint32_t qt = smem_u32(qs + st * kTileBytes);
    const uint32_t ot = smem_u32(os + st * kTileBytes);
    const float* const lr = ls + st * kTile;
    const float* const dr = dls + st * kTile;
    const int i0 = (qt0 + it % nqt) * kTile;

    float s[8][4], dp[8][4];
    two_products(s, dp, kt, vt, qt, ot, 16 * w, lane);
    // P^T and dS^T: s[n][e] is key j0 + 16 w + g (+ 8 for e >= 2), query
    // i0 + 8 n + 2 tq + (e & 1)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * tq + (e & 1);
        const int j = j0 + 16 * w + g + ((e >> 1) << 3);
        const float p = mk.live(i0 + c, j)
                            ? ex2(s[n][e] * scale_l2 - lr[c] * kLog2e)
                            : 0.f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - dr[c]);
      }
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t pa[4], sa[4];
      acc_as_a(pa, s, kk);
      acc_as_a(sa, dp, kk);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        uint32_t b[4];
        frag_bt(b, ot, kk, 2 * c, lane);
        mma(dva[2 * c], pa, b[0], b[1]);
        mma(dva[2 * c + 1], pa, b[2], b[3]);
        frag_bt(b, qt, kk, 2 * c, lane);
        mma(dka[2 * c], sa, b[0], b[1]);
        mma(dka[2 * c + 1], sa, b[2], b[3]);
      }
    }
    __syncthreads();   // stage st is refilled at it + 1
  }
  cp_async_wait_all();

  const int ja = j0 + 16 * w + g, jb = ja + 8;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const int c = 8 * n + 2 * tq;
    if (ja < t) {
      *reinterpret_cast<float2*>(dk + (kv + ja) * D + c) =
          make_float2(dka[n][0] * sm_scale, dka[n][1] * sm_scale);
      *reinterpret_cast<float2*>(dv + (kv + ja) * D + c) =
          make_float2(dva[n][0], dva[n][1]);
    }
    if (jb < t) {
      *reinterpret_cast<float2*>(dk + (kv + jb) * D + c) =
          make_float2(dka[n][2] * sm_scale, dka[n][3] * sm_scale);
      *reinterpret_cast<float2*>(dv + (kv + jb) * D + c) =
          make_float2(dva[n][2], dva[n][3]);
    }
  }
}

// (c): block (query tile, query head row y = (b * nh + h) * rep + r), the
// heaviest tiles (the last rows) first.  Warp w owns rows i0 + 16 w .. +
// 15, computes S = Q K^T and dP = dO V^T against each key tile from the
// tile's first row start to its diagonal, and dQ += dS K.
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dob,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    const int* __restrict__ pos0, int nh, int rep, int t,
                    int mode, int window, int chunk, float sm_scale) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* const qs = smem;
  uint8_t* const os = qs + kTileBytes;
  uint8_t* const ks = os + kTileBytes;            // two stages
  uint8_t* const vs = ks + 2 * kTileBytes;        // two stages
  const int row = blockIdx.y, bh = row / rep;
  const int i0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const Mask mk{mode, window, chunk,
                mode == kChunk ? __ldg(pos0 + bh / nh) : 0, t};
  // key tiles from the first row's start (starts never decrease) to the
  // last row's diagonal
  const int kt0 = max(0, mk.start(i0)) / kTile;
  const int kt1 = (min(t, i0 + kTile) - 1) / kTile + 1;
  const size_t qrow = (size_t)row * t, kv = (size_t)bh * t;

  load_tile(qs, q + qrow * D, i0, t);
  load_tile(os, dob + qrow * D, i0, t);
  load_tile(ks, k + kv * D, kt0 * kTile, t);
  load_tile(vs, v + kv * D, kt0 * kTile, t);
  cp_async_commit();
  const int ia = i0 + 16 * w + g, ib = ia + 8;
  const float la = lse[qrow + min(ia, t - 1)] * kLog2e;
  const float lb = lse[qrow + min(ib, t - 1)] * kLog2e;
  const float da = delta[qrow + min(ia, t - 1)];
  const float db = delta[qrow + min(ib, t - 1)];

  float dqa[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;
  const float scale_l2 = sm_scale * kLog2e;
  const uint32_t qt = smem_u32(qs), ot = smem_u32(os);

  for (int kt = kt0; kt < kt1; ++kt) {
    const int st = (kt - kt0) & 1;
    if (kt + 1 < kt1) {
      load_tile(ks + (st ^ 1) * kTileBytes, k + kv * D, (kt + 1) * kTile, t);
      load_tile(vs + (st ^ 1) * kTileBytes, v + kv * D, (kt + 1) * kTile, t);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint32_t kst = smem_u32(ks + st * kTileBytes);
    const uint32_t vst = smem_u32(vs + st * kTileBytes);

    float s[8][4], dp[8][4];
    two_products(s, dp, qt, ot, kst, vst, 16 * w, lane);
    // s[n][e] is query ia (e < 2) or ib, key kt * 64 + 8 n + 2 tq + (e & 1)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = kt * kTile + 8 * n + 2 * tq + (e & 1);
        const bool hi = e >> 1;
        const float p = mk.live(hi ? ib : ia, j)
                            ? ex2(s[n][e] * scale_l2 - (hi ? lb : la))
                            : 0.f;
        dp[n][e] = p * (dp[n][e] - (hi ? db : da));
      }
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t sa[4];
      acc_as_a(sa, dp, kk);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        uint32_t b[4];
        frag_bt(b, kst, kk, 2 * c, lane);
        mma(dqa[2 * c], sa, b[0], b[1]);
        mma(dqa[2 * c + 1], sa, b[2], b[3]);
      }
    }
    __syncthreads();   // stage st is refilled at kt + 1
  }
  cp_async_wait_all();

#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const int c = 8 * n + 2 * tq;
    if (ia < t)
      *reinterpret_cast<float2*>(dq + (qrow + ia) * D + c) =
          make_float2(dqa[n][0] * sm_scale, dqa[n][1] * sm_scale);
    if (ib < t)
      *reinterpret_cast<float2*>(dq + (qrow + ib) * D + c) =
          make_float2(dqa[n][2] * sm_scale, dqa[n][3] * sm_scale);
  }
}

// the forward's mode: a chunk, a window below t, or the plain causal mask;
// -1 for arguments the kernels do not take
int mode_of(int nb, int nh, int rep, int t, int window, int chunk, int d,
            const void* pos0) {
  if (d != D || nb < 1 || nh < 1 || rep < 1 || t < 1 || window < 1 ||
      chunk < 0)
    return -1;
  if (chunk > 0) return window >= t && pos0 != nullptr ? kChunk : -1;
  return window < t ? kWindow : kCausal;
}

}  // namespace

// o, dout [rows, 128] f32 -> delta [rows] f32 (the rows' dO . O) and dob
// [rows, 128] bf16 (dO rounded).  Returns cudaGetLastError().
extern "C" int pq_flash_bwd_delta(const void* o, const void* dout,
                                  void* delta, void* dob, int64_t rows,
                                  void* stream) {
  if (rows < 1) return (int)cudaErrorInvalidValue;
  flash_bwd_delta_kernel<<<(unsigned)((rows + 7) / 8), 256, 0,
                           reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(dout),
      static_cast<float*>(delta), static_cast<__nv_bfloat16*>(dob), rows);
  return (int)cudaGetLastError();
}

// q [B,H,rep,T,128] bf16, k/v [B,H,T,128] bf16, dob [B,H,rep,T,128] bf16,
// lse / delta [B,H,rep,T] f32 -> dk, dv [B,H,T,128] f32; the mask as
// pq_flash_prefill's (window T: causal; a chunk > 0 with window T and pos0
// [B] int32 on the device).  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a head_dim other than 128 or another
// unsupported argument.
extern "C" int pq_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dob, const void* lse,
                                const void* delta, void* dk, void* dv,
                                const void* pos0, int nb, int nh, int rep,
                                int t, int window, int chunk, int d,
                                float sm_scale, void* stream) {
  const int mode = mode_of(nb, nh, rep, t, window, chunk, d, pos0);
  if (mode < 0 || nb * nh > 65535) return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kDkvSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((t + kTile - 1) / kTile, nb * nh);
  flash_bwd_dkv_kernel<<<grid, kThreads, kDkvSmem,
                         reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dob), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk),
      static_cast<float*>(dv), static_cast<const int*>(pos0), nh, rep, t,
      mode, window, chunk, sm_scale);
  return (int)cudaGetLastError();
}

// The same inputs -> dq [B,H,rep,T,128] f32.
extern "C" int pq_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dob, const void* lse,
                               const void* delta, void* dq, const void* pos0,
                               int nb, int nh, int rep, int t, int window,
                               int chunk, int d, float sm_scale,
                               void* stream) {
  const int mode = mode_of(nb, nh, rep, t, window, chunk, d, pos0);
  if (mode < 0 || (int64_t)nb * nh * rep > 65535)
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kDqSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((t + kTile - 1) / kTile, nb * nh * rep);
  flash_bwd_dq_kernel<<<grid, kThreads, kDqSmem,
                        reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dob), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq),
      static_cast<const int*>(pos0), nh, rep, t, mode, window, chunk,
      sm_scale);
  return (int)cudaGetLastError();
}

// Registers, local (spill) bytes and dynamic shared memory of kernel
// `which` (0 delta, 1 dkv, 2 dq) into out[3].
extern "C" int pq_flash_bwd_attributes(int which, int* out) {
  cudaFuncAttributes a;
  cudaError_t err;
  if (which == 0) err = cudaFuncGetAttributes(&a, flash_bwd_delta_kernel);
  else if (which == 1) err = cudaFuncGetAttributes(&a, flash_bwd_dkv_kernel);
  else if (which == 2) err = cudaFuncGetAttributes(&a, flash_bwd_dq_kernel);
  else return (int)cudaErrorInvalidValue;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = which == 0 ? 0 : which == 1 ? kDkvSmem : kDqSmem;
  return (int)err;
}
