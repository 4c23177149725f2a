// flash_prefill: GQA-native flash attention for prefill, causal, with a
// sliding window or with Llama-4's chunked mask, with or without a logit
// softcap and attention sinks, at head_dim 128 or 256.
//
// Replaces piquant_tpu/ops/pallas/flash.py::_kernel (the plain causal mask,
// the sliding-window, chunk, softcap and sinks branches), and through it
// the JAX-shipped TPU flash kernel that piquant_tpu/ops/flash_prefill.py
// uses for plain causal masks.
//
//   out[b, h, r, i] = sum_{start(i) <= j <= i} e(i, j) v[b, h, j]
//                     / (sum_{start(i) <= j <= i} e(i, j) + exp(snk - m_i)),
//   e(i, j) = exp(cap(q[b,h,r,i] . k[b,h,j] * scale) - m_i),
//   cap(s) = c * tanh(s * (1 / c)) under a softcap c (Gemma-2), else s;
//   m_i the row's largest live score; the sink term only with sinks
//   (GPT-OSS: snk = sinks[h * rep + r], in the denominator alone)
//
// start(i) is 0 under the plain causal mask, i - (w - 1) under a sliding
// window w, and ((p0 + i) / C) * C - p0 under Llama-4's chunk C, where p0
// = pos0[b] is the absolute position of row 0 (read on the device): key j
// is live for query i when (p0 + j) / C == (p0 + i) / C, which under
// j <= i is j >= start(i).  Both starts are non-decreasing in i.
//
// q [B, Hkv, rep, T, D] bf16, k/v [B, Hkv, T, D] bf16, out f32, D 128 or
// 256; any GQA rep from 1 to 8; the window w is T for the plain causal mask
// (every key j <= i < T then has j > i - T).  Mask on indices (positions
// are contiguous per row), the softcap on the scaled score before the mask
// (tanhf, not the approximate tanh: at c = 50 its 2^-11 relative error is
// 0.02 of a logit); online softmax in f32 (running max, denominator and
// context), bf16 operands for both products, the probabilities rounded to
// bf16 before the PV product, and the denominator taken from the unrounded
// probabilities, the sink joining it as exp(snk - m) against the row's
// final running max: the TPU kernel's recipe.
//
// Bound on the H100: the live (q, k) pairs' FLOPs at the bf16 tensor-core
// peak.  Design:
//   * one block = the rep heads of ONE kv head times bq positions, so
//     every K/V tile loaded into shared memory serves all rep heads (no K/V
//     repeat); 8 warps of 16 rows, subs = 8 / rep (integer division)
//     16-row groups a head, bq = 16 subs: rep 1, 2, 4, 8 fill all 8 warps,
//     rep 3 runs 6 busy warps on 32-position blocks and rep 5, 6 and 7 run
//     5, 6 or 7 on 16-position blocks; the idle warps still load tiles and
//     join every __syncthreads();
//   * products on the tensor cores with mma.sync m16n8k16 (bf16 in, f32
//     accumulate), the S fragment reused as the A operand of PV, V
//     fragments through ldmatrix.trans.  At D 128 Q stays in registers
//     (8 k-steps of A fragments) beside a 16 x 128 f32 output; at D 256 the
//     16 x 256 output alone takes 128 registers a thread, so Q waits in
//     shared memory and each k-step's A fragment comes through ldmatrix,
//     and K, V and Q tiles (135 KB) take dynamic shared memory;
//   * key tiles of 64 walk from the tile holding the block's first row
//     start, start(q0) rounded down to 64, to the block's last row, so a
//     windowed or chunked prefill reads only the live K/V bytes, not
//     O(T^2) (the TPU kernel's dead-block elision); a warp skips tiles
//     wholly above its own rows or wholly before its first row's start,
//     and masks only the tiles that cross its diagonal or its last row's
//     start (rows that straddle a chunk boundary, inside a block or a
//     warp, are masked element by element); masked scores give
//     probability 0, and every row keeps its diagonal live;
//   * the row start is a template mode: causal (the start code compiled
//     out: the plain walk from key 0 and its one compare a score), window
//     or chunk; no softcap compiles the softcap out, and no sinks the
//     sink epilogue (one expf a row after the key loop, yet as a runtime
//     test it cost the causal D 128 kernel 1.5% on the H100): the D 128
//     causal instance is the one the Llama path always ran;
//   * the heaviest query blocks launch first: under a window every block
//     past the first w positions does the same work, so the order only
//     moves the light early blocks last;
//   * ragged T is masked in the kernel (loads zero past T, no stores).
// Tiles are loaded synchronously; cp.async/TMA pipelining and wgmma are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;           // 16 query rows each
constexpr int kThreads = kWarps * 32;
constexpr int kKeys = 64;           // keys per tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* smem_ptr) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_ptr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// A fragment of m16n8k16 (16 rows x 16 columns, row-major in shared
// memory): lane l gives the address of row l % 16, columns (l / 16) * 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem_ptr) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_ptr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Q in shared memory at D 256 (registers at D 128); dynamic shared memory
// of the K, V and Q tiles, in bytes (0: the static K/V tiles)
template <int D>
__host__ __device__ constexpr bool q_shared() { return D > 128; }
template <int D>
__host__ __device__ constexpr int dyn_smem() {
  return q_shared<D>() ? (2 * kKeys + kWarps * 16) * (D + 8) * 2 : 0;
}

// the row-start modes: kCausal, the plain causal mask (window, chunk and
// pos0 are ignored, the walk starts at key 0, where every row has a live
// key); kWindow, the sliding window; kChunk, Llama-4's chunk
constexpr int kCausal = 0, kWindow = 1, kChunk = 2;

// kSoftcap false: no softcap (softcap and inv_softcap are ignored).
// kSinks false: no sinks (sinks is ignored).
template <int D, int kMode, bool kSoftcap, bool kSinks>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     float* __restrict__ out,
                     const int* __restrict__ pos0,
                     const float* __restrict__ sinks,
                     int nh, int rep, int t, int window, int chunk,
                     float sm_scale, float softcap, float inv_softcap) {
  constexpr int kStride = D + 8;    // smem row stride (bf16), conflict-free
  constexpr int kSteps = D / 16;    // k-steps of Q K^T over D
  constexpr bool kQShared = q_shared<D>();
  __shared__ __align__(16) __nv_bfloat16 ks_static[kQShared ? 8 : kKeys * kStride];
  __shared__ __align__(16) __nv_bfloat16 vs_static[kQShared ? 8 : kKeys * kStride];
  extern __shared__ __align__(16) __nv_bfloat16 flash_dyn[];
  __nv_bfloat16* const ks = kQShared ? flash_dyn : ks_static;
  __nv_bfloat16* const vs = kQShared ? flash_dyn + kKeys * kStride : vs_static;

  const int subs = kWarps / rep;                 // 16-row groups a head
  const int bq = 16 * subs;                      // positions per block
  const int qb = gridDim.x - 1 - blockIdx.x;     // heaviest blocks first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qb * bq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const bool busy = warp < rep * subs;           // the rest only load tiles
  const int r = busy ? warp / subs : 0;          // query head within group
  const int qbase = q0 + (warp % subs) * 16;
  const int qpos0 = qbase + g, qpos1 = qbase + g + 8;
  // rows start past key 0 (window, chunk): the first live key of row qp
  constexpr bool kStarts = kMode != kCausal;
  const int p0 = kMode == kChunk ? pos0[b] : 0;
  auto row_start = [&](int qp) -> int {
    if constexpr (kMode == kWindow) return qp - (window - 1);
    else return (p0 + qp) / chunk * chunk - p0;
  };

  const size_t kv_off = ((size_t)b * nh + h) * t * D;
  const __nv_bfloat16* qh = q + (((size_t)b * nh + h) * rep + r) * t * D;

  // Q: A fragments for the k-steps over D in registers (D 128), or the
  // warp's 16 rows in its own slice of shared memory (D 256), zero past T;
  // the key loop's first __syncthreads() comes before any read
  const bool ld0 = busy && qpos0 < t, ld1 = busy && qpos1 < t;
  uint32_t qa[kQShared ? 1 : kSteps][4];
  __nv_bfloat16* const qw = flash_dyn + 2 * kKeys * kStride + warp * 16 * kStride;
  if constexpr (kQShared) {
    if (busy) {
      for (int i = lane; i < 16 * (D / 8); i += 32) {
        const int row = i / (D / 8), ch = i % (D / 8);
        int4 val = make_int4(0, 0, 0, 0);
        if (qbase + row < t)
          val = *reinterpret_cast<const int4*>(qh + (size_t)(qbase + row) * D + ch * 8);
        *reinterpret_cast<int4*>(qw + row * kStride + ch * 8) = val;
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const int c = kk * 16 + 2 * tq;
      const uint32_t* r0 = reinterpret_cast<const uint32_t*>(qh + (size_t)qpos0 * D + c);
      const uint32_t* r1 = reinterpret_cast<const uint32_t*>(qh + (size_t)qpos1 * D + c);
      qa[kk][0] = ld0 ? r0[0] : 0u;
      qa[kk][1] = ld1 ? r1[0] : 0u;
      qa[kk][2] = ld0 ? r0[4] : 0u;   // +8 columns
      qa[kk][3] = ld1 ? r1[4] : 0u;
    }
  }

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  // keys [kbegin, kend) of the block; the warp's live keys lie in
  // [warp_kbegin, warp_kend) (none for an idle warp); every key of a tile
  // from warp_klast on is past the start of all 16 rows of the warp
  const int kend = min(t, q0 + bq);
  const int kbegin = kStarts ? max(0, row_start(q0)) / kKeys * kKeys : 0;
  const int warp_kend = busy ? min(t, qbase + 16) : 0;
  const int warp_kbegin = kStarts ? row_start(qbase) : 0;
  const int warp_klast = kStarts ? row_start(qbase + 15) : 0;
  const int st0 = kStarts ? row_start(qpos0) : 0;
  const int st1 = kStarts ? row_start(qpos1) : 0;
  for (int k0 = kbegin; k0 < kend; k0 += kKeys) {
    __syncthreads();
    // K/V tile: 64 rows x D/8 chunks of 16 bytes each, zero past T
    for (int i = threadIdx.x; i < kKeys * (D / 8); i += kThreads) {
      const int row = i / (D / 8), ch = i % (D / 8);
      const int key = k0 + row;
      int4 kv = make_int4(0, 0, 0, 0), vv = kv;
      if (key < t) {
        kv = *reinterpret_cast<const int4*>(k + kv_off + (size_t)key * D + ch * 8);
        vv = *reinterpret_cast<const int4*>(v + kv_off + (size_t)key * D + ch * 8);
      }
      *reinterpret_cast<int4*>(&ks[row * kStride + ch * 8]) = kv;
      *reinterpret_cast<int4*>(&vs[row * kStride + ch * 8]) = vv;
    }
    __syncthreads();
    if (k0 >= warp_kend || k0 + kKeys <= warp_kbegin) continue;

    // S = Q K^T for 16 rows x 64 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    if constexpr (kQShared) {
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, qw + (lane % 16) * kStride + kk * 16 + (lane / 16) * 8);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const __nv_bfloat16* kr = &ks[(nt * 8 + g) * kStride + 2 * tq + kk * 16];
          mma_bf16(s[nt], a, *reinterpret_cast<const uint32_t*>(kr),
                   *reinterpret_cast<const uint32_t*>(kr + 8));
        }
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* kr = &ks[(nt * 8 + g) * kStride + 2 * tq];
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + kk * 16);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8);
          mma_bf16(s[nt], qa[kk], b0, b1);
        }
      }
    }
    // scale (and cap), then the inclusive causal mask (and the row
    // starts, except in a tile whose every key is live for all 16 rows of
    // the warp: below the diagonal and past the last row's start); row
    // maxima
    const bool interior = kStarts && k0 + kKeys - 1 <= qbase &&
                          k0 >= warp_klast;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = k0 + nt * 8 + 2 * tq + j;
        if constexpr (kStarts || kSoftcap) {
          s[nt][j] *= sm_scale;
          s[nt][2 + j] *= sm_scale;
          if constexpr (kSoftcap) {
            s[nt][j] = softcap * tanhf(s[nt][j] * inv_softcap);
            s[nt][2 + j] = softcap * tanhf(s[nt][2 + j] * inv_softcap);
          }
          if (kStarts ? !interior : true) {
            if (key > qpos0 || (kStarts && key < st0)) s[nt][j] = kNegInf;
            if (key > qpos1 || (kStarts && key < st1)) s[nt][2 + j] = kNegInf;
          }
        } else {
          s[nt][j] = key <= qpos0 ? s[nt][j] * sm_scale : kNegInf;
          s[nt][2 + j] = key <= qpos1 ? s[nt][2 + j] * sm_scale : kNegInf;
        }
        mx0 = fmaxf(mx0, s[nt][j]);
        mx1 = fmaxf(mx1, s[nt][2 + j]);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    // under a window or a chunk, a row with no live key yet keeps the
    // sentinel as its max: its exponents are taken against 0, so its
    // masked scores give 0 (causally, key 0 of the first tile is live for
    // every row)
    const float e0 = kStarts && mn0 == kNegInf ? 0.f : mn0;
    const float e1 = kStarts && mn1 == kNegInf ? 0.f : mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[nt][j] = expf(s[nt][j] - e0);
        s[nt][2 + j] = expf(s[nt][2 + j] - e1);
        sum0 += s[nt][j];
        sum1 += s[nt][2 + j];
      }
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[i][0] *= c0;
      o[i][1] *= c0;
      o[i][2] *= c1;
      o[i][3] *= c1;
    }
    // O += bf16(P) V
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
      const int vrow = j * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, &vs[vrow * kStride + dp * 16 + (lane / 16) * 8]);
        mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
  }

  if (!busy) return;
  // the 4 lanes of a row hold partial denominators
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  // the sink logit joins the denominator against the row's final running
  // max, which every lane of the row holds
  if constexpr (kSinks) {
    const float snk = sinks[h * rep + r];
    l0 += expf(snk - m0);
    l1 += expf(snk - m1);
  }
  float* oh = out + (((size_t)b * nh + h) * rep + r) * t * D;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int c = nt * 8 + 2 * tq;
    if (qpos0 < t)
      *reinterpret_cast<float2*>(oh + (size_t)qpos0 * D + c) =
          make_float2(o[nt][0] / l0, o[nt][1] / l0);
    if (qpos1 < t)
      *reinterpret_cast<float2*>(oh + (size_t)qpos1 * D + c) =
          make_float2(o[nt][2] / l1, o[nt][3] / l1);
  }
}

template <int D, int kMode, bool kSoftcap, bool kSinks>
int launch(const void* q, const void* k, const void* v, void* out,
           const int* pos0, const float* sinks, int nb, int nh, int rep,
           int t, int window, int chunk, float sm_scale, float softcap,
           cudaStream_t stream) {
  auto kern = flash_prefill_kernel<D, kMode, kSoftcap, kSinks>;
  constexpr int smem = dyn_smem<D>();
  if constexpr (smem > 48 * 1024) {
    // once an instance: the opt-in above the 48 KB default
    static const cudaError_t attr = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return (int)attr;
  }
  const int bq = 16 * (kWarps / rep);
  dim3 grid((t + bq - 1) / bq, nh, nb);
  // the softcap's reciprocal in f32, as the TPU kernel's 1.0 / softcap
  const float inv_softcap = kSoftcap ? (float)(1.0 / (double)softcap) : 0.f;
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<float*>(out), pos0,
      sinks, nh, rep, t, window, chunk, sm_scale, softcap, inv_softcap);
  return (int)cudaGetLastError();
}

#define PQ_FLASH_ARGS q, k, v, out, pos0, sinks, nb, nh, rep, t, window, \
                      chunk, sm_scale, softcap, st

template <int D, int kMode>
int dispatch_epilogue(const void* q, const void* k, const void* v, void* out,
                      const int* pos0, const float* sinks, int nb, int nh,
                      int rep, int t, int window, int chunk, float sm_scale,
                      float softcap, cudaStream_t st) {
  if (sinks != nullptr) {
    if (softcap > 0.f) return launch<D, kMode, true, true>(PQ_FLASH_ARGS);
    return launch<D, kMode, false, true>(PQ_FLASH_ARGS);
  }
  if (softcap > 0.f) return launch<D, kMode, true, false>(PQ_FLASH_ARGS);
  return launch<D, kMode, false, false>(PQ_FLASH_ARGS);
}

template <int D>
int dispatch(const void* q, const void* k, const void* v, void* out,
             const int* pos0, const float* sinks, int nb, int nh, int rep,
             int t, int window, int chunk, float sm_scale, float softcap,
             cudaStream_t st) {
  // a window of T or more masks nothing the causal mask keeps
  if (chunk > 0) return dispatch_epilogue<D, kChunk>(PQ_FLASH_ARGS);
  if (window < t) return dispatch_epilogue<D, kWindow>(PQ_FLASH_ARGS);
  return dispatch_epilogue<D, kCausal>(PQ_FLASH_ARGS);
}

}  // namespace

// q [B,H,rep,T,D] bf16, k/v [B,H,T,D] bf16, out [B,H,rep,T,D] f32, D 128 or
// 256; keys i - window < j <= i attend (window T: the plain causal mask),
// or under a chunk > 0 (window T) the keys j <= i of i's chunk, counted
// from the absolute position pos0[b] of row 0 (pos0: [B] int32 on the
// device); their scaled scores capped at softcap (0: no cap); sinks [H *
// rep] f32 on the device (null: none) join each row's denominator.  rep
// must be 1 to 8, window >= 1, chunk >= 0 and softcap >= 0.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for an unsupported D, rep,
// window, chunk or softcap, a chunk beside a window, or a chunk without
// pos0.
extern "C" int pq_flash_prefill(const void* q, const void* k, const void* v,
                                void* out, const void* pos0_ptr,
                                const void* sinks_ptr, int nb, int nh,
                                int rep, int t, int window, int chunk, int d,
                                float sm_scale, float softcap, void* stream) {
  const int* pos0 = static_cast<const int*>(pos0_ptr);
  const float* sinks = static_cast<const float*>(sinks_ptr);
  if (rep < 1 || rep > kWarps || window < 1 || chunk < 0 ||
      !(softcap >= 0.f) || (chunk > 0 && (window < t || pos0 == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (d == 128) return dispatch<128>(PQ_FLASH_ARGS);
  if (d == 256) return dispatch<256>(PQ_FLASH_ARGS);
  return (int)cudaErrorInvalidValue;
}
