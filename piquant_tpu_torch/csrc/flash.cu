// flash_prefill: GQA-native flash attention for prefill, causal or with a
// sliding window.
//
// Replaces piquant_tpu/ops/pallas/flash.py::_kernel (the plain causal mask
// and the sliding-window branch), and through it the JAX-shipped TPU flash
// kernel that piquant_tpu/ops/flash_prefill.py uses for plain causal masks.
//
//   out[b, h, r, i] = sum_{i - w < j <= i} softmax_j(q[b,h,r,i] . k[b,h,j]
//                     * scale) * v[b, h, j]
//
// q [B, Hkv, rep, T, 128] bf16, k/v [B, Hkv, T, 128] bf16, out f32; any GQA
// rep from 1 to 8; the window w is T for the plain causal mask (every key
// j <= i < T then has j > i - T).  Mask on indices (positions are
// contiguous per row); online softmax in f32 (running max, denominator and
// context), bf16 operands for both products, the probabilities rounded to
// bf16 before the PV product, and the denominator taken from the unrounded
// probabilities: the TPU kernel's recipe.
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
//     accumulate), Q kept in registers, the S fragment reused as the A
//     operand of PV, V fragments through ldmatrix.trans;
//   * key tiles of 64 walk from the tile holding the block's first window
//     start, q0 - (w - 1) rounded down to 64, to the block's last row, so a
//     windowed prefill reads O(T w) K/V bytes, not O(T^2) (the TPU
//     kernel's dead-block elision); a warp skips tiles wholly above its own
//     rows or wholly before its first row's window, and masks only the
//     tiles that cross its diagonal or its window's start; masked scores
//     give probability 0, and every row keeps its diagonal live;
//   * a window of T or more takes a second instance of the kernel with
//     the window code compiled out: the plain causal walk from key 0 and
//     its one compare a score;
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

constexpr int kD = 128;
constexpr int kWarps = 8;           // 16 query rows each
constexpr int kThreads = kWarps * 32;
constexpr int kKeys = 64;           // keys per tile
constexpr int kStride = kD + 8;     // smem row stride (bf16), conflict-free
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// kWindowed false: the plain causal mask (the window is ignored, the walk
// starts at key 0, where every row has a live key)
template <bool kWindowed>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     float* __restrict__ out,
                     int nh, int rep, int t, int window, float sm_scale) {
  __shared__ __align__(16) __nv_bfloat16 ks[kKeys * kStride];
  __shared__ __align__(16) __nv_bfloat16 vs[kKeys * kStride];

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

  const size_t kv_off = ((size_t)b * nh + h) * t * kD;
  const __nv_bfloat16* qh = q + (((size_t)b * nh + h) * rep + r) * t * kD;

  // Q fragments for the 8 k-steps over D
  const bool ld0 = busy && qpos0 < t, ld1 = busy && qpos1 < t;
  uint32_t qa[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const int c = kk * 16 + 2 * tq;
    const uint32_t* r0 = reinterpret_cast<const uint32_t*>(qh + (size_t)qpos0 * kD + c);
    const uint32_t* r1 = reinterpret_cast<const uint32_t*>(qh + (size_t)qpos1 * kD + c);
    qa[kk][0] = ld0 ? r0[0] : 0u;
    qa[kk][1] = ld1 ? r1[0] : 0u;
    qa[kk][2] = ld0 ? r0[4] : 0u;   // +8 columns
    qa[kk][3] = ld1 ? r1[4] : 0u;
  }

  float o[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  // keys [kbegin, kend) of the block; the warp's live keys lie in
  // [warp_kbegin, warp_kend) (none for an idle warp)
  const int kend = min(t, q0 + bq);
  const int kbegin =
      kWindowed ? max(0, q0 - (window - 1)) / kKeys * kKeys : 0;
  const int warp_kend = busy ? min(t, qbase + 16) : 0;
  const int warp_kbegin = kWindowed ? qbase - (window - 1) : 0;
  for (int k0 = kbegin; k0 < kend; k0 += kKeys) {
    __syncthreads();
    // K/V tile: 64 rows x 16 chunks of 16 bytes each, zero past T
    for (int i = threadIdx.x; i < kKeys * (kD / 8); i += kThreads) {
      const int row = i / (kD / 8), ch = i % (kD / 8);
      const int key = k0 + row;
      int4 kv = make_int4(0, 0, 0, 0), vv = kv;
      if (key < t) {
        kv = *reinterpret_cast<const int4*>(k + kv_off + (size_t)key * kD + ch * 8);
        vv = *reinterpret_cast<const int4*>(v + kv_off + (size_t)key * kD + ch * 8);
      }
      *reinterpret_cast<int4*>(&ks[row * kStride + ch * 8]) = kv;
      *reinterpret_cast<int4*>(&vs[row * kStride + ch * 8]) = vv;
    }
    __syncthreads();
    if (k0 >= warp_kend || k0 + kKeys <= warp_kbegin) continue;

    // S = Q K^T for 16 rows x 64 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kr = &ks[(nt * 8 + g) * kStride + 2 * tq];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + kk * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8);
        mma_bf16(s[nt], qa[kk], b0, b1);
      }
    }
    // scale, then the inclusive causal mask (and the window, except in a
    // tile whose every key is live for all 16 rows of the warp: below the
    // diagonal and inside the last row's window); row maxima
    const bool interior = kWindowed && k0 + kKeys - 1 <= qbase &&
                          k0 > qbase + 15 - window;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = k0 + nt * 8 + 2 * tq + j;
        if constexpr (kWindowed) {
          s[nt][j] *= sm_scale;
          s[nt][2 + j] *= sm_scale;
          if (!interior) {
            if (key > qpos0 || key <= qpos0 - window) s[nt][j] = kNegInf;
            if (key > qpos1 || key <= qpos1 - window) s[nt][2 + j] = kNegInf;
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
    // under a window, a row with no live key yet keeps the sentinel as
    // its max: its exponents are taken against 0, so its masked scores
    // give 0 (causally, key 0 of the first tile is live for every row)
    const float e0 = kWindowed && mn0 == kNegInf ? 0.f : mn0;
    const float e1 = kWindowed && mn1 == kNegInf ? 0.f : mn1;
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
    for (int i = 0; i < 16; ++i) {
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
      for (int dp = 0; dp < 8; ++dp) {
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
  float* oh = out + (((size_t)b * nh + h) * rep + r) * t * kD;
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const int c = nt * 8 + 2 * tq;
    if (qpos0 < t)
      *reinterpret_cast<float2*>(oh + (size_t)qpos0 * kD + c) =
          make_float2(o[nt][0] / l0, o[nt][1] / l0);
    if (qpos1 < t)
      *reinterpret_cast<float2*>(oh + (size_t)qpos1 * kD + c) =
          make_float2(o[nt][2] / l1, o[nt][3] / l1);
  }
}

}  // namespace

// q [B,H,rep,T,128] bf16, k/v [B,H,T,128] bf16, out [B,H,rep,T,128] f32;
// keys i - window < j <= i attend (window T: the plain causal mask).  rep
// must be 1 to 8 and window >= 1.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for an unsupported rep or window.
extern "C" int pq_flash_prefill(const void* q, const void* k, const void* v,
                                void* out, int nb, int nh, int rep, int t,
                                int window, float sm_scale, void* stream) {
  if (rep < 1 || rep > kWarps || window < 1) return (int)cudaErrorInvalidValue;
  const int bq = 16 * (kWarps / rep);
  dim3 grid((t + bq - 1) / bq, nh, nb);
  // a window of T or more masks nothing the causal mask keeps
  auto kern = window < t ? flash_prefill_kernel<true> : flash_prefill_kernel<false>;
  kern<<<grid, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<float*>(out), nh, rep,
      t, window, sm_scale);
  return (int)cudaGetLastError();
}
