// flash_wide: flash.cu's GQA-native prefill attention (causal, sliding
// window, Llama-4's chunk, the logit softcap, attention sinks; every GQA
// rep) at head_dims of 384 to 1024 (multiples of 128).
//
// Replaces piquant_tpu/ops/pallas/flash.py::_kernel at the head_dims that
// flash.cu's instances (128, 256) do not take; the reference's kernel takes
// any multiple of 128.  The function, its masks, the softcap's form, the
// sink term and the rounding recipe (bf16 probabilities for P V, the
// denominator from the unrounded ones, an IEEE division at the end) are
// flash.cu's (its header comment).  flash.cu's tiling does not scale: at D
// 512 its Q alone takes 128 KB of the block's 227 KB, and a consumer thread
// would hold 256 f32 of O.  Here:
//   * O is cut into 128-column slabs, one a block (a grid coordinate beside
//     the work item): a thread holds 64 f32 of O at every D.  Each block of
//     an item computes the whole S = Q K^T, in the same order, so the
//     blocks' running maxima and denominators agree bit for bit and no
//     merge is needed; Q K^T is recomputed once a slab (D / 128 times), so
//     the operations are (D / 128 + 1) / 2 times the bound's 4 D a pair:
//     2x at D 384, 2.5x at D 512, 4.5x at D 1024;
//   * an item is 64 query rows, the rep heads of one kv head times 64 / rep
//     positions (head-major, flash.cu's packing at 64 rows; a rep above 64
//     takes its heads in groups of 64, one position an item); 4 warps of 16
//     rows, both products on the warp-level m16n8k16 MMA with ldmatrix
//     fragments, P kept in registers between them;
//   * Q (64 rows x D, 128 D bytes: 128 KB at D 1024) stays in shared
//     memory for the item; K in 64-key x 128-dim chunks and the slab of V
//     in 64-key x 128-column tiles, 16 KB each, stream through one ring of
//     3 stages by cp.async, 2 loads in flight beyond the one in use, rows
//     past T zero-filled: 112 KB of shared memory at D 512, so two blocks
//     an SM up to D 512; every buffer XOR-swizzled in 16-byte units, so the
//     ldmatrix rows of a matrix fall in distinct banks;
//   * the key walk, the interior-tile test and the row starts are
//     flash.cu's at 64 keys a tile; the mode (causal, window, chunk), the
//     softcap and the sinks are runtime flags of one instance.
// Bound on the H100: the live (q, k) pairs' 4 D operations at the bf16
// peak, or the bytes (q, k, v read once, the f32 context written once):
// 0.0701 ms at B 8, Hkv 2, rep 4, T 1024, D 512, where this kernel takes
// 1.0100 ms (chip_smoke.py phase 20; H100 80GB HBM3, 700 W).  Four warps
// a block issue both products and the softmax with no warp specialised
// to loads, and Q K^T runs D / 128 times: a right first kernel, not a
// fast one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pq_hopper.cuh"
#include "pq_mma.cuh"

namespace {

using namespace pq;

constexpr int kRows = 64;      // query rows an item (16 a warp)
constexpr int kKeys = 64;      // keys a tile
constexpr int kSlab = 128;     // context columns a block
constexpr int kThreads = 128;
constexpr int kStages = 3;     // ring stages: a K chunk or a V tile each
constexpr int kAhead = kStages - 1;   // loads in flight beyond the one in use
constexpr int kStage = kKeys * 128 * 2;   // 64 rows x 128 bf16
constexpr int kMinD = 384;
constexpr int kMaxD = 1024;
constexpr int kSmemMax = 232448;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kCausal = 0, kWindow = 1, kChunk = 2;

struct Args {
  const __nv_bfloat16* q;   // [B, Hkv, rep, T, D]
  const __nv_bfloat16* k;   // [B, Hkv, T, D]
  const __nv_bfloat16* v;
  float* out;               // [B, Hkv, rep, T, D]
  const int* pos0;          // [B] (chunk only)
  const float* sinks;       // [Hkv * rep] or null
  int nb, nh, rep, t, d, window, chunk, mode;
  float sm_scale, softcap, inv_softcap;   // softcap 0: none
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// byte offset of 16-byte unit c of row r in a buffer of row_bytes a row
__device__ __forceinline__ uint32_t swz(int r, int c, int row_bytes) {
  return (uint32_t)(r * row_bytes + ((c ^ (r & 7)) << 4));
}

__global__ void __launch_bounds__(kThreads, 2)
flash_wide_kernel(const Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int D = a.d, nc = D / 128, nslab = D / kSlab;
  uint8_t* const qs = smem;                        // [64][D] bf16
  uint8_t* const ring = smem + kRows * D * 2;      // [3][64][128] bf16
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;

  // the block's item (heaviest first: the last query blocks) and slab
  const int slab = blockIdx.x % nslab, item = blockIdx.x / nslab;
  const int rep = a.rep, t = a.t;
  const int hpi = min(rep, kRows);              // heads an item
  const int ngrp = (rep + hpi - 1) / hpi;       // head groups a kv head
  const int bq = kRows / hpi;                   // positions an item
  const int live = hpi * bq;                    // rows holding a query
  const int nq = (t + bq - 1) / bq;
  const int rows_kv = a.nb * a.nh * ngrp;
  const int q0 = (nq - 1 - item / rows_kv) * bq;
  const int bh = item % rows_kv / ngrp;
  const int h0 = item % rows_kv % ngrp * hpi;
  const int p0 = a.mode == kChunk ? __ldg(a.pos0 + bh / a.nh) : 0;
  auto row_start = [&](int qp) -> int {
    if (a.mode == kWindow) return qp - (a.window - 1);
    if (a.mode == kChunk) return (p0 + qp) / a.chunk * a.chunk - p0;
    return 0;
  };
  const int kend = min(t, q0 + bq);
  const int kbegin = max(0, row_start(q0)) / kKeys * kKeys;
  const int n_tiles = (kend - kbegin + kKeys - 1) / kKeys;
  const int last_start = row_start(kend - 1);
  const bool starts = a.mode != kCausal;

  const __nv_bfloat16* const kb = a.k + (size_t)bh * t * D;
  const __nv_bfloat16* const vb = a.v + (size_t)bh * t * D + slab * kSlab;

  // Q: row r is head h0 + r / bq at position q0 + r % bq; zeros past the
  // group's heads, rep or T (those rows are never stored)
  for (int i = tid; i < kRows * (D / 8); i += kThreads) {
    const int r = i / (D / 8), c = i % (D / 8);
    const int hr = r / bq, qp = q0 + r % bq;
    const bool on = r < live && h0 + hr < rep && qp < t;
    cp_async16(qs + swz(r, c, 2 * D),
               on ? a.q + (((size_t)bh * rep + h0 + hr) * t + qp) * D + 8 * c
                  : a.q,
               on);
  }
  cp_async_commit();

  // load j of the walk into stage j % 3: tile n = j / (nc + 1)'s K chunk
  // c = j % (nc + 1) (dims 128c ..; c < nc) or its V slab tile (c = nc),
  // both 64 rows of 128 bf16; one commit group each, empty past the walk's
  // end
  const int total = n_tiles * (nc + 1);
  auto issue = [&](int j) {
    if (j < total) {
      const int n = j / (nc + 1), c = j % (nc + 1);
      const int key0 = kbegin + n * kKeys;
      const __nv_bfloat16* const src = c < nc ? kb + 128 * c : vb;
      uint8_t* const dst = ring + (j % kStages) * kStage;
      for (int i = tid; i < kKeys * 16; i += kThreads) {
        const int r = i >> 4, u = i & 15, key = key0 + r;
        cp_async16(dst + swz(r, u, 256),
                   key < t ? src + (size_t)key * D + 8 * u : src, key < t);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < kAhead; ++j) issue(j);

  // the thread's rows a and b (g, g + 8 of its warp's 16), their heads in
  // the item's group, positions and row starts
  const int row_a = 16 * warp + g, row_b = row_a + 8;
  const int hr_a = row_a / bq, hr_b = row_b / bq;
  const int qp_a = q0 + row_a % bq, qp_b = q0 + row_b % bq;
  const int st_a = row_start(qp_a), st_b = row_start(qp_b);
  const bool capped = a.softcap > 0.f;
  const float scale_l2 = a.sm_scale * kLog2e, cap_l2 = a.softcap * kLog2e;
  const uint32_t q_addr = smem_u32(qs), r_addr = smem_u32(ring);
  const int qr = 16 * warp + (lane & 15);      // the lane's ldmatrix row

  float s[8][4];       // S of the tile: n8 tile j, rows a (0, 1), b (2, 3)
  float o[16][4];      // O of the slab: n8 tile j of 128 columns
  uint32_t p[4][4];    // P as the A fragments of the 4 k16 steps of keys
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  for (int j = 0; j < total; ++j) {
    cp_async_wait<kAhead - 1>();    // Q and loads 0 .. j have landed
    __syncthreads();                // for every thread; load j - 1's stage
    issue(j + kAhead);              // is free again
    const int n = j / (nc + 1), c = j % (nc + 1);
    const uint32_t slot = r_addr + (j % kStages) * kStage;
    if (c < nc) {
      // ---- S += Q[:, 128c ..] K[64 keys, 128c ..]^T
      if (c == 0) {
#pragma unroll
        for (int jn = 0; jn < 8; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[jn][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        uint32_t qa[4];
        ldsm_x4(qa, q_addr + swz(qr, 16 * c + 2 * kk + (lane >> 4), 2 * D));
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t kf[4];
          const int kr = 16 * np + (lane & 7) + ((lane >> 4) << 3);
          ldsm_x4(kf, slot + swz(kr, 2 * kk + ((lane >> 3) & 1), 256));
          mma16816(s[2 * np], qa[0], qa[1], qa[2], qa[3], kf[0], kf[1]);
          mma16816(s[2 * np + 1], qa[0], qa[1], qa[2], qa[3], kf[2], kf[3]);
        }
      }
      if (c < nc - 1) continue;
      // ---- the tile's softmax: the scale in log2 units (or the cap), the
      // mask on tiles that are not interior, the running max, the
      // probabilities in place, the denominator, O rescaled, P packed.  A
      // row with no live key yet keeps the sentinel max, its exponents
      // taken against 0.
      const int k0 = kbegin + n * kKeys;
      const bool masked = k0 + kKeys - 1 > q0 || (starts && k0 < last_start);
      float mxa = kNegInf, mxb = kNegInf;
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float xa = s[jn][e], xb = s[jn][2 + e];
          if (capped) {
            xa = cap_l2 * tanhf(xa * a.sm_scale * a.inv_softcap);
            xb = cap_l2 * tanhf(xb * a.sm_scale * a.inv_softcap);
          } else {
            xa *= scale_l2;
            xb *= scale_l2;
          }
          if (masked) {
            const int key = k0 + 8 * jn + 2 * tq + e;
            if (key > qp_a || key < st_a) xa = kNegInf;
            if (key > qp_b || key < st_b) xb = kNegInf;
          }
          s[jn][e] = xa;
          s[jn][2 + e] = xb;
          mxa = fmaxf(mxa, xa);
          mxb = fmaxf(mxb, xb);
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, off));
        mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, off));
      }
      const float mn_a = fmaxf(m_a, mxa), mn_b = fmaxf(m_b, mxb);
      const float ca = ex2(m_a - mn_a), cb = ex2(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      const float e_a = mn_a == kNegInf ? 0.f : mn_a;
      const float e_b = mn_b == kNegInf ? 0.f : mn_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[jn][e] = ex2(s[jn][e] - e_a);
          s[jn][2 + e] = ex2(s[jn][2 + e] - e_b);
          sum_a += s[jn][e];
          sum_b += s[jn][2 + e];
        }
      l_a = l_a * ca + sum_a;
      l_b = l_b * cb + sum_b;
#pragma unroll
      for (int jn = 0; jn < 16; ++jn) {
        o[jn][0] *= ca;
        o[jn][1] *= ca;
        o[jn][2] *= cb;
        o[jn][3] *= cb;
      }
      // k16 step kk: row a's keys 2tq, 2tq + 1, row b's, then both at + 8
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        p[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        p[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        p[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        p[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      }
    } else {
      // ---- O += P V[64 keys, the slab's 128 columns]
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int vr = 16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
        for (int np = 0; np < 8; ++np) {
          uint32_t vf[4];
          ldsm_x4_trans(vf, slot + swz(vr, 2 * np + (lane >> 4), 256));
          mma16816(o[2 * np], p[kk][0], p[kk][1], p[kk][2], p[kk][3], vf[0],
                   vf[1]);
          mma16816(o[2 * np + 1], p[kk][0], p[kk][1], p[kk][2], p[kk][3],
                   vf[2], vf[3]);
        }
      }
    }
  }

  // the 4 lanes of a row hold partial denominators
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  // a padding row (past the group's heads or rep) repeats a head and is
  // never stored
  const int ha = min(h0 + hr_a, rep - 1), hb = min(h0 + hr_b, rep - 1);
  // the sink logit joins the denominator against the row's final running
  // max (log2 units, as m)
  if (a.sinks != nullptr) {
    const int hh = bh % a.nh;
    l_a += exp2f(__ldg(a.sinks + hh * rep + ha) * kLog2e - m_a);
    l_b += exp2f(__ldg(a.sinks + hh * rep + hb) * kLog2e - m_b);
  }
  const bool out_a = hr_a < hpi && h0 + hr_a < rep && qp_a < t;
  const bool out_b = hr_b < hpi && h0 + hr_b < rep && qp_b < t;
  float* const oa =
      a.out + (((size_t)bh * rep + ha) * t + qp_a) * D + slab * kSlab;
  float* const ob =
      a.out + (((size_t)bh * rep + hb) * t + qp_b) * D + slab * kSlab;
#pragma unroll
  for (int jn = 0; jn < 16; ++jn) {
    const int col = 8 * jn + 2 * tq;
    if (out_a)
      *reinterpret_cast<float2*>(oa + col) =
          make_float2(o[jn][0] / l_a, o[jn][1] / l_a);
    if (out_b)
      *reinterpret_cast<float2*>(ob + col) =
          make_float2(o[jn][2] / l_b, o[jn][3] / l_b);
  }
}

size_t smem_bytes(int d) {
  return (size_t)kRows * d * 2 + kStages * kStage;
}

}  // namespace

// As pq_flash_prefill (flash.cu) at head_dim d of 384 to 1024, a multiple
// of 128: q [B,H,rep,T,D] bf16, k/v [B,H,T,D] bf16, out [B,H,rep,T,D] f32;
// keys i - window < j <= i attend (window T: the plain causal mask), or
// under a chunk > 0 (window T) the keys j <= i of i's chunk, counted from
// pos0[b] (int32 on the device); scaled scores capped at softcap (0: no
// cap); sinks [H * rep] f32 on the device (null: none).  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for an unsupported D, rep,
// window, chunk or softcap.
extern "C" int pq_flash_prefill_wide(const void* q, const void* k,
                                     const void* v, void* out,
                                     const void* pos0, const void* sinks,
                                     int nb, int nh, int rep, int t,
                                     int window, int chunk, int d,
                                     float sm_scale, float softcap,
                                     void* stream) {
  if (rep < 1 || t < 1 || window < 1 || chunk < 0 || !(softcap >= 0.f) ||
      (chunk > 0 && (window < t || pos0 == nullptr)) || d % 128 ||
      d < kMinD || d > kMaxD)
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemMax);
  if (attr != cudaSuccess) return (int)attr;
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.out = static_cast<float*>(out);
  a.pos0 = static_cast<const int*>(pos0);
  a.sinks = static_cast<const float*>(sinks);
  a.nb = nb;
  a.nh = nh;
  a.rep = rep;
  a.t = t;
  a.d = d;
  a.window = window;
  a.chunk = chunk;
  // a window of T or more masks nothing the causal mask keeps
  a.mode = chunk > 0 ? kChunk : window < t ? kWindow : kCausal;
  a.sm_scale = sm_scale;
  a.softcap = softcap;
  // the softcap's reciprocal in f32, as the TPU kernel's 1.0 / softcap
  a.inv_softcap = softcap > 0.f ? (float)(1.0 / (double)softcap) : 0.f;
  const int hpi = rep < kRows ? rep : kRows;
  const int bq = kRows / hpi;
  const long long blocks = (long long)((t + bq - 1) / bq) * nb * nh *
                           ((rep + hpi - 1) / hpi) * (d / kSlab);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_wide_kernel<<<(unsigned)blocks, kThreads, smem_bytes(d),
                      reinterpret_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// Registers, local (spill) bytes and dynamic shared memory of the wide
// instance at head_dim d, and its ring stages, into out[4].
extern "C" int pq_flash_wide_attributes(int d, int* out) {
  if (d % 128 || d < kMinD || d > kMaxD) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, flash_wide_kernel);
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)smem_bytes(d);
  out[3] = kStages;
  return (int)err;
}
