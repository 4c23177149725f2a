// mlp_fused: the gated MLP at decode M in one launch,
//   y = (act(x . w1) * (x . w3)) . w2,   act = SiLU or GELU (tanh form),
// channelwise INT4 split-half weights with the fused [w1 | w3] matrix.
//
// Replaces piquant_tpu/ops/pallas/qmatmul.py::_mlp_fused_kernel (def :1200,
// pallas_call :1300; the gate mlp_fused_matmul :1340, PIQUANT_MLP_FUSE=1).
// What it computes, step for step:
//   stage A, hidden column j (gate j, up i_ff + j of w13):
//     acc = x[:, :K/2] . lo(w13[:, j]) + x[:, K/2:] . hi(w13[:, j])  (f32)
//     g = acc * s13[j] - xsum * (zp13[j] * s13[j]),  u likewise,
//     h[:, j] = bf16(act(g) * u);
//   stage B, per split of the w2 packed rows r in [r0, r1):
//     part = (h[:, r] . lo(w2[r]) + h[:, r + i_ff/2] . hi(w2[r])) * s2
//            - hsum * (zp2 * s2),
//     hsum the f32 sum of the split's h values of both planes, so the zero
//     point folds per split (exact in real arithmetic for any split);
//   y = the parts summed in split order, in f32, rounded once to the
//     output type.  (The TPU kernel adds each chunk into the output in the
//     output dtype; here the sum is f32 and rounds once.)
// xsum is the f32 row sum of the bf16 x: the caller's, or (null) summed
// here from the staged x.
//
// Bound on the H100: the two code streams, (K/2) * 2 i_ff + (i_ff/2) * N
// bytes (88 MB at Llama-3-8B's K 4096, i_ff 14336, N 4096), plus the f32
// scales and zero points; x, h and y are a few hundred KB at decode M, and
// the products are ~30x under the line where the tensor cores would bound
// at M = 8 (about at it at M = 64).
// Design: the decode GEMV template's loop (qmatmul_gemv.cu, its helpers in
// pq_gemv.cuh) over both weight streams in one launch of a persistent grid
// (one block an SM), whose blocks take work items from a queue in the
// state buffer, every A item before any B item:
//   * a ring stage holds two weight boxes of 128 columns (the GEMV's box,
//     128-byte swizzled) and the x (or h) boxes of its rows; the 8 warps
//     split the 256 columns and the stage's rows (MlpTile).
//   * an A item is 128 hidden columns over all of K: its stages hold the
//     gate columns j .. j + 127 and the up columns i_ff + j .. of the same
//     rows, so its epilogue folds, activates and writes the bf16 h of
//     those columns (to an L2-resident [M, i_ff] scratch), then adds one
//     (release) to the ready count of each B split whose rows those
//     columns feed.  Items are queued so that the two halves of h a B
//     split reads (j and j + i_ff/2) come together.  (Split over K, with
//     the parts added through global memory, stage A ran slower on an
//     H100 at every split tried: an item's epilogue costs microseconds.)
//   * a B item is 256 output columns over one split of the i_ff/2 packed
//     w2 rows (split on the host: ops/cuda/qmatmul.py::mlp_split); the h
//     boxes of its stages wait only for its split's ready count (acquire;
//     the splits complete in any order, so a block trusts a split only
//     once it has read that split's count), and its weight boxes are
//     issued before that wait, so the w2 stream overlaps the tail of
//     stage A; no grid-wide barrier.  The
//     split's part is folded with its own h sums (an all-ones mma on the
//     staged h); every split but the last writes its part and counts
//     itself done (release), and the last split's item (queued last)
//     waits for that count, adds the others' parts and its own in split
//     order and rounds once.
//   * an item's scales and zero points are copied into shared memory
//     (cp.async) while it streams, so its epilogue waits on no L2 load but
//     the parts.
//   * the products on the tensor cores: the weight columns the A operand of
//     mma.sync.m16n8k16 bf16 built in registers from the packed bytes (a
//     lop3 into the mantissa of 128.0 and one bf16x2 subtract a pair), the
//     tokens (x or h) the n8 B operand, f32 sums; all M <= 64 rows in one
//     block, so a call reads each weight byte once at any M.
//   * one thread issues the weight and x / h boxes of each ring stage onto
//     the slot's full mbarrier; each warp releases the slot on its empty
//     mbarrier; the ring runs across items, so the next item's loads fly
//     during an item's epilogue.
// Every sum has a fixed order, whichever block takes an item: two calls on
// the same inputs are bit-equal, with no atomics on the values.  The waits
// cannot deadlock: a block claims items in queue order and finishes its A
// items before it waits for any count, and A items wait for nothing.  The
// last block to finish resets the queue and the counts, so a CUDA graph
// can replay the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pq_gemv.cuh"
#include "pq_hopper.cuh"

namespace {

using namespace pq::gemv;   // the tile geometry and loop helpers
using pq::mbar_arrive;
using pq::mbar_arrive_tx;
using pq::mbar_init;
using pq::mbar_wait;
using pq::tma_load_2d;

constexpr int kThreads = 256;       // 8 warps
constexpr int kMaxStages = 12;
constexpr int kItem = 2 * kCols;    // weight columns an item (two boxes)
constexpr int kPitch = kItem + 4;   // floats a row of the warps' sums (the
                                    // 4 shift a row's banks)
// the state buffer: the queue, the finished blocks, the finished splits
// an output tile of B, a ready count a B split
constexpr int kQueue = 0, kDone = 1, kDoneB = 2;

// The block's geometry at MT n8 token tiles: the GEMV's warp widths (128
// columns a warp at M <= 16, 64 at M <= 32, 32 above) across the item's
// 256 columns, the rest of the 8 warps along K, one or two 16-row blocks a
// warp a stage.
template <int MT>
struct MlpTile {
  static constexpr int CW = MT <= 2 ? 128 : MT == 4 ? 64 : 32;  // columns a warp
  static constexpr int WN = kItem / CW;   // warps across the columns
  static constexpr int KW = 8 / WN;       // warps along K
  static constexpr int U = MT == 1 || MT == 8 ? 2 : 1;  // 16-row blocks a warp
  static constexpr int R = 16 * KW * U;   // packed rows a stage: 128, 64, 32, 32
  static constexpr int NT = CW / 16;      // m16 tiles a warp
  static constexpr int CB = CW / 8;       // columns (bytes of a row) a lane
  static constexpr int XT = 8 * MT;       // tokens staged
};

// Shared memory at MT n8 token tiles (host and device agree): 1 KB of
// barriers and slot tags, the warps' sums [KW][XT][kPitch] and row sums
// [KW][XT] (apart from the ring, which stays in flight across an item's
// epilogue), two buffers of an item's 512 scales and zero points (kSide
// bytes each), then the ring (slots 1 KB aligned for the 128-byte
// swizzle).
constexpr int kSide = 512 * 4;

struct Layout {
  int w, x, slot, part, stages, total;
};

template <int MT>
__host__ __device__ inline Layout layout() {
  using T = MlpTile<MT>;
  Layout L;
  L.w = 2 * T::R * kCols;                   // two weight boxes
  L.x = 2 * T::XT * T::R * 2;               // two planes of bf16 x / h
  L.slot = (L.w + L.x + 1023) / 1024 * 1024;
  L.part = (T::KW * T::XT * (kPitch + 1) * 4 + 1023) / 1024 * 1024;
  const int s = (232448 - 2048 - L.part - 2 * kSide) / L.slot;
  L.stages = s < 2 ? 2 : s > kMaxStages ? kMaxStages : s;
  L.total = 2048 + L.part + 2 * kSide + L.stages * L.slot;   // + 1 KB to align
  return L;
}

// The launch's work queue, in the order its blocks claim it (kernel and
// host share it; ops/cuda/qmatmul.py::mlp_queue, the planner's copy, is
// held equal to pq_mlp_queue's report on the card):
//   ids 0 .. n_a - 1, A items: hidden tile a_tile(id) of 128 columns, the
//     two halves j and j + i_ff/2 that a B split reads queued in pairs,
//     over all K/2 packed rows; each adds one to the ready counts of the
//     B splits fed(id);
//   then the B items, split-major: split (id - n_a) / ct, output tile
//     (id - n_a) % ct of 256 columns, packed rows [r0, r1) of the split.
struct Queue {
  int n_a, ct, kh, ih, rows_b;
  __host__ __device__ Queue(int k, int i_ff, int n, int rows_b_)
      : n_a(i_ff / kCols), ct((n + kItem - 1) / kItem), kh(k / 2),
        ih(i_ff / 2), rows_b(rows_b_) {}
  __host__ __device__ int total(int ksb) const { return n_a + ct * ksb; }
  __host__ __device__ int a_tile(int id) const {
    return (id & 1) * (n_a / 2) + (id >> 1);
  }
  __host__ __device__ int split(int id) const { return (id - n_a) / ct; }
  __host__ __device__ int tile(int id) const { return (id - n_a) % ct; }
  __host__ __device__ void rows(int id, int& r0, int& r1) const {
    r0 = id < n_a ? 0 : split(id) * rows_b;
    r1 = id < n_a ? kh : (r0 + rows_b < ih ? r0 + rows_b : ih);
  }
  // the splits [q0, q1] whose h rows A item id writes
  __host__ __device__ void fed(int id, int& q0, int& q1) const {
    const int j = a_tile(id) * kCols % ih;
    q0 = j / rows_b;
    q1 = (j + kCols - 1) / rows_b;
  }
  // the A items that feed split q
  __host__ __device__ int feeds(int q) const {
    const int r0 = q * rows_b, r1 = r0 + rows_b < ih ? r0 + rows_b : ih;
    return 2 * ((r1 + kCols - 1) / kCols - r0 / kCols);
  }
};

struct Params {
  const float* s13;     // [2 i_ff]
  const int* zp13;      // [2 i_ff]
  const float* s2;      // [n]
  const int* zp2;       // [n]
  const float* xsum;    // [m] or null
  __nv_bfloat16* h;     // [m, i_ff] scratch
  float* part_b;        // [ksb, m, n] scratch
  void* out;            // [m, n] bf16 or f32
  int* state;           // [2 + ceil(n / 256) + ksb], zero between launches
  int m, k, i_ff, n, ksb, rows_b, gelu, out_bf16;
};

__device__ __forceinline__ float comp(const float2& v, int e) {
  return e ? v.y : v.x;
}
__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// acc = the sum over `np` parts of 4 consecutive floats (at p, p + stride,
// ...) in part order, the loads of four parts in flight at once; read
// past L1 (other SMs wrote them in this launch).
__device__ __forceinline__ void sum_parts(const float* p, size_t stride,
                                          int np, float (&acc)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = 0.f;
  for (int s0 = 0; s0 < np; s0 += 4) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (s0 + u < np)
        v[u] = __ldcg(reinterpret_cast<const float4*>(p + (s0 + u) * stride));
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (s0 + u < np)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] += comp(v[u], e);
  }
}

__device__ __forceinline__ float act_fn(float g, int gelu) {
  if (gelu) {
    // jax.nn.gelu(approximate=True): 0.5 g (1 + tanh(sqrt(2/pi) (g + 0.044715 g^3)))
    const float c = 0.7978845608028654f;
    return 0.5f * g * (1.f + tanhf(c * (g + 0.044715f * g * g * g)));
  }
  return g / (1.f + expf(-g));    // SiLU
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void red_release(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// 4 bytes global -> shared without a register (completes at cp_wait)
__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   pq::smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Generic-proxy global writes / reads against the TMA's (async proxy).
__device__ __forceinline__ void fence_proxy_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// Spin until a count reaches `want`; trap (a launch error, not a hung
// card) after ~2 s.
__device__ __forceinline__ void wait_count(const int* f, int want) {
  for (int polls = 0; ld_acquire(f) < want; ++polls) {
    if (polls == (1 << 24)) __trap();
    __nanosleep(128);
  }
}

template <int MT>
__global__ void __launch_bounds__(kThreads, 1)
mlp_tc(const __grid_constant__ CUtensorMap w13_map,   // [k/2, 2 i_ff] u8
       const __grid_constant__ CUtensorMap x_map,     // [m, k] bf16
       const __grid_constant__ CUtensorMap w2_map,    // [i_ff/2, n] u8
       const __grid_constant__ CUtensorMap h_map,     // [m, i_ff] bf16
       const Params a) {
  using T = MlpTile<MT>;
  constexpr int R = T::R, KW = T::KW, NT = T::NT, CB = T::CB, XT = T::XT;
  constexpr int XIN = R * 2 < 128 ? R * 2 : 128;   // x box row bytes
  constexpr int NB = R * 2 / XIN;                   // x boxes a plane
  const Layout L = layout<MT>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const smem =
      smem_raw + ((1024 - (pq::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* const empty = full + kMaxStages;
  int* const tag = reinterpret_cast<int*>(empty + kMaxStages);  // item id (-1: end)
  int* const tag_k = tag + kMaxStages;      // the stage's index in its item
  int* const xpend = tag_k + kMaxStages;    // thread 0: h boxes not issued
  float* const part = reinterpret_cast<float*>(smem + 1024);
  float* const partx = part + KW * XT * kPitch;
  uint8_t* const sides = smem + 1024 + L.part;   // [2][kSide]
  uint8_t* const ring = sides + 2 * kSide;

  const int m = a.m, i_ff = a.i_ff, n = a.n;
  const int kh = a.k / 2, ih = i_ff / 2;
  const Queue qu(a.k, i_ff, n, a.rows_b);
  const int n_a = qu.n_a;                   // A items: 128 hidden columns
  const int ct = qu.ct;                     // output tiles of B
  const int total = qu.total(a.ksb);
  int* const done_b = a.state + kDoneB;     // [ct] splits done a B tile
  int* const ready = done_b + ct;           // [ksb]
  const int S = L.stages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wc = warp % T::WN, kw = warp / T::WN;
  const int cl = wc * T::CW + g * CB;       // the lane's first column
  const int box = cl / kCols, cb = cl % kCols;   // its box, column there
  const bool own_xsum = a.xsum == nullptr;

  auto stages_of = [&](int id) {
    int r0, r1;
    qu.rows(id, r0, r1);
    return (r1 - r0 + R - 1) / R;
  };

  // ---- the issuing thread's state (thread 0) ----
  int is_id = -1, is_k = 0, is_nst = 0;
  bool ended = false;
  // Splits finish stage A out of order, so `verified` (the block's last
  // B split known ready) may only pass a split whose h boxes it issued:
  // it advances in issue order, which is split order (a block claims B
  // items split-major), and never while a stage waits (npend > 0), whose
  // split then lies above it.
  int verified = -1;
  int npend = 0;                            // stages whose h waits (xpend)
  // split q's count complete: then the TMA may read its h
  auto h_check = [&](int q) {
    if (ld_acquire(ready + q) < qu.feeds(q)) return false;
    fence_proxy_global();
    verified = q;
    return true;
  };

  auto issue_x = [&](uint8_t* base, const CUtensorMap* map, uint64_t* bar,
                     int plane_rows, int r0) {
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int b = 0; b < NB; ++b)
        tma_load_2d(base + L.w + (p * NB + b) * XT * XIN, map, bar,
                    p * plane_rows + r0 + b * (XIN / 2), 0, true);
  };
  // global stage gst of this block into its slot: the next stage of the
  // current item, claiming the next item from the queue when it is done
  auto issue = [&](int gst) {
    const int slot = gst % S;
    if (!ended && is_k == is_nst) {
      is_id = atomicAdd(a.state + kQueue, 1);
      is_k = 0;
      if (is_id >= total) ended = true;
      else is_nst = stages_of(is_id);
    }
    if (ended) {                            // an empty stage: the end
      tag[slot] = -1;
      mbar_arrive(&full[slot], true);
      return;
    }
    tag[slot] = is_id;
    tag_k[slot] = is_k;
    uint8_t* base = ring + slot * L.slot;
    mbar_arrive_tx(&full[slot], L.w + L.x, true);
    int r0, r1;
    qu.rows(is_id, r0, r1);
    r0 += is_k * R;
    if (is_id < n_a) {                      // gate and up columns
      const int j = qu.a_tile(is_id) * kCols;
      tma_load_2d(base, &w13_map, &full[slot], j, r0, true);
      tma_load_2d(base + R * kCols, &w13_map, &full[slot], i_ff + j, r0, true);
      issue_x(base, &x_map, &full[slot], kh, r0);
    } else {                                // two output tiles of 128
      const int c0 = qu.tile(is_id) * kItem;
      tma_load_2d(base, &w2_map, &full[slot], c0, r0, true);
      tma_load_2d(base + R * kCols, &w2_map, &full[slot], c0 + kCols, r0,
                  true);
      const int q = qu.split(is_id);
      if (q <= verified || (npend == 0 && h_check(q))) {
        issue_x(base, &h_map, &full[slot], ih, r0);
      } else {
        xpend[slot] = 1;
        ++npend;
      }
    }
    ++is_k;
  };

  if (threadIdx.x == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&w13_map) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&x_map) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&w2_map) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&h_map) : "memory");
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);                  // the issuing lane's arrival
      mbar_init(&empty[i], kThreads / 32);     // one arrival a warp
      xpend[i] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int st = 0; st < S; ++st) issue(st);

  float acc[NT][MT][4];
  float xacc[MT][2];                        // row sums of x (A) or h (B)
  auto zero = [&]() {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][i][e] = 0.f;
#pragma unroll
    for (int i = 0; i < MT; ++i) xacc[i][0] = xacc[i][1] = 0.f;
  };
  zero();
  int n_items = 0;                          // items this block has done

  // y (4 columns of row tok, starting at col) to the output, rounded once
  auto store_out = [&](int tok, int col, const float (&y)[4]) {
    const size_t o = (size_t)tok * n + col;
    if (a.out_bf16) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(y[0], y[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(y[2], y[3]);
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(a.out) + o) =
          make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                     *reinterpret_cast<const uint32_t*>(&hi));
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(a.out) + o) =
          make_float4(y[0], y[1], y[2], y[3]);
    }
  };

  // The item's 512 scales and zero points (A: gate scale, gate zp, up
  // scale, up zp of its 128 columns; B: scale, zp of its 256) into side
  // buffer `sb`, copied while the item streams
  auto fetch_side = [&](int id, int sb) {
    uint32_t* d = reinterpret_cast<uint32_t*>(sides + sb * kSide);
    for (int i = threadIdx.x; i < 512; i += kThreads) {
      const void* src;
      if (id < n_a) {
        const int j = qu.a_tile(id) * kCols + (i & 127) + (i & 256 ? i_ff : 0);
        src = i & 128 ? (const void*)(a.zp13 + j) : (const void*)(a.s13 + j);
      } else {
        const int col = min(qu.tile(id) * kItem + (i & 255), n - 1);
        src = i & 256 ? (const void*)(a.zp2 + col) : (const void*)(a.s2 + col);
      }
      cp4(d + i, src);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // the item's epilogue: the warps' sums in k-warp order, then A: fold,
  // activation, h, the ready counts; B: fold with its h sums, then a split
  // writes its part and counts itself done, and the last split adds the
  // others' parts (once they are all done) and its own, in split order
  auto epilogue = [&](int id, int sb) {
    __syncthreads();                        // the last epilogue's reads done
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float* d = part + (kw * XT + 8 * i + 2 * t + hr) * kPitch + cl;
#pragma unroll
        for (int c = 0; c < CB; c += 4)
          *reinterpret_cast<float4*>(d + c) =
              make_float4(acc[c / 2][i][hr], acc[c / 2][i][2 + hr],
                          acc[c / 2 + 1][i][hr], acc[c / 2 + 1][i][2 + hr]);
        if (i % T::WN == wc && g == 0)      // the warp that summed tile i
          partx[kw * XT + 8 * i + 2 * t + hr] = xacc[i][hr];
      }
    cp_wait();                              // this thread's side copies
    __syncthreads();
    const float* sf = reinterpret_cast<const float*>(sides + sb * kSide);
    const int* si = reinterpret_cast<const int*>(sf);
    auto row_sum = [&](int tok) {
      float s = partx[tok];
#pragma unroll
      for (int kk = 1; kk < KW; ++kk) s += partx[kk * XT + tok];
      return s;
    };
    // the sums of N (2 or 4) columns from col, over the K warps in order
    auto col_sum = [&](int tok, int col, float* y, auto vec) {
      using V = decltype(vec);
      constexpr int N = sizeof(V) / 4;
#pragma unroll
      for (int kk = 0; kk < KW; ++kk) {
        const V v = *reinterpret_cast<const V*>(part + (kk * XT + tok) * kPitch + col);
#pragma unroll
        for (int e = 0; e < N; ++e) y[e] = kk ? y[e] + comp(v, e) : comp(v, e);
      }
    };
    if (id < n_a) {                         // A: h of the tile's columns
      const int j0 = qu.a_tile(id) * kCols;
      for (int i = threadIdx.x; i < m * (kCols / 2); i += kThreads) {
        const int tok = i / (kCols / 2), cc = (i % (kCols / 2)) * 2;
        const float xs = own_xsum ? row_sum(tok) : a.xsum[tok];
        float gs[2], us[2], hv[2];
        col_sum(tok, cc, gs, float2());
        col_sum(tok, kCols + cc, us, float2());
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = cc + e;
          const float sg = sf[c], su = sf[256 + c];
          const float gg = gs[e] * sg - xs * ((float)si[128 + c] * sg);
          const float uu = us[e] * su - xs * ((float)si[384 + c] * su);
          hv[e] = act_fn(gg, a.gelu) * uu;
        }
        *reinterpret_cast<__nv_bfloat162*>(a.h + (size_t)tok * i_ff + j0 + cc) =
            __floats2bfloat162_rn(hv[0], hv[1]);
      }
      fence_proxy_global();                 // h is read back by TMA
      __syncthreads();
      if (threadIdx.x == 0) {               // the splits these columns feed
        int q0, q1;
        qu.fed(id, q0, q1);
        for (int q = q0; q <= q1; ++q) red_release(ready + q, 1);
      }
      return;
    }
    const int c = qu.tile(id), q = qu.split(id), c0 = c * kItem;
    const bool last = q == a.ksb - 1;       // block-uniform
    if (last) {
      if (threadIdx.x == 0 && a.ksb > 1) {  // the other splits' parts
        wait_count(done_b + c, a.ksb - 1);
        done_b[c] = 0;
      }
      __syncthreads();
    }
    for (int qi = threadIdx.x; qi < m * (kItem / 4); qi += kThreads) {
      const int tok = qi / (kItem / 4), c4 = (qi % (kItem / 4)) * 4;
      const int col = c0 + c4;
      if (col >= n) continue;               // a last tile of 128 columns
      const float hs = row_sum(tok);
      float y[4];
      col_sum(tok, c4, y, float4());
      const float4 s4 = *reinterpret_cast<const float4*>(sf + c4);
      const int4 z4 = *reinterpret_cast<const int4*>(si + 256 + c4);
      const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
      const int zv[4] = {z4.x, z4.y, z4.z, z4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        y[e] = y[e] * sv[e] - hs * ((float)zv[e] * sv[e]);
      if (!last) {
        *reinterpret_cast<float4*>(a.part_b + ((size_t)q * m + tok) * n + col) =
            make_float4(y[0], y[1], y[2], y[3]);
        continue;
      }
      if (a.ksb > 1) {
        float p[4];
        sum_parts(a.part_b + (size_t)tok * n + col, (size_t)m * n, a.ksb - 1,
                  p);
#pragma unroll
        for (int e = 0; e < 4; ++e) y[e] = p[e] + y[e];
      }
      store_out(tok, col, y);
    }
    if (!last) {                            // this split's part is written
      __syncthreads();
      if (threadIdx.x == 0) red_release(done_b + c, 1);
    }
  };

  for (int st = 0;; ++st) {
    const int slot = st % S;
    // thread 0: B stages whose h boxes wait for stage A (all of this
    // block's A items are done by now): wait for this stage's split, then
    // issue the h of the waiting stages in ring (= issue) order while
    // their splits are ready, stopping at the first that is not
    if (threadIdx.x == 0 && xpend[slot]) {
      const int q0 = qu.split(tag[slot]);
      wait_count(ready + q0, qu.feeds(q0));
      fence_proxy_global();
      verified = q0;
      for (int i = 0; i < S; ++i) {
        const int sl = (slot + i) % S, id = tag[sl];
        if (!xpend[sl]) continue;
        const int q = qu.split(id);
        if (q > verified && !h_check(q)) break;
        int r0, r1;
        qu.rows(id, r0, r1);
        issue_x(ring + sl * L.slot, &h_map, &full[sl], ih,
                r0 + tag_k[sl] * R);
        xpend[sl] = 0;
        --npend;
      }
    }
    mbar_wait(&full[slot], (st / S) & 1);
    const int id = tag[slot];
    if (id < 0) break;
    const int kk = tag_k[slot];
    if (kk == 0) fetch_side(id, n_items & 1);
    const uint8_t* ws = ring + slot * L.slot + box * (R * kCols);
    const uint8_t* xsm = ring + slot * L.slot + L.w;
    int r0, r1;
    qu.rows(id, r0, r1);
    const int live_rows = min(R, r1 - r0 - kk * R);
    const bool sums = id >= n_a || own_xsum;   // the row sums of h or x
    // one block of 16 rows a warp: k16 step rows 2t, 2t + 1 (half 0) and
    // 8 + 2t, 9 + 2t (half 1) of each plane
#pragma unroll
    for (int rb = 16 * kw; rb < live_rows; rb += 16 * KW) {
      uint32_t pr[2][CB / 4][2];            // [half][word][cols 0,2 | 1,3]
      {
        uint32_t wv[4][CB / 4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          load_row<CB>(wv[i], wrow(ws, rb + 2 * t + (i & 1) + 8 * (i >> 1), cb));
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int d = 0; d < CB / 4; ++d)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              pr[hf][d][e] = __byte_perm(wv[2 * hf][d], wv[2 * hf + 1][d],
                                         e ? 0x7531 : 0x6420);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        uint32_t b[MT][2];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int e = (rb + 2 * t) * 2;
          b[i][0] = *reinterpret_cast<const uint32_t*>(
              xaddr<XIN, NB, XT>(xsm, q, 8 * i + g, e));
          b[i][1] = *reinterpret_cast<const uint32_t*>(
              xaddr<XIN, NB, XT>(xsm, q, 8 * i + g, e + 16));
          if (sums && i % T::WN == wc) mma_ones_bf16(xacc[i], b[i]);
        }
        uint32_t am[NT][4];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int d = 0; d < CB / 4; ++d)
#pragma unroll
            for (int s2 = 0; s2 < 2; ++s2) {
              const int j = 2 * d + s2;     // tile j: lane columns 2j, 2j + 1
              if (j >= NT) continue;
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const uint32_t v = pr[hf][d][e] >> (8 * s2);
                am[j][2 * hf + e] = q ? code_pair<2, 1>(v) : code_pair<2, 0>(v);
              }
            }
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int i = 0; i < MT; ++i) mma_bf16(acc[j][i], am[j], b[i]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot], true);
    // thread 0 refills the slot of stage st - 1 once every warp released it
    // (after its own stage st, so it seldom waits)
    if (threadIdx.x == 0 && st > 0) {
      mbar_wait(&empty[(st - 1) % S], ((st - 1) / S) & 1);
      issue(st - 1 + S);
    }
    if (kk == stages_of(id) - 1) {
      epilogue(id, n_items & 1);
      ++n_items;
      zero();
    }
  }

  // the last block out leaves the state zero for the next launch
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(a.state + kDone, 1) == (int)gridDim.x - 1) {
      __threadfence();
      a.state[kQueue] = 0;
      a.state[kDone] = 0;
      for (int q = 0; q < a.ksb; ++q) ready[q] = 0;
      __threadfence();
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <int MT>
cudaError_t prepare() {
  static const cudaError_t e = cudaFuncSetAttribute(
      mlp_tc<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  return e;
}

struct Host {
  const void *x, *w13, *w2;
  Params p;
  int blocks;
  cudaStream_t stream;
};

// The tensor maps: w13 and w2 in boxes of 128 columns x R rows (128-byte
// swizzle; columns past n read as zeros), x and h in boxes of XIN bytes x
// 8 MT tokens (the swizzle of that width; rows past m read as zeros).
template <int MT>
int launch_mt(const Host& hs) {
  using pq::encode;
  constexpr int R = MlpTile<MT>::R;
  constexpr int XIN = R * 2 < 128 ? R * 2 : 128;
  const Params& a = hs.p;
  const CUtensorMapSwizzle xsw = XIN == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : XIN == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                             : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap mp[4];
  const uint64_t w13d[2] = {(uint64_t)(2 * a.i_ff), (uint64_t)(a.k / 2)};
  const uint64_t xd[2] = {(uint64_t)a.k, (uint64_t)a.m};
  const uint64_t w2d[2] = {(uint64_t)a.n, (uint64_t)(a.i_ff / 2)};
  const uint32_t wb[2] = {kCols, R};
  const uint64_t hd[2] = {(uint64_t)a.i_ff, (uint64_t)a.m};
  const uint32_t xb[2] = {XIN / 2, 8 * MT};
  if (!encode(&mp[0], CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 2, hs.w13, w13d, wb,
              CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&mp[1], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 2, hs.x, xd, xb,
              xsw) ||
      !encode(&mp[2], CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 2, hs.w2, w2d, wb,
              CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&mp[3], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 2, a.h, hd, xb,
              xsw))
    return (int)cudaErrorInvalidValue;
  const cudaError_t set = prepare<MT>();
  if (set != cudaSuccess) return (int)set;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(hs.blocks, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = layout<MT>().total;
  cfg.stream = hs.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;   // every block resident
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, mlp_tc<MT>, mp[0], mp[1], mp[2], mp[3], a);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

int n8_tiles(int m) { return m <= 8 ? 1 : m <= 16 ? 2 : m <= 32 ? 4 : 8; }

template <int MT>
int attributes_mt(int* out) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, mlp_tc<MT>);
  if (e != cudaSuccess) return (int)e;
  if ((e = prepare<MT>()) != cudaSuccess) return (int)e;
  const Layout L = layout<MT>();
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = L.total;
  out[3] = L.stages;
  out[4] = MlpTile<MT>::R;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[5], mlp_tc<MT>, kThreads, L.total);
}

// Splits of whole stages that cover `rows` packed rows once.
bool covers(long rows, int splits, int per, int stage) {
  return splits >= 1 && per > 0 && per % stage == 0 &&
         (long)splits * per >= rows && (long)(splits - 1) * per < rows;
}

}  // namespace

// x [m, k] bf16; w13 [k/2, 2 i_ff] u8 split-half codes of [w1 | w3], s13 /
// zp13 [2 i_ff] f32 / int32; w2 [i_ff/2, n] u8, s2 / zp2 [n]; xsum [m] f32
// or null (then summed here from x); out [m, n] (bf16 if out_bf16 else
// f32); scratch h [m, i_ff] bf16 and part_b [ksb, m, n] f32; state
// [2 + ceil(n / 256) + ksb] int32, zero before the first launch (each
// launch leaves it zero).  Needs 1 <= m <= 64, k % 256 == 0, i_ff % 256 ==
// 0, n % 128 == 0, 16-byte aligned operands, rows_b a multiple of the
// instance's stage rows (pq_mlp_attributes' out[4]) with ksb splits
// covering the i_ff / 2 packed rows of w2 once, and at most as many blocks
// as the card holds at once (ops/cuda/qmatmul.py::mlp_plan).  Returns
// cudaGetLastError() or the launch's error.
extern "C" int pq_mlp_fused(const void* x, const void* w13, const void* s13,
                            const void* zp13, const void* w2, const void* s2,
                            const void* zp2, const void* xsum, void* out,
                            void* h, void* part_b, void* state, int m, int k,
                            int i_ff, int n, int ksb, int rows_b, int blocks,
                            int gelu, int out_bf16, void* stream) {
  if (m < 1 || m > 64 || k % 256 || i_ff % 256 || n % kCols || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const int mt = n8_tiles(m);
  const int stage = mt == 1 ? MlpTile<1>::R
                    : mt == 2 ? MlpTile<2>::R
                    : mt == 4 ? MlpTile<4>::R : MlpTile<8>::R;
  if (!covers(i_ff / 2, ksb, rows_b, stage)) return (int)cudaErrorInvalidValue;
  const Host hs{x, w13, w2,
                Params{static_cast<const float*>(s13),
                       static_cast<const int*>(zp13),
                       static_cast<const float*>(s2),
                       static_cast<const int*>(zp2),
                       static_cast<const float*>(xsum),
                       static_cast<__nv_bfloat16*>(h),
                       static_cast<float*>(part_b), out,
                       static_cast<int*>(state), m, k, i_ff, n, ksb, rows_b,
                       gelu, out_bf16},
                blocks, reinterpret_cast<cudaStream_t>(stream)};
  switch (mt) {
    case 1: return launch_mt<1>(hs);
    case 2: return launch_mt<2>(hs);
    case 4: return launch_mt<4>(hs);
    default: return launch_mt<8>(hs);
  }
}

// The work queue of a launch (Queue), an item a row of out[5 * items]:
// A items {0, hidden tile, packed rows r1 (all K/2), first and last split
// fed}, B items {1, output tile, rows r0, r1, split}; then the count of A
// items feeding each of the ksb splits.  Returns the items, or -1 where
// the split does not cover the rows once.
extern "C" int pq_mlp_queue(int k, int i_ff, int n, int ksb, int rows_b,
                            int* out) {
  if (k % 256 || i_ff % 256 || n % kCols || !covers(i_ff / 2, ksb, rows_b, 1))
    return -1;
  const Queue qu(k, i_ff, n, rows_b);
  const int items = qu.total(ksb);
  for (int id = 0; id < items; ++id) {
    int* o = out + 5 * id;
    int r0, r1;
    qu.rows(id, r0, r1);
    if (id < qu.n_a) {
      int q0, q1;
      qu.fed(id, q0, q1);
      o[0] = 0, o[1] = qu.a_tile(id), o[2] = r1, o[3] = q0, o[4] = q1;
    } else {
      o[0] = 1, o[1] = qu.tile(id), o[2] = r0, o[3] = r1, o[4] = qu.split(id);
    }
  }
  for (int q = 0; q < ksb; ++q) out[5 * items + q] = qu.feeds(q);
  return items;
}

// Registers, local (spill) bytes, dynamic shared memory, ring stages,
// packed rows a stage (the unit of rows_b) and the blocks an SM holds at
// once (out[0..5]) of the instance at mt n8 token tiles (1, 2, 4, 8).
extern "C" int pq_mlp_attributes(int mt, int* out) {
  switch (mt) {
    case 1: return attributes_mt<1>(out);
    case 2: return attributes_mt<2>(out);
    case 4: return attributes_mt<4>(out);
    case 8: return attributes_mt<8>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}
