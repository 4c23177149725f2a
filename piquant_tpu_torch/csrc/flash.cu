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
// 256; any GQA rep of 1 or more; the window w is T for the plain causal mask
// (every key j <= i < T then has j > i - T).  Mask on indices (positions
// are contiguous per row), the softcap on the scaled score before the mask
// (tanhf, not the approximate tanh: at c = 50 its 2^-11 relative error is
// 0.02 of a logit); online softmax in f32 (running max, denominator and
// context), bf16 operands for both products, the probabilities rounded to
// bf16 before the PV product, and the denominator taken from the unrounded
// probabilities, the sink joining it as exp(snk - m) against the row's
// final running max: the TPU kernel's recipe.  The context is o / l, an
// IEEE division.
//
// Bound on the H100: the live (q, k) pairs' operations (4 D a pair) at the
// 989 TFLOP/s bf16 tensor-core peak, or the bytes (q, k, v read once, the
// f32 context written once: 57% of them at Llama-3-8B's shape) at 3.35
// TB/s, whichever is larger: 0.0701 ms at B 8, Hkv 8, rep 4, T 1024.  The
// first design (PRs 1-9: Ampere's warp-level m16n8k16 MMA, 64-key tiles
// loaded through registers between two __syncthreads(), 16 rows a warp and
// 16 (8 / rep) positions a block) took 0.6642 ms there, 4.4x SDPA's
// 0.1519; rep 7 (Qwen2-7B) 0.6158, Gemma-7B (D 256, rep 1) 0.3735,
// Gemma-2B (D 256, rep 8) 0.3136 (H100 80GB HBM3, 700 W).  What held it
// back, and this design:
//   1. products on the warp-level MMA: here both are wgmma (sm_90a).  S =
//      Q K^T is a shared-memory x shared-memory m64nNk16 (Q and K both
//      K-major under the 128-byte swizzle, a 64-element atom a row of 128
//      bytes); O += P V takes P from registers (the S accumulator rounded
//      to bf16 pairs is exactly wgmma's A fragment of each k16 step) and V
//      [keys, D] from shared memory as an MN-major B (the transpose bit).
//      Key tiles: N 128 at D 128 (S 64 and O 64 f32 registers a thread),
//      N 64 at D 256 (S 32, O 128, as two m64n128 halves).  P is packed
//      only once the P V that reads the last P has retired: wgmma reads
//      its A registers until then, and ptxas serializes every wgmma of a
//      kernel that redefines them earlier;
//   2. synchronous loads: here TMA, from a producer warpgroup (setmaxnreg:
//      24 registers a producer thread, 240 a consumer; no spills) whose
//      one thread loads each item's Q (zero fill past T) and streams K and
//      V tiles into a ring of S stages (3 at D 128, 2 at D 256: Q 32 KB +
//      3 x 64 KB, or Q 64 KB + 2 x 64 KB) with a full and an empty
//      mbarrier for each K slot and each V slot, so the next tile's Q K^T
//      can start before this tile's V has landed.  The consumers only wait
//      and release: refilling from a consumer thread stalled its whole
//      warpgroup at every tile;
//   3. small, unevenly filled tiles: here a work item is 128 rows, the rep
//      heads of ONE kv head times bq = 128 / rep (integer division)
//      positions, head-major (row r * bq + i, the reference's order), so
//      every K/V tile serves all rep heads and rep 3, 5, 6, 7 fill 126,
//      125, 126, 126 rows (rep 12 and 16: 10 and 8 positions, 120 and 128
//      rows; rep 64: 2 positions); the padding rows are zeroed once and
//      never stored.  A rep above 128 cannot share an item: its heads go
//      in groups of 128, one position an item (the group a coordinate of
//      the item, as the kv head is).  Two consumer warpgroups own 64 rows
//      each (wgmma M 64);
//   4. per-element expf and a separate scale: here the scale and log2(e)
//      are one multiply and the exponent one ex2 (MUFU).  Folding the
//      scale into the exponent's FFMA saved an instruction an element but
//      left a row's largest score a rounding short of exp(0) = 1, so it is
//      not done.  The softmax is issue-bound (an exp2 on the FMA pipes for
//      part of the elements was slower), so it must run under the tensor
//      cores: each step issues tile n's Q K^T and tile n - 1's P V, runs
//      tile n's softmax while they retire, and the two warpgroups take
//      turns at the tensor cores (FA3's pingpong: named barriers 1 and 2),
//      so one's softmax runs under the other's products;
//   5. warp-divergent tile skips and masks: here the walk and the mask
//      are uniform in the block.  Key tiles walk from the tile holding the
//      item's first row start (start(q0) rounded down to N) to its last
//      row (the TPU kernel's dead-block elision: a windowed or chunked
//      prefill reads only the live K/V bytes); a tile is interior (no
//      mask) when every key lies at or below the item's first position and
//      at or past its last row's start, else every element is masked (the
//      diagonal, a window or chunk start, T).  The choice is made once a
//      step, with no wgmma of the warpgroup in flight, between two
//      instantiations of the step; every branch taken while wgmmas are in
//      flight lives inside an asm block.  A row with no live key yet keeps
//      the sentinel max, and its exponents are taken against 0.
// The grid is persistent, one block an SM: the producer loads the next
// item's Q and tiles while the consumers finish an item and store its
// context (direct 8-byte stores, four lanes filling a 32-byte sector, none
// past T; staging it for a TMA store was slower), and the items go
// heaviest first, snake-wise across the blocks.  The row start is a
// template mode: causal (its start code compiled out), window or chunk;
// no softcap compiles the softcap out, and no sinks the sink epilogue: 24
// instances.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pq_hopper.cuh"

namespace {

using namespace pq;

constexpr int kThreads = 256;       // two consumer warpgroups
constexpr int kBlockThreads = 384;  // and a producer warpgroup
constexpr int kRows = 128;          // query rows a block (64 a warpgroup)
constexpr int kSmemMax = 232448;    // a block's shared memory
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>   // keys a tile
__host__ __device__ constexpr int keys() { return D == 128 ? 128 : 64; }
template <int D>   // one K (or V) tile: D / 64 atoms of keys x 128 bytes
__host__ __device__ constexpr int tile_bytes() { return keys<D>() * D * 2; }
template <int D>   // Q: D / 64 atoms of 128 rows x 128 bytes
__host__ __device__ constexpr int q_bytes() { return kRows * D * 2; }
template <int D>   // K/V stages: as many as fit, at most 3
__host__ __device__ constexpr int n_stages() {
  const int fit =
      (kSmemMax - 1024 - 256 - q_bytes<D>()) / (2 * tile_bytes<D>());
  return fit < 3 ? fit : 3;
}
template <int D>   // 1 KB to align, Q, the K and V rings, 2 + 4 S barriers
__host__ __device__ constexpr int smem_bytes() {
  return 1024 + q_bytes<D>() + 2 * n_stages<D>() * tile_bytes<D>() +
         (2 + 4 * n_stages<D>()) * 8;
}

// the row-start modes: kCausal, the plain causal mask (window, chunk and
// pos0 are ignored, the walk starts at key 0, where every row has a live
// key); kWindow, the sliding window; kChunk, Llama-4's chunk
constexpr int kCausal = 0, kWindow = 1, kChunk = 2;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Keeps the compiler from moving reads or writes of wgmma accumulators
// across a wgmma wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d[64 x 128] (= or +=, by acc) A[64 x 16] . B[16 x 128], both bf16 in
// shared memory, K-major; f32 sums.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a,
                                         uint64_t desc_b, bool acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"((int)acc));
}

// The same at N 64.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, bool acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"((int)acc));
}

// A thread's view of its block's work item: the K/V ring, the item's key
// walk, the thread's rows, their running softmax and context.  Every
// method is inlined into the kernel, so the arrays live in registers (all
// their indices are compile-time constants).
// kSoftcap false: no softcap (softcap and inv_softcap are ignored).
template <int D, int kMode, bool kSoftcap>
struct Block {
  static constexpr int N = keys<D>();
  static constexpr int S = n_stages<D>();
  static constexpr int kAtoms = D / 64;     // 64-element atoms of a row
  static constexpr int kTile = tile_bytes<D>();
  static constexpr int kQAtom = kRows * 128;   // one atom of Q
  static constexpr int kKAtom = N * 128;    // one atom of a K or V tile
  static constexpr int kHalves = D / 128;   // m64n128 halves of O
  static constexpr bool kStarts = kMode != kCausal;

  const CUtensorMap* k_map;
  const CUtensorMap* v_map;
  uint8_t* ks;
  uint8_t* vs;
  uint64_t* kfull;
  uint64_t* vfull;
  uint64_t* kempty;
  uint64_t* vempty;
  uint64_t* qempty;
  uint32_t q_addr, k_addr, v_addr;
  // the item's first key, tiles, kv head row and the ring position of its
  // tile 0 (the ring runs on across a block's items)
  int kbegin, n_tiles, bh, g0;
  int wg, lane, tq;
  int qp_a, qp_b, st_a, st_b;   // the thread's rows' positions and starts
  bool leader;
  float sm_scale, inv_softcap, scale_l2, cap_l2;

  float o[kHalves][64];
  float s[N / 2];
  uint32_t p[N / 16][4];
  float m_a, m_b, l_a, l_b;

  // TMA loads of the item's tile n's K (or V) into the slot of ring
  // position g, issued where `on`
  __device__ __forceinline__ void load_k(int g, int n, bool on) {
    const int sl = g % S;
    mbar_arrive_tx(&kfull[sl], kTile, on);
#pragma unroll
    for (int a = 0; a < kAtoms; ++a)
      tma_load_3d(ks + sl * kTile + a * kKAtom, k_map, &kfull[sl], 64 * a,
                  kbegin + n * N, bh, on);
  }
  __device__ __forceinline__ void load_v(int g, int n, bool on) {
    const int sl = g % S;
    mbar_arrive_tx(&vfull[sl], kTile, on);
#pragma unroll
    for (int a = 0; a < kAtoms; ++a)
      tma_load_3d(vs + sl * kTile + a * kKAtom, v_map, &vfull[sl], 64 * a,
                  kbegin + n * N, bh, on);
  }

  // S = Q K^T of the tile in slot sl, one commit group
  __device__ __forceinline__ void issue_s(int sl) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, desc_sw128(q_addr + (kk / 4) * kQAtom + (kk % 4) * 32),
               desc_sw128(k_addr + sl * kTile + (kk / 4) * kKAtom +
                          (kk % 4) * 32),
               kk > 0);
    wgmma_commit();
  }

  // O += P V of the tile in slot sl, one commit group
  __device__ __forceinline__ void issue_pv(int sl) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
      for (int hf = 0; hf < kHalves; ++hf)
        wgmma_rs<1>(o[hf], p[kk],
                    desc_sw128(v_addr + sl * kTile + kk * 2048 +
                                   hf * 2 * kKAtom,
                               kKAtom));
    wgmma_commit();
  }

  // The softmax of the tile at keys k0 in s: the scale in log2 units (and
  // the cap), the mask (kMask: every element), the running max, the
  // probabilities in place, the denominator; the O rescale factors into
  // ca, cb.  s[4j + e] is row a, key k0 + 8j + 2tq + e; s[4j + 2 + e] row
  // b.  The scale is applied before the max (not folded into the
  // exponent's FFMA), so a row's largest score gives exactly 1.
  template <bool kMask>
  __device__ __forceinline__ void softmax(int k0, float& ca, float& cb) {
    float mx_a[2] = {kNegInf, kNegInf}, mx_b[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float xa = s[4 * j + e], xb = s[4 * j + 2 + e];
        if constexpr (kSoftcap) {
          xa = cap_l2 * tanhf(xa * sm_scale * inv_softcap);
          xb = cap_l2 * tanhf(xb * sm_scale * inv_softcap);
        } else {
          xa *= scale_l2;
          xb *= scale_l2;
        }
        if constexpr (kMask) {
          const int key = k0 + 8 * j + 2 * tq + e;
          if (key > qp_a || (kStarts && key < st_a)) xa = kNegInf;
          if (key > qp_b || (kStarts && key < st_b)) xb = kNegInf;
        }
        s[4 * j + e] = xa;
        s[4 * j + 2 + e] = xb;
        mx_a[e] = fmaxf(mx_a[e], xa);
        mx_b[e] = fmaxf(mx_b[e], xb);
      }
    float mxa = fmaxf(mx_a[0], mx_a[1]), mxb = fmaxf(mx_b[0], mx_b[1]);
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, off));
      mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, off));
    }
    const float mn_a = fmaxf(m_a, mxa), mn_b = fmaxf(m_b, mxb);
    ca = ex2(m_a - mn_a);
    cb = ex2(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    // under a window or a chunk, a row with no live key yet keeps the
    // sentinel as its max: its exponents are taken against 0, so its
    // masked scores give 0 (causally, key 0 of the first tile is live for
    // every row)
    const float e_a = kStarts && mn_a == kNegInf ? 0.f : mn_a;
    const float e_b = kStarts && mn_b == kNegInf ? 0.f : mn_b;
    float sum_a[2] = {0.f, 0.f}, sum_b[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[4 * i + e] = ex2(s[4 * i + e] - e_a);
        s[4 * i + 2 + e] = ex2(s[4 * i + 2 + e] - e_b);
        sum_a[e] += s[4 * i + e];
        sum_b[e] += s[4 * i + 2 + e];
      }
    }
    l_a = l_a * ca + (sum_a[0] + sum_a[1]);
    l_b = l_b * cb + (sum_b[0] + sum_b[1]);
  }

  // The probabilities in s as bf16 pairs into p, the A fragments of P V:
  // k16 step kk holds row a's keys 2tq, 2tq + 1, row b's, then both at +8.
  // Only once no P V is in flight, since p is that product's input.
  __device__ __forceinline__ void pack() {
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      p[i / 2][2 * (i % 2)] = pack_bf16(s[4 * i], s[4 * i + 1]);
      p[i / 2][2 * (i % 2) + 1] = pack_bf16(s[4 * i + 2], s[4 * i + 3]);
    }
  }

  // The tensor cores alternate between the two warpgroups (FA3's
  // pingpong): a warpgroup issues its products on its turn (named barrier
  // 1 + wg) and passes the turn to the other (barrier 2 - wg), so one
  // warpgroup's softmax runs under the other's products.
  __device__ __forceinline__ void turn() {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "r"(kThreads)
                 : "memory");
  }
  __device__ __forceinline__ void pass(bool on) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %2, 0;\n"
        "@p bar.arrive %0, %1;\n"
        "}\n" ::"r"(2 - wg),
        "r"(kThreads), "r"((int)on)
        : "memory");
  }

  // Tile 0: its Q K^T alone, then its softmax into p (O is still zero).
  template <bool kMask>
  __device__ __forceinline__ void first() {
    mbar_wait(&kfull[g0 % S], (g0 / S) & 1);
    turn();
    issue_s(g0 % S);
    pass(true);
    wgmma_wait<0>();
    fence_regs(s);
    mbar_arrive(&kempty[g0 % S], lane == 0);
    float ca, cb;
    softmax<kMask>(kbegin, ca, cb);
    pack();
  }

  // One step of the key walk: tile n's Q K^T and tile n - 1's P V in
  // flight together, tile n's softmax under the second (and under the
  // other warpgroup's products), then O rescaled and tile n's P packed;
  // nothing of the warpgroup is in flight between steps.
  template <bool kMask>
  __device__ __forceinline__ void step(int n) {
    const int g = g0 + n, sl = g % S, pl = (g - 1) % S;
    mbar_wait(&kfull[sl], (g / S) & 1);
    mbar_wait(&vfull[pl], ((g - 1) / S) & 1);
    turn();
    issue_s(sl);
    issue_pv(pl);
    pass(true);
    wgmma_wait<1>();                          // Q K^T done
    fence_regs(s);
    mbar_arrive(&kempty[sl], lane == 0);
    float ca, cb;
    softmax<kMask>(kbegin + n * N, ca, cb);
    wgmma_wait<0>();                          // P V done
#pragma unroll
    for (int hf = 0; hf < kHalves; ++hf) fence_regs(o[hf]);
    mbar_arrive(&vempty[pl], lane == 0);
#pragma unroll
    for (int hf = 0; hf < kHalves; ++hf)
#pragma unroll
      for (int i = 0; i < 64; i += 4) {
        o[hf][i] *= ca;
        o[hf][i + 1] *= ca;
        o[hf][i + 2] *= cb;
        o[hf][i + 3] *= cb;
      }
    pack();
  }

  // The last tile's P V.  Every Q K^T of the item is done: Q's buffer is
  // released for the next item first.  Warpgroup 1 passes no turn after
  // the block's final item: warpgroup 0 takes no more.
  __device__ __forceinline__ void last(bool final) {
    mbar_arrive(qempty, lane == 0);
    const int g = g0 + n_tiles - 1, pl = g % S;
    mbar_wait(&vfull[pl], (g / S) & 1);
    turn();
    issue_pv(pl);
    pass(wg == 0 || !final);
    wgmma_wait<0>();
#pragma unroll
    for (int hf = 0; hf < kHalves; ++hf) fence_regs(o[hf]);
    mbar_arrive(&vempty[pl], lane == 0);
  }
};

// kSinks false: no sinks (sinks is ignored).
//
// A persistent grid of G blocks walks the work items in rounds of G,
// snake-wise: block c takes item r G + c in even rounds r and r G + G - 1
// - c in odd ones, item i being query block nq - 1 - i / (B Hkv) of kv
// head row i % (B Hkv).  The heaviest items go first, and the snake evens
// out each block's sum of work.  Warpgroup 2 is the producer: its thread
// 0 loads each item's Q once the last item's Q K^T are done, and K/V tiles
// into the ring as slots free, running on into the next item while the
// consumers finish this one.
template <int D, int kMode, bool kSoftcap, bool kSinks>
__global__ void __launch_bounds__(kBlockThreads, 1)
flash_prefill_kernel(const __grid_constant__ CUtensorMap q_map,  // q
                     const __grid_constant__ CUtensorMap k_map,  // k
                     const __grid_constant__ CUtensorMap v_map,  // v
                     float* __restrict__ out,
                     const int* __restrict__ pos0,
                     const float* __restrict__ sinks,
                     int nb, int nh, int rep, int t, int window, int chunk,
                     float sm_scale, float softcap, float inv_softcap) {
  using Blk = Block<D, kMode, kSoftcap>;
  constexpr int N = Blk::N;
  constexpr int S = Blk::S;
  constexpr int kAtoms = Blk::kAtoms;
  constexpr int kTile = Blk::kTile;
  constexpr int kQAtom = Blk::kQAtom;
  constexpr bool kStarts = Blk::kStarts;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* const qfull =
      reinterpret_cast<uint64_t*>(qs + q_bytes<D>() + 2 * S * kTile);

  Blk blk;
  blk.k_map = &k_map;
  blk.v_map = &v_map;
  blk.ks = qs + q_bytes<D>();
  blk.vs = blk.ks + S * kTile;
  blk.kfull = qfull + 1;
  blk.vfull = blk.kfull + S;
  blk.kempty = blk.vfull + S;
  blk.vempty = blk.kempty + S;
  blk.qempty = blk.vempty + S;

  const int hpi = min(rep, kRows);               // heads an item
  const int ngrp = (rep + hpi - 1) / hpi;        // head groups a kv head
  const int bq = kRows / hpi;                    // positions an item
  const int live = hpi * bq;                     // rows holding a query
  const int nq = (t + bq - 1) / bq;
  const int rows_kv = nb * nh * ngrp;
  const int items = nq * rows_kv;
  // item i: its first position, kv head row, head group and key walk
  int q0 = 0, p0 = 0, kend = 0, last_start = 0, h0 = 0;
  auto row_start = [&](int qp) -> int {
    if constexpr (kMode == kWindow) return qp - (window - 1);
    else return (p0 + qp) / chunk * chunk - p0;
  };
  auto item = [&](int i) {
    q0 = (nq - 1 - i / rows_kv) * bq;
    blk.bh = i % rows_kv / ngrp;
    h0 = i % rows_kv % ngrp * hpi;
    p0 = kMode == kChunk ? __ldg(pos0 + blk.bh / nh) : 0;
    kend = min(t, q0 + bq);
    blk.kbegin = kStarts ? max(0, row_start(q0)) / N * N : 0;
    blk.n_tiles = (kend - blk.kbegin + N - 1) / N;
    last_start = kStarts ? row_start(kend - 1) : 0;
  };
  // a tile is interior (no mask) when its keys lie at or below q0 and at
  // or past the last row's start
  auto masked = [&](int n) -> bool {
    const int k0 = blk.kbegin + n * N;
    return k0 + N - 1 > q0 || (kStarts && k0 < last_start);
  };
  // block c's item of round r (>= items: none left)
  auto item_of = [&](int r) -> int {
    return r * (int)gridDim.x +
           (r & 1 ? (int)gridDim.x - 1 - (int)blockIdx.x : (int)blockIdx.x);
  };
  blk.leader = threadIdx.x == kThreads;

  if (blk.leader) {
    mbar_init(qfull, 1);
    mbar_init(blk.qempty, kThreads / 32);
    for (int s = 0; s < S; ++s) {
      mbar_init(&blk.kfull[s], 1);              // the leader's arrival
      mbar_init(&blk.vfull[s], 1);
      mbar_init(&blk.kempty[s], kThreads / 32); // one arrival a warp
      mbar_init(&blk.vempty[s], kThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the padding rows of Q (no TMA box writes them), zeroed once by the
  // generic proxy before the async proxy (wgmma) reads them
  for (int i = threadIdx.x; i < kAtoms * (kRows - live) * 8;
       i += kBlockThreads) {
    const int a = i / ((kRows - live) * 8), c = i % ((kRows - live) * 8);
    *reinterpret_cast<int4*>(qs + a * kQAtom + live * 128 + c * 16) =
        make_int4(0, 0, 0, 0);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (threadIdx.x >= kThreads) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (blk.leader) {
      int g = 0;
      for (int k = 0; item_of(k) < items; ++k) {
        item(item_of(k));
        // Q: a (64, bq, hpi) box an atom, head-major rows, zeros past T
        // (a last head group past rep reads rows it never stores)
        if (k > 0) mbar_wait(blk.qempty, (k - 1) & 1);
        mbar_arrive_tx(qfull, kAtoms * 128 * live, true);
        for (int a = 0; a < kAtoms; ++a)
          tma_load_3d(qs + a * kQAtom, &q_map, qfull, 64 * a, q0,
                      blk.bh * rep + h0, true);
        for (int n = 0; n < blk.n_tiles; ++n, ++g) {
          if (g >= S) mbar_wait(&blk.kempty[g % S], ((g - S) / S) & 1);
          blk.load_k(g, n, true);
          if (g >= S) mbar_wait(&blk.vempty[g % S], ((g - S) / S) & 1);
          blk.load_v(g, n, true);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
    blk.wg = wg;
    blk.lane = threadIdx.x % 32;
    blk.tq = blk.lane % 4;
    // the thread's rows a and b (g, g + 8 of its warp's 16) and their
    // heads in the item's group; a padding row (past the group's heads or
    // rep) repeats a position and is never stored
    const int row_a = 64 * wg + 16 * warp + blk.lane / 4, row_b = row_a + 8;
    const int hr_a = row_a / bq, hr_b = row_b / bq;
    blk.q_addr = smem_u32(qs) + wg * 64 * 128;
    blk.k_addr = smem_u32(blk.ks);
    blk.v_addr = smem_u32(blk.vs);
    blk.sm_scale = sm_scale;
    blk.inv_softcap = inv_softcap;
    blk.scale_l2 = sm_scale * kLog2e;
    blk.cap_l2 = softcap * kLog2e;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) blk.s[i] = 0.f;
    blk.g0 = 0;
    blk.pass(wg == 1);                          // warpgroup 0 goes first
    for (int k = 0; item_of(k) < items; ++k) {
      item(item_of(k));
      const int ha = min(h0 + hr_a, rep - 1), hb = min(h0 + hr_b, rep - 1);
      blk.qp_a = q0 + row_a % bq;
      blk.qp_b = q0 + row_b % bq;
      blk.st_a = kStarts ? row_start(blk.qp_a) : 0;
      blk.st_b = kStarts ? row_start(blk.qp_b) : 0;
#pragma unroll
      for (int hf = 0; hf < Blk::kHalves; ++hf)
#pragma unroll
        for (int j = 0; j < 64; ++j) blk.o[hf][j] = 0.f;
      blk.m_a = blk.m_b = kNegInf;
      blk.l_a = blk.l_b = 0.f;

      mbar_wait(qfull, k & 1);
      if (masked(0)) blk.template first<true>();
      else blk.template first<false>();
      for (int n = 1; n < blk.n_tiles; ++n) {
        if (masked(n)) blk.template step<true>(n);
        else blk.template step<false>(n);
      }
      blk.last(item_of(k + 1) >= items);
      blk.g0 += blk.n_tiles;

      // the 4 lanes of a row hold partial denominators
      float l_a = blk.l_a, l_b = blk.l_b;
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
        l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
      }
      // the sink logit joins the denominator against the row's final
      // running max (log2 units, as m), which every lane of the row holds
      if constexpr (kSinks) {
        const int hh = blk.bh % nh;
        l_a += exp2f(__ldg(sinks + hh * rep + ha) * kLog2e - blk.m_a);
        l_b += exp2f(__ldg(sinks + hh * rep + hb) * kLog2e - blk.m_b);
      }
      const bool out_a = hr_a < hpi && h0 + hr_a < rep && blk.qp_a < t;
      const bool out_b = hr_b < hpi && h0 + hr_b < rep && blk.qp_b < t;
      float* const oa = out + (((size_t)blk.bh * rep + ha) * t + blk.qp_a) * D;
      float* const ob = out + (((size_t)blk.bh * rep + hb) * t + blk.qp_b) * D;
#pragma unroll
      for (int hf = 0; hf < Blk::kHalves; ++hf)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = 128 * hf + 8 * j + 2 * blk.tq;
          if (out_a)
            *reinterpret_cast<float2*>(oa + c) = make_float2(
                blk.o[hf][4 * j] / l_a, blk.o[hf][4 * j + 1] / l_a);
          if (out_b)
            *reinterpret_cast<float2*>(ob + c) = make_float2(
                blk.o[hf][4 * j + 2] / l_b, blk.o[hf][4 * j + 3] / l_b);
        }
    }
  }
}

template <int D, int kMode, bool kSoftcap, bool kSinks>
int launch(const void* q, const void* k, const void* v, void* out,
           const int* pos0, const float* sinks, int nb, int nh, int rep,
           int t, int window, int chunk, float sm_scale, float softcap,
           cudaStream_t stream) {
  auto kern = flash_prefill_kernel<D, kMode, kSoftcap, kSinks>;
  constexpr int smem = smem_bytes<D>();
  // once an instance: the opt-in above the 48 KB default
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const int hpi = rep < kRows ? rep : kRows;
  const int bq = kRows / hpi;
  CUtensorMap qm, km, vm;
  const uint64_t qd[3] = {(uint64_t)D, (uint64_t)t, (uint64_t)nb * nh * rep};
  const uint32_t qbox[3] = {64, (uint32_t)bq, (uint32_t)hpi};
  const uint64_t kd[3] = {(uint64_t)D, (uint64_t)t, (uint64_t)nb * nh};
  const uint32_t kbox[3] = {64, (uint32_t)keys<D>(), 1};
  if (!encode(&qm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 3, q, qd, qbox,
              CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&km, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 3, k, kd, kbox,
              CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&vm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 3, v, kd, kbox,
              CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  // one block an SM (its shared memory allows no more), none idle
  const int items = (t + bq - 1) / bq * nb * nh * ((rep + hpi - 1) / hpi);
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  const int grid = items < sms ? items : sms;
  // the softcap's reciprocal in f32, as the TPU kernel's 1.0 / softcap
  const float inv_softcap = kSoftcap ? (float)(1.0 / (double)softcap) : 0.f;
  kern<<<grid, kBlockThreads, smem, stream>>>(
      qm, km, vm, static_cast<float*>(out), pos0, sinks, nb, nh, rep, t,
      window, chunk, sm_scale, softcap, inv_softcap);
  return (int)cudaGetLastError();
}

template <int D, int kMode, bool kSoftcap, bool kSinks>
int attributes(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(
      &a, flash_prefill_kernel<D, kMode, kSoftcap, kSinks>);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = smem_bytes<D>();
  out[3] = n_stages<D>();
  return (int)err;
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

template <int D, int kMode>
int attributes_epilogue(int softcap, int sinks, int* out) {
  if (sinks) return softcap ? attributes<D, kMode, true, true>(out)
                            : attributes<D, kMode, false, true>(out);
  return softcap ? attributes<D, kMode, true, false>(out)
                 : attributes<D, kMode, false, false>(out);
}

template <int D>
int attributes_mode(int mode, int softcap, int sinks, int* out) {
  if (mode == kChunk)
    return attributes_epilogue<D, kChunk>(softcap, sinks, out);
  if (mode == kWindow)
    return attributes_epilogue<D, kWindow>(softcap, sinks, out);
  return attributes_epilogue<D, kCausal>(softcap, sinks, out);
}

}  // namespace

// q [B,H,rep,T,D] bf16, k/v [B,H,T,D] bf16, out [B,H,rep,T,D] f32, D 128 or
// 256; keys i - window < j <= i attend (window T: the plain causal mask),
// or under a chunk > 0 (window T) the keys j <= i of i's chunk, counted
// from the absolute position pos0[b] of row 0 (pos0: [B] int32 on the
// device); their scaled scores capped at softcap (0: no cap); sinks [H *
// rep] f32 on the device (null: none) join each row's denominator.  rep
// must be 1 or more, window >= 1, chunk >= 0 and softcap >= 0.  Returns
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
  if (rep < 1 || window < 1 || chunk < 0 ||
      !(softcap >= 0.f) || (chunk > 0 && (window < t || pos0 == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (d == 128) return dispatch<128>(PQ_FLASH_ARGS);
  if (d == 256) return dispatch<256>(PQ_FLASH_ARGS);
  return (int)cudaErrorInvalidValue;
}

// Registers, local (spill) bytes, dynamic shared memory and K/V stages of
// the instance (d 128 or 256; mode 0 causal, 1 window, 2 chunk; softcap,
// sinks 0 or 1) into out[4].
extern "C" int pq_flash_attributes(int d, int mode, int softcap, int sinks,
                                   int* out) {
  if (mode < kCausal || mode > kChunk) return (int)cudaErrorInvalidValue;
  if (d == 128) return attributes_mode<128>(mode, softcap, sinks, out);
  if (d == 256) return attributes_mode<256>(mode, softcap, sinks, out);
  return (int)cudaErrorInvalidValue;
}
