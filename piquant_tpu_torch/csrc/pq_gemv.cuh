// The decode GEMV template's tile geometry and inner-loop helpers
// (qmatmul_gemv.cu), shared with the fused MLP (qmatmul_mlp.cu), which runs
// the same loop over its two weight streams: the warps' split of a block's
// 128 weight columns and the ring stage's packed rows by M, the 128-byte
// swizzled reads of a weight box and of the x boxes, a code pair made a
// bf16x2 operand in registers, and the m16n8k16 products (the weight
// columns as A, the tokens as the n8 B operand, f32 sums; an all-ones A
// gives the row sums of x).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace pq {
namespace gemv {

constexpr int kCols = 128;          // weight columns a block

enum Mode { kChannel, kChunk, kW4A16, kNF4, kNF4G };

// The block's geometry at MT n8 token tiles: 128-column warps for the
// light forms (channelwise, NF4) at M <= 16, at M <= 8 two 16-row blocks a
// warp a stage (one block an SM, 5-6 stages); 64-column warps for the forms
// with per-group work (chunk, W4A16, NF4 grouped) there, which fit two
// blocks an SM at M <= 8, and for all at M <= 32; 32-column warps above.
// (At M <= 8 on an H100, two 16-row blocks a warp at one block an SM ran
// a Llama-3-8B INT4 layer and NF4 faster than one at two blocks an SM,
// INT2 and the INT8 lm_head about 1% slower; three blocks an SM, slower
// still.)
template <int MODE, int MT>
struct Tile {
  static constexpr bool kLight = MODE == kChannel || MODE == kNF4;
  static constexpr int CW = MT <= 2 && kLight ? 128 : MT <= 4 ? 64 : 32;  // columns a warp
  static constexpr int WN = kCols / CW;   // warps across the columns
  static constexpr int KW = 8 / WN;       // warps along K
  static constexpr int U = kLight && MT == 1 ? 2 : 1;  // 16-row blocks a warp
  static constexpr int R = 16 * KW * U;   // packed rows a stage
  static constexpr int NT = CW / 16;      // m16 tiles a warp
  static constexpr int CB = CW / 8;       // columns (bytes of a row) a lane
  static constexpr int XT = 8 * MT;       // tokens staged
};

__device__ __forceinline__ uint32_t lop_or(uint32_t v, uint32_t mask,
                                           uint32_t c) {   // (v & mask) | c
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0xea;\n" : "=r"(r) : "r"(v), "r"(mask), "r"(c));
  return r;
}

__device__ __forceinline__ uint32_t bf2_sub(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t bf2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t bf2_fma(uint32_t a, uint32_t b,
                                            uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// s[0], s[1] += the sums over the step's k of tokens 2t, 2t + 1: an A of
// ones (its rows all alike, so d2, d3 repeat d0, d1 and are dropped).
__device__ __forceinline__ void mma_ones_bf16(float (&s)[2],
                                              const uint32_t (&b)[2]) {
  float d2, d3;
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%6,%6,%6,%6}, {%4,%5}, {%0,%1,%0,%1};\n"
      : "+f"(s[0]), "+f"(s[1]), "=f"(d2), "=f"(d3)
      : "r"(b[0]), "r"(b[1]), "r"(0x3F803F80u));
}

// TMA's 128-byte swizzle: the 16-byte chunk c of stage row `row` sits at
// chunk c ^ (row % 8).  The rows one load instruction reads (2t + const for
// bf16 x; 4t + (i ^ (t & 2)) for the int8-x form) land on distinct chunks.
__device__ __forceinline__ const uint8_t* wrow(const uint8_t* ws, int row,
                                               int cl) {
  return ws + row * kCols + ((((cl >> 4) ^ (row & 7)) << 4) | (cl & 15));
}

// Byte e of token tok's x row (plane p) in a stage: boxes of XIN bytes a
// token (XIN = min(R * bytes, 128)), stored by TMA under the swizzle of
// that width (16-byte chunk ^= address bits 7.. of the token's row), so a
// warp's fragment reads (8 tokens x 4 words) hit 32 distinct banks.
template <int XIN, int NB, int XT>
__device__ __forceinline__ const uint8_t* xaddr(const uint8_t* xs, int p,
                                                int tok, int e) {
  const int b = e / XIN, w = e % XIN;
  const int f = ((tok * XIN) >> 7) & (XIN / 16 - 1);
  return xs + ((p * NB + b) * XT + tok) * XIN + ((((w >> 4) ^ f) << 4) | (w & 15));
}

template <int CB>
__device__ __forceinline__ void load_row(uint32_t (&v)[CB / 4],
                                         const uint8_t* p) {
  if constexpr (CB == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  } else if constexpr (CB == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    v[0] = u.x; v[1] = u.y;
  } else {
    v[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

// Sub-plane Q of a pair word v (row r's byte in bits 0-7, row r + 1's in
// bits 16-23) as the bf16x2 code pair, exactly.
template <int P, int Q>
__device__ __forceinline__ uint32_t code_pair(uint32_t v) {
  constexpr uint32_t kMagic = 0x43004300u;   // (128, 128)
  if constexpr (P == 1) {
    // c - 128: (128 + low 7 bits) - (256 if bit 7 of c ^ 0x80 else 128)
    uint32_t hi;
    asm("lop3.b32 %0, %1, %2, %3, 0xae;\n"     // (~v & 0x80) | magic
        : "=r"(hi) : "r"(v), "r"(0x00800080u), "r"(kMagic));
    return bf2_sub(lop_or(v, 0x007F007Fu, kMagic), hi);
  } else if constexpr (P == 2) {
    return bf2_sub(lop_or(Q ? v >> 4 : v, 0x000F000Fu, kMagic), kMagic);
  } else if constexpr (Q == 0) {
    return bf2_sub(lop_or(v, 0x00030003u, kMagic), kMagic);
  } else if constexpr (Q == 2) {       // 128 + 16c -> c
    return bf2_fma(lop_or(v, 0x00300030u, kMagic), 0x3D803D80u, 0xC100C100u);
  } else {                             // 128 + 4c -> c (Q 3: bits 6-7)
    return bf2_fma(lop_or(Q == 3 ? v >> 4 : v, 0x000C000Cu, kMagic),
                   0x3E803E80u, 0xC200C200u);
  }
}

}  // namespace gemv
}  // namespace pq
