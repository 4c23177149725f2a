// The decode-attention kernels' launch arguments and cache layout, shared
// by decode_attn2.cu (head_dim 128 and 256) and decode_wide.cu (384 to
// 1024): both take the same tensors, scratch and tickets, split the cache
// into the same 64-position tiles and splits, and merge in the same launch.
#pragma once

#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

namespace pq {

constexpr int kDecodeTile = 64;     // cache positions a ring stage holds
constexpr int kDecodeMaxTps = 16;   // tiles a split (its scores: 2 KB each)

struct DecodeArgs {
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
  int layer, nb, nh, rep, s_len, d, tps, nstage, region;
  float sm_scale;
};

inline DecodeArgs decode_args(const void* q, const void* kc, const void* ks,
                              const void* vc, const void* vs, const void* pos,
                              const void* start, void* acc, void* m, void* l,
                              void* part_acc, void* part_ml, void* tickets,
                              int layer, int nb, int nh, int rep, int s_len,
                              int d, int tps, float sm_scale) {
  DecodeArgs a;
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
  a.d = d;
  a.tps = tps;
  a.nstage = 0;
  a.region = 0;
  a.sm_scale = sm_scale;
  return a;
}

// position p's scale in its (layer, b, h) slab: kv8 [S], kv4 [2, S/2]
// with p at [p % 2, p / 2]
template <bool KV4>
__device__ __forceinline__ size_t scale_at(int p, int s_len) {
  if constexpr (KV4) return (size_t)(p & 1) * (s_len / 2) + (p >> 1);
  return (size_t)p;
}

// splits of `tps` 64-position tiles over S positions
inline int decode_splits(int s_len, int tps) {
  const int tiles = (s_len + kDecodeTile - 1) / kDecodeTile;
  return (tiles + tps - 1) / tps;
}

}  // namespace pq
