// Weight-only quantized matmul for decode-sized M (M <= 64): one kernel
// template, six entry points, each replacing TPU kernels of
// piquant_tpu/ops/pallas/qmatmul.py:
//
//   pq_w4_gemv   _w4_kernel + _w4_kernel_ksplit   INT4 split-half, channelwise
//   pq_w8_gemv   _w8_kernel                       INT8, channelwise (lm_head)
//   pq_w2_gemv   _w2_kernel                       INT2 split-quarter, channelwise
//   pq_wg_gemv   _wg_chunk_kernel (bf16 / int8 x) grouped INT2 / INT4
//   pq_w4g_gemv  _w4_grouped_kernel               grouped INT4, W4A16 numerics
//   pq_nf4_gemv  _nf4_kernel                      NF4 codebook, channelwise or grouped
//
// (On Hopper a K split is a loop inside the block plus a split over
// blocks, so _w4_kernel_ksplit needs no kernel of its own.)
//
// The weight w [K/P, N] (uint8, N contiguous) packs P = 1, 2 or 4 codes a
// byte: byte row r holds code row r + p*K/P in bits [p*8/P, (p+1)*8/P).
//
// Channelwise:
//   out[m, n] = (sum_k x[m, k] c[k, n]) * scale[n] - xsum[m] * (zp[n] * scale[n])
// The zero point is never subtracted from the codes: it folds in as the
// rank-1 term, exactly as the TPU kernels do, and the products of the raw
// codes accumulate in f32.
//
// Grouped: the code in packed row r of plane p belongs to group (p, r / gs).
//   chunk: s is the group's bf16 scale and z its raw int8 zero point, both
//     read in the chunk-major order the TPU kernel streams them in
//     (group (p, j) at index (j / ch) * P * ch + p * ch + j % ch).  The TPU
//     kernel takes one raw-code product per group, scales it after the
//     product by s and subtracts xg * (z * s), xg the group's sum of x.
//     That is sum_k x[m, k] * (c - z) * s regrouped; here each code becomes
//     (c - z) * s = c * s - z * s in registers, exact in f32 (an integer of
//     at most 8 bits times an 8-bit mantissa), so every group's part is
//     scaled before it joins the f32 sum and no group sum of x is needed.
//     The int8-x form (the TPU kernel's xdt='i8', W2A8-g / W4A8-g) stages
//     x as the f32 values of the int8 codes xq (exact) and multiplies the
//     sum by the row's scale xs[m] once, after the K-split reduction, as
//     the TPU kernel scales its accumulator at the last chunk.  Its
//     products are exact; only the order of the f32 sums differs from the
//     TPU kernel's per-group int32 dots.
//   w4a16: w = bf16((c - bf16(z)) * bf16(s)) from the f32 scale and int32
//     zero point in natural group order, as the TPU kernel rounds the
//     dequantised weight to bf16 before its two bf16 products.
//
// NF4: a code indexes the 16-entry NormalFloat-4 table, each entry rounded
// to bf16 as the TPU kernel's select chain casts it (kept in shared memory:
// 16 words in 16 banks, so any lanes' lookups are conflict-free).  There is
// no zero point.  Channelwise: the table values' products accumulate in f32
// and the sum is scaled by scale[n] once, at the end (the TPU kernel's acc *
// s_n).  Grouped: w = bf16(lut[c] * bf16(s)) with the f32 group scale in
// natural group order, the TPU kernel's pre-scaled bf16 value planes.
//
// Bound on the H100: the weight stream, K*N/P bytes a call, plus the side
// streams of grouped weights (3 B a group entry in chunk form, 8 B in
// w4a16 form); x and the output are small at decode M, except the INT8
// lm_head's f32 output (4.1 MB at M = 8, N = 128256).  Design:
//   * each warp reads one packed row of 128 columns a step (32 lanes x 4
//     bytes: one fully used 128-byte line), expands the P codes of each
//     byte in registers and takes x from shared memory as P-wide vectors;
//     it works on 8 rows at a time while the loads of its next 8 are in
//     flight;
//   * the 8 warps of a block walk interleaved rows of one K range, so a
//     block streams a contiguous slab of the weight; x is staged in chunks
//     of 1024/P packed rows (32 KB), so a K range has no length limit;
//   * K is also split over blocks (ksplit, chosen by the wrapper for about
//     one wave of 4 blocks per SM, aligned to whole groups), and a second
//     pass sums the f32 partials in a fixed order: deterministic, no
//     atomics;
//   * M is tiled by 8 rows a block (decode batch 8 = one tile);
//   * a warp loads a group's side values (per plane, its 4 columns) once,
//     when its row enters the group.
// The arithmetic runs on the CUDA cores (P FMAs per byte and x row, plus
// one per code for grouped weights), which at M = 8 costs about as much as
// the stream itself, and INT2 does the most of it per byte; tensor-core
// products are the next step for these kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;      // output columns per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMT = 8;          // x rows per block
constexpr int kStage = 8192;    // shared floats: x chunks, then the reduction
constexpr int kUnroll = 8;      // packed rows a warp has in flight

enum Mode { kChannel, kChunk, kW4A16, kNF4, kNF4G };

// NF4_CODEBOOK of piquant_tpu/quant/linear.py, as f32
__constant__ float kNF4Table[16] = {
    -1.0f, -0.6961928009986877f, -0.5250730514526367f, -0.39491748809814453f,
    -0.28444138169288635f, -0.18477343022823334f, -0.09105003625154495f, 0.0f,
    0.07958029955625534f, 0.16093020141124725f, 0.24611230194568634f,
    0.33791524171829224f, 0.44070982933044434f, 0.5626170039176941f,
    0.7229568362236023f, 1.0f};

__device__ __forceinline__ void store_out(void* out, size_t i, float v,
                                          int out_bf16) {
  if (out_bf16) {
    reinterpret_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(v);
  } else {
    reinterpret_cast<float*>(out)[i] = v;
  }
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int P>
__device__ __forceinline__ void load_x(const float* s, float (&v)[P]) {
  if constexpr (P == 1) {
    v[0] = s[0];
  } else if constexpr (P == 2) {
    const float2 t = *reinterpret_cast<const float2*>(s);
    v[0] = t.x;
    v[1] = t.y;
  } else {
    const float4 t = *reinterpret_cast<const float4*>(s);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  }
}

// Group j's side values for one lane's 4 columns, per plane: sv the scale,
// zv = z * s (chunk) or z (w4a16); NF4 grouped reads only bf16(s).
template <int P, int MODE>
__device__ __forceinline__ void load_side(const void* side_s,
                                          const void* side_z, int j, int gp,
                                          int ch, int n, int col,
                                          float (&sv)[P][4],
                                          float (&zv)[P][4]) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if constexpr (MODE == kChunk) {
      const size_t e = (size_t)(j / ch) * (P * ch) + p * ch + j % ch;
      const uint2 s4 = __ldg(reinterpret_cast<const uint2*>(
          static_cast<const uint16_t*>(side_s) + e * n + col));
      const uint32_t z4 = __ldg(reinterpret_cast<const unsigned int*>(
          static_cast<const int8_t*>(side_z) + e * n + col));
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t half = ((c < 2 ? s4.x : s4.y) >> (16 * (c % 2))) & 0xffffu;
        const float s = __uint_as_float(half << 16);     // bf16 -> f32
        const float z = (float)(signed char)((z4 >> (8 * c)) & 0xffu);
        sv[p][c] = s;
        zv[p][c] = z * s;                                 // exact
      }
    } else if constexpr (MODE == kNF4G) {
      const size_t e = (size_t)p * gp + j;
      const float4 s4 = __ldg(reinterpret_cast<const float4*>(
          static_cast<const float*>(side_s) + e * n + col));
      sv[p][0] = round_bf16(s4.x);
      sv[p][1] = round_bf16(s4.y);
      sv[p][2] = round_bf16(s4.z);
      sv[p][3] = round_bf16(s4.w);
    } else {
      const size_t e = (size_t)p * gp + j;
      const float4 s4 = __ldg(reinterpret_cast<const float4*>(
          static_cast<const float*>(side_s) + e * n + col));
      const int4 z4 = __ldg(reinterpret_cast<const int4*>(
          static_cast<const int*>(side_z) + e * n + col));
      const float s[4] = {s4.x, s4.y, s4.z, s4.w};
      const int z[4] = {z4.x, z4.y, z4.z, z4.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sv[p][c] = round_bf16(s[c]);
        zv[p][c] = round_bf16((float)z[c]);
      }
    }
  }
}

template <int P, int MODE, bool XI8>
__global__ void __launch_bounds__(kThreads)
gemv_partial(const void* __restrict__ x,    // bf16, or int8 when XI8
             const uint8_t* __restrict__ w,
             const float* __restrict__ scale,   // channelwise only
             const int* __restrict__ zp,
             const float* __restrict__ xsum,
             const void* __restrict__ side_s,   // grouped only
             const void* __restrict__ side_z,
             const float* __restrict__ xs,      // int8 x only: row scales
             int gs, int ch,
             void* __restrict__ out,
             float* __restrict__ partial,       // null: write `out` directly
             int m, int k, int n, int rows_per_split, int out_bf16) {
  constexpr int kBits = 8 / P;
  constexpr uint32_t kMask = (1u << kBits) - 1u;
  constexpr int kChunkRows = kStage / (kMT * P);
  __shared__ __align__(16) float smem[kStage];
  __shared__ float lut[16];   // NF4 modes: the bf16-rounded table

  const int rows = k / P;                 // packed rows of the weight
  const int col0 = blockIdx.x * kCols;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * kMT;
  const int r0 = split * rows_per_split;
  const int r1 = min(r0 + rows_per_split, rows);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = col0 + lane * 4;
  const int gp = MODE == kChannel || MODE == kNF4 ? 1 : rows / gs;  // groups per plane
  if constexpr (MODE == kNF4 || MODE == kNF4G) {
    if (threadIdx.x < 16) lut[threadIdx.x] = round_bf16(kNF4Table[threadIdx.x]);
  }   // read after the chunk loop's first barrier

  float acc[kMT][4];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[mi][c] = 0.f;
  float sv[P][4], zv[P][4];
  int cur = -1;                           // group of sv / zv

  for (int c0 = r0; c0 < r1; c0 += kChunkRows) {
    const int nrows = min(c0 + kChunkRows, r1) - c0;
    __syncthreads();                      // the last chunk's x is read
    // stage x[m, p*K/P + c0 + r] for this chunk's rows, zero past M
    for (int i = threadIdx.x; i < nrows * kMT; i += kThreads) {
      const int mi = i / nrows, r = i % nrows;
      float* dst = smem + (r * kMT + mi) * P;
      const bool live = m0 + mi < m;
      const size_t e = (size_t)(m0 + mi) * k + c0 + r;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        float v = 0.f;
        if (live) {
          if constexpr (XI8) {
            v = (float)static_cast<const int8_t*>(x)[e + (size_t)p * rows];
          } else {
            v = __bfloat162float(
                static_cast<const __nv_bfloat16*>(x)[e + (size_t)p * rows]);
          }
        }
        dst[p] = v;
      }
    }
    __syncthreads();

    const uint8_t* wp = w + (size_t)c0 * n + col;
    auto fetch = [&](int r) {
      return r < nrows ? __ldg(reinterpret_cast<const uint32_t*>(
                             wp + (size_t)r * n))
                       : 0u;
    };
    uint32_t next[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) next[u] = fetch(warp + u * kWarps);
    for (int rb = warp; rb < nrows; rb += kWarps * kUnroll) {
      uint32_t word[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {   // the next rows load meanwhile
        word[u] = next[u];
        next[u] = fetch(rb + (kUnroll + u) * kWarps);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = rb + u * kWarps;
        if (r >= nrows) break;
        if constexpr (MODE != kChannel && MODE != kNF4) {
          const int j = (c0 + r) / gs;
          if (j != cur) {                   // warp-uniform
            cur = j;
            load_side<P, MODE>(side_s, side_z, j, gp, ch, n, col, sv, zv);
          }
        }
        float cv[P][4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint32_t byte = (word[u] >> (8 * c)) & 0xffu;
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const uint32_t code = (byte >> (kBits * p)) & kMask;
            float f = (float)code;
            if constexpr (MODE == kChunk) f = fmaf(f, sv[p][c], -zv[p][c]);
            if constexpr (MODE == kW4A16) f = round_bf16((f - zv[p][c]) * sv[p][c]);
            if constexpr (MODE == kNF4) f = lut[code];
            if constexpr (MODE == kNF4G) f = round_bf16(lut[code] * sv[p][c]);
            cv[p][c] = f;
          }
        }
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi) {
          float xv[P];
          load_x<P>(smem + (r * kMT + mi) * P, xv);
#pragma unroll
          for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int p = 0; p < P; ++p)
              acc[mi][c] = fmaf(xv[p], cv[p][c], acc[mi][c]);
        }
      }
    }
  }

  // sum the 8 warps' row subsets through shared memory
  __syncthreads();
  float* red = smem;   // [kWarps][kMT][kCols]
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
    *reinterpret_cast<float4*>(&red[(warp * kMT + mi) * kCols + lane * 4]) =
        make_float4(acc[mi][0], acc[mi][1], acc[mi][2], acc[mi][3]);
  __syncthreads();
  for (int i = threadIdx.x; i < kMT * kCols; i += kThreads) {
    const int mi = i / kCols, cc = i % kCols;
    const int row = m0 + mi, cl = col0 + cc;
    if (row >= m) continue;
    float s = 0.f;
#pragma unroll
    for (int wv = 0; wv < kWarps; ++wv) s += red[(wv * kMT + mi) * kCols + cc];
    if (partial != nullptr) {
      partial[((size_t)split * m + row) * n + cl] = s;
    } else if (MODE == kChannel) {
      const float sc = scale[cl];
      const float zs = (float)zp[cl] * sc;
      store_out(out, (size_t)row * n + cl, s * sc - xsum[row] * zs, out_bf16);
    } else if (MODE == kNF4) {
      store_out(out, (size_t)row * n + cl, s * scale[cl], out_bf16);
    } else {
      store_out(out, (size_t)row * n + cl, XI8 ? __fmul_rn(s, xs[row]) : s,
                out_bf16);
    }
  }
}

// Second pass of a K split: the f32 partials summed in split order, then
// the channelwise fold (scale != null; NF4 channelwise, zp null: the scale
// alone), the int8-x row scale (xs != null) or nothing (grouped, bf16 x).
__global__ void gemv_reduce(const float* __restrict__ partial,
                            const float* __restrict__ scale,
                            const int* __restrict__ zp,
                            const float* __restrict__ xsum,
                            const float* __restrict__ xs,
                            void* __restrict__ out,
                            int m, int n, int ksplit, int out_bf16) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m * n) return;
  const int row = i / n, col = i % n;
  float s = 0.f;
  for (int sp = 0; sp < ksplit; ++sp) s += partial[(size_t)sp * m * n + i];
  if (scale != nullptr) {
    const float sc = scale[col];
    s = zp != nullptr ? s * sc - xsum[row] * ((float)zp[col] * sc) : s * sc;
  } else if (xs != nullptr) {
    s = __fmul_rn(s, xs[row]);
  }
  store_out(out, i, s, out_bf16);
}

template <int P, int MODE, bool XI8 = false>
int launch(const void* x, const void* w, const void* scale, const void* zp,
           const void* xsum, const void* side_s, const void* side_z,
           const void* xs, int gs, int ch, void* out, void* partial, int m,
           int k, int n, int ksplit, int rows_per_split, int out_bf16,
           void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  dim3 grid(n / kCols, ksplit, (m + kMT - 1) / kMT);
  gemv_partial<P, MODE, XI8><<<grid, kThreads, 0, st>>>(
      x, static_cast<const uint8_t*>(w),
      static_cast<const float*>(scale), static_cast<const int*>(zp),
      static_cast<const float*>(xsum), side_s, side_z,
      static_cast<const float*>(xs), gs, ch, out,
      ksplit > 1 ? static_cast<float*>(partial) : nullptr, m, k, n,
      rows_per_split, out_bf16);
  if (ksplit > 1) {
    const int total = m * n;
    gemv_reduce<<<(total + 255) / 256, 256, 0, st>>>(
        static_cast<const float*>(partial),
        MODE == kChannel || MODE == kNF4 ? static_cast<const float*>(scale)
                                         : nullptr,
        static_cast<const int*>(zp), static_cast<const float*>(xsum),
        XI8 ? static_cast<const float*>(xs) : nullptr, out, m, n, ksplit,
        out_bf16);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Channelwise: x [m, k] bf16, w [k/P, n] u8, scale [n] f32, zp [n] i32,
// xsum [m] f32, out [m, n] (bf16 if out_bf16 else f32), partial
// [ksplit, m, n] f32 scratch (unused when ksplit == 1).  Needs n % 128 ==
// 0, k % 256 == 0 (k % 512 for INT2), 16-byte aligned operands and
// ksplit * rows_per_split >= k / P.
#define PQ_CHANNEL_ENTRY(NAME, P)                                            \
  extern "C" int NAME(const void* x, const void* w, const void* scale,       \
                      const void* zp, const void* xsum, void* out,           \
                      void* partial, int m, int k, int n, int ksplit,        \
                      int rows_per_split, int out_bf16, void* stream) {      \
    return launch<P, kChannel>(x, w, scale, zp, xsum, nullptr, nullptr,      \
                               nullptr, 1, 1, out, partial, m, k, n, ksplit, \
                               rows_per_split, out_bf16, stream);            \
  }

PQ_CHANNEL_ENTRY(pq_w4_gemv, 2)
PQ_CHANNEL_ENTRY(pq_w8_gemv, 1)
PQ_CHANNEL_ENTRY(pq_w2_gemv, 4)

// Grouped, chunk form: s_chunk [k/gs, n] bf16 and z_chunk [k/gs, n] int8 in
// chunk-major order with chunk factor ch; planes 2 (INT4) or 4 (INT2);
// (k / planes) % gs == 0 and rows_per_split a multiple of gs.  x is bf16
// when xs is null, else int8 codes with row scales xs [m] f32.
template <int P>
int launch_chunk(const void* x, const void* w, const void* s_chunk,
                 const void* z_chunk, const void* xs, void* out,
                 void* partial, int m, int k, int n, int gs, int ch,
                 int ksplit, int rows_per_split, int out_bf16, void* stream) {
  if (xs != nullptr)
    return launch<P, kChunk, true>(x, w, nullptr, nullptr, nullptr, s_chunk,
                                   z_chunk, xs, gs, ch, out, partial, m, k, n,
                                   ksplit, rows_per_split, out_bf16, stream);
  return launch<P, kChunk>(x, w, nullptr, nullptr, nullptr, s_chunk, z_chunk,
                           nullptr, gs, ch, out, partial, m, k, n, ksplit,
                           rows_per_split, out_bf16, stream);
}

extern "C" int pq_wg_gemv(const void* x, const void* w, const void* s_chunk,
                          const void* z_chunk, const void* xs, void* out,
                          void* partial, int m, int k, int n, int gs, int ch,
                          int planes, int ksplit, int rows_per_split,
                          int out_bf16, void* stream) {
  if (planes == 4)
    return launch_chunk<4>(x, w, s_chunk, z_chunk, xs, out, partial, m, k, n,
                           gs, ch, ksplit, rows_per_split, out_bf16, stream);
  if (planes == 2)
    return launch_chunk<2>(x, w, s_chunk, z_chunk, xs, out, partial, m, k, n,
                           gs, ch, ksplit, rows_per_split, out_bf16, stream);
  return (int)cudaErrorInvalidValue;
}

// Grouped INT4, W4A16 form: scale [k/gs, n] f32 and zp [k/gs, n] int32 in
// natural group order (the lo plane's groups, then the hi plane's).
extern "C" int pq_w4g_gemv(const void* x, const void* w, const void* scale,
                           const void* zp, void* out, void* partial, int m,
                           int k, int n, int gs, int ksplit,
                           int rows_per_split, int out_bf16, void* stream) {
  return launch<2, kW4A16>(x, w, nullptr, nullptr, nullptr, scale, zp,
                           nullptr, gs, 1, out, partial, m, k, n, ksplit,
                           rows_per_split, out_bf16, stream);
}

// NF4, x [m, k] bf16, w [k/2, n] u8 split-half codes: channelwise (gs 0)
// with scale [n] f32, or grouped with scale [k/gs, n] f32 in natural group
// order ((k/2) % gs == 0, rows_per_split a multiple of gs).
extern "C" int pq_nf4_gemv(const void* x, const void* w, const void* scale,
                           void* out, void* partial, int m, int k, int n,
                           int gs, int ksplit, int rows_per_split,
                           int out_bf16, void* stream) {
  if (gs == 0)
    return launch<2, kNF4>(x, w, scale, nullptr, nullptr, nullptr, nullptr,
                           nullptr, 1, 1, out, partial, m, k, n, ksplit,
                           rows_per_split, out_bf16, stream);
  return launch<2, kNF4G>(x, w, nullptr, nullptr, nullptr, scale, nullptr,
                          nullptr, gs, 1, out, partial, m, k, n, ksplit,
                          rows_per_split, out_bf16, stream);
}
