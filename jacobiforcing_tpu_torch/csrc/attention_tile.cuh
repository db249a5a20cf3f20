// Shared pieces of the hand-written attention kernels (paged_attention.cu,
// spec_attention.cu): the CTA geometry, 16-byte typed loads, fixed-order warp
// reductions, and one online-softmax step over a tile of KT keys.
//
// Geometry: a CTA holds ROWS = 64 query rows of one (sequence, KV head); a
// query row is one (token, query head) pair, token-major (r = t * G + g), so
// the G query heads of a KV head share every K/V tile.  Each of the 4 warps
// owns RW = 16 rows; lane j of a warp scores key j of the current tile.
//
// Bit stability: a row's arithmetic depends on nothing but the row and its
// keys.  The key tile width and key order are fixed, each score is one fmaf
// chain, the reductions are fixed butterflies over the 32 keys of a tile
// (explicit fmaf/__fmul_rn/__fadd_rn so contraction cannot differ between
// rows), and a tile that is fully masked for a row leaves its running state
// exactly unchanged (alpha = exp(0) = 1, p = 0).
//
// Narrow K/V storage: the cache's element type S is a template parameter of
// its own (float, bfloat16, fp8 e4m3, int8), apart from the query type T.  An
// fp8 or int8 cache comes with one float32 dequant scale per stored row, at
// scale[h * num_slots + slot]; a row is dequantized while it is staged, in
// the query type: round_T(float(stored) * round_T(scale)).  That is bit for
// bit what ops/kv_cache.dequantize_rows computes, so a committed row read
// here equals the fake-quantized copy of the same row that the MR decoder
// feeds in as an in-flight key, in float32 and in bfloat16 alike.  The value
// depends on nothing but the key, so the properties above carry over.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace jf {

constexpr int KT = 32;                 // keys per tile: one per lane
constexpr int WARPS = 4;
constexpr int RW = 16;                 // query rows per warp
constexpr int ROWS = WARPS * RW;       // query rows per CTA
constexpr int THREADS = WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;  // elements per 16-byte load
  __device__ __forceinline__ static void load(const float* p, float* o) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
  }
  __device__ __forceinline__ static float from_f32(float x) { return x; }
  __device__ __forceinline__ static float round(float x) { return x; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* o) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static __nv_bfloat16 from_f32(float x) { return __float2bfloat16(x); }
  // x rounded to the nearest bfloat16 (ties to even), as a float
  __device__ __forceinline__ static float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
};

// Storage-only types: 16 elements per 16-byte load, each exact in float32.
template <>
struct Vec<__nv_fp8_e4m3> {
  static constexpr int N = 16;
  __device__ __forceinline__ static void load(const __nv_fp8_e4m3* p, float* o) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_fp8_e4m3* e = reinterpret_cast<const __nv_fp8_e4m3*>(&x);
#pragma unroll
    for (int i = 0; i < 16; ++i) o[i] = static_cast<float>(e[i]);
  }
};

template <>
struct Vec<int8_t> {
  static constexpr int N = 16;
  __device__ __forceinline__ static void load(const int8_t* p, float* o) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const int8_t* e = reinterpret_cast<const int8_t*>(&x);
#pragma unroll
    for (int i = 0; i < 16; ++i) o[i] = static_cast<float>(e[i]);
  }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// Butterfly sum: every lane ends with the same bits (a + b == b + a).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// Shared memory of one CTA: q_s[ROWS][D], k_s[KT][D + 4], v_s[KT][D], fp32.
template <int D>
constexpr int K_STRIDE = D + 4;  // padded K rows: lane j reads row j conflict-free

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(ROWS) * D + size_t(KT) * K_STRIDE<D> + size_t(KT) * D);
}

// The running softmax state of a warp's RW rows; lane i holds output dims
// [i * D/32, (i + 1) * D/32) of each row.
template <int D>
struct RowState {
  float m[RW], l[RW], acc[RW][D / 32];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.f;
#pragma unroll
      for (int i = 0; i < D / 32; ++i) acc[r][i] = 0.f;
    }
  }
};

// Load the CTA's query rows [row0, row0 + ROWS) of (b, KV head h) from
// q[B, L, NH, D] into q_s as fp32; rows at or past n_rows = G * L are zero.
template <typename T, int D>
__device__ __forceinline__ void load_q_tile(const T* __restrict__ q, float* q_s, int b, int L,
                                            int NH, int h, int G, int row0, int tid) {
  constexpr int NV = Vec<T>::N;
  const int n_rows = G * L;
  for (int idx = tid; idx < ROWS * (D / NV); idx += THREADS) {
    const int i = idx / (D / NV);
    const int c = (idx % (D / NV)) * NV;
    const int r = row0 + i;
    float vals[NV];
    if (r < n_rows) {
      const int t = r / G, g = r % G;
      Vec<T>::load(q + ((long long)(b * L + t) * NH + h * G + g) * D + c, vals);
    } else {
#pragma unroll
      for (int e = 0; e < NV; ++e) vals[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < NV; ++e) q_s[i * D + c + e] = vals[e];
  }
}

// Stage one tile of KT keys into k_s / v_s as fp32.  Key j lives at element
// offset off_s[j] from k_base / v_base (stored as S); a negative offset means
// "no key" and stages zeros (the caller masks it).  With ks_s / vs_s (the
// dequant scales of the tile's keys, both or neither) a row is dequantized in
// the query type T as described above.  All threads of the CTA take part.
template <typename T, typename S, int D>
__device__ __forceinline__ void stage_kv_tile(const S* __restrict__ k_base,
                                              const S* __restrict__ v_base,
                                              const long long* off_s, const float* ks_s,
                                              const float* vs_s, float* k_s, float* v_s,
                                              int tid) {
  constexpr int NV = Vec<S>::N;
  for (int idx = tid; idx < KT * (D / NV); idx += THREADS) {
    const int j = idx / (D / NV);
    const int c = (idx % (D / NV)) * NV;
    const long long off = off_s[j];
    float kv[NV], vv[NV];
    if (off >= 0) {
      Vec<S>::load(k_base + off + c, kv);
      Vec<S>::load(v_base + off + c, vv);
      if (ks_s != nullptr) {
        const float ks = Vec<T>::round(ks_s[j]);
        const float vs = Vec<T>::round(vs_s[j]);
#pragma unroll
        for (int e = 0; e < NV; ++e) {
          kv[e] = Vec<T>::round(__fmul_rn(kv[e], ks));
          vv[e] = Vec<T>::round(__fmul_rn(vv[e], vs));
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < NV; ++e) kv[e] = vv[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < NV; ++e) {
      k_s[j * K_STRIDE<D> + c + e] = kv[e];
      v_s[j * D + c + e] = vv[e];
    }
  }
}

// One online-softmax step of a warp over the staged tile.  q_w points at the
// warp's RW query rows in q_s; bit r of `visible` says whether this lane's
// key counts for row r.  A row that sees no key of the tile keeps its state
// bit for bit.
template <int D>
__device__ __forceinline__ void tile_step(const float* q_w, const float* k_s, const float* v_s,
                                          int lane, unsigned visible, float scale,
                                          RowState<D>& st) {
  constexpr int DPL = D / 32;
  // ---- scores: lane j scores key j against the warp's RW rows ----
  float s[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) s[r] = 0.f;
  const float* krow = k_s + lane * K_STRIDE<D>;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    const float4 k4 = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const float4 q4 = *reinterpret_cast<const float4*>(q_w + r * D + d);
      s[r] = fmaf(q4.x, k4.x, s[r]);
      s[r] = fmaf(q4.y, k4.y, s[r]);
      s[r] = fmaf(q4.z, k4.z, s[r]);
      s[r] = fmaf(q4.w, k4.w, s[r]);
    }
  }

  // ---- online softmax update (s[r] becomes the probability of the key) ----
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const bool ok = (visible >> r) & 1u;
    const float sc = ok ? __fmul_rn(s[r], scale) : -INFINITY;
    const float m_new = fmaxf(st.m[r], warp_max(sc));
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = expf(st.m[r] - m_use);
    const float p = expf(sc - m_use);
    st.l[r] = fmaf(st.l[r], alpha, warp_sum(p));
    st.m[r] = m_new;
#pragma unroll
    for (int i = 0; i < DPL; ++i) st.acc[r][i] = __fmul_rn(st.acc[r][i], alpha);
    s[r] = p;
  }

  // ---- acc += P @ V over the tile, keys in order ----
#pragma unroll 2
  for (int jj = 0; jj < KT; ++jj) {
    float v[DPL];
    const float* vrow = v_s + jj * D + lane * DPL;
    if constexpr (DPL == 4) {
      const float4 x = *reinterpret_cast<const float4*>(vrow);
      v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    } else {
      const float2 x = *reinterpret_cast<const float2*>(vrow);
      v[0] = x.x; v[1] = x.y;
    }
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const float p = __shfl_sync(FULL, s[r], jj);
#pragma unroll
      for (int i = 0; i < DPL; ++i) st.acc[r][i] = fmaf(p, v[i], st.acc[r][i]);
    }
  }
}

// Write the warp's rows of the CTA to out[B, L, NH, D]; a row with no visible
// key (a padding row) writes zeros, never NaN.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* __restrict__ out, const RowState<D>& st, int b,
                                           int L, int NH, int h, int G, int row0, int warp,
                                           int lane) {
  constexpr int DPL = D / 32;
  const int n_rows = G * L;
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int row = row0 + warp * RW + r;
    if (row >= n_rows) continue;
    const int t = row / G, g = row % G;
    const float inv = st.l[r] > 0.f ? 1.f / st.l[r] : 0.f;
    T* o = out + ((long long)(b * L + t) * NH + h * G + g) * D + lane * DPL;
#pragma unroll
    for (int i = 0; i < DPL; ++i) o[i] = Vec<T>::from_f32(__fmul_rn(st.acc[r][i], inv));
  }
}

// Element offset of the key at absolute position `pos` of the paged cache of
// one KV head ([num_slots, D]), or -1 where the block table holds no page.
__device__ __forceinline__ long long paged_key_offset(const int* bt, int P, int page_size,
                                                      int pos, int D) {
  const int pi = pos / page_size;
  const int page = pi < P ? bt[pi] : -1;
  if (page < 0) return -1;
  return ((long long)page * page_size + pos % page_size) * D;
}

// One tile's key offsets and, for a scaled cache, dequant scales: thread
// `tid` < KT fills entry `tid` for the key at absolute position `pos` (no key
// when `live` is false).  k_scale_h / v_scale_h point at the head's
// [num_slots] scale rows, or are null.
template <int D>
__device__ __forceinline__ void fill_paged_key(long long* off_s, float* ks_s, float* vs_s,
                                               int tid, bool live, const int* bt, int P,
                                               int page_size, int pos,
                                               const float* __restrict__ k_scale_h,
                                               const float* __restrict__ v_scale_h) {
  const long long off = live ? paged_key_offset(bt, P, page_size, pos, D) : -1;
  off_s[tid] = off;
  if (k_scale_h != nullptr) {
    ks_s[tid] = off >= 0 ? k_scale_h[off / D] : 0.f;
    vs_s[tid] = off >= 0 ? v_scale_h[off / D] : 0.f;
  }
}

// The storage codes of the C interfaces: 0 float32, 1 bfloat16 (no scales),
// 2 fp8 e4m3, 3 int8 (with scales).  Served pairs (query, cache): the cache in
// the query's type, a bfloat16 cache under float32 queries, and fp8 / int8
// under either.
#define JF_DISPATCH_TYPES(QD, CD, HD, CALL)                                          \
  do {                                                                               \
    if ((QD) == 0 && (CD) == 0 && (HD) == 64) return CALL(float, float, 64);         \
    if ((QD) == 0 && (CD) == 0 && (HD) == 128) return CALL(float, float, 128);       \
    if ((QD) == 0 && (CD) == 1 && (HD) == 64) return CALL(float, __nv_bfloat16, 64); \
    if ((QD) == 0 && (CD) == 1 && (HD) == 128) return CALL(float, __nv_bfloat16, 128); \
    if ((QD) == 0 && (CD) == 2 && (HD) == 64) return CALL(float, __nv_fp8_e4m3, 64); \
    if ((QD) == 0 && (CD) == 2 && (HD) == 128) return CALL(float, __nv_fp8_e4m3, 128); \
    if ((QD) == 0 && (CD) == 3 && (HD) == 64) return CALL(float, int8_t, 64);        \
    if ((QD) == 0 && (CD) == 3 && (HD) == 128) return CALL(float, int8_t, 128);      \
    if ((QD) == 1 && (CD) == 1 && (HD) == 64) return CALL(__nv_bfloat16, __nv_bfloat16, 64); \
    if ((QD) == 1 && (CD) == 1 && (HD) == 128) return CALL(__nv_bfloat16, __nv_bfloat16, 128); \
    if ((QD) == 1 && (CD) == 2 && (HD) == 64) return CALL(__nv_bfloat16, __nv_fp8_e4m3, 64); \
    if ((QD) == 1 && (CD) == 2 && (HD) == 128) return CALL(__nv_bfloat16, __nv_fp8_e4m3, 128); \
    if ((QD) == 1 && (CD) == 3 && (HD) == 64) return CALL(__nv_bfloat16, int8_t, 64); \
    if ((QD) == 1 && (CD) == 3 && (HD) == 128) return CALL(__nv_bfloat16, int8_t, 128); \
  } while (0)

}  // namespace jf
