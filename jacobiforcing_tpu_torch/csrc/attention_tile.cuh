// Shared pieces of the hand-written attention kernels (paged_attention.cu,
// spec_attention.cu).  Two tiles live here, chosen at compile time by the
// query type of a kernel variant:
//
//   * float32 queries: the exact fp32 tile on the CUDA cores (namespace jf):
//     16-byte typed loads, fixed-order warp reductions and one online-softmax
//     step over a tile of KT = 32 keys.  It carries the float32 serving
//     anchors (greedy AR == Jacobi == MR token for token), which TF32 tensor
//     cores would lose.
//   * bfloat16 queries: the tensor-core tile (namespace jf::tc, further down):
//     wgmma scores and P.V over 64-key tiles staged by cp.async in two
//     shared-memory stages.
//
// fp32 tile geometry: a CTA holds ROWS = 64 query rows of one (sequence, KV
// head); a query row is one (token, query head) pair, token-major
// (r = t * G + g), so the G query heads of a KV head share every K/V tile.
// Each of the 4 warps owns RW = 16 rows; lane j of a warp scores key j of the
// current tile.
//
// Bit stability (both tiles): a row's arithmetic depends on nothing but the
// row and its keys.  One instruction shape and one key tile for every B, L
// and T, fixed key order, no variant chosen by shape and no split of the keys
// whose boundaries depend on the call; the reductions are fixed butterflies
// with explicit fmaf/__fmul_rn/__fadd_rn so contraction cannot differ
// between rows; and a tile that is fully masked for a row leaves its running
// state exactly unchanged (alpha = exp(0) = 1, p = 0).
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

#include <type_traits>

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

// ===========================================================================
// The tensor-core tile (bfloat16 queries), Hopper sm_90a.
//
// Geometry: a warpgroup (4 warps, 128 threads) owns 64 query rows, token-major
// as above; a CTA holds WGS warpgroups (ROWS = 64 * WGS rows) that share every
// staged K/V tile.  Keys come in tiles of KT = 64: one wgmma N = 64.
//
//   S = Q.K^T   wgmma.mma_async m64n64k16, bf16 in, fp32 accumulate; Q (64 x D
//               per warpgroup, staged once) and K both from 128-byte-swizzled
//               shared memory through wgmma descriptors (K-major).
//   softmax     online, on the accumulator fragments: thread (warp w, lane)
//               holds rows 16w + lane/4 and 16w + lane/4 + 8 of its
//               warpgroup, keys 8i + 2(lane%4) + {0, 1}; row max by two
//               fixed-order quad shuffles; each thread keeps its partial row
//               sum, added across the quad in fixed order at the end;
//               per-element -inf masking.  Scores are scaled into the log2
//               domain once (s * scale * log2 e) and exponentiated by exp2f.
//   O += P.V    P rounded to bf16 as the A operand from registers (the
//               accumulator layout of S is the A-fragment layout), V from the
//               same shared-memory tile read MN-major (transposed B),
//               fp32 accumulate.
//
// Shared memory: every operand tile is [D/64][64 rows][64 bf16], each 64 x 64
// block 8 KiB with the 128-byte swizzle (16-byte chunk c of row r stored at
// chunk c ^ (r % 8)), 1024-byte aligned.  Q: WGS tiles.  K/V: a ring of
// STAGES stages, filled by 16-byte cp.async.cg gathers through the block
// table: STAGES - 1 tiles are in flight while one computes (WGS = 2 and
// STAGES = 4 were the fastest of the geometries timed, PERF.md).  The copies of a
// later tile are issued while this tile's wgmma run (tile_step's `fill`),
// where the threads would otherwise wait.  A key with no row (past the
// length, a -1 page) is zero-filled and never read.  An fp8 / int8 cache is
// copied raw into a ring of RAW raw stages and widened, with its row scale,
// into two bf16 work tiles: tile i + 1 is widened while tile i's P.V
// computes, so the widening stays off the critical path:
// round_bf16(float(stored) * round_bf16(scale)) as above.
// ===========================================================================

namespace tc {

constexpr int KT = 64;                       // keys per tile: one wgmma N = 64
constexpr int WGS = 2;                       // warpgroups per CTA
constexpr int STAGES = 4;                    // K/V stages in the ring
// raw stages of a narrow cache: tiles i + 1 .. i + RAW - 2 are in flight (and
// i + 1 widened) while tile i computes
constexpr int RAW = 4;
// operand tiles in the K/V region: the bf16 ring (K and V of each stage), or
// two bf16 work tiles and the raw ring (one raw stage holds K and V of 64
// keys in TILE bytes)
constexpr int KV_TILES = 8;
static_assert(KV_TILES == 2 * STAGES && KV_TILES == 4 + RAW, "both rings fill the K/V region");
constexpr int ROWS = 64 * WGS;               // query rows per CTA
constexpr int THREADS = 128 * WGS;
constexpr uint32_t SUB = 64 * 128;           // bytes of one swizzled 64 x 64 bf16 block

template <int D>
constexpr uint32_t TILE = 64 * D * 2;        // one [64][D] bf16 operand tile

// dynamic shared memory: 1 KiB of alignment slack, Q, the K/V region
template <int D>
constexpr size_t SMEM = 1024 + size_t(WGS) * TILE<D> + size_t(KV_TILES) * TILE<D>;

// byte offset of 16-byte chunk c (along D) of row r in an operand tile
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 3) * SUB + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// make this thread's shared-memory writes visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads/writes across a wgmma wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (all >> 4)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
// K-major operand (Q, K): rows of 128 bytes, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return make_desc(addr, 16, 1024);
}
// MN-major operand (V as [keys][D]): 8-key groups 1024 bytes apart, the next
// 64 columns one block (SUB bytes) on
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr) {
  return make_desc(addr, SUB, 1024);
}

__device__ __forceinline__ void mma_ss_m64n64(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void mma_rs_m64n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void mma_rs_m64n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int D>
__device__ __forceinline__ void mma_pv(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (D == 128) mma_rs_m64n128(d, a, b);
  else mma_rs_m64n64(d, a, b);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// true in every thread of this thread's warpgroup iff v holds in any of them
__device__ __forceinline__ bool wg_any(bool v) {
  unsigned r;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.u32 p, %1, 0;\n"
      "bar.red.or.pred q, %2, 128, p;\nselp.u32 %0, 1, 0, q;\n}\n"
      : "=r"(r)
      : "r"((unsigned)v), "r"((int)(threadIdx.x >> 7) + 1)
      : "memory");
  return r != 0;
}

// The CTA's shared-memory operand tiles (shared-window addresses).
template <int D>
struct Smem {
  unsigned char* base;  // generic pointer of q
  uint32_t q;           // warpgroup w's Q tile at q + w * TILE<D>
  uint32_t kv;          // stage s: K tile at kv + 2 s TILE<D>, V tile TILE<D> on
  __device__ __forceinline__ explicit Smem(unsigned char* raw) {
    const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(raw));
    const uint32_t pad = (1024u - (a & 1023u)) & 1023u;
    base = raw + pad;
    q = a + pad;
    kv = q + WGS * TILE<D>;
  }
  __device__ __forceinline__ uint32_t k(int s) const { return kv + 2 * s * TILE<D>; }
  __device__ __forceinline__ uint32_t v(int s) const { return k(s) + TILE<D>; }
  __device__ __forceinline__ unsigned char* ptr(uint32_t addr) const { return base + (addr - q); }
  // raw stage s of a narrow cache (64 x D bytes for K, then for V), behind
  // the two bf16 work tiles k(0) / v(0) and k(1) / v(1)
  __device__ __forceinline__ uint32_t raw_k(int s) const { return k(2) + 2 * s * 64 * D; }
  __device__ __forceinline__ uint32_t raw_v(int s) const { return raw_k(s) + 64 * D; }
};

// Issue the copies of the CTA's query rows [row0, row0 + ROWS) of (b, KV
// head h) from q[B, L, NH, D]; rows at or past G * L are zero-filled.
template <int D>
__device__ __forceinline__ void issue_q(const __nv_bfloat16* __restrict__ q, uint32_t q_dst,
                                        int b, int L, int NH, int h, int G, int row0, int tid) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  const int n_rows = G * L;
#pragma unroll
  for (int it = 0; it < ROWS * CPR / THREADS; ++it) {
    const int idx = tid + it * THREADS;
    const int i = idx / CPR, c = idx % CPR;
    const int r = row0 + i;
    const bool ok = r < n_rows;
    const __nv_bfloat16* src =
        ok ? q + ((long long)(b * L + r / G) * NH + h * G + r % G) * D + c * 8 : q;
    cp_async16(q_dst + (i / 64) * TILE<D> + swz(i % 64, c), src, ok);
  }
}

// Issue half `part` (0 or 1) of the copies of one tile of 64 bf16 keys into a
// stage: key j at element offset off(j) from k_base / v_base, or no key
// (off(j) < 0: zero-filled).  The offsets are computed before the first copy
// is issued, so their block-table reads overlap.
template <int D, typename Off>
__device__ __forceinline__ void issue_kv_bf16(const __nv_bfloat16* __restrict__ k_base,
                                              const __nv_bfloat16* __restrict__ v_base,
                                              const Off& off, uint32_t k_dst, uint32_t v_dst,
                                              int tid, int part) {
  constexpr int CPR = D / 8;
  constexpr int IT = KT * CPR / THREADS;
  long long o[IT];
#pragma unroll
  for (int it = 0; it < IT; ++it)
    o[it] = (2 * it) / IT == part ? off((tid + it * THREADS) / CPR) : -1;
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    if ((2 * it) / IT != part) continue;
    const int idx = tid + it * THREADS;
    const int j = idx / CPR, c = idx % CPR;
    const bool ok = o[it] >= 0;
    const uint32_t d = swz(j, c);
    cp_async16(k_dst + d, ok ? k_base + o[it] + c * 8 : k_base, ok);
    cp_async16(v_dst + d, ok ? v_base + o[it] + c * 8 : v_base, ok);
  }
}

// The same for a one-byte cache (fp8 / int8): the rows go raw into
// raw_k / raw_v ([64][D] bytes) and, with part 1, their float32 scales into
// ks / vs.
template <typename S, int D, typename Off>
__device__ __forceinline__ void issue_kv_raw(const S* __restrict__ k_base,
                                             const S* __restrict__ v_base,
                                             const float* __restrict__ ks_head,
                                             const float* __restrict__ vs_head, const Off& off,
                                             uint32_t raw_k, uint32_t raw_v, uint32_t ks,
                                             uint32_t vs, int tid, int part) {
  static_assert(sizeof(S) == 1, "one-byte storage only");
  constexpr int CPR = D / 16;
  constexpr int IT = KT * CPR / THREADS;
  long long o[IT];
#pragma unroll
  for (int it = 0; it < IT; ++it)
    o[it] = (2 * it) / IT == part ? off((tid + it * THREADS) / CPR) : -1;
  const long long o_s = part == 1 && tid < KT ? off(tid) : -1;
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    if ((2 * it) / IT != part) continue;
    const int idx = tid + it * THREADS;
    const int j = idx / CPR, c = idx % CPR;
    const bool ok = o[it] >= 0;
    cp_async16(raw_k + j * D + c * 16, ok ? k_base + o[it] + c * 16 : k_base, ok);
    cp_async16(raw_v + j * D + c * 16, ok ? v_base + o[it] + c * 16 : v_base, ok);
  }
  if (part == 1 && tid < KT) {
    const bool ok = o_s >= 0;
    cp_async4(ks + tid * 4, ok ? ks_head + o_s / D : ks_head, ok);
    cp_async4(vs + tid * 4, ok ? vs_head + o_s / D : vs_head, ok);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The paged keys of one (sequence, KV head) for a K/V walk: tile i holds the
// keys at positions [64 i, 64 i + 64) below `end`, read through the block
// table; a position at or past `end`, or on a -1 page, has no row.
template <typename S, int D>
struct PagedKeys {
  const S* k;        // the head's [num_slots, D] rows
  const S* v;
  const float* ks;   // the head's [num_slots] dequant scales (narrow cache), or null
  const float* vs;
  const int* bt;     // the sequence's block-table row
  int P, page_size, end;

  // Issue half `part` of tile i's copies into stage s; part 0 also writes the
  // stage's liveness word (bit j: key j has a row).  live / ks_s / vs_s are
  // the stage's entries.
  __device__ __forceinline__ void issue(const Smem<D>& sm, int i, int s, int part,
                                        unsigned (&live)[2], float* ks_s, float* vs_s,
                                        int tid) const {
    const int k0 = i * KT;
    auto off = [&](int j) -> long long {
      return k0 + j < end ? paged_key_offset(bt, P, page_size, k0 + j, D) : -1;
    };
    if (part == 0 && tid < KT) {
      const unsigned w = __ballot_sync(FULL, off(tid) >= 0);
      if ((tid & 31) == 0) live[tid >> 5] = w;
    }
    if constexpr (std::is_same<S, __nv_bfloat16>::value) {
      issue_kv_bf16<D>(k, v, off, sm.k(s), sm.v(s), tid, part);
    } else {
      issue_kv_raw<S, D>(k, v, ks, vs, off, sm.raw_k(s), sm.raw_v(s), smem_addr(ks_s),
                         smem_addr(vs_s), tid, part);
    }
  }
};

__device__ __forceinline__ unsigned long long live_word(const unsigned (&live)[2]) {
  return live[0] | ((unsigned long long)live[1] << 32);
}

template <typename S>
__device__ __forceinline__ float byte_to_f32(unsigned char x);
template <>
__device__ __forceinline__ float byte_to_f32<__nv_fp8_e4m3>(unsigned char x) {
  return static_cast<float>(*reinterpret_cast<const __nv_fp8_e4m3*>(&x));
}
template <>
__device__ __forceinline__ float byte_to_f32<int8_t>(unsigned char x) {
  return static_cast<float>(static_cast<int8_t>(x));
}

// Widen a raw stage into a bf16 operand tile: round_bf16(float(stored) *
// round_bf16(scale)), bit for bit the dequantization of the fp32 tile.
template <typename S, int D>
__device__ __forceinline__ void widen_kv(const unsigned char* raw_k, const unsigned char* raw_v,
                                         const float* ks, const float* vs, unsigned char* k_dst,
                                         unsigned char* v_dst, int tid) {
  constexpr int CPR = D / 8;  // 8 elements -> one 16-byte bf16 chunk
#pragma unroll
  for (int it = 0; it < KT * CPR / THREADS; ++it) {
    const int idx = tid + it * THREADS;
    const int j = idx / CPR, c = idx % CPR;
    const float ksj = Vec<__nv_bfloat16>::round(ks[j]);
    const float vsj = Vec<__nv_bfloat16>::round(vs[j]);
    const uint2 kx = *reinterpret_cast<const uint2*>(raw_k + j * D + c * 8);
    const uint2 vx = *reinterpret_cast<const uint2*>(raw_v + j * D + c * 8);
    const unsigned char* kb = reinterpret_cast<const unsigned char*>(&kx);
    const unsigned char* vb = reinterpret_cast<const unsigned char*>(&vx);
    uint4 ko, vo;
    uint32_t* kw = reinterpret_cast<uint32_t*>(&ko);
    uint32_t* vw = reinterpret_cast<uint32_t*>(&vo);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      kw[e] = pack_bf16(__fmul_rn(byte_to_f32<S>(kb[2 * e]), ksj),
                        __fmul_rn(byte_to_f32<S>(kb[2 * e + 1]), ksj));
      vw[e] = pack_bf16(__fmul_rn(byte_to_f32<S>(vb[2 * e]), vsj),
                        __fmul_rn(byte_to_f32<S>(vb[2 * e + 1]), vsj));
    }
    *reinterpret_cast<uint4*>(k_dst + swz(j, c)) = ko;
    *reinterpret_cast<uint4*>(v_dst + swz(j, c)) = vo;
  }
}

// One K/V walk over n_tiles tiles of 64 keys, double-buffered or deeper.
// issue(i, stage, part) issues half `part` of tile i's copies into that stage
// (bf16: the ring stage itself; narrow: raw stage `stage`).  step(i, stage,
// k, v, fill) computes on the operand tiles at shared addresses k / v and
// calls fill(0) and fill(1), in that order, where the threads would
// otherwise wait for a wgmma (see tile_step); fill issues the copies of a
// later tile and, for a narrow cache, widens tile i + 1 into the other work
// tile.
//   bf16: a ring of STAGES stages; tiles i + 1 .. i + STAGES - 1 are in
//   flight while tile i computes.
//   narrow: a ring of RAW raw stages and two bf16 work tiles; tile i + 1 has
//   landed (and is widened during tile i) and tiles i + 2 .. i + RAW - 1 are
//   in flight.
// Every thread of the CTA calls walk_keys, with the CTA's query copies
// committed or still to commit; on return no copy is pending and every stage
// is free.
template <typename S, int D, typename Issue, typename Step>
__device__ __forceinline__ void walk_keys(const Smem<D>& sm, int n_tiles, const Issue& issue,
                                          const Step& step, const float* ks_s, const float* vs_s,
                                          int tid) {
  if (n_tiles <= 0) return;
  constexpr bool narrow = !std::is_same<S, __nv_bfloat16>::value;
  constexpr int ring = narrow ? RAW : STAGES;
#pragma unroll
  for (int i = 0; i < ring - 1; ++i) {
    if (i < n_tiles) {
      issue(i, i, 0);
      issue(i, i, 1);
    }
    cp_async_commit();  // one group per tile, empty past the end
  }
  // raw stage r into work tile w (narrow cache only)
  auto widen = [&](int r, int w) {
    if constexpr (narrow) {
      widen_kv<S, D>(sm.ptr(sm.raw_k(r)), sm.ptr(sm.raw_v(r)), ks_s + r * KT, vs_s + r * KT,
                     sm.ptr(sm.k(w)), sm.ptr(sm.v(w)), tid);
      fence_async_smem();
    }
  };
  if constexpr (narrow) {
    cp_async_wait<RAW - 2>();
    __syncthreads();  // tile 0 has landed everywhere
    widen(0, 0);
  }
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % ring;
    if constexpr (narrow) {
      cp_async_wait<RAW - 3>();
    } else {
      cp_async_wait<STAGES - 2>();
      fence_async_smem();
    }
    // bf16: tile i has landed everywhere; narrow: tile i is widened and tile
    // i + 1 has landed.  Either way tile i - 1 is consumed.
    __syncthreads();
    const int next = i + ring - 1;  // into tile i - 1's stage
    auto fill = [&](int part) {
      if (narrow && part == 1 && i + 1 < n_tiles) widen((i + 1) % RAW, (i + 1) & 1);
      if (next < n_tiles) issue(next, next % ring, part);
    };
    if constexpr (narrow) {
      step(i, s, sm.k(i & 1), sm.v(i & 1), fill);
    } else {
      step(i, s, sm.k(s), sm.v(s), fill);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The running softmax state of a thread's two rows (lo = 16w + lane/4 and
// hi = lo + 8 of its warpgroup): o is the wgmma m64nD accumulator, element
// 4i + e at row (e < 2 ? lo : hi), column 8i + 2(lane % 4) + (e & 1).
template <int D>
struct Rows {
  float o[D / 2];
  float m[2], l[2];  // l: this thread's partial row sums
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
  }
};

// 2^x on the special-function unit (relative error about 2^-22; 2^0 is 1
// exactly and 2^-inf is 0, which the masked-tile rule needs)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One online-softmax step of a warpgroup over the staged tile: q, k, v are
// the shared addresses of its Q tile and of the stage; vis(rr, j) says
// whether key j of the tile counts for this thread's row rr (0 lo, 1 hi).  A
// row that sees no key of the tile keeps its state bit for bit.  fill(0) is
// called while the scores compute and fill(1) while P.V computes.
// Scores stay unscaled until the exponent: the row max is taken over the raw
// scores (scaling by a positive constant keeps the order) and scaled once,
// and p = 2^(s * scale_log2 - m) is one fused multiply-add and one ex2.
template <int D, typename Vis, typename Fill>
__device__ __forceinline__ void tile_step(uint32_t q, uint32_t k, uint32_t v, float scale_log2,
                                          const Vis& vis, const Fill& fill, Rows<D>& st) {
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk >> 2) * SUB + (kk & 3) * 32;
    mma_ss_m64n64(s, desc_kmajor(q + off), desc_kmajor(k + off), kk);
  }
  wgmma_commit();
  fill(0);
  wgmma_wait_all();
  fence_regs(s);

  const int q4 = threadIdx.x & 3;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rr = e >> 1;
      const float x = vis(rr, 8 * i + 2 * q4 + (e & 1)) ? s[4 * i + e] : -INFINITY;
      s[4 * i + e] = x;
      mx[rr] = fmaxf(mx[rr], x);
    }
  }
  float base[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(FULL, mx[rr], 1));
    mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(FULL, mx[rr], 2));
    const float m_new = fmaxf(st.m[rr], __fmul_rn(mx[rr], scale_log2));
    base[rr] = m_new == -INFINITY ? 0.f : m_new;
    alpha[rr] = ex2(st.m[rr] - base[rr]);
    st.m[rr] = m_new;
  }
  uint32_t a[4][4];  // P as bf16 A fragments, one per 16 keys
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(fmaf(s[4 * i + e], scale_log2, -base[e >> 1]));
      s[4 * i + e] = p;
      sum[e >> 1] = __fadd_rn(sum[e >> 1], p);
    }
    a[i >> 1][(i & 1) * 2] = pack_bf16(s[4 * i], s[4 * i + 1]);
    a[i >> 1][(i & 1) * 2 + 1] = pack_bf16(s[4 * i + 2], s[4 * i + 3]);
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) st.l[rr] = fmaf(st.l[rr], alpha[rr], sum[rr]);
#pragma unroll
  for (int i = 0; i < D / 2; ++i) st.o[i] = __fmul_rn(st.o[i], alpha[(i >> 1) & 1]);

  fence_regs(st.o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk) mma_pv<D>(st.o, a[kk], desc_mnmajor(v + kk * 16 * 128));
  wgmma_commit();
  fill(1);
  wgmma_wait_all();
  fence_regs(st.o);
}

// Write this thread's two rows to out[B, L, NH, D] (r_lo: the CTA row of
// row lo); a row with no visible key (a padding row) writes zeros.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ out, const Rows<D>& st,
                                           int b, int L, int NH, int h, int G, int row0,
                                           int r_lo) {
  const int q4 = threadIdx.x & 3;
  const int n_rows = G * L;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float l = st.l[rr];
    l = __fadd_rn(l, __shfl_xor_sync(FULL, l, 1));
    l = __fadd_rn(l, __shfl_xor_sync(FULL, l, 2));
    const int r = row0 + r_lo + 8 * rr;
    if (r >= n_rows) continue;
    const int t = r / G, g = r % G;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    __nv_bfloat16* o = out + ((long long)(b * L + t) * NH + h * G + g) * D + 2 * q4;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * i) = __floats2bfloat162_rn(
          __fmul_rn(st.o[4 * i + 2 * rr], inv), __fmul_rn(st.o[4 * i + 2 * rr + 1], inv));
    }
  }
}

}  // namespace tc

// What the `*_attrs` C functions report of a kernel variant: out = {tensor
// cores (1) or fp32 tile (0), registers per thread, local (stack or spilled)
// bytes per thread, static shared bytes, dynamic shared bytes, threads per
// CTA, keys per tile, K/V stages}.
template <typename K>
int kernel_attrs(K kernel, bool tensor_cores, size_t dyn_smem, int threads, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = tensor_cores ? 1 : 0;
  out[1] = a.numRegs;
  out[2] = (int)a.localSizeBytes;
  out[3] = (int)a.sharedSizeBytes;
  out[4] = (int)dyn_smem;
  out[5] = threads;
  out[6] = tensor_cores ? tc::KT : KT;
  out[7] = tensor_cores ? tc::STAGES : 1;
  return 0;
}

}  // namespace jf
