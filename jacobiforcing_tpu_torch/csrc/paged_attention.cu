// Paged causal GQA attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel jacobiforcing_tpu/ops/pallas/paged_attention.py
// (paged_attention_pallas, bodies _kernel / _kernel_fused, and the query-tiled
// prefill path _prefill_tiled).  It computes exactly
// jacobiforcing_tpu_torch.ops.attention.paged_attention_ref: queries
// q[B, L, NH, D] at absolute positions[B, L] attend to one layer of the
// head-major paged cache k/v[KH, num_slots, D] through block_tables[B, P];
// key j counts iff j < cache_lens[b] and j <= position.
//
// Design (a simple kernel that is right first):
//   * one CTA per (query-row tile, KV head h, sequence b).  A query row is one
//     (token, query head) pair; rows are token-major, r = t * G + g, so the G
//     query heads that share KV head h share every K/V tile the CTA loads;
//   * the CTA loads its own block-table row, cache length and positions (the
//     positions array itself: prefill clamps positions, so they need not be
//     consecutive) and walks keys from 0 upward in tiles of KT = 32 keys,
//     slot = block_tables[b, pos / page] * page + pos % page.  Keys at or past
//     min(cache_len, last position of the CTA + 1) are never read, nor is a
//     -1 page: dead tail slots and padding rows cost nothing and never fault;
//   * exact online softmax in fp32 with -inf masking, fp32 accumulation, on
//     the CUDA cores.  Inputs float32 or bfloat16; D in {64, 128} is a
//     template parameter; any page size that is a multiple of 16.
//
// Bit stability (the property greedy Jacobi == greedy AR rests on): the
// output row of a query at position p is bitwise the same whether it comes
// from an L=1 call, an L=N block, any batch or any query tile.  The key tile
// width and key order are fixed; each row's arithmetic (one fixed fma chain
// per score, fixed butterfly reductions over the 32 keys of a tile, explicit
// fmaf/__fmul_rn so contraction cannot differ between rows) depends on
// nothing but the row and its keys; and a tile that is fully masked for a
// row leaves its running state exactly unchanged (alpha = exp(0) = 1,
// p = 0), so how far a CTA walks past a row's position does not matter.
//
// What bounds it on the H100: for AR decode (L=1) the K/V bytes read
// (3.35 TB/s); for long prefill, and already for Jacobi blocks of L=64 with
// G=7 (448 query rows per KV head), the FLOPs (989 TFLOP/s bf16 on the
// tensor cores).  This first version does neither justice: it computes on
// the CUDA cores (fp32 FMA), stages K/V through shared memory without
// cp.async/TMA double buffering, and re-reads K/V once per query tile.  Its
// answer is to keep every K/V tile shared by all G query heads and all
// tokens of a CTA, and to skip tiles in a warp's causal future.  Tensor-core
// (wgmma) scores and pipelined loads are later work; chip_smoke.py records
// its time beside the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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
  __device__ __forceinline__ static float to_f32(float x) { return x; }
  __device__ __forceinline__ static float from_f32(float x) { return x; }
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
  __device__ __forceinline__ static float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ __forceinline__ static __nv_bfloat16 from_f32(float x) { return __float2bfloat16(x); }
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

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(ROWS) * D + size_t(KT) * (D + 4) + size_t(KT) * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                       const T* __restrict__ v_cache, const int* __restrict__ block_tables,
                       const int* __restrict__ cache_lens, const int* __restrict__ positions,
                       T* __restrict__ out, int L, int NH, int KH, int P, long long num_slots,
                       int page_size, float scale) {
  constexpr int KSTRIDE = D + 4;  // padded K rows: lane j reads row j conflict-free
  constexpr int DPL = D / 32;     // output dims per lane
  constexpr int NV = Vec<T>::N;

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                   // [ROWS][D]
  float* k_s = q_s + ROWS * D;         // [KT][KSTRIDE]
  float* v_s = k_s + KT * KSTRIDE;     // [KT][D]
  __shared__ long long slot_s[KT];
  __shared__ int pos_s[ROWS];
  __shared__ int kv_end_s;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * ROWS;
  const int G = NH / KH;
  const int n_rows = G * L;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int clen = cache_lens[b];

  for (int i = tid; i < ROWS; i += THREADS) {
    const int r = row0 + i;
    pos_s[i] = r < n_rows ? positions[(long long)b * L + r / G] : -1;
  }
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
  __syncthreads();
  if (tid == 0) {
    int mx = -1;
    for (int i = 0; i < ROWS; ++i) mx = max(mx, pos_s[i]);
    kv_end_s = min(clen, mx + 1);
  }
  __syncthreads();
  const int kv_end = kv_end_s;

  int warp_max_pos = -1;
#pragma unroll
  for (int r = 0; r < RW; ++r) warp_max_pos = max(warp_max_pos, pos_s[warp * RW + r]);

  float m[RW], l[RW], acc[RW][DPL];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  const int* bt = block_tables + (long long)b * P;
  const T* k_head = k_cache + (long long)h * num_slots * D;
  const T* v_head = v_cache + (long long)h * num_slots * D;

  for (int k0 = 0; k0 < kv_end; k0 += KT) {
    __syncthreads();  // the previous tile is consumed
    if (tid < KT) {
      const int pos = k0 + tid;
      long long slot = -1;
      if (pos < kv_end) {
        const int pi = pos / page_size;
        const int page = pi < P ? bt[pi] : -1;
        if (page >= 0) slot = (long long)page * page_size + pos % page_size;
      }
      slot_s[tid] = slot;
    }
    __syncthreads();
    for (int idx = tid; idx < KT * (D / NV); idx += THREADS) {
      const int j = idx / (D / NV);
      const int c = (idx % (D / NV)) * NV;
      const long long slot = slot_s[j];
      float kv[NV], vv[NV];
      if (slot >= 0) {
        Vec<T>::load(k_head + slot * D + c, kv);
        Vec<T>::load(v_head + slot * D + c, vv);
      } else {
#pragma unroll
        for (int e = 0; e < NV; ++e) kv[e] = vv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < NV; ++e) {
        k_s[j * KSTRIDE + c + e] = kv[e];
        v_s[j * D + c + e] = vv[e];
      }
    }
    __syncthreads();
    if (warp_max_pos < k0) continue;  // tile in every row's causal future

    // ---- scores: lane j scores key k0 + j against the warp's RW rows ----
    const int kpos = k0 + lane;
    const bool key_ok = slot_s[lane] >= 0;
    float s[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) s[r] = 0.f;
    const float* krow = k_s + lane * KSTRIDE;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 k4 = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float4 q4 = *reinterpret_cast<const float4*>(q_s + (warp * RW + r) * D + d);
        s[r] = fmaf(q4.x, k4.x, s[r]);
        s[r] = fmaf(q4.y, k4.y, s[r]);
        s[r] = fmaf(q4.z, k4.z, s[r]);
        s[r] = fmaf(q4.w, k4.w, s[r]);
      }
    }

    // ---- online softmax update (s[r] becomes the probability of the key) ----
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const bool ok = key_ok && kpos <= pos_s[warp * RW + r];
      const float sc = ok ? __fmul_rn(s[r], scale) : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(sc));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[r] - m_use);
      const float p = expf(sc - m_use);
      l[r] = fmaf(l[r], alpha, warp_sum(p));
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] = __fmul_rn(acc[r][i], alpha);
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
        for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(p, v[i], acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int row = row0 + warp * RW + r;
    if (row >= n_rows) continue;
    const int t = row / G, g = row % G;
    // a row with no visible key (a padding row) writes zeros, never NaN
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    T* o = out + ((long long)(b * L + t) * NH + h * G + g) * D + lane * DPL;
#pragma unroll
    for (int i = 0; i < DPL; ++i) o[i] = Vec<T>::from_f32(__fmul_rn(acc[r][i], inv));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* bt, const void* cl,
           const void* pos, void* out, int B, int L, int NH, int KH, int P, long long num_slots,
           int page_size, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(paged_attention_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = (NH / KH) * L;
  const dim3 grid((rows + ROWS - 1) / ROWS, KH, B);
  paged_attention_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(bt), static_cast<const int*>(cl), static_cast<const int*>(pos),
      static_cast<T*>(out), L, NH, KH, P, num_slots, page_size, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns 0 on success, a cudaError_t
// code after a refused launch, or -1 for a shape/dtype the kernel does not
// take (the Python wrapper checks those first).
extern "C" int jf_paged_attention(const void* q, const void* k, const void* v, const void* bt,
                                  const void* cl, const void* pos, void* out, int B, int L,
                                  int NH, int KH, int D, int P, long long num_slots,
                                  int page_size, float scale, int dtype, void* stream) {
  if (B <= 0 || L <= 0 || KH <= 0 || NH % KH != 0 || page_size % 16 != 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, bt, cl, pos, out, B, L, NH, KH, P, num_slots, page_size, scale, s);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, bt, cl, pos, out, B, L, NH, KH, P, num_slots, page_size, scale, s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, bt, cl, pos, out, B, L, NH, KH, P, num_slots, page_size, scale, s);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, bt, cl, pos, out, B, L, NH, KH, P, num_slots, page_size, scale, s);
  return -1;
}

extern "C" const char* jf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
