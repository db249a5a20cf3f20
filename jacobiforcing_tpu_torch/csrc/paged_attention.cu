// Paged causal GQA attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel jacobiforcing_tpu/ops/pallas/paged_attention.py
// (paged_attention_pallas, bodies _kernel / _kernel_fused, and the query-tiled
// prefill path _prefill_tiled).  It computes exactly
// jacobiforcing_tpu_torch.ops.attention.paged_attention_ref: queries
// q[B, L, NH, D] at absolute positions[B, L] attend to one layer of the
// head-major paged cache k/v[KH, num_slots, D] through block_tables[B, P];
// key j counts iff j < cache_lens[b] and j <= position.  The cache may be
// stored narrower than the queries (bfloat16 under float32; fp8 e4m3 or int8
// with one float32 dequant scale per stored row, k_scale / v_scale
// [KH, num_slots]): the TPU kernel folds the K scale into the scores and the
// V scale into the probabilities; here a row is dequantized once while it is
// staged (attention_tile.cuh), which is the same function.
//
// Design:
//   * one CTA per (query-row tile, KV head h, sequence b).  A query row is one
//     (token, query head) pair; rows are token-major, r = t * G + g, so the G
//     query heads that share KV head h share every K/V tile the CTA loads;
//   * the CTA loads its own block-table row, cache length and positions (the
//     positions array itself: prefill clamps positions, so they need not be
//     consecutive) and walks keys from 0 upward in fixed tiles,
//     slot = block_tables[b, pos / page] * page + pos % page.  Keys at or past
//     kv_end = min(cache_len, last position of the CTA + 1) are never read,
//     nor is a -1 page: dead tail slots and padding rows cost nothing and
//     never fault; a tile in the causal future of every row of a warp
//     (warpgroup) is not computed;
//   * exact online softmax with -inf masking, fp32 accumulation.  D in
//     {64, 128} and the cache's storage type are template parameters; any
//     page size that is a multiple of 16.  The tile arithmetic lives in
//     attention_tile.cuh, shared with spec_attention.cu:
//       - float32 queries: the fp32 CUDA-core tile, 64 rows per CTA, 32-key
//         tiles (the exact variant the float32 serving anchors rest on);
//       - bfloat16 queries: the tensor-core tile, 64 rows per warpgroup and
//         tc::WGS warpgroups per CTA sharing each 64-key K/V tile; wgmma
//         scores and P.V; K/V gathered by cp.async through the block table
//         into a ring of tc::STAGES shared-memory stages, the next tiles in
//         flight while the current one computes; an fp8 / int8 cache widened
//         to bf16 with its row scale as it is staged.
//
// Bit stability (the property greedy Jacobi == greedy AR rests on): the
// output row of a query at position p is bitwise the same whether it comes
// from an L=1 call, an L=N block, any batch or any query tile.  The key tile
// width and key order are fixed for each variant; each row's arithmetic
// (fixed instruction shapes, fixed-order reductions, explicit
// fmaf/__fmul_rn so contraction cannot differ between rows) depends on
// nothing but the row and its keys; and a tile that is fully masked for a
// row leaves its running state exactly unchanged (alpha = exp(0) = 1,
// p = 0), so how far a CTA walks past a row's position does not matter.
//
// What bounds it on the H100: for AR decode (L=1) the K/V bytes read
// (3.35 TB/s); for long prefill, and already for Jacobi blocks of L=64 with
// G=7 (448 query rows per KV head), the operations, which only the tensor
// cores (989 TFLOP/s bf16, against 67 TFLOP/s fp32 FMA) can approach.  The
// bf16 variants put both products on the tensor cores and keep several
// tiles' gathers in flight behind the compute; two warpgroups per CTA halve
// how often a prefill re-reads K/V.  Left for later: TMA and a
// warp-specialised producer, a split of the keys at fixed boundaries for AR
// decode at small B (B * KH CTAs leave most SMs idle), and a tensor-core
// path for float32 queries.  chip_smoke.py records the times beside the
// bound.

#include "attention_tile.cuh"

namespace {

using namespace jf;

template <typename T, typename S, int D>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const T* __restrict__ q, const S* __restrict__ k_cache,
                       const S* __restrict__ v_cache, const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale, const int* __restrict__ block_tables,
                       const int* __restrict__ cache_lens, const int* __restrict__ positions,
                       T* __restrict__ out, int L, int NH, int KH, int P, long long num_slots,
                       int page_size, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                        // [ROWS][D]
  float* k_s = q_s + ROWS * D;              // [KT][D + 4]
  float* v_s = k_s + KT * K_STRIDE<D>;    // [KT][D]
  __shared__ long long off_s[KT];
  __shared__ float ks_s[KT], vs_s[KT];  // the tile's dequant scales (scaled cache only)
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
  load_q_tile<T, D>(q, q_s, b, L, NH, h, G, row0, tid);
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

  RowState<D> st;
  st.init();

  const int* bt = block_tables + (long long)b * P;
  const S* k_head = k_cache + (long long)h * num_slots * D;
  const S* v_head = v_cache + (long long)h * num_slots * D;
  const bool scaled = k_scale != nullptr;
  const float* ks_head = scaled ? k_scale + (long long)h * num_slots : nullptr;
  const float* vs_head = scaled ? v_scale + (long long)h * num_slots : nullptr;

  for (int k0 = 0; k0 < kv_end; k0 += KT) {
    __syncthreads();  // the previous tile is consumed
    if (tid < KT)
      fill_paged_key<D>(off_s, ks_s, vs_s, tid, k0 + tid < kv_end, bt, P, page_size, k0 + tid,
                        ks_head, vs_head);
    __syncthreads();
    stage_kv_tile<T, S, D>(k_head, v_head, off_s, scaled ? ks_s : nullptr,
                           scaled ? vs_s : nullptr, k_s, v_s, tid);
    __syncthreads();
    if (warp_max_pos < k0) continue;  // tile in every row's causal future

    const int kpos = k0 + lane;
    unsigned visible = 0;
    if (off_s[lane] >= 0) {
#pragma unroll
      for (int r = 0; r < RW; ++r) visible |= (kpos <= pos_s[warp * RW + r] ? 1u : 0u) << r;
    }
    tile_step<D>(q_s + warp * RW * D, k_s, v_s, lane, visible, scale, st);
  }

  store_rows<T, D>(out, st, b, L, NH, h, G, row0, warp, lane);
}

// The bfloat16-query variant on the tensor-core tile (see attention_tile.cuh).
template <typename S, int D>
__global__ void __launch_bounds__(tc::THREADS, 1)
paged_attention_tc_kernel(const __nv_bfloat16* __restrict__ q, const S* __restrict__ k_cache,
                          const S* __restrict__ v_cache, const float* __restrict__ k_scale,
                          const float* __restrict__ v_scale,
                          const int* __restrict__ block_tables,
                          const int* __restrict__ cache_lens, const int* __restrict__ positions,
                          __nv_bfloat16* __restrict__ out, int L, int NH, int KH, int P,
                          long long num_slots, int page_size, float scale) {
  extern __shared__ unsigned char smem_tc[];
  const tc::Smem<D> sm(smem_tc);
  __shared__ int pos_s[tc::ROWS];
  __shared__ int warp_max_s[tc::THREADS / 32];  // the largest position each warp loaded
  __shared__ unsigned live_s[tc::RAW][2];    // per stage: bit j = key j has a row
  // the dequant scales of each stage's keys (narrow cache)
  __shared__ float ks_s[tc::RAW][tc::KT], vs_s[tc::RAW][tc::KT];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * tc::ROWS;
  const int G = NH / KH;
  const int n_rows = G * L;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int r_lo = wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);  // CTA row of row lo
  const int clen = cache_lens[b];

  tc::issue_q<D>(q, sm.q, b, L, NH, h, G, row0, tid);
  tc::cp_async_commit();
  // thread i < ROWS loads the position of CTA row i, so warps 2w and 2w + 1
  // hold warpgroup w's 64 rows
  int my_pos = -1;
  if (tid < tc::ROWS) {
    const int r = row0 + tid;
    my_pos = r < n_rows ? positions[(long long)b * L + r / G] : -1;
    pos_s[tid] = my_pos;
  }
  const int max_in_warp = __reduce_max_sync(FULL, my_pos);
  if (lane == 0) warp_max_s[tid >> 5] = max_in_warp;
  __syncthreads();
  int cta_max_pos = -1;
#pragma unroll
  for (int w = 0; w < 2 * tc::WGS; ++w) cta_max_pos = max(cta_max_pos, warp_max_s[w]);
  const int kv_end = min(clen, cta_max_pos + 1);
  const int wg_max_pos = max(warp_max_s[2 * wg], warp_max_s[2 * wg + 1]);
  const int pos_lo = pos_s[r_lo], pos_hi = pos_s[r_lo + 8];

  const int* bt = block_tables + (long long)b * P;
  const S* k_head = k_cache + (long long)h * num_slots * D;
  const S* v_head = v_cache + (long long)h * num_slots * D;
  const float* ks_head = k_scale != nullptr ? k_scale + (long long)h * num_slots : nullptr;
  const float* vs_head = v_scale != nullptr ? v_scale + (long long)h * num_slots : nullptr;
  const float scale_log2 = __fmul_rn(scale, 1.4426950408889634f);

  tc::Rows<D> st;
  st.init();
  const uint32_t q_wg = sm.q + wg * tc::TILE<D>;

  const tc::PagedKeys<S, D> keys{k_head, v_head, ks_head, vs_head, bt, P, page_size, kv_end};
  auto issue = [&](int i, int s, int part) {
    keys.issue(sm, i, s, part, live_s[s], ks_s[s], vs_s[s], tid);
  };
  auto step = [&](int i, int s, uint32_t k, uint32_t v, const auto& fill) {
    const int k0 = i * tc::KT;
    const unsigned long long live = tc::live_word(live_s[s]);
    if (live == 0 || wg_max_pos < k0) {  // no key, or every row's causal future
      fill(0);
      fill(1);
      return;
    }
    tc::tile_step<D>(
        q_wg, k, v, scale_log2,
        [&](int rr, int j) { return ((live >> j) & 1ull) && k0 + j <= (rr ? pos_hi : pos_lo); },
        fill, st);
  };
  tc::walk_keys<S, D>(sm, (kv_end + tc::KT - 1) / tc::KT, issue, step, &ks_s[0][0], &vs_s[0][0],
                      tid);
  tc::cp_async_wait<0>();  // the query copies, where no tile was walked

  tc::store_rows<D>(out, st, b, L, NH, h, G, row0, r_lo);
}

template <typename T, typename S, int D>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* bt, const void* cl, const void* pos, void* out, int B, int L, int NH,
           int KH, int P, long long num_slots, int page_size, float scale,
           cudaStream_t stream) {
  const int rows = (NH / KH) * L;
  if constexpr (std::is_same<T, float>::value) {
    constexpr size_t smem = smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(paged_attention_kernel<T, S, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((rows + ROWS - 1) / ROWS, KH, B);
    paged_attention_kernel<T, S, D><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const S*>(k), static_cast<const S*>(v),
        static_cast<const float*>(ks), static_cast<const float*>(vs),
        static_cast<const int*>(bt), static_cast<const int*>(cl), static_cast<const int*>(pos),
        static_cast<T*>(out), L, NH, KH, P, num_slots, page_size, scale);
  } else {
    constexpr size_t smem = tc::SMEM<D>;
    cudaError_t err = cudaFuncSetAttribute(paged_attention_tc_kernel<S, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((rows + tc::ROWS - 1) / tc::ROWS, KH, B);
    paged_attention_tc_kernel<S, D><<<grid, tc::THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const S*>(k), static_cast<const S*>(v),
        static_cast<const float*>(ks), static_cast<const float*>(vs),
        static_cast<const int*>(bt), static_cast<const int*>(cl), static_cast<const int*>(pos),
        static_cast<T*>(out), L, NH, KH, P, num_slots, page_size, scale);
  }
  return (int)cudaGetLastError();
}

template <typename T, typename S, int D>
int attrs(int* out) {
  if constexpr (std::is_same<T, float>::value)
    return kernel_attrs(paged_attention_kernel<T, S, D>, false, smem_bytes<D>(), THREADS, out);
  else
    return kernel_attrs(paged_attention_tc_kernel<S, D>, true, tc::SMEM<D>, tc::THREADS, out);
}

}  // namespace

// dtype (queries and output): 0 = float32, 1 = bfloat16.  cache_dtype: 0 =
// float32, 1 = bfloat16, 2 = fp8 e4m3, 3 = int8; k_scale / v_scale are the
// [KH, num_slots] float32 dequant scales for codes 2 and 3 and null otherwise.
// Returns 0 on success, a cudaError_t code after a refused launch, or -1 for a
// shape/dtype the kernel does not take (the Python wrapper checks those first).
extern "C" int jf_paged_attention(const void* q, const void* k, const void* v,
                                  const void* k_scale, const void* v_scale, const void* bt,
                                  const void* cl, const void* pos, void* out, int B, int L,
                                  int NH, int KH, int D, int P, long long num_slots,
                                  int page_size, float scale, int dtype, int cache_dtype,
                                  void* stream) {
  if (B <= 0 || L <= 0 || KH <= 0 || NH % KH != 0 || page_size % 16 != 0) return -1;
  if ((cache_dtype >= 2) != (k_scale != nullptr) || (k_scale == nullptr) != (v_scale == nullptr))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define JF_CALL(T, S, HD)                                                                  \
  launch<T, S, HD>(q, k, v, k_scale, v_scale, bt, cl, pos, out, B, L, NH, KH, P, num_slots, \
                   page_size, scale, s)
  JF_DISPATCH_TYPES(dtype, cache_dtype, D, JF_CALL);
#undef JF_CALL
  return -1;
}

// The tile, registers and shared memory of the variant (dtype, cache_dtype,
// D), as kernel_attrs writes them into out[8]; -1 for a variant that is not
// built.
extern "C" int jf_paged_attention_attrs(int dtype, int cache_dtype, int D, int* out) {
#define JF_CALL(T, S, HD) attrs<T, S, HD>(out)
  JF_DISPATCH_TYPES(dtype, cache_dtype, D, JF_CALL);
#undef JF_CALL
  return -1;
}

extern "C" const char* jf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
