// Speculative (multiblock / rejection-recycling) GQA attention for Hopper
// (sm_90a), plain C interface.
//
// Replaces the TPU kernel jacobiforcing_tpu/ops/pallas/spec_attention.py
// (spec_attention_pallas, body _kernel).  It computes exactly
// jacobiforcing_tpu_torch.ops.attention.paged_attention_with_block_ref:
// queries q[B, T, NH, D] attend to the committed keys of one layer of the
// head-major paged cache k/v[KH, num_slots, D] (key j counts iff
// j < cache_lens[b]; every in-flight query lies past the committed length, so
// there is no causal term) AND to the in-flight block k_new/v_new[B, T, KH, D],
// which is in no cache, under intra_mask[B, T, T] (one byte per entry, shared
// by all heads), with ONE softmax over both.  It writes no K/V.  The cache may
// be stored narrower than the queries (bfloat16 under float32; fp8 e4m3 or
// int8 with per-row float32 dequant scales k_scale / v_scale [KH, num_slots]),
// as in paged_attention.cu: committed rows are dequantized while staged, in
// the query type.  The in-flight block always comes in the query type (for a
// scaled cache the caller has fake-quantized it the same way).
//
// Design:
//   * one CTA per (query-row tile, KV head h, sequence b), rows token-major,
//     as in paged_attention.cu, so the G query heads of a KV head share each
//     K/V tile and each mask byte;
//   * phase 1 walks the committed keys from 0 to cache_lens[b] in fixed tiles
//     through the block table; nothing at or past cache_lens[b] is read and
//     no -1 page is dereferenced, so a padding row (all -1 table) reads
//     nothing;
//   * phase 2 walks the T in-flight keys in tiles of the same width, a key's
//     visibility coming from the mask row of the query's token.  The
//     in-flight K/V is tiled like the committed keys, not held whole (at
//     T = 384, D = 128 it would be 96 KiB each in bf16).  A warp (warpgroup)
//     skips a tile none of its rows can see (RA rows never see candidate or
//     pseudo keys);
//   * m, l and the accumulator carry across both phases: one online softmax.
//     A query row with no visible key at all writes zeros, not NaN.
//   The two tiles of attention_tile.cuh: float32 queries take the fp32
//   CUDA-core tile (64 rows per CTA, 32-key tiles); bfloat16 queries the
//   tensor-core tile (64 rows per warpgroup, tc::WGS warpgroups per CTA
//   sharing each 64-key tile, wgmma scores and P.V, K/V gathered by cp.async
//   into a ring of tc::STAGES stages ahead of the compute, an fp8 / int8
//   cache widened as it is staged).  In phase 2 the CTA stages, with each K/V tile,
//   one 64-bit visibility word per token of its rows, built from the mask
//   bytes.
//
// Bit stability: with the shared tile arithmetic (attention_tile.cuh) a row's
// bits depend only on the row, its committed keys and the in-flight keys its
// mask lets through, in key order within fixed tiles (32 keys in the fp32
// tile, 64 in the tensor-core tile); a fully masked tile changes nothing.
// So the RA segment's rows are bitwise equal whether the call carries T = N,
// K*N or (1+C+K-1)*N tokens, and a sequence's rows do not depend on its
// batch.  With a committed length that is a multiple of the key tile, a row
// is bitwise the row paged_attention.cu gives once the block is committed.
//
// What bounds it on the H100: the operations (4*D per visible key and query
// head; 2688 query rows per KV head at T = 384, G = 7), which only the tensor
// cores (989 TFLOP/s bf16, against 67 TFLOP/s fp32 FMA) can approach.  The
// bf16 variants put both products on the tensor cores and keep several
// tiles' gathers in flight behind the compute; two warpgroups per CTA
// halve how often the committed keys are re-streamed (21 CTAs per
// (sequence, KV head) at T = 384, G = 7, instead of 42).  The committed keys
// are still read once per CTA (from L2 after the first); TMA, a
// warp-specialised producer and one K/V pass per sequence are later work.
// chip_smoke.py records the times beside the bound.

#include "attention_tile.cuh"

namespace {

using namespace jf;

template <typename T, typename S, int D>
__global__ void __launch_bounds__(THREADS)
spec_attention_kernel(const T* __restrict__ q, const S* __restrict__ k_cache,
                      const S* __restrict__ v_cache, const float* __restrict__ k_scale,
                      const float* __restrict__ v_scale, const int* __restrict__ block_tables,
                      const int* __restrict__ cache_lens, const T* __restrict__ k_new,
                      const T* __restrict__ v_new, const unsigned char* __restrict__ intra_mask,
                      T* __restrict__ out, int L, int NH, int KH, int P, long long num_slots,
                      int page_size, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                        // [ROWS][D]
  float* k_s = q_s + ROWS * D;              // [KT][D + 4]
  float* v_s = k_s + KT * K_STRIDE<D>;    // [KT][D]
  __shared__ long long off_s[KT];
  __shared__ float ks_s[KT], vs_s[KT];  // the tile's dequant scales (scaled cache only)
  __shared__ int tok_s[ROWS];  // token of each query row, -1 past the last row

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * ROWS;
  const int G = NH / KH;
  const int n_rows = G * L;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int clen = cache_lens[b];

  for (int i = tid; i < ROWS; i += THREADS) tok_s[i] = row0 + i < n_rows ? (row0 + i) / G : -1;
  load_q_tile<T, D>(q, q_s, b, L, NH, h, G, row0, tid);

  RowState<D> st;
  st.init();
  const float* q_w = q_s + warp * RW * D;

  // ---- phase 1: the committed keys, length mask only ----
  const int* bt = block_tables + (long long)b * P;
  const S* k_head = k_cache + (long long)h * num_slots * D;
  const S* v_head = v_cache + (long long)h * num_slots * D;
  const bool scaled = k_scale != nullptr;
  const float* ks_head = scaled ? k_scale + (long long)h * num_slots : nullptr;
  const float* vs_head = scaled ? v_scale + (long long)h * num_slots : nullptr;
  for (int k0 = 0; k0 < clen; k0 += KT) {
    __syncthreads();  // q_s is loaded / the previous tile is consumed
    if (tid < KT)
      fill_paged_key<D>(off_s, ks_s, vs_s, tid, k0 + tid < clen, bt, P, page_size, k0 + tid,
                        ks_head, vs_head);
    __syncthreads();
    stage_kv_tile<T, S, D>(k_head, v_head, off_s, scaled ? ks_s : nullptr,
                           scaled ? vs_s : nullptr, k_s, v_s, tid);
    __syncthreads();
    const unsigned visible = off_s[lane] >= 0 ? 0xffffu : 0u;
    if (!__any_sync(FULL, visible != 0)) continue;  // a tile of -1 pages
    tile_step<D>(q_w, k_s, v_s, lane, visible, scale, st);
  }

  // ---- phase 2: the in-flight keys under the intra-block mask ----
  const unsigned char* mask_b = intra_mask + (long long)b * L * L;
  const long long blk0 = ((long long)b * L * KH + h) * D;  // (b, token 0, head h)
  for (int j0 = 0; j0 < L; j0 += KT) {
    __syncthreads();
    if (tid < KT) {
      const int j = j0 + tid;
      off_s[tid] = j < L ? (long long)j * KH * D : -1;
    }
    __syncthreads();
    stage_kv_tile<T, T, D>(k_new + blk0, v_new + blk0, off_s, nullptr, nullptr, k_s, v_s, tid);
    __syncthreads();
    const int j = j0 + lane;
    unsigned visible = 0;
    if (j < L) {
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const int t = tok_s[warp * RW + r];  // the row's mask row is its token's
        if (t >= 0 && mask_b[(long long)t * L + j] != 0) visible |= 1u << r;
      }
    }
    if (!__any_sync(FULL, visible != 0)) continue;  // no row of the warp sees this tile
    tile_step<D>(q_w, k_s, v_s, lane, visible, scale, st);
  }

  store_rows<T, D>(out, st, b, L, NH, h, G, row0, warp, lane);
}

// The bfloat16-query variant on the tensor-core tile (see attention_tile.cuh).
template <typename S, int D>
__global__ void __launch_bounds__(tc::THREADS, 1)
spec_attention_tc_kernel(const __nv_bfloat16* __restrict__ q, const S* __restrict__ k_cache,
                         const S* __restrict__ v_cache, const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale, const int* __restrict__ block_tables,
                         const int* __restrict__ cache_lens,
                         const __nv_bfloat16* __restrict__ k_new,
                         const __nv_bfloat16* __restrict__ v_new,
                         const unsigned char* __restrict__ intra_mask,
                         __nv_bfloat16* __restrict__ out, int L, int NH, int KH, int P,
                         long long num_slots, int page_size, float scale) {
  extern __shared__ unsigned char smem_tc[];
  const tc::Smem<D> sm(smem_tc);
  __shared__ unsigned live_s[tc::RAW][2];  // phase 1, per stage: bit j = key j is committed
  // phase 2, per stage: bit j = in-flight key j counts for token t_first + i
  __shared__ unsigned long long vis_s[tc::RAW][tc::ROWS];
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
  // the tokens of the CTA's rows, and of this thread's two rows (-1: none)
  const int t_first = row0 / G;
  const int n_tok = (min(row0 + tc::ROWS, n_rows) - 1) / G - t_first + 1;
  const int tok_lo = row0 + r_lo < n_rows ? (row0 + r_lo) / G : -1;
  const int tok_hi = row0 + r_lo + 8 < n_rows ? (row0 + r_lo + 8) / G : -1;

  tc::issue_q<D>(q, sm.q, b, L, NH, h, G, row0, tid);
  tc::cp_async_commit();

  tc::Rows<D> st;
  st.init();
  const uint32_t q_wg = sm.q + wg * tc::TILE<D>;
  const float scale_log2 = __fmul_rn(scale, 1.4426950408889634f);

  // ---- phase 1: the committed keys, length mask only ----
  const int* bt = block_tables + (long long)b * P;
  const S* k_head = k_cache + (long long)h * num_slots * D;
  const S* v_head = v_cache + (long long)h * num_slots * D;
  const float* ks_head = k_scale != nullptr ? k_scale + (long long)h * num_slots : nullptr;
  const float* vs_head = v_scale != nullptr ? v_scale + (long long)h * num_slots : nullptr;
  const tc::PagedKeys<S, D> keys{k_head, v_head, ks_head, vs_head, bt, P, page_size, clen};
  auto issue1 = [&](int i, int s, int part) {
    keys.issue(sm, i, s, part, live_s[s], ks_s[s], vs_s[s], tid);
  };
  auto step1 = [&](int, int s, uint32_t k, uint32_t v, const auto& fill) {
    const unsigned long long live = tc::live_word(live_s[s]);
    if (live == 0) {  // a tile of -1 pages
      fill(0);
      fill(1);
      return;
    }
    tc::tile_step<D>(q_wg, k, v, scale_log2, [&](int, int j) { return ((live >> j) & 1ull) != 0; },
                     fill, st);
  };
  tc::walk_keys<S, D>(sm, (clen + tc::KT - 1) / tc::KT, issue1, step1, &ks_s[0][0], &vs_s[0][0],
                      tid);

  // ---- phase 2: the in-flight keys under the intra-block mask ----
  const unsigned char* mask_b = intra_mask + (long long)b * L * L;
  const long long blk0 = ((long long)b * L * KH + h) * D;  // (b, token 0, head h)
  auto issue2 = [&](int i, int s, int part) {
    const int j0 = i * tc::KT;
    tc::issue_kv_bf16<D>(k_new + blk0, v_new + blk0,
                         [&](int j) -> long long {
                           return j0 + j < L ? (long long)(j0 + j) * KH * D : -1;
                         },
                         sm.k(s), sm.v(s), tid, part);
    if (part == 0) return;
    // byte `by` of token tt's word: keys j0 + 8 * by .. + 7
    for (int idx = tid; idx < n_tok * 8; idx += tc::THREADS) {
      const int tt = idx >> 3, by = idx & 7;
      const int j = j0 + by * 8;
      const unsigned char* m = mask_b + (long long)(t_first + tt) * L + j;
      unsigned bits = 0;
#pragma unroll
      for (int e = 0; e < 8; ++e) bits |= (j + e < L && m[e] != 0 ? 1u : 0u) << e;
      reinterpret_cast<unsigned char*>(&vis_s[s][tt])[by] = static_cast<unsigned char>(bits);
    }
  };
  auto step2 = [&](int, int s, uint32_t k, uint32_t v, const auto& fill) {
    const unsigned long long w_lo = tok_lo >= 0 ? vis_s[s][tok_lo - t_first] : 0ull;
    const unsigned long long w_hi = tok_hi >= 0 ? vis_s[s][tok_hi - t_first] : 0ull;
    if (!tc::wg_any((w_lo | w_hi) != 0)) {  // no row of the warpgroup sees this tile
      fill(0);
      fill(1);
      return;
    }
    tc::tile_step<D>(q_wg, k, v, scale_log2,
                     [&](int rr, int j) { return (((rr ? w_hi : w_lo) >> j) & 1ull) != 0; },
                     fill, st);
  };
  tc::walk_keys<__nv_bfloat16, D>(sm, (L + tc::KT - 1) / tc::KT, issue2, step2, nullptr, nullptr,
                                  tid);

  tc::store_rows<D>(out, st, b, L, NH, h, G, row0, r_lo);
}

template <typename T, typename S, int D>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* bt, const void* cl, const void* k_new, const void* v_new,
           const void* mask, void* out, int B, int L, int NH, int KH, int P,
           long long num_slots, int page_size, float scale, cudaStream_t stream) {
  const int rows = (NH / KH) * L;
  if constexpr (std::is_same<T, float>::value) {
    constexpr size_t smem = smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(spec_attention_kernel<T, S, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((rows + ROWS - 1) / ROWS, KH, B);
    spec_attention_kernel<T, S, D><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const S*>(k), static_cast<const S*>(v),
        static_cast<const float*>(ks), static_cast<const float*>(vs),
        static_cast<const int*>(bt), static_cast<const int*>(cl), static_cast<const T*>(k_new),
        static_cast<const T*>(v_new), static_cast<const unsigned char*>(mask),
        static_cast<T*>(out), L, NH, KH, P, num_slots, page_size, scale);
  } else {
    constexpr size_t smem = tc::SMEM<D>;
    cudaError_t err = cudaFuncSetAttribute(spec_attention_tc_kernel<S, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((rows + tc::ROWS - 1) / tc::ROWS, KH, B);
    spec_attention_tc_kernel<S, D><<<grid, tc::THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const S*>(k), static_cast<const S*>(v),
        static_cast<const float*>(ks), static_cast<const float*>(vs),
        static_cast<const int*>(bt), static_cast<const int*>(cl), static_cast<const T*>(k_new),
        static_cast<const T*>(v_new), static_cast<const unsigned char*>(mask),
        static_cast<T*>(out), L, NH, KH, P, num_slots, page_size, scale);
  }
  return (int)cudaGetLastError();
}

template <typename T, typename S, int D>
int attrs(int* out) {
  if constexpr (std::is_same<T, float>::value)
    return kernel_attrs(spec_attention_kernel<T, S, D>, false, smem_bytes<D>(), THREADS, out);
  else
    return kernel_attrs(spec_attention_tc_kernel<S, D>, true, tc::SMEM<D>, tc::THREADS, out);
}

}  // namespace

// dtype (queries, in-flight block and output): 0 = float32, 1 = bfloat16.
// cache_dtype: 0 = float32, 1 = bfloat16, 2 = fp8 e4m3, 3 = int8; k_scale /
// v_scale are the [KH, num_slots] float32 dequant scales for codes 2 and 3 and
// null otherwise.  Returns 0 on success, a cudaError_t code after a refused
// launch, or -1 for a shape/dtype the kernel does not take (the Python wrapper
// checks those first).
extern "C" int jf_spec_attention(const void* q, const void* k, const void* v,
                                 const void* k_scale, const void* v_scale, const void* bt,
                                 const void* cl, const void* k_new, const void* v_new,
                                 const void* mask, void* out, int B, int L, int NH, int KH,
                                 int D, int P, long long num_slots, int page_size, float scale,
                                 int dtype, int cache_dtype, void* stream) {
  if (B <= 0 || L <= 0 || KH <= 0 || NH % KH != 0 || page_size % 16 != 0) return -1;
  if ((cache_dtype >= 2) != (k_scale != nullptr) || (k_scale == nullptr) != (v_scale == nullptr))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define JF_CALL(T, S, HD)                                                                    \
  launch<T, S, HD>(q, k, v, k_scale, v_scale, bt, cl, k_new, v_new, mask, out, B, L, NH, KH, \
                   P, num_slots, page_size, scale, s)
  JF_DISPATCH_TYPES(dtype, cache_dtype, D, JF_CALL);
#undef JF_CALL
  return -1;
}

// The tile, registers and shared memory of the variant (dtype, cache_dtype,
// D), as kernel_attrs writes them into out[8]; -1 for a variant that is not
// built.
extern "C" int jf_spec_attention_attrs(int dtype, int cache_dtype, int D, int* out) {
#define JF_CALL(T, S, HD) attrs<T, S, HD>(out)
  JF_DISPATCH_TYPES(dtype, cache_dtype, D, JF_CALL);
#undef JF_CALL
  return -1;
}

extern "C" const char* jf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
