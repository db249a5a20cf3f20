// Paged causal GQA attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel jacobiforcing_tpu/ops/pallas/paged_attention.py
// (paged_attention_pallas, bodies _kernel / _kernel_fused, and the query-tiled
// prefill path _prefill_tiled).  It computes exactly
// jacobiforcing_tpu_torch.ops.attention.paged_attention_ref: queries
// q[B, L, NH, D] at absolute positions[B, L] attend to one layer of the
// head-major paged cache k/v[KH, num_slots, D] through block_tables[B, P];
// key j counts iff j < cache_lens[b] and j <= position.  The cache may be
// stored narrower than the queries (bfloat16 under float32; fp8 e4m3 / e5m2
// or int8 with one float32 dequant scale per stored row, k_scale / v_scale
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
//     kv_end = min(cache_len, last position of the CTA + 1) count for
//     nothing and no -1 page is read: dead tail slots and padding rows cost
//     nothing and never fault (the TMA design reads the rest of the last
//     box, inside the pool, and zeroes it); a tile in the causal future of
//     every row of a warp (warpgroup) is not computed;
//   * exact online softmax with -inf masking, fp32 accumulation.  D in
//     {64, 128} and the cache's storage type are template parameters; any
//     page size that is a multiple of 16.  The tile arithmetic lives in
//     attention_tile.cuh, shared with spec_attention.cu.  Three routes, chosen
//     by the (query, cache) types alone:
//       - float32 queries: the fp32 CUDA-core tile, 64 rows per CTA, 32-key
//         tiles (the exact variant the float32 serving anchors rest on);
//       - bfloat16 queries over a bfloat16 cache: the warp-specialised
//         tensor-core design (paged_attention_ws_kernel, below);
//       - bfloat16 queries over an fp8 / int8 cache: the tensor-core tile fed
//         by cp.async (paged_attention_tc_kernel): 64 rows per warpgroup and
//         tc::WGS warpgroups per CTA sharing each 64-key K/V tile, K/V
//         gathered through the block table by every thread into a ring of
//         raw stages and widened to bf16 with its row scale as it is staged.
//
// The warp-specialised design (bf16 queries, bf16 cache).  The cp.async tile
// spent most of its time outside the tensor cores (8x off its bound in the
// benchmark's Jacobi trips): every thread computed block-table addresses
// and waited on their loads inside the wgmma windows, and the whole CTA met
// at a __syncthreads() on every 64-key tile.  Here the CTA has three
// warpgroups with fixed roles:
//   * one producer warp (the third warpgroup, which hands its registers to
//     the consumers with setmaxnreg) keeps a ring of ws::STAGES K/V stages in
//     flight.  Each stage has a full and an empty mbarrier.  It reads the
//     tile's pages from the block table and loads the K and V tiles with TMA
//     through a 2-D tensor map over the layer's [KH * num_slots, D] cache,
//     in boxes of 64 columns x box_rows keys (box_rows = the largest of 64,
//     32, 16 that divides the page size, so a box never crosses a page),
//     with the 128-byte swizzle that tc::swz and the wgmma descriptors read;
//   * two consumer warpgroups run tc::tile_step on each stage as it lands
//     and release it on its empty barrier.  No barrier spans the CTA inside
//     the walk, and the two warpgroups run apart: named barriers that made
//     them take turns issuing their products (FlashAttention-3's ping-pong)
//     and a software pipeline that issued tile i + 1's scores during tile
//     i's softmax were timed and made it no faster (PERF.md).
//   * CTA z of the grid takes the sequence of rank z by cache length, so the
//     longest walks start first and the grid's last wave holds the shortest.
//   * A key with no row (at or past the length, or on a -1 page) must read
//     as zeros in V, as the cp.async gather's zero-fill made it: pool slots
//     past a sequence's length may hold anything, and NaN * 0 is NaN in P.V.
//     A tile with such keys lands on a barrier of the producer's own; the
//     producer zeroes those V rows and then marks the stage full.  (Their K
//     rows are masked to -inf before the softmax, so they need nothing.)  A
//     tile with no live key loads nothing and is skipped.
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
// Both bf16-query designs call the same tc::tile_step on the same staged
// operand tiles (the same K/V bytes in the same swizzled layout, dead V rows
// zero, dead keys masked), so the two compute the same bits for a row; the
// route depends on the types alone, never on B, L or the lengths.
//
// What bounds it on the H100: for AR decode (L=1) the K/V bytes read
// (3.35 TB/s); for long prefill, and already for Jacobi blocks of L=64 with
// G=7 (448 query rows per KV head), the operations, which only the tensor
// cores (989 TFLOP/s bf16, against 67 TFLOP/s fp32 FMA) can approach.  The
// bf16 designs put both products on the tensor cores; the warp-specialised
// one keeps the address work and the copies' latency off the consumers.
// What bounds it now is each consumer warpgroup's chain per tile: the score
// products, the softmax (32 ex2 a thread on the special-function units and
// the fixed-order max and sum chains), then P.V.  Timed on the H100 (PERF.md):
// K/V loads are not the bound (loading half the bytes, or the same rows
// again, moved the time by 2%), nor the ring's depth (2 to 6 stages, the
// same).  Left for later: a split of
// the keys at fixed boundaries for AR decode at small B (B * KH CTAs leave
// most SMs idle), a persistent grid that loads the next tile of work while
// the last one computes, and a tensor-core path for float32 queries.
// chip_smoke.py records the times beside the bound.

#include <cuda.h>

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

// ---------------------------------------------------------------------------
// The warp-specialised design (bf16 queries over a bf16 cache); see the note
// at the head of this file.
// ---------------------------------------------------------------------------

namespace ws {

constexpr int CONSUMERS = tc::WGS;                 // consumer warpgroups, 64 rows each
constexpr int THREADS = 128 * (CONSUMERS + 1);     // and the producer warpgroup
constexpr int CONSUMER_THREADS = 128 * CONSUMERS;
// K/V stages in the ring
template <int D>
constexpr int STAGES = 4;
// dynamic shared memory: 1 KiB of alignment slack, Q, the K/V ring (tc::Smem's layout)
template <int D>
constexpr size_t SMEM = 1024 + size_t(tc::WGS) * tc::TILE<D> + 2 * size_t(STAGES<D>) * tc::TILE<D>;
// the consumers' named barrier (0 is __syncthreads) for their query tiles
constexpr int BAR_Q = 1;

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(bar)
               : "memory");
}
// arrive and expect `bytes` of asynchronous copies on the barrier's phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// one TMA box of the tensor map at (column, row) into shared memory,
// completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int col, int row,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

}  // namespace ws

// k_map / v_map: the layer's cache as [KH * num_slots, D] bf16, boxes of 64
// columns x box_rows rows, 128-byte swizzle (make_kv_map).
template <int D>
__global__ void __launch_bounds__(ws::THREADS, 1)
paged_attention_ws_kernel(const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __nv_bfloat16* __restrict__ q,
                          const int* __restrict__ block_tables,
                          const int* __restrict__ cache_lens, const int* __restrict__ positions,
                          __nv_bfloat16* __restrict__ out, int L, int NH, int KH, int P,
                          int num_slots, int page_size, int box_rows, float scale) {
  constexpr int ST = ws::STAGES<D>;
  extern __shared__ unsigned char smem_ws[];
  const tc::Smem<D> sm(smem_ws);
  __shared__ __align__(8) unsigned long long full_b[ST], empty_b[ST], fix_b;
  __shared__ unsigned long long live_s[ST];  // per stage: bit j = key j has a row
  __shared__ int pos_s[tc::ROWS];
  __shared__ int warp_max_s[2 * tc::WGS];    // the largest position each warp loaded
  __shared__ int b_s;

  const int B = gridDim.z;
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * tc::ROWS;
  const int G = NH / KH;
  const int n_rows = G * L;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const uint32_t full0 = tc::smem_addr(&full_b[0]), empty0 = tc::smem_addr(&empty_b[0]);
  const uint32_t fix = tc::smem_addr(&fix_b);

  // The longest sequences first: CTAs start in the order of blockIdx.z, and
  // z takes the sequence of rank z by cache length (ties by index), so that
  // the grid's last wave holds the shortest walks.  Which CTA computes a row
  // changes none of its bits.
  for (int i = tid; i < B; i += ws::THREADS) {
    const int len = cache_lens[i];
    int rank = 0;
    for (int o = 0; o < B; ++o) {
      const int other = cache_lens[o];
      rank += other > len || (other == len && o < i);
    }
    if (rank == blockIdx.z) b_s = i;
  }
  __syncthreads();
  const int b = b_s;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      ws::mbar_init(full0 + 8 * s, 1);
      ws::mbar_init(empty0 + 8 * s, 4 * ws::CONSUMERS);  // one arrival per consumer warp
    }
    ws::mbar_init(fix, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // thread i < ROWS loads the position of CTA row i, so warps 2w and 2w + 1
  // hold warpgroup w's 64 rows
  if (tid < tc::ROWS) {
    const int r = row0 + tid;
    const int my_pos = r < n_rows ? positions[(long long)b * L + r / G] : -1;
    pos_s[tid] = my_pos;
    const int max_in_warp = __reduce_max_sync(FULL, my_pos);
    if (lane == 0) warp_max_s[tid >> 5] = max_in_warp;
  }
  __syncthreads();
  int cta_max_pos = -1;
#pragma unroll
  for (int w = 0; w < 2 * tc::WGS; ++w) cta_max_pos = max(cta_max_pos, warp_max_s[w]);
  const int kv_end = min(cache_lens[b], cta_max_pos + 1);
  const int n_tiles = kv_end > 0 ? (kv_end + tc::KT - 1) / tc::KT : 0;

  if (wg == ws::CONSUMERS) {
    // ---- producer: one warp keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid != ws::CONSUMER_THREADS + lane) return;  // the first warp only
    const int* bt = block_tables + (long long)b * P;
    const int head_row = h * num_slots;
    const int n_box = tc::KT / box_rows;
    const uint32_t box_bytes = uint32_t(box_rows) * 128u;  // one box: box_rows x 64 bf16
    // lane j holds the table's entry 32 c + j of the chunk c of pages in use
    // (a tile never spans two chunks: 32 pages hold a multiple of 64 keys)
    int chunk = -1, chunk_page = -1;
    uint32_t fix_phase = 0;
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % ST;
      const int k0 = i * tc::KT;
      const int c = k0 / page_size / 32;
      if (c != chunk) {
        chunk = c;
        chunk_page = 32 * c + lane < P ? bt[32 * c + lane] : -1;
      }
      // lane j < n_box: box j, keys [k0 + j box_rows, k0 + (j + 1) box_rows),
      // which lie on one page
      const int key = k0 + lane * box_rows;
      const int page = __shfl_sync(FULL, chunk_page, (key / page_size) & 31);
      const int n_live = lane < n_box && page >= 0 ? min(max(kv_end - key, 0), box_rows) : 0;
      const unsigned long long box_live =
          n_live == 64 ? ~0ull : ((1ull << n_live) - 1) << (lane * box_rows & 63);
      const unsigned long long live =
          __reduce_or_sync(FULL, unsigned(box_live)) |
          (unsigned long long)__reduce_or_sync(FULL, unsigned(box_live >> 32)) << 32;
      const unsigned issuing = __ballot_sync(FULL, n_live > 0);
      ws::mbar_wait(empty0 + 8 * s, ((i / ST) & 1) ^ 1);  // stage s is consumed
      const uint32_t full = full0 + 8 * s;
      if (lane == 0) live_s[s] = live;
      if (live == 0) {  // no key: nothing to load, the consumers skip the tile
        if (lane == 0) ws::mbar_arrive(full);
        continue;
      }
      // a tile with a dead key lands on `fix` first, for the producer to zero
      const bool dead = live != ~0ull;
      const uint32_t bar = dead ? fix : full;
      if (lane == 0) ws::mbar_expect_tx(bar, __popc(issuing) * box_bytes * (D / 64) * 2);
      __syncwarp();
      if (n_live > 0) {
        const int row = head_row + page * page_size + key % page_size;
#pragma unroll
        for (int cc = 0; cc < D / 64; ++cc) {
          const uint32_t off = cc * tc::SUB + lane * box_bytes;
          ws::tma_load(sm.k(s) + off, &k_map, cc * 64, row, bar);
          ws::tma_load(sm.v(s) + off, &v_map, cc * 64, row, bar);
        }
      }
      if (dead) {
        ws::mbar_wait(fix, fix_phase);
        fix_phase ^= 1;
        unsigned char* v_st = sm.ptr(sm.v(s));
        for (int idx = lane; idx < tc::KT * (D / 8); idx += 32) {
          const int j = idx / (D / 8), cc = idx % (D / 8);
          if (!((live >> j) & 1ull))
            *reinterpret_cast<uint4*>(v_st + tc::swz(j, cc)) = make_uint4(0, 0, 0, 0);
        }
        tc::fence_async_smem();  // the zeros, before wgmma reads the stage
        __syncwarp();
        if (lane == 0) ws::mbar_arrive(full);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns CTA rows [64 wg, 64 wg + 64) ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int r_lo = wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);  // CTA row of row lo
  const int wg_max_pos = max(warp_max_s[2 * wg], warp_max_s[2 * wg + 1]);
  const int pos_lo = pos_s[r_lo], pos_hi = pos_s[r_lo + 8];
  const float scale_log2 = __fmul_rn(scale, 1.4426950408889634f);

  tc::issue_q<D>(q, sm.q, b, L, NH, h, G, row0, tid);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  tc::fence_async_smem();
  ws::bar_sync(ws::BAR_Q, ws::CONSUMER_THREADS);  // both query tiles are in

  tc::Rows<D> st;
  st.init();
  const uint32_t q_wg = sm.q + wg * tc::TILE<D>;
  const int c0 = 2 * (lane & 3);  // this thread's first column of each 8-key group
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % ST;
    const int k0 = i * tc::KT;
    ws::mbar_wait(full0 + 8 * s, (i / ST) & 1);
    const unsigned long long live = live_s[s];
    if (live != 0 && wg_max_pos >= k0) {  // else no key, or every row's causal future
      // the keys a row sees, bit j for key j, shifted by c0 so that each of
      // the thread's 32 scores tests a bit at a position fixed at compile time
      auto seen = [&](int pos) {
        const int n = pos - k0 + 1;  // keys [k0, pos] are not in the row's future
        const unsigned long long past = n >= 64 ? ~0ull : n <= 0 ? 0ull : (1ull << n) - 1;
        return (live & past) >> c0;
      };
      const unsigned long long seen_lo = seen(pos_lo), seen_hi = seen(pos_hi);
      tc::tile_step<D>(
          q_wg, sm.k(s), sm.v(s), scale_log2,
          [&](int rr, int j) { return (((rr ? seen_hi : seen_lo) >> (j - c0)) & 1ull) != 0; },
          [](int) {}, st);
    }
    __syncwarp();
    if (lane == 0) ws::mbar_arrive(empty0 + 8 * s);  // this warp is done with stage s
  }

  tc::store_rows<D>(out, st, b, L, NH, h, G, row0, r_lo);
}

// libcuda's cuTensorMapEncodeTiled, found through the runtime (no -lcuda),
// or null where libcuda lacks it.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

constexpr int TENSOR_MAP_REFUSED = -2;  // jf_error_string names it

// The tensor map of one layer's cache [KH * num_slots, D] (bf16): boxes of 64
// columns x box_rows rows, 128-byte swizzle, as the wgmma operand tiles lie.
int make_kv_map(CUtensorMap* map, const void* base, long long rows, int D, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return TENSOR_MAP_REFUSED;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TENSOR_MAP_REFUSED;
}

// rows of one TMA box: the largest of 64, 32, 16 that divides the page size
int box_rows_for(int page_size) {
  return page_size % 64 == 0 ? 64 : page_size % 32 == 0 ? 32 : 16;
}

template <int D>
int launch_ws(const void* q, const void* k, const void* v, const void* bt, const void* cl,
              const void* pos, void* out, int B, int L, int NH, int KH, int P,
              long long num_slots, int page_size, float scale, cudaStream_t stream) {
  if ((long long)KH * num_slots > 0x7fffffffLL) return -1;  // tensor-map rows are int32
  const int box_rows = box_rows_for(page_size);
  CUtensorMap k_map, v_map;
  int rc = make_kv_map(&k_map, k, KH * num_slots, D, box_rows);
  if (rc == 0) rc = make_kv_map(&v_map, v, KH * num_slots, D, box_rows);
  if (rc != 0) return rc;
  constexpr size_t smem = ws::SMEM<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      paged_attention_ws_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((NH / KH) * L + tc::ROWS - 1) / tc::ROWS, KH, B);
  paged_attention_ws_kernel<D><<<grid, ws::THREADS, smem, stream>>>(
      k_map, v_map, static_cast<const __nv_bfloat16*>(q), static_cast<const int*>(bt),
      static_cast<const int*>(cl), static_cast<const int*>(pos), static_cast<__nv_bfloat16*>(out),
      L, NH, KH, P, (int)num_slots, page_size, box_rows, scale);
  return (int)cudaGetLastError();
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
  } else if constexpr (std::is_same<S, __nv_bfloat16>::value) {
    return launch_ws<D>(q, k, v, bt, cl, pos, out, B, L, NH, KH, P, num_slots, page_size, scale,
                        stream);
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

// out[0]: 0 the fp32 tile, 1 the cp.async tensor-core tile, 2 the
// warp-specialised design
template <typename T, typename S, int D>
int attrs(int* out) {
  if constexpr (std::is_same<T, float>::value) {
    return kernel_attrs(paged_attention_kernel<T, S, D>, false, smem_bytes<D>(), THREADS, out);
  } else if constexpr (std::is_same<S, __nv_bfloat16>::value) {
    const int rc =
        kernel_attrs(paged_attention_ws_kernel<D>, true, ws::SMEM<D>, ws::THREADS, out);
    out[0] = 2;
    out[7] = ws::STAGES<D>;
    return rc;
  } else {
    return kernel_attrs(paged_attention_tc_kernel<S, D>, true, tc::SMEM<D>, tc::THREADS, out);
  }
}

}  // namespace

// dtype (queries and output): 0 = float32, 1 = bfloat16.  cache_dtype: 0 =
// float32, 1 = bfloat16, 2 = fp8 e4m3, 3 = int8, 4 = fp8 e5m2; k_scale /
// v_scale are the [KH, num_slots] float32 dequant scales for codes 2-4 and
// null otherwise.
// Returns 0 on success, a cudaError_t code after a refused launch, -1 for a
// shape/dtype the kernel does not take (the Python wrapper checks those first),
// or -2 where cuTensorMapEncodeTiled refused the K/V tensor map.
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
  if (code == TENSOR_MAP_REFUSED) return "cuTensorMapEncodeTiled refused the K/V cache's TMA map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
