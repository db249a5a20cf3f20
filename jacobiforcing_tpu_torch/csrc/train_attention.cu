// Block-sparse GQA attention over the consistency trainer's packed row, forward
// and backward, for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel jacobiforcing_tpu/ops/pallas/train_attention.py
// (splash_train_attention: jax's splash-attention kernel under the computable
// JacobiTrainingMask, forward and custom-VJP backward).  It computes exactly
// jacobiforcing_tpu_torch.ops.train_attention.train_attention_ref and its
// gradients: one packed row q[L, NH, D], k/v[L, KH, D] laid out as
// [prompt][k_0][last_0]...[k_{T-1}][last_{T-1}] in blocks of N tokens, under
// the visibility rule of train_mask (see `sees` below), scale 1/sqrt(D).
//
// Design (simple kernels on the CUDA cores that are right first):
//   * No [L, L] mask exists anywhere.  The host classifies every (query tile of
//     64 rows, key tile of 32 keys) pair as empty, partial or full and hands the
//     kernels two CSR lists: per query tile its non-empty key tiles, per key
//     tile its non-empty query tiles (entry = 2 * tile + is_full).  A full tile
//     runs unmasked; a partial tile evaluates the rule per element from the six
//     layout scalars, with the block number of each row and key worked out once
//     per tile; an empty tile is never visited.
//   * Rows are token-major (row = token * G + head in group), so the G query
//     heads of a KV head share each K/V tile, and dK/dV sum over the group in
//     registers: no K/V repeat, no per-head mask copies.
//   * forward: one CTA per (query tile, KV head), the online-softmax tile step
//     shared with the serving kernels (attention_tile.cuh); writes the output
//     and the row log-sum-exp.  A row with no visible key writes zeros and a
//     log-sum-exp of 0, and the backward gives it zero gradients: every one of
//     its probabilities is masked to 0, so exp(s - lse) is never taken for it.
//   * backward, no atomics, fixed summation order, so gradients are
//     bit-identical run to run: a small kernel takes delta = rowsum(dO * O);
//     the dQ kernel (one CTA per query tile and KV head) walks key tiles as the
//     forward does; the dK/dV kernel (one CTA per key tile and KV head) walks
//     the query tiles of the transposed list in halves of 32 rows, recomputes P
//     from the saved log-sum-exp, passes P and dS through shared memory and
//     accumulates dV += P^T dO and dK += dS^T Q for its 32 keys over all G
//     heads, then writes dK/dV[L, KH, D] once.
//
// What bounds it on the H100: the operations (4*D per visible pair and query
// head forward, 10*D backward: five products), which belong on the tensor
// cores.  These kernels compute in fp32 on the CUDA cores; chip_smoke.py
// records their times beside the bound.  The dK/dV grid is unbalanced (a prompt
// key tile is seen by every row, a k_j tile by its own block only); wgmma, TMA
// pipelining and a balanced dK/dV schedule are later work.

#include "attention_tile.cuh"

namespace {

using namespace jf;

constexpr int RQ = 32;            // query rows per step of the dK/dV kernel
constexpr int PS = KT + 1;        // padded row of the P / dS exchange buffers

struct Layout {
  int P, T, seq_len, N, variant, W;  // variant: 0 single, 1 multiblock, 2 window
};

// Block number of a position: -1 in the prompt, -2 where the position takes no
// part (no such row, at or past seq_len, or past pair T), else (pos - P) / N,
// even for a k_j block and odd for a last_j block.  pos - P is never negative
// where it is divided, so C++ truncation equals the floor the rule is written in.
__device__ __forceinline__ int block_of(int pos, const Layout& lay) {
  if (pos < 0 || pos >= lay.seq_len) return -2;
  if (pos < lay.P) return -1;
  const int b = (pos - lay.P) / lay.N;
  return b < 2 * lay.T ? b : -2;
}

// Does query position q (block bq) see key position k (block bk)?
__device__ __forceinline__ bool sees(int q, int bq, int k, int bk, const Layout& lay) {
  if (bq == -2 || bk == -2) return false;
  if (bq == -1) return k <= q;       // prompt rows: causal (so the key is a prompt key)
  if (bk == -1) return true;         // every block row sees the whole prompt
  if (bk == bq) return k <= q;       // its own block, causally
  const int first_of_pair = bq & ~1; // 2 * j_q
  if (bk & 1) return bk < first_of_pair;                    // previous last_* blocks
  if ((bq & 1) || lay.variant == 0 || bk >= first_of_pair)  // k_* blocks: only k_j rows of
    return false;                                           // multiblock / window see them
  if (lay.variant == 2) return (bk >> 1) / lay.W == (bq >> 1) / lay.W;
  return true;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Stage n rows of D elements into dst (row stride STRIDE) as fp32; row i lives
// at element offset off[i] of src, a negative offset stages zeros.
template <typename T, int D, int STRIDE>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, const long long* off,
                                           float* dst, int n, int tid) {
  constexpr int NV = Vec<T>::N;
  for (int idx = tid; idx < n * (D / NV); idx += THREADS) {
    const int i = idx / (D / NV);
    const int c = (idx % (D / NV)) * NV;
    float vals[NV];
    if (off[i] >= 0) {
      Vec<T>::load(src + off[i] + c, vals);
    } else {
#pragma unroll
      for (int e = 0; e < NV; ++e) vals[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < NV; ++e) dst[i * STRIDE + c + e] = vals[e];
  }
}

// Bit r of the result: does this lane's key (position kk) count for row r of
// the n rows whose tokens / blocks are tok[r] / blk[r]?
__device__ __forceinline__ unsigned visible_bits(const int* tok, const int* blk, int n, int kk,
                                                 int L, const Layout& lay) {
  const int bk = block_of(kk < L ? kk : -1, lay);
  unsigned bits = 0;
  if (bk != -2) {
    for (int r = 0; r < n; ++r)
      if (sees(tok[r], blk[r], kk, bk, lay)) bits |= 1u << r;
  }
  return bits;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
train_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ q_ptr, const int* __restrict__ q_ent,
                 T* __restrict__ out, float* __restrict__ lse, int L, int NH, int KH, Layout lay,
                 float scale) {
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                      // [ROWS][D]
  float* k_s = q_s + ROWS * D;            // [KT][D + 4]
  float* v_s = k_s + KT * K_STRIDE<D>;    // [KT][D]
  __shared__ long long off_s[KT];
  __shared__ int tok_s[ROWS], blk_s[ROWS];

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int row0 = qt * ROWS;
  const int G = NH / KH;
  const int n_rows = G * L;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < ROWS; i += THREADS) {
    const int t = row0 + i < n_rows ? (row0 + i) / G : -1;
    tok_s[i] = t;
    blk_s[i] = block_of(t, lay);
  }
  load_q_tile<T, D>(q, q_s, 0, L, NH, h, G, row0, tid);

  RowState<D> st;
  st.init();
  const float* q_w = q_s + warp * RW * D;
  const int e_end = q_ptr[qt + 1];
  for (int e = q_ptr[qt]; e < e_end; ++e) {
    const int ent = q_ent[e];
    const int k0 = (ent >> 1) * KT;
    __syncthreads();  // q_s and the row tables are loaded / the previous tile is consumed
    if (tid < KT) off_s[tid] = k0 + tid < L ? (long long)(k0 + tid) * KH * D : -1;
    __syncthreads();
    stage_kv_tile<T, T, D>(k + h * D, v + h * D, off_s, nullptr, nullptr, k_s, v_s, tid);
    __syncthreads();
    unsigned visible = 0xffffu;
    if (!(ent & 1)) {
      visible = visible_bits(tok_s + warp * RW, blk_s + warp * RW, RW, k0 + lane, L, lay);
      if (!__any_sync(FULL, visible != 0)) continue;  // no row of the warp sees this tile
    }
    tile_step<D>(q_w, k_s, v_s, lane, visible, scale, st);
  }

  store_rows<T, D>(out, st, 0, L, NH, h, G, row0, warp, lane);
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int row = row0 + warp * RW + r;
      if (row >= n_rows) continue;
      lse[(long long)(row / G) * NH + h * G + row % G] =
          st.l[r] > 0.f ? st.m[r] + logf(st.l[r]) : 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// delta[t, head] = sum_d dO * O, one warp per row, fixed order.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
train_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                   float* __restrict__ delta, long long n_rows) {
  constexpr int DPL = D / 32;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int lane = threadIdx.x & 31;
  const T* o = out + row * D + lane * DPL;
  const T* g = dout + row * D + lane * DPL;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < DPL; ++i) s = fmaf(to_f32(g[i]), to_f32(o[i]), s);
  s = warp_sum(s);
  if (lane == 0) delta[row] = s;
}

// Rows of one (query tile or half tile, KV head): token, block, element offset
// into q / dO, log-sum-exp and delta of each, for n rows from row0 on.
__device__ __forceinline__ void load_row_tables(int row0, int n, int L, int NH, int h, int G,
                                                int D, const Layout& lay,
                                                const float* __restrict__ lse,
                                                const float* __restrict__ delta, int* tok_s,
                                                int* blk_s, long long* off_s, float* lse_s,
                                                float* delta_s, int tid) {
  for (int i = tid; i < n; i += THREADS) {
    const int row = row0 + i;
    if (row < G * L) {
      const int t = row / G;
      const long long head_row = (long long)t * NH + h * G + row % G;
      tok_s[i] = t;
      blk_s[i] = block_of(t, lay);
      off_s[i] = head_row * D;
      lse_s[i] = lse[head_row];
      delta_s[i] = delta[head_row];
    } else {
      tok_s[i] = -1;
      blk_s[i] = -2;
      off_s[i] = -1;
      lse_s[i] = 0.f;
      delta_s[i] = 0.f;
    }
  }
}

// Scores and dP of NR rows against this lane's key: s[r] = q_r . k, dp[r] = dO_r . v,
// the score as the forward's fmaf chain so that exp(s - lse) repeats its bits.
template <int D, int NR>
__device__ __forceinline__ void score_rows(const float* q_w, const float* do_w,
                                           const float* krow, const float* vrow, float* s,
                                           float* dp) {
#pragma unroll
  for (int r = 0; r < NR; ++r) s[r] = dp[r] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    const float4 k4 = *reinterpret_cast<const float4*>(krow + d);
    const float4 v4 = *reinterpret_cast<const float4*>(vrow + d);
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const float4 q4 = *reinterpret_cast<const float4*>(q_w + r * D + d);
      const float4 g4 = *reinterpret_cast<const float4*>(do_w + r * D + d);
      s[r] = fmaf(q4.x, k4.x, s[r]);
      s[r] = fmaf(q4.y, k4.y, s[r]);
      s[r] = fmaf(q4.z, k4.z, s[r]);
      s[r] = fmaf(q4.w, k4.w, s[r]);
      dp[r] = fmaf(g4.x, v4.x, dp[r]);
      dp[r] = fmaf(g4.y, v4.y, dp[r]);
      dp[r] = fmaf(g4.z, v4.z, dp[r]);
      dp[r] = fmaf(g4.w, v4.w, dp[r]);
    }
  }
}

// dQ: one CTA per (query tile, KV head).  Lane j scores key j of the tile
// against the warp's RW rows, dS goes from lane to lane by shuffle, and lane i
// holds dims [i * D/32, (i + 1) * D/32) of each row's dQ.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
train_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, const int* __restrict__ q_ptr,
                const int* __restrict__ q_ent, T* __restrict__ dq, int L, int NH, int KH,
                Layout lay, float scale) {
  constexpr int DPL = D / 32;
  constexpr int KS = K_STRIDE<D>;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                 // [ROWS][D]
  float* do_s = q_s + ROWS * D;      // [ROWS][D]
  float* k_s = do_s + ROWS * D;      // [KT][D + 4]
  float* v_s = k_s + KT * KS;        // [KT][D + 4]
  __shared__ long long off_s[ROWS];
  __shared__ long long koff_s[KT];
  __shared__ int tok_s[ROWS], blk_s[ROWS];
  __shared__ float lse_s[ROWS], delta_s[ROWS];

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int row0 = qt * ROWS;
  const int G = NH / KH;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  load_row_tables(row0, ROWS, L, NH, h, G, D, lay, lse, delta, tok_s, blk_s, off_s, lse_s,
                  delta_s, tid);
  __syncthreads();
  stage_rows<T, D, D>(q, off_s, q_s, ROWS, tid);
  stage_rows<T, D, D>(dout, off_s, do_s, ROWS, tid);

  float acc[RW][DPL];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;

  const float* q_w = q_s + warp * RW * D;
  const float* do_w = do_s + warp * RW * D;
  const int e_end = q_ptr[qt + 1];
  for (int e = q_ptr[qt]; e < e_end; ++e) {
    const int ent = q_ent[e];
    const int k0 = (ent >> 1) * KT;
    __syncthreads();  // q_s / do_s are staged, the previous tile is consumed
    if (tid < KT) koff_s[tid] = k0 + tid < L ? ((long long)(k0 + tid) * KH + h) * D : -1;
    __syncthreads();
    stage_rows<T, D, KS>(k, koff_s, k_s, KT, tid);
    stage_rows<T, D, KS>(v, koff_s, v_s, KT, tid);
    __syncthreads();
    unsigned visible = 0xffffu;
    if (!(ent & 1)) {
      visible = visible_bits(tok_s + warp * RW, blk_s + warp * RW, RW, k0 + lane, L, lay);
      if (!__any_sync(FULL, visible != 0)) continue;
    }
    float s[RW], dp[RW];
    score_rows<D, RW>(q_w, do_w, k_s + lane * KS, v_s + lane * KS, s, dp);
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const bool ok = (visible >> r) & 1u;
      const float p = ok ? expf(__fmul_rn(s[r], scale) - lse_s[warp * RW + r]) : 0.f;
      s[r] = __fmul_rn(p, dp[r] - delta_s[warp * RW + r]);  // dS
    }
    // dQ += dS @ K over the tile, keys in order
#pragma unroll 2
    for (int jj = 0; jj < KT; ++jj) {
      float kv[DPL];
      const float* krow = k_s + jj * KS + lane * DPL;
      if constexpr (DPL == 4) {
        const float4 x = *reinterpret_cast<const float4*>(krow);
        kv[0] = x.x; kv[1] = x.y; kv[2] = x.z; kv[3] = x.w;
      } else {
        const float2 x = *reinterpret_cast<const float2*>(krow);
        kv[0] = x.x; kv[1] = x.y;
      }
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float ds = __shfl_sync(FULL, s[r], jj);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(ds, kv[i], acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const long long off = off_s[warp * RW + r];
    if (off < 0) continue;
    T* o = dq + off + lane * DPL;
#pragma unroll
    for (int i = 0; i < DPL; ++i) o[i] = Vec<T>::from_f32(__fmul_rn(acc[r][i], scale));
  }
}

// dK/dV: one CTA per (key tile, KV head).  Lane j owns key j of the tile.  Per
// half query tile of RQ rows: warp w scores rows [w * RQ/4, (w + 1) * RQ/4)
// (P and dS go to shared memory), then thread (w, j) adds all RQ rows into
// dims [w * D/4, (w + 1) * D/4) of dV[j] and dK[j].
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
train_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, const int* __restrict__ k_ptr,
                  const int* __restrict__ k_ent, T* __restrict__ dk, T* __restrict__ dv, int L,
                  int NH, int KH, Layout lay, float scale) {
  constexpr int KS = K_STRIDE<D>;
  constexpr int DW = D / WARPS;   // dims of dK / dV per thread
  constexpr int RWB = RQ / WARPS; // rows scored per warp
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;               // [KT][D + 4]
  float* v_s = k_s + KT * KS;      // [KT][D + 4]
  float* q_s = v_s + KT * KS;      // [RQ][D]
  float* do_s = q_s + RQ * D;      // [RQ][D]
  float* p_s = do_s + RQ * D;      // [RQ][KT + 1]
  float* ds_s = p_s + RQ * PS;     // [RQ][KT + 1]
  __shared__ long long off_s[RQ];
  __shared__ long long koff_s[KT];
  __shared__ int tok_s[RQ], blk_s[RQ];
  __shared__ float lse_s[RQ], delta_s[RQ];

  const int kt = blockIdx.x;
  const int h = blockIdx.y;
  const int k0 = kt * KT;
  const int G = NH / KH;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (tid < KT) koff_s[tid] = k0 + tid < L ? ((long long)(k0 + tid) * KH + h) * D : -1;
  __syncthreads();
  stage_rows<T, D, KS>(k, koff_s, k_s, KT, tid);
  stage_rows<T, D, KS>(v, koff_s, v_s, KT, tid);

  float acc_k[DW], acc_v[DW];
#pragma unroll
  for (int i = 0; i < DW; ++i) acc_k[i] = acc_v[i] = 0.f;

  const int e_end = k_ptr[kt + 1];
  for (int e = k_ptr[kt]; e < e_end; ++e) {
    const int ent = k_ent[e];
    for (int half = 0; half < ROWS / RQ; ++half) {
      const int row0 = (ent >> 1) * ROWS + half * RQ;
      __syncthreads();  // K / V are staged, the previous rows are consumed
      load_row_tables(row0, RQ, L, NH, h, G, D, lay, lse, delta, tok_s, blk_s, off_s, lse_s,
                      delta_s, tid);
      __syncthreads();
      stage_rows<T, D, D>(q, off_s, q_s, RQ, tid);
      stage_rows<T, D, D>(dout, off_s, do_s, RQ, tid);
      __syncthreads();

      // ---- this warp's rows against this lane's key ----
      unsigned visible = 0;
      if (ent & 1) {
#pragma unroll
        for (int r = 0; r < RWB; ++r)
          if (tok_s[warp * RWB + r] >= 0) visible |= 1u << r;
      } else {
        visible = visible_bits(tok_s + warp * RWB, blk_s + warp * RWB, RWB, k0 + lane, L, lay);
      }
      const bool any = __syncthreads_or(visible != 0);
      if (!any) continue;  // nothing of these rows sees this key tile (the whole CTA agrees)
      float s[RWB], dp[RWB];
      score_rows<D, RWB>(q_s + warp * RWB * D, do_s + warp * RWB * D, k_s + lane * KS,
                         v_s + lane * KS, s, dp);
#pragma unroll
      for (int r = 0; r < RWB; ++r) {
        const int i = warp * RWB + r;
        const bool ok = (visible >> r) & 1u;
        const float p = ok ? expf(__fmul_rn(s[r], scale) - lse_s[i]) : 0.f;
        p_s[i * PS + lane] = p;
        ds_s[i * PS + lane] = __fmul_rn(p, dp[r] - delta_s[i]);
      }
      __syncthreads();

      // ---- dV[j] += P^T dO, dK[j] += dS^T Q, rows in order ----
      const float* do_w = do_s + warp * DW;
      const float* q_w = q_s + warp * DW;
#pragma unroll 2
      for (int i = 0; i < RQ; ++i) {
        const float p = p_s[i * PS + lane];
        const float ds = ds_s[i * PS + lane];
#pragma unroll
        for (int d = 0; d < DW; d += 4) {
          const float4 g4 = *reinterpret_cast<const float4*>(do_w + i * D + d);
          const float4 q4 = *reinterpret_cast<const float4*>(q_w + i * D + d);
          acc_v[d] = fmaf(p, g4.x, acc_v[d]);
          acc_v[d + 1] = fmaf(p, g4.y, acc_v[d + 1]);
          acc_v[d + 2] = fmaf(p, g4.z, acc_v[d + 2]);
          acc_v[d + 3] = fmaf(p, g4.w, acc_v[d + 3]);
          acc_k[d] = fmaf(ds, q4.x, acc_k[d]);
          acc_k[d + 1] = fmaf(ds, q4.y, acc_k[d + 1]);
          acc_k[d + 2] = fmaf(ds, q4.z, acc_k[d + 2]);
          acc_k[d + 3] = fmaf(ds, q4.w, acc_k[d + 3]);
        }
      }
    }
  }

  if (k0 + lane < L) {
    const long long off = ((long long)(k0 + lane) * KH + h) * D + warp * DW;
#pragma unroll
    for (int i = 0; i < DW; ++i) {
      dk[off + i] = Vec<T>::from_f32(__fmul_rn(acc_k[i], scale));
      dv[off + i] = Vec<T>::from_f32(acc_v[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * size_t(ROWS) * D + 2 * size_t(KT) * K_STRIDE<D>);
}

template <int D>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(float) * (2 * size_t(KT) * K_STRIDE<D> + 2 * size_t(RQ) * D + 2 * size_t(RQ) * PS);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

struct Args {
  const void *q, *k, *v, *out, *dout, *lse, *delta, *ptr, *ent;
  void *o0, *o1;  // outputs: fwd (out, lse), dq (dq, delta), dkdv (dk, dv)
  int L, NH, KH;
  Layout lay;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_fwd(const Args& a) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = allow_smem(train_fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = (a.NH / a.KH) * a.L;
  const dim3 grid((rows + ROWS - 1) / ROWS, a.KH);
  train_fwd_kernel<T, D><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const int*>(a.ptr), static_cast<const int*>(a.ent), static_cast<T*>(a.o0),
      static_cast<float*>(a.o1), a.L, a.NH, a.KH, a.lay, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const Args& a) {
  const long long n_rows = (long long)a.L * a.NH;
  train_delta_kernel<T, D><<<(unsigned)((n_rows + WARPS - 1) / WARPS), THREADS, 0, a.stream>>>(
      static_cast<const T*>(a.out), static_cast<const T*>(a.dout), static_cast<float*>(a.o1),
      n_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr size_t smem = dq_smem_bytes<D>();
  err = allow_smem(train_dq_kernel<T, D>, smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = (a.NH / a.KH) * a.L;
  const dim3 grid((rows + ROWS - 1) / ROWS, a.KH);
  train_dq_kernel<T, D><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.o1), static_cast<const int*>(a.ptr),
      static_cast<const int*>(a.ent), static_cast<T*>(a.o0), a.L, a.NH, a.KH, a.lay, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkdv(const Args& a) {
  constexpr size_t smem = dkdv_smem_bytes<D>();
  cudaError_t err = allow_smem(train_dkdv_kernel<T, D>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.L + KT - 1) / KT, a.KH);
  train_dkdv_kernel<T, D><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const int*>(a.ptr),
      static_cast<const int*>(a.ent), static_cast<T*>(a.o0), static_cast<T*>(a.o1), a.L, a.NH,
      a.KH, a.lay, a.scale);
  return (int)cudaGetLastError();
}

// which: 0 forward, 1 dQ (with delta), 2 dK/dV
int dispatch(int which, int dtype, int D, const Args& a) {
  if (a.L <= 0 || a.KH <= 0 || a.NH % a.KH != 0 || a.lay.N <= 0 || a.lay.W <= 0 ||
      a.lay.P < 0 || a.lay.T < 0 || a.lay.seq_len < 0 || a.lay.seq_len > a.L ||
      a.lay.variant < 0 || a.lay.variant > 2)
    return -1;
#define JF_CASE(TYPE, DIM)                                   \
  switch (which) {                                           \
    case 0: return launch_fwd<TYPE, DIM>(a);                 \
    case 1: return launch_dq<TYPE, DIM>(a);                  \
    case 2: return launch_dkdv<TYPE, DIM>(a);                \
    default: return -1;                                      \
  }
  if (dtype == 0 && D == 64) JF_CASE(float, 64)
  if (dtype == 0 && D == 128) JF_CASE(float, 128)
  if (dtype == 1 && D == 64) JF_CASE(__nv_bfloat16, 64)
  if (dtype == 1 && D == 128) JF_CASE(__nv_bfloat16, 128)
#undef JF_CASE
  return -1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `layout` is {prompt_len, T, seq_len, N,
// variant (0 single, 1 multiblock, 2 window), window_size}.  Each returns 0 on
// success, a cudaError_t code after a refused launch, or -1 for a shape, dtype
// or layout the kernels do not take (the Python wrapper checks those first).

extern "C" int jf_train_attention_fwd(const void* q, const void* k, const void* v,
                                      const void* q_ptr, const void* q_ent, void* out, void* lse,
                                      int L, int NH, int KH, int D, const int* layout,
                                      float scale, int dtype, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.ptr = q_ptr; a.ent = q_ent; a.o0 = out; a.o1 = lse;
  a.L = L; a.NH = NH; a.KH = KH; a.scale = scale;
  a.lay = Layout{layout[0], layout[1], layout[2], layout[3], layout[4], layout[5]};
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(0, dtype, D, a);
}

// Also writes delta[L, NH] = rowsum(dout * out), which the dK/dV call reads.
extern "C" int jf_train_attention_dq(const void* q, const void* k, const void* v,
                                     const void* out, const void* dout, const void* lse,
                                     const void* q_ptr, const void* q_ent, void* dq, void* delta,
                                     int L, int NH, int KH, int D, const int* layout,
                                     float scale, int dtype, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.out = out; a.dout = dout; a.lse = lse; a.ptr = q_ptr;
  a.ent = q_ent; a.o0 = dq; a.o1 = delta;
  a.L = L; a.NH = NH; a.KH = KH; a.scale = scale;
  a.lay = Layout{layout[0], layout[1], layout[2], layout[3], layout[4], layout[5]};
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(1, dtype, D, a);
}

extern "C" int jf_train_attention_dkdv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       const void* k_ptr, const void* k_ent, void* dk, void* dv,
                                       int L, int NH, int KH, int D, const int* layout,
                                       float scale, int dtype, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta; a.ptr = k_ptr;
  a.ent = k_ent; a.o0 = dk; a.o1 = dv;
  a.L = L; a.NH = NH; a.KH = KH; a.scale = scale;
  a.lay = Layout{layout[0], layout[1], layout[2], layout[3], layout[4], layout[5]};
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(2, dtype, D, a);
}

extern "C" const char* jf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
