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
// What bounds it on the H100: the operations.  Per visible (query row, key)
// pair the forward does 4*D (S = Q.K^T, O += P.V), dQ 6*D and dK/dV 8*D
// (S and dP recomputed, dV += P^T.dO, dK += dS^T.Q), against 2-4 bf16 inputs
// of D elements per row read once: at the trainer's shapes (L 4096, 70% of
// the pairs masked) that is over a thousand operations per byte, far above the
// H100's 295 operations per byte in bf16.  The products belong on the tensor
// cores (989 TFLOP/s bf16, against 67 TFLOP/s fp32 on the CUDA cores).
//
// Common to every kernel here:
//   * No [L, L] mask exists anywhere.  The host classifies every (query tile of
//     64 rows, key tile) pair as empty, partial or full and hands the kernels
//     CSR lists (ops/train_attention.classify_tiles): per query tile its
//     non-empty key tiles, per key tile its non-empty query tiles.  A full
//     tile runs unmasked; a partial tile evaluates the rule from the six
//     layout scalars (`sees` below: per element in the fp32 kernels, once per
//     run of keys that share a block in the bf16 ones, which build a 64-bit
//     visibility word per query row and tile); an empty tile is never visited.
//   * Rows are token-major (row = token * G + head in group), so the G query
//     heads of a KV head share each K/V tile, and dK/dV sum over the group
//     inside the tile products: no K/V repeat, no per-head mask copies.
//   * A row with no visible key writes zeros and a log-sum-exp of 0, and the
//     backward gives it zero gradients: every one of its probabilities is
//     masked to 0, so exp(s - lse) is never taken for it.
//   * No atomics, fixed summation orders: gradients are bit-identical run to
//     run.
//
// float32 inputs: exact fp32 kernels on the CUDA cores (32-key tiles, the fp32
// tile of attention_tile.cuh), which carry the f32 training anchors.
//   * forward: one CTA per (query tile, KV head), the online-softmax tile step
//     shared with the serving kernels; writes O and the row log-sum-exp.
//   * dQ: train_dq_kernel, one CTA per (query tile, KV head), in two sweeps
//     over the row's visible key tiles.  The backward recomputes P_ij =
//     exp(s_ij - lse_i), and lse's rounding (~1e-7 of |lse|) scales a whole
//     row of P by one factor 1 + eps, so sigma_i = sum_j P_ij is not 1 to
//     rounding; autograd's softmax keeps it so.  The first sweep therefore
//     takes sigma_i and sum_j P_ij dP_ij from the same P and dP that form dS
//     (keys in list order per lane, then a fixed shuffle tree across lanes),
//     and the P of both backward kernels is P / sigma, with delta_i = sum_j
//     (P_ij / sigma_i) dP_ij: sum_j dS_ij is then zero to rounding, as in
//     autograd.  Delta and sigma go to dK/dV in one [2][L, NH] buffer.  The
//     second sweep forms dS = (P / sigma) (dP - delta) and dQ += dS.K, dS
//     going from lane to lane by shuffle.  With delta = rowsum(dO * O) and an
//     unnormalised P, sum_j dS_ij kept a rounding residue, and where the
//     exact gradient cancels (q and k projections and biases) it flipped
//     the sign of ~1% of the gradient's entries.  The first sweep costs a
//     second pass of scores: dQ takes about twice the time of one sweep, on
//     the demo-width path only.
//   * dK/dV: one CTA per (key tile, KV head) over the transposed list, in
//     halves of 32 query rows, with dQ's delta and sigma; P / sigma and dS
//     pass through shared memory.
//
// bfloat16 inputs: all three on Hopper's tensor cores (wgmma, the jf::tc
// tools of attention_tile.cuh), 64-key tiles:
//   * forward (train_fwd_tc_kernel): the serving kernels' tensor-core tile.
//     A CTA of two warpgroups holds two query tiles (128 rows) and walks the
//     64-key tiles either of them sees, in ascending order, through a ring of
//     cp.async stages; the host's pair list says per warpgroup whether a tile
//     is empty (the warpgroup skips it), partial (masked by the words) or
//     full, and the pairs with the longest lists are launched first.
//     Writes O, a float32 log-sum-exp, which dQ and dK/dV read, and O's
//     rounding residual O_lo = bf16(O - bf16(O)), which dQ reads.
//   * dQ (train_dq_tc_kernel): the forward's grid, pair lists, K/V ring and
//     masking, with the CTA's dO tiles staged beside its Q tiles.  Per key
//     tile S = Q.K^T and dP = dO.V^T by wgmma from shared memory (K and V
//     read K-major), P = 2^(scale_log2 S - lse log2 e) and dS = P (dP -
//     delta) on the accumulator fragments, then dQ += dS.K with dS rounded
//     to bf16 as the register A operand and K read MN-major (as P.V reads
//     V); dQ is scaled once at the end.  Delta is folded in: each CTA first
//     takes rowsum(dO * (O + O_lo)) of its 128 rows and writes it for dK/dV,
//     so one kernel replaces the fp32 pair.  O + O_lo is the forward's
//     float32 O to about 2^-17 of itself: delta from the bf16 O alone is off
//     by up to 2^-9 of rowsum|dO * O|, and in dQ = scale P (dP - delta) K that
//     error does not cancel where the exact terms do (a row that sees few
//     keys), which put dQ past the bf16 rule at one KV head.  Bounded, like the
//     forward, by the operations (three products per visible pair against
//     the forward's two); what it leaves on the table is the same: the copy
//     issue of the 16-byte cp.async gathers inside the wgmma windows and one
//     CTA per SM (~198 KiB of shared memory at D 128), which TMA and a
//     producer warp would lift.
//   * dK/dV (train_dkdv_tc_kernel): a CTA is one warpgroup that owns 64 keys
//     of one KV head and keeps their dK and dV in fp32 registers.  Per query
//     tile (64 token-major rows, Q and dO double-buffered by cp.async):
//     S^T = K.Q^T and dP^T = V.dO^T by wgmma from shared memory (Q and dO
//     read K-major); P^T = exp(scale S^T - lse), dS^T = P^T (dP^T - delta) on
//     the accumulator fragments; then dV += P^T.dO and dK += dS^T.Q with P^T
//     and dS^T rounded to bf16 as register A operands and dO and Q read
//     MN-major.
//   * A balanced dK/dV grid: a prompt key tile is seen by every query tile, a
//     k_j tile under `single` by the few of its own block, so one CTA per key
//     tile leaves the card waiting on the prompt tiles.  The host cuts each
//     key tile's list into chunks of at most C query tiles (C and why:
//     ops/train_attention.py, DKDV_CHUNKS); each (chunk, KV head) is one CTA,
//     launched longest first.  A key tile of one chunk writes dK / dV itself;
//     one of several writes fp32 partials to a scratch buffer, and
//     train_dkdv_reduce_kernel sums them in chunk order and scales dK.

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

// 1 / sigma, the factor that normalises a row's recomputed P; 0 for a row
// that sees no key (sigma 0), whose P is all masked to 0 anyway.
__device__ __forceinline__ float inv_sigma(float sigma) {
  return sigma > 0.f ? __frcp_rn(sigma) : 0.f;
}

// Rows of one (query tile or half tile, KV head): token, block, element offset
// into q / dO and log-sum-exp of each, for n rows from row0 on; with `delta`
// ([2][L * NH]: delta, then sigma, as the f32 dQ kernel writes them) also
// each row's delta and 1 / sigma (0 and 1 where `delta` is null).
__device__ __forceinline__ void load_row_tables(int row0, int n, int L, int NH, int h, int G,
                                                int D, const Layout& lay,
                                                const float* __restrict__ lse,
                                                const float* __restrict__ delta, int* tok_s,
                                                int* blk_s, long long* off_s, float* lse_s,
                                                float* delta_s, float* isig_s, int tid) {
  for (int i = tid; i < n; i += THREADS) {
    const int row = row0 + i;
    if (row < G * L) {
      const int t = row / G;
      const long long head_row = (long long)t * NH + h * G + row % G;
      tok_s[i] = t;
      blk_s[i] = block_of(t, lay);
      off_s[i] = head_row * D;
      lse_s[i] = lse[head_row];
      delta_s[i] = delta != nullptr ? delta[head_row] : 0.f;
      isig_s[i] = delta != nullptr ? inv_sigma(delta[head_row + (long long)L * NH]) : 1.f;
    } else {
      tok_s[i] = -1;
      blk_s[i] = -2;
      off_s[i] = -1;
      lse_s[i] = 0.f;
      delta_s[i] = 0.f;
      isig_s[i] = 0.f;
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

// Stage key tile `ent` of one (query tile, KV head) into k_s / v_s and return
// this lane's visibility bits for the warp's RW rows (0xffff for a full tile).
template <typename T, int D>
__device__ __forceinline__ unsigned stage_key_tile(const T* __restrict__ k,
                                                   const T* __restrict__ v, int ent, int L,
                                                   int KH, int h, const Layout& lay,
                                                   long long* koff_s, float* k_s, float* v_s,
                                                   const int* tok_w, const int* blk_w, int tid) {
  constexpr int KS = K_STRIDE<D>;
  const int k0 = (ent >> 1) * KT;
  __syncthreads();  // q_s / do_s are staged, the previous tile is consumed
  if (tid < KT) koff_s[tid] = k0 + tid < L ? ((long long)(k0 + tid) * KH + h) * D : -1;
  __syncthreads();
  stage_rows<T, D, KS>(k, koff_s, k_s, KT, tid);
  stage_rows<T, D, KS>(v, koff_s, v_s, KT, tid);
  __syncthreads();
  if (ent & 1) return 0xffffu;
  return visible_bits(tok_w, blk_w, RW, k0 + (tid & 31), L, lay);
}

// dQ: one CTA per (query tile, KV head).  Lane j scores key j of the tile
// against the warp's RW rows.  Sweep 1 takes delta = sum_j P dP per row from
// the P and dP of sweep 2 and writes it; sweep 2 forms dS, which goes from
// lane to lane by shuffle, and lane i holds dims [i * D/32, (i + 1) * D/32)
// of each row's dQ.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
train_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                float* __restrict__ delta, const int* __restrict__ q_ptr,
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
  __shared__ float lse_s[ROWS], delta_s[ROWS], isig_s[ROWS];

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int row0 = qt * ROWS;
  const int G = NH / KH;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  load_row_tables(row0, ROWS, L, NH, h, G, D, lay, lse, nullptr, tok_s, blk_s, off_s, lse_s,
                  delta_s, isig_s, tid);
  __syncthreads();
  stage_rows<T, D, D>(q, off_s, q_s, ROWS, tid);
  stage_rows<T, D, D>(dout, off_s, do_s, ROWS, tid);

  const float* q_w = q_s + warp * RW * D;
  const float* do_w = do_s + warp * RW * D;
  const int* tok_w = tok_s + warp * RW;
  const int* blk_w = blk_s + warp * RW;
  const int e_begin = q_ptr[qt];
  const int e_end = q_ptr[qt + 1];

  // ---- sweep 1: sigma = sum_j P and sum_j P dP, the P of the dS line below ----
  {
    float ps[RW], pd[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) ps[r] = pd[r] = 0.f;
    for (int e = e_begin; e < e_end; ++e) {
      const unsigned visible = stage_key_tile<T, D>(k, v, q_ent[e], L, KH, h, lay, koff_s, k_s,
                                                    v_s, tok_w, blk_w, tid);
      if (!__any_sync(FULL, visible != 0)) continue;
      float s[RW], dp[RW];
      score_rows<D, RW>(q_w, do_w, k_s + lane * KS, v_s + lane * KS, s, dp);
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const bool ok = (visible >> r) & 1u;
        const float p = ok ? expf(__fmul_rn(s[r], scale) - lse_s[warp * RW + r]) : 0.f;
        ps[r] = __fadd_rn(ps[r], p);
        pd[r] = fmaf(p, dp[r], pd[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const float sigma = warp_sum(ps[r]);  // every lane holds the same sums
      const float pdsum = warp_sum(pd[r]);
      const int i = warp * RW + r;
      if (lane == 0) {
        // delta of the normalised P: sum_j (P / sigma) dP
        const float d = sigma > 0.f ? __fdiv_rn(pdsum, sigma) : 0.f;
        delta_s[i] = d;
        isig_s[i] = inv_sigma(sigma);
        if (off_s[i] >= 0) {
          delta[off_s[i] / D] = d;
          delta[off_s[i] / D + (long long)L * NH] = sigma;
        }
      }
    }
    __syncwarp();
  }

  // ---- sweep 2: dS = (P / sigma) (dP - delta), dQ += dS.K ----
  float acc[RW][DPL];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;

  for (int e = e_begin; e < e_end; ++e) {
    const unsigned visible = stage_key_tile<T, D>(k, v, q_ent[e], L, KH, h, lay, koff_s, k_s,
                                                  v_s, tok_w, blk_w, tid);
    if (!__any_sync(FULL, visible != 0)) continue;
    float s[RW], dp[RW];
    score_rows<D, RW>(q_w, do_w, k_s + lane * KS, v_s + lane * KS, s, dp);
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const bool ok = (visible >> r) & 1u;
      const float p = ok ? __fmul_rn(expf(__fmul_rn(s[r], scale) - lse_s[warp * RW + r]),
                                     isig_s[warp * RW + r])
                         : 0.f;
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
  __shared__ float lse_s[RQ], delta_s[RQ], isig_s[RQ];

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
                      delta_s, isig_s, tid);
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
        const float p = ok ? __fmul_rn(expf(__fmul_rn(s[r], scale) - lse_s[i]), isig_s[i]) : 0.f;
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
// bfloat16: forward, dQ and dK/dV on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int EMPTY_TILE = 0, FULL_TILE = 2;  // classes of ops/train_attention.py

// Bits [a, b) of a 64-bit word (0 <= a <= 64; none where b <= a).
__device__ __forceinline__ unsigned long long bit_range(int a, int b) {
  if (b <= a) return 0ull;
  const unsigned long long w = b - a == 64 ? ~0ull : (1ull << (b - a)) - 1ull;
  return w << a;
}

// Bit j: does query position q (block bq) see key k0 + j?  The rule of `sees`
// taken once per run of keys that share a block, not once per key: outside a
// row's own block (and a prompt row's causal prompt) it depends on the two
// blocks only, so a run is visible whole, not at all, or up to q.
__device__ __forceinline__ unsigned long long visible_word(int q, int bq, int k0,
                                                           const Layout& lay) {
  unsigned long long w = 0ull;
  if (bq == -2) return w;
  const int end = min(k0 + 64, lay.seq_len);
  for (int pos = k0; pos < end;) {
    const int bk = block_of(pos, lay);
    if (bk == -2) break;  // past pair T, and so is every later key
    const int run_end = min(end, bk == -1 ? lay.P : lay.P + (bk + 1) * lay.N);
    const int vis_end = (bq == -1 || bk == bq) ? min(run_end, q + 1)
                        : (sees(q, bq, pos, bk, lay) ? run_end : pos);
    w |= bit_range(pos - k0, vis_end - k0);
    pos = run_end;
  }
  return w;
}

// Write this thread's two rows of O (r_lo: the CTA row of row lo) as hi =
// bf16(O) to out, as tc::store_rows does, and lo = bf16(O - hi) to out_lo;
// a row with no visible key writes zeros to both.
template <int D>
__device__ __forceinline__ void store_rows_split(bf16* __restrict__ out, bf16* __restrict__ out_lo,
                                                 const tc::Rows<D>& st, int L, int NH, int h,
                                                 int G, int row0, int r_lo) {
  const int q4 = threadIdx.x & 3;
  const int n_rows = G * L;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float l = st.l[rr];
    l = __fadd_rn(l, __shfl_xor_sync(FULL, l, 1));
    l = __fadd_rn(l, __shfl_xor_sync(FULL, l, 2));
    const int r = row0 + r_lo + 8 * rr;
    if (r >= n_rows) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    const long long off = ((long long)(r / G) * NH + h * G + r % G) * D + 2 * q4;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const float x0 = __fmul_rn(st.o[4 * i + 2 * rr], inv);
      const float x1 = __fmul_rn(st.o[4 * i + 2 * rr + 1], inv);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(hi);
      *reinterpret_cast<__nv_bfloat162*>(out + off + 8 * i) = hi;
      *reinterpret_cast<__nv_bfloat162*>(out_lo + off + 8 * i) =
          __floats2bfloat162_rn(__fsub_rn(x0, hf.x), __fsub_rn(x1, hf.y));
    }
  }
}

// The forward: CTA = tc::WGS = 2 warpgroups = query tiles 2p and 2p + 1 of KV
// head h; pair_ent holds 16 * key tile + class of tile 2p + 4 * class of tile
// 2p + 1 for every 64-key tile either of them sees.  The K/V ring, the copy
// issue inside the wgmma windows and the online softmax are the serving
// kernels' (tc::walk_keys, tc::tile_step).
template <int D>
__global__ void __launch_bounds__(tc::THREADS, 1)
train_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ pair_ptr,
                    const int* __restrict__ pair_ent, const int* __restrict__ pair_order,
                    bf16* __restrict__ out, float* __restrict__ lse, bf16* __restrict__ out_lo,
                    int L, int NH, int KH, Layout lay, float scale) {
  extern __shared__ unsigned char smem_tc[];
  const tc::Smem<D> sm(smem_tc);
  __shared__ int ent_s[tc::STAGES];  // each stage's pair entry
  // each stage's visibility words of the CTA's rows (visible_word)
  __shared__ unsigned long long vis_s[tc::STAGES][tc::ROWS];

  const int pair = pair_order[blockIdx.x];  // the pairs with the longest lists first
  const int h = blockIdx.y;
  const int row0 = pair * tc::ROWS;
  const int G = NH / KH;
  const int n_rows = G * L;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int r_lo = wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);  // CTA row of row lo
  // the first 64 threads of each warpgroup build the visibility words of its
  // 64 rows: CTA row row_w, its token and block
  const bool builds = (tid & 64) == 0;
  const int row_w = wg * 64 + (tid & 63);
  const int tok_w = row0 + row_w < n_rows ? (row0 + row_w) / G : -1;
  const int blk_w = block_of(tok_w, lay);

  tc::issue_q<D>(q, sm.q, 0, L, NH, h, G, row0, tid);
  tc::cp_async_commit();

  tc::Rows<D> st;
  st.init();
  const uint32_t q_wg = sm.q + wg * tc::TILE<D>;
  const float scale_log2 = __fmul_rn(scale, LOG2E);
  const int e0 = pair_ptr[pair];
  const bf16* k_head = k + (long long)h * D;
  const bf16* v_head = v + (long long)h * D;
  auto issue = [&](int i, int s, int part) {
    const int ent = pair_ent[e0 + i];
    const int k0 = (ent >> 4) * tc::KT;
    tc::issue_kv_bf16<D>(k_head, v_head,
                         [&](int j) -> long long {
                           return k0 + j < L ? (long long)(k0 + j) * KH * D : -1;
                         },
                         sm.k(s), sm.v(s), tid, part);
    if (part == 1 && builds) vis_s[s][row_w] = visible_word(tok_w, blk_w, k0, lay);
    if (part == 0 && tid == 0) ent_s[s] = ent;
  };
  auto step = [&](int, int s, uint32_t kt, uint32_t vt, const auto& fill) {
    const int ent = ent_s[s];
    const int cls = (ent >> (2 * wg)) & 3;
    if (cls == EMPTY_TILE) {  // no row of this warpgroup sees the tile
      fill(0);
      fill(1);
    } else if (cls == FULL_TILE) {
      tc::tile_step<D>(q_wg, kt, vt, scale_log2, [](int, int) { return true; }, fill, st);
    } else {
      const unsigned long long w_lo = vis_s[s][r_lo], w_hi = vis_s[s][r_lo + 8];
      tc::tile_step<D>(q_wg, kt, vt, scale_log2,
                       [&](int rr, int j) { return (((rr ? w_hi : w_lo) >> j) & 1ull) != 0; },
                       fill, st);
    }
  };
  tc::walk_keys<bf16, D>(sm, pair_ptr[pair + 1] - e0, issue, step, nullptr, nullptr, tid);

  store_rows_split<D>(out, out_lo, st, L, NH, h, G, row0, r_lo);
  // the natural-log log-sum-exp of the scaled scores: m is the running max in
  // the log2 domain, l the row sum of 2^(s * scale_log2 - m)
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float l = st.l[rr];
    l = __fadd_rn(l, __shfl_xor_sync(FULL, l, 1));
    l = __fadd_rn(l, __shfl_xor_sync(FULL, l, 2));
    const int r = row0 + r_lo + 8 * rr;
    if ((lane & 3) != 0 || r >= n_rows) continue;
    lse[(long long)(r / G) * NH + h * G + r % G] =
        l > 0.f ? __fmul_rn(__fadd_rn(st.m[rr], log2f(l)), LN2) : 0.f;
  }
}

// One dQ step of a warpgroup over the staged key tile: q / dO are the shared
// addresses of its Q and dO tiles, k / v the stage's.  S = Q.K^T and
// dP = dO.V^T by wgmma from shared memory (fill(0) meanwhile); on the
// accumulator fragments P = 2^(scale_log2 S - lse log2 e) where vis(rr, j)
// holds (else 0) and dS = P (dP - delta); then dQ += bf16(dS).K with dS as
// the register A operand and K read MN-major, as P.V reads V (fill(1)
// meanwhile).  lse2 / dlt: lse log2 e and delta of this thread's two rows.
template <int D, typename Vis, typename Fill>
__device__ __forceinline__ void dq_tile_step(uint32_t q, uint32_t dO, uint32_t k, uint32_t v,
                                             float scale_log2, const float (&lse2)[2],
                                             const float (&dlt)[2], const Vis& vis,
                                             const Fill& fill, float (&acc)[D / 2]) {
  float s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  tc::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk >> 2) * tc::SUB + (kk & 3) * 32;
    tc::mma_ss_m64n64(s, tc::desc_kmajor(q + off), tc::desc_kmajor(k + off), kk);
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk >> 2) * tc::SUB + (kk & 3) * 32;
    tc::mma_ss_m64n64(dp, tc::desc_kmajor(dO + off), tc::desc_kmajor(v + off), kk);
  }
  tc::wgmma_commit();
  fill(0);
  tc::wgmma_wait_all();
  tc::fence_regs(s);
  tc::fence_regs(dp);

  // element 4i + e: row (e < 2 ? lo : hi), key 8i + 2 q4 + (e & 1)
  const int q4 = threadIdx.x & 3;
  uint32_t a[4][4];  // dS as bf16 A fragments, one per 16 keys
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rr = e >> 1;
      const float p = vis(rr, 8 * i + 2 * q4 + (e & 1))
                          ? tc::ex2(fmaf(s[4 * i + e], scale_log2, -lse2[rr]))
                          : 0.f;
      s[4 * i + e] = __fmul_rn(p, dp[4 * i + e] - dlt[rr]);
    }
    a[i >> 1][(i & 1) * 2] = tc::pack_bf16(s[4 * i], s[4 * i + 1]);
    a[i >> 1][(i & 1) * 2 + 1] = tc::pack_bf16(s[4 * i + 2], s[4 * i + 3]);
  }

  tc::fence_regs(acc);
  tc::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < tc::KT / 16; ++kk)
    tc::mma_pv<D>(acc, a[kk], tc::desc_mnmajor(k + kk * 16 * 128));
  tc::wgmma_commit();
  fill(1);
  tc::wgmma_wait_all();
  tc::fence_regs(acc);
}

// dQ with delta folded in: the forward's grid and lists (CTA = tc::WGS = 2
// warpgroups = query tiles 2p and 2p + 1 of KV head h, the 64-key tiles of
// pair_ent in ascending order, longest lists first) and its K/V ring.  The
// CTA first takes delta = rowsum(dO * (O + O_lo)) of its 128 rows from the
// forward's O and residual (one warp per row, fmaf over each lane's elements
// in order, then a fixed butterfly), writes it for the dK/dV call and keeps it
// for dS.  Dynamic
// shared memory: tc::SMEM<D> (Q tiles, the K/V ring), then the dO tiles.
template <int D>
constexpr size_t DQ_SMEM = tc::SMEM<D> + size_t(tc::WGS) * tc::TILE<D>;

template <int D>
__global__ void __launch_bounds__(tc::THREADS, 1)
train_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ out,
                   const bf16* __restrict__ out_lo, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const int* __restrict__ pair_ptr,
                   const int* __restrict__ pair_ent, const int* __restrict__ pair_order,
                   bf16* __restrict__ dq,
                   float* __restrict__ delta, int L, int NH, int KH, Layout lay, float scale) {
  extern __shared__ unsigned char smem_tc[];
  const tc::Smem<D> sm(smem_tc);
  const uint32_t do_t = sm.kv + tc::KV_TILES * tc::TILE<D>;  // warpgroup w's dO at + w TILE
  __shared__ int ent_s[tc::STAGES];
  __shared__ unsigned long long vis_s[tc::STAGES][tc::ROWS];
  __shared__ float delta_s[tc::ROWS];

  const int pair = pair_order[blockIdx.x];
  const int h = blockIdx.y;
  const int row0 = pair * tc::ROWS;
  const int G = NH / KH;
  const int n_rows = G * L;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int r_lo = wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
  const bool builds = (tid & 64) == 0;
  const int row_w = wg * 64 + (tid & 63);
  const int tok_w = row0 + row_w < n_rows ? (row0 + row_w) / G : -1;
  const int blk_w = block_of(tok_w, lay);

  tc::issue_q<D>(q, sm.q, 0, L, NH, h, G, row0, tid);
  tc::issue_q<D>(dout, do_t, 0, L, NH, h, G, row0, tid);
  tc::cp_async_commit();

  // ---- delta of the CTA's rows while Q and dO land ----
  {
    constexpr int DPL = D / 32;
    constexpr int RPW = tc::ROWS / (tc::THREADS / 32);  // rows per warp
    const int warp = tid >> 5;
    float d[RPW];
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      const int r = row0 + warp + j * (tc::THREADS / 32);
      d[j] = 0.f;
      if (r < n_rows) {
        const long long off = ((long long)(r / G) * NH + h * G + r % G) * D + lane * DPL;
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          d[j] = fmaf(__bfloat162float(dout[off + i]),
                      __fadd_rn(__bfloat162float(out[off + i]), __bfloat162float(out_lo[off + i])),
                      d[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      const int i = warp + j * (tc::THREADS / 32);
      const int r = row0 + i;
      const float x = warp_sum(d[j]);
      if (lane == 0) {
        delta_s[i] = x;
        if (r < n_rows) delta[(long long)(r / G) * NH + h * G + r % G] = x;
      }
    }
  }
  __syncthreads();
  float lse2[2], dlt[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = row0 + r_lo + 8 * rr;
    lse2[rr] = r < n_rows ? __fmul_rn(lse[(long long)(r / G) * NH + h * G + r % G], LOG2E) : 0.f;
    dlt[rr] = delta_s[r_lo + 8 * rr];
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const uint32_t q_wg = sm.q + wg * tc::TILE<D>;
  const uint32_t do_wg = do_t + wg * tc::TILE<D>;
  const float scale_log2 = __fmul_rn(scale, LOG2E);
  const int e0 = pair_ptr[pair];
  const bf16* k_head = k + (long long)h * D;
  const bf16* v_head = v + (long long)h * D;
  auto issue = [&](int i, int s, int part) {
    const int ent = pair_ent[e0 + i];
    const int k0 = (ent >> 4) * tc::KT;
    tc::issue_kv_bf16<D>(k_head, v_head,
                         [&](int j) -> long long {
                           return k0 + j < L ? (long long)(k0 + j) * KH * D : -1;
                         },
                         sm.k(s), sm.v(s), tid, part);
    if (part == 1 && builds) vis_s[s][row_w] = visible_word(tok_w, blk_w, k0, lay);
    if (part == 0 && tid == 0) ent_s[s] = ent;
  };
  auto step = [&](int, int s, uint32_t kt, uint32_t vt, const auto& fill) {
    const int ent = ent_s[s];
    const int cls = (ent >> (2 * wg)) & 3;
    if (cls == EMPTY_TILE) {
      fill(0);
      fill(1);
    } else if (cls == FULL_TILE) {
      dq_tile_step<D>(q_wg, do_wg, kt, vt, scale_log2, lse2, dlt,
                      [](int, int) { return true; }, fill, acc);
    } else {
      const unsigned long long w_lo = vis_s[s][r_lo], w_hi = vis_s[s][r_lo + 8];
      dq_tile_step<D>(q_wg, do_wg, kt, vt, scale_log2, lse2, dlt,
                      [&](int rr, int j) { return (((rr ? w_hi : w_lo) >> j) & 1ull) != 0; },
                      fill, acc);
    }
  };
  tc::walk_keys<bf16, D>(sm, pair_ptr[pair + 1] - e0, issue, step, nullptr, nullptr, tid);

  // ---- dQ = scale * sum dS.K, token-major rows; a row that sees nothing is zero ----
  const int q4 = lane & 3;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = row0 + r_lo + 8 * rr;
    if (r >= n_rows) continue;
    bf16* o = dq + ((long long)(r / G) * NH + h * G + r % G) * D + 2 * q4;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * i) = __floats2bfloat162_rn(
          __fmul_rn(acc[4 * i + 2 * rr], scale), __fmul_rn(acc[4 * i + 2 * rr + 1], scale));
    }
  }
}

// dK/dV: one warpgroup per CTA, which owns the 64 keys of one key tile of KV
// head h; two query-tile stages (tile i + 1 is copied while tile i computes).
// Two CTAs fit an SM at D = 128 (~99 KB of shared memory each), so one CTA's
// softmax overlaps the other's wgmma.
constexpr int DK_THREADS = 128;
constexpr int DK_STAGES = 2;
constexpr int REDUCE_THREADS = 256;

// 1 KiB of alignment slack, the K and V tiles, then per stage a Q and a dO tile
template <int D>
constexpr size_t DKDV_SMEM = 1024 + 2 * size_t(tc::TILE<D>) + DK_STAGES * 2 * size_t(tc::TILE<D>);

// Issue the copies of query tile qt's rows (Q, dO, lse, delta) into a stage;
// rows at or past n_rows are zero-filled.
template <int D>
__device__ __forceinline__ void issue_query_tile(const bf16* __restrict__ q,
                                                 const bf16* __restrict__ dout,
                                                 const float* __restrict__ lse,
                                                 const float* __restrict__ delta, uint32_t q_dst,
                                                 uint32_t do_dst, uint32_t lse_dst,
                                                 uint32_t delta_dst, int row0, int n_rows, int NH,
                                                 int h, int G, int tid) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int it = 0; it < 64 * CPR / DK_THREADS; ++it) {
    const int idx = tid + it * DK_THREADS;
    const int i = idx / CPR, c = idx % CPR;
    const int r = row0 + i;
    const bool ok = r < n_rows;
    const long long off = ok ? ((long long)(r / G) * NH + h * G + r % G) * D + c * 8 : 0;
    tc::cp_async16(q_dst + tc::swz(i, c), q + off, ok);
    tc::cp_async16(do_dst + tc::swz(i, c), dout + off, ok);
  }
  if (tid < 64) {
    const int r = row0 + tid;
    const bool ok = r < n_rows;
    const long long hr = ok ? (long long)(r / G) * NH + h * G + r % G : 0;
    tc::cp_async4(lse_dst + tid * 4, lse + hr, ok);
    tc::cp_async4(delta_dst + tid * 4, delta + hr, ok);
  }
}

// chunks[c] = {key tile, first, end index into k_ent, partial slot or -1};
// partial is [slot][dK, dV][KH][64 keys][D] float32.
template <int D>
__global__ void __launch_bounds__(DK_THREADS, 2)
train_dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ k_ent, const int4* __restrict__ chunks,
                     float* __restrict__ partial, bf16* __restrict__ dk, bf16* __restrict__ dv,
                     int L, int NH, int KH, Layout lay, float scale) {
  extern __shared__ unsigned char smem_tc[];
  const uint32_t base = tc::smem_addr(smem_tc);
  const uint32_t k_t = base + ((1024u - (base & 1023u)) & 1023u);
  const uint32_t v_t = k_t + tc::TILE<D>;
  auto q_t = [&](int s) { return v_t + (1 + 2 * s) * tc::TILE<D>; };
  auto do_t = [&](int s) { return v_t + (2 + 2 * s) * tc::TILE<D>; };
  __shared__ float lse_s[DK_STAGES][64], delta_s[DK_STAGES][64];
  // each stage's visibility words of its 64 query rows over the key tile
  // (visible_word; all ones for a full tile)
  __shared__ unsigned long long vis_s[DK_STAGES][64];

  const int4 ch = chunks[blockIdx.x];
  const int h = blockIdx.y;
  const int k0 = ch.x * tc::KT;
  const int G = NH / KH;
  const int n_rows = G * L;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int q4 = lane & 3;
  // this thread's two keys (rows lo / hi of the m64 accumulators)
  const int key_lo = (tid >> 5) * 16 + (lane >> 2);
  const float scale_log2 = __fmul_rn(scale, LOG2E);

  float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

  // query tile i of the chunk into stage s, with its row tables
  auto issue = [&](int i, int s) {
    const int ent = k_ent[ch.y + i];
    const int row0 = (ent >> 1) * 64;
    issue_query_tile<D>(q, dout, lse, delta, q_t(s), do_t(s), tc::smem_addr(lse_s[s]),
                        tc::smem_addr(delta_s[s]), row0, n_rows, NH, h, G, tid);
    if (tid < 64) {
      const int t = row0 + tid < n_rows ? (row0 + tid) / G : -1;
      vis_s[s][tid] = (ent & 1) ? ~0ull : visible_word(t, block_of(t, lay), k0, lay);
    }
  };

  const int n = ch.z - ch.y;
  if (n > 0) {
    // K and V of the key tile (keys at or past L zero-filled), with query tile 0
    constexpr int CPR = D / 8;
#pragma unroll
    for (int it = 0; it < 64 * CPR / DK_THREADS; ++it) {
      const int idx = tid + it * DK_THREADS;
      const int j = idx / CPR, c = idx % CPR;
      const bool ok = k0 + j < L;
      const long long off = ok ? ((long long)(k0 + j) * KH + h) * D + c * 8 : 0;
      tc::cp_async16(k_t + tc::swz(j, c), k + off, ok);
      tc::cp_async16(v_t + tc::swz(j, c), v + off, ok);
    }
    issue(0, 0);
    tc::cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    const int s = i & 1;
    tc::cp_async_wait<0>();
    tc::fence_async_smem();
    __syncthreads();  // tile i has landed everywhere; tile i - 1 is consumed
    const uint32_t qs = q_t(s), dos = do_t(s);

    // ---- S^T = K.Q^T and dP^T = V.dO^T (keys x query rows) ----
    float sacc[32], pacc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sacc[e] = pacc[e] = 0.f;
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * tc::SUB + (kk & 3) * 32;
      tc::mma_ss_m64n64(sacc, tc::desc_kmajor(k_t + off), tc::desc_kmajor(qs + off), kk);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * tc::SUB + (kk & 3) * 32;
      tc::mma_ss_m64n64(pacc, tc::desc_kmajor(v_t + off), tc::desc_kmajor(dos + off), kk);
    }
    tc::wgmma_commit();
    if (i + 1 < n) issue(i + 1, s ^ 1);  // into tile i - 1's stage, while the products run
    tc::cp_async_commit();
    tc::wgmma_wait_all();
    tc::fence_regs(sacc);
    tc::fence_regs(pacc);

    // ---- P^T = exp(scale S^T - lse), dS^T = P^T (dP^T - delta) ----
    // element 4i + e: key (e < 2 ? lo : hi), query row 8i + 2 q4 + (e & 1)
#pragma unroll
    for (int a = 0; a < 8; ++a) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * a + 2 * q4 + (e & 1);
        const bool ok = ((vis_s[s][c] >> (key_lo + 8 * (e >> 1))) & 1ull) != 0;
        const float p =
            ok ? tc::ex2(fmaf(sacc[4 * a + e], scale_log2, -__fmul_rn(lse_s[s][c], LOG2E)))
               : 0.f;
        pacc[4 * a + e] = __fmul_rn(p, pacc[4 * a + e] - delta_s[s][c]);
        sacc[4 * a + e] = p;
      }
    }
    uint32_t pa[4][4], da[4][4];  // P^T and dS^T as bf16 A fragments, 16 query rows each
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      pa[a >> 1][(a & 1) * 2] = tc::pack_bf16(sacc[4 * a], sacc[4 * a + 1]);
      pa[a >> 1][(a & 1) * 2 + 1] = tc::pack_bf16(sacc[4 * a + 2], sacc[4 * a + 3]);
      da[a >> 1][(a & 1) * 2] = tc::pack_bf16(pacc[4 * a], pacc[4 * a + 1]);
      da[a >> 1][(a & 1) * 2 + 1] = tc::pack_bf16(pacc[4 * a + 2], pacc[4 * a + 3]);
    }

    // ---- dV += P^T.dO, dK += dS^T.Q (dO, Q read MN-major) ----
    tc::fence_regs(acc_v);
    tc::fence_regs(acc_k);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) tc::mma_pv<D>(acc_v, pa[kk], tc::desc_mnmajor(dos + kk * 16 * 128));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) tc::mma_pv<D>(acc_k, da[kk], tc::desc_mnmajor(qs + kk * 16 * 128));
    tc::wgmma_commit();
    tc::wgmma_wait_all();
    tc::fence_regs(acc_v);
    tc::fence_regs(acc_k);
  }

  // ---- this thread's two keys: dK / dV, or the chunk's float32 partials ----
  // accumulator element 4i + 2 rr + {0, 1}: key rr, dims 8i + 2 q4 + {0, 1}
  const int slot = ch.w;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int key = key_lo + 8 * rr;
    if (slot < 0) {
      if (k0 + key >= L) continue;
      const long long off = ((long long)(k0 + key) * KH + h) * D + 2 * q4;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * i) = __floats2bfloat162_rn(
            __fmul_rn(acc_k[4 * i + 2 * rr], scale), __fmul_rn(acc_k[4 * i + 2 * rr + 1], scale));
        *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * i) =
            __floats2bfloat162_rn(acc_v[4 * i + 2 * rr], acc_v[4 * i + 2 * rr + 1]);
      }
    } else {
      float* pk = partial + (((long long)slot * 2 * KH + h) * 64 + key) * D + 2 * q4;
      float* pv = pk + (long long)KH * 64 * D;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        *reinterpret_cast<float2*>(pk + 8 * i) =
            make_float2(acc_k[4 * i + 2 * rr], acc_k[4 * i + 2 * rr + 1]);
        *reinterpret_cast<float2*>(pv + 8 * i) =
            make_float2(acc_v[4 * i + 2 * rr], acc_v[4 * i + 2 * rr + 1]);
      }
    }
  }
}

// dK / dV of the key tiles cut into several chunks: reduce[r] = {key tile,
// first slot, chunks}; the partials are summed in chunk order, dK scaled once.
template <int D>
__global__ void __launch_bounds__(REDUCE_THREADS)
train_dkdv_reduce_kernel(const float* __restrict__ partial, const int* __restrict__ reduce,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int L, int KH,
                         float scale) {
  const int kt = reduce[3 * blockIdx.x];
  const int slot0 = reduce[3 * blockIdx.x + 1];
  const int m = reduce[3 * blockIdx.x + 2];
  const int h = blockIdx.y;
  constexpr int TILE4 = 64 * D / 4;  // float4 per [64][D] tile
  for (int idx = threadIdx.x; idx < 2 * TILE4; idx += REDUCE_THREADS) {
    const int which = idx / TILE4;  // 0 dK, 1 dV
    const int e = (idx % TILE4) * 4;
    const int pos = kt * tc::KT + e / D;
    if (pos >= L) continue;
    const float4* src = reinterpret_cast<const float4*>(partial) +
                        (((long long)slot0 * 2 + which) * KH + h) * TILE4 + e / 4;
    const long long stride = 2LL * KH * TILE4;  // one slot on
    float4 acc = src[0];
    for (int c = 1; c < m; ++c) {
      const float4 x = src[c * stride];
      acc.x = __fadd_rn(acc.x, x.x);
      acc.y = __fadd_rn(acc.y, x.y);
      acc.z = __fadd_rn(acc.z, x.z);
      acc.w = __fadd_rn(acc.w, x.w);
    }
    if (which == 0) {
      acc.x = __fmul_rn(acc.x, scale);
      acc.y = __fmul_rn(acc.y, scale);
      acc.z = __fmul_rn(acc.z, scale);
      acc.w = __fmul_rn(acc.w, scale);
    }
    bf16* o = (which == 0 ? dk : dv) + ((long long)pos * KH + h) * D + e % D;
    reinterpret_cast<__nv_bfloat162*>(o)[0] = __floats2bfloat162_rn(acc.x, acc.y);
    reinterpret_cast<__nv_bfloat162*>(o)[1] = __floats2bfloat162_rn(acc.z, acc.w);
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
  const void* order;            // bf16 forward and dQ: the pairs in launch order
  void* out_lo;                 // bf16 forward (written) and dQ (read): O's residual
  const void *chunks, *reduce;  // bf16 dK/dV: the chunk and reduce lists
  void* partial;                // bf16 dK/dV: float32 partials of split key tiles
  void *o0, *o1;  // outputs: fwd (out, lse), dq (dq, delta), dkdv (dk, dv)
  int n_chunks, n_reduce;
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
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t err = allow_smem(train_dq_kernel<T, D>, smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = (a.NH / a.KH) * a.L;
  const dim3 grid((rows + ROWS - 1) / ROWS, a.KH);
  train_dq_kernel<T, D><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<float*>(a.o1), static_cast<const int*>(a.ptr),
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

// pair_ptr / pair_ent in ptr / ent, the launch order of the pairs in order;
// writes O, the log-sum-exp and O's residual
template <int D>
int launch_fwd_tc(const Args& a) {
  if (a.order == nullptr || a.out_lo == nullptr) return -1;
  constexpr size_t smem = tc::SMEM<D>;
  cudaError_t err = allow_smem(train_fwd_tc_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = (a.NH / a.KH) * a.L;
  const dim3 grid((rows + tc::ROWS - 1) / tc::ROWS, a.KH);
  train_fwd_tc_kernel<D><<<grid, tc::THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const int*>(a.ptr), static_cast<const int*>(a.ent),
      static_cast<const int*>(a.order), static_cast<bf16*>(a.o0), static_cast<float*>(a.o1),
      static_cast<bf16*>(a.out_lo), a.L, a.NH, a.KH, a.lay, a.scale);
  return (int)cudaGetLastError();
}

// pair_ptr / pair_ent in ptr / ent, the pairs' launch order in order, O's
// residual in out_lo; writes dQ and delta
template <int D>
int launch_dq_tc(const Args& a) {
  if (a.order == nullptr || a.out_lo == nullptr) return -1;
  constexpr size_t smem = DQ_SMEM<D>;
  cudaError_t err = allow_smem(train_dq_tc_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = (a.NH / a.KH) * a.L;
  const dim3 grid((rows + tc::ROWS - 1) / tc::ROWS, a.KH);
  train_dq_tc_kernel<D><<<grid, tc::THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const bf16*>(a.out), static_cast<const bf16*>(a.out_lo),
      static_cast<const bf16*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const int*>(a.ptr), static_cast<const int*>(a.ent),
      static_cast<const int*>(a.order), static_cast<bf16*>(a.o0), static_cast<float*>(a.o1),
      a.L, a.NH, a.KH, a.lay, a.scale);
  return (int)cudaGetLastError();
}

// k_ent (64-key tiles) in ent; every key tile has at least one chunk
template <int D>
int launch_dkdv_tc(const Args& a) {
  if (a.n_chunks <= 0 || a.n_reduce < 0 || (a.n_reduce > 0 && a.partial == nullptr)) return -1;
  constexpr size_t smem = DKDV_SMEM<D>;
  cudaError_t err = allow_smem(train_dkdv_tc_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  train_dkdv_tc_kernel<D><<<dim3(a.n_chunks, a.KH), DK_THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const bf16*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const int*>(a.ent),
      static_cast<const int4*>(a.chunks), static_cast<float*>(a.partial),
      static_cast<bf16*>(a.o0), static_cast<bf16*>(a.o1), a.L, a.NH, a.KH, a.lay, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_reduce == 0) return (int)err;
  train_dkdv_reduce_kernel<D><<<dim3(a.n_reduce, a.KH), REDUCE_THREADS, 0, a.stream>>>(
      static_cast<const float*>(a.partial), static_cast<const int*>(a.reduce),
      static_cast<bf16*>(a.o0), static_cast<bf16*>(a.o1), a.L, a.KH, a.scale);
  return (int)cudaGetLastError();
}

// which: 0 forward, 1 dQ (with delta), 2 dK/dV.  float32 runs the fp32
// kernels; bfloat16 the tensor-core ones.
int dispatch(int which, int dtype, int D, const Args& a) {
  if (a.L <= 0 || a.KH <= 0 || a.NH % a.KH != 0 || a.lay.N <= 0 || a.lay.W <= 0 ||
      a.lay.P < 0 || a.lay.T < 0 || a.lay.seq_len < 0 || a.lay.seq_len > a.L ||
      a.lay.variant < 0 || a.lay.variant > 2)
    return -1;
#define JF_F32(DIM)                               \
  switch (which) {                                \
    case 0: return launch_fwd<float, DIM>(a);     \
    case 1: return launch_dq<float, DIM>(a);      \
    case 2: return launch_dkdv<float, DIM>(a);    \
    default: return -1;                           \
  }
#define JF_BF16(DIM)                              \
  switch (which) {                                \
    case 0: return launch_fwd_tc<DIM>(a);         \
    case 1: return launch_dq_tc<DIM>(a);          \
    case 2: return launch_dkdv_tc<DIM>(a);        \
    default: return -1;                           \
  }
  if (dtype == 0 && D == 64) JF_F32(64)
  if (dtype == 0 && D == 128) JF_F32(128)
  if (dtype == 1 && D == 64) JF_BF16(64)
  if (dtype == 1 && D == 128) JF_BF16(128)
#undef JF_F32
#undef JF_BF16
  return -1;
}

// kernel_attrs of one variant; which 3 is the bf16 dK/dV's reduce kernel
// (both dQ kernels take delta themselves)
template <int D>
int attrs(int which, int dtype, int* out) {
  int rc = -1;
  if (dtype == 0) {
    if (which == 0) rc = kernel_attrs(train_fwd_kernel<float, D>, false, smem_bytes<D>(), THREADS, out);
    if (which == 1) rc = kernel_attrs(train_dq_kernel<float, D>, false, dq_smem_bytes<D>(), THREADS, out);
    if (which == 2)
      rc = kernel_attrs(train_dkdv_kernel<float, D>, false, dkdv_smem_bytes<D>(), THREADS, out);
    return rc;
  }
  if (dtype != 1) return -1;
  if (which == 0) rc = kernel_attrs(train_fwd_tc_kernel<D>, true, tc::SMEM<D>, tc::THREADS, out);
  if (which == 1) rc = kernel_attrs(train_dq_tc_kernel<D>, true, DQ_SMEM<D>, tc::THREADS, out);
  if (which == 2) {
    rc = kernel_attrs(train_dkdv_tc_kernel<D>, true, DKDV_SMEM<D>, DK_THREADS, out);
    out[7] = DK_STAGES;
  }
  if (which == 3) {
    rc = kernel_attrs(train_dkdv_reduce_kernel<D>, false, 0, REDUCE_THREADS, out);
    out[6] = tc::KT;
    out[7] = 0;
  }
  return rc;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `layout` is {prompt_len, T, seq_len, N,
// variant (0 single, 1 multiblock, 2 window), window_size}.  Each returns 0 on
// success, a cudaError_t code after a refused launch, or -1 for a shape, dtype
// or layout the kernels do not take (the Python wrapper checks those first).

// float32: q_ptr / q_ent per query tile over 32-key tiles, order and out_lo
// null; bfloat16: pair_ptr / pair_ent per pair of query tiles over 64-key
// tiles and the pairs in launch order (TileMap), and out_lo [L, NH, D], where
// the forward writes O's rounding residual and dQ reads it.  The same for dQ.
extern "C" int jf_train_attention_fwd(const void* q, const void* k, const void* v,
                                      const void* q_ptr, const void* q_ent, const void* order,
                                      void* out, void* lse, void* out_lo, int L, int NH, int KH,
                                      int D, const int* layout, float scale, int dtype,
                                      void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.ptr = q_ptr; a.ent = q_ent; a.order = order; a.o0 = out;
  a.o1 = lse; a.out_lo = out_lo;
  a.L = L; a.NH = NH; a.KH = KH; a.scale = scale;
  a.lay = Layout{layout[0], layout[1], layout[2], layout[3], layout[4], layout[5]};
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(0, dtype, D, a);
}

// Also writes delta, which the dK/dV call reads: bf16 [L, NH] rowsum(dout *
// (out + out_lo)); f32 [2][L, NH], sum_j (P / sigma) dP over the row's keys
// and then sigma = sum_j P (out is not read).
extern "C" int jf_train_attention_dq(const void* q, const void* k, const void* v,
                                     const void* out, const void* out_lo, const void* dout,
                                     const void* lse, const void* q_ptr, const void* q_ent,
                                     const void* order, void* dq, void* delta,
                                     int L, int NH, int KH, int D, const int* layout,
                                     float scale, int dtype, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.out = out; a.dout = dout; a.lse = lse; a.ptr = q_ptr;
  a.ent = q_ent; a.order = order; a.o0 = dq; a.o1 = delta;
  a.out_lo = const_cast<void*>(out_lo);
  a.L = L; a.NH = NH; a.KH = KH; a.scale = scale;
  a.lay = Layout{layout[0], layout[1], layout[2], layout[3], layout[4], layout[5]};
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(1, dtype, D, a);
}

// float32: k_ptr / k_ent over 32-key tiles, chunks, reduce and partial null.
// bfloat16: k_ptr null, k_ent over 64-key tiles, the chunk list (n_chunks rows
// {key tile, first, end, slot}), the reduce list (n_reduce rows {key tile,
// first slot, chunks}) and the float32 partials [slots][2][KH][64][D].
extern "C" int jf_train_attention_dkdv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       const void* k_ptr, const void* k_ent, const void* chunks,
                                       const void* reduce, void* partial, void* dk, void* dv,
                                       int n_chunks, int n_reduce, int L, int NH, int KH, int D,
                                       const int* layout, float scale, int dtype, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta; a.ptr = k_ptr;
  a.ent = k_ent; a.chunks = chunks; a.reduce = reduce; a.partial = partial; a.o0 = dk; a.o1 = dv;
  a.n_chunks = n_chunks; a.n_reduce = n_reduce;
  a.L = L; a.NH = NH; a.KH = KH; a.scale = scale;
  a.lay = Layout{layout[0], layout[1], layout[2], layout[3], layout[4], layout[5]};
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(2, dtype, D, a);
}

// The tile, registers and shared memory of kernel `which` (0 forward, 1 dQ,
// 2 dK/dV, 3 the bf16 dK/dV's reduce kernel) for
// (dtype, D), as kernel_attrs
// writes them into out[8]; -1 for a variant that is not built.
extern "C" int jf_train_attention_attrs(int which, int dtype, int D, int* out) {
  if (D == 64) return attrs<64>(which, dtype, out);
  if (D == 128) return attrs<128>(which, dtype, out);
  return -1;
}

extern "C" const char* jf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
