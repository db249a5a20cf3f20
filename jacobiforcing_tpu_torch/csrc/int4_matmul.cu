// Int4 weight-only dequant-matmul for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel jacobiforcing_tpu/ops/pallas/int4_matmul.py
// (int4_matmul, body _kernel).  It computes exactly
// jacobiforcing_tpu_torch.ops.int4_matmul.int4_matmul_ref:
//
//     y[M, N] = (x[M, K] @ unpack(w_packed[K, N/2])) * scale[N]
//
// x float32 or bfloat16, the sum in float32, y in x's type.  Packing is
// split-half along the output axis: byte j of a row of w_packed holds output
// column j in its low nibble and column j + N/2 in its high nibble, each
// stored as value + 8.
//
// Two kernels, chosen by x's type:
//
// bfloat16 x: int4_tc_kernel on Hopper's tensor cores (wgmma).  The product is
// taken swapped, y^T = W^T . x^T:
//   * output channels are wgmma's 64-row M dimension and x's rows its N
//     dimension (BN = 8 rows per instruction at M <= 8, 128 above), so M = 4
//     costs one n8 column block, not a 64-row tile of padding;
//   * the weights are the register A operand.  The packed bytes are staged by
//     16-byte cp.async into shared memory (rows padded by 16 bytes, so a
//     warp's byte reads are free of bank conflicts), read once and turned
//     into bf16 pairs in registers (nibble | 0x4300 is the bf16 of 128 +
//     nibble; one bf16x2 subtraction of 136 leaves the value, exactly); they
//     never go to shared memory as bf16.  A thread's two A rows (lo and hi, 8
//     apart) are a low channel j and its high partner j + N/2, so each byte is
//     read once and both nibbles are used.  Stage g + 1 is dequantized into a
//     second register set while stage g's wgmma run;
//   * x^T is the B operand, K-major from shared memory (x is [M, K] row-major),
//     64 K-elements per stage in one 128-byte-swizzled row per x row;
//   * geometry (the constants below say why): at n8 a CTA is one warpgroup
//     with one m64 tile (32 low channels and their partners) and a ring of 8
//     stages; at n128 two warpgroups of two m64 tiles each (256 channels)
//     share each x stage, in a ring of 3;
//   * K is cut into chunks whose size depends on (K, N) only
//     (ops/int4_matmul_cuda.chunk_plan); a chunk is accumulated from zero in
//     fp32 and added to the running total in ascending chunk order.  At small
//     M the chunks go to separate CTAs (grid z), which write fp32 partials to
//     a scratch buffer that int4_reduce_kernel sums in chunk order before the
//     scale; at large M one CTA walks all chunks and does the same additions
//     in registers (n8) or shared memory (n128).  A row's bits do not
//     depend on M: the route and BN enter neither a chunk's sum nor the order
//     of the chunk sums.
//   * epilogue: the fp32 scale after the sum (__fmul_rn), one rounding to
//     bf16, low and high channels written to their logical columns.
//
// float32 x: the exact fp32 kernel of the first port (int4_matmul_kernel,
// below), kept as it is:
//   * one CTA owns a tile of TM = 64 rows x TP = 128 packed byte-columns, that
//     is 256 output columns: the 128 "low" columns [p0, p0 + 128) and the 128
//     "high" columns N/2 + [p0, p0 + 128).  It writes both straight to their
//     logical places, so there is no rearranged scale vector and no reshuffle
//     of the output afterwards (the TPU kernel needs both because its tile
//     holds [lo | hi] side by side);
//   * K is walked in stages of TK = 32.  Per stage the CTA loads its x tile
//     into shared memory as float32, transposed ([k][row]), and its packed
//     weight tile 16 bytes per thread, unpacking each byte ONCE into two
//     float32 values in shared memory ([k][lo 128 | hi 128]); the inner loop
//     is then a plain shared-memory SGEMM step: a thread holds 8 rows x
//     (4 low + 4 high) columns = 64 accumulators and does 64 fmaf per
//     4 x 16-byte shared loads;
//   * a warp is one row group (8 rows), so when M is small the warps whose
//     rows lie past M skip the arithmetic (they still help stage the tiles);
//   * each sum is one fmaf chain over k in ascending order: a row's result
//     does not depend on M or on which tile it falls in.
//
// Limits: N/2 a multiple of 16 (the 16-byte weight copies; the wrapper
// checks); M and K are free (ragged edges are guarded; x is copied 16 bytes
// at a time when K is a multiple of 8 and x is 16-byte aligned, else one
// element at a time).
//
// What bounds it on the H100: for M up to a few dozen the packed weight bytes
// (K * N / 2 at 3.35 TB/s), which the chunked grid spreads over enough CTAs
// to keep the memory busy; beyond that the 2 * M * K * N operations on the
// tensor cores (989 TFLOP/s bf16).  At large M this kernel is bound by neither:
// the per-stage copies, barriers and dequantization of one CTA of 8 warps per
// SM are (PERF.md); a producer warp with TMA would take them off the
// warpgroups that issue the wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tile.cuh"  // jf::tc: cp.async, wgmma, descriptors, swizzle

namespace {

constexpr int TM = 64;    // rows per CTA
constexpr int TP = 128;   // packed byte-columns per CTA
constexpr int TK = 32;    // K per stage
constexpr int TX = 32;    // threads along the columns: 4 packed bytes each
constexpr int TY = 8;     // threads along the rows: RM rows each (one warp per row group)
constexpr int RM = TM / TY;
constexpr int THREADS = TX * TY;
constexpr int XS = TM + 4;   // row stride of x_s (floats), a multiple of 4
constexpr int WS = 2 * TP;   // row stride of w_s (floats): [lo | hi]

static_assert(TP == TX * 4 && RM == 8 && THREADS == 256, "thread layout");
static_assert(TK * (TP / 16) == THREADS, "one 16-byte weight load per thread and stage");
static_assert(TM * (TK / 8) == THREADS, "eight x elements per thread and stage");

__device__ __forceinline__ float to_f32(float x) { return x; }

__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
int4_matmul_kernel(const T* __restrict__ x, const uint8_t* __restrict__ wp,
                   const float* __restrict__ scale, T* __restrict__ y, int M, int K, int NP,
                   int x_vec) {
  __shared__ __align__(16) float x_s[TK * XS];  // [k][row]
  __shared__ __align__(16) float w_s[TK * WS];  // [k][lo TP | hi TP]

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int p0 = blockIdx.x * TP;
  const int row0 = blockIdx.y * TM;
  const bool rows_live = row0 + ty * RM < M;  // the same for a whole warp

  // staging roles
  const int xr = tid >> 2, xk = (tid & 3) * 8;   // x: row, first k of 8
  const int wk = tid >> 3, wb = (tid & 7) * 16;  // w: k, first byte of 16

  float acc[RM][8];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < K; k0 += TK) {
    __syncthreads();  // the previous stage is consumed
    {
      float xv[8];
      const int row = row0 + xr;
      const int k = k0 + xk;
      if (row < M && x_vec && k + 8 <= K) {
        load8(x + (long long)row * K + k, xv);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          xv[e] = (row < M && k + e < K) ? to_f32(x[(long long)row * K + k + e]) : 0.f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) x_s[(xk + e) * XS + xr] = xv[e];
    }
    {
      // past K or past the packed width: bytes 0x88 unpack to (0, 0)
      uint4 v = make_uint4(0x88888888u, 0x88888888u, 0x88888888u, 0x88888888u);
      if (k0 + wk < K && p0 + wb < NP)
        v = *reinterpret_cast<const uint4*>(wp + (long long)(k0 + wk) * NP + p0 + wb);
      const uint8_t* b = reinterpret_cast<const uint8_t*>(&v);
      float* lo = w_s + wk * WS + wb;
      float* hi = lo + TP;
#pragma unroll
      for (int i = 0; i < 16; i += 4) {
        store4(lo + i, float(int(b[i] & 0xF) - 8), float(int(b[i + 1] & 0xF) - 8),
               float(int(b[i + 2] & 0xF) - 8), float(int(b[i + 3] & 0xF) - 8));
        store4(hi + i, float(int(b[i] >> 4) - 8), float(int(b[i + 1] >> 4) - 8),
               float(int(b[i + 2] >> 4) - 8), float(int(b[i + 3] >> 4) - 8));
      }
    }
    __syncthreads();
    if (!rows_live) continue;

#pragma unroll 4
    for (int k = 0; k < TK; ++k) {
      const float4 xa = *reinterpret_cast<const float4*>(x_s + k * XS + ty * RM);
      const float4 xb = *reinterpret_cast<const float4*>(x_s + k * XS + ty * RM + 4);
      const float4 wl = *reinterpret_cast<const float4*>(w_s + k * WS + tx * 4);
      const float4 wh = *reinterpret_cast<const float4*>(w_s + k * WS + TP + tx * 4);
      const float xs[RM] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
      const float ws[8] = {wl.x, wl.y, wl.z, wl.w, wh.x, wh.y, wh.z, wh.w};
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(xs[r], ws[c], acc[r][c]);
    }
  }

  // ---- epilogue: scale, cast, write the low and the high columns ----
  const int pc = p0 + tx * 4;  // first of this thread's 4 packed columns
  if (!rows_live || pc >= NP) return;
  const int N = 2 * NP;
  const float4 sl = *reinterpret_cast<const float4*>(scale + pc);
  const float4 sh = *reinterpret_cast<const float4*>(scale + NP + pc);
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int row = row0 + ty * RM + r;
    if (row >= M) break;
    T* o = y + (long long)row * N;
    store4(o + pc, __fmul_rn(acc[r][0], sl.x), __fmul_rn(acc[r][1], sl.y),
           __fmul_rn(acc[r][2], sl.z), __fmul_rn(acc[r][3], sl.w));
    store4(o + NP + pc, __fmul_rn(acc[r][4], sh.x), __fmul_rn(acc[r][5], sh.y),
           __fmul_rn(acc[r][6], sh.z), __fmul_rn(acc[r][7], sh.w));
  }
}

template <typename T>
int launch(const void* x, const void* wp, const void* scale, void* y, int M, int K, int N,
           cudaStream_t stream) {
  const int NP = N / 2;
  const dim3 grid((NP + TP - 1) / TP, (M + TM - 1) / TM);
  const int x_vec = (K % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  int4_matmul_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(wp),
      static_cast<const float*>(scale), static_cast<T*>(y), M, K, NP, x_vec);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16 x: the tensor-core kernel
// ---------------------------------------------------------------------------

namespace tc = jf::tc;

constexpr int TC_TK = 64;  // K per stage: one 128-byte bf16 row of x
constexpr int REDUCE_THREADS = 256;

// Geometry by BN, the x rows per wgmma:
//   BN = 8 (M <= 8, bytes-bound): one warpgroup, one m64 tile (32 packed
//     columns), 8 stages: many small CTAs with many weight bytes in flight;
//   BN = 128: two warpgroups of two m64 tiles each share every x stage (128
//     packed columns = 256 channels per CTA, so x is re-read from L2 by
//     N / 256 CTAs, not N / 64), 3 stages, and the running chunk totals in
//     shared memory (128 fp32 a thread), which leaves the registers to the
//     two 64-register accumulators.
template <int BN> constexpr int WGS = BN <= 8 ? 1 : 2;       // warpgroups per CTA
template <int BN> constexpr int MT = BN <= 8 ? 1 : 2;        // m64 tiles per warpgroup
template <int BN> constexpr int STAGES = BN <= 8 ? 8 : 3;
template <int BN> constexpr bool TOTAL_SMEM = BN > 8;
template <int BN> constexpr int THREADS_OF = 128 * WGS<BN>;
template <int BN> constexpr int TP_OF = 32 * MT<BN> * WGS<BN>;  // packed columns per CTA
template <int BN> constexpr int W_ROW = TP_OF<BN> + 16;  // padded shared weight row (bytes)
template <int BN> constexpr int W_STAGE = TC_TK * W_ROW<BN>;
template <int BN> constexpr int X_STAGE = BN * 128;  // BN rows of 64 bf16, 128-byte swizzle
template <int BN>
constexpr size_t TOTAL_BYTES = TOTAL_SMEM<BN> ? size_t(MT<BN>) * (BN / 2) * THREADS_OF<BN> * 4 : 0;

// 1 KiB of alignment slack, the x stages (each a multiple of 1 KiB), the
// weight stages, the chunk totals
template <int BN>
constexpr size_t TC_SMEM =
    1024 + size_t(STAGES<BN>) * (X_STAGE<BN> + W_STAGE<BN>) + TOTAL_BYTES<BN>;

// wgmma m64nBNk16, A (the weights) from registers, B (x^T) K-major from shared
// memory, accumulate into d
__device__ __forceinline__ void mma_w_x(float (&d)[4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void mma_w_x(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
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
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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

// Two nibbles (bits 0-3 and 16-19 of n) -> the bf16 pair (nibble - 8): n |
// 0x4300 is the bf16 of 128 + nibble, and 128 + nibble - 136 is exact.
__device__ __forceinline__ uint32_t nibbles_to_bf16(uint32_t n) {
  const uint32_t x = n | 0x43004300u;
  const __nv_bfloat162 v =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&x), __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// y = (x @ unpack(wp)) * scale for bf16 x.  CTA (blockIdx.x, .y, .z): BN rows
// of x from m0 = x * BN, packed columns [p0, p0 + TP) from p0 = y * TP, and
// chunks [c0, c1) of `chunk` K each: chunk z alone when `split` (fp32
// partials to partial[z][M][N]), else all of them (y written here).
//
// Rows of m64 tile t of warpgroup v: warp w, lane l; row 16 w + l / 4 is the
// low channel pc = p0 + 32 MT v + MT (8 w + l / 4) + t, row 16 w + l / 4 + 8
// its high partner N/2 + pc.  The A fragment of k16 step kk holds, per row,
// k = 16 kk + 2 (l % 4) + {0, 1} (registers 0 / 1: lo / hi row) and + 8
// (registers 2 / 3): the low and high nibbles of the weight bytes (k, pc),
// which the thread reads for its MT tiles as one MT-byte load per k.
template <int BN>
__global__ void __launch_bounds__(THREADS_OF<BN>)
int4_tc_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ wp,
               const float* __restrict__ scale, __nv_bfloat16* __restrict__ y,
               float* __restrict__ partial, int M, int K, int NP, int chunk, int split,
               int x_vec) {
  constexpr int NA = BN / 2;  // accumulator registers of one m64 tile
  constexpr int NS = STAGES<BN>;
  constexpr int NT = THREADS_OF<BN>;
  constexpr int TP = TP_OF<BN>;
  constexpr int WR = W_ROW<BN>;
  constexpr int T = MT<BN>;
  extern __shared__ unsigned char smem_i4[];
  const uint32_t raw = tc::smem_addr(smem_i4);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  const uint32_t xs0 = raw + pad;                // x stage s at xs0 + s X_STAGE
  const uint32_t ws0 = xs0 + NS * X_STAGE<BN>;  // weight stage s at ws0 + s W_STAGE
  const unsigned char* const ws_ptr = smem_i4 + pad + NS * X_STAGE<BN>;
  // chunk totals: element i of this thread at total_s[i * NT + tid]
  float* const total_s =
      reinterpret_cast<float*>(smem_i4 + pad + NS * (X_STAGE<BN> + W_STAGE<BN>));

  const int N = 2 * NP;
  const int m0 = blockIdx.x * BN;
  const int p0 = blockIdx.y * TP;
  const int n_chunks = (K + chunk - 1) / chunk;
  const int c0 = split ? blockIdx.z : 0;
  const int c1 = split ? c0 + 1 : n_chunks;
  const int kbeg = c0 * chunk;
  const int kend = min(K, c1 * chunk);
  const int per = chunk / TC_TK;  // stages per chunk
  const int n_st = (kend - kbeg + TC_TK - 1) / TC_TK;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int q4 = lane & 3;
  // this thread's first packed column - p0 (its tiles t: + t)
  const int col = 32 * T * (tid >> 7) + T * (8 * ((tid & 127) >> 5) + (lane >> 2));

  // stage g (K from kbeg + 64 g) into slot s
  auto issue = [&](int g, int s) {
    const int kb = kbeg + g * TC_TK;
    const uint32_t xd = xs0 + s * X_STAGE<BN>;
#pragma unroll
    for (int it = 0; it < (BN * 8 + NT - 1) / NT; ++it) {
      const int idx = tid + it * NT;
      if (idx >= BN * 8) break;
      const int r = idx >> 3, c = idx & 7;
      const int row = m0 + r, k = kb + 8 * c;
      const uint32_t d = xd + r * 128 + ((c ^ (r & 7)) << 4);
      if (x_vec) {
        const bool ok = row < M && k < K;
        tc::cp_async16(d, ok ? x + (long long)row * K + k : x, ok);
      } else {  // ragged K or unaligned x: element by element, zeros past K
        uint32_t v[4];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const __nv_bfloat16 h =
              row < M && k + e < K ? x[(long long)row * K + k + e] : __float2bfloat16(0.f);
          const uint32_t b = *reinterpret_cast<const unsigned short*>(&h);
          v[e >> 1] = (e & 1) ? (v[e >> 1] | (b << 16)) : b;
        }
        *reinterpret_cast<uint4*>(smem_i4 + (d - raw)) = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
    // weight row kb + r, bytes [16 c, 16 c + 16) of the CTA's TP
#pragma unroll
    for (int it = 0; it < TC_TK * TP / 16 / NT; ++it) {
      const int idx = tid + it * NT;
      const int r = idx / (TP / 16), c = idx % (TP / 16);
      const bool ok = kb + r < K && p0 + 16 * c < NP;
      tc::cp_async16(ws0 + s * W_STAGE<BN> + r * WR + 16 * c,
                     ok ? wp + (long long)(kb + r) * NP + p0 + 16 * c : wp, ok);
    }
  };
  // the T bytes (k, col + t), t < T, as bits 8 t .. 8 t + 7
  auto ld = [&](const unsigned char* p) -> uint32_t {
    if constexpr (T == 2) return *reinterpret_cast<const unsigned short*>(p);
    else return *p;
  };

  float acc[T][NA];
  float total[TOTAL_SMEM<BN> ? 1 : T][TOTAL_SMEM<BN> ? 1 : NA];  // registers (n8)
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[t][i] = 0.f;
  if constexpr (!TOTAL_SMEM<BN>) {
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
      for (int i = 0; i < NA; ++i) total[t][i] = 0.f;
  }

  // The weights of stage g as bf16 A fragments [k16 step][m64 tile][register]
  auto dequant = [&](int g, uint32_t (&a)[4][T][4]) {
    const unsigned char* wcol = ws_ptr + (g % NS) * W_STAGE<BN> + col;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const unsigned char* r0 = wcol + (16 * kk + 2 * q4) * WR;
      // the bytes of weight rows k and k + 1 (k = 16 kk + 2 q4), and of k + 8, k + 9
      const uint32_t x01 = ld(r0) | (ld(r0 + WR) << 16);
      const uint32_t x89 = ld(r0 + 8 * WR) | (ld(r0 + 9 * WR) << 16);
#pragma unroll
      for (int t = 0; t < T; ++t) {
        a[kk][t][0] = nibbles_to_bf16((x01 >> (8 * t)) & 0x000F000Fu);      // low channel
        a[kk][t][1] = nibbles_to_bf16((x01 >> (8 * t + 4)) & 0x000F000Fu);  // high partner
        a[kk][t][2] = nibbles_to_bf16((x89 >> (8 * t)) & 0x000F000Fu);
        a[kk][t][3] = nibbles_to_bf16((x89 >> (8 * t + 4)) & 0x000F000Fu);
      }
    }
  };
  // Stage g: its products (from `cur`) run while stage g + 1 is awaited,
  // stage g + NS - 1 is issued into stage g - 1's slot and stage g + 1 is
  // dequantized into `nxt`; then the chunk bookkeeping of stage g.
  auto step = [&](int g, const uint32_t (&cur)[4][T][4], uint32_t (&nxt)[4][T][4]) {
    if (g % per == 0) {  // a chunk starts: its sum starts from zero
#pragma unroll
      for (int t = 0; t < T; ++t)
#pragma unroll
        for (int i = 0; i < NA; ++i) acc[t][i] = 0.f;
    }
#pragma unroll
    for (int t = 0; t < T; ++t) tc::fence_regs(acc[t]);
    tc::wgmma_fence();
    const uint32_t xs = xs0 + (g % NS) * X_STAGE<BN>;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t b = tc::desc_kmajor(xs + kk * 32);
#pragma unroll
      for (int t = 0; t < T; ++t) mma_w_x(acc[t], cur[kk][t], b);
    }
    tc::wgmma_commit();
    if (g + 1 < n_st) {
      tc::cp_async_wait<NS - 3>();  // stage g + 1 has landed (this thread's copies)
      tc::fence_async_smem();
      __syncthreads();  // ... everywhere, and every thread is done with stage g - 1
      if (g + NS - 1 < n_st) issue(g + NS - 1, (g + NS - 1) % NS);
      tc::cp_async_commit();
      dequant(g + 1, nxt);
    }
    tc::wgmma_wait_all();
#pragma unroll
    for (int t = 0; t < T; ++t) tc::fence_regs(acc[t]);
    if (!split && (g % per == per - 1 || g == n_st - 1)) {  // a chunk ends: add it in order
      const bool first = g < per;
#pragma unroll
      for (int t = 0; t < T; ++t) {
#pragma unroll
        for (int i = 0; i < NA; ++i) {
          if constexpr (TOTAL_SMEM<BN>) {
            float& slot = total_s[(t * NA + i) * NT + tid];
            slot = first ? acc[t][i] : __fadd_rn(slot, acc[t][i]);
          } else {
            total[t][i] = first ? acc[t][i] : __fadd_rn(total[t][i], acc[t][i]);
          }
        }
      }
    }
  };

#pragma unroll
  for (int g = 0; g < NS - 1; ++g) {
    if (g < n_st) issue(g, g);
    tc::cp_async_commit();
  }
  tc::cp_async_wait<NS - 2>();
  tc::fence_async_smem();
  __syncthreads();  // stage 0 has landed everywhere
  uint32_t a0[4][T][4], a1[4][T][4];  // two register sets, so the loop is unrolled by two
  dequant(0, a0);
  for (int g = 0; g < n_st; g += 2) {
    step(g, a0, a1);
    if (g + 1 < n_st) step(g + 1, a1, a0);
  }
  tc::cp_async_wait<0>();

  // ---- epilogue: accumulator element 4 j + e of tile t is row (e < 2 ? low
  // channel : high partner) pc + t, x row m0 + 8 j + 2 q4 + (e & 1) ----
  const int pc = p0 + col;
  if (pc >= NP) return;  // NP and T-column groups are even: pc + T - 1 < NP too
  if (split) {
    float* out = partial + (long long)blockIdx.z * M * N + pc;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + 8 * j + 2 * q4 + (e & 1);
        if (m >= M) continue;
        float* o = out + (long long)m * N + (e < 2 ? 0 : NP);
        if constexpr (T == 2) {
          *reinterpret_cast<float2*>(o) = make_float2(acc[0][4 * j + e], acc[1][4 * j + e]);
        } else {
          *o = acc[0][4 * j + e];
        }
      }
    }
    return;
  }
  float s_lo[T], s_hi[T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    s_lo[t] = scale[pc + t];
    s_hi[t] = scale[NP + pc + t];
  }
  auto tot = [&](int t, int i) -> float {
    if constexpr (TOTAL_SMEM<BN>) return total_s[(t * NA + i) * NT + tid];
    else return total[t][i];
  };
  __nv_bfloat16* out = y + pc;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + 8 * j + 2 * q4 + (e & 1);
      if (m >= M) continue;
      __nv_bfloat16* o = out + (long long)m * N + (e < 2 ? 0 : NP);
      const float* sc = e < 2 ? s_lo : s_hi;
      if constexpr (T == 2) {
        *reinterpret_cast<__nv_bfloat162*>(o) =
            __floats2bfloat162_rn(__fmul_rn(tot(0, 4 * j + e), sc[0]),
                                  __fmul_rn(tot(1, 4 * j + e), sc[1]));
      } else {
        *o = __float2bfloat16(__fmul_rn(tot(0, 4 * j + e), sc[0]));
      }
    }
  }
}

// The split route's second pass: y[m, n] = bf16(scale[n] * sum of the chunks'
// partials in chunk order), two columns per thread.
__global__ void __launch_bounds__(REDUCE_THREADS)
int4_reduce_kernel(const float* __restrict__ partial, const float* __restrict__ scale,
                   __nv_bfloat16* __restrict__ y, int M, int N, int n_chunks) {
  const long long idx = (long long)blockIdx.x * REDUCE_THREADS + threadIdx.x;
  const long long pairs = (long long)M * N / 2;  // float2 per chunk
  if (idx >= pairs) return;
  const float2* src = reinterpret_cast<const float2*>(partial) + idx;
  float2 acc = src[0];
  for (int c = 1; c < n_chunks; ++c) {
    const float2 v = src[c * pairs];
    acc.x = __fadd_rn(acc.x, v.x);
    acc.y = __fadd_rn(acc.y, v.y);
  }
  const int n = (int)(idx % (N / 2)) * 2;
  const float2 sc = *reinterpret_cast<const float2*>(scale + n);
  reinterpret_cast<__nv_bfloat162*>(y)[idx] =
      __floats2bfloat162_rn(__fmul_rn(acc.x, sc.x), __fmul_rn(acc.y, sc.y));
}

template <int BN>
int launch_tc(const void* x, const void* wp, const void* scale, void* y, void* partial, int M,
              int K, int N, int chunk, int split, cudaStream_t stream) {
  constexpr size_t smem = TC_SMEM<BN>;
  cudaError_t err = cudaFuncSetAttribute(int4_tc_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int NP = N / 2;
  const int n_chunks = (K + chunk - 1) / chunk;
  const dim3 grid((M + BN - 1) / BN, (NP + TP_OF<BN> - 1) / TP_OF<BN>, split ? n_chunks : 1);
  const int x_vec = (K % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  int4_tc_kernel<BN><<<grid, THREADS_OF<BN>, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(wp),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y),
      static_cast<float*>(partial), M, K, NP, chunk, split, x_vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || !split) return (int)err;
  const long long pairs = (long long)M * N / 2;
  int4_reduce_kernel<<<(unsigned)((pairs + REDUCE_THREADS - 1) / REDUCE_THREADS), REDUCE_THREADS,
                       0, stream>>>(static_cast<const float*>(partial),
                                    static_cast<const float*>(scale),
                                    static_cast<__nv_bfloat16*>(y), M, N, n_chunks);
  return (int)cudaGetLastError();
}

template <typename K>
int attrs_of(K kernel, bool tensor_cores, size_t dyn_smem, int threads, int rows_n, int stages,
             int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = tensor_cores ? 1 : 0;
  out[1] = a.numRegs;
  out[2] = (int)a.localSizeBytes;
  out[3] = (int)a.sharedSizeBytes;
  out[4] = (int)dyn_smem;
  out[5] = threads;
  out[6] = rows_n;
  out[7] = stages;
  return 0;
}

}  // namespace

// dtype: 0 = float32 (the fp32 kernel; bn, chunk, split and partial unused),
// 1 = bfloat16 (the tensor-core kernel: bn 8 or 128 x rows per instruction,
// K chunks of `chunk` (a multiple of 64), split 1: one CTA per chunk with the
// fp32 partials [chunks][M][N] in `partial`, then the reduce kernel).
// Returns 0 on success, a cudaError_t code after a refused launch, or -1 for
// a shape, dtype or plan the kernels do not take (the Python wrapper checks
// those first).
extern "C" int jf_int4_matmul(const void* x, const void* wp, const void* scale, void* y,
                              void* partial, int M, int K, int N, int dtype, int bn, int chunk,
                              int split, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || N % 32 != 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if ((M + TM - 1) / TM > 65535) return -1;
    return launch<float>(x, wp, scale, y, M, K, N, s);
  }
  if (dtype != 1 || chunk <= 0 || chunk % TC_TK != 0 || (split && partial == nullptr) ||
      (N / 2 + 31) / 32 > 65535 || (K + chunk - 1) / chunk > 65535)
    return -1;
  if (bn == 8) return launch_tc<8>(x, wp, scale, y, partial, M, K, N, chunk, split, s);
  if (bn == 128) return launch_tc<128>(x, wp, scale, y, partial, M, K, N, chunk, split, s);
  return -1;
}

// The attributes of kernel `which` (0 the fp32 kernel, 1 / 2 the tensor-core
// kernel at bn 8 / 128, 3 the reduce kernel) into out[8]: {tensor cores,
// registers, local bytes, static shared bytes, dynamic shared bytes, threads,
// x rows per instruction, stages}; -1 for no such kernel.
extern "C" int jf_int4_matmul_attrs(int which, int* out) {
  if (which == 0) return attrs_of(int4_matmul_kernel<float>, false, 0, THREADS, TM, 1, out);
  if (which == 1)
    return attrs_of(int4_tc_kernel<8>, true, TC_SMEM<8>, THREADS_OF<8>, 8, STAGES<8>, out);
  if (which == 2)
    return attrs_of(int4_tc_kernel<128>, true, TC_SMEM<128>, THREADS_OF<128>, 128, STAGES<128>,
                    out);
  if (which == 3) return attrs_of(int4_reduce_kernel, false, 0, REDUCE_THREADS, 0, 0, out);
  return -1;
}

extern "C" const char* jf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
