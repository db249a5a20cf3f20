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
// Design (a simple kernel that is right first):
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
// Limits: N/2 a multiple of 16 (the 16-byte weight loads; the wrapper
// checks); M and K are free (ragged edges are guarded; x is loaded 16 bytes
// at a time when K is a multiple of 8 and x is 16-byte aligned, else one
// element at a time).
//
// What bounds it on the H100: for M <= ~64 the packed weight bytes
// (K * N / 2 at 3.35 TB/s); beyond that the 2 * M * K * N operations, which
// belong on the tensor cores (989 TFLOP/s bf16).  This first version does
// neither justice: it computes on the CUDA cores in float32, stages without
// cp.async / TMA double buffering, and at small M runs N / 256 CTAs, too few
// to pull the card's memory rate.  A tensor-core version (nibbles to bf16
// pairs, mma / wgmma) and a split-K small-M variant are later work;
// chip_smoke.py records its time beside the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns 0 on success, a cudaError_t code
// after a refused launch, or -1 for a shape/dtype the kernel does not take
// (the Python wrapper checks those first).
extern "C" int jf_int4_matmul(const void* x, const void* wp, const void* scale, void* y, int M,
                              int K, int N, int dtype, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || N % 32 != 0 || (M + TM - 1) / TM > 65535) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, wp, scale, y, M, K, N, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, wp, scale, y, M, K, N, s);
  return -1;
}

extern "C" const char* jf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
