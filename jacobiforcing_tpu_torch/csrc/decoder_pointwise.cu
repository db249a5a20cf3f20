// The decoder layer's float32 pointwise chains for Hopper (sm_90a), one pass
// each, plain C interface.
//
// Replaces no TPU kernel: under XLA on the TPU these chains were fused into
// their neighbours by the compiler.  Run as separate aten kernels, each chain
// went through float32 tensors in device memory and moved ~5.6x the bytes its
// work needs.  All three are bound by device-memory bytes (a few operations
// per byte), so the design reads each bf16 input once, keeps every float32
// intermediate in registers and writes each bf16 output once, with 16-byte
// loads and stores.
//
// Each kernel computes exactly what the plain functions of
// jacobiforcing_tpu_torch/models/qwen.py compute, rounding where they round:
// the products and sums are written with __fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn, so no FMA contraction changes a bit, and every intermediate
// that the plain path stores as bfloat16 is rounded to bfloat16 here too.
//
//   * add_rms_norm_kernel: s = bf16(x + delta) (delta optional) and
//     out = bf16(s * rsqrt(mean(s*s) + eps) * w): the residual add of
//     the previous sub-layer folded into the next RMSNorm.  One CTA per row;
//     a thread holds up to NORM_VECS 16-byte vectors of the row in registers,
//     so the row is read once.  The norm reads the rounded sum, as the plain
//     path does.  Only the order of the sum of squares differs from aten's
//     reduction, so the output is within one bf16 ulp of the plain one.
//   * qkv_rope_kernel: on the q/k/v projections' outputs, the bias (Qwen2),
//     the per-head q/k RMSNorm (Qwen3), then rotate-half RoPE from the
//     cos/sin rows of each token, q and k written in bf16; v gets its bias
//     in a second range of CTAs (without a bias v is not touched).  A head
//     is D / 16 threads, each holding 8 elements of the first half and the
//     matching 8 of the second half, so a rotation pair never leaves a
//     thread and a head's sum of squares is a shuffle over D / 16 lanes.
//   * silu_mul_kernel: bf16(bf16(silu(g)) * u), silu as aten computes it,
//     g / (1 + exp(-g)) in float32; 8 elements a thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NORM_VECS = 4;       // 16-byte vectors of a row per thread, at most
constexpr int MAX_NORM_THREADS = 512;   // H up to 16384
constexpr int THREADS = 256;       // qkv_rope and silu_mul

__device__ __forceinline__ void load8(const bf16* p, float (&f)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void store8(bf16* p, const float (&f)[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void loadf8(const float* p, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// the float32 value's bfloat16 rounding, as float32 again
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ---------------------------------------------------------------------------
// residual add + RMSNorm
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(MAX_NORM_THREADS)
add_rms_norm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ delta,
                    const bf16* __restrict__ w, bf16* __restrict__ sum_out,
                    bf16* __restrict__ out, int H, float inv_h, float eps) {
  __shared__ float partial[MAX_NORM_THREADS / 32];
  const long long base = (long long)blockIdx.x * H;
  const int nvec = H / 8;
  float v[NORM_VECS][8];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NORM_VECS; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < nvec) {
      load8(x + base + c * 8, v[i]);
      if (delta != nullptr) {
        float d[8];
        load8(delta + base + c * 8, d);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[i][j] = round_bf16(__fadd_rn(v[i][j], d[j]));
        store8(sum_out + base + c * 8, v[i]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) ss = __fadd_rn(ss, __fmul_rn(v[i][j], v[i][j]));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const int warps = blockDim.x / 32;
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x / 32] = ss;
  __syncthreads();
  float total = 0.f;
  for (int i = 0; i < warps; ++i) total += partial[i];
  // aten: mean = sum * (1 / H), then var + eps, then rsqrt
  const float r = rsqrtf(__fadd_rn(__fmul_rn(total, inv_h), eps));
#pragma unroll
  for (int i = 0; i < NORM_VECS; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < nvec) {
      float wv[8];
      load8(w + c * 8, wv);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[i][j] = __fmul_rn(__fmul_rn(v[i][j], r), wv[j]);
      store8(out + base + c * 8, v[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// q/k/v bias, q/k RMSNorm, RoPE
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS)
qkv_rope_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ bq,
                const bf16* __restrict__ bk, const bf16* __restrict__ bv,
                const bf16* __restrict__ qn, const bf16* __restrict__ kn,
                const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                bf16* __restrict__ qo, bf16* __restrict__ ko, bf16* __restrict__ vo,
                int rows, int NH, int KH, int qk_blocks, float eps) {
  constexpr int HALF = D / 2;
  constexpr int TPH = D / 16;  // threads per head
  if ((int)blockIdx.x >= qk_blocks) {
    // v + bias, 8 elements a thread
    const long long c = ((long long)(blockIdx.x - qk_blocks) * THREADS + threadIdx.x) * 8;
    if (c >= (long long)rows * KH * D) return;
    const int col = (int)(c % (KH * D));
    float a[8], b[8];
    load8(v + c, a);
    load8(bv + col, b);
#pragma unroll
    for (int j = 0; j < 8; ++j) a[j] = __fadd_rn(a[j], b[j]);
    store8(vo + c, a);
    return;
  }
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long unit = t / TPH;  // one (token, q or k head)
  const int lane = (int)(t % TPH);
  const int heads = NH + KH;
  // every lane takes part in the shuffle below; a lane past the last head
  // computes on zeros and stores nothing
  const bool valid = unit < (long long)rows * heads;
  const long long row = valid ? unit / heads : 0;
  const int hh = valid ? (int)(unit % heads) : 0;
  const bool is_q = hh < NH;
  const int head = is_q ? hh : hh - NH;
  const long long off = (row * (is_q ? NH : KH) + head) * D;
  const bf16* src = (is_q ? q : k) + off;
  const bf16* bias = is_q ? bq : bk;
  const bf16* nw = is_q ? qn : kn;
  const int e1 = lane * 8, e2 = HALF + lane * 8;

  float a[8], b[8];
  if (valid) {
    load8(src + e1, a);
    load8(src + e2, b);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) a[j] = b[j] = 0.f;
  }
  if (bias != nullptr) {
    float ba[8], bb[8];
    load8(bias + head * D + e1, ba);
    load8(bias + head * D + e2, bb);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      a[j] = round_bf16(__fadd_rn(a[j], ba[j]));
      b[j] = round_bf16(__fadd_rn(b[j], bb[j]));
    }
  }
  if (nw != nullptr) {  // the same for every thread of the launch
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      ss = __fadd_rn(ss, __fadd_rn(__fmul_rn(a[j], a[j]), __fmul_rn(b[j], b[j])));
#pragma unroll
    for (int o = TPH / 2; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float r = rsqrtf(__fadd_rn(__fmul_rn(ss, 1.0f / D), eps));
    float wa[8], wb[8];
    load8(nw + e1, wa);
    load8(nw + e2, wb);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      a[j] = round_bf16(__fmul_rn(__fmul_rn(a[j], r), wa[j]));
      b[j] = round_bf16(__fmul_rn(__fmul_rn(b[j], r), wb[j]));
    }
  }
  if (!valid) return;
  float c[8], s[8], o1[8], o2[8];
  loadf8(cos_t + row * HALF + e1, c);
  loadf8(sin_t + row * HALF + e1, s);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    o1[j] = __fsub_rn(__fmul_rn(a[j], c[j]), __fmul_rn(b[j], s[j]));
    o2[j] = __fadd_rn(__fmul_rn(b[j], c[j]), __fmul_rn(a[j], s[j]));
  }
  bf16* dst = (is_q ? qo : ko) + off;
  store8(dst + e1, o1);
  store8(dst + e2, o2);
}

// ---------------------------------------------------------------------------
// SiLU(gate) * up
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
silu_mul_kernel(const bf16* __restrict__ g, const bf16* __restrict__ u, bf16* __restrict__ out,
                long long n) {
  const long long c = ((long long)blockIdx.x * THREADS + threadIdx.x) * 8;
  if (c >= n) return;
  float a[8], b[8];
  load8(g + c, a);
  load8(u + c, b);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float s = round_bf16(__fdiv_rn(a[j], __fadd_rn(1.0f, expf(-a[j]))));
    a[j] = __fmul_rn(s, b[j]);
  }
  store8(out + c, a);
}

}  // namespace

// sum_out may be null exactly when delta is.  Returns 0, a CUDA error code,
// or -1 for a shape the kernel does not take.
extern "C" int jf_add_rms_norm(const void* x, const void* delta, const void* w, void* sum_out,
                               void* out, int rows, int H, float eps, void* stream) {
  if (rows <= 0 || H <= 0 || H % 8 != 0 || (delta == nullptr) != (sum_out == nullptr)) return -1;
  const int per_thread = (H / 8 + NORM_VECS - 1) / NORM_VECS;
  const int threads = (per_thread + 31) / 32 * 32;
  if (threads > MAX_NORM_THREADS) return -1;
  add_rms_norm_kernel<<<rows, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(delta),
      static_cast<const bf16*>(w), static_cast<bf16*>(sum_out), static_cast<bf16*>(out), H,
      1.0f / H, eps);
  return (int)cudaGetLastError();
}

// q [rows, NH * D], k / v [rows, KH * D]; bq / bk / bv and qn / kn may be
// null (bq, bk and bv together, qn and kn together; vo is written only with
// bv); cos / sin [rows, D / 2] float32.
extern "C" int jf_qkv_rope(const void* q, const void* k, const void* v, const void* bq,
                           const void* bk, const void* bv, const void* qn, const void* kn,
                           const void* cos_t, const void* sin_t, void* qo, void* ko, void* vo,
                           int rows, int NH, int KH, int D, float eps, void* stream) {
  if (rows <= 0 || NH <= 0 || KH <= 0 || (D != 64 && D != 128)) return -1;
  if ((bq == nullptr) != (bk == nullptr) || (bq == nullptr) != (bv == nullptr) ||
      (qn == nullptr) != (kn == nullptr))
    return -1;
  const long long qk_threads = (long long)rows * (NH + KH) * (D / 16);
  const long long qk_blocks = (qk_threads + THREADS - 1) / THREADS;
  const long long v_blocks =
      bv == nullptr ? 0 : ((long long)rows * KH * D / 8 + THREADS - 1) / THREADS;
  if (qk_blocks + v_blocks > 0x7fffffffLL) return -1;
  const unsigned grid = (unsigned)(qk_blocks + v_blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define JF_QKV_ROPE_ARGS                                                                     \
  static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),    \
      static_cast<const bf16*>(bq), static_cast<const bf16*>(bk),                           \
      static_cast<const bf16*>(bv), static_cast<const bf16*>(qn),                           \
      static_cast<const bf16*>(kn), static_cast<const float*>(cos_t),                       \
      static_cast<const float*>(sin_t), static_cast<bf16*>(qo), static_cast<bf16*>(ko),     \
      static_cast<bf16*>(vo), rows, NH, KH, (int)qk_blocks, eps
  if (D == 128)
    qkv_rope_kernel<128><<<grid, THREADS, 0, s>>>(JF_QKV_ROPE_ARGS);
  else
    qkv_rope_kernel<64><<<grid, THREADS, 0, s>>>(JF_QKV_ROPE_ARGS);
#undef JF_QKV_ROPE_ARGS
  return (int)cudaGetLastError();
}

// g, u, out: n bfloat16 values, n a multiple of 8
extern "C" int jf_silu_mul(const void* g, const void* u, void* out, long long n, void* stream) {
  if (n <= 0 || n % 8 != 0) return -1;
  const long long blocks = (n / 8 + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return -1;
  silu_mul_kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(g), static_cast<const bf16*>(u), static_cast<bf16*>(out), n);
  return (int)cudaGetLastError();
}

extern "C" const char* jf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
