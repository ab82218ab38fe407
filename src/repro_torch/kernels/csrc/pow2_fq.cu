// Pow-2 fake-quant: y = clip(rint(x / 2^s), lo, hi) * 2^s in the dtype of
// x, with one f32 scale_log2 for the whole tensor (`p2_fake_quant`) or one
// per row of a contiguous (rows, cols) view (`p2_fq_rows`).
//
// Replaces: repro/numerics/pallas_backend.py `_p2_fq_kernel` (launched
// through `_elementwise_2d` / `_flat_call` by `_p2_fake_quant_pallas`, and
// by the shims kernels/quantize.py `quantize` and kernels/ops.py
// `quantize_fused`) and `_p2_fq_rows_kernel` (through `_rowscale_call` by
// `_p2_fake_quant_rows`). On the training path the scalar kernel is every
// TT-core quantization (4-bit, fixed per-core scale), every activation edge
// (8-bit) and every gradient edge (16-bit) of the paper's MLP. The row
// kernel is what the codec API's `fake_quant` runs for a scale per leading
// index (`Pow2Pallas.fake_quant`); no path of the reference reaches it.
//
// Numerics (bit-identical to Pow2Reference.fake_quant, i.e. JAX's
// `pow2_qdq`, which computes in x.dtype):
//   scale = T(2^s)                  the scale is cast to x.dtype first
//   v     = T(float(x) / scale)     IEEE divide, rounded to T
//   q     = rintf(v)                half-to-even
//   q     = clip(q, T(lo), T(hi))   bounds in T: JAX's weak-typed clip
//                                   makes the 16-bit hi 32767 -> 32768 in bf16
//   y     = T(q * scale)
// For f32 every T() is the identity. 2^s is formed with ldexpf for integer
// s (exact); the build has no --use_fast_math, so `/` and rintf keep their
// IEEE meaning. The clip is written with comparisons so a NaN passes
// through, as jnp.clip's does. The STE mask is not computed here: it stays
// outside the kernel, as in the Pallas backend (pallas_backend.py:326 and
// :350-355, the row kernel's mask on the `_bcast`-shaped scale).
//
// Bound on the H100: bytes. One read and one write per element and a
// handful of operations, far below the card's ~295 operations per byte.
// The scales are read from device memory, so a managed scale that the step
// just updated needs no host round trip.
// Design: a grid-stride loop over 4-element vectors (16/8-byte accesses)
// when the pointers are aligned and n % 4 == 0 (the row kernel: cols % 4
// == 0, so a vector never straddles two rows; its row's step is one cached
// load per vector), else a scalar loop. No shared memory, no
// synchronisation.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum DType { F32 = 0, BF16 = 1 };

__device__ __forceinline__ float pow2_step(float s) {
  // exact 2^s for integer-valued s; the range guard keeps (int)s defined
  if (s == truncf(s) && fabsf(s) <= 1024.f) return ldexpf(1.f, (int)s);
  return exp2f(s);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// round a float to T and back (identity for f32)
template <typename T> __device__ __forceinline__ float in_t(float v) {
  return to_f32(from_f32<T>(v));
}

template <typename T>
__device__ __forceinline__ T fq_one(T x, float scale, float lo, float hi) {
  float q = rintf(in_t<T>(to_f32(x) / scale));
  q = q < lo ? lo : (q > hi ? hi : q);
  return from_f32<T>(q * scale);
}

template <typename T> struct alignas(4 * sizeof(T)) Vec4 { T v[4]; };

template <typename T, bool VEC>
__global__ void p2_fq_kernel(const T* __restrict__ x, const float* __restrict__ s,
                             T* __restrict__ y, long long n, float lo, float hi) {
  const float scale = in_t<T>(pow2_step(__ldg(s)));
  const float lo_t = in_t<T>(lo), hi_t = in_t<T>(hi);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (VEC) {
    for (long long i = first; i < n / 4; i += stride) {
      const Vec4<T> in = reinterpret_cast<const Vec4<T>*>(x)[i];
      Vec4<T> out;
#pragma unroll
      for (int j = 0; j < 4; ++j) out.v[j] = fq_one(in.v[j], scale, lo_t, hi_t);
      reinterpret_cast<Vec4<T>*>(y)[i] = out;
    }
  } else {
    for (long long i = first; i < n; i += stride) y[i] = fq_one(x[i], scale, lo_t, hi_t);
  }
}

template <typename T, bool VEC>
__global__ void p2_fq_rows_kernel(const T* __restrict__ x, const float* __restrict__ s,
                                  T* __restrict__ y, long long n, long long cols, float lo,
                                  float hi) {
  const float lo_t = in_t<T>(lo), hi_t = in_t<T>(hi);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (VEC) {
    const long long cv = cols / 4;
    for (long long i = first; i < n / 4; i += stride) {
      const float scale = in_t<T>(pow2_step(__ldg(s + i / cv)));
      const Vec4<T> in = reinterpret_cast<const Vec4<T>*>(x)[i];
      Vec4<T> out;
#pragma unroll
      for (int j = 0; j < 4; ++j) out.v[j] = fq_one(in.v[j], scale, lo_t, hi_t);
      reinterpret_cast<Vec4<T>*>(y)[i] = out;
    }
  } else {
    for (long long i = first; i < n; i += stride)
      y[i] = fq_one(x[i], in_t<T>(pow2_step(__ldg(s + i / cols))), lo_t, hi_t);
  }
}

constexpr int kThreads = 256;

inline int grid_for(long long work) {
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = 132LL * 32;  // enough resident blocks for every SM
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : (int)blocks;
}

inline bool aligned(const void* p, size_t a) { return ((uintptr_t)p % a) == 0; }

template <typename T>
void launch(const void* x, const float* s, void* y, long long n, float lo, float hi,
            cudaStream_t st) {
  if (n % 4 == 0 && aligned(x, 4 * sizeof(T)) && aligned(y, 4 * sizeof(T)))
    p2_fq_kernel<T, true><<<grid_for(n / 4), kThreads, 0, st>>>((const T*)x, s, (T*)y, n, lo,
                                                                hi);
  else
    p2_fq_kernel<T, false><<<grid_for(n), kThreads, 0, st>>>((const T*)x, s, (T*)y, n, lo, hi);
}

template <typename T>
void launch_rows(const void* x, const float* s, void* y, long long rows, long long cols,
                 float lo, float hi, cudaStream_t st) {
  const long long n = rows * cols;
  if (cols % 4 == 0 && aligned(x, 4 * sizeof(T)) && aligned(y, 4 * sizeof(T)))
    p2_fq_rows_kernel<T, true><<<grid_for(n / 4), kThreads, 0, st>>>((const T*)x, s, (T*)y,
                                                                     n, cols, lo, hi);
  else
    p2_fq_rows_kernel<T, false><<<grid_for(n), kThreads, 0, st>>>((const T*)x, s, (T*)y, n,
                                                                  cols, lo, hi);
}

}  // namespace

extern "C" {

// x, y: n contiguous elements of x_dtype; s: one f32 scale_log2 on the
// device; bits in [2, 16]. Returns cudaGetLastError() after the launch.
int p2_fake_quant(const void* x, int x_dtype, const void* s, void* y, long long n, int bits,
                  void* stream) {
  if (bits < 2 || bits > 16) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const float lo = -(float)(1 << (bits - 1)), hi = (float)((1 << (bits - 1)) - 1);
  cudaStream_t st = (cudaStream_t)stream;
  switch (x_dtype) {
    case F32: launch<float>(x, (const float*)s, y, n, lo, hi, st); break;
    case BF16: launch<__nv_bfloat16>(x, (const float*)s, y, n, lo, hi, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// x, y: (rows, cols) contiguous of x_dtype; s: (rows,) f32 scale_log2 on
// the device; bits in [2, 16].
int p2_fq_rows(const void* x, int x_dtype, const void* s, void* y, long long rows,
               long long cols, int bits, void* stream) {
  if (bits < 2 || bits > 16) return (int)cudaErrorInvalidValue;
  if (rows * cols == 0) return (int)cudaSuccess;
  const float lo = -(float)(1 << (bits - 1)), hi = (float)((1 << (bits - 1)) - 1);
  cudaStream_t st = (cudaStream_t)stream;
  switch (x_dtype) {
    case F32: launch_rows<float>(x, (const float*)s, y, rows, cols, lo, hi, st); break;
    case BF16: launch_rows<__nv_bfloat16>(x, (const float*)s, y, rows, cols, lo, hi, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
