// Scalar-scale pow-2 codec: int8 encode and decode of a whole tensor under
// one f32 scale_log2, read on the device.
//
// Replaces: repro/numerics/pallas_backend.py `_p2_enc_kernel` and
// `_p2_dec_kernel` (launched through `_flat_call` -> `_elementwise_2d` by
// `Pow2Pallas.encode` / `decode` whenever the scale has one element). On
// the serving path these are chunked prefill's pool writes
// (`kv_cache.write_chunk`: one chunk's K or V, (S_chunk, Hkv, Dh), under
// the slot's scale) and its history reads (`gather_slots` of one slot,
// (1, max_len, Hkv, Dh)): two of each per layer per chunk step.
//
// Numerics (bit-identical to Pow2Reference):
//   encode  q = int8(clamp(rint(x / 2^s), lo, hi))   rint: half-to-even
//   decode  y = T(float(q) * 2^s)                      round-to-nearest cast
// 2^s is formed with ldexpf(1, s), exact for the integer-valued scales the
// pool uses (codecs.per_tensor_max_scale_log2 takes a ceil); a fractional s
// falls back to exp2f. Division by a power of two is exact (or correctly
// rounded into the subnormals), so x / 2^s == x * 2^-s here. The build has
// no --use_fast_math: division, rintf and exp2f keep their IEEE meaning.
//
// Bound on the H100: bytes. Each element is read once and written once
// (encode: 4 or 2 bytes in, 1 out; decode: 1 in, 4 or 2 out) with one
// divide and one round. At the chunk step's full width an encode of
// (128, 8, 128) bf16 moves 393 KB (0.12 us at 3.35 TB/s) and a decode of
// (1, 1024, 8, 128) into bf16 3.1 MB (0.94 us): both sit far below the
// ~5 us a launch costs, so the design keeps the launch lean.
// Design: the step is read once per thread from the device pointer (the
// slot's scale lives on the card, so the host never syncs for it) and
// formed once; a flat grid-stride loop over 4-element vectors (16/8-byte
// loads of the float side, 4-byte int8 words) with no per-vector index
// arithmetic beyond the stride, then a scalar tail for n % 4 elements.
// The chunk write's K/V is a slice of the projection, so the wrapper makes
// it contiguous and the launcher checks alignment: an unaligned pointer
// takes the scalar loop for the whole tensor. No shared memory, no
// synchronisation.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

enum DType { F32 = 0, BF16 = 1, F16 = 2 };

__device__ __forceinline__ float pow2_step(float s) {
  // exact 2^s for integer-valued s; the range guard keeps (int)s defined
  if (s == truncf(s) && fabsf(s) <= 1024.f) return ldexpf(1.f, (int)s);
  return exp2f(s);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

__device__ __forceinline__ int8_t encode_one(float x, float step, float lo, float hi) {
  return (int8_t)(int)fminf(fmaxf(rintf(x / step), lo), hi);
}

// aligned bundle of 4 elements of T (16 bytes for f32, 8 for 16-bit types)
template <typename T> struct alignas(4 * sizeof(T)) Vec4 { T v[4]; };

template <typename T, bool VEC>
__global__ void p2_enc_kernel(const T* __restrict__ x, const float* __restrict__ s,
                              int8_t* __restrict__ q, long long n, float lo, float hi) {
  const float step = pow2_step(__ldg(s));
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long tail = 0;
  if (VEC) {
    const long long nv = n / 4;
    for (long long i = first; i < nv; i += stride) {
      const Vec4<T> in = reinterpret_cast<const Vec4<T>*>(x)[i];
      char4 out;
      out.x = encode_one(to_f32(in.v[0]), step, lo, hi);
      out.y = encode_one(to_f32(in.v[1]), step, lo, hi);
      out.z = encode_one(to_f32(in.v[2]), step, lo, hi);
      out.w = encode_one(to_f32(in.v[3]), step, lo, hi);
      reinterpret_cast<char4*>(q)[i] = out;
    }
    tail = nv * 4;
  }
  for (long long i = tail + first; i < n; i += stride)
    q[i] = encode_one(to_f32(x[i]), step, lo, hi);
}

template <typename T, bool VEC>
__global__ void p2_dec_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                              T* __restrict__ y, long long n) {
  const float step = pow2_step(__ldg(s));
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long tail = 0;
  if (VEC) {
    const long long nv = n / 4;
    for (long long i = first; i < nv; i += stride) {
      const char4 in = reinterpret_cast<const char4*>(q)[i];
      Vec4<T> out;
      out.v[0] = from_f32<T>((float)in.x * step);
      out.v[1] = from_f32<T>((float)in.y * step);
      out.v[2] = from_f32<T>((float)in.z * step);
      out.v[3] = from_f32<T>((float)in.w * step);
      reinterpret_cast<Vec4<T>*>(y)[i] = out;
    }
    tail = nv * 4;
  }
  for (long long i = tail + first; i < n; i += stride)
    y[i] = from_f32<T>((float)q[i] * step);
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
void launch_enc(const void* x, const float* s, void* q, long long n, float lo, float hi,
                cudaStream_t st) {
  if (n >= 4 && aligned(x, 4 * sizeof(T)) && aligned(q, 4))
    p2_enc_kernel<T, true><<<grid_for(n / 4), kThreads, 0, st>>>((const T*)x, s, (int8_t*)q,
                                                                 n, lo, hi);
  else
    p2_enc_kernel<T, false><<<grid_for(n), kThreads, 0, st>>>((const T*)x, s, (int8_t*)q, n,
                                                              lo, hi);
}

template <typename T>
void launch_dec(const void* q, const float* s, void* y, long long n, cudaStream_t st) {
  if (n >= 4 && aligned(q, 4) && aligned(y, 4 * sizeof(T)))
    p2_dec_kernel<T, true><<<grid_for(n / 4), kThreads, 0, st>>>((const int8_t*)q, s, (T*)y,
                                                                 n);
  else
    p2_dec_kernel<T, false><<<grid_for(n), kThreads, 0, st>>>((const int8_t*)q, s, (T*)y, n);
}

}  // namespace

extern "C" {

// x: n contiguous elements of x_dtype, s: one f32 scale_log2 on the
// device, q: n int8. bits in [2, 8]. Returns cudaGetLastError() after the
// launch.
int p2_enc(const void* x, int x_dtype, const void* s, void* q, long long n, int bits,
           void* stream) {
  if (bits < 2 || bits > 8) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const float lo = -(float)(1 << (bits - 1)), hi = (float)((1 << (bits - 1)) - 1);
  cudaStream_t st = (cudaStream_t)stream;
  const float* sc = (const float*)s;
  switch (x_dtype) {
    case F32: launch_enc<float>(x, sc, q, n, lo, hi, st); break;
    case BF16: launch_enc<__nv_bfloat16>(x, sc, q, n, lo, hi, st); break;
    case F16: launch_enc<__half>(x, sc, q, n, lo, hi, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// q: n contiguous int8, s: one f32 scale_log2 on the device, y: n of
// y_dtype.
int p2_dec(const void* q, const void* s, void* y, int y_dtype, long long n, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const float* sc = (const float*)s;
  switch (y_dtype) {
    case F32: launch_dec<float>(q, sc, y, n, st); break;
    case BF16: launch_dec<__nv_bfloat16>(q, sc, y, n, st); break;
    case F16: launch_dec<__half>(q, sc, y, n, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
