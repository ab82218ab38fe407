// What the codec kernels share (pow2_rows.cu, pow2_scalar.cu, blockwise.cu):
// the element types they read and write, the exact pow-2 step, and the code
// types a QuantSpec stores codes in.
//
// Code types (numerics/spec.py STORAGE_DTYPES, int4x2 aside): int8, int16,
// int32, and float32 "codes" (the integer-valued f32 the encode computes,
// stored as is). The C entry points take a storage code beside the data's
// dtype code; `with_code` turns it into the template argument.
//
// Saturation: the encode computes clip(rint(x / 2^s), lo, hi) in f32 and then
// converts to the code type. JAX converts float to int with saturation, and
// a C cast of an out-of-range float is undefined, so `to_code` clamps to the
// type's range first. Where it matters: a 32-bit grid's hi (2^31 - 1) rounds
// to 2^31 in f32 and must store INT32_MAX; a grid wider than its storage
// (16 bits in int8) stores the type's ends, as the reference does.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace pow2_codes {

enum DType { F32 = 0, BF16 = 1, F16 = 2 };
enum Code { I8 = 0, I16 = 1, I32 = 2, CF32 = 3 };

__device__ __forceinline__ float pow2_step(float s) {
  // exact 2^s for integer-valued s; the range guard keeps (int)s defined
  if (s == truncf(s) && fabsf(s) <= 1024.f) return ldexpf(1.f, (int)s);
  return exp2f(s);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
// codes: (float) of an int32 rounds to nearest, as JAX's astype does
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }
__device__ __forceinline__ float to_f32(int16_t v) { return (float)v; }
__device__ __forceinline__ float to_f32(int32_t v) { return (float)v; }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// An integer-valued f32 as a code of type Q, saturated to Q's range.
template <typename Q> __device__ __forceinline__ Q to_code(float v);
template <> __device__ __forceinline__ float to_code<float>(float v) { return v; }
template <> __device__ __forceinline__ int8_t to_code<int8_t>(float v) {
  return (int8_t)(int)fminf(fmaxf(v, -128.f), 127.f);
}
template <> __device__ __forceinline__ int16_t to_code<int16_t>(float v) {
  return (int16_t)(int)fminf(fmaxf(v, -32768.f), 32767.f);
}
template <> __device__ __forceinline__ int32_t to_code<int32_t>(float v) {
  // +-2^31 are exact in f32; everything strictly between converts exactly
  if (v >= 2147483648.f) return 2147483647;
  if (v <= -2147483648.f) return (int32_t)(-2147483647 - 1);
  return (int32_t)v;
}

// aligned bundle of 4 elements (16 bytes for 4-byte types, 8 for 2, 4 for 1)
template <typename T> struct alignas(4 * sizeof(T)) Vec4 { T v[4]; };

// The qrange of a `bits`-bit grid as f32, as the reference's clip sees it:
// -2^(bits-1) and 2^(bits-1) - 1 rounded to f32 (2^31 at 32 bits).
inline void qrange_f32(int bits, float* lo, float* hi) {
  const double h = ldexp(1.0, bits - 1);
  *lo = (float)-h;
  *hi = (float)(h - 1.0);
}

// The largest grid a code type holds: bits in [2, code_bits(code)].
inline int code_bits(int code) {
  switch (code) {
    case I8: return 8;
    case I16: return 16;
    case I32: case CF32: return 32;
    default: return 0;
  }
}

// Call f(Q{}) with Q the code type of `code`; cudaErrorInvalidValue for an
// unknown code, else cudaGetLastError() after f's launch.
template <typename F>
int with_code(int code, F&& f) {
  switch (code) {
    case I8: f(int8_t{}); break;
    case I16: f(int16_t{}); break;
    case I32: f(int32_t{}); break;
    case CF32: f(float{}); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

inline bool aligned(const void* p, size_t a) { return ((uintptr_t)p % a) == 0; }

}  // namespace pow2_codes
