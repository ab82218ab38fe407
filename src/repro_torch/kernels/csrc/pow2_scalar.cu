// Scalar-scale pow-2 codec: encode and decode of a whole tensor under one f32
// scale_log2, read on the device, codes in any storage type of the spec
// (int8, int16, int32 or float32; pow2_codes.cuh).
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
//   encode  q = Q(clamp(rint(x / 2^s), lo, hi))      rint: half-to-even,
//                                                       Q saturating
//   decode  y = T(float(q) * 2^s)                      round-to-nearest cast
// 2^s is formed with ldexpf(1, s), exact for the integer-valued scales the
// pool uses (codecs.per_tensor_max_scale_log2 takes a ceil); a fractional s
// falls back to exp2f. Division by a power of two is exact (or correctly
// rounded into the subnormals), so x / 2^s == x * 2^-s here. The build has
// no --use_fast_math: division, rintf and exp2f keep their IEEE meaning.
//
// Bound on the H100: bytes. Each element is read once and written once
// (encode: 4 or 2 bytes in, 1-4 out; decode: 1-4 in, 4 or 2 out) with one
// divide and one round. At the chunk step's full width an encode of
// (128, 8, 128) bf16 moves 393 KB (0.12 us at 3.35 TB/s) and a decode of
// (1, 1024, 8, 128) into bf16 3.1 MB (0.94 us): both sit far below the
// ~5 us a launch costs, so the design keeps the launch lean.
// Design: the step is read once per thread from the device pointer (the
// slot's scale lives on the card, so the host never syncs for it) and
// formed once; a flat grid-stride loop over 4-element vectors (16/8-byte
// loads of the float side, 4/8/16-byte words of codes) with no per-vector index
// arithmetic beyond the stride, then a scalar tail for n % 4 elements.
// The chunk write's K/V is a slice of the projection, so the wrapper makes
// it contiguous and the launcher checks alignment: an unaligned pointer
// takes the scalar loop for the whole tensor. No shared memory, no
// synchronisation.

#include "pow2_codes.cuh"

namespace {

using namespace pow2_codes;

template <typename T, typename Q, bool VEC>
__global__ void p2_enc_kernel(const T* __restrict__ x, const float* __restrict__ s,
                              Q* __restrict__ q, long long n, float lo, float hi) {
  const float step = pow2_step(__ldg(s));
  auto enc = [step, lo, hi](float v) { return to_code<Q>(fminf(fmaxf(rintf(v / step), lo), hi)); };
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long tail = 0;
  if (VEC) {
    const long long nv = n / 4;
    for (long long i = first; i < nv; i += stride) {
      const Vec4<T> in = reinterpret_cast<const Vec4<T>*>(x)[i];
      Vec4<Q> out;
#pragma unroll
      for (int k = 0; k < 4; ++k) out.v[k] = enc(to_f32(in.v[k]));
      reinterpret_cast<Vec4<Q>*>(q)[i] = out;
    }
    tail = nv * 4;
  }
  for (long long i = tail + first; i < n; i += stride) q[i] = enc(to_f32(x[i]));
}

template <typename Q, typename T, bool VEC>
__global__ void p2_dec_kernel(const Q* __restrict__ q, const float* __restrict__ s,
                              T* __restrict__ y, long long n) {
  const float step = pow2_step(__ldg(s));
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long tail = 0;
  if (VEC) {
    const long long nv = n / 4;
    for (long long i = first; i < nv; i += stride) {
      const Vec4<Q> in = reinterpret_cast<const Vec4<Q>*>(q)[i];
      Vec4<T> out;
#pragma unroll
      for (int k = 0; k < 4; ++k) out.v[k] = from_f32<T>(to_f32(in.v[k]) * step);
      reinterpret_cast<Vec4<T>*>(y)[i] = out;
    }
    tail = nv * 4;
  }
  for (long long i = tail + first; i < n; i += stride) y[i] = from_f32<T>(to_f32(q[i]) * step);
}

constexpr int kThreads = 256;

inline int grid_for(long long work) {
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = 132LL * 32;  // enough resident blocks for every SM
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : (int)blocks;
}

template <typename T, typename Q>
void launch_enc(const void* x, const float* s, void* q, long long n, float lo, float hi,
                cudaStream_t st) {
  if (n >= 4 && aligned(x, 4 * sizeof(T)) && aligned(q, 4 * sizeof(Q)))
    p2_enc_kernel<T, Q, true><<<grid_for(n / 4), kThreads, 0, st>>>((const T*)x, s, (Q*)q, n,
                                                                    lo, hi);
  else
    p2_enc_kernel<T, Q, false><<<grid_for(n), kThreads, 0, st>>>((const T*)x, s, (Q*)q, n, lo,
                                                                 hi);
}

template <typename Q, typename T>
void launch_dec(const void* q, const float* s, void* y, long long n, cudaStream_t st) {
  if (n >= 4 && aligned(q, 4 * sizeof(Q)) && aligned(y, 4 * sizeof(T)))
    p2_dec_kernel<Q, T, true><<<grid_for(n / 4), kThreads, 0, st>>>((const Q*)q, s, (T*)y, n);
  else
    p2_dec_kernel<Q, T, false><<<grid_for(n), kThreads, 0, st>>>((const Q*)q, s, (T*)y, n);
}

}  // namespace

extern "C" {

// x: n contiguous elements of x_dtype (0 f32, 1 bf16, 2 f16), s: one f32
// scale_log2 on the device, q: n codes of q_code (0 int8, 1 int16, 2 int32,
// 3 f32). bits in [2, code_bits(q_code)]. Returns cudaGetLastError() after
// the launch.
int p2_enc(const void* x, int x_dtype, const void* s, void* q, int q_code, long long n, int bits,
           void* stream) {
  if (bits < 2 || bits > code_bits(q_code) || x_dtype < F32 || x_dtype > F16)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  float lo, hi;
  qrange_f32(bits, &lo, &hi);
  cudaStream_t st = (cudaStream_t)stream;
  const float* sc = (const float*)s;
  return with_code(q_code, [&](auto qt) {
    using Q = decltype(qt);
    switch (x_dtype) {
      case F32: launch_enc<float, Q>(x, sc, q, n, lo, hi, st); break;
      case BF16: launch_enc<__nv_bfloat16, Q>(x, sc, q, n, lo, hi, st); break;
      case F16: launch_enc<__half, Q>(x, sc, q, n, lo, hi, st); break;
    }
  });
}

// q: n contiguous codes of q_code, s: one f32 scale_log2 on the device, y:
// n of y_dtype.
int p2_dec(const void* q, int q_code, const void* s, void* y, int y_dtype, long long n,
           void* stream) {
  if (code_bits(q_code) == 0 || y_dtype < F32 || y_dtype > F16) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const float* sc = (const float*)s;
  return with_code(q_code, [&](auto qt) {
    using Q = decltype(qt);
    switch (y_dtype) {
      case F32: launch_dec<Q, float>(q, sc, y, n, st); break;
      case BF16: launch_dec<Q, __nv_bfloat16>(q, sc, y, n, st); break;
      case F16: launch_dec<Q, __half>(q, sc, y, n, st); break;
    }
  });
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
