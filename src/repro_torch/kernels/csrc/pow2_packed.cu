// Packed int4x2 pow-2 codec: two 4-bit codes a byte along the trailing axis
// of a contiguous (rows, last) view, one f32 scale_log2 per row (or one for
// every row: s_stride 0).
//
// Replaces: repro/numerics/pallas_backend.py `_p2_enc_packed_kernel`,
// `_p2_enc_packed_rows_kernel` (scalar and per-row step, `_encode_packed`)
// and `_p2_dec_packed_kernel`, `_p2_dec_packed_rows_kernel`
// (`_decode_packed`), all launched through `_packed_call`. On the training
// path these are the TT-factor deploy export (`ckpt.export_tt_deploy`: each
// core flattened to one row of 448..4,096 elements at its fixed
// `wscale_log2`) and its load (`ckpt.load_tt_deploy`).
//
// Numerics (bit-identical to Pow2Reference with storage "int4x2"):
//   encode  q = clamp(rint(x / 2^s), lo, hi)              lo, hi = qrange(bits)
//           byte j = (q[2j] & 0xF) | (q[2j+1] & 0xF) << 4  the low nibble is the
//           even index; an odd `last` pads the last byte's high nibble with 0
//   decode  q = sign-extended nibble, y = float(q) * 2^s   pad nibble dropped
// 2^s is formed with ldexpf for integer-valued s (exact; the export's steps
// are integers), exp2f otherwise. No --use_fast_math: `/`, rintf and exp2f
// keep their IEEE meaning.
//
// Bound on the H100: bytes (encode: 4 in, 0.5 out per element; decode: 0.5
// in, 4 out), and at the export's sizes launch latency.
// Design: one thread per packed byte in a grid-stride loop; a byte's two
// codes lie in one row because the view keeps the logical trailing dim
// (`cuda_backend._rowwise_lastdim`), so a pair never straddles rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float pow2_step(float s) {
  // exact 2^s for integer-valued s; the range guard keeps (int)s defined
  if (s == truncf(s) && fabsf(s) <= 1024.f) return ldexpf(1.f, (int)s);
  return exp2f(s);
}

__device__ __forceinline__ int nibble(float x, float step, float lo, float hi) {
  return ((int)fminf(fmaxf(rintf(x / step), lo), hi)) & 0xF;
}

__global__ void p2_enc_packed_kernel(const float* __restrict__ x, const float* __restrict__ s,
                                     long long s_stride, int8_t* __restrict__ out,
                                     long long rows, long long last, float lo, float hi) {
  const long long pk = (last + 1) / 2;
  const long long n = rows * pk;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const long long r = i / pk, j = i % pk;
    const float step = pow2_step(__ldg(s + r * s_stride));
    const float* xr = x + r * last;
    const int q0 = nibble(xr[2 * j], step, lo, hi);
    const int q1 = 2 * j + 1 < last ? nibble(xr[2 * j + 1], step, lo, hi) : 0;
    out[i] = (int8_t)(q0 | (q1 << 4));
  }
}

__global__ void p2_dec_packed_kernel(const int8_t* __restrict__ in, const float* __restrict__ s,
                                     long long s_stride, float* __restrict__ y, long long rows,
                                     long long last) {
  const long long pk = (last + 1) / 2;
  const long long n = rows * last;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const long long r = i / last, c = i % last;
    const int v = (int)(uint8_t)in[r * pk + c / 2];
    const int q = ((((c & 1) ? (v >> 4) : v) & 0xF) ^ 8) - 8;   // sign-extend
    y[i] = (float)q * pow2_step(__ldg(s + r * s_stride));
  }
}

inline int grid_for(long long work) {
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = 132LL * 32;  // enough resident blocks for every SM
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : (int)blocks;
}

}  // namespace

extern "C" {

// x: (rows, last) f32; s: f32 scale_log2 at s[r * s_stride] (s_stride 0 or 1);
// out: (rows, ceil(last / 2)) int8. bits in [2, 4]. Returns cudaGetLastError().
int p2_enc_packed(const void* x, const void* s, long long s_stride, void* out, long long rows,
                  long long last, int bits, void* stream) {
  if (bits < 2 || bits > 4 || s_stride < 0 || s_stride > 1) return (int)cudaErrorInvalidValue;
  if (rows * last == 0) return (int)cudaSuccess;
  const float lo = -(float)(1 << (bits - 1)), hi = (float)((1 << (bits - 1)) - 1);
  p2_enc_packed_kernel<<<grid_for(rows * ((last + 1) / 2)), kThreads, 0,
                         (cudaStream_t)stream>>>((const float*)x, (const float*)s, s_stride,
                                                 (int8_t*)out, rows, last, lo, hi);
  return (int)cudaGetLastError();
}

// in: (rows, ceil(last / 2)) int8; s as above; y: (rows, last) f32.
int p2_dec_packed(const void* in, const void* s, long long s_stride, void* y, long long rows,
                  long long last, void* stream) {
  if (s_stride < 0 || s_stride > 1) return (int)cudaErrorInvalidValue;
  if (rows * last == 0) return (int)cudaSuccess;
  p2_dec_packed_kernel<<<grid_for(rows * last), kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)in, (const float*)s, s_stride, (float*)y, rows, last);
  return (int)cudaGetLastError();
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
