// Blockwise absmax int8 codec: per-block f32 scale along the last axis of a
// contiguous (rows, last) f32 view, codes padded to nb * b per row.
//
// Replaces: repro/numerics/pallas_backend.py `_bw_enc_kernel` and
// `_bw_dec_kernel` (launched by `BlockwisePallas.encode` / `.decode`). On the
// training path these are the Adam moments (`optim/adam.py`, block 256: each
// of the 17 moment leaves decoded before the update and encoded after it, m
// and v) and the gradient wire (`optim/grad_compress.py`, block 1024: every
// floating gradient leaf flattened and round-tripped), 55 encodes and 55
// decodes a step.
//
// Geometry (`codecs.blockwise_geometry`): b = min(block, max(1, last)),
// nb = ceil(last / b); elements past `last` in the last block are zero pads,
// and their codes are written as 0.
//
// Numerics (bit-identical to BlockwiseReference on finite inputs):
//   sc = max|x| / qmax                      IEEE f32 division
//   q  = int8(clip(rint(x / max(sc, 1e-20)), -qmax, qmax))
//   y  = float(q) * sc                       decode
// An all-zero block gives sc = 0 and codes 0. The build has no
// --use_fast_math, so `/` is the correctly rounded division (not a reciprocal
// multiply) and rintf rounds half to even, as jnp.round does. NaN is outside
// the lock: fmaxf drops a NaN operand, jnp.max keeps it.
//
// Bound on the H100: bytes (4 in, 1 + 4/b out per element, a handful of
// operations each) — and at the step's sizes (a few thousand elements a
// leaf) launch latency, far above either bound.
// Design: the mapping follows b. For b <= 32 one thread owns a block (the
// step's moment blocks are 1 or 16 wide, and a warp per block would leave
// most lanes idle); for b > 32 one warp owns a block, each lane strides over
// it, and the absmax is a shuffle reduction. Both walk the blocks with a
// grid-stride loop. Decode is one thread per output element (pads are never
// read back). No shared memory, no synchronisation beyond the warp shuffle.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kScaleFloor = 1e-20f;

__device__ __forceinline__ int8_t bw_code(float v, float d, float qmax) {
  return (int8_t)(int)fminf(fmaxf(rintf(v / d), -qmax), qmax);
}

// one thread per (row, block)
__global__ void bw_enc_thread_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                                     float* __restrict__ sc, long long rows, long long last,
                                     long long b, long long nb, float qmax) {
  const long long units = rows * nb;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x; u < units; u += stride) {
    const long long r = u / nb, j = u % nb;
    const float* xr = x + r * last;
    const long long c0 = j * b;
    const long long n = (last - c0) < b ? (last - c0) : b;   // real elements
    float amax = 0.f;
    for (long long t = 0; t < n; ++t) amax = fmaxf(amax, fabsf(xr[c0 + t]));
    const float s = amax / qmax;
    const float d = fmaxf(s, kScaleFloor);
    int8_t* qr = q + r * nb * b + c0;
    for (long long t = 0; t < n; ++t) qr[t] = bw_code(xr[c0 + t], d, qmax);
    for (long long t = n; t < b; ++t) qr[t] = 0;
    sc[u] = s;
  }
}

// one warp per (row, block)
__global__ void bw_enc_warp_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                                   float* __restrict__ sc, long long rows, long long last,
                                   long long b, long long nb, float qmax) {
  const long long units = rows * nb;
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (blockDim.x / 32);
  for (long long u = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32; u < units;
       u += warps) {
    const long long r = u / nb, j = u % nb;
    const float* xr = x + r * last;
    const long long c0 = j * b;
    const long long n = (last - c0) < b ? (last - c0) : b;
    float amax = 0.f;
    for (long long t = lane; t < n; t += 32) amax = fmaxf(amax, fabsf(xr[c0 + t]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float s = amax / qmax;
    const float d = fmaxf(s, kScaleFloor);
    int8_t* qr = q + r * nb * b + c0;
    for (long long t = lane; t < b; t += 32) qr[t] = t < n ? bw_code(xr[c0 + t], d, qmax) : 0;
    if (lane == 0) sc[u] = s;
  }
}

__global__ void bw_dec_kernel(const int8_t* __restrict__ q, const float* __restrict__ sc,
                              float* __restrict__ y, long long rows, long long last,
                              long long b, long long nb) {
  const long long n = rows * last;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const long long r = i / last, c = i % last;
    y[i] = (float)q[r * nb * b + c] * __ldg(sc + r * nb + c / b);
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

// x: (rows, last) f32; q: (rows, nb * b) int8; sc: (rows, nb) f32.
// qmax = 2^(bits-1) - 1 for bits in [2, 8]. Returns cudaGetLastError().
int bw_enc(const void* x, void* q, void* sc, long long rows, long long last, long long b,
           long long nb, int qmax, void* stream) {
  if (qmax < 1 || qmax > 127 || b < 1 || nb < 1 || nb * b < last || (nb - 1) * b >= last)
    return (int)cudaErrorInvalidValue;
  if (rows * last == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const long long units = rows * nb;
  if (b <= 32)
    bw_enc_thread_kernel<<<grid_for(units), kThreads, 0, st>>>(
        (const float*)x, (int8_t*)q, (float*)sc, rows, last, b, nb, (float)qmax);
  else
    bw_enc_warp_kernel<<<grid_for(units * 32), kThreads, 0, st>>>(
        (const float*)x, (int8_t*)q, (float*)sc, rows, last, b, nb, (float)qmax);
  return (int)cudaGetLastError();
}

// q: (rows, nb * b) int8; sc: (rows, nb) f32; y: (rows, last) f32.
int bw_dec(const void* q, const void* sc, void* y, long long rows, long long last, long long b,
           long long nb, void* stream) {
  if (b < 1 || nb < 1 || nb * b < last || (nb - 1) * b >= last)
    return (int)cudaErrorInvalidValue;
  if (rows * last == 0) return (int)cudaSuccess;
  bw_dec_kernel<<<grid_for(rows * last), kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)q, (const float*)sc, (float*)y, rows, last, b, nb);
  return (int)cudaGetLastError();
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
