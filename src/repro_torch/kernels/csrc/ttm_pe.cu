// The strided fp32 FMA product PE1-PE3 first used, kept as a yardstick only: it
// is on no path. PE1, PE2 and PE3 each have a kernel of their own
// (ttm_pe1.cu, ttm_pe2.cu, ttm_pe3.cu); chip_smoke.py launches this one
// with the strides their wrappers once gave it and reports its time as
// each PE row's `previous_ms`. It computes
//
//   a batched product C[z][m][n] = sum_k A[z][m][k] B[z][k][n] over arbitrary
//   element strides, with the contraction index split in two (k = k1 * K2 +
//   k2) so that PE1's (b, c) pair needs no re-layout of G:
//     PE1: z = -, m = a, n = d, (k1, k2) = (b, c)
//
// with the FPGA PE's optional requantize-on-writeback epilogue
// (clip(rintf(acc / 2^s), lo, hi) * 2^s, as Pow2Reference.epilogue).
//
// Numerics: inputs f32 or bf16, products accumulated in f32 with FMA on the
// CUDA cores (no tensor cores, so no TF32), k in increasing order, one
// thread per output element in its tile. Out-of-range rows, columns and k
// are masked with bounds checks (zeros in shared memory), never padded in
// device memory.
//
// Design: 64 x 64 output tiles, 256 threads each computing a 4 x 4 strided
// sub-tile, K staged through shared memory 16 at a time; loads walk
// whichever of (row, k) is unit stride. Grid-stride loops over row tiles
// and batch cover any shape. The split index is divided in 64 bits per
// staged element and nothing is pipelined: what the kernels that replaced
// it avoid.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

namespace {

enum DType { F32 = 0, BF16 = 1 };

constexpr int BM = 64, BN = 64, BK = 16, TX = 16, TY = 16;
constexpr int kThreads = TX * TY;

struct Geom {
  long long batch, M, N, K1, K2;
  long long a_z, a_m, a_k1, a_k2;  // element strides of A
  long long b_z, b_n, b_k1, b_k2;  // element strides of B
  long long c_z, c_m, c_n;         // element strides of C
};
constexpr int kGeomFields = 16;
static_assert(sizeof(Geom) == kGeomFields * sizeof(long long), "Geom is 16 int64");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float pow2_step(float s) {
  if (s == truncf(s) && fabsf(s) <= 1024.f) return ldexpf(1.f, (int)s);
  return exp2f(s);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pe_gemm_kernel(const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ C, Geom g,
               int epilogue, const float* __restrict__ step, float lo, float hi) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX, tid = threadIdx.x;
  const long long K = g.K1 * g.K2;
  const long long n0 = (long long)blockIdx.x * BN;
  // A row-tile loads walk m when it is unit stride, else k; B walks n or k
  const bool a_m_fast = g.a_m == 1, b_n_fast = g.b_n == 1;
  const float scale = epilogue ? pow2_step(__ldg(step)) : 1.f;

  for (long long z = blockIdx.z; z < g.batch; z += gridDim.z) {
    const T* Az = A + z * g.a_z;
    const T* Bz = B + z * g.b_z;
    T* Cz = C + z * g.c_z;
    for (long long m0 = (long long)blockIdx.y * BM; m0 < g.M; m0 += (long long)gridDim.y * BM) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

      for (long long k0 = 0; k0 < K; k0 += BK) {
        for (int l = tid; l < BM * BK; l += kThreads) {
          const int mm = a_m_fast ? l % BM : l / BK;
          const int kk = a_m_fast ? l / BM : l % BK;
          const long long m = m0 + mm, k = k0 + kk;
          float v = 0.f;
          if (m < g.M && k < K)
            v = to_f32(Az[m * g.a_m + (k / g.K2) * g.a_k1 + (k % g.K2) * g.a_k2]);
          As[kk][mm] = v;
        }
        for (int l = tid; l < BN * BK; l += kThreads) {
          const int nn = b_n_fast ? l % BN : l / BK;
          const int kk = b_n_fast ? l / BN : l % BK;
          const long long n = n0 + nn, k = k0 + kk;
          float v = 0.f;
          if (n < g.N && k < K)
            v = to_f32(Bz[n * g.b_n + (k / g.K2) * g.b_k1 + (k % g.K2) * g.b_k2]);
          Bs[kk][nn] = v;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
          float a[4], b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + TY * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + TX * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long m = m0 + ty + TY * i;
        if (m >= g.M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const long long n = n0 + tx + TX * j;
          if (n >= g.N) continue;
          float v = acc[i][j];
          if (epilogue) {
            float q = rintf(v / scale);
            q = q < lo ? lo : (q > hi ? hi : q);
            v = q * scale;
          }
          Cz[m * g.c_m + n * g.c_n] = from_f32<T>(v);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// A, B, C: device pointers of dtype (0 f32, 1 bf16) laid out by the
// strides in `geom` (16 int64: batch, M, N, K1, K2, a_z, a_m, a_k1, a_k2,
// b_z, b_n, b_k1, b_k2, c_z, c_m, c_n). epilogue != 0 requantizes to the
// `bits`-bit pow-2 grid at the f32 scale_log2 `step` (a device pointer).
// Returns cudaGetLastError() after the launch.
int pe_gemm(const void* A, const void* B, void* C, int dtype, const long long* geom,
            int epilogue, const void* step, int bits, void* stream) {
  Geom g;
  memcpy(&g, geom, sizeof(Geom));
  if (g.batch == 0 || g.M == 0 || g.N == 0) return (int)cudaSuccess;
  if (epilogue && (bits < 2 || bits > 16 || step == nullptr)) return (int)cudaErrorInvalidValue;
  const float lo = epilogue ? -(float)(1 << (bits - 1)) : 0.f;
  const float hi = epilogue ? (float)((1 << (bits - 1)) - 1) : 0.f;
  long long gy = (g.M + BM - 1) / BM, gz = g.batch;
  if (gy > 65535) gy = 65535;
  if (gz > 65535) gz = 65535;
  const long long gx = (g.N + BN - 1) / BN;
  if (gx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)gz);
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case F32:
      pe_gemm_kernel<float><<<grid, kThreads, 0, st>>>((const float*)A, (const float*)B,
                                                        (float*)C, g, epilogue,
                                                        (const float*)step, lo, hi);
      break;
    case BF16:
      pe_gemm_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
          (const __nv_bfloat16*)A, (const __nv_bfloat16*)B, (__nv_bfloat16*)C, g, epilogue,
          (const float*)step, lo, hi);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
