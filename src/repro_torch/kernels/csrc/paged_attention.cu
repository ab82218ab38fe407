// Fused paged attention: q-block online-softmax attention straight off the
// paged KV pool, with in-kernel pow-2 dequantization of int8 pages.
//
// Replaces: repro/kernels/paged_attention.py `_pa_kernel` (launched by
// `paged_attention_kernel`). Same numerics contract: per slot b, query row
// j (position lens[b] + j) computes softmax(q_j . K^T * 1/sqrt(Dh), masked
// to pos <= lens[b] + j) @ V in f32, the scale applied after the dot,
// masked scores set to NEG_INF = -1e30 (not -inf), an online softmax over
// pages (m, l, acc), and the result acc / max(l, 1e-30) cast to q's dtype.
// int8 pages dequantize as float(code) * 2^scale[b] (ldexpf, exact for the
// pool's integer-valued scales); pages in the model dtype are read as is.
//
// Layouts: q/out (B, S, Hq, Dh); k/v pages (P+1, page, Hkv, Dh) with row P
// the trash page; kscale/vscale (B,) f32; table (B, pps) int32 page ids in
// [0, P]; lens (B,) int32. The query heads of KV head h are the contiguous
// block h*g .. h*g+g-1 (g = Hq/Hkv), so GQA needs no KV expansion.
//
// Design for Hopper (not the TPU grid): the Pallas kernel runs a sequential
// (slot, page) grid and carries m/l/acc in VMEM from one grid step to the
// next. Here one 256-thread block owns one (slot, KV head) pair and all of
// its S*g query rows, and a loop inside the block walks the slot's pages:
// stage the page's K and V head slice in shared memory (dequantized to
// f32), each warp four (row, key) dot products at a time with shuffle
// reductions, one warp per row for the softmax bookkeeping, and one thread
// per (row, column) for the accumulator, which lives in shared memory. The loop
// bound is the number of pages whose first position is <= lens[b] + S - 1:
// pages above the block's last row are never read (the Pallas kernel
// predicates them out; here they are not iterated at all).
//
// Bound on the H100: bytes. A decode step reads each mapped page's int8 K
// and V once (2 * page * Hkv * Dh bytes per page) and does ~4*g flops per
// byte, far below the ~295 flops per byte where compute would bind. What
// the design does about it: pages are staged with 16-byte loads (an int8
// 16 x 128 slice is one load on each of 128 threads per tensor), and the
// next page's loads are issued into registers before the current page is
// computed, so one page of HBM latency overlaps the math instead of
// stalling each page.
// Known limits, left for a later change: (1) B*Hkv blocks (8*8 = 64 at the
// serving shape) occupy under half of the 132 SMs; splitting the page walk
// across blocks flash-decoding style, with a second combine pass, would
// fill the card. (2) No TMA/cp.async and no wgmma: the lookahead is one
// page deep in registers, and the dot products run on the FMA pipes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum DType { F32 = 0, BF16 = 1, F16 = 2 };

__device__ __forceinline__ float pow2_step(float s) {
  if (s == truncf(s) && fabsf(s) <= 1024.f) return ldexpf(1.f, (int)s);
  return exp2f(s);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

constexpr int kMaxVec = 2;  // 16-byte vectors per thread per tensor and page
constexpr int kPairs = 4;   // (row, key) dot products in flight per warp

// One page's K or V head slice as raw 16-byte vectors, kMaxVec per thread.
struct PageRegs {
  uint4 k[kMaxVec], v[kMaxVec];
};

template <typename KV>
__device__ __forceinline__ void unpack16(const uint4& raw, float step, float* dst) {
  constexpr int E = 16 / sizeof(KV);
  const KV* x = reinterpret_cast<const KV*>(&raw);
#pragma unroll
  for (int k = 0; k < E; k += 4)  // 16-byte stores: 4-way, not 16-way, bank conflicts
    *reinterpret_cast<float4*>(dst + k) =
        make_float4(to_f32(x[k]) * step, to_f32(x[k + 1]) * step, to_f32(x[k + 2]) * step,
                    to_f32(x[k + 3]) * step);
}

// T: q/out dtype. KV: page storage (int8_t codes, or T itself).
// VEC: stage pages with 16-byte loads, the next page's loads in flight
// while the current page is computed (host checks alignment and fit).
template <typename T, typename KV, bool VEC>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const T* __restrict__ q, const KV* __restrict__ kd, const KV* __restrict__ vd,
    const float* __restrict__ ks, const float* __restrict__ vs,
    const int* __restrict__ table, const int* __restrict__ lens, T* __restrict__ out,
    int S, int Hq, int Hkv, int Dh, int page, int pps, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int g = Hq / Hkv, R = S * g;  // query rows of this block: r = j*g + gi
  float* Qs = smem;                   // (R, Dh)
  float* Acc = Qs + R * Dh;           // (R, Dh) running numerator
  float* Ks = Acc + R * Dh;           // (page, Dh) dequantized K slice
  float* Vs = Ks + page * Dh;         // (page, Dh)
  float* Ps = Vs + page * Dh;         // (R, page) scores, then probabilities
  float* Ms = Ps + R * page;          // (R,) running max
  float* Ls = Ms + R;                 // (R,) running denominator
  float* Cs = Ls + R;                 // (R,) this page's correction factor
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int e = tid; e < R * Dh; e += kThreads) {
    const int r = e / Dh, d = e % Dh, j = r / g, gi = r % g;
    Qs[e] = to_f32(q[(((long long)b * S + j) * Hq + h * g + gi) * Dh + d]);
    Acc[e] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    Ms[r] = NEG_INF;
    Ls[r] = 0.f;
  }
  const int len = lens[b];
  const bool quant = sizeof(KV) == 1;
  const float kstep = quant ? pow2_step(ks[b]) : 1.f;
  const float vstep = quant ? pow2_step(vs[b]) : 1.f;
  // pages holding a position <= len + S - 1, the block's last row
  int n_pages = (len + S - 1) / page + 1;
  if (n_pages > pps) n_pages = pps;
  const int* row = table + (long long)b * pps;

  // VEC staging geometry: E elements per 16-byte vector, vpr per token row
  constexpr int E = 16 / sizeof(KV);
  const int vpr = Dh / E, nvec = page * vpr;
  PageRegs regs;
  auto load_page = [&](int p) {
    const long long pg = row[p];
#pragma unroll
    for (int i = 0; i < kMaxVec; ++i) {
      const int v = tid + i * kThreads;
      if (v < nvec) {
        const int t = v / vpr, c = v % vpr;
        const long long off = ((pg * page + t) * Hkv + h) * Dh + c * E;
        regs.k[i] = __ldg(reinterpret_cast<const uint4*>(kd + off));
        regs.v[i] = __ldg(reinterpret_cast<const uint4*>(vd + off));
      }
    }
  };
  if (VEC && n_pages > 0) load_page(0);
  __syncthreads();

  for (int p = 0; p < n_pages; ++p) {
    const int base = p * page;
    if (VEC) {
#pragma unroll
      for (int i = 0; i < kMaxVec; ++i) {
        const int v = tid + i * kThreads;
        if (v < nvec) {
          const int e = (v / vpr) * Dh + (v % vpr) * E;
          unpack16<KV>(regs.k[i], kstep, Ks + e);
          unpack16<KV>(regs.v[i], vstep, Vs + e);
        }
      }
    } else {
      const long long pg = row[p];
      for (int e = tid; e < page * Dh; e += kThreads) {
        const int t = e / Dh, d = e % Dh;
        const long long off = ((pg * page + t) * Hkv + h) * Dh + d;
        Ks[e] = to_f32(kd[off]) * kstep;
        Vs[e] = to_f32(vd[off]) * vstep;
      }
    }
    __syncthreads();
    if (VEC && p + 1 < n_pages) load_page(p + 1);  // lands while we compute

    // scores: each warp takes kPairs (row, key) pairs at a time, lanes split
    // the head dim; the kPairs dot products and shuffle reductions are
    // independent chains, interleaved for instruction-level parallelism
    for (int p0 = warp * kPairs; p0 < R * page; p0 += kWarps * kPairs) {
      int qo[kPairs], ko[kPairs];
      float dot[kPairs];
#pragma unroll
      for (int k = 0; k < kPairs; ++k) {
        const int pair = min(p0 + k, R * page - 1);
        qo[k] = (pair / page) * Dh;
        ko[k] = (pair % page) * Dh;
        dot[k] = 0.f;
      }
      for (int d = lane; d < Dh; d += 32) {
#pragma unroll
        for (int k = 0; k < kPairs; ++k) dot[k] = fmaf(Qs[qo[k] + d], Ks[ko[k] + d], dot[k]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int k = 0; k < kPairs; ++k) dot[k] += __shfl_xor_sync(0xffffffffu, dot[k], o);
      }
#pragma unroll
      for (int k = 0; k < kPairs; ++k) {
        const int pair = p0 + k;
        if (lane == k && pair < R * page) {
          const int r = pair / page, t = pair % page;
          Ps[pair] = (base + t <= len + r / g) ? dot[k] * scale : NEG_INF;
        }
      }
    }
    __syncthreads();

    // online softmax: one warp per row, lanes split the page's keys
    for (int r = warp; r < R; r += kWarps) {
      float* pr = Ps + r * page;
      float mx = NEG_INF;
      for (int t = lane; t < page; t += 32) mx = fmaxf(mx, pr[t]);
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = Ms[r], m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < page; t += 32) {
        const float e = expf(pr[t] - m_new);
        pr[t] = e;
        sum += e;
      }
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        Ls[r] = Ls[r] * corr + sum;
        Ms[r] = m_new;
        Cs[r] = corr;
      }
    }
    __syncthreads();

    // accumulator: one thread per (row, column), four partial sums over
    // the page's keys so the loads are not one dependent chain
    for (int e = tid; e < R * Dh; e += kThreads) {
      const int r = e / Dh, d = e % Dh;
      const float* pr = Ps + r * page;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      int t = 0;
      for (; t + 4 <= page; t += 4) {
        a0 = fmaf(pr[t], Vs[t * Dh + d], a0);
        a1 = fmaf(pr[t + 1], Vs[(t + 1) * Dh + d], a1);
        a2 = fmaf(pr[t + 2], Vs[(t + 2) * Dh + d], a2);
        a3 = fmaf(pr[t + 3], Vs[(t + 3) * Dh + d], a3);
      }
      for (; t < page; ++t) a0 = fmaf(pr[t], Vs[t * Dh + d], a0);
      Acc[e] = Acc[e] * Cs[r] + ((a0 + a1) + (a2 + a3));
    }
    __syncthreads();
  }

  for (int e = tid; e < R * Dh; e += kThreads) {
    const int r = e / Dh, d = e % Dh, j = r / g, gi = r % g;
    out[(((long long)b * S + j) * Hq + h * g + gi) * Dh + d] =
        from_f32<T>(Acc[e] / fmaxf(Ls[r], 1e-30f));
  }
}

template <typename T, typename KV, bool VEC>
int launch_one(const void* q, const void* kd, const void* vd, const float* ks,
               const float* vs, const int* table, const int* lens, void* out, int B, int S,
               int Hq, int Hkv, int Dh, int page, int pps, size_t smem, cudaStream_t st) {
  auto kern = paged_attention_kernel<T, KV, VEC>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const float scale = (float)(1.0 / sqrt((double)Dh));
  kern<<<B * Hkv, kThreads, smem, st>>>((const T*)q, (const KV*)kd, (const KV*)vd, ks, vs,
                                         table, lens, (T*)out, S, Hq, Hkv, Dh, page, pps, scale);
  return (int)cudaGetLastError();
}

template <typename T, typename KV>
int launch(const void* q, const void* kd, const void* vd, const float* ks, const float* vs,
           const int* table, const int* lens, void* out, int B, int S, int Hq, int Hkv, int Dh,
           int page, int pps, cudaStream_t st) {
  const int R = S * (Hq / Hkv);
  const size_t smem = sizeof(float) * ((size_t)2 * R * Dh + (size_t)2 * page * Dh +
                                       (size_t)R * page + 3 * (size_t)R);
  // 16-byte staging needs whole vectors per token row, 16-byte aligned
  // page rows, and a page slice that fits kMaxVec vectors per thread
  const int E = 16 / (int)sizeof(KV);
  const bool vec = Dh % E == 0 && ((uintptr_t)kd % 16) == 0 && ((uintptr_t)vd % 16) == 0 &&
                   (long long)page * (Dh / E) <= (long long)kMaxVec * kThreads;
  return vec ? launch_one<T, KV, true>(q, kd, vd, ks, vs, table, lens, out, B, S, Hq, Hkv, Dh,
                                       page, pps, smem, st)
             : launch_one<T, KV, false>(q, kd, vd, ks, vs, table, lens, out, B, S, Hq, Hkv,
                                        Dh, page, pps, smem, st);
}

}  // namespace

extern "C" {

// q/out: (B, S, Hq, Dh) of dtype; k/v pages: (P+1, page, Hkv, Dh), int8
// when quantized else of dtype; kscale/vscale (B,) f32; table (B, pps) and
// lens (B,) int32. Returns cudaGetLastError() after the launch.
int paged_attention(const void* q, int dtype, const void* kd, const void* vd, int quantized,
                    const void* ks, const void* vs, const void* table, const void* lens,
                    void* out, int B, int S, int Hq, int Hkv, int Dh, int page, int pps,
                    void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Dh <= 0 || page <= 0 || pps <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* fks = (const float*)ks;
  const float* fvs = (const float*)vs;
  const int* tab = (const int*)table;
  const int* ln = (const int*)lens;
#define PA_ARGS q, kd, vd, fks, fvs, tab, ln, out, B, S, Hq, Hkv, Dh, page, pps, st
  switch (dtype) {
    case F32:
      return quantized ? launch<float, int8_t>(PA_ARGS) : launch<float, float>(PA_ARGS);
    case BF16:
      return quantized ? launch<__nv_bfloat16, int8_t>(PA_ARGS)
                       : launch<__nv_bfloat16, __nv_bfloat16>(PA_ARGS);
    case F16:
      return quantized ? launch<__half, int8_t>(PA_ARGS) : launch<__half, __half>(PA_ARGS);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PA_ARGS
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
