// Fused paged attention: q-block online-softmax attention straight off the
// paged KV pool, with in-kernel pow-2 dequantization of int8 pages, as two
// launches: a split pass over page spans and a combine pass.
//
// Replaces: repro/kernels/paged_attention.py `_pa_kernel` (launched by
// `paged_attention_kernel`). Same numerics contract: per slot b, query row
// j (position lens[b] + j) computes softmax(q_j . K^T * 1/sqrt(Dh), masked
// to pos <= lens[b] + j) @ V in f32, the scale applied after the dot,
// masked scores set to NEG_INF = -1e30 (not -inf), and the result
// acc / max(l, 1e-30) cast to q's dtype. int8 pages dequantize as
// float(code) * 2^scale[b] (ldexpf, exact for the pool's integer-valued
// scales): the step is a power of two, so it is applied to a dot product
// or a weighted sum of codes after the sum, with the same bits as to each
// term before it. Pages in the model dtype are read as is.
//
// Layouts: q/out (B, S, Hq, Dh); k/v pages (P+1, page, Hkv, Dh) with row P
// the trash page; kscale/vscale (B,) f32; table (B, pps) int32 page ids in
// [0, P]; lens (B,) int32. The query heads of KV head h are the contiguous
// block h*g .. h*g+g-1 (g = Hq/Hkv), so GQA needs no KV expansion: a CTA
// owns all R = S*g query rows of its (slot, KV head), row r = j*g + gi.
//
// Design for Hopper (flash-decoding). The Pallas kernel runs a sequential
// (slot, page) grid and carries m/l/acc in VMEM from one page to the next;
// a CTA per (slot, KV head) walking its pages in series leaves most of the
// 132 SMs idle and pays every page's latency in turn. Here the page walk is
// split across CTAs:
//   1. `pa_split_kernel`, grid B x Hkv x n_split: CTA sp takes pages
//      [sp*pps_split, (sp+1)*pps_split) of its slot, up to the last page
//      the slot needs (the one holding position lens[b] + S - 1); a CTA
//      whose span starts past it exits at once. n_split is fixed on the
//      host from pps (the host never reads lens). The CTA issues every
//      page's K head slice, then every page's V, into shared memory by
//      16-byte cp.async (int8 staged as is, dequantized as read) as two
//      groups, so the V copies land while the scores are computed: all
//      pps_split * page keys of the span (128 at the serving shape) in one
//      round of three __syncthreads. Scores: one thread per (row, key),
//      rows of shared memory padded to an odd number of 16-byte units so
//      the threads' 16-byte reads of consecutive keys are conflict-free;
//      int8 codes widen by a byte permute and one add. Softmax: a warp per
//      row. P @ V: threads own (row, 4 columns) with the span's keys split
//      over kp lanes, the lanes' sums meeting by a fixed xor tree. The
//      partial (m, l, acc) of the span goes to f32 scratch.
//   2. `pa_combine_kernel`, one CTA per (slot, KV head): lens and the
//      spans' m and l in one round of loads into shared memory, then acc in
//      16-byte loads, every span's in flight at once; for each output,
//      M = max_s m_s over the spans the slot needs, L = sum_s e^(m_s - M)
//      l_s, acc = sum_s e^(m_s - M) acc_s in split order, out = acc /
//      max(L, 1e-30). A span where a row has no unmasked key (S > 1, the
//      row's limit before the span) keeps m = -1e30 and l counts its
//      masked keys; its weight e^(-1e30 - M) is exactly 0, so it adds
//      nothing, and its l is never used alone.
// No float atomics and fixed summation orders: two launches give the same
// bits.
//
// Bound on the H100: bytes. A decode step reads each needed page's int8 K
// and V once (2 * page * Hkv * Dh bytes a page) and does ~4*g flops per
// byte, far below the ~295 flops per byte where compute would bind; the
// scratch adds 4 * R * (Dh + 2) bytes per span, written once and read
// once. What stood between the old kernel and that bound was latency (64
// CTAs on 132 SMs, pages in series); now every needed span is a CTA and
// its loads are all in flight at once. The products stay on the FMA pipes
// (no wgmma): at S = 1 to 4 each span is a few thousand FMAs a thread-row.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;

enum DType { F32 = 0, BF16 = 1, F16 = 2 };

// Field order is kernels/paged_attention.py PLAN_FIELDS.
struct Plan {
  int B, S, Hq, Hkv, Dh, page, pps;
  int pps_split, n_split;  // pages per span, spans per slot
  int R;                   // query rows per CTA: S * Hq / Hkv
  int gb;                  // copy granule bytes of a K/V row (16 or 4)
  int pitch;               // shared-memory bytes between K (V) rows
  int kp;                  // lanes sharing a (row, column quad) in P @ V
  int qs_off, ps_off;      // byte offsets of Qs and Ps in shared memory
  int smem;                // dynamic shared-memory bytes
  int grid;                // split CTAs: B * Hkv * n_split
};
constexpr int kPlanFields = 17;
static_assert(sizeof(Plan) == kPlanFields * sizeof(int), "Plan is 17 int32");

__device__ __forceinline__ float pow2_step(float s) {
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

// Four bytes of a word as KV values widened to f32 (int8 by a byte permute
// into 2^23 + (code + 128) and one exact subtraction), or the word's
// 16-bit / 32-bit values (4 bytes: 2 or 1 of them).
template <typename KV> struct Widen;
template <> struct Widen<int8_t> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void run(uint32_t w, float* v) {
    const uint32_t x = w ^ 0x80808080u;
    v[0] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540)) - 8388736.f;
    v[1] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7541)) - 8388736.f;
    v[2] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7542)) - 8388736.f;
    v[3] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7543)) - 8388736.f;
  }
};
template <> struct Widen<__nv_bfloat16> {
  static constexpr int N = 2;
  __device__ __forceinline__ static void run(uint32_t w, float* v) {
    v[0] = __uint_as_float(w << 16);
    v[1] = __uint_as_float(w & 0xffff0000u);
  }
};
template <> struct Widen<__half> {
  static constexpr int N = 2;
  __device__ __forceinline__ static void run(uint32_t w, float* v) {
    __half2 h;
    memcpy(&h, &w, 4);
    const float2 f = __half22float2(h);
    v[0] = f.x;
    v[1] = f.y;
  }
};
template <> struct Widen<float> {
  static constexpr int N = 1;
  __device__ __forceinline__ static void run(uint32_t w, float* v) { v[0] = __uint_as_float(w); }
};

// NW 32-bit words from 4*NW-aligned shared memory, in one load.
template <int NW>
__device__ __forceinline__ void load_words(const unsigned char* p, uint32_t* w) {
  if constexpr (NW == 4) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
  } else if constexpr (NW == 2) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    w[0] = x.x; w[1] = x.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

// N consecutive f32 from N*4-aligned shared memory, in one load.
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float* v) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  } else {
    v[0] = *p;
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int GB>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (GB == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "n"(GB)
                 : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The span's pages of one K or V head slice into rows of `pitch` bytes:
// granule f of the span is (row f / gpr, granule f % gpr), row = page *
// page_size + token.
template <int GB>
__device__ __forceinline__ void stage(unsigned char* dst, const unsigned char* src,
                                      const int* pages, int np, int page, int row_bytes,
                                      long long tok_bytes, int h_off, int pitch) {
  const int gpr = row_bytes / GB, total = np * page * gpr;
  for (int f = threadIdx.x; f < total; f += kThreads) {
    const int row = f / gpr, gi = f - row * gpr;
    const int p = row / page, t = row - p * page;
    const unsigned char* s =
        src + ((long long)__ldg(pages + p) * page + t) * tok_bytes + h_off + gi * GB;
    cp_async<GB>(dst + row * pitch + gi * GB, s);
  }
}

// T: q/out dtype. KV: page storage (int8_t codes, or T itself). GB: copy
// granule bytes of a K/V row (16 when Dh * sizeof(KV) and the pages allow).
template <typename T, typename KV, int GB>
__global__ void __launch_bounds__(kThreads)
pa_split_kernel(const T* __restrict__ q, const KV* __restrict__ kd, const KV* __restrict__ vd,
                const float* __restrict__ ks, const float* __restrict__ vs,
                const int* __restrict__ table, const int* __restrict__ lens,
                float* __restrict__ m_out, float* __restrict__ l_out,
                float* __restrict__ acc_out, Plan p, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int sp = blockIdx.x % p.n_split, bh = blockIdx.x / p.n_split;
  const int b = bh / p.Hkv, h = bh - b * p.Hkv;
  const int len = __ldg(lens + b);
  int n_pages = (len + p.S - 1) / p.page + 1;  // pages holding a position <= len + S - 1
  if (n_pages > p.pps) n_pages = p.pps;
  const int p0 = sp * p.pps_split;
  if (p0 >= n_pages) return;  // the slot needs nothing of this span
  const int np = min(p.pps_split, n_pages - p0), nk = np * p.page;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = p.Hq / p.Hkv, R = p.R, Dh = p.Dh;
  const int KS = p.pps_split * p.page;  // key capacity of a span

  unsigned char* Ks = smem;
  unsigned char* Vs = smem + KS * p.pitch;
  float* Qs = reinterpret_cast<float*>(smem + p.qs_off);  // (R, Dh)
  float* Ps = reinterpret_cast<float*>(smem + p.ps_off);  // (R, KS)

  // K then V of the span's pages, two cp.async groups
  const int* pages = table + (long long)b * p.pps + p0;
  const int row_bytes = Dh * (int)sizeof(KV);
  const long long tok_bytes = (long long)p.Hkv * row_bytes;
  stage<GB>(Ks, reinterpret_cast<const unsigned char*>(kd), pages, np, p.page, row_bytes,
            tok_bytes, h * row_bytes, p.pitch);
  cp_commit();
  stage<GB>(Vs, reinterpret_cast<const unsigned char*>(vd), pages, np, p.page, row_bytes,
            tok_bytes, h * row_bytes, p.pitch);
  cp_commit();

  for (int e = tid; e < R * Dh; e += kThreads) {
    const int r = e / Dh, d = e - r * Dh, j = r / g, gi = r - j * g;
    Qs[e] = to_f32(q[(((long long)b * p.S + j) * p.Hq + h * g + gi) * Dh + d]);
  }
  const bool quant = sizeof(KV) == 1;
  const float kstep = quant ? pow2_step(__ldg(ks + b)) : 1.f;
  const float vstep = quant ? pow2_step(__ldg(vs + b)) : 1.f;
  cp_wait<1>();  // K has landed; V may still be in flight
  __syncthreads();

  // scores: one thread per (row, key), keys fastest
  const int base = p0 * p.page;
  for (int pr = tid; pr < R * nk; pr += kThreads) {
    const int r = pr / nk, t = pr - r * nk;
    const float* qr = Qs + r * Dh;
    const unsigned char* kr = Ks + t * p.pitch;
    constexpr int N = Widen<KV>::N;  // values per 32-bit word
    float sum[4] = {0.f, 0.f, 0.f, 0.f};  // four chains, fixed by the column
    for (int u = 0; u < row_bytes; u += GB) {
      uint32_t w[GB / 4];
      load_words<GB / 4>(kr + u, w);
      const float* qd = qr + u / (int)sizeof(KV);
#pragma unroll
      for (int i = 0; i < GB / 4; ++i) {
        float kv[N], qv[N];
        Widen<KV>::run(w[i], kv);
        load_f32<N>(qd + i * N, qv);
#pragma unroll
        for (int e = 0; e < N; ++e) sum[(i * N + e) & 3] = fmaf(qv[e], kv[e], sum[(i * N + e) & 3]);
      }
    }
    const float dot = (sum[0] + sum[1]) + (sum[2] + sum[3]);
    Ps[r * KS + t] = (base + t <= len + r / g) ? dot * kstep * scale : NEG_INF;
  }
  __syncthreads();

  // softmax over the span: one warp per row
  float* mo = m_out + ((long long)bh * p.n_split + sp) * R;
  float* lo = l_out + ((long long)bh * p.n_split + sp) * R;
  for (int r = warp; r < R; r += kWarps) {
    float* pr = Ps + r * KS;
    float mx = NEG_INF;
    for (int t = lane; t < nk; t += 32) mx = fmaxf(mx, pr[t]);
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int t = lane; t < nk; t += 32) {
      const float e = expf(pr[t] - mx);
      pr[t] = e;
      sum += e;
    }
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      mo[r] = mx;
      lo[r] = sum;
    }
  }
  cp_wait<0>();  // V has landed
  __syncthreads();

  // P @ V: lanes k = tid % kp share (row, column quad), taking keys k,
  // k + kp, ...; their sums meet by a fixed xor tree
  const int kp = p.kp, nq = Dh / 4, items = R * nq, per_pass = kThreads / kp;
  const int k = tid % kp;
  float* ao = acc_out + ((long long)bh * p.n_split + sp) * R * Dh;
  for (int i0 = 0; i0 < items; i0 += per_pass) {
    const int item = i0 + tid / kp;
    const bool on = item < items;
    const int r = on ? item / nq : 0, cq = on ? item - r * nq : 0;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    if (on) {
      const float* pr = Ps + r * KS;
      for (int t = k; t < nk; t += kp) {
        const float w = pr[t];
        constexpr int N = Widen<KV>::N, NW = 4 / N;
        uint32_t words[NW];
        load_words<NW>(Vs + t * p.pitch + cq * 4 * (int)sizeof(KV), words);
        float v[4];
#pragma unroll
        for (int i = 0; i < NW; ++i) Widen<KV>::run(words[i], v + i * N);
#pragma unroll
        for (int c = 0; c < 4; ++c) a[c] = fmaf(w, v[c], a[c]);
      }
    }
    for (int o = 1; o < kp; o <<= 1)
#pragma unroll
      for (int c = 0; c < 4; ++c) a[c] += __shfl_xor_sync(0xffffffffu, a[c], o);
    if (on && k == 0)
      *reinterpret_cast<float4*>(ao + r * Dh + cq * 4) =
          make_float4(a[0] * vstep, a[1] * vstep, a[2] * vstep, a[3] * vstep);
  }
}

// One CTA per (slot, KV head): the spans' partials meet in split order.
// lens and the spans' m and l are one round of loads into shared memory;
// one thread per row forms the weights e^(m_s - M) and L; then one thread
// per (row, column quad) adds its spans' acc with 16-byte loads, batched.
template <typename T>
__global__ void __launch_bounds__(kThreads)
pa_combine_kernel(const float* __restrict__ m_in, const float* __restrict__ l_in,
                  const float* __restrict__ acc_in, const int* __restrict__ lens,
                  T* __restrict__ out, Plan p) {
  extern __shared__ float cs[];  // W (n_split, R) weights, Ls likewise, Lc (R)
  const int bh = blockIdx.x, b = bh / p.Hkv, h = bh - b * p.Hkv;
  const int g = p.Hq / p.Hkv, R = p.R, Dh = p.Dh;
  float* W = cs;
  float* Ls = cs + p.n_split * R;
  float* Lc = Ls + p.n_split * R;
  const float* mb = m_in + (long long)bh * p.n_split * R;
  const float* lb = l_in + (long long)bh * p.n_split * R;
  const float* ab = acc_in + (long long)bh * p.n_split * R * Dh;
  // one round of loads: lens and every span's m and l (the spans the slot
  // does not need hold anything; only the first ns are used)
  const int len = __ldg(lens + b);
  for (int i = threadIdx.x; i < p.n_split * R; i += kThreads) {
    W[i] = mb[i];
    Ls[i] = lb[i];
  }
  int n_pages = (len + p.S - 1) / p.page + 1;
  if (n_pages > p.pps) n_pages = p.pps;
  const int ns = (n_pages + p.pps_split - 1) / p.pps_split;  // spans the slot needs
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += kThreads) {
    float M = NEG_INF;
    for (int s = 0; s < ns; ++s) M = fmaxf(M, W[s * R + r]);
    float L = 0.f;
    for (int s = 0; s < ns; ++s) {
      const float w = expf(W[s * R + r] - M);
      W[s * R + r] = w;
      L = fmaf(w, Ls[s * R + r], L);
    }
    Lc[r] = fmaxf(L, 1e-30f);
  }
  __syncthreads();
  // one thread per (row, column quad): 16-byte loads of each span's acc
  const int nq = Dh / 4;
  for (int e = threadIdx.x; e < R * nq; e += kThreads) {
    const int r = e / nq, d = (e - r * nq) * 4, j = r / g, gi = r - j * g;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int s = 0; s < ns; ++s) {
      const float w = W[s * R + r];
      const float4 x = __ldg(reinterpret_cast<const float4*>(ab + (s * R + r) * Dh + d));
      acc[0] = fmaf(w, x.x, acc[0]);
      acc[1] = fmaf(w, x.y, acc[1]);
      acc[2] = fmaf(w, x.z, acc[2]);
      acc[3] = fmaf(w, x.w, acc[3]);
    }
    T* o = out + (((long long)b * p.S + j) * p.Hq + h * g + gi) * Dh + d;
    const float lc = Lc[r];
#pragma unroll
    for (int c = 0; c < 4; ++c) o[c] = from_f32<T>(acc[c] / lc);
  }
}

// What both passes rely on: the shapes and the span geometry.
bool shape_ok(const Plan& p) {
  return p.B > 0 && p.S > 0 && p.Hkv > 0 && p.Hq % p.Hkv == 0 && p.Dh > 0 && p.Dh % 4 == 0 &&
         p.page > 0 && p.pps > 0 && p.pps_split > 0 && p.n_split * p.pps_split >= p.pps &&
         p.R == p.S * (p.Hq / p.Hkv);
}

// And the split pass's staging and shared-memory layout.
bool plan_ok(const Plan& p, int kv_size) {
  const int row_bytes = p.Dh * kv_size;
  return shape_ok(p) && (p.gb == 16 || p.gb == 4) && row_bytes % p.gb == 0 &&
         p.pitch % 16 == 0 && p.pitch >= row_bytes && p.kp >= 1 && p.kp <= 32 &&
         (p.kp & (p.kp - 1)) == 0 && p.qs_off >= 2 * p.pps_split * p.page * p.pitch &&
         p.qs_off % 16 == 0 && p.ps_off >= p.qs_off + p.R * p.Dh * 4 && p.ps_off % 16 == 0 &&
         p.smem >= p.ps_off + p.R * p.pps_split * p.page * 4 && p.smem <= kMaxSmem &&
         p.grid == p.B * p.Hkv * p.n_split;
}

template <typename T, typename KV, int GB>
int launch_split(const void* q, const void* kd, const void* vd, const float* ks, const float* vs,
                 const int* table, const int* lens, float* m, float* l, float* acc,
                 const Plan& p, cudaStream_t st) {
  auto kern = pa_split_kernel<T, KV, GB>;
  if (p.smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return (int)e;
  }
  const float scale = (float)(1.0 / sqrt((double)p.Dh));
  kern<<<p.grid, kThreads, p.smem, st>>>((const T*)q, (const KV*)kd, (const KV*)vd, ks, vs,
                                         table, lens, m, l, acc, p, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_split_t(int quantized, int gb, const void* q, const void* kd, const void* vd,
                   const float* ks, const float* vs, const int* table, const int* lens,
                   float* m, float* l, float* acc, const Plan& p, cudaStream_t st) {
  if (quantized)
    return gb == 16 ? launch_split<T, int8_t, 16>(q, kd, vd, ks, vs, table, lens, m, l, acc, p, st)
                    : launch_split<T, int8_t, 4>(q, kd, vd, ks, vs, table, lens, m, l, acc, p, st);
  return gb == 16 ? launch_split<T, T, 16>(q, kd, vd, ks, vs, table, lens, m, l, acc, p, st)
                  : launch_split<T, T, 4>(q, kd, vd, ks, vs, table, lens, m, l, acc, p, st);
}

}  // namespace

extern "C" {

// The split pass. q: (B, S, Hq, Dh) of dtype (0 f32, 1 bf16, 2 f16); k/v
// pages (P+1, page, Hkv, Dh), int8 when quantized else of dtype;
// kscale/vscale (B,) f32; table (B, pps) and lens (B,) int32; m, l:
// (B, Hkv, n_split, R) f32 and acc (B, Hkv, n_split, R, Dh) f32 scratch
// (spans a slot does not need are left unwritten); `plan` is 17 int32
// (kernels/paged_attention.py PLAN_FIELDS). Returns cudaGetLastError().
int paged_attention_split(const void* q, int dtype, const void* kd, const void* vd,
                          int quantized, const void* ks, const void* vs, const void* table,
                          const void* lens, void* m, void* l, void* acc, const int* fields,
                          void* stream) {
  Plan p;
  memcpy(&p, fields, sizeof(Plan));
  const int kv_size = quantized ? 1 : (dtype == F32 ? 4 : 2);
  if (!plan_ok(p, kv_size) || dtype < F32 || dtype > F16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define PA_ARGS quantized, p.gb, q, kd, vd, (const float*)ks, (const float*)vs, \
    (const int*)table, (const int*)lens, (float*)m, (float*)l, (float*)acc, p, st
  switch (dtype) {
    case F32: return launch_split_t<float>(PA_ARGS);
    case BF16: return launch_split_t<__nv_bfloat16>(PA_ARGS);
    default: return launch_split_t<__half>(PA_ARGS);
  }
#undef PA_ARGS
}

// The combine pass: m, l, acc as the split pass left them; out (B, S, Hq,
// Dh) of dtype. Returns cudaGetLastError().
int paged_attention_combine(const void* m, const void* l, const void* acc, const void* lens,
                            void* out, int dtype, const int* fields, void* stream) {
  Plan p;
  memcpy(&p, fields, sizeof(Plan));
  const size_t smem = sizeof(float) * (2 * (size_t)p.n_split * p.R + p.R);
  if (!shape_ok(p) || dtype < F32 || dtype > F16 || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int grid = p.B * p.Hkv;
#define PC_ARGS (const float*)m, (const float*)l, (const float*)acc, (const int*)lens
  switch (dtype) {
    case F32: pa_combine_kernel<float><<<grid, kThreads, smem, st>>>(PC_ARGS, (float*)out, p); break;
    case BF16:
      pa_combine_kernel<__nv_bfloat16><<<grid, kThreads, smem, st>>>(PC_ARGS,
                                                                      (__nv_bfloat16*)out, p);
      break;
    default:
      pa_combine_kernel<__half><<<grid, kThreads, smem, st>>>(PC_ARGS, (__half*)out, p);
      break;
  }
#undef PC_ARGS
  return (int)cudaGetLastError();
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
