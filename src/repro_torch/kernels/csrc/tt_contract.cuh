// The streamed single-index contraction behind PE2 and PE3:
//
//   O(a, d, c) = sum_b  Z(a, b, c) * G(b, d)
//
// PE2 (csrc/ttm_pe2.cu) is this as written; PE3 (csrc/ttm_pe3.cu) is it at
// a = 1 with Z = X (b, i) and G = Ybar (b, j), so O = What (j, i). Each of
// the two sources wraps `contract` in a __global__ kernel of its own name.
//
// Work split (the plan, computed by kernels/tt_contract.py::plan and passed
// in as `Plan`): a CTA owns a run of `spc` slabs Z[a], side by side, and
// one output tile of DT = dg * rd rows of d by CT = cg * 4 columns of c.
// Each thread keeps an rd x 4 register tile of f32 sums over (d, c); along
// a warp the c groups come first, so shared-memory reads of Z are 16-byte
// vectors and stores are coalesced. Where a tile has few outputs (d = 1
// with b = 512, PE3's 16 x 512), `split` neighbouring lanes share it, each
// taking every split-th b row; the shares meet in a fixed order (an xor
// tree of warp shuffles, then warp by warp through shared memory when more
// than 32 share), so two launches on the same inputs give the same bits.
// No float atomics. The plan keeps slabs side by side (as many warps per
// SM as the work gives): measured on the H100, streaming them through
// fewer threads, or wider per-thread tiles, made the FMA loop slower.
//
// Staging: the CTA's Z[slabs, b, c-tile] and G[b, d-tile] land in shared
// memory in their own dtype, copied with cp.async in 16-, 8- or 4-byte
// granules (whatever the rows' length, the tile width and the pointers
// allow; plain loads for 2-byte bf16 granules); ragged edges are
// zero-filled. Where b does not fit one stage it is cut into chunks that
// pass through a ring of up to four slots: every slot's copy is in flight
// before the first FMA, the FMAs on a chunk start as soon as it has landed,
// and a slot is refilled with the next chunk once it is consumed. Under a
// b-split, rows over 16 bytes are padded by 16 so that the shares (rows
// apart) read distinct banks. Values are widened to f32 as they are read;
// sums are f32 FMA on the CUDA cores (no tensor cores, so no TF32), each
// thread walking its b rows in increasing order. All index math is 32-bit
// (the wrappers refuse tensors of 2^31 elements or more); divisions are
// once per thread at the start, none in the copy, FMA or reduction loops.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace tt_contract {

enum DType { F32 = 0, BF16 = 1 };
constexpr int kMaxThreads = 256;
constexpr int kMaxSmem = 232448;  // 227 KB, the most a CTA may ask for
constexpr int kMaxStages = 4;

// Field order is kernels/tt_contract.py PLAN_FIELDS.
struct Plan {
  int a, b, c, d;         // Z (a, b, c), G (b, d), O (a, d, c)
  int rd;                 // d rows per thread: 1, 2 or 4 (the template)
  int cg, dg;             // c groups of 4 and d groups of rd per tile
  int spc, split;         // slabs per CTA, threads sharing a tile over b
  int threads;            // CTA size, a multiple of 32
  int bc, stages;         // b rows per chunk; 1, or ring slots (2..4)
  int gz, gg;             // copy granule bytes of Z and G rows
  int zp, gp;             // shared-memory row pitches of Z and G, elements
  int z_stage, stage;     // bytes of a slot's Z region (16-aligned), slot
  int smem;               // dynamic shared-memory bytes
  int tiles_c, tiles_d;   // output tiles along c and d
  int grid;               // CTAs: slab runs x tiles_d x tiles_c
  int vec_out;            // 1: c % 4 == 0, outputs stored 4 at a time
};
constexpr int kPlanFields = 23;
static_assert(sizeof(Plan) == kPlanFields * sizeof(int), "Plan is 23 int32");

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// N consecutive values from shared memory, widened to f32 (aligned vectors).
template <int N>
__device__ __forceinline__ void load(const float* p, float* v) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  } else {
    v[0] = p[0];
  }
}
template <int N>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(p);
  if constexpr (N == 4) {
    const float2 lo = __bfloat1622float2(h[0]), hi = __bfloat1622float2(h[1]);
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
  } else if constexpr (N == 2) {
    const float2 x = __bfloat1622float2(h[0]);
    v[0] = x.x; v[1] = x.y;
  } else {
    v[0] = __bfloat162float(p[0]);
  }
}

__device__ __forceinline__ void store4(float* o, const float* v, int n, bool vec) {
  if (vec && n >= 4) {
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < n) o[j] = v[j];
  }
}
__device__ __forceinline__ void store4(__nv_bfloat16* o, const float* v, int n, bool vec) {
  if (vec && n >= 4) {
    __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v[0], v[1]), __floats2bfloat162_rn(v[2], v[3])};
    *reinterpret_cast<uint2*>(o) = *reinterpret_cast<const uint2*>(h);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < n) o[j] = __float2bfloat16_rn(v[j]);
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One granule of G bytes (4, 8 or 16), zero-filled when `in` is false.
template <int G>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool in) {
  const int n = in ? G : 0;
  if constexpr (G == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(G), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait_upto(int pending) {  // pending <= N
  if constexpr (N > 0) {
    if (pending >= N) {
      cp_wait<N>();
      return;
    }
    cp_wait_upto<N - 1>(pending);
  } else {
    cp_wait<0>();
  }
}

// A position (slab q, row r, granule g) in a chunk's copy, and a stride of
// the same shape: a thread walks f = tid, tid + nt, ... by adding the
// digits of nt with carries, so the copy loop divides nothing.
struct Digits {
  int g, r, q;
};
__device__ __forceinline__ Digits digits(int f, int per_row, int rows) {
  Digits d;
  d.g = f % per_row;
  f /= per_row;
  d.r = f % rows;
  d.q = f / rows;
  return d;
}

// Copy granules (q, r, g) of a chunk, q < nslab, r < rows (of bc), g <
// per_row, from src + q * s_slab + r * s_row + g * E to dst + (q * bc + r)
// * d_row + g * E; granules at or past `valid` (past the tensor's edge) are
// zero-filled. Plain loads for granules narrower than 4 bytes.
template <typename T, int G>
__device__ __forceinline__ void copy_chunk(T* dst, int d_row, const T* src, int s_slab, int s_row,
                                           int nslab, int bc, int rows, int per_row, int valid,
                                           Digits at, const Digits& step) {
  constexpr int E = G >= (int)sizeof(T) ? G / (int)sizeof(T) : 1;
  while (at.q < nslab) {
    if (at.r < rows) {
      const bool in = at.g < valid;
      T* d = dst + (at.q * bc + at.r) * d_row + at.g * E;
      const T* s = src + at.q * s_slab + at.r * s_row + at.g * E;
      if constexpr (G >= 4 && G >= (int)sizeof(T))
        cp_async<G>(d, in ? s : src, in);
      else
        *d = in ? *s : from_f32<T>(0.f);
    }
    at.g += step.g;
    if (at.g >= per_row) {
      at.g -= per_row;
      ++at.r;
    }
    at.r += step.r;
    if (at.r >= bc) {
      at.r -= bc;
      ++at.q;
    }
    at.q += step.q;
  }
}

template <typename T>
__device__ __forceinline__ void copy_any(int granule, T* dst, int d_row, const T* src, int s_slab,
                                         int s_row, int nslab, int bc, int rows, int per_row,
                                         int valid, const Digits& at, const Digits& step) {
  switch (granule) {
    case 16:
      copy_chunk<T, 16>(dst, d_row, src, s_slab, s_row, nslab, bc, rows, per_row, valid, at, step);
      break;
    case 8:
      copy_chunk<T, 8>(dst, d_row, src, s_slab, s_row, nslab, bc, rows, per_row, valid, at, step);
      break;
    case 4:
      copy_chunk<T, 4>(dst, d_row, src, s_slab, s_row, nslab, bc, rows, per_row, valid, at, step);
      break;
    default:
      copy_chunk<T, 2>(dst, d_row, src, s_slab, s_row, nslab, bc, rows, per_row, valid, at, step);
      break;
  }
}

// acc[i][j] += G[r][d + i] * Z[r][c + j] for one b row r.
template <typename T, int RD>
__device__ __forceinline__ void fma_row(const T* zr, const T* gr, float (&acc)[RD][4]) {
  float zv[4], gv[RD];
  load<4>(zr, zv);
  load<RD>(gr, gv);
#pragma unroll
  for (int i = 0; i < RD; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(gv[i], zv[j], acc[i][j]);
}

template <typename T, int RD>
__device__ __forceinline__ void contract(const T* __restrict__ Z, const T* __restrict__ G,
                                         T* __restrict__ O, const Plan& p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int CT = p.cg * 4, DT = p.dg * RD;

  // a grouped call (the experts of an MoE layer): group blockIdx.y's
  // operands follow the previous group's, each the plan's shapes
  Z += (size_t)blockIdx.y * p.a * p.b * p.c;
  G += (size_t)blockIdx.y * p.b * p.d;
  O += (size_t)blockIdx.y * p.a * p.d * p.c;

  // this CTA's slab run and output tile
  int t = blockIdx.x;
  const int ti_c = t % p.tiles_c;
  t /= p.tiles_c;
  const int ti_d = t % p.tiles_d;
  const int a0 = (t / p.tiles_d) * p.spc, c0 = ti_c * CT, d0 = ti_d * DT;
  const int nslab = min(p.spc, p.a - a0);
  const int ncols = min(CT, p.c - c0), nrows_d = min(DT, p.d - d0);

  // this thread's place: b share fastest (a tile's shares are neighbouring
  // lanes), then c group, d group, slab
  t = tid;
  const int k = t % p.split;
  t /= p.split;
  const int cgi = t % p.cg;
  t /= p.cg;
  const int dgi = t % p.dg, s = t / p.dg;
  const bool active = s < p.spc;

  // copy walks: granules per tile row, how many lie inside the tensor, and
  // this thread's first position and stride in a chunk
  const int ez = p.gz >= (int)sizeof(T) ? p.gz / (int)sizeof(T) : 1;
  const int eg = p.gg >= (int)sizeof(T) ? p.gg / (int)sizeof(T) : 1;
  const int zq = CT / ez, gq = DT / eg;
  const int zvalid = (ncols + ez - 1) / ez, gvalid = (nrows_d + eg - 1) / eg;
  const Digits z_at = digits(tid, zq, p.bc), z_step = digits(nt, zq, p.bc);
  const Digits g_at = digits(tid, gq, p.bc), g_step = digits(nt, gq, p.bc);
  const int slab_sm = p.bc * p.zp;  // elements between slabs in a slot
  const int slab_gl = p.b * p.c;  // and in Z

  // chunk ch of b into slot st: Z[run, b-chunk, c-tile], G[b-chunk,
  // d-tile], one cp.async group
  auto issue = [&](int ch, int st) {
    const int b0 = ch * p.bc, rows = min(p.bc, p.b - b0);
    T* zs = reinterpret_cast<T*>(smem + st * p.stage);
    T* gs = reinterpret_cast<T*>(smem + st * p.stage + p.z_stage);
    copy_any<T>(p.gz, zs, p.zp, Z + a0 * slab_gl + b0 * p.c + c0, slab_gl, p.c, nslab, p.bc,
                rows, zq, zvalid, z_at, z_step);
    copy_any<T>(p.gg, gs, p.gp, G + b0 * p.d + d0, 0, p.d, 1, p.bc, rows, gq, gvalid, g_at,
                g_step);
    cp_commit();
  };

  float acc[RD][4];
#pragma unroll
  for (int i = 0; i < RD; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int nch = (p.b + p.bc - 1) / p.bc;
  for (int i = 0; i < p.stages && i < nch; ++i) issue(i, i);
  for (int ch = 0, st = 0; ch < nch; ++ch) {
    cp_wait_upto<kMaxStages - 1>(min(p.stages - 1, nch - 1 - ch));
    __syncthreads();
    const int rows = min(p.bc, p.b - ch * p.bc);
    if (active) {
      const T* zr = reinterpret_cast<const T*>(smem + st * p.stage) + s * slab_sm + cgi * 4;
      const T* gr = reinterpret_cast<const T*>(smem + st * p.stage + p.z_stage) + dgi * RD;
      if (p.split == 1) {  // unrolled, so the next rows' loads issue early
#pragma unroll 4
        for (int r = 0; r < rows; ++r) fma_row<T, RD>(zr + r * p.zp, gr + r * p.gp, acc);
      } else {
        for (int r = k; r < rows; r += p.split)
          fma_row<T, RD>(zr + r * p.zp, gr + r * p.gp, acc);
      }
    }
    __syncthreads();
    if (ch + p.stages < nch) issue(ch + p.stages, st);
    st = st + 1 == p.stages ? 0 : st + 1;
  }

  // a b-split's shares meet: an xor tree over the shares inside a warp,
  // then (split > 32) each warp's sums through shared memory, added in
  // warp order; share 0 holds the total. Fixed order, no atomics.
  if (p.split > 1) {
    const int wsplit = min(p.split, 32);
    for (int off = 1; off < wsplit; off <<= 1)
#pragma unroll
      for (int i = 0; i < RD; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], off);
    if (p.split > 32) {
      float* red = reinterpret_cast<float*>(smem);  // the slots are free
      const int npos = p.cg * p.dg * p.spc, pos = tid / p.split;
      if (active && (k & 31) == 0)
#pragma unroll
        for (int i = 0; i < RD; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) red[((k >> 5) * npos + pos) * RD * 4 + i * 4 + j] = acc[i][j];
      __syncthreads();
      if (active && k == 0)
        for (int w = 1; w < p.split >> 5; ++w)
#pragma unroll
          for (int i = 0; i < RD; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += red[(w * npos + pos) * RD * 4 + i * 4 + j];
    }
  }
  if (!active || k != 0 || s >= nslab) return;
  T* o = O + ((a0 + s) * p.d + d0 + dgi * RD) * p.c + c0 + cgi * 4;
#pragma unroll
  for (int i = 0; i < RD; ++i)
    if (dgi * RD + i < nrows_d) store4(o + i * p.c, acc[i], ncols - cgi * 4, p.vec_out);
}

// Launch `fn` (a kernel<T, RD> taking (Z, G, O, Plan)) on `stream` after
// checking the plan, `groups` groups of the plan's shapes one after another
// in each operand (blockIdx.y the group); returns cudaGetLastError() after
// the launch.
inline int launch(const void* fn, const void* z, const void* g, void* o, const int* fields,
                  int groups, void* stream) {
  Plan p;
  memcpy(&p, fields, sizeof(Plan));
  if (fn == nullptr || groups < 1 || groups > 65535) return (int)cudaErrorInvalidValue;
  if (p.grid == 0) return (int)cudaSuccess;
  const bool ok = p.threads >= 32 && p.threads <= kMaxThreads && p.threads % 32 == 0 &&
                  p.smem >= 0 && p.smem <= kMaxSmem && p.bc >= 1 && p.stages >= 1 &&
                  p.stages <= kMaxStages && p.stages * p.stage <= p.smem && p.cg >= 1 &&
                  p.dg >= 1 && p.spc >= 1 && p.split >= 1 && (p.stages > 1 || p.bc >= p.b) &&
                  p.cg * p.dg * p.spc * p.split <= p.threads &&
                  (p.split & (p.split - 1)) == 0 && p.zp >= p.cg * 4 && p.gp >= p.dg * p.rd;
  if (!ok) return (int)cudaErrorInvalidValue;
  if (p.smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return (int)e;
  }
  void* args[] = {&z, &g, &o, &p};
  const cudaError_t e =
      cudaLaunchKernel(fn, dim3((unsigned)p.grid, (unsigned)groups), dim3((unsigned)p.threads),
                       args, (size_t)p.smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace tt_contract
