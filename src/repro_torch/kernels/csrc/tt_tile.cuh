// The f32 body of PE2 and PE3 at large shapes: the contraction
//
//   O(a, d, c) = sum_b  Z(a, b, c) * G(b, d)
//
// as one GEMM of M = the (slab, column) pairs (a, c), N = d and K = b, read
// in place (no permute copy). PE2 (csrc/ttm_pe2.cu) is this as written; PE3
// (csrc/ttm_pe3.cu) is it at a = 1 with Z = X (b, i) and G = Ybar (b, j).
// Each source wraps `gemm` in a __global__ kernel of its own name
// (`pe2_tile_kernel`, `pe3_tile_kernel`); kernels/tt_tile.py plans it.
//
// Tiles (the plan): a CTA's M-tile is `spc` whole slabs times `ct` columns
// of c, or where c >= 96 one slab cut into tiles of `ct` columns; M row m
// of the tile is (slab m / ct, column m % ct). Its N-tile is `bn` <= 128
// columns of d. Two bodies:
//   wide    (16 x 8 sums a thread, 256 threads, one CTA an SM): 256 x 128
//           tiles (21 slabs at c = 12, 16 at c = 16, 8 at c = 32, 256
//           columns of PE3's Ŵ head), where those tiles fill the card and
//           waste at most a fifth of their columns; its pitches are
//           immediates and its chunks 32 K rows;
//   square  (8 x tn sums, tn = 4, 8 or 12; two or three CTAs an SM): tiles
//           of at most 128 x 128 (8 slabs at c = 12 or 16, 4 at c = 32) and
//           the thin calls (d = 8-32: the N-tile is all of d, and `ks`
//           groups of threads share the tile, group g taking rows g*kr ..
//           g*kr + kr - 1 of every chunk).
// Both operands arrive K-outer, as they lie in memory: a K row of the Z
// tile is `spc` runs of `ct` contiguous floats (48 B at c = 12: 16-byte
// cp.async granules where rows, runs and the pointer allow, else 8 or 4),
// a K row of the G tile `bn` contiguous floats, so shared memory holds both
// as [k][m] and [k][n] and no transpose is needed. K-chunks of `bk` rows
// pass through a ring of `stages` (3-6) cp.async slots: every slot but one
// in flight before the first FMA, one barrier a chunk, the slot read last
// refilled right after it. Ragged edges (slabs past a, columns past c, rows
// of d past d, K rows past b) are zero-filled.
//
// A thread's sums: rows tm*4 + (0..3) in TM/4 runs bm/(TM/4) apart, columns
// tn*4 + (0..3) in TN/4 runs bn/(TN/4) apart, read from shared memory as
// float4s (a warp's 4 x 8 or 8 x 4 threads reading 4 and 8 distinct
// vectors of a row: one wavefront each), one fmaf per product, K in
// increasing order. The wide body's inner loop is 4,096 FFMA and 188
// LDS.128 a 32-row chunk and nothing else (cuobjdump of the H100 build).
//
// Split-K over a thread block cluster (cs > 1, <= 8 CTAs): where the tiles
// leave the card's last wave short (PE3's Ŵ 768 x 768 is 36 tiles of 128 x
// 128), the cluster's CTAs share one tile, rank r summing one contiguous
// range of the K-chunks; the planner picks cs from a cost model of the
// card's waves (kernels/tt_tile.py _cost). One launch: no workspace, no
// counters, no float atomics.
//
// Write-back through shared memory: after the K loop every thread stores
// its sums into a [group][n][m] tile of the (now free) ring; after a
// barrier (a cluster barrier under split-K) each output is the sum over
// ranks 0..cs-1, each over groups 0..ks-1, in that order (remote ranks'
// tiles read through distributed shared memory), so two launches on the
// same inputs give the same bits. Outputs are enumerated (slab, n, column)
// with the column fastest: a (slab, n) row of O is a contiguous run of
// `ct` floats, and where ct = c a slab's bn rows are one contiguous run, so
// stores are coalesced (float4 where c % 4 == 0) even where a thread's
// rows cross a slab. Under split-K rank r stores the r-th share of the
// tile; a second cluster barrier keeps every CTA's shared memory alive
// until its readers are done.
//
// Full FP32 on the CUDA cores, as torch.matmul runs f32 with TF32 off
// (PyTorch's default). 3xTF32 on the tensor cores would change both the
// operation bound these calls are held to (67 TFLOP/s FP32) and the
// accuracy contract (1e-4 relative and absolute), so it is not used. All
// index math is 32-bit (the wrappers refuse tensors of 2^31 elements);
// divisions happen once per thread at the start and in the write-back,
// none in the copy or FMA loops.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "tt_contract.cuh"

namespace tt_tile {

namespace cg = cooperative_groups;

constexpr int kMaxSmem = 232448;   // 227 KB, the most a CTA may ask for
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kMaxStages = 6;

// CTA size at most and CTAs an SM must hold (__launch_bounds__) of a
// kernel<TM, TN, KR>: 8 x 4 and 8 x 8 register tiles fit 128 registers
// (256 threads, two CTAs an SM), 8 x 12 fits 168 (128 threads, three),
// 16 x 8 up to 255 (256 threads, one).
__host__ __device__ constexpr int max_threads(int tm, int tn) {
  return tm == 8 && tn > 8 ? 128 : 256;
}
__host__ __device__ constexpr int min_blocks(int tm, int tn) {
  return tm == 16 ? 1 : tn == 12 ? 3 : 2;
}

// Field order is kernels/tt_tile.py PLAN_FIELDS.
struct Plan {
  int a, b, c, d;        // Z (a, b, c), G (b, d), O (a, d, c)
  int tm, tn, kr;        // M rows (8, 16) and N columns (4-16) a thread; K
                         // rows a group takes a chunk (4, 8, 16): the
                         // template
  int spc, ct;           // slabs and c columns of an M-tile
  int wm, wn, ks;        // threads along M (tm rows each) and N, K groups
  int lm;                // lanes along M in a warp (4, 8), 0: row-major
  int threads;           // CTA size, a multiple of 32
  int bn, bk;            // N-tile; K rows a chunk (ks * kr)
  int stages;            // ring slots
  int cs;                // CTAs of a cluster splitting K over one tile
  int nk, kc;            // K-chunks; chunks a rank (ceil(nk / cs))
  int gz, gg;            // copy granule bytes of Z and G rows (16, 8, 4)
  int zp, gp, op;        // shared row pitches (floats): Z, G, output tile
  int z_stage, stage;    // bytes of a slot's Z region, and of a slot
  int smem;              // dynamic shared-memory bytes
  int tiles_m, tiles_c;  // M-tiles (slab runs x c tiles), c tiles a run
  int tiles_n;           // N-tiles
  int m_fast;            // 1: consecutive tiles walk M (share a G tile)
  int grid;              // CTAs: tiles x cs
  int vec_out;           // 1: c % 4 == 0 and ct % 4 == 0, float4 stores
};
constexpr int kPlanFields = 34;
static_assert(sizeof(Plan) == kPlanFields * sizeof(int), "Plan is 34 int32");

using tt_contract::cp_async;
using tt_contract::cp_commit;
using tt_contract::Digits;
using tt_contract::digits;

// Copy granules (g, r, q) of a chunk: g < per_run granules of a run, r <
// runs runs of a row, q < rows rows, from src + r * s_run + q * s_row + g * E
// to dst + q * d_row + r * d_run + g * E. Granules with q >= nrows, r >=
// nruns or g >= valid (past the tensor's edge) are zero-filled. A thread
// walks f = tid, tid + nt, ... by adding the digits of nt with carries.
template <int G>
__device__ __forceinline__ void copy_rows(float* dst, int d_row, int d_run, const float* src,
                                          int s_run, int s_row, int runs, int nruns, int rows,
                                          int nrows, int per_run, int valid, Digits at,
                                          const Digits& step) {
  constexpr int E = G / 4;
  while (at.q < rows) {
    const bool in = at.q < nrows && at.r < nruns && at.g < valid;
    cp_async<G>(dst + at.q * d_row + at.r * d_run + at.g * E,
                in ? src + at.r * s_run + at.q * s_row + at.g * E : src, in);
    at.g += step.g;
    if (at.g >= per_run) {
      at.g -= per_run;
      ++at.r;
    }
    at.r += step.r;
    if (at.r >= runs) {
      at.r -= runs;
      ++at.q;
    }
    at.q += step.q;
  }
}

__device__ __forceinline__ void copy_any(int granule, float* dst, int d_row, int d_run,
                                         const float* src, int s_run, int s_row, int runs,
                                         int nruns, int rows, int nrows, int per_run, int valid,
                                         const Digits& at, const Digits& step) {
  switch (granule) {
    case 16:
      copy_rows<16>(dst, d_row, d_run, src, s_run, s_row, runs, nruns, rows, nrows, per_run,
                    valid, at, step);
      break;
    case 8:
      copy_rows<8>(dst, d_row, d_run, src, s_run, s_row, runs, nruns, rows, nrows, per_run,
                   valid, at, step);
      break;
    default:
      copy_rows<4>(dst, d_row, d_run, src, s_run, s_row, runs, nruns, rows, nrows, per_run,
                   valid, at, step);
      break;
  }
}

template <int N>
__device__ __forceinline__ void add(float* v, const float* p) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] += x.x; v[1] += x.y; v[2] += x.z; v[3] += x.w;
  } else {
    v[0] += p[0];
  }
}

template <int N>
__device__ __forceinline__ void put(float* o, const float* v) {
  if constexpr (N == 4)
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
  else
    o[0] = v[0];
}

// The tile's outputs from units lo .. hi - 1 of (slab, n, column group of
// N), each the sum over ranks 0..cs-1 and groups 0..ks-1, in that order. A
// thread walks u = lo + tid, lo + tid + nt, ... as digits (column group,
// n, slab) added with carries: no division in the loop.
template <int N>
__device__ __forceinline__ void write_back(float* __restrict__ O, const Plan& p, float* part,
                                          int lo, int hi, int a0, int c0, int n0, int nslab,
                                          int ncols, int nn) {
  const int per_run = p.ct / N, tile = p.bn * p.op, nt = blockDim.x;
  cg::cluster_group cluster = cg::this_cluster();
  Digits at = digits(lo + (int)threadIdx.x, per_run, p.bn);
  const Digits step = digits(nt, per_run, p.bn);
  for (int u = lo + (int)threadIdx.x; u < hi; u += nt) {
    const int n = at.r, s = at.q, col = at.g * N;
    if (s < nslab && n < nn && col < ncols) {
      const int off = n * p.op + s * p.ct + col;
      float v[N];
#pragma unroll
      for (int j = 0; j < N; ++j) v[j] = 0.f;
      for (int r = 0; r < p.cs; ++r) {
        const float* src = p.cs > 1 ? cluster.map_shared_rank(part, r) : part;
        for (int g = 0; g < p.ks; ++g) add<N>(v, src + g * tile + off);
      }
      put<N>(O + ((a0 + s) * p.d + n0 + n) * p.c + c0 + col, v);
    }
    at.g += step.g;
    if (at.g >= per_run) {
      at.g -= per_run;
      ++at.r;
    }
    at.r += step.r;
    if (at.r >= p.bn) {
      at.r -= p.bn;
      ++at.q;
    }
    at.q += step.q;
  }
}

template <int TM, int TN, int KR>
__device__ __forceinline__ void gemm(const float* __restrict__ Z, const float* __restrict__ G,
                                     float* __restrict__ O, const Plan& p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sm = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int bm = p.wm * TM;  // the M-tile padded to whole thread rows

  // this CTA's tile and rank
  const int rank = blockIdx.x % p.cs, tile = blockIdx.x / p.cs;
  const int mt = p.m_fast ? tile % p.tiles_m : tile / p.tiles_n;
  const int ti_n = p.m_fast ? tile / p.tiles_m : tile % p.tiles_n;
  const int a0 = (mt / p.tiles_c) * p.spc, c0 = (mt % p.tiles_c) * p.ct, n0 = ti_n * p.bn;
  const int nslab = min(p.spc, p.a - a0), ncols = min(p.ct, p.c - c0), nn = min(p.bn, p.d - n0);

  // this thread's group and place in the group's wm x wn grid of threads
  const int group = p.wm * p.wn;
  const bool active = tid < group * p.ks;
  const int g = tid / group, r = tid % group;
  int tm, tn;
  if (p.lm) {  // a warp is lm x (32 / lm) threads of the grid
    const int lane = r & 31, w = r >> 5, wpm = p.wm / p.lm;
    tm = (w % wpm) * p.lm + lane % p.lm;
    tn = (w / wpm) * (32 / p.lm) + lane / p.lm;
  } else {
    tm = r % p.wm;
    tn = r / p.wm;
  }

  // copy walks: Z granules (granule of a run, slab, K row), G granules
  // (granule, -, K row); this thread's first position and stride
  const int ez = p.gz / 4, eg = p.gg / 4;
  const int zq = p.ct / ez, gq = p.bn / eg;
  const int zvalid = (ncols + ez - 1) / ez, gvalid = (nn + eg - 1) / eg;
  const Digits z_at = digits(tid, zq, p.spc), z_step = digits(nt, zq, p.spc);
  const Digits g_at = digits(tid, gq, 1), g_step = digits(nt, gq, 1);
  const int slab = p.b * p.c;
  const float* zbase = Z + a0 * slab + c0;
  const float* gbase = G + n0;

  // chunk ch into slot st: Z[k-chunk][slabs][columns], G[k-chunk][n]
  auto issue = [&](int ch, int st) {
    const int k0 = ch * p.bk, rows = min(p.bk, p.b - k0);
    float* zs = sm + st * (p.stage / 4);
    float* gs = zs + p.z_stage / 4;
    copy_any(p.gz, zs, p.zp, p.ct, zbase + k0 * p.c, slab, p.c, p.spc, nslab, p.bk, rows, zq,
             zvalid, z_at, z_step);
    copy_any(p.gg, gs, p.gp, 0, gbase + k0 * p.d, 0, p.d, 1, 1, p.bk, rows, gq, gvalid, g_at,
             g_step);
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // this rank's K-chunks, through the ring
  const int ch0 = rank * p.kc, nch = min(p.nk, ch0 + p.kc) - ch0;
  for (int i = 0; i < p.stages - 1; ++i) {
    if (i < nch) issue(ch0 + i, i);
    cp_commit();
  }
  // a thread's rows: MG runs of 4, bm / MG apart; its columns: NG runs of
  // 4, bn / NG apart
  constexpr int MG = TM / 4, NG = TN / 4;
  // the 16 x 8 instance's tile is always 256 x 128 with unpadded rows
  // (kernels/tt_tile.py), so its pitches are immediates
  const int zp = TM == 16 ? 256 : p.zp, gp = TM == 16 ? 128 : p.gp;
  const int zoff = g * KR * zp + tm * 4, goff = g * KR * gp + tn * 4;
  const int mq = TM == 16 ? 64 : bm / MG, nq = TM == 16 ? 64 : p.bn / NG;
  for (int i = 0, st = 0; i < nch; ++i) {
    tt_contract::cp_wait_upto<kMaxStages - 2>(p.stages - 2);
    __syncthreads();
    const int nx = i + p.stages - 1;
    if (nx < nch) issue(ch0 + nx, nx % p.stages);
    cp_commit();
    if (active) {
      const float* zr = sm + st * (p.stage / 4) + zoff;
      const float* gr = sm + st * (p.stage / 4) + p.z_stage / 4 + goff;
#pragma unroll
      for (int k = 0; k < KR; ++k) {
        float av[TM], bv[TN];
#pragma unroll
        for (int q = 0; q < MG; ++q) tt_contract::load<4>(zr + q * mq, av + 4 * q);
#pragma unroll
        for (int q = 0; q < NG; ++q) tt_contract::load<4>(gr + q * nq, bv + 4 * q);
#pragma unroll
        for (int ii = 0; ii < TM; ++ii)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[ii][j] = fmaf(av[ii], bv[j], acc[ii][j]);
        zr += zp;
        gr += gp;
      }
    }
    st = st + 1 == p.stages ? 0 : st + 1;
  }
  tt_contract::cp_wait<0>();
  __syncthreads();

  // the sums into shared memory as [group][n][m], the ring's bytes reused
  if (active) {
    float* part = sm + g * p.bn * p.op + tm * 4;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = (j >> 2) * nq + tn * 4 + (j & 3);
#pragma unroll
      for (int h = 0; h < MG; ++h)
        *reinterpret_cast<float4*>(part + n * p.op + h * mq) =
            make_float4(acc[4 * h][j], acc[4 * h + 1][j], acc[4 * h + 2][j], acc[4 * h + 3][j]);
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  if (p.cs > 1)
    cluster.sync();
  else
    __syncthreads();

  // this rank's share of the tile's outputs, coalesced along c
  const int units = p.spc * p.bn * (p.ct / (p.vec_out ? 4 : 1));
  const int lo = rank * units / p.cs, hi = (rank + 1) * units / p.cs;
  if (p.vec_out)
    write_back<4>(O, p, sm, lo, hi, a0, c0, n0, nslab, ncols, nn);
  else
    write_back<1>(O, p, sm, lo, hi, a0, c0, n0, nslab, ncols, nn);
  if (p.cs > 1) cluster.sync();  // no CTA leaves while a rank reads it
}

// Launch `fn` (a kernel<TM, TN, KR> taking (Z, G, O, Plan)) on `stream` after
// checking the plan and the operands' alignment; a cluster of `cs` CTAs a
// tile. Returns the launch's error, then cudaGetLastError().
inline int launch(const void* fn, const void* z, const void* g, void* o, const int* fields,
                  void* stream) {
  Plan p;
  memcpy(&p, fields, sizeof(Plan));
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  if (p.grid == 0) return (int)cudaSuccess;
  const int bm = p.wm * p.tm, group = p.wm * p.wn;
  const auto mis = [](const void* q, int n) {
    return reinterpret_cast<uintptr_t>(q) % (uintptr_t)n != 0;
  };
  const bool ok =
      ((p.tm == 8 && (p.tn == 4 || p.tn == 8 || p.tn == 12) &&
        (p.kr == 4 || p.kr == 8 || p.kr == 16)) ||
       (p.tm == 16 && p.tn == 8 && p.kr == 32 && p.wm == 16 && p.wn == 16 &&
        p.ks == 1 && p.zp == 256 && p.gp == 128)) &&
      p.spc >= 1 &&
      p.ct >= 1 && p.spc * p.ct <= bm && bm <= 256 && p.bn == p.wn * p.tn && p.bn <= 128 &&
      p.ks >= 1 && p.ks <= 8 && p.bk == p.ks * p.kr && p.threads % 32 == 0 &&
      p.threads >= group * p.ks && p.threads < group * p.ks + 32 && p.threads <= max_threads(p.tm, p.tn) &&
      (p.lm == 0 || (p.wm % p.lm == 0 && p.wn % (32 / p.lm) == 0)) && p.stages >= 3 &&
      p.stages <= kMaxStages && p.cs >= 1 && p.cs <= kMaxCluster && p.nk >= 1 && p.kc >= 1 &&
      p.nk == (p.b + p.bk - 1) / p.bk && (p.cs - 1) * p.kc < p.nk && p.kc * p.cs >= p.nk &&
      (p.gz == 16 || p.gz == 8 || p.gz == 4) && (p.gg == 16 || p.gg == 8 || p.gg == 4) &&
      p.ct % (p.gz / 4) == 0 && p.bn % (p.gg / 4) == 0 && (p.c * 4) % p.gz == 0 &&
      (p.d * 4) % p.gg == 0 && p.zp >= bm && p.gp >= p.bn &&
      p.op >= bm && p.zp % 4 == 0 && p.gp % 4 == 0 && p.op % 4 == 0 &&
      p.z_stage % 16 == 0 && p.stage % 16 == 0 && p.z_stage >= p.bk * p.zp * 4 &&
      p.stage >= p.z_stage + p.bk * p.gp * 4 && p.smem >= p.stages * p.stage &&
      p.smem >= p.ks * p.bn * p.op * 4 && p.smem <= kMaxSmem &&
      p.tiles_c == (p.c + p.ct - 1) / p.ct &&
      p.tiles_m == (p.a + p.spc - 1) / p.spc * p.tiles_c &&
      p.tiles_n == (p.d + p.bn - 1) / p.bn && p.grid == p.tiles_m * p.tiles_n * p.cs &&
      (!p.vec_out || (p.c % 4 == 0 && p.ct % 4 == 0)) && !mis(z, p.gz) && !mis(g, p.gg) &&
      !mis(o, p.vec_out ? 16 : 4);
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)p.grid);
  cfg.blockDim = dim3((unsigned)p.threads);
  cfg.dynamicSmemBytes = (size_t)p.smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {&z, &g, &o, &p};
  e = cudaLaunchKernelExC(&cfg, fn, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Diagnostic: the clusters of `fn` under the plan's CTA size, shared
// memory and cluster size that the card runs at once
// (cudaOccupancyMaxActiveClusters), or minus the error code.
inline int clusters(const void* fn, const int* fields) {
  Plan p;
  memcpy(&p, fields, sizeof(Plan));
  if (fn == nullptr) return -(int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)p.grid);
  cfg.blockDim = dim3((unsigned)p.threads);
  cfg.dynamicSmemBytes = (size_t)p.smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, fn, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

// The kernel<TM, TN, KR> of `Kernel` (a template struct with a static
// fn()): 8 x {4, 8, 12} register tiles with K rows 4, 8 or 16 a group and
// chunk, and 16 x 8 with 32.
template <template <int, int, int> class Kernel, int TN>
const void* pick8(int kr) {
  if (kr == 16) return Kernel<8, TN, 16>::fn();
  if (kr == 8) return Kernel<8, TN, 8>::fn();
  if (kr == 4) return Kernel<8, TN, 4>::fn();
  return nullptr;
}
template <template <int, int, int> class Kernel>
const void* pick(int tm, int tn, int kr) {
  if (tm == 16 && tn == 8) return kr == 32 ? Kernel<16, 8, 32>::fn() : nullptr;
  if (tm != 8) return nullptr;
  if (tn == 12) return pick8<Kernel, 12>(kr);
  if (tn == 8) return pick8<Kernel, 8>(kr);
  if (tn == 4) return pick8<Kernel, 4>(kr);
  return nullptr;
}

}  // namespace tt_tile
