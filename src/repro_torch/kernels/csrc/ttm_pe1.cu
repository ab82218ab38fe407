// PE1 (paper Eq. 5) with the FPGA PE's optional requantize-on-writeback
// epilogue:
//
//   Y(a, d) = sum_{b,c} Z(a, b, c) G(b, d, c)   [+ pow-2 requant]
//
// Replaces: repro/kernels/ttm_pe1.py:34 `_pe1_kernel` / `pe1_matmul`. On the
// training path it runs every TT matvec chain's first contraction (Eq. 8,
// b = 1): 6 launches an FMNIST MLP step (f32, Z (a, 1, 16) x G (1, 256, 16)
// with a = 3584, 2048, 2048 and 64), 432 a step of with_tt(internlm2-1.8b)
// (bf16: (262144, 1, 16) x (1, 256, 16) and x (1, 512, 16), (524288, 1, 32)
// x (1, 256, 32)).
//
// Two bodies, chosen by kernels/ttm_pe1.py from dtype, shape and alignment
// alone (`plan_pe1`; the calls it cannot tile take `plan`):
//
// bf16 with b = 1, even c <= 64, d a multiple of 8 and operands on at least
// 4-byte boundaries (every LM call, and the frontends': hubert-xlarge's
// (524288, 1, 20) x (1, 256, 20), 192 launches a step, and llava-next-34b's
// c = 28 at d = 256 / 448 / 512): `pe1_mma_kernel`, wgmma on the tensor cores.
// With b = 1 the call is a plain GEMM, M = a, N = d, K = c, both operands
// K-major (Z (a, c) and G (d, c) are contiguous along c). Bound on the H100:
// bytes, the output's above all: Y is d / c = 8-32x Z. (262144, 1, 16) x (1,
// 256, 16) writes 134 MB and reads 8.4 MB, 42.6 us at 3.35 TB/s, against 2.2
// GFLOP, 2.2 us at 989 TFLOP/s (on the CUDA cores, at 16-20 TFLOP/s, the
// products alone outlasted the bytes at c = 32). What the design does about
// it: keep HBM's write stream full and put nothing in its way. A persistent
// CTA (one per SM) walks its tiles in order; each tile spans all of d (128 x
// 256 at d = 256, two consumer warpgroups along a; 64 x 512 at d = 512, two
// along d), one contiguous run of Y of 64 KB. G (8-16 KB) is loaded once per
// CTA and stays; Z streams through a ring of TMA loads (rows of c under the
// 32-, 64- or 128-byte swizzle, zero-filled to the next 16 of K and past a)
// that a producer warp keeps ahead. A warpgroup's 64 x 256 tile is two
// m64n128 products (64 f32 sums a thread: at 128 the body spilled) of one to
// four wgmma k-steps of 16, both operands K-major (the instruction's
// transpose immediates 0); after each, the epilogue converts the f32 sums to
// bf16 (requantized first when asked) into a staging tile laid out as the
// output map's 128-byte swizzle (boxes of 64 columns, so the fragment writes
// do not conflict), and TMA tensor stores take it out, rows past a dropped.
// Rows of Z and G the TMA cannot take (c not a multiple of 8: 40 and 56
// bytes at c = 20 / 28; or an operand 4 or 8 bytes off 16; the plan's
// `gran`) are staged by cp.async in 8-byte granules (4 where the rows or
// offsets allow no more) into the same swizzled rows (stage_rows): the CTA
// zeroes G and the ring first, so the K padding past c (to the next 16)
// stays zero, the producer warp's 32 lanes copy G once and each tile's Z
// rows (rows past a zero-filled), each lane arrives on the slot's barrier
// when its granules land (cp.async.mbarrier.arrive.noinc: 32 arrivals a
// tile, against a tile's 32-64 KB of stores), and the consumers fence
// (the copies write through the generic proxy, wgmma reads through the
// async one) before their products. The epilogue is unchanged: d stays a
// multiple of 8. At c = 20 the call reads 21.0 MB of Z and writes 268 MB
// of Y: 86.4 us at 3.35 TB/s, against 5.4 GFLOP (5.4 us at 989 TFLOP/s);
// at the 16-20 TFLOP/s the CUDA-core body (`pe1_kernel`, which these calls
// took before) reached at the LM's shapes, the products alone outlast the
// bytes (times: PERF.md row 12d).
// Each warpgroup double-buffers its staging: a tile's stores run under the
// next tile's loads, products and conversions, and a warpgroup waits only
// until the stores of the tile two back have read their staging. No split-K
// and no atomics: each output is one warpgroup's sum in a fixed order, so
// two launches give the same bits.
//
// f32, and the bf16 calls the tensor-core plan cannot tile (odd c, 2-byte
// offsets, b > 1, c > 64): `pe1_kernel`,
// FMA on the CUDA cores. Bound on the H100: bytes. With b = 1 and c = 16
// each output is a 16-long dot product: a = 3584 stores 3.67 MB (1.1 us at
// 3.35 TB/s) for 29 MFLOP (0.44 us at the 67 TFLOP/s FP32 rate); at a = 64
// the call is launch latency. What costs is getting every SM storing early:
// the CTA's loads, its few FMAs and its stores run one after another, so
// the design keeps each of them short and the grid wide.
//
// Design of `pe1_kernel`. Z and G are both contiguous along c, so the
// contraction walks (b, c) in chunks of BK = 16 with nested counters (no
// division in any loop). A CTA owns AT = rm * ta rows of a by DT = 4 * td
// columns of d; a thread keeps an rm x 4 register tile of f32 sums, its four
// columns adjacent so the output leaves as one float4 (8 bytes in bf16)
// store, and along a warp the columns come first, so the warp stores whole
// lines. Per chunk, Z's rows land in shared memory by 16-byte cp.async (8-,
// 4- or 2-byte granules where c, the tile and the pointer allow no more;
// ragged c is zero-filled) and are read as broadcasts; G's (d-tile, c-chunk)
// slice is read with vector loads, a batch of granules in flight per thread,
// widened to f32 and stored transposed (c-major), so each thread reads its
// four columns as one conflict-free float4. At the step's shapes G is 16 KB
// and one chunk. The tile and grid come from the pure function
// kernels/ttm_pe1.py::plan: up to 64 columns of d (td = 16 threads of four),
// 16 threads along a, and the largest row tile (rm <= 8) that still gives
// CTAs for 7/8 of the 132 SMs: a = 3584 and 2048 take 224 and 128 CTAs of 64
// x 64 outputs, a = 64 takes 16. Tried on the H100 at the step's shapes and
// dropped (probe runs, not kept): tiles of 256 columns, and reading Z and G
// straight into registers without shared memory; both were slower.
//
// Numerics: `pe1_kernel` takes f32 or bf16 and accumulates in f32 with FMA
// on the CUDA cores (no tensor cores, so no TF32), each output's (b, c)
// terms in increasing order; `pe1_mma_kernel` takes bf16 and sums in f32 on
// the tensor cores. Both carry the optional epilogue, which requantizes the
// f32 sum before the store exactly as Pow2Reference.epilogue / encode ->
// decode do:
//   clip(rintf(acc / 2^s), lo, hi) * 2^s, then cast to the output dtype,
// so the fused output is bit-identical to the unfused sum passed through
// the codec. All index math is 32-bit (the wrapper refuses tensors of 2^31
// elements or more).

#include "tt_contract.cuh"
#include "tt_mma.cuh"

namespace {

using tt_contract::Digits;

constexpr int BK = 16;             // c values per chunk
constexpr int kMaxThreads = 256;
constexpr int kBatch = 4;          // G granules in flight per thread

// Field order is kernels/ttm_pe1.py PLAN_FIELDS.
struct Plan {
  int a, b, c, d;          // Z (a, b, c), G (b, d, c), Y (a, d)
  int rm, td, ta;          // rows per thread; threads along d and along a
  int threads;             // CTA size, a multiple of 32
  int tiles_a, tiles_d;    // output tiles of AT = rm * ta rows, DT = 4 * td
  int grid;                // CTAs: tiles_a x tiles_d
  int gz, gg;              // granule bytes of Z's and G's rows
  int zs_bytes;            // bytes of the Z region (16-aligned)
  int smem;                // dynamic shared memory bytes
  int vec_out;             // 1: d % 4 == 0, outputs stored 4 at a time
};
constexpr int kPlanFields = 16;
static_assert(sizeof(Plan) == kPlanFields * sizeof(int), "Plan is 16 int32");

__device__ __forceinline__ float pow2_step(float s) {
  if (s == truncf(s) && fabsf(s) <= 1024.f) return ldexpf(1.f, (int)s);
  return exp2f(s);
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int E>
struct alignas(E * sizeof(T)) Raw {
  T v[E];
};

// G's (d-tile, c-chunk) slice into Gs (BK, DT) f32, transposed. Granule
// (n, q) holds G[d0 + n][c0 + q*E .. +E); n runs fastest across the CTA so
// the transposed stores are conflict-free. Granules past the d-tile's or
// c's end store zeros. Up to kBatch loads are in flight before any store.
template <typename T, int GB>
__device__ __forceinline__ void stage_g(float* Gs, int DT, const T* g0, int c, int ncols,
                                        int cvalid, int n, int q, int step_n, int step_q) {
  constexpr int E = GB >= (int)sizeof(T) ? GB / (int)sizeof(T) : 1;
  constexpr int gq = BK / E;
  while (q < gq) {
    Raw<T, E> r[kBatch];
    int bn[kBatch], bq[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      bn[i] = n;
      bq[i] = q;
      if (q < gq && n < ncols && q * E < cvalid)
        r[i] = *reinterpret_cast<const Raw<T, E>*>(g0 + n * c + q * E);
      else
#pragma unroll
        for (int e = 0; e < E; ++e) r[i].v[e] = tt_contract::from_f32<T>(0.f);
      n += step_n;
      if (n >= DT) {
        n -= DT;
        ++q;
      }
      q += step_q;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      if (bq[i] < gq)
#pragma unroll
        for (int e = 0; e < E; ++e) Gs[(bq[i] * E + e) * DT + bn[i]] = widen(r[i].v[e]);
  }
}

template <typename T>
__device__ __forceinline__ void stage_g_any(int granule, float* Gs, int DT, const T* g0, int c,
                                            int ncols, int cvalid, int n, int q, int step_n,
                                            int step_q) {
  switch (granule) {
    case 16: stage_g<T, 16>(Gs, DT, g0, c, ncols, cvalid, n, q, step_n, step_q); break;
    case 8: stage_g<T, 8>(Gs, DT, g0, c, ncols, cvalid, n, q, step_n, step_q); break;
    case 4: stage_g<T, 4>(Gs, DT, g0, c, ncols, cvalid, n, q, step_n, step_q); break;
    default: stage_g<T, 2>(Gs, DT, g0, c, ncols, cvalid, n, q, step_n, step_q); break;
  }
}

template <typename T, int RM>
__global__ void __launch_bounds__(kMaxThreads)
pe1_kernel(const T* __restrict__ Z, const T* __restrict__ G, T* __restrict__ Y, Plan p,
           int epilogue, const float* __restrict__ step, float lo, float hi) {
  extern __shared__ __align__(16) unsigned char smem[];
  // a grouped call (the experts of an MoE layer): group blockIdx.y's
  // operands follow the previous group's, each the plan's shapes
  Z += (size_t)blockIdx.y * p.a * p.b * p.c;
  G += (size_t)blockIdx.y * p.b * p.d * p.c;
  Y += (size_t)blockIdx.y * p.a * p.d;
  T* Zs = reinterpret_cast<T*>(smem);                       // (AT, BK) in T
  float* Gs = reinterpret_cast<float*>(smem + p.zs_bytes);  // (BK, DT) f32
  const int tid = threadIdx.x, nt = blockDim.x;
  const int AT = RM * p.ta, DT = 4 * p.td;
  const int ti_d = blockIdx.x % p.tiles_d, ti_a = blockIdx.x / p.tiles_d;
  const int a0 = ti_a * AT, d0 = ti_d * DT;
  const int nrows = min(AT, p.a - a0), ncols = min(DT, p.d - d0);
  const int tx = tid % p.td, ty = tid / p.td;
  const bool active = ty < p.ta;

  // copy walks, set up once: Z granules (row, granule) with the granule
  // fastest; G granules (column, granule) with the column fastest
  const int ez = p.gz / (int)sizeof(T), ez_shift = __ffs(ez) - 1;
  const int zq = BK >> ez_shift;
  const Digits z_at = tt_contract::digits(tid, zq, AT);
  const Digits z_step = tt_contract::digits(nt, zq, AT);
  const int g_n = tid % DT, g_q = tid / DT, g_sn = nt % DT, g_sq = nt / DT;

  float acc[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int zrow = p.b * p.c;  // Z's row stride, elements
  const T* zb = Z + a0 * zrow;
  const T* gb = G + d0 * p.c;
  for (int bi = 0; bi < p.b; ++bi, zb += p.c, gb += p.d * p.c) {
    for (int c0 = 0; c0 < p.c; c0 += BK) {
      const int cvalid = p.c - c0;  // c values left from c0
      const int zvalid = cvalid >= BK ? zq : (cvalid + ez - 1) >> ez_shift;
      tt_contract::copy_any<T>(p.gz, Zs, BK, zb + c0, 0, zrow, 1, AT, nrows, zq, zvalid, z_at,
                               z_step);
      tt_contract::cp_commit();
      stage_g_any<T>(p.gg, Gs, DT, gb + c0, p.c, ncols, cvalid, g_n, g_q, g_sn, g_sq);
      tt_contract::cp_wait<0>();
      __syncthreads();
      if (active) {
        const T* zr = Zs + ty * RM * BK;
        const float* gr = Gs + tx * 4;
#pragma unroll
        for (int k = 0; k < BK; k += 4) {
          float zv[RM][4];
#pragma unroll
          for (int i = 0; i < RM; ++i) tt_contract::load<4>(zr + i * BK + k, zv[i]);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float4 g4 = *reinterpret_cast<const float4*>(gr + (k + kk) * DT);
#pragma unroll
            for (int i = 0; i < RM; ++i) {
              acc[i][0] = fmaf(zv[i][kk], g4.x, acc[i][0]);
              acc[i][1] = fmaf(zv[i][kk], g4.y, acc[i][1]);
              acc[i][2] = fmaf(zv[i][kk], g4.z, acc[i][2]);
              acc[i][3] = fmaf(zv[i][kk], g4.w, acc[i][3]);
            }
          }
        }
      }
      __syncthreads();
    }
  }

  if (!active) return;
  const float scale = epilogue ? pow2_step(__ldg(step)) : 1.f;
  const int nc = ncols - tx * 4;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int m = ty * RM + i;
    if (m >= nrows) break;
    if (epilogue) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float q = rintf(acc[i][j] / scale);
        q = q < lo ? lo : (q > hi ? hi : q);
        acc[i][j] = q * scale;
      }
    }
    tt_contract::store4(Y + (a0 + m) * p.d + d0 + tx * 4, acc[i], nc, p.vec_out);
  }
}

template <typename T>
const void* pick(int rm) {
  switch (rm) {
    case 1: return (const void*)pe1_kernel<T, 1>;
    case 2: return (const void*)pe1_kernel<T, 2>;
    case 4: return (const void*)pe1_kernel<T, 4>;
    case 8: return (const void*)pe1_kernel<T, 8>;
    default: return nullptr;
  }
}

// ---- the tensor-core body (bf16, b = 1)

constexpr int kMmaThreads = 2 * 128 + 32;  // two consumer warpgroups, the producer warp
constexpr int kOutBox = 64;                // output box: 64 columns (128 bytes) x 64 rows
constexpr int kOutBoxBytes = kOutBox * 64 * 2;

// Field order is kernels/ttm_pe1.py MMA_FIELDS.
struct MmaPlan {
  int a, c, d;               // Z (a, c), G (d, c), Y (a, d)
  int wgn, sw, ksteps;       // N per warpgroup and Z's / G's swizzle bytes (the
                             // template); k-steps of 16
  int wm, wn;                // consumer warpgroups along a and along d
  int tiles_m, tiles_n, tiles;
  int grid, threads;
  int stages, nbuf;          // ring slots; staging tiles per warpgroup
  int stage, g_bytes, out_bytes, smem;  // bytes: a ring slot, resident G, a
                                        // staging tile, the whole
  int gran;                  // Z's and G's cp.async granule bytes (4, 8), 0: TMA
};
constexpr int kMmaFields = 20;
static_assert(sizeof(MmaPlan) == kMmaFields * sizeof(int), "MmaPlan is 20 int32");

// Rows r0 .. r0 + n - 1 of a row-major (rows, c) bf16 array into a tile of
// SW-byte rows under the SW-byte swizzle (row r at r * SW, as the TMA lays
// a box of c <= SW / 2 columns), by cp.async granules of GR bytes: lane l
// of 32 takes granules l, l + 32, ... of the rows' one run, counters only.
// Rows past `rows` are zero fill; a row's bytes past 2 c keep the zeros the
// kernel wrote at its start.
template <int SW, int GR>
__device__ __forceinline__ void stage_rows(uint8_t* tile, const uint8_t* src, int r0, int n,
                                           int rows, int c, int lane) {
  const int row = c * 2, gpr = row / GR, total = n * gpr;
  const int dr = 32 / gpr, dq = 32 % gpr;
  int r = lane / gpr, q = lane - r * gpr;
#pragma unroll 1
  for (int e = lane; e < total; e += 32) {
    const bool in = r0 + r < rows;
    tt_mma::cp_granule<GR>(tile + tt_mma::swz<SW>(r * SW + q * GR),
                           in ? src + (size_t)(r0 + r) * row + q * GR : src, in ? GR : 0);
    q += dq;
    r += dr;
    if (q >= gpr) {
      q -= gpr;
      ++r;
    }
  }
}

// until all but this thread's nbuf - 1 most recent bulk groups (one a
// tile) have read their staging tiles
__device__ __forceinline__ void wait_staging(int nbuf) {
  if (nbuf == 1)
    tt_mma::bulk_wait_read();
  else
    tt_mma::bulk_wait_read_upto<1>();
}

// Warps 0-7 are the consumer warpgroups (warpgroup g takes rows 64 * (g /
// wn) and columns WGN * (g % wn) of a tile), warp 8 the producer. Shared
// memory, from a 1024-byte boundary: resident G (rows of SW bytes, boxes of
// WGN rows), the ring of Z slots (64 * wm rows of SW bytes), each
// warpgroup's nbuf staging tiles (WGN / 64 boxes of 64 x 128 bytes), the
// barriers. A grouped call runs group blockIdx.y's tiles in this CTA: the
// maps carry the group as their outermost coordinate (rows past a group's
// a are zero fill on the way in and dropped on the way out), the granules
// read the group's rows, and the resident G is the group's.
template <int WGN, int SW>
__global__ void __launch_bounds__(kMmaThreads, 1)
pe1_mma_kernel(const __grid_constant__ CUtensorMap tz, const __grid_constant__ CUtensorMap tg,
               const __grid_constant__ CUtensorMap ty, const uint8_t* __restrict__ z,
               const uint8_t* __restrict__ g, const MmaPlan p, int epilogue,
               const float* __restrict__ step, float lo, float hi) {
  using namespace tt_mma;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                           ~uintptr_t(1023));
  const int grp = blockIdx.y;
  z += (size_t)grp * p.a * p.c * 2;
  g += (size_t)grp * p.d * p.c * 2;
  const int nwg = p.wm * p.wn;
  uint8_t* g_res = sm;
  uint8_t* ring = g_res + p.g_bytes;
  uint8_t* outs = ring + p.stages * p.stage;
  uint64_t* full = reinterpret_cast<uint64_t*>(outs + nwg * p.nbuf * p.out_bytes);
  uint64_t* empty = full + p.stages;
  uint64_t* gbar = empty + p.stages;
  const int wg = threadIdx.x >> 7;

  // off the TMA (p.gran), each of the producer's 32 lanes arrives once a
  // phase, when its granules have landed
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + s, p.gran ? 32 : 1);
      mbar_init(empty + s, nwg);
    }
    mbar_init(gbar, p.gran ? 32 : 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (p.gran) zero_smem(g_res, p.g_bytes + p.stages * p.stage);  // K and row padding
  __syncthreads();
  const int bm = 64 * p.wm, bn = WGN * p.wn;

  if (wg == nwg && p.gran) {  // ---- producer on granules: every lane
    const int lane = threadIdx.x & 31;
    if (p.gran == 8)
      stage_rows<SW, 8>(g_res, g, 0, p.d, p.d, p.c, lane);
    else
      stage_rows<SW, 4>(g_res, g, 0, p.d, p.d, p.c, lane);
    cp_arrive(gbar);
    int st = 0, ph = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      mbar_wait(empty + st, ph ^ 1);
      uint8_t* slot = ring + st * p.stage;
      if (p.gran == 8)
        stage_rows<SW, 8>(slot, z, (t / p.tiles_n) * bm, bm, p.a, p.c, lane);
      else
        stage_rows<SW, 4>(slot, z, (t / p.tiles_n) * bm, bm, p.a, p.c, lane);
      cp_arrive(full + st);
      if (++st == p.stages) {
        st = 0;
        ph ^= 1;
      }
    }
    cp_wait_all();
    return;
  }
  if (wg == nwg) {  // ---- producer: one lane issues every copy
    if ((threadIdx.x & 31) != 0) return;
    mbar_expect_tx(gbar, p.g_bytes);
    for (int i = 0; i < p.tiles_n * p.wn; ++i)
      tma_3d(g_res + i * WGN * SW, &tg, gbar, 0, i * WGN, grp);
    int st = 0, ph = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      mbar_wait(empty + st, ph ^ 1);
      mbar_expect_tx(full + st, p.stage);
      tma_3d(ring + st * p.stage, &tz, full + st, 0, (t / p.tiles_n) * bm, grp);
      if (++st == p.stages) {
        st = 0;
        ph ^= 1;
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: its WGN columns as NH products of HN (a
  // 64 x 256 tile as two of 64 x 128: 64 f32 sums a thread, not 128)
  constexpr int NH = WGN > 128 ? WGN / 128 : 1, HN = WGN / NH;
  const int wmi = wg / p.wn, wni = wg - (wg / p.wn) * p.wn;
  const int lane = threadIdx.x & 127;
  const float scale = epilogue ? pow2_step(__ldg(step)) : 1.f;
  const uint32_t sbo = 8 * SW;  // K-major, K within one swizzle row: the
                                // 8-row groups' stride; no LBO
  // the fragment's rows r0 and r0 + 8, columns 8 j + cb, cb + 1
  const int r0 = (lane >> 5) * 16 + ((lane & 31) >> 2), cb = 2 * (lane & 3);
  uint8_t* stg0 = outs + wg * p.nbuf * p.out_bytes;
  float acc[HN / 2];
#pragma unroll
  for (int i = 0; i < HN / 2; ++i) acc[i] = 0.f;
  mbar_wait(gbar, 0);
  if (p.gran) fence_async();
  int st = 0, ph = 0, buf = 0;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const int tm = t / p.tiles_n, tn = t - tm * p.tiles_n;
    const int m0 = tm * bm + 64 * wmi, n0 = tn * bn + WGN * wni;
    mbar_wait(full + st, ph);
    if (p.gran) fence_async();
    const uint8_t* as = ring + st * p.stage + wmi * 64 * SW;
    // staging tile `buf`, free once the stores of the tile nbuf back have
    // read it (lane 0 issued them), laid out as the output map's 128-byte
    // swizzle: 16-byte chunk q of row r at q ^ (r % 8)
    uint8_t* stg = stg0 + buf * p.out_bytes;
    if (lane == 0) wait_staging(p.nbuf);
    bar_sync(1 + wg);
#pragma unroll 1
    for (int h = 0; h < NH; ++h) {
      const uint8_t* bs = g_res + (n0 + h * HN) * SW;
      fence_acc(acc);
      mma_fence();
#pragma unroll
      for (int ks = 0; ks < SW / 32; ++ks)
        if (ks < p.ksteps)
          mma<HN, 0>(acc, desc(as + 32 * ks, 16, sbo, SW), desc(bs + 32 * ks, 16, sbo, SW),
                     ks != 0);
      mma_commit();
      fence_acc(acc);
      mma_wait<0>();
      fence_acc(acc);
      if (h == NH - 1 && lane == 0) mbar_arrive(empty + st);
      // epilogue: f32 -> bf16, requantized first when asked
#pragma unroll
      for (int j = 0; j < HN / 8; ++j) {
        float v[4] = {acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]};
        if (epilogue) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float q = rintf(v[e] / scale);
            q = q < lo ? lo : (q > hi ? hi : q);
            v[e] = q * scale;
          }
        }
        const int jj = h * (HN / 8) + j;
        uint8_t* at =
            stg + (jj >> 3) * kOutBoxBytes + ((((jj & 7) ^ (r0 & 7)) << 4) | (cb * 2));
        *reinterpret_cast<__nv_bfloat162*>(at + r0 * 128) = __floats2bfloat162_rn(v[0], v[1]);
        *reinterpret_cast<__nv_bfloat162*>(at + (r0 + 8) * 128) =
            __floats2bfloat162_rn(v[2], v[3]);
      }
      // this product's boxes go out while the next one runs
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_sync(1 + wg);
      if (lane == 0 && m0 < p.a)
        for (int i = h * HN / kOutBox; i < (h + 1) * HN / kOutBox; ++i)
          if (n0 + kOutBox * i < p.d)
            tma_store_3d(&ty, stg + i * kOutBoxBytes, n0 + kOutBox * i, m0, grp);
    }
    if (lane == 0) bulk_commit();
    if (++st == p.stages) {
      st = 0;
      ph ^= 1;
    }
    if (++buf == p.nbuf) buf = 0;
  }
  if (lane == 0) bulk_wait();
}

template <int WGN, int SW>
const void* mma_fn() {
  return (const void*)pe1_mma_kernel<WGN, SW>;
}

// The instance for the plan's (wgn, sw), or null.
const void* pick_mma(int wgn, int sw) {
#define PE1_MMA_CASE(N)                       \
  if (wgn == N) {                             \
    if (sw == 32) return mma_fn<N, 32>();     \
    if (sw == 64) return mma_fn<N, 64>();     \
    if (sw == 128) return mma_fn<N, 128>();   \
  }
  PE1_MMA_CASE(64)
  PE1_MMA_CASE(128)
  PE1_MMA_CASE(256)
#undef PE1_MMA_CASE
  return nullptr;
}

int cdiv(int n, int m) { return (n + m - 1) / m; }

}  // namespace

extern "C" {

// z (groups, a, b, c), g (groups, b, d, c), y (groups, a, d): contiguous
// device arrays of dtype (0 f32, 1 bf16); `plan` is 16 int32
// (kernels/ttm_pe1.py PLAN_FIELDS), one group's. epilogue != 0 requantizes
// to the `bits`-bit pow-2 grid at the f32 scale_log2 `step` (a device
// pointer). Returns cudaGetLastError() after the launch.
int pe1(const void* z, const void* g, void* y, int dtype, const int* fields, int epilogue,
        const void* step, int bits, int groups, void* stream) {
  Plan p;
  memcpy(&p, fields, sizeof(Plan));
  if (groups < 1 || groups > 65535) return (int)cudaErrorInvalidValue;
  if (p.grid == 0) return (int)cudaSuccess;
  const int es = dtype == tt_contract::F32 ? 4 : 2;
  const bool ok = (dtype == tt_contract::F32 || dtype == tt_contract::BF16) &&
                  p.threads >= 32 && p.threads <= kMaxThreads && p.threads % 32 == 0 &&
                  p.td >= 1 && p.ta >= 1 && p.td * p.ta <= p.threads &&
                  p.tiles_a * p.tiles_d == p.grid && p.zs_bytes % 16 == 0 &&
                  p.zs_bytes >= p.rm * p.ta * BK * es &&
                  p.smem >= p.zs_bytes + BK * 4 * p.td * 4 && p.smem <= tt_contract::kMaxSmem &&
                  (p.gz == 16 || p.gz == 8 || p.gz == 4 || p.gz == 2) &&
                  (p.gg == 16 || p.gg == 8 || p.gg == 4 || p.gg == 2) && p.gz >= es &&
                  p.gg >= es;
  if (!ok || (epilogue && (bits < 2 || bits > 16 || step == nullptr)))
    return (int)cudaErrorInvalidValue;
  const void* fn = dtype == tt_contract::F32 ? pick<float>(p.rm) : pick<__nv_bfloat16>(p.rm);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  if (p.smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return (int)e;
  }
  const float lo = epilogue ? -ldexpf(1.f, bits - 1) : 0.f;
  const float hi = epilogue ? ldexpf(1.f, bits - 1) - 1.f : 0.f;
  void* args[] = {&z, &g, &y, &p, &epilogue, &step, (void*)&lo, (void*)&hi};
  const cudaError_t e =
      cudaLaunchKernel(fn, dim3((unsigned)p.grid, (unsigned)groups), dim3((unsigned)p.threads),
                       args, (size_t)p.smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The tensor-core route: z (groups, a, 1, c), g (groups, 1, d, c), y
// (groups, a, d), contiguous bf16, y 16-byte aligned, z and g 16-byte
// aligned or on their granules (every group's start too); `plan` is 20
// int32 (kernels/ttm_pe1.py MMA_FIELDS), one group's; the epilogue as
// `pe1`'s. Returns cudaGetLastError() after the launch.
int pe1_mma(const void* z, const void* g, void* y, const int* fields, int epilogue,
            const void* step, int bits, int groups, void* stream) {
  MmaPlan p;
  memcpy(&p, fields, sizeof(MmaPlan));
  if (groups < 1 || groups > 65535) return (int)cudaErrorInvalidValue;
  if (p.tiles == 0) return (int)cudaSuccess;
  const int nwg = p.wm * p.wn;
  // rows of c off the TMA: even c on 4- or 8-byte granules of both operands
  const bool rows = p.gran ? (p.gran == 4 || p.gran == 8) && p.c >= 2 && (p.c * 2) % p.gran == 0
                           : p.c >= 8 && p.c % 8 == 0;
  const uintptr_t zg = reinterpret_cast<uintptr_t>(z) | reinterpret_cast<uintptr_t>(g) |
                       (groups > 1 ? (uintptr_t)p.a * p.c * 2 | (uintptr_t)p.d * p.c * 2 : 0);
  const bool ok =
      (p.wgn == 64 || p.wgn == 128 || p.wgn == 256) && (p.sw == 32 || p.sw == 64 || p.sw == 128) &&
      p.a >= 1 && rows && p.d >= 8 && p.d % 8 == 0 && p.ksteps >= 1 &&
      p.ksteps * 32 <= p.sw && p.ksteps * 16 >= p.c && nwg >= 1 && nwg <= 2 &&
      p.threads == nwg * 128 + 32 && p.tiles_m == cdiv(p.a, 64 * p.wm) &&
      p.tiles_n * p.wgn * p.wn >= p.d && p.tiles == p.tiles_m * p.tiles_n && p.grid >= 1 &&
      p.grid <= p.tiles && p.stages >= 2 && (p.nbuf == 1 || p.nbuf == 2) &&
      p.stage == 64 * p.wm * p.sw && p.g_bytes == p.tiles_n * p.wn * p.wgn * p.sw &&
      p.out_bytes == 64 * p.wgn * 2 &&
      p.smem >= 1024 + p.g_bytes + p.stages * p.stage + nwg * p.nbuf * p.out_bytes +
                    16 * p.stages + 8 &&
      p.smem <= tt_mma::kMaxSmem && zg % (p.gran ? p.gran : 16) == 0 &&
      reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (!ok || (epilogue && (bits < 2 || bits > 16 || step == nullptr)))
    return (int)cudaErrorInvalidValue;
  const void* fn = pick_mma(p.wgn, p.sw);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  CUtensorMap tz, tg, ty;  // Z's and G's maps unused (zero) on granules
  memset(&tz, 0, sizeof(tz));
  memset(&tg, 0, sizeof(tg));
  if ((!p.gran && (!tt_mma::map_3d(&tz, z, p.c, p.a, groups, (uint64_t)p.c * 2, p.sw / 2,
                                   64 * p.wm, p.sw) ||
                   !tt_mma::map_3d(&tg, g, p.c, p.d, groups, (uint64_t)p.c * 2, p.sw / 2, p.wgn,
                                   p.sw))) ||
      !tt_mma::map_3d(&ty, y, p.d, p.a, groups, (uint64_t)p.d * 2, kOutBox, 64, 128))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (e != cudaSuccess) return (int)e;
  const float lo = epilogue ? -ldexpf(1.f, bits - 1) : 0.f;
  const float hi = epilogue ? ldexpf(1.f, bits - 1) - 1.f : 0.f;
  void* args[] = {&tz, &tg, &ty, (void*)&z, (void*)&g,
                  &p, &epilogue, &step, (void*)&lo, (void*)&hi};
  e = cudaLaunchKernel(fn, dim3((unsigned)p.grid, (unsigned)groups), dim3((unsigned)p.threads),
                       args, (size_t)p.smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
