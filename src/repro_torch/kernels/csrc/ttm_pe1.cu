// PE1 (paper Eq. 5) with the FPGA PE's optional requantize-on-writeback
// epilogue:
//
//   Y(a, d) = sum_{b,c} Z(a, b, c) G(b, d, c)   [+ pow-2 requant]
//
// Replaces: repro/kernels/ttm_pe1.py:34 `_pe1_kernel` / `pe1_matmul`. On the
// training path it runs every TT matvec chain's first contraction: 6
// launches a step, at Z (a, 1, 16) x G (1, 256, 16) with a = 3584, 2048,
// 2048 and 64.
//
// Bound on the H100: bytes. With b = 1 and c = 16 each output is a 16-long
// dot product: a = 3584 stores 3.67 MB (1.1 us at 3.35 TB/s) for 29 MFLOP
// (0.44 us at the 67 TFLOP/s FP32 rate); at a = 64 the call is launch
// latency. What costs is getting every SM storing early: the CTA's loads,
// its few FMAs and its stores run one after another, so the design keeps
// each of them short and the grid wide.
//
// Design. Z and G are both contiguous along c, so the contraction walks
// (b, c) in chunks of BK = 16 with nested counters (no division in any
// loop). A CTA owns AT = rm * ta rows of a by DT = 4 * td columns of d; a
// thread keeps an rm x 4 register tile of f32 sums, its four columns
// adjacent so the output leaves as one float4 (8 bytes in bf16) store, and
// along a warp the columns come first, so the warp stores whole lines. Per
// chunk, Z's rows land in shared memory by 16-byte cp.async (8-, 4- or
// 2-byte granules where c, the tile and the pointer allow no more; ragged
// c is zero-filled) and are read as broadcasts; G's (d-tile, c-chunk)
// slice is read with vector loads, a batch of granules in flight per
// thread, widened to f32 and stored transposed (c-major), so each thread
// reads its four columns as one conflict-free float4. At the step's shapes
// G is 16 KB and one chunk. The tile and grid come from the pure function
// kernels/ttm_pe1.py::plan: up to 64 columns of d (td = 16 threads of
// four), 16 threads along a, and the largest row tile (rm <= 8) that still
// gives CTAs for 7/8 of the 132 SMs: a = 3584 and 2048 take 224 and 128
// CTAs of 64 x 64 outputs, a = 64 takes 16. Tried on the H100 at the
// step's shapes and dropped (probe runs, not kept): tiles of 256 columns,
// and reading Z and G straight into registers without shared memory; both
// were slower.
//
// Numerics: inputs f32 or bf16, products accumulated in f32 with FMA on the
// CUDA cores (no tensor cores, so no TF32), each output's (b, c) terms in
// increasing order: two launches give the same bits. The optional epilogue
// requantizes the f32 sum before the store exactly as
// Pow2Reference.epilogue / encode -> decode do:
//   clip(rintf(acc / 2^s), lo, hi) * 2^s, then cast to the output dtype,
// so the fused output is bit-identical to the unfused one passed through
// the codec. All index math is 32-bit (the wrapper refuses tensors of 2^31
// elements or more).

#include "tt_contract.cuh"

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

}  // namespace

extern "C" {

// z (a, b, c), g (b, d, c), y (a, d): contiguous device arrays of dtype
// (0 f32, 1 bf16); `plan` is 16 int32 (kernels/ttm_pe1.py PLAN_FIELDS).
// epilogue != 0 requantizes to the `bits`-bit pow-2 grid at the f32
// scale_log2 `step` (a device pointer). Returns cudaGetLastError() after
// the launch.
int pe1(const void* z, const void* g, void* y, int dtype, const int* fields, int epilogue,
        const void* step, int bits, void* stream) {
  Plan p;
  memcpy(&p, fields, sizeof(Plan));
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
  const cudaError_t e = cudaLaunchKernel(fn, dim3((unsigned)p.grid), dim3((unsigned)p.threads),
                                         args, (size_t)p.smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
