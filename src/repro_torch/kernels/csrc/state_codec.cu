// Recurrent-state pool codec, grouped by decode step: one launch decodes
// every state tensor of every layer for all slots before the step's first
// layer (st_dec_group), one launch encodes every layer's new state into the
// pool after its last layer (st_enc_group), each (layer, slot) row under its
// own pow-2 scale, chosen on the device.
//
// Replaces: repro/numerics/pallas_backend.py `_p2_dec_rows_kernel` (:196)
// and `_p2_enc_rows_kernel` (:189) as the reference's decode step runs them
// on the state pool (repro/serve/state_cache.py read_layer / write_layer,
// called per (layer, state tensor) from the jitted step at
// repro/serve/engine.py:457-511: decode every slot's state of a layer,
// choose each slot's scale as per_tensor_max of its new state, encode, keep
// the inactive lanes' codes and scale). The first port ran them as
// pow2_rows.cu p2_dec_rows / p2_enc_rows, one launch per (layer, tensor)
// each way (72 + 72 a rwkv6-1.6b decode step), with ~6 eager kernels
// choosing each scale and two where + copy_ pairs masking the inactive
// lanes, every launch at launch latency.
//
// Why a step can be grouped: in a decode step layer l's state is read only
// by layer l and what layer l writes is read only by the next step, so all
// layers' states can be decoded before the first layer and every new state
// encoded after the last, each value's arithmetic unchanged.
//
// Numerics (bit-identical to the per-layer route on the card):
//   decode  y = T(float(q) * 2^s)                        p2_dec_rows's
//   encode  row (l, b), only where active[b] is set (read on the device):
//           m = max |x| in f32
//           s = ceil(log2f(fmaxf(m, 1e-8) * (1 / qmax)))
//           q = Q(clamp(rint(x / 2^s), lo, hi))          p2_enc_rows's
// The scale step is the route this kernel replaces on the card, op for op:
// PyTorch on CUDA divides by a Python scalar as a multiply by its f32
// reciprocal, then log2f and ceilf (no --use_fast_math), as kv_prefill.cu
// derives it. A NaN in the max is outside that match: fmaxf drops it,
// PyTorch's amax keeps it. 2^s is pow2_codes.cuh's pow2_step. For an
// integer |s| <= 126 the encode multiplies by 2^-s: x * 2^-s and x / 2^s
// round the same exact value once, as 2^s and 2^-s are both normal f32;
// any other s (+inf from an infinite max, 127 or 128 at 2 bits) divides as
// p2_enc_rows does. An inactive row writes nothing.
//
// Bound on the H100: bytes. Each code is read once and each value written
// once by the decode, each value read once and each code written once by
// the encode (the maximum's pass and the encode's pass read the same
// values; counted once). A rwkv6-1.6b decode step moves 24 x 8 x (131,072
// x 5 + 2 x 2,048 x 3) B = 128.2 MB each way, 38.3 us at 3.35 TB/s; jamba's
// period (7 Mamba layers, 8 slots) 56 x (262,144 x 5 + 49,152 x 3) B = 81.7
// MB each way, 24.4 us.
//
// Design. Both kernels take their table by value (__grid_constant__, within
// the 4 KB of a launch's parameters): nothing is copied to the device and
// nothing read back, so a step stays capturable. kernels/grouped.py's
// st_dec_plan / st_enc_plan chunk a table that would overflow.
// - st_dec_group: an entry is a pool tensor (L, B, *feat) of int8 codes and
//   its (L, B) scales, decoded into an (L, B, *feat) workspace of its own
//   dtype. Its work is split in units of 16 codes (one 16-byte word) that
//   never straddle a row, so a unit reads one scale; a CTA takes a tile of
//   kDecTile units at a time, grid-stride over the launch's tiles, and
//   finds its entry by a binary search of the tile prefix. A tile's codes
//   are one contiguous run. Where rows are whole 16-byte words of codes
//   and the bases aligned, lane after lane takes the 4 (f32) or 8 (bf16)
//   codes of one 16-byte word of values, so every load and store of a warp
//   is whole lines, kDecPer words a thread in flight; else element by
//   element. (A whole unit a thread would store its 64 bytes of f32 as
//   four words 64 bytes apart across the warp, each store touching half
//   of 32 sectors.)
// - st_enc_group: a task is one row (a (layer, slot) of one tensor), or for
//   small rows a group of kCluster of them. The launch is a grid of thread
//   block clusters of kCluster = 16 CTAs (the non-portable size the H100
//   allows: twice the portable 8 halves each CTA's part of a large row,
//   32 KB of rwkv6's wkv and 64 KB of jamba's h). A row of at least 64 KB
//   of values (rwkv6's wkv 512 KB, jamba's
//   h 1 MB and conv 96 KB) takes a cluster: each CTA reduces |x| over its
//   sixteenth of the row's units, the cluster's maximum is combined through
//   distributed shared memory after a cluster barrier, every CTA forms the
//   scale (rank 0 writes it) and encodes its sixteenth, lane after lane a
//   16-byte word of values in both passes (4 or 8 bytes of codes stored).
//   A smaller row (rwkv6's shift, 4 KB)
//   takes one CTA, which reduces with a block reduction and no cluster
//   barrier, so small rows cost no cluster of idle CTAs: the kCluster CTAs
//   of a small task each take a row of their own. A row whose slot is
//   inactive returns before its first load (the whole cluster of a large
//   row sees the same flag). The table describes each pool tensor once,
//   from the first layer it covers, and gives each (layer, tensor) only its
//   new state's pointer and slot stride: the mixers' outputs are used where
//   they lie (the Mamba conv state is a strided view).
//   Where a CTA's part is at most 64 KB of values (grouped.st_enc_plan
//   decides from the shapes: rwkv6's 32 KB, jamba's 64 KB) the STAGE
//   instantiation keeps it in shared memory between the passes; a larger
//   part is re-read from global memory, L2-warm, as kv_prefill.cu does.
//   chip_smoke.py's state group phase times the re-read beside the staged
//   pass at rwkv6's and jamba's step: 69.0 / 61.2 us against 64.3 / 57.1
//   (NVIDIA H100 80GB HBM3, 700 W).

#include <cooperative_groups.h>

#include "pow2_codes.cuh"

namespace {

using namespace pow2_codes;
namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kUnit = 16;        // codes a unit: one 16-byte word of int8
constexpr int kCap = 16;         // pool tensors a launch (grouped.ST_CAP)
constexpr int kPtrCap = 160;     // new states an encode launch (grouped.ST_PTR_CAP)
constexpr int kCluster = 16;     // CTAs a large row (grouped.ST_CLUSTER; past the portable 8)
constexpr int kDecTile = 1024;   // units a decode tile (grouped.ST_TILE)
constexpr int kDecPer = 8;       // 16-byte words of values a thread has in flight

// The decode's table: entry e's rows r < units / ceil(F / kUnit) hold F
// codes at q + r * F, scale s[r], values at y + r * F.
struct DecGroup {
  const int8_t* q[kCap];
  const float* s[kCap];
  void* y[kCap];
  int units[kCap];               // rows * ceil(F / kUnit)
  int tile_end[kCap];            // prefix sum of ceil(units / kDecTile)
  int feat[kCap];                // F
  int dtype[kCap];               // of y: F32, BF16, F16
  int count;
};

// The encode's table: piece e covers `rows` = layers x slots rows of one pool
// tensor from its first layer l0 here; row r = l * slots + b writes codes at
// q + r * F and its scale at s + r (q, s already at layer l0) from slot b's
// row of the new state src[ptr0 + l] + b * sstride[ptr0 + l].
struct EncGroup {
  int8_t* q[kCap];
  float* s[kCap];
  int feat[kCap];
  int dtype[kCap];               // of the new states
  int rows[kCap];
  int ptr0[kCap];
  int big[kCap];                 // a cluster a row, else a CTA a row
  int task_end[kCap];            // prefix sum of the pieces' tasks
  const void* src[kPtrCap];
  long long sstride[kPtrCap];    // elements between two slots' rows
  const unsigned char* active;   // (slots,) bool, on the device
  int slots;
  int count;
  float lo, hi, inv_qmax;
};

static_assert(sizeof(DecGroup) <= 4096, "the decode table must fit a launch's parameters");
static_assert(sizeof(EncGroup) <= 4096, "the encode table must fit a launch's parameters");

// the first entry whose prefix ends past t
__device__ __forceinline__ int find_entry(const int* end, int count, int t) {
  int e = 0, top = count - 1;
  while (e < top) {
    const int mid = (e + top) >> 1;
    if (end[mid] > t) top = mid; else e = mid + 1;
  }
  return e;
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// ---- decode ---------------------------------------------------------------

// the first code of unit u of an entry whose rows hold F codes in upr units
__device__ __forceinline__ int code_of(int u, int F, int upr) {
  const int r = u / upr;
  return r * F + (u - r * upr) * kUnit;
}

__device__ __forceinline__ float code_at(uint32_t w, int k) {
  return (float)(int8_t)(w >> (8 * k));            // byte k, sign-extended
}

__device__ __forceinline__ uint32_t bits16(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }
__device__ __forceinline__ uint32_t bits16(__half v) { return __half_as_ushort(v); }

// C = 16 / sizeof(T) codes (one word of 4 or two of 8 bytes) as one 16-byte
// word of values
template <typename T> struct Codes;
template <> struct Codes<float> {
  using W = uint32_t;
  static __device__ __forceinline__ uint4 values(W c, float step) {
    float4 o = make_float4(code_at(c, 0) * step, code_at(c, 1) * step, code_at(c, 2) * step,
                           code_at(c, 3) * step);
    return *reinterpret_cast<uint4*>(&o);
  }
};
template <typename H> struct Codes16 {
  using W = uint2;
  static __device__ __forceinline__ uint32_t pair(uint32_t c, int k, float step) {
    return bits16(from_f32<H>(code_at(c, k) * step)) |
           bits16(from_f32<H>(code_at(c, k + 1) * step)) << 16;
  }
  static __device__ __forceinline__ uint4 values(W c, float step) {
    return make_uint4(pair(c.x, 0, step), pair(c.x, 2, step), pair(c.y, 0, step),
                      pair(c.y, 2, step));
  }
};
template <> struct Codes<__nv_bfloat16> : Codes16<__nv_bfloat16> {};
template <> struct Codes<__half> : Codes16<__half> {};

// One tile of entry e: units ti * kDecTile .. , whose codes are one
// contiguous run (units follow each other along the rows, and rows along
// the tensor). Where every row is whole 16-byte words of codes (F % 16 == 0,
// aligned bases) lane after lane takes C codes and stores one 16-byte word
// of values, kDecPer words a thread in flight; else element by element.
template <typename T>
__device__ __forceinline__ void dec_tile(const DecGroup& g, int e, int ti) {
  const int F = g.feat[e], units = g.units[e];
  const int upr = (F + kUnit - 1) / kUnit;
  const int u1 = min((ti + 1) * kDecTile, units);
  const int c0 = code_of(ti * kDecTile, F, upr);
  const int c1 = code_of(u1, F, upr);
  const int8_t* __restrict__ q = g.q[e];
  const float* __restrict__ s = g.s[e];
  T* __restrict__ y = static_cast<T*>(g.y[e]);
  if (F % kUnit == 0 && aligned(q, 16) && aligned(y, 16)) {
    using C = Codes<T>;
    constexpr int kC = 16 / sizeof(T);
    for (int c = c0 + (int)threadIdx.x * kC; c < c1; c += kDecPer * kThreads * kC) {
      typename C::W w[kDecPer];
      float step[kDecPer];
#pragma unroll
      for (int k = 0; k < kDecPer; ++k) {
        const int ck = c + k * kThreads * kC;
        if (ck < c1) {
          w[k] = __ldg(reinterpret_cast<const typename C::W*>(q + ck));
          step[k] = pow2_step(__ldg(s + ck / F));
        }
      }
#pragma unroll
      for (int k = 0; k < kDecPer; ++k) {
        const int ck = c + k * kThreads * kC;
        if (ck < c1) reinterpret_cast<uint4*>(y + ck)[0] = C::values(w[k], step[k]);
      }
    }
    return;
  }
  for (int c = c0 + (int)threadIdx.x; c < c1; c += kThreads)
    y[c] = from_f32<T>(to_f32(q[c]) * pow2_step(__ldg(s + c / F)));
}

template <typename Q>
__global__ void __launch_bounds__(kThreads)
    st_dec_group_kernel(const __grid_constant__ DecGroup g) {
  const int tiles = g.tile_end[g.count - 1];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int e = find_entry(g.tile_end, g.count, tile);
    const int ti = tile - (e ? g.tile_end[e - 1] : 0);
    switch (g.dtype[e]) {
      case F32: dec_tile<float>(g, e, ti); break;
      case BF16: dec_tile<__nv_bfloat16>(g, e, ti); break;
      default: dec_tile<__half>(g, e, ti); break;
    }
  }
}

// ---- encode ---------------------------------------------------------------

struct Shared {
  float warp_part[kThreads / 32];
  float cta_max;
  float scale;
};

// V = 16 / sizeof(T) codes of one 16-byte word of values, stored as one
// word of V bytes
template <typename T> struct CodeWord;
template <> struct CodeWord<float> {
  using W = uint32_t;
  static __device__ __forceinline__ W pack(const uint32_t* c) {
    return c[0] | c[1] << 8 | c[2] << 16 | c[3] << 24;
  }
};
template <typename H> struct CodeWord16 {
  using W = uint2;
  static __device__ __forceinline__ W pack(const uint32_t* c) {
    return make_uint2(c[0] | c[1] << 8 | c[2] << 16 | c[3] << 24,
                      c[4] | c[5] << 8 | c[6] << 16 | c[7] << 24);
  }
};
template <> struct CodeWord<__nv_bfloat16> : CodeWord16<__nv_bfloat16> {};
template <> struct CodeWord<__half> : CodeWord16<__half> {};

// One CTA's part of a row: its values from unit u0 to u1 (16 a unit) of x
// (F values) into q, the scale into *sc (rank 0 of a large row's cluster,
// or the CTA of a small row). Lane after lane takes one 16-byte word of
// values, so both passes load and store whole lines. STAGE: `stage` holds
// the CTA's words between the passes.
template <typename T, bool STAGE>
__device__ __forceinline__ void enc_row(const EncGroup& g, const T* __restrict__ x,
                                        int8_t* __restrict__ q, float* sc, int F, int u0,
                                        int u1, bool big, Shared& sh, uint4* stage) {
  constexpr int V = 16 / sizeof(T);             // values a 16-byte word
  const bool vec = F % kUnit == 0 && aligned(x, 16) && aligned(q, 16);
  const int i0 = u0 * kUnit, i1 = min(u1 * kUnit, F);   // this CTA's values
  const uint4* __restrict__ xw = reinterpret_cast<const uint4*>(x);

  // ---- max |x| over this CTA's values
  float m = 0.f;
  if (vec) {
#pragma unroll 4
    for (int w = i0 / V + (int)threadIdx.x; w < i1 / V; w += kThreads) {
      const uint4 v = __ldg(xw + w);
      if (STAGE) stage[w - i0 / V] = v;
      const T* t = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int k = 0; k < V; ++k) m = fmaxf(m, fabsf(to_f32(t[k])));
    }
  } else {
    for (int i = i0 + (int)threadIdx.x; i < i1; i += kThreads) m = fmaxf(m, fabsf(to_f32(x[i])));
  }
  m = warp_max(m);
  if ((threadIdx.x & 31) == 0) sh.warp_part[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) v = fmaxf(v, sh.warp_part[w]);
    sh.cta_max = v;
  }
  if (big) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (threadIdx.x == 0) {
      float v = 0.f;
      for (int r = 0; r < kCluster; ++r) v = fmaxf(v, *cluster.map_shared_rank(&sh.cta_max, r));
      sh.scale = ceilf(log2f(fmaxf(v, 1e-8f) * g.inv_qmax));
      if (cluster.block_rank() == 0) *sc = sh.scale;
    }
    // done reading the others' maxima: they may leave once all have arrived
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  } else if (threadIdx.x == 0) {
    sh.scale = ceilf(log2f(fmaxf(sh.cta_max, 1e-8f) * g.inv_qmax));
    *sc = sh.scale;
  }
  __syncthreads();

  // ---- encode this CTA's values
  const float s = sh.scale;
  const bool mul = fabsf(s) <= 126.f;
  const float f = mul ? pow2_step(-s) : pow2_step(s);
  const float lo = g.lo, hi = g.hi;
  auto enc = [mul, f, lo, hi](float v) {
    return (uint32_t)(uint8_t)to_code<int8_t>(fminf(fmaxf(rintf(mul ? v * f : v / f), lo), hi));
  };
  if (vec) {
    using CW = CodeWord<T>;
#pragma unroll 4
    for (int w = i0 / V + (int)threadIdx.x; w < i1 / V; w += kThreads) {
      const uint4 v = STAGE ? stage[w - i0 / V] : __ldg(xw + w);
      const T* t = reinterpret_cast<const T*>(&v);
      uint32_t c[V];
#pragma unroll
      for (int k = 0; k < V; ++k) c[k] = enc(to_f32(t[k]));
      reinterpret_cast<typename CW::W*>(q)[w] = CW::pack(c);
    }
  } else {
    for (int i = i0 + (int)threadIdx.x; i < i1; i += kThreads) q[i] = (int8_t)enc(to_f32(x[i]));
  }
  if (big) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <typename Q, bool STAGE>
__global__ void __launch_bounds__(kThreads)
    st_enc_group_kernel(const __grid_constant__ EncGroup g) {
  __shared__ Shared sh;
  extern __shared__ uint4 stage[];
  const int task = blockIdx.x / kCluster;
  const int rank = blockIdx.x - task * kCluster;   // the cluster spans kCluster CTAs in x
  const int e = find_entry(g.task_end, g.count, task);
  const int t = task - (e ? g.task_end[e - 1] : 0);
  const bool big = g.big[e];
  const int row = big ? t : t * kCluster + rank;
  if (row >= g.rows[e]) return;                  // a small task's spare CTA
  const int l = row / g.slots, b = row - l * g.slots;
  if (!__ldg(g.active + b)) return;              // inactive: the whole cluster leaves
  const int F = g.feat[e];
  const int units = (F + kUnit - 1) / kUnit;
  int u0 = 0, u1 = units;
  if (big) {
    const int per = (units + kCluster - 1) / kCluster;
    u0 = min(rank * per, units);
    u1 = min(u0 + per, units);
  }
  Q* q = g.q[e] + (long long)row * F;
  float* sc = g.s[e] + row;
  const int p = g.ptr0[e] + l;
  const long long off = (long long)b * g.sstride[p];
  switch (g.dtype[e]) {
    case F32:
      enc_row<float, STAGE>(g, static_cast<const float*>(g.src[p]) + off, q, sc, F, u0, u1, big,
                            sh, stage);
      break;
    case BF16:
      enc_row<__nv_bfloat16, STAGE>(g, static_cast<const __nv_bfloat16*>(g.src[p]) + off, q, sc,
                                    F, u0, u1, big, sh, stage);
      break;
    default:
      enc_row<__half, STAGE>(g, static_cast<const __half*>(g.src[p]) + off, q, sc, F, u0, u1,
                             big, sh, stage);
      break;
  }
}

template <bool STAGE>
int launch_enc(const EncGroup& g, int tasks, int smem, cudaStream_t st) {
  auto* kernel = st_enc_group_kernel<int8_t, STAGE>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  if (STAGE) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(tasks * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = STAGE ? smem : 0;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, g);
}

inline bool valid_dtype(long long d) { return d >= F32 && d <= F16; }

}  // namespace

extern "C" {

// table: count rows of 7 long longs, one a pool tensor: codes (int8, rows x
// F), scales (f32, rows), values (dtype, rows x F), units (rows *
// ceil(F / 16)), tile_end (the prefix of ceil(units / 1024)), F, dtype (0
// f32, 1 bf16, 2 f16). count in [1, 16]. Returns cudaGetLastError() after
// the launch.
int st_dec_group(const long long* table, int count, void* stream) {
  if (count < 1 || count > kCap) return (int)cudaErrorInvalidValue;
  DecGroup g{};
  g.count = count;
  for (int e = 0; e < count; ++e) {
    const long long* t = table + 7 * e;
    if (t[3] < 0 || t[4] < (e ? g.tile_end[e - 1] : 0) || t[5] < 1 || !valid_dtype(t[6]))
      return (int)cudaErrorInvalidValue;
    g.q[e] = reinterpret_cast<const int8_t*>(t[0]);
    g.s[e] = reinterpret_cast<const float*>(t[1]);
    g.y[e] = reinterpret_cast<void*>(t[2]);
    g.units[e] = (int)t[3];
    g.tile_end[e] = (int)t[4];
    g.feat[e] = (int)t[5];
    g.dtype[e] = (int)t[6];
  }
  const int tiles = g.tile_end[count - 1];
  if (tiles == 0) return (int)cudaSuccess;
  const int grid = tiles < 132 * 8 ? tiles : 132 * 8;   // resident blocks for every SM
  st_dec_group_kernel<int8_t><<<grid, kThreads, 0, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}

// pieces: count rows of 8 long longs: codes (int8, at the piece's first
// layer), scales (f32, at its first layer), F, dtype of the new states, rows
// (layers x slots), ptr0, big (0 / 1), task_end (the prefix of the pieces'
// tasks: rows for a big piece, ceil(rows / 8) for a small one); ptrs: nptr
// rows of 2 long longs, a new state's address and its slot stride in
// elements; active: (slots,) bool on the device. bits in [2, 8]. stage 1
// keeps each CTA's values in `smem` bytes of shared memory between its two
// passes (the yardstick), 0 re-reads them. count in [1, 16], nptr in [0,
// 160]. Returns the launch's error code, then cudaGetLastError().
int st_enc_group(const long long* pieces, int count, const long long* ptrs, int nptr,
                 const void* active, int slots, int bits, int stage, int smem, void* stream) {
  if (count < 1 || count > kCap || nptr < 0 || nptr > kPtrCap || slots < 1 || bits < 2 ||
      bits > 8 || smem < 0)
    return (int)cudaErrorInvalidValue;
  EncGroup g{};
  g.count = count;
  g.slots = slots;
  g.active = static_cast<const unsigned char*>(active);
  qrange_f32(bits, &g.lo, &g.hi);
  g.inv_qmax = 1.0f / g.hi;     // PyTorch's reciprocal of the f32 scalar qmax
  for (int e = 0; e < count; ++e) {
    const long long* t = pieces + 8 * e;
    const long long rows = t[4], ptr0 = t[5];
    if (t[2] < 1 || !valid_dtype(t[3]) || rows < 0 || ptr0 < 0 ||
        ptr0 + (rows + slots - 1) / slots > nptr || t[7] < (e ? g.task_end[e - 1] : 0))
      return (int)cudaErrorInvalidValue;
    g.q[e] = reinterpret_cast<int8_t*>(t[0]);
    g.s[e] = reinterpret_cast<float*>(t[1]);
    g.feat[e] = (int)t[2];
    g.dtype[e] = (int)t[3];
    g.rows[e] = (int)rows;
    g.ptr0[e] = (int)ptr0;
    g.big[e] = (int)t[6];
    g.task_end[e] = (int)t[7];
  }
  for (int i = 0; i < nptr; ++i) {
    g.src[i] = reinterpret_cast<const void*>(ptrs[2 * i]);
    g.sstride[i] = ptrs[2 * i + 1];
  }
  const int tasks = g.task_end[count - 1];
  if (tasks == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const int err = stage ? launch_enc<true>(g, tasks, smem, st) : launch_enc<false>(g, tasks, 0, st);
  return err ? err : (int)cudaGetLastError();
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
