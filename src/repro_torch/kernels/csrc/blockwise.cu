// Blockwise absmax codec: per-block f32 scale along the last axis of a
// contiguous (rows, last) f32 view, codes padded to nb * b per row, in any
// storage type of the spec (int8, int16, int32 or float32; pow2_codes.cuh).
//
// Replaces: repro/numerics/pallas_backend.py `_bw_enc_kernel` and
// `_bw_dec_kernel` (launched by `BlockwisePallas.encode` / `.decode`). On the
// training path these are the Adam moments (`optim/adam.py`, block 256: each
// of the 17 moment leaves decoded before the update and encoded after it, m
// and v) and the gradient wire (`optim/grad_compress.py`, block 1024: every
// floating gradient leaf flattened and round-tripped): a wire step's 55
// leaves are encoded in two launches (the 34 moments, the 21 wire leaves)
// and decoded in 55.
//
// Geometry (`codecs.blockwise_geometry`): b = min(block, max(1, last)),
// nb = ceil(last / b); elements past `last` in the last block are zero pads,
// and their codes are written as 0.
//
// Numerics (bit-identical to BlockwiseReference on finite inputs):
//   sc = max|x| / qmax                      IEEE f32 division
//   q  = Q(clip(rint(x / max(sc, 1e-20)), -qmax, qmax))   Q saturating
//   y  = float(q) * sc                       decode
// An all-zero block gives sc = 0 and codes 0. The build has no
// --use_fast_math, so `/` is the correctly rounded division (not a reciprocal
// multiply) and rintf rounds half to even, as jnp.round does. NaN is outside
// the lock: fmaxf drops a NaN operand, jnp.max keeps it.
//
// Bound on the H100: bytes (4 in, 1-4 + 4/b out per element, a handful of
// operations each) — and at the step's sizes (a few thousand elements a
// leaf) launch latency, far above either bound.
// Design, encode: one launch covers a group of up to kBwCap leaves of one
// storage type and bit width (the step's 34 moments, or its 21 wire
// leaves), described by a table passed by value as a __grid_constant__
// parameter (no copy to the device, no extra launch), sized to the group:
// the parameters' bytes cost launch time, so a single leaf passes a table
// of one. The work unit is a warp task, and its mapping follows each
// leaf's b: for b <= 32 a warp codes 32 consecutive blocks, one per lane
// (the moments' blocks are 1 or 16 wide, and a warp per block would leave
// most lanes idle); for b > 32 a warp codes one block, each lane striding
// over it, and the absmax is a shuffle reduction (16-byte loads and 4-code
// stores when b >= 128 and the rows are aligned). Either way the absmax
// pass's loads are unrolled so they issue together (a warp holds a block
// up to b = 1,024 in registers): at these sizes a chain of dependent
// loads, not bytes, is what a task waits on. Warps walk the tasks with a grid-stride
// loop and find their leaf by a binary search of the table's prefix of task
// counts, so both mappings live in one launch. Decode is one thread per
// output element (pads are never read back). No shared memory, no
// synchronisation beyond the warp shuffle.

#include "pow2_codes.cuh"

namespace {

using namespace pow2_codes;

constexpr int kThreads = 256;
constexpr float kScaleFloor = 1e-20f;

template <typename Q>
__device__ __forceinline__ Q bw_code(float v, float d, float qmax) {
  return to_code<Q>(fminf(fmaxf(rintf(v / d), -qmax), qmax));
}

constexpr int kBwCap = 48;      // leaves an encode launch takes
constexpr int kLaneBlock = 32;  // b <= kLaneBlock: a lane codes a block
constexpr int kWarpVecs = 8;    // b <= 4 * 32 * kWarpVecs: a warp codes a
                                // block from registers

// The encode group's table, passed by value: N entries, sized to the group
// (N = 1, 8 or kBwCap; 3 KB of the 4 KB parameter space at kBwCap, 72
// bytes at 1, since a launch's parameters cost launch time). task_end[e] is
// the prefix sum of the warp tasks of leaves 0..e: ceil(rows * nb / 32) for
// b <= 32, rows * nb for b > 32.
template <int N>
struct BwGroup {
  const float* x[N];           // (rows, last) f32
  void* q[N];                  // (rows, nb * b) codes
  float* sc[N];                // (rows, nb) scales
  long long rows[N], last[N], b[N], nb[N];
  long long task_end[N];
  int count;
  float qmax;
};

// block u = (row, j) of a leaf, coded by one lane (b <= 32): the absmax
// pass is unrolled, so its loads are independent and issue together; the
// coding pass (an IEEE division per element) stays a loop, which keeps the
// kernel's code small
template <typename Q>
__device__ __forceinline__ void bw_block_lane(const float* __restrict__ x, Q* __restrict__ q,
                                              float* __restrict__ sc, long long u,
                                              long long last, int b, long long nb,
                                              float qmax) {
  const long long r = u / nb, j = u % nb;
  const float* xr = x + r * last + j * b;
  const int n = (int)((last - j * b) < b ? (last - j * b) : b);   // real elements
  float amax = 0.f;
#pragma unroll
  for (int t = 0; t < kLaneBlock; ++t)
    if (t < n) amax = fmaxf(amax, fabsf(xr[t]));
  const float s = amax / qmax;
  const float d = fmaxf(s, kScaleFloor);
  Q* qr = q + r * nb * b + j * b;
  for (int t = 0; t < n; ++t) qr[t] = bw_code<Q>(xr[t], d, qmax);
  for (int t = n; t < b; ++t) qr[t] = Q(0);
  sc[u] = s;
}

__device__ __forceinline__ float absmax4(float4 v) {
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// block u = (row, j) of a leaf, coded by one warp (b > 32). Where the rows
// are aligned and b >= 128 (the wire's 1,024, the moments' 256), lanes take
// 16-byte vectors, all of a block up to b = 1,024 held in registers (one
// round of independent loads); elsewhere lanes stride over the block.
template <typename Q>
__device__ __forceinline__ void bw_block_warp(const float* __restrict__ x, Q* __restrict__ q,
                                              float* __restrict__ sc, long long u,
                                              long long last, int b, long long nb,
                                              float qmax, int lane) {
  const long long r = u / nb, j = u % nb;
  const long long c0 = j * b;
  const int n = (int)((last - c0) < b ? (last - c0) : b);   // real elements
  const float* xb = x + r * last + c0;
  Q* qb = q + r * nb * b + c0;
  // every block of the leaf starts on 16 bytes of x and 4 codes
  const bool vec = b >= 128 && b % 4 == 0 && last % 4 == 0 && aligned(x, 16) &&
                   aligned(q, 4 * sizeof(Q));
  if (vec && b <= 4 * 32 * kWarpVecs) {
    float4 v[kWarpVecs];
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < kWarpVecs; ++i) {
      const int k = 4 * (lane + 32 * i);
      if (k + 3 < n) {
        v[i] = reinterpret_cast<const float4*>(xb)[lane + 32 * i];
      } else {
        v[i].x = k < n ? xb[k] : 0.f;
        v[i].y = k + 1 < n ? xb[k + 1] : 0.f;
        v[i].z = k + 2 < n ? xb[k + 2] : 0.f;
        v[i].w = k + 3 < n ? xb[k + 3] : 0.f;
      }
      amax = fmaxf(amax, absmax4(v[i]));
    }
    const float s = warp_max(amax) / qmax;
    const float d = fmaxf(s, kScaleFloor);
#pragma unroll
    for (int i = 0; i < kWarpVecs; ++i) {
      const int k = 4 * (lane + 32 * i);
      if (k < b) {
        Vec4<Q> out;
        out.v[0] = k < n ? bw_code<Q>(v[i].x, d, qmax) : Q(0);
        out.v[1] = k + 1 < n ? bw_code<Q>(v[i].y, d, qmax) : Q(0);
        out.v[2] = k + 2 < n ? bw_code<Q>(v[i].z, d, qmax) : Q(0);
        out.v[3] = k + 3 < n ? bw_code<Q>(v[i].w, d, qmax) : Q(0);
        reinterpret_cast<Vec4<Q>*>(qb)[lane + 32 * i] = out;
      }
    }
    if (lane == 0) sc[u] = s;
    return;
  }
  float amax = 0.f;
  for (int t = lane; t < n; t += 32) amax = fmaxf(amax, fabsf(xb[t]));
  const float s = warp_max(amax) / qmax;
  const float d = fmaxf(s, kScaleFloor);
  for (int t = lane; t < b; t += 32) qb[t] = t < n ? bw_code<Q>(xb[t], d, qmax) : Q(0);
  if (lane == 0) sc[u] = s;
}

template <typename Q, int N>
__global__ void __launch_bounds__(kThreads)
    bw_enc_group_kernel(const __grid_constant__ BwGroup<N> g) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (blockDim.x / 32);
  const long long tasks = g.task_end[N == 1 ? 0 : g.count - 1];
  // warp-uniform: every lane of a warp walks the same tasks
  for (long long t = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32; t < tasks;
       t += warps) {
    // the first leaf whose tasks end past t; a table of one indexes its
    // entry with a constant, read straight from the parameter bank
    int e = 0, top = N == 1 ? 0 : g.count - 1;
    while (e < top) {
      const int mid = (e + top) / 2;
      if (g.task_end[mid] > t) top = mid; else e = mid + 1;
    }
    const long long local = t - (e ? g.task_end[e - 1] : 0);
    const int b = (int)g.b[e];
    const long long nb = g.nb[e];
    Q* q = static_cast<Q*>(g.q[e]);
    if (b <= kLaneBlock) {
      const long long u = local * 32 + lane;
      if (u < g.rows[e] * nb) bw_block_lane<Q>(g.x[e], q, g.sc[e], u, g.last[e], b, nb, g.qmax);
    } else {
      bw_block_warp<Q>(g.x[e], q, g.sc[e], local, g.last[e], b, nb, g.qmax, lane);
    }
  }
}

template <typename Q>
__global__ void bw_dec_kernel(const Q* __restrict__ q, const float* __restrict__ sc,
                              float* __restrict__ y, long long rows, long long last,
                              long long b, long long nb) {
  const long long n = rows * last;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const long long r = i / last, c = i % last;
    y[i] = to_f32(q[r * nb * b + c]) * __ldg(sc + r * nb + c / b);
  }
}

inline int grid_for(long long work) {
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = 132LL * 32;  // enough resident blocks for every SM
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : (int)blocks;
}

template <int N>
int bw_enc_launch(const long long* table, int count, int q_code, int bits, cudaStream_t st) {
  BwGroup<N> g{};
  long long prev = 0;
  for (int e = 0; e < count; ++e) {
    const long long* row = table + 8 * e;
    g.x[e] = (const float*)row[0];
    g.q[e] = (void*)row[1];
    g.sc[e] = (float*)row[2];
    const long long rows = g.rows[e] = row[3], last = g.last[e] = row[4];
    const long long b = g.b[e] = row[5], nb = g.nb[e] = row[6];
    g.task_end[e] = row[7];
    const long long units = rows * last == 0 ? 0 : rows * nb;
    if (rows < 0 || last < 0 ||
        (units && (b < 1 || nb < 1 || nb * b < last || (nb - 1) * b >= last)) ||
        g.task_end[e] - prev != (b <= kLaneBlock ? (units + 31) / 32 : units))
      return (int)cudaErrorInvalidValue;
    prev = g.task_end[e];
  }
  g.count = count;
  if (prev == 0) return (int)cudaSuccess;
  float lo;
  qrange_f32(bits, &lo, &g.qmax);
  return with_code(q_code, [&](auto qt) {
    using Q = decltype(qt);
    bw_enc_group_kernel<Q, N><<<grid_for(prev * 32), kThreads, 0, st>>>(g);
  });
}

}  // namespace

extern "C" {

// A group of `count` (1..kBwCap) leaves as rows of `table`: {x, q, sc,
// rows, last, b, nb, task_end} (pointers as integers; x: (rows, last) f32;
// q: (rows, nb * b) codes of q_code (0 int8, 1 int16, 2 int32, 3 f32); sc:
// (rows, nb) f32; task_end: the prefix sum of each leaf's warp tasks,
// kernels/grouped.py::bw_plan). qmax = 2^(bits-1) - 1 for bits in
// [2, code_bits(q_code)]. Returns cudaGetLastError() after the launch
// (none for a group with no elements).
int bw_enc_group(const long long* table, int count, int q_code, int bits, void* stream) {
  if (count < 1 || count > kBwCap || bits < 2 || bits > code_bits(q_code))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (count == 1) return bw_enc_launch<1>(table, count, q_code, bits, st);
  if (count <= 8) return bw_enc_launch<8>(table, count, q_code, bits, st);
  return bw_enc_launch<kBwCap>(table, count, q_code, bits, st);
}

// q: (rows, nb * b) codes of q_code; sc: (rows, nb) f32; y: (rows, last) f32.
int bw_dec(const void* q, int q_code, const void* sc, void* y, long long rows, long long last,
           long long b, long long nb, void* stream) {
  if (code_bits(q_code) == 0 || b < 1 || nb < 1 || nb * b < last || (nb - 1) * b >= last)
    return (int)cudaErrorInvalidValue;
  if (rows * last == 0) return (int)cudaSuccess;
  return with_code(q_code, [&](auto qt) {
    using Q = decltype(qt);
    bw_dec_kernel<Q><<<grid_for(rows * last), kThreads, 0, (cudaStream_t)stream>>>(
        (const Q*)q, (const float*)sc, (float*)y, rows, last, b, nb);
  });
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
