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
// and decoded in two (the same two sets).
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
// leaf) launch latency, far above either bound. Both directions therefore
// take a group of leaves in one launch: a table passed by value as a
// __grid_constant__ parameter (no copy to the device, no extra launch),
// sized to the group (1, 8 or kBwCap entries), since a launch's parameters
// cost launch time; a single leaf passes a table of one.
// Design, encode: one launch covers a group of up to kBwCap leaves of one
// storage type and bit width (the step's 34 moments, or its 21 wire
// leaves). The work unit is a warp task, and its mapping follows each
// leaf's b: for b <= 32 a warp codes 32 consecutive blocks, one per lane
// (the moments' blocks are 1 or 16 wide, and a warp per block would leave
// most lanes idle); for b > 32 a warp codes one block, each lane striding
// over it, and the absmax is a shuffle reduction (16-byte loads and 4-code
// stores when b >= 128 and the rows are aligned). Either way the absmax
// pass's loads are unrolled so they issue together (a warp holds a block
// up to b = 1,024 in registers): at these sizes a chain of dependent
// loads, not bytes, is what a task waits on. Warps walk the tasks with a grid-stride
// loop and find their leaf by a binary search of the table's prefix of task
// counts, so both mappings live in one launch.
// Design, stream tasks (the LM step: the embedding's and the head's m and v,
// (92544, 2048) and (2048, 92544) f32 at b = 256, and the wire's flattened
// leaves of 190M at b = 1,024; kernels/grouped.py plans them for leaves of
// at least STREAM_MIN elements in blocks of 256, 512 or 1,024 on rows of
// whole float4): there a warp per block holds b / 128 float4 a lane (at b
// = 256, 1 KB a warp) and codes it with nothing of the next block in
// flight; measured on the H100 (chip_smoke.py --codec-anatomy), the moment
// group ran at 1.91x its byte bound, 1.13x with its coding pass cut out.
// A stream task is 8 steps of 1,024 values, 1024 / b consecutive blocks a
// step, coded from 8 float4 a lane (the register tile sized to b: 2 float4
// a block at 256, 8 at 1,024). Each warp copies its steps into its own
// ring of 3 in shared memory with asynchronous 16-byte copies (cp.async,
// a lane reading back only its own slots, so no barrier), 2 steps ahead of
// its coding: the next steps' bytes arrive while the current one is coded,
// 8 KB a warp in flight that hold no registers. (Two steps held in
// registers instead took 128-146 registers and spilled: the IEEE division's
// slow-path call keeps its operands live.) The G blocks of a step reduce
// side by side (G shuffle trees interleaved); each code keeps the IEEE
// division (locked bit for bit to the reference), except where it rounds
// to a zero anyway (|x| < d / 4, bw_code_stream): a zero dividend takes
// the division's slow path, and on the LM step's own moments (60-98%
// zeros) that doubled the group's time. A task finds its first
// block's row by one 64-bit division and steps (row, block) after that; a
// padded row end is whole float4 of zeros, so no lane runs a scalar tail.
// Codes go out as 4-code stores, each block's scale from one lane.
// Design, decode: one launch covers up to kBwCap leaves, each entry with its
// own code type (a CTA-uniform switch), and writes every leaf's f32 values
// into ONE output buffer at the entry's offset (the wrapper hands out views
// of it: one allocation a launch, not one a leaf). The work unit is a tile
// of kDecTile consecutive output elements of one leaf (never two), a CTA's
// work at a time; CTAs walk the tiles grid-stride and find their leaf by a
// binary search of the tile prefix, as the encode does. Where b % 4 == 0,
// last % 4 == 0 and the codes start on 4 codes (the encode group puts each
// leaf on 16 bytes) a thread reads 4 codes in one load, all of one row and
// one block (one scale), and writes a float4; a leaf of last = 1 (a code
// and a scale a row) skips the index arithmetic and, where its scales
// start on 16 bytes, reads 4 of each a load; elsewhere threads take single
// elements, coalesced. Index arithmetic is 32-bit wherever a leaf's codes
// fit (a 64-bit division is a long software sequence, and a b = 1 leaf
// takes its divisions per element). Pads are never read. No shared
// memory, no synchronisation.

#include "pow2_codes.cuh"

namespace {

using namespace pow2_codes;

constexpr int kThreads = 256;
constexpr float kScaleFloor = 1e-20f;

template <typename Q>
__device__ __forceinline__ Q bw_code(float v, float d, float qmax) {
  return to_code<Q>(fminf(fmaxf(rintf(v / d), -qmax), qmax));
}

constexpr int kBwCap = 48;      // leaves a launch takes, either way
constexpr int kLaneBlock = 32;  // b <= kLaneBlock: a lane codes a block
constexpr int kWarpVecs = 8;    // b <= 4 * 32 * kWarpVecs: a warp codes a
                                // block from registers
constexpr int kStreamSteps = 8; // steps of a stream task: each step is
                                // kWarpVecs float4 a lane, 1024 / b blocks

// The encode group's table, passed by value: N entries, sized to the group
// (N = 1, 8 or kBwCap; 3.2 KB of the 4 KB parameter space at kBwCap, 80
// bytes at 1, since a launch's parameters cost launch time). task_end[e] is
// the prefix sum of the warp tasks of leaves 0..e: ceil(rows * nb / 32) for
// b <= 32, rows * nb for b > 32, and for a stream leaf ceil(rows * nb /
// (kStreamSteps * 1024 / b)).
template <int N>
struct BwGroup {
  const float* x[N];           // (rows, last) f32
  void* q[N];                  // (rows, nb * b) codes
  float* sc[N];                // (rows, nb) scales
  long long rows[N], last[N], b[N], nb[N];
  long long task_end[N];
  int stream[N];               // 1: the leaf's tasks are stream tasks
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

// bw_code for the stream tasks: an element with |v| < d / 4 codes as a zero
// with v's sign (rint of a quotient under 1/4), taken without dividing, for
// a zero or subnormal dividend sends the IEEE division down its slow path
// (the LM's moments are 60-98% zeros); every other element divides as
// bw_code does, v / d lying in [1/4, qmax]. Bit for bit bw_code's code.
template <typename Q>
__device__ __forceinline__ Q bw_code_stream(float v, float d, float qmax) {
  const bool small = fabsf(v) < 0.25f * d;
  const float q = rintf((small ? d : v) / d);
  return to_code<Q>(fminf(fmaxf(small ? copysignf(0.f, v) : q, -qmax), qmax));
}

// Real elements of block column j of a row of `last`, or 0 for block u past
// the leaf's `units`.
template <int V>
__device__ __forceinline__ int block_len(long long u, long long units, int j, long long last) {
  constexpr int b = 128 * V;
  const long long rest = last - (long long)j * b;
  return u < units ? (int)(rest < b ? rest : b) : 0;
}

// 16 bytes global -> shared without registers (LDGSTS), or 16 zero bytes
// where `real` is false (a source size of 0 reads nothing)
__device__ __forceinline__ void cp_async16(float4* dst, const float* src, bool real) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(real ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A warp's ring of kStages steps in shared memory, a step being kWarpVecs
// float4 a lane (slot i of lane l at step_base + 32 i + l: a lane reads
// back only what it copied, so no barrier is needed).
constexpr int kStepVecs = 32 * kWarpVecs;   // float4 a step
constexpr int kStages = 3;                  // steps in a warp's ring

// Issue the copies of the G blocks from block u on into `stage`: `off` is
// block u's first element in x and j its column; both advance by G blocks
// without a division (a row's end moves `off` to the next row's start).
template <int V>
__device__ __forceinline__ void stream_issue(const float* __restrict__ x, float4* stage,
                                             long long u, long long units, long long last,
                                             int nb, long long& off, int& j, int lane) {
  constexpr int b = 128 * V, G = kWarpVecs / V;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int n = block_len<V>(u + g, units, j, last);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int k = 4 * (lane + 32 * i);
      // last % 4 == 0: a float4 is all real or all pad (zeros)
      cp_async16(stage + 32 * (g * V + i) + lane, k < n ? x + off + k : x, k < n);
    }
    off += b;
    if (++j == nb) { j = 0; off += last - (long long)nb * b; }
  }
  cp_async_commit();
}

// Code the G blocks of a landed step from block u on (j: the first one's
// column): each block's absmax by a shuffle reduction (the G of them side
// by side), its scale, its b codes (pads 0) as 4-code stores, and lane g
// stores block g's scale.
template <typename Q, int V>
__device__ __forceinline__ void stream_code(const float4* stage, Q* __restrict__ q,
                                            float* __restrict__ sc, long long u,
                                            long long units, long long last, int nb, int& j,
                                            float qmax, int lane) {
  constexpr int b = 128 * V, G = kWarpVecs / V;
  float4 v[kWarpVecs];
#pragma unroll
  for (int i = 0; i < kWarpVecs; ++i) v[i] = stage[32 * i + lane];
  float amax[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    amax[g] = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) amax[g] = fmaxf(amax[g], absmax4(v[g * V + i]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int g = 0; g < G; ++g)
      amax[g] = fmaxf(amax[g], __shfl_xor_sync(0xffffffffu, amax[g], off));
  float mine = 0.f;
  bool mine_real = false;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int n = block_len<V>(u + g, units, j, last);
    if (++j == nb) j = 0;
    // an all-zero block's scale without the division (0 / qmax is +0)
    const float s = amax[g] > 0.f ? amax[g] / qmax : 0.f;
    const float d = fmaxf(s, kScaleFloor);
    if (n > 0) {
      Q* qb = q + (u + g) * b;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int k = 4 * (lane + 32 * i);
        const float4 e = v[g * V + i];
        Vec4<Q> out;
        const bool real = k < n;
        out.v[0] = real ? bw_code_stream<Q>(e.x, d, qmax) : Q(0);
        out.v[1] = real ? bw_code_stream<Q>(e.y, d, qmax) : Q(0);
        out.v[2] = real ? bw_code_stream<Q>(e.z, d, qmax) : Q(0);
        out.v[3] = real ? bw_code_stream<Q>(e.w, d, qmax) : Q(0);
        reinterpret_cast<Vec4<Q>*>(qb)[lane + 32 * i] = out;
      }
    }
    if (lane == g) { mine = s; mine_real = n > 0; }
  }
  if (mine_real) sc[u + lane] = mine;
}

// A stream task: kStreamSteps * G consecutive blocks of a leaf from block
// u0 on (b = 128 V). The warp's copies run kStages - 1 steps ahead of its
// coding through its ring (`ring`, kStages * kStepVecs float4 of shared
// memory), so the next steps' bytes arrive while the current step is
// coded, and the in-flight bytes hold no registers. One 64-bit division a
// task finds the first block's row. A leaf whose x or codes are not
// aligned for vectors takes its blocks one at a time on the strided warp
// path.
template <typename Q, int V>
__device__ __forceinline__ void bw_stream_task(const float* __restrict__ x, Q* __restrict__ q,
                                               float* __restrict__ sc, long long u0,
                                               long long units, long long last, long long nb,
                                               float qmax, int lane, float4* ring) {
  constexpr int b = 128 * V, G = kWarpVecs / V;
  if (!aligned(x, 16) || !aligned(q, 4 * sizeof(Q))) {
    for (long long u = u0; u < u0 + kStreamSteps * G && u < units; ++u)
      bw_block_warp<Q>(x, q, sc, u, last, b, nb, qmax, lane);
    return;
  }
  const long long r = u0 / nb;
  int j = (int)(u0 - r * nb), jc = j;
  long long off = r * last + (long long)j * b;
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k)
    stream_issue<V>(x, ring + k * kStepVecs, u0 + k * G, units, last, (int)nb, off, j, lane);
#pragma unroll 1
  for (int k = 0; k < kStreamSteps; ++k) {
    const int ahead = k + kStages - 1;
    if (ahead < kStreamSteps)
      stream_issue<V>(x, ring + (ahead % kStages) * kStepVecs, u0 + (long long)ahead * G,
                      units, last, (int)nb, off, j, lane);
    else
      cp_async_commit();   // an empty group keeps the count of groups in flight
    cp_async_wait<kStages - 1>();
    stream_code<Q, V>(ring + (k % kStages) * kStepVecs, q, sc, u0 + (long long)k * G, units,
                      last, (int)nb, jc, qmax, lane);
  }
}

template <typename Q>
__device__ __forceinline__ void bw_stream(const float* __restrict__ x, Q* __restrict__ q,
                                          float* __restrict__ sc, long long u0, long long units,
                                          long long last, int b, long long nb, float qmax,
                                          int lane, float4* ring) {
  switch (b) {   // warp-uniform; the plan gives stream tasks b in {256, 512, 1024}
    case 256: bw_stream_task<Q, 2>(x, q, sc, u0, units, last, nb, qmax, lane, ring); break;
    case 512: bw_stream_task<Q, 4>(x, q, sc, u0, units, last, nb, qmax, lane, ring); break;
    default: bw_stream_task<Q, 8>(x, q, sc, u0, units, last, nb, qmax, lane, ring); break;
  }
}

// STREAM: the group has stream leaves (an instantiation of its own, so a
// group without runs the other paths' code and registers alone); then two
// CTAs an SM (their rings fill 192 KB of shared memory), up to 128
// registers a thread, which the stream tasks use without spilling
template <typename Q, int N, bool STREAM>
__global__ void __launch_bounds__(kThreads, STREAM ? 2 : 1)
    bw_enc_group_kernel(const __grid_constant__ BwGroup<N> g) {
  // the warps' rings (dynamic shared memory of a STREAM launch)
  extern __shared__ float4 rings[];
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
    if (STREAM && g.stream[e]) {
      const long long u0 = local * kStreamSteps * (kWarpVecs * 128 / b);
      bw_stream<Q>(g.x[e], q, g.sc[e], u0, g.rows[e] * nb, g.last[e], b, nb, g.qmax, lane,
                   rings + (threadIdx.x / 32) * kStages * kStepVecs);
    } else if (b <= kLaneBlock) {
      const long long u = local * 32 + lane;
      if (u < g.rows[e] * nb) bw_block_lane<Q>(g.x[e], q, g.sc[e], u, g.last[e], b, nb, g.qmax);
    } else {
      bw_block_warp<Q>(g.x[e], q, g.sc[e], local, g.last[e], b, nb, g.qmax, lane);
    }
  }
}

constexpr int kDecTile = 4 * kThreads;   // output elements a CTA decodes

// The decode group's table, passed by value: N entries sized to the group
// (N = 1, 8 or kBwCap; 3.3 KB at kBwCap). tile_end[e] is the prefix sum of
// ceil(rows * last / kDecTile) of leaves 0..e.
template <int N>
struct BwdGroup {
  const void* q[N];            // (rows, nb * b) codes of code[e]
  const float* sc[N];          // (rows, nb) scales
  long long y_off[N];          // elements into y: the leaf's (rows, last)
  long long rows[N], last[N], b[N], nb[N];
  long long tile_end[N];
  int code[N];
  int count;
  float* y;                    // the launch's one f32 output buffer
};

// one tile of a leaf: outputs base .. base + kDecTile - 1 of its n, with
// index arithmetic in I (32-bit where the leaf's codes fit: a 64-bit
// division is a long software sequence, and b = 1 leaves take three an
// element)
template <typename Q, typename I>
__device__ __forceinline__ void bw_dec_tile(const Q* __restrict__ q, const float* __restrict__ sc,
                                            float* __restrict__ y, I base, I n, I last, I b,
                                            I nb) {
  const I row_codes = nb * b;
  if (last == 1) {
    // b = nb = 1 (the moments' (..., 1) leaves, a 0-d leaf): a code and a
    // scale a row, no index arithmetic
    if (n % 4 == 0 && aligned(q, 4 * sizeof(Q)) && aligned(sc, 16) && aligned(y, 16)) {
      const I i = base + 4 * (I)threadIdx.x;
      if (i < n) {
        const Vec4<Q> in = *reinterpret_cast<const Vec4<Q>*>(q + i);
        const float4 s = *reinterpret_cast<const float4*>(sc + i);
        float4 out;
        out.x = to_f32(in.v[0]) * s.x;
        out.y = to_f32(in.v[1]) * s.y;
        out.z = to_f32(in.v[2]) * s.z;
        out.w = to_f32(in.v[3]) * s.w;
        *reinterpret_cast<float4*>(y + i) = out;
      }
      return;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const I i = base + (I)(j * kThreads + threadIdx.x);
      if (i < n) y[i] = to_f32(q[i]) * __ldg(sc + i);
    }
    return;
  }
  if (b % 4 == 0 && last % 4 == 0 && aligned(q, 4 * sizeof(Q)) && aligned(y, 16)) {
    // 4 outputs of one row and one block (last % 4 == 0 keeps i + 3 < n)
    const I i = base + 4 * (I)threadIdx.x;
    if (i < n) {
      const I r = i / last, c = i % last;
      const float s = __ldg(sc + r * nb + c / b);
      const Vec4<Q> in = *reinterpret_cast<const Vec4<Q>*>(q + r * row_codes + c);
      float4 out;
      out.x = to_f32(in.v[0]) * s;
      out.y = to_f32(in.v[1]) * s;
      out.z = to_f32(in.v[2]) * s;
      out.w = to_f32(in.v[3]) * s;
      *reinterpret_cast<float4*>(y + i) = out;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const I i = base + (I)(j * kThreads + threadIdx.x);
    if (i < n) {
      const I r = i / last, c = i % last;
      y[i] = to_f32(q[r * row_codes + c]) * __ldg(sc + r * nb + c / b);
    }
  }
}

template <typename I, int N>
__device__ __forceinline__ void bw_dec_entry(const BwdGroup<N>& g, int e, long long base) {
  const I last = (I)g.last[e], b = (I)g.b[e], nb = (I)g.nb[e];
  const I n = (I)(g.rows[e] * g.last[e]);
  float* y = g.y + g.y_off[e];
  switch (g.code[e]) {   // uniform across the CTA
    case I8: bw_dec_tile<int8_t, I>(static_cast<const int8_t*>(g.q[e]), g.sc[e], y, (I)base, n,
                                    last, b, nb); break;
    case I16: bw_dec_tile<int16_t, I>(static_cast<const int16_t*>(g.q[e]), g.sc[e], y, (I)base,
                                      n, last, b, nb); break;
    case I32: bw_dec_tile<int32_t, I>(static_cast<const int32_t*>(g.q[e]), g.sc[e], y, (I)base,
                                      n, last, b, nb); break;
    default: bw_dec_tile<float, I>(static_cast<const float*>(g.q[e]), g.sc[e], y, (I)base, n,
                                   last, b, nb); break;
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads)
    bw_dec_group_kernel(const __grid_constant__ BwdGroup<N> g) {
  const long long tiles = g.tile_end[N == 1 ? 0 : g.count - 1];
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    // the first leaf whose tiles end past `tile`; a table of one indexes
    // its entry with a constant, read straight from the parameter bank
    int e = 0, top = N == 1 ? 0 : g.count - 1;
    while (e < top) {
      const int mid = (e + top) / 2;
      if (g.tile_end[mid] > tile) top = mid; else e = mid + 1;
    }
    const long long base = (tile - (e ? g.tile_end[e - 1] : 0)) * kDecTile;
    // every index of the leaf (codes, scales, values) below 2^32
    if (g.rows[e] * g.nb[e] * g.b[e] < (1LL << 32))
      bw_dec_entry<unsigned, N>(g, e, base);
    else
      bw_dec_entry<long long, N>(g, e, base);
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
    const long long* row = table + 9 * e;
    g.x[e] = (const float*)row[0];
    g.q[e] = (void*)row[1];
    g.sc[e] = (float*)row[2];
    const long long rows = g.rows[e] = row[3], last = g.last[e] = row[4];
    const long long b = g.b[e] = row[5], nb = g.nb[e] = row[6];
    g.task_end[e] = row[7];
    const bool stream = g.stream[e] = row[8] != 0;
    const long long units = rows * last == 0 ? 0 : rows * nb;
    // a stream leaf: b in {256, 512, 1024} and rows of whole float4
    const bool stream_ok = (b == 256 || b == 512 || b == 1024) && last % 4 == 0;
    const long long per = stream ? kStreamSteps * (kWarpVecs * 128 / (stream_ok ? b : 256))
                                 : (b <= kLaneBlock ? 32 : 1);
    if (rows < 0 || last < 0 || (stream && (!stream_ok || nb >= (1LL << 31))) ||
        (units && (b < 1 || nb < 1 || nb * b < last || (nb - 1) * b >= last)) ||
        g.task_end[e] - prev != (units + per - 1) / per)
      return (int)cudaErrorInvalidValue;
    prev = g.task_end[e];
  }
  g.count = count;
  if (prev == 0) return (int)cudaSuccess;
  float lo;
  qrange_f32(bits, &lo, &g.qmax);
  bool stream = false;
  for (int e = 0; e < count; ++e) stream = stream || g.stream[e];
  // each warp's ring of kStages steps (96 KB a CTA), only where needed
  constexpr int kRingBytes = (kThreads / 32) * kStages * kStepVecs * (int)sizeof(float4);
  return with_code(q_code, [&](auto qt) {
    using Q = decltype(qt);
    if (!stream) {
      bw_enc_group_kernel<Q, N, false><<<grid_for(prev * 32), kThreads, 0, st>>>(g);
      return;
    }
    static bool opted = false;   // once per instantiation
    if (!opted) {
      cudaFuncSetAttribute(bw_enc_group_kernel<Q, N, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kRingBytes);
      opted = true;
    }
    bw_enc_group_kernel<Q, N, true><<<grid_for(prev * 32), kThreads, kRingBytes, st>>>(g);
  });
}

template <int N>
int bw_dec_launch(const long long* table, int count, void* y, cudaStream_t st) {
  BwdGroup<N> g{};
  long long prev = 0;
  for (int e = 0; e < count; ++e) {
    const long long* row = table + 9 * e;
    g.q[e] = (const void*)row[0];
    g.code[e] = (int)row[1];
    g.sc[e] = (const float*)row[2];
    g.y_off[e] = row[3];
    const long long rows = g.rows[e] = row[4], last = g.last[e] = row[5];
    const long long b = g.b[e] = row[6], nb = g.nb[e] = row[7];
    g.tile_end[e] = row[8];
    const long long n = rows * last;
    if (code_bits(g.code[e]) == 0 || rows < 0 || last < 0 || g.y_off[e] < 0 ||
        (n && (b < 1 || nb < 1 || nb * b < last || (nb - 1) * b >= last)) ||
        g.tile_end[e] - prev != (n + kDecTile - 1) / kDecTile)
      return (int)cudaErrorInvalidValue;
    prev = g.tile_end[e];
  }
  g.count = count;
  g.y = (float*)y;
  if (prev == 0) return (int)cudaSuccess;
  const long long cap = 132LL * 32;  // enough resident blocks for every SM
  bw_dec_group_kernel<N><<<(int)(prev < cap ? prev : cap), kThreads, 0, st>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// A group of `count` (1..kBwCap) leaves as rows of `table`: {x, q, sc,
// rows, last, b, nb, task_end, stream} (pointers as integers; x: (rows,
// last) f32; q: (rows, nb * b) codes of q_code (0 int8, 1 int16, 2 int32,
// 3 f32); sc: (rows, nb) f32; stream: 1 for stream tasks (b in {256, 512,
// 1024}, last % 4 == 0); task_end: the prefix sum of each leaf's warp
// tasks, kernels/grouped.py::bw_plan). qmax = 2^(bits-1) - 1 for bits in
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

// A group of `count` (1..kBwCap) leaves as rows of `table`: {q, q_code,
// sc, y_off, rows, last, b, nb, tile_end} (pointers as integers; q: (rows,
// nb * b) codes of q_code (0 int8, 1 int16, 2 int32, 3 f32); sc: (rows, nb)
// f32; y_off: where the leaf's (rows, last) f32 values start in y, in
// elements; tile_end: the prefix sum of each leaf's ceil(rows * last /
// 1024) tiles, kernels/grouped.py::bwd_plan). Returns cudaGetLastError()
// after the launch (none for a group with no elements).
int bw_dec_group(const long long* table, int count, void* y, void* stream) {
  if (count < 1 || count > kBwCap) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (count == 1) return bw_dec_launch<1>(table, count, y, st);
  if (count <= 8) return bw_dec_launch<8>(table, count, y, st);
  return bw_dec_launch<kBwCap>(table, count, y, st);
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
