// Pow-2 fake-quant: y = clip(rint(x / 2^s), lo, hi) * 2^s in the dtype of
// x, with one f32 scale_log2 for each tensor of a group (`p2_fq_group`) or
// one per row of a contiguous (rows, cols) view (`p2_fq_rows`). The group
// kernel also runs the codec's round trip, decode(encode(x)) under the
// same table (`p2_fq_group` with a code type): the BinaryConnect export.
//
// Replaces: repro/numerics/pallas_backend.py `_p2_fq_kernel` (launched
// through `_elementwise_2d` / `_flat_call` by `_p2_fake_quant_pallas`, and
// by the shims kernels/quantize.py `quantize` and kernels/ops.py
// `quantize_fused`) and `_p2_fq_rows_kernel` (through `_rowscale_call` by
// `_p2_fake_quant_rows`). On the training path the group kernel is every
// TT-core quantization (4-bit, fixed per-core scale: one launch for a
// layer's cores), every activation edge (8-bit) and every gradient edge
// (16-bit) of the paper's MLP (a group of one). The row kernel is what the
// codec API's `fake_quant` runs for a scale per leading index
// (`Pow2Pallas.fake_quant`); no path of the reference reaches it.
//
// Numerics (bit-identical to Pow2Reference.fake_quant, i.e. JAX's
// `pow2_qdq`, which computes in x.dtype):
//   scale = T(2^s)                  the scale is cast to x.dtype first
//   v     = T(float(x) / scale)     IEEE divide, rounded to T
//   q     = rintf(v)                half-to-even
//   q     = clip(q, T(lo), T(hi))   bounds in T: JAX's weak-typed clip
//                                   makes the 16-bit hi 32767 -> 32768 in bf16
//   y     = T(q * scale)
// For f32 every T() is the identity. 2^s is formed with ldexpf for integer
// s (exact); the build has no --use_fast_math, so `/` and rintf keep their
// IEEE meaning. The clip is written with comparisons so a NaN passes
// through, as jnp.clip's does. The STE mask is not computed here: it stays
// outside the kernel, as in the Pallas backend (pallas_backend.py:326 and
// :350-355, the row kernel's mask on the `_bcast`-shaped scale).
//
// Round trip (replaces `_p2_enc_kernel` and `_p2_dec_kernel`, :120 and
// :127, as the reference's export runs them: repro/optim/binaryconnect.py
// quantize_for_deploy, one encode and one decode a leaf through
// core/quant.py quantize_store): bit-identical to p2_enc then p2_dec, which
// compute in f32 whatever T is:
//   q = clip(rint(float(x) / 2^s), lo, hi)   fminf/fmaxf, as p2_enc
//   q = Q(q)                                  the code: an integer type's
//                                             zero has no sign (+0.f does
//                                             that); an f32 code keeps -0
//   y = T(float(q) * 2^s)                     as p2_dec
// so a zero code decodes to +0.0 where the fake-quant gives -0.0 for a
// small negative x. One launch covers every leaf of one bit width.
//
// Bound on the H100: bytes. One read and one write per element and a
// handful of operations, far below the card's ~295 operations per byte.
// The scales are read from device memory, so a managed scale that the step
// just updated needs no host round trip.
// Design, group kernel: the training step's tensors are a few hundred to a
// few thousand elements each, so a launch per tensor costs ~6 us against a
// bound of a hundredth of that; one launch covers up to kFqCap tensors of
// one dtype and bit width, described by a table passed by value as a
// __grid_constant__ parameter (no copy to the device, no extra launch),
// sized to the group (a single tensor passes a table of one). CTAs take
// units in tensor-major order (a unit never straddles two tensors) and
// find their tensor by a binary search of the table's prefix of unit
// counts. A narrow unit is kTile elements: a tensor whose pointers are
// aligned and whose n % 4 == 0 is read and written as 4-element vectors
// (16/8 bytes a thread), else element by element, coalesced.
// Design, wide units (the LM step: its activation edges, 4M bf16 each, and
// the grad-edge group's embedding and head, 190M each; kernels/grouped.py
// plans them for tensors of at least STREAM_MIN elements): there the
// narrow units leave 8 bytes a thread in flight (about 16 KB an SM) and pay
// the table search, the step's load and the alignment checks every kTile
// elements; measured on the H100 (chip_smoke.py --codec-anatomy), the
// group of 64 ran at 2.07x its byte bound with its arithmetic cut out as
// with it in, and as a table of one at 1.36x. A wide unit is 16 KB of x:
// each thread issues four independent 16-byte loads (8 bf16 or 4 f32
// each) before any arithmetic, 64 bytes in flight a thread, and the search,
// the step, the alignment checks and the choice between x * 2^-s and x /
// 2^s are made once a unit. Plain loads were taken over bulk asynchronous
// copies into a shared-memory ring: the data passes through each thread
// once with no reuse, so a ring adds a shared-memory round trip and its
// barriers without adding bytes in flight that four loads a thread do not
// already give at this occupancy. A group with wide units launches an
// instantiation of its own (WIDE: 62 registers against the narrow path's
// 32), so the MLP's groups and the previous units keep their occupancy;
// the LM's grad-edge group ran at 1.16x its bound with the arithmetic's
// cost hidden. The row kernel is a
// grid-stride loop over 4-element vectors (cols % 4 == 0, so a vector never
// straddles two rows; its row's step is one cached load per vector), else a
// scalar loop. No shared memory, no synchronisation.
//
// Quant health (health.cuh), the group's fake-quant only: with `sat`
// non-null the launch also adds (saturated, total) to sat[0..1], the
// reference's tree_sat_stats over the group (repro/obs/counters.py: the
// codes encode(x, spec, step) gives, counted where they sit at lo or hi;
// repro/launch/steps.py:107-129 runs it on the gradients the grad edge
// quantizes). An element saturates where rint of its quotient x / 2^s (the
// one the fake-quant rounds) is <= lo or >= hi, the f32 grid bounds: that
// is the reference's test on its clipped f32 codes, whatever T's rounding
// of the bounds (a bf16 16-bit grid clips at 32768, the codes at 32767).
// The grad edge runs each tensor at its per-tensor-max step. Cost: two
// compares an element, and a CTA one warp reduction, one __syncthreads and
// up to two 64-bit atomics, once after its last unit (a separate
// instantiation: a null pointer launches the kernel without them).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "health.cuh"

namespace {

enum DType { F32 = 0, BF16 = 1 };

__device__ __forceinline__ float pow2_step(float s) {
  // exact 2^s for integer-valued s; the range guard keeps (int)s defined
  if (s == truncf(s) && fabsf(s) <= 1024.f) return ldexpf(1.f, (int)s);
  return exp2f(s);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// round a float to T and back (identity for f32)
template <typename T> __device__ __forceinline__ float in_t(float v) {
  return to_f32(from_f32<T>(v));
}

template <typename T>
__device__ __forceinline__ T fq_one(T x, float scale, float lo, float hi) {
  float q = rintf(in_t<T>(to_f32(x) / scale));
  q = q < lo ? lo : (q > hi ? hi : q);
  return from_f32<T>(q * scale);
}

// fq_one, counting into *sat a code that saturates the f32 grid [glo, ghi]
template <typename T>
__device__ __forceinline__ T fq_one_sat(T x, float scale, float lo, float hi, float glo,
                                        float ghi, unsigned* sat) {
  float q = rintf(in_t<T>(to_f32(x) / scale));
  *sat += (q <= glo) | (q >= ghi);
  q = q < lo ? lo : (q > hi ? hi : q);
  return from_f32<T>(q * scale);
}

// decode(encode(x)); int_codes: through an integer code type, whose zero
// has no sign
template <typename T>
__device__ __forceinline__ T rt_one(T x, float step, float lo, float hi, bool int_codes) {
  float q = fminf(fmaxf(rintf(to_f32(x) / step), lo), hi);
  if (int_codes) q += 0.f;
  return from_f32<T>(q * step);
}

template <typename T> struct alignas(4 * sizeof(T)) Vec4 { T v[4]; };
// 16 bytes of T: 4 f32 or 8 bf16
template <typename T> struct alignas(16) Vec16 { T v[16 / sizeof(T)]; };

constexpr int kThreads = 256;
constexpr int kTile = 4 * kThreads;   // elements of a narrow unit
constexpr int kWideVecs = 4;          // 16-byte loads a thread issues in a wide unit
constexpr int kFqCap = 64;            // tensors a launch takes

// elements of a wide unit: kWideVecs 16-byte vectors a thread (16 KB of x)
template <typename T> __host__ __device__ constexpr long long wide_tile() {
  return (long long)kThreads * kWideVecs * (16 / sizeof(T));
}

// The group's table, passed by value: N entries, sized to the group (N =
// 1, 8 or kFqCap; 2.8 KB of the 4 KB parameter space at kFqCap, 48 bytes
// at 1, since a launch's parameters cost launch time). A tensor takes
// narrow units of kTile elements or, where `wide` is set, wide units of
// wide_tile<T>(); tile_end[e] is the prefix sum of the units of tensors
// 0..e.
template <int N>
struct FqGroup {
  const void* x[N];
  void* y[N];
  const float* s[N];          // each tensor's f32 scale_log2, on the device
  long long n[N];
  long long tile_end[N];
  int wide[N];
  int count;
};

__host__ __device__ inline bool aligned(const void* p, size_t a) {
  return ((uintptr_t)p % a) == 0;
}

// x / step for step = 2^s: x * 2^-s where that is bit-identical (MUL: s an
// integer with |s| <= 126, so 2^s and 2^-s are normal f32 and both are the
// one correctly rounded x / 2^s, subnormal results included), else the
// IEEE division
template <bool MUL>
__device__ __forceinline__ float div_step(float x, float step, float inv) {
  return MUL ? x * inv : x / step;
}

template <typename T, bool RT, bool MUL, bool SAT = false>
__device__ __forceinline__ T wide_one(T x, float step, float inv, float lo, float hi,
                                      float lo_t, float hi_t, bool int_codes,
                                      unsigned* sat = nullptr) {
  if (RT) {   // rt_one
    float q = fminf(fmaxf(rintf(div_step<MUL>(to_f32(x), step, inv)), lo), hi);
    if (int_codes) q += 0.f;
    return from_f32<T>(q * step);
  }
  // fq_one with the scale in T (exact for |s| <= 126: 2^s is a normal bf16)
  const float scale = in_t<T>(step);
  float q = rintf(in_t<T>(div_step<MUL>(to_f32(x), scale, inv)));
  if (SAT) *sat += (q <= lo) | (q >= hi);
  q = q < lo_t ? lo_t : (q > hi_t ? hi_t : q);
  return from_f32<T>(q * scale);
}

// One wide unit: elements base .. base + wide_tile<T>() - 1 of a tensor of
// n. Where x and y start on 16 bytes and n fills whole vectors, each
// thread issues its kWideVecs 16-byte loads (neighbouring threads on
// neighbouring vectors) before any arithmetic, then stores as many; else
// it takes single elements, coalesced.
template <typename T, bool RT, bool MUL, bool SAT = false>
__device__ __forceinline__ void fq_wide_unit(const T* __restrict__ x, T* __restrict__ y,
                                             long long base, long long n, float step,
                                             float inv, float lo, float hi, float lo_t,
                                             float hi_t, bool int_codes,
                                             unsigned* sat = nullptr) {
  constexpr int kPer = 16 / sizeof(T);
  if (n % kPer == 0 && aligned(x, 16) && aligned(y, 16)) {
    const long long v0 = base / kPer + threadIdx.x, nv = n / kPer;
    Vec16<T> in[kWideVecs];
#pragma unroll
    for (int k = 0; k < kWideVecs; ++k) {
      const long long i = v0 + (long long)k * kThreads;
      if (i < nv) in[k] = reinterpret_cast<const Vec16<T>*>(x)[i];
    }
#pragma unroll
    for (int k = 0; k < kWideVecs; ++k) {
      const long long i = v0 + (long long)k * kThreads;
      if (i < nv) {
        Vec16<T> out;
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          out.v[j] = wide_one<T, RT, MUL, SAT>(in[k].v[j], step, inv, lo, hi, lo_t, hi_t,
                                               int_codes, sat);
        reinterpret_cast<Vec16<T>*>(y)[i] = out;
      }
    }
    return;
  }
  for (int j = 0; j < kWideVecs * kPer; ++j) {
    const long long i = base + (long long)j * kThreads + threadIdx.x;
    if (i < n)
      y[i] = wide_one<T, RT, MUL, SAT>(x[i], step, inv, lo, hi, lo_t, hi_t, int_codes, sat);
  }
}

// WIDE: the group has wide units (an instantiation of its own, so a group
// of narrow units runs the narrow path's code and registers alone). SAT:
// count saturated codes into sat (the fake-quant only, RT false).
template <typename T, int N, bool RT, bool WIDE, bool SAT = false>
__global__ void __launch_bounds__(kThreads)
    p2_fq_group_kernel(const __grid_constant__ FqGroup<N> g, float lo, float hi, int int_codes,
                       unsigned long long* sat) {
  static_assert(!(SAT && RT), "saturation counts the fake-quant only");
  const float lo_t = in_t<T>(lo), hi_t = in_t<T>(hi);
  unsigned nsat = 0, ntot = 0;
  auto one = [&](T v, float step) {
    if (SAT) return fq_one_sat(v, in_t<T>(step), lo_t, hi_t, lo, hi, &nsat);
    return RT ? rt_one(v, step, lo, hi, int_codes)
              : fq_one(v, in_t<T>(step), lo_t, hi_t);
  };
  const long long tiles = g.tile_end[N == 1 ? 0 : g.count - 1];
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    // the first tensor whose tiles end past `tile`; a table of one indexes
    // its entry with a constant, read straight from the parameter bank
    int e = 0, top = N == 1 ? 0 : g.count - 1;
    while (e < top) {
      const int mid = (e + top) / 2;
      if (g.tile_end[mid] > tile) top = mid; else e = mid + 1;
    }
    const long long unit = tile - (e ? g.tile_end[e - 1] : 0);
    const T* __restrict__ x = static_cast<const T*>(g.x[e]);
    T* __restrict__ y = static_cast<T*>(g.y[e]);
    const long long n = g.n[e];
    if (WIDE && g.wide[e]) {
      // the step, and whether x / 2^s may be a product, once a unit
      const float s = __ldg(g.s[e]);
      const float step = pow2_step(s);
      const long long base = unit * wide_tile<T>();
      if (SAT) ntot += (unsigned)min(wide_tile<T>(), n - base);
      if (s == truncf(s) && fabsf(s) <= 126.f)
        fq_wide_unit<T, RT, true, SAT>(x, y, base, n, step, ldexpf(1.f, -(int)s), lo, hi, lo_t,
                                       hi_t, int_codes, &nsat);
      else
        fq_wide_unit<T, RT, false, SAT>(x, y, base, n, step, 0.f, lo, hi, lo_t, hi_t,
                                        int_codes, &nsat);
      continue;
    }
    const long long base = unit * kTile;
    if (SAT) ntot += (unsigned)min((long long)kTile, n - base);
    const float step = pow2_step(__ldg(g.s[e]));
    if (n % 4 == 0 && aligned(x, 4 * sizeof(T)) && aligned(y, 4 * sizeof(T))) {
      const long long i = base / 4 + threadIdx.x;
      if (i < n / 4) {
        const Vec4<T> in = reinterpret_cast<const Vec4<T>*>(x)[i];
        Vec4<T> out;
#pragma unroll
        for (int j = 0; j < 4; ++j) out.v[j] = one(in.v[j], step);
        reinterpret_cast<Vec4<T>*>(y)[i] = out;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long i = base + j * kThreads + threadIdx.x;
        if (i < n) y[i] = one(x[i], step);
      }
    }
  }
  if constexpr (SAT) {
    // the units' element counts were added by every thread: keep thread 0's
    __shared__ unsigned part[64];
    health::cta_add2(sat, nsat, threadIdx.x == 0 ? ntot : 0u, part);
  }
}

template <typename T, bool VEC>
__global__ void p2_fq_rows_kernel(const T* __restrict__ x, const float* __restrict__ s,
                                  T* __restrict__ y, long long n, long long cols, float lo,
                                  float hi) {
  const float lo_t = in_t<T>(lo), hi_t = in_t<T>(hi);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (VEC) {
    const long long cv = cols / 4;
    for (long long i = first; i < n / 4; i += stride) {
      const float scale = in_t<T>(pow2_step(__ldg(s + i / cv)));
      const Vec4<T> in = reinterpret_cast<const Vec4<T>*>(x)[i];
      Vec4<T> out;
#pragma unroll
      for (int j = 0; j < 4; ++j) out.v[j] = fq_one(in.v[j], scale, lo_t, hi_t);
      reinterpret_cast<Vec4<T>*>(y)[i] = out;
    }
  } else {
    for (long long i = first; i < n; i += stride)
      y[i] = fq_one(x[i], in_t<T>(pow2_step(__ldg(s + i / cols))), lo_t, hi_t);
  }
}

inline int grid_for(long long work) {
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = 132LL * 32;  // enough resident blocks for every SM
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : (int)blocks;
}

template <typename T>
void launch_rows(const void* x, const float* s, void* y, long long rows, long long cols,
                 float lo, float hi, cudaStream_t st) {
  const long long n = rows * cols;
  if (cols % 4 == 0 && aligned(x, 4 * sizeof(T)) && aligned(y, 4 * sizeof(T)))
    p2_fq_rows_kernel<T, true><<<grid_for(n / 4), kThreads, 0, st>>>((const T*)x, s, (T*)y,
                                                                     n, cols, lo, hi);
  else
    p2_fq_rows_kernel<T, false><<<grid_for(n), kThreads, 0, st>>>((const T*)x, s, (T*)y, n,
                                                                  cols, lo, hi);
}

template <int N, bool RT>
int fq_launch(const long long* table, int count, int x_dtype, int bits, int int_codes,
              unsigned long long* sat, cudaStream_t st) {
  FqGroup<N> g{};
  long long prev = 0;
  const long long wide = x_dtype == BF16 ? wide_tile<__nv_bfloat16>() : wide_tile<float>();
  for (int e = 0; e < count; ++e) {
    const long long* row = table + 6 * e;
    g.x[e] = (const void*)row[0];
    g.y[e] = (void*)row[1];
    g.s[e] = (const float*)row[2];
    g.n[e] = row[3];
    g.tile_end[e] = row[4];
    g.wide[e] = row[5] != 0;
    const long long unit = g.wide[e] ? wide : kTile;
    if (g.n[e] < 0 || g.tile_end[e] - prev != (g.n[e] + unit - 1) / unit)
      return (int)cudaErrorInvalidValue;
    prev = g.tile_end[e];
  }
  g.count = count;
  if (prev == 0) return (int)cudaSuccess;
  const float lo = -(float)(1 << (bits - 1)), hi = (float)((1 << (bits - 1)) - 1);
  const int grid = grid_for(prev * kThreads);
  bool wide_any = false;
  for (int e = 0; e < count; ++e) wide_any = wide_any || g.wide[e];
  auto launch = [&](auto t, auto w) {
    using T = decltype(t);
    constexpr bool W = decltype(w)::value;
    if constexpr (!RT) {
      if (sat) {
        p2_fq_group_kernel<T, N, false, W, true><<<grid, kThreads, 0, st>>>(g, lo, hi,
                                                                           int_codes, sat);
        return;
      }
    }
    p2_fq_group_kernel<T, N, RT, W><<<grid, kThreads, 0, st>>>(g, lo, hi, int_codes, nullptr);
  };
  switch (x_dtype) {
    case F32:
      if (wide_any) launch(float{}, std::true_type{}); else launch(float{}, std::false_type{});
      break;
    case BF16:
      if (wide_any) launch(__nv_bfloat16{}, std::true_type{});
      else launch(__nv_bfloat16{}, std::false_type{});
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <bool RT>
int fq_dispatch(const long long* table, int count, int x_dtype, int bits, int int_codes,
                unsigned long long* sat, cudaStream_t st) {
  if (count == 1) return fq_launch<1, RT>(table, count, x_dtype, bits, int_codes, sat, st);
  if (count <= 8) return fq_launch<8, RT>(table, count, x_dtype, bits, int_codes, sat, st);
  return fq_launch<kFqCap, RT>(table, count, x_dtype, bits, int_codes, sat, st);
}

}  // namespace

extern "C" {

// A group of `count` (1..kFqCap) tensors of x_dtype, as rows of `table`:
// {x, y, s, n, tile_end, wide} (pointers as integers; x, y: n contiguous
// elements; s: one f32 scale_log2 on the device; wide: 0 for narrow units
// of kTile elements, 1 for wide units of wide_tile<T>(); tile_end: the
// prefix sum of ceil(n / unit), kernels/grouped.py::fq_plan); bits in
// [2, 16].
// q_code -1: the fake-quant; 0 int8, 1 int16, 2 int32, 3 f32: the round
// trip through codes of that type (bits at most the type's, so the grid
// lies inside it and to_code's saturation never acts). sat: two uint64
// counters on the device that the fake-quant adds (saturated, total) to,
// or null (the round trip takes null). Returns cudaGetLastError() after
// the launch (none for a group with no elements).
int p2_fq_group(const long long* table, int count, int x_dtype, int bits, int q_code,
                void* sat, void* stream) {
  if (bits < 2 || bits > 16 || count < 1 || count > kFqCap || q_code < -1 || q_code > 3 ||
      (q_code == 0 && bits > 8) || (q_code >= 0 && sat != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  auto* counts = static_cast<unsigned long long*>(sat);
  if (q_code < 0) return fq_dispatch<false>(table, count, x_dtype, bits, 0, counts, st);
  return fq_dispatch<true>(table, count, x_dtype, bits, q_code != 3, nullptr, st);
}

// x, y: (rows, cols) contiguous of x_dtype; s: (rows,) f32 scale_log2 on
// the device; bits in [2, 16].
int p2_fq_rows(const void* x, int x_dtype, const void* s, void* y, long long rows,
               long long cols, int bits, void* stream) {
  if (bits < 2 || bits > 16) return (int)cudaErrorInvalidValue;
  if (rows * cols == 0) return (int)cudaSuccess;
  const float lo = -(float)(1 << (bits - 1)), hi = (float)((1 << (bits - 1)) - 1);
  cudaStream_t st = (cudaStream_t)stream;
  switch (x_dtype) {
    case F32: launch_rows<float>(x, (const float*)s, y, rows, cols, lo, hi, st); break;
    case BF16: launch_rows<__nv_bfloat16>(x, (const float*)s, y, rows, cols, lo, hi, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
