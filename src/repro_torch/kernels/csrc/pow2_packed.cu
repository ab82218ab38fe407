// Packed int4x2 pow-2 codec, grouped: two 4-bit codes a byte along the
// trailing axis of each entry's contiguous (rows, last) view, one f32
// scale_log2 per row (s_stride 1) or one for every row (s_stride 0), a
// group of entries in one launch each way.
//
// Replaces: repro/numerics/pallas_backend.py `_p2_enc_packed_kernel` (:229),
// `_p2_enc_packed_rows_kernel` (:237) (scalar and per-row step,
// `_encode_packed` :384) and `_p2_dec_packed_kernel` (:245),
// `_p2_dec_packed_rows_kernel` (:252) (`_decode_packed` :405), all launched
// through `_packed_call` (:283, the pallas_call at :307). On the training
// path these are the TT-factor deploy export (`ckpt.export_tt_deploy`: each
// core flattened to one row of 448..4,096 elements at its fixed
// `wscale_log2`, repro/ckpt/checkpoint.py:196) and its load
// (`ckpt.load_tt_deploy`, :274). The first port ran one launch a core
// each way: 6 per export and 6 per load of the FMNIST MLP.
//
// Numerics (bit-identical to Pow2Reference with storage "int4x2"):
//   encode  q = clamp(rint(x / 2^s), lo, hi)              lo, hi = qrange(bits)
//           byte j = (q[2j] & 0xF) | (q[2j+1] & 0xF) << 4  the low nibble is the
//           even index; an odd `last` pads the last byte's high nibble with 0
//   decode  q = sign-extended nibble, y = float(q) * 2^s   pad nibble dropped
// 2^s is formed with ldexpf for integer-valued s (exact; the export's steps
// are integers), exp2f otherwise (pow2_codes.cuh). The encode keeps the
// IEEE divide: a step need not be a power of two (exp2f of a fractional s),
// and the divide costs nothing at these sizes. No --use_fast_math: `/`,
// rintf and exp2f keep their IEEE meaning.
//
// Bound on the H100: launch latency. The export moves 57 KB in and 7 KB out
// (14,272 elements; 0.019 us at 3.35 TB/s), the load the reverse, and one
// launch costs ~5.5 us whatever it does: a launch a core made the export
// six fixed costs for a hundredth of one in bytes.
// Design: one launch covers up to kPkCap entries, described by a table
// passed by value as a __grid_constant__ parameter (no copy to the device,
// no extra launch), sized to the group (1, 8 or kPkCap entries: a single
// tensor passes a table of one, 56 bytes). Each entry writes into ONE flat
// output buffer at its offset (codes on 16 bytes, values on 16 bytes; the
// wrapper hands out views of it), so the export copies one codes buffer to
// the host and the load one to the device. The work unit is a tile of
// kTile packed bytes of one entry (never two); CTAs walk the tiles
// grid-stride and find their entry by a binary search of the tile prefix.
// Where last % 16 == 0 and the entry's pointers are aligned, a thread
// takes 8 bytes of one row: the encode reads 16 f32 values as 4 float4 and
// writes 8 bytes, the decode reads 8 bytes and writes 4 float4. Elsewhere
// (an odd `last`, whose rows end on a pad nibble; a 0-d scalar seen as
// (1, 1); an unaligned view) a thread takes one byte at a time, coalesced.
// Index arithmetic is 32-bit wherever the entry fits. No shared memory, no
// synchronisation.

#include "pow2_codes.cuh"

namespace {

using namespace pow2_codes;

constexpr int kThreads = 256;
constexpr int kBytes = 8;                  // packed bytes a thread takes a tile
constexpr int kTile = kBytes * kThreads;   // packed bytes a CTA takes at a time
constexpr int kPkCap = 64;                 // entries a launch takes

// The group's table, passed by value: N entries (N = 1, 8 or kPkCap; 3.3
// KB of the 4 KB parameter space at kPkCap). in: the encode's f32 values or
// the decode's int8 codes; off: where the entry starts in the output
// buffer (bytes for the encode, f32 elements for the decode); tile_end[e]:
// the prefix sum of ceil(rows * ceil(last / 2) / kTile) over entries 0..e.
template <int N>
struct PkGroup {
  const void* in[N];
  const float* s[N];
  long long rows[N];
  long long last[N];
  long long off[N];
  long long tile_end[N];
  int s_stride[N];
  int count;
};

__device__ __forceinline__ uint32_t nibble(float x, float step, float lo, float hi) {
  return (uint32_t)((int)fminf(fmaxf(rintf(x / step), lo), hi)) & 0xFu;
}

__device__ __forceinline__ float code_at(uint32_t v, int shift) {
  return (float)((int)(((v >> shift) & 0xFu) ^ 8u) - 8);   // sign-extend
}

// the first entry whose tiles end past `tile`; a table of one indexes its
// entry with a constant, read straight from the parameter bank
template <int N>
__device__ __forceinline__ int entry_of(const PkGroup<N>& g, long long tile) {
  int e = 0, top = N == 1 ? 0 : g.count - 1;
  while (e < top) {
    const int mid = (e + top) / 2;
    if (g.tile_end[mid] > tile) top = mid; else e = mid + 1;
  }
  return e;
}

// one tile of an entry's encode: packed bytes base .. base + kTile - 1
template <typename I>
__device__ __forceinline__ void enc_tile(const float* __restrict__ x, const float* __restrict__ s,
                                         int s_stride, int8_t* __restrict__ out, I rows, I last,
                                         I base, bool vec, float lo, float hi) {
  const I pk = (last + 1) / 2, n = rows * pk;
  if (vec) {                       // pk % 8 == 0: a thread's 8 bytes lie in one row
    const I i = base + (I)threadIdx.x * kBytes;
    if (i >= n) return;
    const float step = pow2_step(__ldg(s + (s_stride ? i / pk : 0)));
    const float4* xv = reinterpret_cast<const float4*>(x + 2 * i);   // last even
    uint32_t w[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 a = xv[2 * h], b = xv[2 * h + 1];
      w[h] = nibble(a.x, step, lo, hi) | nibble(a.y, step, lo, hi) << 4 |
             nibble(a.z, step, lo, hi) << 8 | nibble(a.w, step, lo, hi) << 12 |
             nibble(b.x, step, lo, hi) << 16 | nibble(b.y, step, lo, hi) << 20 |
             nibble(b.z, step, lo, hi) << 24 | nibble(b.w, step, lo, hi) << 28;
    }
    *reinterpret_cast<uint2*>(out + i) = make_uint2(w[0], w[1]);
    return;
  }
#pragma unroll
  for (int k = 0; k < kBytes; ++k) {
    const I i = base + (I)k * kThreads + (I)threadIdx.x;
    if (i < n) {
      const I r = i / pk, j = i - r * pk;
      const float step = pow2_step(__ldg(s + (s_stride ? r : 0)));
      const float* xr = x + r * last;
      const uint32_t q0 = nibble(xr[2 * j], step, lo, hi);
      const uint32_t q1 = 2 * j + 1 < last ? nibble(xr[2 * j + 1], step, lo, hi) : 0u;
      out[i] = (int8_t)(q0 | q1 << 4);
    }
  }
}

// one tile of an entry's decode: the values of packed bytes base ..
// base + kTile - 1
template <typename I>
__device__ __forceinline__ void dec_tile(const int8_t* __restrict__ q, const float* __restrict__ s,
                                         int s_stride, float* __restrict__ y, I rows, I last,
                                         I base, bool vec) {
  const I pk = (last + 1) / 2, n = rows * pk;
  if (vec) {
    const I i = base + (I)threadIdx.x * kBytes;
    if (i >= n) return;
    const float step = pow2_step(__ldg(s + (s_stride ? i / pk : 0)));
    const uint2 v = *reinterpret_cast<const uint2*>(q + i);
    float4* yv = reinterpret_cast<float4*>(y + 2 * i);
    const uint32_t w[2] = {v.x, v.y};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      yv[2 * h] = make_float4(code_at(w[h], 0) * step, code_at(w[h], 4) * step,
                              code_at(w[h], 8) * step, code_at(w[h], 12) * step);
      yv[2 * h + 1] = make_float4(code_at(w[h], 16) * step, code_at(w[h], 20) * step,
                                  code_at(w[h], 24) * step, code_at(w[h], 28) * step);
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < kBytes; ++k) {
    const I i = base + (I)k * kThreads + (I)threadIdx.x;
    if (i < n) {
      const I r = i / pk, j = i - r * pk;
      const float step = pow2_step(__ldg(s + (s_stride ? r : 0)));
      const uint32_t v = (uint8_t)q[i];
      float* yr = y + r * last;
      yr[2 * j] = code_at(v, 0) * step;
      if (2 * j + 1 < last) yr[2 * j + 1] = code_at(v, 4) * step;
    }
  }
}

// 32-bit indices where every index of the entry (values, bytes) fits
__device__ __forceinline__ bool fits32(long long rows, long long last) {
  return rows * (last + 1) < (1LL << 31);
}

template <int N>
__global__ void __launch_bounds__(kThreads)
    p2_enc_packed_kernel(const __grid_constant__ PkGroup<N> g, int8_t* __restrict__ out,
                         float lo, float hi) {
  const long long tiles = g.tile_end[N == 1 ? 0 : g.count - 1];
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int e = entry_of(g, tile);
    const long long base = (tile - (e ? g.tile_end[e - 1] : 0)) * kTile;
    const float* x = static_cast<const float*>(g.in[e]);
    int8_t* o = out + g.off[e];
    const long long rows = g.rows[e], last = g.last[e];
    const bool vec = last % 16 == 0 && aligned(x, 16) && aligned(o, 8);
    if (fits32(rows, last))
      enc_tile<int>(x, g.s[e], g.s_stride[e], o, (int)rows, (int)last, (int)base, vec, lo, hi);
    else
      enc_tile<long long>(x, g.s[e], g.s_stride[e], o, rows, last, base, vec, lo, hi);
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads)
    p2_dec_packed_kernel(const __grid_constant__ PkGroup<N> g, float* __restrict__ y) {
  const long long tiles = g.tile_end[N == 1 ? 0 : g.count - 1];
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int e = entry_of(g, tile);
    const long long base = (tile - (e ? g.tile_end[e - 1] : 0)) * kTile;
    const int8_t* q = static_cast<const int8_t*>(g.in[e]);
    float* o = y + g.off[e];
    const long long rows = g.rows[e], last = g.last[e];
    const bool vec = last % 16 == 0 && aligned(q, 8) && aligned(o, 16);
    if (fits32(rows, last))
      dec_tile<int>(q, g.s[e], g.s_stride[e], o, (int)rows, (int)last, (int)base, vec);
    else
      dec_tile<long long>(q, g.s[e], g.s_stride[e], o, rows, last, base, vec);
  }
}

// Fill the table from `table` rows {in, s, s_stride, rows, last, off,
// tile_end}; false on a row the kernels do not take. *tiles: the group's.
template <int N>
bool fill(PkGroup<N>& g, const long long* table, int count, long long off_align,
          long long* tiles) {
  long long prev = 0;
  for (int e = 0; e < count; ++e) {
    const long long* row = table + 7 * e;
    g.in[e] = (const void*)row[0];
    g.s[e] = (const float*)row[1];
    const long long stride = row[2], rows = row[3], last = row[4], off = row[5];
    if (stride < 0 || stride > 1 || rows < 0 || last < 0 || off < 0 || off % off_align ||
        row[6] - prev != (rows * ((last + 1) / 2) + kTile - 1) / kTile)
      return false;
    g.s_stride[e] = (int)stride;
    g.rows[e] = rows;
    g.last[e] = last;
    g.off[e] = off;
    g.tile_end[e] = prev = row[6];
  }
  g.count = count;
  *tiles = prev;
  return true;
}

inline int grid_for(long long tiles) {
  const long long cap = 132LL * 16;  // enough resident blocks for every SM
  return (int)(tiles < cap ? tiles : cap);
}

template <int N>
int enc_launch(const long long* table, int count, void* out, int bits, cudaStream_t st) {
  PkGroup<N> g{};
  long long tiles;
  if (!fill(g, table, count, 16, &tiles)) return (int)cudaErrorInvalidValue;
  if (tiles == 0) return (int)cudaSuccess;
  float lo, hi;
  qrange_f32(bits, &lo, &hi);
  p2_enc_packed_kernel<N><<<grid_for(tiles), kThreads, 0, st>>>(g, (int8_t*)out, lo, hi);
  return (int)cudaGetLastError();
}

template <int N>
int dec_launch(const long long* table, int count, void* y, cudaStream_t st) {
  PkGroup<N> g{};
  long long tiles;
  if (!fill(g, table, count, 4, &tiles)) return (int)cudaErrorInvalidValue;
  if (tiles == 0) return (int)cudaSuccess;
  p2_dec_packed_kernel<N><<<grid_for(tiles), kThreads, 0, st>>>(g, (float*)y);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// A group of `count` (1..kPkCap) entries as rows of `table`: {x, s,
// s_stride, rows, last, off, tile_end} (pointers as integers; x: (rows,
// last) f32; s: f32 scale_log2 at s[r * s_stride], s_stride 0 or 1; off:
// where the entry's (rows, ceil(last / 2)) bytes start in `out`, a
// multiple of 16; tile_end: the prefix sum of each entry's ceil(rows *
// ceil(last / 2) / 2048) tiles, kernels/grouped.py::pk_plan). bits in
// [2, 4]. Returns cudaGetLastError() after the launch (none for a group
// with no elements).
int p2_enc_packed(const long long* table, int count, void* out, int bits, void* stream) {
  if (count < 1 || count > kPkCap || bits < 2 || bits > 4) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (count == 1) return enc_launch<1>(table, count, out, bits, st);
  if (count <= 8) return enc_launch<8>(table, count, out, bits, st);
  return enc_launch<kPkCap>(table, count, out, bits, st);
}

// The same table with q: (rows, ceil(last / 2)) int8 codes in place of x,
// and off: where the entry's (rows, last) f32 values start in `y`, in
// elements, a multiple of 4.
int p2_dec_packed(const long long* table, int count, void* y, void* stream) {
  if (count < 1 || count > kPkCap) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (count == 1) return dec_launch<1>(table, count, y, st);
  if (count <= 8) return dec_launch<8>(table, count, y, st);
  return dec_launch<kPkCap>(table, count, y, st);
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
