// Whole-prompt prefill write: K and V of every layer of one prompt, each
// (tensor, layer) scale chosen on the device, encoded to pow-2 codes under
// it and written straight into the slot's pool pages, in one launch.
//
// Replaces: repro/numerics/pallas_backend.py `_p2_enc_rows_kernel` (:189)
// as the reference's prefill runs it (repro/serve/kv_cache.py write_prefill:
// choose_scale_log2 over the valid rows of each layer, the scale column's
// write, the row-scale encode of the (L, S * Hkv * Dh) cache and the
// `.at[:, pages, offs].set` scatter), for K and for V. On the serving path
// this is once per whole-prompt prefill, where the port ran about 25 eager
// kernels and two p2_enc_rows launches.
//
// Per tensor t and layer l, on the device (nothing is read back to the
// host; `length` is a device int):
//   nv             = min(max(length, 0), S)
//   m              = max |x[l, j, :]| over rows j < nv, in f32 (0 if none)
//   scale[l, slot] = ceil(log2(max(m, 1e-8) * (1 / qmax)))
//   row j          -> data[l, page(j), j mod page_size, :] =
//                     Q(clamp(rint(x / 2^scale), lo, hi))
// page(j) is kv_pages.cuh's row_page with the clamp rule (write_prefill's
// gather clamps the page index): rows at or past nv, and the earlier of two
// valid rows that meet in one cell past the slot's last page, go to the
// trash page. The encode is p2_enc_rows's (pow2_codes.cuh: exact 2^s, IEEE
// division, rintf, Q saturating). The scale step is the route this kernel
// replaces on the card, op for op: PyTorch on CUDA divides by a Python
// scalar as a multiply by its f32 reciprocal, then log2f and ceilf (no
// --use_fast_math). A NaN in the max is outside that match: fmaxf drops it,
// PyTorch's amax keeps it.
//
// Bound on the H100: bytes. K and V are read once and their codes written
// once: at S = 512 on internlm2-1.8b (24 layers, 8 x 128, bf16) 50.3 MB in
// and 25.2 MB out, 22.5 us at 3.35 TB/s. The scale needs every valid row of
// a (tensor, layer) before any row can be encoded, and a (tensor, layer) is
// 1 MB, more than one SM should carry. Design: one thread block cluster per
// (tensor, layer), 2L clusters of up to kCluster CTAs, each CTA a run of
// rows, over its own tensor's width (K and V may differ in width: MLA's
// latent c_kv and rope key, 512 and 64). A CTA reduces |x| over its valid
// rows, the cluster's max is
// combined through distributed shared memory after a cluster barrier, every
// CTA forms the scale (the leader writes it) and encodes its rows, re-read
// from global memory (L2-warm by then), storing them to their page in
// 16-byte words (16 int8 codes a lane from two 16-byte loads of bf16). A
// warp takes a row at a time, its lanes the row's units, so every index is
// 32-bit and needs no division. Rows that are not 16-byte aligned, or a
// row width that is no multiple of a lane's unit, take an element loop. A
// CTA leaves only after every CTA of its cluster has read its max (split
// cluster barrier: arrive after the read, wait at the end). Staging a
// CTA's rows in shared memory with cp.async for the second pass measured
// no faster at S = 128 and slower at S = 512 and 1,024 (fewer CTAs
// resident: PERF.md), so the second pass reads global memory.
//
// The encode multiplies by 2^-s: x * 2^-s and x / 2^s round the same exact
// value once, and 2^-s is an f32 (normal or subnormal) for every s this
// kernel forms (-57 <= s <= 128, or +inf from an infinite max, where both
// give the same zeros and NaNs). An IEEE divide an element would make the
// kernel bound by its arithmetic, not its bytes.

#include <cooperative_groups.h>

#include "kv_pages.cuh"
#include "pow2_codes.cuh"

namespace {

using namespace pow2_codes;
namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kCluster = 8;     // CTAs a (tensor, layer): the portable maximum
// CTAs an SM keeps resident for int8 codes (the serving pool): at most 32
// registers a thread. With a width per tensor ptxas chose 40, 6 CTAs an SM,
// and a 48-layer x 512 x 16 x 128 prefill write ran 13% slower (PERF.md).
constexpr int kMinBlocks = 8;

template <typename T, int V>
struct alignas(sizeof(T) * V < 16 ? sizeof(T) * V : 16) VecN {
  T v[V];
};

// elements a lane encodes at a time: a 16-byte load of T or a 16-byte
// store of Q codes, whichever holds more
template <typename T, typename Q>
__host__ __device__ constexpr int unit() {
  return sizeof(T) < sizeof(Q) ? 16 / sizeof(T) : 16 / sizeof(Q);
}

struct PrefillArgs {
  const void* x[2];          // K, V: row j of layer l at x + l * lstride + j * tstride
  long long lstride[2];      // their layer strides, in elements
  long long tstride[2];      // their token strides, in elements
  void* data[2];             // K, V pools (L, trash + 1, page_size, F[t]) codes
  long long data_lstride[2]; // elements between two layers of each pool
  float* scale[2];           // (L, slots) f32 scale_log2, row stride scale_lstride
  long long scale_lstride;
  const int* table;          // (pages_per_slot,) int32, the slot's row
  const int* length;         // (1,) int32 valid rows
  long long feat[2];         // K, V: F = Hkv * Dh (GQA, the same twice), or
                             // MLA's kv_lora_rank and qk_rope_head_dim
  int tokens;                // S rows a layer
  int layers;                // L
  int slot, pages_per_slot, page_size, trash;
  int rows_per_cta;          // rows each CTA of a cluster owns
  int vec[2];                // K / V take the 16-byte path
  float lo, hi, inv_qmax;
};

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

template <typename T, int V>
__device__ __forceinline__ float abs_max(const VecN<T, V> in, float m) {
#pragma unroll
  for (int k = 0; k < V; ++k) m = fmaxf(m, fabsf(to_f32(in.v[k])));
  return m;
}

// Rows go to warps (row r0 + w, r0 + w + kWarps, ...), a row's units to
// lanes: a 16-byte load of x in the first pass; in the second kU elements,
// one 16-byte load of x or one 16-byte store of codes, whichever covers
// more (16 bf16 -> 16 int8, 4 f32 -> 4 int32).
template <typename T, typename Q>
__global__ void __launch_bounds__(kThreads, sizeof(Q) == 1 ? kMinBlocks : 1)
    p2_prefill_paged_kernel(const __grid_constant__ PrefillArgs a) {
  constexpr int V = 16 / sizeof(T);            // elements a 16-byte load
  constexpr int kU = unit<T, Q>();
  constexpr int kWarps = kThreads / 32;
  using In = VecN<T, V>;
  __shared__ float warp_part[kWarps];
  __shared__ float cta_max;
  __shared__ float scale_sh;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const int pair = blockIdx.x / csize;
  const int t = pair / a.layers, l = pair - t * a.layers;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nv = min(max(__ldg(a.length), 0), a.tokens);
  const int r0 = min(rank * a.rows_per_cta, a.tokens);
  const int r1 = min(r0 + a.rows_per_cta, a.tokens);
  const int F = (int)a.feat[t];
  const T* __restrict__ x = static_cast<const T*>(a.x[t]) + l * a.lstride[t];
  const long long ts = a.tstride[t];
  const bool vec = a.vec[t];

  // ---- max |x| over this CTA's valid rows
  float m = 0.f;
  for (int j = r0 + warp; j < min(r1, nv); j += kWarps) {
    if (vec) {
      const In* row = reinterpret_cast<const In*>(x + j * ts);
#pragma unroll 4
      for (int c = lane; c < F / V; c += 32) m = abs_max(row[c], m);
    } else {
      for (int i = lane; i < F; i += 32) m = fmaxf(m, fabsf(to_f32(x[j * ts + i])));
    }
  }
  m = warp_max(m);
  if (lane == 0) warp_part[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v = fmaxf(v, warp_part[w]);
    cta_max = v;
  }

  // ---- the cluster's max and the scale
  cluster.sync();
  if (threadIdx.x == 0) {
    float v = 0.f;
    for (int r = 0; r < csize; ++r) v = fmaxf(v, *cluster.map_shared_rank(&cta_max, r));
    const float s = ceilf(log2f(fmaxf(v, 1e-8f) * a.inv_qmax));
    scale_sh = s;
    if (rank == 0) a.scale[t][l * a.scale_lstride + a.slot] = s;
  }
  // done reading the others' maxima: they may leave once all have arrived
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  __syncthreads();

  // ---- encode every row of this CTA into its page
  const float inv = pow2_step(-scale_sh);
  const float lo = a.lo, hi = a.hi;
  auto enc = [inv, lo, hi](float v) { return to_code<Q>(fminf(fmaxf(rintf(v * inv), lo), hi)); };
  Q* __restrict__ q0 = static_cast<Q*>(a.data[t]) + l * a.data_lstride[t];
  for (int j = r0 + warp; j < r1; j += kWarps) {
    const int page = kv_pages::row_page(a.table, a.pages_per_slot, a.page_size, a.trash, 1, j,
                                        j, true, nv);
    Q* __restrict__ q = q0 + ((long long)page * a.page_size + j % a.page_size) * F;
    const T* __restrict__ src = x + j * ts;
    if (vec) {
#pragma unroll 2
      for (int c = lane; c < F / kU; c += 32) {
        VecN<Q, kU> out;
#pragma unroll
        for (int h = 0; h < kU / V; ++h) {
          const In in = reinterpret_cast<const In*>(src + c * kU)[h];
#pragma unroll
          for (int k = 0; k < V; ++k) out.v[h * V + k] = enc(to_f32(in.v[k]));
        }
        reinterpret_cast<VecN<Q, kU>*>(q)[c] = out;
      }
    } else {
      for (int i = lane; i < F; i += 32) q[i] = enc(to_f32(src[i]));
    }
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <typename T, typename Q>
int launch(PrefillArgs a, cudaStream_t st) {
  for (int t = 0; t < 2; ++t)
    a.vec[t] = a.feat[t] % unit<T, Q>() == 0 && aligned(a.x[t], 16) &&
               (a.lstride[t] * (long long)sizeof(T)) % 16 == 0 &&
               (a.tstride[t] * (long long)sizeof(T)) % 16 == 0 && aligned(a.data[t], 16);
  const int csize = a.tokens < kCluster ? a.tokens : kCluster;
  a.rows_per_cta = (a.tokens + csize - 1) / csize;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(2 * a.layers * csize);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, p2_prefill_paged_kernel<T, Q>, a);
}

}  // namespace

extern "C" {

// k, v: row j of layer l holds kfeat (vfeat) elements of x_dtype (0 f32,
// 1 bf16, 2 f16) at k + l * k_lstride + j * k_tstride (v likewise),
// contiguous within the row, j < tokens; kdata, vdata: (layers, trash + 1,
// page_size, kfeat) and (layers, trash + 1, page_size, vfeat) codes of
// q_code (0 int8, 1 int16, 2 int32, 3 f32), layers k_data_lstride /
// v_data_lstride elements apart, written in place; kscale, vscale:
// (layers, slots) f32 with row stride scale_lstride, column `slot` written;
// table: (pages_per_slot,) int32, the slot's row of the page table;
// length: (1,) int32 valid rows, on the device. bits in
// [2, code_bits(q_code)]; inv_qmax = 1 / (2^(bits-1) - 1) in f32.
// Returns the launch's error code, then cudaGetLastError().
int p2_prefill_paged(const void* k, const void* v, int x_dtype, long long k_lstride,
                     long long v_lstride, long long k_tstride, long long v_tstride, int tokens,
                     int layers, void* kdata, void* vdata, int q_code,
                     long long k_data_lstride, long long v_data_lstride, void* kscale,
                     void* vscale, long long scale_lstride, int slot, const void* table,
                     int pages_per_slot, const void* length, long long kfeat, long long vfeat,
                     int page_size, int trash, int bits, void* stream) {
  if (bits < 2 || bits > code_bits(q_code) || x_dtype < F32 || x_dtype > F16 || tokens < 0 ||
      layers < 0 || kfeat < 0 || vfeat < 0 || page_size < 1 || pages_per_slot < 1 ||
      trash < 0 || slot < 0 || kfeat > 0x7fffffffLL || vfeat > 0x7fffffffLL ||
      2LL * layers * kCluster > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (tokens == 0 || layers == 0 || kfeat + vfeat == 0) return (int)cudaSuccess;
  PrefillArgs a{};
  a.x[0] = k;
  a.x[1] = v;
  a.lstride[0] = k_lstride;
  a.lstride[1] = v_lstride;
  a.tstride[0] = k_tstride;
  a.tstride[1] = v_tstride;
  a.data[0] = kdata;
  a.data[1] = vdata;
  a.data_lstride[0] = k_data_lstride;
  a.data_lstride[1] = v_data_lstride;
  a.scale[0] = (float*)kscale;
  a.scale[1] = (float*)vscale;
  a.scale_lstride = scale_lstride;
  a.table = (const int*)table;
  a.length = (const int*)length;
  a.feat[0] = kfeat;
  a.feat[1] = vfeat;
  a.tokens = tokens;
  a.layers = layers;
  a.slot = slot;
  a.pages_per_slot = pages_per_slot;
  a.page_size = page_size;
  a.trash = trash;
  qrange_f32(bits, &a.lo, &a.hi);
  a.inv_qmax = 1.0f / a.hi;     // PyTorch's reciprocal of the f32 scalar qmax
  cudaStream_t st = (cudaStream_t)stream;
  int err = 0;
  const int code = with_code(q_code, [&](auto qt) {
    using Q = decltype(qt);
    switch (x_dtype) {
      case F32: err = launch<float, Q>(a, st); break;
      case BF16: err = launch<__nv_bfloat16, Q>(a, st); break;
      case F16: err = launch<__half, Q>(a, st); break;
    }
  });
  return err ? err : code;
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
