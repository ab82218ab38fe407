// Paged KV read: every slot's cache view of one layer, K and V, decoded from
// the pool's pow-2 codes under the slot's scale in one launch, straight off
// the pages (no gathered copy of the codes).
//
// Replaces: repro/numerics/pallas_backend.py `_p2_dec_kernel` (:127) as the
// reference's chunk step runs it, and `_p2_dec_rows_kernel` (:196) as its
// gather decode runs it (repro/serve/kv_cache.py gather_slots: the
// `data_l[table]` page gather, then the scalar- or row-scale decode of the
// (B, pages_per_slot * page_size, Hkv, Dh) view), for K and for V. On the
// serving path this is once a layer a chunk step (B = 1) and once a layer a
// decode step of the gather engine (B = num_slots): 24 launches a step on
// internlm2-1.8b, where the port copied the slot's pages with an eager
// gather and then launched a decode over the copy, twice a layer.
//
// Page p of slot b, on the device:
//   page = table[b, p], or the trash page for a number outside [0, trash]
//   out[b, p * page_size + i, :] = T(float(data[page, i, :]) * 2^scale[b])
// with p2_dec's and p2_dec_rows's numerics (which are the same): 2^s formed
// exactly (pow2_step), one f32 product, a round-to-nearest cast. Every
// position of the view is written, masked or not, as gather_slots does; the
// reference's gather clamps a too-large page number to the trash page too.
//
// Bound on the H100: bytes. Each code is read once and each value written
// once: for one slot's 1,024 positions x 1,024 features, 2 MiB of int8 in
// and 4 MiB of bf16 out for K and V, 1.88 us at 3.35 TB/s (15.0 us for 8
// slots); one product an element. Design: grid (slot x page, tensor, part
// of the page); a CTA reads its page number and the slot's step from device
// memory once, then streams its part of the page's page_size x F codes. A
// thread takes V elements a step, V set by the wider of the two types so
// that side moves 16 bytes (8 int8 codes -> 16 bytes of bf16, 4 -> 16 bytes
// of f32; 4 int32 codes (16 bytes) -> 8 bytes of bf16), and neighbouring
// threads take neighbouring vectors, so a warp's loads and stores each
// cover whole lines. Splitting a page over several CTAs keeps enough of
// them in flight when one slot's pages are all the work. K and V may differ
// in width (MLA's latent c_kv and rope key): the grid's parts cover the
// wider page and a CTA past the narrower tensor's page returns at once.
// Pages whose rows are not multiples of V, or unaligned pools, take an
// element loop, each tensor on its own. No
// shared memory, no synchronisation.

#include "pow2_codes.cuh"

namespace {

using namespace pow2_codes;

constexpr int kThreads = 256;
constexpr int kSteps = 2;          // vectors a thread takes in a CTA's part

// V elements of T, aligned to their size up to 16 bytes
template <typename T, int V>
struct alignas(sizeof(T) * V < 16 ? sizeof(T) * V : 16) VecN {
  T v[V];
};

// elements a thread moves a step: 16 bytes of the wider of Q and T
template <typename Q, typename T>
__host__ __device__ constexpr int vec_elems() {
  return 16 / (sizeof(Q) > sizeof(T) ? sizeof(Q) : sizeof(T));
}

struct ReadArgs {
  const void* data[2];       // K, V pages (trash + 1, page_size, F) codes
  void* out[2];              // K, V views (B, pages_per_slot * page_size, F)
  const float* scale[2];     // (B,) scale_log2 of each slot
  const int* table;          // (B, pages_per_slot) int32, row stride table_stride
  long long table_stride;
  long long page_elems[2];   // K, V: page_size * F[t] (GQA: the same twice;
                             // MLA: kv_lora_rank and qk_rope_head_dim wide)
  long long part;            // elements of a page a CTA takes
  int pages_per_slot, trash;
  int vec[2];                // K / V take the vector path
};

template <typename Q, typename T>
__global__ void __launch_bounds__(kThreads)
    p2_read_paged_kernel(const __grid_constant__ ReadArgs a) {
  constexpr int V = vec_elems<Q, T>();
  const int t = blockIdx.y;
  const long long pe = a.page_elems[t];
  const long long lo = blockIdx.z * a.part;
  if (lo >= pe) return;      // past the narrower tensor's page
  const int b = blockIdx.x / a.pages_per_slot, p = blockIdx.x - b * a.pages_per_slot;
  int page = __ldg(a.table + b * a.table_stride + p);
  if (page < 0 || page > a.trash) page = a.trash;
  const float step = pow2_step(__ldg(a.scale[t] + b));
  const Q* __restrict__ src = static_cast<const Q*>(a.data[t]) + (long long)page * pe;
  T* __restrict__ dst = static_cast<T*>(a.out[t]) + (long long)blockIdx.x * pe;
  const long long hi = min(lo + a.part, pe);
  if (a.vec[t]) {
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const long long i = lo / V + threadIdx.x + (long long)k * blockDim.x;
      if (i < hi / V) {
        const VecN<Q, V> in = reinterpret_cast<const VecN<Q, V>*>(src)[i];
        VecN<T, V> o;
#pragma unroll
        for (int e = 0; e < V; ++e) o.v[e] = from_f32<T>(to_f32(in.v[e]) * step);
        reinterpret_cast<VecN<T, V>*>(dst)[i] = o;
      }
    }
  } else {
    for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x)
      dst[i] = from_f32<T>(to_f32(src[i]) * step);
  }
}

template <typename Q, typename T>
int launch(ReadArgs a, int slots, cudaStream_t st) {
  constexpr int V = vec_elems<Q, T>();
  a.part = (long long)kThreads * V * kSteps;
  const long long widest = a.page_elems[0] > a.page_elems[1] ? a.page_elems[0] : a.page_elems[1];
  const long long parts = (widest + a.part - 1) / a.part;
  if (parts > 65535) return (int)cudaErrorInvalidValue;
  for (int t = 0; t < 2; ++t)
    a.vec[t] = a.page_elems[t] % V == 0 && aligned(a.data[t], alignof(VecN<Q, V>)) &&
               aligned(a.out[t], alignof(VecN<T, V>));
  p2_read_paged_kernel<Q, T>
      <<<dim3(slots * a.pages_per_slot, 2, (unsigned)parts), kThreads, 0, st>>>(a);
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

// kdata, vdata: (trash + 1, page_size, kF) and (trash + 1, page_size, vF)
// codes of q_code (0 int8, 1 int16, 2 int32, 3 f32); kout, vout: (slots,
// pages_per_slot * page_size, kF / vF) of y_dtype (0 f32, 1 bf16, 2 f16),
// contiguous, written whole; kscale, vscale: (slots,) f32 scale_log2;
// table: (slots, pages_per_slot) int32 with row stride table_stride;
// k_page_elems = page_size * kF, v_page_elems = page_size * vF. Returns
// cudaGetLastError() after the launch.
int p2_read_paged(const void* kdata, const void* vdata, int q_code, void* kout, void* vout,
                  int y_dtype, const void* kscale, const void* vscale, const void* table,
                  long long table_stride, int slots, int pages_per_slot,
                  long long k_page_elems, long long v_page_elems, int trash, void* stream) {
  if (y_dtype < F32 || y_dtype > F16 || slots < 0 || pages_per_slot < 1 || k_page_elems < 0 ||
      v_page_elems < 0 || trash < 0 || (long long)slots * pages_per_slot > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (slots == 0 || k_page_elems + v_page_elems == 0) return (int)cudaSuccess;
  ReadArgs a{};
  a.data[0] = kdata;
  a.data[1] = vdata;
  a.out[0] = kout;
  a.out[1] = vout;
  a.scale[0] = (const float*)kscale;
  a.scale[1] = (const float*)vscale;
  a.table = (const int*)table;
  a.table_stride = table_stride;
  a.page_elems[0] = k_page_elems;
  a.page_elems[1] = v_page_elems;
  a.pages_per_slot = pages_per_slot;
  a.trash = trash;
  cudaStream_t st = (cudaStream_t)stream;
  int refused = (int)cudaSuccess;
  const int code = with_code(q_code, [&](auto qt) {
    using Q = decltype(qt);
    switch (y_dtype) {
      case F32: refused = launch<Q, float>(a, slots, st); break;
      case BF16: refused = launch<Q, __nv_bfloat16>(a, slots, st); break;
      case F16: refused = launch<Q, __half>(a, slots, st); break;
    }
  });
  return refused != (int)cudaSuccess ? refused : code;
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
