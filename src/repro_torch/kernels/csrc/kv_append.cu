// Decode-step KV append: one new token per slot, K and V of one layer,
// encoded to pow-2 codes under the slot's scale and written straight into
// the layer's pool pages, in place, in one launch.
//
// Replaces: repro/numerics/pallas_backend.py `_p2_enc_rows_kernel` as the
// reference's decode append runs it (repro/serve/kv_cache.py append_token:
// the page gathered from the page table, the trash redirect of inactive
// slots, the row-scale encode of the (B, Hkv*Dh) token and the
// `.at[pages, offs].set` scatter), for K and for V. On the serving path this
// is once a layer a decode step (24 launches a step on internlm2-1.8b),
// where the port launched `p2_enc_rows` twice a layer with about six eager
// index kernels and an `index_put_` around each launch.
//
// Per slot b, on the device (nothing is read back to the host):
//   j    = lens[b] / page_size
//   page = active[b] and 0 <= j < pages_per_slot ? table[b, j] : trash
//   off  = lens[b] mod page_size                    (non-negative)
//   data[page, off, :] = Q(clamp(rint(x / 2^scale[b]), lo, hi))
// with p2_enc_rows's numerics: 2^s formed exactly (pow2_step), IEEE
// division and rintf (no --use_fast_math), Q saturating (to_code). A
// position past the slot's last page goes to the trash page: the
// reference's take_along_axis fills such an index (INT_MIN) and its scatter
// drops the write, so no real page changes either way. A page number
// outside the pool is sent to the trash page too, so a bad table never
// writes outside it.
//
// Bound on the H100: bytes. 2 x B x F inputs read once and as many codes
// written (48 KB for K and V of 8 slots x 8 heads x 128 in bf16: 0.015 us
// at 3.35 TB/s), one divide and one round an element; at these sizes the
// launch itself is what a call waits on. Design: one launch takes K and V
// of every slot, so a decode step pays one launch a layer and no host work
// beyond it. Grid (slot, tensor): a CTA reads its slot's page, offset and
// step from device memory and walks the slot's F elements in 16-byte
// vectors of the input (8 bf16 or 4 f32 elements), writing the codes as
// one 8- or 4-byte word a vector where the rows are aligned, else element
// by element. Each input is taken at its own slot stride, so V, a strided
// view of the fused kv projection, is read in place with no copy. No shared
// memory, no synchronisation.

#include "pow2_codes.cuh"

namespace {

using namespace pow2_codes;

constexpr int kThreads = 128;

// V elements of T, aligned to their size up to 16 bytes
template <typename T, int V>
struct alignas(sizeof(T) * V < 16 ? sizeof(T) * V : 16) VecN {
  T v[V];
};

struct AppendArgs {
  const void* x[2];          // K, V tokens: slot b's F elements at x + b * stride
  long long stride[2];       // their slot strides, in elements
  void* data[2];             // K, V pages (trash + 1, page_size, F) codes
  const float* scale[2];     // (B,) scale_log2 of each slot
  const int* table;          // (B, pages_per_slot) int32, row stride table_stride
  long long table_stride;
  const int* lens;           // (B,) int32 position of each slot's new token
  const uint8_t* active;     // (B,) bool
  long long feat;            // F = Hkv * Dh
  int pages_per_slot, page_size, trash;
  int vec[2];                // K / V take the vector path
  float lo, hi;
};

template <typename T, typename Q>
__global__ void __launch_bounds__(kThreads)
    p2_append_paged_kernel(const __grid_constant__ AppendArgs a) {
  constexpr int V = 16 / sizeof(T);
  const int b = blockIdx.x, t = blockIdx.y;
  const int len = __ldg(a.lens + b);
  const int j = len / a.page_size;
  int page = a.trash;
  if (a.active[b] && len >= 0 && j < a.pages_per_slot) {
    page = __ldg(a.table + b * a.table_stride + j);
    if (page < 0 || page > a.trash) page = a.trash;
  }
  const int off = (len % a.page_size + a.page_size) % a.page_size;
  const T* __restrict__ x = static_cast<const T*>(a.x[t]) + b * a.stride[t];
  Q* __restrict__ q =
      static_cast<Q*>(a.data[t]) + ((long long)page * a.page_size + off) * a.feat;
  const float step = pow2_step(__ldg(a.scale[t] + b));
  const float lo = a.lo, hi = a.hi;
  auto enc = [lo, hi, step](float v) {
    return to_code<Q>(fminf(fmaxf(rintf(v / step), lo), hi));
  };
  if (a.vec[t]) {
    for (long long i = threadIdx.x; i < a.feat / V; i += blockDim.x) {
      const VecN<T, V> in = reinterpret_cast<const VecN<T, V>*>(x)[i];
      VecN<Q, V> out;
#pragma unroll
      for (int k = 0; k < V; ++k) out.v[k] = enc(to_f32(in.v[k]));
      reinterpret_cast<VecN<Q, V>*>(q)[i] = out;
    }
  } else {
    for (long long i = threadIdx.x; i < a.feat; i += blockDim.x) q[i] = enc(to_f32(x[i]));
  }
}

template <typename T, typename Q>
void launch(AppendArgs a, int slots, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  for (int t = 0; t < 2; ++t)
    a.vec[t] = a.feat % V == 0 && aligned(a.x[t], 16) &&
               (slots == 1 || (a.stride[t] * (long long)sizeof(T)) % 16 == 0) &&
               aligned(a.data[t], alignof(VecN<Q, V>));
  p2_append_paged_kernel<T, Q><<<dim3(slots, 2), kThreads, 0, st>>>(a);
}

}  // namespace

extern "C" {

// k, v: slot b's F = Hkv * Dh elements of x_dtype (0 f32, 1 bf16, 2 f16)
// at k + b * k_stride (v + b * v_stride), contiguous within the slot;
// kdata, vdata: (trash + 1, page_size, F) codes of q_code (0 int8, 1 int16,
// 2 int32, 3 f32), written in place; kscale, vscale: (slots,) f32
// scale_log2; table: (slots, pages_per_slot) int32 with row stride
// table_stride; lens: (slots,) int32; active: (slots,) bool. bits in
// [2, code_bits(q_code)]. Returns cudaGetLastError() after the launch.
int p2_append_paged(const void* k, const void* v, int x_dtype, long long k_stride,
                    long long v_stride, void* kdata, void* vdata, int q_code,
                    const void* kscale, const void* vscale, const void* table,
                    long long table_stride, int pages_per_slot, const void* lens,
                    const void* active, int slots, long long feat, int page_size, int trash,
                    int bits, void* stream) {
  if (bits < 2 || bits > code_bits(q_code) || x_dtype < F32 || x_dtype > F16 || slots < 0 ||
      feat < 0 || page_size < 1 || pages_per_slot < 1 || trash < 0)
    return (int)cudaErrorInvalidValue;
  if (slots == 0 || feat == 0) return (int)cudaSuccess;
  AppendArgs a{};
  a.x[0] = k;
  a.x[1] = v;
  a.stride[0] = k_stride;
  a.stride[1] = v_stride;
  a.data[0] = kdata;
  a.data[1] = vdata;
  a.scale[0] = (const float*)kscale;
  a.scale[1] = (const float*)vscale;
  a.table = (const int*)table;
  a.table_stride = table_stride;
  a.lens = (const int*)lens;
  a.active = (const uint8_t*)active;
  a.feat = feat;
  a.pages_per_slot = pages_per_slot;
  a.page_size = page_size;
  a.trash = trash;
  qrange_f32(bits, &a.lo, &a.hi);
  cudaStream_t st = (cudaStream_t)stream;
  return with_code(q_code, [&](auto qt) {
    using Q = decltype(qt);
    switch (x_dtype) {
      case F32: launch<float, Q>(a, slots, st); break;
      case BF16: launch<__nv_bfloat16, Q>(a, slots, st); break;
      case F16: launch<__half, Q>(a, slots, st); break;
    }
  });
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
