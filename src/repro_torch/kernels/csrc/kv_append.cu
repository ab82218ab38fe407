// Paged KV write: S tokens per slot, K and V of one layer, encoded to pow-2
// codes under the slot's scale and written straight into the layer's pool
// pages, in place, in one launch. S = 1 is the decode step's append; S > 1
// is the chunk step's write (chunked prefill, a prefix hit's suffix).
//
// Replaces: repro/numerics/pallas_backend.py `_p2_enc_rows_kernel` as the
// reference's decode append runs it (repro/serve/kv_cache.py append_token:
// the page gathered from the page table, the trash redirect of inactive
// slots, the row-scale encode of the (B, Hkv*Dh) token and the
// `.at[pages, offs].set` scatter), and `_p2_enc_kernel` (:120) as its chunk
// write runs it (kv_cache.py write_chunk: the page index of each row, the
// trash redirect of pad rows, the scalar-scale encode of the (S, Hkv*Dh)
// chunk and the scatter), for K and for V. On the serving path this is once
// a layer a decode step and once a layer a chunk step (24 launches a step
// on internlm2-1.8b), where the port launched an encode twice a layer with
// about six eager index kernels and an `index_put_` around each launch.
//
// Row j of slot b (position pos = lens[b] + j), on the device (nothing is
// read back to the host):
//   valid = (active == null or active[b]) and (n_valid == null or j < n_valid[b])
//   idx   = pos / page_size
//   drop rule  (clamp_last = 0, append_token): idx >= pages_per_slot -> trash
//   clamp rule (clamp_last = 1, write_chunk):  idx = min(idx, pages_per_slot - 1)
//   page  = valid and 0 <= idx < pages_per_slot ? table[b, idx] : trash
//   data[page, pos mod page_size, :] = Q(clamp(rint(x / 2^scale[b]), lo, hi))
// with p2_enc_rows's and p2_enc's numerics (which are the same): 2^s formed
// exactly (pow2_step), IEEE division and rintf (no --use_fast_math), Q
// saturating (to_code). The two rules are the reference's two writes where
// they differ: append_token's take_along_axis fills an index past the
// slot's last page (INT_MIN) and its scatter drops the write, so no real
// page changes; write_chunk's gather clamps it, so the row lands in the last
// page. Under the clamp rule two valid rows pos and pos + page_size both past
// the last page's start write one cell; the reference's scatter keeps the
// later, so the earlier goes to the trash page here and the result does not
// depend on the order the CTAs run in. A negative position and a page number
// outside the pool go to the trash page, so a bad table never writes outside
// it.
//
// Bound on the H100: bytes. 2 x B x S x F inputs read once and as many codes
// written (786 KB for K and V of a 128-token chunk x 8 heads x 128 in bf16:
// 0.235 us at 3.35 TB/s; 48 KB for a decode step's 8 slots, 0.015 us), one
// divide and one round an element; at these sizes the launch itself is what
// a call waits on. Design: one launch takes K and V of every row of every
// slot, so a step pays one launch a layer and no host work beyond it. Grid
// (slot x row, tensor): a CTA reads its slot's page, offset and step from
// device memory and walks its tensor's row of F[t] elements (K and V may
// differ in width: MLA's latent c_kv and rope key) in 16-byte vectors of the
// input (8 bf16 or 4 f32 elements), writing the codes as one 8- or 4-byte
// word a vector where the rows are aligned, else element by element. Each
// input is taken at its own slot and token strides, so V, a strided view of
// the fused kv projection, is read in place with no copy. Each tensor takes
// the vector path or the element loop on its own width and alignment, so
// one launch may run both. No shared memory, no synchronisation.
//
// Quant health (health.cuh): with `health` non-null the launch also adds
// (clipped, total) to health[0..1], the reference's append_health
// (repro/serve/kv_cache.py:294, obs.pow2_clip_stats of the new K/V against
// the slots' frozen scales) summed over both tensors: a row counts where
// its slot is active and j < n_valid (at S = 1, the decode step, exactly
// active[b]; a row sent to the trash page because it is past the slot's
// last page still counts, an inactive slot's never does), and an element
// is clipped where the f32 quotient x / 2^s the encode rounds lies outside
// [lo, hi] before the clamp. The engine passes one buffer to every layer's
// launch and reads it once a step, only when health is on. Cost: two
// compares an element in registers and, a CTA, one warp reduction, one
// __syncthreads and up to two 64-bit atomics (a separate instantiation, so
// a null buffer runs the kernel without them).

#include "health.cuh"
#include "kv_pages.cuh"
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
  const void* x[2];          // K, V: row j of slot b at x + b * stride + j * tstride
  long long stride[2];       // their slot strides, in elements
  long long tstride[2];      // their token strides, in elements
  void* data[2];             // K, V pages (trash + 1, page_size, F) codes
  const float* scale[2];     // (B,) scale_log2 of each slot
  const int* table;          // (B, pages_per_slot) int32, row stride table_stride
  long long table_stride;
  const int* lens;           // (B,) int32 position of each slot's row 0
  const uint8_t* active;     // (B,) bool, or null: every slot active
  const int* n_valid;        // (B,) int32 valid rows, or null: every row valid
  long long feat[2];         // K, V: F = Hkv * Dh (GQA, the same twice), or
                             // MLA's kv_lora_rank and qk_rope_head_dim
  int tokens;                // S rows a slot
  int pages_per_slot, page_size, trash;
  int clamp_last;            // 0: drop rule, 1: clamp rule
  int vec[2];                // K / V take the vector path
  float lo, hi;
  unsigned long long* health;  // (clipped, total), or null: no counting
};

template <typename T, typename Q, bool HEALTH>
__global__ void __launch_bounds__(kThreads)
    p2_append_paged_kernel(const __grid_constant__ AppendArgs a) {
  constexpr int V = 16 / sizeof(T);
  const int t = blockIdx.y;
  const int b = a.tokens == 1 ? blockIdx.x : blockIdx.x / a.tokens;
  const int j = blockIdx.x - b * a.tokens;
  // the slot's loads are independent of each other: issue them together,
  // so the table read is the only one that waits on another
  const int len = __ldg(a.lens + b);
  const bool act = a.active == nullptr || a.active[b];
  const int nv = a.n_valid == nullptr ? a.tokens : min(__ldg(a.n_valid + b), a.tokens);
  const float s = __ldg(a.scale[t] + b);
  const int pos = len + j;
  const int page = kv_pages::row_page(a.table + b * a.table_stride, a.pages_per_slot,
                                      a.page_size, a.trash, a.clamp_last, j, pos, act, nv);
  const int off = (pos % a.page_size + a.page_size) % a.page_size;
  const T* __restrict__ x =
      static_cast<const T*>(a.x[t]) + b * a.stride[t] + j * a.tstride[t];
  const long long F = a.feat[t];
  Q* __restrict__ q =
      static_cast<Q*>(a.data[t]) + ((long long)page * a.page_size + off) * F;
  const float step = pow2_step(s);
  const float lo = a.lo, hi = a.hi;
  unsigned clipped = 0;
  auto enc = [lo, hi, step, &clipped](float v) {
    const float r = v / step;
    if (HEALTH) clipped += (r < lo) | (r > hi);
    return to_code<Q>(fminf(fmaxf(rintf(r), lo), hi));
  };
  if (a.vec[t]) {
    for (long long i = threadIdx.x; i < F / V; i += blockDim.x) {
      const VecN<T, V> in = reinterpret_cast<const VecN<T, V>*>(x)[i];
      VecN<Q, V> out;
#pragma unroll
      for (int k = 0; k < V; ++k) out.v[k] = enc(to_f32(in.v[k]));
      reinterpret_cast<VecN<Q, V>*>(q)[i] = out;
    }
  } else {
    for (long long i = threadIdx.x; i < F; i += blockDim.x) q[i] = enc(to_f32(x[i]));
  }
  if constexpr (HEALTH) {
    __shared__ unsigned part[64];
    const bool counted = act && j < nv;
    health::cta_add2(a.health, counted ? clipped : 0u,
                     counted && threadIdx.x == 0 ? (unsigned)F : 0u, part);
  }
}

template <typename T, typename Q>
void launch(AppendArgs a, int slots, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  for (int t = 0; t < 2; ++t)
    a.vec[t] = a.feat[t] % V == 0 && aligned(a.x[t], 16) &&
               (slots == 1 || (a.stride[t] * (long long)sizeof(T)) % 16 == 0) &&
               (a.tokens == 1 || (a.tstride[t] * (long long)sizeof(T)) % 16 == 0) &&
               aligned(a.data[t], alignof(VecN<Q, V>));
  if (a.health)
    p2_append_paged_kernel<T, Q, true><<<dim3(slots * a.tokens, 2), kThreads, 0, st>>>(a);
  else
    p2_append_paged_kernel<T, Q, false><<<dim3(slots * a.tokens, 2), kThreads, 0, st>>>(a);
}

}  // namespace

extern "C" {

// k, v: row j of slot b holds kfeat (vfeat) elements of x_dtype (0 f32,
// 1 bf16, 2 f16) at k + b * k_stride + j * k_tstride (v likewise),
// contiguous within the row, j < tokens; kdata, vdata: (trash + 1,
// page_size, kfeat) and (trash + 1, page_size, vfeat) codes of q_code
// (0 int8, 1 int16, 2 int32, 3 f32), written in place; kscale, vscale:
// (slots,) f32 scale_log2; table: (slots, pages_per_slot) int32 with row
// stride table_stride; lens: (slots,) int32 position of row 0; active:
// (slots,) bool or null (every slot active); n_valid: (slots,) int32 or
// null (every row valid); clamp_last selects the rule for a valid row past
// the slot's last page (0 trash, 1 the last page); health: two uint64
// counters on the device that the launch adds (clipped, total) to, or null.
// bits in [2, code_bits(q_code)]. Returns cudaGetLastError() after the
// launch.
int p2_append_paged(const void* k, const void* v, int x_dtype, long long k_stride,
                    long long v_stride, long long k_tstride, long long v_tstride, int tokens,
                    void* kdata, void* vdata, int q_code, const void* kscale,
                    const void* vscale, const void* table, long long table_stride,
                    int pages_per_slot, const void* lens, const void* active,
                    const void* n_valid, int clamp_last, int slots, long long kfeat,
                    long long vfeat, int page_size, int trash, int bits, void* health,
                    void* stream) {
  if (bits < 2 || bits > code_bits(q_code) || x_dtype < F32 || x_dtype > F16 || slots < 0 ||
      tokens < 0 || kfeat < 0 || vfeat < 0 || page_size < 1 || pages_per_slot < 1 ||
      trash < 0 || (long long)slots * tokens > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (slots == 0 || tokens == 0 || kfeat + vfeat == 0) return (int)cudaSuccess;
  AppendArgs a{};
  a.x[0] = k;
  a.x[1] = v;
  a.stride[0] = k_stride;
  a.stride[1] = v_stride;
  a.tstride[0] = k_tstride;
  a.tstride[1] = v_tstride;
  a.data[0] = kdata;
  a.data[1] = vdata;
  a.scale[0] = (const float*)kscale;
  a.scale[1] = (const float*)vscale;
  a.table = (const int*)table;
  a.table_stride = table_stride;
  a.lens = (const int*)lens;
  a.active = (const uint8_t*)active;
  a.n_valid = (const int*)n_valid;
  a.feat[0] = kfeat;
  a.feat[1] = vfeat;
  a.tokens = tokens;
  a.pages_per_slot = pages_per_slot;
  a.page_size = page_size;
  a.trash = trash;
  a.clamp_last = clamp_last != 0;
  a.health = (unsigned long long*)health;
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
