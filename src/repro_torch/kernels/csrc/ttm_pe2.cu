// PE2 (paper Eq. 6): Z'(a, d, c) = sum_b Z(a, b, c) G(b, d).
//
// Replaces: repro/kernels/ttm_pe2.py:25 `_pe2_kernel` / `pe2_batched`. On
// the training path it runs inside every TT matvec chain (forward, the
// scale manager's forward probe and the transposed dx chain): 12 launches
// a step, at (a, b, c) x (b, d) from (1792, 32, 16) x (32, 32) down to
// (64, 512, 16) x (512, 1).
//
// Bound on the H100: bytes. The step's shapes read and write 0.2-7.4 MB
// for at most 117 MFLOP, at or under the FP32 ridge (67 TFLOP/s over 3.35
// TB/s, ~20 FLOP/B), so each call is 0.06-2.2 us of HBM traffic; at those
// sizes what costs is latency: too few CTAs, idle lanes, and loads that
// wait one after another.
//
// Design (tt_contract.cuh): every slab Z[a] is b x c contiguous, so a CTA
// copies a run of slabs and the matching rows of G into shared memory with
// 16-byte cp.async (b-chunks through a ring of up to four slots when b
// does not fit one stage) and keeps an rd x 4 register tile of f32 sums
// per thread, threads along c. The plan (kernels/tt_contract.py) sizes
// slab runs and tiles so the grid fills the 132 SMs with the fewest
// slab-tiles on the busiest SM, and splits b across neighbouring lanes
// where a tile has few outputs (d = 1 with b = 512: 16 outputs of 512-long
// dot products), the shares meeting in a fixed order.

#include "tt_contract.cuh"

namespace {

template <typename T, int RD>
__global__ void __launch_bounds__(tt_contract::kMaxThreads)
pe2_kernel(const T* __restrict__ z, const T* __restrict__ g, T* __restrict__ o,
           tt_contract::Plan p) {
  tt_contract::contract<T, RD>(z, g, o, p);
}

template <typename T>
const void* pick(int rd) {
  switch (rd) {
    case 1: return (const void*)pe2_kernel<T, 1>;
    case 2: return (const void*)pe2_kernel<T, 2>;
    case 4: return (const void*)pe2_kernel<T, 4>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// z (a, b, c), g (b, d), o (a, d, c): contiguous device arrays of dtype
// (0 f32, 1 bf16); `plan` is 23 int32 (kernels/tt_contract.py PLAN_FIELDS).
// Returns cudaGetLastError() after the launch.
int pe2(const void* z, const void* g, void* o, int dtype, const int* plan, void* stream) {
  const int rd = plan[4];
  const void* fn = dtype == tt_contract::F32    ? pick<float>(rd)
                   : dtype == tt_contract::BF16 ? pick<__nv_bfloat16>(rd)
                                                : nullptr;
  return tt_contract::launch(fn, z, g, o, plan, stream);
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
