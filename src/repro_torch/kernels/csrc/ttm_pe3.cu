// PE3 (paper Appendix A.2): What(j, i) = sum_b Ybar(b, j) X(b, i), the
// batch-contracted outer product the full-weight gradient comes from.
//
// Replaces: repro/kernels/ttm_pe3.py:23 `_pe3_kernel` / `pe3_outer`. On the
// training path: one launch per layer a step, at b = 64 with (j, i) =
// (512, 896) and (16, 512).
//
// Bound on the H100: FP32 operations for the large shape (58.7 MFLOP, 0.88
// us at 67 TFLOP/s), bytes for the small one (0.05 us); at both sizes what
// costs is filling the card: a 64 x 64 output tile gives 112 CTAs for 512 x
// 896 and 8 for 16 x 512 on 132 SMs.
//
// Design: PE3 is the PE2 contraction at a = 1 with Z = X (1, b, i) and G =
// Ybar (b, j), so it runs the same streamed body (tt_contract.cuh) under
// its own kernel name. The plan (kernels/tt_contract.py) gives 512 x 896
// tiles of 32 (j) x 64 (i): 224 CTAs of 128 threads, each thread a 4 x 4
// register tile, the whole b = 64 in one 24 KB stage brought in with 16-byte
// cp.async. 16 x 512 gets 4 x 8 tiles, 256 CTAs, with b split 32 ways
// across a warp's lanes and the shares added by a fixed xor tree.

#include "tt_contract.cuh"

namespace {

template <typename T, int RD>
__global__ void __launch_bounds__(tt_contract::kMaxThreads)
pe3_kernel(const T* __restrict__ x, const T* __restrict__ ybar, T* __restrict__ w,
           tt_contract::Plan p) {
  tt_contract::contract<T, RD>(x, ybar, w, p);
}

template <typename T>
const void* pick(int rd) {
  switch (rd) {
    case 1: return (const void*)pe3_kernel<T, 1>;
    case 2: return (const void*)pe3_kernel<T, 2>;
    case 4: return (const void*)pe3_kernel<T, 4>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// x (b, i), ybar (b, j), w (j, i): contiguous device arrays of dtype (0 f32,
// 1 bf16); `plan` is the PE2 plan at a = 1, c = i, d = j (23 int32,
// kernels/tt_contract.py PLAN_FIELDS). Returns cudaGetLastError() after the
// launch.
int pe3(const void* x, const void* ybar, void* w, int dtype, const int* plan, void* stream) {
  const int rd = plan[4];
  const void* fn = dtype == tt_contract::F32    ? pick<float>(rd)
                   : dtype == tt_contract::BF16 ? pick<__nv_bfloat16>(rd)
                                                : nullptr;
  return tt_contract::launch(fn, x, ybar, w, plan, stream);
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
