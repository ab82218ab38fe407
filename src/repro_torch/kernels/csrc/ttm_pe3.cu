// PE3 (paper Appendix A.2): What(j, i) = sum_b Ybar(b, j) X(b, i), the
// batch-contracted outer product the full-weight gradient comes from.
//
// Replaces: repro/kernels/ttm_pe3.py:23 `_pe3_kernel` / `pe3_outer`
// (pallas_call at :51). On the training path: one launch per TT site a
// step, in each layer's backward: 2 an FMNIST MLP step (f32, b = 64, (j,
// i) = (512, 896) and (16, 512)), 144 a step of with_tt(internlm2-1.8b)
// (bf16, b = 2048, Ŵ 8192 x 2048, 2048 x 8192 and 2048 x 2048), 72 a step
// of with_tt(LM100M, d=3, max_rank=48) (f32, b = 2048, Ŵ 768 x 768, 1536 x
// 768, 3072 x 768 and 768 x 3072; 73 with the TT head's 32768 x 768).
//
// PE3 is the PE2 contraction at a = 1 with Z = X (1, b, i) and G = Ybar
// (b, j), so it runs PE2's three bodies under names of its own, chosen in
// the same order (kernels/tt_mma.py::plan, kernels/tt_tile.py::plan, the
// rest):
//
// bf16 with even rows (every LM call; rows the TMA cannot take staged by
// cp.async granules, tt_mma.cuh): `pe3_mma_kernel`, wgmma on the
// tensor cores (tt_mma.cuh). Bound on the H100 at the LM's shapes: bf16
// operations. 8192 x 2048 x 2048 is 68.7 GFLOP, 69.5 us at 989 TFLOP/s,
// against 50 MB of operands and output (15 us at 3.35 TB/s). What the
// design does about it: a plain GEMM on the tensor cores, M = j, N = i,
// K = b, both operands MN-major as they lie in memory (no transpose
// pass): 128 x 256 tiles, each of two consumer warpgroups a 64 x 256
// product of m64n256k16 wgmma steps with 128 f32 sums a thread, b in
// chunks of 64 rows streamed by TMA (128-byte swizzle) through a ring of
// three 48 KB stages that a producer warp keeps full across tiles of a
// persistent CTA. The whole of b (2,048) runs in each CTA: no split-K.
//
// f32 with at least 2^28 flops (LM100M's Ŵ): `pe3_tile_kernel`, a GEMM of
// M = i, N = j, K = b on the CUDA cores in full FP32 (tt_tile.cuh). Bound
// on the H100: FP32 operations at 67 TFLOP/s, 36.1 us at 768 x 768, 72.1
// at 1536 x 768, 144.2 at 3072 x 768 and 768 x 3072, 1,538.5 at the
// head's 32768 x 768 (the bytes, b x (i + j) floats read and i x j
// written, take a fraction of that at 3.35 TB/s). What the design does
// about it: the head's Ŵ is 768 tiles of 256 x 128 on the wide body (16 x
// 8 sums a thread, one CTA an SM); the small Ŵ are 36-144 tiles of 128 x
// 128 (8 x 8 sums, two CTAs an SM), too few for 132 SMs over b = 2048, so
// a thread block cluster of 3 or 6 CTAs shares each tile, each CTA summing
// a contiguous third or sixth of b, and the partial tiles are added in
// rank order through distributed shared memory in the same launch. The
// previous design, `pe3_kernel`, ran 128 x 32 tiles of 4 x 4 sums, each
// CTA walking all of b.
//
// f32 under that size (the MLP) and the bf16 calls the tensor-core plan
// cannot tile: `pe3_kernel`,
// PE2's streamed FMA body (tt_contract.cuh). Bound: FP32 operations for
// 512 x 896 (58.7 MFLOP, 0.88 us at 67 TFLOP/s), bytes for 16 x 512 (0.05
// us); at both sizes what costs is filling the card. The plan
// (kernels/tt_contract.py) gives 512 x 896 tiles of 32 (j) x 64 (i): 224
// CTAs of 128 threads, each thread a 4 x 4 register tile, the whole b = 64
// in one 24 KB stage brought in with 16-byte cp.async. 16 x 512 gets 4 x 8
// tiles, 256 CTAs, with b split 32 ways across a warp's lanes and the
// shares added by a fixed xor tree.

#include "tt_contract.cuh"
#include "tt_mma.cuh"
#include "tt_tile.cuh"

namespace {

template <typename T, int RD>
__global__ void __launch_bounds__(tt_contract::kMaxThreads)
pe3_kernel(const T* __restrict__ x, const T* __restrict__ ybar, T* __restrict__ w,
           tt_contract::Plan p) {
  tt_contract::contract<T, RD>(x, ybar, w, p);
}

template <int WGN, int SW>
__global__ void __launch_bounds__(tt_mma::kMaxThreads<WGN, SW>, 1)
pe3_mma_kernel(const __grid_constant__ CUtensorMap tybar, const __grid_constant__ CUtensorMap tx,
               const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ ybar,
               __nv_bfloat16* __restrict__ w, const tt_mma::Plan p) {
  tt_mma::gemm<WGN, SW>(&tybar, &tx, reinterpret_cast<const uint8_t*>(x),
                        reinterpret_cast<const uint8_t*>(ybar), w, p);
}

template <int WGN, int SW>
struct Mma {
  static const void* fn() { return (const void*)pe3_mma_kernel<WGN, SW>; }
};

template <int TM, int TN, int KR>
__global__ void __launch_bounds__(tt_tile::max_threads(TM, TN), tt_tile::min_blocks(TM, TN))
pe3_tile_kernel(const float* __restrict__ x, const float* __restrict__ ybar,
                float* __restrict__ w, const tt_tile::Plan p) {
  tt_tile::gemm<TM, TN, KR>(x, ybar, w, p);
}

template <int TM, int TN, int KR>
struct Tile {
  static const void* fn() { return (const void*)pe3_tile_kernel<TM, TN, KR>; }
};

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

// x (groups, b, i), ybar (groups, b, j), w (groups, j, i): contiguous
// device arrays of dtype (0 f32, 1 bf16); `plan` is one group's PE2 plan at
// a = 1, c = i, d = j (23 int32, kernels/tt_contract.py PLAN_FIELDS).
// Returns cudaGetLastError() after the launch.
int pe3(const void* x, const void* ybar, void* w, int dtype, const int* plan, int groups,
        void* stream) {
  const int rd = plan[4];
  const void* fn = dtype == tt_contract::F32    ? pick<float>(rd)
                   : dtype == tt_contract::BF16 ? pick<__nv_bfloat16>(rd)
                                                : nullptr;
  return tt_contract::launch(fn, x, ybar, w, plan, groups, stream);
}

// The tensor-core route: x (groups, b, i), ybar (groups, b, j), w (groups,
// j, i), contiguous bf16, w 16-byte aligned, x and ybar 16-byte aligned or
// on their granules; `plan` is one group's PE2 plan at a = 1, c = i, d = j
// (27 int32, kernels/tt_mma.py PLAN_FIELDS). Returns cudaGetLastError()
// after the launch.
int pe3_mma(const void* x, const void* ybar, void* w, const int* plan, int groups,
            void* stream) {
  return tt_mma::launch(tt_mma::pick<Mma>(plan[4], plan[5]), x, ybar, w, plan, groups, stream);
}

// The f32 tile route: x (b, i), ybar (b, j), w (j, i), contiguous f32;
// `plan` is the PE2 plan at a = 1, c = i, d = j (34 int32,
// kernels/tt_tile.py PLAN_FIELDS). Returns the launch's error, then
// cudaGetLastError().
int pe3_tile(const void* x, const void* ybar, void* w, const int* plan, void* stream) {
  return tt_tile::launch(tt_tile::pick<Tile>(plan[4], plan[5], plan[6]), x, ybar, w, plan, stream);
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
