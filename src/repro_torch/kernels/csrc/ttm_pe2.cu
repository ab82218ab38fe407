// PE2 (paper Eq. 6): Z'(a, d, c) = sum_b Z(a, b, c) G(b, d).
//
// Replaces: repro/kernels/ttm_pe2.py:25 `_pe2_kernel` / `pe2_batched`
// (pallas_call at :47). On the training path it runs inside every TT
// matvec chain (forward, the remat recompute or the scale manager's
// forward probe, and the transposed dx chain): 12 launches an FMNIST MLP
// step (f32, (1792, 32, 16) x (32, 32) down to (64, 512, 16) x (512, 1)),
// 864 a step of with_tt(internlm2-1.8b) (bf16, six shapes).
//
// Two bodies, chosen by kernels/tt_mma.py::plan from dtype, shape and
// alignment alone:
//
// bf16 with 16-byte rows (every LM call): `pe2_mma_kernel`, wgmma on the
// tensor cores (tt_mma.cuh). Bound on the H100 at the LM's shapes: bytes.
// (32768, 256, 16) x (256, 256) reads 268 MB of Z and writes 268 MB of O
// for 68.7 GFLOP: 160.3 us at 3.35 TB/s against 69.5 us of bf16 products
// at 989 TFLOP/s; (2048, 128, 512) x (128, 16) is 90.1 us of bytes for
// 4.3 GFLOP. What the design does about it: Z streams through a TMA ring
// of 64-row chunks kept in flight across tile boundaries by a producer
// warp of a persistent CTA, and G (at most 256 x 256 bf16, 128 KB) is
// loaded once per CTA and stays in shared memory, so HBM carries Z in
// and O out once and nothing else. Where c = 16 or 32, 64 / c slabs stand
// side by side as the N of one 64 x 64 product per warpgroup (one 3-D TMA
// box, 32- or 64-byte swizzle), and a warpgroup's 64 rows of a slab are
// one contiguous run of O (2 or 4 KB), bulk-copied out of a staging tile
// while the next tile's products run. Where d = 8 or 16, the 64 rows of M
// are mostly the TMA's zero fill: 4-8x the products, still a fifth of the
// byte time per slab.
//
// f32 (the MLP) and the bf16 calls the plan cannot tile: `pe2_kernel`,
// the streamed FMA body (tt_contract.cuh). Bound: bytes; the MLP's shapes
// read and write 0.2-7.4 MB for at most 117 MFLOP, at or under the FP32
// ridge (67 TFLOP/s over 3.35 TB/s, ~20 FLOP/B), so each call is 0.06-2.2
// us of HBM traffic and what costs is latency: too few CTAs, idle lanes,
// loads that wait one after another. Every slab Z[a] is b x c contiguous,
// so a CTA copies a run of slabs and the matching rows of G into shared
// memory with 16-byte cp.async (b-chunks through a ring of up to four
// slots when b does not fit one stage) and keeps an rd x 4 register tile
// of f32 sums per thread, threads along c. The plan (kernels/tt_contract.py)
// sizes slab runs and tiles so the grid fills the 132 SMs with the fewest
// slab-tiles on the busiest SM, and splits b across neighbouring lanes
// where a tile has few outputs (d = 1 with b = 512: 16 outputs of 512-long
// dot products), the shares meeting in a fixed order.

#include "tt_contract.cuh"
#include "tt_mma.cuh"

namespace {

template <typename T, int RD>
__global__ void __launch_bounds__(tt_contract::kMaxThreads)
pe2_kernel(const T* __restrict__ z, const T* __restrict__ g, T* __restrict__ o,
           tt_contract::Plan p) {
  tt_contract::contract<T, RD>(z, g, o, p);
}

template <int WGN, int SW>
__global__ void __launch_bounds__(tt_mma::kMaxThreads<WGN>, 1)
pe2_mma_kernel(const __grid_constant__ CUtensorMap g, const __grid_constant__ CUtensorMap z,
               __nv_bfloat16* __restrict__ o, const tt_mma::Plan p) {
  tt_mma::gemm<WGN, SW>(&g, &z, o, p);
}

template <int WGN, int SW>
struct Mma {
  static const void* fn() { return (const void*)pe2_mma_kernel<WGN, SW>; }
};

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

// The tensor-core route: z (a, b, c), g (b, d), o (a, d, c), contiguous
// bf16, 16-byte aligned; `plan` is 25 int32 (kernels/tt_mma.py
// PLAN_FIELDS). Returns cudaGetLastError() after the launch.
int pe2_mma(const void* z, const void* g, void* o, const int* plan, void* stream) {
  return tt_mma::launch(tt_mma::pick<Mma>(plan[4], plan[5]), z, g, o, plan, stream);
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
