// PE2 (paper Eq. 6): Z'(a, d, c) = sum_b Z(a, b, c) G(b, d).
//
// Replaces: repro/kernels/ttm_pe2.py:25 `_pe2_kernel` / `pe2_batched`
// (pallas_call at :47). On the training path it runs inside every TT
// matvec chain (forward, the remat recompute or the scale manager's
// forward probe, and the transposed dx chain): 12 launches an FMNIST MLP
// step (f32, (1792, 32, 16) x (32, 32) down to (64, 512, 16) x (512, 1)),
// 864 a step of with_tt(internlm2-1.8b) (bf16, six shapes), 288 a step of
// with_tt(LM100M, d=3, max_rank=48) (f32, nine shapes; 292 and thirteen
// with TT embedding and head).
//
// Three bodies, chosen from dtype, shape and alignment alone, in this
// order: kernels/tt_mma.py::plan, kernels/tt_tile.py::plan, the rest:
//
// bf16 with even rows (every LM call, and every frontend call since the
// granules: hubert-xlarge's (16384, 160, 20) x (160, 256) and (2048, 128,
// 256) x (128, 10), llava-next-34b's c = 28 at d = 256 and (512, 256,
// 1024) x (256, 20)): `pe2_mma_kernel`, wgmma on the tensor cores
// (tt_mma.cuh; rows the TMA cannot take staged by cp.async granules, its
// "Granules"). Bound on the H100 at the LM's and the frontends' shapes: bytes.
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
// f32 with at least 2^28 flops (LM100M's calls): `pe2_tile_kernel`, the
// contraction as one GEMM of M = (slab, column) pairs, N = d, K = b on the
// CUDA cores in full FP32 (tt_tile.cuh). Bound on the H100: FP32
// operations at 67 TFLOP/s for the large calls, (16384, 384, 12) x (384,
// 384) 0.87 ms, (16384, 384, 16) x (384, 576 / 768) 1.73 / 2.31 ms, (16384,
// 576, 12) x (576, 384) 1.30 ms, (24576, 768, 12) x (768, 384) 2.60 ms,
// (16384, 384, 32) x (384, 1536) 9.23 ms, (65536, 1536, 12) x (1536, 384)
// 13.85 ms; bytes at 3.35 TB/s for the thin calls (d = 8-32), where Z has
// to stream once at the HBM rate: (2048, 384 / 576 / 1536, 96) x (., 8)
// 0.09 / 0.14 / 0.36 ms, (2048, 384, 192) x (384, 8) 0.18 ms, (2048, 384,
// 256) x (384, 12) 0.25 ms, (2048, 384, 1024) x (384, 32) 1.04 ms. What
// the design does about it: the large calls run 256 x 128 tiles (21, 16 or
// 8 whole slabs by 128 of d) with 16 x 8 register tiles, one CTA of 256
// threads an SM, 32-row K-chunks through a 4-slot cp.async ring, so each
// value a thread reads from shared memory feeds 8 or 16 FMAs and the
// inner loop is nothing but FFMA and LDS.128; the thin calls take the
// whole of d in a CTA, one slab's 96 or 128 columns, and split each chunk
// of K between 4 or 8 groups of threads, so Z streams through many small
// CTAs (four or five an SM) and each value of it is read from shared
// memory once. The previous design, `pe2_kernel`, staged G once per slab
// (6 FLOP per staged byte at c = 12); the tiles stage Z and G once per
// 256 x 128 tile.
//
// f32 under that size (the MLP) and the bf16 calls the tensor-core plan
// cannot tile (odd rows, 2-byte offsets): `pe2_kernel`,
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
#include "tt_tile.cuh"

namespace {

template <typename T, int RD>
__global__ void __launch_bounds__(tt_contract::kMaxThreads)
pe2_kernel(const T* __restrict__ z, const T* __restrict__ g, T* __restrict__ o,
           tt_contract::Plan p) {
  tt_contract::contract<T, RD>(z, g, o, p);
}

template <int WGN, int SW>
__global__ void __launch_bounds__(tt_mma::kMaxThreads<WGN, SW>, 1)
pe2_mma_kernel(const __grid_constant__ CUtensorMap tg, const __grid_constant__ CUtensorMap tz,
               const __nv_bfloat16* __restrict__ z, const __nv_bfloat16* __restrict__ g,
               __nv_bfloat16* __restrict__ o, const tt_mma::Plan p) {
  tt_mma::gemm<WGN, SW>(&tg, &tz, reinterpret_cast<const uint8_t*>(z),
                        reinterpret_cast<const uint8_t*>(g), o, p);
}

template <int WGN, int SW>
struct Mma {
  static const void* fn() { return (const void*)pe2_mma_kernel<WGN, SW>; }
};

template <int TM, int TN, int KR>
__global__ void __launch_bounds__(tt_tile::max_threads(TM, TN), tt_tile::min_blocks(TM, TN))
pe2_tile_kernel(const float* __restrict__ z, const float* __restrict__ g, float* __restrict__ o,
                const tt_tile::Plan p) {
  tt_tile::gemm<TM, TN, KR>(z, g, o, p);
}

template <int TM, int TN, int KR>
struct Tile {
  static const void* fn() { return (const void*)pe2_tile_kernel<TM, TN, KR>; }
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

// z (groups, a, b, c), g (groups, b, d), o (groups, a, d, c): contiguous
// device arrays of dtype (0 f32, 1 bf16); `plan` is 23 int32
// (kernels/tt_contract.py PLAN_FIELDS), one group's. Returns
// cudaGetLastError() after the launch.
int pe2(const void* z, const void* g, void* o, int dtype, const int* plan, int groups,
        void* stream) {
  const int rd = plan[4];
  const void* fn = dtype == tt_contract::F32    ? pick<float>(rd)
                   : dtype == tt_contract::BF16 ? pick<__nv_bfloat16>(rd)
                                                : nullptr;
  return tt_contract::launch(fn, z, g, o, plan, groups, stream);
}

// The tensor-core route: z (groups, a, b, c), g (groups, b, d), o (groups,
// a, d, c), contiguous bf16, o 16-byte aligned, z and g 16-byte aligned or
// on their granules; `plan` is 27 int32 (kernels/tt_mma.py PLAN_FIELDS),
// one group's. Returns cudaGetLastError() after the launch.
int pe2_mma(const void* z, const void* g, void* o, const int* plan, int groups, void* stream) {
  return tt_mma::launch(tt_mma::pick<Mma>(plan[4], plan[5]), z, g, o, plan, groups, stream);
}

// The f32 tile route: z (a, b, c), g (b, d), o (a, d, c), contiguous f32;
// `plan` is 34 int32 (kernels/tt_tile.py PLAN_FIELDS). Returns the
// launch's error, then cudaGetLastError().
int pe2_tile(const void* z, const void* g, void* o, const int* plan, void* stream) {
  return tt_tile::launch(tt_tile::pick<Tile>(plan[4], plan[5], plan[6]), z, g, o, plan, stream);
}

// Diagnostic: the clusters of `plan`'s kernel, CTA size, shared memory and
// cluster size that the card runs at once (kernels/tt_tile.py clusters).
int pe2_tile_clusters(const int* plan) {
  return tt_tile::clusters(tt_tile::pick<Tile>(plan[4], plan[5], plan[6]), plan);
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
