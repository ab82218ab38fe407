// The tensor-core body behind PE2 and PE3 in bf16 (sm_90a):
//
//   O(a, d, c) = sum_b  Z(a, b, c) * G(b, d)
//
// with f32 sums on wgmma and bf16 out. PE2 (csrc/ttm_pe2.cu) is this as
// written; PE3 (csrc/ttm_pe3.cu) is it at a = 1 with Z = X (b, i) and G =
// Ybar (b, j). Each source wraps `gemm` in a __global__ kernel of its own
// name; the f32 calls and the bf16 calls the plan cannot tile stay on the
// CUDA-core body (tt_contract.cuh).
//
// As a product on the tensor cores, every output tile is D = A^T B with M
// = d, N = c and K = b: A is a tile of G (b rows, d contiguous) and B a
// tile of Z (b rows, c contiguous), both MN-major (wgmma's transposed bf16
// operands), read by wgmma from shared memory through 128-, 64- or 32-byte
// swizzled layouts that the TMA writes as it copies. The plan
// (kernels/tt_mma.py) picks one of three tilings by shape:
//   wide     d > 64, c not 16 or 32 (PE3's Ŵ): 128 (d) x 256 (c) tiles,
//            two consumer warpgroups of 64 x 256, b through the ring.
//   thin     d <= 64 (PE2 with d = 8 or 16, c = 256 or 512): 64 x 256
//            tiles of one slab, two warpgroups of 64 x 128; the rows of d
//            past d are the TMA's zero fill (4-8x the products, all under
//            the byte bound), so the output needs no transpose.
//   stacked  c = 16 or 32 (PE2 with d = 256): N runs over 64 / c whole
//            slabs side by side (one 3-D TMA box (c, 64 rows of b, slabs),
//            32- or 64-byte swizzle), M over all of d in up to four
//            warpgroups of 64 x 64. On granules (below), any even c <= 32:
//            64 / c slabs in a row of 128 bytes (c = 20: 3 slabs, 60 of
//            the 64 columns; c = 28: 2, 56), 128-byte swizzle.
// Where a CTA's tiles share one row of tiles of G (d <= its tile), the
// whole of G is loaded once for the CTA's life ("resident"), so only Z
// streams; 256 x 256 bf16 is 128 KB of shared memory.
//
// Schedule: a persistent grid (at most one CTA per SM) walks the tiles in
// order, N fastest. A producer (one warp; a warpgroup for 64 x 256, which
// hands its registers to the consumers, and for Z's granules) keeps loads
// of 64-row b-chunks in flight through a ring of stages under mbarriers (full:
// bytes landed; empty: every consumer warpgroup is done with the slot),
// across tile boundaries, so HBM never waits for an epilogue. Each consumer
// warpgroup issues its 4 wgmma k-steps a chunk and keeps one chunk's group
// in flight (wait_group 1) before it frees the previous slot. The epilogue
// converts the f32 sums to bf16 into a staging tile in shared memory laid
// out as the rows lie in O (a stacked tile's slab: 64 rows of c, one
// contiguous run of 2-4 KB; otherwise rows of WGN columns a padded pitch
// apart, so the fragment writes do not conflict), and bulk copies
// (cp.async.bulk) take it out while the next tile's products run; the
// 32- and 64-byte rows of c = 16 / 32 are written whole. No split-K and no
// atomics: each output is one warpgroup's sum in a fixed order, so two
// launches give the same bits.
//
// Requirements (checked by the plan, which routes the rest to the FMA
// body): bf16; rows of Z (c) and G (d) that are 16-byte multiples on
// 16-byte aligned operands go through the TMA (its stride unit); ragged
// edges in a, b, c and d are its zero fill on the way in and masks on the
// way out.
//
// Granules: rows of even c or d that the TMA cannot take (c = 20 / 28 and
// d = 10 / 20 in the audio and vision frontends' steps: 40-, 56-, 20- or
// 40-byte rows; or operands 4 or 8 bytes off 16) are staged by cp.async
// in 8-byte granules (4 where the row or the offset allows no more) into
// the same swizzled tiles the TMA would write, so the consumers and the
// wgmma descriptors are unchanged. Those calls are bound by bytes, as all
// here; what kept them off the tensor cores was only the copy.
//   Z (p.gz): the stacked tiling only (c <= 32, d c a multiple of 8, so a
//            slab's rows of O leave as one 16-byte-multiple run). Each
//            slab's row of Z (2 c bytes) lands at byte 2 c s of its b
//            row; the producer, a warpgroup, copies the rows granule by
//            granule (stage_slabs), zero-filling rows past b and slabs past
//            a (cp.async with src-size 0), and each thread arrives on the
//            slot's full barrier when its copies land
//            (cp.async.mbarrier.arrive.noinc; the consumers fence for the
//            async proxy after the wait: the copies write through the
//            generic one). What keeps these calls from their byte bound
//            on the card is the producer's instructions: in probes, one
//            producer warp doubled the time, a walk of the slabs' runs by
//            counters (one granule after another across rows) cost a third
//            more than a loop over (slab, row) pairs, and a walk that read
//            the plan's fields after every copy cost more again. G stays
//            on the TMA, resident or streamed.
//   G (p.gg): where G is resident (not under the 64 x 256 warpgroups,
//            whose producer gives its registers away): the CTA zeroes the
//            resident tiles, every producer thread copies its share of G's
//            rows once (stage_g; K and M padding stays zero) and arrives
//            when they land; the consumers fence before their first
//            product. Z stays on the TMA.
// Odd c or d, 2-byte offsets, Z on granules past c = 32 and G on granules
// where it is not resident stay on the FMA body.
//
// The helpers below `gemm`'s (mbarriers, TMA loads and tensor stores, bulk
// stores, descriptors, wgmma in both operand majors, the tensor-map
// encoders) also serve PE1's tensor-core body (csrc/ttm_pe1.cu
// `pe1_mma_kernel`).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace tt_mma {

constexpr int kMaxSmem = 232448;  // 227 KB, the most a CTA may ask for
constexpr int kBK = 64;           // b rows per chunk
constexpr int kABox = 64;         // G's box: 64 columns of d (128 bytes)
// CTA size bound per N of a warpgroup: up to four consumer warpgroups of 64
// x 64 (32 f32 sums a thread), two of 64 x 128 or 64 x 256 (up to 128), and
// the producer warp; the register file (64 K) splits over them.
// The producer is one warp, or (64 x 256) a whole warpgroup, which hands
// its registers to the consumers (setmaxnreg redistributes a CTA's own).
template <int WGN>
constexpr int kMaxWG = WGN <= 64 ? 4 : 2;
// The stacked tiling on granules (WGN 64 under the 128-byte swizzle) takes a
// producer warpgroup too: its 128 threads issue Z's cp.async granules.
template <int WGN, int SW>
constexpr int kProducer = WGN == 256 || (WGN == 64 && SW == 128) ? 128 : 32;
template <int WGN, int SW>
constexpr int kMaxThreads = kMaxWG<WGN> * 128 + kProducer<WGN, SW>;

// Field order is kernels/tt_mma.py PLAN_FIELDS.
struct Plan {
  int a, b, c, d;              // Z (a, b, c), G (b, d), O (a, d, c)
  int wgn, sw;                 // N per warpgroup, B's swizzle bytes (the template)
  int wm, wn;                  // consumer warpgroups along M and N
  int nk, stages, resident;    // b-chunks; ring slots; G loaded once (1) or streamed
  int slabs, bw;               // slabs side by side in a tile; B box columns
  int tiles_m, tiles_c, tiles_n, tiles;
  int grid, threads;
  int a_chunk, b_chunk, stage, a_res, out_pitch, smem;  // bytes
  int gz, gg;                  // Z's / G's cp.async granule bytes (4, 8), 0: TMA
};
constexpr int kPlanFields = 27;
static_assert(sizeof(Plan) == kPlanFields * sizeof(int), "Plan is 27 int32");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// ---- TMA loads, completing on `bar`
__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int x,
                                       int y, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y), "r"(z)
      : "memory");
}
__device__ __forceinline__ void tma_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int x,
                                       int y, int z, int w) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y), "r"(z), "r"(w)
      : "memory");
}

// ---- cp.async granules, for rows the TMA cannot take (not a multiple of
// 16 bytes, or off a 16-byte boundary). `bytes` below GR reads that many
// and zero-fills the rest (0: all zeros, `src` unread).
template <int GR>
__device__ __forceinline__ void cp_granule(void* dst, const void* src, int bytes) {
  static_assert(GR == 4 || GR == 8, "granules of 4 or 8 bytes");
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)), "l"(src),
               "n"(GR), "r"(bytes)
               : "memory");
}
// `bar` sees one arrival once every cp.async this thread issued has landed
// (noinc: the arrival is one of those the barrier was initialised with)
__device__ __forceinline__ void cp_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }
// cp.async writes through the generic proxy, wgmma reads through the async
// one: a consumer fences after the barrier says its granules landed
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// 16-byte zero stores over [p, p + bytes) by the CTA's threads, fenced for
// the async proxy (granule-staged tiles' padding, which no copy writes)
__device__ __forceinline__ void zero_smem(uint8_t* p, int bytes) {
  for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(p)[i] = make_uint4(0, 0, 0, 0);
  fence_async();
}
// The byte of a tile of SW-byte rows at which the SW-byte swizzle puts
// logical byte o (the TMA's and wgmma's pattern: 16-byte chunk bits 4.. of
// the offset XOR the row bits 7.., from a 1024-byte aligned tile).
template <int SW>
__device__ __forceinline__ int swz(int o) {
  return o ^ ((o >> 3) & (SW - 16));
}

// ---- wgmma
// Shared-memory matrix descriptor: start address, leading byte offset (for
// an MN-major swizzled operand: between the swizzle-wide column blocks),
// stride byte offset (between 8-row groups of K), swizzle (1: 128 B, 2: 64
// B, 3: 32 B). A K-major swizzled operand whose K fits one swizzle row
// (PE1's) has no LBO and an SBO of 8 rows; its k-steps start 32 bytes
// apart within the row.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo, uint32_t sbo, int sw) {
  const uint64_t layout = sw == 128 ? 1 : sw == 64 ? 2 : 3;
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}
__device__ __forceinline__ void mma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N, f32) += A B over one k-step of 16; scale_d = 0 starts a sum.
// TR is the instruction's two transpose immediates: 1, A and B MN-major
// (D = A^T B of PE2 / PE3's tiles), 0, both K-major (PE1's).
template <int TR>
__device__ __forceinline__ void mma64(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TR));
}
template <int TR>
__device__ __forceinline__ void mma128(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TR));
}
template <int TR>
__device__ __forceinline__ void mma256(float (&d)[128], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %131;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TR));
}
template <int N, int TR = 1>
__device__ __forceinline__ void mma(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d) {
  static_assert(N == 64 || N == 128 || N == 256, "wgmma N of this body: 64, 128 or 256");
  if constexpr (N == 64)
    mma64<TR>(d, a, b, scale_d);
  else if constexpr (N == 128)
    mma128<TR>(d, a, b, scale_d);
  else
    mma256<TR>(d, a, b, scale_d);
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// ---- bulk stores (shared -> global), completing in this thread's groups
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}
// a TMA tensor store of the box at (x, y, z) from a shared-memory tile laid
// out as the map's swizzle says; rows and columns past the tensor are dropped
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int x,
                                             int y, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(x), "r"(y), "r"(z)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// this thread's bulk stores have read shared memory (.read) or are done
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// ... or all but this thread's N most recent groups have read it
template <int N>
__device__ __forceinline__ void bulk_wait_read_upto() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Z's slabs a0 .. a0 + slabs - 1 at b rows k0 .. k0 + 63 into a stacked B
// tile on granules: 64 rows of 128 bytes (one per b row), slab s's c
// columns at byte 2 c s of each, under the 128-byte swizzle. Thread t of N
// takes the (slab, row) pairs t, t + N, ... and copies each pair's 2 c
// bytes of Z granule by granule: a handful of instructions a granule,
// which is what bounds these calls (the plan's fields are read once a call:
// an asm "memory" clobber after every copy would make the compiler reload
// them). Rows past b and slabs past a are zero fill; the tile's columns
// past slabs * c are never written (their sums are never stored).
template <int GR, int N>
__device__ __forceinline__ void stage_slabs(uint8_t* tile, const uint8_t* z, int a0, int k0,
                                            const Plan& p, int t) {
  const int row = p.c * 2, pairs = p.slabs * kBK, in_s = p.a - a0, in_k = p.b - k0;
  const size_t slab = (size_t)p.b * row;
  const uint8_t* base = z + ((size_t)a0 * p.b + k0) * row;
#pragma unroll 1
  for (int i = t; i < pairs; i += N) {
    const int s = i / kBK, k = i % kBK, swk = (k & 7) << 4;
    const bool in = s < in_s && k < in_k;
    const uint8_t* src = base + s * slab + k * row;
    uint8_t* dst = tile + k * 128;
#pragma unroll 1
    for (int q = 0, x = s * row; q < row; q += GR, x += GR)
      cp_granule<GR>(dst + (x ^ swk), in ? src + q : z, in ? GR : 0);
  }
}

// G (b, d) whole into the resident A tiles on granules: row k of G is row
// k % 64 of chunk k / 64, its d columns in boxes of 64 (128 bytes, the
// 128-byte swizzle) kABox * kBK * 2 bytes apart, as the TMA would lay them;
// thread t of n takes granules t, t + n, ... The rows past b and columns
// past d were zeroed before.
template <int GR>
__device__ __forceinline__ void stage_g(uint8_t* a_res, const uint8_t* g, const Plan& p, int t,
                                        int n) {
  const int row = p.d * 2, gpr = row / GR, total = p.b * gpr;
#pragma unroll 1
  for (int e = t; e < total; e += n) {
    const int k = e / gpr, x = (e - k * gpr) * GR, r = k & (kBK - 1);
    cp_granule<GR>(a_res + (k / kBK) * p.a_chunk + (x >> 7) * (kABox * kBK * 2) + r * 128 +
                       ((x & 127) ^ ((r & 7) << 4)),
                   g + (size_t)k * row + x, GR);
  }
}

// The body. WGN: N per consumer warpgroup (64, 128 or 256); SW: B's swizzle
// bytes (32, 64 or 128). WGN 64 is the stacked tiling: c = SW / 2 slabs off
// the TMA below 128, any even c <= 32 on granules (p.gz) at 128.
// Warps 0 .. 4 * wm * wn - 1 are the consumer warpgroups (warpgroup g takes
// rows 64 * (g / wn) and columns WGN * (g % wn) of a tile), the rest the
// producer. z and g are the operands' own pointers, read where p.gz / p.gg
// stage them by granules (the maps are then unused). A grouped call (the
// experts of an MoE layer) runs group blockIdx.y's tiles in this CTA: its
// operands follow the previous group's, the maps carry the group as their
// outermost coordinate (a box never reads the next group's rows: the
// zero fill pads each group's tail), and a resident G is its group's.
template <int WGN, int SW>
__device__ __forceinline__ void gemm(const CUtensorMap* ta, const CUtensorMap* tb,
                                     const uint8_t* __restrict__ z, const uint8_t* __restrict__ g,
                                     __nv_bfloat16* __restrict__ O, const Plan& p) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const int grp = blockIdx.y;
  z += (size_t)grp * p.a * p.b * p.c * 2;
  g += (size_t)grp * p.b * p.d * 2;
  O += (size_t)grp * p.a * p.d * p.c;
  uint8_t* sm = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                           ~uintptr_t(1023));
  constexpr int kProd = kProducer<WGN, SW>;
  // Z on granules: the stacked tiling's 128-byte-swizzle instance, and only
  // it (launch checks p.gz against it); G on granules: any instance but 64
  // x 256 (launch refuses p.gg there)
  constexpr bool kZGran = WGN == 64 && SW == 128, kGGran = WGN != 256;
  const int nwg = p.wm * p.wn;
  uint8_t* a_res = sm;
  uint8_t* ring = sm + p.a_res;
  uint8_t* outs = ring + p.stages * p.stage;
  uint64_t* full = reinterpret_cast<uint64_t*>(outs + nwg * 64 * p.out_pitch);
  uint64_t* empty = full + p.stages;
  uint64_t* abar = empty + p.stages;
  const int wg = threadIdx.x >> 7;
  // a ring slot's TMA bytes (G streamed, Z off the TMA); it is full once
  // they have landed and, on granules, every producer warp's copies have
  const int stage_tx = (p.resident ? 0 : p.a_chunk) + (kZGran ? 0 : p.b_chunk);

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + s, (stage_tx ? 1 : 0) + (kZGran ? kProd : 0));
      mbar_init(empty + s, nwg);
    }
    mbar_init(abar, kGGran && p.gg ? kProd : 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (kGGran && p.gg) zero_smem(a_res, p.a_res);  // G's K and M padding
  __syncthreads();

  const int bm = 64 * p.wm, bn = WGN * p.wn;
  const int a_box = kABox * kBK * 2;             // bytes of one box of G
  const int b_box = p.bw * kBK * p.slabs * 2;    // and of Z
  const int nbox = kZGran ? 0 : bn / (p.bw * p.slabs);

  // 64 x 256 warpgroups hold 128 sums a thread: at 384 threads the
  // compiler's budget is 168 registers, so the producer warpgroup gives
  // its registers back and the consumers take 232 (setmaxnreg; the two
  // roles never meet again below)
  if (wg == nwg) {  // ---- producer: one lane issues every TMA copy, every
                    // thread its share of the granules
    if constexpr (WGN == 256) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int pt = threadIdx.x - nwg * 128;
    // G's granules where the producer keeps its registers (not under 64 x
    // 256, whose producer holds 40 a thread); Z's in kZGran's instance only
    const bool gg = kGGran && p.gg;
    if (!kZGran && !gg && pt != 0) return;
    if (p.resident) {
      if (gg) {
        if constexpr (kGGran) {
          if (p.gg == 8)
            stage_g<8>(a_res, g, p, pt, kProd);
          else
            stage_g<4>(a_res, g, p, pt, kProd);
          cp_arrive(abar);
        }
      } else if (pt == 0) {
        mbar_expect_tx(abar, p.a_res);
        for (int kc = 0; kc < p.nk; ++kc)
          for (int mb = 0; mb < p.wm; ++mb)
            tma_3d(a_res + kc * p.a_chunk + mb * a_box, ta, abar, kABox * mb, kc * kBK, grp);
      }
    }
    if (!kZGran && pt != 0) {  // G's granules only: the rest is lane 0's TMA
      cp_wait_all();
      return;
    }
    int st = 0, ph = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      const int tm = t / p.tiles_n, tn = t - tm * p.tiles_n;
      const int ct = tn % p.tiles_c;
      const int d0 = tm * bm, a0 = (tn / p.tiles_c) * p.slabs, c0 = ct * bn;
      for (int kc = 0; kc < p.nk; ++kc) {
        mbar_wait(empty + st, ph ^ 1);
        uint8_t* slot = ring + st * p.stage;
        if (pt == 0 && stage_tx) {
          mbar_expect_tx(full + st, stage_tx);
          if (!p.resident)
            for (int mb = 0; mb < p.wm; ++mb)
              tma_3d(slot + mb * a_box, ta, full + st, d0 + kABox * mb, kc * kBK, grp);
        }
        if (!p.resident) slot += p.a_chunk;
        if constexpr (kZGran) {
          if (p.gz == 8)
            stage_slabs<8, kProd>(slot, z, a0, kc * kBK, p, pt);
          else
            stage_slabs<4, kProd>(slot, z, a0, kc * kBK, p, pt);
          cp_arrive(full + st);
        } else {
          for (int i = 0; i < nbox; ++i)
            tma_4d(slot + i * b_box, tb, full + st, c0 + i * p.bw, kc * kBK, a0, grp);
        }
        if (++st == p.stages) {
          st = 0;
          ph ^= 1;
        }
      }
    }
    if constexpr (kZGran) cp_wait_all();
    return;
  }

  // ---- consumer warpgroup wg
  if constexpr (WGN == 256) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wmi = wg / p.wn, wni = wg - (wg / p.wn) * p.wn;
  const int lane = threadIdx.x & 127;
  const uint32_t a_lbo = kBK * 128, b_lbo = kBK * SW;
  // this warpgroup's column block of B, and its row block of A
  const int b_off = kZGran ? 0 : (wni * WGN / p.bw) * (p.bw * kBK * 2);
  const int a_off = wmi * a_box;
  uint8_t* stg = outs + wg * 64 * p.out_pitch;
  constexpr bool kStacked = WGN == 64;
  // c of a stacked tiling: SW / 2 off the TMA, any even c on granules
  const int slab_c = kZGran ? p.c : SW / 2;
  float acc[WGN / 2];
#pragma unroll
  for (int i = 0; i < WGN / 2; ++i) acc[i] = 0.f;
  if (p.resident) {
    mbar_wait(abar, 0);
    if (kGGran && p.gg) fence_async();
  }
  int st = 0, ph = 0;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const int tm = t / p.tiles_n, tn = t - tm * p.tiles_n;
    const int ct = tn % p.tiles_c;
    const int d0 = tm * bm + 64 * wmi, a0 = (tn / p.tiles_c) * p.slabs, c0 = ct * bn;
    int prev = 0;
    for (int kc = 0; kc < p.nk; ++kc) {
      mbar_wait(full + st, ph);
      if constexpr (kZGran) fence_async();
      uint8_t* slot = ring + st * p.stage;
      const uint8_t* as = (p.resident ? a_res + kc * p.a_chunk : slot) + a_off;
      const uint8_t* bs = slot + (p.resident ? 0 : p.a_chunk) + b_off;
      fence_acc(acc);
      mma_fence();
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks)
        mma<WGN>(acc, desc(as + ks * 16 * 128, a_lbo, 8 * 128, 128),
                 desc(bs + ks * 16 * SW, b_lbo, 8 * SW, SW), (kc | ks) != 0);
      mma_commit();
      fence_acc(acc);
      mma_wait<1>();  // the previous chunk's products are done: free its slot
      fence_acc(acc);
      if (kc > 0 && lane == 0) mbar_arrive(empty + prev);
      prev = st;
      if (++st == p.stages) {
        st = 0;
        ph ^= 1;
      }
    }
    mma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(empty + prev);

    // epilogue: f32 -> bf16 into this warpgroup's staging tile, laid out
    // as its rows lie in O (stacked: a slab's 64 rows of c dense; else a
    // row of WGN columns a pitch apart, 4 banks on), then out by bulk
    // copies that run while the next tile's products do; warp 0 issues
    // them and, before the staging tile is written again, waits until they
    // have read it
    if (lane < 32) bulk_wait_read();
    bar_sync(1 + wg);
    {
      const int r0 = (lane >> 5) * 16 + ((lane & 31) >> 2), cb = 2 * (lane & 3);
      // on granules: columns 8 j + cb, + 1 are column col of slab s (c even:
      // never split), walked by counters as j steps 8 columns on
      int s = 0, col = cb;
      if constexpr (kZGran) {
        while (col >= slab_c) {
          col -= slab_c;
          ++s;
        }
      }
#pragma unroll
      for (int j = 0; j < WGN / 8; ++j) {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
        uint8_t* at;
        int pitch;
        if constexpr (kStacked && !kZGran) {
          at = stg + (8 * j / slab_c) * (64 * slab_c * 2) + ((8 * j) % slab_c + cb) * 2;
          pitch = slab_c * 2;
        } else if constexpr (kZGran) {
          if (j > 0) {
            col += 8;
            while (col >= slab_c) {
              col -= slab_c;
              ++s;
            }
          }
          if (s >= p.slabs) continue;
          at = stg + s * (64 * slab_c * 2) + col * 2;
          pitch = slab_c * 2;
        } else {
          at = stg + (8 * j + cb) * 2;
          pitch = p.out_pitch;
        }
        *reinterpret_cast<__nv_bfloat162*>(at + r0 * pitch) = lo;
        *reinterpret_cast<__nv_bfloat162*>(at + (r0 + 8) * pitch) = hi;
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_sync(1 + wg);
    if (lane < 32) {
      const int rows = min(64, p.d - d0);
      if constexpr (kStacked) {  // lane s: the slabs' runs (wn is 1: launch checks)
        if (lane < p.slabs && a0 + lane < p.a && rows > 0)
          bulk_store(O + ((size_t)(a0 + lane) * p.d + d0) * p.c,
                     stg + lane * (64 * slab_c * 2), rows * slab_c * 2);
      } else {  // lanes over rows: each row's WGN columns (fewer at c's edge)
        const int col = c0 + wni * WGN;
        const int n = min(WGN, p.c - col);
        for (int m = lane; m < rows && n > 0; m += 32)
          bulk_store(O + ((size_t)a0 * p.d + d0 + m) * p.c + col, stg + m * p.out_pitch, n * 2);
      }
      bulk_commit();
    }
  }
  if (lane < 32) bulk_wait();
}

// ---- host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (the
// libraries link nothing but cudart).
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return nullptr;
#endif
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

inline CUtensorMapSwizzle swizzle(int bytes) {
  return bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
         : bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                       : CU_TENSOR_MAP_SWIZZLE_32B;
}

// A 3-D bf16 map of `groups` matrices one after another: `inner` x `outer`
// elements each, rows `stride` bytes apart, boxes of box_inner x box_outer
// x 1 under the `sw`-byte swizzle (the box of a 2-D map); reads past a
// matrix's edges give zeros, never the next matrix's rows.
inline bool map_3d(CUtensorMap* m, const void* ptr, uint64_t inner, uint64_t outer,
                   uint64_t groups, uint64_t stride, uint32_t box_inner, uint32_t box_outer,
                   int sw) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dim[3] = {(cuuint64_t)inner, (cuuint64_t)outer, (cuuint64_t)groups};
  const cuuint64_t str[2] = {(cuuint64_t)stride, (cuuint64_t)(stride * outer)};
  const cuuint32_t box[3] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer, 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dim, str, box, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle(sw), CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// G (groups, b, d) as A: boxes of 64 columns of d by kBK rows of one
// group, 128-byte swizzle; Z (groups, a, b, c) as B: boxes of bw columns by
// kBK rows by `slabs` slabs of one group. An operand staged by granules has
// no map (left zero).
inline bool encode(const Plan& p, const void* z, const void* g, int groups, CUtensorMap* ta,
                   CUtensorMap* tb) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  memset(ta, 0, sizeof(CUtensorMap));
  memset(tb, 0, sizeof(CUtensorMap));
  const cuuint64_t zdim[4] = {(cuuint64_t)p.c, (cuuint64_t)p.b, (cuuint64_t)p.a,
                              (cuuint64_t)groups};
  const cuuint64_t zstr[3] = {(cuuint64_t)p.c * 2, (cuuint64_t)p.b * p.c * 2,
                              (cuuint64_t)p.a * p.b * p.c * 2};
  const cuuint32_t zbox[4] = {(cuuint32_t)p.bw, (cuuint32_t)kBK, (cuuint32_t)p.slabs, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return (p.gg || map_3d(ta, g, p.d, p.b, groups, (uint64_t)p.d * 2, kABox, kBK, 128)) &&
         (p.gz ||
          enc(tb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(z), zdim, zstr, zbox,
              ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle(p.sw),
              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
              CUDA_SUCCESS);
}

// The instance of `Kernel` for the plan's (wgn, sw), or null.
template <template <int, int> class Kernel>
const void* pick(int wgn, int sw) {
  if (wgn == 64 && sw == 32) return Kernel<64, 32>::fn();
  if (wgn == 64 && sw == 64) return Kernel<64, 64>::fn();
  if (wgn == 64 && sw == 128) return Kernel<64, 128>::fn();
  if (wgn == 128 && sw == 128) return Kernel<128, 128>::fn();
  if (wgn == 256 && sw == 128) return Kernel<256, 128>::fn();
  return nullptr;
}

// Check the plan, encode the tensor maps and launch `fn` (a kernel taking
// (CUtensorMap, CUtensorMap, const bf16* z, const bf16* g, bf16*, Plan)) on
// `stream`, `groups` groups of the plan's shapes one after another in each
// operand (blockIdx.y the group); returns cudaGetLastError() after the
// launch.
inline int launch(const void* fn, const void* z, const void* g, void* o, const int* fields,
                  int groups, void* stream) {
  Plan p;
  memcpy(&p, fields, sizeof(Plan));
  if (fn == nullptr || groups < 1 || groups > 65535) return (int)cudaErrorInvalidValue;
  if (p.tiles == 0) return (int)cudaSuccess;
  const int nwg = p.wm * p.wn;
  const bool stacked_gz = p.wgn == 64 && p.sw == 128;  // the stacked tiling on granules
  const int producer = p.wgn == 256 || stacked_gz ? 128 : 32;
  // Z by granules: the stacked tiling only, whole even-c slabs in N = 64,
  // slab runs of O 16-byte multiples; off granules, 16-byte rows (TMA).
  // G by granules: resident, not under the 64 x 256 warpgroups (whose
  // producer gives its registers away).
  const bool zrows = p.gz ? (p.gz == 4 || p.gz == 8) && stacked_gz && p.c % 2 == 0 &&
                                (p.c * 2) % p.gz == 0 && p.slabs == 64 / p.c && p.bw == p.c &&
                                (p.c * p.d) % 8 == 0
                          : p.c % 8 == 0 && !stacked_gz && (p.wgn * p.wn) % (p.bw * p.slabs) == 0;
  const bool grows = p.gg ? (p.gg == 4 || p.gg == 8) && (p.d * 2) % p.gg == 0 && p.resident &&
                                p.wgn != 256
                          : p.d % 8 == 0;
  const uintptr_t za = reinterpret_cast<uintptr_t>(z), ga = reinterpret_cast<uintptr_t>(g);
  const bool ok =
      p.threads == nwg * 128 + producer && nwg >= 1 && nwg <= (p.wgn <= 64 ? 4 : 2) &&
      (p.sw == 128 || p.c * 2 == p.sw) && p.stages >= 2 && p.nk >= 1 && p.smem <= kMaxSmem &&
      zrows && grows && p.grid >= 1 && p.tiles == p.tiles_m * p.tiles_n &&
      p.a_chunk == 64 * p.wm * kBK * 2 && p.b_chunk == p.wgn * p.wn * kBK * 2 &&
      p.stage == p.b_chunk + (p.resident ? 0 : p.a_chunk) &&
      p.a_res == (p.resident ? p.nk * p.a_chunk : 0) &&
      (p.slabs == 1 || p.wn == 1) &&  // the stacked store's slab index carries no wn offset
      p.smem >= 1024 + p.a_res + p.stages * p.stage + nwg * 64 * p.out_pitch + 16 * p.stages + 8 &&
      za % (p.gz ? p.gz : 16) == 0 && ga % (p.gg ? p.gg : 16) == 0 &&
      (groups == 1 || ((size_t)p.a * p.b * p.c * 2 % (p.gz ? p.gz : 16) == 0 &&
                       (size_t)p.b * p.d * 2 % (p.gg ? p.gg : 16) == 0)) &&
      reinterpret_cast<uintptr_t>(o) % 16 == 0;
  if (!ok) return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  if (!encode(p, z, g, groups, &ta, &tb)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&ta, &tb, &z, &g, &o, &p};
  e = cudaLaunchKernel(fn, dim3((unsigned)p.grid, (unsigned)groups), dim3((unsigned)p.threads),
                       args, (size_t)p.smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace tt_mma
