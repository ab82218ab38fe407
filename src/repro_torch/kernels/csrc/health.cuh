// Quant-health counters inside the encoding kernels (kv_append.cu,
// state_codec.cu, pow2_fq.cu): each CTA sums its threads' counts in
// registers and shared memory and adds them to a device buffer of 64-bit
// counters with one atomicAdd per counter. Integer atomics commute, so the
// totals do not depend on the order the CTAs run in. The counts are the
// reference's repro/obs/counters.py aggregates (pow2_clip_stats,
// saturation_counts, scale_drift_stats), integer for integer.
//
// Cost: a compare or two an element in registers, one warp reduction and
// one __syncthreads a CTA, and one or two atomics a CTA. Each kernel takes
// the counters as a template flag, so with the counter buffer null the
// launch runs the instantiation without them: the same code and codes as
// before the counters existed.

#pragma once

#include <cuda_runtime.h>

namespace health {

// Add the CTA's per-thread counts a and b to dst[0] and dst[1]. Every
// thread of the CTA calls it (it synchronizes the CTA); blockDim.x is a
// multiple of 32 and at most 1024. `part` is 64 words of shared memory.
__device__ __forceinline__ void cta_add2(unsigned long long* dst, unsigned a, unsigned b,
                                         unsigned* part) {
  a = __reduce_add_sync(0xffffffffu, a);
  b = __reduce_add_sync(0xffffffffu, b);
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    part[w] = a;
    part[32 + w] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long sa = 0, sb = 0;
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) {
      sa += part[i];
      sb += part[32 + i];
    }
    if (sa) atomicAdd(dst, sa);
    if (sb) atomicAdd(dst + 1, sb);
  }
}

}  // namespace health
