// Helpers shared by the port's CUDA sources: warp and block sums.
//
// Each source is its own translation unit, so everything here is inline
// and in an anonymous namespace.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sums (a, b) over the whole block and returns the totals to every thread.
// `scratch` holds 32 float2 in shared memory; blockDim.x is a multiple of
// 32.  Ends with a barrier, so the caller may reuse `scratch` afterwards
// only after another barrier.
__device__ __forceinline__ float2 block_sum2(float a, float b,
                                             float2* scratch) {
  a = warp_sum(a);
  b = warp_sum(b);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) scratch[warp] = make_float2(a, b);
  __syncthreads();
  if (warp == 0) {
    const float2 v = lane < (int)(blockDim.x >> 5) ? scratch[lane]
                                                   : make_float2(0.f, 0.f);
    const float sa = warp_sum(v.x), sb = warp_sum(v.y);
    if (lane == 0) scratch[0] = make_float2(sa, sb);
  }
  __syncthreads();
  return scratch[0];
}

}  // namespace
