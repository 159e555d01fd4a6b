// Helpers shared by the port's CUDA sources: warp, block and cluster sums.
//
// Each source is its own translation unit, so everything here is inline
// and in an anonymous namespace.

#pragma once

#include <cooperative_groups.h>
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

// Sums (a, b) over every block of the thread block cluster and returns the
// totals to every thread of each block.  Each block publishes its own sum
// in scratch[0] (block_sum2), cluster.sync() makes them visible, and every
// thread adds its peers' through distributed shared memory in rank order,
// so all blocks hold the same totals bit for bit.  It then arrives on the
// cluster barrier; the caller must call cluster_sum2_wait() before the
// block exits, so that no block's shared memory goes while its peers may
// still read it (the wait is left to the end, off the critical path).
// Every thread of every block of the cluster calls both.
__device__ __forceinline__ float2 cluster_sum2(float a, float b,
                                               float2* scratch) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  block_sum2(a, b, scratch);
  cluster.sync();
  float2 tot = make_float2(0.f, 0.f);
  for (unsigned r = 0; r < cluster.num_blocks(); ++r) {
    const float2 v = *cluster.map_shared_rank(scratch, r);
    tot.x += v.x;
    tot.y += v.y;
  }
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  return tot;
}

__device__ __forceinline__ void cluster_sum2_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

}  // namespace
