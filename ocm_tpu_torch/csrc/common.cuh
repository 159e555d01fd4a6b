// Helpers shared by the port's CUDA sources: warp, row-group, block and
// cluster sums, vector loads and stores, and the row-group launch plan of
// the reparameterization kernels.
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

// Sums v over each aligned group of g lanes (g a power of two <= 32) and
// returns the group's total to each of its lanes.  Every lane of the warp
// calls it: the xor partners of a lane stay inside its group.
__device__ __forceinline__ float group_sum(float v, int g) {
  for (int o = g >> 1; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// V consecutive floats (V = 1, 2, 4) of one row, as one load or store.
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

inline size_t addr_bits(const void* p) { return reinterpret_cast<size_t>(p); }

// The widest vector (4, 2 or 1 floats) that every row of n floats and
// every address or byte stride OR-ed into `align` allow.
inline int vec_width(int n, size_t align) {
  if (n % 4 == 0 && align % 16 == 0) return 4;
  if (n % 2 == 0 && align % 8 == 0) return 2;
  return 1;
}

// The row-group launch of K4, K6's backward and K5 (ops/kernels.py
// reparam_plan): a row of `units` lane steps gets `lanes` lanes, the
// smallest power of two >= units, at most 32, so a warp holds 32 / lanes
// rows and a block of kRowThreads threads kRowThreads / lanes rows.  The
// C entry points recompute it and refuse a caller's plan that differs.
constexpr int kRowThreads = 256;

struct RowPlan {
  int lanes, rows, blocks;
};

inline RowPlan row_plan(int n, int units) {
  int lanes = 1;
  while (lanes < units && lanes < 32) lanes <<= 1;
  const int rows = kRowThreads / lanes;
  return {lanes, rows, (n + rows - 1) / rows};
}

inline bool same_plan(const RowPlan& p, int lanes, int rows, int blocks) {
  return p.lanes == lanes && p.rows == rows && p.blocks == blocks;
}

inline int log2_of(int g) {
  int lg = 0;
  while ((1 << lg) < g) ++lg;
  return lg;
}

// Programmatic dependent launch: a kernel launched by launch_dependent
// may start while the kernel before it on the stream is still running;
// it must call wait_for_producer() before it reads anything that kernel
// wrote (griddepcontrol.wait returns once the preceding grid has completed
// and its writes are visible; where there is none, at once).
__device__ __forceinline__ void wait_for_producer() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// One launch of `kernel` over `blocks` blocks of `threads` threads on
// `stream` with programmatic stream serialization allowed; returns the
// launch's error, or cudaGetLastError() after it.
template <typename... Params, typename... Args>
int launch_dependent(void (*kernel)(Params...), int blocks, int threads,
                     cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
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
