// Fused reparameterization and per-sample KL of the VAE's latent code
// (K4), and its analytic backward (K6's VJP).
//
// Replaces the TPU kernel reparam_loss_pallas with explicit noise
// (ocm_tpu/ops/kernels.py:110, call :153) and the VJP of fused_reparam_kl
// (kernels.py:192, VJP :207-221), which JAX leaves to one fused XLA pass;
// here the differentiable form is ocm_tpu_torch.ops.kernels
// .fused_reparam_kl, a torch.autograd.Function whose forward is
// reparam_kl_kernel and whose backward is reparam_kl_bwd_kernel.
//
//   z_ij   = mu_ij + eps_ij * exp(lv_ij / 2)
//   kl_i   = -1/2 * sum_j (1 + lv_ij - mu_ij^2 - exp(lv_ij))
//   dmu_ij = dz_ij + dkl_i * mu_ij
//   dlv_ij = dz_ij * eps_ij * exp(lv_ij / 2) / 2 - dkl_i (1 - exp(lv_ij)) / 2
//
// Inputs mu, logvar, eps (N, k) f32, contiguous; outputs z (N, k), kl
// (N,).  The backward takes dz (N, k) with any non-negative strides and
// dkl (N,) with any stride (0 where it is the expand of kl.mean()'s
// gradient), and writes dmu, dlv (N, k) contiguous.  The TPU kernel
// padded k to 128 lanes (zero columns add exactly 0 to the KL); nothing
// is padded here.
//
// What bounds them on an H100: at the VAE's shapes (N 64, k 16) the
// forward moves 16 N k + 4 N bytes = 16.6 KB and the backward 24 N k + 4
// bytes, nanoseconds of bandwidth: the launch sets their time.  Design:
// each row a group of g lanes (ops/kernels.py reparam_plan, common.cuh
// row_plan), g the smallest power of two >= the row's vectors, a lane
// moving 16 bytes of each tensor where k % 4 == 0 and every base is
// 16-byte aligned (8 or 4 bytes otherwise), the KL row sum reduced by
// shuffles within the group.  At (64, 16) that is 4 lanes a row and the
// whole train batch in one block of 256 threads; the backward is one
// launch in place of a dozen eager elementwise ones.  Both are launched as
// programmatic dependents (common.cuh launch_dependent): each may start
// while the product that writes its input (fc_logvar's Linear; for dz the
// decoder's first product) is still running, and waits for its writes
// before its first read, which takes ~1 us off each pair on an H100
// (PERF.md §6).

#include <cuda_runtime.h>
#include <stddef.h>

#include "common.cuh"

namespace {

template <int V>
__global__ void __launch_bounds__(kRowThreads)
    reparam_kl_kernel(const float* __restrict__ mu,
                      const float* __restrict__ logvar,
                      const float* __restrict__ eps, float* __restrict__ z,
                      float* __restrict__ kl, int n, int k, int lg) {
  wait_for_producer();
  const int g = 1 << lg;
  const int row = blockIdx.x * (kRowThreads >> lg) + (int)(threadIdx.x >> lg);
  const int lane = threadIdx.x & (g - 1);
  float acc = 0.f;
  if (row < n) {
    const size_t base = (size_t)row * k;
    for (int j = lane * V; j < k; j += g * V) {
      float m[V], lv[V], e[V], out[V];
      load_vec<V>(mu + base + j, m);
      load_vec<V>(logvar + base + j, lv);
      load_vec<V>(eps + base + j, e);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        out[i] = m[i] + e[i] * expf(0.5f * lv[i]);
        acc += 1.f + lv[i] - m[i] * m[i] - expf(lv[i]);
      }
      store_vec<V>(z + base + j, out);
    }
  }
  acc = group_sum(acc, g);   // every lane of the warp, rows past n too
  if (row < n && lane == 0) kl[row] = -0.5f * acc;
}

// dz is read with row stride dz_rs and column stride dz_cs (1 where V >
// 1), dkl with stride dkl_s.
template <int V>
__global__ void __launch_bounds__(kRowThreads)
    reparam_kl_bwd_kernel(const float* __restrict__ mu,
                          const float* __restrict__ logvar,
                          const float* __restrict__ eps,
                          const float* __restrict__ dz,
                          const float* __restrict__ dkl,
                          float* __restrict__ dmu, float* __restrict__ dlv,
                          int n, int k, long long dz_rs, long long dz_cs,
                          long long dkl_s, int lg) {
  wait_for_producer();
  const int g = 1 << lg;
  const int row = blockIdx.x * (kRowThreads >> lg) + (int)(threadIdx.x >> lg);
  const int lane = threadIdx.x & (g - 1);
  if (row >= n) return;
  const float d = dkl[row * dkl_s];
  const size_t base = (size_t)row * k;
  const float* dzr = dz + row * dz_rs;
  for (int j = lane * V; j < k; j += g * V) {
    float m[V], lv[V], e[V], dzv[V], gm[V], gl[V];
    load_vec<V>(mu + base + j, m);
    load_vec<V>(logvar + base + j, lv);
    load_vec<V>(eps + base + j, e);
    if constexpr (V > 1)
      load_vec<V>(dzr + j, dzv);
    else
      dzv[0] = dzr[j * dz_cs];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      gm[i] = dzv[i] + d * m[i];
      gl[i] = dzv[i] * 0.5f * e[i] * expf(0.5f * lv[i]) -
              d * 0.5f * (1.f - expf(lv[i]));
    }
    store_vec<V>(dmu + base + j, gm);
    store_vec<V>(dlv + base + j, gl);
  }
}

}  // namespace

extern "C" {

// Launch on `stream` by the caller's plan (lanes a row, rows a block,
// blocks, bytes a lane's access), which must equal row_plan's for these
// shapes and pointers; returns cudaErrorInvalidValue if it does not, else
// cudaGetLastError() after the launch (0 = ok).
int reparam_kl_f32(const float* mu, const float* logvar, const float* eps,
                   float* z, float* kl, int n, int k, int lanes, int rows,
                   int blocks, int vec, void* stream) {
  if (n < 1 || k < 1) return (int)cudaErrorInvalidValue;
  const int v = vec_width(k, addr_bits(mu) | addr_bits(logvar) |
                                 addr_bits(eps) | addr_bits(z));
  const RowPlan p = row_plan(n, k / v);
  if (!same_plan(p, lanes, rows, blocks) || vec != 4 * v)
    return (int)cudaErrorInvalidValue;
  const int lg = log2_of(p.lanes);
  const auto kernel = v == 4   ? reparam_kl_kernel<4>
                      : v == 2 ? reparam_kl_kernel<2>
                               : reparam_kl_kernel<1>;
  return launch_dependent(kernel, p.blocks, kRowThreads,
                          (cudaStream_t)stream, mu, logvar, eps, z, kl, n, k,
                          lg);
}

// The backward: dz's row and column strides and dkl's stride in elements
// (all >= 0); vectors only where dz's columns are contiguous and its row
// stride keeps every row's base aligned.  The same plan rules as above.
int reparam_kl_bwd_f32(const float* mu, const float* logvar, const float* eps,
                       const float* dz, const float* dkl, float* dmu,
                       float* dlv, int n, int k, int dz_rs, int dz_cs,
                       int dkl_s, int lanes, int rows, int blocks, int vec,
                       void* stream) {
  if (n < 1 || k < 1 || dz_rs < 0 || dz_cs < 0 || dkl_s < 0)
    return (int)cudaErrorInvalidValue;
  const size_t align = addr_bits(mu) | addr_bits(logvar) | addr_bits(eps) |
                       addr_bits(dz) | addr_bits(dmu) | addr_bits(dlv) |
                       (size_t)dz_rs * sizeof(float);
  const int v = dz_cs != 1 ? 1 : vec_width(k, align);
  const RowPlan p = row_plan(n, k / v);
  if (!same_plan(p, lanes, rows, blocks) || vec != 4 * v)
    return (int)cudaErrorInvalidValue;
  const int lg = log2_of(p.lanes);
  const auto kernel = v == 4   ? reparam_kl_bwd_kernel<4>
                      : v == 2 ? reparam_kl_bwd_kernel<2>
                               : reparam_kl_bwd_kernel<1>;
  return launch_dependent(kernel, p.blocks, kRowThreads,
                          (cudaStream_t)stream, mu, logvar, eps, dz, dkl, dmu,
                          dlv, n, k, (long long)dz_rs, (long long)dz_cs,
                          (long long)dkl_s, lg);
}

}  // extern "C"
