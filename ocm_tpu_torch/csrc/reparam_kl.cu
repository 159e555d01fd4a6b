// Fused reparameterization and per-sample KL of the VAE's latent code.
//
// Replaces the TPU kernel reparam_loss_pallas with explicit noise
// (ocm_tpu/ops/kernels.py:110, call :153), which fused_reparam_kl
// (kernels.py:192) makes differentiable; here the differentiable form is
// ocm_tpu_torch.ops.kernels.fused_reparam_kl, a torch.autograd.Function
// whose forward is this kernel and whose backward stays plain elementwise
// torch (in JAX too it is jnp outside any Pallas kernel).
//
//   z_ij  = mu_ij + eps_ij * exp(lv_ij / 2)
//   kl_i  = -1/2 * sum_j (1 + lv_ij - mu_ij^2 - exp(lv_ij))
//
// Inputs mu, logvar, eps (N, k) f32, contiguous; outputs z (N, k), kl (N,).
// The TPU kernel padded k to 128 lanes (zero columns add exactly 0 to the
// KL); nothing is padded here.
//
// What bounds it on an H100: at the VAE's shapes (N 64, k 16) it moves 16
// N k + 4 N bytes = 16.6 KB, nanoseconds of bandwidth: the launch itself
// sets its time.  Design: one warp per row, lanes striding over k, the KL
// row sum reduced by shuffles; 8 rows to a block of 256 threads.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
    reparam_kl_kernel(const float* __restrict__ mu,
                      const float* __restrict__ logvar,
                      const float* __restrict__ eps, float* __restrict__ z,
                      float* __restrict__ kl, int n, int k) {
  const int row = blockIdx.x * kRowsPerBlock + (int)(threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;   // the whole warp leaves together
  const size_t base = (size_t)row * k;
  float acc = 0.f;
  for (int j = lane; j < k; j += 32) {
    const float m = mu[base + j];
    const float lv = logvar[base + j];
    z[base + j] = m + eps[base + j] * expf(0.5f * lv);
    acc += 1.f + lv - m * m - expf(lv);
  }
  acc = warp_sum(acc);
  if (lane == 0) kl[row] = -0.5f * acc;
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
int reparam_kl_f32(const float* mu, const float* logvar, const float* eps,
                   float* z, float* kl, int n, int k, void* stream) {
  if (n < 1 || k < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  reparam_kl_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      mu, logvar, eps, z, kl, n, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
