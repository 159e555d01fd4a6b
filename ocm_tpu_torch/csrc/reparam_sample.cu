// Reparameterization and per-sample KL with the noise drawn in the kernel.
//
// Replaces the TPU kernel reparam_loss_pallas with eps=None
// (ocm_tpu/ops/kernels.py:160-183, call :180), which seeds the core's PRNG
// per tile and turns its bits into standard normals by Box-Muller.  The
// port uses it where a latent code is sampled outside training: the
// stochastic calibration forward and the sampled eval forward.
//
//   eps_ij = sqrt(-2 ln u1) * cos(2 pi u2),
//            u1 = (b1 >> 8) 2^-24 + 1e-7,  u2 = (b2 >> 8) 2^-24
//   z_ij   = mu_ij + eps_ij * exp(lv_ij / 2)
//   kl_i   = -1/2 * sum_j (1 + lv_ij - mu_ij^2 - exp(lv_ij))
//
// The transform of the bits is the TPU kernel's, so eps has the same
// distribution (|eps| <= sqrt(-2 ln 1e-7) ~ 5.68).  The bits come from
// Philox4x32-10 (Random123): key = the 64-bit seed, counter = (element-pair
// index p, 64-bit offset).  One Philox call gives four words: (w0, w1) make
// the normal of element 2p, (w2, w3) that of element 2p + 1, where the
// element index is row * k + col.  The noise therefore depends only on
// (seed, offset, row, col) for a given k, never on the grid; the TPU
// kernel's per-tile seeds (seed + tile) tied it to tile_n.
//
// Inputs mu, logvar (N, k) f32, contiguous; outputs z (N, k), kl (N,) and,
// when eps_out is not null, the noise itself (N, k) for checking.
//
// What bounds it on an H100: 12 N k + 4 N bytes against ~150 integer and
// transcendental operations per two elements (ten Philox rounds of two
// 32x32 multiplies, xors and key bumps; log, sqrt and cos per normal), so
// bytes bound it at (65536, 16) by ~4x; at the calibration's (512, 16) the
// launch sets its time.  Design: each row a group of g lanes
// (ops/kernels.py reparam_plan, common.cuh row_plan), g the smallest power
// of two >= the element pairs the row touches ((k + 1) / 2: at odd k a
// row's first or last pair straddles into its neighbour, and both rows'
// lanes draw it), at most 32; each lane draws the pairs lane, lane + g,
// ... of its row, one Philox call a pair, so which thread draws a pair
// changes with g but never the bits it draws.  z, mu and logvar move by
// 8-byte pairs where k is even and every base is 8-byte aligned, else by
// scalars; the KL row sum is reduced by shuffles within the group.  At
// (65536, 16): 8 lanes a row, 2,048 blocks of 256 threads, every lane
// busy.  The kernel writes every row of kl, so the wrapper allocates it
// without a fill.  Launched as a programmatic dependent, like K4
// (reparam_kl.cu): it may start while fc_logvar's Linear is running and
// waits for its writes before its first read.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr uint32_t kMul0 = 0xD2511F53u, kMul1 = 0xCD9E8D57u;
constexpr uint32_t kBump0 = 0x9E3779B9u, kBump1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kMul0, c.x), lo0 = kMul0 * c.x;
    const uint32_t hi1 = __umulhi(kMul1, c.z), lo1 = kMul1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += kBump0;
    k1 += kBump1;
  }
  return c;
}

// The TPU kernel's Box-Muller on two 32-bit words (kernels.py:169-174).
__device__ __forceinline__ float box_muller(uint32_t b1, uint32_t b2) {
  const float u1 = (float)(b1 >> 8) * 5.9604644775390625e-8f + 1e-7f;
  const float u2 = (float)(b2 >> 8) * 5.9604644775390625e-8f;
  return sqrtf(-2.f * logf(u1)) * cosf(6.283185307179586f * u2);
}

template <int V>
__global__ void __launch_bounds__(kRowThreads)
    reparam_kl_sample_kernel(const float* __restrict__ mu,
                             const float* __restrict__ logvar,
                             float* __restrict__ z, float* __restrict__ kl,
                             float* __restrict__ eps_out, int n, int k,
                             int lg, uint32_t key0, uint32_t key1,
                             uint32_t off0, uint32_t off1) {
  wait_for_producer();
  const int g = 1 << lg;
  const int row = blockIdx.x * (kRowThreads >> lg) + (int)(threadIdx.x >> lg);
  const int lane = threadIdx.x & (g - 1);
  float acc = 0.f;
  if (row < n) {
    const long long first = (long long)row * k, end = first + k;
    for (long long p = (first >> 1) + lane; 2 * p < end; p += g) {
      const uint4 w = philox4x32_10(
          make_uint4((uint32_t)p, (uint32_t)(p >> 32), off0, off1), key0,
          key1);
      if constexpr (V == 2) {   // k even: the pair lies in this row
        const long long e = 2 * p;
        float m[2], lv[2], out[2];
        const float eps[2] = {box_muller(w.x, w.y), box_muller(w.z, w.w)};
        load_vec<2>(mu + e, m);
        load_vec<2>(logvar + e, lv);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          out[h] = m[h] + eps[h] * expf(0.5f * lv[h]);
          acc += 1.f + lv[h] - m[h] * m[h] - expf(lv[h]);
        }
        store_vec<2>(z + e, out);
        if (eps_out != nullptr) store_vec<2>(eps_out + e, eps);
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long e = 2 * p + h;
          if (e < first || e >= end) continue;
          const float eps =
              h == 0 ? box_muller(w.x, w.y) : box_muller(w.z, w.w);
          const float m = mu[e];
          const float lv = logvar[e];
          z[e] = m + eps * expf(0.5f * lv);
          acc += 1.f + lv - m * m - expf(lv);
          if (eps_out != nullptr) eps_out[e] = eps;
        }
      }
    }
  }
  acc = group_sum(acc, g);   // every lane of the warp, rows past n too
  if (row < n && lane == 0) kl[row] = -0.5f * acc;
}

}  // namespace

extern "C" {

// Launch on `stream` by the caller's plan (lanes a row, rows a block,
// blocks, bytes a lane's access to z), which must equal row_plan's for
// these shapes and pointers; returns cudaErrorInvalidValue if it does
// not, else cudaGetLastError() after the launch (0 = ok).  `eps_out` may
// be null.
int reparam_kl_sample_f32(const float* mu, const float* logvar, float* z,
                          float* kl, float* eps_out, int n, int k,
                          unsigned long long seed, unsigned long long offset,
                          int lanes, int rows, int blocks, int vec,
                          void* stream) {
  if (n < 1 || k < 1) return (int)cudaErrorInvalidValue;
  const size_t align = addr_bits(mu) | addr_bits(logvar) | addr_bits(z) |
                       addr_bits(eps_out);
  const int v = vec_width(k, align) > 1 ? 2 : 1;
  const RowPlan p = row_plan(n, (k + 1) / 2);
  if (!same_plan(p, lanes, rows, blocks) || vec != 4 * v)
    return (int)cudaErrorInvalidValue;
  const int lg = log2_of(p.lanes);
  const uint32_t key0 = (uint32_t)seed, key1 = (uint32_t)(seed >> 32);
  const uint32_t off0 = (uint32_t)offset, off1 = (uint32_t)(offset >> 32);
  const auto kernel =
      v == 2 ? reparam_kl_sample_kernel<2> : reparam_kl_sample_kernel<1>;
  return launch_dependent(kernel, p.blocks, kRowThreads,
                          (cudaStream_t)stream, mu, logvar, z, kl, eps_out, n,
                          k, lg, key0, key1, off0, off1);
}

}  // extern "C"
