// Training-mode BatchNorm + activation in one kernel per direction.
//
// Replaces the TPU kernels _bn_fwd_pallas (forward, ocm_tpu/ops/bn.py:126,
// body _fwd_kernel :91) and _bn_bwd_pallas (backward, bn.py:147, body
// _bwd_kernel :104), paired there by a custom VJP and here by
// ocm_tpu_torch.ops.bn.fused_bn_act (a torch.autograd.Function).
//
// Layout: torch's conv layout x (B, C, L), f32, contiguous; statistics over
// B and L for each channel, with no relayout (the TPU kernel transposed to
// (C, B*L) and padded C to 8 and B*L to 128; nothing here is padded, the
// sums divide by the true n = B*L and the ragged edge is masked).
//
//   forward (K2):  mean = E[x], var = max(E[x^2] - mean^2, 0)  (flax's fast
//                  variance), y = (x - mean) * rsqrt(var + eps) * gamma
//                  + beta, out = act(y); writes out, mean, var.
//   backward (K3): xhat = (x - mean) * rstd, y = xhat * gamma + beta,
//                  dy = dout * act'(y), dbeta = sum(dy),
//                  dgamma = sum(dy * xhat),
//                  dx = rstd * gamma * (dy - dbeta/n - xhat * dgamma/n).
//
// act: 0 = ELU (expm1f; the TPU kernel used exp(y) - 1), 1 = exact GELU
// (erff), 2 = none.
//
// What bounds it on an H100: bytes.  The forward must read x and write out
// (8 B C L bytes), the backward read x and dout and write dx (12 B C L);
// at the VAE's training shapes (B 64, C 32..128, L 126..504) that is 8-12
// MB a layer, ~2.5-3.7 us at 3.35 TB/s, against ~10-30 f32 operations an
// element.  The design is the simple one: one block of 1024 threads per
// channel walks the channel's B*L elements (a flat index, l innermost, so
// neighbouring threads read neighbouring addresses), four independent
// loads in flight per thread; f32 partial sums are reduced by warp
// shuffles and shared memory; the same block then re-reads its channel
// (from L2: a channel is at most 128 KB here) to normalise or to form dx.
//
// First thing a later PR would change: the grid.  There are only C = 32 to
// 128 blocks for the card's 132 SMs, one block on each, so most of the
// card idles and each SM's bandwidth is bounded by the loads its one block
// keeps in flight.  Splitting each channel over several blocks (partial
// sums, then a second pass or a cluster reduction) would fill the card.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kUnroll = 4;

enum Act : int { kElu = 0, kGelu = 1, kNone = 2 };

constexpr float kSqrtHalf = 0.70710678118654752f;   // 1 / sqrt(2)
constexpr float kInvSqrt2Pi = 0.39894228040143268f; // 1 / sqrt(2 pi)

template <int A>
__device__ __forceinline__ float act(float y) {
  if constexpr (A == kElu) {
    return y > 0.f ? y : expm1f(y);
  } else if constexpr (A == kGelu) {
    return 0.5f * y * (1.f + erff(y * kSqrtHalf));
  } else {
    return y;
  }
}

// d act(y) / dy at the pre-activation y.
template <int A>
__device__ __forceinline__ float act_grad(float y) {
  if constexpr (A == kElu) {
    return y > 0.f ? 1.f : expf(y);
  } else if constexpr (A == kGelu) {
    const float phi = expf(-0.5f * y * y) * kInvSqrt2Pi;
    const float cdf = 0.5f * (1.f + erff(y * kSqrtHalf));
    return cdf + y * phi;
  } else {
    return 1.f;
  }
}

// Element i (0 <= i < B*L) of channel c: offset of (b, c, l), i = b*L + l.
struct Channel {
  size_t base;     // c * L
  size_t row;      // C * L, the stride of b
  int l;

  __device__ __forceinline__ size_t at(int i) const {
    const int b = i / l;
    return (size_t)b * row + base + (size_t)(i - b * l);
  }
};

template <int A>
__global__ void __launch_bounds__(kThreads)
    bn_act_fwd_kernel(const float* __restrict__ x,
                      const float* __restrict__ gamma,
                      const float* __restrict__ beta, float* __restrict__ out,
                      float* __restrict__ mean_out,
                      float* __restrict__ var_out, int nb, int nc, int nl,
                      float eps) {
  __shared__ float2 scratch[32];
  const int c = blockIdx.x;
  const int n = nb * nl;
  const Channel ch{(size_t)c * nl, (size_t)nc * nl, nl};

  float s = 0.f, s2 = 0.f;
  for (int i0 = threadIdx.x; i0 < n; i0 += kThreads * kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads;
      v[u] = i < n ? x[ch.at(i)] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      s += v[u];
      s2 += v[u] * v[u];
    }
  }
  const float2 tot = block_sum2(s, s2, scratch);
  const float inv_n = 1.f / (float)n;
  const float mean = tot.x * inv_n;
  const float var = fmaxf(tot.y * inv_n - mean * mean, 0.f);
  const float mul = rsqrtf(var + eps) * gamma[c];
  const float shift = beta[c];

  for (int i0 = threadIdx.x; i0 < n; i0 += kThreads * kUnroll) {
    size_t off[kUnroll];
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads;
      off[u] = i < n ? ch.at(i) : 0;
      v[u] = i < n ? x[off[u]] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i0 + u * kThreads < n)
        out[off[u]] = act<A>((v[u] - mean) * mul + shift);
    }
  }
  if (threadIdx.x == 0) {
    mean_out[c] = mean;
    var_out[c] = var;
  }
}

template <int A>
__global__ void __launch_bounds__(kThreads)
    bn_act_bwd_kernel(const float* __restrict__ x,
                      const float* __restrict__ gamma,
                      const float* __restrict__ beta,
                      const float* __restrict__ mean_in,
                      const float* __restrict__ var_in,
                      const float* __restrict__ dout, float* __restrict__ dx,
                      float* __restrict__ dgamma_out,
                      float* __restrict__ dbeta_out, int nb, int nc, int nl,
                      float eps) {
  __shared__ float2 scratch[32];
  const int c = blockIdx.x;
  const int n = nb * nl;
  const Channel ch{(size_t)c * nl, (size_t)nc * nl, nl};
  const float mean = mean_in[c];
  const float rstd = rsqrtf(var_in[c] + eps);
  const float g = gamma[c];
  const float bt = beta[c];

  float sdy = 0.f, sdyx = 0.f;
  for (int i0 = threadIdx.x; i0 < n; i0 += kThreads * kUnroll) {
    float v[kUnroll], d[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads;
      const size_t off = i < n ? ch.at(i) : 0;
      v[u] = i < n ? x[off] : 0.f;
      d[u] = i < n ? dout[off] : 0.f;   // 0 for the masked tail: adds 0
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float xhat = (v[u] - mean) * rstd;
      const float dy = d[u] * act_grad<A>(xhat * g + bt);
      sdy += dy;
      sdyx += dy * xhat;
    }
  }
  const float2 tot = block_sum2(sdy, sdyx, scratch);
  const float inv_n = 1.f / (float)n;
  const float dbeta_n = tot.x * inv_n;
  const float dgamma_n = tot.y * inv_n;
  const float scale = rstd * g;

  for (int i0 = threadIdx.x; i0 < n; i0 += kThreads * kUnroll) {
    size_t off[kUnroll];
    float v[kUnroll], d[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads;
      off[u] = i < n ? ch.at(i) : 0;
      v[u] = i < n ? x[off[u]] : 0.f;
      d[u] = i < n ? dout[off[u]] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i0 + u * kThreads < n) {
        const float xhat = (v[u] - mean) * rstd;
        const float dy = d[u] * act_grad<A>(xhat * g + bt);
        dx[off[u]] = scale * (dy - dbeta_n - xhat * dgamma_n);
      }
    }
  }
  if (threadIdx.x == 0) {
    dgamma_out[c] = tot.y;
    dbeta_out[c] = tot.x;
  }
}

bool bad_shape(int nb, int nc, int nl, int act) {
  return nb < 1 || nc < 1 || nl < 1 || act < kElu || act > kNone;
}

}  // namespace

extern "C" {

// x, out (B, C, L); gamma, beta, mean, var (C,).  One block per channel on
// `stream`; returns cudaGetLastError() after the launch (0 = ok).
int bn_act_fwd_f32(const float* x, const float* gamma, const float* beta,
                   float* out, float* mean, float* var, int nb, int nc,
                   int nl, float eps, int act, void* stream) {
  if (bad_shape(nb, nc, nl, act)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (act) {
    case kElu:
      bn_act_fwd_kernel<kElu><<<nc, kThreads, 0, s>>>(
          x, gamma, beta, out, mean, var, nb, nc, nl, eps);
      break;
    case kGelu:
      bn_act_fwd_kernel<kGelu><<<nc, kThreads, 0, s>>>(
          x, gamma, beta, out, mean, var, nb, nc, nl, eps);
      break;
    default:
      bn_act_fwd_kernel<kNone><<<nc, kThreads, 0, s>>>(
          x, gamma, beta, out, mean, var, nb, nc, nl, eps);
  }
  return (int)cudaGetLastError();
}

// x, dout, dx (B, C, L); gamma, beta, mean, var, dgamma, dbeta (C,).
int bn_act_bwd_f32(const float* x, const float* gamma, const float* beta,
                   const float* mean, const float* var, const float* dout,
                   float* dx, float* dgamma, float* dbeta, int nb, int nc,
                   int nl, float eps, int act, void* stream) {
  if (bad_shape(nb, nc, nl, act)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (act) {
    case kElu:
      bn_act_bwd_kernel<kElu><<<nc, kThreads, 0, s>>>(
          x, gamma, beta, mean, var, dout, dx, dgamma, dbeta, nb, nc, nl,
          eps);
      break;
    case kGelu:
      bn_act_bwd_kernel<kGelu><<<nc, kThreads, 0, s>>>(
          x, gamma, beta, mean, var, dout, dx, dgamma, dbeta, nb, nc, nl,
          eps);
      break;
    default:
      bn_act_bwd_kernel<kNone><<<nc, kThreads, 0, s>>>(
          x, gamma, beta, mean, var, dout, dx, dgamma, dbeta, nb, nc, nl,
          eps);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
