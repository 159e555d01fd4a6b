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
// element.
//
// Forward (bn_act_fwd_cluster_kernel): one launch of thread block clusters,
// each channel split over the `cluster` blocks of one cluster (1-8, chosen
// by the wrapper so that C x cluster is ~256 blocks, two a SM: 8 at C 32, 4
// at C 64, 2 at C 128; one channel a block would leave a third to three
// quarters of the 132 SMs idle at C 32-64).  A block of 256 threads takes
// a contiguous share of the channel's B*L elements (a flat index, l
// innermost) and, where the share fits (<= 16 elements a thread; every
// train-step shape does), holds it in registers: it reads x once, forms
// the partial (sum x, sum x^2), and cluster_sum2 (common.cuh) adds the
// cluster's partials through distributed shared memory, in rank order, so
// every block has the same mean and variance; then it normalises from
// registers and writes out.  So x is read once and out written once, in
// one launch.  A share too large for registers is read again, from L2 or
// device memory, to normalise.  Loads are 16 bytes where L % 4 == 0 and x
// is 16-byte aligned, 8 bytes where L % 2 == 0, else 4.
//
// Backward (bn_act_bwd_kernel): the first design, one block of 1024
// threads per channel walks the channel's B*L elements, four independent
// loads in flight per thread; f32 partial sums are reduced by warp
// shuffles and shared memory; the same block then re-reads its channel
// (from L2: a channel is at most 128 KB here) to form dx.  Only C = 32 to
// 128 blocks run on 132 SMs; the forward's cluster split (cluster_sum2
// over its two sums) is the change it would take.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;             // K3's block
constexpr int kUnroll = 4;
constexpr int kFwdThreads = 256;           // K2's block
constexpr int kFwdItems = 16;              // elements a thread keeps

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

template <int A, int V>
__global__ void __launch_bounds__(kFwdThreads)
    bn_act_fwd_cluster_kernel(const float* __restrict__ x,
                              const float* __restrict__ gamma,
                              const float* __restrict__ beta,
                              float* __restrict__ out,
                              float* __restrict__ mean_out,
                              float* __restrict__ var_out, int nb, int nc,
                              int nl, float eps) {
  constexpr int NV = kFwdItems / V;            // vectors a thread keeps
  __shared__ float2 scratch[32];
  const int cluster = (int)cooperative_groups::this_cluster().num_blocks();
  const int rank = (int)cooperative_groups::this_cluster().block_rank();
  const int c = blockIdx.x / cluster;
  const int n = nb * nl;
  const Channel ch{(size_t)c * nl, (size_t)nc * nl, nl};
  // this block's share of the channel, in whole vectors (L % V == 0, so a
  // vector never straddles two rows)
  const int nvec = n / V;
  const int per = (nvec + cluster - 1) / cluster;
  const int q0 = min(nvec, rank * per), q1 = min(nvec, q0 + per);
  const bool resident = q1 - q0 <= NV * kFwdThreads;

  float v[NV][V];
  size_t off[NV];
  float s = 0.f, s2 = 0.f;
  if (resident) {
    // the offsets of this thread's vectors, kFwdThreads * V elements apart:
    // the first one's (b, l) by one division, then stepped
    const int step = kFwdThreads * V, db = step / nl, dl = step - db * nl;
    int b = (q0 + (int)threadIdx.x) * V / nl;
    int l = (q0 + (int)threadIdx.x) * V - b * nl;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      off[j] = (size_t)b * ch.row + ch.base + l;
      b += db;
      l += dl;
      if (l >= nl) {
        l -= nl;
        ++b;
      }
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int q = q0 + threadIdx.x + j * kFwdThreads;
      if (q < q1) {
        load_vec<V>(x + off[j], v[j]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) v[j][e] = 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        s += v[j][e];
        s2 += v[j][e] * v[j][e];
      }
  } else {
    for (int q = q0 + threadIdx.x; q < q1; q += kFwdThreads) {
      float t[V];
      load_vec<V>(x + ch.at(q * V), t);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        s += t[e];
        s2 += t[e] * t[e];
      }
    }
  }
  const float2 tot = cluster_sum2(s, s2, scratch);
  const float inv_n = 1.f / (float)n;
  const float mean = tot.x * inv_n;
  const float var = fmaxf(tot.y * inv_n - mean * mean, 0.f);
  const float mul = rsqrtf(var + eps) * gamma[c];
  const float shift = beta[c];

  if (resident) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int q = q0 + threadIdx.x + j * kFwdThreads;
      if (q >= q1) continue;
#pragma unroll
      for (int e = 0; e < V; ++e) v[j][e] = act<A>((v[j][e] - mean) * mul + shift);
      store_vec<V>(out + off[j], v[j]);
    }
  } else {
    for (int q = q0 + threadIdx.x; q < q1; q += kFwdThreads) {
      const size_t off = ch.at(q * V);
      float t[V];
      load_vec<V>(x + off, t);
#pragma unroll
      for (int e = 0; e < V; ++e) t[e] = act<A>((t[e] - mean) * mul + shift);
      store_vec<V>(out + off, t);
    }
  }
  if (rank == 0 && threadIdx.x == 0) {
    mean_out[c] = mean;
    var_out[c] = var;
  }
  cluster_sum2_wait();
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

template <int A, int V>
int launch_fwd(const float* x, const float* gamma, const float* beta,
               float* out, float* mean, float* var, int nb, int nc, int nl,
               float eps, int cluster, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)nc * cluster);
  cfg.blockDim = dim3(kFwdThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, bn_act_fwd_cluster_kernel<A, V>, x, gamma, beta, out, mean, var,
      nb, nc, nl, eps);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <int A>
int launch_fwd_vec(const float* x, const float* gamma, const float* beta,
                   float* out, float* mean, float* var, int nb, int nc,
                   int nl, float eps, int cluster, cudaStream_t stream) {
  const size_t align = reinterpret_cast<size_t>(x) |
                       reinterpret_cast<size_t>(out);
  if (nl % 4 == 0 && align % 16 == 0)
    return launch_fwd<A, 4>(x, gamma, beta, out, mean, var, nb, nc, nl, eps,
                            cluster, stream);
  if (nl % 2 == 0 && align % 8 == 0)
    return launch_fwd<A, 2>(x, gamma, beta, out, mean, var, nb, nc, nl, eps,
                            cluster, stream);
  return launch_fwd<A, 1>(x, gamma, beta, out, mean, var, nb, nc, nl, eps,
                          cluster, stream);
}

bool bad_shape(int nb, int nc, int nl, int act) {
  return nb < 1 || nc < 1 || nl < 1 || act < kElu || act > kNone;
}

}  // namespace

extern "C" {

// x, out (B, C, L); gamma, beta, mean, var (C,).  One launch of C
// clusters of `cluster` (1-8) blocks on `stream`; returns the launch's
// error, or cudaGetLastError() after it (0 = ok).
int bn_act_fwd_f32(const float* x, const float* gamma, const float* beta,
                   float* out, float* mean, float* var, int nb, int nc,
                   int nl, float eps, int act, int cluster, void* stream) {
  if (bad_shape(nb, nc, nl, act) || cluster < 1 || cluster > 8)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (act) {
    case kElu:
      return launch_fwd_vec<kElu>(x, gamma, beta, out, mean, var, nb, nc, nl,
                                  eps, cluster, s);
    case kGelu:
      return launch_fwd_vec<kGelu>(x, gamma, beta, out, mean, var, nb, nc,
                                   nl, eps, cluster, s);
    default:
      return launch_fwd_vec<kNone>(x, gamma, beta, out, mean, var, nb, nc,
                                   nl, eps, cluster, s);
  }
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
