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
// Both directions are one launch of thread block clusters, each channel
// split over the `cluster` blocks of one cluster (1-8, chosen by the
// wrapper, ops.bn.k2_cluster_size, so that C x cluster is ~256 blocks, two
// a SM: 8 at C 32, 4 at C 64, 2 at C 128; one channel a block would leave
// a third to three quarters of the 132 SMs idle at C 32-64).  A block of
// 256 threads takes a contiguous share of the channel's B*L elements (a
// flat index, l innermost) and, where the share fits (<= 16 elements a
// thread; every train-step shape does), holds it in registers:
//
// - forward (bn_act_fwd_cluster_kernel): it reads x once and forms the
//   partial (sum x, sum x^2);
// - backward (bn_act_bwd_cluster_kernel): it reads x and dout once, keeps
//   xhat and dy = dout act'(y) and forms the partial (sum dy, sum dy xhat).
//
// cluster_sum2 (common.cuh) adds the cluster's partials through
// distributed shared memory, in rank order, so every block has the same
// totals bit for bit; then each thread writes out (forward) or dx
// (backward) from its registers.  So the forward moves 8 bytes an element
// and the backward 12, each in one launch.  A share too large for
// registers is read again, from L2 or device memory, for the second half.
// Loads are 16 bytes where L % 4 == 0 and every tensor of the shape is
// 16-byte aligned, 8 bytes where L % 2 == 0, else 4.
//
// Measured (PERF.md §6, NVIDIA H100 80GB HBM3, 700 W), over the train
// step's six shapes: K2 0.056 ms with inputs rotating past the L2, 0.048
// L2-warm; K3 0.062 and 0.050 (its first design, one 1024-thread block a
// channel reading x and dout twice, 0.146 and 0.131).  That is 3.3-3.8x
// (K2) and 2.3-2.8x (K3) their bounds: a shape's read, cluster barrier and
// write run one after the other in one wave, and a launch alone takes ~2
// us.
//
// Eval mode (K9, bn_act_eval_kernel): the epilogue of a convolution whose
// bias was left out, with the running statistics instead of the batch's,
//
//   out = act((((x + bias) - mean) * mul) + beta),  mul = rsqrt(var + eps)
//   * gamma (computed by the caller, a C-length op),
//
// in place or into `out`.  It replaces the eager chain conv bias add, x -
// mean, * mul, + beta, act: five passes over the activation, where this
// is one.  The four operations are the chain's own, in its order, each
// rounded on its own (__fadd_rn / __fsub_rn / __fmul_rn: nvcc may not
// contract them into an FMA), and ELU is torch's expm1f, so with ELU and
// none the output equals the chain's bit for bit (exact GELU: within 2
// ulp of torch's).  Nothing is reduced: bytes bound it, 8
// B an element, 0.36 ms for the nuts screens' 16,384 x 9,216-float
// activations at 3.35 TB/s.  Each thread takes one vector of the flat (B,
// C, L) array, in a grid of as many blocks as the vectors fill (at those
// shapes 0.40 ms, 90 % of the bound, as fast as torch's copy of the same
// bytes; grid-stride loops over the resident blocks, 1-8 vectors a thread
// in flight, with or without streaming cache hints, read 0.43-0.45 ms,
// 80-84 %; PERF.md section 6).  Vectors are 16 bytes where L % 4 == 0 and x
// and out are 16-byte aligned, 8 bytes where L % 2 == 0, else 4, as in
// K2, so a vector lies in one row; its channel is (i / L) % C of its
// first element i.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;              // a block
constexpr int kItems = 16;                 // elements a thread keeps

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

// This block's share of its channel, in whole vectors of V elements
// (L % V == 0, so a vector never straddles two rows): [q0, q1) of the
// channel's n / V, split evenly over the cluster's blocks.  Where the share
// fits in registers (at most NV vectors a thread), `off` holds this
// thread's vectors' offsets, kThreads * V elements apart: the first one's
// (b, l) by one division, then stepped.
template <int V, int NV>
struct Share {
  int q0, q1;
  bool resident;
  size_t off[NV];

  __device__ __forceinline__ Share(const Channel& ch, int n, int rank,
                                   int cluster) {
    const int nvec = n / V;
    const int per = (nvec + cluster - 1) / cluster;
    q0 = min(nvec, rank * per);
    q1 = min(nvec, q0 + per);
    resident = q1 - q0 <= NV * kThreads;
    if (!resident) return;
    const int step = kThreads * V, db = step / ch.l, dl = step - db * ch.l;
    int b = (q0 + (int)threadIdx.x) * V / ch.l;
    int l = (q0 + (int)threadIdx.x) * V - b * ch.l;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      off[j] = (size_t)b * ch.row + ch.base + l;
      b += db;
      l += dl;
      if (l >= ch.l) {
        l -= ch.l;
        ++b;
      }
    }
  }

  // this thread's j-th vector lies in the share
  __device__ __forceinline__ bool has(int j) const {
    return q0 + (int)threadIdx.x + j * kThreads < q1;
  }
};

__device__ __forceinline__ int cluster_blocks() {
  return (int)cooperative_groups::this_cluster().num_blocks();
}

__device__ __forceinline__ int cluster_rank() {
  return (int)cooperative_groups::this_cluster().block_rank();
}

template <int A, int V>
__global__ void __launch_bounds__(kThreads)
    bn_act_fwd_cluster_kernel(const float* __restrict__ x,
                              const float* __restrict__ gamma,
                              const float* __restrict__ beta,
                              float* __restrict__ out,
                              float* __restrict__ mean_out,
                              float* __restrict__ var_out, int nb, int nc,
                              int nl, float eps) {
  constexpr int NV = kItems / V;               // vectors a thread keeps
  __shared__ float2 scratch[32];
  const int cluster = cluster_blocks(), rank = cluster_rank();
  const int c = blockIdx.x / cluster;
  const int n = nb * nl;
  const Channel ch{(size_t)c * nl, (size_t)nc * nl, nl};
  const Share<V, NV> sh(ch, n, rank, cluster);

  float v[NV][V];
  float s = 0.f, s2 = 0.f;
  if (sh.resident) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (sh.has(j)) {
        load_vec<V>(x + sh.off[j], v[j]);
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
    for (int q = sh.q0 + threadIdx.x; q < sh.q1; q += kThreads) {
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

  if (sh.resident) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (!sh.has(j)) continue;
#pragma unroll
      for (int e = 0; e < V; ++e) v[j][e] = act<A>((v[j][e] - mean) * mul + shift);
      store_vec<V>(out + sh.off[j], v[j]);
    }
  } else {
    for (int q = sh.q0 + threadIdx.x; q < sh.q1; q += kThreads) {
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

// The backward's per-element terms: x becomes xhat and d becomes
// dy = dout * act'(xhat * g + bt).
template <int A>
__device__ __forceinline__ void bwd_terms(float& x, float& d, float mean,
                                          float rstd, float g, float bt) {
  x = (x - mean) * rstd;
  d *= act_grad<A>(x * g + bt);
}

template <int A, int V>
__global__ void __launch_bounds__(kThreads)
    bn_act_bwd_cluster_kernel(const float* __restrict__ x,
                              const float* __restrict__ gamma,
                              const float* __restrict__ beta,
                              const float* __restrict__ mean_in,
                              const float* __restrict__ var_in,
                              const float* __restrict__ dout,
                              float* __restrict__ dx,
                              float* __restrict__ dgamma_out,
                              float* __restrict__ dbeta_out, int nb, int nc,
                              int nl, float eps) {
  constexpr int NV = kItems / V;
  __shared__ float2 scratch[32];
  const int cluster = cluster_blocks(), rank = cluster_rank();
  const int c = blockIdx.x / cluster;
  const int n = nb * nl;
  const Channel ch{(size_t)c * nl, (size_t)nc * nl, nl};
  const Share<V, NV> sh(ch, n, rank, cluster);
  const float mean = mean_in[c];
  const float rstd = rsqrtf(var_in[c] + eps);
  const float g = gamma[c];
  const float bt = beta[c];

  // xh and dy start as x and dout; masked vectors are 0 and add 0 (dy 0)
  float xh[NV][V], dy[NV][V];
  float sdy = 0.f, sdyx = 0.f;
  if (sh.resident) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (sh.has(j)) {
        load_vec<V>(x + sh.off[j], xh[j]);
        load_vec<V>(dout + sh.off[j], dy[j]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) xh[j][e] = dy[j][e] = 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        bwd_terms<A>(xh[j][e], dy[j][e], mean, rstd, g, bt);
        sdy += dy[j][e];
        sdyx += dy[j][e] * xh[j][e];
      }
  } else {
    for (int q = sh.q0 + threadIdx.x; q < sh.q1; q += kThreads) {
      const size_t off = ch.at(q * V);
      float t[V], d[V];
      load_vec<V>(x + off, t);
      load_vec<V>(dout + off, d);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        bwd_terms<A>(t[e], d[e], mean, rstd, g, bt);
        sdy += d[e];
        sdyx += d[e] * t[e];
      }
    }
  }
  const float2 tot = cluster_sum2(sdy, sdyx, scratch);
  const float inv_n = 1.f / (float)n;
  const float dbeta_n = tot.x * inv_n;
  const float dgamma_n = tot.y * inv_n;
  const float scale = rstd * g;

  if (sh.resident) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (!sh.has(j)) continue;
#pragma unroll
      for (int e = 0; e < V; ++e)
        dy[j][e] = scale * (dy[j][e] - dbeta_n - xh[j][e] * dgamma_n);
      store_vec<V>(dx + sh.off[j], dy[j]);
    }
  } else {
    for (int q = sh.q0 + threadIdx.x; q < sh.q1; q += kThreads) {
      const size_t off = ch.at(q * V);
      float t[V], d[V];
      load_vec<V>(x + off, t);
      load_vec<V>(dout + off, d);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        bwd_terms<A>(t[e], d[e], mean, rstd, g, bt);
        d[e] = scale * (d[e] - dbeta_n - t[e] * dgamma_n);
      }
      store_vec<V>(dx + off, d);
    }
  }
  if (rank == 0 && threadIdx.x == 0) {
    dgamma_out[c] = tot.y;
    dbeta_out[c] = tot.x;
  }
  cluster_sum2_wait();
}

// One launch of nc clusters of `cluster` blocks of `kernel` on `stream`;
// returns the launch's error, or cudaGetLastError() after it.
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), int nc, int cluster,
                    cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)nc * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <int A>
int launch_fwd(const float* x, const float* gamma, const float* beta,
               float* out, float* mean, float* var, int nb, int nc, int nl,
               float eps, int cluster, cudaStream_t s) {
  switch (vec_width(nl, reinterpret_cast<size_t>(x) |
                            reinterpret_cast<size_t>(out))) {
    case 4:
      return launch_clusters(bn_act_fwd_cluster_kernel<A, 4>, nc, cluster, s,
                             x, gamma, beta, out, mean, var, nb, nc, nl, eps);
    case 2:
      return launch_clusters(bn_act_fwd_cluster_kernel<A, 2>, nc, cluster, s,
                             x, gamma, beta, out, mean, var, nb, nc, nl, eps);
    default:
      return launch_clusters(bn_act_fwd_cluster_kernel<A, 1>, nc, cluster, s,
                             x, gamma, beta, out, mean, var, nb, nc, nl, eps);
  }
}

template <int A>
int launch_bwd(const float* x, const float* gamma, const float* beta,
               const float* mean, const float* var, const float* dout,
               float* dx, float* dgamma, float* dbeta, int nb, int nc,
               int nl, float eps, int cluster, cudaStream_t s) {
  switch (vec_width(nl, reinterpret_cast<size_t>(x) |
                            reinterpret_cast<size_t>(dout) |
                            reinterpret_cast<size_t>(dx))) {
    case 4:
      return launch_clusters(bn_act_bwd_cluster_kernel<A, 4>, nc, cluster, s,
                             x, gamma, beta, mean, var, dout, dx, dgamma,
                             dbeta, nb, nc, nl, eps);
    case 2:
      return launch_clusters(bn_act_bwd_cluster_kernel<A, 2>, nc, cluster, s,
                             x, gamma, beta, mean, var, dout, dx, dgamma,
                             dbeta, nb, nc, nl, eps);
    default:
      return launch_clusters(bn_act_bwd_cluster_kernel<A, 1>, nc, cluster, s,
                             x, gamma, beta, mean, var, dout, dx, dgamma,
                             dbeta, nb, nc, nl, eps);
  }
}

// One element of the eval epilogue, in the eager chain's order and
// rounding.
template <int A>
__device__ __forceinline__ float eval_epilogue(float v, float bias,
                                              float mean, float mul,
                                              float beta) {
  return act<A>(
      __fadd_rn(__fmul_rn(__fsub_rn(__fadd_rn(v, bias), mean), mul), beta));
}

struct EvalParams {
  const float* __restrict__ bias;
  const float* __restrict__ mean;
  const float* __restrict__ mul;
  const float* __restrict__ beta;
  unsigned nc, nl;
};

// One vector of V elements a thread (L % V == 0, so a vector lies in one
// row: one channel).  x and out may be the same array (in place): each
// element is read once, by the thread that writes it, before it writes it.
template <int A, int V>
__global__ void __launch_bounds__(kThreads)
    bn_act_eval_kernel(const float* x, float* out, EvalParams p,
                       unsigned n) {
  const unsigned q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= n / V) return;
  const unsigned c = q * V / p.nl % p.nc;
  const float b = __ldg(p.bias + c), m = __ldg(p.mean + c),
              k = __ldg(p.mul + c), s = __ldg(p.beta + c);
  float v[V];
  load_vec<V>(x + (size_t)q * V, v);
#pragma unroll
  for (int e = 0; e < V; ++e) v[e] = eval_epilogue<A>(v[e], b, m, k, s);
  store_vec<V>(out + (size_t)q * V, v);
}

template <int A, int V>
int launch_eval_v(const float* x, float* out, const EvalParams& p,
                  unsigned n, cudaStream_t stream) {
  bn_act_eval_kernel<A, V><<<(n / V + kThreads - 1) / kThreads, kThreads, 0,
                             stream>>>(x, out, p, n);
  return (int)cudaGetLastError();
}

template <int A>
int launch_eval(const float* x, float* out, const EvalParams& p, unsigned n,
                cudaStream_t stream) {
  switch (vec_width(p.nl, addr_bits(x) | addr_bits(out))) {
    case 4:
      return launch_eval_v<A, 4>(x, out, p, n, stream);
    case 2:
      return launch_eval_v<A, 2>(x, out, p, n, stream);
    default:
      return launch_eval_v<A, 1>(x, out, p, n, stream);
  }
}

bool bad_shape(int nb, int nc, int nl, int act, int cluster) {
  return nb < 1 || nc < 1 || nl < 1 || act < kElu || act > kNone ||
         cluster < 1 || cluster > 8;
}

}  // namespace

extern "C" {

// x, out (B, C, L); gamma, beta, mean, var (C,).  One launch of C
// clusters of `cluster` (1-8) blocks on `stream`; returns the launch's
// error, or cudaGetLastError() after it (0 = ok).
int bn_act_fwd_f32(const float* x, const float* gamma, const float* beta,
                   float* out, float* mean, float* var, int nb, int nc,
                   int nl, float eps, int act, int cluster, void* stream) {
  if (bad_shape(nb, nc, nl, act, cluster)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (act) {
    case kElu:
      return launch_fwd<kElu>(x, gamma, beta, out, mean, var, nb, nc, nl, eps,
                              cluster, s);
    case kGelu:
      return launch_fwd<kGelu>(x, gamma, beta, out, mean, var, nb, nc, nl,
                               eps, cluster, s);
    default:
      return launch_fwd<kNone>(x, gamma, beta, out, mean, var, nb, nc, nl,
                               eps, cluster, s);
  }
}

// x, dout, dx (B, C, L); gamma, beta, mean, var, dgamma, dbeta (C,).  The
// same launch as the forward's.
int bn_act_bwd_f32(const float* x, const float* gamma, const float* beta,
                   const float* mean, const float* var, const float* dout,
                   float* dx, float* dgamma, float* dbeta, int nb, int nc,
                   int nl, float eps, int act, int cluster, void* stream) {
  if (bad_shape(nb, nc, nl, act, cluster)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (act) {
    case kElu:
      return launch_bwd<kElu>(x, gamma, beta, mean, var, dout, dx, dgamma,
                              dbeta, nb, nc, nl, eps, cluster, s);
    case kGelu:
      return launch_bwd<kGelu>(x, gamma, beta, mean, var, dout, dx, dgamma,
                               dbeta, nb, nc, nl, eps, cluster, s);
    default:
      return launch_bwd<kNone>(x, gamma, beta, mean, var, dout, dx, dgamma,
                               dbeta, nb, nc, nl, eps, cluster, s);
  }
}

// x, out (B, C, L), out == x for the in-place call; bias, mean, mul, beta
// (C,).  One launch on `stream`; returns the launch's error, or
// cudaGetLastError() after it (0 = ok).  The kernel indexes in 32 bits:
// a batch of more than 2^31 - 1 elements is refused, and the caller
// launches it a slice of rows at a time (ops/bn.py, K9_MAX_ELEMENTS).
int bn_act_eval_f32(const float* x, const float* bias, const float* mean,
                    const float* mul, const float* beta, float* out, int nb,
                    int nc, int nl, int act, void* stream) {
  if (bad_shape(nb, nc, nl, act, 1) ||
      (long long)nb * nc * nl > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const EvalParams p{bias, mean, mul, beta, (unsigned)nc, (unsigned)nl};
  const unsigned n = (unsigned)nb * nc * nl;
  switch (act) {
    case kElu:
      return launch_eval<kElu>(x, out, p, n, s);
    case kGelu:
      return launch_eval<kGelu>(x, out, p, n, s);
    default:
      return launch_eval<kNone>(x, out, p, n, s);
  }
}

}  // extern "C"
