// Fused multi-class SIMCA scoring: Hotelling T^2 and Q residual of every
// spectrum against C class models, in one read of the spectra.
//
// Replaces the TPU kernel t2_q_scores_pallas (ocm_tpu/ops/kernels.py:45),
// which scores one class per call; this kernel computes the same function
// for all C classes at once:
//
//   xc_c = x - m_c                       (centered directly, never through
//                                         ||x||^2 - 2 x.m + ||m||^2, which
//                                         cancels on raw spectra)
//   t_c  = xc_c . P_c^T                  (k scores)
//   T2_c = t_c . invcov_c . t_c^T
//   Q_c  = max(||xc_c||^2 - ||t_c||^2, 0)
//
// Inputs (f32, contiguous): x (N, L), means (C, L), loadings (C, k, L),
// invcovs (C, k, k).  Outputs: t2 (C, N), q (C, N).  Nothing of size
// (N, L) or (N, k) goes back to device memory.
//
// What bounds it on an H100: the spectra are read once (4 N L bytes) and
// each element feeds C (k + 1) multiply-adds, so at the bench shapes
// (N = 98304, L = 500, C = 3, k = 10) the bytes (~59 us at 3.35 TB/s) and
// the f32 CUDA-core operations (~51 us at 67 TFLOP/s) are about balanced.
// The design spends as few instructions per multiply-add as it can:
//
// - one thread per spectrum, a block per tile of up to 128 spectra; the
//   tile's x is staged through shared memory in chunks of 64 columns by
//   coalesced 16-byte loads (each x element read from device memory once);
// - each thread keeps all the t_cj and ||xc_c||^2 partial sums of its
//   spectrum in registers: the loop over the k loadings is unrolled at
//   compile time (one instantiation per k up to 32), so a class costs one
//   centering per column and then only broadcast 16-byte shared-memory
//   reads of four loading columns and four FMAs per loading row;
// - no cross-thread reduction: a thread ends with whole sums, writes them
//   to its own column of shared memory and forms T^2 through invcov and
//   clamps Q there.
//
// Measured (PERF.md): ~0.34 ms at the bench shapes on an H100 SXM, about
// a sixth of the bound's speed.  By instruction count it could issue in
// ~0.08 ms, so it waits, most likely on its synchronous staging (load,
// barrier, compute: a block stalls on device memory once per chunk); more
// resident blocks helped where shared memory allowed them.  cp.async
// double buffering of the chunks is the next step toward the bound.
//
// Any C and k: the classes of a block are those of one blockIdx.y group
// (as many as fit kMaxAcc accumulators); above k = 32 the loadings of a
// class are split into tasks of 32 rows, run in passes that re-stage the
// tile's x.  Ragged N and L are zero-padded in shared memory only; x rows
// that are not 16-byte aligned are staged with scalar loads.
//
// bf16 input (the serving scorer's half-width residuals, store_dtype
// bfloat16): the kernel is templated on the type of x.  A bf16 x is read
// at 2 bytes an element and widened to f32 (exactly: a bf16 is the top
// half of an f32) as it is staged, so shared memory, the inner loops,
// means, loadings, T^2 and Q are the f32 kernel's.  Its bound halves
// (98,304 x 500 x 2 B = 98.3 MB, 0.029 ms at 3.35 TB/s).  A bf16 row of
// L = 500 is 1000 bytes, only 8-byte aligned, so bf16 rows are staged with
// 8-byte loads of four values where L % 4 == 0 and the base is 8-byte
// aligned, else value by value.

#include <cuda_runtime.h>

#include <array>
#include <cstdint>
#include <utility>

namespace {

using bf16_bits = uint16_t;             // a bfloat16, as its 16 bits

constexpr int kMaxKB = 32;              // loading rows per task, at most
constexpr int kMaxAcc = 36;             // accumulators per thread
constexpr int kLC = 64;                 // columns of L per staged chunk
constexpr int kGroups = kLC / 4;        // 16-byte column groups per chunk
constexpr int kXStride = kLC + 4;       // padded x row: conflict-free reads
constexpr int kMaxRows = 128;           // spectra (threads) per block

// Tasks (class, block of KB loading rows) whose sums one thread holds.
__host__ __device__ constexpr int tasks_per_pass(int kb) {
  return kMaxAcc / (kb + 1) > 0 ? kMaxAcc / (kb + 1) : 1;
}

template <typename XT>
struct Params {
  const XT* x;
  const float* means;
  const float* comps;
  const float* invcovs;
  float* t2;
  float* q;
  int n, l, c, k;
  int classes_per_group;   // classes of one blockIdx.y
  int tasks_per_class;     // ceil(k / KB)
  int xvec;                // x rows aligned for 4-value vector loads
  int wvec;                // means and loadings 16-byte aligned: float4
};

__device__ __forceinline__ float4 load4(const float* src, int ncols, bool vec) {
  if (vec && ncols >= 4) return __ldg(reinterpret_cast<const float4*>(src));
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (ncols > 0) v.x = __ldg(src);
  if (ncols > 1) v.y = __ldg(src + 1);
  if (ncols > 2) v.z = __ldg(src + 2);
  if (ncols > 3) v.w = __ldg(src + 3);
  return v;
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// Four bf16 values widened to f32: one 8-byte load where aligned.
__device__ __forceinline__ float4 load4(const bf16_bits* src, int ncols,
                                        bool vec) {
  if (vec && ncols >= 4) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(src));
    return make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y), bf16_hi(u.y));
  }
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (ncols > 0) v.x = bf16_lo(__ldg(src));
  if (ncols > 1) v.y = bf16_lo(__ldg(src + 1));
  if (ncols > 2) v.z = bf16_lo(__ldg(src + 2));
  if (ncols > 3) v.w = bf16_lo(__ldg(src + 3));
  return v;
}

// Stage columns [l0, l0 + clen) of the tile's spectra, of the loading rows
// of tasks [first, first + nt) and of their classes' means; zeros elsewhere.
template <typename XT, int KB>
__device__ void stage(const Params<XT>& p, float* xs, float* ws, float* ms,
                      int row0, int c0, int first, int nt, int l0, int clen) {
  const int g = threadIdx.x % kGroups, col = 4 * g;
  const int r0 = threadIdx.x / kGroups, rstep = blockDim.x / kGroups;
  const int ncols = clen - col;
  const bool xvec = p.xvec != 0, vec = p.wvec != 0;
  for (int r = r0; r < blockDim.x; r += rstep) {
    const int row = row0 + r;
    const float4 v = row < p.n
        ? load4(p.x + (size_t)row * p.l + l0 + col, ncols, xvec)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(xs + r * kXStride + col) = v;
  }
  for (int r = r0; r < nt * KB; r += rstep) {
    const int t = r / KB, task = first + t, cls = task / p.tasks_per_class;
    const int j = (task - cls * p.tasks_per_class) * KB + (r - t * KB);
    const float4 v = j < p.k
        ? load4(p.comps + ((size_t)(c0 + cls) * p.k + j) * p.l + l0 + col,
                ncols, vec)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(ws + r * kLC + col) = v;
  }
  for (int t = r0; t < nt; t += rstep) {
    const int cls = (first + t) / p.tasks_per_class;
    *reinterpret_cast<float4*>(ms + t * kLC + col) =
        load4(p.means + (size_t)(c0 + cls) * p.l + l0 + col, ncols, vec);
  }
}

template <typename XT, int KB>
__global__ void __launch_bounds__(kMaxRows) t2q_kernel(Params<XT> p) {
  constexpr int T = tasks_per_pass(KB);
  extern __shared__ __align__(16) float smem[];
  const int rows = blockDim.x, tid = threadIdx.x;
  const int row0 = blockIdx.x * rows, row = row0 + tid;
  const int kp1 = p.k + 1;
  const int c0 = blockIdx.y * p.classes_per_group;
  const int ncls = min(p.c, c0 + p.classes_per_group) - c0;
  const int ntasks = ncls * p.tasks_per_class;

  float* xs = smem;                        // [rows][kXStride]
  float* ws = xs + rows * kXStride;        // [T * KB][kLC]
  float* ms = ws + T * KB * kLC;           // [T][kLC]
  float* res = ms + T * kLC;               // [ncls * (k + 1)][rows]

  for (int first = 0; first < ntasks; first += T) {
    const int nt = min(T, ntasks - first);
    float acc[T][KB + 1];
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
      for (int j = 0; j <= KB; ++j) acc[t][j] = 0.f;

    for (int l0 = 0; l0 < p.l; l0 += kLC) {
      const int clen = min(kLC, p.l - l0);
      __syncthreads();                     // the last chunk's reads are done
      stage<XT, KB>(p, xs, ws, ms, row0, c0, first, nt, l0, clen);
      __syncthreads();
      const float* xr = xs + tid * kXStride;
#pragma unroll 1
      for (int col = 0; col < clen; col += 4) {
        const float4 xv = *reinterpret_cast<const float4*>(xr + col);
#pragma unroll
        for (int t = 0; t < T; ++t) {
          if (t < nt) {
            const float4 m = *reinterpret_cast<const float4*>(ms + t * kLC + col);
            const float d0 = xv.x - m.x, d1 = xv.y - m.y;
            const float d2 = xv.z - m.z, d3 = xv.w - m.w;
#pragma unroll
            for (int j = 0; j < KB; ++j) {
              const float4 w =
                  *reinterpret_cast<const float4*>(ws + (t * KB + j) * kLC + col);
              float a = fmaf(d0, w.x, acc[t][j]);
              a = fmaf(d1, w.y, a);
              a = fmaf(d2, w.z, a);
              acc[t][j] = fmaf(d3, w.w, a);
            }
            float a = fmaf(d0, d0, acc[t][KB]);
            a = fmaf(d1, d1, a);
            a = fmaf(d2, d2, a);
            acc[t][KB] = fmaf(d3, d3, a);
          }
        }
      }
    }

    // this pass's sums to the thread's own column of `res`
#pragma unroll
    for (int t = 0; t < T; ++t) {
      if (t < nt) {
        const int task = first + t, cls = task / p.tasks_per_class;
        const int j0 = (task - cls * p.tasks_per_class) * KB;
        float* out = res + (size_t)cls * kp1 * rows + tid;
#pragma unroll
        for (int j = 0; j < KB; ++j)
          if (j0 + j < p.k) out[(j0 + j) * rows] = acc[t][j];
        if (j0 == 0) out[p.k * rows] = acc[t][KB];
      }
    }
  }

  if (row >= p.n) return;
  for (int cls = 0; cls < ncls; ++cls) {
    const float* t = res + (size_t)cls * kp1 * rows + tid;   // t_c, ||xc_c||^2
    const float* a = p.invcovs + (size_t)(c0 + cls) * p.k * p.k;
    float t2 = 0.f, tt = 0.f;
    for (int i = 0; i < p.k; ++i) {
      const float ti = t[i * rows];
      float u = 0.f;
      for (int j = 0; j < p.k; ++j) u = fmaf(__ldg(a + i * p.k + j), t[j * rows], u);
      t2 = fmaf(ti, u, t2);
      tt = fmaf(ti, ti, tt);
    }
    const size_t o = (size_t)(c0 + cls) * p.n + row;
    p.t2[o] = t2;
    p.q[o] = fmaxf(t[p.k * rows] - tt, 0.f);
  }
}

template <typename XT, int KB>
int launch(const Params<XT>& p, int rows, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      t2q_kernel<XT, KB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.n + rows - 1) / rows,
                  (p.c + p.classes_per_group - 1) / p.classes_per_group);
  t2q_kernel<XT, KB><<<grid, rows, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename XT>
using Launcher = int (*)(const Params<XT>&, int, int, cudaStream_t);

template <typename XT, int... I>
constexpr std::array<Launcher<XT>, sizeof...(I)> launchers(
    std::integer_sequence<int, I...>) {
  return {{&launch<XT, I + 1>...}};
}

template <typename XT>
constexpr std::array<Launcher<XT>, kMaxKB> kLaunchers =
    launchers<XT>(std::make_integer_sequence<int, kMaxKB>{});

template <typename XT>
int scores(const XT* x, const float* means, const float* comps,
           const float* invcovs, float* t2, float* q, int n, int l, int c,
           int k, void* stream) {
  const int kb = k < kMaxKB ? k : kMaxKB;
  const int tpc = (k + kb - 1) / kb;
  const int per_pass = tasks_per_pass(kb);
  Params<XT> p{x, means, comps, invcovs, t2, q, n, l, c, k,
               tpc == 1 ? (c < per_pass ? c : per_pass) : 1, tpc, 0, 0};
  const auto aligned = [](const void* ptr, size_t bytes) {
    return reinterpret_cast<size_t>(ptr) % bytes == 0;
  };
  p.xvec = l % 4 == 0 && aligned(x, 4 * sizeof(XT));
  p.wvec = l % 4 == 0 && aligned(means, 16) && aligned(comps, 16);

  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  // halve the tile until the staging and every spectrum's sums fit
  const int floats_per_row = kXStride + p.classes_per_group * (k + 1);
  const int staged = per_pass * (kb + 1) * kLC;
  int rows = kMaxRows;
  while (rows > 32 && (size_t)4 * (rows * floats_per_row + staged) > (size_t)smem_max)
    rows /= 2;
  const size_t smem = (size_t)4 * (rows * floats_per_row + staged);
  if (smem > (size_t)smem_max) return (int)cudaErrorInvalidValue;
  return kLaunchers<XT>[kb - 1](p, rows, (int)smem, (cudaStream_t)stream);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
int t2q_scores_multiclass_f32(const float* x, const float* means,
                              const float* comps, const float* invcovs,
                              float* t2, float* q, int n, int l, int c, int k,
                              void* stream) {
  return scores(x, means, comps, invcovs, t2, q, n, l, c, k, stream);
}

// The same with x in bfloat16 (its 16 bits); everything else f32.
int t2q_scores_multiclass_bf16(const bf16_bits* x, const float* means,
                               const float* comps, const float* invcovs,
                               float* t2, float* q, int n, int l, int c, int k,
                               void* stream) {
  return scores(x, means, comps, invcovs, t2, q, n, l, c, k, stream);
}

}  // extern "C"
