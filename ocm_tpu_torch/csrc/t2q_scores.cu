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
// Inputs (contiguous): x (N, L) f32 or bf16, means (C, L), loadings (C,
// k, L), invcovs (C, k, k) f32.  Outputs: t2 (C, N), q (C, N) f32.
// Nothing of size (N, L) or (N, k) goes back to device memory.
//
// What bounds it on an H100: the spectra are read once (4 N L bytes, 2 in
// bf16) and each element feeds C (k + 1) f32 multiply-adds on the CUDA
// cores (no tensor-core product: reduced-precision products collapse the
// jm Q limits), so at the bench shapes (N = 98304, L = 500, C = 3, k = 10)
// the bytes (~59 us at 3.35 TB/s) and the operations (~51 us at 67
// TFLOP/s) are about balanced, and in bf16 the operations bound it.  The
// design keeps both streams busy at once:
//
// - persistent: one CTA an SM (ops.kernels.k1_plan), up to 12 warps; each
//   warp owns units of 64 spectra (two a lane, rows lane and lane + 32),
//   taken in turn over the grid, so the 1,536 units of the bench shapes
//   fill 1,584 warp slots in one wave and no tail wave is left;
// - resident models: the means and loadings of every class are copied
//   into shared memory once a CTA (66 KB at the bench shapes), laid out as
//   tasks of KB loading rows and their class's mean, rows zero past k;
// - pipelined x: each warp streams its 64 rows through its own ring of
//   2-4 chunks of 16 columns by cp.async (16-byte copies of four f32, or
//   8-byte copies of four bf16: a bf16 row of L = 500 is only 8-byte
//   aligned), chunk i + stages - 1 in flight while chunk i is computed;
//   no barrier but __syncwarp after the first staging;
// - registers: a lane keeps every t_cj and ||xc_c||^2 of its two spectra
//   (the loop over the KB loading rows unrolled at compile time, one
//   instantiation per KB up to 32), so each broadcast 16-byte read of a
//   loading feeds 8 FMAs; T^2 is formed from those registers through
//   invcov held in shared memory, and Q clamped, with no cross-thread
//   reduction.
//
// Any C and k: a pass holds tasks_per_pass(KB) tasks (class, block of up
// to 32 loading rows) of 36 / (KB + 1) sums a spectrum; more tasks run in
// more passes over the unit's x.  Above k = 32 a class is several tasks;
// each pass parks its scores in the warp's own shared-memory columns and
// the class's last task forms T^2 from them.  Where the models do not fit
// in shared memory (k1_plan's `resident` false, e.g. C 5, k 12, L 2000),
// the CTA stages a window of model columns for the pass's tasks at a time,
// between two barriers, and the warps stream x through that window.  An
// invcov too large for shared memory is read from device memory.  Ragged N
// and L are zero-filled in shared memory; x rows that are not aligned for
// the vector copies are staged value by value, synchronously.
//
// Measured (PERF.md §6, NVIDIA H100 80GB HBM3, 700 W): 0.143 ms at the
// bench shapes, 0.111 at 65,536 rows, bf16 0.107; the first design (one
// thread a spectrum, a block a tile staged synchronously) took 0.31.  That
// is about half the rate at which its instructions could issue, and more
// than device memory needs.  Designs that feed more multiply-adds a
// shared-memory read (four spectra a lane; one class a lane for seven or
// eight spectra) ran slower, 0.149-0.17 ms, at fewer warps a scheduler or
// with spills: under the 168 registers of 12 warps, latency is the likelier
// limit.

#include <cuda_runtime.h>

#include <array>
#include <cstdint>
#include <utility>

namespace {

using bf16_bits = uint16_t;             // a bfloat16, as its 16 bits

constexpr int kMaxKB = 32;              // loading rows a task, at most
constexpr int kMaxAcc = 36;             // sums a spectrum holds in a pass
constexpr int kR = 2;                   // spectra a lane
constexpr int kUnit = 32 * kR;          // spectra a warp's unit
constexpr int kCW = 16;                 // columns of x a chunk
constexpr int kXS = kCW + 4;            // padded chunk row: conflict-free
constexpr int kMaxWarps = 12;
constexpr int kMinStages = 2, kMaxStages = 4;

// Tasks (class, block of KB loading rows) whose sums one spectrum holds.
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
  int lp;              // l rounded up to kCW
  int tpc;             // tasks a class: ceil(k / KB)
  int ntasks, passes, units;
  int stages;
  int resident;        // every task's model in shared memory, staged once
  int window;          // model columns staged at once (lp when resident)
  int xvec;            // x rows aligned for copies of four values
  int wvec;            // means and loadings 16-byte aligned, L % 4 == 0
  int icov_shared;     // invcov copied to shared memory
  int icov_off, ring_off, res_off;   // shared-memory layout, bytes
  int ring_bytes, res_bytes;         // a warp's ring and score columns
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy of `bytes` (4, 8 or 16) global bytes into shared memory, the first
// `valid` of them from src and the rest zero.
template <int bytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const uint32_t n = valid ? bytes : 0;
  if constexpr (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(bytes), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Wait until at most `pending` (stages - 1: 1-3) groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending >= 3)
    asm volatile("cp.async.wait_group 3;" ::: "memory");
  else if (pending == 2)
    asm volatile("cp.async.wait_group 2;" ::: "memory");
  else
    asm volatile("cp.async.wait_group 1;" ::: "memory");
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// Four consecutive staged values of x as f32 (bf16 widened exactly: a
// bf16 is the top half of an f32).
__device__ __forceinline__ float4 load_x4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load_x4(const bf16_bits* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y), bf16_hi(u.y));
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// The whole CTA: stage model columns [w0, w0 + wlen) of tasks [first,
// first + nt) into `model` (row stride p.window): a task's KB loading rows
// (zero past k), then its class's mean; zero past L.  Asynchronous where
// aligned: the caller waits (cp_async_wait_all) and then syncs the CTA.
template <typename XT, int KB>
__device__ void stage_model(const Params<XT>& p, float* model, int first,
                            int nt, int w0, int wlen) {
  const int groups = wlen / 4, total = nt * (KB + 1) * groups;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int r = idx / groups, g = idx - r * groups;
    const int t = r / (KB + 1), j = r - t * (KB + 1);
    const int task = first + t, cls = task / p.tpc;
    const int row = (task - cls * p.tpc) * KB + j;     // loading row
    const int col = w0 + 4 * g;
    const float* src = j == KB ? p.means + (size_t)cls * p.l + col
                               : p.comps + ((size_t)cls * p.k + row) * p.l + col;
    const bool real = j == KB || row < p.k;
    float* dst = model + (size_t)r * p.window + 4 * g;
    if (p.wvec) {
      const bool valid = real && col < p.l;
      cp_async<16>(dst, valid ? src : p.means, valid);
    } else {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (real) {
        if (col < p.l) v.x = src[0];
        if (col + 1 < p.l) v.y = src[1];
        if (col + 2 < p.l) v.z = src[2];
        if (col + 3 < p.l) v.w = src[3];
      }
      *reinterpret_cast<float4*>(dst) = v;
    }
  }
}

// One lane's share of staging columns [col0, col0 + kCW) of the warp's
// 64 rows into a ring slot: cp.async of four values where x is aligned
// for it, else value by value; rows past N and columns past L are zero.
template <typename XT>
__device__ __forceinline__ void issue_chunk(const Params<XT>& p, XT* slot,
                                            int row0, int col0) {
  constexpr int G = kCW / 4;                 // groups of four a row
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int idx = lane; idx < kUnit * G; idx += 32) {
    const int r = idx / G, g = idx - r * G;
    const int row = row0 + r, col = col0 + 4 * g;
    XT* dst = slot + r * kXS + 4 * g;
    const XT* src = p.x + (size_t)min(row, p.n - 1) * p.l + col;
    if (p.xvec) {
      const bool valid = row < p.n && col < p.l;
      cp_async<(int)(4 * sizeof(XT))>(dst, valid ? src : p.x, valid);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dst[e] = row < p.n && col + e < p.l ? src[e] : XT(0);
    }
  }
}

// Stream the window [w0, w0 + wlen) of the unit's x through the warp's
// ring and add every task's sums.  `mbase` is column w0 of the first
// task's model rows (stride p.window).
template <typename XT, int KB, int T>
__device__ __forceinline__ void stream_window(
    const Params<XT>& p, XT* ring, const float* mbase, int row0, int w0,
    int wlen, int nt, float (&acc)[kR][T][KB + 1]) {
  constexpr int slot = kUnit * kXS;
  const int lane = threadIdx.x & 31, ms = p.window;
  const int chunks = wlen / kCW;
  for (int i = 0; i < p.stages - 1; ++i) {
    if (i < chunks) issue_chunk(p, ring + i * slot, row0, w0 + i * kCW);
    cp_async_commit();
  }
  for (int i = 0; i < chunks; ++i) {
    const int ahead = i + p.stages - 1;
    if (ahead < chunks)
      issue_chunk(p, ring + (ahead % p.stages) * slot, row0, w0 + ahead * kCW);
    cp_async_commit();
    cp_async_wait(p.stages - 1);
    __syncwarp();                            // every lane's copies landed
    const XT* xa = ring + (i % p.stages) * slot + lane * kXS;
    const XT* xb = xa + 32 * kXS;
    const float* mc = mbase + i * kCW;
#pragma unroll 1
    for (int g = 0; g < kCW; g += 4) {
      const float4 va = load_x4(xa + g), vb = load_x4(xb + g);
#pragma unroll
      for (int t = 0; t < T; ++t) {
        if (t < nt) {
          const float* mt = mc + (size_t)t * (KB + 1) * ms + g;
          const float4 m = lds4(mt + (size_t)KB * ms);
          const float4 da = make_float4(va.x - m.x, va.y - m.y, va.z - m.z,
                                        va.w - m.w);
          const float4 db = make_float4(vb.x - m.x, vb.y - m.y, vb.z - m.z,
                                        vb.w - m.w);
#pragma unroll
          for (int j = 0; j < KB; ++j) {
            const float4 w = lds4(mt + (size_t)j * ms);
            acc[0][t][j] = dot4(da, w, acc[0][t][j]);
            acc[1][t][j] = dot4(db, w, acc[1][t][j]);
          }
          acc[0][t][KB] = dot4(da, da, acc[0][t][KB]);
          acc[1][t][KB] = dot4(db, db, acc[1][t][KB]);
        }
      }
    }
    __syncwarp();                            // the slot may be refilled
  }
}

__device__ __forceinline__ void store_scores(float t2, float* t2_out,
                                             float* q_out, float xc2,
                                             float tt, int n, int cls,
                                             int row) {
  if (row >= n) return;
  const size_t o = (size_t)cls * n + row;
  t2_out[o] = t2;
  q_out[o] = fmaxf(xc2 - tt, 0.f);
}

// T^2 and Q of the pass's classes for the lane's two spectra.
template <typename XT, int KB, int T>
__device__ __forceinline__ void epilogue(const Params<XT>& p,
                                         const float* icov, float* res,
                                         const float (&acc)[kR][T][KB + 1],
                                         int row0, int first, int nt) {
  const int lane = threadIdx.x & 31;
  if (p.tpc == 1) {              // KB == k: a task is a class, in registers
#pragma unroll
    for (int t = 0; t < T; ++t) {
      if (t >= nt) continue;
      const int cls = first + t;
      const float* a = icov + (size_t)cls * KB * KB;
      float t2[kR] = {}, tt[kR] = {};
#pragma unroll
      for (int i = 0; i < KB; ++i) {
        float u[kR] = {};
#pragma unroll
        for (int j = 0; j < KB; ++j) {
          const float aij = a[i * KB + j];
#pragma unroll
          for (int s = 0; s < kR; ++s) u[s] = fmaf(aij, acc[s][t][j], u[s]);
        }
#pragma unroll
        for (int s = 0; s < kR; ++s) {
          t2[s] = fmaf(acc[s][t][i], u[s], t2[s]);
          tt[s] = fmaf(acc[s][t][i], acc[s][t][i], tt[s]);
        }
      }
#pragma unroll
      for (int s = 0; s < kR; ++s)
        store_scores(t2[s], p.t2, p.q, acc[s][t][KB], tt[s], p.n, cls,
                     row0 + 32 * s + lane);
    }
  } else if constexpr (KB == kMaxKB) {
    // k > 32, so one task a pass: block b of class cls's loading rows;
    // park its scores in the lane's own columns, and after the class's
    // last block form T^2 from them
    const int cls = first / p.tpc, b = first - cls * p.tpc, j0 = b * KB;
#pragma unroll
    for (int s = 0; s < kR; ++s)
#pragma unroll
      for (int j = 0; j < KB; ++j)
        if (j0 + j < p.k) res[(j0 + j) * kUnit + 32 * s + lane] = acc[s][0][j];
    if (b != p.tpc - 1) return;
    const float* a = icov + (size_t)cls * p.k * p.k;
    for (int s = 0; s < kR; ++s) {
      const float* ts = res + 32 * s + lane;
      float t2 = 0.f, tt = 0.f;
      for (int i = 0; i < p.k; ++i) {
        const float ti = ts[i * kUnit];
        float u = 0.f;
        for (int j = 0; j < p.k; ++j) u = fmaf(a[i * p.k + j], ts[j * kUnit], u);
        t2 = fmaf(ti, u, t2);
        tt = fmaf(ti, ti, tt);
      }
      store_scores(t2, p.t2, p.q, acc[s][0][KB], tt, p.n, cls,
                   row0 + 32 * s + lane);
    }
  }
}

template <typename XT, int KB>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
    t2q_kernel(const Params<XT> p) {
  constexpr int T = tasks_per_pass(KB);
  extern __shared__ __align__(16) unsigned char smem[];
  float* model = reinterpret_cast<float*>(smem);
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  XT* ring = reinterpret_cast<XT*>(smem + p.ring_off + warp * p.ring_bytes);
  float* res = reinterpret_cast<float*>(smem + p.res_off + warp * p.res_bytes);
  float* icov_s = reinterpret_cast<float*>(smem + p.icov_off);
  const float* icov = p.icov_shared ? icov_s : p.invcovs;

  if (p.icov_shared)
    for (int i = threadIdx.x; i < p.c * p.k * p.k; i += blockDim.x)
      icov_s[i] = p.invcovs[i];
  if (p.resident) stage_model<XT, KB>(p, model, 0, p.ntasks, 0, p.lp);
  cp_async_wait_all();
  __syncthreads();

  // unit u = blockIdx.x + gridDim.x (warp + warps round): the grid's
  // warps take units in turn, every CTA's first warps first
  for (int base = blockIdx.x; base < p.units; base += gridDim.x * warps) {
    const int unit = base + gridDim.x * warp;
    const bool active = unit < p.units;
    const int row0 = unit * kUnit;
    for (int pass = 0; pass < p.passes; ++pass) {
      const int first = pass * T, nt = min(T, p.ntasks - first);
      float acc[kR][T][KB + 1];
#pragma unroll
      for (int s = 0; s < kR; ++s)
#pragma unroll
        for (int t = 0; t < T; ++t)
#pragma unroll
          for (int j = 0; j <= KB; ++j) acc[s][t][j] = 0.f;
      for (int w0 = 0; w0 < p.lp; w0 += p.window) {
        const int wlen = min(p.window, p.lp - w0);
        if (!p.resident) {                   // CTA-uniform
          __syncthreads();                   // the last window's reads done
          stage_model<XT, KB>(p, model, first, nt, w0, wlen);
          cp_async_wait_all();
          __syncthreads();
        }
        if (active)
          stream_window<XT, KB, T>(
              p, ring,
              p.resident ? model + (size_t)first * (KB + 1) * p.lp : model,
              row0, w0, wlen, nt, acc);
      }
      if (active) epilogue<XT, KB, T>(p, icov, res, acc, row0, first, nt);
    }
  }
}

int round_up(int v, int to) { return (v + to - 1) / to * to; }

template <typename XT, int KB>
int launch(const Params<XT>& p, int warps, int ctas, int smem,
           cudaStream_t stream) {
  const auto kernel = t2q_kernel<XT, KB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      32 * warps, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  kernel<<<ctas, 32 * warps, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename XT>
using Launcher = int (*)(const Params<XT>&, int, int, int, cudaStream_t);

template <typename XT, int... I>
constexpr std::array<Launcher<XT>, sizeof...(I)> launchers(
    std::integer_sequence<int, I...>) {
  return {{&launch<XT, I + 1>...}};
}

template <typename XT>
constexpr std::array<Launcher<XT>, kMaxKB> kLaunchers =
    launchers<XT>(std::make_integer_sequence<int, kMaxKB>{});

// Lays out shared memory for the plan (ops.kernels.k1_plan) and launches;
// the plan's byte count must equal this layout's.
template <typename XT>
int scores(const XT* x, const float* means, const float* comps,
           const float* invcovs, float* t2, float* q, int n, int l, int c,
           int k, int warps, int stages, int window, int resident,
           int icov_shared, int ctas, int smem, void* stream) {
  if (n < 1 || l < 1 || c < 1 || k < 1 || warps < 1 || warps > kMaxWarps ||
      stages < kMinStages || stages > kMaxStages || window < kCW ||
      window % kCW != 0 || ctas < 1)
    return (int)cudaErrorInvalidValue;
  const int kb = k < kMaxKB ? k : kMaxKB;
  const int per_pass = tasks_per_pass(kb);
  Params<XT> p{};
  p.x = x;
  p.means = means;
  p.comps = comps;
  p.invcovs = invcovs;
  p.t2 = t2;
  p.q = q;
  p.n = n;
  p.l = l;
  p.c = c;
  p.k = k;
  p.lp = round_up(l, kCW);
  p.tpc = (k + kb - 1) / kb;
  p.ntasks = c * p.tpc;
  p.passes = (p.ntasks + per_pass - 1) / per_pass;
  p.units = (n + kUnit - 1) / kUnit;
  p.stages = stages;
  p.resident = resident != 0;
  p.window = window;
  p.icov_shared = icov_shared != 0;
  if (p.resident && window != p.lp) return (int)cudaErrorInvalidValue;
  const auto aligned = [](const void* ptr, size_t bytes) {
    return reinterpret_cast<size_t>(ptr) % bytes == 0;
  };
  p.xvec = l % 4 == 0 && aligned(x, 4 * sizeof(XT));
  p.wvec = l % 4 == 0 && aligned(means, 16) && aligned(comps, 16);
  const int model_tasks = p.resident ? p.ntasks
                                     : (per_pass < p.ntasks ? per_pass
                                                            : p.ntasks);
  p.icov_off = model_tasks * (kb + 1) * window * 4;
  p.ring_off = p.icov_off + (p.icov_shared ? round_up(c * k * k * 4, 16) : 0);
  p.ring_bytes = stages * kUnit * kXS * (int)sizeof(XT);
  p.res_off = p.ring_off + warps * p.ring_bytes;
  p.res_bytes = p.tpc > 1 ? kUnit * k * 4 : 0;
  if (p.res_off + warps * p.res_bytes != smem)
    return (int)cudaErrorInvalidValue;
  return kLaunchers<XT>[kb - 1](p, warps, ctas, smem, (cudaStream_t)stream);
}

}  // namespace

extern "C" {

// Launch on `stream` by the plan (warps a CTA, ring stages, model window,
// resident, invcov in shared memory, CTAs, shared-memory bytes); returns
// cudaGetLastError() after the launch (0 = ok).
int t2q_scores_multiclass_f32(const float* x, const float* means,
                              const float* comps, const float* invcovs,
                              float* t2, float* q, int n, int l, int c, int k,
                              int warps, int stages, int window, int resident,
                              int icov_shared, int ctas, int smem,
                              void* stream) {
  return scores(x, means, comps, invcovs, t2, q, n, l, c, k, warps, stages,
                window, resident, icov_shared, ctas, smem, stream);
}

// The same with x in bfloat16 (its 16 bits); everything else f32.
int t2q_scores_multiclass_bf16(const bf16_bits* x, const float* means,
                               const float* comps, const float* invcovs,
                               float* t2, float* q, int n, int l, int c,
                               int k, int warps, int stages, int window,
                               int resident, int icov_shared, int ctas,
                               int smem, void* stream) {
  return scores(x, means, comps, invcovs, t2, q, n, l, c, k, warps, stages,
                window, resident, icov_shared, ctas, smem, stream);
}

}  // extern "C"
