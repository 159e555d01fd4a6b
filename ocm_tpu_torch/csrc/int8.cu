// The int8 serving tier: a tile-sum read of int8 spectra (K7) and the exact
// s8 x s8 -> s32 product (K8).
//
// K7 int8_tile_sum replaces the TPU probe kernel make_read / read_kernel
// (scripts/probe_pallas_int8.py:60,70, call :72): the int32 sum of every
// (tile, L) block of an (N, L) int8 array, out (N / tile,) int32.  It is a
// bandwidth probe: at the probe's shape (98,304 x 512) it reads 50.3 MB and
// does one add a byte, so bytes bound it (0.0150 ms at 3.35 TB/s).  A tile
// is contiguous (tile * L bytes), so the grid cuts every tile into chunks
// of 32 KB: one block of 256 threads a chunk, each thread eight 16-byte
// loads issued together (coalesced, all in flight before the first add),
// four __dp4a(word, 0x01010101) each, then warp shuffles and shared memory
// reduce the block, and one integer atomicAdd adds it to its tile.  Enough
// blocks to fill 132 SMs at every probe tile (1,536 at tiles 512-2048),
// where one block a tile would leave most SMs idle at tile 2048 (48).
// Integer atomics commute, so the result does not depend on their order.
// Rows whose tile is not 16-byte aligned are read byte by byte.
//
// K8 int8_gemm_s32 replaces make_gemm / gemm_kernel (probe_pallas_int8.py
// :64,84, call :86), and is the product of the int8 scoring op
// (ocm_tpu/ops/linalg.py:426, t2_q_scores_multiclass_int8): out = x w^T for
// x (N, L) and w (M, L) int8, exact int32 arithmetic.  One kernel, two
// epilogues:
// - store (tile = 0): the (N, M) int32 product is written (the scoring op,
//   65,536 x 500 against 66 columns: read 32.8 MB + write 17.3 MB, 0.0150
//   ms at 3.35 TB/s);
// - tile sums (tile > 0): per tile of rows the column sums of the product,
//   reduced in the kernel, (N / tile, M), no (N, M) write (the probe,
//   98,304 x 512 x 128: bytes 50.3 MB -> 0.0150 ms; 12.9 G int8 operations
//   -> 0.0065 ms at the tensor cores' 1,979 TOP/s).
// Both shapes are bound by the bytes of x, and w is tiny (33-64 KB).  The
// design (gemm_s8_mma_kernel) follows from that:
// - w resident in shared memory: each block copies its column tile of w
//   (BN = 16 NT <= 128 columns) once, zero past L and past M, at a row
//   stride of 16 mod 128 bytes (the B fragments' 32-bit loads are free of
//   bank conflicts), and keeps it for its whole life;
// - persistent blocks, one a SM, each over a contiguous range of row tiles
//   of 64 rows, fed through a ring of 2-4 stages by cp.async.bulk (one
//   thread, mbarrier completion).  Consecutive rows of a contiguous (N, L)
//   array are one contiguous span, and 8 L is a multiple of 16, so a tile
//   goes in 8 bulk copies of 8 rows each, although a 500-byte row is only
//   4-byte aligned (2-D TMA cannot describe that array: its global strides
//   are multiples of 16 B).  The pieces land at a stride of 16 mod 128
//   bytes, and fragment row g is taken from piece g (rows 8 g + 2 wm and
//   8 g + 2 wm + 1 of the tile for warp row wm), so the 8 rows of a
//   fragment lie 4 banks apart at any L, where a stride of 512 B (the
//   probe) would put them all in one bank.  (Copies of single rows, 64 a
//   tile from the one issuing thread, made the probe 1.4x slower on an
//   H100.)  A ragged last piece's tail (< 16 B) is copied by the issuing
//   thread before it arrives;
// - the tensor cores, exactly: mma.sync m16n8k32 s8 x s8 -> s32, A
//   fragments read from the staged pieces by 32-bit shared loads, B from
//   the resident w.  8 warps: 4 along the tile's rows x 2 along the columns
//   (NT n8 tiles each);
// - the tail of L needs no mask: the K loop runs to L rounded up to 32, w's
//   copy is zero there, so whatever bytes A reads past a row's end (the
//   next row, a piece's 32-byte pad) multiply zero;
// - epilogues from registers: the store writes 8-byte pairs (a row of 66
//   int32 is 264 B, 8-aligned); the tile sums add each warp's rows in
//   registers while they belong to one output tile (tile % 64 == 0) and
//   issue one integer atomicAdd per (warp, tile, column) when it changes,
//   or one per element for other tiles.
// Every partial sum is exact: |x|, |w| <= 127, so |x w^T| <= 127^2 L, below
// 2^31 for L <= 2^17.  The tile sums add those in unsigned (mod 2^32)
// arithmetic, like the TPU's int32 sums; the plain twin wraps the same way.
//
// The first design, __dp4a on the CUDA cores (gemm_s8_dp4a_kernel, 52 TOP/s
// on an H100: operation-bound where the shapes are byte-bound), stays for
// what the bulk copies cannot take: rows not 4-byte aligned (L % 4 != 0),
// an x not 16-byte or a w not 4-byte aligned, and rows so long that w and
// two stages exceed the 227 KB of shared memory (L above ~1,500).  It
// stages 32-bit words (bytes where rows are not 4-byte aligned) of 64 rows
// x 16 TN columns a block, 128 bytes of L a step.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// --- K7 ----------------------------------------------------------------------

constexpr int kReadThreads = 256;
constexpr int kReadVec = 8;                    // 16-byte loads a thread
constexpr long long kChunk = (long long)kReadThreads * kReadVec * 16;

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int dp4a_sum16(const int4 v, int acc) {
  constexpr int kOnes = 0x01010101;
  acc = __dp4a(v.x, kOnes, acc);
  acc = __dp4a(v.y, kOnes, acc);
  acc = __dp4a(v.z, kOnes, acc);
  return __dp4a(v.w, kOnes, acc);
}

__global__ void __launch_bounds__(kReadThreads)
    tile_sum_kernel(const int8_t* __restrict__ x, int* __restrict__ out,
                    long long tile_bytes, int chunks, int vec) {
  __shared__ int partial[kReadThreads / 32];
  const int tile = blockIdx.x / chunks, chunk = blockIdx.x % chunks;
  const int8_t* base = x + (long long)tile * tile_bytes;
  const long long begin = (long long)chunk * kChunk;
  const long long end = min(begin + kChunk, tile_bytes);
  int acc = 0;
  if (vec && end - begin == kChunk) {
    const int4* src = reinterpret_cast<const int4*>(base + begin);
    int4 v[kReadVec];
#pragma unroll
    for (int i = 0; i < kReadVec; ++i)
      v[i] = __ldcs(src + i * kReadThreads + threadIdx.x);
#pragma unroll
    for (int i = 0; i < kReadVec; ++i) acc = dp4a_sum16(v[i], acc);
  } else if (vec) {
    for (long long off = begin + 16 * threadIdx.x; off < end;
         off += 16 * kReadThreads)
      acc = dp4a_sum16(__ldcs(reinterpret_cast<const int4*>(base + off)), acc);
  } else {
    for (long long off = begin + threadIdx.x; off < end; off += kReadThreads)
      acc += base[off];
  }
  acc = warp_sum_int(acc);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) partial[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kReadThreads / 32 ? partial[lane] : 0;
    acc = warp_sum_int(acc);
    if (lane == 0) atomicAdd(out + tile, acc);
  }
}

// --- K8 on the tensor cores ------------------------------------------------

constexpr int kTileRows = 64;                  // rows of x a staged tile
constexpr int kMmaThreads = 256;               // 4 (rows) x 2 (columns) warps
constexpr int kMaxStages = 4;
constexpr int kBarBytes = 128;                 // the stages' mbarriers

struct MmaParams {
  const int8_t* x;
  const int8_t* w;
  int* out;
  int n, l, m, tile;
  int lp;            // l rounded up to 32: the K loop's extent
  int piece;         // stride of a staged tile's 8-row pieces, bytes
  int wst;           // row stride of the resident w, bytes
  int stages, stage_bytes, w_bytes;
  int tiles;         // row tiles of kTileRows
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count));
}

// One arrival that also expects `bytes` of asynchronous copies.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// Global -> shared bulk copy of `bytes` (a multiple of 16, both ends
// 16-byte aligned), completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a b for one m16n8k32 s8 tile (A row-major, B column-major).
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Thread 0: start the copy of row tile `t` into stage buffer `dst`: its
// 64 rows as 8 pieces of 8 consecutive rows (8 L bytes, 16-byte aligned
// since L % 4 == 0), piece P at P * piece.  A ragged last piece's tail
// (< 16 B) is copied here, before the arrival that releases it.
__device__ void issue_tile(const MmaParams& p, int t, unsigned char* dst,
                           uint64_t* bar) {
  const int row0 = t * kTileRows;
  const int rows = min(kTileRows, p.n - row0);
  const int8_t* src = p.x + (size_t)row0 * p.l;
  uint32_t bulk = 0;
  for (int r = 0; r < rows; r += 8) {
    const uint32_t bytes = min(8, rows - r) * p.l, main = bytes & ~15u;
    for (uint32_t b = main; b < bytes; ++b)
      dst[(r / 8) * p.piece + b] = src[(size_t)r * p.l + b];
    bulk += main;
  }
  mbar_arrive_tx(bar, bulk);
  for (int r = 0; r < rows; r += 8) {
    const uint32_t main = (min(8, rows - r) * p.l) & ~15u;
    if (main)
      bulk_copy(dst + (r / 8) * p.piece, src + (size_t)r * p.l, main, bar);
  }
}

// Add each of this lane's column pair over the warp's 16 rows and add it
// to output row `o` of the tile sums.
template <int NT>
__device__ __forceinline__ void flush_sums(const MmaParams& p,
                                           uint32_t (&run)[NT][2], int o,
                                           int col_base, int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t v = run[j][h];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      const int col = col_base + 8 * j + 2 * (lane & 3) + h;
      if (lane < 4 && col < p.m)
        atomicAdd(reinterpret_cast<unsigned*>(p.out) + (size_t)o * p.m + col,
                  v);
      run[j][h] = 0;
    }
  }
}

template <int NT>
__global__ void __launch_bounds__(kMmaThreads, 1)
    gemm_s8_mma_kernel(const MmaParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ws = smem + kBarBytes;
  unsigned char* stage0 = ws + p.w_bytes;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;      // mma fragment coordinates
  const int wm = warp & 3, wn = warp >> 2;
  constexpr int BN = 16 * NT;
  const int col0 = blockIdx.y * BN;
  const int t_begin = (int)((long long)blockIdx.x * p.tiles / gridDim.x);
  const int t_end = (int)((long long)(blockIdx.x + 1) * p.tiles / gridDim.x);

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) mbar_init(bars + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < p.stages && t_begin + s < t_end; ++s)
      issue_tile(p, t_begin + s, stage0 + s * p.stage_bytes, bars + s);
  // w's column tile, once, a warp a row: rows past M and bytes past L
  // are zero
  for (int r = warp; r < BN; r += kMmaThreads / 32)
    for (int k = 4 * lane; k < p.lp; k += 128) {
      unsigned char* dst = ws + r * p.wst + k;
      if (col0 + r < p.m && k < p.l)
        cp_async4(dst, p.w + (size_t)(col0 + r) * p.l + k);
      else
        *reinterpret_cast<uint32_t*>(dst) = 0u;
    }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  const unsigned char* brow = ws + (wn * NT * 8 + g) * p.wst + 4 * tq;
  const int col_base = col0 + wn * NT * 8;
  const bool warp_sums = p.tile > 0 && p.tile % kTileRows == 0;
  uint32_t run[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) run[j][0] = run[j][1] = 0;
  int cur = -1;                                // output row `run` adds to

  int s = 0;
  uint32_t phase = 0;
  for (int t = t_begin; t < t_end; ++t) {
    unsigned char* xs = stage0 + s * p.stage_bytes;
    mbar_wait(bars + s, phase);
    int acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
    const unsigned char* arow = xs + g * p.piece + 2 * wm * p.l + 4 * tq;
    const unsigned char* arow8 = arow + p.l;
#pragma unroll 2
    for (int k0 = 0; k0 < p.lp; k0 += 32) {
      const uint32_t a0 = lds32(arow + k0), a1 = lds32(arow8 + k0);
      const uint32_t a2 = lds32(arow + k0 + 16), a3 = lds32(arow8 + k0 + 16);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const unsigned char* b = brow + j * 8 * p.wst + k0;
        mma_s8(acc[j], a0, a1, a2, a3, lds32(b), lds32(b + 16));
      }
    }
    __syncthreads();                           // every warp is done with xs
    if (tid == 0 && t + p.stages < t_end) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      issue_tile(p, t + p.stages, xs, bars + s);
    }
    if (++s == p.stages) {
      s = 0;
      phase ^= 1u;
    }

    // fragment row g (+ 8 h) is row 8 g + 2 wm + h of the tile
    const int r0 = t * kTileRows + 2 * wm;
    if (r0 >= p.n) continue;
    if (p.tile == 0) {                         // store the (N, M) product
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = col_base + 8 * j + 2 * tq;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + 8 * g + h;
          if (row >= p.n || col >= p.m) continue;
          int* dst = p.out + (size_t)row * p.m + col;
          if (col + 1 < p.m && p.m % 2 == 0) {
            *reinterpret_cast<int2*>(dst) = make_int2(acc[j][2 * h],
                                                      acc[j][2 * h + 1]);
          } else {
            dst[0] = acc[j][2 * h];
            if (col + 1 < p.m) dst[1] = acc[j][2 * h + 1];
          }
        }
      }
    } else if (warp_sums) {                    // the tile's rows: one tile
      const int o = r0 / p.tile;
      if (o != cur) {
        if (cur >= 0) flush_sums<NT>(p, run, cur, col_base, lane);
        cur = o;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        run[j][0] += (uint32_t)acc[j][0] + (uint32_t)acc[j][2];
        run[j][1] += (uint32_t)acc[j][1] + (uint32_t)acc[j][3];
      }
    } else {                                   // tiles of other sizes
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + 8 * g + (e >> 1);
          const int col = col_base + 8 * j + 2 * tq + (e & 1);
          if (row < p.n && col < p.m)
            atomicAdd(reinterpret_cast<unsigned*>(p.out) +
                          (size_t)(row / p.tile) * p.m + col,
                      (uint32_t)acc[j][e]);
        }
    }
  }
  if (cur >= 0) flush_sums<NT>(p, run, cur, col_base, lane);
}

int round_up(int v, int to) { return (v + to - 1) / to * to; }

template <int NT>
int launch_mma(MmaParams p, int smem, cudaStream_t stream) {
  const auto kernel = gemm_s8_mma_kernel<NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kMmaThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const int col_tiles = (p.m + 16 * NT - 1) / (16 * NT);
  const int blocks = max(1, sms * max(per_sm, 1) / col_tiles);
  const dim3 grid(min(p.tiles, blocks), col_tiles);
  kernel<<<grid, kMmaThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The tensor-core launch for these operands, or -1 where it cannot take
// them (the dp4a kernel does).
int try_mma(const int8_t* x, const int8_t* w, int* out, int n, int l, int m,
            int tile, cudaStream_t stream) {
  if (l % 4 != 0 || reinterpret_cast<size_t>(x) % 16 != 0 ||
      reinterpret_cast<size_t>(w) % 4 != 0)
    return -1;
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  MmaParams p{};
  p.x = x;
  p.w = w;
  p.out = out;
  p.n = n;
  p.l = l;
  p.m = m;
  p.tile = tile;
  p.lp = round_up(l, 32);
  // both strides 16 mod 128 bytes: the 8 rows of a fragment lie 4 banks
  // apart, so its 32-bit loads are free of bank conflicts; a piece ends at
  // least 32 bytes past its last row, which the K loop may read past L
  p.wst = round_up(l, 128) + 16;
  p.piece = round_up(8 * l + 32, 128) + 16;
  p.stage_bytes = round_up(8 * p.piece, 128);
  p.tiles = (n + kTileRows - 1) / kTileRows;
  // the widest column tile that leaves room for two stages
  int nt = min(8, (m + 15) / 16);
  for (; nt > 0; --nt) {
    p.w_bytes = round_up(16 * nt * p.wst, 128);
    if (kBarBytes + p.w_bytes + 2 * p.stage_bytes <= max_smem) break;
  }
  if (nt == 0) return -1;
  p.stages = min(kMaxStages,
                 (max_smem - kBarBytes - p.w_bytes) / p.stage_bytes);
  const int smem = kBarBytes + p.w_bytes + p.stages * p.stage_bytes;
  switch (nt) {
    case 1: return launch_mma<1>(p, smem, stream);
    case 2: return launch_mma<2>(p, smem, stream);
    case 3: return launch_mma<3>(p, smem, stream);
    case 4: return launch_mma<4>(p, smem, stream);
    case 5: return launch_mma<5>(p, smem, stream);
    case 6: return launch_mma<6>(p, smem, stream);
    case 7: return launch_mma<7>(p, smem, stream);
    default: return launch_mma<8>(p, smem, stream);
  }
}

// --- K8 by dp4a: unaligned rows, long rows -----------------------------------

constexpr int kBM = 64;                        // rows of x a block
constexpr int kBKW = 32;                       // words of L a step (128 B)
constexpr int kLds = kBKW + 4;                 // padded row, in words
constexpr int kGemmThreads = 256;              // 16 (columns) x 16 (rows)

struct GemmParams {
  const int8_t* x;
  const int8_t* w;
  int* out;
  int n, l, m, tile;
  int xvec, wvec;                              // rows 4-byte aligned
};

// Word `kw` (bytes 4 kw .. 4 kw + 3 from byte k0) of row `row` of an
// (rows, l) int8 array; zero past its end.
__device__ __forceinline__ int load_word(const int8_t* a, int rows, int l,
                                         int row, int kb, bool vec) {
  if (row >= rows || kb >= l) return 0;
  const int8_t* src = a + (size_t)row * l + kb;
  if (vec && kb + 4 <= l) return __ldg(reinterpret_cast<const int*>(src));
  uint32_t word = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (kb + b < l) word |= (uint32_t)(uint8_t)__ldg(src + b) << (8 * b);
  return (int)word;
}

template <int TN>
__global__ void __launch_bounds__(kGemmThreads) gemm_s8_dp4a_kernel(GemmParams p) {
  constexpr int BN = 16 * TN;
  constexpr int kStageWords = (kBM + BN) * kLds;
  constexpr int kSumWords = kBM * BN;
  __shared__ __align__(16) int smem[kStageWords > kSumWords ? kStageWords
                                                            : kSumWords];
  int* xs = smem;                              // [kBM][kLds]
  int* ws = smem + kBM * kLds;                 // [BN][kLds]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.x * kBM, col0 = blockIdx.y * BN;

  int acc[4][TN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < p.l; k0 += 4 * kBKW) {
    __syncthreads();                           // the last step's reads done
    for (int idx = tid; idx < kBM * kBKW; idx += kGemmThreads) {
      const int r = idx / kBKW, kw = idx % kBKW;
      xs[r * kLds + kw] = load_word(p.x, p.n, p.l, row0 + r, k0 + 4 * kw,
                                    p.xvec);
    }
    for (int idx = tid; idx < BN * kBKW; idx += kGemmThreads) {
      const int r = idx / kBKW, kw = idx % kBKW;
      ws[r * kLds + kw] = load_word(p.w, p.m, p.l, col0 + r, k0 + 4 * kw,
                                    p.wvec);
    }
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < kBKW; kk += 4) {
      int4 a[4], b[TN];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const int4*>(xs + (ty + 16 * i) * kLds + kk);
#pragma unroll
      for (int j = 0; j < TN; ++j)
        b[j] = *reinterpret_cast<const int4*>(ws + (tx + 16 * j) * kLds + kk);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          int s = __dp4a(a[i].x, b[j].x, acc[i][j]);
          s = __dp4a(a[i].y, b[j].y, s);
          s = __dp4a(a[i].z, b[j].z, s);
          acc[i][j] = __dp4a(a[i].w, b[j].w, s);
        }
    }
  }

  if (p.tile == 0) {                           // store the (N, M) product
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty + 16 * i;
      if (row >= p.n) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = col0 + tx + 16 * j;
        if (col < p.m) p.out[(size_t)row * p.m + col] = acc[i][j];
      }
    }
    return;
  }
  // tile sums: the block's product to shared memory, then one thread a
  // column adds its rows tile by tile, one atomicAdd per (tile, column)
  __syncthreads();
  int* cs = smem;                              // [kBM][BN]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) cs[(ty + 16 * i) * BN + tx + 16 * j] = acc[i][j];
  __syncthreads();
  for (int c = tid; c < BN; c += kGemmThreads) {
    const int col = col0 + c;
    if (col >= p.m) continue;
    uint32_t sum = 0;
    int cur = row0 / p.tile;
    for (int r = 0; r < kBM && row0 + r < p.n; ++r) {
      const int t = (row0 + r) / p.tile;
      if (t != cur) {
        atomicAdd(reinterpret_cast<unsigned*>(p.out) + (size_t)cur * p.m + col,
                  sum);
        sum = 0;
        cur = t;
      }
      sum += (uint32_t)cs[r * BN + c];
    }
    atomicAdd(reinterpret_cast<unsigned*>(p.out) + (size_t)cur * p.m + col,
              sum);
  }
}

template <int TN>
int launch_dp4a(const GemmParams& p, cudaStream_t stream) {
  const dim3 grid((p.n + kBM - 1) / kBM, (p.m + 16 * TN - 1) / (16 * TN));
  gemm_s8_dp4a_kernel<TN><<<grid, kGemmThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

bool aligned4(const void* ptr) {
  return reinterpret_cast<size_t>(ptr) % 4 == 0;
}

}  // namespace

extern "C" {

// K7: out[t] (zeroed by the caller) += the int32 sum of rows
// [t tile, (t + 1) tile) of x (n, l); n is a multiple of tile.  Launch on
// `stream`; returns cudaGetLastError() after the launch (0 = ok).
int int8_tile_sum(const int8_t* x, int* out, int n, int l, int tile,
                  void* stream) {
  if (n < 1 || l < 1 || tile < 1 || n % tile != 0)
    return (int)cudaErrorInvalidValue;
  const long long tile_bytes = (long long)tile * l;
  const long long chunks = (tile_bytes + kChunk - 1) / kChunk;
  const long long blocks = chunks * (n / tile);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int vec = reinterpret_cast<size_t>(x) % 16 == 0 && tile_bytes % 16 == 0;
  tile_sum_kernel<<<(unsigned)blocks, kReadThreads, 0, (cudaStream_t)stream>>>(
      x, out, tile_bytes, (int)chunks, vec);
  return (int)cudaGetLastError();
}

// K8: out = x (n, l) w (m, l)^T in int32, or with tile > 0 its column sums
// over each tile of rows, out (n / tile, m) zeroed by the caller and n a
// multiple of tile.  One launch on `stream`: the tensor-core kernel, or the
// dp4a kernel where the bulk copies cannot take the operands.  Returns
// cudaGetLastError().
int int8_gemm_s32(const int8_t* x, const int8_t* w, int* out, int n, int l,
                  int m, int tile, void* stream) {
  if (n < 1 || l < 1 || m < 1 || tile < 0 || (tile > 0 && n % tile != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int err = try_mma(x, w, out, n, l, m, tile, s);
  if (err >= 0) return err;
  GemmParams p{x, w, out, n, l, m, tile,
               l % 4 == 0 && aligned4(x), l % 4 == 0 && aligned4(w)};
  const int tn = (m + 15) / 16 < 8 ? (m + 15) / 16 : 8;
  switch (tn) {
    case 1: return launch_dp4a<1>(p, s);
    case 2: return launch_dp4a<2>(p, s);
    case 3: return launch_dp4a<3>(p, s);
    case 4: return launch_dp4a<4>(p, s);
    case 5: return launch_dp4a<5>(p, s);
    case 6: return launch_dp4a<6>(p, s);
    case 7: return launch_dp4a<7>(p, s);
    default: return launch_dp4a<8>(p, s);
  }
}

}  // extern "C"
