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
// What bounds this first design is its arithmetic, not the bytes: it runs on
// the CUDA cores with __dp4a (four int8 multiply-adds into an int32), not on
// the tensor cores (mma.sync / wgmma .s8 are later work).  The rate assumed:
// one dp4a per lane every other clock (64 an SM a clock, the Hopper rate of
// 32-bit integer multiply-add), 132 SMs at ~1.75 GHz: ~14.8 T dp4a/s,
// ~118 T int8 operations/s, so ~0.11 ms at the probe's shape.
// The design keeps the dp4a issue fed from shared memory:
// - a block of 256 threads owns 64 rows x BN = 16 TN columns (TN = 1..8,
//   chosen from M so that 66 columns waste 14 of 80, not 62 of 128) and
//   walks L in steps of 128 bytes, staging x and w as 32-bit words
//   (coalesced: a warp reads one 128-byte row segment);
// - each thread holds a 4 x TN tile of int32 sums; per 16 bytes of L it
//   reads 4 + TN int4 words from shared memory (rows padded to 144 bytes:
//   no bank conflicts, broadcasts for x) for 16 TN dp4a.
// Every partial sum is exact: |x|, |w| <= 127, so |x w^T| <= 127^2 L, below
// 2^31 for L <= 2^17.  The tile sums add those in unsigned (mod 2^32)
// arithmetic, like the TPU's int32 sums; the plain twin wraps the same way.
// Any N, L, M: ragged rows and columns are masked, the tail of L is zero in
// shared memory; rows that are not 4-byte aligned (L % 4 != 0) are staged
// byte by byte.

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

// --- K8 ----------------------------------------------------------------------

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
__global__ void __launch_bounds__(kGemmThreads) gemm_s8_kernel(GemmParams p) {
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
int launch_gemm(const GemmParams& p, cudaStream_t stream) {
  const dim3 grid((p.n + kBM - 1) / kBM, (p.m + 16 * TN - 1) / (16 * TN));
  gemm_s8_kernel<TN><<<grid, kGemmThreads, 0, stream>>>(p);
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
// multiple of tile.  Launch on `stream`; returns cudaGetLastError().
int int8_gemm_s32(const int8_t* x, const int8_t* w, int* out, int n, int l,
                  int m, int tile, void* stream) {
  if (n < 1 || l < 1 || m < 1 || tile < 0 || (tile > 0 && n % tile != 0))
    return (int)cudaErrorInvalidValue;
  GemmParams p{x, w, out, n, l, m, tile,
               l % 4 == 0 && aligned4(x), l % 4 == 0 && aligned4(w)};
  const int tn = (m + 15) / 16 < 8 ? (m + 15) / 16 : 8;
  cudaStream_t s = (cudaStream_t)stream;
  switch (tn) {
    case 1: return launch_gemm<1>(p, s);
    case 2: return launch_gemm<2>(p, s);
    case 3: return launch_gemm<3>(p, s);
    case 4: return launch_gemm<4>(p, s);
    case 5: return launch_gemm<5>(p, s);
    case 6: return launch_gemm<6>(p, s);
    case 7: return launch_gemm<7>(p, s);
    default: return launch_gemm<8>(p, s);
  }
}

}  // extern "C"
