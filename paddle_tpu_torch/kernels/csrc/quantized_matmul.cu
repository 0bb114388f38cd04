// Weight-only int8 matmul for Hopper (sm_90a): kernel B8.
//
// Replaces `_dqmm_kernel` of paddle_tpu/kernels/quantized_matmul.py (:101):
// out[M, N] = (x[M, K] @ q[K, N]) * scale[N] / 127, with q the int8 codes of
// `quantize_absmax`, x bf16 or f32, the sums in f32 and the output in x's
// dtype. As in the Pallas kernel the weight stays int8 in device memory: each
// code is widened in registers (every int8 is exact in bf16 and f32) and the
// per-output-channel scale / 127 multiplies the f32 sum once, in the epilogue.
// M, N and K are all masked: out-of-range x and weight elements are read as 0
// (both operands of the K tail, as the reference zeroes both, :114-121) and
// out-of-range outputs are not written.
//
// Five kernels, picked by shape and dtype only (the caller's `route`):
//
//   b8_gemv_mma_kernel (M <= 16, bf16): decode. What bounds it: bytes. At
//     Llama-2-7B width a decode step streams 6.6 GB of int8 weights, 2 * M
//     flops a byte. The products run on the tensor cores (mma.m16n8k16, the
//     codes as the A operand, x as the n8 operand), each code read from
//     device memory once into registers and widened there; the K split is
//     a thread-block cluster (interleaved k16 steps) that sums its partials
//     through distributed shared memory in a fixed order, in the same
//     launch. The design and its index maps are written out above the
//     kernel.
//   b8_gemv_kernel (M <= 16, f32): the CUDA-core GEMV, kept for the f32
//     checks of the arithmetic (f32 activations are not the serving path).
//     Eight lanes share one K row and each loads 16 consecutive codes (8
//     when M > 8); every thread keeps M x its columns f32 sums. When N alone
//     gives too few blocks to fill the card, K is split across blocks
//     (gridDim.y); the blocks then write f32 partial sums that
//     b8_reduce_kernel adds in a fixed order and scales.
//   b8_tma_kernel (M > 16, bf16, on the TMA gate): prefill. What bounds it:
//     operations (2 M N K; a 2048-row prefill of the 4096 x 11008 FFN matrix
//     is 185 GFLOP, 0.19 ms at 989 TFLOP/s), and only wgmma reaches that
//     rate. A block of three warpgroups owns a BM x BN output tile (256 x
//     128, 128 x 256 or 128 x 128: the caller picks what fills the card at
//     the shape). Warpgroup 2 gives up its registers (setmaxnreg) and one of
//     its threads keeps a ring of 3-4 stages full by TMA, each stage guarded
//     by a full and an empty mbarrier: x [BM x 64 K] bf16, K-major, 128-byte
//     swizzle, and the int8 codes [64 K x BN], N contiguous, zero-filled past
//     M, N and K by the copy itself. Nothing else in the block spends an
//     instruction on addresses. wgmma reads B only from shared memory, so the
//     codes are widened there (route (a); route (b), the operands swapped
//     with the codes as a register A operand, would need the codes in the A
//     fragment order, K-pairs of one N row, which an N-contiguous tile does
//     not give without a byte transpose): the two consumer warpgroups widen
//     the landed codes into a bf16 tile, MN-major in 128-byte swizzled
//     [64 K x 64 N] blocks, by byte permutes (each code exact, no rounding
//     conversion), then each runs wgmma.m64n{128|64}k16 SS twice a k16 step
//     over its 128 rows, f32 sums in registers. At BM = 256 each warpgroup
//     owns 128 rows and widens half the K rows of the codes; at BM = 128 each
//     owns half the columns and widens those. A warpgroup widens stage k + 1
//     while stage k's products run; a stage is refilled only when every
//     consumer warp has seen its products done. The epilogue multiplies the
//     sums by scale[n] / 127 in their registers (the accumulator layout of
//     hopper.cuh) and stores bf16 pairs. Measured (kernels/sweep_b8.py):
//     the TMA copies alone (L2 to shared memory) take most of the kernel's
//     time, and the widening is the next cost, which 256-row tiles halve
//     per product.
//   b8_mma_kernel (M > 16, bf16, off the TMA gate: K % 8 != 0, N % 16 != 0
//     or a pointer not 16-byte aligned): 128 x 128 output tiles, 8 warps
//     each with a 64 x 32 block of wmma 16x16x16 bf16 fragments with f32
//     accumulators. Tiles of 32 K step through two shared-memory buffers:
//     the next tile's x and int8 codes (widened to bf16 before they are
//     stored) are loaded into registers while the current tile is
//     multiplied. No shape of the serving path takes it.
//   b8_simt_kernel (M > 16, f32): 64 x 64 tiles on the CUDA cores in full f32.
//     f32 activations serve the checks against the f32 plain version; the
//     serving path computes in bf16 and never reaches it.
//
// What the design still leaves: the TMA kernel is not persistent (one tile a
// block, so a tile's epilogue does not overlap the next one's loads) and
// widens on the same warpgroups that issue wgmma; the bf16 GEMV spends
// about 3 instructions a code on widening, so at M = 1 the issue rate, not
// the bytes, may bound it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// four int8 codes packed in a word, widened to f32. A code c becomes a float
// by bit assembly: 0x4B0000xx with xx = c ^ 0x80 is 2^23 + c + 128, exact, so
// a byte permute and an add replace the quarter-rate int-to-float conversion.
__device__ __forceinline__ void widen4(uint32_t u, float* f) {
  const uint32_t x = u ^ 0x80808080u;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    f[b] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540u + b))
           - 8388736.f;
}

// ---------------------------------------------------------------------------
// decode: GEMV-shaped
// ---------------------------------------------------------------------------

constexpr int kGemvThreads = 256;
constexpr int kGemvWarps = kGemvThreads / 32;
constexpr int kLanesPerRow = 8;                           // lanes on one K row
constexpr int kRowGroups = kGemvThreads / kLanesPerRow;   // K rows in flight
constexpr int kXChunk = 512;                              // K rows of x staged
constexpr int kDepth = 4;             // weight loads a thread has in flight

// ROWS: the most rows of x this instantiation holds (M <= ROWS); COLS:
// columns per thread. ROWS * COLS <= 128 sums a thread.
template <typename T, int ROWS, int COLS>
__global__ void __launch_bounds__(kGemvThreads) b8_gemv_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, T* __restrict__ out,
    float* __restrict__ partial, int M, int K, int N, int k_per_split,
    int vec) {
  constexpr int kBlockCols = kLanesPerRow * COLS;
  constexpr int kRedFloats = kGemvWarps * ROWS * kBlockCols;
  constexpr int kXFloats = ROWS * kXChunk;
  constexpr int kSmemFloats = kRedFloats > kXFloats ? kRedFloats : kXFloats;
  __shared__ __align__(16) float smem[kSmemFloats];   // x chunk, then sums

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int lig = tid % kLanesPerRow, group = tid / kLanesPerRow;
  const int n_base = blockIdx.x * kBlockCols;
  const int n0 = n_base + lig * COLS;
  const int k_begin = blockIdx.y * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);

  float acc[ROWS][COLS];
#pragma unroll
  for (int m = 0; m < ROWS; ++m)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[m][c] = 0.f;

  // this thread's codes of K row kk (COLS bytes packed in words), 0 past the
  // chunk or the N edge
  constexpr int kWords = COLS / 4;
  auto fetch = [&](uint32_t* dst, int kk, int clen, int kc) {
    if (kk < clen && n0 < N) {
      const int8_t* row = w + (int64_t)(kc + kk) * N + n0;
      if (vec) {   // N % 16 == 0 and w 16-byte aligned: n0 + COLS <= N
        if constexpr (COLS == 16) {
          const uint4 u = *reinterpret_cast<const uint4*>(row);
          dst[0] = u.x; dst[1] = u.y; dst[2] = u.z; dst[3] = u.w;
        } else {
          const uint2 u = *reinterpret_cast<const uint2*>(row);
          dst[0] = u.x; dst[1] = u.y;
        }
      } else {
#pragma unroll
        for (int i = 0; i < kWords; ++i) {
          uint32_t v = 0;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int c = i * 4 + b;
            if (n0 + c < N) v |= (uint32_t)(uint8_t)row[c] << (8 * b);
          }
          dst[i] = v;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < kWords; ++i) dst[i] = 0u;
    }
  };

  for (int kc = k_begin; kc < k_end; kc += kXChunk) {
    const int clen = min(kXChunk, k_end - kc);
    __syncthreads();   // the previous chunk is no longer read
    for (int i = tid; i < ROWS * kXChunk; i += kGemvThreads) {
      const int m = i / kXChunk, kk = i % kXChunk;
      smem[i] = (m < M && kk < clen) ? to_f(x[(int64_t)m * K + kc + kk])
                                     : 0.f;
    }
    __syncthreads();
    // kDepth rows in flight, the next kDepth fetched while these are summed
    uint32_t cur[kDepth][kWords], nxt[kDepth][kWords];
#pragma unroll
    for (int d = 0; d < kDepth; ++d)
      fetch(cur[d], group + d * kRowGroups, clen, kc);
    for (int r0 = group; r0 < clen; r0 += kDepth * kRowGroups) {
      const int r1 = r0 + kDepth * kRowGroups;
#pragma unroll
      for (int d = 0; d < kDepth; ++d)
        fetch(nxt[d], r1 + d * kRowGroups, clen, kc);
#pragma unroll
      for (int d = 0; d < kDepth; ++d) {
        const int kk = r0 + d * kRowGroups;
        float wf[COLS];
#pragma unroll
        for (int i = 0; i < kWords; ++i) widen4(cur[d][i], wf + 4 * i);
        // rows past the chunk hold codes 0 and x 0 (kk < kXChunk always)
#pragma unroll
        for (int m = 0; m < ROWS; ++m) {
          const float xv = smem[m * kXChunk + min(kk, kXChunk - 1)];
#pragma unroll
          for (int c = 0; c < COLS; ++c)
            acc[m][c] = fmaf(xv, wf[c], acc[m][c]);
        }
      }
#pragma unroll
      for (int d = 0; d < kDepth; ++d)
#pragma unroll
        for (int i = 0; i < kWords; ++i) cur[d][i] = nxt[d][i];
    }
  }

  // the four row groups of a warp that share this thread's columns
#pragma unroll
  for (int m = 0; m < ROWS; ++m)
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      float v = acc[m][c];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][c] = v;
    }
  __syncthreads();   // the x chunk is no longer read: reuse it for the sums
  float* red = smem;  // [warp][m][col]
  if (lane < kLanesPerRow) {
#pragma unroll
    for (int m = 0; m < ROWS; ++m)
#pragma unroll
      for (int c = 0; c < COLS; ++c)
        red[(warp * ROWS + m) * kBlockCols + lig * COLS + c] = acc[m][c];
  }
  __syncthreads();
  for (int i = tid; i < ROWS * kBlockCols; i += kGemvThreads) {
    const int m = i / kBlockCols, col = i % kBlockCols, n = n_base + col;
    if (m >= M || n >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < kGemvWarps; ++wi)
      s += red[(wi * ROWS + m) * kBlockCols + col];
    if (partial != nullptr)
      partial[((int64_t)blockIdx.y * M + m) * N + n] = s;
    else
      out[(int64_t)m * N + n] = from_f<T>(s * (scale[n] / 127.f));
  }
}

// out[m, n] = sum over splits of partial[s, m, n], in split order, scaled
template <typename T>
__global__ void b8_reduce_kernel(const float* __restrict__ partial,
                              const float* __restrict__ scale,
                              T* __restrict__ out, int M, int N, int splits) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t mn = (int64_t)M * N;
  if (i >= mn) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += partial[sp * mn + i];
  out[i] = from_f<T>(s * (scale[i % N] / 127.f));
}

// ---------------------------------------------------------------------------
// prefill: tensor cores (bf16)
// ---------------------------------------------------------------------------

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kMmaThreads = 256;
constexpr int kALd = kBK + 8;    // bf16 elements per row of the x tile
constexpr int kBLd = kBN + 8;    // bf16 elements per row of the weight tile

__global__ void __launch_bounds__(kMmaThreads) b8_mma_kernel(
    const bf16* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, bf16* __restrict__ out, int M, int K,
    int N, int vec_x, int vec_w) {
  using namespace nvcuda;
  __shared__ __align__(128) bf16 a_s[2][kBM * kALd];
  __shared__ __align__(128) bf16 b_s[2][kBK * kBLd];
  __shared__ __align__(128) float c_s[kMmaThreads / 32][16 * 16];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;           // 2 x 4 warps
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int n_kt = (K + kBK - 1) / kBK;

  // x tile: 128 rows x 32 K = 512 chunks of 8 bf16, two a thread;
  // weight tile: 32 K x 128 codes = 256 chunks of 16 codes, one a thread
  uint4 ra[2], rb;
  auto load = [&](int kt) {
    const int k0 = kt * kBK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kMmaThreads;
      const int r = c / 4, kk = (c % 4) * 8;
      const int m = m0 + r, k = k0 + kk;
      const bf16* src = x + (int64_t)m * K + k;
      if (vec_x) {   // K % 8 == 0: a chunk is all in or all out
        ra[i] = (m < M && k < K) ? *reinterpret_cast<const uint4*>(src)
                                 : make_uint4(0, 0, 0, 0);
      } else {
        __align__(16) bf16 e[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          e[j] = (m < M && k + j < K) ? src[j] : __float2bfloat16(0.f);
        ra[i] = *reinterpret_cast<uint4*>(e);
      }
    }
    const int r = tid / 8, nn = (tid % 8) * 16;
    const int k = k0 + r, n = n0 + nn;
    const int8_t* src = w + (int64_t)k * N + n;
    if (vec_w) {     // N % 16 == 0: a chunk is all in or all out
      rb = (k < K && n < N) ? *reinterpret_cast<const uint4*>(src)
                            : make_uint4(0, 0, 0, 0);
    } else {
      __align__(16) int8_t e[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) e[j] = (k < K && n + j < N) ? src[j] : 0;
      rb = *reinterpret_cast<uint4*>(e);
    }
  };
  auto park = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kMmaThreads;
      *reinterpret_cast<uint4*>(&a_s[buf][(c / 4) * kALd + (c % 4) * 8]) =
          ra[i];
    }
    float f[16];
    widen4(rb.x, f); widen4(rb.y, f + 4); widen4(rb.z, f + 8);
    widen4(rb.w, f + 12);
    __align__(16) bf16 h[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) h[j] = __float2bfloat16(f[j]);   // exact
    uint4* dst = reinterpret_cast<uint4*>(
        &b_s[buf][(tid / 8) * kBLd + (tid % 8) * 16]);
    dst[0] = reinterpret_cast<uint4*>(h)[0];
    dst[1] = reinterpret_cast<uint4*>(h)[1];
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  load(0);
  park(0);
  __syncthreads();
  for (int kt = 0; kt < n_kt; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < n_kt) load(kt + 1);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(
            fa[i], &a_s[cur][(wm * 64 + i * 16) * kALd + kk], kALd);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(
            fb[j], &b_s[cur][kk * kBLd + wn * 32 + j * 16], kBLd);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    if (kt + 1 < n_kt) park(cur ^ 1);
    __syncthreads();
  }

  // epilogue: one fragment at a time through this warp's 16 x 16 scratch
  float* cs = c_s[warp];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int r = lane / 2, c0 = (lane % 2) * 8;
      const int m = m0 + wm * 64 + i * 16 + r;
      if (m < M) {
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int n = n0 + wn * 32 + j * 16 + c0 + t;
          if (n < N)
            out[(int64_t)m * N + n] =
                __float2bfloat16(cs[r * 16 + c0 + t] * (scale[n] / 127.f));
        }
      }
      __syncwarp();
    }
}

// ---------------------------------------------------------------------------
// prefill: TMA + wgmma (bf16, on the gate)
// ---------------------------------------------------------------------------

constexpr int kTBK = 64;        // K per stage: one 128-byte swizzle row of x
constexpr int kTThreads = 384;  // consumer warpgroups 0, 1; producer 2

// Tiles BM x BN: 128 x 128, 128 x 256 or 256 x 128. A consumer warpgroup
// always runs two m64 products a k16 step, over 128 rows x kCols columns:
// at BM = 128 the warpgroups split the columns (each widens its own half of
// the codes), at BM = 256 the rows (each widens half the K rows of the
// codes, and both wait for the whole tile).
template <int BM, int BN>
struct TmaTile {
  static constexpr bool kSplitRows = BM == 256;
  static constexpr int kCols = kSplitRows ? BN : BN / 2;
  static constexpr int kAcc = kCols / 2;           // f32 sums per m64 product
  static constexpr int kABytes = BM * kTBK * 2;    // x tile
  static constexpr int kWBytes = kTBK * BN;        // int8 codes [64 K][BN]
  static constexpr int kBBytes = kTBK * BN * 2;    // widened codes
  // widest stage ring that fits the 227 KB a block may hold
  static constexpr int kStages =
      (232448 - 2048) / (kABytes + kWBytes + kBBytes) > 4
          ? 4 : (232448 - 2048) / (kABytes + kWBytes + kBBytes);
  static constexpr size_t kSmem =
      (size_t)kStages * (kABytes + kWBytes + kBBytes) + 2 * kStages * 8 +
      1024;   // + mbarriers + slack to align the swizzle atoms
  static_assert(kCols == 64 || kCols == 128, "tile");
};

// two codes (bytes b, b + 1 of x = codes ^ 0x80808080) as a bf16 pair
__device__ __forceinline__ uint32_t widen2_bf16(uint32_t x, int b) {
  return hopper::widen_pair(x, x, b, b + 1);
}

// out tile [BM, BN] at (blockIdx.x * BM, blockIdx.y * BN)
template <int BM, int BN>
__global__ void __launch_bounds__(kTThreads, 1) b8_tma_kernel(
    const __grid_constant__ CUtensorMap tmap_x,
    const __grid_constant__ CUtensorMap tmap_w,
    const float* __restrict__ scale, bf16* __restrict__ out, int M, int K,
    int N) {
  using namespace hopper;
  using T = TmaTile<BM, BN>;
  constexpr int kStages = T::kStages, kAcc = T::kAcc, kCols = T::kCols;
  constexpr int kABytes = T::kABytes, kWBytes = T::kWBytes;
  constexpr int kBBytes = T::kBBytes;
  // the 16-code chunks of the codes a warpgroup widens, and per K row
  constexpr int kRowChunks = (T::kSplitRows ? BN : BN / 2) / 16;
  constexpr int kChunks = (T::kSplitRows ? kTBK / 2 : kTBK) * kRowChunks;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* As = align1024(smem_raw);
  uint8_t* Ws = As + kStages * kABytes;
  uint8_t* Bs = Ws + kStages * kWBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + kStages * kBBytes);
  uint64_t* empty = full + kStages;

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int n_kt = (K + kTBK - 1) / kTBK;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);     // one arrival a consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread keeps the ring full; TMA zero-fills past M, N, K
    setmaxnreg_dec<40>();
    if (t == 0) {
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(&empty[s], (kt / kStages - 1) & 1);
        mbar_expect_tx(&full[s], kABytes + kWBytes);
        tma_load_2d(As + s * kABytes, &tmap_x, &full[s], kt * kTBK, m0);
        tma_load_2d(Ws + s * kWBytes, &tmap_w, &full[s], n0, kt * kTBK);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    // this warpgroup's rows of the x tile, columns of the widened codes
    const int row0 = T::kSplitRows ? wg * 128 : 0;
    const int col0 = T::kSplitRows ? 0 : wg * kCols;
    float acc[2][kAcc];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[h][i] = 0.f;
    fence_regs(acc[0]);
    fence_regs(acc[1]);

    // a consumer warp releases a stage once its products are done
    auto release = [&](int st) {
      __syncwarp();
      if (t % 32 == 0) mbar_arrive(&empty[st]);
    };
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % kStages;
      mbar_wait(&full[s], (kt / kStages) & 1);
      // widen this warpgroup's part of the codes into bf16, MN-major:
      // 64-N blocks of [64 K][64 N], 128-byte swizzled
      const uint8_t* w = Ws + s * kWBytes;
      uint8_t* b = Bs + s * kBBytes;
#pragma unroll
      for (int i = 0; i < kChunks / 128; ++i) {
        const int id = i * 128 + t;
        const int k = id / kRowChunks + (T::kSplitRows ? wg * kTBK / 2 : 0);
        const int nc = id % kRowChunks + (T::kSplitRows ? 0 : col0 / 16);
        const uint4 u = *reinterpret_cast<const uint4*>(w + k * BN + nc * 16);
        const uint32_t words[4] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u,
                                   u.z ^ 0x80808080u, u.w ^ 0x80808080u};
        uint32_t h[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          h[2 * j] = widen2_bf16(words[j], 0);
          h[2 * j + 1] = widen2_bf16(words[j], 2);
        }
        const int jb = nc / 4, c0 = (nc % 4) * 2;
        uint8_t* row = b + jb * (kTBK * 128) + k * 128;
        // odd blocks store their second chunk first: the 8 threads of a
        // store phase then cover all 8 chunk positions (no bank conflict)
        const int first = c0 + (jb & 1), second = c0 + 1 - (jb & 1);
        *reinterpret_cast<uint4*>(row + ((first ^ (k & 7)) << 4)) =
            (jb & 1) ? make_uint4(h[4], h[5], h[6], h[7])
                     : make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(row + ((second ^ (k & 7)) << 4)) =
            (jb & 1) ? make_uint4(h[0], h[1], h[2], h[3])
                     : make_uint4(h[4], h[5], h[6], h[7]);
      }
      fence_proxy_async();
      if constexpr (T::kSplitRows)
        named_sync(1, 256);            // both halves of the codes widened
      else
        named_sync(1 + wg, 128);       // this warpgroup's columns widened

      const uint32_t a_addr = smem_u32(As + s * kABytes) + row0 * 128;
      const uint32_t b_addr = smem_u32(b) + (col0 / 64) * (kTBK * 128);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTBK / 16; ++kk) {
        const uint64_t db = sw128_desc(b_addr + kk * 2048, kTBK * 128, 1024);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint64_t da =
              sw128_desc(a_addr + h * 64 * 128 + kk * 32, 16, 1024);
          if constexpr (kCols == 128)
            wgmma_ss_n128<1>(acc[h], da, db, 1);
          else
            wgmma_ss_n64<1>(acc[h], da, db, 1);
        }
      }
      wgmma_commit();
      // the previous stage's products are done; this stage's stay in
      // flight while the next stage is widened (nothing but wgmma touches
      // the sums inside the loop, so no register fence here: one would
      // serialise the products)
      wgmma_wait<1>();
      if (kt > 0) release((kt - 1) % kStages);
    }
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);

    // epilogue: scale[n] / 127 in f32 on the sums in their registers, bf16
    // pairs straight to device memory
    const int warp = t / 32, g = (t % 32) / 4, q = t % 4;
    const int ncol0 = n0 + col0 + 2 * q;
    float2 sc[kAcc / 4];
#pragma unroll
    for (int j = 0; j < kAcc / 4; ++j) {
      const int n = ncol0 + 8 * j;
      sc[j] = n < N ? make_float2(scale[n] / 127.f, scale[n + 1] / 127.f)
                    : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < kAcc; i += 2) {
        const int m = m0 + row0 + h * 64 + warp * 16 + g + 8 * ((i / 2) % 2);
        const int n = ncol0 + 8 * (i / 4);
        if (m < M && n < N)
          *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)m * N + n) =
              __floats2bfloat162_rn(acc[h][i] * sc[i / 4].x,
                                    acc[h][i + 1] * sc[i / 4].y);
      }
  }
}

template <int BM, int BN>
int launch_tma(const void* x, const void* w, const float* scale, void* out,
               int M, int K, int N, cudaStream_t st) {
  CUtensorMap tx, tw;
  const cuuint64_t xd[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t xs[1] = {(cuuint64_t)K * 2};
  const cuuint32_t xb[2] = {kTBK, BM};
  const cuuint64_t wd[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t ws[1] = {(cuuint64_t)N};
  const cuuint32_t wb[2] = {BN, kTBK};
  if (!hopper::make_map(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, xd, xs,
                        xb, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hopper::make_map(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, wd, ws, wb,
                        CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  auto kern = b8_tma_kernel<BM, BN>;
  constexpr size_t smem = TmaTile<BM, BN>::kSmem;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  // M fastest: the blocks in flight share few weight tiles, each read from
  // device memory about once while x stays in L2
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  kern<<<grid, kTThreads, smem, st>>>(tx, tw, scale, (bf16*)out, M, K, N);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// decode, bf16 x: mma.sync over the int8 codes, K split over a cluster
// ---------------------------------------------------------------------------
//
// out^T[N, M] = W^T[N, K] x^T[K, M] as mma.m16n8k16 products: 16 columns of
// the weight are the A rows, the (at most 8) rows of x the n8 columns (two n8
// tiles for 9-16 rows). The A fragment wants, for one column, pairs of
// consecutive K, but the codes lie N-contiguous. Both index maps of a
// product are free to choose as long as A, B and the output agree, so:
//   - the 16 A rows of product t (t = 0..7) of a 128-column block are
//     columns 16 g + 2 t (row g) and 16 g + 2 t + 1 (row g + 8): thread
//     (g, q) of the warp owns 16 consecutive columns, 16 g .. 16 g + 15,
//     across the 8 products;
//   - the 16 k-slots of a k16 step are K rows 4 q .. 4 q + 3 for slots
//     (2q, 2q + 1, 2q + 8, 2q + 9): thread (g, q) owns 4 consecutive K rows.
// So a thread loads 16 bytes from each of 4 K rows (a warp reads 16 whole
// 128-byte row segments a step) and x rows at K 4 q .. 4 q + 3 (its B
// fragment, 8 bytes) into registers, 2-3 steps ahead (the code loads are
// volatile asm: loaded through __ldg, the compiler, at the 128 registers
// of two blocks an SM, moved them toward their use and the kernel ran
// 5-19% slower, kernels/sweep_decode.py), gathers the two
// K-pairs of each column pair with one byte permute a pair of rows and
// widens each code exactly into bf16 (byte permutes into an f32 2^23 + c +
// 128, one subtract, the top halves packed: every int8 is exact in bf16).
// About 3 instructions a code, against 10.75 for the CUDA-core GEMV at M =
// 8; the sums are 4 registers a product.
//
// A block of 8 warps covers 128 columns. The blocks of a cluster (gridDim.y,
// chosen by the caller's `gemv_split` so that the grid fills the card)
// split K by interleaving their k16 steps: step j of warp w of block r is
// rows 16 ((j R + r) 8 + w), so that the whole grid walks the weight front
// to back together and every row is read by all column blocks at about the
// same time (contiguous K ranges a block read 8 separate regions at once
// and ran slower: kernels/sweep_decode.py). Each block sums its warps'
// partials in shared memory in warp order, then, after a cluster barrier,
// block c adds the cluster's partials for its share of the columns in rank
// order, reading the other blocks' shared memory, and applies scale / 127:
// one launch, no partial sums in device memory, the same result whatever
// the timing. The K tail reads both operands as 0; a ragged N or a weight
// not 16-byte aligned is read byte by byte (vec_w = 0), x not 8-byte aligned
// or K % 4 != 0 element by element (vec_x = 0).

constexpr int kGvThreads = 256;
constexpr int kGvWarps = kGvThreads / 32;
constexpr int kGvCols = 128;          // output columns a block
constexpr int kGvMaxCluster = 8;      // a portable cluster

template <int MT>
struct Gv {
  static constexpr int kRows = 8 * MT;            // rows of x a block holds
  static constexpr int kDepth = MT == 1 ? 3 : 2;  // k16 steps of loads a thread
  static constexpr int kSmem = kGvWarps * kGvCols * kRows * 4;
};

template <int MT>
__global__ void __launch_bounds__(kGvThreads, MT == 1 ? 2 : 1)
    b8_gemv_mma_kernel(const bf16* __restrict__ x,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ scale,
                       bf16* __restrict__ out, int M, int K, int N,
                       int vec_w, int vec_x) {
  using namespace hopper;
  constexpr int R8 = Gv<MT>::kRows, D = Gv<MT>::kDepth;
  extern __shared__ __align__(16) float red[];   // [warp][column][row]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, qq = lane % 4;
  const int n_base = blockIdx.x * kGvCols;
  const int n0 = n_base + 16 * gq;
  const int ranks = gridDim.y, rank = blockIdx.y;

  // the codes of K rows k0 + 4 q .. + 3 at columns n0 .. n0 + 15 and x rows
  // g (+ 8) at those K; 0 past K, N and M (no load at all past K)
  auto fetch = [&](int k0, uint4 (&c)[4], uint2 (&xr)[MT]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int kr = k0 + 4 * qq + kk;
      uint4 u = make_uint4(0, 0, 0, 0);
      if (kr < K && n0 < N) {
        const int8_t* row = w + (int64_t)kr * N + n0;
        if (vec_w) {
          u = ld_stream16(row);
        } else {
          uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
          for (int e = 0; e < 16; ++e)
            if (n0 + e < N)
              v[e / 4] |= (uint32_t)(uint8_t)row[e] << (8 * (e % 4));
          u = make_uint4(v[0], v[1], v[2], v[3]);
        }
      }
      c[kk] = u;
    }
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      const int m = gq + 8 * t, kx = k0 + 4 * qq;
      uint2 u = make_uint2(0, 0);
      if (m < M && kx < K) {
        const bf16* src = x + (int64_t)m * K + kx;
        if (vec_x) {
          u = __ldg(reinterpret_cast<const uint2*>(src));
        } else {
          __align__(8) bf16 e4[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            e4[e] = kx + e < K ? src[e] : __float2bfloat16(0.f);
          u = *reinterpret_cast<uint2*>(e4);
        }
      }
      xr[t] = u;
    }
  };

  float acc[8][MT][4];
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][mt][e] = 0.f;

  auto compute = [&](const uint4 (&c)[4], const uint2 (&xr)[MT]) {
    uint32_t wd[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wd[kk][0] = c[kk].x ^ 0x80808080u;
      wd[kk][1] = c[kk].y ^ 0x80808080u;
      wd[kk][2] = c[kk].z ^ 0x80808080u;
      wd[kk][3] = c[kk].w ^ 0x80808080u;
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      // bytes (2t, 2t + 1) of rows (0, 1) and of rows (2, 3), interleaved
      const uint32_t sel = (t % 2) ? 0x7362u : 0x5140u;
      const uint32_t g01 = __byte_perm(wd[0][t / 2], wd[1][t / 2], sel);
      const uint32_t g23 = __byte_perm(wd[2][t / 2], wd[3][t / 2], sel);
      const uint32_t a[4] = {widen2_bf16(g01, 0), widen2_bf16(g01, 2),
                             widen2_bf16(g23, 0), widen2_bf16(g23, 2)};
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        mma_16816(acc[t][mt], a, xr[mt].x, xr[mt].y);
    }
  };

  // Step j of warp w of block `rank` is K rows 16 ((j ranks + rank) 8 + w)
  // ..: the blocks of a cluster interleave their k16 steps, so that the
  // whole grid walks K front to back together and each weight row is read
  // by every column block at about the same time. D steps of loads in
  // flight a thread, in registers.
  const int kStride = 16 * kGvWarps * ranks;
  const int k_first = 16 * (rank * kGvWarps + warp);
  uint4 c[D][4];
  uint2 xr[D][MT];
#pragma unroll
  for (int d = 0; d < D; ++d) fetch(k_first + kStride * d, c[d], xr[d]);
  for (int base = k_first; base < K; base += kStride * D) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int k0 = base + kStride * d;
      if (k0 < K) {
        compute(c[d], xr[d]);
        fetch(k0 + kStride * D, c[d], xr[d]);
      }
    }
  }

  // this warp's sums: column 16 g + 2 t (+1 for d[2], d[3]), row 8 mt + 2 q
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float* r0 = red + ((warp * kGvCols + 16 * gq + 2 * t) * R8 + 8 * mt +
                         2 * qq);
      *reinterpret_cast<float2*>(r0) =
          make_float2(acc[t][mt][0], acc[t][mt][1]);
      *reinterpret_cast<float2*>(r0 + R8) =
          make_float2(acc[t][mt][2], acc[t][mt][3]);
    }
  __syncthreads();
  // the block's sums, in warp order, into warp 0's place
  for (int e = tid; e < kGvCols * R8; e += kGvThreads) {
    float sum = 0.f;
#pragma unroll
    for (int wi = 0; wi < kGvWarps; ++wi) sum += red[wi * kGvCols * R8 + e];
    red[e] = sum;
  }
  cluster_sync();

  // block `rank` of the cluster finishes its share of the columns, summing
  // the cluster's partials in rank order
  const int c0 = rank * kGvCols / ranks;
  const int ncols = (rank + 1) * kGvCols / ranks - c0;
  const uint32_t red_u32 = smem_u32(red);
  for (int e = tid; e < ncols * R8; e += kGvThreads) {
    const int col = c0 + e % ncols, m = e / ncols, n = n_base + col;
    if (m >= M || n >= N) continue;
    const uint32_t a = red_u32 + (col * R8 + m) * 4;
    float sum = 0.f;
    for (int r = 0; r < ranks; ++r) sum += ld_cluster(map_rank(a, r));
    out[(int64_t)m * N + n] = __float2bfloat16(sum * (scale[n] / 127.f));
  }
  cluster_sync();   // no block leaves while another reads its sums
}

template <int MT>
int launch_gemv_mma(const void* x, const int8_t* w, const float* scale,
                    void* out, int M, int K, int N, int ranks,
                    cudaStream_t st) {
  const int vec_w = (N % 16 == 0) && ((uintptr_t)w % 16 == 0);
  const int vec_x = (K % 4 == 0) && ((uintptr_t)x % 8 == 0);
  hopper::opt_in_smem<b8_gemv_mma_kernel<MT>>(Gv<MT>::kSmem);
  return (int)hopper::launch_cluster(
      b8_gemv_mma_kernel<MT>, dim3((N + kGvCols - 1) / kGvCols, ranks),
      dim3(kGvThreads), Gv<MT>::kSmem, st, dim3(1, ranks, 1), x, w, scale,
      out, M, K, N, vec_w, vec_x);
}

// ---------------------------------------------------------------------------
// M > 16 in f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kSBM = 64, kSBN = 64, kSBK = 16;

__global__ void __launch_bounds__(256) b8_simt_kernel(
    const float* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, float* __restrict__ out, int M, int K,
    int N) {
  __shared__ float a_s[kSBK][kSBM + 4];   // transposed: [k][m]
  __shared__ float b_s[kSBK][kSBN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kSBM, n0 = blockIdx.x * kSBN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kSBK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * 256;
      const int r = e / kSBK, kk = e % kSBK;          // x: [64 m][16 k]
      const int m = m0 + r, k = k0 + kk;
      a_s[kk][r] = (m < M && k < K) ? x[(int64_t)m * K + k] : 0.f;
      const int kr = e / kSBN, nn = e % kSBN;          // w: [16 k][64 n]
      const int k2 = k0 + kr, n = n0 + nn;
      b_s[kr][nn] = (k2 < K && n < N) ? (float)w[(int64_t)k2 * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_s[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = b_s[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) out[(int64_t)m * N + n] = acc[i][j] * (scale[n] / 127.f);
    }
  }
}

template <typename T, int ROWS, int COLS>
void launch_gemv(const void* x, const int8_t* w, const float* scale, void* out,
                 float* partial, int M, int K, int N, int k_per_split,
                 int splits, cudaStream_t st) {
  constexpr int kBlockCols = kLanesPerRow * COLS;
  const int vec = (N % 16 == 0) && ((uintptr_t)w % 16 == 0);
  dim3 grid((N + kBlockCols - 1) / kBlockCols, splits);
  b8_gemv_kernel<T, ROWS, COLS><<<grid, kGemvThreads, 0, st>>>(
      (const T*)x, w, scale, (T*)out, splits > 1 ? partial : nullptr, M, K, N,
      k_per_split, vec);
  if (splits > 1) {
    const int64_t mn = (int64_t)M * N;
    b8_reduce_kernel<T><<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(
        partial, scale, (T*)out, M, N, splits);
  }
}

template <typename T>
void dispatch_gemv(const void* x, const int8_t* w, const float* scale,
                   void* out, float* partial, int M, int K, int N,
                   int k_per_split, int splits, cudaStream_t st) {
  if (M <= 1)
    launch_gemv<T, 1, 16>(x, w, scale, out, partial, M, K, N, k_per_split,
                          splits, st);
  else if (M <= 4)
    launch_gemv<T, 4, 16>(x, w, scale, out, partial, M, K, N, k_per_split,
                          splits, st);
  else if (M <= 8)
    launch_gemv<T, 8, 16>(x, w, scale, out, partial, M, K, N, k_per_split,
                          splits, st);
  else
    launch_gemv<T, 16, 8>(x, w, scale, out, partial, M, K, N, k_per_split,
                          splits, st);
}

int launch_tiled(const void* x, const void* w, const float* sc, void* out,
                 int M, int K, int N, int tile_m, int tile_n,
                 cudaStream_t st) {
  if (tile_m == 256) return launch_tma<256, 128>(x, w, sc, out, M, K, N, st);
  return tile_n == 256 ? launch_tma<128, 256>(x, w, sc, out, M, K, N, st)
                       : launch_tma<128, 128>(x, w, sc, out, M, K, N, st);
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16
// (x and out). route, chosen by the caller from the shape before the launch
// (kernels/quantized_matmul.py `route`):
//   0 GEMV (M <= 16), with `splits` blocks over K of `k_per_split` rows each
//     (the caller's `gemv_split` in bf16, `_k_split` in f32). bf16: the
//     mma.sync kernel, the splits one cluster (at most 8) whose blocks take
//     turns of 128 K rows (k_per_split = 128 ceil(ceil(K / 16) / (8
//     splits))), partial unused. f32: the
//     CUDA-core GEMV, partial f32 [splits, M, N] when splits > 1, summed by
//     a second launch; the columns a block covers (128 for M <= 8, 64
//     above) are `_gemv_cols`;
//   1 TMA + wgmma (bf16; K % 8 == 0, N % 16 == 0, x and w 16-byte aligned),
//     output tiles tile_m x tile_n: 128 x 128, 128 x 256 or 256 x 128;
//   2 wmma tiles (bf16, any shape: the shapes the TMA cannot take);
//   3 CUDA-core tiles (f32).
// A route the shape does not fit returns cudaErrorInvalidValue; otherwise
// cudaGetLastError() after the launches.
extern "C" int pt_weight_only_matmul(const void* x, const void* w,
                                     const void* scale, void* out,
                                     void* partial, int M, int K, int N,
                                     int k_per_split, int splits, int dtype,
                                     int route, int tile_m, int tile_n,
                                     void* stream) {
  if (M < 1 || K < 1 || N < 1 || splits < 1 || k_per_split < 1 ||
      (long long)k_per_split * splits < K ||
      (route == 0 && dtype == 0 && splits > 1 && !partial) ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* wq = (const int8_t*)w;
  const float* sc = (const float*)scale;
  switch (route) {
    case 0:
      if (M > 16) return (int)cudaErrorInvalidValue;
      if (dtype == 1) {
        // a cluster of `splits` blocks over K taking turns of 128 rows:
        // k_per_split = 128 ceil(ceil(K / 16) / (8 splits))
        const int steps = (K + 15) / 16;
        if (splits > kGvMaxCluster ||
            k_per_split != 128 * ((steps + 8 * splits - 1) / (8 * splits)))
          return (int)cudaErrorInvalidValue;
        const int rc =
            M <= 8 ? launch_gemv_mma<1>(x, wq, sc, out, M, K, N, splits, st)
                   : launch_gemv_mma<2>(x, wq, sc, out, M, K, N, splits, st);
        if (rc != 0) return rc;
      } else {
        dispatch_gemv<float>(x, wq, sc, out, (float*)partial, M, K, N,
                             k_per_split, splits, st);
      }
      break;
    case 1:
      if (dtype != 1 || K % 8 != 0 || N % 16 != 0 ||
          (uintptr_t)x % 16 != 0 || (uintptr_t)w % 16 != 0 ||
          !((tile_m == 128 && (tile_n == 128 || tile_n == 256)) ||
            (tile_m == 256 && tile_n == 128)))
        return (int)cudaErrorInvalidValue;
      return launch_tiled(x, w, sc, out, M, K, N, tile_m, tile_n, st);
    case 2: {
      if (dtype != 1) return (int)cudaErrorInvalidValue;
      const int vec_x = (K % 8 == 0) && ((uintptr_t)x % 16 == 0);
      const int vec_w = (N % 16 == 0) && ((uintptr_t)w % 16 == 0);
      dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
      b8_mma_kernel<<<grid, kMmaThreads, 0, st>>>((const bf16*)x, wq, sc,
                                                  (bf16*)out, M, K, N, vec_x,
                                                  vec_w);
      break;
    }
    case 3: {
      if (dtype != 0) return (int)cudaErrorInvalidValue;
      dim3 grid((N + kSBN - 1) / kSBN, (M + kSBM - 1) / kSBM);
      b8_simt_kernel<<<grid, 256, 0, st>>>((const float*)x, wq, sc,
                                           (float*)out, M, K, N);
      break;
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
