// Decode-time attention kernels for Hopper (sm_90a): B4, B5, B6 and B7.
//
// Each replaces one Pallas kernel of paddle_tpu/kernels/quantized_matmul.py:
//
//   decode_attention_kernel        <- _decode_kernel        (B4): one query per
//       row against the contiguous cache [b, nkv, len, hd], keys [0, pos[r]].
//   window_attention_kernel        <- _window_kernel        (B5): s queries per
//       row, query i at pos[r] + i, keys [0, min(pos[r] + s - 1, len - 1)].
//   paged_decode_attention_kernel  <- _paged_decode_kernel  (B6): one query per
//       row against the page pool [NP, nkv, ps, hd] through the block table
//       bt[b, P]; key j of row r lives in page bt[r, j / ps] at offset j % ps,
//       computed here, so no page past pos[r] / ps is ever read.
//   paged_decode_attention_q8_kernel  <- _paged_decode_kernel_q8  (B7): B6 over
//       an int8 pool with per-(page, kv head) absmax scales sk, sv [NP, nkv]
//       (dequant = code * scale / 127).
//
// In bf16, B5 has a kernel of its own, window_mma_kernel, and B4, B6 and B7
// share decode_mma_kernel (the keys of each row split over a thread-block
// cluster, tensor-core products; B4's keys arrive by TMA, B6's and B7's by
// cp.async through the block table: their designs are written out above
// them). f32 runs one shared body:
//
// Design (B4-B7 in f32; in bf16 B4/B6/B7 with `splits` 0, which
// kernels/sweep_decode.py times beside the cluster kernel): one block of 256
// threads per (kv head, row). The block holds the R query rows that share
// the kv head (R = g for B4/B6, s * g for B5, at most 64) in shared memory
// as f32 and walks the keys up to the row's watermark in tiles (64 keys in
// bf16, 32 in f32). The K and
// V rows of the next tile are loaded into registers, 16 bytes a thread, while
// the current tile is computed, then parked in shared memory (rows padded by
// one word so that a thread per key reads without bank conflicts). B7 loads
// 16 int8 codes a thread and parks them in q's dtype, each multiplied by its
// own key's scale / 127: a scale belongs to a page and a tile of 64 keys spans up
// to 64 / ps pages, so the scale is looked up per key (page bt[r, j / ps]),
// never per tile, and fetched with the codes one tile ahead. A page whose scale is 0 (fresh, or the null page) reads as
// zeros. The dequantized page exists only in shared memory. Per tile:
// one thread per (row, key) computes the score over head_dim, one warp per
// row runs the online max/sum, and each thread folds p * V into f32
// accumulators for one head_dim column of its rows. Every kv-head key and
// value is read from device memory once per block, whatever g is (GQA native,
// no repeated heads). Scores, max, sum and accumulators are f32; masked
// scores are -1e30 as in the reference; the output is written in q's dtype.
//
// What bounds it: bytes. A call moves sum_r (last_r + 1) * nkv * hd * 2 (K and
// V) * itemsize bytes (B7: 1 byte a code, plus the scales of the pages read),
// which at Llama-2-7B widths (hd 128) and 2k-token rows is megabytes against
// a few flops per byte. What the shared body leaves on the table (the
// bf16 kernels take it): at b = 1 the grid has only nkv = 32 blocks for 132
// SMs, a ragged batch waits for its longest row, the staging goes through
// registers one tile ahead instead of a deeper cp.async or TMA pipeline, and
// the dot products run on the CUDA cores, not the tensor cores.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 64;              // query rows per block (s * g)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// two consecutive elements of a shared-memory word, as floats
__device__ __forceinline__ float2 word2(const uint32_t* w, float) {
  return make_float2(__uint_as_float(w[0]), __uint_as_float(w[1]));
}
__device__ __forceinline__ float2 word2(const uint32_t* w, __nv_bfloat16) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(w));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Element offset of key j's head_dim row for this block's (row, kv head).
struct ContiguousKV {
  int64_t base;          // ((b * nkv + h) * len) * hd
  int hd;
  __device__ __forceinline__ int64_t operator()(int j) const {
    return base + (int64_t)j * hd;
  }
};

struct PagedKV {
  const int* bt_row;     // bt + b * P
  int nkv, h, ps, hd;
  __device__ __forceinline__ int64_t operator()(int j) const {
    const int64_t page = bt_row[j / ps];
    return ((page * nkv + h) * ps + j % ps) * (int64_t)hd;
  }
};

// int8 pages: PagedKV's addressing plus key j's (k, v) dequant factors
struct PagedKVQ8 {
  const int* bt_row;
  const float* sk;       // [NP, nkv]
  const float* sv;
  int nkv, h, ps, hd;
  __device__ __forceinline__ int64_t operator()(int j) const {
    const int64_t page = bt_row[j / ps];
    return ((page * nkv + h) * ps + j % ps) * (int64_t)hd;
  }
  __device__ __forceinline__ float2 scales(int j) const {
    const int64_t i = (int64_t)bt_row[j / ps] * nkv + h;
    return make_float2(sk[i] / 127.f, sv[i] / 127.f);
  }
};

// 16 int8 codes (one 16-byte load) times their key's factor, stored as 16
// elements of type SE (f32: 16 words; bf16: 8 words, rounded as the plain
// version's gather rounds them). A code c becomes a float by bit assembly:
// 0x4B0000xx with xx = c ^ 0x80 is 2^23 + c + 128, exact, so one byte permute
// and one add replace the quarter-rate int-to-float conversion.
template <typename SE>
__device__ __forceinline__ void dequant16(const uint4& u, float s,
                                          uint32_t* dst) {
  const uint32_t w[4] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u,
                         u.z ^ 0x80808080u, u.w ^ 0x80808080u};
  float f[16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[i * 4 + b] =
          (__uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7540u + b))
           - 8388736.f) * s;
  if constexpr (std::is_same<SE, float>::value) {
#pragma unroll
    for (int e = 0; e < 16; ++e) dst[e] = __float_as_uint(f[e]);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
      dst[e] = *reinterpret_cast<const uint32_t*>(&h);
    }
  }
}

// T: the q/out dtype; KVT: the K/V storage type (T, or int8_t for B7). K/V
// are parked in shared memory as SE = T (int8 codes dequantized into it).
template <typename T, typename KVT, int HD>
struct Shape {
  static constexpr bool kQ8 = std::is_same<KVT, int8_t>::value;
  using SE = T;
  // keys per tile; int8 codes take 64 whatever T is, so that kChunks below
  // stays whole at head_dim 64
  static constexpr int kTile = kQ8 ? 64 : 128 / (int)sizeof(SE);
  static constexpr int kRowWords = HD * (int)sizeof(SE) / 4;  // words per row
  static constexpr int kStride = kRowWords + 1;               // padded
  static constexpr int kRowChunks = HD * (int)sizeof(KVT) / 16;  // 16 B loads
  static constexpr int kChunks = kTile * kRowChunks / kThreads;  // per thread
  static constexpr int kChunkElems = 16 / (int)sizeof(KVT);
  static constexpr int kRowSplit = kThreads / HD;   // threads per column
  static constexpr int kAcc = kMaxRows / kRowSplit; // rows per thread
  // shared-memory words for R rows
  static constexpr int words(int rows) {
    return rows * HD + 2 * kTile * kStride + rows * (kTile + 1) + 3 * rows;
  }
};

// The shared body. Query row r of the block is query i = r / g of the window
// for query head h * g + r % g; it sits at position qpos0 + i. Keys [0, last].
template <typename T, typename KVT, int HD, typename KV>
__device__ __forceinline__ void attend(
    const T* __restrict__ q, T* __restrict__ out, const KVT* __restrict__ kp,
    const KVT* __restrict__ vp, KV kv, int rows, int g, int s, int nh, int b,
    int h, int qpos0, int last, float scale) {
  using S = Shape<T, KVT, HD>;
  using SE = typename S::SE;
  constexpr int TILE = S::kTile;
  extern __shared__ __align__(16) uint32_t smem[];
  float* q_s = reinterpret_cast<float*>(smem);                  // [rows][HD]
  uint32_t* k_s = smem + rows * HD;                             // [TILE][stride]
  uint32_t* v_s = k_s + TILE * S::kStride;
  float* sc = reinterpret_cast<float*>(v_s + TILE * S::kStride);  // [rows][TILE+1]
  float* m_s = sc + rows * (TILE + 1);
  float* l_s = m_s + rows;
  float* alpha_s = l_s + rows;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  auto q_off = [&](int r) -> int64_t {
    return (((int64_t)b * s + r / g) * nh + (int64_t)h * g + r % g) * HD;
  };

  for (int idx = tid; idx < rows * HD; idx += kThreads)
    q_s[idx] = to_f(q[q_off(idx / HD) + idx % HD]);
  for (int r = tid; r < rows; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  const int n_keys = last + 1;
  const int n_tiles = (n_keys + TILE - 1) / TILE;
  uint4 kreg[S::kChunks], vreg[S::kChunks];
  float2 sreg[S::kChunks];   // B7: the chunk's key's (k, v) factors
  auto load = [&](int tile) {
    const int t0 = tile * TILE, tlen = min(TILE, n_keys - t0);
#pragma unroll
    for (int c = 0; c < S::kChunks; ++c) {
      const int idx = tid + c * kThreads;
      const int t = idx / S::kRowChunks, col = idx % S::kRowChunks;
      if (t < tlen) {
        const int64_t off = kv(t0 + t) + col * S::kChunkElems;
        kreg[c] = *reinterpret_cast<const uint4*>(kp + off);
        vreg[c] = *reinterpret_cast<const uint4*>(vp + off);
        if constexpr (S::kQ8) sreg[c] = kv.scales(t0 + t);
      }
    }
  };

  // this thread's accumulators: head_dim column d of rows rs, rs + split, ...
  const int d = tid % HD, rs = tid / HD;
  float acc[S::kAcc];
#pragma unroll
  for (int k = 0; k < S::kAcc; ++k) acc[k] = 0.f;

  if (n_tiles > 0) load(0);
  for (int n = 0; n < n_tiles; ++n) {
    const int t0 = n * TILE, tlen = min(TILE, n_keys - t0);
    // park this tile's K/V, then start the next tile's loads
#pragma unroll
    for (int c = 0; c < S::kChunks; ++c) {
      const int idx = tid + c * kThreads;
      const int t = idx / S::kRowChunks, col = idx % S::kRowChunks;
      if (t < tlen) {
        if constexpr (S::kQ8) {
          constexpr int kWordsPerChunk = 16 * (int)sizeof(SE) / 4;
          uint32_t* kd = k_s + t * S::kStride + col * kWordsPerChunk;
          uint32_t* vd = v_s + t * S::kStride + col * kWordsPerChunk;
          dequant16<SE>(kreg[c], sreg[c].x, kd);
          dequant16<SE>(vreg[c], sreg[c].y, vd);
        } else {
          uint32_t* kd = k_s + t * S::kStride + col * 4;
          uint32_t* vd = v_s + t * S::kStride + col * 4;
          kd[0] = kreg[c].x; kd[1] = kreg[c].y;
          kd[2] = kreg[c].z; kd[3] = kreg[c].w;
          vd[0] = vreg[c].x; vd[1] = vreg[c].y;
          vd[2] = vreg[c].z; vd[3] = vreg[c].w;
        }
      }
    }
    if (n + 1 < n_tiles) load(n + 1);
    __syncthreads();

    // 1. scores: one thread per (row, key)
    for (int p = tid; p < rows * TILE; p += kThreads) {
      const int r = p / TILE, t = p % TILE;
      float sv = kNegInf;
      if (t < tlen && t0 + t <= qpos0 + r / g) {
        const uint32_t* kr = k_s + t * S::kStride;
        const float* qr = q_s + r * HD;
        constexpr int kPairWords = 2 * (int)sizeof(SE) / 4;  // 2 elements
        float dot0 = 0.f, dot1 = 0.f;   // two chains of dependent FMAs
#pragma unroll 8
        for (int w = 0; w < S::kRowWords; w += kPairWords) {
          const float2 kk = word2(kr + w, SE());
          const int e = w * 4 / (int)sizeof(SE);
          dot0 = fmaf(qr[e], kk.x, dot0);
          dot1 = fmaf(qr[e + 1], kk.y, dot1);
        }
        sv = (dot0 + dot1) * scale;
      }
      sc[r * (TILE + 1) + t] = sv;
    }
    __syncthreads();

    // 2. online max/sum: one warp per row; p overwrites the score
    for (int r = warp; r < rows; r += kWarps) {
      float* sr = sc + r * (TILE + 1);
      float tmax = kNegInf;
      for (int t = lane; t < TILE; t += 32) tmax = fmaxf(tmax, sr[t]);
      tmax = warp_max(tmax);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, tmax);
      float sum = 0.f;
      for (int t = lane; t < TILE; t += 32) {
        const float p = expf(sr[t] - m_new);
        sr[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // 3. rescale and fold p * V into column d of this thread's rows (the
    // row loop stops at `rows`: uniform across a warp, so with one row the
    // other row slots cost nothing)
    const SE* vcol = reinterpret_cast<const SE*>(v_s) + d;
    constexpr int kStrideT = S::kStride * 4 / (int)sizeof(SE);
#pragma unroll
    for (int k = 0; k < S::kAcc; ++k) {
      const int r = rs + k * S::kRowSplit;
      if (r >= rows) break;
      const float* pr = sc + r * (TILE + 1);
      float a = acc[k] * alpha_s[r];
#pragma unroll 8
      for (int t = 0; t < tlen; ++t) a += pr[t] * to_f(vcol[t * kStrideT]);
      acc[k] = a;
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < S::kAcc; ++k) {
    const int r = rs + k * S::kRowSplit;
    if (r >= rows) break;
    out[q_off(r) + d] = from_f<T>(acc[k] / l_s[r]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ pos, T* __restrict__ out, int nh, int nkv,
    int len, float scale) {
  const int h = blockIdx.x, b = blockIdx.y, g = nh / nkv;
  const int p = pos[b];
  const ContiguousKV kv{((int64_t)b * nkv + h) * len * HD, HD};
  attend<T, T, HD>(q, out, k, v, kv, g, g, 1, nh, b, h, p, min(p, len - 1),
                   scale);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) window_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ pos, T* __restrict__ out, int s, int nh, int nkv,
    int len, float scale) {
  const int h = blockIdx.x, b = blockIdx.y, g = nh / nkv;
  const int p = pos[b];
  const ContiguousKV kv{((int64_t)b * nkv + h) * len * HD, HD};
  // stop at the last query's watermark, clamped to the cache end: a window
  // may overhang the cache, and keys past it do not exist
  attend<T, T, HD>(q, out, k, v, kv, s * g, g, s, nh, b, h, p,
                   min(p + s - 1, len - 1), scale);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) paged_decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ pk,
    const T* __restrict__ pv, const int* __restrict__ bt,
    const int* __restrict__ pos, T* __restrict__ out, int nh, int nkv, int ps,
    int P, float scale) {
  const int h = blockIdx.x, b = blockIdx.y, g = nh / nkv;
  const int p = pos[b];
  const PagedKV kv{bt + (int64_t)b * P, nkv, h, ps, HD};
  attend<T, T, HD>(q, out, pk, pv, kv, g, g, 1, nh, b, h, p,
                   min(p, P * ps - 1), scale);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) paged_decode_attention_q8_kernel(
    const T* __restrict__ q, const int8_t* __restrict__ pk,
    const int8_t* __restrict__ pv, const float* __restrict__ sk,
    const float* __restrict__ sv, const int* __restrict__ bt,
    const int* __restrict__ pos, T* __restrict__ out, int nh, int nkv, int ps,
    int P, float scale) {
  const int h = blockIdx.x, b = blockIdx.y, g = nh / nkv;
  const int p = pos[b];
  const PagedKVQ8 kv{bt + (int64_t)b * P, sk, sv, nkv, h, ps, HD};
  attend<T, int8_t, HD>(q, out, pk, pv, kv, g, g, 1, nh, b, h, p,
                        min(p, P * ps - 1), scale);
}

// ---------------------------------------------------------------------------
// B5 in bf16: the keys split across a cluster, scores and P.V on mma.sync
// ---------------------------------------------------------------------------
//
// One block per (kv head, row, split); the blocks of a (kv head, row) form
// one thread-block cluster of nsplit blocks, cut by the host for the widest
// watermark it knows of (`window_splits`). A row splits its own T = last /
// 64 + 1 tiles (every key the row's window sees lies in one of them) over
// ns = min(nsplit, row_splits(T, split_tiles)) splits, a count of the row
// alone (`attention.row_splits`, split_tiles = WINDOW_SPLIT_TILES), so its
// result does not depend on the other rows of the batch: split z < ns walks
// tiles [z T / ns, (z + 1) T / ns); blocks z >= ns walk none and only join
// the cluster's barriers and the combine's share of rows. Its K/V tiles
// stream through a ring of
// cp.async stages (64 keys x head_dim, 16-byte chunks, swizzled so ldmatrix
// reads without bank conflicts; keys past the watermark are written as
// zeros and read no memory). The R = s * g query rows (at most 64) are
// padded to 16-row tiles; four warps share each tile of keys: a warp takes
// one 16-row tile and 64 / KG keys of it (KG = 4, 2, 1 for 1, 2, 3-4 row
// tiles), with its Q fragments in registers for the whole walk. S = Q K^T
// and O += P V run as mma.m16n8k16 (bf16 in, f32 sums); S stays in
// registers, is masked by select after the exp (a masked key adds exactly
// 0, also in a row that sees no key of the split: its m stays -1e30, its l
// 0), and P is rounded to bf16 for the product, as the Pallas kernel does
// (p.astype(v.dtype)). Each warp keeps its own (m, l, O) in f32 and leaves
// it in shared memory; after a cluster barrier, block z combines rows z,
// z + nsplit, ...: a warp a row, one lane per (split z < ns, warp) partial
// read
// from the owning block's shared memory (distributed shared memory), M the
// largest m, L = sum l e^(m - M), out = sum O e^(m - M) / L in split order,
// so the result does not depend on block timing. A second cluster barrier
// keeps every block's partials alive until all have read them.

constexpr int kWinThreads = 128;
constexpr int kWinKeys = 64;       // keys a tile
constexpr int kMaxSplits = 8;      // blocks a portable cluster holds
constexpr float kLog2e = 1.4426950408889634f;

// the splits a row whose keys span `tiles` tiles takes: one for every
// `split_tiles` tiles, at most a cluster's kMaxSplits (attention.row_splits)
__device__ __forceinline__ int row_splits(int tiles, int split_tiles) {
  return min(kMaxSplits, (tiles + split_tiles - 1) / split_tiles);
}

template <int HD>
struct Win {
  static constexpr int kChunks = HD / 8;               // 16-byte chunks a row
  static constexpr int kStages = HD == 128 ? 3 : 4;
  static constexpr int kTileBytes = kWinKeys * HD * 2;  // K or V of a tile
  static constexpr int kQBytes = kMaxRows * HD * 2;
  static constexpr int kAccLd = HD + 8;                 // floats a partial row
  static constexpr int kSlotFloats = 32 + 16 * kAccLd;  // m, l, O of a warp
  static constexpr int kSmem = kQBytes + kStages * 2 * kTileBytes;
  static_assert(4 * kSlotFloats * 4 <= kStages * 2 * kTileBytes,
                "the partials overlay the ring");
};

// byte offset of 16-byte chunk c of row r: chunk c ^ (r % 8) of the row
template <int HD>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * Win<HD>::kChunks + (c ^ (r & 7))) * 16;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int HD, int KG>
__global__ void __launch_bounds__(kWinThreads) window_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ pos,
    __nv_bfloat16* __restrict__ out, int s, int nh, int nkv, int len,
    int split_tiles, float scale) {
  using namespace hopper;
  using W = Win<HD>;
  constexpr int kW = kWinKeys / KG;   // keys of a tile a warp takes
  constexpr int kNT = kW / 8;         // its n8 tiles of scores
  constexpr int kKC = HD / 16;        // k16 steps over head_dim
  constexpr int kDT = HD / 8;         // n8 tiles of the output
  extern __shared__ __align__(128) uint8_t win_smem[];
  uint8_t* q_s = win_smem;
  uint8_t* ring = win_smem + W::kQBytes;

  const int h = blockIdx.x, b = blockIdx.y, g = nh / nkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rows = s * g;
  const int p0 = pos[b];
  // the last query's watermark, clamped to the cache end
  const int last = min(p0 + s - 1, len - 1);
  const int n_tiles = last / kWinKeys + 1;
  const int nsplit = gridDim.z, z = blockIdx.z;   // z: the cluster rank
  // the row's own split count; blocks past it walk no tile
  const int ns = min(nsplit, row_splits(n_tiles, split_tiles));
  const int tb = z < ns ? z * n_tiles / ns : 0;
  const int nt = z < ns ? (z + 1) * n_tiles / ns - tb : 0;
  const int64_t kv0 = ((int64_t)b * nkv + h) * len * HD;
  auto q_off = [&](int r) -> int64_t {
    return (((int64_t)b * s + r / g) * nh + (int64_t)h * g + r % g) * HD;
  };

  const int rows16 = (rows + 15) & ~15;
  for (int i = tid; i < rows16 * W::kChunks; i += kWinThreads) {
    const int r = i / W::kChunks, c = i % W::kChunks;
    const bool ok = r < rows;
    cp_async16(smem_u32(q_s) + swz<HD>(r, c), q + (ok ? q_off(r) + c * 8 : 0),
               ok ? 16 : 0);
  }
  cp_async_commit();
  auto load = [&](int tile, int stage) {
    const uint32_t ks = smem_u32(ring) + stage * 2 * W::kTileBytes;
    const uint32_t vs = ks + W::kTileBytes;
    const int t0 = tile * kWinKeys;
#pragma unroll
    for (int j = 0; j < kWinKeys * W::kChunks / kWinThreads; ++j) {
      const int i = tid + j * kWinThreads;
      const int t = i / W::kChunks, c = i % W::kChunks;
      const bool ok = t0 + t <= last;
      const int64_t off = ok ? kv0 + (int64_t)(t0 + t) * HD + c * 8 : 0;
      cp_async16(ks + swz<HD>(t, c), k + off, ok ? 16 : 0);
      cp_async16(vs + swz<HD>(t, c), v + off, ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int i = 0; i < W::kStages; ++i) {
    if (i < nt) load(tb + i, i);
    cp_async_commit();
  }

  // this warp: row tile rt, keys kq * kW .. of each tile
  const int rt = warp / KG, kq = warp % KG;
  const bool active = rt * 16 < rows;
  const int gq = lane / 4, qq = lane % 4;
  const int row0 = rt * 16 + gq, row1 = row0 + 8;
  // the last key each of the thread's two rows sees (padded rows: all)
  const int lim0 = row0 < rows ? min(p0 + row0 / g, last) : last;
  const int lim1 = row1 < rows ? min(p0 + row1 / g, last) : last;
  const float sl2 = scale * kLog2e;
  uint32_t qf[kKC][4];
  float o[kDT][4];
#pragma unroll
  for (int d = 0; d < kDT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < nt; ++it) {
    cp_async_wait<W::kStages - 1>();
    __syncthreads();
    if (active) {
      const int mat = lane / 8;
      if (it == 0) {
#pragma unroll
        for (int kc = 0; kc < kKC; ++kc)
          ldsm_x4(qf[kc], smem_u32(q_s) + swz<HD>(rt * 16 + (mat % 2) * 8 +
                                                      lane % 8,
                                                  2 * kc + mat / 2));
      }
      const uint32_t ks =
          smem_u32(ring) + (it % W::kStages) * 2 * W::kTileBytes;
      const uint32_t vs = ks + W::kTileBytes;
      const int key0 = (tb + it) * kWinKeys + kq * kW;
      float sc[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
      // S = Q K^T over this warp's keys
#pragma unroll
      for (int kc = 0; kc < kKC; ++kc)
#pragma unroll
        for (int j = 0; j < kNT / 2; ++j) {
          uint32_t bk[4];
          ldsm_x4(bk, ks + swz<HD>(kq * kW + j * 16 + (mat / 2) * 8 +
                                       lane % 8,
                                   2 * kc + mat % 2));
          mma_16816(sc[2 * j], qf[kc], bk[0], bk[1]);
          mma_16816(sc[2 * j + 1], qf[kc], bk[2], bk[3]);
        }
      // online softmax in base 2; a key past a row's limit is -1e30 and
      // adds exactly 0
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + j * 8 + 2 * qq + (e & 1);
          const bool live = key <= (e < 2 ? lim0 : lim1);
          sc[j][e] = live ? sc[j][e] * sl2 : kNegInf;
          if (e < 2) mx0 = fmaxf(mx0, sc[j][e]);
          else mx1 = fmaxf(mx1, sc[j][e]);
        }
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + j * 8 + 2 * qq + (e & 1);
          const bool live = key <= (e < 2 ? lim0 : lim1);
          const float p = live ? exp2f(sc[j][e] - (e < 2 ? mn0 : mn1)) : 0.f;
          sc[j][e] = p;
          if (e < 2) s0 += p;
          else s1 += p;
        }
      l0 = l0 * a0 + s0;
      l1 = l1 * a1 + s1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int d = 0; d < kDT; ++d) {
        o[d][0] *= a0; o[d][1] *= a0;
        o[d][2] *= a1; o[d][3] *= a1;
      }
      // O += P V, P rounded to bf16
#pragma unroll
      for (int j = 0; j < kW / 16; ++j) {
        const uint32_t pa[4] = {pack_bf16(sc[2 * j][0], sc[2 * j][1]),
                                pack_bf16(sc[2 * j][2], sc[2 * j][3]),
                                pack_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1]),
                                pack_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3])};
#pragma unroll
        for (int dd = 0; dd < kDT / 2; ++dd) {
          uint32_t bv[4];
          ldsm_x4_t(bv, vs + swz<HD>(kq * kW + j * 16 + (mat % 2) * 8 +
                                         lane % 8,
                                     2 * dd + mat / 2));
          mma_16816(o[2 * dd], pa, bv[0], bv[1]);
          mma_16816(o[2 * dd + 1], pa, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();   // the stage is read by every warp before its refill
    if (it + W::kStages < nt) load(tb + it + W::kStages, it % W::kStages);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();

  // this warp's partial (m, l in base 2, unnormalised O) over the ring
  float* slots = reinterpret_cast<float*>(ring);
  if (active) {
    float* slot = slots + warp * W::kSlotFloats;
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    if (qq == 0) {
      slot[gq] = m0;
      slot[gq + 8] = m1;
      slot[16 + gq] = l0;
      slot[16 + gq + 8] = l1;
    }
    float* acc = slot + 32;
#pragma unroll
    for (int d = 0; d < kDT; ++d) {
      *reinterpret_cast<float2*>(acc + gq * W::kAccLd + d * 8 + 2 * qq) =
          make_float2(o[d][0], o[d][1]);
      *reinterpret_cast<float2*>(acc + (gq + 8) * W::kAccLd + d * 8 +
                                 2 * qq) = make_float2(o[d][2], o[d][3]);
    }
  }
  cluster_sync();

  // combine: a warp a row; lane p < ns * KG holds partial p (split p / KG,
  // warp p % KG of the row's tile)
  const int parts = ns * KG;
  const uint32_t slots_u32 = smem_u32(slots);
  constexpr int kCols = HD / 32;        // output columns a lane
  for (int r = z + nsplit * warp; r < rows; r += nsplit * 4) {
    const int rr = r % 16;
    float mp = kNegInf, lp = 0.f;
    uint32_t base = 0;
    if (lane < parts) {
      base = map_rank(slots_u32 + ((r / 16) * KG + lane % KG) *
                                      W::kSlotFloats * 4,
                      lane / KG);
      mp = ld_cluster(base + rr * 4);
      lp = ld_cluster(base + (16 + rr) * 4);
    }
    const float mx = warp_max(mp);
    const float wgt = lane < parts ? exp2f(mp - mx) : 0.f;
    const float L = __shfl_sync(0xffffffffu, warp_sum(lp * wgt), 0);
    float acc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
    for (int p = 0; p < parts; ++p) {
      const float wp = __shfl_sync(0xffffffffu, wgt, p);
      const uint32_t a = __shfl_sync(0xffffffffu, base, p) +
                         (32 + rr * W::kAccLd + lane * kCols) * 4;
      if constexpr (kCols == 4) {
        const float4 t = ld_cluster4(a);
        acc[0] += wp * t.x; acc[1] += wp * t.y;
        acc[2] += wp * t.z; acc[3] += wp * t.w;
      } else {
        const float2 t = ld_cluster2(a);
        acc[0] += wp * t.x; acc[1] += wp * t.y;
      }
    }
    __nv_bfloat16* dst = out + q_off(r) + lane * kCols;
#pragma unroll
    for (int c = 0; c < kCols; c += 2)
      *reinterpret_cast<uint32_t*>(dst + c) =
          pack_bf16(acc[c] / L, acc[c + 1] / L);
  }
  cluster_sync();   // no block leaves while another reads its partials
}

// ---------------------------------------------------------------------------
// B4, B6 and B7 in bf16: each row's keys split across a cluster, mma.sync
// ---------------------------------------------------------------------------
//
// decode_mma_kernel<Keys, HD, KG, kTop> replaces _decode_kernel (B4,
// quantized_matmul.py:253) with Keys = CacheKeys (the contiguous cache,
// copied by TMA), _paged_decode_kernel (B6, :529) with Keys =
// PagedKeys<bf16> and _paged_decode_kernel_q8 (B7, :595) with Keys =
// PagedKeys<int8_t> (codes, per-(page, kv head) scales sk, sv), for a bf16
// query; f32 keeps the shared body. The key source is the only difference:
// the products, the softmax, the merge and the combine are one body.
//
// What bounds it: bytes, sum_r (last_r + 1) * nkv * hd * 2 (K and V) * (2 or
// 1), last_r = min(pos[r], keys - 1) (keys: the cache's len, or the table's
// P * ps), against 2 flops a byte at g = 1. The shared body gave each (kv
// head, row) one block: a ragged batch waited for the blocks of its longest
// row, each walking all of the row's tiles with one tile in flight.
//
// Design. One block of 128 threads per (kv head, row, split); the nsplit
// blocks of a (kv head, row) form one thread-block cluster. The host cannot
// read pos (a device tensor in the engine), so it cuts nsplit for the
// longest row it knows of (`attention.decode_splits` for B4: min(pos, len -
// 1) for a pos it holds, else the cache's len; `attention.paged_splits` for
// B6/B7: the table's P * ps keys or the engine scheduler's bound on pos).
// Each row then splits its own T = last / 64 + 1 tiles over ns = min(nsplit,
// row_splits(T, split_tiles)) splits, read off its own pos on the card
// (split_tiles = PAGED_SPLIT_TILES: at most 8 tiles a split, at most a
// cluster's 8 blocks), so a row's cut, and with it the rounding of its
// result, does not depend on the other rows of the batch. Split z < ns walks
// key tiles [z T / ns, (z + 1) T / ns); the blocks past ns walk none: a row
// of one split writes its output from block 0 and its other blocks return
// at once, otherwise they join the cluster barriers and the combine's share
// of rows. A host bound below a row's pos makes nsplit too small for that
// row: it is still right, cut over fewer splits. Every block
// pays a chain of dependent reads (pos, for B6/B7 the table, its first
// tile) and holds its slot until its cluster is done, so more splits than
// the rule gives ran slower on an H100 (`kernels/sweep_decode.py`: 8 rows
// ragged to 2047 keys, 2 splits 0.052 ms, 8 splits 0.066; 8 rows of 257-320
// keys, 1 split 0.027, 2 splits 0.035).
//
// K/V tiles of 64 keys stream through a ring of kStages stages (at head_dim
// 128: 2 in bf16, 3 in int8, so that 3 blocks share an SM; deeper rings
// bought nothing for B6/B7).
//   B6/B7 (PagedKeys), cp.async: key j lives in page bt[r, j / ps] at offset
//   j % ps (shifts for a power-of-two ps), and the ps keys of a (page, kv
//   head) are contiguous in the pool, so a key row is a run of 16-byte
//   chunks; chunk c of key t lands at chunk c ^ (t % 8) of its row in shared
//   memory (c ^ (t % 4) for 4-chunk rows), which keeps the fragment reads
//   below free of bank conflicts. A thread reads the block-table entries of
//   its chunks' keys one tile before it issues their copies, so no copy
//   waits on a table read; keys past the row's end read nothing and land as
//   zeros.
//   B4 (CacheKeys), TMA: the keys of a (row, kv head) are one run of rows of
//   the cache viewed as [b * nkv][len][hd], and a tensor map over that view
//   (encoded by the C entry point, passed as a __grid_constant__ parameter)
//   copies a tile as boxes of 64 keys x 64 columns (two at head_dim 128) in
//   the 128-byte swizzle: chunk c of key t at chunk (c % 8) ^ (t % 8) of
//   the t-th 128-byte row of box c / 8 (`tma_swz`), the layout the fragment
//   reads already take. One thread issues a stage's copies onto the stage's
//   mbarrier; every thread waits on it. Keys past len arrive as zeros (the
//   map's bounds), but keys in (last, len) are real memory: unwritten cache
//   slots, which may hold NaN or Inf. Their scores are masked by select (a
//   NaN never reaches the softmax), and in the row's last tile the V rows
//   past `last` are zeroed in shared memory before P V, where p = 0 times a
//   NaN would still be NaN.
//
// Products run as mma.sync m16n8k16 (bf16 in, f32 sums) as in
// window_mma_kernel: the g = nh / nkv query rows (at most 64) padded to
// 16-row tiles, KG warps sharing each tile of keys, Q's fragments read once
// from device memory into registers. At g <= 8 (Llama-2-7B: g = 1) the rows
// fill rows 0-7 of one tile, and the kernel keeps only those
// (`mma_16816_top`, kTop): half the accumulators and Q registers. The
// kernel is byte-bound; the products move no bytes.
//
// B7 never dequantizes a page. A code widens exactly to bf16 (|c| <= 127) in
// the registers of a fragment (a byte permute and a subtract, as B8's GEMV
// does). S = Q K^T sums over head_dim in a permuted order in which each
// thread's K fragment of a k16 step is 4 consecutive codes of one key (one
// 16-byte read serves 4 steps), Q's fragments following the same order. In
// O += P V the output columns of each group of four n8 tiles are permuted so
// that one 32-bit read of a key row gives a thread its code for all four.
// Each key's score is multiplied by its page's sk / 127 (with the softmax
// scale), each key's p by its page's sv / 127 before it is rounded to bf16
// for P V, and l sums the unscaled p, as the Pallas kernel folds them: a
// page with scale 0 gives its keys score 0 and value 0, as its dequantized
// page does. A tile's scales arrive with its codes, 4 bytes a key.
//
// The end: each warp leaves its (m, l, O) in shared memory over the ring
// and the warps of a row tile merge theirs (`merge_warps`); a row with one
// split writes its output there, with no cluster barrier; otherwise a
// cluster barrier, and each block combines its rows through distributed
// shared memory in a fixed order, a lane a split (`combine_splits`; B5's
// own end reads a lane a (split, warp) partial). One launch a call; two
// calls give the same bits.

// A warp's partial softmax sums over its keys for its 16-row tile, left in
// shared memory for the merge: m and l (base 2) of rows gq and gq + 8, then
// O unnormalised, one row of kAccLd floats a row. o holds the C fragments of
// P V: n8 tile dt, column n = 2 qq (+1) is head_dim column dt * 8 + n, or
// with kByFour (B7's permuted columns) (dt / 4) * 32 + 4 n + dt % 4; kE = 2:
// rows gq only (a tile whose rows 8-15 are padding).
template <int HD, bool kByFour, int kE>
__device__ __forceinline__ void leave_partial(float* slot, int gq, int qq,
                                              float m0, float m1, float l0,
                                              float l1,
                                              const float (&o)[HD / 8][kE]) {
  constexpr int kLd = Win<HD>::kAccLd;
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  if (qq == 0) {
    slot[gq] = m0;
    slot[16 + gq] = l0;
    if constexpr (kE == 4) {
      slot[gq + 8] = m1;
      slot[16 + gq + 8] = l1;
    }
  }
  float* acc = slot + 32;
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
#pragma unroll
    for (int h = 0; h < kE / 2; ++h) {     // rows gq, gq + 8
      float* row = acc + (gq + 8 * h) * kLd;
      if constexpr (kByFour) {
        const int c = (d / 4) * 32 + 8 * qq + d % 4;
        row[c] = o[d][2 * h];
        row[c + 4] = o[d][2 * h + 1];
      } else {
        *reinterpret_cast<float2*>(row + d * 8 + 2 * qq) =
            make_float2(o[d][2 * h], o[d][2 * h + 1]);
      }
    }
  }
}

// The KG partials (one a warp, left by leave_partial, after a block
// barrier) of each of the block's `rows` rows, merged: M the largest m,
// L = sum l e^(m - M), O = sum O e^(m - M) in warp order. With `out` (the
// only split of the row) each thread writes its (row, column) elements of
// O / L to dst(row); without, the merged partial goes back into the row
// tile's first slot for the cluster's combine: O in place (each element has
// one owner), then m and l after a barrier (every thread reads them first).
// The caller's cluster barrier publishes it.
template <int HD, int KG, typename Dst>
__device__ __forceinline__ void merge_warps(float* slots, int rows, int tid,
                                            bool out, Dst dst) {
  using W = Win<HD>;
  if (!out && KG == 1) return;
  for (int i = tid; i < rows * HD; i += kWinThreads) {
    const int r = i / HD, rr = r % 16, c = i % HD;
    float* s0 = slots + (r / 16) * KG * W::kSlotFloats;
    float m = kNegInf;
#pragma unroll
    for (int k = 0; k < KG; ++k) m = fmaxf(m, s0[k * W::kSlotFloats + rr]);
    float o = 0.f, l = 0.f;
#pragma unroll
    for (int k = 0; k < KG; ++k) {
      const float w = exp2f(s0[k * W::kSlotFloats + rr] - m);
      o += w * s0[k * W::kSlotFloats + 32 + rr * W::kAccLd + c];
      l += w * s0[k * W::kSlotFloats + 16 + rr];
    }
    if (out) dst(r)[c] = __float2bfloat16(o / l);
    else s0[32 + rr * W::kAccLd + c] = o;
  }
  if (out) return;
  __syncthreads();
  if (tid < rows) {
    float* s0 = slots + (tid / 16) * KG * W::kSlotFloats;
    const int rr = tid % 16;
    float m = kNegInf, l = 0.f;
#pragma unroll
    for (int k = 0; k < KG; ++k) m = fmaxf(m, s0[k * W::kSlotFloats + rr]);
#pragma unroll
    for (int k = 0; k < KG; ++k)
      l += exp2f(s0[k * W::kSlotFloats + rr] - m) *
           s0[k * W::kSlotFloats + 16 + rr];
    s0[rr] = m;
    s0[16 + rr] = l;
  }
}

// The combine of a cluster's partials, after merge_warps and a cluster
// barrier: block z of nsplit writes rows z, z + nsplit, ..., a warp a row;
// lane p < ns (the row's own splits) holds split p's partial of the row's
// tile, read from the
// owning block's shared memory (distributed shared memory), every split's
// columns loaded before any is summed. M the largest m, L = sum l e^(m -
// M), out = sum O e^(m - M) / L in split order, so the result does not
// depend on block timing. dst(r): row r's output.
template <int HD, int KG, typename Dst>
__device__ __forceinline__ void combine_splits(float* slots, int rows, int z,
                                               int nsplit, int ns, int warp,
                                               int lane, Dst dst) {
  using namespace hopper;
  using W = Win<HD>;
  const uint32_t slots_u32 = smem_u32(slots);
  constexpr int kCols = HD / 32;        // output columns a lane
  for (int r = z + nsplit * warp; r < rows; r += nsplit * 4) {
    const int rr = r % 16;
    float mp = kNegInf, lp = 0.f;
    uint32_t base = 0;
    if (lane < ns) {
      base = map_rank(slots_u32 + (r / 16) * KG * W::kSlotFloats * 4, lane);
      mp = ld_cluster(base + rr * 4);
      lp = ld_cluster(base + (16 + rr) * 4);
    }
    const float mx = warp_max(mp);
    const float wgt = lane < ns ? exp2f(mp - mx) : 0.f;
    const float L = __shfl_sync(0xffffffffu, warp_sum(lp * wgt), 0);
    float4 t[kMaxSplits];
#pragma unroll
    for (int p = 0; p < kMaxSplits; ++p) {
      const uint32_t a = __shfl_sync(0xffffffffu, base, p) +
                         (32 + rr * W::kAccLd + lane * kCols) * 4;
      if (p < ns) {
        if constexpr (kCols == 4) {
          t[p] = ld_cluster4(a);
        } else {
          const float2 u = ld_cluster2(a);
          t[p] = make_float4(u.x, u.y, 0.f, 0.f);
        }
      }
    }
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int p = 0; p < kMaxSplits; ++p) {
      const float wp = __shfl_sync(0xffffffffu, wgt, p);
      if (p < ns) {
        acc[0] += wp * t[p].x; acc[1] += wp * t[p].y;
        acc[2] += wp * t[p].z; acc[3] += wp * t[p].w;
      }
    }
    __nv_bfloat16* d = dst(r) + lane * kCols;
#pragma unroll
    for (int c = 0; c < kCols; c += 2)
      *reinterpret_cast<uint32_t*>(d + c) =
          pack_bf16(acc[c] / L, acc[c + 1] / L);
  }
}

template <typename KVT, int HD>
struct PagedTile {
  static constexpr bool kQ8 = std::is_same<KVT, int8_t>::value;
  static constexpr int kRowBytes = HD * (int)sizeof(KVT);
  static constexpr int kChunks = kRowBytes / 16;          // 16-byte chunks a key
  static constexpr int kSwz = kChunks < 8 ? kChunks - 1 : 7;
  static constexpr int kChunkElems = 16 / (int)sizeof(KVT);
  static constexpr int kTileBytes = kWinKeys * kRowBytes;  // K or V of a tile
  static constexpr int kStages = HD == 128 ? (kQ8 ? 3 : 2) : 4;
  // a thread copies chunk tid % kChunks of kLoads keys a tile, kKeyStep apart
  static constexpr int kLoads = kWinKeys * kChunks / kWinThreads;
  static constexpr int kKeyStep = kWinThreads / kChunks;
  static constexpr int kRingBytes = kStages * 2 * kTileBytes;
  // the warps' partials overlay the ring; B7's k and v scales of each
  // stage's keys follow it
  static constexpr int kPartBytes = 4 * Win<HD>::kSlotFloats * 4;
  static constexpr int kScaleAt =
      kRingBytes > kPartBytes ? kRingBytes : kPartBytes;
  static constexpr int kSmem =
      kScaleAt + (kQ8 ? kStages * 2 * kWinKeys * 4 : 0);
};

// byte offset of 16-byte chunk c of key row t in a stage
template <typename KVT, int HD>
__device__ __forceinline__ uint32_t pswz(int t, int c) {
  using T = PagedTile<KVT, HD>;
  return (uint32_t)(t * T::kChunks + (c ^ (t & T::kSwz))) * 16;
}

// byte offset of 16-byte chunk c of key row t in a stage copied by TMA in
// the 128-byte swizzle: 64-column boxes of 64 rows of 128 bytes, one after
// the other (head_dim 128: two boxes a tile)
__device__ __forceinline__ uint32_t tma_swz(int t, int c) {
  return (uint32_t)((c >> 3) * (kWinKeys * 128) + t * 128 +
                    (((c & 7) ^ (t & 7)) << 4));
}

// B6's and B7's keys: the page pool [NP, nkv, ps, hd] through the block
// table bt [b, P], copied with cp.async (B7: KVT = int8_t, with the scales
// sk, sv [NP, nkv]; null for B6)
template <typename KVT_>
struct PagedKeys {
  using KVT = KVT_;
  static constexpr bool kTma = false;
  const KVT* k;
  const KVT* v;
  const float* sk;
  const float* sv;
  const int* bt;
  int ps, P;
  __device__ __forceinline__ int keys() const { return P * ps; }
};

// B4's keys: the contiguous cache [b, nkv, len, hd] through two tensor maps
// over its [b * nkv][len][hd] view, boxes of 64 keys x 64 columns
struct CacheKeys {
  using KVT = __nv_bfloat16;
  static constexpr bool kTma = true;
  CUtensorMap k, v;
  int len;
  __device__ __forceinline__ int keys() const { return len; }
};

// dynamic shared memory of decode_mma_kernel: the ring (the partials and
// B7's scales overlay or follow it); the TMA source adds the stages'
// mbarriers and the slack that aligns the ring to 1024 bytes (the swizzle's
// atoms)
template <typename Keys, int HD>
constexpr int decode_smem() {
  using T = PagedTile<typename Keys::KVT, HD>;
  return Keys::kTma ? 1024 + T::kScaleAt + T::kStages * 8 : T::kSmem;
}

// kTop: the g <= 8 query rows fill rows 0-7 of the single 16-row tile, so
// the products keep rows 0-7 only (mma_16816_top): half the accumulator and
// Q registers, which lets more blocks share an SM
template <typename Keys, int HD, int KG, bool kTop>
__global__ void __launch_bounds__(kWinThreads) decode_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __grid_constant__ Keys keys,
    const int* __restrict__ pos, __nv_bfloat16* __restrict__ out, int nh,
    int nkv, int split_tiles, float scale) {
  using namespace hopper;
  using KVT = typename Keys::KVT;
  using T = PagedTile<KVT, HD>;
  constexpr bool kQ8 = T::kQ8;
  constexpr bool kTma = Keys::kTma;
  constexpr int kStages = T::kStages;
  constexpr int kW = kWinKeys / KG;   // keys of a tile a warp takes
  constexpr int kNT = kW / 8;         // its n8 tiles of scores
  constexpr int kKC = HD / 16;        // k16 steps over head_dim
  constexpr int kDT = HD / 8;         // n8 tiles of the output
  constexpr int kE = kTop ? 2 : 4;    // C-fragment elements kept a tile
  static_assert(!kTop || KG == 4, "kTop: one row tile");
  static_assert(!kTma || !kQ8, "the TMA source copies bf16 keys");
  extern __shared__ __align__(128) uint8_t decode_smem_raw[];
  uint8_t* ring = kTma ? align1024(decode_smem_raw) : decode_smem_raw;
  // B7: each stage's k and v scales; TMA: each stage's barrier
  float* scl = reinterpret_cast<float*>(ring + T::kScaleAt);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + T::kScaleAt);
  // byte offset of 16-byte chunk c of key t in a stage
  auto koff = [](int t, int c) -> uint32_t {
    if constexpr (kTma) return tma_swz(t, c);
    else return pswz<KVT, HD>(t, c);
  };

  const int h = blockIdx.x, b = blockIdx.y, g = nh / nkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rows = g;
  const int last = min(pos[b], keys.keys() - 1);
  const int n_tiles = last / kWinKeys + 1;
  const int nsplit = gridDim.z, z = blockIdx.z;   // z: the cluster rank
  // the row's own split count: a row of one split is block 0's alone
  const int ns = min(nsplit, row_splits(n_tiles, split_tiles));
  if (z >= ns && ns == 1) return;
  const int tb = z < ns ? z * n_tiles / ns : 0;
  const int nt = z < ns ? (z + 1) * n_tiles / ns - tb : 0;
  auto q_off = [&](int r) -> int64_t {
    return ((int64_t)b * nh + (int64_t)h * g + r) * HD;
  };

  // B6/B7: the page of each key this thread copies in tile `tile`, -1 past
  // `last`; key j's table entry and offset in its page (shifts for a
  // power-of-two ps). Generic lambdas over the key source `src`, so that
  // B4's instantiations, which never call them, do not compile them.
  const int cq = tid % T::kChunks, tq = tid / T::kChunks;
  auto fetch = [&](const auto& src, int tile, int (&pg)[T::kLoads]) {
    const int* bt_row = src.bt + (int64_t)b * src.P;
    const int sh = (src.ps & (src.ps - 1)) ? -1 : __ffs(src.ps) - 1;
#pragma unroll
    for (int i = 0; i < T::kLoads; ++i) {
      const int j = tile * kWinKeys + tq + i * T::kKeyStep;
      pg[i] = j <= last ? __ldg(bt_row + (sh >= 0 ? j >> sh : j / src.ps))
                        : -1;
    }
  };
  auto issue = [&](const auto& src, int tile, int stage,
                   const int (&pg)[T::kLoads]) {
    const uint32_t ks = smem_u32(ring) + stage * 2 * T::kTileBytes;
    const uint32_t vs = ks + T::kTileBytes;
    const int ps = src.ps;
    const int sh = (ps & (ps - 1)) ? -1 : __ffs(ps) - 1;
#pragma unroll
    for (int i = 0; i < T::kLoads; ++i) {
      const int t = tq + i * T::kKeyStep;
      const int j = tile * kWinKeys + t;
      const bool ok = pg[i] >= 0;
      const int64_t page = ok ? (int64_t)pg[i] * nkv + h : 0;
      const int64_t off =
          ok ? (page * ps + (sh >= 0 ? j & (ps - 1) : j % ps)) * HD +
                   cq * T::kChunkElems
             : 0;
      cp_async16(ks + koff(t, cq), src.k + off, ok ? 16 : 0);
      cp_async16(vs + koff(t, cq), src.v + off, ok ? 16 : 0);
      if constexpr (kQ8) {
        if (cq == 0) {
          const uint32_t sd = smem_u32(scl + stage * 2 * kWinKeys + t);
          cp_async4(sd, src.sk + page, ok ? 4 : 0);
          cp_async4(sd + kWinKeys * 4, src.sv + page, ok ? 4 : 0);
        }
      }
    }
  };
  // B4: tile `tile`'s K and V boxes onto the stage's barrier (one thread)
  auto issue_tma = [&](const auto& src, int tile, int stage) {
    uint8_t* ks = ring + stage * 2 * T::kTileBytes;
    uint8_t* vs = ks + T::kTileBytes;
    const int row = b * nkv + h;
    mbar_expect_tx(&full[stage], 2 * T::kTileBytes);
#pragma unroll
    for (int half = 0; half < HD / 64; ++half) {
      tma_load_3d(ks + half * kWinKeys * 128, &src.k, &full[stage],
                  half * 64, tile * kWinKeys, row);
      tma_load_3d(vs + half * kWinKeys * 128, &src.v, &full[stage],
                  half * 64, tile * kWinKeys, row);
    }
  };
  int pg_next[T::kLoads];
  if constexpr (kTma) {
    if (tid == 0) {
#pragma unroll
      for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
      fence_barrier_init();
    }
    __syncthreads();
    if (tid == 0)
#pragma unroll
      for (int s = 0; s < kStages; ++s)
        if (s < nt) issue_tma(keys, tb + s, s);
  } else {
    int pg[kStages][T::kLoads];
#pragma unroll
    for (int s = 0; s < kStages; ++s)
      if (s < nt) fetch(keys, tb + s, pg[s]);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      if (s < nt) issue(keys, tb + s, s, pg[s]);
      cp_async_commit();
    }
  }

  // this warp: row tile rt, keys kq * kW .. of each tile
  const int rt = warp / KG, kq = warp % KG;
  const bool active = rt * 16 < rows;
  const int gq = lane / 4, qq = lane % 4;
  const int row0 = rt * 16 + gq, row1 = row0 + 8;
  // Q's A fragments: the head_dim columns of step kc's two column pairs
  // (B7: the permuted order of the K fragments); kTop keeps rows 0-7
  uint32_t qf[kKC][kE];
  auto qword = [&](int r, int d) -> uint32_t {
    return r < rows ? *reinterpret_cast<const uint32_t*>(q + q_off(r) + d)
                    : 0u;
  };
#pragma unroll
  for (int kc = 0; kc < kKC; ++kc) {
    const int d0 = kQ8 ? qq * (HD / 4) + 4 * kc : 16 * kc + 2 * qq;
    const int d1 = kQ8 ? d0 + 2 : d0 + 8;
    if constexpr (kTop) {
      qf[kc][0] = qword(row0, d0);
      qf[kc][1] = qword(row0, d1);
    } else {
      qf[kc][0] = qword(row0, d0);
      qf[kc][1] = qword(row1, d0);
      qf[kc][2] = qword(row0, d1);
      qf[kc][3] = qword(row1, d1);
    }
  }
  // d (+)= A B on the kept rows
  auto mma = [&](float (&d)[kE], const uint32_t (&a)[kE], uint32_t b0,
                 uint32_t b1) {
    if constexpr (kTop) mma_16816_top(d, a[0], a[1], b0, b1);
    else mma_16816(d, a, b0, b1);
  };
  const float sl2 = scale * kLog2e / (kQ8 ? 127.f : 1.f);
  float o[kDT][kE];
#pragma unroll
  for (int d = 0; d < kDT; ++d)
#pragma unroll
    for (int e = 0; e < kE; ++e) o[d][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < nt; ++it) {
    const int stage = it % kStages;
    const int tile_key0 = (tb + it) * kWinKeys;
    // the tile this iteration refills, a stage ahead (B6/B7: its table
    // entries first)
    const bool refill = it + kStages < nt;
    if constexpr (kTma) {
      mbar_wait(&full[stage], (it / kStages) & 1);
      if (tile_key0 + kWinKeys - 1 > last) {
        // the row's last tile: V's keys past `last` (unwritten cache
        // slots) to zeros, so that p = 0 adds exactly 0 to P V
        uint8_t* vt = ring + stage * 2 * T::kTileBytes + T::kTileBytes;
        for (int i = tid; i < kWinKeys * T::kChunks; i += kWinThreads) {
          const int t = i / T::kChunks;
          if (tile_key0 + t > last)
            *reinterpret_cast<uint4*>(vt + koff(t, i % T::kChunks)) =
                make_uint4(0u, 0u, 0u, 0u);
        }
        __syncthreads();
      }
    } else {
      if (refill) fetch(keys, tb + it + kStages, pg_next);
      cp_async_wait<kStages - 1>();
      __syncthreads();
    }
    if (active) {
      const uint8_t* kt = ring + stage * 2 * T::kTileBytes;
      const uint8_t* vt = kt + T::kTileBytes;
      const float* ksc = scl + stage * 2 * kWinKeys;   // B7: raw scales
      const float* vsc = ksc + kWinKeys;
      const int t0 = kq * kW;                         // the warp's keys
      const int mat = lane / 8;
      float sc[kNT][kE];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < kE; ++e) sc[j][e] = 0.f;
      // S = Q K^T over this warp's keys
      if constexpr (kQ8) {
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const int t = t0 + j * 8 + gq;
          uint4 u[HD / 64];
#pragma unroll
          for (int c = 0; c < HD / 64; ++c)
            u[c] = *reinterpret_cast<const uint4*>(
                kt + koff(t, qq * (HD / 64) + c));
#pragma unroll
          for (int kc = 0; kc < kKC; ++kc) {
            const uint4& w4 = u[kc / 4];
            const uint32_t w = (kc % 4 == 0   ? w4.x
                                : kc % 4 == 1 ? w4.y
                                : kc % 4 == 2 ? w4.z
                                              : w4.w) ^
                               0x80808080u;
            mma(sc[j], qf[kc], widen_pair(w, w, 0, 1),
                widen_pair(w, w, 2, 3));
          }
        }
      } else {
        const uint32_t ks = smem_u32(kt);
#pragma unroll
        for (int kc = 0; kc < kKC; ++kc)
#pragma unroll
          for (int j = 0; j < kNT / 2; ++j) {
            uint32_t bk[4];
            ldsm_x4(bk, ks + koff(t0 + j * 16 + (mat / 2) * 8 + lane % 8,
                                  2 * kc + mat % 2));
            mma(sc[2 * j], qf[kc], bk[0], bk[1]);
            mma(sc[2 * j + 1], qf[kc], bk[2], bk[3]);
          }
      }
      // online softmax in base 2 (B7: each key's score times its page's
      // sk / 127); a key past the row's end is -1e30 by select, whatever
      // its score (B4: a NaN of an unwritten slot), and adds exactly 0
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          const int t = t0 + j * 8 + 2 * qq + (e & 1);
          const float f = kQ8 ? sl2 * ksc[t] : sl2;
          sc[j][e] = tile_key0 + t <= last ? sc[j][e] * f : kNegInf;
          if (e < 2) mx0 = fmaxf(mx0, sc[j][e]);
          else mx1 = fmaxf(mx1, sc[j][e]);
        }
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = kTop ? m1 : fmaxf(m1, quad_max(mx1));
      const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          const int t = t0 + j * 8 + 2 * qq + (e & 1);
          const float p = tile_key0 + t <= last
                              ? exp2f(sc[j][e] - (e < 2 ? mn0 : mn1))
                              : 0.f;
          sc[j][e] = p;
          if (e < 2) s0 += p;
          else s1 += p;
        }
      l0 = l0 * a0 + s0;
      l1 = l1 * a1 + s1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int d = 0; d < kDT; ++d)
#pragma unroll
        for (int e = 0; e < kE; ++e) o[d][e] *= e < 2 ? a0 : a1;
      // O += P V, P rounded to bf16 (B7: each key's p times its page's
      // sv / 127 first); pa: P's A fragment of k16 step j (kTop: rows 0-7)
#pragma unroll
      for (int j = 0; j < kW / 16; ++j) {
        const int t = t0 + j * 16 + 2 * qq;   // keys t, t + 1, t + 8, t + 9
        float v0 = 1.f, v1 = 1.f, v8 = 1.f, v9 = 1.f;
        if constexpr (kQ8) {
          v0 = vsc[t] / 127.f;
          v1 = vsc[t + 1] / 127.f;
          v8 = vsc[t + 8] / 127.f;
          v9 = vsc[t + 9] / 127.f;
        }
        uint32_t pa[kE];
        if constexpr (kTop) {
          pa[0] = pack_bf16(sc[2 * j][0] * v0, sc[2 * j][1] * v1);
          pa[1] = pack_bf16(sc[2 * j + 1][0] * v8, sc[2 * j + 1][1] * v9);
        } else {
          pa[0] = pack_bf16(sc[2 * j][0] * v0, sc[2 * j][1] * v1);
          pa[1] = pack_bf16(sc[2 * j][2] * v0, sc[2 * j][3] * v1);
          pa[2] = pack_bf16(sc[2 * j + 1][0] * v8, sc[2 * j + 1][1] * v9);
          pa[3] = pack_bf16(sc[2 * j + 1][2] * v8, sc[2 * j + 1][3] * v9);
        }
        if constexpr (kQ8) {
          // codes of key `key` at columns 32 grp + 4 gq .. + 3
          auto vword = [&](int key, int grp) -> uint32_t {
            const int col = grp * 32 + 4 * gq;
            return *reinterpret_cast<const uint32_t*>(
                       vt + koff(key, col / 16) + col % 16) ^
                   0x80808080u;
          };
#pragma unroll
          for (int grp = 0; grp < HD / 32; ++grp) {
            const uint32_t w0 = vword(t, grp), w1 = vword(t + 1, grp);
            const uint32_t w8 = vword(t + 8, grp), w9 = vword(t + 9, grp);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              mma(o[grp * 4 + i], pa, widen_pair(w0, w1, i, i),
                  widen_pair(w8, w9, i, i));
          }
        } else {
          const uint32_t vs = smem_u32(vt);
#pragma unroll
          for (int dd = 0; dd < kDT / 2; ++dd) {
            uint32_t bv[4];
            ldsm_x4_t(bv, vs + koff(t0 + j * 16 + (mat % 2) * 8 + lane % 8,
                                    2 * dd + mat / 2));
            mma(o[2 * dd], pa, bv[0], bv[1]);
            mma(o[2 * dd + 1], pa, bv[2], bv[3]);
          }
        }
      }
    }
    __syncthreads();   // the stage is read by every warp before its refill
    if constexpr (kTma) {
      if (refill && tid == 0) issue_tma(keys, tb + it + kStages, stage);
    } else {
      if (refill) issue(keys, tb + it + kStages, stage, pg_next);
      cp_async_commit();
    }
  }
  if constexpr (!kTma) cp_async_wait<0>();
  __syncthreads();

  // this warp's partial over the ring, merged with the other warps' (the
  // output itself when the row has one split), then the combine of the
  // row's ns splits (a block past them leaves no partial)
  float* slots = reinterpret_cast<float*>(ring);
  auto dst = [&](int r) { return out + q_off(r); };
  if (z < ns) {
    if (active)
      leave_partial<HD, kQ8, kE>(slots + warp * Win<HD>::kSlotFloats, gq,
                                 qq, m0, m1, l0, l1, o);
    __syncthreads();
    merge_warps<HD, KG>(slots, rows, tid, ns == 1, dst);
  }
  if (ns == 1) return;
  cluster_sync();
  combine_splits<HD, KG>(slots, rows, z, nsplit, ns, warp, lane, dst);
  cluster_sync();   // no block leaves while another reads its partials
}

// Dynamic shared memory for `rows` rows; above 48 KB the kernel must be
// allowed it first, on each device it runs on (the attribute is the
// current device's): once per instantiation and device, at the most rows it
// can take. One bit a device; devices past 63 opt in before every launch.
template <typename T, typename KVT, int HD, typename K>
size_t smem_for(K kernel, int rows) {
  static uint64_t opted_in = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (!(opted_in & bit)) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         Shape<T, KVT, HD>::words(kMaxRows) * 4);
    opted_in |= bit;
  }
  return (size_t)Shape<T, KVT, HD>::words(rows) * 4;
}

template <typename T, int HD>
void launch_decode(const void* q, const void* k, const void* v,
                   const void* pos, void* out, int b, int nh, int nkv,
                   int len, float scale, cudaStream_t st) {
  auto kern = decode_attention_kernel<T, HD>;
  kern<<<dim3(nkv, b), kThreads, smem_for<T, T, HD>(kern, nh / nkv), st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)pos, (T*)out, nh,
      nkv, len, scale);
}

// f32: the shared body, one block per (kv head, row)
template <int HD>
void launch_window_f32(const void* q, const void* k, const void* v,
                       const void* pos, void* out, int b, int s, int nh,
                       int nkv, int len, float scale, cudaStream_t st) {
  auto kern = window_attention_kernel<float, HD>;
  kern<<<dim3(nkv, b), kThreads, smem_for<float, float, HD>(kern, s * (nh / nkv)),
         st>>>((const float*)q, (const float*)k, (const float*)v,
               (const int*)pos, (float*)out, s, nh, nkv, len, scale);
}

// bf16: the key-split tensor-core kernel, `splits` blocks a cluster
template <int HD, int KG>
cudaError_t launch_window_mma(const void* q, const void* k, const void* v,
                              const void* pos, void* out, int b, int s,
                              int nh, int nkv, int len, int split_tiles,
                              int splits, float scale, cudaStream_t st) {
  hopper::opt_in_smem<window_mma_kernel<HD, KG>>(Win<HD>::kSmem);
  return hopper::launch_cluster(
      window_mma_kernel<HD, KG>, dim3(nkv, b, splits), dim3(kWinThreads),
      Win<HD>::kSmem, st, dim3(1, 1, splits), q, k, v, pos, out, s, nh, nkv,
      len, split_tiles, scale);
}

// KG, the warps that share a tile of keys: 4 / the 16-row tiles (3 -> 4)
template <int HD>
cudaError_t launch_window_bf16(const void* q, const void* k, const void* v,
                               const void* pos, void* out, int b, int s,
                               int nh, int nkv, int len, int split_tiles,
                               int splits, float scale, cudaStream_t st) {
  const int tiles = (s * (nh / nkv) + 15) / 16;
  if (tiles == 1)
    return launch_window_mma<HD, 4>(q, k, v, pos, out, b, s, nh, nkv, len,
                                    split_tiles, splits, scale, st);
  if (tiles == 2)
    return launch_window_mma<HD, 2>(q, k, v, pos, out, b, s, nh, nkv, len,
                                    split_tiles, splits, scale, st);
  return launch_window_mma<HD, 1>(q, k, v, pos, out, b, s, nh, nkv, len,
                                  split_tiles, splits, scale, st);
}

template <typename T, int HD>
void launch_paged(const void* q, const void* pk, const void* pv,
                  const void* bt, const void* pos, void* out, int b, int nh,
                  int nkv, int ps, int P, float scale, cudaStream_t st) {
  auto kern = paged_decode_attention_kernel<T, HD>;
  kern<<<dim3(nkv, b), kThreads, smem_for<T, T, HD>(kern, nh / nkv), st>>>(
      (const T*)q, (const T*)pk, (const T*)pv, (const int*)bt,
      (const int*)pos, (T*)out, nh, nkv, ps, P, scale);
}

template <typename T, int HD>
void launch_paged_q8(const void* q, const void* pk, const void* pv,
                     const void* sk, const void* sv, const void* bt,
                     const void* pos, void* out, int b, int nh, int nkv,
                     int ps, int P, float scale, cudaStream_t st) {
  auto kern = paged_decode_attention_q8_kernel<T, HD>;
  kern<<<dim3(nkv, b), kThreads, smem_for<T, int8_t, HD>(kern, nh / nkv),
         st>>>((const T*)q, (const int8_t*)pk, (const int8_t*)pv,
               (const float*)sk, (const float*)sv, (const int*)bt,
               (const int*)pos, (T*)out, nh, nkv, ps, P, scale);
}

// B4, B6 and B7 in bf16: the key-split kernel over key source `keys`,
// `splits` blocks a cluster
template <typename Keys, int HD, int KG, bool kTop>
cudaError_t launch_decode_mma(const void* q, const Keys& keys,
                              const void* pos, void* out, int b, int nh,
                              int nkv, int split_tiles, int splits,
                              float scale, cudaStream_t st) {
  constexpr int kSmem = decode_smem<Keys, HD>();
  hopper::opt_in_smem<decode_mma_kernel<Keys, HD, KG, kTop>>(kSmem);
  return hopper::launch_cluster(
      decode_mma_kernel<Keys, HD, KG, kTop>, dim3(nkv, b, splits),
      dim3(kWinThreads), kSmem, st, dim3(1, 1, splits), q, keys, pos, out,
      nh, nkv, split_tiles, scale);
}

// KG as for B5: 4 / the 16-row tiles of the g query rows (3 -> 4); g <= 8
// keeps rows 0-7 of its tile only (kTop)
template <typename Keys, int HD>
cudaError_t launch_decode_bf16(const void* q, const Keys& keys,
                               const void* pos, void* out, int b, int nh,
                               int nkv, int split_tiles, int splits,
                               float scale, cudaStream_t st) {
  const int g = nh / nkv, tiles = (g + 15) / 16;
  if (g <= 8)
    return launch_decode_mma<Keys, HD, 4, true>(
        q, keys, pos, out, b, nh, nkv, split_tiles, splits, scale, st);
  if (tiles == 1)
    return launch_decode_mma<Keys, HD, 4, false>(
        q, keys, pos, out, b, nh, nkv, split_tiles, splits, scale, st);
  if (tiles == 2)
    return launch_decode_mma<Keys, HD, 2, false>(
        q, keys, pos, out, b, nh, nkv, split_tiles, splits, scale, st);
  return launch_decode_mma<Keys, HD, 1, false>(
      q, keys, pos, out, b, nh, nkv, split_tiles, splits, scale, st);
}

template <typename KVT>
cudaError_t launch_paged_split(const void* q, const void* pk, const void* pv,
                               const void* sk, const void* sv, const void* bt,
                               const void* pos, void* out, int b, int nh,
                               int nkv, int ps, int P, int hd,
                               int split_tiles, int splits, float scale,
                               cudaStream_t st) {
  const PagedKeys<KVT> keys{(const KVT*)pk, (const KVT*)pv, (const float*)sk,
                            (const float*)sv, (const int*)bt, ps, P};
  return hd == 128 ? launch_decode_bf16<PagedKeys<KVT>, 128>(
                         q, keys, pos, out, b, nh, nkv, split_tiles, splits,
                         scale, st)
                   : launch_decode_bf16<PagedKeys<KVT>, 64>(
                         q, keys, pos, out, b, nh, nkv, split_tiles, splits,
                         scale, st);
}

// B4 in bf16: the tensor maps of k and v, viewed as [b * nkv][len][hd], in
// boxes of 64 keys x 64 columns, 128-byte swizzle; keys past len read as
// zeros. cudaErrorInvalidValue when cuTensorMapEncodeTiled refuses a map.
cudaError_t launch_cache_split(const void* q, const void* k, const void* v,
                               const void* pos, void* out, int b, int nh,
                               int nkv, int len, int hd, int split_tiles,
                               int splits, float scale, cudaStream_t st) {
  CacheKeys keys;
  keys.len = len;
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)len,
                              (cuuint64_t)b * nkv};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2, (cuuint64_t)len * hd * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)kWinKeys, 1};
  for (int i = 0; i < 2; ++i)
    if (!hopper::make_map(i ? &keys.v : &keys.k,
                          CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, i ? v : k,
                          dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B))
      return cudaErrorInvalidValue;
  return hd == 128 ? launch_decode_bf16<CacheKeys, 128>(
                         q, keys, pos, out, b, nh, nkv, split_tiles, splits,
                         scale, st)
                   : launch_decode_bf16<CacheKeys, 64>(
                         q, keys, pos, out, b, nh, nkv, split_tiles, splits,
                         scale, st);
}

bool shape_ok(int rows, int hd) {
  return (hd == 64 || hd == 128) && rows >= 1 && rows <= kMaxRows;
}

// B4, B6 and B7 take `splits`: 1 to kMaxSplits (the caller's
// `decode_splits` / `paged_splits`) runs the key-split kernel over a
// cluster of that many blocks (bf16 only), each row cut over its own
// row_splits(tiles, split_tiles) of them (split_tiles >= 1; 1 gives every
// row min(splits, its tiles), the sweeps' forced counts); 0 runs the shared
// body, f32's route (kernels/sweep_decode.py also times it in bf16, beside
// the key-split kernel)
bool splits_ok(int dtype, int split_tiles, int splits) {
  return splits >= 0 && splits <= kMaxSplits && split_tiles >= 1 &&
         (dtype == 1 || splits == 0);
}

bool paged_ok(int nh, int nkv, int ps, int P, int hd, int dtype,
              int split_tiles, int splits) {
  return nkv >= 1 && nh % nkv == 0 && ps >= 1 && P >= 1 &&
         shape_ok(nh / nkv, hd) && splits_ok(dtype, split_tiles, splits);
}

}  // namespace

// Plain C entry points, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// Each returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// a shape the kernels do not take); the Python wrapper raises when it is not 0.

#define PT_DISPATCH(LAUNCH, ...)                                   \
  if (dtype == 1) {                                                \
    if (hd == 128) LAUNCH<__nv_bfloat16, 128>(__VA_ARGS__);        \
    else LAUNCH<__nv_bfloat16, 64>(__VA_ARGS__);                   \
  } else {                                                         \
    if (hd == 128) LAUNCH<float, 128>(__VA_ARGS__);                \
    else LAUNCH<float, 64>(__VA_ARGS__);                           \
  }

extern "C" int pt_decode_attention(const void* q, const void* k,
                                   const void* v, const void* pos, void* out,
                                   int b, int nh, int nkv, int len, int hd,
                                   int dtype, int split_tiles, int splits,
                                   float scale, void* stream) {
  if (nkv < 1 || nh % nkv || !shape_ok(nh / nkv, hd) || len < 1 ||
      !splits_ok(dtype, split_tiles, splits))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (splits == 0) {
    PT_DISPATCH(launch_decode, q, k, v, pos, out, b, nh, nkv, len, scale, st)
  } else {
    const cudaError_t e =
        launch_cache_split(q, k, v, pos, out, b, nh, nkv, len, hd,
                           split_tiles, splits, scale, st);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

// B5 takes `splits` (1 to kMaxSplits, the caller's `window_splits`): the
// blocks, and the cluster, over the keys of each (kv head, row) in bf16,
// each row cut over its own row_splits(tiles, split_tiles) of them; f32
// runs the shared body and takes 1
extern "C" int pt_window_attention(const void* q, const void* k,
                                   const void* v, const void* pos, void* out,
                                   int b, int s, int nh, int nkv, int len,
                                   int hd, int dtype, int split_tiles,
                                   int splits, float scale, void* stream) {
  if (nkv < 1 || nh % nkv || !shape_ok(s * (nh / nkv), hd) || splits < 1 ||
      splits > kMaxSplits || split_tiles < 1 || (dtype != 1 && splits != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) {
    const cudaError_t e =
        hd == 128 ? launch_window_bf16<128>(q, k, v, pos, out, b, s, nh, nkv,
                                            len, split_tiles, splits, scale,
                                            st)
                  : launch_window_bf16<64>(q, k, v, pos, out, b, s, nh, nkv,
                                           len, split_tiles, splits, scale,
                                           st);
    if (e != cudaSuccess) return (int)e;
  } else if (hd == 128) {
    launch_window_f32<128>(q, k, v, pos, out, b, s, nh, nkv, len, scale, st);
  } else {
    launch_window_f32<64>(q, k, v, pos, out, b, s, nh, nkv, len, scale, st);
  }
  return (int)cudaGetLastError();
}

extern "C" int pt_paged_decode_attention(const void* q, const void* pk,
                                         const void* pv, const void* bt,
                                         const void* pos, void* out, int b,
                                         int nh, int nkv, int ps, int P,
                                         int hd, int dtype, int split_tiles,
                                         int splits, float scale,
                                         void* stream) {
  if (!paged_ok(nh, nkv, ps, P, hd, dtype, split_tiles, splits))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (splits == 0) {
    PT_DISPATCH(launch_paged, q, pk, pv, bt, pos, out, b, nh, nkv, ps, P,
                scale, st)
  } else {
    const cudaError_t e = launch_paged_split<__nv_bfloat16>(
        q, pk, pv, nullptr, nullptr, bt, pos, out, b, nh, nkv, ps, P, hd,
        split_tiles, splits, scale, st);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

extern "C" int pt_paged_decode_attention_q8(
    const void* q, const void* pk, const void* pv, const void* sk,
    const void* sv, const void* bt, const void* pos, void* out, int b, int nh,
    int nkv, int ps, int P, int hd, int dtype, int split_tiles, int splits,
    float scale, void* stream) {
  if (!paged_ok(nh, nkv, ps, P, hd, dtype, split_tiles, splits))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (splits == 0) {
    PT_DISPATCH(launch_paged_q8, q, pk, pv, sk, sv, bt, pos, out, b, nh, nkv,
                ps, P, scale, st)
  } else {
    const cudaError_t e = launch_paged_split<int8_t>(
        q, pk, pv, sk, sv, bt, pos, out, b, nh, nkv, ps, P, hd, split_tiles,
        splits, scale, st);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}
