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
// B5 in bf16 has a kernel of its own, window_mma_kernel (the keys split
// over a thread-block cluster, tensor-core products: its design is written
// out above it). The rest share one body:
//
// Design (B4, B6, B7, and B5 in f32): one block of 256 threads per (kv head,
// row). The block holds the R query rows that share the kv head (R = g for
// B4/B6, s * g for B5, at most 64) in shared memory as f32 and walks the keys
// up to the row's watermark in tiles (64 keys in bf16, 32 in f32). The K and
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
// a few flops per byte. What the shared body
// leaves on the table (B5's bf16 kernel takes it, B4, B6 and B7 not yet):
// at b = 1 the grid has only nkv = 32 blocks for 132 SMs, a ragged batch
// waits for its longest row, the staging goes through registers one tile
// ahead instead of a deeper cp.async or TMA pipeline, and the dot products
// run on the CUDA cores, not the tensor cores.

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
// One block per (kv head, row, split); the splits of a (kv head, row) form
// one thread-block cluster. Split z of nsplit walks key tiles [z T / nsplit,
// (z + 1) T / nsplit) of the row's T = last / 64 + 1 tiles (every key the
// row's window sees lies in one of them); the caller picks nsplit
// (`window_splits`: 2 at b = 1 and 32 kv heads, one block for every two
// SMs, which ran faster than 4 or 8). Its K/V tiles stream through a ring of
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
// z + nsplit, ...: a warp a row, one lane per (split, warp) partial read
// from the owning block's shared memory (distributed shared memory), M the
// largest m, L = sum l e^(m - M), out = sum O e^(m - M) / L in split order,
// so the result does not depend on block timing. A second cluster barrier
// keeps every block's partials alive until all have read them.

constexpr int kWinThreads = 128;
constexpr int kWinKeys = 64;       // keys a tile
constexpr int kMaxSplits = 8;      // blocks a portable cluster holds
constexpr float kLog2e = 1.4426950408889634f;

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
    float scale) {
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
  const int tb = z * n_tiles / nsplit;
  const int nt = (z + 1) * n_tiles / nsplit - tb;
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

  // combine: a warp a row; lane p < nsplit * KG holds partial p (split
  // p / KG, warp p % KG of the row's tile)
  const int parts = nsplit * KG;
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
                              int nh, int nkv, int len, int splits,
                              float scale, cudaStream_t st) {
  hopper::opt_in_smem<window_mma_kernel<HD, KG>>(Win<HD>::kSmem);
  return hopper::launch_cluster(
      window_mma_kernel<HD, KG>, dim3(nkv, b, splits), dim3(kWinThreads),
      Win<HD>::kSmem, st, dim3(1, 1, splits), q, k, v, pos, out, s, nh, nkv,
      len, scale);
}

// KG, the warps that share a tile of keys: 4 / the 16-row tiles (3 -> 4)
template <int HD>
cudaError_t launch_window_bf16(const void* q, const void* k, const void* v,
                               const void* pos, void* out, int b, int s,
                               int nh, int nkv, int len, int splits,
                               float scale, cudaStream_t st) {
  const int tiles = (s * (nh / nkv) + 15) / 16;
  if (tiles == 1)
    return launch_window_mma<HD, 4>(q, k, v, pos, out, b, s, nh, nkv, len,
                                    splits, scale, st);
  if (tiles == 2)
    return launch_window_mma<HD, 2>(q, k, v, pos, out, b, s, nh, nkv, len,
                                    splits, scale, st);
  return launch_window_mma<HD, 1>(q, k, v, pos, out, b, s, nh, nkv, len,
                                  splits, scale, st);
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

bool shape_ok(int rows, int hd) {
  return (hd == 64 || hd == 128) && rows >= 1 && rows <= kMaxRows;
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
                                   int dtype, float scale, void* stream) {
  if (nkv < 1 || nh % nkv || !shape_ok(nh / nkv, hd))
    return (int)cudaErrorInvalidValue;
  PT_DISPATCH(launch_decode, q, k, v, pos, out, b, nh, nkv, len, scale,
              (cudaStream_t)stream)
  return (int)cudaGetLastError();
}

// B5 takes `splits` (1 to kMaxSplits, the caller's `window_splits`): the
// blocks, and the cluster, over the keys of each (kv head, row) in bf16;
// f32 runs the shared body and takes 1
extern "C" int pt_window_attention(const void* q, const void* k,
                                   const void* v, const void* pos, void* out,
                                   int b, int s, int nh, int nkv, int len,
                                   int hd, int dtype, int splits, float scale,
                                   void* stream) {
  if (nkv < 1 || nh % nkv || !shape_ok(s * (nh / nkv), hd) || splits < 1 ||
      splits > kMaxSplits || (dtype != 1 && splits != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) {
    const cudaError_t e =
        hd == 128 ? launch_window_bf16<128>(q, k, v, pos, out, b, s, nh, nkv,
                                            len, splits, scale, st)
                  : launch_window_bf16<64>(q, k, v, pos, out, b, s, nh, nkv,
                                           len, splits, scale, st);
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
                                         int hd, int dtype, float scale,
                                         void* stream) {
  if (nkv < 1 || nh % nkv || ps < 1 || P < 1 || !shape_ok(nh / nkv, hd))
    return (int)cudaErrorInvalidValue;
  PT_DISPATCH(launch_paged, q, pk, pv, bt, pos, out, b, nh, nkv, ps, P,
              scale, (cudaStream_t)stream)
  return (int)cudaGetLastError();
}

extern "C" int pt_paged_decode_attention_q8(
    const void* q, const void* pk, const void* pv, const void* sk,
    const void* sv, const void* bt, const void* pos, void* out, int b, int nh,
    int nkv, int ps, int P, int hd, int dtype, float scale, void* stream) {
  if (nkv < 1 || nh % nkv || ps < 1 || P < 1 || !shape_ok(nh / nkv, hd))
    return (int)cudaErrorInvalidValue;
  PT_DISPATCH(launch_paged_q8, q, pk, pv, sk, sv, bt, pos, out, b, nh, nkv,
              ps, P, scale, (cudaStream_t)stream)
  return (int)cudaGetLastError();
}
