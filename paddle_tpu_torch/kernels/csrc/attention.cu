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
// Design (one body for all four): one block of 256 threads per (kv head,
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
// a few flops per byte. What the simple design
// leaves on the table: at b = 1 the grid has only nkv = 32 blocks for 132 SMs
// (no split of the keys across blocks with a second reduction pass), a
// ragged batch waits for its longest row, the staging goes through registers
// one tile ahead instead of a deeper cp.async or TMA pipeline, and the dot
// products run on the CUDA cores, not the tensor cores.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

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

template <typename T, int HD>
void launch_window(const void* q, const void* k, const void* v,
                   const void* pos, void* out, int b, int s, int nh, int nkv,
                   int len, float scale, cudaStream_t st) {
  auto kern = window_attention_kernel<T, HD>;
  kern<<<dim3(nkv, b), kThreads, smem_for<T, T, HD>(kern, s * (nh / nkv)),
         st>>>((const T*)q, (const T*)k, (const T*)v, (const int*)pos,
               (T*)out, s, nh, nkv, len, scale);
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

extern "C" int pt_window_attention(const void* q, const void* k,
                                   const void* v, const void* pos, void* out,
                                   int b, int s, int nh, int nkv, int len,
                                   int hd, int dtype, float scale,
                                   void* stream) {
  if (nkv < 1 || nh % nkv || !shape_ok(s * (nh / nkv), hd))
    return (int)cudaErrorInvalidValue;
  PT_DISPATCH(launch_window, q, k, v, pos, out, b, s, nh, nkv, len, scale,
              (cudaStream_t)stream)
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
