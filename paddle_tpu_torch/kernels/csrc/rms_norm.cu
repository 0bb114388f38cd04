// Fused RMSNorm for Hopper (sm_90a): B9 (forward) and B10 (backward).
//
// Each replaces one Pallas kernel of paddle_tpu/kernels/rms_norm.py:
//
//   rms_norm_fwd_kernel  <- _fwd_kernel (B9): y = x * r * w over rows
//       x [n, H], r = rsqrt(mean_H(x^2) + eps) in f32, r [n] f32 stored on
//       request.
//   rms_norm_bwd_kernel  <- _bwd_kernel (B10):
//       dx = r * (gw - x * r^2 * mean_H(gw * x)), gw = g * w, and
//       dw = sum_rows(g * x * r), all in f32, in one launch.
//
// Rounding (B9): y = rnd(rnd(x * r) * w) in x's dtype, the order of the
// composite it replaces on the port's path (normalise in f32, cast to x's
// dtype, multiply by w in the working dtype). The Pallas kernel rounds once,
// rnd(x * r * w); the port keeps the composite's two roundings so that its
// outputs stay those of the plain path. B10 computes in f32 and rounds dx
// to x's dtype and dw to w's dtype once each.
//
// What bounds them: bytes. B9 reads x and w once and writes y (and r): about 4
// bytes an element in bf16 or fp16 against a dozen flops, far below the ~295
// flops a byte at which the H100's bf16 tensor cores would become the limit.
// B10 reads x, g, w and r and writes dx (6 bytes an element) plus dw.
//
// B9: one block per row. Each thread loads its 16-byte vectors of the row (8
// bf16 or fp16, or 4 f32) into registers, sums their squares in f32, the block
// reduces by warp shuffles and one shared-memory step, and the thread writes y
// from the registers it already holds: x is read once. At decode (8 rows) the
// kernel is latency-bound: one launch is what counts there.
//
// B10. The Pallas grid carries dw from one row block to the next in the same
// output block, which serialises it (on one TPU core that is the grid's
// order; on 132 SMs nothing carries over between blocks). Here:
//   - Rows go to row groups of R threads (`rms_norm.bwd_plan`: about 2
//     vectors a thread, R <= 512), G row groups a block (G R <= 512), one
//     block an SM (`rms_norm.bwd_grid`): row group u of U takes the rows
//     [u rows / U, (u + 1) rows / U). A thread owns the same NV vectors of
//     columns in every row: w and its dw partial stay in registers.
//   - Each row group streams its rows' x and g through a ring of S stages
//     of shared memory (cp.async, 16 bytes a copy). A thread copies exactly
//     the vectors it later reads, so the ring needs no barrier: while a row
//     reduces, the next S rows are in flight. The row's mean(gw * x) is a
//     warp-shuffle sum and, for R > 32, one named barrier of the row group
//     over a double-buffered slot of warp sums; the thread then writes its
//     dx vectors. At [4096, 4096] bf16: R = 256, G = 2, S = 2, 4 rows of
//     16 KB in flight an SM.
//   - dw is summed on the card in a fixed order, inside the launch. Blocks
//     run in clusters of C (4, or fewer for small grids). Each block leaves
//     its row groups' partials in shared memory over the ring; block z of a
//     cluster sums columns [z H / C, (z + 1) H / C) over the cluster's
//     blocks and row groups, in rank and group order, through distributed
//     shared memory. With one cluster that is dw; otherwise each cluster
//     writes its partial [H] f32 to the scratch `part`, fences, and counts
//     its arrival on `counter` (atomicInc, which wraps it back to 0 for the
//     next call). The last cluster to arrive sums the cluster partials in
//     index order, each block its share of the columns. Nothing depends on
//     block timing: two calls give the same bits. The partials move
//     clusters x H x 8 bytes (0.5 MB at 33 clusters and H 4096), against
//     the 100.7 MB the bound counts, and no second launch reads them.
// Gate (checked by the wrapper, again here): bf16, fp16 or f32, x, g and w
// of one dtype, H % 8 == 0, H <= 16384, rows 16-byte aligned (row strides a
// multiple of 8 elements), any row count. Calls that share `counter` and
// `part` must not run concurrently: the wrapper keeps one pair a (device,
// stream) (`rms_norm._bwd_scratch`), and calls on one stream run in order.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kMaxH = 16384;
constexpr int kMaxThreads = 512;   // a block's threads; up to 8 vectors each

typedef __nv_bfloat16 bf16;
typedef __half f16;

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int n = 4; };
template <> struct Vec<bf16> { static constexpr int n = 8; };
template <> struct Vec<f16> { static constexpr int n = 8; };

__device__ __forceinline__ void load_vec(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load_vec(const bf16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load_vec(const f16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store_vec(float* p, const float* in) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}
__device__ __forceinline__ void store_vec(bf16* p, const float* in) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = v;
}
__device__ __forceinline__ void store_vec(f16* p, const float* in) {
  uint4 v;
  __half2* h = reinterpret_cast<__half2*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2half2_rn(in[2 * i], in[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = v;
}

// a stored 16-byte vector (4 f32, or 8 bf16 or fp16) as floats
__device__ __forceinline__ void unpack(const uint4& v, float* out, float) {
  out[0] = __uint_as_float(v.x); out[1] = __uint_as_float(v.y);
  out[2] = __uint_as_float(v.z); out[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(const uint4& v, float* out, bf16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack(const uint4& v, float* out, f16) {
  const __half2* h = reinterpret_cast<const __half2*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
// two consecutive dw entries, rounded once to T
__device__ __forceinline__ void store_pair(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void store_pair(bf16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
}
__device__ __forceinline__ void store_pair(f16* p, float2 v) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(v.x, v.y);
}

// x rounded to T and back to f32 (the composite's cast to x's dtype)
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, bf16) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float round_to(float x, f16) {
  return __half2float(__float2half_rn(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// sum of x over the block, returned to every thread. `red` holds 33 floats;
// the two barriers let a loop call it once per row.
__device__ __forceinline__ float block_sum(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  x = warp_sum(x);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    float t = lane < nwarps ? red[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) red[32] = t;
  }
  __syncthreads();
  return red[32];
}

// B9: one block of ceil(H / (V * NV)) threads per row, NV vectors a thread
template <typename T, int NV>
__global__ void __launch_bounds__(kMaxThreads)
rms_norm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ y, float* __restrict__ r, int H,
                    long long ldx, float inv_h, float eps) {
  constexpr int V = Vec<T>::n;
  __shared__ float red[33];
  const int nvec = H / V;
  const long long row = blockIdx.x;
  const T* xr = x + row * ldx;
  T* yr = y + row * (long long)H;
  float xv[NV][V];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = threadIdx.x + i * blockDim.x;
    if (v < nvec) {
      load_vec(xr + v * V, xv[i]);
#pragma unroll
      for (int e = 0; e < V; ++e) ss += xv[i][e] * xv[i][e];
    }
  }
  const float rr = rsqrtf(block_sum(ss, red) * inv_h + eps);
  if (r != nullptr && threadIdx.x == 0) r[row] = rr;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = threadIdx.x + i * blockDim.x;
    if (v < nvec) {
      float wv[V];
      load_vec(w + v * V, wv);
#pragma unroll
      for (int e = 0; e < V; ++e)
        xv[i][e] = round_to(xv[i][e] * rr, T()) * wv[e];
      store_vec(yr + v * V, xv[i]);
    }
  }
}

// blocks a cluster of B10 at most (rms_norm.BWD_CLUSTER)
constexpr int kMaxCluster = 4;

// B10: one launch. Row group rg (R threads) of block blockIdx.x takes its
// strip of rows through a ring of S stages of x and g; a thread owns the
// same NV vectors of columns in every row. Then dw over the cluster and the
// clusters (the design above).
template <typename T, int NV, int S>
__global__ void __launch_bounds__(kMaxThreads, 1)
rms_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const float* __restrict__ r, const T* __restrict__ g,
                    T* __restrict__ dx, T* __restrict__ dw,
                    float* __restrict__ part, unsigned* __restrict__ counter,
                    int rows, int H, long long ldx, long long ldg, int R,
                    float inv_h) {
  using namespace hopper;
  constexpr int V = Vec<T>::n;
  extern __shared__ __align__(16) uint8_t bwd_smem_raw[];
  const int G = blockDim.x / R;
  const int tid = threadIdx.x, rg = tid / R, t = tid % R;
  const int lane = tid & 31, wig = t >> 5;          // warp in the row group
  const int nvec = H / V;
  T* ring = reinterpret_cast<T*>(bwd_smem_raw) + (size_t)rg * S * 2 * H;
  // each row group's warp sums, double-buffered by row: [2][G][16]
  float* red = reinterpret_cast<float*>(bwd_smem_raw +
                                        (size_t)G * S * 2 * H * sizeof(T));
  unsigned* flag = reinterpret_cast<unsigned*>(red + 2 * G * 16);

  // this row group's rows [row0, row0 + n)
  const long long U = (long long)gridDim.x * G;
  const long long u = (long long)blockIdx.x * G + rg;
  const int row0 = (int)(u * rows / U);
  const int n = (int)((u + 1) * rows / U) - row0;

  uint4 wr[NV];            // this thread's vectors of w, as stored
  float dwp[NV][V];        // and of its dw partial
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = t + i * R;
#pragma unroll
    for (int e = 0; e < V; ++e) dwp[i][e] = 0.f;
    if (v < nvec) wr[i] = *reinterpret_cast<const uint4*>(w + v * V);
  }
  // local row k's x and g into stage `stage`: this thread's vectors only
  auto issue = [&](int k, int stage) {
    const long long row = row0 + k;
    T* xs = ring + stage * 2 * H;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = t + i * R;
      if (v < nvec) {
        cp_async16(smem_u32(xs + v * V), x + row * ldx + v * V, 16);
        cp_async16(smem_u32(xs + H + v * V), g + row * ldg + v * V, 16);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (s < n) issue(s, s);
    cp_async_commit();
  }
  float r_next = n > 0 ? __ldg(r + row0) : 0.f;
  for (int k = 0; k < n; ++k) {
    const int stage = k % S;
    const float rr = r_next;
    if (k + 1 < n) r_next = __ldg(r + row0 + k + 1);
    cp_async_wait<S - 1>();              // row k's copies (this thread's)
    const T* xs = ring + stage * 2 * H;
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = t + i * R;
      if (v < nvec) {
        float xf[V], gf[V], wf[V];
        unpack(*reinterpret_cast<const uint4*>(xs + v * V), xf, T());
        unpack(*reinterpret_cast<const uint4*>(xs + H + v * V), gf, T());
        unpack(wr[i], wf, T());
#pragma unroll
        for (int e = 0; e < V; ++e) {
          dot += gf[e] * wf[e] * xf[e];
          dwp[i][e] += gf[e] * xf[e] * rr;
        }
      }
    }
    dot = warp_sum(dot);
    float m = dot;
    if (R > 32) {
      float* slot = red + ((k & 1) * G + rg) * 16;
      if (lane == 0) slot[wig] = dot;
      named_sync(1 + rg, R);
      m = 0.f;
      for (int i = 0; i < R / 32; ++i) m += slot[i];
    }
    m *= inv_h;
    const float rr2 = rr * rr;
    T* dxr = dx + (long long)(row0 + k) * H;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = t + i * R;
      if (v < nvec) {
        float xf[V], gf[V], wf[V];
        unpack(*reinterpret_cast<const uint4*>(xs + v * V), xf, T());
        unpack(*reinterpret_cast<const uint4*>(xs + H + v * V), gf, T());
        unpack(wr[i], wf, T());
#pragma unroll
        for (int e = 0; e < V; ++e)
          xf[e] = rr * (gf[e] * wf[e] - xf[e] * rr2 * m);
        store_vec(dxr + v * V, xf);
      }
    }
    // the stage is read (its values are in the dx just stored): the row S
    // ahead into it
    if (k + S < n) issue(k + S, stage);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();                       // every row group is off the ring

  // the row groups' dw partials over the ring: [G][H] f32
  float* slab = reinterpret_cast<float*>(bwd_smem_raw);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = t + i * R;
    if (v < nvec)
#pragma unroll
      for (int e = 0; e < V; e += 4)
        store_vec(slab + (size_t)rg * H + v * V + e, dwp[i] + e);
  }
  cluster_sync();
  // block z of the cluster: columns [c0, c0 + cols), two at a time, summed
  // over the cluster's blocks and row groups in rank and group order
  const int C = (int)cluster_size(), z = (int)cluster_rank();
  const int cols = H / C, c0 = z * cols;
  const int nclusters = gridDim.x / C, cid = blockIdx.x / C;
  const uint32_t slab_u32 = smem_u32(slab);
  for (int c = c0 + 2 * tid; c < c0 + cols; c += 2 * blockDim.x) {
    float2 sum = make_float2(0.f, 0.f);
    for (int k = 0; k < C; ++k)
      for (int gg = 0; gg < G; ++gg) {
        const float2 p = ld_cluster2(map_rank(
            slab_u32 + (uint32_t)((size_t)gg * H + c) * 4, (uint32_t)k));
        sum.x += p.x;
        sum.y += p.y;
      }
    if (nclusters == 1)
      store_pair(dw + c, sum);
    else
      *reinterpret_cast<float2*>(part + (size_t)cid * H + c) = sum;
  }
  if (nclusters == 1) {
    cluster_sync();   // no block leaves while another reads its partials
    return;
  }
  __threadfence();    // this cluster's partial, before its arrival counts
  cluster_sync();
  if (z == 0 && tid == 0) {
    const unsigned last =
        atomicInc(counter, (unsigned)(nclusters - 1)) ==
        (unsigned)(nclusters - 1);
    for (int k = 0; k < C; ++k)
      st_cluster(map_rank(smem_u32(flag), (uint32_t)k), last);
  }
  cluster_sync();
  if (*flag == 0) return;
  // the last cluster: every cluster's partial of its columns, in index
  // order (through L2: the partials were written by other SMs)
  __threadfence();
  for (int c = c0 + 2 * tid; c < c0 + cols; c += 2 * blockDim.x) {
    float2 sum = make_float2(0.f, 0.f);
#pragma unroll 8
    for (int k = 0; k < nclusters; ++k) {
      const float2 p =
          __ldcg(reinterpret_cast<const float2*>(part + (size_t)k * H + c));
      sum.x += p.x;
      sum.y += p.y;
    }
    store_pair(dw + c, sum);
  }
}

// vectors a thread: the fewest that keep a block within kMaxThreads
int vecs_per_thread(int nvec) {
  int nv = 1;
  while (nvec > nv * kMaxThreads) nv *= 2;
  return nv;
}

int threads_for(int nvec, int nv) {
  const int t = (nvec + nv - 1) / nv;
  return ((t + 31) / 32) * 32;
}

bool bad_shape(int rows, int H, long long ld, const void* p) {
  return rows < 0 || H < 8 || H % 8 != 0 || H > kMaxH || ld < H ||
         ld % 8 != 0 || (uintptr_t)p % 16 != 0;
}

template <typename T, int NV>
void fwd_nv(const void* x, const void* w, void* y, void* r, int rows, int H,
            long long ldx, float eps, cudaStream_t st) {
  rms_norm_fwd_kernel<T, NV>
      <<<rows, threads_for(H / Vec<T>::n, NV), 0, st>>>(
          (const T*)x, (const T*)w, (T*)y, (float*)r, H, ldx,
          1.0f / (float)H, eps);
}

template <typename T>
int launch_fwd(const void* x, const void* w, void* y, void* r, int rows,
               int H, long long ldx, float eps, cudaStream_t st) {
  if (rows == 0) return 0;
  switch (vecs_per_thread(H / Vec<T>::n)) {
    case 1: fwd_nv<T, 1>(x, w, y, r, rows, H, ldx, eps, st); break;
    case 2: fwd_nv<T, 2>(x, w, y, r, rows, H, ldx, eps, st); break;
    case 4: fwd_nv<T, 4>(x, w, y, r, rows, H, ldx, eps, st); break;
    default: fwd_nv<T, 8>(x, w, y, r, rows, H, ldx, eps, st); break;
  }
  return (int)cudaGetLastError();
}

// B10's plan for H and the dtype (mirrored by rms_norm.bwd_plan): R threads
// a row group, about 2 vectors a thread (NV, a power of two; 4 ran 8-15%
// slower on an H100, kernels/sweep_rms.py), G row groups a block (G R <=
// 512, G <= 8: a named barrier each), S = 2 stages when the ring fits
// kRingBudget, else 1
constexpr int kRingBudget = 192 * 1024;
struct BwdPlan {
  int R, NV, G, S;
};
BwdPlan bwd_plan(int H, int itemsize) {
  const int nvec = H / (16 / itemsize);
  const int want = ((nvec + 1) / 2 + 31) / 32 * 32;
  const int R = want < kMaxThreads ? want : kMaxThreads;
  int NV = 1;
  while (NV * R < nvec) NV *= 2;
  const int G = kMaxThreads / R < 8 ? kMaxThreads / R : 8;
  const int S = G * 2 * (2 * H * itemsize) <= kRingBudget ? 2 : 1;
  return {R, NV, G, S};
}
size_t bwd_smem(int H, int itemsize, const BwdPlan& p) {
  return (size_t)p.G * p.S * 2 * H * itemsize + 2 * p.G * 16 * 4 + 16;
}

// the blocks of `cluster` that can run at once for this kernel and shared
// memory: a grid past them would run a second wave of clusters. Asked once
// per (device, kernel, shared memory, cluster) and kept.
template <typename K>
int coresident_blocks(K kernel, int threads, size_t smem, int cluster) {
  struct Entry {
    int dev;
    const void* fn;
    size_t smem;
    int threads, cluster, blocks;
  };
  static Entry seen[32];
  static int n_seen = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].dev == dev && seen[i].fn == (const void*)kernel &&
        seen[i].smem == smem && seen[i].threads == threads &&
        seen[i].cluster == cluster)
      return seen[i].blocks;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &cfg) !=
          cudaSuccess ||
      clusters < 1) {
    cudaGetLastError();   // clear it: the launch itself reports a real fault
    return 1 << 30;
  }
  if (n_seen < 32) seen[n_seen++] = {dev, (const void*)kernel, smem, threads,
                                     cluster, clusters * cluster};
  return clusters * cluster;
}

template <typename T, int NV, int S>
int bwd_launch(const void* x, const void* w, const void* r, const void* g,
               void* dx, void* dw, void* part, void* counter, int rows,
               int H, long long ldx, long long ldg, int blocks, int cluster,
               const BwdPlan& p, cudaStream_t st) {
  auto kern = rms_norm_bwd_kernel<T, NV, S>;
  const size_t smem = bwd_smem(H, (int)sizeof(T), p);
  hopper::opt_in_smem<rms_norm_bwd_kernel<T, NV, S>>(kRingBudget + 2048);
  const int fit = coresident_blocks(kern, p.G * p.R, smem, cluster);
  if (blocks > fit) blocks = fit / cluster * cluster;
  return (int)hopper::launch_cluster(
      kern, dim3(blocks), dim3(p.G * p.R), smem, st, dim3(cluster), x, w, r,
      g, dx, dw, part, counter, rows, H, ldx, ldg, p.R, 1.0f / (float)H);
}

template <typename T>
int launch_bwd(const void* x, const void* w, const void* r, const void* g,
               void* dx, void* dw, void* part, void* counter, int rows,
               int H, long long ldx, long long ldg, int blocks, int cluster,
               cudaStream_t st) {
  const BwdPlan p = bwd_plan(H, (int)sizeof(T));
  int err;
#define PT_BWD(NV, S)                                                      \
  err = bwd_launch<T, NV, S>(x, w, r, g, dx, dw, part, counter, rows, H,   \
                             ldx, ldg, blocks, cluster, p, st)
  // NV 8 only in f32: bf16 and fp16 rows of H <= 16384 take at most 4
  // vectors a thread of 512
  if (p.S == 2) {
    switch (p.NV) {
      case 1: PT_BWD(1, 2); break;
      case 2: PT_BWD(2, 2); break;
      case 4: PT_BWD(4, 2); break;
      default:
        if constexpr (sizeof(T) == 4) PT_BWD(8, 2);
        else return (int)cudaErrorInvalidValue;
        break;
    }
  } else {
    switch (p.NV) {
      case 1: PT_BWD(1, 1); break;
      case 2: PT_BWD(2, 1); break;
      case 4: PT_BWD(4, 1); break;
      default:
        if constexpr (sizeof(T) == 4) PT_BWD(8, 1);
        else return (int)cudaErrorInvalidValue;
        break;
    }
  }
#undef PT_BWD
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

}  // namespace

// B9. dtype 0: f32, 1: bf16, 2: fp16. r may be null (nothing stored).
extern "C" int pt_rms_norm_fwd(const void* x, const void* w, void* y, void* r,
                               int rows, int H, int ldx, int dtype, float eps,
                               void* stream) {
  if (bad_shape(rows, H, ldx, x) || (uintptr_t)w % 16 != 0 ||
      (uintptr_t)y % 16 != 0 || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) return launch_fwd<bf16>(x, w, y, r, rows, H, ldx, eps, st);
  if (dtype == 2) return launch_fwd<f16>(x, w, y, r, rows, H, ldx, eps, st);
  return launch_fwd<float>(x, w, y, r, rows, H, ldx, eps, st);
}

// B10. part: f32 scratch of at least (blocks / cluster) * H; counter: a
// zeroed unsigned the kernel leaves at 0 (one a device); blocks (a
// multiple of cluster, 1, 2 or 4) from rms_norm.bwd_grid, fewer when the
// card cannot hold that many clusters at once.
extern "C" int pt_rms_norm_bwd(const void* x, const void* w, const void* r,
                               const void* g, void* dx, void* dw, void* part,
                               void* counter, int rows, int H, int ldx,
                               int ldg, int blocks, int cluster, int dtype,
                               void* stream) {
  if (bad_shape(rows, H, ldx, x) || bad_shape(rows, H, ldg, g) ||
      (uintptr_t)w % 16 != 0 || (uintptr_t)dx % 16 != 0 ||
      (uintptr_t)dw % 8 != 0 || (uintptr_t)part % 8 != 0 || blocks < 1 ||
      (cluster != 1 && cluster != 2 && cluster != kMaxCluster) ||
      blocks % cluster || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return launch_bwd<bf16>(x, w, r, g, dx, dw, part, counter, rows, H, ldx,
                            ldg, blocks, cluster, st);
  if (dtype == 2)
    return launch_bwd<f16>(x, w, r, g, dx, dw, part, counter, rows, H, ldx,
                           ldg, blocks, cluster, st);
  return launch_bwd<float>(x, w, r, g, dx, dw, part, counter, rows, H, ldx,
                           ldg, blocks, cluster, st);
}
