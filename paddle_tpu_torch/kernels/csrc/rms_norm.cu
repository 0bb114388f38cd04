// Fused RMSNorm for Hopper (sm_90a): B9 (forward) and B10 (backward).
//
// Each replaces one Pallas kernel of paddle_tpu/kernels/rms_norm.py:
//
//   rms_norm_fwd_kernel  <- _fwd_kernel (B9): y = x * r * w over rows
//       x [n, H], r = rsqrt(mean_H(x^2) + eps) in f32, r [n] f32 stored on
//       request.
//   rms_norm_bwd_kernel + rms_norm_dw_kernel  <- _bwd_kernel (B10):
//       dx = r * (gw - x * r^2 * mean_H(gw * x)), gw = g * w, and
//       dw = sum_rows(g * x * r), all in f32.
//
// Rounding (B9): y = rnd(rnd(x * r) * w) in x's dtype, the order of the
// composite it replaces on the port's path (normalise in f32, cast to x's
// dtype, multiply by w in the working dtype). The Pallas kernel rounds once,
// rnd(x * r * w); the port keeps the composite's two roundings so that its
// outputs stay those of the plain path. B10 computes in f32 and rounds dx
// to x's dtype and dw to w's dtype once each.
//
// What bounds them: bytes. B9 reads x and w once and writes y (and r): about
// 4 bytes an element in bf16 against a dozen flops, far below the ~295 flops
// a byte at which the H100's bf16 tensor cores would become the limit. B10
// reads x, g, w and r and writes dx (6 bytes an element) plus dw.
//
// Design, one pass over each tensor:
//   B9: one block per row. Each thread loads its 16-byte vectors of the row
//       (8 bf16 or 4 f32) into registers, sums their squares in f32, the
//       block reduces by warp shuffles and one shared-memory step, and the
//       thread writes y from the registers it already holds: x is read once.
//       At decode (8 rows) the kernel is latency-bound: one launch is what
//       counts there.
//   B10: the Pallas grid carries dw from one row block to the next in the
//       same output block, which serialises it (on one TPU core that is the
//       grid's order; on 132 SMs nothing carries over between blocks). Here
//       each block takes a strip of rows, sized so that the grid is a few
//       blocks per SM. A thread owns the same columns in every row of its
//       strip: it keeps w and its dw partial in f32 registers across the
//       strip, and writes dx row by row after the row's mean(gw * x) block
//       reduction. The strip's dw partial goes to an f32 scratch [strips, H]
//       (allocated by the wrapper); rms_norm_dw_kernel sums it over strips
//       in a fixed order and casts to w's dtype. No atomics: dw is
//       deterministic.
// Gate (checked by the wrapper, again here): bf16 or f32, x, g and w of one
// dtype, H % 8 == 0, H <= 16384, rows 16-byte aligned (row strides a
// multiple of 8 elements), any row count.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxH = 16384;
constexpr int kMaxThreads = 512;   // a block's threads; up to 8 vectors each

typedef __nv_bfloat16 bf16;

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int n = 4; };
template <> struct Vec<bf16> { static constexpr int n = 8; };

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

// x rounded to T and back to f32 (the composite's cast to x's dtype)
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, bf16) {
  return __bfloat162float(__float2bfloat16(x));
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

// B10: one block per strip of rows; a thread owns the same NV vectors of
// columns in every row of the strip
template <typename T, int NV>
__global__ void __launch_bounds__(kMaxThreads)
rms_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const float* __restrict__ r, const T* __restrict__ g,
                    T* __restrict__ dx, float* __restrict__ dw_part, int rows,
                    int H, long long ldx, long long ldg, int rows_per_strip,
                    float inv_h) {
  constexpr int V = Vec<T>::n;
  __shared__ float red[33];
  const int nvec = H / V;
  const int row0 = blockIdx.x * rows_per_strip;
  const int row1 = min(rows, row0 + rows_per_strip);
  float wv[NV][V], dw[NV][V];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = threadIdx.x + i * blockDim.x;
#pragma unroll
    for (int e = 0; e < V; ++e) dw[i][e] = 0.f;
    if (v < nvec) load_vec(w + v * V, wv[i]);
  }
  for (int row = row0; row < row1; ++row) {
    const T* xr = x + row * ldx;
    const T* gr = g + row * ldg;
    const float rr = r[row];
    float xv[NV][V], gw[NV][V];
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = threadIdx.x + i * blockDim.x;
      if (v < nvec) {
        float gv[V];
        load_vec(xr + v * V, xv[i]);
        load_vec(gr + v * V, gv);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          gw[i][e] = gv[e] * wv[i][e];
          dot += gw[i][e] * xv[i][e];
          dw[i][e] += gv[e] * xv[i][e] * rr;
        }
      }
    }
    const float m = block_sum(dot, red) * inv_h;
    const float rr2 = rr * rr;
    T* dxr = dx + row * (long long)H;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = threadIdx.x + i * blockDim.x;
      if (v < nvec) {
        float out[V];
#pragma unroll
        for (int e = 0; e < V; ++e)
          out[e] = rr * (gw[i][e] - xv[i][e] * rr2 * m);
        store_vec(dxr + v * V, out);
      }
    }
  }
  float* part = dw_part + (long long)blockIdx.x * H;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = threadIdx.x + i * blockDim.x;
    if (v < nvec) {
#pragma unroll
      for (int e = 0; e < V; e += 4) store_vec(part + v * V + e, dw[i] + e);
    }
  }
}

// dw[c] = sum over strips, in strip order, of dw_part[s, c]; cast to T
template <typename T>
__global__ void rms_norm_dw_kernel(const float* __restrict__ dw_part,
                                   T* __restrict__ dw, int strips, int H) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= H) return;
  float s = 0.f;
  for (int i = 0; i < strips; ++i) s += dw_part[(long long)i * H + c];
  if constexpr (sizeof(T) == 2)
    dw[c] = __float2bfloat16(s);
  else
    dw[c] = s;
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

template <typename T, int NV>
void bwd_nv(const void* x, const void* w, const void* r, const void* g,
            void* dx, void* dw_part, int rows, int H, long long ldx,
            long long ldg, int rows_per_strip, int strips, cudaStream_t st) {
  rms_norm_bwd_kernel<T, NV>
      <<<strips, threads_for(H / Vec<T>::n, NV), 0, st>>>(
          (const T*)x, (const T*)w, (const float*)r, (const T*)g, (T*)dx,
          (float*)dw_part, rows, H, ldx, ldg, rows_per_strip,
          1.0f / (float)H);
}

template <typename T>
int launch_bwd(const void* x, const void* w, const void* r, const void* g,
               void* dx, void* dw_part, void* dw, int rows, int H,
               long long ldx, long long ldg, int rows_per_strip, int strips,
               cudaStream_t st) {
  if (rows > 0) {
    switch (vecs_per_thread(H / Vec<T>::n)) {
      case 1: bwd_nv<T, 1>(x, w, r, g, dx, dw_part, rows, H, ldx, ldg,
                           rows_per_strip, strips, st); break;
      case 2: bwd_nv<T, 2>(x, w, r, g, dx, dw_part, rows, H, ldx, ldg,
                           rows_per_strip, strips, st); break;
      case 4: bwd_nv<T, 4>(x, w, r, g, dx, dw_part, rows, H, ldx, ldg,
                           rows_per_strip, strips, st); break;
      default: bwd_nv<T, 8>(x, w, r, g, dx, dw_part, rows, H, ldx, ldg,
                            rows_per_strip, strips, st); break;
    }
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  rms_norm_dw_kernel<T><<<(H + 255) / 256, 256, 0, st>>>(
      (const float*)dw_part, (T*)dw, rows > 0 ? strips : 0, H);
  return (int)cudaGetLastError();
}

}  // namespace

// B9. dtype 0: f32, 1: bf16. r may be null (nothing stored).
extern "C" int pt_rms_norm_fwd(const void* x, const void* w, void* y, void* r,
                               int rows, int H, int ldx, int dtype, float eps,
                               void* stream) {
  if (bad_shape(rows, H, ldx, x) || (uintptr_t)w % 16 != 0 ||
      (uintptr_t)y % 16 != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) return launch_fwd<bf16>(x, w, y, r, rows, H, ldx, eps, st);
  return launch_fwd<float>(x, w, y, r, rows, H, ldx, eps, st);
}

// B10. dw_part: f32 [strips, H]; strips * rows_per_strip >= rows.
extern "C" int pt_rms_norm_bwd(const void* x, const void* w, const void* r,
                               const void* g, void* dx, void* dw_part,
                               void* dw, int rows, int H, int ldx, int ldg,
                               int rows_per_strip, int strips, int dtype,
                               void* stream) {
  if (bad_shape(rows, H, ldx, x) || bad_shape(rows, H, ldg, g) ||
      (uintptr_t)w % 16 != 0 || (uintptr_t)dx % 16 != 0 ||
      rows_per_strip < 1 || strips < 1 ||
      (long long)rows_per_strip * strips < rows ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return launch_bwd<bf16>(x, w, r, g, dx, dw_part, dw, rows, H, ldx, ldg,
                            rows_per_strip, strips, st);
  return launch_bwd<float>(x, w, r, g, dx, dw_part, dw, rows, H, ldx, ldg,
                           rows_per_strip, strips, st);
}
