// Flash attention forward and backward for Hopper (sm_90a): B1, B2, B3.
//
// Each replaces one Pallas kernel of paddle_tpu/kernels/flash_attention.py:
//
//   flash_fwd_tma_kernel  <- _fwd_kernel     (B1, :112): out and the f32 lse of
//       causal or full online-softmax attention (bf16; flash_fwd_f32_kernel
//       in f32).
//   flash_bwd_dq_kernel   <- _bwd_dq_kernel  (B2, :215): dq = scale * sum_j
//       p * (dp - delta) * k, P rebuilt from lse.
//   flash_bwd_dkv_kernel  <- _bwd_dkv_kernel (B3, :260): dk, dv of one kv head,
//       summed over the g query heads of its group inside one block.
//
// Layout: the public one, read through strides with no copies: q, do, out, dq
// [B, Sq, H, D]; k, v [B, Sk, Hk, D]; dk, dv [B, Sk, Hk, D] f32; lse, delta
// [B, H, Sq] f32. Query head h reads kv head h / (H / Hk). Causal: query i
// sees keys j <= i + (Sk - Sq) (the offset diagonal); a key tile past every
// row's diagonal is never visited. Masks (causal, ragged tails past Sq / Sk)
// are selects on p after the exp, never products with a 0/1 mask: a row with
// no visible key has lse = -1e30, and exp(s - lse) overflows. Such a row
// writes out 0 and lse -1e30 (:159-166). Rows and keys past Sq / Sk are
// zero-filled in shared memory and masked.
//
// B1, bf16 (flash_fwd_tma_kernel): what bounds it is operations (68.7 GFLOP
// at the 7B leg's shape, 0.07 ms at 989 TFLOP/s), and only wgmma reaches
// that rate. One block of three warpgroups per (128-row Q tile, head, batch),
// long rows first. Warpgroup 2 gives up its registers (setmaxnreg) and one
// of its threads issues every copy by TMA over 4-D tensor maps of the public
// [B, S, H, D] layout, boxes of 1 x 128 rows x 1 x 64 columns in the 128-byte
// swizzle (D = 128 takes two): Q once, then K and V tiles of 128 keys through
// a 2-stage ring, each tile on its own mbarrier so that Q.K^T starts before V
// lands; rows past Sq and Sk arrive as zeros. Each consumer warpgroup owns 64
// rows: S = Q.K^T by wgmma SS (K the K-major B operand), the online softmax on
// the f32 scores in registers (scale * log2 e folded into one FMA before
// exp2), P rounded to bf16 in registers as the A operand of wgmma RS for
// P.V, V the MN-major B operand: P never touches shared memory. Only the key
// tiles that the offset diagonal or the Sk tail crosses run the mask (the
// first ones of the loop, which walks the key tiles backwards); the other
// iterations run none. The two warpgroups run unsynchronised, so one's
// softmax overlaps the other's products.
//
// B2, B3 (bf16): one block of 4 warps per (64-row tile, head, batch) for
// B2, per (64-key tile, kv head, batch) for B3. Every product runs on the
// tensor cores as mma.sync m16n8k16 (bf16 in, f32 accumulators) with the
// fragment layouts of the PTX ISA, so the score tile and the accumulators stay
// in registers: the softmax statistics are per-row f32 values reduced across a
// quad of lanes, and P (B2) or dS (B2, B3) becomes the next product's A
// operand in place, rounded to bf16 where the reference rounds
// (p.astype(v.dtype), ds.astype(k.dtype), p.astype(do.dtype)). Tiles stream
// through a double-buffered ring in shared memory filled by cp.async (16
// bytes a thread, zero-fill past the end): K/V tiles of 64 keys for B2, Q/dO
// tiles of 32 rows for B3. B3 keeps dk and dv of its 64 keys in registers
// across the whole group and all q tiles, so the sum over the group needs no
// atomics and is deterministic.
//
// f32 (the parity checks and the f32 training check only): the same three
// functions on the CUDA cores in full f32, 32 x 32 tiles, 256 threads, one
// thread per (row, key) score and per (rows, column) accumulator.
//
// What bounds them: operations. At the 7B leg's shape (b2 h32 s2048 d128,
// causal) B1 does 68.7 GFLOP, B2 103, B3 137: 0.07-0.14 ms at 989 TFLOP/s,
// against ~0.04 ms of bytes. What B1's design leaves: a warpgroup waits for
// its own products (a software pipeline that issues tile j's Q.K^T beside
// tile j - 1's P.V measured slower: the consumer code is held to the 168
// registers of the block's launch bound, setmaxnreg notwithstanding, and it
// spilled), the block is not persistent, and the two warpgroups are not
// scheduled against each other (FA3's ping-pong). What B2/B3's
// simple design leaves: mma.sync reaches about two thirds of the wgmma rate,
// there is no TMA or warp specialisation, V and the strided operands are
// read from shared memory two bf16 at a time (no ldmatrix), and a diagonal
// tile computes its masked half.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// tensor-core and copy helpers
// ---------------------------------------------------------------------------

// c[16x8] += a[16x16] @ b[16x8]. Fragments (lane = 4 * g + t):
//   a[0]: row g,   k 2t..2t+1    a[1]: row g+8, k 2t..2t+1
//   a[2]: row g,   k 2t+8..+9    a[3]: row g+8, k 2t+8..+9
//   b[0]: k 2t..2t+1, col g      b[1]: k 2t+8..+9, col g
//   c[0..1]: row g, cols 2t, 2t+1; c[2..3]: row g+8, cols 2t, 2t+1
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two consecutive bf16 (the lower index in the low half)
__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
// two bf16 one row apart
__device__ __forceinline__ uint32_t ld_pair_strided(const bf16* p, int ld) {
  const uint32_t lo = *reinterpret_cast<const uint16_t*>(p);
  const uint32_t hi = *reinterpret_cast<const uint16_t*>(p + ld);
  return lo | (hi << 16);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// A fragment of rows [r0, r0+16), k [k0, k0+16) of a row-major smem tile
__device__ __forceinline__ void frag_a(uint32_t* a, const bf16* s, int ld,
                                       int r0, int k0, int g, int t) {
  const bf16* p = s + (r0 + g) * ld + k0 + 2 * t;
  a[0] = ld_pair(p);
  a[1] = ld_pair(p + 8 * ld);
  a[2] = ld_pair(p + 8);
  a[3] = ld_pair(p + 8 * ld + 8);
}
// B fragment with B[k][n] = s[n0 + n][k0 + k] (a row-major tile, transposed)
__device__ __forceinline__ void frag_bt(uint32_t* b, const bf16* s, int ld,
                                        int n0, int k0, int g, int t) {
  const bf16* p = s + (n0 + g) * ld + k0 + 2 * t;
  b[0] = ld_pair(p);
  b[1] = ld_pair(p + 8);
}
// B fragment with B[k][n] = s[k0 + k][n0 + n] (a row-major tile as it is)
__device__ __forceinline__ void frag_b(uint32_t* b, const bf16* s, int ld,
                                       int k0, int n0, int g, int t) {
  const bf16* p = s + (k0 + 2 * t) * ld + n0 + g;
  b[0] = ld_pair_strided(p, ld);
  b[1] = ld_pair_strided(p + 8 * ld, ld);
}
// the A fragment of k-step kk made of the f32 accumulator tiles 2kk, 2kk+1
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float (*c)[4],
                                         int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = pred ? 16 : 0;    // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

constexpr int kThreads = 128;   // bf16 kernels: 4 warps

// rows [r0, r0 + ROWS) of x [B, S, heads, D] at (b, h) into a smem tile of
// row stride D + 8; rows past S read as zeros
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* x, int b,
                                          int r0, int S, int heads, int h,
                                          int tid) {
  constexpr int kChunks = D / 8;
  constexpr int LD = D + 8;
  for (int c = tid; c < ROWS * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const int row = r0 + r;
    const bool ok = row < S;
    const bf16* src =
        x + (((int64_t)b * S + (ok ? row : 0)) * heads + h) * D + col;
    cp_async16(dst + r * LD + col, src, ok);
  }
}

// ROWS f32 values [r0, r0 + ROWS) of x [B, H, S] at (b, h); zeros past S
template <int ROWS>
__device__ __forceinline__ void load_vec(float* dst, const float* x, int b,
                                         int H, int h, int r0, int S,
                                         int tid) {
  for (int r = tid; r < ROWS; r += kThreads) {
    const int row = r0 + r;
    const bool ok = row < S;
    cp_async4(dst + r, x + ((int64_t)b * H + h) * S + (ok ? row : 0), ok);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ bool visible(int row, int col, int Sq, int Sk,
                                        int causal, int off) {
  return row < Sq && col < Sk && (!causal || col <= row + off);
}

// key tiles of 64 a q tile [i0, i0 + 64) needs
__device__ __forceinline__ int key_tiles(int i0, int Sk, int causal,
                                         int off) {
  int n = (Sk + 63) / 64;
  if (causal) {
    const int last = i0 + 63 + off;
    n = min(n, last < 0 ? 0 : last / 64 + 1);
  }
  return n;
}

// ---------------------------------------------------------------------------
// B1: forward, bf16 (TMA + wgmma)
// ---------------------------------------------------------------------------

constexpr int kFwdRows = 128;     // query rows a block: 64 a warpgroup
constexpr int kFwdKeys = 128;     // keys a tile
constexpr int kFwdStages = 2;
constexpr int kFwdThreads = 384;  // consumer warpgroups 0, 1; producer 2

template <int D>
constexpr size_t fwd_smem() {
  // Q, then K and V per stage; mbarriers: q, 2 x (full K, full V, empty)
  return (size_t)(kFwdRows + 2 * kFwdStages * kFwdKeys) * D * 2 +
         (1 + 3 * kFwdStages) * 8 + 1024;
}

// the A operand of k16 step kk of P.V from the score accumulator (columns
// 16 kk .. 16 kk + 15), rounded to bf16 (p.astype(v.dtype))
__device__ __forceinline__ void acc_to_a16(uint32_t* a, const float* p,
                                           int kk) {
  a[0] = pack_bf16(p[8 * kk + 0], p[8 * kk + 1]);
  a[1] = pack_bf16(p[8 * kk + 2], p[8 * kk + 3]);
  a[2] = pack_bf16(p[8 * kk + 4], p[8 * kk + 5]);
  a[3] = pack_bf16(p[8 * kk + 6], p[8 * kk + 7]);
}

// one block per (128-row Q tile, head, batch); key tiles of 128 walked from
// the last (the ones the causal diagonal or the Sk tail cross) to the first
template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1) flash_fwd_tma_kernel(
    const __grid_constant__ CUtensorMap tmap_q,
    const __grid_constant__ CUtensorMap tmap_k,
    const __grid_constant__ CUtensorMap tmap_v, bf16* __restrict__ out,
    float* __restrict__ lse, int Sq, int Sk, int H, int Hk, int causal,
    float scale) {
  using namespace hopper;
  constexpr int kAtoms = D / 64;                    // 64-wide column blocks
  constexpr int kQAtom = kFwdRows * 128;            // bytes of one block
  constexpr int kKVAtom = kFwdKeys * 128;
  constexpr int kKVBytes = kAtoms * kKVAtom;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align1024(smem_raw);
  uint8_t* Ks = Qs + kAtoms * kQAtom;               // [stage][atom][key][64]
  uint8_t* Vs = Ks + kFwdStages * kKVBytes;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(Vs + kFwdStages * kKVBytes);
  uint64_t* kfull = qbar + 1;
  uint64_t* vfull = kfull + kFwdStages;
  uint64_t* empty = vfull + kFwdStages;

  const int n_qt = (Sq + kFwdRows - 1) / kFwdRows;
  const int i0 = (n_qt - 1 - (int)blockIdx.x) * kFwdRows;   // long rows first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hk);
  const int off = Sk - Sq;
  int n_kt = (Sk + kFwdKeys - 1) / kFwdKeys;
  if (causal) {
    const int last = i0 + kFwdRows - 1 + off;
    n_kt = min(n_kt, last < 0 ? 0 : last / kFwdKeys + 1);
  }
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
#pragma unroll
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&vfull[s], 1);
      mbar_init(&empty[s], 256);   // every consumer thread releases
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: Q once, then K and V tiles through the ring; rows past Sq
    // and Sk arrive as zeros
    setmaxnreg_dec<40>();
    if (t == 0) {
      mbar_expect_tx(qbar, kAtoms * kQAtom);
#pragma unroll
      for (int a = 0; a < kAtoms; ++a)
        tma_load_4d(Qs + a * kQAtom, &tmap_q, qbar, a * 64, h, i0, b);
      for (int it = 0; it < n_kt; ++it) {
        const int s = it % kFwdStages, j0 = (n_kt - 1 - it) * kFwdKeys;
        if (it >= kFwdStages) mbar_wait(&empty[s], (it / kFwdStages - 1) & 1);
        mbar_expect_tx(&kfull[s], kKVBytes);
#pragma unroll
        for (int a = 0; a < kAtoms; ++a)
          tma_load_4d(Ks + s * kKVBytes + a * kKVAtom, &tmap_k, &kfull[s],
                      a * 64, hk, j0, b);
        mbar_expect_tx(&vfull[s], kKVBytes);
#pragma unroll
        for (int a = 0; a < kAtoms; ++a)
          tma_load_4d(Vs + s * kKVBytes + a * kKVAtom, &tmap_v, &vfull[s],
                      a * 64, hk, j0, b);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int warp = t / 32, g = (t % 32) / 4, q4 = t % 4;
    const int rA = i0 + wg * 64 + warp * 16 + g, rB = rA + 8;  // this thread's
    const float sl2 = scale * kLog2e;
    float o[D / 2], sc[kFwdKeys / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    // running max of the raw scores, per-thread partial row sums
    float mA = -INFINITY, mB = -INFINITY, lA = 0.f, lB = 0.f;
    const uint32_t q_addr = smem_u32(Qs) + wg * 64 * 128;
    mbar_wait(qbar, 0);

    for (int it = 0; it < n_kt; ++it) {
      const int s = it % kFwdStages, j0 = (n_kt - 1 - it) * kFwdKeys;
      const int par = (it / kFwdStages) & 1;
      // S = Q K^T: K as the K-major B operand
      mbar_wait(&kfull[s], par);
      const uint32_t k_addr = smem_u32(Ks + s * kKVBytes);
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int a = kk / 4, c = (kk % 4) * 32;
        wgmma_ss_n128<0>(sc, sw128_desc(q_addr + a * kQAtom + c, 16, 1024),
                         sw128_desc(k_addr + a * kKVAtom + c, 16, 1024),
                         kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // masks only where the offset diagonal or the Sk tail crosses the
      // tile: a select to -inf before the max, so that exp2 gives exactly 0
      // (a select, never a product with a 0/1 mask)
      if (j0 + kFwdKeys > Sk || (causal && j0 + kFwdKeys - 1 > i0 + off)) {
#pragma unroll
        for (int i = 0; i < kFwdKeys / 2; ++i) {
          const int col = j0 + 8 * (i / 4) + 2 * q4 + (i % 2);
          const int row = ((i / 2) % 2) ? rB : rA;
          if (col >= Sk || (causal && col > row + off)) sc[i] = -INFINITY;
        }
      }
      float tA = -INFINITY, tB = -INFINITY;
#pragma unroll
      for (int i = 0; i < kFwdKeys / 2; ++i) {
        if ((i / 2) % 2) tB = fmaxf(tB, sc[i]);
        else tA = fmaxf(tA, sc[i]);
      }
      const float mnA = fmaxf(mA, quad_max(tA));
      const float mnB = fmaxf(mB, quad_max(tB));
      // exp2(s * scale * log2 e - m * scale * log2 e) as one FMA; a row
      // that has seen no key yet keeps m = -inf and subtracts 0
      const float bA = mnA == -INFINITY ? 0.f : mnA * sl2;
      const float bB = mnB == -INFINITY ? 0.f : mnB * sl2;
      const float alphaA = exp2f(fmaf(mA, sl2, -bA));
      const float alphaB = exp2f(fmaf(mB, sl2, -bB));
      float sumA = 0.f, sumB = 0.f;
#pragma unroll
      for (int i = 0; i < kFwdKeys / 2; ++i) {
        if ((i / 2) % 2) {
          sc[i] = exp2f(fmaf(sc[i], sl2, -bB));
          sumB += sc[i];
        } else {
          sc[i] = exp2f(fmaf(sc[i], sl2, -bA));
          sumA += sc[i];
        }
      }
      lA = lA * alphaA + sumA;
      lB = lB * alphaB + sumB;
      mA = mnA;
      mB = mnB;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= ((i / 2) % 2) ? alphaB : alphaA;

      // O += P V: P from registers (bf16), V as the MN-major B operand
      uint32_t pa[kFwdKeys / 16][4];
#pragma unroll
      for (int kk = 0; kk < kFwdKeys / 16; ++kk) acc_to_a16(pa[kk], sc, kk);
      mbar_wait(&vfull[s], par);
      const uint32_t v_addr = smem_u32(Vs + s * kKVBytes);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kFwdKeys / 16; ++kk) {
        const uint64_t dv = sw128_desc(v_addr + kk * 2048, kKVAtom, 1024);
        if constexpr (D == 128)
          wgmma_rs_n128<1>(o, pa[kk], dv, 1);
        else
          wgmma_rs_n64<1>(o, pa[kk], dv, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(&empty[s]);
    }

    lA = quad_sum(lA);
    lB = quad_sum(lB);
    const float invA = lA > 0.f ? 1.f / lA : 0.f;
    const float invB = lB > 0.f ? 1.f / lB : 0.f;
    if (q4 == 0) {
      float* lrow = lse + ((int64_t)b * H + h) * Sq;
      if (rA < Sq) lrow[rA] = lA > 0.f ? mA * scale + logf(lA) : kNegInf;
      if (rB < Sq) lrow[rB] = lB > 0.f ? mB * scale + logf(lB) : kNegInf;
    }
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int col = 8 * (i / 4) + 2 * q4;
      const bool upper = (i / 2) % 2;
      const int row = upper ? rB : rA;
      const float inv = upper ? invB : invA;
      if (row < Sq)
        *reinterpret_cast<__nv_bfloat162*>(
            out + (((int64_t)b * Sq + row) * H + h) * D + col) =
            __floats2bfloat162_rn(o[i] * inv, o[i + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// B2: dq, bf16
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int Sq, int Sk, int H, int Hk, int causal,
    float scale) {
  constexpr int LD = D + 8;
  constexpr int kTile = 64 * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + kTile;
  bf16* Ks = dOs + kTile;       // [2][64][LD]
  bf16* Vs = Ks + 2 * kTile;    // [2][64][LD]

  const int n_qt = (Sq + 63) / 64;
  const int i0 = (n_qt - 1 - (int)blockIdx.x) * 64;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hk);
  const int off = Sk - Sq;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int iA = i0 + warp * 16 + g, iB = iA + 8;
  const int n_kt = key_tiles(i0, Sk, causal, off);
  const int64_t vec = ((int64_t)b * H + h) * Sq;
  const float lseA = iA < Sq ? lse[vec + iA] : 0.f;
  const float lseB = iB < Sq ? lse[vec + iB] : 0.f;
  const float dlA = iA < Sq ? delta[vec + iA] : 0.f;
  const float dlB = iB < Sq ? delta[vec + iB] : 0.f;

  load_rows<D, 64>(Qs, q, b, i0, Sq, H, h, tid);
  load_rows<D, 64>(dOs, dout, b, i0, Sq, H, h, tid);
  if (n_kt > 0) {
    load_rows<D, 64>(Ks, k, b, 0, Sk, Hk, hk, tid);
    load_rows<D, 64>(Vs, v, b, 0, Sk, Hk, hk, tid);
  }
  cp_async_commit();

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int n = 0; n < n_kt; ++n) {
    const int cur = n & 1;
    if (n + 1 < n_kt) {
      load_rows<D, 64>(Ks + (cur ^ 1) * kTile, k, b, (n + 1) * 64, Sk, Hk, hk,
                       tid);
      load_rows<D, 64>(Vs + (cur ^ 1) * kTile, v, b, (n + 1) * 64, Sk, Hk, hk,
                       tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Kc = Ks + cur * kTile;
    const bf16* Vc = Vs + cur * kTile;

    // S = Q K^T and dP = dO V^T, 16 rows x 64 keys per warp
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4], ad[4];
      frag_a(a, Qs, LD, warp * 16, kk, g, t);
      frag_a(ad, dOs, LD, warp * 16, kk, g, t);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t bb[2];
        frag_bt(bb, Kc, LD, j * 8, kk, g, t);
        mma16816(s[j], a, bb);
        frag_bt(bb, Vc, LD, j * 8, kk, g, t);
        mma16816(dp[j], ad, bb);
      }
    }
    // dS = P (dP - delta), P = exp(s - lse) where visible (select after exp)
    const int j0 = n * 64;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j0 + j * 8 + 2 * t + e;
        const float pa = visible(iA, col, Sq, Sk, causal, off)
            ? exp2f((s[j][e] * scale - lseA) * kLog2e) : 0.f;
        const float pb = visible(iB, col, Sq, Sk, causal, off)
            ? exp2f((s[j][2 + e] * scale - lseB) * kLog2e) : 0.f;
        s[j][e] = pa * (dp[j][e] - dlA);
        s[j][2 + e] = pb * (dp[j][2 + e] - dlB);
      }
    // dQ += dS K, dS rounded to bf16 (ds.astype(k.dtype))
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s, kk);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        uint32_t bb[2];
        frag_b(bb, Kc, LD, kk * 16, dt * 8, g, t);
        mma16816(acc[dt], a, bb);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (iA < Sq)
      *reinterpret_cast<__nv_bfloat162*>(
          dq + (((int64_t)b * Sq + iA) * H + h) * D + col) =
          __floats2bfloat162_rn(acc[dt][0] * scale, acc[dt][1] * scale);
    if (iB < Sq)
      *reinterpret_cast<__nv_bfloat162*>(
          dq + (((int64_t)b * Sq + iB) * H + h) * D + col) =
          __floats2bfloat162_rn(acc[dt][2] * scale, acc[dt][3] * scale);
  }
}

// ---------------------------------------------------------------------------
// B3: dk, dv, bf16
// ---------------------------------------------------------------------------

constexpr int kDkvRows = 32;   // q rows a step of B3 streams

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk, int H,
    int Hk, int causal, float scale) {
  constexpr int LD = D + 8;
  constexpr int R = kDkvRows;
  constexpr int kKTile = 64 * LD, kQTile = R * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kKTile;
  bf16* Qs = Vs + kKTile;       // [2][R][LD]
  bf16* dOs = Qs + 2 * kQTile;  // [2][R][LD]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * kQTile);   // [2][R]
  float* dl_s = lse_s + 2 * R;                                 // [2][R]

  const int j0 = blockIdx.x * 64;
  const int hk = blockIdx.y, b = blockIdx.z, grp = H / Hk;
  const int off = Sk - Sq;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int kA = j0 + warp * 16 + g, kB = kA + 8;   // this thread's keys
  const int n_rt = (Sq + R - 1) / R;
  // first q tile whose rows reach this key tile's diagonal (:305)
  int rt0 = 0;
  if (causal) rt0 = min(n_rt, max(0, j0 - off) / R);
  const int per_head = n_rt - rt0;
  const int steps = grp * per_head;

  load_rows<D, 64>(Ks, k, b, j0, Sk, Hk, hk, tid);
  load_rows<D, 64>(Vs, v, b, j0, Sk, Hk, hk, tid);
  auto load_step = [&](int st, int buf) {
    const int h = hk * grp + st / per_head;
    const int r0 = (rt0 + st % per_head) * R;
    load_rows<D, R>(Qs + buf * kQTile, q, b, r0, Sq, H, h, tid);
    load_rows<D, R>(dOs + buf * kQTile, dout, b, r0, Sq, H, h, tid);
    load_vec<R>(lse_s + buf * R, lse, b, H, h, r0, Sq, tid);
    load_vec<R>(dl_s + buf * R, delta, b, H, h, r0, Sq, tid);
  };
  if (steps > 0) load_step(0, 0);
  cp_async_commit();

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;

  for (int st = 0; st < steps; ++st) {
    const int cur = st & 1;
    if (st + 1 < steps) load_step(st + 1, cur ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Qc = Qs + cur * kQTile;
    const bf16* dOc = dOs + cur * kQTile;
    const float* lc = lse_s + cur * R;
    const float* dc = dl_s + cur * R;
    const int r0 = (rt0 + st % per_head) * R;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x R rows per warp
    float s[R / 8][4], dp[R / 8][4];
#pragma unroll
    for (int j = 0; j < R / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4], av[4];
      frag_a(a, Ks, LD, warp * 16, kk, g, t);
      frag_a(av, Vs, LD, warp * 16, kk, g, t);
#pragma unroll
      for (int j = 0; j < R / 8; ++j) {
        uint32_t bb[2];
        frag_bt(bb, Qc, LD, j * 8, kk, g, t);
        mma16816(s[j], a, bb);
        frag_bt(bb, dOc, LD, j * 8, kk, g, t);
        mma16816(dp[j], av, bb);
      }
    }
    // P^T where visible (select after exp); dS^T = P^T (dP^T - delta)
#pragma unroll
    for (int j = 0; j < R / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int rr = j * 8 + 2 * t + e, row = r0 + rr;
        const float lr = lc[rr], dr = dc[rr];
        const float pa = visible(row, kA, Sq, Sk, causal, off)
            ? exp2f((s[j][e] * scale - lr) * kLog2e) : 0.f;
        const float pb = visible(row, kB, Sq, Sk, causal, off)
            ? exp2f((s[j][2 + e] * scale - lr) * kLog2e) : 0.f;
        s[j][e] = pa;
        s[j][2 + e] = pb;
        dp[j][e] = pa * (dp[j][e] - dr);
        dp[j][2 + e] = pb * (dp[j][2 + e] - dr);
      }
    // dV += P^T dO (p.astype(do.dtype)); dK += dS^T Q (ds.astype(q.dtype))
#pragma unroll
    for (int kk = 0; kk < R / 16; ++kk) {
      uint32_t ap[4], ad[4];
      acc_to_a(ap, s, kk);
      acc_to_a(ad, dp, kk);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        uint32_t bb[2];
        frag_b(bb, dOc, LD, kk * 16, dt * 8, g, t);
        mma16816(dva[dt], ap, bb);
        frag_b(bb, Qc, LD, kk * 16, dt * 8, g, t);
        mma16816(dka[dt], ad, bb);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (kA < Sk) {
      const int64_t o = (((int64_t)b * Sk + kA) * Hk + hk) * D + col;
      *reinterpret_cast<float2*>(dk + o) =
          make_float2(dka[dt][0] * scale, dka[dt][1] * scale);
      *reinterpret_cast<float2*>(dv + o) = make_float2(dva[dt][0], dva[dt][1]);
    }
    if (kB < Sk) {
      const int64_t o = (((int64_t)b * Sk + kB) * Hk + hk) * D + col;
      *reinterpret_cast<float2*>(dk + o) =
          make_float2(dka[dt][2] * scale, dka[dt][3] * scale);
      *reinterpret_cast<float2*>(dv + o) = make_float2(dva[dt][2], dva[dt][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: the same three functions on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF = 32;            // rows and keys of an f32 tile
constexpr int kFThreads = 256;
constexpr int kFWarps = kFThreads / 32;

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

// kF rows [r0, r0 + kF) of x [B, S, heads, D] into dst (row stride ld);
// zeros past S
template <int D>
__device__ __forceinline__ void load_rows_f32(float* dst, int ld,
                                              const float* x, int b, int r0,
                                              int S, int heads, int h) {
  for (int i = threadIdx.x; i < kF * D; i += kFThreads) {
    const int r = i / D, d = i % D, row = r0 + r;
    dst[r * ld + d] =
        row < S ? x[(((int64_t)b * S + row) * heads + h) * D + d] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kFThreads) flash_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out,
    float* __restrict__ lse, int Sq, int Sk, int H, int Hk, int causal,
    float scale) {
  constexpr int LDK = D + 1;
  constexpr int kSplit = kFThreads / D;     // threads per column
  constexpr int kAcc = kF / kSplit;         // rows per thread
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;                    // [kF][D]
  float* Ks = Qs + kF * D;            // [kF][LDK]
  float* Vs = Ks + kF * LDK;          // [kF][D]
  float* Ss = Vs + kF * D;            // [kF][kF + 1]
  float* m_s = Ss + kF * (kF + 1);
  float* l_s = m_s + kF;
  float* al_s = l_s + kF;

  const int n_qt = (Sq + kF - 1) / kF;
  const int i0 = (n_qt - 1 - (int)blockIdx.x) * kF;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hk);
  const int off = Sk - Sq;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int n_kt = (Sk + kF - 1) / kF;
  if (causal) {
    const int last = i0 + kF - 1 + off;
    n_kt = min(n_kt, last < 0 ? 0 : last / kF + 1);
  }
  load_rows_f32<D>(Qs, D, q, b, i0, Sq, H, h);
  for (int r = tid; r < kF; r += kFThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  const int d = tid % D, rs = tid / D;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  for (int n = 0; n < n_kt; ++n) {
    const int j0 = n * kF;
    __syncthreads();
    load_rows_f32<D>(Ks, LDK, k, b, j0, Sk, Hk, hk);
    load_rows_f32<D>(Vs, D, v, b, j0, Sk, Hk, hk);
    __syncthreads();
    for (int p = tid; p < kF * kF; p += kFThreads) {
      const int r = p / kF, c = p % kF;
      float sv = kNegInf;
      if (visible(i0 + r, j0 + c, Sq, Sk, causal, off)) {
        float dot = 0.f;
#pragma unroll 8
        for (int e = 0; e < D; ++e) dot = fmaf(Qs[r * D + e], Ks[c * LDK + e], dot);
        sv = dot * scale;
      }
      Ss[r * (kF + 1) + c] = sv;
    }
    __syncthreads();
    for (int r = warp; r < kF; r += kFWarps) {
      float* sr = Ss + r * (kF + 1);
      const float sv = sr[lane];
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(sv));
      const float p = sv == kNegInf ? 0.f : expf(sv - m_new);
      sr[lane] = p;
      const float sum = warp_sum(p);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        al_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int r = rs + i * kSplit;
      const float* pr = Ss + r * (kF + 1);
      float a = acc[i] * al_s[r];
#pragma unroll 8
      for (int c = 0; c < kF; ++c) a = fmaf(pr[c], Vs[c * D + d], a);
      acc[i] = a;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int r = rs + i * kSplit, row = i0 + r;
    if (row >= Sq) continue;
    const float l = l_s[r];
    out[(((int64_t)b * Sq + row) * H + h) * D + d] = l > 0.f ? acc[i] / l : 0.f;
    if (d == 0)
      lse[((int64_t)b * H + h) * Sq + row] =
          l > 0.f ? m_s[r] + logf(l) : kNegInf;
  }
}

template <int D>
__global__ void __launch_bounds__(kFThreads) flash_bwd_dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int Sq, int Sk, int H, int Hk, int causal,
    float scale) {
  constexpr int LDK = D + 1;
  constexpr int kSplit = kFThreads / D;
  constexpr int kAcc = kF / kSplit;
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;                    // [kF][D]
  float* dOs = Qs + kF * D;           // [kF][D]
  float* Ks = dOs + kF * D;           // [kF][LDK]
  float* Vs = Ks + kF * LDK;          // [kF][LDK]
  float* dS = Vs + kF * LDK;          // [kF][kF + 1]
  float* lse_s = dS + kF * (kF + 1);
  float* dl_s = lse_s + kF;

  const int n_qt = (Sq + kF - 1) / kF;
  const int i0 = (n_qt - 1 - (int)blockIdx.x) * kF;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hk);
  const int off = Sk - Sq;
  const int tid = threadIdx.x;
  int n_kt = (Sk + kF - 1) / kF;
  if (causal) {
    const int last = i0 + kF - 1 + off;
    n_kt = min(n_kt, last < 0 ? 0 : last / kF + 1);
  }
  load_rows_f32<D>(Qs, D, q, b, i0, Sq, H, h);
  load_rows_f32<D>(dOs, D, dout, b, i0, Sq, H, h);
  for (int r = tid; r < kF; r += kFThreads) {
    const int row = i0 + r;
    const int64_t o = ((int64_t)b * H + h) * Sq + row;
    lse_s[r] = row < Sq ? lse[o] : 0.f;
    dl_s[r] = row < Sq ? delta[o] : 0.f;
  }
  const int d = tid % D, rs = tid / D;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  for (int n = 0; n < n_kt; ++n) {
    const int j0 = n * kF;
    __syncthreads();
    load_rows_f32<D>(Ks, LDK, k, b, j0, Sk, Hk, hk);
    load_rows_f32<D>(Vs, LDK, v, b, j0, Sk, Hk, hk);
    __syncthreads();
    for (int p = tid; p < kF * kF; p += kFThreads) {
      const int r = p / kF, c = p % kF;
      float ds = 0.f;
      if (visible(i0 + r, j0 + c, Sq, Sk, causal, off)) {
        float s = 0.f, dp = 0.f;
#pragma unroll 8
        for (int e = 0; e < D; ++e) {
          s = fmaf(Qs[r * D + e], Ks[c * LDK + e], s);
          dp = fmaf(dOs[r * D + e], Vs[c * LDK + e], dp);
        }
        ds = expf(s * scale - lse_s[r]) * (dp - dl_s[r]);
      }
      dS[r * (kF + 1) + c] = ds;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int r = rs + i * kSplit;
      const float* sr = dS + r * (kF + 1);
      float a = acc[i];
#pragma unroll 8
      for (int c = 0; c < kF; ++c) a = fmaf(sr[c], Ks[c * LDK + d], a);
      acc[i] = a;
    }
  }
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int row = i0 + rs + i * kSplit;
    if (row < Sq) dq[(((int64_t)b * Sq + row) * H + h) * D + d] = acc[i] * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(kFThreads) flash_bwd_dkv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk, int H,
    int Hk, int causal, float scale) {
  constexpr int LDK = D + 1;
  constexpr int kSplit = kFThreads / D;
  constexpr int kAcc = kF / kSplit;
  extern __shared__ __align__(16) float fsm[];
  float* Ks = fsm;                    // [kF][LDK]
  float* Vs = Ks + kF * LDK;
  float* Qs = Vs + kF * LDK;
  float* dOs = Qs + kF * LDK;
  float* Ps = dOs + kF * LDK;         // [key][row], kF + 1 stride
  float* dSs = Ps + kF * (kF + 1);
  float* lse_s = dSs + kF * (kF + 1);
  float* dl_s = lse_s + kF;

  const int j0 = blockIdx.x * kF;
  const int hk = blockIdx.y, b = blockIdx.z, grp = H / Hk;
  const int off = Sk - Sq;
  const int tid = threadIdx.x;
  const int n_rt = (Sq + kF - 1) / kF;
  int rt0 = 0;
  if (causal) rt0 = min(n_rt, max(0, j0 - off) / kF);
  load_rows_f32<D>(Ks, LDK, k, b, j0, Sk, Hk, hk);
  load_rows_f32<D>(Vs, LDK, v, b, j0, Sk, Hk, hk);
  const int d = tid % D, cs = tid / D;
  float dka[kAcc], dva[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) dka[i] = dva[i] = 0.f;

  for (int hh = hk * grp; hh < (hk + 1) * grp; ++hh)
    for (int rt = rt0; rt < n_rt; ++rt) {
      const int r0 = rt * kF;
      __syncthreads();
      load_rows_f32<D>(Qs, LDK, q, b, r0, Sq, H, hh);
      load_rows_f32<D>(dOs, LDK, dout, b, r0, Sq, H, hh);
      for (int r = tid; r < kF; r += kFThreads) {
        const int row = r0 + r;
        const int64_t o = ((int64_t)b * H + hh) * Sq + row;
        lse_s[r] = row < Sq ? lse[o] : 0.f;
        dl_s[r] = row < Sq ? delta[o] : 0.f;
      }
      __syncthreads();
      for (int p = tid; p < kF * kF; p += kFThreads) {
        const int c = p / kF, r = p % kF;
        float pv = 0.f, ds = 0.f;
        if (visible(r0 + r, j0 + c, Sq, Sk, causal, off)) {
          float s = 0.f, dp = 0.f;
#pragma unroll 8
          for (int e = 0; e < D; ++e) {
            s = fmaf(Ks[c * LDK + e], Qs[r * LDK + e], s);
            dp = fmaf(Vs[c * LDK + e], dOs[r * LDK + e], dp);
          }
          pv = expf(s * scale - lse_s[r]);
          ds = pv * (dp - dl_s[r]);
        }
        Ps[c * (kF + 1) + r] = pv;
        dSs[c * (kF + 1) + r] = ds;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        const int c = cs + i * kSplit;
        const float* pr = Ps + c * (kF + 1);
        const float* sr = dSs + c * (kF + 1);
        float av = dva[i], ak = dka[i];
#pragma unroll 8
        for (int r = 0; r < kF; ++r) {
          av = fmaf(pr[r], dOs[r * LDK + d], av);
          ak = fmaf(sr[r], Qs[r * LDK + d], ak);
        }
        dva[i] = av;
        dka[i] = ak;
      }
    }
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int key = j0 + cs + i * kSplit;
    if (key >= Sk) continue;
    const int64_t o = (((int64_t)b * Sk + key) * Hk + hk) * D + d;
    dk[o] = dka[i] * scale;
    dv[o] = dva[i];
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// Dynamic shared memory: above 48 KB a kernel must be allowed it first. Set
// before every launch (a host call of microseconds): the D = 64 and D = 128
// instantiations share a function type, so a per-type flag would skip one.
template <typename K>
void allow_smem(K kernel, size_t bytes) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)bytes);
}

template <int D>
constexpr size_t dq_smem() { return (size_t)6 * 64 * (D + 8) * 2; }
template <int D>
constexpr size_t dkv_smem() {
  return (size_t)(2 * 64 + 4 * kDkvRows) * (D + 8) * 2 + 4 * kDkvRows * 4;
}
template <int D>
constexpr size_t fwd_f32_smem() {
  return (size_t)(2 * kF * D + kF * (D + 1) + kF * (kF + 1) + 3 * kF) * 4;
}
template <int D>
constexpr size_t dq_f32_smem() {
  return (size_t)(2 * kF * D + 2 * kF * (D + 1) + kF * (kF + 1) + 2 * kF) * 4;
}
template <int D>
constexpr size_t dkv_f32_smem() {
  return (size_t)(4 * kF * (D + 1) + 2 * kF * (kF + 1) + 2 * kF) * 4;
}

struct Dims {
  int B, Sq, Sk, H, Hk, causal;
  float scale;
};

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               void* lse, Dims m, int dtype, cudaStream_t st) {
  if (dtype == 1) {
    // 4-D maps over [B, S, heads, D] (innermost first), boxes of one
    // (batch, head) x 128 rows x 64 columns, 128-byte swizzle
    CUtensorMap tq, tk, tv;
    const cuuint64_t qd[4] = {D, (cuuint64_t)m.H, (cuuint64_t)m.Sq,
                              (cuuint64_t)m.B};
    const cuuint64_t qs[3] = {D * 2, (cuuint64_t)m.H * D * 2,
                              (cuuint64_t)m.Sq * m.H * D * 2};
    const cuuint64_t kd[4] = {D, (cuuint64_t)m.Hk, (cuuint64_t)m.Sk,
                              (cuuint64_t)m.B};
    const cuuint64_t ks[3] = {D * 2, (cuuint64_t)m.Hk * D * 2,
                              (cuuint64_t)m.Sk * m.Hk * D * 2};
    const cuuint32_t qb[4] = {64, 1, kFwdRows, 1};
    const cuuint32_t kb[4] = {64, 1, kFwdKeys, 1};
    const auto bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
    if (!hopper::make_map(&tq, bf, 4, q, qd, qs, qb, sw) ||
        !hopper::make_map(&tk, bf, 4, k, kd, ks, kb, sw) ||
        !hopper::make_map(&tv, bf, 4, v, kd, ks, kb, sw))
      return (int)cudaErrorInvalidValue;
    auto kern = flash_fwd_tma_kernel<D>;
    allow_smem(kern, fwd_smem<D>());
    kern<<<dim3((m.Sq + kFwdRows - 1) / kFwdRows, m.H, m.B), kFwdThreads,
           fwd_smem<D>(), st>>>(tq, tk, tv, (bf16*)out, (float*)lse, m.Sq,
                                m.Sk, m.H, m.Hk, m.causal, m.scale);
  } else {
    auto kern = flash_fwd_f32_kernel<D>;
    allow_smem(kern, fwd_f32_smem<D>());
    kern<<<dim3((m.Sq + kF - 1) / kF, m.H, m.B), kFThreads, fwd_f32_smem<D>(),
           st>>>((const float*)q, (const float*)k, (const float*)v,
                 (float*)out, (float*)lse, m.Sq, m.Sk, m.H, m.Hk, m.causal,
                 m.scale);
  }
  return (int)cudaGetLastError();
}

template <int D>
void launch_dq(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dq, Dims m,
               int dtype, cudaStream_t st) {
  if (dtype == 1) {
    auto kern = flash_bwd_dq_kernel<D>;
    allow_smem(kern, dq_smem<D>());
    kern<<<dim3((m.Sq + 63) / 64, m.H, m.B), kThreads, dq_smem<D>(), st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
        (const float*)lse, (const float*)delta, (bf16*)dq, m.Sq, m.Sk, m.H,
        m.Hk, m.causal, m.scale);
  } else {
    auto kern = flash_bwd_dq_f32_kernel<D>;
    allow_smem(kern, dq_f32_smem<D>());
    kern<<<dim3((m.Sq + kF - 1) / kF, m.H, m.B), kFThreads, dq_f32_smem<D>(),
           st>>>((const float*)q, (const float*)k, (const float*)v,
                 (const float*)dout, (const float*)lse, (const float*)delta,
                 (float*)dq, m.Sq, m.Sk, m.H, m.Hk, m.causal, m.scale);
  }
}

template <int D>
void launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dk, void* dv,
                Dims m, int dtype, cudaStream_t st) {
  if (dtype == 1) {
    auto kern = flash_bwd_dkv_kernel<D>;
    allow_smem(kern, dkv_smem<D>());
    kern<<<dim3((m.Sk + 63) / 64, m.Hk, m.B), kThreads, dkv_smem<D>(), st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
        (const float*)lse, (const float*)delta, (float*)dk, (float*)dv, m.Sq,
        m.Sk, m.H, m.Hk, m.causal, m.scale);
  } else {
    auto kern = flash_bwd_dkv_f32_kernel<D>;
    allow_smem(kern, dkv_f32_smem<D>());
    kern<<<dim3((m.Sk + kF - 1) / kF, m.Hk, m.B), kFThreads,
           dkv_f32_smem<D>(), st>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
        (const float*)lse, (const float*)delta, (float*)dk, (float*)dv, m.Sq,
        m.Sk, m.H, m.Hk, m.causal, m.scale);
  }
}

bool dims_ok(int B, int Sq, int Sk, int H, int Hk, int D, int dtype) {
  return B >= 1 && Sq >= 1 && Sk >= 1 && Hk >= 1 && H % Hk == 0 &&
         (D == 64 || D == 128) && (dtype == 0 || dtype == 1) &&
         B <= 65535 && H <= 65535;
}

}  // namespace

// Plain C entry points, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16
// (q, k, v, do, out, dq); lse, delta, dk, dv are float32. Each returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a shape the
// kernels do not take); the Python wrapper raises when it is not 0.

extern "C" int pt_flash_fwd(const void* q, const void* k, const void* v,
                            void* out, void* lse, int B, int Sq, int Sk,
                            int H, int Hk, int D, int dtype, int causal,
                            float scale, void* stream) {
  if (!dims_ok(B, Sq, Sk, H, Hk, D, dtype)) return (int)cudaErrorInvalidValue;
  const Dims m{B, Sq, Sk, H, Hk, causal, scale};
  return D == 128
             ? launch_fwd<128>(q, k, v, out, lse, m, dtype,
                               (cudaStream_t)stream)
             : launch_fwd<64>(q, k, v, out, lse, m, dtype,
                              (cudaStream_t)stream);
}

extern "C" int pt_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int B, int Sq,
                               int Sk, int H, int Hk, int D, int dtype,
                               int causal, float scale, void* stream) {
  if (!dims_ok(B, Sq, Sk, H, Hk, D, dtype)) return (int)cudaErrorInvalidValue;
  const Dims m{B, Sq, Sk, H, Hk, causal, scale};
  if (D == 128)
    launch_dq<128>(q, k, v, dout, lse, delta, dq, m, dtype,
                   (cudaStream_t)stream);
  else
    launch_dq<64>(q, k, v, dout, lse, delta, dq, m, dtype,
                  (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

extern "C" int pt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int B,
                                int Sq, int Sk, int H, int Hk, int D,
                                int dtype, int causal, float scale,
                                void* stream) {
  if (!dims_ok(B, Sq, Sk, H, Hk, D, dtype)) return (int)cudaErrorInvalidValue;
  const Dims m{B, Sq, Sk, H, Hk, causal, scale};
  if (D == 128)
    launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, m, dtype,
                    (cudaStream_t)stream);
  else
    launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, m, dtype,
                   (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
