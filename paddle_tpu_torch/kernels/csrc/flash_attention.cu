// Flash attention forward and backward for Hopper (sm_90a): B1, B2, B3.
//
// Each replaces one Pallas kernel of paddle_tpu/kernels/flash_attention.py:
//
//   flash_fwd_tma_kernel  <- _fwd_kernel     (B1, :112): out and the f32 lse of
//       causal or full online-softmax attention (bf16 and fp16 at head_dim
//       32, 64, 128; flash_fwd_f32_kernel in f32).
//   flash_bwd_dq_tma_kernel  <- _bwd_dq_kernel  (B2, :215): dq = scale *
//       sum_j p * (dp - delta) * k, P rebuilt from lse (bf16;
//       flash_bwd_dq_f32_kernel in f32).
//   flash_bwd_dkv_tma_kernel <- _bwd_dkv_kernel (B3, :260): dk, dv of one kv
//       head, summed over the g query heads of its group inside one block
//       (bf16; flash_bwd_dkv_f32_kernel in f32).
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
// B1, bf16 and fp16 (flash_fwd_tma_kernel<T, D>): what bounds it is
// operations (68.7 GFLOP at the 7B leg's shape, 0.07 ms at 989 TFLOP/s),
// and only wgmma reaches that rate. fp16 is the same body with the
// instructions' .f16 type, an FLOAT16 tensor map and P packed to fp16 (the
// Pallas kernel rounds P to v's dtype). At head_dim 32 a row is 64 bytes:
// one 32-column box in the 64-byte swizzle, its descriptors (sw64_desc)
// and a 64 x 32 P.V product; the rest is the D = 64 code. B2 and B3 take
// neither (no training config needs them). One block of three warpgroups
// per (128-row Q tile, head, batch), long rows first. Warpgroup 2 gives
// up its registers (setmaxnreg) and one of its threads issues every copy
// by TMA over 4-D tensor maps of the public
// [B, S, H, D] layout, boxes of 1 x 128 rows x 1 x 64 columns in the 128-byte
// swizzle (D = 128 takes two): Q once, then K and V tiles of 128 keys through
// a 2-stage ring, each tile on its own mbarrier so that Q.K^T starts before V
// lands; rows past Sq and Sk arrive as zeros. Each consumer warpgroup owns 64
// rows: S = Q.K^T by wgmma SS (K the K-major B operand), the online softmax on
// the f32 scores in registers (scale * log2 e folded into one FMA before
// exp2), P rounded to v's type in registers as the A operand of wgmma RS for
// P.V, V the MN-major B operand: P never touches shared memory. Only the key
// tiles that the offset diagonal or the Sk tail crosses run the mask (the
// first ones of the loop, which walks the key tiles backwards); the other
// iterations run none. The two warpgroups run unsynchronised, so one's
// softmax overlaps the other's products.
//
// B2, B3 (bf16, flash_bwd_dq_tma_kernel, flash_bwd_dkv_tma_kernel): B1's
// building blocks, two consumer warpgroups a block. B2: one block per (128-row
// Q tile, head, batch), long rows first; Q and dO land once by TMA, K and V
// tiles of 64 keys stream through a 2-stage ring (each on its own mbarrier)
// filled by a producer warp, walked from the last; each warpgroup owns 64 rows:
// S = Q.K^T and dP = dO.V^T by wgmma SS (K, V K-major), P = exp2(S * scale *
// log2 e - lse * log2 e) and dS = P (dP - delta) in f32 registers, dS rounded
// to bf16 in registers (ds.astype(k.dtype)) as the A operand of dQ += dS.K by
// wgmma RS, K read again as the MN-major B operand of the same swizzled tile.
// B3: the transposed form, one block per (128-key tile, kv head, batch), low
// keys first; K and V land once, Q and dO tiles of 64 rows and their lse and
// delta stream through the ring for every head of the GQA group and every q
// tile from the diagonal's first, four stages filled by warp 0 (no producer
// warp: 8 warps a block leave a thread 255 registers, 9 only 168, and dK and dV
// alone take 128); S^T = K.Q^T and dP^T = V.dO^T by wgmma SS (lse and delta per
// column, from shared memory), then dV += P^T.dO and dK += dS^T.Q by wgmma RS
// from registers (p.astype(do.dtype), ds.astype(q.dtype)), dO and Q as MN-major
// B operands: nothing is transposed through shared memory. dK and dV stay in
// registers across the whole group, so the sum over the group needs no atomics
// and is deterministic. Rows past Sq carry lse = +inf, so their P is exactly 0;
// the masks (selects after the exp) run only on the tiles that the offset
// diagonal (or, in B2, the Sk tail) crosses, and a warpgroup skips a tile that
// lies wholly past its diagonal.
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
// scheduled against each other (FA3's ping-pong). B2 and B3: each
// warpgroup waits for its own products before the exp and again before the
// accumulation, and the blocks are not persistent. Taken apart on an H100
// (7B leg's shape), the TMA copies and barriers alone take about half of
// either kernel's time: every block streams its K, V (B2) or Q, dO (B3)
// tiles from L2 again, 570 MB each. Issuing S and dP as two groups (the exp
// beside dP's product) and turns between the warpgroups for the products
// (ping-pong) both measured slower and were left out.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
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

// B1's 16-bit input types, bf16 and fp16 (`hopper::Elem`): the same
// wgmma layouts and swizzled tiles; the instruction's type suffix, the
// tensor map's type and the rounding of P and of the output differ
using hopper::Elem;

// a descriptor of a tile whose rows are RowB bytes: the 128-byte swizzle
// (64 columns of 16-bit values) or, at head_dim 32, the 64-byte one
template <int RowB>
__device__ __forceinline__ uint64_t sw_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  static_assert(RowB == 128 || RowB == 64, "128- or 64-byte rows");
  if constexpr (RowB == 128)
    return hopper::sw128_desc(addr, lbo, sbo);
  else
    return hopper::sw64_desc(addr, lbo, sbo);
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

// ---------------------------------------------------------------------------
// B1: forward, bf16 and fp16 (TMA + wgmma)
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
// 16 kk .. 16 kk + 15), rounded to v's type T (p.astype(v.dtype)); B2 and
// B3 round dS and P to bf16 the same way
template <typename T = bf16>
__device__ __forceinline__ void acc_to_a16(uint32_t* a, const float* p,
                                           int kk) {
  a[0] = Elem<T>::pack(p[8 * kk + 0], p[8 * kk + 1]);
  a[1] = Elem<T>::pack(p[8 * kk + 2], p[8 * kk + 3]);
  a[2] = Elem<T>::pack(p[8 * kk + 4], p[8 * kk + 5]);
  a[3] = Elem<T>::pack(p[8 * kk + 6], p[8 * kk + 7]);
}

// one block per (128-row Q tile, head, batch); key tiles of 128 walked from
// the last (the ones the causal diagonal or the Sk tail cross) to the first.
// T: bf16 or __half; D: 32, 64 or 128. At D >= 64 the tiles are 64-column
// blocks in the 128-byte swizzle (D = 128 takes two); at D = 32 one 32-column
// block in the 64-byte swizzle, the same code over narrower rows
template <typename T, int D>
__global__ void __launch_bounds__(kFwdThreads, 1) flash_fwd_tma_kernel(
    const __grid_constant__ CUtensorMap tmap_q,
    const __grid_constant__ CUtensorMap tmap_k,
    const __grid_constant__ CUtensorMap tmap_v, T* __restrict__ out,
    float* __restrict__ lse, int Sq, int Sk, int H, int Hk, int causal,
    float scale) {
  using namespace hopper;
  constexpr bool kF16 = Elem<T>::kF16;
  constexpr int kCols = D < 64 ? D : 64;            // columns a block row
  constexpr int kRowB = kCols * 2;                  // its bytes: 128 or 64
  constexpr int kSteps = kRowB / 32;                // k16 steps a block row
  constexpr int kAtoms = D / kCols;                 // column blocks
  constexpr int kQAtom = kFwdRows * kRowB;          // bytes of one block
  constexpr int kKVAtom = kFwdKeys * kRowB;
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
        tma_load_4d(Qs + a * kQAtom, &tmap_q, qbar, a * kCols, h, i0, b);
      for (int it = 0; it < n_kt; ++it) {
        const int s = it % kFwdStages, j0 = (n_kt - 1 - it) * kFwdKeys;
        if (it >= kFwdStages) mbar_wait(&empty[s], (it / kFwdStages - 1) & 1);
        mbar_expect_tx(&kfull[s], kKVBytes);
#pragma unroll
        for (int a = 0; a < kAtoms; ++a)
          tma_load_4d(Ks + s * kKVBytes + a * kKVAtom, &tmap_k, &kfull[s],
                      a * kCols, hk, j0, b);
        mbar_expect_tx(&vfull[s], kKVBytes);
#pragma unroll
        for (int a = 0; a < kAtoms; ++a)
          tma_load_4d(Vs + s * kKVBytes + a * kKVAtom, &tmap_v, &vfull[s],
                      a * kCols, hk, j0, b);
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
    const uint32_t q_addr = smem_u32(Qs) + wg * 64 * kRowB;
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
        const int a = kk / kSteps, c = (kk % kSteps) * 32;
        wgmma_ss_n128<0, kF16>(
            sc, sw_desc<kRowB>(q_addr + a * kQAtom + c, 16, 8 * kRowB),
            sw_desc<kRowB>(k_addr + a * kKVAtom + c, 16, 8 * kRowB), kk > 0);
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

      // O += P V: P from registers (in v's type), V as the MN-major B
      // operand
      uint32_t pa[kFwdKeys / 16][4];
#pragma unroll
      for (int kk = 0; kk < kFwdKeys / 16; ++kk) acc_to_a16<T>(pa[kk], sc, kk);
      mbar_wait(&vfull[s], par);
      const uint32_t v_addr = smem_u32(Vs + s * kKVBytes);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kFwdKeys / 16; ++kk) {
        const uint64_t dv =
            sw_desc<kRowB>(v_addr + kk * 16 * kRowB, kKVAtom, 8 * kRowB);
        if constexpr (D == 128)
          wgmma_rs_n128<1, kF16>(o, pa[kk], dv, 1);
        else if constexpr (D == 64)
          wgmma_rs_n64<1, kF16>(o, pa[kk], dv, 1);
        else
          wgmma_rs_n32<1, kF16>(o, pa[kk], dv, 1);
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
        Elem<T>::store2(out + (((int64_t)b * Sq + row) * H + h) * D + col,
                        o[i] * inv, o[i + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// B2, B3: backward, bf16 (TMA + wgmma)
// ---------------------------------------------------------------------------

// Registers. ptxas gives each thread of a block at most the register file
// of an SM sub-partition (16384) over the warps that land on it: 9 to 12
// warps put 3 on one, 168 registers a thread, whatever setmaxnreg says; 8
// warps put 2, 255. B2 holds dQ, S and dP (128 for D = 128) and runs two
// consumer warpgroups beside a producer warp (9 warps). B3 holds dK, dV, S^T
// and dP^T (192) and runs 8 warps: the two consumer warpgroups, warp 0 of
// which also fills the ring.
constexpr int kDqThreads = 288;   // warpgroups 0, 1; producer warp 8
constexpr int kDqStages = 2;
constexpr int kDqRows = 128;      // query rows a block, 64 a warpgroup
constexpr int kDqKeys = 64;       // keys a streamed K / V tile
constexpr int kDkvThreads = 256;  // warpgroups 0, 1
constexpr int kDkvStages = 4;
constexpr int kDkvKeys = 128;     // keys a block, 64 a warpgroup
constexpr int kDkvRows = 64;      // query rows a streamed Q / dO tile

template <int D>
constexpr size_t dq_smem() {
  // Q, dO; K and V per stage; mbarriers: q, 3 per stage
  return (size_t)(2 * kDqRows + 2 * kDqStages * kDqKeys) * D * 2 +
         (1 + 3 * kDqStages) * 8 + 1024;
}
template <int D>
constexpr size_t dkv_smem() {
  // K, V; Q and dO per stage; lse and delta per stage; mbarriers: kv, 2 per
  // stage
  return (size_t)(2 * kDkvKeys + 2 * kDkvStages * kDkvRows) * D * 2 +
         (size_t)2 * kDkvStages * kDkvRows * 4 + (1 + 2 * kDkvStages) * 8 +
         1024;
}

// d[64 x D] += A[64 x 64] (four k16 register steps) B, B the MN-major
// [64][D] tile at `addr` (64-column blocks `lbo` bytes apart)
template <int D>
__device__ __forceinline__ void mma_rs_mn(float (&d)[D / 2],
                                          const uint32_t (&a)[4][4],
                                          uint32_t addr, uint32_t lbo) {
  using namespace hopper;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = sw128_desc(addr + kk * 2048, lbo, 1024);
    if constexpr (D == 128)
      wgmma_rs_n128<1>(d, a[kk], db, 1);
    else
      wgmma_rs_n64<1>(d, a[kk], db, 1);
  }
}

// d[64 x 64] = A B^T over D: A the K-major rows at `a_addr` (64-column
// blocks `a_atom` bytes apart), B the K-major 64 rows at `b_addr` (`b_atom`)
template <int D>
__device__ __forceinline__ void mma_ss_kk(float (&d)[32], uint32_t a_addr,
                                          uint32_t a_atom, uint32_t b_addr,
                                          uint32_t b_atom) {
  using namespace hopper;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int a = kk / 4, c = (kk % 4) * 32;
    wgmma_ss_n64<0>(d, sw128_desc(a_addr + a * a_atom + c, 16, 1024),
                    sw128_desc(b_addr + a * b_atom + c, 16, 1024), kk > 0);
  }
}

// B2: one block per (128-row Q tile, head, batch), long rows first; key
// tiles of 64 walked from the last (the ones the offset diagonal or the Sk
// tail cross) to the first
template <int D>
__global__ void __launch_bounds__(kDqThreads, 1) flash_bwd_dq_tma_kernel(
    const __grid_constant__ CUtensorMap tmap_q,
    const __grid_constant__ CUtensorMap tmap_k,
    const __grid_constant__ CUtensorMap tmap_v,
    const __grid_constant__ CUtensorMap tmap_do,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int Sq, int Sk, int H, int Hk, int causal,
    float scale) {
  using namespace hopper;
  constexpr int kAtoms = D / 64;
  constexpr int kQAtom = kDqRows * 128;
  constexpr int kKVAtom = kDqKeys * 128;
  constexpr int kQBytes = kAtoms * kQAtom;
  constexpr int kKVBytes = kAtoms * kKVAtom;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align1024(smem_raw);
  uint8_t* dOs = Qs + kQBytes;
  uint8_t* Ks = dOs + kQBytes;                      // [stage][atom][key][64]
  uint8_t* Vs = Ks + kDqStages * kKVBytes;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(Vs + kDqStages * kKVBytes);
  uint64_t* kfull = qbar + 1;
  uint64_t* vfull = kfull + kDqStages;
  uint64_t* empty = vfull + kDqStages;

  const int n_qt = (Sq + kDqRows - 1) / kDqRows;
  const int i0 = (n_qt - 1 - (int)blockIdx.x) * kDqRows;   // long rows first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hk);
  const int off = Sk - Sq;
  int n_kt = (Sk + kDqKeys - 1) / kDqKeys;
  if (causal) {
    const int last = i0 + kDqRows - 1 + off;
    n_kt = min(n_kt, last < 0 ? 0 : last / kDqKeys + 1);
  }
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
#pragma unroll
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&vfull[s], 1);
      mbar_init(&empty[s], 256);   // every consumer thread releases
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: Q and dO once, then K and V tiles through the ring; rows
    // past Sq and Sk arrive as zeros
    if (t == 0 && n_kt > 0) {
      mbar_expect_tx(qbar, 2 * kQBytes);
#pragma unroll
      for (int a = 0; a < kAtoms; ++a) {
        tma_load_4d(Qs + a * kQAtom, &tmap_q, qbar, a * 64, h, i0, b);
        tma_load_4d(dOs + a * kQAtom, &tmap_do, qbar, a * 64, h, i0, b);
      }
      for (int it = 0; it < n_kt; ++it) {
        const int s = it % kDqStages, j0 = (n_kt - 1 - it) * kDqKeys;
        if (it >= kDqStages) mbar_wait(&empty[s], (it / kDqStages - 1) & 1);
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
    const int warp = t / 32, g = (t % 32) / 4, q4 = t % 4;
    const int r0 = i0 + wg * 64;                      // this warpgroup's rows
    const int rA = r0 + warp * 16 + g, rB = rA + 8;   // this thread's
    const float sl2 = scale * kLog2e;
    // lse * log2 e and delta of the thread's rows; rows past Sq take +inf
    // and 0, so that their P and dS are exactly 0
    const int64_t vec = ((int64_t)b * H + h) * Sq;
    const float lA = rA < Sq ? lse[vec + rA] * kLog2e : INFINITY;
    const float lB = rB < Sq ? lse[vec + rB] * kLog2e : INFINITY;
    const float dA = rA < Sq ? delta[vec + rA] : 0.f;
    const float dB = rB < Sq ? delta[vec + rB] : 0.f;
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    const uint32_t q_addr = smem_u32(Qs) + wg * 64 * 128;
    const uint32_t do_addr = smem_u32(dOs) + wg * 64 * 128;
    if (n_kt > 0) mbar_wait(qbar, 0);

    for (int it = 0; it < n_kt; ++it) {
      const int s = it % kDqStages, j0 = (n_kt - 1 - it) * kDqKeys;
      const int par = (it / kDqStages) & 1;
      mbar_wait(&kfull[s], par);
      mbar_wait(&vfull[s], par);
      // a tile past every one of this warpgroup's diagonals: nothing to do
      if (!(causal && j0 > r0 + 63 + off)) {
        const uint32_t k_addr = smem_u32(Ks + s * kKVBytes);
        const uint32_t v_addr = smem_u32(Vs + s * kKVBytes);
        // S = Q K^T, dP = dO V^T: K and V as K-major B operands
        float sc[32], dp[32];
        fence_regs(sc);
        fence_regs(dp);
        wgmma_fence();
        mma_ss_kk<D>(sc, q_addr, kQAtom, k_addr, kKVAtom);
        mma_ss_kk<D>(dp, do_addr, kQAtom, v_addr, kKVAtom);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);
        // P = exp(S * scale - lse) as one FMA before exp2
#pragma unroll
        for (int i = 0; i < 32; ++i)
          sc[i] = exp2f(fmaf(sc[i], sl2, ((i / 2) % 2) ? -lB : -lA));
        // masks only where the offset diagonal or the Sk tail crosses the
        // tile: a select after the exp (never a product with a 0/1 mask)
        if (j0 + kDqKeys > Sk || (causal && j0 + kDqKeys - 1 > r0 + off)) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int col = j0 + 8 * (i / 4) + 2 * q4 + (i % 2);
            const int row = ((i / 2) % 2) ? rB : rA;
            if (col >= Sk || (causal && col > row + off)) sc[i] = 0.f;
          }
        }
        // dS = P (dP - delta), rounded to bf16 (ds.astype(k.dtype)) into
        // the A operand of dQ += dS K; K as the MN-major B operand
        uint32_t ds[4][4];
#pragma unroll
        for (int i = 0; i < 32; ++i)
          sc[i] *= dp[i] - (((i / 2) % 2) ? dB : dA);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) acc_to_a16(ds[kk], sc, kk);
        fence_regs(acc);
        wgmma_fence();
        mma_rs_mn<D>(acc, ds, k_addr, kKVAtom);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
      }
      mbar_arrive(&empty[s]);
    }

    // dq = dQ * scale, rounded to q's dtype
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int col = 8 * (i / 4) + 2 * q4;
      const int row = ((i / 2) % 2) ? rB : rA;
      if (row < Sq)
        *reinterpret_cast<__nv_bfloat162*>(
            dq + (((int64_t)b * Sq + row) * H + h) * D + col) =
            __floats2bfloat162_rn(acc[i] * scale, acc[i + 1] * scale);
    }
  }
}

// B3: one block per (128-key tile, kv head, batch), low keys (the most q
// tiles under causal masking) first. Transposed form: S^T = K Q^T and dP^T =
// V dO^T, so P^T and dS^T are register A operands of dV += P^T dO and dK +=
// dS^T Q. Q and dO tiles of 64 rows stream through the ring for every head
// of the group and every q tile from the diagonal's first; dK and dV stay in
// registers throughout, so the sum over the group needs no atomics and is
// deterministic. Two warpgroups and no producer warp (see kDkvThreads): warp
// 0 fills the ring kDkvStages - 1 steps ahead of its own.
template <int D>
__global__ void __launch_bounds__(kDkvThreads, 1) flash_bwd_dkv_tma_kernel(
    const __grid_constant__ CUtensorMap tmap_q,
    const __grid_constant__ CUtensorMap tmap_k,
    const __grid_constant__ CUtensorMap tmap_v,
    const __grid_constant__ CUtensorMap tmap_do,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk, int H,
    int Hk, int causal, float scale) {
  using namespace hopper;
  constexpr int kAtoms = D / 64;
  constexpr int kKAtom = kDkvKeys * 128;
  constexpr int kQAtom = kDkvRows * 128;
  constexpr int kKBytes = kAtoms * kKAtom;
  constexpr int kQBytes = kAtoms * kQAtom;
  constexpr int S = kDkvStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = align1024(smem_raw);
  uint8_t* Vs = Ks + kKBytes;
  uint8_t* Qs = Vs + kKBytes;                       // [stage][atom][row][64]
  uint8_t* dOs = Qs + S * kQBytes;
  float* l2s = reinterpret_cast<float*>(dOs + S * kQBytes);
  float* dls = l2s + S * kDkvRows;                  // [stage][row]
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(dls + S * kDkvRows);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + S;

  const int j0 = blockIdx.x * kDkvKeys;
  const int hk = blockIdx.y, b = blockIdx.z, grp = H / Hk;
  const int off = Sk - Sq;
  const int n_rt = (Sq + kDkvRows - 1) / kDkvRows;
  // the first q tile whose rows reach this key tile's diagonal
  const int rt0 = causal ? min(n_rt, max(0, j0 - off) / kDkvRows) : 0;
  const int per_head = n_rt - rt0;
  const int steps = grp * per_head;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 33);     // lane 0's copies, every lane of warp 0
      mbar_init(&empty[s], 256);   // every thread
    }
    fence_barrier_init();
  }
  __syncthreads();

  // warp 0 fills the ring kDkvStages - 1 steps ahead, in two halves: at the
  // top of a step, once every thread has released the stage, lane 0 starts
  // the TMA copies of the Q and dO tiles and every lane starts loading two
  // rows' lse and delta into registers; at the end of the step, when those
  // loads have long landed, every lane writes lse * log2 e and delta to the
  // stage (rows past Sq: +inf and 0, so that their P and dS are exactly 0)
  // and arrives
  const bool producer = threadIdx.x < 32;
  float pre[4];   // lse, delta of rows t and t + 32 of the step in flight
  auto fetch = [&](int st) {
    const int s = st % S;
    const int h = hk * grp + st / per_head;
    const int r0 = (rt0 + st % per_head) * kDkvRows;
    if (st >= S) mbar_wait(&empty[s], (st / S - 1) & 1);
    if (t == 0) {
      mbar_expect_tx(&full[s], 2 * kQBytes);
#pragma unroll
      for (int a = 0; a < kAtoms; ++a) {
        tma_load_4d(Qs + s * kQBytes + a * kQAtom, &tmap_q, &full[s],
                    a * 64, h, r0, b);
        tma_load_4d(dOs + s * kQBytes + a * kQAtom, &tmap_do, &full[s],
                    a * 64, h, r0, b);
      }
    }
    const int64_t vec = ((int64_t)b * H + h) * Sq;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + t + 32 * i;
      pre[2 * i] = row < Sq ? lse[vec + row] * kLog2e : INFINITY;
      pre[2 * i + 1] = row < Sq ? delta[vec + row] : 0.f;
    }
  };
  auto publish = [&](int st) {
    const int s = st % S;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l2s[s * kDkvRows + t + 32 * i] = pre[2 * i];
      dls[s * kDkvRows + t + 32 * i] = pre[2 * i + 1];
    }
    mbar_arrive(&full[s]);
  };
  if (producer && steps > 0) {
    if (t == 0) {
      mbar_expect_tx(kvbar, 2 * kKBytes);
#pragma unroll
      for (int a = 0; a < kAtoms; ++a) {
        tma_load_4d(Ks + a * kKAtom, &tmap_k, kvbar, a * 64, hk, j0, b);
        tma_load_4d(Vs + a * kKAtom, &tmap_v, kvbar, a * 64, hk, j0, b);
      }
    }
    for (int st = 0; st < min(S - 1, steps); ++st) {
      fetch(st);
      publish(st);
    }
  }

  const int warp = t / 32, g = (t % 32) / 4, q4 = t % 4;
  const int jw = j0 + wg * 64;                        // this warpgroup's keys
  const int kA = jw + warp * 16 + g, kB = kA + 8;     // this thread's
  const float sl2 = scale * kLog2e;
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  const uint32_t k_addr = smem_u32(Ks) + wg * 64 * 128;
  const uint32_t v_addr = smem_u32(Vs) + wg * 64 * 128;
  if (steps > 0) mbar_wait(kvbar, 0);

  for (int st = 0; st < steps; ++st) {
    const bool ahead = producer && st + S - 1 < steps;
    if (ahead) fetch(st + S - 1);
    const int s = st % S, par = (st / S) & 1;
    const int r0 = (rt0 + st % per_head) * kDkvRows;
    mbar_wait(&full[s], par);
    // rows that all sit before this warpgroup's keys: nothing to do
    if (!(causal && jw > r0 + kDkvRows - 1 + off)) {
      const uint32_t q_addr = smem_u32(Qs + s * kQBytes);
      const uint32_t do_addr = smem_u32(dOs + s * kQBytes);
      const float* l2 = l2s + s * kDkvRows;
      const float* dl = dls + s * kDkvRows;
      // S^T = K Q^T, dP^T = V dO^T: Q and dO as K-major B operands
      float sc[32], dp[32];
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
      mma_ss_kk<D>(sc, k_addr, kKAtom, q_addr, kQAtom);
      mma_ss_kk<D>(dp, v_addr, kKAtom, do_addr, kQAtom);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      // P^T = exp(S^T * scale - lse), lse per column
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const float2 l = *reinterpret_cast<const float2*>(
            l2 + 8 * (i / 4) + 2 * q4);
        sc[i] = exp2f(fmaf(sc[i], sl2, -l.x));
        sc[i + 1] = exp2f(fmaf(sc[i + 1], sl2, -l.y));
      }
      // the causal mask only where the offset diagonal crosses the tile: a
      // select after the exp
      if (causal && jw + 63 > r0 + off) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int row = r0 + 8 * (i / 4) + 2 * q4 + (i % 2);
          const int key = ((i / 2) % 2) ? kB : kA;
          if (key > row + off) sc[i] = 0.f;
        }
      }
      // dS^T = P^T (dP^T - delta); P^T and dS^T rounded to bf16
      // (p.astype(do.dtype), ds.astype(q.dtype)) into the A operands of dV
      // += P^T dO and dK += dS^T Q, dO and Q as MN-major B operands
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const float2 d = *reinterpret_cast<const float2*>(
            dl + 8 * (i / 4) + 2 * q4);
        dp[i] = sc[i] * (dp[i] - d.x);
        dp[i + 1] = sc[i + 1] * (dp[i + 1] - d.y);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        acc_to_a16(pa[kk], sc, kk);
        acc_to_a16(da[kk], dp, kk);
      }
      fence_regs(dva);
      fence_regs(dka);
      wgmma_fence();
      mma_rs_mn<D>(dva, pa, do_addr, kQAtom);
      mma_rs_mn<D>(dka, da, q_addr, kQAtom);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
    }
    mbar_arrive(&empty[s]);
    if (ahead) publish(st + S - 1);
  }

  // dk = dK * scale and dv, in f32
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int col = 8 * (i / 4) + 2 * q4;
    const int key = ((i / 2) % 2) ? kB : kA;
    if (key < Sk) {
      const int64_t o = (((int64_t)b * Sk + key) * Hk + hk) * D + col;
      *reinterpret_cast<float2*>(dk + o) =
          make_float2(dka[i] * scale, dka[i + 1] * scale);
      *reinterpret_cast<float2*>(dv + o) = make_float2(dva[i], dva[i + 1]);
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
// before every launch (a host call of microseconds): the instantiations of
// one kernel at its head dims (B1: 32, 64, 128; B2, B3: 64, 128) share a
// function type, so a per-type flag would skip one.
template <typename K>
void allow_smem(K kernel, size_t bytes) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)bytes);
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

// a 4-D map over x [B, S, heads, D] of 16-bit values `type` (innermost
// first): boxes of one (batch, head) x `rows` rows x 64 columns in the
// 128-byte swizzle, or at D = 32 x 32 columns in the 64-byte swizzle; rows
// past S read as zeros
template <int D>
bool bshd_map(CUtensorMap* map, const void* x, int B, int S, int heads,
              int rows,
              CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const cuuint64_t dims[4] = {D, (cuuint64_t)heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {D < 64 ? D : 64, 1, (cuuint32_t)rows, 1};
  return hopper::make_map(
      map, type, 4, x, dims, strides, box,
      D < 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B);
}

// the maps of q and do (boxes of q_rows) and of k and v (boxes of k_rows)
template <int D>
bool qkv_maps(CUtensorMap* maps, const void* q, const void* k, const void* v,
              const void* dout, Dims m, int q_rows, int k_rows,
              CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  return bshd_map<D>(&maps[0], q, m.B, m.Sq, m.H, q_rows, type) &&
         bshd_map<D>(&maps[1], k, m.B, m.Sk, m.Hk, k_rows, type) &&
         bshd_map<D>(&maps[2], v, m.B, m.Sk, m.Hk, k_rows, type) &&
         (dout == nullptr ||
          bshd_map<D>(&maps[3], dout, m.B, m.Sq, m.H, q_rows, type));
}

// B1 in a 16-bit type T (bf16 or __half)
template <typename T, int D>
int launch_fwd_tma(const void* q, const void* k, const void* v, void* out,
                   void* lse, Dims m, cudaStream_t st) {
  CUtensorMap t[3];
  if (!qkv_maps<D>(t, q, k, v, nullptr, m, kFwdRows, kFwdKeys,
                   Elem<T>::kMap))
    return (int)cudaErrorInvalidValue;
  auto kern = flash_fwd_tma_kernel<T, D>;
  allow_smem(kern, fwd_smem<D>());
  kern<<<dim3((m.Sq + kFwdRows - 1) / kFwdRows, m.H, m.B), kFwdThreads,
         fwd_smem<D>(), st>>>(t[0], t[1], t[2], (T*)out, (float*)lse, m.Sq,
                              m.Sk, m.H, m.Hk, m.causal, m.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               void* lse, Dims m, int dtype, cudaStream_t st) {
  if (dtype == 1) return launch_fwd_tma<bf16, D>(q, k, v, out, lse, m, st);
  if (dtype == 2) return launch_fwd_tma<__half, D>(q, k, v, out, lse, m, st);
  auto kern = flash_fwd_f32_kernel<D>;
  allow_smem(kern, fwd_f32_smem<D>());
  kern<<<dim3((m.Sq + kF - 1) / kF, m.H, m.B), kFThreads, fwd_f32_smem<D>(),
         st>>>((const float*)q, (const float*)k, (const float*)v, (float*)out,
               (float*)lse, m.Sq, m.Sk, m.H, m.Hk, m.causal, m.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, Dims m,
              int dtype, cudaStream_t st) {
  if (dtype == 1) {
    CUtensorMap t[4];
    if (!qkv_maps<D>(t, q, k, v, dout, m, kDqRows, kDqKeys))
      return (int)cudaErrorInvalidValue;
    auto kern = flash_bwd_dq_tma_kernel<D>;
    allow_smem(kern, dq_smem<D>());
    kern<<<dim3((m.Sq + kDqRows - 1) / kDqRows, m.H, m.B), kDqThreads,
           dq_smem<D>(), st>>>(t[0], t[1], t[2], t[3], (const float*)lse,
                               (const float*)delta, (bf16*)dq, m.Sq, m.Sk,
                               m.H, m.Hk, m.causal, m.scale);
  } else {
    auto kern = flash_bwd_dq_f32_kernel<D>;
    allow_smem(kern, dq_f32_smem<D>());
    kern<<<dim3((m.Sq + kF - 1) / kF, m.H, m.B), kFThreads, dq_f32_smem<D>(),
           st>>>((const float*)q, (const float*)k, (const float*)v,
                 (const float*)dout, (const float*)lse, (const float*)delta,
                 (float*)dq, m.Sq, m.Sk, m.H, m.Hk, m.causal, m.scale);
  }
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               Dims m, int dtype, cudaStream_t st) {
  if (dtype == 1) {
    CUtensorMap t[4];
    if (!qkv_maps<D>(t, q, k, v, dout, m, kDkvRows, kDkvKeys))
      return (int)cudaErrorInvalidValue;
    auto kern = flash_bwd_dkv_tma_kernel<D>;
    allow_smem(kern, dkv_smem<D>());
    kern<<<dim3((m.Sk + kDkvKeys - 1) / kDkvKeys, m.Hk, m.B), kDkvThreads,
           dkv_smem<D>(), st>>>(t[0], t[1], t[2], t[3], (const float*)lse,
                                (const float*)delta, (float*)dk, (float*)dv,
                                m.Sq, m.Sk, m.H, m.Hk, m.causal, m.scale);
  } else {
    auto kern = flash_bwd_dkv_f32_kernel<D>;
    allow_smem(kern, dkv_f32_smem<D>());
    kern<<<dim3((m.Sk + kF - 1) / kF, m.Hk, m.B), kFThreads,
           dkv_f32_smem<D>(), st>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
        (const float*)lse, (const float*)delta, (float*)dk, (float*)dv, m.Sq,
        m.Sk, m.H, m.Hk, m.causal, m.scale);
  }
  return (int)cudaGetLastError();
}

bool dims_ok(int B, int Sq, int Sk, int H, int Hk) {
  return B >= 1 && Sq >= 1 && Sk >= 1 && Hk >= 1 && H % Hk == 0 &&
         B <= 65535 && H <= 65535;
}
// B1: f32, bf16 or fp16 at head_dim 32, 64 or 128
bool fwd_ok(int D, int dtype) {
  return (D == 32 || D == 64 || D == 128) && dtype >= 0 && dtype <= 2;
}
// B2, B3: f32 or bf16 at head_dim 64 or 128
bool bwd_ok(int D, int dtype) {
  return (D == 64 || D == 128) && (dtype == 0 || dtype == 1);
}

}  // namespace

// Plain C entry points, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16,
// 2 = float16 (q, k, v, do, out, dq; float16 in B1 only); lse, delta, dk, dv
// are float32. Each returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a shape the
// kernels do not take); the Python wrapper raises when it is not 0.

extern "C" int pt_flash_fwd(const void* q, const void* k, const void* v,
                            void* out, void* lse, int B, int Sq, int Sk,
                            int H, int Hk, int D, int dtype, int causal,
                            float scale, void* stream) {
  if (!dims_ok(B, Sq, Sk, H, Hk) || !fwd_ok(D, dtype))
    return (int)cudaErrorInvalidValue;
  const Dims m{B, Sq, Sk, H, Hk, causal, scale};
  const cudaStream_t st = (cudaStream_t)stream;
  if (D == 128) return launch_fwd<128>(q, k, v, out, lse, m, dtype, st);
  if (D == 64) return launch_fwd<64>(q, k, v, out, lse, m, dtype, st);
  return launch_fwd<32>(q, k, v, out, lse, m, dtype, st);
}

extern "C" int pt_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int B, int Sq,
                               int Sk, int H, int Hk, int D, int dtype,
                               int causal, float scale, void* stream) {
  if (!dims_ok(B, Sq, Sk, H, Hk) || !bwd_ok(D, dtype))
    return (int)cudaErrorInvalidValue;
  const Dims m{B, Sq, Sk, H, Hk, causal, scale};
  return D == 128
             ? launch_dq<128>(q, k, v, dout, lse, delta, dq, m, dtype,
                              (cudaStream_t)stream)
             : launch_dq<64>(q, k, v, dout, lse, delta, dq, m, dtype,
                             (cudaStream_t)stream);
}

extern "C" int pt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int B,
                                int Sq, int Sk, int H, int Hk, int D,
                                int dtype, int causal, float scale,
                                void* stream) {
  if (!dims_ok(B, Sq, Sk, H, Hk) || !bwd_ok(D, dtype))
    return (int)cudaErrorInvalidValue;
  const Dims m{B, Sq, Sk, H, Hk, causal, scale};
  return D == 128
             ? launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, m, dtype,
                               (cudaStream_t)stream)
             : launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, m, dtype,
                              (cudaStream_t)stream);
}
