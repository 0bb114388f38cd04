// Hopper building blocks shared by the hand-written kernels (sm_90a): the
// tensor maps the TMA copies through, mbarriers, shared-memory matrix
// descriptors for wgmma and the wgmma instructions themselves (B1-B3, B8's
// prefill; B4's TMA copies); mma.sync, ldmatrix, cp.async and the cluster
// barrier and distributed shared-memory loads and stores (B4-B7, B8's
// GEMV, B10's dw); in raw PTX (PTX ISA 8.x, "Tensor Memory Accelerator",
// "mbarrier", "wgmma", "mma", "Cluster").
//
// Layouts. Every operand tile in shared memory is stored in the 128-byte
// swizzle (what a TMA copy with CU_TENSOR_MAP_SWIZZLE_128B writes): rows of
// 128 bytes (64 bf16), 8-row groups of 1024 bytes, the 16-byte chunk c of row
// r at chunk c ^ (r % 8), every group 1024-byte aligned.
//   K-major operand (the contraction dimension contiguous: x for B8, Q and K
//     for B1): a row is one row of the matrix, 64 K-values wide. A k16 step
//     advances the start address by 32 bytes inside the row; the next 8 rows
//     are SBO = 1024 bytes on; LBO is unused.
//   MN-major operand (the output dimension contiguous: the widened weight
//     for B8, V for B1): a row is one K-value, 64 N-values wide; 8 K-rows make
//     SBO = 1024 bytes, so a k16 step advances the start by 2048 bytes; the
//     next 64 N-values are a separate [K][64] block LBO bytes on.
//
// Accumulators (f32, m64nNk16): thread t of the warpgroup holds, for i in
// [0, N/2): row 16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2), column
// 8 * (i / 4) + 2 * (t % 4) + i % 2. A register A operand (bf16, k16) is the
// mma.m16n8k16 A fragment of each warp's 16 rows, so the accumulator of a
// product turns into the A operand of the next in place (`acc_to_a16`).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// the first 1024-byte-aligned address at or after p (swizzle atoms)
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// ---- mbarrier --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}
// make the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}
// arrive and add `bytes` to the transaction count the phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// wait for the completion of the phase of parity `parity` (the j-th
// completion of a barrier has parity j % 2). No timeout: a poll counter
// here costs B1 the register that keeps it from spilling.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

// ---- TMA -------------------------------------------------------------------

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0),
        "r"(c1) : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0),
        "r"(c1), "r"(c2) : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0),
        "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// ---- warpgroups ------------------------------------------------------------

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
// a barrier among `threads` threads (a warpgroup), id 1..15
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// generic-proxy writes to shared memory visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- wgmma -----------------------------------------------------------------

// descriptor of a 128-byte-swizzled operand starting at shared address
// `addr`; lbo / sbo in bytes (see the layouts above)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | (1ull << 62);
}
// the same for the 64-byte swizzle (layout type 2): rows of 64 bytes (32
// 16-bit values), 8-row groups of 512 bytes, the 16-byte chunk c of row r
// at chunk c ^ ((r / 2) % 4), every group 512-byte aligned (what a TMA copy
// with CU_TENSOR_MAP_SWIZZLE_64B writes). K-major: a k16 step advances the
// start by 32 bytes inside the row, SBO = 512. MN-major: a row is one
// K-value, 32 N-values wide, so a k16 step advances the start by 1024
// bytes, SBO = 512 (B1 at head_dim 32)
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | (2ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// ties the registers of an accumulator to this point of the program, so
// that the compiler moves no read or write of them across an asynchronous
// wgmma's issue or wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x N] (+)= A[64 x 16] B[16 x N], 16-bit floats in (bf16, or fp16
// with F16), f32 sums. SS: A and B from shared memory through descriptors;
// RS: A from registers. TB: B is MN-major (1) or K-major (0); A is K-major.
// scale_d 0 overwrites d. The two input types share every layout, so only
// the instruction's type suffix differs.

#define HOPPER_WGMMA_RS_N32(TY)                                               \
  asm volatile(                                                               \
      "{\n.reg .pred p;\n"                                                    \
      "setp.ne.b32 p, %21, 0;\n"                                              \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "             \
      "{"                                                                     \
      "%0, %1, %2, %3, %4, %5, %6, %7,"                                       \
      "%8, %9, %10, %11, %12, %13, %14, %15"                                  \
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"                      \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),\
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])       \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),                  \
        "r"(scale_d), "n"(TB))

template <int TB, bool F16 = false>
__device__ __forceinline__ void wgmma_rs_n32(
    float (&d)[16], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  if constexpr (F16)
    HOPPER_WGMMA_RS_N32("f16");
  else
    HOPPER_WGMMA_RS_N32("bf16");
}
#undef HOPPER_WGMMA_RS_N32

#define HOPPER_WGMMA_SS_N64(TY)                                               \
  asm volatile(                                                               \
      "{\n.reg .pred p;\n"                                                    \
      "setp.ne.b32 p, %34, 0;\n"                                              \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "             \
      "{"                                                                     \
      "%0, %1, %2, %3, %4, %5, %6, %7,"                                       \
      "%8, %9, %10, %11, %12, %13, %14, %15,"                                 \
      "%16, %17, %18, %19, %20, %21, %22, %23,"                               \
      "%24, %25, %26, %27, %28, %29, %30, %31"                                \
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"                                    \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),\
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
        "+f"(d[31])                                                           \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB))

template <int TB, bool F16 = false>
__device__ __forceinline__ void wgmma_ss_n64(
    float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (F16)
    HOPPER_WGMMA_SS_N64("f16");
  else
    HOPPER_WGMMA_SS_N64("bf16");
}
#undef HOPPER_WGMMA_SS_N64

#define HOPPER_WGMMA_RS_N64(TY)                                               \
  asm volatile(                                                               \
      "{\n.reg .pred p;\n"                                                    \
      "setp.ne.b32 p, %37, 0;\n"                                              \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "             \
      "{"                                                                     \
      "%0, %1, %2, %3, %4, %5, %6, %7,"                                       \
      "%8, %9, %10, %11, %12, %13, %14, %15,"                                 \
      "%16, %17, %18, %19, %20, %21, %22, %23,"                               \
      "%24, %25, %26, %27, %28, %29, %30, %31"                                \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"                      \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),\
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
        "+f"(d[31])                                                           \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),                  \
        "r"(scale_d), "n"(TB))

template <int TB, bool F16 = false>
__device__ __forceinline__ void wgmma_rs_n64(
    float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  if constexpr (F16)
    HOPPER_WGMMA_RS_N64("f16");
  else
    HOPPER_WGMMA_RS_N64("bf16");
}
#undef HOPPER_WGMMA_RS_N64

#define HOPPER_WGMMA_SS_N128(TY)                                              \
  asm volatile(                                                               \
      "{\n.reg .pred p;\n"                                                    \
      "setp.ne.b32 p, %66, 0;\n"                                              \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "            \
      "{"                                                                     \
      "%0, %1, %2, %3, %4, %5, %6, %7,"                                       \
      "%8, %9, %10, %11, %12, %13, %14, %15,"                                 \
      "%16, %17, %18, %19, %20, %21, %22, %23,"                               \
      "%24, %25, %26, %27, %28, %29, %30, %31,"                               \
      "%32, %33, %34, %35, %36, %37, %38, %39,"                               \
      "%40, %41, %42, %43, %44, %45, %46, %47,"                               \
      "%48, %49, %50, %51, %52, %53, %54, %55,"                               \
      "%56, %57, %58, %59, %60, %61, %62, %63"                                \
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"                                    \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),\
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),      \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),      \
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),      \
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),      \
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),      \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),      \
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                                 \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB))

template <int TB, bool F16 = false>
__device__ __forceinline__ void wgmma_ss_n128(
    float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (F16)
    HOPPER_WGMMA_SS_N128("f16");
  else
    HOPPER_WGMMA_SS_N128("bf16");
}
#undef HOPPER_WGMMA_SS_N128

#define HOPPER_WGMMA_RS_N128(TY)                                              \
  asm volatile(                                                               \
      "{\n.reg .pred p;\n"                                                    \
      "setp.ne.b32 p, %69, 0;\n"                                              \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "            \
      "{"                                                                     \
      "%0, %1, %2, %3, %4, %5, %6, %7,"                                       \
      "%8, %9, %10, %11, %12, %13, %14, %15,"                                 \
      "%16, %17, %18, %19, %20, %21, %22, %23,"                               \
      "%24, %25, %26, %27, %28, %29, %30, %31,"                               \
      "%32, %33, %34, %35, %36, %37, %38, %39,"                               \
      "%40, %41, %42, %43, %44, %45, %46, %47,"                               \
      "%48, %49, %50, %51, %52, %53, %54, %55,"                               \
      "%56, %57, %58, %59, %60, %61, %62, %63"                                \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"                      \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),\
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),      \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),      \
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),      \
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),      \
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),      \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),      \
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                                 \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),                  \
        "r"(scale_d), "n"(TB))

template <int TB, bool F16 = false>
__device__ __forceinline__ void wgmma_rs_n128(
    float (&d)[64], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  if constexpr (F16)
    HOPPER_WGMMA_RS_N128("f16");
  else
    HOPPER_WGMMA_RS_N128("bf16");
}
#undef HOPPER_WGMMA_RS_N128

// ---- mma.sync, ldmatrix, cp.async, streamed loads (B5, B8's GEMV) ---------

// d[16 x 8] += A[16 x 16] B[16 x 8], bf16 in, f32 sums. Thread t = 4 g + q
// of the warp holds A rows g and g + 8 at columns (2q, 2q + 1) (a[0], a[1])
// and (2q + 8, 2q + 9) (a[2], a[3]); B rows (2q, 2q + 1) (b0) and (2q + 8,
// 2q + 9) (b1) of column g; d rows g (d[0], d[1]) and g + 8 (d[2], d[3]) at
// columns (2q, 2q + 1). The low half of a register is the lower index.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the same product for an A whose rows 8-15 are zero (its registers a1 and
// a3): d holds rows 0-7 of the sum (D's registers d0, d1); rows 8-15 go to
// two scratch registers and are dropped
__device__ __forceinline__ void mma_16816_top(float (&d)[2], uint32_t a0,
                                              uint32_t a2, uint32_t b0,
                                              uint32_t b1) {
  float x, y;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %5}, {%7, %8}, {%0, %1, %9, %9};\n"
      : "+f"(d[0]), "+f"(d[1]), "=f"(x), "=f"(y)
      : "r"(a0), "r"(0u), "r"(a2), "r"(b0), "r"(b1), "f"(0.f));
}

// four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8. Lane t receives, of each matrix, row t / 4 at
// columns (2 (t % 4), +1), or with .trans column t / 4 at rows (2 (t % 4), +1)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 16 bytes from device to shared memory, asynchronously; bytes = 0 writes
// 16 zeros and reads nothing (src must still be a valid address)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
// 4 bytes from device to shared memory, asynchronously, through L1;
// bytes = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes read once (streamed weights): through the non-coherent path,
// not kept in L1. Volatile, so that the compiler issues it where it stands
// in the program and does not move it next to its first use
__device__ __forceinline__ uint4 ld_stream16(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// byte ia of a and byte ib of b, int8 codes each XORed with 0x80 (c + 128),
// as a bf16 pair (a's in the low half), exactly: the f32 bit patterns
// 0x4B0000xx = 2^23 + xx by byte permutes, one exact subtract, and the top
// halves permuted together (|c| <= 128 is exact in bf16)
__device__ __forceinline__ uint32_t widen_pair(uint32_t a, uint32_t b, int ia,
                                               int ib) {
  const float lo =
      __uint_as_float(__byte_perm(a, 0x4B000000u, 0x7540u + ia)) - 8388736.f;
  const float hi =
      __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7540u + ib)) - 8388736.f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632u);
}

// ---- thread-block clusters ---------------------------------------------------

// every thread of every block of the cluster arrives, then waits: shared
// memory written before it is visible to the whole cluster after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the shared::cluster address of shared address `addr` in block `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(addr)
               : "memory");
  return v;
}
__device__ __forceinline__ float2 ld_cluster2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}
__device__ __forceinline__ float4 ld_cluster4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_cluster(uint32_t addr, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(addr), "r"(v)
               : "memory");
}
// this block's rank in its cluster, and the cluster's blocks
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

// ---- host ------------------------------------------------------------------

// Let kernel K take `bytes` of dynamic shared memory (above 48 KB it must be
// allowed first). The attribute belongs to the current device: set once per
// kernel and device (a bit a device; devices past 63 set it every call).
template <auto K>
inline void opt_in_smem(int bytes) {
  static uint64_t opted_in = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (!(opted_in & bit)) {
    cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         bytes);
    opted_in |= bit;
  }
}

// launch `kernel` over `grid` in clusters of `cluster` blocks
template <typename... Params, typename... Args>
inline cudaError_t launch_cluster(void (*kernel)(Params...), dim3 grid,
                                  dim3 block, size_t smem, cudaStream_t st,
                                  dim3 cluster, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster.x;
  attr[0].val.clusterDim.y = cluster.y;
  attr[0].val.clusterDim.z = cluster.z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, ((Params)args)...);
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver library the runtime already
// loaded (no -lcuda), or null if that library does not offer it
static inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = (EncodeTiledFn)p;
  }
  return fn;
}

// a tensor map over `rank` dims (innermost first; strides in bytes of dims
// 1..rank-1), boxes of `box`, out-of-range elements read as zeros. Returns
// false when cuTensorMapEncodeTiled refuses it (alignment, sizes).
static inline bool make_map(CUtensorMap* map, CUtensorMapDataType type,
                            int rank, const void* base,
                            const cuuint64_t* dims, const cuuint64_t* strides,
                            const cuuint32_t* box, CUtensorMapSwizzle swz) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return enc(map, type, (cuuint32_t)rank, const_cast<void*>(base), dims,
             strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
