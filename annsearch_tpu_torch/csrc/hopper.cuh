// Hopper's own means for K2's scan (flat_scan.cu) and the wgmma probe
// (mma_probe.cu): mbarriers, TMA tile loads, wgmma with A from registers,
// setmaxnreg. sm_90a only.
//
// wgmma.mma_async m64nNk16 .f32.bf16.bf16, A from registers: a warpgroup
// (four warps) multiplies 64 rows x 16 (k) of A by 16 x N of B, B read from
// shared memory through a descriptor. Warp w of the group holds rows 16 w ..
// 16 w + 15 of A and of D in mma.sync's m16n8k16 fragments (mma_terms.cuh):
// A as a[0..3] over k 0-7 / 8-15, D as N / 8 accumulator fragments, d[4 i
// + e] at row 16 w + g + 8 (e / 2), column 8 i + 2 t + e % 2 (lane = 4 g +
// t). B here is K-major (the database rows themselves) in the 64-byte
// swizzle TMA writes (CU_TENSOR_MAP_SWIZZLE_64B): rows of 64 bytes (32 bf16
// columns), the 16-byte units of row r XORed with (r / 2) mod 4, in atoms of
// 8 rows (512 bytes, aligned); the descriptor's stride between 8-row groups
// is 512 bytes, and the k16 step at byte 32 of a row adds 32 to its start.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// -- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// after the inits, before any other thread uses the barriers
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive once, and expect `bytes` of asynchronous copies in this phase
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// -- TMA ---------------------------------------------------------------------

// the box of `map` at coordinates (c0, c1[, c2]) into shared memory at dst,
// completing `bytes` on bar; coordinates outside the tensor read as zeros
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"((uint64_t)map), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"((uint64_t)map), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// -- wgmma -------------------------------------------------------------------

// the descriptor of a K-major B operand at p in the 64-byte swizzle
__device__ __forceinline__ uint64_t desc_sw64(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4)   // start address
         | (1ull << 16)                               // leading offset (unused)
         | ((uint64_t)(512 >> 4) << 32)               // 8-row groups 512 B apart
         | (2ull << 62);                              // 64-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// keeps the compiler from moving accesses of d across a wgmma wait
template <int kN>
__device__ __forceinline__ void fence_operands(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = a . b (+ d where accumulate): one m64n64k16, A from registers
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// -- registers ---------------------------------------------------------------

template <int kRegs>
__device__ __forceinline__ void regs_raise() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void regs_lower() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// byte offset of the 16-byte unit `unit` of row `row` in the 64-byte swizzle
__host__ __device__ constexpr int sw64(int row, int unit) {
  return row * 64 + ((unit ^ ((row >> 1) & 3)) << 4);
}

}  // namespace hopper
