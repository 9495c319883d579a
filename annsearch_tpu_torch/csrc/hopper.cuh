// Hopper's own means for the scans (K2's flat_scan.cu, K1's ivf_scan.cu)
// and the wgmma probe (mma_probe.cu): mbarriers, TMA tile and bulk loads,
// wgmma with A from registers, setmaxnreg, named barriers, and on the host
// the tensor maps. sm_90a only.
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
// m64n32k32 .s32.s8.s8 takes the same bytes: A's registers hold four int8
// a word where the bf16 form holds two, and a k32 step is 32 bytes of B.

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

// `bytes` contiguous bytes from global memory into shared memory at dst,
// completing on bar (both 16-byte aligned, bytes a multiple of 16)
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// arrives on bar once this thread's earlier cp.async copies have landed
// (the barrier's count includes this arrival)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// orders this thread's earlier generic writes of shared memory before later
// reads by the async proxy (a wgmma's B operand)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a barrier of `count` threads (whole warps) under id `id` (0 is
// __syncthreads')
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
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

template <int kN>
__device__ __forceinline__ void fence_operands(int (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d = a . b (+ d where accumulate): one m64n32k16, A from registers
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], const uint32_t (&a)[4],
                                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// the same in int8: one m64n32k32 .s32.s8.s8, exact int32 sums
__device__ __forceinline__ void wgmma_m64n32k32_s8(int (&d)[16], const uint32_t (&a)[4],
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
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

// d = a . b (+ d where accumulate): one m64n128k16, A from registers (K2's
// wide rows: four tiles of 32 rows a product)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
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

// -- host: tensor maps -------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (the library
// links no libcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// a tensor map of `rank` dims (innermost first), strides in bytes of dims
// 1..; boxes past the tensor read as zeros
inline bool make_map(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* base,
                     const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                     CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  const cuuint32_t ones[3] = {1, 1, 1};
  return fn != nullptr &&
         fn(map, type, (cuuint32_t)rank, const_cast<void*>(base), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
