// Tensor-core building blocks of the scans (ivf_scan.cu, flat_scan.cu).
//
// Both Pallas kernels form their dot products as bf16 passes on the MXU:
// an f32 operand travels as the bf16 terms of a mantissa split
// (annsearch_tpu/utils/dist.py::mantissa_split) and the kernel sums chosen
// cross terms into one f32 accumulator (flat_scan_pallas.py::_CROSS,
// ivf_scan_pallas.py::_scan_body). The port does the same on Hopper's
// tensor cores: this header holds the split, the fragment loads (ldmatrix)
// and the mma.sync product of the probe (mma_probe.cu; the scans' wgmma
// products are in hopper.cuh).
//
// Split. Term i < kTerms - 1 is the residual rounded to bf16 by integer
// add-then-mask ((bits + 0x8000) & 0xFFFF0000: half-way cases away from
// zero; the carry crosses a binade correctly), the last term the residual
// rounded to nearest even, as mantissa_split. One term is bf16_rne(v);
// two carry about 16 mantissa bits; three are exact for every normal f32
// (each residual holds at most the bits below the previous term's 8).
//
// Products. mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32: A is 16
// rows x 16 columns (k), B 16 (k) x 8 columns, C 16 x 8 in f32; the
// products are exact. On the H100 an element's 16 products and C are
// aligned to the largest of them and summed in fixed point about 25 bits
// wide, and the sum is truncated (rounded toward zero) to f32: it keeps 24
// bits of the largest term, where an IEEE sum rounds to nearest at every
// add (chip_smoke.py phase 1b measures it; the card test
// test_mma_sync_keeps_24_bits_of_the_largest_term holds it). So six cross
// terms of a three-way split sum to f32 grade in one mma chain, and a long
// accumulation is cut into fresh per-step sums joined by IEEE adds, so that
// the chops do not gather. For int8 operands (SQ8) K1 takes wgmma's
// .s32.s8.s8 (hopper.cuh), which sums exactly in int32. In bytes an A
// fragment is 16 rows x 32 bytes in either type (four int8 a register
// where bf16 puts two), so one loader serves both: ldmatrix.x4 of four 8 x
// 16-byte matrices.
//
// Accumulator fragment (f32 or s32), lane = 4 g + t (g = lane / 4,
// t = lane % 4):
//   c[0]: row g,     column 2t        c[1]: row g,     column 2t + 1
//   c[2]: row g + 8, column 2t        c[3]: row g + 8, column 2t + 1
// An element of a warp's tile therefore sits in the same thread and
// register for every k and every tile: the scans keep their selection
// state there.
//
// Shared-memory rows are in the 64-byte swizzle (hopper.cuh), so the eight
// rows of one ldmatrix matrix fall in distinct banks.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma {

// the kTerms bf16 terms (raw bits) of the mantissa split of v
template <int kTerms>
__device__ __forceinline__ void split(float v, uint16_t (&t)[kTerms]) {
  float r = v;
#pragma unroll
  for (int i = 0; i < kTerms - 1; ++i) {
    const uint32_t hb = (__float_as_uint(r) + 0x8000u) & 0xFFFF0000u;
    t[i] = (uint16_t)(hb >> 16);
    r = __fsub_rn(r, __uint_as_float(hb));
  }
  t[kTerms - 1] = __bfloat16_as_ushort(__float2bfloat16_rn(r));
}

// two bf16 values as one 32-bit word in memory order (lo at the lower
// address)
__device__ __forceinline__ uint32_t pack2(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

// Pairs (query term a, database term b) summed into one accumulator, in
// the order of flat_scan_pallas.py::_CROSS: with one database term every
// query term against it; with as many database terms as query terms the
// first cross_count pairs of (0,0) (0,1) (1,0) (0,2) (2,0) (1,1).
__host__ __device__ constexpr int cross_count(int qt, int xt) {
  return xt == 1 ? qt : (qt == 1 ? 1 : qt == 2 ? 3 : 6);
}
__host__ __device__ constexpr int cross_a(int xt, int p) {
  return xt == 1 ? p : (p == 2 ? 1 : p == 4 ? 2 : p == 5 ? 1 : 0);
}
__host__ __device__ constexpr int cross_b(int xt, int p) {
  return xt == 1 ? 0 : (p == 1 ? 1 : p == 3 ? 2 : p == 5 ? 1 : 0);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c += a . b over k 16 (bf16 operands, f32 sums)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte asynchronous copy global -> shared; `bytes` 0 fills zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes));
}

}  // namespace mma
