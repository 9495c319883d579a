// Lexicographic (value, index) minimum: the order in which the scans'
// extractions emit their survivors (ties on the value go to the lower
// index). Shared by ivf_scan.cu and flat_scan.cu.

#pragma once

__device__ __forceinline__ bool lex_less(float va, int ia, float vb, int ib) {
  return va < vb || (va == vb && ia < ib);
}

// warp-wide lexicographic arg-min of (bv, bi); every lane gets the winner
__device__ __forceinline__ void warp_lex_min(float& bv, int& bi) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (lex_less(ov, oi, bv, bi)) { bv = ov; bi = oi; }
  }
}
