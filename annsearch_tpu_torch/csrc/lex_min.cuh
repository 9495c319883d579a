// Lexicographic (value, index) order: the order in which the scans'
// extractions emit their survivors (ties on the value go to the lower
// index). Used by flat_scan.cu's bins update.

#pragma once

__device__ __forceinline__ bool lex_less(float va, int ia, float vb, int ib) {
  return va < vb || (va == vb && ia < ib);
}
