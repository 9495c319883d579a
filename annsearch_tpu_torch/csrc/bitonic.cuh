// Selections computed at once: a bitonic sort of (value, column) keys in a
// warp's registers. Shared by the K1 fold's selection (ivf_scan.cu,
// fold_select) and K2's extraction (flat_scan.cu, flat_extract_kernel).
//
// A pair (value, column) is one unsigned 64-bit key: the value's bits made
// order-preserving above the column, so that key order is lex_less's order
// (lex_min.cuh). -0 is taken as +0 (lex_less ranks them equal; no epilogue
// makes -0). A warp holds groups of 128 keys, 4 a lane: key u of lane l is
// element 4 l + u, so the network's partner distances 1 and 2 are
// compare-exchanges in registers and 4 .. 64 are __shfl_xor_sync of whole
// keys.

#pragma once

#include <stdint.h>

__device__ __forceinline__ uint64_t sort_key(float v, int col) {
  uint32_t b = __float_as_uint(__fadd_rn(v, 0.f));
  b ^= (b >> 31) ? 0xFFFFFFFFu : 0x80000000u;
  return ((uint64_t)b << 32) | (uint32_t)col;
}

__device__ __forceinline__ float key_value(uint64_t key) {
  uint32_t b = (uint32_t)(key >> 32);
  b ^= (b >> 31) ? 0x80000000u : 0xFFFFFFFFu;
  return __uint_as_float(b);
}

// one stage of a bitonic network over kH groups of 128 keys (group h in
// x[4 h .. 4 h + 3]): partner distance J, element i ascending where bit K
// of i is 0, odd groups the other way (so that two groups sorted together
// end one ascending, one descending); K = 256: every element ascending (odd
// groups descending)
template <int kH, int K, int J>
__device__ __forceinline__ void bitonic_stage(uint64_t (&x)[4 * kH], int lane) {
#pragma unroll
  for (int h = 0; h < kH; ++h) {
    if constexpr (J < 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (u & J) continue;
        const bool up = (((4 * lane + u) & K) == 0) != ((h & 1) == 1);
        const uint64_t a = x[4 * h + u], b = x[4 * h + (u | J)];
        const bool keep = (a < b) == up;
        x[4 * h + u] = keep ? a : b;
        x[4 * h + (u | J)] = keep ? b : a;
      }
    } else {
      const bool up = (((4 * lane) & K) == 0) != ((h & 1) == 1);
      const bool keep_min = ((lane & (J / 4)) == 0) == up;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint64_t a = x[4 * h + u];
        const uint64_t b = __shfl_xor_sync(0xffffffffu, a, J / 4);
        x[4 * h + u] = ((a < b) == keep_min) ? a : b;
      }
    }
  }
}

// the stages of partner distance J, J / 2, .. 1 under direction bit K
template <int kH, int K, int J>
__device__ __forceinline__ void bitonic_merge(uint64_t (&x)[4 * kH], int lane) {
  bitonic_stage<kH, K, J>(x, lane);
  if constexpr (J > 1) bitonic_merge<kH, K, J / 2>(x, lane);
}

// bitonic sort of each group: the merges of runs of 2, 4, .. K
template <int kH, int K>
__device__ __forceinline__ void bitonic_sort(uint64_t (&x)[4 * kH], int lane) {
  if constexpr (K > 2) bitonic_sort<kH, K / 2>(x, lane);
  bitonic_merge<kH, K, K / 2>(x, lane);
}
