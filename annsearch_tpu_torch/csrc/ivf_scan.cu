// IVF cell scan: one kernel template, every variant of the Pallas kernel
// annsearch_tpu/ops/ivf_scan_pallas.py (_scan_kernel / _scan_body, launched
// by _fused_cell_scan):
//
//   K1a       int8 residual cells ("i8dec_residual"), l2, depth-2 fold, one
//             bf16 query term (the IVF-PQ main path);
//   K1b-l2    the same with two bf16 query terms (q_split: the mantissa
//             split hi + lo of the scaled residual);
//   K1b-cos   int8 residual cells, cos_renorm, fold, one or two query terms
//             (cosine IVF-PQ / IVF-OPQ);
//   K1d-i8dec int8 decode cells without centroids ("i8dec"), l2 or
//             cos_renorm, fold, one or two query terms;
//   K1d-f32   f32 cells, l2 or cos_plain, depth-2 fold (IvfIndex, approx);
//   K1c-f32   f32 cells, l2 or cos_plain, exact selection (IvfIndex, the
//             recall-1.0 tier);
//   K1d-bf16  bf16 cells, the query rounded to bf16 (one bf16 pass), l2 or
//             cos_plain, fold (IvfIndexBf16, approx);
//   K1c-bf16  bf16 cells, the f32 query, l2 or cos_plain, exact selection
//             (IvfIndexBf16, the default tier);
//   K1d-sq8   int8 cells and int8 query codes (carried as integer-valued
//             f32), l2 or cos_qnorm, fold (IvfSq8Index, approx);
//   K1c-sq8   the same, exact selection (IvfSq8Index, the default tier);
//   K1-fold1  any fold variant above with fold depth 1 (one survivor per
//             stride class: 128, not 256), _scan_body's fold_depth=1;
//   K1-exact-i8  the int8-decode prologues (K1a, K1b, K1d-i8dec) with the
//             exact selection, _scan_body's selection="exact" over int8
//             decode cells;
//   wide rows every variant at a padded d above kDMax (4,096): the query
//             term is staged in column blocks beside the cells' (below).
//
// What it computes, for task row r (segment s = task_seg[r], n = cnt[r]
// valid rows) and each query slot j < maxq (query id qid = lists[r, j]):
//   K1a, K1b-l2: qr = q[qid] - cent[s], qadd = sum(qr * qr), qk = T(qr * scales)
//   K1b-cos:     qk = T(q[qid] * scales), qadd = sum(q[qid] * cent[s])
//   K1d-i8dec:   qk = T(q[qid] * scales), qadd = sum(q * q) (l2) or 0
//         T(v) = bf16_rne(v) with one query term. With two, hi is v rounded
//         to bf16 by integer add-then-mask ((bits + 0x8000) & 0xFFFF0000:
//         ties away from zero, as the JAX package's mantissa_split), lo =
//         bf16_rne(v - hi), and T(v) = hi + lo. That sum is exact in f32
//         (both terms are multiples of ulp(v) and |hi + lo| <= 2^(e+1)), so
//         the kernel carries ONE f32 query value of up to 16 mantissa bits
//         and one FFMA per cell value: the FMA forms (hi + lo) * x exactly
//         and rounds only the running sum, where two separately accumulated
//         dots hi.x + lo.x round twice as often. The Pallas kernel sums two
//         MXU passes; either way the order of the f32 sums differs, so a
//         tolerance, not bits, holds the two packages together.
//   else: qk = q[qid] (K1d-bf16: bf16_rne(q[qid])); qadd = sum(q * q) (l2),
//         unused (cos_plain), or q_sq = sum(q * q) and qadd = 1 / sqrt(q_sq)
//         or 0 for a zero query (cos_qnorm)
//   dot_l = sum_c qk[c] * cell[s, l, c]   l < seg    (f32 FFMA; the int8 x
//           bf16, bf16 x bf16 and int8 x int8 products are exact in f32, and
//           sq8's sums stay integers below 2^24, so they are exact too)
//   dist  = max(qadd + sn[s, l] - 2 dot_l, 0) (l2), 1 - dot_l (cos_plain),
//           1 - (dot_l * qadd) * (1 / sqrt(max(sn[s, l], 1e-12)))
//           (cos_qnorm), or 1 - (dot_l + qadd) * (1 / sqrt(max(sn[s, l],
//           1e-12))) (cos_renorm); lanes l >= n are 3e38. The square roots and
//           quotients are IEEE-rounded (__fsqrt_rn, __fdiv_rn), not the
//           approximate rsqrtf, so the plain PyTorch version gives the
//           same bits.
//   fold:  stride class t = l mod 128 keeps its best and runner-up (depth
//          2) or its best alone (depth 1) over the chunks c = 0 .. seg/128-1
//          in order, updated with a strict <; then kb rounds of the
//          lexicographic minimum (value, lane) over the 256 (128) survivors,
//          each round setting the entries equal to the winner to 3e38 (so
//          short rows surface their 3e38 lanes in a fixed order)
//   exact: the kb lexicographically smallest (value, lane) pairs over the
//          valid lanes, then (3e38, 0) in every slot past n: the Pallas
//          extraction sets each emitted lane to 3e38 and so finds lane 0 in
//          every later round
// and writes out_d / out_i [R, maxq, kb]. A row with n == 0 writes
// (3e38, 0) everywhere, as the computation itself would.
//
// Bound on the H100: the multiply-adds, about (real query slots) x n x d per
// task row, done here on the CUDA cores in f32 (K1a's bf16 x int8, K1d-bf16's
// bf16 x bf16 and sq8's int8 x int8 products are exact in tensor-core MMA,
// so their bounds are the bf16 or int8 tensor-core peaks; the two-term
// variants' is two passes at the bf16 peak; K1c-bf16's f32 query is three
// exact bf16 terms, so its bound is three passes at the bf16 peak; the f32
// variants' is the fp32 peak). Each cell row is read from
// device memory once per block of 8 slots; f32 rows are 4x the bytes of int8
// ones, bf16 rows 2x.
// Design: one block per (task row, 8 query slots), one warp per slot. The
// segment's rows are staged 128 at a time, and at most 128 columns at a
// time, into shared memory as f32 and shared by the block's 8 warps, so a
// block holds at most 128 x 132 floats of cells whatever d is (three blocks
// fit an SM at d 256); thread t of a warp owns lanes t, t+32, t+64, t+96 of
// each chunk and keeps its selection state in registers, so the [maxq, seg]
// distance tile never leaves the SM. Chunks wholly past the row's valid
// rows are skipped (their lanes are 3e38 and change no selection state).
// The row stride in shared memory is padded by 4 floats, so the 128-bit
// loads of a quarter-warp fall in distinct banks. Each warp's query term
// sits in shared memory whole up to a padded d of kDMax (8 x 4,096 floats
// beside the staged cells); above it (kWide) the warp writes its query
// term's current 128 columns anew beside each staged column block, from
// the same per-element prologue, and qadd is summed once over all
// columns, so a wide row's partial dots add up over the blocks in column
// order before the epilogue, as a narrow row's do.
//   fold:  each thread holds the (best, runner-up) of its 4 stride classes
//          (the best alone at depth 1).
//   exact: the warp holds a sorted top-kb list (slot t in thread t mod 32,
//          register t / 32). A chunk whose lanes all rank after the list's
//          kb-th entry (a warp ballot) costs nothing more; otherwise the
//          list and the chunk's 128 candidates are merged by kb rounds of the
//          warp-wide lexicographic arg-min. seg is not bounded: a segment is
//          never held whole.
// Tensor-core MMA (wgmma) and TMA staging are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "lex_min.cuh"

namespace {

constexpr int kLanes = 128;   // chunk width: stride classes per query
constexpr int kCols = 128;    // columns staged at a time
constexpr int kWarps = 8;     // query slots per block
constexpr int kDMax = 4096;   // widest padded row whose query term is held whole
constexpr int kThreads = kWarps * 32;
constexpr float kBig = 3.0e38f;
constexpr float kEmpty = 3.4028234663852886e38f;  // FLT_MAX: an empty exact slot

enum Epilogue { kL2 = 0, kCosPlain = 1, kCosQnorm = 2, kCosRenorm = 3 };
// the query term: the scaled residual (K1a, K1b-l2), the query as it is,
// rounded to bf16, the scaled query (K1d-i8dec), or the scaled query with
// qadd = q . centroid (K1b-cos)
enum Prologue { kResidual = 0, kPlain = 1, kBf16Query = 2, kScaled = 3, kScaledCent = 4 };
// the selection: exact, or the fold at depth 1 or 2 (the C entries' `sel`)
enum Selection { kExactSel = 0, kFold1 = 1, kFold2 = 2 };

// the scaled query value as the scan scores it: one bf16 term, or the exact
// f32 sum of the two bf16 terms of the mantissa split (see the file header)
template <bool kSplit>
__device__ __forceinline__ float query_term(float v) {
  if constexpr (!kSplit) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    const float hi = __uint_as_float((__float_as_uint(v) + 0x8000u) & 0xFFFF0000u);
    const float lo = __bfloat162float(__float2bfloat16_rn(__fsub_rn(v, hi)));
    return __fadd_rn(hi, lo);
  }
}

// column c of a query slot's term as the scan scores it (0 past d), and its
// share of qadd added to `qadd`; `cent` is the segment's centroid row
template <int kPro, int kEpi, bool kSplit>
__device__ __forceinline__ float query_value(const float* qrow, const float* cent,
                                             const float* scales, int c, int d,
                                             float& qadd) {
  if (c >= d) return 0.f;
  if constexpr (kPro == kResidual) {
    const float qr = __fsub_rn(qrow[c], cent[c]);
    qadd = __fadd_rn(qadd, __fmul_rn(qr, qr));
    return query_term<kSplit>(__fmul_rn(qr, scales[c]));
  } else if constexpr (kPro == kScaled || kPro == kScaledCent) {
    const float qv = qrow[c];
    if constexpr (kPro == kScaledCent) {
      qadd = __fadd_rn(qadd, __fmul_rn(qv, cent[c]));
    } else if constexpr (kEpi == kL2) {
      qadd = __fadd_rn(qadd, __fmul_rn(qv, qv));
    }
    return query_term<kSplit>(__fmul_rn(qv, scales[c]));
  } else {
    const float v = qrow[c];
    if constexpr (kEpi != kCosPlain) qadd = __fadd_rn(qadd, __fmul_rn(v, v));
    if constexpr (kPro == kBf16Query) return __bfloat162float(__float2bfloat16_rn(v));
    return v;
  }
}

// stage columns [c0, c0 + w) of rows [0, 128) of `src` ([128, dp] cells)
// into cell_s as f32 (w a multiple of 16)
__device__ __forceinline__ void stage_chunk(const int8_t* src, float* cell_s,
                                            int dp, int c0, int w, int stride) {
  const int vec_per_row = w / 16;
  for (int v = threadIdx.x; v < kLanes * vec_per_row; v += kThreads) {
    const int row = v / vec_per_row;
    const int col = (v - row * vec_per_row) * 16;
    const int4 raw = *reinterpret_cast<const int4*>(src + (size_t)row * dp + c0 + col);
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
    float4* dst = reinterpret_cast<float4*>(cell_s + row * stride + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dst[e] = make_float4((float)b[4 * e], (float)b[4 * e + 1],
                           (float)b[4 * e + 2], (float)b[4 * e + 3]);
    }
  }
}

__device__ __forceinline__ void stage_chunk(const __nv_bfloat16* src, float* cell_s,
                                            int dp, int c0, int w, int stride) {
  const int vec_per_row = w / 8;
  for (int v = threadIdx.x; v < kLanes * vec_per_row; v += kThreads) {
    const int row = v / vec_per_row;
    const int col = (v - row * vec_per_row) * 8;
    const int4 raw = *reinterpret_cast<const int4*>(src + (size_t)row * dp + c0 + col);
    const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&raw);
    float4* dst = reinterpret_cast<float4*>(cell_s + row * stride + col);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      dst[e] = make_float4(__bfloat162float(b[4 * e]), __bfloat162float(b[4 * e + 1]),
                           __bfloat162float(b[4 * e + 2]), __bfloat162float(b[4 * e + 3]));
    }
  }
}

__device__ __forceinline__ void stage_chunk(const float* src, float* cell_s,
                                            int dp, int c0, int w, int stride) {
  const int vec_per_row = w / 4;
  for (int v = threadIdx.x; v < kLanes * vec_per_row; v += kThreads) {
    const int row = v / vec_per_row;
    const int col = (v - row * vec_per_row) * 4;
    *reinterpret_cast<float4*>(cell_s + row * stride + col) =
        *reinterpret_cast<const float4*>(src + (size_t)row * dp + c0 + col);
  }
}

template <typename CellT, int kPro, int kEpi, int kSel, bool kSplit, bool kWide>
__global__ void __launch_bounds__(kThreads)
ivf_scan_kernel(const int* __restrict__ lists,
                const int* __restrict__ task_seg,
                const int* __restrict__ cnt,
                const float* __restrict__ queries,
                const float* __restrict__ cents,   // kResidual, kScaledCent
                const float* __restrict__ scales,  // the int8-decode variants
                const CellT* __restrict__ cells,
                const float* __restrict__ sn,
                float* __restrict__ out_d, int* __restrict__ out_i,
                int maxq, int seg, int d, int dp, int kb) {
  constexpr bool kExact = kSel == kExactSel;
  extern __shared__ __align__(16) float smem[];
  const int cols = min(dp, kCols);
  const int stride = cols + 4;
  float* cell_s = smem;                            // [kLanes][cols + 4]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // this warp's query term: [dp], or its current column block [kCols]
  float* qk = smem + kLanes * stride + warp * (kWide ? kCols : dp);

  const int r = blockIdx.x;
  const int j = blockIdx.y * kWarps + warp;
  const bool active = j < maxq;
  const int n_valid = cnt[r];
  const size_t out_base = ((size_t)r * maxq + j) * kb;

  if (n_valid == 0) {  // block-uniform: no thread reaches a barrier
    if (active) {
      for (int t = lane; t < kb; t += 32) {
        out_d[out_base + t] = kBig;
        out_i[out_base + t] = 0;
      }
    }
    return;
  }
  const int s = task_seg[r];

  // prologue: this warp's query term and qadd
  float qadd = 0.f;
  const float* qrow = nullptr;
  const float* cent = nullptr;
  if constexpr (kPro == kResidual || kPro == kScaledCent) cent = cents + (size_t)s * d;
  if (active) {
    qrow = queries + (size_t)lists[(size_t)r * maxq + j] * d;
    for (int c = lane; c < dp; c += 32) {
      const float v = query_value<kPro, kEpi, kSplit>(qrow, cent, scales, c, d, qadd);
      if constexpr (!kWide) qk[c] = v;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      qadd += __shfl_xor_sync(0xffffffffu, qadd, o);
    }
    if constexpr (kEpi == kCosQnorm) {  // qadd = 1 / |q| (0 for a zero query)
      qadd = qadd > 0.f ? __fdiv_rn(1.f, __fsqrt_rn(fmaxf(qadd, 1e-12f))) : 0.f;
    }
  }

  // fold state: (best, runner-up) of stride classes lane + 32 i
  float v1[4], v2[4];
  int i1[4], i2[4];
  // exact state: sorted list slots lane + 32 i, and its kb-th entry
  float ev[4];
  int ei[4];
  float tv = kEmpty;
  int ti = INT_MAX;
#pragma unroll
  for (int i = 0; i < 4; ++i) { ev[i] = kEmpty; ei[i] = INT_MAX; }

  const CellT* blk = cells + (size_t)s * seg * dp;
  const float* snr = sn + (size_t)s * seg;
  // chunks past the valid rows hold only 3e38 lanes: skipped
  const int nchunks = (n_valid + kLanes - 1) / kLanes;

  for (int ch = 0; ch < nchunks; ++ch) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c0 = 0; c0 < dp; c0 += cols) {
      const int w = min(cols, dp - c0);
      __syncthreads();  // the previous block's reads are done (and qk written)
      stage_chunk(blk + (size_t)ch * kLanes * dp, cell_s, dp, c0, w, stride);
      if constexpr (kWide) {  // this block's query columns, beside the cells'
        if (active) {
          float unused = 0.f;
          for (int c = lane; c < w; c += 32) {
            qk[c] = query_value<kPro, kEpi, kSplit>(qrow, cent, scales, c0 + c, d, unused);
          }
        }
      }
      __syncthreads();
      if (!active) continue;
      const float* qb = kWide ? qk : qk + c0;
      // columns in order, as without the column blocks
      for (int c = 0; c < w; c += 4) {
        const float4 q4 = *reinterpret_cast<const float4*>(qb + c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 x4 =
              *reinterpret_cast<const float4*>(cell_s + (lane + 32 * i) * stride + c);
          acc[i] = __fmaf_rn(q4.x, x4.x, acc[i]);
          acc[i] = __fmaf_rn(q4.y, x4.y, acc[i]);
          acc[i] = __fmaf_rn(q4.z, x4.z, acc[i]);
          acc[i] = __fmaf_rn(q4.w, x4.w, acc[i]);
        }
      }
    }
    if (!active) continue;
    float dist[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = ch * kLanes + lane + 32 * i;
      if constexpr (kEpi == kL2) {
        dist[i] = fmaxf(__fsub_rn(__fadd_rn(qadd, snr[l]), 2.f * acc[i]), 0.f);
      } else if constexpr (kEpi == kCosPlain) {
        dist[i] = __fsub_rn(1.f, acc[i]);
      } else {
        const float rs = __fdiv_rn(1.f, __fsqrt_rn(fmaxf(snr[l], 1e-12f)));
        if constexpr (kEpi == kCosQnorm) {
          dist[i] = __fsub_rn(1.f, __fmul_rn(__fmul_rn(acc[i], qadd), rs));
        } else {  // cos_renorm
          dist[i] = __fsub_rn(1.f, __fmul_rn(__fadd_rn(acc[i], qadd), rs));
        }
      }
      if (l >= n_valid) dist[i] = kBig;
    }

    if constexpr (!kExact) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = ch * kLanes + lane + 32 * i;
        if (ch == 0) {
          v1[i] = dist[i]; i1[i] = l; v2[i] = kBig; i2[i] = 0;
        } else {
          const bool upd = dist[i] < v1[i];
          const float lose_v = upd ? v1[i] : dist[i];
          const int lose_i = upd ? i1[i] : l;
          if (upd) { v1[i] = dist[i]; i1[i] = l; }
          if constexpr (kSel == kFold2) {
            if (lose_v < v2[i]) { v2[i] = lose_v; i2[i] = lose_i; }
          }
        }
      }
    } else {
      // candidates: the chunk's valid lanes; the rest never enter the list
      float cv[4];
      int ci[4];
      bool beats = false;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = ch * kLanes + lane + 32 * i;
        cv[i] = l < n_valid ? dist[i] : kEmpty;
        ci[i] = l < n_valid ? l : INT_MAX;
        beats |= lex_less(cv[i], ci[i], tv, ti);
      }
      if (__any_sync(0xffffffffu, beats)) {
        float nv[4];
        int ni[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) { nv[i] = kEmpty; ni[i] = INT_MAX; }
        for (int t = 0; t < kb; ++t) {
          float bv = ev[0];
          int bi = ei[0];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (lex_less(ev[i], ei[i], bv, bi)) { bv = ev[i]; bi = ei[i]; }
            if (lex_less(cv[i], ci[i], bv, bi)) { bv = cv[i]; bi = ci[i]; }
          }
          warp_lex_min(bv, bi);
          if (bi == INT_MAX) break;  // warp-uniform: nothing left to take
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (t == lane + 32 * i) { nv[i] = bv; ni[i] = bi; }
            // lanes are unique: exactly one entry holds the winner
            if (ei[i] == bi) { ev[i] = kEmpty; ei[i] = INT_MAX; }
            if (ci[i] == bi) { cv[i] = kEmpty; ci[i] = INT_MAX; }
          }
        }
        float kv = nv[0];
        int ki = ni[0];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ev[i] = nv[i]; ei[i] = ni[i];
          if (i == (kb - 1) >> 5) { kv = nv[i]; ki = ni[i]; }
        }
        tv = __shfl_sync(0xffffffffu, kv, (kb - 1) & 31);
        ti = __shfl_sync(0xffffffffu, ki, (kb - 1) & 31);
      }
    }
  }
  if (!active) return;

  if constexpr (kExact) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = lane + 32 * i;
      if (t < kb) {
        const bool real = ei[i] != INT_MAX;
        out_d[out_base + t] = real ? ev[i] : kBig;
        out_i[out_base + t] = real ? ei[i] : 0;
      }
    }
  } else {
    // extraction: kb rounds of a warp-wide lexicographic arg-min
    for (int t = 0; t < kb; ++t) {
      float bv = v1[0];
      int bi = i1[0];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (lex_less(v1[i], i1[i], bv, bi)) { bv = v1[i]; bi = i1[i]; }
        if constexpr (kSel == kFold2) {
          if (lex_less(v2[i], i2[i], bv, bi)) { bv = v2[i]; bi = i2[i]; }
        }
      }
      warp_lex_min(bv, bi);
      if (lane == 0) {
        out_d[out_base + t] = bv;
        out_i[out_base + t] = bi;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (v1[i] == bv && i1[i] == bi) v1[i] = kBig;
        if constexpr (kSel == kFold2) {
          if (v2[i] == bv && i2[i] == bi) v2[i] = kBig;
        }
      }
    }
  }
}

size_t smem_bytes(int dp) {
  const int cols = dp < kCols ? dp : kCols;
  const int q_cols = dp > kDMax ? kCols : dp;
  return ((size_t)kLanes * (cols + 4) + (size_t)kWarps * q_cols) * sizeof(float);
}

template <typename CellT, int kPro, int kEpi, int kSel, bool kSplit, bool kWide>
int launch_impl(const void* lists, const void* task_seg, const void* cnt,
                const void* queries, const void* cents, const void* scales,
                const void* cells, const void* sn, void* out_d, void* out_i,
                int R, int maxq, int seg, int d, int dp, int kb, void* stream) {
  auto kern = ivf_scan_kernel<CellT, kPro, kEpi, kSel, kSplit, kWide>;
  const size_t smem = smem_bytes(dp);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(R, (maxq + kWarps - 1) / kWarps);
  kern<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)lists, (const int*)task_seg, (const int*)cnt,
      (const float*)queries, (const float*)cents, (const float*)scales,
      (const CellT*)cells, (const float*)sn, (float*)out_d, (int*)out_i,
      maxq, seg, d, dp, kb);
  return (int)cudaGetLastError();
}

// one variant at any width: the query term held whole up to kDMax, in
// column blocks above
template <typename CellT, int kPro, int kEpi, int kSel, bool kSplit = false>
int launch(const void* lists, const void* task_seg, const void* cnt,
           const void* queries, const void* cents, const void* scales,
           const void* cells, const void* sn, void* out_d, void* out_i,
           int R, int maxq, int seg, int d, int dp, int kb, void* stream) {
  auto run = dp > kDMax ? &launch_impl<CellT, kPro, kEpi, kSel, kSplit, true>
                        : &launch_impl<CellT, kPro, kEpi, kSel, kSplit, false>;
  return run(lists, task_seg, cnt, queries, cents, scales, cells, sn, out_d, out_i,
             R, maxq, seg, d, dp, kb, stream);
}

// Every instance's launcher has one signature
using Launch = decltype(&launch<float, kPlain, kL2, kExactSel>);

// one prologue and epilogue under each selection: [sel] (exact, fold 1, fold 2)
template <typename CellT, int kPro, int kEpi, bool kSplit = false>
constexpr Launch kBySel[3] = {
    launch<CellT, kPro, kEpi, kExactSel, kSplit>,
    launch<CellT, kPro, kEpi, kFold1, kSplit>,
    launch<CellT, kPro, kEpi, kFold2, kSplit>,
};

// K1c-f32 (exact) and K1d-f32 (fold): f32 cells, l2 or cos_plain: [cosine][sel]
const Launch* const kF32[2] = {kBySel<float, kPlain, kL2>, kBySel<float, kPlain, kCosPlain>};
// K1c-bf16 (exact: the f32 query) and K1d-bf16 (fold: the query rounded to
// bf16): bf16 cells, l2 or cos_plain: [cosine][sel]
const Launch kBf16[2][3] = {
    {launch<__nv_bfloat16, kPlain, kL2, kExactSel>,
     launch<__nv_bfloat16, kBf16Query, kL2, kFold1>,
     launch<__nv_bfloat16, kBf16Query, kL2, kFold2>},
    {launch<__nv_bfloat16, kPlain, kCosPlain, kExactSel>,
     launch<__nv_bfloat16, kBf16Query, kCosPlain, kFold1>,
     launch<__nv_bfloat16, kBf16Query, kCosPlain, kFold2>},
};
// K1c-sq8 and K1d-sq8: int8 cells, integer-valued query codes, l2 or
// cos_qnorm: [cosine][sel]
const Launch* const kSq8[2] = {kBySel<int8_t, kPlain, kL2>, kBySel<int8_t, kPlain, kCosQnorm>};
// K1a (one query term) and K1b-l2 (two): int8 residual cells, l2: [split][sel]
const Launch* const kResidualL2[2] = {kBySel<int8_t, kResidual, kL2, false>,
                                      kBySel<int8_t, kResidual, kL2, true>};
// K1b-cos: int8 residual cells, cos_renorm: [split][sel]
const Launch* const kResidualCos[2] = {kBySel<int8_t, kScaledCent, kCosRenorm, false>,
                                       kBySel<int8_t, kScaledCent, kCosRenorm, true>};
// K1d-i8dec: int8 decode cells, l2 or cos_renorm: [cosine][split][sel]
const Launch* const kI8dec[2][2] = {
    {kBySel<int8_t, kScaled, kL2, false>, kBySel<int8_t, kScaled, kL2, true>},
    {kBySel<int8_t, kScaled, kCosRenorm, false>, kBySel<int8_t, kScaled, kCosRenorm, true>},
};

int bad_sel(int sel) { return sel < 0 || sel > 2 ? (int)cudaErrorInvalidValue : 0; }

}  // namespace

// Launches on `stream`; each returns the launch's cudaError_t (0 on
// success). The caller validates shapes, types, contiguity and alignment.
// `sel` is the selection: 0 exact, 1 or 2 the fold at that depth.

// K1a: int8 residual cells, l2, one bf16 query term (sel 0: K1-exact-i8)
extern "C" int annsearch_ivf_scan_k1a(
    const void* lists, const void* task_seg, const void* cnt,
    const void* queries, const void* cents, const void* scales,
    const void* cells, const void* sn, void* out_d, void* out_i,
    int R, int maxq, int seg, int d, int dp, int kb, int sel, void* stream) {
  if (bad_sel(sel)) return bad_sel(sel);
  return kResidualL2[0][sel](
      lists, task_seg, cnt, queries, cents, scales, cells, sn, out_d, out_i,
      R, maxq, seg, d, dp, kb, stream);
}

// K1b-l2: int8 residual cells, l2, two bf16 query terms
extern "C" int annsearch_ivf_scan_k1b_l2(
    const void* lists, const void* task_seg, const void* cnt,
    const void* queries, const void* cents, const void* scales,
    const void* cells, const void* sn, void* out_d, void* out_i,
    int R, int maxq, int seg, int d, int dp, int kb, int sel, void* stream) {
  if (bad_sel(sel)) return bad_sel(sel);
  return kResidualL2[1][sel](
      lists, task_seg, cnt, queries, cents, scales, cells, sn, out_d, out_i,
      R, maxq, seg, d, dp, kb, stream);
}

// K1b-cos: int8 residual cells, cos_renorm, one or two query terms
extern "C" int annsearch_ivf_scan_k1b_cos(
    const void* lists, const void* task_seg, const void* cnt,
    const void* queries, const void* cents, const void* scales,
    const void* cells, const void* sn, void* out_d, void* out_i,
    int R, int maxq, int seg, int d, int dp, int kb, int split, int sel, void* stream) {
  if (bad_sel(sel)) return bad_sel(sel);
  return kResidualCos[split != 0][sel](
      lists, task_seg, cnt, queries, cents, scales, cells, sn, out_d, out_i,
      R, maxq, seg, d, dp, kb, stream);
}

// K1d-i8dec: int8 decode cells (no centroids), l2 or cos_renorm, one or two
// query terms
extern "C" int annsearch_ivf_scan_i8dec(
    const void* lists, const void* task_seg, const void* cnt,
    const void* queries, const void* scales, const void* cells,
    const void* sn, void* out_d, void* out_i, int R, int maxq, int seg, int d,
    int dp, int kb, int cosine, int split, int sel, void* stream) {
  if (bad_sel(sel)) return bad_sel(sel);
  return kI8dec[cosine != 0][split != 0][sel](
      lists, task_seg, cnt, queries, nullptr, scales, cells, sn, out_d, out_i,
      R, maxq, seg, d, dp, kb, stream);
}

// K1c-f32 / K1d-f32: f32 cells (f32 queries)
extern "C" int annsearch_ivf_scan_f32(
    const void* lists, const void* task_seg, const void* cnt,
    const void* queries, const void* cells, const void* sn, void* out_d,
    void* out_i, int R, int maxq, int seg, int d, int dp, int kb, int cosine,
    int sel, void* stream) {
  if (bad_sel(sel)) return bad_sel(sel);
  return kF32[cosine != 0][sel](lists, task_seg, cnt, queries, nullptr, nullptr, cells,
                                sn, out_d, out_i, R, maxq, seg, d, dp, kb, stream);
}

// K1c-bf16 / K1d-bf16: bf16 cells (f32 queries)
extern "C" int annsearch_ivf_scan_bf16(
    const void* lists, const void* task_seg, const void* cnt,
    const void* queries, const void* cells, const void* sn, void* out_d,
    void* out_i, int R, int maxq, int seg, int d, int dp, int kb, int cosine,
    int sel, void* stream) {
  if (bad_sel(sel)) return bad_sel(sel);
  return kBf16[cosine != 0][sel](lists, task_seg, cnt, queries, nullptr, nullptr, cells,
                                 sn, out_d, out_i, R, maxq, seg, d, dp, kb, stream);
}

// K1c-sq8 / K1d-sq8: int8 cells (f32 queries holding int8 codes)
extern "C" int annsearch_ivf_scan_sq8(
    const void* lists, const void* task_seg, const void* cnt,
    const void* queries, const void* cells, const void* sn, void* out_d,
    void* out_i, int R, int maxq, int seg, int d, int dp, int kb, int cosine,
    int sel, void* stream) {
  if (bad_sel(sel)) return bad_sel(sel);
  return kSq8[cosine != 0][sel](lists, task_seg, cnt, queries, nullptr, nullptr, cells,
                                sn, out_d, out_i, R, maxq, seg, d, dp, kb, stream);
}
