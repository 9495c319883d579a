// IVF cell scan: one kernel template, every variant of the Pallas kernel
// annsearch_tpu/ops/ivf_scan_pallas.py (_scan_kernel / _scan_body, launched
// by _fused_cell_scan), its products on the tensor cores:
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
//   K1a-bf16  K1a's residual prologue and l2 epilogue over bf16 cells, two
//             bf16 query terms, any selection (RaBitQ's fused
//             estimator: the cells are +-1 sign rows scaled by
//             |x - c| / |R u|_1, the scales ones; models/binary/rabitq.py);
//   K1-fold1  any fold variant above with fold depth 1 (one survivor per
//             stride class: 128, not 256), _scan_body's fold_depth=1;
//   K1-exact-i8  the int8-decode prologues (K1a, K1b, K1d-i8dec) with the
//             exact selection, _scan_body's selection="exact" over int8
//             decode cells;
//   wide rows every variant whose query terms do not fit the block whole:
//             the query terms are staged in column blocks beside the cells'
//             (below).
//
// What it computes, for task row r (segment s = task_seg[r], n = cnt[r]
// valid rows) and each query slot j < maxq (query id qid = lists[r, j]):
//   K1a, K1b-l2, K1a-bf16: v = (q[qid] - cent[s]) * scales,
//                qadd = |q[qid] - cent[s]|^2
//   K1b-cos:     v = q[qid] * scales, qadd = q[qid] . cent[s]
//   K1d-i8dec:   v = q[qid] * scales, qadd = |q|^2 (l2) or 0
//   else: v = q[qid]; qadd = |q|^2 (l2), unused (cos_plain), or q_sq =
//         |q|^2 and qadd = 1 / sqrt(q_sq), 0 for a zero query (cos_qnorm)
//   dot_l = sum over the pairs (a, b) of q_a . x_b[s, l]   l < seg
//         where q_a are the terms of v and x_b those of the cell row
//         (mma_terms.cuh), every pair and column into one accumulator:
//           int8 decode cells: x as bf16 (exact), v as one bf16 term
//             (bf16_rne) or two (q_split: hi by add-then-mask, lo =
//             bf16_rne(v - hi)): one or two passes, as the Pallas kernel;
//             K1a-bf16 takes bf16 cells as they are under the same
//             prologue (the Pallas body casts any cell type to bf16);
//           bf16 cells: v as one term (K1d-bf16, bf16_rne) or as three
//             (K1c-bf16: exact, the f32 query's 24 bits): 1 or 3 passes;
//           f32 cells: both sides as three terms, the six largest cross
//             terms (_CROSS[3]). The Pallas kernel splits f32 cells in two
//             (3 or 4 passes, about 16 mantissa bits); the port keeps f32
//             grade: three terms hold all 24 bits, and each 16-column
//             step is summed to 24 bits of its largest term (below), so
//             the dots stray from f64 no more than an FFMA loop's;
//           sq8: int8 codes x int8 cells on the integer tensor cores,
//             summed exactly in int32 and converted to f32 once (< 2^24:
//             the JAX package's integer-space distances bit for bit).
//         Products of bf16 terms are exact and sum into f32.
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
//          valid lanes whose value is at most FLT_MAX (-0 ranking as +0;
//          an inf or NaN distance never enters), then (3e38, 0) in every
//          slot past them: the Pallas extraction sets each emitted lane to
//          3e38 and so finds lane 0 in every later round
// and writes out_d / out_i [R, maxq, kb]. A row with n == 0 writes
// (3e38, 0) everywhere, as the computation itself would.
//
// Bound on the H100: the multiply-adds, about (real query slots) x n x d per
// task row, times the passes of the variant, at the tensor-core peak of
// their type (bf16; int8 for sq8). Each cell row is read from device
// memory once per block of 32 slots; f32 rows are 4x the bytes of int8
// ones, bf16 rows 2x.
// Design: one block per (task row, 32 query slots), eight warps. The
// segment's rows go 128 at a time (a chunk) and 128 source bytes of a row
// at a time (a step: 32 f32, 64 bf16 or 128 int8 columns) through shared
// memory, converted once per block into the bf16 terms the products take
// (int8 widened exactly, f32 split in three, bf16 and sq8 as they are);
// the next step's 16 KB are loaded into registers while the tensor cores
// work on this one. The slots' query terms come from the per-element
// prologue into shared memory as bf16 (int8 for sq8), whole when the block
// fits 110 KB (two blocks an SM); otherwise (kWide) each step's query
// columns are formed anew beside its cells, and qadd is summed once over
// all columns. Warp w takes slots 16 (w mod 2) .. +15 x lanes 32 (w / 2) ..
// +31 of a chunk: four m16n8 tiles, fed by ldmatrix, one mma.sync per
// (term pair, tile) per 16 columns (32 for int8), the accumulators carried
// over the steps of a chunk, so a wide row's sums run over all its columns
// before the epilogue, as a narrow row's do. The cross terms go smallest
// first; for f32 cells, the f32 query in three terms (K1c-bf16) and wide
// rows each 16 columns sum apart and join the chunk's sums by one IEEE
// add: an mma chops its sum to 24 bits of its largest term (mma_terms.cuh),
// and one accumulator over many steps gathers those chops, all leaning one
// way (hundreds of ulps over thousands of columns). Chunks wholly past the
// row's valid rows are skipped (their lanes are 3e38 and change no
// selection).
//   fold:  by the fragment map a thread holds the same 16 (slot, stride
//          class) elements in every chunk, and keeps their (best,
//          runner-up) in registers; after the last chunk the survivors go
//          to shared memory and each warp selects for its 4 slots, one at a
//          time: a bitonic sort of the slot's 128 (256) survivors in
//          registers, 4 (8) keys a lane, which gives the kb rounds' result
//          at once (fold_select); each lane stores its own 4 outputs. The
//          rounds themselves (kb dependent warp-wide arg-mins of 5 shuffles
//          each, one lane storing each winner) cost K1a-bf16 about 0.25 ms
//          per unit of kb on RaBitQ's 1M-row batch, where the sort costs
//          the same at every kb (PERF.md, the kb sweep).
//   exact: each slot keeps its kb smallest (value, lane) pairs as a sorted
//          list of 64-bit keys in shared memory (exact_key: the value's
//          order-preserving bits above the lane). A chunk's epilogue writes
//          its [32, 128] distances into one of two tiles (by chunk parity),
//          an entrant's value where the lane is valid, not above FLT_MAX and
//          at most its slot's kb-th value as last merged (a stale bound is
//          only looser), NaN elsewhere. No barrier follows: the warp that
//          owns a slot merges the tile row during the next chunk's first
//          step, beside that step's products, and after the last chunk
//          (exact_merge). A merge rechecks the entrants against the list's
//          kb-th key; none: nothing to do; up to 32 / ceil(kb / 32): one a
//          lane, each placed by counting the list's keys and the other
//          entrants below it (n broadcast steps); more: a bitonic sort of
//          the chunk's 128 keys, its minimum against the list read
//          backwards and a half cleaner.
//          So a merge costs what enters the list, never kb rounds. seg is
//          not bounded: a segment is never held whole.
// wgmma and TMA staging are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cfloat>
#include <climits>
#include <type_traits>

#include "bitonic.cuh"
#include "mma_terms.cuh"

namespace {

constexpr int kLanes = 128;    // chunk width: stride classes per query
constexpr int kSlots = 32;     // query slots per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStepBytes = 128;        // source bytes of a cell row per step
constexpr int kNarrowSmem = 110 * 1024;  // largest block with its query terms whole
constexpr int kTileStride = kLanes + 8;  // exact: floats of a distance-tile row
constexpr int kTile = kSlots * kTileStride;  // exact: floats of one distance tile
// exact: a merge takes its entrants one a lane while their count times the
// list's keys a lane (ceil(kb / 32)) is at most this, else it sorts
constexpr int kFew = 32;
constexpr float kBig = 3.0e38f;
// exact: the key of an empty list entry, exact_key(FLT_MAX, INT_MAX); every
// valid lane whose value is at most FLT_MAX ranks below it
constexpr uint64_t kEmptyKey = 0xFF7FFFFFFFFFFFFEull;
constexpr uint32_t kNoChunk = 0xFFFFu;  // fold: a runner-up that is still lane 0

enum Epilogue { kL2 = 0, kCosPlain = 1, kCosQnorm = 2, kCosRenorm = 3 };
// the query value: the scaled residual (K1a, K1b-l2), the query as it is
// (scored in three terms, or in int8 for sq8), the query in one bf16 term
// (K1d-bf16), the scaled query (K1d-i8dec), or the scaled query with
// qadd = q . centroid (K1b-cos)
enum Prologue { kResidual = 0, kPlain = 1, kBf16Query = 2, kScaled = 3, kScaledCent = 4 };
// the selection: exact, or the fold at depth 1 or 2 (the C entries' `sel`)
enum Selection { kExactSel = 0, kFold1 = 1, kFold2 = 2 };

// the arithmetic of an instance: which products, how many terms, and how a
// step is staged
template <typename CellT, int kPro, bool kSplit>
struct Terms {
  static constexpr bool kInt8 = std::is_same<CellT, int8_t>::value && kPro == kPlain;
  static constexpr int kXT = std::is_same<CellT, float>::value ? 3 : 1;   // cell terms
  static constexpr int kQT = kInt8 ? 1
                             : kPro == kPlain ? 3
                             : (kSplit && kPro != kBf16Query) ? 2 : 1;  // query terms
  static constexpr int kES = kInt8 ? 1 : 2;              // bytes of a term element
  static constexpr int kKStep = kInt8 ? 32 : 16;         // columns of one mma
  static constexpr int kCols = kStepBytes / (int)sizeof(CellT);   // columns of a step
  static constexpr int kRow = kCols * kES + 16;          // bytes of a staged row
  static constexpr int kCellTerm = kLanes * kRow;        // bytes of a staged cell term
  static constexpr int kMaxKs = kCols * kES / 32;        // mma steps of a step
};

// the query value of column c of a slot (0 past d), before the split, and
// its share of qadd added to `qadd`; `cent` is the segment's centroid row
template <int kPro, int kEpi>
__device__ __forceinline__ float query_value(const float* qrow, const float* cent,
                                             const float* scales, int c, int d,
                                             float& qadd) {
  if (c >= d) return 0.f;
  if constexpr (kPro == kResidual) {
    const float qr = __fsub_rn(qrow[c], cent[c]);
    qadd = __fadd_rn(qadd, __fmul_rn(qr, qr));
    return __fmul_rn(qr, scales[c]);
  } else if constexpr (kPro == kScaled || kPro == kScaledCent) {
    const float qv = qrow[c];
    if constexpr (kPro == kScaledCent) {
      qadd = __fadd_rn(qadd, __fmul_rn(qv, cent[c]));
    } else if constexpr (kEpi == kL2) {
      qadd = __fadd_rn(qadd, __fmul_rn(qv, qv));
    }
    return __fmul_rn(qv, scales[c]);
  } else {
    const float v = qrow[c];
    if constexpr (kEpi != kCosPlain) qadd = __fadd_rn(qadd, __fmul_rn(v, v));
    return v;
  }
}

// element c of a slot's query row in shared memory: the kQT bf16 terms of
// v at `term` bytes apart, or v as an int8 code
template <int kQT, bool kInt8>
__device__ __forceinline__ void put_query(unsigned char* row, int term, int c, float v) {
  if constexpr (kInt8) {
    row[c] = (unsigned char)(int8_t)__float2int_rn(v);
  } else {
    uint16_t t[kQT];
    mma::split<kQT>(v, t);
#pragma unroll
    for (int i = 0; i < kQT; ++i) *reinterpret_cast<uint16_t*>(row + i * term + 2 * c) = t[i];
  }
}

// a staged 16-byte source vector (row `row`, vector `vec` of the step) as
// the cell terms in shared memory
__device__ __forceinline__ void put_cells(unsigned char* cs, int row, int vec,
                                          const uint4& raw, const float*) {
  // f32: four values, three bf16 terms each
  const float* f = reinterpret_cast<const float*>(&raw);
  uint16_t t[4][3];
#pragma unroll
  for (int e = 0; e < 4; ++e) mma::split<3>(f[e], t[e]);
  constexpr int kRow = Terms<float, kPlain, false>::kRow;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    *reinterpret_cast<uint2*>(cs + i * Terms<float, kPlain, false>::kCellTerm + row * kRow +
                              vec * 8) =
        make_uint2(mma::pack2(t[0][i], t[1][i]), mma::pack2(t[2][i], t[3][i]));
  }
}
__device__ __forceinline__ void put_cells(unsigned char* cs, int row, int vec,
                                          const uint4& raw, const __nv_bfloat16*) {
  constexpr int kRow = Terms<__nv_bfloat16, kPlain, false>::kRow;
  *reinterpret_cast<uint4*>(cs + row * kRow + vec * 16) = raw;
}
// int8: as it is for the integer products (sq8), else widened to bf16
template <bool kInt8>
__device__ __forceinline__ void put_cells_i8(unsigned char* cs, int row, int vec,
                                             const uint4& raw) {
  constexpr int kRow = Terms<int8_t, kInt8 ? kPlain : kResidual, false>::kRow;
  if constexpr (kInt8) {
    *reinterpret_cast<uint4*>(cs + row * kRow + vec * 16) = raw;
  } else {
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
    uint32_t w[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      w[e] = mma::pack2(__bfloat16_as_ushort(__float2bfloat16_rn((float)b[2 * e])),
                        __bfloat16_as_ushort(__float2bfloat16_rn((float)b[2 * e + 1])));
    }
    uint4* dst = reinterpret_cast<uint4*>(cs + row * kRow + vec * 32);
    dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
    dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

// -- the fold's selection: a bitonic sort of the survivors in registers ------
// (the keys and the network: bitonic.cuh)

// The fold's selection of one slot: the kb rounds of _scan_body's stage 2
// (each emits the lexicographic minimum (value, lane) of the survivors and
// sets the entries equal to it to 3e38, keeping their lanes), computed at
// once. `sv` / `si` are the slot's kDepth x 128 survivors in shared memory.
// The rounds emit the survivors below 3e38 in key order; once those are
// spent, every entry holds 3e38 and each later round emits (3e38, m), m
// the least lane among the entries then at 3e38: those extracted and those
// at 3e38 from the start (runner-ups never displaced, lanes past a short
// row). So: sort the keys, keep the 128 smallest, emit the first n_fin,
// then (3e38, m). (Every survivor above 3e38, which only
// an overflowing distance gives: the first round takes the least, and the
// rest repeat its lane at 3e38.) Lane l writes outputs 4 l .. 4 l + 3.
template <int kDepth>
__device__ __forceinline__ void fold_select(const float* sv, const int* si, int lane, int kb,
                                            float* od, int* oi) {
  uint64_t x[4 * kDepth];
#pragma unroll
  for (int h = 0; h < kDepth; ++h) {
    const float4 v = *reinterpret_cast<const float4*>(sv + h * kLanes + 4 * lane);
    const int4 l = *reinterpret_cast<const int4*>(si + h * kLanes + 4 * lane);
    x[4 * h + 0] = sort_key(v.x, l.x);
    x[4 * h + 1] = sort_key(v.y, l.y);
    x[4 * h + 2] = sort_key(v.z, l.z);
    x[4 * h + 3] = sort_key(v.w, l.w);
  }
  bitonic_sort<kDepth, kLanes>(x, lane);
  // depth 2: the elementwise minimum of the ascending and the descending
  // half is a bitonic sequence holding the 128 smallest; its half cleaner
  // sorts it
  uint64_t s[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    s[u] = x[u];
    if constexpr (kDepth == 2) s[u] = x[4 + u] < s[u] ? x[4 + u] : s[u];
  }
  if constexpr (kDepth == 2) bitonic_merge<1, 2 * kLanes, kLanes / 2>(s, lane);
  // n_fin: keys below 3e38; m: the least lane of the keys at most 3e38
  const uint32_t big = __float_as_uint(kBig) ^ 0x80000000u;
  int n_fin = 0;
  uint32_t m = 0xFFFFFFFFu;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const uint32_t hi = (uint32_t)(s[u] >> 32);
    n_fin += hi < big;
    if (hi <= big) m = min(m, (uint32_t)s[u]);
  }
  n_fin = __reduce_add_sync(0xffffffffu, n_fin);
  m = __reduce_min_sync(0xffffffffu, m);
  if (m == 0xFFFFFFFFu) {   // warp-uniform
    n_fin = 1;
    m = __shfl_sync(0xffffffffu, (uint32_t)s[0], 0);
  }
  float d[4];
  int id[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const bool real = 4 * lane + u < n_fin;
    d[u] = real ? key_value(s[u]) : kBig;
    id[u] = (int)(real ? (uint32_t)s[u] : m);
  }
  if ((kb & 3) == 0) {   // 16-byte aligned rows of kb entries
    if (4 * lane < kb) {
      *reinterpret_cast<float4*>(od + 4 * lane) = make_float4(d[0], d[1], d[2], d[3]);
      *reinterpret_cast<int4*>(oi + 4 * lane) = make_int4(id[0], id[1], id[2], id[3]);
    }
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (4 * lane + u < kb) {
        od[4 * lane + u] = d[u];
        oi[4 * lane + u] = id[u];
      }
    }
  }
}

// -- the exact selection: sorted lists of (value, lane) keys ------------------

// The key of (v, lane): the value's order-preserving bits above the lane
// shifted left by one, whose low bit marks a -0. Key order is the
// lexicographic (value, lane) order with -0 ranking as +0 (lanes are
// unique, so the mark never decides), and a -0 comes back as it went in.
__device__ __forceinline__ uint64_t exact_key(float v, int lane) {
  uint32_t b = __float_as_uint(v);
  const uint32_t neg0 = b == 0x80000000u;
  b = neg0 ? 0u : b;
  b ^= (b >> 31) ? 0xFFFFFFFFu : 0x80000000u;
  return ((uint64_t)b << 32) | ((uint32_t)lane << 1) | neg0;
}

__device__ __forceinline__ float exact_value(uint64_t key) {
  return (key & 1) ? -0.f : key_value(key);
}

__device__ __forceinline__ int exact_lane(uint64_t key) { return (int)((uint32_t)key >> 1); }

// Merges one chunk's entrants of one slot into the slot's sorted list of kb
// keys, warp-wide. `trow` is the slot's row of the chunk's tile (an
// entrant's value, NaN elsewhere), `lbase` the chunk's first lane, `ecomp`
// 32 keys of this warp's own. The entrants are rechecked against the
// list's kb-th key (the tile was filtered by an older one). None: nothing
// to do. Few (n ceil(kb / 32) <= kFew): compacted one a lane in (lane,
// element) order, each placed by the count of list keys and of other
// entrants below it, and each list key moved up by the entrants below it
// (n broadcast steps of ceil(kb / 32) compares and ballots). More: a
// bitonic sort of the chunk's 128 keys (the empty key where no
// entrant), their elementwise minimum with the list read backwards, and a
// half cleaner, as fold_select at depth 2. Keys are unique, so both give
// the kb smallest of the list and the entrants, in order.
__device__ __forceinline__ void exact_merge(const float* trow, int lbase, uint64_t* list, int kb,
                                            uint64_t* ecomp, int lane) {
  const float4 v4 = *reinterpret_cast<const float4*>(trow + 4 * lane);
  const float v[4] = {v4.x, v4.y, v4.z, v4.w};
  const uint64_t kth = list[kb - 1];
  const uint32_t lower = (1u << lane) - 1u;
  uint64_t x[4];
  bool in[4];
  int n = 0, idx = 0;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    x[u] = exact_key(v[u], lbase + 4 * lane + u);
    in[u] = v[u] <= FLT_MAX && x[u] < kth;   // NaN: no entrant
    const uint32_t b = __ballot_sync(0xffffffffu, in[u]);
    n += __popc(b);
    idx += __popc(b & lower);
  }
  if (n == 0) return;   // warp-uniform
  if (n * ((kb + 31) / 32) > kFew) {
#pragma unroll
    for (int u = 0; u < 4; ++u) x[u] = in[u] ? x[u] : kEmptyKey;
    bitonic_sort<1, kLanes>(x, lane);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = kLanes - 1 - 4 * lane - u;
      const uint64_t y = r < kb ? list[r] : kEmptyKey;
      x[u] = y < x[u] ? y : x[u];
    }
    bitonic_merge<1, 2 * kLanes, kLanes / 2>(x, lane);
    __syncwarp();   // every lane has read the list
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (4 * lane + u < kb) list[4 * lane + u] = x[u];
    }
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (in[u]) ecomp[idx++] = x[u];
    }
    __syncwarp();
    const uint64_t e = lane < n ? ecomp[lane] : kEmptyKey;
    uint64_t lk[4];
    int up[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      lk[u] = lane + 32 * u < kb ? list[lane + 32 * u] : kEmptyKey;
      up[u] = 0;
    }
    int rank = 0, pos = 0;
    for (int j = 0; j < n; ++j) {
      const uint64_t ej = ecomp[j];
      rank += ej < e;
      int below = 0;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (32 * u >= kb) break;   // warp-uniform
        up[u] += ej < lk[u];
        below += __popc(__ballot_sync(0xffffffffu, lk[u] < ej));
      }
      if (lane == j) pos = below;
    }
    pos += rank;
    __syncwarp();   // every lane has read the list and the entrants
    if (lane < n && pos < kb) list[pos] = e;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int p = lane + 32 * u;
      if (p < kb && p + up[u] < kb) list[p + up[u]] = lk[u];
    }
  }
  __syncwarp();
}

// shared memory of an instance's stage: the staged cell terms and the query
// terms (whole, or one step's columns when wide)
template <typename CellT, int kPro, bool kSplit>
size_t stage_bytes(int dp, bool wide) {
  using TT = Terms<CellT, kPro, kSplit>;
  const size_t dkq = (size_t)(dp + TT::kKStep - 1) / TT::kKStep * TT::kKStep;
  const size_t qstride = wide ? TT::kRow : dkq * TT::kES + 16;
  return (size_t)TT::kXT * TT::kCellTerm + (size_t)TT::kQT * kSlots * qstride;
}

// dynamic shared memory of an instance: the stage, then for the exact
// selection its two distance tiles, the lists of kb keys and each warp's
// 32 compacted entrants; a fold's survivors reuse it after the scan
template <typename CellT, int kPro, int kSel, bool kSplit>
size_t smem_bytes(int dp, bool wide, int kb) {
  const size_t stage = stage_bytes<CellT, kPro, kSplit>(dp, wide);
  if (kSel == kExactSel) {
    return stage + 2 * kTile * sizeof(float) + (size_t)kSlots * kb * 8 + kWarps * 32 * 8;
  }
  const size_t surv = (size_t)kSlots * kSel * kLanes * 8;
  return stage > surv ? stage : surv;
}

// whether an instance forms its query terms a step at a time: the block
// with the query terms whole and 32 KB of selection state (a fold's
// survivors, or the exact lists as they were at 128 entries a slot) would
// pass kNarrowSmem. The rule predates the exact selection's smaller state
// and stays, so that every input takes the variant it took before.
template <typename CellT, int kPro, int kSel, bool kSplit>
bool wide_rows(int dp) {
  const size_t stage = stage_bytes<CellT, kPro, kSplit>(dp, false);
  const size_t sel = kSel == kExactSel ? stage + (size_t)kSlots * kLanes * 8
                                       : smem_bytes<CellT, kPro, kSel, kSplit>(dp, false, 0);
  return sel > (size_t)kNarrowSmem;
}

template <typename CellT, int kPro, int kEpi, int kSel, bool kSplit, bool kWide>
__global__ void __launch_bounds__(kThreads, 2)
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
  using TT = Terms<CellT, kPro, kSplit>;
  constexpr int kQT = TT::kQT, kXT = TT::kXT;
  constexpr bool kInt8 = TT::kInt8;
  constexpr bool kExact = kSel == kExactSel;
  constexpr int kDepth = kExact ? 1 : kSel;
  using Acc = typename std::conditional<kInt8, int, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float qadd_s[kSlots];
  __shared__ int qid_s[kSlots];   // a slot's query row, -1 past maxq

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;
  const int r = blockIdx.x;
  const int j0 = blockIdx.y * kSlots;
  const int n_valid = cnt[r];

  if (n_valid == 0) {  // block-uniform: no thread reaches a barrier
    for (int i = tid; i < kSlots * kb; i += kThreads) {
      const int slot = i / kb;
      if (j0 + slot < maxq) {
        const size_t o = ((size_t)r * maxq + j0 + slot) * kb + (i - slot * kb);
        out_d[o] = kBig;
        out_i[o] = 0;
      }
    }
    return;
  }
  const int s = task_seg[r];

  // shared memory: staged cell terms [kXT][128][kRow], query terms
  // [kQT][32][qstride], then (exact) the distance tiles [2][32][kTileStride],
  // the lists [32][kb] and the warps' compacted entrants [8][32]
  const int dkq = (dp + TT::kKStep - 1) / TT::kKStep * TT::kKStep;
  const int qstride = kWide ? TT::kRow : dkq * TT::kES + 16;
  const int q_term = kSlots * qstride;
  unsigned char* cell_s = smem;
  unsigned char* q_s = smem + kXT * TT::kCellTerm;
  float* tile_s = reinterpret_cast<float*>(q_s + kQT * q_term);
  uint64_t* list_s = reinterpret_cast<uint64_t*>(tile_s + 2 * kTile);
  uint64_t* ecomp_s = list_s + kSlots * kb + warp * 32;

  // prologue: each warp forms the query terms and qadd of its 4 slots,
  // the 4 side by side column by column so that their loads overlap
  constexpr int kPerWarp = kSlots / kWarps;
  const float* cent = nullptr;
  if constexpr (kPro == kResidual || kPro == kScaledCent) cent = cents + (size_t)s * d;
  {
    int qid[kPerWarp];
    float qadd[kPerWarp];
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
      const int j = j0 + warp * kPerWarp + i;
      qid[i] = j < maxq ? lists[(size_t)r * maxq + j] : -1;   // warp-uniform
      qadd[i] = 0.f;
    }
    for (int c = lane; c < (kWide ? d : dkq); c += 32) {
#pragma unroll
      for (int i = 0; i < kPerWarp; ++i) {
        const float v = qid[i] >= 0 ? query_value<kPro, kEpi>(queries + (size_t)qid[i] * d,
                                                              cent, scales, c, d, qadd[i])
                                    : 0.f;
        if constexpr (!kWide) {
          put_query<kQT, kInt8>(q_s + (warp * kPerWarp + i) * qstride, q_term, c, v);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
      float qa = qadd[i];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) qa += __shfl_xor_sync(0xffffffffu, qa, o);
      if constexpr (kEpi == kCosQnorm) {  // qadd = 1 / |q| (0 for a zero query)
        qa = qa > 0.f ? __fdiv_rn(1.f, __fsqrt_rn(fmaxf(qa, 1e-12f))) : 0.f;
      }
      if (lane == 0) {
        qadd_s[warp * kPerWarp + i] = qa;
        qid_s[warp * kPerWarp + i] = qid[i];
      }
    }
  }
  if constexpr (kExact) {
    for (int i = tid; i < kSlots * kb; i += kThreads) list_s[i] = kEmptyKey;
  }
  // exact: this warp's 4 slots merge chunk c's tile
  auto merge_chunk = [&](int c) {
    for (int i = 0; i < kPerWarp; ++i) {
      const int slot = warp * kPerWarp + i;
      if (qid_s[slot] < 0) continue;   // warp-uniform
      exact_merge(tile_s + (c & 1) * kTile + slot * kTileStride, c * kLanes,
                  list_s + slot * kb, kb, ecomp_s, lane);
    }
  };

  // fold state of the thread's 16 elements: element e of n-tile nb at
  // 4 nb + e is slot 16 wm + g + 8 (e / 2), stride class 32 wn + 8 nb +
  // 2 t4 + e % 2. A survivor's lane is chunk * 128 + its class, so one
  // register holds both survivors' chunks: the best's in the low 16 bits,
  // the runner-up's in the high 16 (kNoChunk: the runner-up's initial
  // lane 0); the C entries refuse segments of 65,535 chunks or more
  float v1[16], v2[16];
  uint32_t ic[16];
  Acc acc[4][4];
  // f32-grade products (f32 cells, the f32 query in three terms) and wide
  // rows: each 16 (32) columns' products sum into a fresh `part`, smallest
  // cross terms first, which joins `acc` by one IEEE add. An mma chops its
  // sum to 24 bits of its largest term, so one accumulator over many steps
  // gathers chops that all lean one way
  constexpr bool kStepSums = !kInt8 && (kXT == 3 || kQT == 3 || kWide);
  Acc part[4][4];
  Acc(&sum)[4][4] = kStepSums ? part : acc;

  const CellT* blk = cells + (size_t)s * seg * dp;
  const float* snr = sn + (size_t)s * seg;
  // chunks past the valid rows hold only 3e38 lanes: skipped
  const int nchunks = (n_valid + kLanes - 1) / kLanes;
  const int ncb = (dkq + TT::kCols - 1) / TT::kCols;
  const int nsteps = nchunks * ncb;
  constexpr int kVE = 16 / (int)sizeof(CellT);   // elements of a 16-byte vector

  // step t = (chunk, column block): the thread's up to 4 source vectors
  uint4 pre[4];
  auto load = [&](int t) {
    const int ch = t / ncb, c0 = (t - ch * ncb) * TT::kCols;
    const int vpr = min(TT::kCols, dkq - c0) / kVE;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int v = tid + kThreads * i;
      const int row = v / vpr, col = c0 + (v - row * vpr) * kVE;
      pre[i] = make_uint4(0u, 0u, 0u, 0u);
      if (v < kLanes * vpr && col < dp) {
        pre[i] = *reinterpret_cast<const uint4*>(blk + ((size_t)ch * kLanes + row) * dp + col);
      }
    }
  };
  auto store = [&](int t) {
    const int c0 = (t - t / ncb * ncb) * TT::kCols;
    const int vpr = min(TT::kCols, dkq - c0) / kVE;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int v = tid + kThreads * i;
      if (v >= kLanes * vpr) continue;
      const int row = v / vpr, vec = v - row * vpr;
      if constexpr (std::is_same<CellT, int8_t>::value) {
        put_cells_i8<kInt8>(cell_s, row, vec, pre[i]);
      } else {
        put_cells(cell_s, row, vec, pre[i], static_cast<const CellT*>(nullptr));
      }
    }
  };

  const int a_base = mma::a_offset(lane, qstride) + wm * 16 * qstride;
  const int b_base = mma::b_offset(lane, TT::kRow) + wn * 32 * TT::kRow;
  load(0);
  for (int t = 0; t < nsteps; ++t) {
    const int ch = t / ncb, cb = t - ch * ncb;
    const int c0 = cb * TT::kCols;
    const int w = min(TT::kCols, dkq - c0);
    __syncthreads();  // the previous step's reads of the staged terms are done
    store(t);
    if constexpr (kWide) {  // this step's query columns, beside the cells'
      for (int i = tid; i < kSlots * w; i += kThreads) {
        const int slot = i / w, c = i - slot * w;
        const int qid = qid_s[slot];
        float unused = 0.f;
        const float v = qid >= 0 ? query_value<kPro, kEpi>(queries + (size_t)qid * d, cent,
                                                         scales, c0 + c, d, unused)
                                 : 0.f;
        put_query<kQT, kInt8>(q_s + slot * qstride, q_term, c, v);
      }
    }
    __syncthreads();
    if (t + 1 < nsteps) load(t + 1);
    if constexpr (kExact) {
      // the previous chunk's tile, written before the barriers above; the
      // next write of it (chunk ch + 1) comes after at least one more
      if (cb == 0 && ch > 0) merge_chunk(ch - 1);
    }
    if (cb == 0) {
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nb][e] = 0;
      }
    }
    const unsigned char* qa = q_s + a_base + (kWide ? 0 : c0 * TT::kES);
    const unsigned char* xb = cell_s + b_base;
    const int nks = w * TT::kES / 32;
#pragma unroll
    for (int ks = 0; ks < TT::kMaxKs; ++ks) {
      if (ks >= nks) break;
      uint32_t a[kQT][4];
#pragma unroll
      for (int i = 0; i < kQT; ++i) mma::ldsm_x4(a[i], qa + i * q_term + ks * 32);
      if constexpr (kStepSums) {
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
          for (int e = 0; e < 4; ++e) part[nb][e] = 0;
        }
      }
      // cell terms from the smallest; within one, query terms likewise
#pragma unroll
      for (int b = kXT - 1; b >= 0; --b) {
        uint32_t b01[4], b23[4];
        mma::ldsm_x4(b01, xb + b * TT::kCellTerm + ks * 32);
        mma::ldsm_x4(b23, xb + b * TT::kCellTerm + 16 * TT::kRow + ks * 32);
#pragma unroll
        for (int p = mma::cross_count(kQT, kXT) - 1; p >= 0; --p) {
          if (mma::cross_b(kXT, p) != b) continue;
          const int ai = mma::cross_a(kXT, p);
          if constexpr (kInt8) {
            mma::mma_s8(sum[0], a[ai], b01[0], b01[1]);
            mma::mma_s8(sum[1], a[ai], b01[2], b01[3]);
            mma::mma_s8(sum[2], a[ai], b23[0], b23[1]);
            mma::mma_s8(sum[3], a[ai], b23[2], b23[3]);
          } else {
            mma::mma_bf16(sum[0], a[ai], b01[0], b01[1]);
            mma::mma_bf16(sum[1], a[ai], b01[2], b01[3]);
            mma::mma_bf16(sum[2], a[ai], b23[0], b23[1]);
            mma::mma_bf16(sum[3], a[ai], b23[2], b23[3]);
          }
        }
      }
      if constexpr (kStepSums) {
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nb][e] = __fadd_rn(acc[nb][e], part[nb][e]);
        }
      }
    }
    if (cb != ncb - 1) continue;

    // epilogue of chunk ch on the fragment
    const float qa0 = qadd_s[wm * 16 + g], qa1 = qadd_s[wm * 16 + g + 8];
    float dist[16];
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      const int l0 = ch * kLanes + wn * 32 + nb * 8 + 2 * t4;
      const float2 sv = *reinterpret_cast<const float2*>(snr + l0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int l = l0 + (e & 1);
        const float snl = (e & 1) ? sv.y : sv.x;
        const float qadd = (e >> 1) ? qa1 : qa0;
        const float dot = (float)acc[nb][e];
        float dv;
        if constexpr (kEpi == kL2) {
          dv = fmaxf(__fsub_rn(__fadd_rn(qadd, snl), 2.f * dot), 0.f);
        } else if constexpr (kEpi == kCosPlain) {
          dv = __fsub_rn(1.f, dot);
        } else {
          const float rs = __fdiv_rn(1.f, __fsqrt_rn(fmaxf(snl, 1e-12f)));
          if constexpr (kEpi == kCosQnorm) {
            dv = __fsub_rn(1.f, __fmul_rn(__fmul_rn(dot, qadd), rs));
          } else {  // cos_renorm
            dv = __fsub_rn(1.f, __fmul_rn(__fadd_rn(dot, qadd), rs));
          }
        }
        dist[nb * 4 + e] = l >= n_valid ? kBig : dv;
      }
    }

    if constexpr (!kExact) {
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        if (ch == 0) {
          v1[k] = dist[k]; v2[k] = kBig; ic[k] = kNoChunk << 16;
        } else {
          const bool upd = dist[k] < v1[k];
          const float lose_v = upd ? v1[k] : dist[k];
          const uint32_t lose_c = upd ? ic[k] & 0xFFFFu : (uint32_t)ch;
          if (upd) { v1[k] = dist[k]; ic[k] = (ic[k] & 0xFFFF0000u) | ch; }
          if constexpr (kSel == kFold2) {
            if (lose_v < v2[k]) { v2[k] = lose_v; ic[k] = (ic[k] & 0xFFFFu) | (lose_c << 16); }
          }
        }
      }
    } else {
      // the chunk's tile (by parity): an entrant's value where the lane is
      // valid, the value at most FLT_MAX (no inf, no NaN) and its key's
      // value bits at most those of the slot's kb-th key as last merged
      // (read as one word: a concurrent merge leaves the old or the new)
      float* tile = tile_s + (ch & 1) * kTile;
      uint32_t thr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        thr[h] = reinterpret_cast<const volatile uint32_t*>(
            list_s + (wm * 16 + g + 8 * h) * kb + kb - 1)[1];
      }
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float w[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int l = ch * kLanes + wn * 32 + nb * 8 + 2 * t4 + e;
            const float dv = dist[nb * 4 + 2 * h + e];
            const bool in = l < n_valid && dv <= FLT_MAX &&
                            (uint32_t)(exact_key(dv, l) >> 32) <= thr[h];
            w[e] = in ? dv : __int_as_float(0x7fffffff);
          }
          const int slot = wm * 16 + g + 8 * h;
          *reinterpret_cast<float2*>(tile + slot * kTileStride + wn * 32 + nb * 8 + 2 * t4) =
              make_float2(w[0], w[1]);
        }
      }
    }
  }

  if constexpr (kExact) {
    __syncthreads();   // the last chunk's tile is written
    merge_chunk(nchunks - 1);
    for (int i = 0; i < kPerWarp; ++i) {
      const int slot = warp * kPerWarp + i;
      if (qid_s[slot] < 0) continue;
      const size_t ob = ((size_t)r * maxq + j0 + slot) * kb;
      for (int p = lane; p < kb; p += 32) {
        const uint64_t key = list_s[slot * kb + p];
        const bool real = key != kEmptyKey;
        out_d[ob + p] = real ? exact_value(key) : kBig;
        out_i[ob + p] = real ? exact_lane(key) : 0;
      }
    }
  } else {
    // the survivors of every slot to shared memory ([32][kDepth * 128]),
    // then each warp selects for its 4 slots (fold_select)
    constexpr int kSurv = kDepth * kLanes;
    float* sv_s = reinterpret_cast<float*>(smem);
    int* si_s = reinterpret_cast<int*>(sv_s + kSlots * kSurv);
    __syncthreads();  // every warp is done with the staged terms
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int slot = wm * 16 + g + 8 * ((k & 3) >> 1);
      const int cls = wn * 32 + (k >> 2) * 8 + 2 * t4 + (k & 1);
      sv_s[slot * kSurv + cls] = v1[k];
      si_s[slot * kSurv + cls] = (int)(ic[k] & 0xFFFFu) * kLanes + cls;
      if constexpr (kSel == kFold2) {
        const uint32_t c2 = ic[k] >> 16;
        sv_s[slot * kSurv + kLanes + cls] = v2[k];
        si_s[slot * kSurv + kLanes + cls] = c2 == kNoChunk ? 0 : (int)c2 * kLanes + cls;
      }
    }
    __syncthreads();
    for (int i = 0; i < kPerWarp; ++i) {
      const int slot = warp * kPerWarp + i;
      if (qid_s[slot] < 0) continue;   // warp-uniform
      const size_t ob = ((size_t)r * maxq + j0 + slot) * kb;
      fold_select<kDepth>(sv_s + slot * kSurv, si_s + slot * kSurv, lane, kb, out_d + ob,
                          out_i + ob);
    }
  }
}

// the last launch: blocks an SM (the occupancy calculator), dynamic shared
// memory, whether its rows were wide, and its stage's shared memory
int g_last_launch[4];

template <typename CellT, int kPro, int kEpi, int kSel, bool kSplit, bool kWide>
int launch_impl(const void* lists, const void* task_seg, const void* cnt,
                const void* queries, const void* cents, const void* scales,
                const void* cells, const void* sn, void* out_d, void* out_i,
                int R, int maxq, int seg, int d, int dp, int kb, void* stream) {
  auto kern = ivf_scan_kernel<CellT, kPro, kEpi, kSel, kSplit, kWide>;
  const size_t smem = smem_bytes<CellT, kPro, kSel, kSplit>(dp, kWide, kb);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  static size_t seen = 0;   // the occupancy of this instance at `seen` bytes
  static int blocks = 0;
  if (smem != seen) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    seen = smem;
  }
  g_last_launch[0] = blocks;
  g_last_launch[1] = (int)smem;
  g_last_launch[2] = kWide;
  g_last_launch[3] = (int)stage_bytes<CellT, kPro, kSplit>(dp, kWide);
  const dim3 grid(R, (maxq + kSlots - 1) / kSlots);
  kern<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)lists, (const int*)task_seg, (const int*)cnt,
      (const float*)queries, (const float*)cents, (const float*)scales,
      (const CellT*)cells, (const float*)sn, (float*)out_d, (int*)out_i,
      maxq, seg, d, dp, kb);
  return (int)cudaGetLastError();
}

// one variant at any width: the query terms held whole where the block
// fits kNarrowSmem (wide_rows), in column blocks beside the cells' past it
template <typename CellT, int kPro, int kEpi, int kSel, bool kSplit = false>
int launch(const void* lists, const void* task_seg, const void* cnt,
           const void* queries, const void* cents, const void* scales,
           const void* cells, const void* sn, void* out_d, void* out_i,
           int R, int maxq, int seg, int d, int dp, int kb, void* stream) {
  const bool wide = wide_rows<CellT, kPro, kSel, kSplit>(dp);
  auto run = wide ? &launch_impl<CellT, kPro, kEpi, kSel, kSplit, true>
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
// K1c-bf16 (exact: the f32 query in three terms) and K1d-bf16 (fold: the
// query in one bf16 term): bf16 cells, l2 or cos_plain: [cosine][sel]
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
// K1a-bf16: bf16 residual cells, l2, two query terms (RaBitQ's estimator
// takes fused_ivf_scan's q_split=True; one term is refused): [sel]. The
// staged row of a bf16 step holds 64 columns (kCols), so d 128 and 256 take two
// and four steps a chunk (64 KB of shared memory at fold depth 2, the
// survivors' share; 58 / 67 KB exact at d 128 / 256); the query terms stay
// whole up to a padded d of 1,464 (fold) or 952 (exact) under
// kNarrowSmem, past which the kWide instances take them
const Launch* const kResidualBf16 = kBySel<__nv_bfloat16, kResidual, kL2, true>;
// K1d-i8dec: int8 decode cells, l2 or cos_renorm: [cosine][split][sel]
const Launch* const kI8dec[2][2] = {
    {kBySel<int8_t, kScaled, kL2, false>, kBySel<int8_t, kScaled, kL2, true>},
    {kBySel<int8_t, kScaled, kCosRenorm, false>, kBySel<int8_t, kScaled, kCosRenorm, true>},
};

// `sel` is 0, 1 or 2; a fold's segment holds fewer than kNoChunk chunks
int bad_sel(int sel, int seg) {
  return sel < 0 || sel > 2 || (sel > 0 && seg / kLanes >= (int)kNoChunk)
             ? (int)cudaErrorInvalidValue
             : 0;
}

}  // namespace

// Launches on `stream`; each returns the launch's cudaError_t (0 on
// success). The caller validates shapes, types, contiguity and alignment.
// `sel` is the selection: 0 exact, 1 or 2 the fold at that depth.

// The last launch of any entry below: (blocks an SM, dynamic shared memory
// in bytes, 1 if its rows were wide, its stage's bytes) into out[0..3]
extern "C" int annsearch_ivf_scan_last_launch(int* out) {
  for (int i = 0; i < 4; ++i) out[i] = g_last_launch[i];
  return 0;
}

// K1a: int8 residual cells, l2, one bf16 query term (sel 0: K1-exact-i8)
extern "C" int annsearch_ivf_scan_k1a(
    const void* lists, const void* task_seg, const void* cnt,
    const void* queries, const void* cents, const void* scales,
    const void* cells, const void* sn, void* out_d, void* out_i,
    int R, int maxq, int seg, int d, int dp, int kb, int sel, void* stream) {
  if (bad_sel(sel, seg)) return bad_sel(sel, seg);
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
  if (bad_sel(sel, seg)) return bad_sel(sel, seg);
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
  if (bad_sel(sel, seg)) return bad_sel(sel, seg);
  return kResidualCos[split != 0][sel](
      lists, task_seg, cnt, queries, cents, scales, cells, sn, out_d, out_i,
      R, maxq, seg, d, dp, kb, stream);
}

// K1a-bf16: bf16 residual cells, l2, two bf16 query terms (RaBitQ's
// estimator rows)
extern "C" int annsearch_ivf_scan_k1a_bf16(
    const void* lists, const void* task_seg, const void* cnt,
    const void* queries, const void* cents, const void* scales,
    const void* cells, const void* sn, void* out_d, void* out_i,
    int R, int maxq, int seg, int d, int dp, int kb, int sel, void* stream) {
  if (bad_sel(sel, seg)) return bad_sel(sel, seg);
  return kResidualBf16[sel](
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
  if (bad_sel(sel, seg)) return bad_sel(sel, seg);
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
  if (bad_sel(sel, seg)) return bad_sel(sel, seg);
  return kF32[cosine != 0][sel](lists, task_seg, cnt, queries, nullptr, nullptr, cells,
                                sn, out_d, out_i, R, maxq, seg, d, dp, kb, stream);
}

// K1c-bf16 / K1d-bf16: bf16 cells (f32 queries)
extern "C" int annsearch_ivf_scan_bf16(
    const void* lists, const void* task_seg, const void* cnt,
    const void* queries, const void* cells, const void* sn, void* out_d,
    void* out_i, int R, int maxq, int seg, int d, int dp, int kb, int cosine,
    int sel, void* stream) {
  if (bad_sel(sel, seg)) return bad_sel(sel, seg);
  return kBf16[cosine != 0][sel](lists, task_seg, cnt, queries, nullptr, nullptr, cells,
                                 sn, out_d, out_i, R, maxq, seg, d, dp, kb, stream);
}

// K1c-sq8 / K1d-sq8: int8 cells (f32 queries holding int8 codes)
extern "C" int annsearch_ivf_scan_sq8(
    const void* lists, const void* task_seg, const void* cnt,
    const void* queries, const void* cells, const void* sn, void* out_d,
    void* out_i, int R, int maxq, int seg, int d, int dp, int kb, int cosine,
    int sel, void* stream) {
  if (bad_sel(sel, seg)) return bad_sel(sel, seg);
  return kSq8[cosine != 0][sel](lists, task_seg, cnt, queries, nullptr, nullptr, cells,
                                sn, out_d, out_i, R, maxq, seg, d, dp, kb, stream);
}
