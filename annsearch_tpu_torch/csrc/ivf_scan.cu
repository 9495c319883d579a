// IVF cell scan: one kernel template, every variant of the Pallas kernel
// annsearch_tpu/ops/ivf_scan_pallas.py (_scan_kernel / _scan_body, launched
// by _fused_cell_scan), on Hopper's wgmma fed by a TMA ring:
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
//   K1-bf16-decode  bf16 cells under the int8-decode modes K1a-bf16 does
//             not take: mode i8dec (l2 or cos_renorm), i8dec_residual under
//             cos_renorm, and the residual l2 with one query term; one or
//             two terms, any selection (the instances are compiled in
//             ivf_scan_bf16.cu, which includes this file);
//   K1-fold1  any fold variant above with fold depth 1 (one survivor per
//             stride class: 128, not 256), _scan_body's fold_depth=1;
//   K1-exact-i8  the int8-decode prologues (K1a, K1b, K1d-i8dec) with the
//             exact selection, _scan_body's selection="exact" over int8
//             decode cells;
//   wide rows every variant whose query terms do not fit the block whole:
//             the query terms come a stage at a time beside the cells'
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
//         (mma_terms.cuh):
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
// memory once per block of 32 slots (the blocks of a task row are adjacent
// in the grid, so the others read it from L2); f32 rows are 4x the bytes of
// int8 ones, bf16 rows 2x. Beside the products every (slot, lane) costs the
// CUDA cores the conversion of its cells' share and about ten instructions
// of epilogue and selection, which at d 32-128 is as much time as the
// tensor cores' share.
//
// Design: one block per (task row, 32 query slots): a producer warp and two
// consumer warpgroups; the blocks of a task row are adjacent in the grid,
// so they read its segment from L2. The segment's rows go 128 at a time (a
// chunk) and 128 source bytes of a row at a time (a stage: 32 f32, 64 bf16
// or 128 int8 columns) through a ring of 2-4 stages in shared memory: the
// producer issues one TMA load of a [128 rows][64 bytes] box (64-byte
// swizzle) per half stage and, with a chunk's last stage, a bulk copy of
// its 128 norms, onto the stage's full mbarrier (the first stages while the
// consumers still form the query terms); the consumers release a stage on
// its empty mbarrier, one arrival a warp, once they have read it. No block
// barrier runs in the main loop. Consumer warpgroup w takes rows 64 w ..
// 64 w + 63 of each chunk as the A operand of wgmma.mma_async m64n32k16
// (m64n32k32 s8 for sq8), from registers: each thread reads its rows' cells
// from the landed stage (ldmatrix for bf16 and int8, 16-byte loads for f32)
// and converts them there (int8 widened exactly to bf16, f32 split in three
// terms by the masked split, bf16 and sq8 as they are). B is the 32 slots'
// query terms, K-major in the 64-byte swizzle that the descriptor reads:
// formed once by the consumers' prologue and held whole in shared memory
// where the block fits (plan_of), else (kWide) a stage's share at a time
// beside the stage's cells: copied by the producer warp (cp.async, one
// lane a slot) from query_terms_kernel's [nq1][kQT][dk] buffer, formed once
// per launch (the slots are gathered query rows, which one tensor-map box
// cannot land), or for the residual prologue, whose terms depend on the
// segment, formed by the producer warp; qadd is summed once over all
// columns. For f32 and int8-decode cells a thread reads columns 4t ..
// 4t + 3 of each 16 (one 16-byte or 4-byte load a row), so its k positions
// hold the columns in the order 0 1 4 5 8 9 12 13 2 3 6 7 10 11 14 15 and
// the query terms are written in that order too (q_offset). The f32-grade
// products (f32 cells, the f32 query in three terms) and wide rows sum
// each k step into a fresh `part` (the step's first wgmma with scale-d 0),
// the cross terms smallest first, joined to the chunk's sums by one IEEE
// add: a tensor-core sum keeps 24 bits of its largest term (mma_terms.cuh),
// and one accumulator over many steps would gather those chops, all
// leaning one way. The other products chain into `acc`, a group of k steps
// (one load's worth) a commit, and the next group's A fragments are loaded
// and converted while this group's products run. Chunks wholly past the
// row's valid rows are skipped (their lanes are 3e38 and change no
// selection). At 288 threads and two blocks an SM ptxas gives a thread 96
// registers (allocated per quarter SM), and the fold-2 instances spill a
// few dozen bytes.
//   The accumulator map: a consumer thread holds d[4 i + e] at stride class
//   64 w + 16 (warp mod 4) + g + 8 (e / 2) and slot 8 i + 2 t + e % 2 (lane
//   = 4 g + t), the same 16 (slot, class) elements in every chunk.
//   fold:  those elements' (best, runner-up) stay in registers; after the
//          last chunk the survivors go to shared memory and each consumer
//          warp selects for its 4 slots, one at a time: a bitonic sort of
//          the slot's 128 (256) survivors in registers, 4 (8) keys a lane,
//          which gives the kb rounds' result at once (fold_select); each
//          lane stores its own 4 outputs.
//   exact: each slot keeps its kb smallest (value, lane) pairs as a sorted
//          list of 64-bit keys in shared memory (exact_key: the value's
//          order-preserving bits above the lane). A chunk's epilogue writes
//          its [32, 128] distances into a tile, an entrant's value where the
//          lane is valid, not above FLT_MAX and at most its slot's kb-th
//          value, NaN elsewhere. The warp that owns a slot merges the tile
//          row between the commit and the wait of the next chunk's first
//          products (exact_merge), after a barrier of the consumers (every
//          warp has written the tile), and the next chunk's epilogue
//          overwrites the tile after a second (every owner has merged it);
//          the last chunk's tile is merged after the loop. One tile, not
//          one a chunk parity, keeps the instances with three query terms at
//          d 256 at two blocks an SM. A merge rechecks the entrants against
//          the list's kb-th key; none: nothing to do; up to 32 / ceil(kb /
//          32): one a lane, each placed by counting the list's keys and the
//          other entrants below it (n broadcast steps); more: a bitonic sort
//          of the chunk's 128 keys, its minimum against the list read
//          backwards and a half cleaner.
//          So a merge costs what enters the list, never kb rounds. seg is
//          not bounded: a segment is never held whole.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cfloat>
#include <climits>
#include <type_traits>

#include "bitonic.cuh"
#include "hopper.cuh"
#include "mma_terms.cuh"

// The last launch of any K1 entry: blocks an SM (the occupancy calculator),
// dynamic shared memory, whether its rows were wide, its stage's bytes and
// stages; then the launches since the library was loaded with the query
// terms whole and a stage at a time. ivf_scan_bf16.cu compiles more
// instances of the template below (it includes this file with
// ANNSEARCH_IVF_SCAN_TEMPLATE_ONLY, which leaves out this file's instance
// tables and C entries), and its launches write here too.
#ifdef ANNSEARCH_IVF_SCAN_TEMPLATE_ONLY
extern int g_last_launch[7];
#else
int g_last_launch[7];
#endif

namespace {

constexpr int kLanes = 128;    // chunk width: stride classes per query
constexpr int kSlots = 32;     // query slots per block: the products' N
constexpr int kConsumerWarps = 8;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 32;   // two consumer warpgroups, the producer warp
constexpr int kPerWarp = kSlots / kConsumerWarps;   // slots a consumer warp forms and selects
constexpr int kBox = 64;                 // bytes of a cell row per TMA box: the swizzle's row
constexpr int kBoxBytes = kLanes * kBox;            // one box: 128 rows
constexpr int kSnOff = 2 * kBoxBytes;               // a stage: two boxes, then 128 norms
constexpr int kStageHead = 33 * 512;                // ... rounded up to 512 (the swizzle atom)
constexpr int kMaxStages = 4;
constexpr int kQBlock = kSlots * 64;     // 64 bytes of K of each slot's query term
constexpr int kTileStride = kLanes + 4;  // exact: floats of a distance-tile row
constexpr int kTile = kSlots * kTileStride;  // exact: floats of one distance tile
// dynamic shared memory of a block when two share an SM (228 KB, 1 KB
// reserved a block, the static part), and of a block alone
constexpr int kTwoBlocks = 115200;
constexpr int kOneBlock = 231424;
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
// stage is split into the products' k steps
template <typename CellT, int kPro, bool kSplit>
struct Terms {
  static constexpr bool kF32 = std::is_same<CellT, float>::value;
  static constexpr bool kI8Cells = std::is_same<CellT, int8_t>::value;
  static constexpr bool kInt8 = kI8Cells && kPro == kPlain;   // sq8: int8 products
  static constexpr int kXT = kF32 ? 3 : 1;   // cell terms
  static constexpr int kQT = kInt8 ? 1
                             : kPro == kPlain ? 3
                             : (kSplit && kPro != kBf16Query) ? 2 : 1;  // query terms
  static constexpr int kES = kInt8 ? 1 : 2;                  // bytes of a term element
  static constexpr int kKStep = kInt8 ? 32 : 16;             // columns of one product
  static constexpr int kCols = 2 * kBox / (int)sizeof(CellT);   // columns of a stage
  static constexpr int kSteps = kCols / kKStep;              // k steps of a stage
  static constexpr int kQStage = kSteps / 2;                 // query blocks of a stage
  // A holds columns 4t .. 4t + 3 of each 16 in thread t (f32, widened int8)
  static constexpr bool kPerm = kF32 || (kI8Cells && !kInt8);
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

// The byte offset of column c of a slot's query term in the products' B
// layout: K-major, 64 bytes of K a row, the 32 slots' rows of each 64 bytes
// a 2048-byte block in the 64-byte swizzle (hopper.cuh); with kPerm the
// columns of each 16 in A's order (0 1 4 5 8 9 12 13 2 3 6 7 10 11 14 15)
template <int kES, bool kPerm>
__device__ __forceinline__ int q_offset(int slot, int c) {
  int k = c;
  if constexpr (kPerm) {
    const int w = c & 15, e = w & 3;
    k = (c & ~15) | ((e & 2) << 2) | ((w >> 2) << 1) | (e & 1);
  }
  const int byte = k * kES;
  return (byte >> 6) * kQBlock + hopper::sw64(slot, (byte >> 4) & 3) + (byte & 15);
}

// column c of a slot's query as the kQT bf16 terms of v, `term` bytes
// apart, or as an int8 code
template <int kQT, bool kInt8, bool kPerm>
__device__ __forceinline__ void put_query(unsigned char* q, int term, int slot, int c,
                                          float v) {
  const int o = q_offset<kInt8 ? 1 : 2, kPerm>(slot, c);
  if constexpr (kInt8) {
    q[o] = (unsigned char)(int8_t)__float2int_rn(v);
  } else {
    uint16_t t[kQT];
    mma::split<kQT>(v, t);
#pragma unroll
    for (int i = 0; i < kQT; ++i) *reinterpret_cast<uint16_t*>(q + i * term + o) = t[i];
  }
}

// Wide rows whose query terms depend on the query alone (every prologue
// but the residual's): one pass forms each query's terms once, [nq1][kQT]
// rows of dk columns in the products' order of K (q_offset's), so that the
// producer copies a slot's share of a stage as 16-byte units.
template <int kPro, int kEpi, int kQT, bool kInt8, bool kPerm>
__global__ void query_terms_kernel(const float* __restrict__ queries,
                                   const float* __restrict__ scales,
                                   unsigned char* __restrict__ out, int d, int dk) {
  constexpr int kES = kInt8 ? 1 : 2;
  const int qid = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= dk) return;
  float unused = 0.f;
  // K1b-cos's value is the scaled query (its qadd, q . centroid, is summed
  // in the block)
  constexpr int kValue = kPro == kScaledCent ? kScaled : kPro;
  const float v = query_value<kValue, kEpi>(queries + (size_t)qid * d, nullptr, scales, c, d,
                                             unused);
  int k = c;
  if constexpr (kPerm) {
    const int w = c & 15, e = w & 3;
    k = (c & ~15) | ((e & 2) << 2) | ((w >> 2) << 1) | (e & 1);
  }
  unsigned char* row = out + (size_t)qid * kQT * dk * kES;
  if constexpr (kInt8) {
    row[k] = (unsigned char)(int8_t)__float2int_rn(v);
  } else {
    uint16_t t[kQT];
    mma::split<kQT>(v, t);
#pragma unroll
    for (int i = 0; i < kQT; ++i) reinterpret_cast<uint16_t*>(row + (size_t)i * dk * 2)[k] = t[i];
  }
}

// bytes 2h and 2h + 1 of x, int8, as two bf16 values (exact)
__device__ __forceinline__ uint32_t widen2(uint32_t x, int h) {
  const __nv_bfloat162 v = __floats2bfloat162_rn((float)(int8_t)(x >> (16 * h)),
                                                 (float)(int8_t)(x >> (16 * h + 8)));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragments of k step ls of a landed stage for the thread's rows
// row0 + g and row0 + 8 + g (the mma.sync fragment of its warp's 16 rows):
// f32: both rows' 16-byte unit t of box ls (columns 4t .. 4t + 3) split in
// three terms; bf16: one ldmatrix.x4 of the step's 32 bytes; int8: one
// ldmatrix.x4 of 32 bytes (`r4`, kept) serves two k16 steps widened, or one
// k32 step of sq8.
template <typename CellT, bool kInt8, int kXT>
__device__ __forceinline__ void frag(const unsigned char* stage, int row0, int lane, int ls,
                                     uint32_t (&r4)[4], uint32_t (&a)[kXT][4]) {
  if constexpr (std::is_same<CellT, float>::value) {
    const int g = lane >> 2, t = lane & 3;
    const unsigned char* box = stage + ls * kBoxBytes;
    const float4 lo = *reinterpret_cast<const float4*>(box + hopper::sw64(row0 + g, t));
    const float4 hi = *reinterpret_cast<const float4*>(box + hopper::sw64(row0 + g + 8, t));
    uint16_t tl[4][3], th[4][3];
    mma::split<3>(lo.x, tl[0]);
    mma::split<3>(lo.y, tl[1]);
    mma::split<3>(lo.z, tl[2]);
    mma::split<3>(lo.w, tl[3]);
    mma::split<3>(hi.x, th[0]);
    mma::split<3>(hi.y, th[1]);
    mma::split<3>(hi.z, th[2]);
    mma::split<3>(hi.w, th[3]);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      a[i][0] = mma::pack2(tl[0][i], tl[1][i]);
      a[i][1] = mma::pack2(th[0][i], th[1][i]);
      a[i][2] = mma::pack2(tl[2][i], tl[3][i]);
      a[i][3] = mma::pack2(th[2][i], th[3][i]);
    }
  } else {
    // matrices (rows 0-7, the step's first 16 bytes), (rows 8-15, first),
    // (rows 0-7, second), (rows 8-15, second) of the warp's 16 rows
    const int row = row0 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const bool bf16 = std::is_same<CellT, __nv_bfloat16>::value;
    const int j = bf16 || kInt8 ? ls : ls >> 1;   // the 32-byte step
    if (bf16 || kInt8 || (ls & 1) == 0) {
      mma::ldsm_x4(r4, stage + (j >> 1) * kBoxBytes + hopper::sw64(row, 2 * (j & 1) + (lane >> 4)));
    }
    if (bf16 || kInt8) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[0][i] = r4[i];
    } else {   // r4: (row g, columns 4t..4t+3), (row g+8, same), then 16 columns on
      const int h = ls & 1;
      a[0][0] = widen2(r4[2 * h], 0);
      a[0][1] = widen2(r4[2 * h + 1], 0);
      a[0][2] = widen2(r4[2 * h], 1);
      a[0][3] = widen2(r4[2 * h + 1], 1);
    }
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

// -- the scan ------------------------------------------------------------------

// The shared memory of an instance on rows of dp columns: the query terms
// held whole (`q_bytes`, 0 when wide), then the ring of `stages` stages of
// `stage_bytes` (each the cells' two boxes and the chunk's norms, rounded to
// 512, then when wide the stage's query terms), then for the exact
// selection its distance tile, the lists of kb keys and each warp's 32
// compacted entrants (at `exact_off`); a fold's survivors reuse the start
// after the scan. `smem` includes 512 bytes of alignment slack (every
// region starts on a 512-byte swizzle atom).
struct Plan {
  int wide, stages, stage_bytes, q_bytes, exact_off, smem;
};

// The plan of an instance (cells of `cell_bytes`, `qt` query terms, int8
// products for sq8, selection `sel`) on rows of dp columns: the query terms
// held whole with as many stages (4 down to 2) as keep two blocks an SM,
// else at one block an SM; else the same with the query terms a stage at a
// time (wide). ops/ivf_scan_fused.py::scan_plan mirrors it.
Plan plan_of(int cell_bytes, int qt, bool int8, int sel, int dp, int kb) {
  const int cols = 2 * kBox / cell_bytes;          // Terms::kCols
  const int es = int8 ? 1 : 2;                     // Terms::kES
  const int qstage = cols / (int8 ? 32 : 16) / 2;  // Terms::kQStage
  const int dk = (dp + cols - 1) / cols * cols;
  const int surv = sel == kExactSel ? 0 : kSlots * sel * kLanes * 8;
  const int exact = sel == kExactSel
                        ? kTile * 4 + kSlots * kb * 8 + kConsumerWarps * 32 * 8
                        : 0;
  const int caps[2] = {kTwoBlocks, kOneBlock};
  for (int wide = 0; wide < 2; ++wide) {
    const int q_bytes = wide ? 0 : qt * (dk * es / 64) * kQBlock;
    const int stage = kStageHead + (wide ? qt * qstage * kQBlock : 0);
    for (int cap : caps) {
      for (int stages = kMaxStages; stages >= 2; --stages) {
        const int scan = q_bytes + stages * stage;
        const int exact_off = scan > surv ? scan : surv;
        const int smem = 512 + exact_off + exact;
        if (smem <= cap) return Plan{wide, stages, stage, q_bytes, exact_off, smem};
      }
    }
  }
  return Plan{0, 0, 0, 0, 0, 0};
}

template <typename CellT, int kPro, int kEpi, int kSel, bool kSplit, bool kWide>
__global__ void __launch_bounds__(kThreads, 2)
ivf_scan_kernel(const __grid_constant__ CUtensorMap cmap,   // cells [nblk * seg, dp]
                const int* __restrict__ lists,
                const int* __restrict__ task_seg,
                const int* __restrict__ cnt,
                const float* __restrict__ queries,
                const float* __restrict__ cents,   // kResidual, kScaledCent
                const float* __restrict__ scales,  // the int8-decode variants
                const float* __restrict__ sn,
                const unsigned char* __restrict__ qterms,   // wide: query_terms_kernel's
                float* __restrict__ out_d, int* __restrict__ out_i,
                int maxq, int seg, int d, int dk, int kb, int nyb,
                int stages, int stage_bytes, int q_bytes, int exact_off) {
  using TT = Terms<CellT, kPro, kSplit>;
  constexpr int kQT = TT::kQT, kXT = TT::kXT;
  constexpr bool kInt8 = TT::kInt8;
  constexpr bool kExact = kSel == kExactSel;
  constexpr int kDepth = kExact ? 1 : kSel;
  // wide rows: the producer copies each stage's query terms from the
  // pre-pass, or (the residual prologue) forms them
  constexpr bool kCopied = kWide && kPro != kResidual;
  using Acc = typename std::conditional<kInt8, int, float>::type;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[kMaxStages], empty[kMaxStages];
  __shared__ __align__(16) float qadd_s[kSlots];
  __shared__ int qid_s[kSlots];   // a slot's query row, -1 past maxq

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int r = blockIdx.x / nyb;
  const int j0 = (blockIdx.x - r * nyb) * kSlots;
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

  unsigned char* smem = smem_raw + ((512 - (hopper::smem_addr(smem_raw) & 511)) & 511);
  unsigned char* q_s = smem;                      // the query terms held whole
  unsigned char* ring = smem + q_bytes;
  float* tile_s = reinterpret_cast<float*>(smem + exact_off);
  uint64_t* list_s = reinterpret_cast<uint64_t*>(tile_s + kTile);
  uint64_t* ecomp_s = list_s + kSlots * kb + warp * 32;
  // one term's bytes: whole, or a stage's columns
  const int q_term = kWide ? TT::kQStage * kQBlock : dk * TT::kES / 64 * kQBlock;
  const float* cent = nullptr;
  if constexpr (kPro == kResidual || kPro == kScaledCent) cent = cents + (size_t)s * d;
  const int nchunks = (n_valid + kLanes - 1) / kLanes;   // chunks past the valid rows: skipped
  const int ncb = dk / TT::kCols;
  const int nsteps = nchunks * ncb;

  // the producer's lane 0: the cells (and a chunk's norms with its last
  // column block) of step t = (chunk t / ncb, column block t mod ncb) into
  // stage st
  auto load_stage = [&](int t, int st) {
    const int ch = t / ncb, cb = t - ch * ncb;
    unsigned char* stage = ring + st * stage_bytes;
    const bool last = cb == ncb - 1;
    const int row = s * seg + ch * kLanes;
    hopper::bar_expect(&full[st], 2 * kBoxBytes + (last ? kLanes * 4 : 0));
    hopper::tma_load(stage, &cmap, &full[st], cb * TT::kCols, row);
    hopper::tma_load(stage + kBoxBytes, &cmap, &full[st], cb * TT::kCols + TT::kCols / 2, row);
    if (last) {
      hopper::bulk_load(stage + kSnOff, sn + (size_t)s * seg + ch * kLanes, kLanes * 4,
                        &full[st]);
    }
  };
  // the producer sets the barriers up and, where the query terms are held
  // whole, starts the ring's first stages while the consumers form them
  int preloaded = 0;
  if (warp == kConsumerWarps && lane == 0) {
    for (int i = 0; i < stages; ++i) {
      // the TMA's arrival; wide rows: and the query terms' (the copying
      // lanes' 32 or the forming warp's one)
      hopper::bar_init(&full[i], 1 + (kCopied ? 32 : kWide ? 1 : 0));
      hopper::bar_init(&empty[i], kConsumerWarps);
    }
    hopper::bar_init_fence();
    if constexpr (!kWide) {
      for (; preloaded < stages && preloaded < nsteps; ++preloaded) {
        load_stage(preloaded, preloaded);
      }
    }
  }
  if (warp < kConsumerWarps) {
    // prologue: each consumer warp forms the query terms and qadd of its 4
    // slots, the 4 side by side column by column so that their loads overlap
    int qid[kPerWarp];
    float qadd[kPerWarp];
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
      const int j = j0 + warp * kPerWarp + i;
      qid[i] = j < maxq ? lists[(size_t)r * maxq + j] : -1;   // warp-uniform
      qadd[i] = 0.f;
    }
    for (int c = lane; c < (kWide ? d : dk); c += 32) {
#pragma unroll
      for (int i = 0; i < kPerWarp; ++i) {
        const float v = qid[i] >= 0 ? query_value<kPro, kEpi>(queries + (size_t)qid[i] * d,
                                                              cent, scales, c, d, qadd[i])
                                    : 0.f;
        if constexpr (!kWide) {
          put_query<kQT, kInt8, TT::kPerm>(q_s, q_term, warp * kPerWarp + i, c, v);
        }
      }
    }
    hopper::fence_proxy_async();   // the terms are read by wgmma
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
    if constexpr (kExact) {
      for (int i = tid; i < kSlots * kb; i += kConsumers) list_s[i] = kEmptyKey;
    }
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // the producer: step t into stage t mod stages once the consumers have
    // released it (the held-whole rows: lane 0 alone, past the preloaded)
    if (!kWide && lane != 0) return;
    int st = preloaded % stages, ph = preloaded >= stages ? 0 : 1;
    for (int t = preloaded; t < nsteps; ++t) {
      const int cb = t - t / ncb * ncb;
      unsigned char* stage = ring + st * stage_bytes;
      hopper::bar_wait(&empty[st], ph);
      if (lane == 0) load_stage(t, st);
      if constexpr (kCopied) {
        // lane j copies slot j's share of the stage, 16 bytes at a time,
        // into the swizzled B layout; the copies arrive on the stage's full
        // barrier when they have landed
        constexpr int kUnits = TT::kCols * TT::kES / 16;
        const int qid = qid_s[lane];
        const unsigned char* src = qterms + (size_t)(qid < 0 ? 0 : qid) * kQT * dk * TT::kES +
                                   cb * TT::kCols * TT::kES;
        unsigned char* qst = stage + kStageHead;
#pragma unroll
        for (int i = 0; i < kQT; ++i) {
#pragma unroll
          for (int u = 0; u < kUnits; ++u) {
            mma::cp_async16(qst + i * q_term + (u >> 2) * kQBlock + hopper::sw64(lane, u & 3),
                            src + (size_t)i * dk * TT::kES + 16 * u, 16);
          }
        }
        hopper::cp_async_arrive(&full[st]);
      } else if constexpr (kWide) {
        // the residual prologue: the stage's query columns of every slot,
        // lane by lane along them
        unsigned char* qst = stage + kStageHead;
        for (int slot = 0; slot < kSlots; ++slot) {
          const int qid = qid_s[slot];
          const float* qrow = queries + (size_t)(qid < 0 ? 0 : qid) * d;
#pragma unroll
          for (int m = 0; m < TT::kCols / 32; ++m) {
            const int lc = lane + 32 * m;
            float unused = 0.f;
            const float v = qid >= 0 ? query_value<kPro, kEpi>(qrow, cent, scales,
                                                               cb * TT::kCols + lc, d, unused)
                                     : 0.f;
            put_query<kQT, kInt8, TT::kPerm>(qst, q_term, slot, lc, v);
          }
        }
        hopper::fence_proxy_async();
        __syncwarp();
        if (lane == 0) hopper::bar_arrive(&full[st]);
      }
      if (++st == stages) { st = 0; ph ^= 1; }
    }
    return;
  }

  // the consumers
  const int wg = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = 64 * wg + 16 * (warp & 3);   // the warp's 16 rows of a chunk
  const int c0 = row0 + g;                      // the thread's classes: c0, c0 + 8
  // exact: this warp's 4 slots merge chunk c's tile
  auto merge_chunk = [&](int c) {
    for (int i = 0; i < kPerWarp; ++i) {
      const int slot = warp * kPerWarp + i;
      if (qid_s[slot] < 0) continue;   // warp-uniform
      exact_merge(tile_s + slot * kTileStride, c * kLanes,
                  list_s + slot * kb, kb, ecomp_s, lane);
    }
  };

  // fold state of the thread's 16 elements, element e of n-tile i at 4 i +
  // e: slot 8 i + 2 t4 + e % 2, stride class c0 + 8 (e / 2). A survivor's
  // lane is chunk * 128 + its class, so one register holds both survivors'
  // chunks: the best's in the low 16 bits, the runner-up's in the high 16
  // (kNoChunk: the runner-up's initial lane 0); the C entries refuse
  // segments of 65,535 chunks or more
  float v1[16], v2[16];
  uint32_t ic[16];
  Acc acc[16];
  // f32-grade products (f32 cells, the f32 query in three terms) and wide
  // rows: each k step's products sum into a fresh `part`, smallest cross
  // terms first, which joins `acc` by one IEEE add
  constexpr bool kStepSums = !kInt8 && (kXT == 3 || kQT == 3 || kWide);
  Acc part[16];
  Acc(&sum)[16] = kStepSums ? part : acc;

  for (int ch = 0, st = 0, ph = 0; ch < nchunks; ++ch) {
    float sn0 = 0.f, sn1 = 0.f;
    for (int cb = 0; cb < ncb; ++cb) {
      const unsigned char* stage = ring + st * stage_bytes;
      hopper::bar_wait(&full[st], ph);
      // the copied query terms were written through the generic proxy
      if constexpr (kCopied) hopper::fence_proxy_async();
      if (cb == ncb - 1) {
        const float* sns = reinterpret_cast<const float*>(stage + kSnOff);
        sn0 = sns[c0];
        sn1 = sns[c0 + 8];
      }
      // this stage's query blocks: whole terms at column block cb, or the
      // stage's own
      const unsigned char* qb = kWide ? stage + kStageHead : q_s + cb * TT::kQStage * kQBlock;
      // the stage's k steps in groups of one load each (an int8 ldmatrix
      // serves two widened k16 steps), the next group's fragments loaded
      // and converted while this group's products run; f32-grade and wide
      // sums wait for each step's `part`, the others chain their products
      // into `acc` and wait for the group before last
      constexpr int kPerGroup = TT::kI8Cells && !kInt8 && !kStepSums ? 2 : 1;
      constexpr int kGroups = TT::kSteps / kPerGroup;
      uint32_t r4[4];
      uint32_t a[2][kPerGroup][kXT][4];
      auto load_group = [&](int gi, uint32_t (&ag)[kPerGroup][kXT][4]) {
#pragma unroll
        for (int j = 0; j < kPerGroup; ++j) {
          frag<CellT, kInt8, kXT>(stage, row0, lane, gi * kPerGroup + j, r4, ag[j]);
        }
      };
      load_group(0, a[0]);
#pragma unroll
      for (int gi = 0; gi < kGroups; ++gi) {
        hopper::wgmma_fence();
#pragma unroll
        for (int j = 0; j < kPerGroup; ++j) {
          const int ls = gi * kPerGroup + j;
          const unsigned char* qs = qb + (ls >> 1) * kQBlock;
          bool first = true;
          // cell terms from the smallest; within one, query terms likewise
#pragma unroll
          for (int b = kXT - 1; b >= 0; --b) {
#pragma unroll
            for (int p = mma::cross_count(kQT, kXT) - 1; p >= 0; --p) {
              if (mma::cross_b(kXT, p) != b) continue;
              const uint64_t desc = hopper::desc_sw64(qs + mma::cross_a(kXT, p) * q_term) +
                                    2 * (ls & 1);   // 32 bytes on
              const int keep = first ? (kStepSums ? 0 : (cb | ls)) : 1;
              if constexpr (kInt8) {
                hopper::wgmma_m64n32k32_s8(sum, a[gi & 1][j][b], desc, keep);
              } else {
                hopper::wgmma_m64n32k16(sum, a[gi & 1][j][b], desc, keep);
              }
              first = false;
            }
          }
        }
        hopper::wgmma_commit();
        if constexpr (kExact) {
          // every warp has written the previous chunk's tile: merge it
          // beside the products
          if (cb == 0 && gi == 0 && ch > 0) {
            hopper::named_sync(1, kConsumers);
            merge_chunk(ch - 1);
          }
        }
        if (gi + 1 < kGroups) {
          if constexpr (!kStepSums) hopper::wgmma_wait<1>();   // the group before is done
          load_group(gi + 1, a[(gi + 1) & 1]);
          if (!kWide && gi + 2 == kGroups) {   // read: release the stage
            __syncwarp();
            if (lane == 0) hopper::bar_arrive(&empty[st]);
          }
        }
        if constexpr (kStepSums) {
          hopper::wgmma_wait<0>();
          hopper::fence_operands(part);
#pragma unroll
          for (int e = 0; e < 16; ++e) acc[e] = (cb | gi) ? __fadd_rn(acc[e], part[e]) : part[e];
        }
      }
      if constexpr (!kStepSums) {
        hopper::wgmma_wait<0>();
        hopper::fence_operands(acc);
      }
      if (kWide) {   // the products have read the stage's query terms
        __syncwarp();
        if (lane == 0) hopper::bar_arrive(&empty[st]);
      }
      if (++st == stages) { st = 0; ph ^= 1; }
    }

    // epilogue of chunk ch on the accumulator map
    float dist[16];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 qa = *reinterpret_cast<const float2*>(qadd_s + 8 * i + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int l = ch * kLanes + c0 + 8 * (e >> 1);
        const float snl = (e >> 1) ? sn1 : sn0;
        const float qadd = (e & 1) ? qa.y : qa.x;
        const float dot = (float)acc[4 * i + e];
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
        dist[4 * i + e] = l >= n_valid ? kBig : dv;
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
      // the chunk's tile, once every owner has merged the previous one: an
      // entrant's value where the lane is valid, the value at most FLT_MAX
      // (no inf, no NaN) and its key's value bits at most those of the
      // slot's kb-th key
      if (ch > 0) hopper::named_sync(1, kConsumers);
      float* tile = tile_s;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int slot = 8 * i + 2 * t4 + e1;
          const uint32_t thr =
              reinterpret_cast<const volatile uint32_t*>(list_s + slot * kb + kb - 1)[1];
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int cls = c0 + 8 * e2;
            const int l = ch * kLanes + cls;
            const float dv = dist[4 * i + 2 * e2 + e1];
            const bool in = l < n_valid && dv <= FLT_MAX &&
                            (uint32_t)(exact_key(dv, l) >> 32) <= thr;
            tile[slot * kTileStride + cls] = in ? dv : __int_as_float(0x7fffffff);
          }
        }
      }
    }
  }

  if constexpr (kExact) {
    hopper::named_sync(1, kConsumers);   // the last chunk's tile is written
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
    // then each consumer warp selects for its 4 slots (fold_select)
    constexpr int kSurv = kDepth * kLanes;
    float* sv_s = reinterpret_cast<float*>(smem);
    int* si_s = reinterpret_cast<int*>(sv_s + kSlots * kSurv);
    hopper::named_sync(1, kConsumers);   // every consumer is done with the ring
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int slot = 8 * (k >> 2) + 2 * t4 + (k & 1);
      const int cls = c0 + 8 * ((k & 3) >> 1);
      sv_s[slot * kSurv + cls] = v1[k];
      si_s[slot * kSurv + cls] = (int)(ic[k] & 0xFFFFu) * kLanes + cls;
      if constexpr (kSel == kFold2) {
        const uint32_t c2 = ic[k] >> 16;
        sv_s[slot * kSurv + kLanes + cls] = v2[k];
        si_s[slot * kSurv + kLanes + cls] = c2 == kNoChunk ? 0 : (int)c2 * kLanes + cls;
      }
    }
    hopper::named_sync(1, kConsumers);
    for (int i = 0; i < kPerWarp; ++i) {
      const int slot = warp * kPerWarp + i;
      if (qid_s[slot] < 0) continue;   // warp-uniform
      const size_t ob = ((size_t)r * maxq + j0 + slot) * kb;
      fold_select<kDepth>(sv_s + slot * kSurv, si_s + slot * kSurv, lane, kb, out_d + ob,
                          out_i + ob);
    }
  }
}

template <typename CellT>
constexpr CUtensorMapDataType cell_type() {
  return std::is_same<CellT, float>::value            ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
         : std::is_same<CellT, __nv_bfloat16>::value ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                      : CU_TENSOR_MAP_DATA_TYPE_UINT8;
}

template <typename CellT, int kPro, int kEpi, int kSel, bool kSplit, bool kWide>
int launch_impl(const Plan& p, const CUtensorMap& cmap, const void* lists,
                const void* task_seg, const void* cnt, const void* queries, const void* cents,
                const void* scales, const void* sn, void* out_d, void* out_i, int R, int maxq,
                int seg, int d, int dp, int kb, void* stream, int nq1, void* scratch,
                size_t scratch_bytes) {
  using TT = Terms<CellT, kPro, kSplit>;
  auto kern = ivf_scan_kernel<CellT, kPro, kEpi, kSel, kSplit, kWide>;
  const int dk = (dp + TT::kCols - 1) / TT::kCols * TT::kCols;
  if (kWide && kPro != kResidual) {   // the pre-pass: every query's terms once
    if (scratch == nullptr || scratch_bytes < (size_t)nq1 * TT::kQT * dk * TT::kES) {
      return (int)cudaErrorInvalidValue;
    }
    query_terms_kernel<kPro, kEpi, TT::kQT, TT::kInt8, TT::kPerm>
        <<<dim3((dk + 255) / 256, nq1), 256, 0, (cudaStream_t)stream>>>(
            (const float*)queries, (const float*)scales, (unsigned char*)scratch, d, dk);
    const cudaError_t perr = cudaGetLastError();
    if (perr != cudaSuccess) return (int)perr;
  }
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  static int seen = 0;   // the occupancy of this instance at `seen` bytes
  static int blocks = 0;
  if (p.smem != seen) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, kThreads, p.smem);
    if (err != cudaSuccess) return (int)err;
    seen = p.smem;
  }
  g_last_launch[0] = blocks;
  g_last_launch[1] = p.smem;
  g_last_launch[2] = kWide;
  g_last_launch[3] = p.stage_bytes;
  g_last_launch[4] = p.stages;
  ++g_last_launch[kWide ? 6 : 5];
  const int nyb = (maxq + kSlots - 1) / kSlots;
  kern<<<(unsigned)R * nyb, kThreads, p.smem, (cudaStream_t)stream>>>(
      cmap, (const int*)lists, (const int*)task_seg, (const int*)cnt, (const float*)queries,
      (const float*)cents, (const float*)scales, (const float*)sn,
      (const unsigned char*)scratch, (float*)out_d, (int*)out_i, maxq, seg, d, dk, kb, nyb,
      p.stages, p.stage_bytes, p.q_bytes, p.exact_off);
  return (int)cudaGetLastError();
}

// one variant at any width: the tensor map of the cells ([nblk * seg, dp],
// boxes of 128 rows x 64 bytes, 64-byte swizzle), the plan, and the
// instance with the query terms whole or a stage at a time
template <typename CellT, int kPro, int kEpi, int kSel, bool kSplit = false>
int launch(const void* lists, const void* task_seg, const void* cnt,
           const void* queries, const void* cents, const void* scales,
           const void* cells, const void* sn, void* out_d, void* out_i,
           int R, int maxq, int seg, int d, int dp, int kb, void* stream, int nblk, int nq1,
           void* scratch, size_t scratch_bytes) {
  if (R <= 0 || maxq <= 0) return 0;
  using TT = Terms<CellT, kPro, kSplit>;
  const Plan p = plan_of((int)sizeof(CellT), TT::kQT, TT::kInt8, kSel, dp, kb);
  if (p.stages == 0) return (int)cudaErrorInvalidValue;
  CUtensorMap cmap;
  const cuuint64_t dims[2] = {(cuuint64_t)dp, (cuuint64_t)nblk * seg};
  const cuuint64_t strides[1] = {(cuuint64_t)dp * sizeof(CellT)};
  const cuuint32_t box[2] = {(cuuint32_t)(kBox / sizeof(CellT)), (cuuint32_t)kLanes};
  if (!hopper::make_map(&cmap, cell_type<CellT>(), 2, cells, dims, strides, box,
                        CU_TENSOR_MAP_SWIZZLE_64B)) {
    return (int)cudaErrorInvalidValue;
  }
  auto run = p.wide ? &launch_impl<CellT, kPro, kEpi, kSel, kSplit, true>
                    : &launch_impl<CellT, kPro, kEpi, kSel, kSplit, false>;
  return run(p, cmap, lists, task_seg, cnt, queries, cents, scales, sn, out_d, out_i, R, maxq,
             seg, d, dp, kb, stream, nq1, scratch, scratch_bytes);
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

#ifndef ANNSEARCH_IVF_SCAN_TEMPLATE_ONLY
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
// takes fused_ivf_scan's q_split=True; one term and the other int8-decode
// prologues and epilogues over bf16 cells: ivf_scan_bf16.cu): [sel]. A bf16
// stage holds 64 columns, so d 128 and 256 take two and four stages a chunk
const Launch* const kResidualBf16 = kBySel<__nv_bfloat16, kResidual, kL2, true>;
// K1d-i8dec: int8 decode cells, l2 or cos_renorm: [cosine][split][sel]
const Launch* const kI8dec[2][2] = {
    {kBySel<int8_t, kScaled, kL2, false>, kBySel<int8_t, kScaled, kL2, true>},
    {kBySel<int8_t, kScaled, kCosRenorm, false>, kBySel<int8_t, kScaled, kCosRenorm, true>},
};
#endif

// `sel` is 0, 1 or 2; a fold's segment holds fewer than kNoChunk chunks
int bad_sel(int sel, int seg) {
  return sel < 0 || sel > 2 || (sel > 0 && seg / kLanes >= (int)kNoChunk)
             ? (int)cudaErrorInvalidValue
             : 0;
}

}  // namespace

#ifndef ANNSEARCH_IVF_SCAN_TEMPLATE_ONLY
// Launches on `stream`; each returns the launch's cudaError_t (0 on
// success). The caller validates shapes, types, contiguity and alignment.
// `sel` is the selection: 0 exact, 1 or 2 the fold at that depth; `nblk`
// the blocks of `cells` ([nblk, seg, dp]: the tensor map's extent), `nq1`
// the rows of `queries`; `scratch` (`scratch_bytes`) holds the query terms
// of wide rows (ops/ivf_scan_fused.py::_query_scratch; unused otherwise).

// The last launch of any entry below: (blocks an SM, dynamic shared memory
// in bytes, 1 if its rows were wide, a stage's bytes, stages) into
// out[0..4], and the launches of every entry since the library was loaded
// with the query terms whole (out[5]) and a stage at a time (out[6])
extern "C" int annsearch_ivf_scan_last_launch(int* out) {
  for (int i = 0; i < 7; ++i) out[i] = g_last_launch[i];
  return 0;
}

// The plan of a launch (cells of `cell_bytes` bytes, `query_terms` query
// terms, int8 products for sq8, selection `sel`, rows of dp columns, kb):
// out[0..3] = wide (the query terms a stage at a time), stages, bytes a
// stage, dynamic shared memory. Returns 0.
extern "C" int annsearch_ivf_scan_plan(int cell_bytes, int query_terms, int int8, int sel,
                                       int dp, int kb, int* out) {
  const Plan p = plan_of(cell_bytes, query_terms, int8 != 0, sel, dp, kb);
  out[0] = p.wide;
  out[1] = p.stages;
  out[2] = p.stage_bytes;
  out[3] = p.smem;
  return 0;
}

// K1a: int8 residual cells, l2, one bf16 query term (sel 0: K1-exact-i8)
extern "C" int annsearch_ivf_scan_k1a(
    const void* lists, const void* task_seg, const void* cnt,
    const void* queries, const void* cents, const void* scales,
    const void* cells, const void* sn, void* out_d, void* out_i,
    int R, int maxq, int seg, int d, int dp, int kb, int sel, void* stream, int nblk, int nq1, void* scratch,
    size_t scratch_bytes) {
  if (bad_sel(sel, seg)) return bad_sel(sel, seg);
  return kResidualL2[0][sel](
      lists, task_seg, cnt, queries, cents, scales, cells, sn, out_d, out_i,
      R, maxq, seg, d, dp, kb, stream, nblk, nq1, scratch, scratch_bytes);
}

// K1b-l2: int8 residual cells, l2, two bf16 query terms
extern "C" int annsearch_ivf_scan_k1b_l2(
    const void* lists, const void* task_seg, const void* cnt,
    const void* queries, const void* cents, const void* scales,
    const void* cells, const void* sn, void* out_d, void* out_i,
    int R, int maxq, int seg, int d, int dp, int kb, int sel, void* stream, int nblk, int nq1, void* scratch,
    size_t scratch_bytes) {
  if (bad_sel(sel, seg)) return bad_sel(sel, seg);
  return kResidualL2[1][sel](
      lists, task_seg, cnt, queries, cents, scales, cells, sn, out_d, out_i,
      R, maxq, seg, d, dp, kb, stream, nblk, nq1, scratch, scratch_bytes);
}

// K1b-cos: int8 residual cells, cos_renorm, one or two query terms
extern "C" int annsearch_ivf_scan_k1b_cos(
    const void* lists, const void* task_seg, const void* cnt,
    const void* queries, const void* cents, const void* scales,
    const void* cells, const void* sn, void* out_d, void* out_i,
    int R, int maxq, int seg, int d, int dp, int kb, int split, int sel, void* stream, int nblk, int nq1, void* scratch,
    size_t scratch_bytes) {
  if (bad_sel(sel, seg)) return bad_sel(sel, seg);
  return kResidualCos[split != 0][sel](
      lists, task_seg, cnt, queries, cents, scales, cells, sn, out_d, out_i,
      R, maxq, seg, d, dp, kb, stream, nblk, nq1, scratch, scratch_bytes);
}

// K1a-bf16: bf16 residual cells, l2, two bf16 query terms (RaBitQ's
// estimator rows)
extern "C" int annsearch_ivf_scan_k1a_bf16(
    const void* lists, const void* task_seg, const void* cnt,
    const void* queries, const void* cents, const void* scales,
    const void* cells, const void* sn, void* out_d, void* out_i,
    int R, int maxq, int seg, int d, int dp, int kb, int sel, void* stream, int nblk, int nq1, void* scratch,
    size_t scratch_bytes) {
  if (bad_sel(sel, seg)) return bad_sel(sel, seg);
  return kResidualBf16[sel](
      lists, task_seg, cnt, queries, cents, scales, cells, sn, out_d, out_i,
      R, maxq, seg, d, dp, kb, stream, nblk, nq1, scratch, scratch_bytes);
}

// K1d-i8dec: int8 decode cells (no centroids), l2 or cos_renorm, one or two
// query terms
extern "C" int annsearch_ivf_scan_i8dec(
    const void* lists, const void* task_seg, const void* cnt,
    const void* queries, const void* scales, const void* cells,
    const void* sn, void* out_d, void* out_i, int R, int maxq, int seg, int d,
    int dp, int kb, int cosine, int split, int sel, void* stream, int nblk, int nq1,
    void* scratch, size_t scratch_bytes) {
  if (bad_sel(sel, seg)) return bad_sel(sel, seg);
  return kI8dec[cosine != 0][split != 0][sel](
      lists, task_seg, cnt, queries, nullptr, scales, cells, sn, out_d, out_i,
      R, maxq, seg, d, dp, kb, stream, nblk, nq1, scratch, scratch_bytes);
}

// K1c-f32 / K1d-f32: f32 cells (f32 queries)
extern "C" int annsearch_ivf_scan_f32(
    const void* lists, const void* task_seg, const void* cnt,
    const void* queries, const void* cells, const void* sn, void* out_d,
    void* out_i, int R, int maxq, int seg, int d, int dp, int kb, int cosine,
    int sel, void* stream, int nblk, int nq1, void* scratch,
    size_t scratch_bytes) {
  if (bad_sel(sel, seg)) return bad_sel(sel, seg);
  return kF32[cosine != 0][sel](lists, task_seg, cnt, queries, nullptr, nullptr, cells,
                                sn, out_d, out_i, R, maxq, seg, d, dp, kb, stream, nblk, nq1, scratch, scratch_bytes);
}

// K1c-bf16 / K1d-bf16: bf16 cells (f32 queries)
extern "C" int annsearch_ivf_scan_bf16(
    const void* lists, const void* task_seg, const void* cnt,
    const void* queries, const void* cells, const void* sn, void* out_d,
    void* out_i, int R, int maxq, int seg, int d, int dp, int kb, int cosine,
    int sel, void* stream, int nblk, int nq1, void* scratch,
    size_t scratch_bytes) {
  if (bad_sel(sel, seg)) return bad_sel(sel, seg);
  return kBf16[cosine != 0][sel](lists, task_seg, cnt, queries, nullptr, nullptr, cells,
                                 sn, out_d, out_i, R, maxq, seg, d, dp, kb, stream, nblk, nq1, scratch, scratch_bytes);
}

// K1c-sq8 / K1d-sq8: int8 cells (f32 queries holding int8 codes)
extern "C" int annsearch_ivf_scan_sq8(
    const void* lists, const void* task_seg, const void* cnt,
    const void* queries, const void* cells, const void* sn, void* out_d,
    void* out_i, int R, int maxq, int seg, int d, int dp, int kb, int cosine,
    int sel, void* stream, int nblk, int nq1, void* scratch,
    size_t scratch_bytes) {
  if (bad_sel(sel, seg)) return bad_sel(sel, seg);
  return kSq8[cosine != 0][sel](lists, task_seg, cnt, queries, nullptr, nullptr, cells,
                                sn, out_d, out_i, R, maxq, seg, d, dp, kb, stream, nblk, nq1, scratch, scratch_bytes);
}
#endif  // ANNSEARCH_IVF_SCAN_TEMPLATE_ONLY
