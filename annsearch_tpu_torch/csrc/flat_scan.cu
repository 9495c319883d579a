// K2, the fused flat top-k: the Pallas kernel
// annsearch_tpu/ops/flat_scan_pallas.py (_flat_kernel, launched by
// flat_topk_fused) as two hand-written kernels for Hopper, a scan on
// wgmma fed by TMA and an extraction by a sort network.
//
// What it computes, for query i < nq over the rows x[0 .. n):
//   dot    = sum over the pairs (a, b) of _CROSS[T] of q_a[i] . x_b[col]
//            (q_a, x_b the bf16 terms of the mantissa split, T = 1, 2 or
//            3 terms for passes 1, 3 and 6; see mma_terms.cuh), all pairs
//            and all columns into one f32 accumulator
//   score  = sn[col] - 2 dot, rounded once   (sn = |x|^2, 0 under cosine,
//            3e38 at and past n_valid: the wrapper pads sn to whole tiles)
//   class  = col mod B keeps its best (depth 1) or best two (depth 2)
//            (score, col) over the db tiles j = col / B in order, updated
//            with a strict <: b1 = score < m1; the loser of that comparison
//            goes against m2 with a strict < again. Bins start at (3e38, 0).
//   then kb rounds of the lexicographic minimum (value, col) over the
//   depth * B bins; each round writes (value + qadd[i], col) and sets the
//   value of every bin equal to the winner in value and col to 3e38.
// A row past n_valid never enters a bin: 3e38 - 2 dot rounds to 3e38,
// which is not < 3e38.
//
// Grade. These are the Pallas body's passes: the same split, the same
// cross terms. The terms are formed once per call by the wrapper (tensor
// code, as the JAX package's _prep_parts), bf16 [T, rows, dk] with dk = d
// rounded up to 32 and zero columns.
//
// Bound on the H100: the cross terms' passes (1, 3 or 6) x nq * n * d
// multiply-adds at the bf16 tensor-core peak (6 x 5.2e11 for 16,384
// queries x 1M x 32d: 6.4 ms); q, x and the outputs are a few hundred MB,
// the bins between the two kernels 0.5 GB a slab. At d 32 the products are
// short (K = 32 a tile) and each output costs as much on the CUDA cores as
// on the tensor cores: the bins update is about ten instructions per
// (query, class) per tile against 6 x 32 multiply-adds. The design keeps
// the two side by side, and spends as few instructions as it can on the
// rest (barriers, copies, indexing).
//
// Scan design (flat_scan_kernel). A block owns 128 queries (two consumer
// warpgroups of 64) and a slice of 32 classes: of every db tile j it reads
// the 32 contiguous rows j*B + s0 .. j*B + s0 + 31. A producer (one thread
// of a third warpgroup, whose registers setmaxnreg lowers to 40 so that the
// consumers can take 232) issues TMA loads of those rows, one box a term of
// 32 rows x 32 columns, 64-byte swizzled, and of their 32 norms, into a
// ring of stages of an even number of tiles, with a full and an empty
// mbarrier each: no block barrier in the main loop. Rows past n come back
// as zeros (TMA's out-of-bounds fill). The query terms come once, by TMA,
// into shared memory; at d 32 each consumer thread keeps its fragments of
// them in registers for the whole scan, wider rows take them by ldmatrix
// per 32-column chunk. One wgmma.mma_async m64n64k16 (A from registers, B
// the stage) covers a pair of tiles, the 32 rows of tile j and then those
// of tile j + 1, which a stage holds adjacent for each term: the products
// a warpgroup issues per tile are half what m64n32 would take, and at these
// shapes a wgmma's cost goes with its count more than with its width. Each
// 32-column chunk of a pair is two k16 steps, each summed into a fresh
// `part` (the first product with scale-d 0), the smallest cross terms
// first, the two steps' chains interleaved, and joined to the pair's sums
// by IEEE adds (see mma_terms.cuh: a tensor-core sum keeps 24 bits of its
// largest term, so one long accumulation would gather chops that all lean
// one way). The consumers issue the next chunk's products before they run
// this pair's bins update (selects, no branches, so a thread's 32 updates
// run side by side), so the update overlaps the tensor cores; the issue in
// the loop is unconditional, or ptxas waits for the products on the spot.
// By the wgmma accumulator map a thread holds the same 16 (query, class)
// pairs of both tiles in fixed registers, and keeps their bins in
// registers over the whole database: every pair is followed by one thread
// through the tiles in order, so the bins are those of the sequential scan
// entry for entry, exact score ties included. The bins of a slab of
// queries go to device memory once ([queries, depth*B] values and
// columns). Blocks of one class slice are adjacent in the grid, so the
// blocks in flight read the same slice of x from L2. A launch covers fewer
// than 65,535 tiles (a bin's tile is kept below 0xFFFF); the C entry scans
// longer databases in runs of tiles and merges each run's bins into the
// earlier runs' (flat_merge_kernel). Rows so wide that the query terms and
// two stages of two tiles do not fit shared memory (d > 128 at three terms,
// d > 192 at two, d > 416 at one) take flat_scan_wide_kernel, the same scan
// K outer: each stage brings a 32-column chunk of the queries' terms beside
// the same chunk of four tiles, whose sums stay in registers across the
// chunks (m64n128k16 products); chosen by shape alone
// (annsearch_flat_scan_plan). No K2 scan holds an mma.sync.
//
// Extraction (flat_extract_kernel), one block per query: the kb rounds
// computed at once. Each warp sorts its 512 keys (value, col) (bitonic.cuh)
// in registers and keeps its 128 smallest, the warps' lists are merged in
// a tree through shared memory, and the first kb of the result are the
// rounds' output (see flat_extract_kernel for their tail). Its bound is the
// bins' bytes (8 a bin, read once).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>


#include "bitonic.cuh"
#include "hopper.cuh"
#include "lex_min.cuh"
#include "mma_terms.cuh"

namespace {

constexpr int kQT = 128;       // queries per scan block
constexpr int kCS = 32;        // classes per scan block
constexpr float kBig = 3.0e38f;
constexpr uint32_t kNoTile = 0xFFFFu;   // a bin still at its initial column 0

// -- the scan on wgmma ----------------------------------------------------------

// two consumer warpgroups and a producer warpgroup (one thread of it issues
// the copies): setmaxnreg moves registers between whole warpgroups, and
// ptxas gives such a kernel 65536 / 384 registers a thread at launch
constexpr int kConsumerWarps = 8;
constexpr int kScanThreads = kConsumerWarps * 32 + 128;
constexpr int kLaunchRegs = 65536 / kScanThreads / 8 * 8;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(kConsumerWarps * 32 * kConsumerRegs + 128 * kProducerRegs <=
                  kScanThreads * kLaunchRegs,
              "setmaxnreg asks for more registers than the block holds");
constexpr int kChunk = 32;           // columns of a box: 64 bytes, the swizzle's row
constexpr int kBox = kCS * 64;       // one term of a tile's chunk: 32 rows x 64 bytes
constexpr int kQBox = 64 * 64;       // one term of a warpgroup's chunk: 64 queries
constexpr int kSmemMax = 227 * 1024;
constexpr int kStageTarget = 16384;  // bytes a stage aims at
constexpr int kMaxStages = 8;

// The scan's shared memory for rows of dk columns and T terms: up to 1024
// bytes of alignment slack, 1024 of barriers, the query terms of both
// warpgroups ([2][nch][T][64][64 B]), and `stages` stages of `tps` tiles
// each, tps even ([nch][T][tps][32][64 B]: a term's tiles adjacent, so that
// one product reads two tiles' rows; then [tps][32] norms), each stage a
// multiple of 1024 bytes. Where the query terms and two stages of two tiles
// do not fit, the wide scan's plan (flat_scan_wide_kernel: `wide` 1, tps
// the tiles of a unit). ops/flat_scan_fused.py::scan_plan mirrors this.
struct Plan {
  int wide, tps, stages, stage_bytes, smem;
};

constexpr int kUnit = 4;                   // tiles of a wide unit: 128 rows, one product
constexpr int kXUnit = kUnit * kBox;       // one term of a unit's chunk: 128 rows x 64 B
// the wide scan's bins (m1, m2 and the tiles of each consumer thread's 16
// (query, class) pairs) live in shared memory: in registers, beside the
// unit's sums and a part, they spilled
constexpr int kWideBins = 3 * 16 * kConsumerWarps * 32 * 4;

// A wide stage: [T][kUnit][32][64 B] of x, [2][T][64][64 B] of the queries,
// then [kUnit][32] norms, rounded up to 1024 bytes; up to 8 stages after
// 1024 bytes of alignment slack, 1024 of barriers and the bins.
Plan wide_plan(int terms) {
  const int stage = (terms * (kXUnit + 2 * kQBox) + kUnit * kCS * 4 + 1023) / 1024 * 1024;
  int stages = (kSmemMax - 2048 - kWideBins) / stage;
  if (stages > kMaxStages) stages = kMaxStages;
  return Plan{1, kUnit, stages, stage, 2048 + kWideBins + stages * stage};
}

Plan scan_plan(int dk, int terms) {
  const int nch = (dk + kChunk - 1) / kChunk;
  const int tile = nch * terms * kBox + kCS * 4;
  const int fixed = 1024 + 1024 + 2 * nch * terms * kQBox;
  auto stage_of = [](int bytes) { return (bytes + 1023) / 1024 * 1024; };
  int tps = kStageTarget / tile / 2 * 2;
  if (tps < 2) tps = 2;
  const int stages = (kSmemMax - fixed) / stage_of(tps * tile);
  if (stages < 2) return wide_plan(terms);
  const int s = stages > kMaxStages ? kMaxStages : stages;
  return Plan{0, tps, s, stage_of(tps * tile), fixed + s * stage_of(tps * tile)};
}

template <int kDepth, int kTerms, bool kARegs>
__global__ void __launch_bounds__(kScanThreads, 1)
flat_scan_kernel(const __grid_constant__ CUtensorMap qmap,   // [T][nq][dk] bf16
                 const __grid_constant__ CUtensorMap xmap,   // [T][n][dk] bf16
                 const __grid_constant__ CUtensorMap snmap,  // [NB][B] f32
                 float* __restrict__ bins_v,                 // [nq, kDepth * B]
                 int* __restrict__ bins_i,                   // [nq, kDepth * B]
                 int nq, int B, int nch, int tile0, int ntiles,  // the db tiles of this launch
                 int tps, int stages, int stage_bytes) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  uint64_t* qbar = empty + kMaxStages;
  unsigned char* qs = smem + 1024;
  const int q_bytes = 2 * nch * kTerms * kQBox;
  unsigned char* xs = qs + q_bytes;
  const int term_x = tps * kBox;              // one term's tiles of a chunk in a stage
  const int chunk_x = kTerms * term_x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kQT;
  const int s0 = blockIdx.y * kCS;
  const int units = (ntiles + tps - 1) / tps;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::bar_init(&full[s], 1);
      hopper::bar_init(&empty[s], kConsumerWarps);
    }
    hopper::bar_init(qbar, 1);
    hopper::bar_init_fence();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // the producer: the query terms once, then unit u (tiles u*tps ..) into
    // stage u mod stages once the consumers have released it
    hopper::regs_lower<kProducerRegs>();
    if (warp == kConsumerWarps && lane == 0) {
      hopper::bar_expect(qbar, q_bytes);
      for (int wg = 0; wg < 2; ++wg) {
        for (int c = 0; c < nch; ++c) {
          hopper::tma_load(qs + (wg * nch + c) * kTerms * kQBox, &qmap, qbar, c * kChunk,
                           q0 + 64 * wg, 0);
        }
      }
      for (int u = 0, st = 0, ph = 1; u < units; ++u) {
        hopper::bar_wait(&empty[st], ph);
        const int nt = min(tps, ntiles - u * tps);
        hopper::bar_expect(&full[st], nt * (nch * kTerms * kBox + kCS * 4));
        unsigned char* sb = xs + st * stage_bytes;
        for (int p = 0; p < nt; ++p) {
          const int row = (tile0 + u * tps + p) * B + s0;
          for (int c = 0; c < nch; ++c) {
            for (int b = 0; b < kTerms; ++b) {
              hopper::tma_load(sb + c * chunk_x + b * term_x + p * kBox, &xmap, &full[st],
                               c * kChunk, row, b);
            }
          }
          hopper::tma_load(sb + nch * chunk_x + p * kCS * 4, &snmap, &full[st], s0,
                           tile0 + u * tps + p);
        }
        if (++st == stages) { st = 0; ph ^= 1; }
      }
    }
  } else {
    hopper::regs_raise<kConsumerRegs>();
    const int wg = warp >> 2, wl = warp & 3;
    const int g = lane >> 2, t4 = lane & 3;
    // the query fragments of one chunk, k16 steps h = 0, 1: ldmatrix.x4 of
    // the warp's 16 rows from the swizzled box (mma::a_offset's matrices)
    const unsigned char* qw = qs + wg * nch * kTerms * kQBox;
    const int a_row = wl * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    uint32_t a[2][kTerms][4];
    auto load_a = [&](int c) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int t = 0; t < kTerms; ++t) {
          mma::ldsm_x4(a[h][t], qw + (c * kTerms + t) * kQBox +
                                    hopper::sw64(a_row, 2 * h + (lane >> 4)));
        }
      }
    };
    hopper::bar_wait(qbar, 0);
    if constexpr (kARegs) load_a(0);

    // bins of the thread's 16 (query, class) pairs, element e of n-tile nb
    // at index 4 nb + e: query 64 wg + 16 wl + g + 8 (e / 2), class nb*8 +
    // 2 t4 + e % 2. A bin's column is (tile0 + tile) * B + s0 + class: t1 /
    // t2 hold the best's and the runner-up's tile within the launch
    // (kNoTile: a bin's initial column 0; a launch covers fewer tiles)
    float m1[16], m2[16];
    uint32_t t1[16], t2[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      m1[e] = kBig;
      m2[e] = kBig;
      t1[e] = kNoTile;
      t2[e] = kNoTile;
    }
    // A product covers a pair of tiles (64 rows: the 32 of tile j, then the
    // 32 of tile j + 1), so element 4 nb + e of the accumulator is pair k =
    // 4 (nb mod 4) + e of tile j + nb / 4. acc: the pair's sums; p0, p1: the
    // two k16 steps of one chunk, each into a fresh part, smallest cross
    // terms first, joined by IEEE adds (a tile's first chunk starts acc at
    // p0 + p1, not 0 + p0 + p1: that differs only in the sign of a zero
    // sum, which sn - 2 acc does not see)
    float acc[32], p0[32], p1[32];

    // a position in the scan: unit u in stage st of phase ph, tile pair pp
    // of the unit, chunk c
    struct Cursor {
      int u, st, ph, pp, c;
    };
    const int last_pairs = (ntiles - (units - 1) * tps + 1) / 2;
    auto advance = [&](Cursor& k) {
      if (++k.c < nch) return;
      k.c = 0;
      if (++k.pp < (k.u == units - 1 ? last_pairs : tps / 2)) return;
      k.pp = 0;
      ++k.u;
      if (++k.st == stages) { k.st = 0; k.ph ^= 1; }
    };
    // both k16 steps of a chunk, their products interleaved (two
    // independent chains), one commit
    auto issue = [&](const Cursor& k) {
      if (k.c == 0 && k.pp == 0) hopper::bar_wait(&full[k.st], k.ph);
      if constexpr (!kARegs) load_a(k.c);
      const unsigned char* xb = xs + k.st * stage_bytes + k.c * chunk_x + 2 * k.pp * kBox;
      hopper::wgmma_fence();
      bool first = true;
#pragma unroll
      for (int b = kTerms - 1; b >= 0; --b) {
#pragma unroll
        for (int pr = mma::cross_count(kTerms, kTerms) - 1; pr >= 0; --pr) {
          if (mma::cross_b(kTerms, pr) != b) continue;
          const int ai = mma::cross_a(kTerms, pr);
          const uint64_t desc = hopper::desc_sw64(xb + b * term_x);
          hopper::wgmma_m64n64k16(p0, a[0][ai], desc, first ? 0 : 1);
          hopper::wgmma_m64n64k16(p1, a[1][ai], desc + 2, first ? 0 : 1);   // 32 bytes on
          first = false;
        }
      }
      hopper::wgmma_commit();
    };
    auto consume = [&](const Cursor& k) {
      hopper::fence_operands(p0);
      hopper::fence_operands(p1);
#pragma unroll
      if (k.c == 0) {
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[e] = __fadd_rn(p0[e], p1[e]);
      } else {
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[e] = __fadd_rn(__fadd_rn(acc[e], p0[e]), p1[e]);
      }
    };
    // after a pair's last chunk: the bins update of its tiles in order, and
    // the stage released after the unit's last pair
    auto pair_end = [&](const Cursor& k) {
      if (k.c != nch - 1) return;
      const float* sn_st = reinterpret_cast<const float*>(xs + k.st * stage_bytes + nch * chunk_x);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = k.u * tps + 2 * k.pp + half;   // the tile within the launch
        if (j >= ntiles) break;
        const float* snr = sn_st + (2 * k.pp + half) * kCS;
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          const float2 sv = *reinterpret_cast<const float2*>(snr + nb * 8 + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int k2 = nb * 4 + e;
            // 2 * acc is exact, so this is sn - 2 dot rounded once
            const float s = __fmaf_rn(-2.f, acc[16 * half + k2], (e & 1) ? sv.y : sv.x);
            // selects, no branch: the 32 updates of a pair run side by side
            const bool b1 = s < m1[k2];
            if constexpr (kDepth == 2) {
              const float lose_v = b1 ? m1[k2] : s;
              const uint32_t lose_t = b1 ? t1[k2] : (uint32_t)j;
              const bool b2 = lose_v < m2[k2];
              m2[k2] = b2 ? lose_v : m2[k2];
              t2[k2] = b2 ? lose_t : t2[k2];
            }
            m1[k2] = b1 ? s : m1[k2];
            t1[k2] = b1 ? (uint32_t)j : t1[k2];
          }
        }
      }
      if (k.pp == (k.u == units - 1 ? last_pairs : tps / 2) - 1) {
        __syncwarp();
        if (lane == 0) hopper::bar_arrive(&empty[k.st]);
      }
    };

    // One chunk in flight while the previous one's bins update runs. The
    // issue in the loop is unconditional: a GMMA result that only some
    // paths define makes ptxas wait for it on the spot.
    const int total = (units - 1) * (tps / 2) * nch + last_pairs * nch;
    Cursor now{0, 0, 0, 0, 0}, next = now;
    issue(next);
    advance(next);
    for (int i = 0; i + 1 < total; ++i) {
      hopper::wgmma_wait<0>();
      consume(now);
      issue(next);   // the next chunk's products run while this pair's bins update does
      advance(next);
      pair_end(now);
      advance(now);
    }
    hopper::wgmma_wait<0>();
    consume(now);
    pair_end(now);

    const size_t width = (size_t)kDepth * B;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int nb = k >> 2, e = k & 3;
      const int qi = q0 + wg * 64 + wl * 16 + g + 8 * (e >> 1);
      if (qi >= nq) continue;
      const int cls = s0 + nb * 8 + 2 * t4 + (e & 1);
      const size_t o = (size_t)qi * width + cls;
      bins_v[o] = m1[k];
      bins_i[o] = t1[k] == kNoTile ? 0 : (tile0 + (int)t1[k]) * B + cls;
      if constexpr (kDepth == 2) {
        bins_v[o + B] = m2[k];
        bins_i[o + B] = t2[k] == kNoTile ? 0 : (tile0 + (int)t2[k]) * B + cls;
      }
    }
  }
}

// -- wide rows: the query terms a stage at a time ----------------------------------
//
// Rows so wide that the query terms and two stages do not fit shared memory
// take this scan, K outer: a stage of the ring holds one 32-column chunk of
// every term of kUnit tiles of x (128 rows: the 32 of tile j, then those of
// tiles j + 1 .. j + 3, a term's rows adjacent), the same chunk of every
// term of the block's 128 queries ([2][T][64][64 B], one TMA box a
// warpgroup), and, with a unit's last chunk, the unit's 4 x 32 norms. So the
// query crosses from L2 once per 128 rows, as many bytes as of x (once per
// tile of 32 it would be four times as many), and a stage at three terms is
// 6.3 Mflop of products for 49 KB.
// Each k16 step is one chain of m64n128k16 products (A the query fragments
// by ldmatrix, B the stage) summed into a fresh `part`, the smallest cross
// terms first, and joined to the unit's sums by an IEEE add, as the narrow
// scan joins its chunks' parts: the same adds in the same order, so the
// same scores. The next step's chain is issued before this step's bins
// update (after a unit's last chunk: per (query, class) pair its bins read
// from shared memory, its 4 tiles in order, selects, no branch, written
// back), which then overlaps the tensor cores. The unit's sums and a part
// take 128 of the consumers' 232 registers; the bins stay in shared memory
// ([3][16][256], a thread's own entries, no barrier), since in registers
// beside them they spilled and the spills set the pace. The grid, the runs
// of tiles and the output are the narrow scan's.

template <int kDepth, int kTerms>
__global__ void __launch_bounds__(kScanThreads, 1)
flat_scan_wide_kernel(const __grid_constant__ CUtensorMap qmap,   // [T][nq][dk] bf16
                      const __grid_constant__ CUtensorMap xmap,   // [T][n][dk] bf16
                      const __grid_constant__ CUtensorMap snmap,  // [NB][B] f32
                      float* __restrict__ bins_v,                 // [nq, kDepth * B]
                      int* __restrict__ bins_i,                   // [nq, kDepth * B]
                      int nq, int B, int nch, int tile0, int ntiles, int stages,
                      int stage_bytes) {
  constexpr int kXBytes = kTerms * kXUnit;
  constexpr int kLoad = kXBytes + 2 * kTerms * kQBox;   // a stage's bytes before the norms
  constexpr int kCT = kConsumerWarps * 32;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  float* m1s = reinterpret_cast<float*>(smem + 1024);   // [16][kCT] each
  float* m2s = m1s + 16 * kCT;
  uint32_t* jts = reinterpret_cast<uint32_t*>(m2s + 16 * kCT);
  unsigned char* ring = smem + 1024 + kWideBins;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kQT;
  const int s0 = blockIdx.y * kCS;
  const int units = (ntiles + kUnit - 1) / kUnit;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::bar_init(&full[s], 1);
      hopper::bar_init(&empty[s], kConsumerWarps);
    }
    hopper::bar_init_fence();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // the producer: (unit u, chunk c) into the next stage once the consumers
    // have released it; tiles past the database read as zeros (a unit's
    // tiles past the launch are loaded and never scored)
    hopper::regs_lower<kProducerRegs>();
    if (warp == kConsumerWarps && lane == 0) {
      for (int u = 0, st = 0, ph = 1; u < units; ++u) {
        const int j0 = tile0 + u * kUnit;
        for (int c = 0; c < nch; ++c) {
          hopper::bar_wait(&empty[st], ph);
          const bool last = c == nch - 1;
          hopper::bar_expect(&full[st], kLoad + (last ? kUnit * kCS * 4 : 0));
          unsigned char* sb = ring + st * stage_bytes;
          for (int p = 0; p < kUnit; ++p) {
            for (int b = 0; b < kTerms; ++b) {
              hopper::tma_load(sb + b * kXUnit + p * kBox, &xmap, &full[st], c * kChunk,
                               (j0 + p) * B + s0, b);
            }
          }
          for (int wg = 0; wg < 2; ++wg) {
            hopper::tma_load(sb + kXBytes + wg * kTerms * kQBox, &qmap, &full[st], c * kChunk,
                             q0 + 64 * wg, 0);
          }
          if (last) {
            for (int p = 0; p < kUnit; ++p) {
              hopper::tma_load(sb + kLoad + p * kCS * 4, &snmap, &full[st], s0, j0 + p);
            }
          }
          if (++st == stages) { st = 0; ph ^= 1; }
        }
      }
    }
  } else {
    hopper::regs_raise<kConsumerRegs>();
    const int ct = threadIdx.x;
    const int wg = warp >> 2, wl = warp & 3;
    const int g = lane >> 2, t4 = lane & 3;
    const int a_row = wl * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int q_off = kXBytes + wg * kTerms * kQBox;

    // the thread's bins, element 4 nb + e of each tile as in
    // flat_scan_kernel at [4 nb + e][ct]; a tile entry holds the best's tile
    // in its low 16 bits and the runner-up's in its high
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      m1s[e * kCT + ct] = kBig;
      m2s[e * kCT + ct] = kBig;
      jts[e * kCT + ct] = kNoTile | (kNoTile << 16);
    }
    // element 16 p + 4 nb + e of acc (and part) is element 4 nb + e of the
    // unit's tile p
    float acc[64], part[64];
    uint32_t a[kTerms][4];

    // a position in the scan: k16 step h of chunk c of the unit whose first
    // tile (within the launch) is j0, in stage st of parity ph
    struct Cursor {
      int st, ph, c, h, j0;
    };
    auto advance = [&](Cursor& k) {
      if (++k.h < 2) return;
      k.h = 0;
      if (++k.st == stages) { k.st = 0; k.ph ^= 1; }
      if (++k.c < nch) return;
      k.c = 0;
      k.j0 += kUnit;
    };
    // one k16 step: the query fragments, then its cross terms chained into
    // a fresh part, the smallest first
    auto issue = [&](const Cursor& k) {
      if (k.h == 0) hopper::bar_wait(&full[k.st], k.ph);
      const unsigned char* sb = ring + k.st * stage_bytes;
#pragma unroll
      for (int t = 0; t < kTerms; ++t) {
        mma::ldsm_x4(a[t], sb + q_off + t * kQBox + hopper::sw64(a_row, 2 * k.h + (lane >> 4)));
      }
      hopper::wgmma_fence();
      bool first = true;
#pragma unroll
      for (int b = kTerms - 1; b >= 0; --b) {
#pragma unroll
        for (int pr = mma::cross_count(kTerms, kTerms) - 1; pr >= 0; --pr) {
          if (mma::cross_b(kTerms, pr) != b) continue;
          const int ai = mma::cross_a(kTerms, pr);
          const uint64_t desc = hopper::desc_sw64(sb + b * kXUnit) + 2 * k.h;   // 32 bytes on
          hopper::wgmma_m64n128k16(part, a[ai], desc, first ? 0 : 1);
          first = false;
        }
      }
      hopper::wgmma_commit();
    };
    auto consume = [&](const Cursor& k) {
      hopper::fence_operands(part);
      if (k.c == 0 && k.h == 0) {
#pragma unroll
        for (int e = 0; e < 64; ++e) acc[e] = part[e];
      } else {
#pragma unroll
        for (int e = 0; e < 64; ++e) acc[e] = __fadd_rn(acc[e], part[e]);
      }
    };
    // after a unit's last step: each pair's bins through the unit's tiles
    // in order
    auto bins_update = [&](const Cursor& k) {
      const float* sn_st = reinterpret_cast<const float*>(ring + k.st * stage_bytes + kLoad);
      const int live = min(kUnit, ntiles - k.j0);   // the unit's tiles within the launch
#pragma unroll
      for (int k2 = 0; k2 < 16; ++k2) {
        const int nb = k2 >> 2, e = k2 & 3;
        const int cls = nb * 8 + 2 * t4 + (e & 1);
        float m1 = m1s[k2 * kCT + ct], m2 = m2s[k2 * kCT + ct];
        uint32_t t1 = jts[k2 * kCT + ct] & 0xFFFFu, t2 = jts[k2 * kCT + ct] >> 16;
#pragma unroll
        for (int p = 0; p < kUnit; ++p) {
          if (p >= live) break;
          const uint32_t j = k.j0 + p;
          // 2 * acc is exact, so this is sn - 2 dot rounded once
          const float s = __fmaf_rn(-2.f, acc[16 * p + k2], sn_st[p * kCS + cls]);
          const bool b1 = s < m1;
          if constexpr (kDepth == 2) {
            const float lose_v = b1 ? m1 : s;
            const uint32_t lose_t = b1 ? t1 : j;
            const bool b2 = lose_v < m2;
            m2 = b2 ? lose_v : m2;
            t2 = b2 ? lose_t : t2;
          }
          m1 = b1 ? s : m1;
          t1 = b1 ? j : t1;
        }
        m1s[k2 * kCT + ct] = m1;
        if constexpr (kDepth == 2) m2s[k2 * kCT + ct] = m2;
        jts[k2 * kCT + ct] = t1 | (t2 << 16);
      }
    };
    // a stage is released after its second step (and, with a unit's last
    // chunk, the bins update that reads its norms)
    auto step_end = [&](const Cursor& k) {
      if (k.h == 0) return;
      if (k.c == nch - 1) bins_update(k);
      __syncwarp();
      if (lane == 0) hopper::bar_arrive(&empty[k.st]);
    };

    // One step in flight while the previous one's sums and bins update
    // run; the issue in the loop is unconditional (see flat_scan_kernel)
    const int total = units * nch * 2;
    Cursor now{0, 0, 0, 0, 0}, next = now;
    issue(next);
    advance(next);
    for (int i = 0; i + 1 < total; ++i) {
      hopper::wgmma_wait<0>();
      consume(now);
      issue(next);
      advance(next);
      step_end(now);
      advance(now);
    }
    hopper::wgmma_wait<0>();
    consume(now);
    step_end(now);

    const size_t width = (size_t)kDepth * B;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int nb = k >> 2, e = k & 3;
      const int qi = q0 + wg * 64 + wl * 16 + g + 8 * (e >> 1);
      if (qi >= nq) continue;
      const int cls = s0 + nb * 8 + 2 * t4 + (e & 1);
      const size_t o = (size_t)qi * width + cls;
      const uint32_t jt = jts[k * kCT + ct], t1 = jt & 0xFFFFu, t2 = jt >> 16;
      bins_v[o] = m1s[k * kCT + ct];
      bins_i[o] = t1 == kNoTile ? 0 : (tile0 + (int)t1) * B + cls;
      if constexpr (kDepth == 2) {
        bins_v[o + B] = m2s[k * kCT + ct];
        bins_i[o + B] = t2 == kNoTile ? 0 : (tile0 + (int)t2) * B + cls;
      }
    }
  }
}

// the bins of a later run of tiles (bv2 / bi2) merged into those of the
// tiles before it (bv / bi), per (query, class): the best one or two by
// (value, col), which is what the sequential scan keeps over both runs (its
// strict < leaves a tie with the earlier column, and every column of the
// earlier run is the lower)
template <int kDepth>
__global__ void flat_merge_kernel(float* __restrict__ bv, int* __restrict__ bi,
                                  const float* __restrict__ bv2,
                                  const int* __restrict__ bi2, size_t nq, int B) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= nq * B) return;
  const size_t o = e / B * (size_t)(kDepth * B) + e % B;
  float a1 = bv[o], c1 = bv2[o];
  int ia1 = bi[o], ic1 = bi2[o];
  if constexpr (kDepth == 1) {
    if (lex_less(c1, ic1, a1, ia1)) { bv[o] = c1; bi[o] = ic1; }
  } else {
    float a2 = bv[o + B], c2 = bv2[o + B];
    int ia2 = bi[o + B], ic2 = bi2[o + B];
    // the two least of the sorted pairs (a1, a2) and (c1, c2)
    if (lex_less(c1, ic1, a1, ia1)) {
      const bool c2_first = lex_less(c2, ic2, a1, ia1);
      bv[o] = c1; bi[o] = ic1;
      bv[o + B] = c2_first ? c2 : a1;
      bi[o + B] = c2_first ? ic2 : ia1;
    } else if (lex_less(c1, ic1, a2, ia2)) {
      bv[o + B] = c1; bi[o + B] = ic1;
    }
  }
}

// -- the extraction: the kb rounds computed at once ---------------------------------

constexpr int kMaxKb = 128;
constexpr int kMaxBins = 4096;   // 8 warps x 512 keys
// a slot past the bins, (inf, INT_MAX): after every bin (every bin is <= 3e38)
constexpr uint64_t kPadKey = (0xFF800000ull << 32) | 0x7FFFFFFFull;

// One block of `blockDim.x / 32` warps (a power of two, 512 * warps >=
// width) per query. The rounds emit the bins below 3e38 in key order;
// once those are spent, every bin holds 3e38 and each later round emits
// (3e38, m), m the least column among the bins then at 3e38: those
// extracted and those at 3e38 from the start (never filled, column 0;
// or, after a merge of runs, a later run's). So: sort the keys, keep the
// 128 smallest, emit the first n_fin (the keys below 3e38), then (3e38,
// m), m the least column of the kept keys at most 3e38 (the least 3e38 key
// is among them whenever n_fin < 128), each value plus qadd. Warp w sorts
// the bins 512 w + 128 h + 4 lane + u (groups h = 0..3, odd groups
// descending), keeps the 128 smallest of each pair of groups and then of
// the two, and the warps' lists merge pairwise in a tree through shared
// memory (the partner's list read reversed: the elementwise minimum of an
// ascending and a descending list is a bitonic sequence holding the 128
// smallest of both). Lane l of warp 0 writes outputs 4 l .. 4 l + 3.
__global__ void __launch_bounds__(kMaxBins / 16)
flat_extract_kernel(const float* __restrict__ bins_v,
                    const int* __restrict__ bins_i,
                    const float* __restrict__ qadd,
                    float* __restrict__ out_d, int* __restrict__ out_i,
                    int width, int kb) {
  __shared__ uint64_t lists[kMaxBins / 512][128];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const size_t qi = blockIdx.x;
  const float* bv_row = bins_v + qi * width;
  const int* bi_row = bins_i + qi * width;

  uint64_t s[4];
  if (512 * warp < width) {
    uint64_t x[16];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int b = 512 * warp + 128 * h + 4 * lane;   // width is a multiple of 32
      if (b < width) {
        const float4 v = *reinterpret_cast<const float4*>(bv_row + b);
        const int4 l = *reinterpret_cast<const int4*>(bi_row + b);
        x[4 * h + 0] = sort_key(v.x, l.x);
        x[4 * h + 1] = sort_key(v.y, l.y);
        x[4 * h + 2] = sort_key(v.z, l.z);
        x[4 * h + 3] = sort_key(v.w, l.w);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) x[4 * h + u] = kPadKey;
      }
    }
    bitonic_sort<4, 128>(x, lane);
    uint64_t m[8];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      m[u] = x[4 + u] < x[u] ? x[4 + u] : x[u];
      m[4 + u] = x[12 + u] < x[8 + u] ? x[12 + u] : x[8 + u];
    }
    bitonic_merge<2, 256, 64>(m, lane);   // group 0 ascending, group 1 descending
#pragma unroll
    for (int u = 0; u < 4; ++u) s[u] = m[4 + u] < m[u] ? m[4 + u] : m[u];
    bitonic_merge<1, 256, 64>(s, lane);
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) s[u] = kPadKey;
  }
  for (int half = warps >> 1; half >= 1; half >>= 1) {
    if (warp >= half && warp < 2 * half) {
#pragma unroll
      for (int u = 0; u < 4; ++u) lists[warp][4 * lane + u] = s[u];
    }
    __syncthreads();
    if (warp < half) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint64_t r = lists[warp + half][127 - 4 * lane - u];
        s[u] = r < s[u] ? r : s[u];
      }
      bitonic_merge<1, 256, 64>(s, lane);
    }
  }
  if (warp != 0) return;

  // n_fin: keys below 3e38; m: the least column of the keys at most 3e38
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
  const float qa = qadd[qi];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r = 4 * lane + u;
    if (r < kb) {
      const bool real = r < n_fin;
      out_d[qi * kb + r] = __fadd_rn(real ? key_value(s[u]) : kBig, qa);
      out_i[qi * kb + r] = (int)(real ? (uint32_t)s[u] : m);
    }
  }
}

int launch_extract(const float* bins_v, const int* bins_i, const float* qadd, float* out_d,
                   int* out_i, int nq, int width, int kb, cudaStream_t stream) {
  int warps = 1;
  while (512 * warps < width) warps *= 2;
  flat_extract_kernel<<<nq, 32 * warps, 0, stream>>>(bins_v, bins_i, qadd, out_d, out_i,
                                                     width, kb);
  return (int)cudaGetLastError();
}

// -- host: launches (tensor maps: hopper.cuh) ---------------------------------------

struct Maps {
  CUtensorMap q, x, sn;
};

// setmaxnreg moves registers within the block's launch allocation: a
// smaller allocation than the launch bounds give would hang the raise
template <typename Kernel>
int prepare(Kernel kern, int smem) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return (int)err;
  if (attr.numRegs < kLaunchRegs) return (int)cudaErrorInvalidConfiguration;
  return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int kDepth, int kTerms>
int launch_terms(const Maps& a, const Plan& plan, float* bins_v, int* bins_i, int nq,
                 int dk, int B, int tile0, int ntiles, cudaStream_t stream) {
  const dim3 grid((nq + kQT - 1) / kQT, B / kCS);
  if (plan.wide) {
    auto kern = flat_scan_wide_kernel<kDepth, kTerms>;
    const int err = prepare(kern, plan.smem);
    if (err) return err;
    kern<<<grid, kScanThreads, plan.smem, stream>>>(a.q, a.x, a.sn, bins_v, bins_i, nq, B,
                                                    dk / kChunk, tile0, ntiles, plan.stages,
                                                    plan.stage_bytes);
    return (int)cudaGetLastError();
  }
  auto kern = dk == kChunk ? flat_scan_kernel<kDepth, kTerms, true>
                           : flat_scan_kernel<kDepth, kTerms, false>;
  const int err = prepare(kern, plan.smem);
  if (err) return err;
  kern<<<grid, kScanThreads, plan.smem, stream>>>(a.q, a.x, a.sn, bins_v, bins_i, nq, B,
                                                  dk / kChunk, tile0, ntiles, plan.tps,
                                                  plan.stages, plan.stage_bytes);
  return (int)cudaGetLastError();
}

using ScanLaunch = decltype(&launch_terms<1, 1>);
// [depth - 1][terms - 1]
const ScanLaunch kScan[2][3] = {
    {launch_terms<1, 1>, launch_terms<1, 2>, launch_terms<1, 3>},
    {launch_terms<2, 1>, launch_terms<2, 2>, launch_terms<2, 3>},
};

}  // namespace

// The scan's plan for rows of dk columns (a multiple of 32) and `terms`
// terms: out[0..4] = wide (1: flat_scan_wide_kernel, the query terms a stage
// at a time), tiles a stage (wide: a unit), stages, bytes a stage, dynamic
// shared memory. Returns 0.
extern "C" int annsearch_flat_scan_plan(int dk, int terms, void* out) {
  const Plan p = scan_plan(dk, terms);
  int* o = (int*)out;
  o[0] = p.wide;
  o[1] = p.tps;
  o[2] = p.stages;
  o[3] = p.stage_bytes;
  o[4] = p.smem;
  return 0;
}

// K2 for one slab of queries: the scan into bins_v / bins_i ([nq, depth * B]
// scratch of the caller) and the extraction into out_d / out_i ([nq, kb]).
// q_terms points at the slab's first row of the first query term; the terms
// are [terms, nq_total, dk] and x_terms [terms, n, dk], bf16; sn holds
// ceil(n / B) * B norms (3e38 at and past n_valid). The scan runs over runs
// of fewer than 65,535 tiles; past the first, each run's bins go to
// bins_v2 / bins_i2 (scratch as bins_v / bins_i, unused with fewer tiles)
// and are merged into the earlier runs'. Launches on `stream` and returns
// the first cudaError_t that is not 0. The caller validates: dk a multiple
// of 32, B a multiple of 32, depth 1 or 2, terms 1 to 3, depth * B <= 4096,
// 1 <= kb <= min(depth * B, 128), 16-byte aligned arrays.
extern "C" int annsearch_flat_scan(
    const void* q_terms, const void* x_terms, const void* sn, const void* qadd,
    void* bins_v, void* bins_i, void* bins_v2, void* bins_i2, void* out_d, void* out_i,
    int nq, int nq_total, int n, int dk, int B, int depth, int kb, int terms,
    void* stream) {
  if (nq <= 0) return 0;
  if (depth < 1 || depth > 2 || terms < 1 || terms > 3 || dk % kChunk || B % kCS ||
      depth * B > kMaxBins || kb < 1 || kb > kMaxKb || kb > depth * B) {
    return (int)cudaErrorInvalidValue;
  }
  const int tiles = (n + B - 1) / B;
  const int run = (int)kNoTile - 1;
  if (tiles > run && (bins_v2 == nullptr || bins_i2 == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const Plan plan = scan_plan(dk, terms);
  Maps maps;
  const cuuint64_t esz = 2, row = (cuuint64_t)dk * esz;
  const cuuint64_t q_dims[3] = {(cuuint64_t)dk, (cuuint64_t)nq, (cuuint64_t)terms};
  const cuuint64_t q_strides[2] = {row, (cuuint64_t)nq_total * row};
  const cuuint32_t q_box[3] = {kChunk, 64, (cuuint32_t)terms};
  const cuuint64_t x_dims[3] = {(cuuint64_t)dk, (cuuint64_t)n, (cuuint64_t)terms};
  const cuuint64_t x_strides[2] = {row, (cuuint64_t)n * row};
  const cuuint32_t x_box[3] = {kChunk, kCS, 1};
  const cuuint64_t sn_dims[2] = {(cuuint64_t)B, (cuuint64_t)tiles};
  const cuuint64_t sn_strides[1] = {(cuuint64_t)B * 4};
  const cuuint32_t sn_box[2] = {kCS, 1};
  if (!hopper::make_map(&maps.q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, q_terms, q_dims,
                        q_strides, q_box, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !hopper::make_map(&maps.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, x_terms, x_dims,
                        x_strides, x_box, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !hopper::make_map(&maps.sn, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, sn, sn_dims,
                        sn_strides, sn_box, CU_TENSOR_MAP_SWIZZLE_NONE)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  for (int t0 = 0; t0 < tiles; t0 += run) {
    const bool first = t0 == 0;
    const int err = kScan[depth - 1][terms - 1](
        maps, plan, (float*)(first ? bins_v : bins_v2), (int*)(first ? bins_i : bins_i2), nq, dk,
        B, t0, min(run, tiles - t0), st);
    if (err) return err;
    if (!first) {
      const size_t pairs = (size_t)nq * B;
      const unsigned blocks = (unsigned)((pairs + 255) / 256);
      if (depth == 1) {
        flat_merge_kernel<1><<<blocks, 256, 0, st>>>(
            (float*)bins_v, (int*)bins_i, (const float*)bins_v2, (const int*)bins_i2, nq, B);
      } else {
        flat_merge_kernel<2><<<blocks, 256, 0, st>>>(
            (float*)bins_v, (int*)bins_i, (const float*)bins_v2, (const int*)bins_i2, nq, B);
      }
      const int merr = (int)cudaGetLastError();
      if (merr) return merr;
    }
  }
  return launch_extract((const float*)bins_v, (const int*)bins_i, (const float*)qadd,
                        (float*)out_d, (int*)out_i, nq, depth * B, kb, st);
}

// K2's extraction alone, on bins the caller gives ([nq, width] values, every
// one at most 3e38, and columns): out_d / out_i [nq, kb] as the kb rounds
// give them. width a multiple of 32 up to 4096, 1 <= kb <= min(width, 128).
extern "C" int annsearch_flat_extract(const void* bins_v, const void* bins_i, const void* qadd,
                                      void* out_d, void* out_i, int nq, int width, int kb,
                                      void* stream) {
  if (nq <= 0) return 0;
  if (width % 32 || width > kMaxBins || kb < 1 || kb > kMaxKb || kb > width) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_extract((const float*)bins_v, (const int*)bins_i, (const float*)qadd,
                        (float*)out_d, (int*)out_i, nq, width, kb, (cudaStream_t)stream);
}
