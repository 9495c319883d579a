// K2, the fused flat top-k: the Pallas kernel
// annsearch_tpu/ops/flat_scan_pallas.py (_flat_kernel, launched by
// flat_topk_fused) as two hand-written kernels, a scan on the tensor cores
// and an extraction.
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
// rounded up to 16 and zero columns. No lane-packed layout: the tensor
// cores take each pair as its own product.
//
// Partition. A scan block owns 128 queries and a slice of 32 classes: of
// every db tile j it reads the 32 contiguous rows j*B + s .. j*B + s + 31.
// Eight warps, each 16 queries x the 32 classes (four m16n8 tiles): by the
// accumulator-fragment map a thread holds the same 16 (query, class) pairs
// in the same registers for every tile, and keeps their bins there over
// the whole database. Every pair is followed by one thread through the
// tiles in order, so the bins are those of the sequential scan entry for
// entry, exact score ties included. The bins of a slab of queries go to
// device memory once ([queries, depth*B] values and columns), and the
// extraction kernel, one block per query, reads them once: 16 bins a
// thread in registers, kb rounds of a block-wide lexicographic arg-min.
//
// Bound on the H100: the cross terms' passes (1, 3 or 6) x nq * n * d
// multiply-adds at the bf16 tensor-core peak (6 x 3.2e13 at 1M x 1M x 32d,
// 0.39 s); q, x and the outputs are a few hundred MB. Design: the query
// terms of the block stay in shared memory for the whole scan where they
// fit (else they are streamed beside x); x steps of 32 rows x 32 columns
// of every term, with the 32 row norms, go through a ring of eight stages
// (three beside a streamed query) filled by cp.async. Per 16 columns a
// warp loads its query fragments and the tile's with ldmatrix and issues
// one mma.sync per (pair, n-tile), the smallest cross terms first into a
// fresh accumulator that then joins the tile's sums by one IEEE add (see
// mma_terms.cuh: each mma chops its sum to 24 bits of its largest term, so
// one accumulator over many steps would gather chops that all lean one
// way). The bins update runs on the accumulator fragment in registers, a
// bin's tile in 16 bits: sn - 2 dot as one FMA, and the update skipped when
// the score does not beat the class's runner-up (m1 <= m2 always holds, so
// the skip changes nothing). A launch covers fewer than 65,535 tiles; the
// C entry scans longer databases in runs of tiles and merges each run's
// bins into the earlier runs' (flat_merge_kernel). Blocks of one class
// slice are adjacent in the grid, so the blocks in flight read the same
// slice of x (n / B * 32 rows) from L2.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "lex_min.cuh"
#include "mma_terms.cuh"

namespace {

constexpr int kQT = 128;       // queries per scan block
constexpr int kCS = 32;        // classes per scan block
constexpr int kKC = 32;        // columns per staged step
constexpr int kRow = kKC * 2 + 16;   // bytes of a staged row (5 x 16: odd)
// stages of the ring: deep where the query tile is resident (a step is
// then one x tile, a few hundred cycles of work against a microsecond of
// L2 latency), three where the query is streamed beside x
__host__ __device__ constexpr int stages(bool resident) { return resident ? 8 : 3; }
constexpr int kThreads = 256;
constexpr int kBinsPerThread = 16;  // extraction: depth * B <= 16 * 256
constexpr float kBig = 3.0e38f;
constexpr uint32_t kNoTile = 0xFFFFu;   // a bin still at its initial column 0

// bytes of one stage: the T terms of 32 x rows, then their 32 norms
template <int kTerms>
__host__ __device__ constexpr int x_stage_bytes() {
  return kTerms * kCS * kRow + kCS * 4;
}

template <int kDepth, int kTerms, bool kResident>
__global__ void __launch_bounds__(kThreads, 2)
flat_scan_kernel(const uint16_t* __restrict__ q,   // [T][.., dk] bf16, this slab's rows
                 size_t q_ts,                      // elements between q terms
                 const uint16_t* __restrict__ x,   // [T][n, dk] bf16
                 const float* __restrict__ sn,     // [NB * B], 3e38 past n_valid
                 float* __restrict__ bins_v,       // [nq, kDepth * B]
                 int* __restrict__ bins_i,         // [nq, kDepth * B]
                 int nq, int n, int dk, int B,
                 int tile0, int ntiles) {          // the db tiles of this launch
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kStages = stages(kResident);
  constexpr int kXStage = x_stage_bytes<kTerms>();
  constexpr int kQStageTerm = kQT * kRow;      // streamed: one term of a step
  unsigned char* xs = smem;                    // [kStages][T][32][kRow] + norms
  unsigned char* qs = smem + kStages * kXStage;
  // resident: [T][128][dk * 2 + 16]; streamed: [kStages][T][128][kRow]
  const int qstride = kResident ? dk * 2 + 16 : kRow;
  const int q_term = kQT * qstride;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * kQT;
  const int s0 = blockIdx.y * kCS;
  const size_t x_ts = (size_t)n * dk;

  const int nch = (dk + kKC - 1) / kKC;
  const int total = ntiles * nch;

  if constexpr (kResident) {
    const int vpr = dk / 8;   // 16-byte vectors of a row
    for (int v = tid; v < kTerms * kQT * vpr; v += kThreads) {
      const int term = v / (kQT * vpr);
      const int rem = v - term * kQT * vpr;
      const int row = rem / vpr, vec = rem - row * vpr;
      const bool ok = q0 + row < nq;
      mma::cp_async16(qs + term * q_term + row * qstride + vec * 16,
                      q + term * q_ts + (ok ? (size_t)(q0 + row) * dk + vec * 8 : 0),
                      ok ? 16 : 0);
    }
  }
  // step t = (tile tile0 + j, column chunk ch) into stage t mod kStages;
  // rows and columns outside the matrices read as zeros
  auto issue = [&](int t) {
    unsigned char* st = xs + (t % kStages) * kXStage;
    const int j = tile0 + t / nch, ch = t % nch;
    const int c0 = ch * kKC;
    for (int v = tid; v < kTerms * kCS * 4; v += kThreads) {
      const int term = v / (kCS * 4);
      const int row = (v >> 2) & (kCS - 1), vec = v & 3;
      const int xr = j * B + s0 + row, col = c0 + vec * 8;
      const bool ok = xr < n && col < dk;
      mma::cp_async16(st + term * kCS * kRow + row * kRow + vec * 16,
                      x + term * x_ts + (ok ? (size_t)xr * dk + col : 0), ok ? 16 : 0);
    }
    if (tid < kCS / 4) {   // the tile's 32 norms (sn holds whole tiles)
      mma::cp_async16(st + kTerms * kCS * kRow + tid * 16,
                      sn + (size_t)j * B + s0 + tid * 4, 16);
    }
    if constexpr (!kResident) {
      unsigned char* qst = qs + (t % kStages) * kTerms * kQStageTerm;
      for (int v = tid; v < kTerms * kQT * 4; v += kThreads) {
        const int term = v / (kQT * 4);
        const int row = (v >> 2) & (kQT - 1), vec = v & 3;
        const int col = c0 + vec * 8;
        const bool ok = q0 + row < nq && col < dk;
        mma::cp_async16(qst + term * kQStageTerm + row * kRow + vec * 16,
                        q + term * q_ts + (ok ? (size_t)(q0 + row) * dk + col : 0),
                        ok ? 16 : 0);
      }
    }
  };

  // bins of the thread's 16 (query, class) pairs, element e of n-tile nb
  // at index 4 nb + e: query warp*16 + g + 8 (e / 2), class nb*8 + 2 t4 +
  // e % 2. A bin's column is (tile0 + tile) * B + s0 + class, so one
  // register holds both bins' tiles within the launch: the best's in the
  // low 16 bits, the runner-up's in the high 16 (kNoTile: a bin's initial
  // column 0); a launch covers fewer than kNoTile tiles
  float m1[16], m2[16];
  uint32_t jt[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    m1[e] = kBig;
    m2[e] = kBig;
    jt[e] = kNoTile | (kNoTile << 16);
  }
  // the tile's sums, and one 16-column step's: each step's products go
  // into a fresh `part`, smallest cross terms first, and join `acc` by one
  // IEEE add (an mma chops its sum to 24 bits of its largest term: the
  // chops of one long accumulation would all lean one way)
  float acc[4][4], part[4][4];

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) issue(s);
    mma::cp_async_commit();
  }
  const int a_off = mma::a_offset(lane, qstride) + warp * 16 * qstride;
  const int b_off = mma::b_offset(lane, kRow);

  for (int t = 0; t < total; ++t) {
    mma::cp_async_wait<kStages - 2>();
    __syncthreads();   // step t landed; every warp is done with step t - 1
    if (t + kStages - 1 < total) issue(t + kStages - 1);
    mma::cp_async_commit();

    const unsigned char* st = xs + (t % kStages) * kXStage;
    const int j = t / nch, ch = t - j * nch;   // j: the tile within the launch
    if (ch == 0) {
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
      }
    }
    const int w = min(kKC, dk - ch * kKC);
    const unsigned char* qb =
        kResident ? qs + a_off + ch * kKC * 2 : qs + (t % kStages) * kTerms * kQStageTerm + a_off;
    const unsigned char* xb = st + b_off;
#pragma unroll
    for (int ks = 0; ks < kKC / 16; ++ks) {
      if (ks * 16 >= w) break;
      uint32_t a[kTerms][4];
#pragma unroll
      for (int i = 0; i < kTerms; ++i) mma::ldsm_x4(a[i], qb + i * q_term + ks * 32);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) part[nb][e] = 0.f;
      }
      // database terms from the smallest; within one, query terms likewise
#pragma unroll
      for (int b = kTerms - 1; b >= 0; --b) {
        uint32_t b01[4], b23[4];
        mma::ldsm_x4(b01, xb + b * kCS * kRow + ks * 32);
        mma::ldsm_x4(b23, xb + b * kCS * kRow + 16 * kRow + ks * 32);
#pragma unroll
        for (int p = mma::cross_count(kTerms, kTerms) - 1; p >= 0; --p) {
          if (mma::cross_b(kTerms, p) != b) continue;
          const int ai = mma::cross_a(kTerms, p);
          mma::mma_bf16(part[0], a[ai], b01[0], b01[1]);
          mma::mma_bf16(part[1], a[ai], b01[2], b01[3]);
          mma::mma_bf16(part[2], a[ai], b23[0], b23[1]);
          mma::mma_bf16(part[3], a[ai], b23[2], b23[3]);
        }
      }
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nb][e] = __fadd_rn(acc[nb][e], part[nb][e]);
      }
    }

    if (ch == nch - 1) {
      // the bins update of tile j on the accumulator fragment
      const float* snr = reinterpret_cast<const float*>(st + kTerms * kCS * kRow);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const float2 sv = *reinterpret_cast<const float2*>(snr + nb * 8 + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = nb * 4 + e;
          // 2 * acc is exact, so this is sn - 2 dot rounded once
          const float s = __fmaf_rn(-2.f, acc[nb][e], (e & 1) ? sv.y : sv.x);
          if constexpr (kDepth == 1) {
            if (s < m1[k]) { m1[k] = s; jt[k] = j; }
          } else if (s < m2[k]) {   // m1 <= m2: else nothing changes
            const bool b1 = s < m1[k];
            const float lose_v = b1 ? m1[k] : s;
            const uint32_t lose_t = b1 ? jt[k] & 0xFFFFu : (uint32_t)j;
            if (b1) { m1[k] = s; jt[k] = (jt[k] & 0xFFFF0000u) | j; }
            if (lose_v < m2[k]) { m2[k] = lose_v; jt[k] = (jt[k] & 0xFFFFu) | (lose_t << 16); }
          }
        }
      }
    }
  }

  const size_t width = (size_t)kDepth * B;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int nb = k >> 2, e = k & 3;
    const int qi = q0 + warp * 16 + g + 8 * (e >> 1);
    if (qi >= nq) continue;
    const int cls = s0 + nb * 8 + 2 * t4 + (e & 1);
    const size_t o = (size_t)qi * width + cls;
    const uint32_t t1 = jt[k] & 0xFFFFu, t2 = jt[k] >> 16;
    bins_v[o] = m1[k];
    bins_i[o] = t1 == kNoTile ? 0 : (tile0 + (int)t1) * B + cls;
    if constexpr (kDepth == 2) {
      bins_v[o + B] = m2[k];
      bins_i[o + B] = t2 == kNoTile ? 0 : (tile0 + (int)t2) * B + cls;
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

// one block per query: kb rounds of the lexicographic (value, col) minimum
// over its `width` bins
__global__ void __launch_bounds__(kThreads)
flat_extract_kernel(const float* __restrict__ bins_v,
                    const int* __restrict__ bins_i,
                    const float* __restrict__ qadd,
                    float* __restrict__ out_d, int* __restrict__ out_i,
                    int width, int kb) {
  __shared__ float wv[2][kThreads / 32];
  __shared__ int wi[2][kThreads / 32];
  const int tid = threadIdx.x;
  const size_t qi = blockIdx.x;
  const float* bv_row = bins_v + qi * width;
  const int* bi_row = bins_i + qi * width;

  float v[kBinsPerThread];
  int id[kBinsPerThread];
#pragma unroll
  for (int e = 0; e < kBinsPerThread; ++e) {
    const int b = tid + kThreads * e;
    // a slot past the bins never wins: every bin is <= 3e38
    v[e] = b < width ? bv_row[b] : __int_as_float(0x7f800000);
    id[e] = b < width ? bi_row[b] : INT_MAX;
  }
  const float qa = qadd[qi];

  for (int t = 0; t < kb; ++t) {
    float bv = v[0];
    int bi = id[0];
#pragma unroll
    for (int e = 1; e < kBinsPerThread; ++e) {
      if (lex_less(v[e], id[e], bv, bi)) { bv = v[e]; bi = id[e]; }
    }
    warp_lex_min(bv, bi);
    const int par = t & 1;
    if ((tid & 31) == 0) { wv[par][tid >> 5] = bv; wi[par][tid >> 5] = bi; }
    __syncthreads();
    bv = wv[par][0];
    bi = wi[par][0];
#pragma unroll
    for (int wp = 1; wp < kThreads / 32; ++wp) {
      if (lex_less(wv[par][wp], wi[par][wp], bv, bi)) { bv = wv[par][wp]; bi = wi[par][wp]; }
    }
    if (tid == 0) {
      out_d[qi * kb + t] = __fadd_rn(bv, qa);
      out_i[qi * kb + t] = bi;
    }
#pragma unroll
    for (int e = 0; e < kBinsPerThread; ++e) {
      if (v[e] == bv && id[e] == bi) v[e] = kBig;
    }
  }
}

template <int kTerms>
size_t scan_smem(int dk, bool resident) {
  const size_t q = resident ? (size_t)kTerms * kQT * (dk * 2 + 16)
                            : (size_t)stages(false) * kTerms * kQT * kRow;
  return (size_t)stages(resident) * x_stage_bytes<kTerms>() + q;
}

template <int kDepth, int kTerms, bool kResident>
int launch_scan(const uint16_t* q, size_t q_ts, const uint16_t* x, const float* sn,
                float* bins_v, int* bins_i, int nq, int n, int dk, int B, int tile0,
                int ntiles, cudaStream_t stream) {
  auto kern = flat_scan_kernel<kDepth, kTerms, kResident>;
  const size_t smem = scan_smem<kTerms>(dk, kResident);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nq + kQT - 1) / kQT, B / kCS);
  kern<<<grid, kThreads, smem, stream>>>(q, q_ts, x, sn, bins_v, bins_i, nq, n, dk, B,
                                         tile0, ntiles);
  return (int)cudaGetLastError();
}

template <int kDepth, int kTerms>
int launch_terms(const uint16_t* q, size_t q_ts, const uint16_t* x, const float* sn,
                 float* bins_v, int* bins_i, int nq, int n, int dk, int B, int tile0,
                 int ntiles, cudaStream_t stream) {
  // the query terms stay resident where the block fits 200 KiB
  auto run = scan_smem<kTerms>(dk, true) <= 200 * 1024 ? &launch_scan<kDepth, kTerms, true>
                                                        : &launch_scan<kDepth, kTerms, false>;
  return run(q, q_ts, x, sn, bins_v, bins_i, nq, n, dk, B, tile0, ntiles, stream);
}

using ScanLaunch = decltype(&launch_terms<1, 1>);
// [depth - 1][terms - 1]
const ScanLaunch kScan[2][3] = {
    {launch_terms<1, 1>, launch_terms<1, 2>, launch_terms<1, 3>},
    {launch_terms<2, 1>, launch_terms<2, 2>, launch_terms<2, 3>},
};

}  // namespace

// K2 for one slab of queries: the scan into bins_v / bins_i ([nq, depth * B]
// scratch of the caller) and the extraction into out_d / out_i ([nq, kb]).
// q_terms points at the slab's first row of the first query term; the terms
// are [terms, nq_total, dk] and x_terms [terms, n, dk], bf16; sn holds
// ceil(n / B) * B norms (3e38 at and past n_valid). The scan runs over runs
// of fewer than 65,535 tiles; past the first, each run's bins go to
// bins_v2 / bins_i2 (scratch as bins_v / bins_i, unused with fewer tiles)
// and are merged into the earlier runs'. Launches on `stream` and returns
// the first cudaError_t that is not 0. The caller validates: dk a multiple
// of 16, B a multiple of 32, depth 1 or 2, terms 1 to 3, depth * B <= 4096,
// 1 <= kb <= depth * B, 16-byte aligned arrays.
extern "C" int annsearch_flat_scan(
    const void* q_terms, const void* x_terms, const void* sn, const void* qadd,
    void* bins_v, void* bins_i, void* bins_v2, void* bins_i2, void* out_d, void* out_i,
    int nq, int nq_total, int n, int dk, int B, int depth, int kb, int terms,
    void* stream) {
  if (nq <= 0) return 0;
  if (depth < 1 || depth > 2 || terms < 1 || terms > 3) return (int)cudaErrorInvalidValue;
  const int tiles = (n + B - 1) / B;
  const int run = (int)kNoTile - 1;
  if (tiles > run && (bins_v2 == nullptr || bins_i2 == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  for (int t0 = 0; t0 < tiles; t0 += run) {
    const bool first = t0 == 0;
    const int err = kScan[depth - 1][terms - 1](
        (const uint16_t*)q_terms, (size_t)nq_total * dk, (const uint16_t*)x_terms,
        (const float*)sn, (float*)(first ? bins_v : bins_v2),
        (int*)(first ? bins_i : bins_i2), nq, n, dk, B, t0, min(run, tiles - t0), st);
    if (err) return err;
    if (!first) {
      const size_t pairs = (size_t)nq * B;
      const unsigned blocks = (unsigned)((pairs + kThreads - 1) / kThreads);
      if (depth == 1) {
        flat_merge_kernel<1><<<blocks, kThreads, 0, st>>>(
            (float*)bins_v, (int*)bins_i, (const float*)bins_v2, (const int*)bins_i2, nq, B);
      } else {
        flat_merge_kernel<2><<<blocks, kThreads, 0, st>>>(
            (float*)bins_v, (int*)bins_i, (const float*)bins_v2, (const int*)bins_i2, nq, B);
      }
      const int merr = (int)cudaGetLastError();
      if (merr) return merr;
    }
  }
  flat_extract_kernel<<<nq, kThreads, 0, st>>>(
      (const float*)bins_v, (const int*)bins_i, (const float*)qadd,
      (float*)out_d, (int*)out_i, depth * B, kb);
  return (int)cudaGetLastError();
}
