// K2, the fused flat top-k: the Pallas kernel
// annsearch_tpu/ops/flat_scan_pallas.py (_flat_kernel, launched by
// flat_topk_fused) as two hand-written kernels, a scan and an extraction.
//
// What it computes, for query i < nq over the rows x[0 .. n_valid):
//   dot    = sum_c T(q[i, c]) * T(x[col, c])      (f32 FFMA, c in order)
//   score  = sn[col] - 2 dot                      (sn = |x|^2, or 0: cosine)
//   class  = col mod B keeps its best (depth 1) or best two (depth 2)
//            (score, col) over the db tiles j = col / B in order, updated
//            with a strict <: b1 = score < m1; the loser of that comparison
//            goes against m2 with a strict < again. Bins start at (3e38, 0).
//   then kb rounds of the lexicographic minimum (value, col) over the
//   depth * B bins; each round writes (value + qadd[i], col) and sets the
//   value of every bin equal to the winner in value and col to 3e38.
// Rows at or past n_valid (the Pallas wrapper gives them sn = 3e38) never
// enter a bin: 3e38 - 2 dot rounds to 3e38, which is not < 3e38.
//
// T is the grade of the dots. The Pallas body sums bf16 cross terms of a
// mantissa split on the MXU (passes 3 and 6) and packs them into the lane
// dimension at d <= 64. Here T is the identity for passes 3 and 6 (FP32 FFMA
// with f32 sums carries all 24 bits, at least what either split promises),
// and round-to-nearest-even to bf16 of both operands for passes 1, summed in
// f32. No packed layout and no sublane-replicated rows.
//
// Partition. The Pallas grid keeps QT x depth*B bins in VMEM (16.8 MiB);
// an SM has 227 KB. A scan block owns 128 queries and a slice of 32
// classes: of every db tile j it reads the 32 contiguous rows j*B + s ..
// j*B + s + 31, and each thread keeps the bins of its 4 queries x 4 classes
// in registers over the whole database. Every (query, class) pair is
// followed by one thread through the tiles in order, so the bins are those
// of the sequential scan entry for entry, exact score ties included. The
// bins of a slab of queries go to device memory once ([queries, depth*B]
// values and columns), and the extraction kernel, one block per query,
// reads them once: 16 bins a thread in registers, kb rounds of a block-wide
// lexicographic arg-min.
//
// Bound on the H100: nq * n * d multiply-adds at the fp32 peak of the CUDA
// cores (3.2e13 at 1M x 1M x 32d, 0.96 s); q, x and the outputs are a few
// hundred MB. Design: x chunks of 32 rows x 32 columns are double-buffered
// in shared memory (one 16-byte load a thread and one barrier a chunk); the
// query tile stays in shared memory for the whole scan where it fits
// (padded d <= 392), else it is streamed in chunks beside x. Row strides
// are padded by 4 floats and a thread's classes are 8 apart, so the 16-byte
// reads of a quarter-warp fall in distinct banks. Each thread does 64 FMAs
// for 8 shared 16-byte reads. The bins update is skipped when the score
// does not beat the class's runner-up (m1 <= m2 always holds, so the skip
// changes nothing). Blocks of one class slice are adjacent in the grid, so
// the blocks in flight read the same slice of x (n / B * 32 rows) from L2.
// wgmma on a split of the operands and TMA staging are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "lex_min.cuh"

namespace {

constexpr int kQT = 128;       // queries per scan block
constexpr int kCS = 32;        // classes per scan block
constexpr int kKC = 32;        // columns per staged chunk
constexpr int kStride = kKC + 4;
constexpr int kThreads = 256;
constexpr int kBinsPerThread = 16;  // extraction: depth * B <= 16 * 256
constexpr float kBig = 3.0e38f;

template <bool kBf16>
__device__ __forceinline__ float4 grade(float4 v) {
  if constexpr (kBf16) {
    v.x = __bfloat162float(__float2bfloat16_rn(v.x));
    v.y = __bfloat162float(__float2bfloat16_rn(v.y));
    v.z = __bfloat162float(__float2bfloat16_rn(v.z));
    v.w = __bfloat162float(__float2bfloat16_rn(v.w));
  }
  return v;
}

// 16 bytes of row `row` at column `col` of a [rows, dp] matrix, zeros
// outside it (dp is a multiple of 4, so a vector never straddles a row end)
__device__ __forceinline__ float4 fetch4(const float* __restrict__ m, int rows,
                                         int dp, int row, int col) {
  if (row < rows && col < dp) {
    return *reinterpret_cast<const float4*>(m + (size_t)row * dp + col);
  }
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

template <int kDepth, bool kBf16, bool kResident>
__global__ void __launch_bounds__(kThreads)
flat_scan_kernel(const float* __restrict__ q,    // [nq, dp]
                 const float* __restrict__ x,    // [n, dp]
                 const float* __restrict__ sn,   // [n] or null (cosine: 0)
                 float* __restrict__ bins_v,     // [nq, kDepth * B]
                 int* __restrict__ bins_i,       // [nq, kDepth * B]
                 int nq, int n, int n_valid, int dp, int B) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                         // [2][kCS][kStride]
  float* qs = smem + 2 * kCS * kStride;     // resident: [kQT][dp + 4];
                                            // streamed: [2][kQT][kStride]
  const int tid = threadIdx.x;
  const int tx = tid & 7;    // classes tx + 8 c
  const int ty = tid >> 3;   // queries ty + 32 r
  const int q0 = blockIdx.x * kQT;
  const int s0 = blockIdx.y * kCS;
  const int qstride = kResident ? dp + 4 : kStride;

  const int nch = (dp + kKC - 1) / kKC;
  const int NB = (n + B - 1) / B;
  const int total = NB * nch;
  // this thread's part of a staged chunk: row lrow (x), rows lrow + 32 r
  // (q), columns lcol .. lcol + 3
  const int lrow = tid >> 3;
  const int lcol = (tid & 7) * 4;

  if constexpr (kResident) {
    const int vpr = dp >> 2;
    for (int v = tid; v < kQT * vpr; v += kThreads) {
      const int row = v / vpr;
      const int col = (v - row * vpr) * 4;
      *reinterpret_cast<float4*>(qs + row * qstride + col) =
          grade<kBf16>(fetch4(q, nq, dp, q0 + row, col));
    }
  }

  float m1[4][4], m2[4][4];
  int i1[4][4], i2[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      m1[r][c] = kBig; i1[r][c] = 0;
      m2[r][c] = kBig; i2[r][c] = 0;
    }
  }

  // stage step 0
  float4 xpre = fetch4(x, n, dp, s0 + lrow, lcol);
  float4 qpre[4];
  *reinterpret_cast<float4*>(xs + lrow * kStride + lcol) = grade<kBf16>(xpre);
  if constexpr (!kResident) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      *reinterpret_cast<float4*>(qs + (lrow + 32 * r) * kStride + lcol) =
          grade<kBf16>(fetch4(q, nq, dp, q0 + lrow + 32 * r, lcol));
    }
  }
  __syncthreads();

  float acc[4][4];
  float snr[4];
  int j = 0, ch = 0;
  for (int t = 0; t < total; ++t) {
    const int cur = t & 1;
    // the next step's tile and chunk
    int nj = j, nc = ch + 1;
    if (nc == nch) { nc = 0; ++nj; }
    const bool more = t + 1 < total;
    if (more) {
      xpre = fetch4(x, n, dp, nj * B + s0 + lrow, nc * kKC + lcol);
      if constexpr (!kResident) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          qpre[r] = fetch4(q, nq, dp, q0 + lrow + 32 * r, nc * kKC + lcol);
        }
      }
    }
    if (ch == 0) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = j * B + s0 + tx + 8 * c;
        snr[c] = col < n_valid ? (sn != nullptr ? sn[col] : 0.f) : kBig;
      }
    }

    const int w = min(kKC, dp - ch * kKC);
    const float* xb = xs + cur * kCS * kStride;
    const float* qb = kResident ? qs + ch * kKC : qs + cur * kQT * kStride;
    for (int k = 0; k < w; k += 4) {
      float4 q4[4], x4[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        q4[r] = *reinterpret_cast<const float4*>(qb + (ty + 32 * r) * qstride + k);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        x4[c] = *reinterpret_cast<const float4*>(xb + (tx + 8 * c) * kStride + k);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[r][c] = __fmaf_rn(q4[r].x, x4[c].x, acc[r][c]);
          acc[r][c] = __fmaf_rn(q4[r].y, x4[c].y, acc[r][c]);
          acc[r][c] = __fmaf_rn(q4[r].z, x4[c].z, acc[r][c]);
          acc[r][c] = __fmaf_rn(q4[r].w, x4[c].w, acc[r][c]);
        }
      }
    }

    if (ch == nch - 1) {
      // the bins update of tile j
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = j * B + s0 + tx + 8 * c;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          // 2 * acc is exact, so this is sn - 2 dot rounded once
          const float s = __fmaf_rn(-2.f, acc[r][c], snr[c]);
          if constexpr (kDepth == 1) {
            if (s < m1[r][c]) { m1[r][c] = s; i1[r][c] = col; }
          } else if (s < m2[r][c]) {   // m1 <= m2: else nothing changes
            const bool b1 = s < m1[r][c];
            const float lose_v = b1 ? m1[r][c] : s;
            const int lose_i = b1 ? i1[r][c] : col;
            if (b1) { m1[r][c] = s; i1[r][c] = col; }
            if (lose_v < m2[r][c]) { m2[r][c] = lose_v; i2[r][c] = lose_i; }
          }
        }
      }
    }

    if (more) {
      const int nxt = cur ^ 1;
      *reinterpret_cast<float4*>(xs + (nxt * kCS + lrow) * kStride + lcol) =
          grade<kBf16>(xpre);
      if constexpr (!kResident) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          *reinterpret_cast<float4*>(qs + (nxt * kQT + lrow + 32 * r) * kStride + lcol) =
              grade<kBf16>(qpre[r]);
        }
      }
    }
    __syncthreads();
    j = nj; ch = nc;
  }

  const size_t width = (size_t)kDepth * B;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ty + 32 * r;
    if (qi >= nq) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const size_t o = (size_t)qi * width + s0 + tx + 8 * c;
      bins_v[o] = m1[r][c];
      bins_i[o] = i1[r][c];
      if constexpr (kDepth == 2) {
        bins_v[o + B] = m2[r][c];
        bins_i[o + B] = i2[r][c];
      }
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

size_t scan_smem(int dp, bool resident) {
  const size_t qf = resident ? (size_t)kQT * (dp + 4) : (size_t)2 * kQT * kStride;
  return ((size_t)2 * kCS * kStride + qf) * sizeof(float);
}

template <int kDepth, bool kBf16, bool kResident>
int launch_scan(const float* q, const float* x, const float* sn, float* bins_v,
                int* bins_i, int nq, int n, int n_valid, int dp, int B,
                cudaStream_t stream) {
  auto kern = flat_scan_kernel<kDepth, kBf16, kResident>;
  const size_t smem = scan_smem(dp, kResident);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nq + kQT - 1) / kQT, B / kCS);
  kern<<<grid, kThreads, smem, stream>>>(q, x, sn, bins_v, bins_i, nq, n,
                                         n_valid, dp, B);
  return (int)cudaGetLastError();
}

using ScanLaunch = decltype(&launch_scan<1, false, false>);
// [depth - 1][bf16 operands][query tile resident]
const ScanLaunch kScan[2][2][2] = {
    {{launch_scan<1, false, false>, launch_scan<1, false, true>},
     {launch_scan<1, true, false>, launch_scan<1, true, true>}},
    {{launch_scan<2, false, false>, launch_scan<2, false, true>},
     {launch_scan<2, true, false>, launch_scan<2, true, true>}},
};

}  // namespace

// K2 for one slab of queries: the scan into bins_v / bins_i ([nq, depth * B]
// scratch of the caller) and the extraction into out_d / out_i ([nq, kb]).
// Launches on `stream` and returns the first cudaError_t that is not 0. The
// caller validates: dp a multiple of 4, B a multiple of 32, depth 1 or 2,
// depth * B <= 4096, 1 <= kb <= depth * B, 16-byte aligned rows.
extern "C" int annsearch_flat_scan(
    const void* q, const void* x, const void* sn, const void* qadd,
    void* bins_v, void* bins_i, void* out_d, void* out_i,
    int nq, int n, int n_valid, int dp, int B, int depth, int kb, int bf16,
    void* stream) {
  if (nq <= 0) return 0;
  const bool resident = scan_smem(dp, true) <= 208 * 1024;
  const int err = kScan[depth - 1][bf16 != 0][resident](
      (const float*)q, (const float*)x, (const float*)sn, (float*)bins_v,
      (int*)bins_i, nq, n, n_valid, dp, B, (cudaStream_t)stream);
  if (err) return err;
  flat_extract_kernel<<<nq, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)bins_v, (const int*)bins_i, (const float*)qadd,
      (float*)out_d, (int*)out_i, depth * B, kb);
  return (int)cudaGetLastError();
}
