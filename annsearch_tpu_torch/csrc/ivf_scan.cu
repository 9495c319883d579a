// IVF cell scan: one kernel template, three variants of the Pallas kernel
// annsearch_tpu/ops/ivf_scan_pallas.py (_scan_kernel / _scan_body, launched
// by _fused_cell_scan):
//
//   K1a      int8 residual cells ("i8dec_residual"), l2, depth-2 fold, one
//            bf16 query term (the IVF-PQ main path);
//   K1d-f32  f32 cells, l2 or cos_plain, depth-2 fold (IvfIndex, approx);
//   K1c-f32  f32 cells, l2 or cos_plain, exact selection (IvfIndex, the
//            recall-1.0 tier).
//
// What it computes, for task row r (segment s = task_seg[r], n = cnt[r]
// valid rows) and each query slot j < maxq (query id qid = lists[r, j]):
//   K1a:  qr = q[qid] - cent[s], qadd = sum(qr * qr), qk = bf16_rne(qr * scales)
//   f32:  qk = q[qid]; qadd = sum(q * q) (l2) or unused (cos_plain)
//   dot_l = sum_c qk[c] * cell[s, l, c]   l < seg    (f32 FFMA; for K1a the
//                                          int8 x bf16 products are exact)
//   dist  = max(qadd + sn[s, l] - 2 dot_l, 0) (l2) or 1 - dot_l (cos_plain);
//           lanes l >= n are 3e38
//   fold:  stride class t = l mod 128 keeps its best and runner-up over the
//          chunks c = 0 .. seg/128-1 in order, updated with a strict <; then
//          kb rounds of the lexicographic minimum (value, lane) over the 256
//          survivors, each round setting the entries equal to the winner to
//          3e38 (so short rows surface their 3e38 lanes in a fixed order)
//   exact: the kb lexicographically smallest (value, lane) pairs over the
//          valid lanes, then (3e38, 0) in every slot past n: the Pallas
//          extraction sets each emitted lane to 3e38 and so finds lane 0 in
//          every later round
// and writes out_d / out_i [R, maxq, kb]. A row with n == 0 writes
// (3e38, 0) everywhere, as the computation itself would.
//
// Bound on the H100: the multiply-adds, about (real query slots) x n x d per
// task row, done here on the CUDA cores in f32 (K1a's bf16 x int8 products
// are exact in bf16 MMA, so its bound is the bf16 tensor-core peak; the f32
// variants' is the fp32 peak). Each cell row is read from device memory
// once per block of 8 slots; f32 rows are 4x the bytes of int8 ones.
// Design: one block per (task row, 8 query slots), one warp per slot. The
// segment's rows are staged 128 at a time into shared memory as f32 and
// shared by the block's 8 warps; thread t of a warp owns lanes t, t+32,
// t+64, t+96 of each chunk and keeps its selection state in registers, so
// the [maxq, seg] distance tile never leaves the SM. The row stride in
// shared memory is padded by 4 floats, so the 128-bit loads of a
// quarter-warp fall in distinct banks.
//   fold:  each thread holds the (best, runner-up) of its 4 stride classes.
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

namespace {

constexpr int kLanes = 128;   // chunk width: stride classes per query
constexpr int kWarps = 8;     // query slots per block
constexpr int kThreads = kWarps * 32;
constexpr float kBig = 3.0e38f;
constexpr float kEmpty = 3.4028234663852886e38f;  // FLT_MAX: an empty exact slot

enum Epilogue { kL2 = 0, kCosPlain = 1 };

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

// stage rows [0, 128) of `src` ([128, dp] cells) into cell_s as f32
__device__ __forceinline__ void stage_chunk(const int8_t* src, float* cell_s,
                                            int dp, int stride) {
  const int vec_per_row = dp / 16;
  for (int v = threadIdx.x; v < kLanes * vec_per_row; v += kThreads) {
    const int row = v / vec_per_row;
    const int col = (v - row * vec_per_row) * 16;
    const int4 raw = *reinterpret_cast<const int4*>(src + (size_t)row * dp + col);
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
    float4* dst = reinterpret_cast<float4*>(cell_s + row * stride + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dst[e] = make_float4((float)b[4 * e], (float)b[4 * e + 1],
                           (float)b[4 * e + 2], (float)b[4 * e + 3]);
    }
  }
}

__device__ __forceinline__ void stage_chunk(const float* src, float* cell_s,
                                            int dp, int stride) {
  const int vec_per_row = dp / 4;
  for (int v = threadIdx.x; v < kLanes * vec_per_row; v += kThreads) {
    const int row = v / vec_per_row;
    const int col = (v - row * vec_per_row) * 4;
    *reinterpret_cast<float4*>(cell_s + row * stride + col) =
        *reinterpret_cast<const float4*>(src + (size_t)row * dp + col);
  }
}

template <typename CellT, bool kResidual, int kEpi, bool kExact>
__global__ void __launch_bounds__(kThreads)
ivf_scan_kernel(const int* __restrict__ lists,
                const int* __restrict__ task_seg,
                const int* __restrict__ cnt,
                const float* __restrict__ queries,
                const float* __restrict__ cents,   // K1a only
                const float* __restrict__ scales,  // K1a only
                const CellT* __restrict__ cells,
                const float* __restrict__ sn,
                float* __restrict__ out_d, int* __restrict__ out_i,
                int maxq, int seg, int d, int dp, int kb) {
  extern __shared__ __align__(16) float smem[];
  const int stride = dp + 4;
  float* cell_s = smem;                            // [kLanes][dp + 4]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* qk = smem + kLanes * stride + warp * dp;  // this warp's [dp]

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

  // prologue: this warp's query term (K1a: the bf16 residual) and norm
  float qadd = 0.f;
  if (active) {
    const int qid = lists[(size_t)r * maxq + j];
    const float* qrow = queries + (size_t)qid * d;
    for (int c = lane; c < dp; c += 32) {
      float v = 0.f;
      if (c < d) {
        if constexpr (kResidual) {
          const float qr = __fsub_rn(qrow[c], cents[(size_t)s * d + c]);
          qadd = __fadd_rn(qadd, __fmul_rn(qr, qr));
          v = __bfloat162float(__float2bfloat16_rn(__fmul_rn(qr, scales[c])));
        } else {
          v = qrow[c];
          if constexpr (kEpi == kL2) qadd = __fadd_rn(qadd, __fmul_rn(v, v));
        }
      }
      qk[c] = v;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      qadd += __shfl_xor_sync(0xffffffffu, qadd, o);
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
  const int nchunks = seg / kLanes;

  for (int ch = 0; ch < nchunks; ++ch) {
    __syncthreads();  // the previous chunk's reads are done (and qk written)
    stage_chunk(blk + (size_t)ch * kLanes * dp, cell_s, dp, stride);
    __syncthreads();
    if (!active) continue;

    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c = 0; c < dp; c += 4) {
      const float4 q4 = *reinterpret_cast<const float4*>(qk + c);
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
    float dist[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = ch * kLanes + lane + 32 * i;
      if constexpr (kEpi == kL2) {
        dist[i] = fmaxf(__fsub_rn(__fadd_rn(qadd, snr[l]), 2.f * acc[i]), 0.f);
      } else {
        dist[i] = __fsub_rn(1.f, acc[i]);
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
          if (lose_v < v2[i]) { v2[i] = lose_v; i2[i] = lose_i; }
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
        if (lex_less(v2[i], i2[i], bv, bi)) { bv = v2[i]; bi = i2[i]; }
      }
      warp_lex_min(bv, bi);
      if (lane == 0) {
        out_d[out_base + t] = bv;
        out_i[out_base + t] = bi;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (v1[i] == bv && i1[i] == bi) v1[i] = kBig;
        if (v2[i] == bv && i2[i] == bi) v2[i] = kBig;
      }
    }
  }
}

size_t smem_bytes(int dp) {
  return ((size_t)kLanes * (dp + 4) + (size_t)kWarps * dp) * sizeof(float);
}

template <typename CellT, bool kResidual, int kEpi, bool kExact>
int launch(const void* lists, const void* task_seg, const void* cnt,
           const void* queries, const void* cents, const void* scales,
           const void* cells, const void* sn, void* out_d, void* out_i,
           int R, int maxq, int seg, int d, int dp, int kb, void* stream) {
  auto kern = ivf_scan_kernel<CellT, kResidual, kEpi, kExact>;
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

}  // namespace

// Launches on `stream`; each returns the launch's cudaError_t (0 on
// success). The caller validates shapes, types, contiguity and alignment.

// K1a: int8 residual cells, l2, fold
extern "C" int annsearch_ivf_scan_k1a(
    const void* lists, const void* task_seg, const void* cnt,
    const void* queries, const void* cents, const void* scales,
    const void* cells, const void* sn, void* out_d, void* out_i,
    int R, int maxq, int seg, int d, int dp, int kb, void* stream) {
  return launch<int8_t, true, kL2, false>(
      lists, task_seg, cnt, queries, cents, scales, cells, sn, out_d, out_i,
      R, maxq, seg, d, dp, kb, stream);
}

// K1c-f32 (exact != 0) and K1d-f32 (fold): f32 cells, l2 or cos_plain
extern "C" int annsearch_ivf_scan_f32(
    const void* lists, const void* task_seg, const void* cnt,
    const void* queries, const void* cells, const void* sn, void* out_d,
    void* out_i, int R, int maxq, int seg, int d, int dp, int kb, int cosine,
    int exact, void* stream) {
  using Launch = decltype(&launch<float, false, kL2, false>);
  const Launch variants[2][2] = {
      {launch<float, false, kL2, false>, launch<float, false, kL2, true>},
      {launch<float, false, kCosPlain, false>,
       launch<float, false, kCosPlain, true>},
  };
  return variants[cosine != 0][exact != 0](
      lists, task_seg, cnt, queries, nullptr, nullptr, cells, sn, out_d, out_i,
      R, maxq, seg, d, dp, kb, stream);
}
