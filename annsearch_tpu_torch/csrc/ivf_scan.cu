// IVF cell scan, variant K1a: int8 residual cells ("i8dec_residual"), l2
// epilogue, depth-2 stride-class fold, one bf16 query term.
//
// Replaces the Pallas kernel annsearch_tpu/ops/ivf_scan_pallas.py
// (_scan_kernel / _scan_body, launched by _fused_cell_scan) in that variant.
//
// What it computes, for task row r (segment s = task_seg[r], n = cnt[r]
// valid rows) and each query slot j < maxq (query id qid = lists[r, j]):
//   qr    = q[qid] - cent[s]                         (f32)
//   qadd  = sum(qr * qr)                             (f32)
//   qk    = bf16_rne(qr * scales)
//   dot_l = sum_c qk[c] * cell[s, l, c]   l < seg    (int8 x bf16 is exact
//                                                     in f32; f32 sums)
//   dist  = max(qadd + sn[s, l] - 2 dot_l, 0); lanes l >= n are 3e38
//   fold: stride class t = l mod 128 keeps its best and runner-up over the
//         chunks c = 0 .. seg/128-1 in order, updated with a strict <
//   out:  kb rounds of the lexicographic minimum (value, lane) over the 256
//         survivors; each round sets the entries equal to the winner to 3e38
// and writes out_d / out_i [R, maxq, kb]. A row with n == 0 writes
// (3e38, 0) everywhere, as the computation itself would.
//
// Bound on the H100: about R*maxq*seg*d multiply-adds (1.3e11 at the
// 1M x 128d main path with nprobe 16), done here on the CUDA cores in f32.
// Design: one block per (task row, 8 query slots), one warp per slot. The
// segment's int8 rows are staged 128 at a time into shared memory, converted
// to f32 once per block and shared by its 8 warps; thread t of a warp owns
// stride classes t, t+32, t+64, t+96 and keeps their fold state in
// registers, so the [maxq, seg] distance tile never leaves the SM. The row
// stride in shared memory is padded by 4 floats, so the 128-bit loads of a
// quarter-warp fall in distinct banks. Tensor-core MMA (wgmma) and TMA
// staging are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;   // fold width: stride classes per query
constexpr int kWarps = 8;     // query slots per block
constexpr int kThreads = kWarps * 32;
constexpr float kBig = 3.0e38f;

__device__ __forceinline__ bool lex_less(float va, int ia, float vb, int ib) {
  return va < vb || (va == vb && ia < ib);
}

__global__ void __launch_bounds__(kThreads)
ivf_scan_k1a_kernel(const int* __restrict__ lists,
                    const int* __restrict__ task_seg,
                    const int* __restrict__ cnt,
                    const float* __restrict__ queries,
                    const float* __restrict__ cents,
                    const float* __restrict__ scales,
                    const int8_t* __restrict__ cells,
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

  // prologue: this warp's query residual, its norm and the bf16 query term
  float qadd = 0.f;
  if (active) {
    const int qid = lists[(size_t)r * maxq + j];
    const float* qrow = queries + (size_t)qid * d;
    const float* crow = cents + (size_t)s * d;
    for (int c = lane; c < dp; c += 32) {
      float v = 0.f;
      if (c < d) {
        const float qr = __fsub_rn(qrow[c], crow[c]);
        qadd = __fadd_rn(qadd, __fmul_rn(qr, qr));
        v = __bfloat162float(__float2bfloat16_rn(__fmul_rn(qr, scales[c])));
      }
      qk[c] = v;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      qadd += __shfl_xor_sync(0xffffffffu, qadd, o);
    }
  }

  float v1[4], v2[4];
  int i1[4], i2[4];
  const int8_t* blk = cells + (size_t)s * seg * dp;
  const float* snr = sn + (size_t)s * seg;
  const int vec_per_row = dp / 16;
  const int nchunks = seg / kLanes;

  for (int ch = 0; ch < nchunks; ++ch) {
    __syncthreads();  // the previous chunk's reads are done (and qk written)
    const int8_t* src = blk + (size_t)ch * kLanes * dp;
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
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = ch * kLanes + lane + 32 * i;
      float dist = fmaxf(__fsub_rn(__fadd_rn(qadd, snr[l]), 2.f * acc[i]), 0.f);
      if (l >= n_valid) dist = kBig;
      if (ch == 0) {
        v1[i] = dist; i1[i] = l; v2[i] = kBig; i2[i] = 0;
      } else {
        const bool upd = dist < v1[i];
        const float lose_v = upd ? v1[i] : dist;
        const int lose_i = upd ? i1[i] : l;
        if (upd) { v1[i] = dist; i1[i] = l; }
        if (lose_v < v2[i]) { v2[i] = lose_v; i2[i] = lose_i; }
      }
    }
  }
  if (!active) return;

  // extraction: kb rounds of a warp-wide lexicographic arg-min
  for (int t = 0; t < kb; ++t) {
    float bv = v1[0];
    int bi = i1[0];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (lex_less(v1[i], i1[i], bv, bi)) { bv = v1[i]; bi = i1[i]; }
      if (lex_less(v2[i], i2[i], bv, bi)) { bv = v2[i]; bi = i2[i]; }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (lex_less(ov, oi, bv, bi)) { bv = ov; bi = oi; }
    }
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

}  // namespace

extern "C" size_t annsearch_ivf_scan_k1a_smem(int dp) {
  return ((size_t)kLanes * (dp + 4) + (size_t)kWarps * dp) * sizeof(float);
}

// Launch on `stream`; returns the launch's cudaError_t (0 on success). The
// caller validates shapes, types, contiguity and alignment.
extern "C" int annsearch_ivf_scan_k1a(
    const void* lists, const void* task_seg, const void* cnt,
    const void* queries, const void* cents, const void* scales,
    const void* cells, const void* sn, void* out_d, void* out_i,
    int R, int maxq, int seg, int d, int dp, int kb, void* stream) {
  const size_t smem = annsearch_ivf_scan_k1a_smem(dp);
  cudaError_t err = cudaFuncSetAttribute(
      ivf_scan_k1a_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(R, (maxq + kWarps - 1) / kWarps);
  ivf_scan_k1a_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)lists, (const int*)task_seg, (const int*)cnt,
      (const float*)queries, (const float*)cents, (const float*)scales,
      (const int8_t*)cells, (const float*)sn, (float*)out_d, (int*)out_i,
      maxq, seg, d, dp, kb);
  return (int)cudaGetLastError();
}
