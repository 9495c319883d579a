// One tensor-core product of the scans on given operands, so that a test
// can read what the tensor cores keep of a sum: D = A B + C for P problems.
// mma_probe_kernel: one mma.sync m16n8k16 (mma_terms.cuh; no scan issues
// it), one warp a problem, A [P][16][16], Bt [P][8][16]
// (B transposed, as the scans hold database rows), C and D [P][16][8].
// wgmma_probe_kernel: one wgmma.mma_async m64n64k16 as K2's scan issues it
// (hopper.cuh: A from registers, B K-major in the 64-byte swizzle through
// its descriptor), one warpgroup a problem, A [P][64][16], Bt [P][64][16],
// C and D [P][64][64]. bf16 bits and f32. Not on any search path.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_terms.cuh"

namespace {

__global__ void mma_probe_kernel(const uint16_t* __restrict__ A,
                                 const uint16_t* __restrict__ Bt,
                                 const float* __restrict__ C, float* __restrict__ D) {
  const size_t p = blockIdx.x;
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const uint16_t* a = A + p * 256;
  const uint16_t* b = Bt + p * 128;
  // the operand fragments of m16n8k16 (PTX ISA): a[0] row g, columns 2t and
  // 2t + 1; a[1] row g + 8; a[2], a[3] the same 8 columns on; b[0] column
  // (of B) g, rows 2t and 2t + 1; b[1] 8 rows on
  const uint32_t af[4] = {
      mma::pack2(a[g * 16 + 2 * t], a[g * 16 + 2 * t + 1]),
      mma::pack2(a[(g + 8) * 16 + 2 * t], a[(g + 8) * 16 + 2 * t + 1]),
      mma::pack2(a[g * 16 + 2 * t + 8], a[g * 16 + 2 * t + 9]),
      mma::pack2(a[(g + 8) * 16 + 2 * t + 8], a[(g + 8) * 16 + 2 * t + 9]),
  };
  const uint32_t b0 = mma::pack2(b[g * 16 + 2 * t], b[g * 16 + 2 * t + 1]);
  const uint32_t b1 = mma::pack2(b[g * 16 + 2 * t + 8], b[g * 16 + 2 * t + 9]);
  const float* c = C + p * 128;
  float acc[4] = {c[g * 8 + 2 * t], c[g * 8 + 2 * t + 1], c[(g + 8) * 8 + 2 * t],
                  c[(g + 8) * 8 + 2 * t + 1]};
  mma::mma_bf16(acc, af, b0, b1);
  float* d = D + p * 128;
  d[g * 8 + 2 * t] = acc[0];
  d[g * 8 + 2 * t + 1] = acc[1];
  d[(g + 8) * 8 + 2 * t] = acc[2];
  d[(g + 8) * 8 + 2 * t + 1] = acc[3];
}

__global__ void wgmma_probe_kernel(const uint16_t* __restrict__ A,
                                   const uint16_t* __restrict__ Bt,
                                   const float* __restrict__ C, float* __restrict__ D) {
  // B's 64 rows of 16 columns in rows of 64 bytes (the last 32 bytes zero),
  // swizzled as TMA writes them
  __shared__ __align__(1024) uint16_t bs[64 * 32];
  const size_t p = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5, g = lane >> 2, t = lane & 3;
  const uint16_t* a = A + p * 64 * 16;
  const uint16_t* b = Bt + p * 64 * 16;
  for (int v = tid; v < 64 * 4; v += 128) {
    const int r = v >> 2, u = v & 3;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (u < 2) val = *reinterpret_cast<const uint4*>(b + r * 16 + u * 8);
    *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(bs) + hopper::sw64(r, u)) = val;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // for wgmma's reads
  __syncthreads();
  // warp w's rows 16 w .. 16 w + 15 in mma.sync's A fragment
  const int r0 = 16 * w + g, r1 = r0 + 8;
  const uint32_t af[4] = {
      mma::pack2(a[r0 * 16 + 2 * t], a[r0 * 16 + 2 * t + 1]),
      mma::pack2(a[r1 * 16 + 2 * t], a[r1 * 16 + 2 * t + 1]),
      mma::pack2(a[r0 * 16 + 2 * t + 8], a[r0 * 16 + 2 * t + 9]),
      mma::pack2(a[r1 * 16 + 2 * t + 8], a[r1 * 16 + 2 * t + 9]),
  };
  const float* c = C + p * 64 * 64;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int row = (i >> 1) & 1 ? r1 : r0, col = (i >> 2) * 8 + 2 * t + (i & 1);
    acc[i] = c[row * 64 + col];
  }
  hopper::wgmma_fence();
  hopper::wgmma_m64n64k16(acc, af, hopper::desc_sw64(bs), 1);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_operands(acc);
  float* d = D + p * 64 * 64;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int row = (i >> 1) & 1 ? r1 : r0, col = (i >> 2) * 8 + 2 * t + (i & 1);
    d[row * 64 + col] = acc[i];
  }
}

}  // namespace

// P problems of D = A B + C on `stream`; returns the launch's cudaError_t
extern "C" int annsearch_mma_probe(const void* A, const void* Bt, const void* C, void* D,
                                   int P, void* stream) {
  if (P <= 0) return 0;
  mma_probe_kernel<<<P, 32, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)A, (const uint16_t*)Bt, (const float*)C, (float*)D);
  return (int)cudaGetLastError();
}

// P problems of D = A B + C by wgmma on `stream`; returns the launch's
// cudaError_t
extern "C" int annsearch_wgmma_probe(const void* A, const void* Bt, const void* C, void* D,
                                     int P, void* stream) {
  if (P <= 0) return 0;
  wgmma_probe_kernel<<<P, 128, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)A, (const uint16_t*)Bt, (const float*)C, (float*)D);
  return (int)cudaGetLastError();
}
