// One mma.sync of the scans' products (mma_terms.cuh) on given operands,
// so that a test can read what the tensor cores keep of a sum: D = A B + C
// for P problems, one warp each. A [P][16][16] and Bt [P][8][16] (B
// transposed, as the scans hold database rows) are bf16 bits, C and D
// [P][16][8] f32. Not on any search path.

#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace

// P problems of D = A B + C on `stream`; returns the launch's cudaError_t
extern "C" int annsearch_mma_probe(const void* A, const void* Bt, const void* C, void* D,
                                   int P, void* stream) {
  if (P <= 0) return 0;
  mma_probe_kernel<<<P, 32, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)A, (const uint16_t*)Bt, (const float*)C, (float*)D);
  return (int)cudaGetLastError();
}
