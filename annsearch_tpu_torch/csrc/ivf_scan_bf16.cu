// K1-bf16-decode: the K1 template (ivf_scan.cu) over bf16 cells under the
// int8-decode prologues and epilogues that K1a-bf16 does not take, as the
// Pallas _scan_kernel takes any cell type under every mode: mode "i8dec"
// (the scaled query, no centroids; l2 or cos_renorm), mode
// "i8dec_residual" under cos_renorm (the scaled query, qadd = q . centroid),
// and the residual l2 with one bf16 query term; one or two query terms,
// every selection. Its own source so that these 42 kernels (21 launchers,
// each with the query terms whole or a stage at a time) compile beside
// ivf_scan.cu's 90, not after them. Their arithmetic is ivf_scan.cu's: a
// bf16 cell enters the products as it is (one term), the query as one or
// two bf16 terms of the mantissa split; bound, design and layout as there.

#define ANNSEARCH_IVF_SCAN_TEMPLATE_ONLY
#include "ivf_scan.cu"

namespace {

using Bf16 = __nv_bfloat16;

// mode i8dec: [cosine][split][sel]
const Launch* const kBf16I8dec[2][2] = {
    {kBySel<Bf16, kScaled, kL2, false>, kBySel<Bf16, kScaled, kL2, true>},
    {kBySel<Bf16, kScaled, kCosRenorm, false>, kBySel<Bf16, kScaled, kCosRenorm, true>},
};
// mode i8dec_residual under cos_renorm: [split][sel]
const Launch* const kBf16ResidualCos[2] = {kBySel<Bf16, kScaledCent, kCosRenorm, false>,
                                           kBySel<Bf16, kScaledCent, kCosRenorm, true>};
// mode i8dec_residual, l2, one query term: [sel]
const Launch* const kBf16ResidualOne = kBySel<Bf16, kResidual, kL2, false>;

}  // namespace

// K1-bf16-decode: bf16 cells; `residual` 1 for mode i8dec_residual (with
// `cents`), 0 for mode i8dec (cents unused); `cosine` cos_renorm, else l2;
// `split` two query terms, else one; `sel` as the other entries. The
// residual l2 with two terms is K1a-bf16 (annsearch_ivf_scan_k1a_bf16) and
// is refused here. Other arguments as annsearch_ivf_scan_k1a_bf16.
extern "C" int annsearch_ivf_scan_bf16_decode(
    const void* lists, const void* task_seg, const void* cnt,
    const void* queries, const void* cents, const void* scales,
    const void* cells, const void* sn, void* out_d, void* out_i,
    int R, int maxq, int seg, int d, int dp, int kb, int residual, int cosine, int split,
    int sel, void* stream, int nblk, int nq1, void* scratch, size_t scratch_bytes) {
  if (bad_sel(sel, seg)) return bad_sel(sel, seg);
  Launch fn;
  if (!residual) {
    fn = kBf16I8dec[cosine != 0][split != 0][sel];
  } else if (cosine) {
    fn = kBf16ResidualCos[split != 0][sel];
  } else if (!split) {
    fn = kBf16ResidualOne[sel];
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return fn(lists, task_seg, cnt, queries, residual ? cents : nullptr, scales, cells, sn, out_d,
            out_i, R, maxq, seg, d, dp, kb, stream, nblk, nq1, scratch, scratch_bytes);
}
