"""k2_roofline: K2's share of its roofline in a whole kNN-graph build: n·n
pairs of the data at the bf16 rate (``roofline.flat_self_knn_work``),
against the device time of K2's scan, extraction and merge kernels
(``csrc/flat_scan.cu``) a traced build."""

from portbench import roofline
from portbench.trace import K2, per_call_s


def read(ctx):
    peaks, s = roofline.peaks_for(ctx.kind), per_call_s(ctx, K2)
    if peaks is None or not s:
        return None
    n, d = ctx.x.shape
    flop, nbytes = roofline.flat_self_knn_work(n, d, ctx.cfg["k"])
    return roofline.share_pct(flop, nbytes, s, peaks["bf16_flop_s"], peaks["hbm_byte_s"])
