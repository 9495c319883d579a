"""exact_scan_roofline: the exact fallback's share of its roofline: each
call scores nq·n pairs (``roofline.flat_query_work``) at the bf16 rate,
against the device time of every operation of a traced call."""

from portbench import roofline
from portbench.trace import per_call_s


def read(ctx):
    peaks, s = roofline.peaks_for(ctx.kind), per_call_s(ctx)
    if peaks is None or not s:
        return None
    n, d = ctx.x.shape
    flop, nbytes = roofline.flat_query_work(ctx.traffic["batch"], n, d, ctx.cfg["k"])
    return roofline.share_pct(flop, nbytes, s, peaks["bf16_flop_s"], peaks["hbm_byte_s"])
