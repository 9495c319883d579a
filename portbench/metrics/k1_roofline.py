"""k1_roofline: K1's share of its roofline. The work is the benchmark's own
count (``roofline.ivf_probe_work``): the real rows of each query's nprobe
nearest cells, the cell sizes recomputed from the data and the index's
centroids under the configuration's metric, so padding never counts; int8
codes are scored at the bf16 rate. Device time: K1's kernels in the traced
calls."""

from portbench import roofline
from portbench.trace import K1, per_call_s

CODE_BYTES = {"int8": 1, "bf16": 2, "float32": 4}


def read(ctx):
    peaks, s = roofline.peaks_for(ctx.kind), per_call_s(ctx, K1)
    if peaks is None or not s or ctx.index is None:
        return None
    cents, metric = ctx.index.centroids, ctx.cfg["metric"]
    sizes = roofline.nearest_centroid_sizes(ctx.x, cents, metric=metric)
    b, p = ctx.traffic["batch"], ctx.traffic["pool"]
    flop = nbytes = 0.0
    for i in ctx.traced_calls:
        a = (i * b) % p
        f, by = roofline.ivf_probe_work(ctx.pool[a : a + b], cents, sizes,
                                        ctx.cfg["query"]["kwargs"]["nprobe"],
                                        CODE_BYTES[ctx.cfg["precision"]], ctx.cfg["k"],
                                        metric)
        flop, nbytes = flop + f, nbytes + by
    n = len(ctx.traced_calls)
    return roofline.share_pct(flop / n, nbytes / n, s, peaks["bf16_flop_s"],
                              peaks["hbm_byte_s"])
