"""cluster_scan_pad_pct: the share of the cluster scan's scored lanes that are
padding (slots holding the sentinel query, rows past their segment's count):
100 · pad_lanes / lanes of the program's stage ``ivf.cluster_scan``."""

from portbench import spans

start = spans.start


def read(ctx):
    return spans.share_pct(ctx, "ivf.cluster_scan", "pad_lanes", "lanes")
