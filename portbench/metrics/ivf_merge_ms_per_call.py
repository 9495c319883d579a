"""ivf_merge_ms_per_call: device ms a call in the program's stage ``ivf.merge``
(``ops/ivf_scan_fused.regroup_topk``: the lanes gathered per query, the stable
sort, the gathers), the interval its CUDA events give."""

from portbench import spans

start = spans.start


def read(ctx):
    return spans.per_call(ctx, "ivf.merge", "device_ns", 1e-6)
