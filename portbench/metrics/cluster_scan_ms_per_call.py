"""cluster_scan_ms_per_call: device self ms a call of the program's stage
``ivf.cluster_scan`` (``ops/ivf_scan.ivf_cluster_scan``'s steps; its merge,
stage ``ivf.merge``, left out), from its CUDA events."""

from portbench import spans

start = spans.start


def read(ctx):
    return spans.per_call(ctx, "ivf.cluster_scan", "device_self_ns", 1e-6)
