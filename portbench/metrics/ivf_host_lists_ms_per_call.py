"""ivf_host_lists_ms_per_call: host ms a call in the program's stage
``ivf.host_lists`` (the cluster scan's lists of split cells: the probes read
back, expanded and inverted in numpy, the lists copied to the card)."""

from portbench import spans

start = spans.start


def read(ctx):
    return spans.per_call(ctx, "ivf.host_lists", "host_ns", 1e-6)
