"""ivf_other_ms_per_call: device ms a call in every operation other than K1
(routing, task lists, the merge, copies), from the profiler's timeline."""

from portbench.trace import K1, per_call_s


def read(ctx):
    s = per_call_s(ctx, K1, exclude=True)
    return None if s is None else 1e3 * s
