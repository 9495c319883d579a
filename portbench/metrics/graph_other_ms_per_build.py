"""graph_other_ms_per_build: device ms a build outside K2 (the norms, the
wrapper's tensor code, the self-query), from the profiler's timeline."""

from portbench.trace import K2, per_call_s


def read(ctx):
    s = per_call_s(ctx, K2, exclude=True)
    return None if s is None else 1e3 * s
