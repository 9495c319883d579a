"""qps: queries answered by the calls completed in the window, over the
window's whole length (host clock; each call ends in a synchronise)."""

from portbench import stats


def read(ctx):
    if ctx.traffic["pattern"] != "query":
        return None
    return stats.rate(ctx.calls * ctx.work_per_call, ctx.window_s)
