"""build_rows_per_s: rows indexed by the builds completed in the window,
over the window's whole length (host clock)."""

from portbench import stats


def read(ctx):
    if ctx.traffic["pattern"] != "build":
        return None
    return stats.rate(ctx.calls * ctx.work_per_call, ctx.window_s)
