"""idle_pct: the share of the traced stretch of the window in which no
kernel, copy or memset ran on the card (profiler timeline). Read for both
``idle_pct.query`` and ``idle_pct.build``."""

from portbench import stats


def read(ctx):
    t = ctx.timeline
    if t is None or t.window_s <= 0.0:
        return None
    return stats.idle_pct(t.busy_s, t.window_s)
