"""ivf_slot_use_pct: the share of the device task lists' slots that hold a real
(query, segment) pair: 100 · pairs / slots of the program's stage ``ivf.lists``
over the window."""

from portbench import spans

start = spans.start


def read(ctx):
    return spans.share_pct(ctx, "ivf.lists", "pairs", "slots")
