"""index_bytes_per_vec: device bytes of every tensor the index object holds
(its attributes, one level into lists, tuples and dicts, each storage
counted once, whole), over the rows indexed. Counted by the benchmark, not
by the program's own ``memory_usage_bytes``."""

from portbench import stats


def read(ctx):
    if ctx.index is None:
        return None
    return stats.held_bytes(ctx.index, ctx.device) / ctx.x.shape[0]
