"""fallback_steps_per_call: (query block, database chunk) steps a call of the
program's stage ``topk.exact`` (``ops/topk.blocked_query_topk``), the exact
fallback's loop."""

from portbench import spans

start = spans.start


def read(ctx):
    return spans.per_call(ctx, "topk.exact", "steps")
