"""fallback_steps_per_call: (query block, database chunk) steps a call of the
program's stage ``topk.exact`` (``ops/topk.blocked_query_topk``), the exact
fallback's loop.

Retired: no entry of ``BENCHMARK.json`` names it, since on the card the
exact fallback runs ``topk.certified`` and never opens ``topk.exact``. The
file stays while ``tests/test_torch_tracing.py`` holds it to a snapshot."""

from portbench import spans

start = spans.start


def read(ctx):
    return spans.per_call(ctx, "topk.exact", "steps")
