"""fallback_host_ms_per_step: host ms of the program's stage ``topk.exact`` over
its steps (``ops/topk.blocked_query_topk``): what the host takes to launch one
(query block, database chunk) step, or to wait for the card.

Retired: no entry of ``BENCHMARK.json`` names it, since on the card the
exact fallback runs ``topk.certified`` and never opens ``topk.exact``. The
file stays while ``tests/test_torch_tracing.py`` holds it to a snapshot."""

from portbench import spans

start = spans.start


def read(ctx):
    ns, steps = spans.stat(ctx, "topk.exact", "host_ns"), spans.stat(ctx, "topk.exact", "steps")
    return None if ns is None or not steps else ns * 1e-6 / steps
