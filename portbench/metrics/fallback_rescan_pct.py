"""fallback_rescan_pct: the share of the exact fallback's queries that K2's
certificate did not settle and that were rescanned over their colliding
column classes: 100 · rescanned / queries of the program's stage
``topk.certified`` (``ops/topk.blocked_query_topk(selector="certified")``)
over the window."""

from portbench import spans

start = spans.start


def read(ctx):
    return spans.share_pct(ctx, "topk.certified", "rescanned", "queries")
