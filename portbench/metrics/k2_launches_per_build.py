"""k2_launches_per_build: the program's counter ``flat_topk_fused.launches``
(one a slab of K2) over the window, a build."""

from annsearch_tpu_torch.ops import flat_scan_fused


def start(ctx):
    ctx.cache["k2_launches_at_start"] = flat_scan_fused.flat_topk_fused.launches


def read(ctx):
    if not ctx.calls:
        return None
    return (flat_scan_fused.flat_topk_fused.launches - ctx.cache["k2_launches_at_start"]) / ctx.calls
