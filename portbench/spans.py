"""The program's stage spans (``annsearch_tpu_torch.utils.profiling``) for
the per-layer readers that read them.

Such a reader's ``start`` is :func:`start`: the first call of a run turns
the program's tracing on and clears its aggregates, so that they cover the
window's calls alone. Readers are loaded only in a traced run, so the runs
whose end-to-end metrics are judged keep tracing off. :func:`stat` reads
one stage's aggregate from one ``snapshot()`` taken after the window. Where
the program has no stage recorder (an older checkout), both find nothing:
the metric is left out and nothing raises.
"""

from __future__ import annotations

__all__ = ["start", "stat", "per_call", "share_pct"]


def start(ctx) -> None:
    if "spans" in ctx.cache:
        return
    from annsearch_tpu_torch.utils import profiling

    ok = all(hasattr(profiling, f) for f in ("enable", "disable", "reset", "snapshot"))
    ctx.cache["spans"] = profiling if ok else None
    if ok:
        profiling.reset()
        profiling.enable()


def stat(ctx, name: str, field: str):
    """``field`` of stage ``name``'s aggregate over the window (one of its
    counts where the aggregate has no such field), or None where the
    program recorded none."""
    if "spans_snapshot" not in ctx.cache:
        prof = ctx.cache.get("spans")
        if prof is not None:
            prof.disable()
        ctx.cache["spans_snapshot"] = {} if prof is None else prof.snapshot()
    st = ctx.cache["spans_snapshot"].get(name)
    if st is None:
        return None
    return st[field] if field in st else st["counts"].get(field)


def per_call(ctx, name: str, field: str, scale: float = 1.0):
    """``field`` of stage ``name`` a completed call of the window, times
    ``scale``."""
    v = stat(ctx, name, field)
    return None if v is None or not ctx.calls else v * scale / ctx.calls


def share_pct(ctx, name: str, part: str, whole: str):
    """100 · ``part`` / ``whole`` of stage ``name``'s counts."""
    a, b = stat(ctx, name, part), stat(ctx, name, whole)
    return None if a is None or not b else 100.0 * a / b
