"""Running top-k over database tiles (port of ``annsearch_tpu.ops.topk``,
``"exact"`` selector only).

Queries stream through in blocks, the database in chunks; each chunk's
local top-k merges into a running ``[bq, k]`` (distance, index) state, so
``[nq, n]`` is never materialised. All results are ascending; ties go to
the lower index, as ``lax.top_k`` breaks them.
"""

from __future__ import annotations

import torch

from ..utils.dist import Dist, pairwise_dist, sq_norms

__all__ = [
    "topk_smallest",
    "merge_topk",
    "chunked_topk",
    "blocked_query_topk",
    "DEFAULT_DB_CHUNK",
    "DEFAULT_QUERY_BLOCK",
]

DEFAULT_DB_CHUNK = 16384
DEFAULT_QUERY_BLOCK = 1024


def topk_smallest(d: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k smallest along the last axis, ascending, ties to the
    lower index (a stable sort: ``torch.topk`` promises no tie order).
    Returns (vals, idx)."""
    vals, idx = torch.sort(d, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def merge_topk(d_a, i_a, d_b, i_b, k: int):
    """Merge two (dists, idx) top-k sets along the last axis → best k."""
    vals, pos = topk_smallest(torch.cat([d_a, d_b], dim=-1), k)
    return vals, torch.gather(torch.cat([i_a, i_b], dim=-1), -1, pos)


def chunked_topk(
    q: torch.Tensor,
    x: torch.Tensor,
    k: int,
    metric: Dist,
    x_sqnorm: torch.Tensor | None = None,
    db_chunk: int = DEFAULT_DB_CHUNK,
    precision: str = "highest",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k nearest rows of ``x`` for one query block; ``(dists [bq, k],
    indices [bq, k])`` ascending."""
    n = x.shape[0]
    if metric == Dist.EUCLIDEAN and x_sqnorm is None:
        x_sqnorm = sq_norms(x)
    bq = q.shape[0]
    best_d = torch.full((bq, k), float("inf"), device=q.device)
    best_i = torch.zeros((bq, k), dtype=torch.int64, device=q.device)
    for base in range(0, n, db_chunk):
        xc = x[base : base + db_chunk]
        xs = None if x_sqnorm is None else x_sqnorm[base : base + db_chunk]
        d = pairwise_dist(q, xc, metric, x_sqnorm=xs, precision=precision)
        # per-chunk selection: torch.topk is far cheaper than a full sort of
        # the chunk; the tie order it leaves matters only for exact ties
        # at the chunk's k-th rank
        kk = min(k, xc.shape[0])
        cd, ci = torch.topk(d, kk, dim=-1, largest=False, sorted=True)
        best_d, best_i = merge_topk(best_d, best_i, cd, base + ci, k)
    return best_d, best_i


def blocked_query_topk(
    q: torch.Tensor,
    x: torch.Tensor,
    k: int,
    metric: Dist,
    x_sqnorm: torch.Tensor | None = None,
    query_block: int = DEFAULT_QUERY_BLOCK,
    db_chunk: int = DEFAULT_DB_CHUNK,
    precision: str = "highest",
    selector: str = "exact",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k for any number of queries, streamed in query blocks."""
    if selector != "exact":
        raise NotImplementedError(
            f"selector={selector!r} is not ported yet: 'fused' needs kernel "
            "K2 (ROADMAP Queue 2), 'bins' and 'approx' come with it"
        )
    parts = [
        chunked_topk(
            q[s : s + query_block], x, k, metric, x_sqnorm=x_sqnorm,
            db_chunk=db_chunk, precision=precision,
        )
        for s in range(0, q.shape[0], query_block)
    ]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
