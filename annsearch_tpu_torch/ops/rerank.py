"""Exact reranking of gathered candidates (port of
``annsearch_tpu.ops.rerank``).

A cheap stage proposes candidates (the leaves of a forest, the leaves of
a ball tree, random rows for LSH's empty-bucket fallback, the Hamming or
RaBitQ scan of a binary index), their f32 rows are gathered, and one
batched FP32 product (TF32 off: the JAX package's HIGHEST) scores them
exactly before a deduplicated top-k. ``rerank_from_store`` gathers from a
device-resident tensor or a store object (``models.binary.vec_store``) in
query blocks.

Not ported: ``rerank_exact_split`` (bf16 hi/lo tables that cheapen the
TPU's gathers; off the TPU the JAX package takes ``rerank_exact`` too).
"""

from __future__ import annotations

import torch

from ..utils.dist import Dist, fp32_matmul, sq_norms

__all__ = ["rerank_exact", "rerank_from_store"]


def _dedup_select(
    ids: torch.Tensor, d: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of ``(d, ids)`` with duplicate ids dropped: candidates sorted
    by (id, distance), every copy of an id after its best set to +inf, then
    the k smallest (ties to the lower sorted position, as ``lax.top_k``).
    Returns ``(dists, ids)`` of width ``min(k, kc)``."""
    by_d = torch.sort(d, dim=-1, stable=True).indices
    ids_d = torch.gather(ids, -1, by_d)
    by_id = torch.sort(ids_d, dim=-1, stable=True).indices
    order = torch.gather(by_d, -1, by_id)
    s_ids = torch.gather(ids, -1, order)
    s_d = torch.gather(d, -1, order)
    dup = torch.zeros_like(s_ids, dtype=torch.bool)
    dup[..., 1:] = s_ids[..., 1:] == s_ids[..., :-1]
    s_d = torch.where(dup, float("inf"), s_d)
    pos = torch.sort(s_d, dim=-1, stable=True).indices[..., : min(k, s_d.shape[-1])]
    return torch.gather(s_d, -1, pos), torch.gather(s_ids, -1, pos)


def rerank_exact(
    q: torch.Tensor,          # [nq, d] (normalised if cosine)
    cand_vecs: torch.Tensor,  # [nq, kc, d] gathered f32 candidate rows
    cand_ids: torch.Tensor,   # [nq, kc] ids
    valid: torch.Tensor,      # [nq, kc] bool
    k: int,
    metric: Dist,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact distances to the candidates, deduplicated top-k ascending →
    ``(dists, ids)``. The dots are FP32 with TF32 off: an exact rerank must
    be exact at f32 grade."""
    with fp32_matmul():
        dots = torch.bmm(cand_vecs.float(), q.float()[:, :, None])[:, :, 0]
    if metric == Dist.COSINE:
        vn = torch.sqrt(torch.clamp(sq_norms(cand_vecs), min=1e-30))
        d = 1.0 - dots / vn
    else:
        d = torch.clamp(sq_norms(q)[:, None] + sq_norms(cand_vecs) - 2.0 * dots, min=0.0)
    d = torch.where(valid, d, float("inf"))
    return _dedup_select(cand_ids.long(), d, k)


def rerank_from_store(
    q: torch.Tensor,        # [nq, d] (normalised if cosine)
    cand_d: torch.Tensor,   # [nq, kc] scan distances (inf = invalid slot)
    cand_i: torch.Tensor,   # [nq, kc] row positions into ``store``
    store,                  # [n, d] f32 device-resident rows, or a store with .gather / .n
    k: int,
    metric: Dist,
    qb: int = 512,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact rerank from a store: per block of ``qb`` queries, gather the
    candidates' rows (ids clamped into the store; a store object's
    ``gather`` returns them on the queries' device) and
    :func:`rerank_exact` them, the slots whose scan distance is not finite
    masked. Returns ``(dists [nq, k'], ids [nq, k'])``, ``k' = min(k,
    kc)``, ids the clamped positions."""
    if torch.is_tensor(store):
        n, gather = store.shape[0], store.__getitem__
    else:
        n, gather = store.n, store.gather
    ds, is_ = [], []
    for s in range(0, q.shape[0], qb):
        ii = torch.clamp(cand_i[s : s + qb].long(), 0, n - 1)
        d, i = rerank_exact(q[s : s + qb], gather(ii), ii,
                            torch.isfinite(cand_d[s : s + qb]), k, metric)
        ds.append(d)
        is_.append(i)
    return torch.cat(ds), torch.cat(is_)
