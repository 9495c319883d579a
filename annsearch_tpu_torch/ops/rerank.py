"""Exact reranking of gathered candidates (port of the part of
``annsearch_tpu.ops.rerank`` that the tree and LSH indexes take).

A cheap stage proposes candidates (the leaves of a forest, the leaves of
a ball tree, random rows for LSH's empty-bucket fallback), their f32 rows
are gathered, and one batched FP32 product (TF32 off: the JAX package's
HIGHEST) scores them exactly before a deduplicated top-k.

Not ported: ``rerank_exact_split`` (bf16 hi/lo tables that cheapen the
TPU's gathers; off the TPU the JAX package takes ``rerank_exact`` too) and
``rerank_from_store``, which comes with the binary index family (ROADMAP
P3).
"""

from __future__ import annotations

import torch

from ..utils.dist import Dist, fp32_matmul, sq_norms

__all__ = ["rerank_exact"]


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
