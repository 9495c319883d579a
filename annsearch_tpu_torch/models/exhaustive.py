"""Exhaustive (flat) index: exact top-k by a full blocked scan. It is the
ground truth of the IVF main path, so it scores at ``"highest"`` precision:
an fp32 matmul with TF32 off.

Built from f64 numpy data, it keeps a host f64 copy: f64 queries then take
a 2k pool from the f32 scan and rescore it in f64 on the host
(``rescore_f64_pool``), as in the JAX package."""

from __future__ import annotations

from typing import Any

import torch

from ..ops.topk import DEFAULT_DB_CHUNK, DEFAULT_QUERY_BLOCK, blocked_query_topk
from .base import BaseIndex, host_f64

__all__ = ["ExhaustiveIndex"]


class ExhaustiveIndex(BaseIndex):
    """Flat index: exact top-k via full scan."""

    def __init__(self, mat: Any, metric: str = "euclidean", device="cuda"):
        super().__init__(mat, metric, device)
        self._x64 = host_f64(mat)

    def query(
        self,
        query_mat: Any,
        k: int,
        query_block: int = DEFAULT_QUERY_BLOCK,
        db_chunk: int = DEFAULT_DB_CHUNK,
        selector: str = "exact",
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Top-k ``(ids, dists)``; f64 queries to an index built from f64
        data answer at f64 grade (dists float64)."""
        q64 = self._f64_queries(query_mat)
        q = self._prep_queries(query_mat)
        k = self._clamp_k(k)
        kp = min(2 * k, self.n) if q64 is not None else k
        d, i = self._topk(q, kp, query_block, db_chunk, selector)
        if q64 is not None:
            return self._rescore_f64(q64, i, k)
        return i, d

    def generate_knn(
        self,
        k: int,
        query_block: int = DEFAULT_QUERY_BLOCK,
        db_chunk: int = DEFAULT_DB_CHUNK,
        selector: str = "exact",
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Self-query of every stored row (each row finds itself)."""
        d, i = self._topk(self.vectors, self._clamp_k(k), query_block, db_chunk, selector)
        return i, d

    def _topk(self, q, k, query_block, db_chunk, selector):
        return blocked_query_topk(
            q, self.vectors, k, self.metric, x_sqnorm=self.sqnorms,
            query_block=query_block, db_chunk=db_chunk, precision="highest",
            selector=selector,
        )
