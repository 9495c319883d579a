"""Exhaustive (flat) index: exact top-k by a full blocked scan. It is the
ground truth of the IVF main path, so it scores at ``"highest"`` precision:
an fp32 matmul with TF32 off."""

from __future__ import annotations

from typing import Any

import torch

from ..ops.topk import DEFAULT_DB_CHUNK, DEFAULT_QUERY_BLOCK, blocked_query_topk
from .base import BaseIndex

__all__ = ["ExhaustiveIndex"]


class ExhaustiveIndex(BaseIndex):
    """Flat index: exact top-k via full scan."""

    def __init__(self, mat: Any, metric: str = "euclidean", device="cuda"):
        super().__init__(mat, metric, device)

    def query(
        self,
        query_mat: Any,
        k: int,
        query_block: int = DEFAULT_QUERY_BLOCK,
        db_chunk: int = DEFAULT_DB_CHUNK,
        selector: str = "exact",
    ) -> tuple[torch.Tensor, torch.Tensor]:
        q = self._prep_queries(query_mat)
        d, i = blocked_query_topk(
            q, self.vectors, self._clamp_k(k), self.metric,
            x_sqnorm=self.sqnorms, query_block=query_block,
            db_chunk=db_chunk, precision="highest", selector=selector,
        )
        return i, d
