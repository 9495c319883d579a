"""Flat (exhaustive-scan) quantised indexes (port of
``annsearch_tpu.models.quantised.flat``): bf16, SQ8, PQ and OPQ storage,
each scanned in full by its ``ops.quantised`` scan. Self-queries decode the
storage and query it.

Queries go through in blocks sized from a memory budget (the distance
tiles of one block and one chunk of rows), not a fixed count; the block
changes no result. Quantised storage keeps no f64 copy: f64 input is cast
to f32.
"""

from __future__ import annotations

from typing import Any

import torch

from ...ops.quantised import chunked_topk_bf16, chunked_topk_pq, chunked_topk_sq8
from ...utils.dist import fp32_matmul, sq_norms
from ..base import BaseIndex
from .quantisers import OptimisedProductQuantiser, ProductQuantiser, ScalarQuantiser

__all__ = [
    "ExhaustiveIndexBf16",
    "ExhaustiveSq8Index",
    "ExhaustivePqIndex",
    "ExhaustiveOpqIndex",
]

#: bytes of one query block's per-chunk work (distances, keys, masks: about
#: 24 bytes a pair) — with the scans' chunk of 16,384 rows, 5,461 queries
QUERY_BUDGET = 2 << 30
_DB_CHUNK = 16384


class _QuantisedFlat(BaseIndex):
    """Shared query blocking and clamping of the flat quantised indexes."""

    def _blocked(self, q: torch.Tensor, k: int, query_block: int | None, scan):
        """``(ids, dists)`` of ``scan(block) → (dists, ids)`` over blocks of
        ``query_block`` queries (default: from ``QUERY_BUDGET``)."""
        qb = query_block or max(1, QUERY_BUDGET // (24 * _DB_CHUNK))
        parts = [scan(q[s : s + qb]) for s in range(0, q.shape[0], qb)]
        return torch.cat([p[1] for p in parts]), torch.cat([p[0] for p in parts])

    def generate_knn(self, k: int, **kw):
        """Self-query of the decoded rows (each row finds its own code)."""
        return self.query(self._decoded_queries(), k, **kw)

    def vectors_original_order(self) -> torch.Tensor:
        return self._decoded_queries()

    def _decoded_queries(self) -> torch.Tensor:
        raise NotImplementedError


class ExhaustiveIndexBf16(_QuantisedFlat):
    """Flat scan over bf16 rows (the query rounded to bf16, f32 sums)."""

    _state_arrays = ("vectors", "sqnorms")

    def __init__(self, mat: Any, metric: str = "euclidean", device="cuda"):
        super().__init__(mat, metric, device)
        self.vectors = self.vectors.to(torch.bfloat16)
        # norms of the stored (rounded) rows, so that ‖q‖² + ‖x‖² − 2q·x
        # is the distance to the bf16 reconstruction
        self.sqnorms = sq_norms(self.vectors.float())

    def query(self, query_mat: Any, k: int, query_block: int | None = None):
        q = self._prep_queries(query_mat)
        k = self._clamp_k(k)
        return self._blocked(q, k, query_block, lambda b: chunked_topk_bf16(
            b, self.vectors, self.sqnorms, k, self.metric, self.n, _DB_CHUNK))

    def _decoded_queries(self) -> torch.Tensor:
        return self.vectors.float()

    @classmethod
    def load(cls, path: str, device="cuda") -> "ExhaustiveIndexBf16":
        """Load an index saved by either package's ``save`` (npz; the bf16
        rows are saved as f32 and cast back)."""
        from ...interop import exhaustive_bf16_from_jax_arrays

        return exhaustive_bf16_from_jax_arrays(*cls._read_npz(path, cls.__name__), device)


class ExhaustiveSq8Index(_QuantisedFlat):
    """Flat int8 scan: the query encoded with the rows' scales, distances in
    integer space (euclidean ``Σ(q̂ − ĉ)²``, cosine ``1 − q̂·ĉ /
    (‖q̂‖‖ĉ‖)``), bit for bit the JAX package's."""

    _state_arrays = ("codes", "code_sqnorms", "scales")

    def __init__(self, mat: Any, metric: str = "euclidean", device="cuda"):
        super().__init__(mat, metric, device)
        self.quantiser = ScalarQuantiser.train(self.vectors)
        self.scales = self.quantiser.scales
        self.codes = self.quantiser.encode(self.vectors)
        c32 = self.codes.int()
        self.code_sqnorms = (c32 * c32).sum(dim=-1, dtype=torch.int32)
        self.vectors = self.sqnorms = None    # compressed storage only

    def query(self, query_mat: Any, k: int, query_block: int | None = None):
        q_i8 = self.quantiser.encode(self._prep_queries(query_mat))
        k = self._clamp_k(k)
        return self._blocked(q_i8, k, query_block, lambda b: chunked_topk_sq8(
            b, self.codes, self.code_sqnorms, k, self.metric, self.n, _DB_CHUNK))

    def _decoded_queries(self) -> torch.Tensor:
        return self.quantiser.decode(self.codes)

    @classmethod
    def load(cls, path: str, device="cuda") -> "ExhaustiveSq8Index":
        """Load an index saved by either package's ``save`` (npz)."""
        from ...interop import exhaustive_sq8_from_jax_arrays

        return exhaustive_sq8_from_jax_arrays(*cls._read_npz(path, cls.__name__), device)


class ExhaustivePqIndex(_QuantisedFlat):
    """Flat scan over PQ codes: each chunk decoded, scored by one product
    (the same reconstruction as an ADC table, see ``ops.quantised``)."""

    _state_arrays = ("codes", "code_sqnorms", "codebooks")
    _state_scalars = ("n", "dim", "m")

    def __init__(self, mat: Any, m: int = 16, metric: str = "euclidean", seed: int = 42,
                 device="cuda"):
        super().__init__(mat, metric, device)
        self.m = m
        self.quantiser = ProductQuantiser.train(self.vectors, m, seed=seed)
        self.codebooks = self.quantiser.codebooks
        self.codes = self.quantiser.encode(self.vectors)
        self.code_sqnorms = self.quantiser.code_sqnorms(self.codes)
        self.vectors = self.sqnorms = None

    def query(self, query_mat: Any, k: int, query_block: int | None = None):
        q = self._code_space(self._prep_queries(query_mat))
        k = self._clamp_k(k)
        return self._blocked(q, k, query_block, lambda b: chunked_topk_pq(
            b, self.codes, self.code_sqnorms, self.codebooks, k, self.metric, self.n,
            _DB_CHUNK))

    def _code_space(self, q: torch.Tensor) -> torch.Tensor:
        return q

    def _decoded_queries(self) -> torch.Tensor:
        return self.quantiser.decode(self.codes)

    @classmethod
    def load(cls, path: str, device="cuda") -> "ExhaustivePqIndex":
        """Load an index saved by either package's ``save`` (npz)."""
        from ...interop import exhaustive_pq_from_jax_arrays

        return exhaustive_pq_from_jax_arrays(*cls._read_npz(path, cls.__name__), device)


class ExhaustiveOpqIndex(ExhaustivePqIndex):
    """Flat OPQ index: a learned rotation, then the PQ scan in the rotated
    space (a rotation keeps distances and norms)."""

    _state_arrays = ("codes", "code_sqnorms", "codebooks", "rotation")

    def __init__(self, mat: Any, m: int = 16, metric: str = "euclidean", seed: int = 42,
                 device="cuda"):
        BaseIndex.__init__(self, mat, metric, device)
        self.m = m
        self.opq = OptimisedProductQuantiser.train(self.vectors, m, seed=seed)
        self.quantiser = self.opq.pq
        self.rotation = self.opq.rotation
        self.codebooks = self.quantiser.codebooks
        self.codes = self.opq.encode(self.vectors)
        self.code_sqnorms = self.quantiser.code_sqnorms(self.codes)
        self.vectors = self.sqnorms = None

    def _code_space(self, q: torch.Tensor) -> torch.Tensor:
        with fp32_matmul():
            return q @ self.rotation

    def _decoded_queries(self) -> torch.Tensor:
        return self.opq.decode(self.codes)

    @classmethod
    def load(cls, path: str, device="cuda") -> "ExhaustiveOpqIndex":
        """Load an index saved by either package's ``save`` (npz)."""
        from ...interop import exhaustive_opq_from_jax_arrays

        return exhaustive_opq_from_jax_arrays(*cls._read_npz(path, cls.__name__), device)
