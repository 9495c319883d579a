"""Graph index: an exact kNN graph and a CAGRA-style beam-search query (port
of ``annsearch_tpu.models.graph.NNDescentIndex``, the part below its brute
build budget).

One index serves two uses:

  * ``knn_ids`` / ``knn_dists``: the kNN graph (``generate_knn(mode="graph")``),
    built exactly by the fused flat scan (kernel K2 on the card, its plain
    version on the CPU) whenever ``n²·d ≤ BRUTE_BUILD_FLOP_BUDGET``;
  * ``nav_graph``: the detour-pruned graph with sampled reverse edges that
    ``query`` walks by beam search from routed entry points. It is built on
    the first query.

Not ported yet (ROADMAP P5): the approximate build above the
budget (``approx_knn_graph``), ``refine_rounds`` and ``diversify_prob``;
each raises ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from ..ops.graph import add_reverse_edges, beam_search, cagra_prune
from ..ops.topk import blocked_query_topk, topk_smallest
from ..utils.dist import Dist, fp32_matmul, sq_norms
from .base import BaseIndex

__all__ = ["NNDescentIndex", "BRUTE_BUILD_FLOP_BUDGET", "brute_knn_graph"]

#: up to this n²·d the graph is built exactly by the flat scan (the JAX
#: package's value: every index up to 2.8M rows at 32d)
BRUTE_BUILD_FLOP_BUDGET = 1_000_000 * 1_000_000 * 256


def brute_knn_graph(
    x: torch.Tensor, sq: torch.Tensor, k: int, metric: Dist,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The exact kNN graph of the rows ``x [n, d]`` (``sq`` their squared
    norms) by the fused flat scan at ``"highest"`` precision (kernel K2 at
    ``passes=6`` on the card), the self column dropped: ``(ids [n, k]
    int32, dists [n, k])`` ascending, empty slots ``(n, inf)``; ``k < n``."""
    n = x.shape[0]
    d, i = blocked_query_topk(
        x, x, min(k + 1, n), metric,
        x_sqnorm=sq if metric == Dist.EUCLIDEAN else None,
        precision="highest", selector="fused",
    )
    # the first hit is the row itself at distance about 0; where ties
    # moved it, any exact self id is masked
    d = torch.where(i == torch.arange(n, device=x.device)[:, None], float("inf"), d)
    dists, pos = topk_smallest(d, k)
    ids = torch.gather(i, 1, pos)
    ids = torch.where(torch.isinf(dists), n, ids)
    return ids.int(), dists


class NNDescentIndex(BaseIndex):
    """kNN-graph and navigable-graph index."""

    _fallback_vectors = BaseIndex._fallback_from_vectors

    _state_arrays = (
        "vectors", "sqnorms", "knn_ids", "knn_dists", "nav_graph", "router_ids",
    )
    _state_scalars = ("n", "dim", "k_build", "out_deg")

    def __init__(
        self,
        mat: Any,
        metric: str = "euclidean",
        k: int = 30,
        build_k: int | None = None,
        n_trees: int = 4,
        max_rounds: int = 40,
        delta: float = 0.001,
        out_deg: int | None = None,
        reverse_extra: int | None = None,
        refine_rounds: int = 0,
        diversify_prob: float = 0.0,
        seed: int = 42,
        verbose: bool = False,
        has_sentinel: bool = False,
        device="cuda",
    ):
        """``build_k`` neighbours per row are built (default ``2k``),
        ``out_deg`` of them survive the pruning (default ``max(k, 16)``) and
        ``reverse_extra`` reverse edges are appended (default
        ``out_deg // 2``). ``n_trees``, ``max_rounds`` and ``delta`` steer
        the approximate build, which is not ported: they are accepted and
        unused below the brute budget.

        ``has_sentinel=True``: ``mat`` is ``[n+1, dim]`` with a zero last
        row and becomes the sentinel-padded table without a concatenation.
        Numpy inputs are validated; tensors are trusted."""
        if refine_rounds > 0:
            raise NotImplementedError(
                "refine_rounds > 0 needs nnd_round_chunked (ROADMAP P5: the "
                "approximate graph build)"
            )
        if diversify_prob > 0.0:
            raise NotImplementedError(
                "diversify_prob > 0 needs diversify_graph (ROADMAP P5: the "
                "approximate graph build with diversify_graph)"
            )
        if has_sentinel and isinstance(mat, np.ndarray):
            if mat.shape[0] < 1 or np.any(mat[-1]):
                raise ValueError("has_sentinel=True requires a zero last row")
        self._capture_f64(mat[:-1] if has_sentinel else mat)
        super().__init__(mat, metric, device)
        if has_sentinel:
            self.n -= 1
        n = self.n
        if n * n * self.dim > BRUTE_BUILD_FLOP_BUDGET:
            raise NotImplementedError(
                f"n²·d = {n * n * self.dim:.3g} exceeds BRUTE_BUILD_FLOP_BUDGET: "
                "the approximate build (approx_knn_graph) is not ported yet "
                "(ROADMAP P5: the approximate graph build)"
            )
        self.k_build = min(build_k if build_k is not None else 2 * k, max(n - 1, 1))
        self.out_deg = min(out_deg if out_deg is not None else max(k, 16), self.k_build)
        self._reverse_extra = (
            reverse_extra if reverse_extra is not None else self.out_deg // 2
        )
        self._seed = seed

        # sentinel row n for safe gathers
        if not has_sentinel:
            self.vectors = torch.cat(
                [self.vectors, torch.zeros((1, self.dim), device=self.device)])
        self.sqnorms = sq_norms(self.vectors)

        self.knn_ids, self.knn_dists = self._brute_knn_graph()
        if verbose:
            print("graph built exactly (the fused flat scan)")
        # the navigable graph and the routers are built on the first query:
        # generate_knn(mode="graph") never pays for them
        self.nav_graph = None
        self.router_ids = None

    def _brute_knn_graph(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The exact kNN graph of the stored rows (:func:`brute_knn_graph`)."""
        n = self.n
        return brute_knn_graph(self.vectors[:n], self.sqnorms[:n], self.k_build, self.metric)

    def _ensure_nav(self) -> None:
        """Build the pruned navigable graph and the router sample on first
        use. The routers are a sampled node set scanned exactly at query
        time; they and the reverse-edge slots are drawn from one CPU
        generator seeded with the index's seed."""
        if self.nav_graph is not None:
            return
        n = self.n
        gen = torch.Generator().manual_seed(self._seed)
        n_routers = min(n, max(256, 4 * math.isqrt(n)))
        self.router_ids = torch.randperm(n, generator=gen)[:n_routers].int().to(self.device)
        pruned = cagra_prune(
            self.vectors, self.sqnorms, self.knn_ids, self.knn_dists,
            self.out_deg, self.metric,
        )
        nav = add_reverse_edges(gen, pruned, n, self._reverse_extra)
        # sentinel row for the beam's gathers
        self.nav_graph = torch.cat(
            [nav, torch.full((1, nav.shape[1]), n, dtype=torch.int32, device=self.device)])

    def _cagra_query(self, q, k, beam, iters, expand, n_entries, qb):
        """Route each query to its ``n_entries`` nearest routers (an exact
        FP32 scan of the router sample), then beam-search in blocks of
        ``qb`` queries."""
        routers = self.router_ids.long()
        with fp32_matmul():
            dots = q @ self.vectors[routers].T
        if self.metric == Dist.COSINE:
            rd = 1.0 - dots
        else:
            rd = self.sqnorms[routers][None, :] - 2.0 * dots
        entries = routers[topk_smallest(rd, n_entries)[1]]
        parts = [
            beam_search(
                q[s : s + qb], self.vectors, self.sqnorms, self.nav_graph,
                entries[s : s + qb], k, beam, iters, self.metric, expand,
            )
            for s in range(0, q.shape[0], qb)
        ]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])

    def query(
        self,
        query_mat: Any,
        k: int,
        beam: int | None = None,
        iters: int | None = None,
        expand: int = 4,
        n_entries: int = 8,
        query_block: int = 1024,
        exact_fallback: bool = True,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Top-k ``(ids, dists)``. Small batches (``nq·n·d`` within
        ``models.base.BRUTE_QUERY_FLOP_BUDGET``) take one exact scan unless
        ``exact_fallback=False``; the rest walk the navigable graph by beam
        search: ``beam`` defaults to ``max(32, 2k)``, ``iters`` to
        ``max(8, beam // 4)``. f64 queries to an index built from f64 data
        are answered at f64 grade."""
        r = self._f64_roundtrip(
            query_mat, k, beam=beam, iters=iters, expand=expand,
            n_entries=n_entries, query_block=query_block,
            exact_fallback=exact_fallback,
        )
        if r is not None:
            return r
        q = self._prep_queries(query_mat)
        k = self._clamp_k(k)
        if exact_fallback and self._exact_fallback_ok(q.shape[0]):
            return self._exact_query_small(q, k)
        self._ensure_nav()
        beam = min(beam if beam is not None else max(32, 2 * k), self.n)
        iters = iters if iters is not None else max(8, beam // 4)
        n_entries = min(n_entries, beam, self.n)
        qb = min(query_block, max(q.shape[0], 8))
        d, i = self._cagra_query(q, k, beam, iters, expand, n_entries, qb)
        return torch.clamp(i, 0, self.n - 1), d

    def generate_knn(self, k: int, mode: str = "graph", **kw):
        """Self-kNN ``(ids, dists)``. ``mode="graph"`` reads the built kNN
        graph (self excluded); ``mode="search"`` queries every stored
        vector (self included)."""
        if mode == "graph":
            k = min(k, self.k_build)
            return (torch.clamp(self.knn_ids[:, :k].long(), 0, self.n - 1),
                    self.knn_dists[:, :k])
        return self.query(self.vectors[: self.n], k, **kw)

    def vectors_original_order(self) -> torch.Tensor:
        return self.vectors[: self.n]

    @classmethod
    def load(cls, path: str, device="cuda") -> "NNDescentIndex":
        """Load an index saved by either package's ``save`` (npz);
        ``nav_graph`` and ``router_ids`` are absent until the saved index
        had answered a query. A loaded index keeps no f64 copy."""
        from ..interop import nndescent_from_jax_arrays

        arrays, meta = cls._read_npz(path, cls.__name__)
        return nndescent_from_jax_arrays(arrays, meta, device)
