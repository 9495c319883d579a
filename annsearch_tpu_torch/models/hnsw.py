"""HNSW index (port of ``annsearch_tpu.models.hnsw``).

Layers are drawn as in the reference (exponential assignment, at most 15
levels) from ``np.random.default_rng(seed)``, so both packages give a seed
the same layers. Every layer's graph is built in batched rounds, not by
inserts: the base layer is the kNN graph (``build_k`` neighbours), pruned
to ``2m`` by ``cagra_prune`` and filled with ``m`` sampled reverse edges;
each upper layer is the ``m``-NN graph of its members in local id space.
A layer of at most ``EXACT_LAYER_MAX`` nodes is one ``pairwise_dist``; a
larger one is kernel K2 (``brute_knn_graph``, the fused flat scan at
``passes=6``), up to ``graph.BRUTE_BUILD_FLOP_BUDGET``; above it
``graph.approx_knn_graph`` builds it (2 partition passes and at most 8
rounds at the base, 1 and 4 on the upper layers, as in the JAX package).

A query scans the largest upper layer exactly for 4 entry nodes and walks
the base layer by beam search. The JAX package pads upper layers to a power
of two to bound its recompiles; the port does not, but reads such layers
from a JAX npz (pad slots repeat member 0, so routing may return an entry
twice, and the beam keeps one copy).
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from ..ops.graph import add_reverse_edges, beam_search, cagra_prune
from ..ops.topk import topk_smallest
from ..utils.dist import Dist, fp32_matmul, pairwise_dist, sq_norms
from .base import BaseIndex, _Marks
from . import graph as _graph

__all__ = ["HnswIndex", "EXACT_LAYER_MAX", "MAX_LAYERS"]

MAX_LAYERS = 16  # the reference caps layer assignment at 15
EXACT_LAYER_MAX = 4096  # layers this small get exact kNN graphs (one matmul)


def _build_knn_graph(vecs: torch.Tensor, sq: torch.Tensor, kk: int, metric: Dist,
                     seed: int, n_trees: int, max_rounds: int):
    """``(ids, dists)`` kNN graph over ``vecs[:-1]`` (sentinel last row),
    self excluded, ``kk`` clamped to ``n − 1``: exact up to
    ``graph.BRUTE_BUILD_FLOP_BUDGET`` (read at call time), above it
    ``graph.approx_knn_graph`` with ``n_trees`` and ``max_rounds``, its
    draws from a generator on the rows' device seeded with ``seed``."""
    n, d_dim = vecs.shape[0] - 1, vecs.shape[1]
    kk = min(kk, max(n - 1, 1))
    if n <= EXACT_LAYER_MAX:
        d = pairwise_dist(vecs[:n], vecs[:n], metric, x_sqnorm=sq[:n])
        d.fill_diagonal_(float("inf"))
        dd, ii = topk_smallest(d, kk)
        return ii.int(), dd
    if n * n * d_dim <= _graph.BRUTE_BUILD_FLOP_BUDGET:
        # the JAX package's accelerator branch: K2 at f32 grade (it takes
        # the "exact" selector only off the TPU)
        return _graph.brute_knn_graph(vecs[:n], sq[:n], kk, metric)
    gen = torch.Generator(device=vecs.device).manual_seed(seed)
    return _graph.approx_knn_graph(gen, vecs, sq, kk, metric, n_trees=n_trees,
                                   max_rounds=max_rounds)


class HnswIndex(BaseIndex):
    """Hierarchical navigable small-world graph."""

    _fallback_vectors = BaseIndex._fallback_from_vectors

    _state_scalars = ("n", "dim", "m", "n_layers")

    def __init__(
        self,
        mat: Any,
        metric: str = "euclidean",
        m: int = 16,
        ef_construction: int = 100,
        seed: int = 42,
        verbose: bool = False,
        device="cuda",
    ):
        """``verbose`` prints each build stage's seconds (each ending in a
        synchronise) and keeps them in ``build_times``."""
        self._capture_f64(mat)
        super().__init__(mat, metric, device)
        n = self.n
        self.m = m
        vecs = torch.cat([self.vectors, torch.zeros((1, self.dim), device=self.device)])
        sq = sq_norms(vecs)
        self.vectors, self.sqnorms = vecs, sq
        mark = _Marks("hnsw", verbose, self.device)

        # exponential layer assignment, mL = 1/ln(M): the JAX package's draw
        rng = np.random.default_rng(seed)
        ml = 1.0 / math.log(max(m, 2))
        levels = np.minimum(
            np.floor(-np.log(rng.uniform(1e-12, 1.0, n)) * ml).astype(np.int64),
            MAX_LAYERS - 1,
        )
        self.n_layers = int(levels.max()) + 1 if n > 1 else 1
        mark("layer assignment")

        # base layer: degree 2M from the exact kNN graph, rank-pruned, with
        # sampled reverse edges
        build_k = min(max(2 * m, ef_construction // 2), max(n - 1, 1))
        ids, dists = _build_knn_graph(vecs, sq, build_k, self.metric, seed, 2, 8)
        mark("base kNN graph")
        deg0 = min(2 * m, build_k)
        pruned = cagra_prune(vecs, sq, ids, dists, deg0, self.metric)
        base = add_reverse_edges(torch.Generator().manual_seed(seed), pruned, n,
                                 max(deg0 // 2, 1))
        self.base_graph = torch.cat(
            [base, torch.full((1, base.shape[1]), n, dtype=torch.int32, device=self.device)])
        mark("prune + reverse edges")

        # upper layers: member sets with their own degree-M graphs in local
        # id space, and the local → global maps
        self.layers = []  # (global ids [s], graph [s+1, kk], vecs [s+1, d], sq [s+1])
        for lv in range(1, self.n_layers):
            members = np.nonzero(levels >= lv)[0]
            s = len(members)
            if s == 0:
                break
            gids = torch.as_tensor(members, dtype=torch.int32, device=self.device)
            lv_vecs = torch.cat([vecs[gids.long()], torch.zeros((1, self.dim), device=self.device)])
            lv_sq = sq_norms(lv_vecs)
            kk = min(m, max(s - 1, 1))
            lids, _ = _build_knn_graph(lv_vecs, lv_sq, kk, self.metric, seed + lv, 1, 4)
            graph = torch.cat(
                [lids, torch.full((1, lids.shape[1]), s, dtype=torch.int32, device=self.device)])
            self.layers.append((gids, graph, lv_vecs, lv_sq))
        mark(f"upper layers ({len(self.layers)})")
        self.build_times = mark.times
        # entry point: the highest layer's first node
        self.entry_global = int(self.layers[-1][0][0]) if self.layers else 0

    def _route(self, q: torch.Tensor) -> torch.Tensor:
        """Entry nodes ``[nq, e]``: the 4 nearest members of the largest
        upper layer by an exact FP32 scan (the layer graphs are kNN graphs
        with no links between clusters, so a greedy descent from one top
        node would stall), or the entry point where there is no layer."""
        if not self.layers:
            return torch.full((q.shape[0], 1), self.entry_global, dtype=torch.long,
                              device=q.device)
        gids0, _, lv_vecs0, lv_sq0 = self.layers[0]
        s0 = gids0.shape[0]
        with fp32_matmul():
            dots = q @ lv_vecs0[:s0].T
        dd = 1.0 - dots if self.metric == Dist.COSINE else lv_sq0[:s0][None, :] - 2.0 * dots
        return gids0.long()[topk_smallest(dd, min(4, s0))[1]]

    def query(
        self,
        query_mat: Any,
        k: int,
        ef_search: int | None = None,
        query_block: int = 1024,
        exact_fallback: bool = True,
        expand: int | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Top-k ``(ids, dists)``: small batches take one exact scan unless
        ``exact_fallback=False``; the rest are routed through the largest
        upper layer and walk the base layer by a beam of ``ef_search``
        (default 100) in blocks of ``query_block`` queries. At a beam of 64
        or more, with ``expand`` left unset, the walk expands 8 nodes an
        iteration for ``max(6, beam // 16)`` iterations, else 4 for
        ``max(8, beam // 8)``. An unreached slot comes back as ``n − 1`` at
        inf, as in the JAX package. f64 queries to an index built from f64
        data are answered at f64 grade."""
        r = self._f64_roundtrip(query_mat, k, ef_search=ef_search, query_block=query_block,
                                exact_fallback=exact_fallback, expand=expand)
        if r is not None:
            return r
        q = self._prep_queries(query_mat)
        k = self._clamp_k(k)
        if exact_fallback and self._exact_fallback_ok(q.shape[0]):
            return self._exact_query_small(q, k)
        ef = max(ef_search if ef_search is not None else 100, k)
        beam = min(ef, self.n)
        if expand is None:
            expand, iters = (8, max(6, beam // 16)) if beam >= 64 else (4, max(8, beam // 8))
        else:
            iters = max(8, beam // 8)
        entries = self._route(q)
        qb = min(query_block, max(q.shape[0], 8))
        parts = [
            beam_search(q[s : s + qb], self.vectors, self.sqnorms, self.base_graph,
                        entries[s : s + qb], k, beam, iters, self.metric, expand)
            for s in range(0, q.shape[0], qb)
        ]
        d = torch.cat([p[0] for p in parts])
        i = torch.cat([p[1] for p in parts])
        return torch.clamp(i, 0, self.n - 1), d

    def generate_knn(self, k: int, **kw):
        return self.query(self.vectors[: self.n], k, **kw)

    def vectors_original_order(self) -> torch.Tensor:
        return self.vectors[: self.n]

    def memory_usage_bytes(self) -> int:
        """4 bytes an element of the rows, norms, base graph and layers
        (the JAX package's count)."""
        total = (self.vectors.numel() + self.sqnorms.numel() + self.base_graph.numel()) * 4
        for layer in self.layers:
            total += sum(t.numel() for t in layer) * 4
        return total

    # the hierarchy does not fit the flat npz schema: the JAX package's own
    # layout, with a numeric meta row
    def save(self, path: str) -> None:
        arrays = {
            "vectors": self.vectors.cpu().numpy(),
            "base_graph": self.base_graph.cpu().numpy(),
            "meta": np.array([self.n, self.dim, self.m, self.n_layers, self.entry_global,
                              1 if self.metric == Dist.COSINE else 0]),
        }
        for i, (gids, graph, _, _) in enumerate(self.layers):
            arrays[f"l{i}_ids"] = gids.cpu().numpy()
            arrays[f"l{i}_graph"] = graph.cpu().numpy()
        np.savez(path, **arrays)

    @classmethod
    def load(cls, path: str, device="cuda") -> "HnswIndex":
        """Load an index saved by either package's ``save`` (npz). A loaded
        index keeps no f64 copy."""
        from ..interop import hnsw_from_jax_arrays

        with np.load(path if path.endswith(".npz") else path + ".npz") as z:
            arrays = {f: z[f] for f in z.files}
        return hnsw_from_jax_arrays(arrays, device)
