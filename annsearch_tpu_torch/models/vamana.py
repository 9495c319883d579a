"""Vamana (DiskANN-style) index (port of ``annsearch_tpu.models.vamana``).

A flat graph of degree ``r_degree`` built by α-robust pruning and queried by
beam search from routed entries plus the medoid. As in the JAX package the
build runs in batched rounds: the kNN pool (``hnsw._build_knn_graph``:
kernel K2 above 4,096 rows, the approximate build above the brute budget)
merged with random long-range candidates, a
first prune with reverse edges, then each node's beam-search trail from the
medoid over that graph merged into its pool, and a second prune with
reverse edges.

Robust prune: neighbour v is kept unless a closer-ranked neighbour w has
``α · d(w, v) < d(u, v)``; α > 1 keeps the long-range "highway" edges that
pure kNN graphs lack. Rank order stands in for "kept earlier", as in the
JAX package.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from ..ops.graph import _merge_rows, add_reverse_edges, beam_search, random_init_graph
from ..ops.topk import topk_smallest
from ..utils.dist import Dist, fp32_matmul, sq_norms
from .base import BaseIndex, _Marks
from .hnsw import _build_knn_graph

__all__ = ["VamanaIndex", "robust_prune"]

#: bytes of the per-row pair tensors one step of ``robust_prune`` builds
_PRUNE_BUDGET = 1 << 30
#: bytes of the gathered candidate rows one block of the trail pass builds
_TRAIL_BUDGET = 2 << 30


def robust_prune(
    vectors: torch.Tensor,      # [n+1, d]
    sqnorms: torch.Tensor,      # [n+1]
    graph_ids: torch.Tensor,    # [n, kk] ascending by distance
    graph_dists: torch.Tensor,  # [n, kk]
    alpha: float,
    out_deg: int,
    metric: Dist,
    tile: int | None = None,
) -> torch.Tensor:
    """Batched α-robust prune: ``[n, out_deg]`` int32, the kept candidates
    in rank order, then the pruned ones (and sentinels) in rank order.

    The pair distances take the JAX package's numerics: the rows rounded
    to bf16, their products exact in f32 and summed in FP32 (TF32 off), so
    only the order of the sums differs; the norms are the f32 rows'.
    ``tile`` rows go through at a time (default: as many as keep the pair
    tensors within ``_PRUNE_BUDGET``); it changes no result."""
    n, kk = graph_ids.shape
    dev = graph_ids.device
    if tile is None:
        tile = max(1, _PRUNE_BUDGET // (kk * (24 * kk + 12 * vectors.shape[1])))
    rank = torch.arange(kk, device=dev)
    rank_lt = rank[:, None] < rank[None, :]          # [w, v]
    out = torch.empty((n, out_deg), dtype=torch.int32, device=dev)
    for u0 in range(0, n, tile):
        nbrs = graph_ids[u0 : u0 + tile].long()
        nd = graph_dists[u0 : u0 + tile]
        safe = torch.clamp(nbrs, max=n)
        nb = vectors[safe].to(torch.bfloat16).float()
        with fp32_matmul():    # bf16 products, exact in f32; f32 sums
            dots = torch.bmm(nb, nb.transpose(1, 2))
        if metric == Dist.COSINE:
            pair = 1.0 - dots
        else:
            nsq = sqnorms[safe]
            pair = torch.clamp(nsq[:, :, None] + nsq[:, None, :] - 2.0 * dots, min=0.0)
        dominated = (alpha * pair) < nd[:, None, :]
        invalid = nbrs >= n
        pruned = (rank_lt & dominated & ~invalid[:, :, None]).any(dim=1) | invalid
        # a stable sort keeps both groups in rank order
        order = torch.sort(pruned.to(torch.uint8), dim=1, stable=True).indices[:, :out_deg]
        out[u0 : u0 + tile] = torch.gather(nbrs, 1, order).int()
    return out


class VamanaIndex(BaseIndex):
    """Fixed-degree α-pruned graph with a medoid entry."""

    _fallback_vectors = BaseIndex._fallback_from_vectors

    _state_arrays = ("vectors", "sqnorms", "graph", "medoid_arr")
    _state_scalars = ("n", "dim", "r_degree")

    def __init__(
        self,
        mat: Any,
        metric: str = "euclidean",
        r_degree: int = 32,
        alpha: float = 1.2,
        build_k: int | None = None,
        n_trees: int = 2,
        max_rounds: int = 8,
        seed: int = 42,
        verbose: bool = False,
        device="cuda",
    ):
        """``build_k`` (default ``max(48, r_degree)``) neighbours seed each
        node's prune pool; ``n_trees`` and ``max_rounds`` steer the
        approximate build of that pool above the brute budget
        (``graph.approx_knn_graph``, its draws from a generator on the
        index's device). ``verbose`` prints each build stage's seconds (each
        ending in a synchronise) and keeps them in ``build_times``. The
        random candidates and reverse-edge slots come from one CPU generator
        seeded with ``seed``."""
        self._capture_f64(mat)
        super().__init__(mat, metric, device)
        n = self.n
        self.r_degree = min(r_degree, max(n - 1, 1))
        build_k = min(build_k if build_k is not None else max(48, self.r_degree), max(n - 1, 1))
        vecs = torch.cat([self.vectors, torch.zeros((1, self.dim), device=self.device)])
        sq = sq_norms(vecs)
        self.vectors, self.sqnorms = vecs, sq
        mark = _Marks("vamana", verbose, self.device)
        gen = torch.Generator().manual_seed(seed)

        ids, dists = _build_knn_graph(vecs, sq, build_k, self.metric, seed, n_trees,
                                      max_rounds)
        mark("base kNN pool")
        # random long-range candidates give the pool its cross-cluster
        # "highway" edges: a pure kNN pool has none, and pruning can only
        # select
        rand_ids, rand_dists = random_init_graph(gen, vecs, sq, self.r_degree, self.metric)
        pool_k = build_k + self.r_degree
        ids, dists = _merge_rows(ids, dists, rand_ids, rand_dists, pool_k)
        mark("random init")

        # medoid: the stored row closest to the mean
        with fp32_matmul():
            d_mean = sq[:n] - 2.0 * (vecs[:n] @ vecs[:n].mean(dim=0))
        self.medoid_arr = torch.argmin(d_mean).int().reshape(1)

        pruned = robust_prune(vecs, sq, ids, dists, alpha, self.r_degree, self.metric)
        graph0 = add_reverse_edges(gen, pruned, n, self.r_degree // 2)
        graph0 = torch.cat(
            [graph0, torch.full((1, graph0.shape[1]), n, dtype=torch.int32, device=self.device)])
        mark("first-pass prune")

        ids, dists = self._second_pass_pool(vecs, sq, graph0, ids, dists, pool_k)
        mark("second-pass trails")
        pruned = robust_prune(vecs, sq, ids, dists, alpha, self.r_degree, self.metric)
        graph = add_reverse_edges(gen, pruned, n, self.r_degree // 2)
        self.graph = torch.cat(
            [graph, torch.full((1, graph.shape[1]), n, dtype=torch.int32, device=self.device)])
        mark("second-pass prune")
        self.build_times = mark.times
        self._router_ids = None

    @property
    def medoid(self) -> int:
        return int(self.medoid_arr[0])

    def _second_pass_pool(self, vecs, sq, graph0, ids, dists, pool_k):
        """Each node's prune pool merged with the trail of a beam search
        for the node itself from the medoid over the first-pass graph (beam
        32, 12 iterations, expand 4): the batched form of the reference's
        second build pass. The walk graph is capped at 48 edges a node (the
        nearest 24 and an even stride over the rest); nodes go through in
        blocks that keep the gathered candidate rows within
        ``_TRAIL_BUDGET``."""
        n = self.n
        beam, iters, expand, trail_cap = min(32, max(n, 1)), 12, 4, 48
        deg0 = int(graph0.shape[1])
        if deg0 > trail_cap:
            near = trail_cap // 2
            far_idx = np.unique(np.linspace(near, deg0 - 1, trail_cap - near).astype(np.int64))
            cols = np.concatenate([np.arange(near), far_idx])
            graph0 = graph0[:, torch.as_tensor(cols, device=graph0.device)].contiguous()
        per_query = expand * graph0.shape[1] * (8 * vecs.shape[1] + 64)
        qb = max(1024, _TRAIL_BUDGET // per_query)
        out_i, out_d = [], []
        for s in range(0, n, qb):
            q = vecs[s : min(s + qb, n)]
            entries = self.medoid_arr.long().expand(q.shape[0], 1)
            _, _, td, tids = beam_search(q, vecs, sq, graph0, entries, 1, beam, iters,
                                         self.metric, expand, return_trail=True)
            # a node's own trail visits itself: mask self and sentinel entries
            own = torch.arange(s, s + q.shape[0], device=q.device)[:, None]
            td = torch.where((tids == own) | (tids >= n), float("inf"), td)
            mi, md = _merge_rows(ids[s : s + qb], dists[s : s + qb], tids, td, pool_k)
            out_i.append(mi)
            out_d.append(md)
        return torch.cat(out_i), torch.cat(out_d)

    def _routers(self) -> torch.Tensor:
        """The router sample, drawn on first use from a CPU generator
        seeded 7 (the JAX package draws it from ``PRNGKey(7)``, which torch
        cannot repeat; ``interop`` can carry a JAX index's sample)."""
        if self._router_ids is None:
            n_routers = min(self.n, max(256, 4 * math.isqrt(self.n)))
            perm = torch.randperm(self.n, generator=torch.Generator().manual_seed(7))
            self._router_ids = perm[:n_routers].int().to(self.device)
        return self._router_ids

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
        """Top-k ``(ids, dists)``: small batches take one exact scan unless
        ``exact_fallback=False``; the rest scan the routers exactly (FP32)
        for ``n_entries − 1`` entries, add the medoid, and beam-search in
        blocks of ``query_block`` queries: ``beam`` defaults to ``max(32,
        2k)``, ``iters`` to ``max(8, beam // 4)``. An unreached slot comes
        back as ``n − 1`` at inf, as in the JAX package. f64 queries to an
        index built from f64 data are answered at f64 grade."""
        r = self._f64_roundtrip(query_mat, k, beam=beam, iters=iters, expand=expand,
                                n_entries=n_entries, query_block=query_block,
                                exact_fallback=exact_fallback)
        if r is not None:
            return r
        q = self._prep_queries(query_mat)
        if exact_fallback and self._exact_fallback_ok(q.shape[0]):
            return self._exact_query_small(q, self._clamp_k(k))
        k = self._clamp_k(k)
        beam = min(beam if beam is not None else max(32, 2 * k), self.n)
        iters = iters if iters is not None else max(8, beam // 4)
        n_entries = max(2, min(n_entries, beam, self.n))
        routers = self._routers().long()
        with fp32_matmul():
            dots = q @ self.vectors[routers].T
        rd = 1.0 - dots if self.metric == Dist.COSINE else self.sqnorms[routers][None, :] - 2.0 * dots
        pos = topk_smallest(rd, min(max(n_entries - 1, 1), routers.shape[0]))[1]
        entries = torch.cat(
            [routers[pos], self.medoid_arr.long().expand(q.shape[0], 1)], dim=1)
        qb = min(query_block, max(q.shape[0], 8))
        parts = [
            beam_search(q[s : s + qb], self.vectors, self.sqnorms, self.graph,
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

    @classmethod
    def load(cls, path: str, device="cuda") -> "VamanaIndex":
        """Load an index saved by either package's ``save`` (npz). A loaded
        index keeps no f64 copy and draws its routers on first use."""
        from ..interop import vamana_from_jax_arrays

        arrays, meta = cls._read_npz(path, cls.__name__)
        return vamana_from_jax_arrays(arrays, meta, device)
