"""Graph index: NN-descent construction and a CAGRA-style beam-search query
(port of ``annsearch_tpu.models.graph``).

One index serves two uses:

  * ``knn_ids`` / ``knn_dists``: the kNN graph (``generate_knn(mode="graph")``),
    built exactly by the fused flat scan (kernel K2 on the card, its plain
    version on the CPU) whenever ``n²·d ≤ BRUTE_BUILD_FLOP_BUDGET``, and
    above it by :func:`approx_knn_graph`: a random graph, k-means partition
    joins, one random-projection pass, then rate-adaptive NN-descent rounds
    (``ops/graph.py``; tensor operations, no kernel of their own);
  * ``nav_graph``: the detour-pruned graph with sampled reverse edges that
    ``query`` walks by beam search from routed entry points. It is built on
    the first query.

The build's random draws come from one generator on the index's device,
seeded with ``seed``: torch cannot repeat the JAX package's key streams, so
the approximate graphs of the two packages agree by recall, not by id.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from ..ops.graph import (
    NND_INPLACE_MIN_N,
    NND_R_NEW,
    NND_R_OLD,
    add_reverse_edges,
    beam_search,
    cagra_prune,
    diversify_graph,
    kmeans_leaves,
    leaf_join_merge,
    nnd_cand_width,
    nnd_draws,
    nnd_round_chunked,
    random_init_graph,
    rp_forest_round,
)
from ..ops.topk import blocked_query_topk, topk_smallest
from ..utils.dist import Dist, fp32_matmul, sq_norms
from .base import BaseIndex, _Marks
from .kmeans import train_centroids

__all__ = ["NNDescentIndex", "approx_knn_graph", "BRUTE_BUILD_FLOP_BUDGET",
           "brute_knn_graph"]

#: up to this n²·d the graph is built exactly by the flat scan (the JAX
#: package's value: every index up to 2.8M rows at 32d). The graph indexes
#: read it at build time, so patching it here forces NNDescent, HNSW and
#: Vamana onto the approximate build
BRUTE_BUILD_FLOP_BUDGET = 1_000_000 * 1_000_000 * 256

#: bytes a tile of an NN-descent round gathers and scores: per candidate
#: its f32 row (4·d), its id and the keyed pre-select's key (int64 each),
#: its distance and masks (about 16 more)
_NND_BUDGET = 1 << 30


def _nnd_tile(width: int, dim: int) -> int:
    """Rows per tile of an NN-descent round of ``width`` candidates a row:
    the largest power of two within ``_NND_BUDGET``, from 64 to 16,384 (a
    power of two divides the in-place rounds' row chunks)."""
    rows = _NND_BUDGET // (width * (4 * dim + 32))
    return 1 << max(6, min(14, rows.bit_length() - 1))


def _round_chunks(n: int, full: bool) -> int:
    """Row chunk of an NN-descent round: the whole graph below
    ``NND_INPLACE_MIN_N`` (Jacobi chunks change no result, and a tile
    bounds the memory), and the JAX package's chunks from it, where the
    in-place merge makes the chunk part of the result."""
    if n < NND_INPLACE_MIN_N:
        return n
    return 32_768 if full else 262_144


def approx_knn_graph(
    gen: torch.Generator,
    vecs: torch.Tensor,         # [n+1, d] (sentinel last row)
    sq: torch.Tensor,           # [n+1]
    kk: int,
    metric: Dist,
    *,
    n_trees: int = 4,
    max_rounds: int = 40,
    delta: float = 0.001,
    seed: int = 42,
    verbose: bool = False,
    mark: _Marks | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Approximate ``kk``-NN graph ``(ids [n, kk] int32, dists [n, kk])``:
    the build of every graph index above the brute budget.

    A random graph (``random_init_graph``), then ``n_trees − 1`` k-means
    partition passes (``kmeans_leaves`` on ``max(64, n / (2·leaf))``
    centroids, the (t mod 3 + 1)-nearest cell in pass t, joined by
    ``leaf_join_merge``) and one random-projection pass
    (``rp_forest_round``), then NN-descent rounds (``nnd_round_chunked``).
    The rounds are rate-adaptive: every block of every row is expanded
    while the update rate stays at 0.02 or more (0.01 from
    ``NND_INPLACE_MIN_N`` rows), then, once it falls below, four sampled
    blocks a row for the rest of the build. The build stops after two
    rounds in a row under ``delta``, or after ``max_rounds``.

    The draws come from ``gen`` in order; ``seed`` seeds the k-means.
    ``verbose`` prints the JAX package's lines; ``mark`` (a stage timer)
    is called after each stage and round, and after each round's draws."""
    n, dim = vecs.shape[0] - 1, vecs.shape[1]
    mark = mark or (lambda label: None)
    ids, dists = random_init_graph(gen, vecs, sq, kk, metric)
    mark("random init")

    leaf = max(16, min(256, n // 8))
    cents = train_centroids(vecs[:n], max(64, n // (2 * leaf)), metric, seed=seed)
    mark("k-means")
    levels = max(1, math.ceil(math.log2(max(n / leaf, 2))))
    for t in range(n_trees):
        if t == n_trees - 1:
            ids, dists = rp_forest_round(gen, vecs, sq, ids, dists, levels, leaf, kk, metric)
        else:
            leaves = kmeans_leaves(gen, vecs, cents, t % 3, leaf, metric)
            ids, dists = leaf_join_merge(leaves, vecs, sq, ids, dists, kk, metric)
        if verbose:
            print(f"partition pass {t + 1}/{n_trees} done")
        mark(f"partition pass {t + 1}")

    flags = torch.ones((n, kk), dtype=torch.bool, device=vecs.device)
    quiet, rate, full = 0, 1.0, True
    base_w = kk + NND_R_NEW + NND_R_OLD     # every block selectable
    # from 8M rows the full-width phase runs one threshold longer: the
    # sampled rounds move too few edges there to recover from an early switch
    full_latch = 0.02 if n < NND_INPLACE_MIN_N else 0.01
    for r in range(max_rounds):
        full = full and rate >= full_latch
        c_act = (base_w if full else 4) * kk
        rev, rev2, noise = nnd_draws(gen, ids, flags)
        mark(f"round {r + 1} draws")
        ids, dists, upd, flags = nnd_round_chunked(
            gen, vecs, sq, ids, dists, kk, metric, new_in=flags, c_active=c_act,
            tile=_nnd_tile(nnd_cand_width(kk, c_act), dim),
            row_chunk=_round_chunks(n, full), rev=rev, rev2=rev2, noise=noise,
        )
        rate = int(upd) / max(n * kk, 1)
        if verbose:
            print(f"nnd round {r + 1} ({'full' if full else 'sampled'}): update rate {rate:.4f}")
        mark(f"round {r + 1} ({'full' if full else 'sampled'}, rate {rate:.4f})")
        quiet = quiet + 1 if rate < delta else 0
        if quiet >= 2:
            break
    return ids, dists


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
        ``out_deg // 2``). Up to ``BRUTE_BUILD_FLOP_BUDGET`` the graph is
        exact; above it :func:`approx_knn_graph` builds it with ``n_trees``
        partition passes and at most ``max_rounds`` rounds that stop under
        the update rate ``delta``, and then ``refine_rounds`` two-hop
        passes (every edge new, every block expanded) follow; below the
        budget ``refine_rounds`` is ignored, as in the JAX package.

        ``diversify_prob`` > 0 prunes occluded edges of the graph after
        either build (``diversify_graph``); pruned slots read ``(n, inf)``.

        ``verbose`` prints the build's lines and each stage's seconds (each
        ending in a synchronise), kept in ``build_times``. The draws come
        from one generator on the index's device seeded with ``seed``.

        ``has_sentinel=True``: ``mat`` is ``[n+1, dim]`` with a zero last
        row and becomes the sentinel-padded table without a concatenation.
        Numpy inputs are validated; tensors are trusted."""
        if has_sentinel and isinstance(mat, np.ndarray):
            if mat.shape[0] < 1 or np.any(mat[-1]):
                raise ValueError("has_sentinel=True requires a zero last row")
        self._capture_f64(mat[:-1] if has_sentinel else mat)
        super().__init__(mat, metric, device)
        if has_sentinel:
            self.n -= 1
        n = self.n
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
        vecs, sq, kb = self.vectors, self.sqnorms, self.k_build
        mark = _Marks("nndescent", verbose, self.device)
        gen = torch.Generator(device=self.device).manual_seed(seed)

        if n * n * self.dim <= BRUTE_BUILD_FLOP_BUDGET:
            ids, dists = self._brute_knn_graph()
            if verbose:
                print("graph built exactly (the fused flat scan)")
            mark("exact graph")
        else:
            ids, dists = approx_knn_graph(
                gen, vecs, sq, kb, self.metric, n_trees=n_trees, max_rounds=max_rounds,
                delta=delta, seed=seed, verbose=verbose, mark=mark,
            )
            # all-new flags and every block: an unfiltered two-hop pass
            c_act = (kb + NND_R_NEW + NND_R_OLD) * kb
            for r in range(refine_rounds):
                ids, dists, upd, _ = nnd_round_chunked(
                    gen, vecs, sq, ids, dists, kb, self.metric,
                    new_in=torch.ones((n, kb), dtype=torch.bool, device=self.device),
                    c_active=c_act, tile=_nnd_tile(nnd_cand_width(kb, c_act), self.dim),
                    row_chunk=_round_chunks(n, True),
                )
                if verbose:
                    print(f"two-hop refinement {r + 1}/{refine_rounds}: {int(upd)} updates")
                mark(f"refine {r + 1}")

        if diversify_prob > 0.0:
            ids, dists = diversify_graph(gen, vecs, sq, ids, dists, diversify_prob, self.metric)
            if verbose:
                print(f"diversified: {int((ids < n).sum())}/{ids.numel()} edges kept "
                      f"(prob {diversify_prob})")
            mark("diversify")
        self.knn_ids, self.knn_dists = ids, dists
        self.build_times = mark.times
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
        seed: int | None = None,
        query_block: int = 1024,
        exact_fallback: bool = True,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Top-k ``(ids, dists)``. Small batches (``nq·n·d`` within
        ``models.base.BRUTE_QUERY_FLOP_BUDGET``) take one exact scan unless
        ``exact_fallback=False``; the rest walk the navigable graph by beam
        search: ``beam`` defaults to ``max(32, 2k)``, ``iters`` to
        ``max(8, beam // 4)``. f64 queries to an index built from f64 data
        are answered at f64 grade. ``seed`` is accepted and ignored, as in
        the JAX package (the entries are routed, not drawn)."""
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
