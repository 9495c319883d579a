"""Sharded CAGRA-style graph index (port of
``annsearch_tpu.parallel.graph_sharded``; BASELINE config 5, the graph
sharded over a v5e-8 mesh).

* **build**: each logical shard builds its own sub-graph over its own rows,
  with no collective: the exact kNN graph by the running top-k
  (``ops.topk``, FP32) while ``m²·d`` stays within
  ``models.graph.BRUTE_BUILD_FLOP_BUDGET`` (read at build time), else a
  random graph, ``n_trees`` random-projection passes and ``rounds``
  NN-descent rounds on a static schedule (every block for three rounds,
  then four sampled blocks a row). Then the detour prune and the sampled
  reverse edges. Shard s draws from a generator seeded from ``(seed, s)``.
* **query**: queries are replicated; each shard beam-searches its
  sub-graph from routed entries, local ids become global, and the shards'
  candidates merge in shard order.
* **self-kNN**: blocks of rows ride a ring of the shards (the JAX
  ``ppermute``; :func:`.mesh.ring_shift`): at each hop the host shard
  scores the visiting block (exactly, or by a beam search of its
  sub-graph) and the block's running top-k merges; after P hops every block
  is home with its global kNN rows.

Pad rows (the last shard's, up to a multiple of P) and self-pairs are
masked by global id. The JAX package scores the walk on bf16 mantissa
splits of the rows (a TPU layout); the port's ``beam_search`` scores in
FP32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..models import graph as _graph
from ..models.base import as_f32_matrix
from ..ops.graph import (
    NND_R_NEW,
    NND_R_OLD,
    add_reverse_edges,
    beam_search,
    cagra_prune,
    nnd_cand_width,
    nnd_round,
    random_init_graph,
    rp_forest_round,
)
from ..ops.topk import DEFAULT_DB_CHUNK, merge_topk, topk_smallest
from ..utils.dist import Dist, matmul_t, normalise, parse_ann_dist, sq_norms
from .mesh import DB_AXIS, Mesh, gather_shards, make_mesh, ring_shift, shard_rows
from .sharded import _pad_to_multiple, _shard_topk, _valid_rows, merge_shards

__all__ = ["ring_self_knn", "ShardedGraphIndex"]

_INF = float("inf")
#: rows one shard scores or walks at a time (it changes no result)
_BLOCK = 8192


def _home(mesh: Mesh, best_d, best_i, n_valid: int):
    """The ring's state once every block is home: pad rows get (n_valid,
    inf), and so does every slot left at inf; gathered to ``(ids, dists)
    [P·m, k]`` on every rank."""
    m = best_d.shape[1]
    rows = torch.stack([s * m + torch.arange(m, device=best_d.device)
                        for s in mesh.db_shards()])
    pad = (rows >= n_valid)[:, :, None]
    best_d = torch.where(pad, _INF, best_d)
    best_i = torch.where(pad | torch.isinf(best_d), n_valid, best_i)
    d = gather_shards(mesh, best_d)
    i = gather_shards(mesh, best_i)
    return i.reshape(-1, i.shape[-1]), d.reshape(-1, d.shape[-1])


def _ring(mesh: Mesh, x_sharded, k: int, n_valid: int, score):
    """The block ring: ``P`` hops; at each, local shard j (global s) scores
    the visiting block by ``score(j, s, block) → (dists, global ids)``,
    self-pairs are masked, and the block's running top-k merges. Block,
    owner and state then move one shard along the ring."""
    m = x_sharded.shape[1]
    dev = x_sharded.device
    blk = x_sharded
    owner = torch.as_tensor(list(mesh.db_shards()), device=dev)
    best_d = torch.full((mesh.n_local, m, k), _INF, device=dev)
    best_i = torch.full((mesh.n_local, m, k), n_valid, dtype=torch.long, device=dev)
    lane = torch.arange(m, device=dev)
    for _ in range(mesh.n_shards):
        nd, ni = [], []
        for j, s in enumerate(mesh.db_shards()):
            d, gi = score(j, s, blk[j])
            d = torch.where(gi == (owner[j] * m + lane)[:, None], _INF, d)
            d, gi = merge_topk(best_d[j], best_i[j], d, gi, k)
            nd.append(d)
            ni.append(gi)
        blk = ring_shift(mesh, blk)
        owner = ring_shift(mesh, owner)
        best_d = ring_shift(mesh, torch.stack(nd))
        best_i = ring_shift(mesh, torch.stack(ni))
    return _home(mesh, best_d, best_i, n_valid)


def ring_self_knn(
    x_sharded: torch.Tensor,   # [P / W, m, d] this rank's shards (pad rows 0)
    k: int,
    metric: Dist,
    n_valid: int,
    mesh: Mesh,
    db_chunk: int = 8192,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact self-kNN graph of a row-sharded database by the block ring:
    every hop scores the visiting block against the host shard's rows
    (FP32 running top-k). Self-pairs are masked by global id.

    Returns ``(ids [P·m, k] global, ascending by distance, dists [P·m,
    k])`` on every rank; pad rows and empty slots read ``(n_valid,
    inf)``."""
    m = x_sharded.shape[1]
    k = min(k, max(n_valid - 1, 1))
    x_sq = sq_norms(x_sharded)

    def score(j, s, block):
        d, i = _shard_topk(block, x_sharded[j], min(k + 1, m), metric,
                           _valid_rows(n_valid, s, m), db_chunk, x_sqnorm=x_sq[j])
        return d, i + s * m

    return _ring(mesh, x_sharded, k, n_valid, score)


def _shard_seed(seed: int, shard: int) -> int:
    """The seed of shard ``shard``'s draws (the JAX ``fold_in(key(seed),
    shard)``)."""
    return (seed * 1_000_003 + shard) % (1 << 63)


class ShardedGraphIndex:
    """CAGRA-style graph index over a grid of logical shards: per-shard
    sub-graphs built with no collective, queries merged over the shards,
    global self-kNN rows from the block ring. The single-card counterpart
    is ``models.NNDescentIndex``. Queries return ``(ids, dists)`` tensors
    on the mesh's card, on every rank."""

    def __init__(
        self,
        mat,
        metric: str = "euclidean",
        k: int = 30,
        build_k: int | None = None,
        out_deg: int | None = None,
        reverse_extra: int | None = None,
        n_trees: int = 2,
        rounds: int = 8,
        seed: int = 42,
        mesh=None,
    ):
        self.mesh = mesh if mesh is not None else make_mesh()
        dev = self.mesh.device
        x = as_f32_matrix(mat, dev)
        self.metric = parse_ann_dist(metric)
        self.n, self.dim = x.shape
        if self.metric == Dist.COSINE:
            x = normalise(x)
        x = _pad_to_multiple(x, self.mesh.shape[DB_AXIS])
        self.n_pad = x.shape[0]
        m = self.shard_rows = self.n_pad // self.mesh.shape[DB_AXIS]
        kk = self.k_build = min(build_k if build_k is not None else 2 * k, max(m - 1, 1))
        self.out_deg = min(out_deg if out_deg is not None else max(k, 16), kk)
        rex = reverse_extra if reverse_extra is not None else self.out_deg // 2
        self._seed = seed
        self._router_idx = None
        self.vectors = shard_rows(x, self.mesh)
        del x

        # the same crossover as the single-card graph build, per shard
        brute = m * m * self.dim <= _graph.BRUTE_BUILD_FLOP_BUDGET
        ids_l, d_l, nav_l = [], [], []
        for j, s in enumerate(self.mesh.db_shards()):
            v = _valid_rows(self.n, s, m)
            gen = torch.Generator(device=dev).manual_seed(_shard_seed(seed, s))
            vecs = torch.cat([self.vectors[j], self.vectors.new_zeros((1, self.dim))])
            sq = sq_norms(vecs)
            if brute:
                ids, dists = self._brute_shard(vecs, sq, v, kk)
            else:
                ids, dists = self._approx_shard(gen, vecs, sq, v, kk, n_trees, rounds)
            row_pad = (torch.arange(m, device=dev) >= v)[:, None]
            ids = torch.where(row_pad, m, ids)
            dists = torch.where(row_pad, _INF, dists)
            pruned = cagra_prune(vecs, sq, ids, dists, self.out_deg, self.metric)
            nav = add_reverse_edges(gen, pruned, m, max(rex, 1))
            ids_l.append(ids.int())
            d_l.append(dists)
            nav_l.append(torch.where(row_pad, m, nav).int())
        self.knn_ids_local = torch.stack(ids_l)
        self.knn_dists = torch.stack(d_l)
        self.nav_local = torch.stack(nav_l)

    def _brute_shard(self, vecs, sq, v: int, kk: int):
        """The shard's exact ``kk``-NN graph (self and pad rows masked):
        ``(ids [m, kk], dists)``, empty slots ``(m, inf)``."""
        m = vecs.shape[0] - 1
        x = vecs[:m]
        d, i = _shard_topk(x, x, min(kk + 1, m), self.metric, v, DEFAULT_DB_CHUNK, x_sqnorm=sq[:m])
        d = torch.where(i == torch.arange(m, device=x.device)[:, None], _INF, d)
        dists, pos = topk_smallest(d, kk)
        ids = torch.where(torch.isinf(dists), m, torch.gather(i, 1, pos))
        return ids, dists

    def _approx_shard(self, gen, vecs, sq, v: int, kk: int, n_trees: int, rounds: int):
        """The shard's approximate graph: a random graph, ``n_trees``
        random-projection passes (leaves of 64), then ``rounds`` NN-descent
        rounds: every block of every row for the first three, four
        sampled blocks a row after (the JAX package's static schedule,
        not ``approx_knn_graph``'s rate-adaptive one). Edges into pad rows
        are dropped."""
        m = vecs.shape[0] - 1
        ids, dists = random_init_graph(gen, vecs, sq, kk, self.metric)
        leaf = 64
        levels = max(1, int(math.ceil(math.log2(max(m / leaf, 2)))))
        for _ in range(n_trees):
            ids, dists = rp_forest_round(gen, vecs, sq, ids, dists, levels, leaf, kk, self.metric)
        flags = torch.ones((m, kk), dtype=torch.bool, device=vecs.device)
        base_w = kk + NND_R_NEW + NND_R_OLD
        for r in range(rounds):
            c_act = (base_w if r < 3 else 4) * kk
            ids, dists, _, flags = nnd_round(
                gen, vecs, sq, ids, dists, kk, self.metric, new_in=flags, c_active=c_act,
                tile=_graph._nnd_tile(nnd_cand_width(kk, c_act), self.dim),
            )
        dists = torch.where(ids.long() >= v, _INF, dists)
        dists, pos = topk_smallest(dists, kk)
        ids = torch.where(torch.isinf(dists), m, torch.gather(ids.long(), 1, pos))
        return ids, dists

    # -- query ---------------------------------------------------------------

    def _routers(self, m: int) -> np.ndarray:
        """The router sample of every shard: ``min(m, max(64, 4√m))`` local
        rows drawn by numpy from the index's seed, sorted."""
        if self._router_idx is None:
            rng = np.random.default_rng(self._seed)
            s = min(m, max(64, 4 * int(math.isqrt(m))))
            self._router_idx = np.sort(rng.permutation(m)[:s].astype(np.int32))
        return self._router_idx

    def _walk(self, j: int, s: int, q, kl: int, beam: int, iters: int, expand: int, ne: int):
        """Local shard j's (global s) beam search of queries ``q`` from its
        ``ne`` nearest valid routers: ``(dists, global ids) [nq, kl]``,
        pad-row hits and unreached slots at ``(n, inf)``."""
        m = self.shard_rows
        dev = q.device
        v = _valid_rows(self.n, s, m)
        vecs = torch.cat([self.vectors[j], self.vectors.new_zeros((1, self.dim))])
        sq = sq_norms(vecs)
        nav = self.nav_local[j]
        graph = torch.cat([nav, torch.full((1, nav.shape[1]), m, dtype=nav.dtype, device=dev)])
        rt = torch.as_tensor(self._routers(m), device=dev).long()
        rt = torch.where(rt < v, rt, 0)
        ds, gs = [], []
        for b in range(0, q.shape[0], _BLOCK):
            qb = q[b : b + _BLOCK]
            dots = matmul_t(qb, vecs[rt], "highest")
            rd = 1.0 - dots if self.metric == Dist.COSINE else sq[rt][None, :] - 2.0 * dots
            entries = rt[topk_smallest(rd, ne)[1]]
            d, i = beam_search(qb, vecs, sq, graph, entries, kl, beam, iters, self.metric,
                               expand=expand)
            gi = torch.where(i >= v, self.n, s * m + i)
            ds.append(torch.where(gi >= self.n, _INF, d))
            gs.append(gi)
        return torch.cat(ds), torch.cat(gs)

    def query(
        self,
        query_mat,
        k: int,
        beam: int | None = None,
        iters: int | None = None,
        expand: int = 4,
        n_entries: int = 8,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-shard beam search, merged over the shards: ``(ids, dists)
        [nq, k]``. ``beam`` defaults to ``max(32, 2k)``, ``iters`` to
        ``max(8, beam // 4)``. On a 2-D ``(batch, db)`` grid the batch
        splits into blocks along ``batch``; a query's answer is the
        same."""
        q = as_f32_matrix(query_mat, self.mesh.device)
        if self.metric == Dist.COSINE:
            q = normalise(q)
        k = max(1, min(k, self.n))
        m = self.shard_rows
        beam = min(beam if beam is not None else max(32, 2 * k), m)
        iters = iters if iters is not None else max(8, beam // 4)
        ne = min(n_entries, beam, m)
        kl = min(k, m)
        nq = q.shape[0]
        nb = self.mesh.n_batch
        q = _pad_to_multiple(q, nb)
        bq = q.shape[0] // nb
        out_d, out_i = [], []
        for b in range(nb):
            qb = q[b * bq : (b + 1) * bq]
            walks = [self._walk(j, s, qb, kl, beam, iters, expand, ne)
                     for j, s in enumerate(self.mesh.db_shards())]
            d, i = merge_shards(self.mesh, torch.stack([w[0] for w in walks]),
                                torch.stack([w[1] for w in walks]), k)
            out_d.append(d)
            out_i.append(i)
        ids = torch.cat(out_i)[:nq]
        return torch.clamp(ids, 0, self.n - 1), torch.cat(out_d)[:nq]

    # -- self-kNN ------------------------------------------------------------

    def generate_knn(
        self, k: int, mode: str = "graph", flop_budget: int | None = None
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Global self-kNN rows ``(ids, dists) [n, k]``, self excluded.

        ``mode="graph"`` takes the exact block ring (:func:`ring_self_knn`)
        while its multiply-adds per shard, ``m·n_pad·d``, fit
        ``flop_budget`` (default ``models.graph.BRUTE_BUILD_FLOP_BUDGET``),
        else the approximate beam ring (:meth:`_ring_self_knn_beam`).
        ``mode="search"`` queries every stored row through :meth:`query`
        (self included)."""
        k = min(k, self.n - 1)
        if mode == "search":
            return self.query(self.vectors_original_order(), k)
        budget = flop_budget if flop_budget is not None else _graph.BRUTE_BUILD_FLOP_BUDGET
        if self.shard_rows * self.n_pad * self.dim <= budget:
            ids, dists = ring_self_knn(self.vectors, k, self.metric, self.n, self.mesh)
        else:
            ids, dists = self._ring_self_knn_beam(k)
        return torch.clamp(ids[: self.n], 0, self.n - 1), dists[: self.n]

    def _ring_self_knn_beam(
        self,
        k: int,
        beam: int | None = None,
        iters: int | None = None,
        expand: int = 4,
        n_entries: int = 8,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Approximate self-kNN ring: at each hop the host shard beam-searches
        the visiting block on its sub-graph (routed entries, FP32 scores)
        instead of scanning it, and the block's running top-k merges.
        Returns ``(ids, dists) [P·m, k]`` as :func:`ring_self_knn`."""
        m = self.shard_rows
        beam = min(beam if beam is not None else max(32, 2 * k), m)
        iters = iters if iters is not None else max(8, beam // 4)
        ne = min(n_entries, beam, m)
        kl = min(k + 1, m)

        def score(j, s, block):
            return self._walk(j, s, block, kl, beam, iters, expand, ne)

        return _ring(self.mesh, self.vectors, k, self.n, score)

    def vectors_original_order(self) -> torch.Tensor:
        """Every stored row in original order (``[n, d]``, all shards)."""
        v = gather_shards(self.mesh, self.vectors)
        return v.reshape(-1, self.dim)[: self.n]

    def memory_usage_bytes(self) -> int:
        """Bytes of the whole index (every shard, all ranks)."""
        return 4 * self.mesh.world * int(
            self.vectors.numel() + self.knn_ids_local.numel()
            + self.knn_dists.numel() + self.nav_local.numel()
        )
