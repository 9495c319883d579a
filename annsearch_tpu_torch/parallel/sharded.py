"""Sharded exact top-k (port of ``annsearch_tpu.parallel.sharded``).

Each logical shard scans its database rows with the single-card running
top-k (``ops.topk.chunked_topk``, FP32 with TF32 off), offsets its local
indices to global ids, and the per-shard candidates merge in shard order
(the JAX ``all_gather(tiled)`` followed by one top-k): the result equals an
exhaustive scan's up to ties, at any shard count.

Inputs are the stacks :func:`.mesh.shard_rows` makes; every function returns
the whole ``(dists, idx)`` on every rank, as a JAX global array reads.
"""

from __future__ import annotations

import torch

from ..models.base import as_f32_matrix
from ..ops.topk import blocked_query_topk, topk_smallest
from ..utils.dist import Dist, normalise, parse_ann_dist
from .mesh import (
    BATCH_AXIS, DB_AXIS, Mesh, gather_shards, make_mesh, make_mesh2d, replicate, shard_rows,
)

__all__ = [
    "ShardedExhaustive",
    "BatchShardedExhaustive",
    "GridShardedExhaustive",
    "sharded_topk",
    "batch_sharded_topk",
    "grid_sharded_topk",
]

#: queries one shard scores at a time (it changes no result)
_QUERY_BLOCK = 8192


def _pad_to_multiple(x: torch.Tensor, m: int) -> torch.Tensor:
    pad = (-x.shape[0]) % m
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return x


def _valid_rows(n_valid: int, shard: int, m: int) -> int:
    """Rows of shard ``shard`` (``m`` rows each) below the global ``n_valid``."""
    return min(max(n_valid - shard * m, 0), m)


def _shard_topk(q, x_shard, k, metric, n_valid, db_chunk, x_sqnorm=None):
    """The per-device body: exact top-k of ``q`` over one shard's rows
    (the running top-k, in query blocks), rows at or past ``n_valid``
    masked."""
    return blocked_query_topk(q, x_shard, k, metric, x_sqnorm=x_sqnorm, n_valid=n_valid,
                              query_block=_QUERY_BLOCK, db_chunk=db_chunk)


def merge_shards(mesh: Mesh, d: torch.Tensor, i: torch.Tensor, k: int):
    """This rank's per-shard candidates ``[P / W, nq, kl]`` (global ids) →
    the best ``k`` of all shards, ``(dists, idx) [nq, k]``: the JAX tiled
    all_gather along the shard axis, then one top-k (ties to the lower
    shard, then the lower column)."""
    dg, ig = gather_shards(mesh, d), gather_shards(mesh, i)
    nq = dg.shape[1]
    dg = dg.permute(1, 0, 2).reshape(nq, -1)
    ig = ig.permute(1, 0, 2).reshape(nq, -1)
    md, pos = topk_smallest(dg, k)
    return md, torch.gather(ig, 1, pos)


def sharded_topk(
    q: torch.Tensor,
    x_sharded: torch.Tensor,
    k: int,
    metric: Dist,
    n_valid: int,
    mesh: Mesh,
    db_chunk: int = 16384,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over a row-sharded database: ``q [nq, d]`` replicated,
    ``x_sharded [P / W, m, d]`` this rank's shards; ``(dists, idx) [nq,
    k]`` with global indices."""
    m = x_sharded.shape[1]
    ds, is_ = [], []
    for j, s in enumerate(mesh.db_shards()):
        d, i = _shard_topk(q, x_sharded[j], k, metric, _valid_rows(n_valid, s, m), db_chunk)
        ds.append(d)
        is_.append(i + s * m)
    return merge_shards(mesh, torch.stack(ds), torch.stack(is_), k)


def batch_sharded_topk(
    q_sharded: torch.Tensor,
    x: torch.Tensor,
    k: int,
    metric: Dist,
    n_valid: int,
    mesh: Mesh,
    db_chunk: int = 16384,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k with the query batch sharded and the database replicated:
    ``q_sharded [P / W, bq, d]`` this rank's query blocks, ``x [n, d]``.
    No merge: each block is answered on its own; the blocks are gathered
    into ``(dists, idx) [P·bq, k]``."""
    ds, is_ = zip(*(_shard_topk(qb, x, k, metric, n_valid, db_chunk) for qb in q_sharded))
    d = gather_shards(mesh, torch.stack(ds))
    i = gather_shards(mesh, torch.stack(is_))
    return d.reshape(-1, d.shape[-1]), i.reshape(-1, i.shape[-1])


def grid_sharded_topk(
    q_sharded: torch.Tensor,
    x_sharded: torch.Tensor,
    k: int,
    metric: Dist,
    n_valid: int,
    mesh: Mesh,
    db_chunk: int = 16384,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k on a 2-D ``(batch, db)`` grid: every (query block × database
    shard) tile is scored on its own, and the candidates merge along the
    ``db`` axis only. ``q_sharded [n_batch, bq, d]``, ``x_sharded [P / W,
    m, d]``; returns ``(dists, idx) [n_batch·bq, k]``."""
    m = x_sharded.shape[1]
    out_d, out_i = [], []
    for qb in q_sharded:
        ds, is_ = [], []
        for j, s in enumerate(mesh.db_shards()):
            d, i = _shard_topk(qb, x_sharded[j], k, metric, _valid_rows(n_valid, s, m), db_chunk)
            ds.append(d)
            is_.append(i + s * m)
        d, i = merge_shards(mesh, torch.stack(ds), torch.stack(is_), k)
        out_d.append(d)
        out_i.append(i)
    return torch.cat(out_d), torch.cat(out_i)


def _prep(mat, metric, device) -> torch.Tensor:
    """f32 rows on ``device``, normalised under cosine (callers pad after,
    so pad rows stay zero)."""
    x = as_f32_matrix(mat, device)
    if metric == Dist.COSINE:
        x = normalise(x)
    return x


class _Sharded:
    """State shared by the exhaustive classes."""

    def _setup(self, mat, metric, mesh):
        self.mesh = mesh
        self.metric = parse_ann_dist(metric)
        x = _prep(mat, self.metric, mesh.device)
        self.n, self.dim = x.shape
        return x

    def _queries(self, query_mat) -> torch.Tensor:
        return _prep(query_mat, self.metric, self.mesh.device)


class GridShardedExhaustive(_Sharded):
    """Exhaustive index on a 2-D ``(batch, db)`` grid: database rows sharded
    along ``db``, query batches along ``batch``; the top-k merge gathers
    along ``db`` only. Without a mesh, ``n_batch × n_db`` (default 1 × 1)
    logical shards on the card."""

    def __init__(self, mat, metric: str = "euclidean", mesh=None,
                 n_batch: int | None = None, n_db: int | None = None):
        if mesh is None:
            n_db = n_db or 1
            n_batch = n_batch or 1
            mesh = make_mesh2d(n_batch, n_db)
        x = self._setup(mat, metric, mesh)
        self.vectors = shard_rows(_pad_to_multiple(x, mesh.shape[DB_AXIS]), mesh)

    def query(self, query_mat, k: int, db_chunk: int = 16384):
        """Top-k ``(ids, dists)`` of every query, on every rank."""
        q = self._queries(query_mat)
        nq = q.shape[0]
        qs = shard_rows(_pad_to_multiple(q, self.mesh.shape[BATCH_AXIS]), self.mesh, BATCH_AXIS)
        k = max(1, min(k, self.n))
        d, i = grid_sharded_topk(qs, self.vectors, k, self.metric, self.n, self.mesh, db_chunk)
        return i[:nq], d[:nq]


class BatchShardedExhaustive(_Sharded):
    """Exhaustive index with the database replicated and query batches
    sharded: the layout for a database that fits on every card when query
    throughput is the goal (the dual of :class:`ShardedExhaustive`)."""

    def __init__(self, mat, metric: str = "euclidean", mesh=None):
        mesh = mesh if mesh is not None else make_mesh()
        self.vectors = replicate(self._setup(mat, metric, mesh), mesh)

    def query(self, query_mat, k: int, db_chunk: int = 16384):
        """Top-k ``(ids, dists)`` of every query, on every rank."""
        q = self._queries(query_mat)
        nq = q.shape[0]
        qs = shard_rows(_pad_to_multiple(q, self.mesh.shape[DB_AXIS]), self.mesh)
        k = max(1, min(k, self.n))
        d, i = batch_sharded_topk(qs, self.vectors, k, self.metric, self.n, self.mesh, db_chunk)
        return i[:nq], d[:nq]


class ShardedExhaustive(_Sharded):
    """Exhaustive index with its rows sharded over a 1-D grid; query =
    :func:`sharded_topk`. The single-card counterpart is
    ``models.ExhaustiveIndex``."""

    def __init__(self, mat, metric: str = "euclidean", mesh=None):
        mesh = mesh if mesh is not None else make_mesh()
        x = self._setup(mat, metric, mesh)
        self.vectors = shard_rows(_pad_to_multiple(x, mesh.shape[DB_AXIS]), mesh)

    def query(self, query_mat, k: int, db_chunk: int = 16384):
        """Top-k ``(ids, dists)`` of every query, on every rank."""
        q = self._queries(query_mat)
        k = max(1, min(k, self.n))
        d, i = sharded_topk(q, self.vectors, k, self.metric, self.n, self.mesh, db_chunk)
        return i, d
