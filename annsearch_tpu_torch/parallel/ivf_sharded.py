"""Sharded IVF: distributed k-means build and a per-shard cell scan (port of
``annsearch_tpu.parallel.ivf_sharded``).

* **build**: Lloyd iterations over the shards: each shard assigns its rows
  to the replicated centroids (FP32, TF32 off, ties to the lower cell) and
  sums each cluster in a fixed order (``models.kmeans.cluster_sums``); the
  partial sums and counts of all shards are gathered and added in shard
  order, so one seed gives the same centroids for any world size at a
  fixed shard count (the JAX package's ``psum``). Each shard then clusters
  its own rows into its own cells.
* **query**: routing is replicated (one set of centroids, one set of probe
  lists built on the host); each shard runs the cluster scan
  (``ops.ivf_scan.ivf_cluster_scan``) over its cells, and the per-shard
  top-k merge in shard order. Only the ``[nq, k]`` candidates cross ranks.

Every rank is given the whole matrix, as every JAX process is; it builds
only its own shards. The initial sample and the PQ training draw come from
a ``torch.Generator`` seeded with ``seed`` (torch cannot repeat the JAX
key streams, so centroids agree with the JAX package's by quality, and
exactly only when both start from one ``init``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..models.base import as_f32_matrix
from ..models.kmeans import _assign_chunked, _dsq_seed_init, _random_init, build_cells, cluster_sums
from ..ops.ivf_scan import build_probe_lists, ivf_cluster_scan
from ..ops.topk import topk_smallest
from ..utils.dist import Dist, matmul_t, normalise, parse_ann_dist, sq_norms
from .mesh import DB_AXIS, Mesh, gather_shards, make_mesh, shard_rows
from .sharded import _pad_to_multiple, _valid_rows, merge_shards

__all__ = [
    "train_centroids_sharded",
    "ShardedIvfIndex",
    "ShardedIvfPqIndex",
]


def _shard_sum(parts: torch.Tensor) -> torch.Tensor:
    """``parts [P, ...]`` added in shard order, one shard at a time."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def train_centroids_sharded(
    x_sharded: torch.Tensor,       # [P / W, m, d] this rank's shards (pad rows 0)
    init_centroids: torch.Tensor,  # [k, d] replicated
    n_valid: int,
    mesh: Mesh,
    iters: int = 15,
) -> torch.Tensor:
    """Distributed Lloyd: ``iters`` rounds of a per-shard assignment and
    fixed-order cluster sums, the shards' partials added in shard order.
    Rows at or past ``n_valid`` (global) are padding. Empty clusters keep
    their centroid. Returns the ``[k, d]`` centroids on every rank."""
    k, d = init_centroids.shape
    m = x_sharded.shape[1]
    c = init_centroids.to(mesh.device, torch.float32)
    xs = [x_sharded[j, : _valid_rows(n_valid, s, m)] for j, s in enumerate(mesh.db_shards())]
    xsq = [sq_norms(x) for x in xs]
    for _ in range(iters):
        sums, counts = [], []
        for x, sq in zip(xs, xsq):
            if x.shape[0] == 0:
                sums.append(c.new_zeros((k, d)))
                counts.append(torch.zeros(k, dtype=torch.long, device=c.device))
                continue
            a, _ = _assign_chunked(x, c, sq)
            s_, n_ = cluster_sums(x, a, k)
            sums.append(s_)
            counts.append(n_)
        total = _shard_sum(gather_shards(mesh, torch.stack(sums)))
        cnt = _shard_sum(gather_shards(mesh, torch.stack(counts))).to(torch.float32)
        c = torch.where(cnt[:, None] > 0, total / torch.clamp(cnt, min=1.0)[:, None], c)
    return c


def _gather_rows(mesh: Mesh, parts: list[torch.Tensor], counts: list[int]) -> torch.Tensor:
    """Every shard's rows in shard order, on every rank: ``parts`` this
    rank's per-shard blocks, ``counts`` the row count of every shard (all
    P, known on every rank)."""
    width = max(max(counts), 1)
    local = torch.stack([
        torch.cat([p, p.new_zeros((width - p.shape[0],) + tuple(p.shape[1:]))]) for p in parts
    ])
    every = gather_shards(mesh, local)
    return torch.cat([every[s, :c] for s, c in enumerate(counts)])


class ShardedIvfIndex:
    """IVF index with its rows and cells sharded over a grid of logical
    shards (:mod:`.mesh`): a 1-D ``db`` grid (queries replicated, the
    default) or a 2-D ``(batch, db)`` grid, whose query batches split into
    blocks along ``batch``. Queries return ``(ids, dists)`` tensors on the
    mesh's card, on every rank."""

    mode = "f32"

    def __init__(
        self,
        mat,
        metric: str = "euclidean",
        nlist: int | None = None,
        max_iters: int = 15,
        seed: int = 42,
        mesh=None,
    ):
        self.mesh = mesh if mesh is not None else make_mesh()
        dev = self.mesh.device
        p = self.mesh.shape[DB_AXIS]
        x = as_f32_matrix(mat, dev)
        self.metric = parse_ann_dist(metric)
        self.n, self.dim = x.shape
        if nlist is None:
            nlist = max(1, int(math.isqrt(self.n)))
        self.nlist = min(nlist, self.n)
        if self.metric == Dist.COSINE:
            x = normalise(x)
        x = _pad_to_multiple(x, p)
        m = self.shard_rows = x.shape[0] // p

        # init on a sample of the rows (the same draws on every rank), then
        # the distributed Lloyd
        gen = torch.Generator(device=dev).manual_seed(seed)
        ms = min(self.n, min(256 * self.nlist, 250_000))
        sample = x[torch.randperm(self.n, generator=gen, device=dev)[:ms]]
        if self.nlist <= 200:
            init = _dsq_seed_init(gen, sample, self.nlist)
        else:
            init = _random_init(gen, sample, self.nlist)
        x_sh = shard_rows(x, self.mesh)
        del x, sample
        self.centroids = train_centroids_sharded(x_sh, init, self.n, self.mesh, iters=max_iters)

        # per-shard cells: rows sorted by cell, pad rows parked at the end
        self._shard_valid = [_valid_rows(self.n, s, m) for s in range(p)]
        sorted_parts, owners_parts, offsets, counts, orig, caps = [], [], [], [], [], []
        for j, s in enumerate(self.mesh.db_shards()):
            v = self._shard_valid[s]
            xs = x_sh[j]
            a = np.zeros(0, np.int64)
            if v:
                a = _assign_chunked(xs[:v], self.centroids, sq_norms(xs[:v]))[0].cpu().numpy()
            members, cnt, order = build_cells(a, self.nlist)
            caps.append(members.shape[1])
            order_t = torch.as_tensor(order.astype(np.int64), device=dev)
            sorted_x = torch.zeros_like(xs)
            sorted_x[:v] = xs[order_t]
            owners = torch.zeros(m, dtype=torch.long, device=dev)
            owners[:v] = torch.as_tensor(a[order], device=dev)
            om = torch.zeros(m, dtype=torch.int32, device=dev)
            om[:v] = (order_t + s * m).int()
            sorted_parts.append(sorted_x)
            owners_parts.append(owners)
            counts.append(torch.as_tensor(cnt, device=dev))
            offsets.append(torch.as_tensor(
                np.concatenate([[0], np.cumsum(cnt)[:-1]]).astype(np.int32), device=dev))
            orig.append(om)
        del x_sh
        self.cell_cap = int(gather_shards(self.mesh, torch.tensor(caps, device=dev)).max())

        storages, sqnorm_parts = self._encode_shards(sorted_parts, owners_parts, seed)
        # each shard's storage carries cell_cap pad rows, the scan's tail
        cap = self.cell_cap
        self.storage = torch.stack([
            torch.cat([st, st.new_zeros((cap,) + tuple(st.shape[1:]))]) for st in storages])
        self.store_sqnorms = torch.stack([
            torch.cat([sq.float(), sq.new_zeros(cap, dtype=torch.float32)]) for sq in sqnorm_parts])
        self.offsets = torch.stack(offsets)
        self.counts = torch.stack(counts)
        self.original_ids = torch.stack(orig)

    # -- storage-encoding hooks (f32 here; ShardedIvfPqIndex overrides) ------

    def _encode_shards(self, sorted_parts, owners_parts, seed):
        return sorted_parts, [sq_norms(s) for s in sorted_parts]

    def _scan_codebooks(self):
        return None

    def default_nprobe(self) -> int:
        return max(1, int(math.isqrt(self.nlist)))

    def _route(self, q: torch.Tensor, nprobe: int) -> np.ndarray:
        """The ``nprobe`` nearest centroids of each query (FP32, ties to
        the lower cell), on the host."""
        dots = matmul_t(q, self.centroids, "highest")
        if self.metric == Dist.COSINE:
            cd = 1.0 - dots
        else:
            cd = sq_norms(q)[:, None] + sq_norms(self.centroids)[None, :] - 2.0 * dots
        return topk_smallest(cd, nprobe)[1].cpu().numpy()

    def _scan(self, q: torch.Tensor, probes: np.ndarray, k: int):
        """Every local shard's cluster scan of queries ``q`` on one set of
        probe lists, merged over all shards: ``(dists, ids) [nq, k]``."""
        dev = self.mesh.device
        cids, lists, gmap = (torch.as_tensor(a.astype(np.int64), device=dev)
                             for a in build_probe_lists(probes, self.nlist, q.shape[0]))
        ds, gs = [], []
        for j in range(self.storage.shape[0]):
            d, i = ivf_cluster_scan(
                q, cids, lists, gmap, self.storage[j], self.store_sqnorms[j],
                self.offsets[j], self.counts[j], self.centroids, k, self.metric,
                self.cell_cap, self.mode, codebooks=self._scan_codebooks(),
            )
            oids = self.original_ids[j]
            ds.append(d)
            gs.append(oids[torch.clamp(i, 0, oids.shape[0] - 1)].long())
        return merge_shards(self.mesh, torch.stack(ds), torch.stack(gs), k)

    def query(self, query_mat, k: int, nprobe: int | None = None):
        """Top-k ``(ids, dists)``: ``nprobe`` cells of each shard (default
        √nlist) through the cluster scan, merged over the shards."""
        q = as_f32_matrix(query_mat, self.mesh.device)
        if self.metric == Dist.COSINE:
            q = normalise(q)
        k = max(1, min(k, self.n))
        nprobe = self.default_nprobe() if nprobe is None else nprobe
        nprobe = max(1, min(nprobe, self.nlist))
        if self.mesh.n_batch > 1:
            return self._query_grid(q, k, nprobe)
        d, ids = self._scan(q, self._route(q, nprobe), k)
        return ids, d

    def _query_grid(self, q: torch.Tensor, k: int, nprobe: int):
        """2-D ``(batch, db)`` query: routing once for the whole batch, then
        each query block with its own probe lists against every shard, the
        merge along ``db`` only. Per query it is the 1-D query's work."""
        nb = self.mesh.n_batch
        nq = q.shape[0]
        q = _pad_to_multiple(q, nb)
        bq = q.shape[0] // nb
        probes = self._route(q, nprobe)
        parts = [self._scan(q[b * bq : (b + 1) * bq], probes[b * bq : (b + 1) * bq], k)
                 for b in range(nb)]
        d = torch.cat([p[0] for p in parts])
        ids = torch.cat([p[1] for p in parts])
        return ids[:nq], d[:nq]


class ShardedIvfPqIndex(ShardedIvfIndex):
    """Sharded IVF-PQ: the distributed coarse quantiser and per-shard
    residual PQ cells.

    The codebooks are trained once on a strided sample of every shard's
    valid residuals (at most about 100k rows); each shard encodes its own
    rows. ``m == dim`` stores the int8 decode cache of the codes (mode
    ``i8dec_residual``, one set of per-dimension scales over all shards),
    any other ``m`` the uint8 codes (mode ``pq_residual``); both go through
    the cluster scan, as in the JAX package."""

    def __init__(self, mat, metric="euclidean", nlist=None, m=None,
                 max_iters=15, seed=42, mesh=None):
        self._m = m
        super().__init__(mat, metric, nlist=nlist, max_iters=max_iters, seed=seed, mesh=mesh)

    def _encode_shards(self, sorted_parts, owners_parts, seed):
        from ..models.quantised.quantisers import ProductQuantiser

        dim = self.dim
        m = self._m if self._m is not None else dim
        c = self.centroids
        res_parts = [s - c[o] for s, o in zip(sorted_parts, owners_parts)]

        # the training sample: every stride-th valid residual of all shards,
        # counted over the shards' valid rows in shard order
        stride = max(1, self.n // 100_000)
        valid = self._shard_valid
        first = np.concatenate([[0], np.cumsum(valid)[:-1]])
        take = [np.arange((-int(f)) % stride, v, stride) for f, v in zip(first, valid)]
        picks = [r[torch.as_tensor(take[s], device=r.device)]
                 for r, s in zip(res_parts, self.mesh.db_shards())]
        sample = _gather_rows(self.mesh, picks, [len(t) for t in take])
        self.pq = ProductQuantiser.train(sample, m, seed=seed)

        cosine = self.metric == Dist.COSINE

        def full_sq(rec, o):
            return sq_norms(rec + c[o]) if cosine else sq_norms(rec)

        storages, sqnorms = [], []
        if dim == m:
            dec_all = [self.pq.decode(self.pq.encode(r)) for r in res_parts]
            amax = [d[: valid[s]].abs().amax(dim=0) if valid[s] else d.new_zeros(dim)
                    for d, s in zip(dec_all, self.mesh.db_shards())]
            absmax = torch.clamp(gather_shards(self.mesh, torch.stack(amax)).amax(dim=0), min=1e-12)
            self.dec_scales = absmax / 127.0
            self.mode = "i8dec_residual"
            for dec, o in zip(dec_all, owners_parts):
                d8 = torch.clamp(torch.round(dec / self.dec_scales), -127, 127).to(torch.int8)
                storages.append(d8)
                sqnorms.append(full_sq(d8.float() * self.dec_scales, o))
        else:
            self.dec_scales = None
            self.mode = "pq_residual"
            for r, o in zip(res_parts, owners_parts):
                codes = self.pq.encode(r)
                storages.append(codes)
                sqnorms.append(full_sq(self.pq.decode(codes), o))
        return storages, sqnorms

    def _scan_codebooks(self):
        if self.mode == "i8dec_residual":
            return self.dec_scales
        return self.pq.codebooks
