"""kMkNN index: exact search with k-means triangle-inequality pruning (port
of ``annsearch_tpu.models.kmknn``).

The reference walks clusters per query in ascending centroid distance and
stops by the triangle bound; that early exit does not batch, so the same
guarantee comes in two fixed phases, as in the JAX package:

  1. scan the ``p0`` nearest cells of each query (the cluster scan,
     ``ops/ivf_scan.py``) → an upper bound ``kth(q)`` on the k-th distance;
  2. the triangle bound ``lb(q, c) = max(0, d(q, c) − r_c)²`` (``r_c`` the
     cell's radius) marks every other cell that could still hold a better
     row; exactly those (query, cell) pairs are scanned and merged.

A cell left out has ``lb ≥ kth ≥`` the true k-th distance, so the result is
exact. The routing distances that feed the bound are FP32 with TF32 off
(the JAX package's HIGHEST): a coarser product could exclude a cell that
holds a true neighbour.

Cosine: rows are normalised and the euclidean machinery runs inside
(euclidean k-means: the bound needs euclidean geometry); distances are
reported as ``d²/2 = 1 − cos``.

Not ported: ``_phase2_need_packed``'s bit packing, which shrank a readback
through a slow host link; phase 2's selection is a bool mask here, and the
packed ``(dists, ids-as-f32)`` readback is two tensors.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from ..ops.ivf_scan import build_probe_lists_from_pairs, ivf_cluster_scan
from ..ops.probe_device import (
    build_probe_lists_device,
    device_probe_shapes,
    expand_probes_device,
)
from ..ops.topk import merge_topk, topk_smallest
from ..utils.dist import Dist, matmul_t, sq_norms
from .base import BaseIndex, host_f64
from .kmeans import assign_clusters, expand_probes_to_segments, segment_layout, train_centroids

__all__ = ["KmknnIndex"]


def _route_kmknn(q: torch.Tensor, centroids: torch.Tensor, p0: int):
    """``(cd2 [nq, nlist], probes [nq, p0])``: squared centroid distances
    (FP32, TF32 off, clamped at 0) and the p0 nearest cells."""
    cd2 = torch.clamp(
        sq_norms(q)[:, None] + sq_norms(centroids)[None, :]
        - 2.0 * matmul_t(q, centroids, "highest"),
        min=0.0,
    )
    return cd2, topk_smallest(cd2, p0)[1]


def _phase2_need(cd2, kth, radii, cell_counts, probes) -> torch.Tensor:
    """``[nq, nlist]`` bool: the non-empty cells not probed in phase 1 whose
    triangle bound lies under the query's phase-1 k-th distance."""
    lb = torch.clamp(torch.sqrt(cd2) - radii[None, :], min=0.0) ** 2
    need = (lb < kth[:, None]) & (cell_counts[None, :] > 0)
    probed = torch.zeros_like(need).scatter_(1, probes, True)
    return need & ~probed


def _kmknn_phase1(index, q, k, p0):
    """Route → device task lists → exact cluster scan; returns ``(d1, i1,
    need)`` (positions in the sorted storage, and phase 2's cells)."""
    nq = q.shape[0]
    nseg = int(index.seg_offsets.shape[0])
    maxq, R = device_probe_shapes(nq, p0, nseg, index._s_max)
    cd2, probes = _route_kmknn(q, index.centroids, p0)
    seg_probes = expand_probes_device(probes, index._cluster_ptr_dev, index._s_max, nseg)
    lists = build_probe_lists_device(seg_probes, nseg, maxq, R)
    d1, i1 = index._scan(q, lists, k)
    return d1, i1, _phase2_need(cd2, d1[:, k - 1], index.radii, index.cell_counts, probes)


def _kmknn_phase2(index, q, need, d1, i1, k):
    """Scan the (query, cell) pairs of ``need`` (host lists over the real
    pairs) and merge with phase 1."""
    qrows, crows = (a.cpu().numpy() for a in torch.nonzero(need, as_tuple=True))
    if not len(qrows):
        return d1, i1
    qs2, segs2 = expand_probes_to_segments(crows[:, None], index._cluster_ptr)
    lists = [torch.as_tensor(a.astype(np.int64), device=q.device)
             for a in build_probe_lists_from_pairs(qrows[qs2], segs2,
                                                   int(index.seg_offsets.shape[0]), q.shape[0])]
    d2, i2 = index._scan(q, lists, k)
    return merge_topk(d1, i1, d2, i2, k)


class KmknnIndex(BaseIndex):
    """Exact k-means-pruned search."""

    def _fallback_vectors(self):
        # the storage is cluster-sorted with seg_size pad rows: map back by
        # original_ids (the pad rows must not enter the scan)
        return self.vectors[: self.n], self.sqnorms[: self.n], self.original_ids[: self.n]

    def __init__(
        self,
        mat: Any,
        metric: str = "euclidean",
        nlist: int | None = None,
        max_iters: int = 30,
        seed: int = 42,
        verbose: bool = False,
        device="cuda",
    ):
        self._x64 = host_f64(mat)
        super().__init__(mat, metric, device)
        x = self.vectors  # normalised if cosine: euclidean runs inside
        nlist = min(max(1, math.isqrt(self.n)) if nlist is None else nlist, self.n)
        self.nlist = nlist
        self.centroids = train_centroids(x, nlist, Dist.EUCLIDEAN, max_iters=max_iters, seed=seed)
        assignments, d2c = assign_clusters(x, self.centroids, Dist.EUCLIDEAN)
        layout = segment_layout(assignments.cpu().numpy(), nlist)
        order = torch.as_tensor(layout.order, device=self.device).long()
        # per-cell radius: the largest member distance to its centroid
        radii = torch.zeros(nlist, device=self.device).scatter_reduce_(
            0, assignments, torch.sqrt(d2c), "amax")
        self._set_state(
            x[order], order, layout.seg_offsets, layout.seg_counts, layout.seg_cluster,
            layout.cluster_ptr, int(layout.seg_size), radii, layout.counts,
        )
        if verbose:
            print(f"kMkNN built: nlist={nlist} nseg={layout.nseg} seg_size={self.seg_size}")

    def _set_state(self, x_sorted, original_ids, seg_offsets, seg_counts, seg_cluster,
                   cluster_ptr, seg_size, radii, cell_counts) -> None:
        """The segmented storage and the pruning state (the arrays the JAX
        index saves); ``centroids`` is set already."""
        dev = self.device
        self.seg_size = seg_size
        self.seg_offsets = torch.as_tensor(np.asarray(seg_offsets), device=dev)
        self.seg_counts = torch.as_tensor(np.asarray(seg_counts), device=dev)
        self.seg_centroids = self.centroids[
            torch.as_tensor(np.asarray(seg_cluster), device=dev).long()]
        self.original_ids = torch.as_tensor(original_ids, device=dev).long()
        self.radii = torch.as_tensor(radii, device=dev).float()
        self.cell_counts = torch.as_tensor(np.asarray(cell_counts), device=dev)
        self.vectors = torch.cat([x_sorted, torch.zeros((seg_size, self.dim), device=dev)])
        self.sqnorms = sq_norms(self.vectors)
        self._cluster_ptr = np.asarray(cluster_ptr, np.int64)
        self._seg_cluster = np.asarray(seg_cluster, np.int32)
        self._cluster_ptr_dev = torch.as_tensor(self._cluster_ptr, device=dev)
        self._s_max = int(np.diff(self._cluster_ptr).max()) if len(self._cluster_ptr) > 1 else 1

    def _scan(self, q, lists, k):
        """The exact cluster scan of task ``lists`` over the sorted storage
        (euclidean, f32)."""
        return ivf_cluster_scan(q, *lists, self.vectors, self.sqnorms, self.seg_offsets,
                                self.seg_counts, self.seg_centroids, k, Dist.EUCLIDEAN,
                                self.seg_size, "f32")

    def query(
        self, query_mat: Any, k: int, p0: int | None = None, exact_fallback: bool = True,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Exact top-k ``(ids, dists)``. ``p0`` cells are scanned in phase 1
        (default √nlist). Small batches take one exact scan unless
        ``exact_fallback=False`` (the same answer); f64 queries to an index
        built from f64 data are answered at f64 grade (a 2k pool rescored
        on the host)."""
        kq = self._clamp_k(k)
        q64 = self._f64_queries(query_mat)
        if q64 is not None:
            kq = min(2 * kq, self.n)
        q = self._prep_queries(query_mat)
        if exact_fallback and self._exact_fallback_ok(q.shape[0]):
            ids, d = self._exact_query_small(q, kq)
        else:
            ids, d = self._query_prepped(q, kq, p0)
        if q64 is not None:
            return self._rescore_f64(q64, ids, k)
        return ids, d

    def _query_prepped(self, q, k, p0=None):
        k = self._clamp_k(k)
        p0 = min(p0 if p0 is not None else max(1, math.isqrt(self.nlist)), self.nlist)
        d1, i1, need = _kmknn_phase1(self, q, k, p0)
        d, i = _kmknn_phase2(self, q, need, d1, i1, k)
        if self.metric == Dist.COSINE:
            d = d * 0.5  # unit sphere: d²/2 = 1 − cos
        return self.original_ids[torch.clamp(i, 0, self.n - 1)], d

    def _inverse(self) -> torch.Tensor:
        inv = torch.empty_like(self.original_ids)
        inv[self.original_ids] = torch.arange(self.n, device=self.device)
        return inv

    def generate_knn(self, k: int, **kw):
        """Every stored row's exact top-k (itself included), in original
        row order."""
        ids, d = self._query_prepped(self.vectors[: self.n], k, kw.get("p0"))
        inv = self._inverse()
        return ids[inv], d[inv]

    def vectors_original_order(self) -> torch.Tensor:
        return self.vectors[: self.n][self._inverse()]

    def memory_usage_bytes(self) -> int:
        return 4 * (self.vectors.numel() + self.sqnorms.numel() + self.centroids.numel()
                    + self.seg_centroids.numel() + self.radii.numel()
                    + self.cell_counts.numel() + self.seg_offsets.numel()
                    + self.seg_counts.numel() + self.original_ids.numel())

    # -- persistence: the JAX package's npz layout -------------------------

    def save(self, path: str) -> None:
        np.savez(
            path,
            vectors=self.vectors.cpu().numpy(),
            centroids=self.centroids.cpu().numpy(),
            seg_centroids=self.seg_centroids.cpu().numpy(),
            seg_offsets=self.seg_offsets.cpu().numpy(),
            seg_counts=self.seg_counts.cpu().numpy(),
            original_ids=self.original_ids.cpu().numpy().astype(np.int32),
            radii=self.radii.cpu().numpy(),
            cell_counts=self.cell_counts.cpu().numpy(),
            cluster_ptr=self._cluster_ptr,
            seg_cluster=self._seg_cluster,
            meta=np.array([self.n, self.dim, self.nlist, self.seg_size,
                           1 if self.metric == Dist.COSINE else 0]),
        )

    @classmethod
    def load(cls, path: str, device="cuda") -> "KmknnIndex":
        """Load an index saved by either package's ``save`` (npz)."""
        from ..interop import kmknn_from_jax_arrays

        with np.load(path if path.endswith(".npz") else path + ".npz") as z:
            arrays = {f: z[f] for f in z.files}
        meta = arrays.pop("meta")
        return kmknn_from_jax_arrays(arrays, {
            "n": int(meta[0]), "dim": int(meta[1]), "nlist": int(meta[2]),
            "seg_size": int(meta[3]),
            "metric": "cosine" if int(meta[4]) == 1 else "euclidean"}, device)
