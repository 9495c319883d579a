"""Shared scaffolding of the IVF index family (port of
``annsearch_tpu.models.ivf_base``, the fused approximate tier).

Build: k-means coarse quantiser → cluster-sorted storage → segment layout
(cells larger than ``seg_size`` split into segments sharing the cell's
centroid) → storage encoding (a subclass hook). Query: route each query to
its nearest segments → invert into per-segment task rows on the device →
fused cell scan (``ops/ivf_scan_fused.py``) → remap to original ids.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from ..ops.ivf_scan_fused import fused_eligible, fused_ivf_scan, repack_blocks
from ..ops.probe_device import build_probe_lists_device, device_probe_shapes
from ..utils.dist import Dist, matmul_t, sq_norms
from .base import BaseIndex
from .kmeans import assign_clusters, segment_layout, train_centroids

__all__ = ["IvfBase", "route_to_cells"]


def route_to_cells(
    q: torch.Tensor, centroids: torch.Tensor, nprobe: int, metric: Dist
) -> torch.Tensor:
    """The ``nprobe`` nearest centroids per query, ``[nq, nprobe]`` int64.

    fp32 matmul with TF32 off. The selection is a stable sort, so equal
    distances go to the lower index: the segment centroids of a split cell
    are exact duplicates, and ``torch.topk`` promises no tie order."""
    dots = matmul_t(q, centroids, "highest")
    if metric == Dist.COSINE:
        d = 1.0 - dots
    else:
        d = sq_norms(q)[:, None] + sq_norms(centroids)[None, :] - 2.0 * dots
    return torch.sort(d, dim=1, stable=True).indices[:, :nprobe]


class IvfBase(BaseIndex):
    """k-means routing + segmented cells + fused cell scan. Subclasses set
    ``mode`` and define ``_encode_storage``, ``_scan_scales`` and
    ``_decoded_sorted``."""

    _state_arrays = (
        "storage", "store_sqnorms", "centroids", "seg_centroids",
        "seg_offsets", "seg_counts", "original_ids",
    )
    _state_scalars = ("n", "dim", "nlist", "seg_size")

    def __init__(
        self,
        mat: Any,
        metric: str | Dist = "euclidean",
        nlist: int | None = None,
        max_iters: int = 30,
        seed: int = 42,
        seg_size: int | None = None,
        verbose: bool = False,
        device="cuda",
        **encode_kwargs,
    ):
        super().__init__(mat, metric, device)
        x = self.vectors  # normalised already if cosine
        nlist = min(max(1, math.isqrt(self.n)) if nlist is None else nlist, self.n)

        self.nlist = nlist
        self.centroids = train_centroids(
            x, nlist, self.metric, max_iters=max_iters, seed=seed
        )
        assignments, _ = assign_clusters(x, self.centroids, self.metric)
        layout = segment_layout(assignments.cpu().numpy(), nlist, seg_size)
        self.seg_size = int(layout.seg_size)
        self._cluster_ptr = layout.cluster_ptr
        self.seg_offsets = torch.as_tensor(layout.seg_offsets, device=self.device)
        self.seg_counts = torch.as_tensor(layout.seg_counts, device=self.device)
        self.seg_centroids = self.centroids[
            torch.as_tensor(layout.seg_cluster, device=self.device).long()
        ]
        self.original_ids = torch.as_tensor(layout.order, device=self.device).long()
        self.vectors = None  # replaced by the encoded storage
        self.sqnorms = None
        self._encode_storage(x, self.original_ids, seed=seed, **encode_kwargs)
        if verbose:
            c = layout.counts
            print(
                f"IVF built: nlist={nlist} nseg={layout.nseg} "
                f"seg_size={self.seg_size} cells min/med/max = "
                f"{c.min()}/{int(np.median(c))}/{c.max()}"
            )

    # -- storage ------------------------------------------------------------

    def _pad_storage(self, storage: torch.Tensor, sqnorms: torch.Tensor) -> None:
        """Append ``seg_size`` zero rows: the scan's sentinel lanes of a
        short segment map into them."""
        pad = self.seg_size
        self.storage = torch.cat(
            [storage, storage.new_zeros((pad,) + tuple(storage.shape[1:]))]
        )
        self.store_sqnorms = torch.cat([sqnorms, sqnorms.new_zeros(pad)])

    def _fused_blocks(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Block-aligned storage tiles for the fused scan, built once."""
        cached = getattr(self, "_fused_blocks_cache", None)
        if cached is None:
            cached = repack_blocks(
                self.storage, self.store_sqnorms, self.seg_offsets, self.seg_size
            )
            self._fused_blocks_cache = cached
        return cached

    def _owner_clusters(self) -> torch.Tensor:
        """[n] owner cluster of each sorted row."""
        ptr = np.asarray(self._cluster_ptr)
        seg_owner = np.repeat(np.arange(len(ptr) - 1), np.diff(ptr))
        counts = self.seg_counts.cpu().numpy().astype(np.int64)
        offs = self.seg_offsets.cpu().numpy().astype(np.int64)
        owners = np.zeros(self.n, np.int64)
        rows = np.repeat(offs, counts) + (
            np.arange(counts.sum()) - np.repeat(np.cumsum(counts) - counts, counts)
        )
        owners[rows] = np.repeat(seg_owner, counts)
        return torch.as_tensor(owners, device=self.device)

    # -- queries -------------------------------------------------------------

    def default_nprobe(self) -> int:
        """√nlist."""
        return max(1, math.isqrt(self.nlist))

    def query(
        self,
        query_mat: Any,
        k: int,
        nprobe: int | None = None,
        approx: bool = False,
        q_split: bool | None = None,
        certify: bool = False,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Top-k ``(ids, dists)`` through the fused approximate tier.

        ``approx=True`` is the only tier ported: each (query, segment)
        keeps kb ≥ k candidates from a depth-2 stride-class fold, and the
        cross-segment top-k is exact. ``q_split`` resolves to one bf16
        query pass for the int8 modes, as in the JAX package."""
        if not approx:
            raise NotImplementedError(
                "approx=False (the exact IVF tier) is ROADMAP Queue 1 item 10"
            )
        if certify:
            raise NotImplementedError(
                "certify=True (the probe certificate) is ROADMAP Queue 1 item 10"
            )
        if q_split:
            raise NotImplementedError(
                "q_split=True (two bf16 query terms) is kernel K1b, "
                "ROADMAP Queue 2"
            )
        return self._query_prepped(self._prep_queries(query_mat), k, nprobe)

    def _scan(self, q: torch.Tensor, k: int, nprobe: int):
        """Route to segments → task lists → fused scan. Returns
        (dists [nq, k], sorted-storage positions [nq, k])."""
        nq = q.shape[0]
        if not fused_eligible(self.mode, self.seg_size, self.dim, k):
            raise NotImplementedError(
                f"mode={self.mode!r} seg_size={self.seg_size} k={k} needs the "
                "XLA-style cluster scan (ROADMAP Queue 1 item 10) or kernels "
                "K1b–K1d (ROADMAP Queue 2)"
            )
        # route straight to segments: a split cell's segments are duplicate
        # routing rows, probed together; nprobe scales to segments so the
        # probed fraction of the database matches cell semantics
        nseg = int(self.seg_offsets.shape[0])
        nprobe_seg = min(nseg, max(nprobe, -(-nprobe * nseg) // max(self.nlist, 1)))
        maxq, R = device_probe_shapes(nq, nprobe_seg, nseg, 1)
        cells, sn = self._fused_blocks()
        kb = max(8, 1 << (max(k, 1) - 1).bit_length())
        probes = route_to_cells(q, self.seg_centroids, nprobe_seg, self.metric)
        cluster_ids, lists, gmap = build_probe_lists_device(probes, nseg, maxq, R)
        return fused_ivf_scan(
            q, cluster_ids, lists, gmap, cells, sn, self.seg_offsets,
            self.seg_counts, self.seg_centroids, k, self.metric, self.mode,
            self._scan_scales(), kb,
        )

    def _query_prepped(self, q, k, nprobe=None):
        k = self._clamp_k(k)
        nprobe = self.default_nprobe() if nprobe is None else nprobe
        nprobe = max(1, min(nprobe, self.nlist))
        d, i = self._scan(q, k, nprobe)
        ids = self.original_ids[torch.clamp(i, 0, self.n - 1)]
        return ids, d

    # -- plumbing ------------------------------------------------------------

    def vectors_original_order(self) -> torch.Tensor:
        """Decoded stored vectors in original row order."""
        inv = torch.empty_like(self.original_ids)
        inv[self.original_ids] = torch.arange(self.n, device=self.device)
        return self._decoded_sorted()[inv]

    def _save_arrays(self) -> dict[str, np.ndarray]:
        arrays = super()._save_arrays()
        arrays["cluster_ptr"] = np.asarray(self._cluster_ptr)
        # the JAX package's dtypes, so that either package loads the file
        for name in ("seg_offsets", "seg_counts", "original_ids"):
            arrays[name] = arrays[name].astype(np.int32)
        return arrays
