"""Shared scaffolding of the IVF index family (port of
``annsearch_tpu.models.ivf_base``: the fused approximate tier, the fused
exact tier and its certificate, and the cluster scan behind both).

Build: k-means coarse quantiser → cluster-sorted storage → segment layout
(cells larger than ``seg_size`` split into segments sharing the cell's
centroid) → storage encoding (a subclass hook).

Query, two tiers over three scans:

* approximate (``approx=True``): route each query to its nearest
  segments → invert into per-segment task rows on the device → fused cell
  scan with the stride-class fold → remap to original ids;
* exact (``approx=False``; f32, bf16 and sq8 cells): route to the nearest
  *clusters* → expand to (query, segment) pairs (dense when no cell is
  split, else the compact pair lists) → fused scan with exact per-segment
  selection → for f32 and bf16 cells (kb ≥ k + 8) an elementwise f32
  rescore of a 2k pool; sq8 distances are exact in integer space, so its
  selection keeps k with no margin and no rescore. ``certify=True`` (f32
  cells) adds the triangle-inequality certificate, which re-probes every
  query whose k-th distance an unprobed cell could still beat;
* the cluster scan (``ops/ivf_scan.py``, tensor operations, exact per-cell
  selection) answers everything else, as in the JAX package: the PQ-coded
  modes, the exact tier of the int8-decode modes, and any shape the fused
  scan's gate refuses (k > 128, a ``seg_size`` that is no multiple of
  128). It routes to clusters and builds its task lists on the device when
  no cell is split, else on the host.

f64 queries to an index built from f64 data take a 2k pool from the f32
scan and rescore it in f64 on the host.
"""

from __future__ import annotations

import math
import warnings
from typing import Any

import numpy as np
import torch

from ..ops.ivf_scan import build_probe_lists_from_pairs, ivf_cluster_scan
from ..ops.ivf_scan_fused import fused_eligible, fused_ivf_scan, repack_blocks
from ..ops.probe_device import (
    build_probe_lists_compact,
    build_probe_lists_device,
    compact_probe_shapes,
    device_probe_shapes,
    expand_probes_device,
    route_pair_stats,
)
from ..utils import profiling
from ..utils.dist import Dist, matmul_t, normalise, sq_norms
from .base import BaseIndex, host_f64
from .kmeans import (
    assign_clusters,
    expand_probes_to_segments,
    segment_layout,
    train_centroids,
)

__all__ = ["IvfBase", "route_to_cells"]

#: modes whose exact tier is the fused scan (K1c), and those of them whose
#: scan distances are rounded: their selection keeps a margin of 8 and a 2k
#: pool is rescored in f32 (sq8's integer-space distances are exact)
_EXACT_MODES = ("f32", "bf16", "sq8")
_RESCORED_MODES = ("f32", "bf16")


def route_to_cells(
    q: torch.Tensor, centroids: torch.Tensor, nprobe: int, metric: Dist,
    precision=None,
) -> torch.Tensor:
    """The ``nprobe`` nearest centroids per query, ``[nq, nprobe]`` int64.

    fp32 matmul with TF32 off, so the JAX package's HIGHEST routing of
    certified queries (``route_hi``) is what every query gets here:
    ``precision`` is accepted and ignored. The
    selection is a stable sort, so equal distances go to the lower index:
    the segment centroids of a split cell are exact duplicates, and
    ``torch.topk`` promises no tie order. Stage ``ivf.route``."""
    with profiling.stage("ivf.route", q):
        dots = matmul_t(q, centroids, "highest")
        if metric == Dist.COSINE:
            d = 1.0 - dots
        else:
            d = sq_norms(q)[:, None] + sq_norms(centroids)[None, :] - 2.0 * dots
        return torch.sort(d, dim=1, stable=True).indices[:, :nprobe]


def _seg_radii(storage, sqn, seg_cents, row_seg, nseg: int) -> torch.Tensor:
    """Per-segment max squared distance of member rows to the owning
    centroid, f32 and elementwise (no matmul). Pad rows carry
    ``row_seg == nseg``."""
    c = seg_cents[torch.clamp(row_seg, max=nseg - 1)]
    dots = (storage.float() * c).sum(dim=-1)
    csq = (c * c).sum(dim=-1)
    d2 = torch.clamp(sqn + csq - 2.0 * dots, min=0.0)
    d2 = torch.where(row_seg < nseg, d2, 0.0)
    out = torch.zeros(nseg + 1, device=storage.device)
    return out.scatter_reduce_(0, row_seg, d2, "amax")[:nseg]


def _cert_flags(q, centroids, radii, dk, npr_used, metric: Dist):
    """Triangle-inequality exactness certificate. A row x of cell c has
    ``|q−x| ≥ |q−c| − r_c``, so a cell with ``(|q−c| − r_c)² > d_k`` cannot
    improve the current top-k. Returns, per query, the 1-based routing rank
    of the furthest cell that could still matter (``m_need``) and whether
    it lies past the probes already scanned. Cosine rides the same
    geometry: rows and queries are unit vectors, so ``1 − sim =
    |q−x|²/2``; centroids need not be, so they keep their real norms.

    fp32 matmul with TF32 off: the routing's own precision, so the ranks
    here are the router's and need no rank margin (the JAX package's
    default margin of 2 covers routing at bf16 precision)."""
    dots = matmul_t(q, centroids, "highest")
    dc2 = torch.clamp(sq_norms(q)[:, None] + sq_norms(centroids)[None, :] - 2.0 * dots, min=0.0)
    dk2 = torch.clamp(2.0 * dk if metric == Dist.COSINE else dk, min=0.0)
    dc = torch.sqrt(dc2)
    bound = torch.clamp(dc - radii[None, :], min=0.0) ** 2
    # float-grade slack: flag on ties rather than certify through noise
    viol = bound <= dk2[:, None] * (1.0 + 1e-3) + 1e-6
    # rank cells as the router ranks them (cosine routes by 1 − dot)
    dr = (1.0 - dots) if metric == Dist.COSINE else dc2
    order = torch.sort(dr, dim=1, stable=True).indices
    viol_sorted = torch.gather(viol, 1, order)
    rank = torch.arange(1, dc.shape[1] + 1, device=q.device)[None, :]
    m_need = torch.where(viol_sorted, rank, 0).max(dim=1).values
    return m_need, m_need > torch.clamp(npr_used, min=1)


def _lane_counts(cluster_ids, lists, seg_counts, nq: int, cap: int) -> dict[str, int]:
    """The cluster scan's ``lanes``, the ``ncl·maxq·cap`` (slot, row) pairs
    it scores over host lists, and ``pad_lanes``, those of slots holding the
    sentinel query or of rows past their segment's count (the sentinel
    segment has none)."""
    ncl, maxq = lists.shape
    sizes = np.append(np.asarray(seg_counts, np.int64), 0)
    real = (lists < nq).sum(axis=1)
    seg = np.minimum(cluster_ids.astype(np.int64), len(sizes) - 1)
    lanes = ncl * maxq * cap
    return {"lanes": lanes, "pad_lanes": lanes - int((real * sizes[seg]).sum())}


def _exact_rescore(q, storage, d, i, k: int, metric: Dist):
    """f32 rescore of a candidate pool, elementwise (``Σ(q−v)²`` or
    ``1 − Σ q·v``; no matmul identity); pool entries whose scan distance is
    not finite stay +inf. bf16 rows are upcast first: exact at storage
    precision. A stable top-k: ties go to the lower pool position, as
    ``lax.top_k`` breaks them."""
    v = storage[torch.clamp(i, 0, storage.shape[0] - 1)].float()   # [nq, kp, d]
    if metric == Dist.COSINE:
        dx = 1.0 - (q[:, None, :] * v).sum(dim=-1)
    else:
        diff = q[:, None, :] - v
        dx = (diff * diff).sum(dim=-1)
    dx = torch.where(torch.isfinite(d), dx, float("inf"))
    order = torch.sort(dx, dim=-1, stable=True).indices[:, :k]
    return torch.gather(dx, 1, order), torch.gather(i, 1, order)


class IvfBase(BaseIndex):
    """k-means routing + segmented cells + cell scan. Subclasses set
    ``mode`` and define ``_encode_storage`` and ``_decoded_sorted`` (and
    ``_codebooks`` for the PQ and int8-decode modes, ``_encode_queries``
    and ``_scan_seg_centroids`` where the scan scores in another space than
    routing)."""

    _state_arrays = (
        "storage", "store_sqnorms", "centroids", "seg_centroids",
        "seg_offsets", "seg_counts", "original_ids",
    )
    _state_scalars = ("n", "dim", "nlist", "seg_size")
    #: host copy of ``seg_counts`` (set at build and load), read only for
    #: the cluster scan's lane counts while tracing is on
    _seg_counts_host: np.ndarray | None = None

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
        # f64 data keeps a host copy only where the storage is full
        # precision: f64 queries are then answered at f64 grade
        if self.mode == "f32":
            self._x64 = host_f64(mat)
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
        self._seg_counts_host = np.asarray(layout.seg_counts, np.int64)
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

    def _codebooks(self) -> torch.Tensor | None:
        """What the scan decodes with: the PQ codebooks, or the ``[d]``
        decode scales of the int8-decode modes (None elsewhere)."""
        return None

    def _encode_queries(self, q: torch.Tensor) -> torch.Tensor:
        """The queries as the scan scores them (routing takes ``q``)."""
        return q

    def _scan_seg_centroids(self) -> torch.Tensor:
        """The segment centroids in the scan's scoring space."""
        return self.seg_centroids

    def _aux(self) -> torch.Tensor | None:
        """A per-row array the cluster scan reads beside the storage
        (RaBitQ: ``‖R·u‖₁``), or None."""
        return None

    def _segment_rows(self) -> tuple[np.ndarray, np.ndarray]:
        """``(rows, seg)``: every stored row's sorted position and its
        segment, segment by segment."""
        counts = self.seg_counts.cpu().numpy().astype(np.int64)
        offs = self.seg_offsets.cpu().numpy().astype(np.int64)
        seg = np.repeat(np.arange(len(counts)), counts)
        rows = offs[seg] + np.arange(counts.sum()) - (np.cumsum(counts) - counts)[seg]
        return rows, seg

    def _owner_clusters(self) -> torch.Tensor:
        """[n] owner cluster of each sorted row."""
        rows, seg = self._segment_rows()
        ptr = np.asarray(self._cluster_ptr)
        seg_owner = np.repeat(np.arange(len(ptr) - 1), np.diff(ptr))
        owners = np.zeros(self.n, np.int64)
        owners[rows] = seg_owner[seg]
        return torch.as_tensor(owners, device=self.device)

    def _seg_s_max(self) -> int:
        """Most segments of one cluster."""
        ptr = np.asarray(self._cluster_ptr)
        return int(np.diff(ptr).max()) if len(ptr) > 1 else 1

    def _cluster_ptr_dev(self) -> torch.Tensor:
        cached = getattr(self, "_ptr_dev_cache", None)
        if cached is None:
            cached = torch.as_tensor(np.asarray(self._cluster_ptr), device=self.device).long()
            self._ptr_dev_cache = cached
        return cached

    def _cell_radii(self) -> torch.Tensor:
        """[nlist] per-cell euclidean radii: f32 upper bounds with a small
        multiplicative slack, so that f32 rounding cannot under-state a
        radius and void the certificate. Built once per index."""
        cached = getattr(self, "_cell_radii_cache", None)
        if cached is None:
            nseg = int(self.seg_offsets.shape[0])
            rows, seg = self._segment_rows()
            row_seg = np.full(int(self.storage.shape[0]), nseg, np.int64)
            row_seg[rows] = seg
            seg_max = _seg_radii(
                self.storage, self.store_sqnorms, self.seg_centroids,
                torch.as_tensor(row_seg, device=self.device), nseg,
            ).cpu().numpy()
            ptr = np.asarray(self._cluster_ptr)
            radii = np.zeros(self.nlist, np.float32)
            full = ptr[1:] > ptr[:-1]
            if full.any():
                radii[full] = np.maximum.reduceat(seg_max, ptr[:-1][full])
            radii = np.sqrt(np.maximum(radii, 0.0) * (1.0 + 2e-3)) + 1e-6
            cached = torch.as_tensor(radii.astype(np.float32), device=self.device)
            self._cell_radii_cache = cached
        return cached

    # -- queries -------------------------------------------------------------

    def default_nprobe(self) -> int:
        """√nlist."""
        return max(1, math.isqrt(self.nlist))

    def query(
        self,
        query_mat: Any,
        k: int,
        nprobe: int | None = None,
        k_scan: int | None = None,
        approx: bool = False,
        q_split: bool | None = None,
        certify: bool = False,
        fold_depth: int = 2,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Top-k ``(ids, dists)``.

        ``approx=True`` is the fused approximate tier: each (query,
        segment) keeps kb ≥ k candidates from a depth-2 stride-class fold,
        and the cross-segment top-k is exact. ``approx=False`` (the default)
        is the exact tier: exact within the probed cells at storage
        precision, by the fused exact selection for f32, bf16 and sq8 cells
        and by the cluster scan for the int8-decode and PQ modes. Where the
        fused scan does not take the index (PQ codes, k > 128, a
        ``seg_size`` that is no multiple of 128), both values of ``approx``
        take the cluster scan and its exact per-cell selection: the JAX
        package's approximate selection there (``lax.approx_min_k``) has
        no counterpart on the card. ``certify=True`` (exact f32 tier only)
        makes the answer provably exact at f32-selection grain: ``nprobe``
        then sets the starting probe count. ``k_scan`` widens the scanned
        pool (the result then has ``k_scan`` columns). f64 queries to an
        index built from f64 data answer at f64 grade (dists float64).
        ``q_split`` acts, as in the JAX package, only in the fused
        approximate tier of the int8-decode modes: ``None`` and ``False``
        score one bf16 query term (kernels K1a, K1b-cos), ``True`` two
        (K1b-l2, K1b-cos); everywhere else it is ignored. ``fold_depth``
        (1 or 2) is the fused approximate tier's fold depth, the JAX
        package's ``ANNSEARCH_IVF_FOLD1`` as an argument."""
        if certify and (approx or self.mode != "f32"):
            raise ValueError(
                "certify=True requires the exact f32 tier (approx=False and a "
                "plain-f32 IVF index): quantised storage cannot certify exact "
                "distances"
            )
        with profiling.stage("ivf.query", self.device) as st:
            q64 = self._f64_queries(query_mat) if k_scan is None else None
            if q64 is not None:
                k_scan = min(2 * self._clamp_k(k), self.n)
            q = self._prep_queries(query_mat)
            st.count(queries=q.shape[0])
            ids, d = self._query_prepped(q, k, nprobe, k_scan, approx, q_split, fold_depth)
            if q64 is not None:
                ids, d = self._rescore_f64(q64, ids, k)
            if certify:
                npr = self.default_nprobe() if nprobe is None else nprobe
                if max(1, min(npr, self.nlist)) < self.nlist:
                    ids, d = self._certify(q, ids, d, k, npr, k_scan, q64)
            return ids, d

    def _certify(self, q, ids, d, k, nprobe, k_scan, q64):
        """Run the certificate (:func:`_cert_flags`) and re-query every
        flagged query at the certified probe count, rounded up to a power
        of two (the rounding decides which cells the re-query probes). The
        re-query's probe set contains the first one (same routing, more
        probes), so flagged rows are overwritten, not merged. Each pass at
        least doubles the flagged rows' probes, so the loop ends within
        log2(nlist) + 2 passes; the cap guards an invariant bug."""
        kc = self._clamp_k(k)
        npr = max(1, min(nprobe, self.nlist))
        radii = self._cell_radii()
        npr_used = np.full(q.shape[0], npr, np.int64)
        sel = np.arange(q.shape[0])
        ids, d = ids.clone(), d.clone()
        max_passes = max(int(self.nlist).bit_length() + 2, 8)
        for _ in range(max_passes):
            sel_t = torch.as_tensor(sel, device=self.device)
            # rows that scanned every cell are exact by construction
            nu = np.where(npr_used[sel] >= self.nlist, self.nlist + 8, npr_used[sel])
            m_need, flags = _cert_flags(
                q[sel_t], self.centroids, radii, d[sel_t, kc - 1].float(),
                torch.as_tensor(nu, device=self.device), self.metric,
            )
            flags = flags.cpu().numpy()
            if not flags.any():
                break
            m_need = m_need.cpu().numpy()
            rows = sel[flags]
            want = int(max(m_need[flags].max() + 2, npr_used[rows].max() + 1))
            npr2 = min(self.nlist, 1 << (want - 1).bit_length())
            rows_t = torch.as_tensor(rows, device=self.device)
            ids2, d2 = self._query_prepped(q[rows_t], k, npr2, k_scan, False)
            if q64 is not None:
                ids2, d2 = self._rescore_f64(q64[rows], ids2, kc)
            ids[rows_t] = ids2
            d[rows_t] = d2.to(d.dtype)
            npr_used[rows] = npr2
            sel = rows
            if npr2 >= self.nlist:
                break
        else:
            warnings.warn(
                f"certify=True: the probe certificate still flagged {len(sel)} "
                f"queries after {max_passes} passes; their results are "
                "returned uncertified (a certificate invariant is broken)",
                RuntimeWarning,
            )
        return ids, d

    def _scan(self, q: torch.Tensor, k: int, nprobe: int, approx: bool = False,
              q_split: bool | None = None, fold_depth: int = 2, mode: str | None = None,
              q_eff: torch.Tensor | None = None):
        """Route → task lists → scan. Returns (dists [nq, k],
        sorted-storage positions [nq, k]). ``mode`` scans the storage in
        another mode than the index's (the binary index's ``binary_asym``
        tier) and ``q_eff`` gives the scoring-space queries; either sends
        the batch to the cluster scan, as in the JAX package."""
        if mode is not None or q_eff is not None:
            return self._scan_cluster(q, k, nprobe, mode, q_eff)
        fused = fused_eligible(self.mode, self.seg_size, int(self.storage.shape[1]), k)
        if approx and fused:
            # q_split None is one bf16 query pass: the int8 codes' own
            # quantisation dominates the query's rounding there, and no
            # other mode reads the knob
            return self._scan_approx(q, k, nprobe, bool(q_split), fold_depth)
        if not approx and fused and self.mode in _EXACT_MODES:
            return self._scan_exact(q, k, nprobe)
        return self._scan_cluster(q, k, nprobe)

    def _fused_args(self):
        cells, sn = self._fused_blocks()
        return cells, sn, self.seg_offsets, self.seg_counts, self._scan_seg_centroids()

    def _segment_probes(self, nprobe: int) -> int:
        """``nprobe`` scaled to segments, so that the probed share of the
        database matches cell semantics."""
        nseg = int(self.seg_offsets.shape[0])
        return min(nseg, max(nprobe, -(-nprobe * nseg) // max(self.nlist, 1)))

    def _scan_approx(self, q, k, nprobe, q_split, fold_depth=2):
        # route straight to segments: a split cell's segments are duplicate
        # routing rows, probed together
        nprobe_seg = self._segment_probes(nprobe)
        kb = max(8, 1 << (max(k, 1) - 1).bit_length())
        probes = route_to_cells(q, self.seg_centroids, nprobe_seg, self.metric)
        cluster_ids, lists, gmap = self._device_lists(probes, nprobe_seg)
        return fused_ivf_scan(
            self._encode_queries(q), cluster_ids, lists, gmap, *self._fused_args(), k,
            self.metric, self.mode, self._codebooks(), kb, q_split=q_split,
            fold_depth=fold_depth,
        )

    def _scan_cluster(self, q, k, nprobe, mode=None, q_eff=None):
        """Route to clusters, expand to (query, segment) tasks and run the
        cluster scan (in ``mode``, default the index's, over ``q_eff``,
        default ``_encode_queries(q)``). With no split cell the expansion
        is the identity and the lists are built on the device; split cells
        would cost the dense expansion its sentinel slots as real scan rows,
        so their lists are built on the host from the real pairs."""
        nq = q.shape[0]
        nseg = int(self.seg_offsets.shape[0])
        probes = route_to_cells(q, self.centroids, nprobe, self.metric)
        host = None
        if self._seg_s_max() == 1 and nq * nprobe < (1 << 26):
            lists = self._device_lists(
                expand_probes_device(probes, self._cluster_ptr_dev(), 1, nseg), nprobe)
        else:
            with profiling.stage("ivf.host_lists", q):
                qs, segs = expand_probes_to_segments(
                    probes.cpu().numpy(), np.asarray(self._cluster_ptr)
                )
                host = build_probe_lists_from_pairs(qs, segs, nseg, nq)
                lists = tuple(torch.as_tensor(a.astype(np.int64), device=self.device)
                              for a in host)
        with profiling.stage("ivf.cluster_scan", q) as st:
            if st and host is not None and self._seg_counts_host is not None:
                st.count(**_lane_counts(*host[:2], self._seg_counts_host, nq, self.seg_size))
            return ivf_cluster_scan(
                self._encode_queries(q) if q_eff is None else q_eff, *lists, self.storage,
                self.store_sqnorms, self.seg_offsets, self.seg_counts,
                self._scan_seg_centroids(), k, self.metric, self.seg_size,
                self.mode if mode is None else mode, codebooks=self._codebooks(),
                aux=self._aux(),
            )

    def _device_lists(self, seg_probes, nprobe):
        """Task lists of the segment probes ``[nq, nprobe·s]`` (sentinel
        ``nseg``), built on the device: stage ``ivf.lists``, whose counts are
        the ``nq·nprobe`` (query, segment) pairs and the lists' slots."""
        nq, T = seg_probes.shape
        nseg = int(self.seg_offsets.shape[0])
        with profiling.stage("ivf.lists", seg_probes) as st:
            maxq, R = device_probe_shapes(nq, nprobe, nseg, T // nprobe)
            if st:
                st.count(pairs=nq * nprobe, slots=R * maxq)
            return build_probe_lists_device(seg_probes, nseg, maxq, R)

    def _scan_exact(self, q, k, nprobe):
        """Recall-1.0 tier: route to clusters, expand to segments, exact
        per-segment selection. f32 and bf16 cells: kb ≥ k + 8 (a margin
        against rank flips of rounded distances), a 2k pool rescored
        elementwise in f32. sq8 cells: kb ≥ k and no rescore, since their
        integer-space distances are exact."""
        nq = q.shape[0]
        nseg = int(self.seg_offsets.shape[0])
        s_max = self._seg_s_max()
        ptr = self._cluster_ptr_dev()
        rescored = self.mode in _RESCORED_MODES
        margin = 8 if rescored else 0
        kb = min(max(8, -(-(k + margin) // 8) * 8), 128)
        probes = route_to_cells(q, self.centroids, nprobe, self.metric)
        if s_max == 1:
            # no split cells: the dense expansion is the identity
            cluster_ids, lists, gmap = self._device_lists(
                expand_probes_device(probes, ptr, s_max, nseg), nprobe)
        else:
            # split cells: the dense [nq, nprobe·s_max] expansion is mostly
            # sentinels on skewed layouts, so size the lists to the real
            # (query, segment) pairs — two scalars read back to the host
            with profiling.stage("ivf.lists", q) as st:
                total, qmax = route_pair_stats(probes, ptr).tolist()
                P, T_g, maxq, R = compact_probe_shapes(total, qmax, nseg)
                if st:
                    st.count(pairs=total, slots=R * maxq)
                cluster_ids, lists, gmap = build_probe_lists_compact(
                    probes, ptr, P, T_g, nseg, maxq, R
                )
        d, i = fused_ivf_scan(
            self._encode_queries(q), cluster_ids, lists, gmap, *self._fused_args(),
            min(2 * k, 128) if rescored else k, self.metric, self.mode,
            self._codebooks(), kb, selection="exact",
        )
        if not rescored:
            return d, i
        return _exact_rescore(q, self.storage, d, i, k, self.metric)

    def _query_prepped(self, q, k, nprobe=None, k_scan=None, approx=False, q_split=None,
                       fold_depth=2):
        k = self._clamp_k(k)
        nprobe = self.default_nprobe() if nprobe is None else nprobe
        nprobe = max(1, min(nprobe, self.nlist))
        d, i = self._scan(q, k if k_scan is None else k_scan, nprobe, approx, q_split,
                          fold_depth)
        ids = self.original_ids[torch.clamp(i, 0, self.n - 1)]
        return ids, d

    def generate_knn(
        self, k: int, nprobe: int | None = None, **kw
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Self-query of every stored row through the exact tier (each row
        finds itself)."""
        q = self.vectors_original_order()
        if self.metric == Dist.COSINE:
            q = normalise(q)
        return self._query_prepped(q, k, nprobe, kw.get("k_scan"))

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
