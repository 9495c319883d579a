"""Tree indexes: Annoy (hyperplane forest), kd-forest, ball tree (port of
``annsearch_tpu.models.trees``).

The reference queries trees with per-query backtracking priority queues
and search budgets; here, as in the JAX package, the budget is the width
of a candidate set:

  * Annoy / kd-forest: every tree routes the query to a leaf (all trees
    descend together, one gather and one FP32 dot per level), and
    ``n_probes − 1`` more descents each flip the split whose margin
    ``|proj − thr|`` is the smallest not yet flipped. Two routes score the
    probed leaves. The fused route (the default where the layout fits
    ``_scan_setup``) stores each tree's sorted rows as contiguous cells of
    one segmented storage, so a probed leaf is a cell scan: device task
    lists → ``fused_ivf_scan(mode="f32", groups=n_trees)`` (kernel K1d-f32,
    then a top-k per tree: K1-groups) → the id dedup. The gather route
    gathers the probed leaves' rows and reranks them exactly
    (``ops.rerank.rerank_exact``).
  * Ball tree: cells are ``max(128, leaf)``-row blocks of the sorted order
    ranked by their nearest leaf centre; the best ``beam`` are scanned by
    the fused scan (K1d-f32). Below ``_BALL_FUSED_MIN_CELLS`` cells the
    gather route reranks the ``beam`` nearest leaves exactly.

Not ported: ``ANNSEARCH_TREE_SPLIT_RERANK`` and ``rerank_exact_split``
(bf16 hi/lo tables for the TPU's gathers), the ``packed2`` lane layout
(f32 rows are scored as six cross terms of a three-way split on the
tensor cores), the packed ``(dists, ids-as-f32)``
results (ids come back as int64 tensors), ``ANNSEARCH_NO_PALLAS`` and the
``interpret`` plumbing.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from ..ops.ivf_scan_fused import fold_kb, fused_eligible, fused_ivf_scan, repack_blocks
from ..ops.probe_device import build_probe_lists_device, device_probe_shapes
from ..ops.rerank import rerank_exact
from ..ops.tree import PartitionTree, build_partition_forest, build_partition_tree
from ..utils.dist import Dist, fp32_matmul, parse_ann_dist, sq_norms
from .base import BaseIndex

__all__ = ["AnnoyIndex", "KdTreeIndex", "BallTreeIndex"]

# below this many scan cells the fused path loses recall to probe
# granularity; the rerank path serves small trees (tests lower it)
_BALL_FUSED_MIN_CELLS = 512


def _sentinel_rows(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.zeros((1, x.shape[1]), device=x.device)])


def _descend(q, norms_lv, thrs_lv, flip_lv=None, want_margins=False):
    """All trees at once: ``node [bq, nt]`` leaf per tree, the split at
    level ``flip_lv [bq, nt]`` inverted where given; with ``want_margins``
    also ``|proj − thr|`` per level. FP32 dots (TF32 off)."""
    bq, nt = q.shape[0], norms_lv[0].shape[0]
    tix = torch.arange(nt, device=q.device)[None, :]
    node = torch.zeros((bq, nt), dtype=torch.long, device=q.device)
    margins = []
    for lv in range(len(norms_lv)):
        nrm = norms_lv[lv][tix, node]                     # [bq, nt, d]
        thr = thrs_lv[lv][tix, node]                      # [bq, nt]
        with fp32_matmul():
            proj = torch.bmm(nrm, q[:, :, None])[:, :, 0]
        dec = proj > thr
        if flip_lv is not None:
            dec = torch.where(flip_lv == lv, ~dec, dec)
        if want_margins:
            margins.append((proj - thr).abs())
        node = 2 * node + dec.long()
    return node, margins


def _probe_leaves(q, norms_lv, thrs_lv, n_probes: int) -> torch.Tensor:
    """``[bq, nt, p]`` probed leaves: the plain descent, then one more per
    extra probe, the e-th flipping each tree's e-th smallest-margin split
    (a stable sort of the margins); ``p = 1 + min(n_probes − 1, levels)``."""
    node0, margins = _descend(q, norms_lv, thrs_lv, None, n_probes > 1)
    leaves = [node0]
    if n_probes > 1:
        flip_order = torch.sort(torch.stack(margins, dim=-1), dim=-1, stable=True).indices
        for e in range(min(n_probes - 1, len(norms_lv))):
            leaves.append(_descend(q, norms_lv, thrs_lv, flip_order[..., e])[0])
    return torch.stack(leaves, dim=2)


def _forest_fused_e2e(q, norms_lv, thrs_lv, scan, n, *, n_probes, k, k2, kb, maxq, R,
                      metric):
    """Multi-probe descent → per-tree cell-major fused scan → id dedup.

    Tree t's sorted order is block t of the concatenated storage, so a
    probed leaf maps to segment ``t·nseg_tree + (leaf >> shift)``. Probes
    of one (query, tree) that land in one cell are duplicates: the later
    copies scan the pad segment instead, so that every query keeps
    ``nt·p`` tree-major task lanes (the per-tree merge, ``groups=nt``,
    needs equal groups in probe order). Each id appears at most once per
    tree, so the ``nt·k2`` group-major survivors hold the true top-k
    distinct ids, and the dedup keeps the k best. Returns ``(dists,
    ids)``."""
    from .lsh import _dedup_topk

    nt, nseg_tree = scan["nt"], scan["nseg_tree"]
    bq = q.shape[0]
    cells = _probe_leaves(q, norms_lv, thrs_lv, n_probes) >> scan["shift"]
    p = cells.shape[2]
    earlier = torch.tril(torch.ones((p, p), dtype=torch.bool, device=q.device), -1)
    dup = ((cells[..., None, :] == cells[..., :, None]) & earlier).any(dim=-1)
    tix = torch.arange(nt, device=q.device)[None, :, None]
    segs = torch.where(dup, nt * nseg_tree, tix * nseg_tree + cells).reshape(bq, -1)
    cids, lists, gmap = build_probe_lists_device(segs, nt * nseg_tree, maxq, R)
    d, pos = fused_ivf_scan(
        q, cids, lists, gmap, scan["cells"], scan["sn"], scan["offsets"], scan["counts"],
        scan["zero_cent"], min(k2, p * kb), metric, "f32", None, kb, groups=nt,
    )
    order = scan["order"]
    ids_dup = order[torch.clamp(pos, 0, order.shape[0] - 1)]
    ids_dup = torch.where(torch.isinf(d), n, ids_dup)
    d, ids = _dedup_topk(d, ids_dup, k)
    return d, torch.clamp(ids, 0, n - 1)


class _ForestIndex(BaseIndex):
    """Shared: forest build, the fused cell scan and the leaf-union
    rerank."""

    _fallback_vectors = BaseIndex._fallback_from_vectors

    _mode = "annoy"

    #: scan-view budget: the cell blocks cost about 256·n bytes a tree (the
    #: JAX package's gate, kept as written)
    _FOREST_SCAN_BYTES = 4 << 30

    def __init__(
        self,
        mat: Any,
        metric: str = "euclidean",
        n_trees: int = 16,
        leaf: int = 64,
        seed: int = 42,
        verbose: bool = False,
        device="cuda",
    ):
        self._capture_f64(mat)
        super().__init__(mat, metric, device)
        self.vectors = _sentinel_rows(self.vectors)
        self.sqnorms = sq_norms(self.vectors)
        self.leaf = leaf
        levels = max(1, math.ceil(math.log2(max(self.n / leaf, 1))))
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.trees = build_partition_forest(gen, self.vectors, n_trees, levels, leaf,
                                            self._mode)
        self._scan_cache = None
        if verbose:
            print(f"{type(self).__name__} built: {n_trees} trees, {levels} levels, "
                  f"leaf {leaf}")

    def _stacked_routing(self):
        """Per level, the forest's normals ``[nt, 2^l, d]`` and thresholds
        ``[nt, 2^l]`` (a forest shares its level shapes by construction)."""
        L = self.trees[0].n_levels
        return ([torch.stack([t.normals[lv] for t in self.trees]) for lv in range(L)],
                [torch.stack([t.thresholds[lv] for t in self.trees]) for lv in range(L)])

    def _scan_setup(self):
        """The concatenated segment view of all trees for the fused scan
        (tree t's leaves are contiguous cells of block t; its padding is a
        global suffix), built once; None where the layout does not fit the
        kernel (a leaf that is no power of two, a small forest) or the cell
        blocks would pass ``_FOREST_SCAN_BYTES``."""
        if self._scan_cache is not None:
            return self._scan_cache if self._scan_cache != "off" else None
        t0 = self.trees[0]
        leaf, nt = t0.leaf, len(self.trees)
        ok = not (leaf & (leaf - 1))
        cell, shift = leaf, 0
        while cell < 128:
            cell, shift = cell * 2, shift + 1
        n_pad = int(t0.order.shape[0])
        # grow cells until the forest has ≤ ~8k segments: fewer, larger
        # task rows, and each probe covers more leaves
        while (
            nt * (n_pad // (2 * cell)) >= 8192
            and cell < 1024
            and n_pad % (2 * cell) == 0
            and n_pad // (2 * cell) >= 8
        ):
            cell, shift = cell * 2, shift + 1
        nseg_tree = n_pad // cell
        bytes_est = nt * (n_pad + cell) * max(256, 4 * self.dim)
        if (not ok or cell % 128 or nseg_tree < 8 or n_pad % cell
                or bytes_est > self._FOREST_SCAN_BYTES):
            self._scan_cache = "off"
            return None
        dev = self.device
        order_flat = torch.cat([t.order for t in self.trees])
        rows = torch.clamp(order_flat, max=self.n)
        storage = torch.cat([self.vectors[rows], torch.zeros((cell, self.dim), device=dev)])
        sqn = torch.cat([self.sqnorms[rows], torch.zeros(cell, device=dev)])
        offsets = torch.arange(nt * nseg_tree, dtype=torch.int32, device=dev) * cell
        counts_tree = torch.clamp(
            self.n - torch.arange(nseg_tree, device=dev) * cell, 0, cell).int()
        cells, sn = repack_blocks(storage, sqn, offsets, cell)
        del storage, sqn
        self._scan_cache = dict(
            cell=cell, shift=shift, nseg_tree=nseg_tree, nt=nt, offsets=offsets,
            counts=counts_tree.repeat(nt), cells=cells, sn=sn, order=order_flat,
            zero_cent=torch.zeros((nt * nseg_tree, self.dim), device=dev),
        )
        return self._scan_cache

    def _fused_plan(self, nq: int, k: int, n_probes: int):
        """``(scan, qb, maxq, R)`` of the fused route, or None where the
        gather route answers: the query block halves until its task slots
        ``R·maxq`` fit 2²² (down to 2,048 queries), and a forest whose
        slots still pass 2²³ takes the gather route."""
        scan = self._scan_setup() if self.n < (1 << 24) else None
        if scan is None or not fused_eligible("f32", scan["cell"], self.dim, min(k, 128)):
            return None
        nt = scan["nt"]
        L = self.trees[0].n_levels
        n_extra = min(n_probes - 1, L) if n_probes > 1 else 0
        qb = nq
        while True:
            maxq, R = device_probe_shapes(qb, nt * (1 + n_extra), nt * scan["nseg_tree"], 1)
            if R * maxq <= (1 << 22) or qb <= 2048:
                break
            qb = -(-qb // 2)
        if R * maxq > (1 << 23):
            return None
        return scan, qb, maxq, R

    def query(
        self,
        query_mat: Any,
        k: int,
        n_probes: int = 2,
        query_block: int = 1024,
        exact_fallback: bool = True,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Top-k ``(ids, dists)``; the candidate budget is about ``n_trees
        · n_probes · leaf`` (the reference's search_k knob). Small batches
        take one exact scan unless ``exact_fallback=False``; f64 queries to
        an index built from f64 data are answered at f64 grade."""
        r = self._f64_roundtrip(query_mat, k, n_probes=n_probes, query_block=query_block,
                                exact_fallback=exact_fallback)
        if r is not None:
            return r
        q = self._prep_queries(query_mat)
        k = self._clamp_k(k)
        if exact_fallback and self._exact_fallback_ok(q.shape[0]):
            return self._exact_query_small(q, k)
        nq = q.shape[0]
        plan = self._fused_plan(nq, k, n_probes)
        if plan is not None:
            scan, qb, maxq, R = plan
            if "norms_lv" not in scan:
                scan["norms_lv"], scan["thrs_lv"] = self._stacked_routing()
            outs = [
                _forest_fused_e2e(
                    q[s : s + qb], scan["norms_lv"], scan["thrs_lv"], scan, self.n,
                    n_probes=n_probes, k=k, k2=k, kb=fold_kb(k), maxq=maxq, R=R,
                    metric=self.metric,
                )
                for s in range(0, nq, qb)
            ]
            return torch.cat([o[1] for o in outs]), torch.cat([o[0] for o in outs])
        return self._gather_query(q, k, n_probes, min(query_block, max(nq, 8)))

    def _gather_query(self, q, k, n_probes, qb):
        """The gather route: the probed leaves' rows reranked exactly, in
        blocks of ``qb`` queries."""
        norms_lv, thrs_lv = self._stacked_routing()
        leaves = torch.stack([t.order.reshape(-1, t.leaf) for t in self.trees])
        nt = len(self.trees)
        tix = torch.arange(nt, device=self.device)[None, :, None]
        ids, dists = [], []
        for s in range(0, q.shape[0], qb):
            qq = q[s : s + qb]
            node = _probe_leaves(qq, norms_lv, thrs_lv, n_probes)   # [bq, nt, p]
            cand = leaves[tix, node].reshape(qq.shape[0], -1)
            d, i = rerank_exact(qq, self.vectors[torch.clamp(cand, max=self.n)],
                                torch.clamp(cand, max=self.n - 1), cand < self.n, k,
                                self.metric)
            ids.append(i)
            dists.append(d)
        return torch.cat(ids), torch.cat(dists)

    def generate_knn(self, k: int, **kw):
        return self.query(self.vectors[: self.n], k, **kw)

    def vectors_original_order(self) -> torch.Tensor:
        return self.vectors[: self.n]

    def memory_usage_bytes(self) -> int:
        total = (self.vectors.numel() + self.sqnorms.numel()) * 4
        for t in self.trees:
            total += t.order.numel() * 4
            total += sum(x.numel() * 4 for x in t.normals)
            total += sum(x.numel() * 4 for x in t.thresholds)
        return total

    # -- persistence: the JAX package's npz layout -------------------------

    def save(self, path: str) -> None:
        arrays = {"vectors": self.vectors[: self.n].cpu().numpy()}
        for ti, t in enumerate(self.trees):
            arrays[f"t{ti}_order"] = t.order.cpu().numpy().astype(np.int32)
            for lv in range(t.n_levels):
                arrays[f"t{ti}_normal{lv}"] = t.normals[lv].cpu().numpy()
                arrays[f"t{ti}_thr{lv}"] = t.thresholds[lv].cpu().numpy()
        arrays["meta"] = np.array([self.n, self.dim, len(self.trees), self.leaf,
                                   1 if self.metric == Dist.COSINE else 0])
        np.savez(path, **arrays)

    @classmethod
    def load(cls, path: str, device="cuda"):
        """Load a forest saved by either package's ``save`` (npz). A loaded
        index keeps no f64 copy."""
        from ..interop import annoy_from_jax_arrays, kd_tree_from_jax_arrays

        with np.load(path if path.endswith(".npz") else path + ".npz") as z:
            arrays = {f: z[f] for f in z.files}
        meta = arrays.pop("meta")
        n_trees, leaf = int(meta[2]), int(meta[3])
        trees = []
        for ti in range(n_trees):
            lv, normals, thrs = 0, [], []
            while f"t{ti}_normal{lv}" in arrays:
                normals.append(arrays[f"t{ti}_normal{lv}"])
                thrs.append(arrays[f"t{ti}_thr{lv}"])
                lv += 1
            trees.append({"order": arrays[f"t{ti}_order"], "normals": normals,
                          "thresholds": thrs})
        loader = annoy_from_jax_arrays if cls._mode == "annoy" else kd_tree_from_jax_arrays
        return loader(arrays["vectors"], trees, leaf,
                      "cosine" if int(meta[4]) == 1 else "euclidean", device)


class AnnoyIndex(_ForestIndex):
    """Forest of two-point hyperplane trees."""

    _mode = "annoy"


class KdTreeIndex(_ForestIndex):
    """Randomised kd-forest: splits on one of the top-3 spread axes."""

    _mode = "kd"


def _ball_fused_e2e(q, scan, n, *, beam, maxq, R, k, kb, metric):
    """Cell ranking → device task lists → fused cell scan. A cell's key is
    its nearest leaf centre (``min`` over its leaves of ``‖q − c‖²``, FP32):
    the JAX package measured the centre distance to rank better than the
    ball bound for a fixed budget. Returns ``(dists, ids)``."""
    nseg = scan["nseg"]
    cent = scan["centers"]
    with fp32_matmul():
        dots = q @ cent.T
    d2 = sq_norms(q)[:, None] + sq_norms(cent)[None, :] - 2.0 * dots
    bound = d2.reshape(q.shape[0], nseg, -1).min(dim=-1).values
    cells = torch.sort(bound, dim=1, stable=True).indices[:, :beam]
    cids, lists, gmap = build_probe_lists_device(cells, nseg, maxq, R)
    d, pos = fused_ivf_scan(
        q, cids, lists, gmap, scan["cells"], scan["sn"], scan["offsets"], scan["counts"],
        scan["zero_cent"], k, metric, "f32", None, kb,
    )
    order = scan["order"]
    ids = order[torch.clamp(pos, 0, order.shape[0] - 1)]
    return d, torch.where(torch.isinf(d), n - 1, ids)


class BallTreeIndex(BaseIndex):
    """One ball tree, scanned by cells (fused) or reranked by leaves."""

    _fallback_vectors = BaseIndex._fallback_from_vectors

    def __init__(
        self,
        mat: Any,
        metric: str = "euclidean",
        leaf: int = 64,
        seed: int = 42,
        verbose: bool = False,
        device="cuda",
    ):
        self._capture_f64(mat)
        super().__init__(mat, metric, device)
        self.vectors = _sentinel_rows(self.vectors)
        self.sqnorms = sq_norms(self.vectors)
        self.leaf = leaf
        levels = max(1, math.ceil(math.log2(max(self.n / leaf, 1))))
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.tree = build_partition_tree(gen, self.vectors, levels, leaf, "ball")
        self._scan_cache = None
        if verbose:
            print(f"BallTreeIndex built: {levels} levels, leaf {leaf}")

    def _scan_setup(self):
        """The fused scan's segment view: cells are contiguous
        ``max(128, leaf)``-row blocks of the sorted order (padding sorts to
        the global suffix, so every cell is a valid prefix), ranked by
        their leaf centres. None for a leaf that is no power of two or a
        tree of fewer than ``_BALL_FUSED_MIN_CELLS`` cells (not cached:
        tests lower the threshold)."""
        if self._scan_cache is not None:
            return self._scan_cache
        t = self.tree
        leaf = t.leaf
        if leaf & (leaf - 1):
            return None
        cell, j = leaf, 0
        while cell < 128:
            cell, j = cell * 2, j + 1
        if cell % 128 or j > t.n_levels or len(t.centers) <= t.n_levels - j:
            return None
        nseg = t.centers[t.n_levels - j].shape[0]
        if nseg < _BALL_FUSED_MIN_CELLS:
            # small trees: cell-granular probing costs recall, and the
            # gather route is cheap there
            return None
        dev = self.device
        order = t.order[: nseg * cell]
        real = order < self.n
        rows = torch.clamp(order, max=self.n)
        storage = torch.where(real[:, None], self.vectors[rows], 0.0)
        sqn = torch.where(real, self.sqnorms[rows], 0.0)
        offsets = torch.arange(nseg, dtype=torch.int32, device=dev) * cell
        counts = torch.clamp(self.n - torch.arange(nseg, device=dev) * cell, 0, cell).int()
        storage = torch.cat([storage, torch.zeros((cell, self.dim), device=dev)])
        sqn = torch.cat([sqn, torch.zeros(cell, device=dev)])
        cells, sn = repack_blocks(storage, sqn, offsets, cell)
        self._scan_cache = dict(
            cell=cell, nseg=nseg, centers=t.centers[-1], offsets=offsets, counts=counts,
            cells=cells, sn=sn, order=order, zero_cent=torch.zeros((nseg, self.dim), device=dev),
        )
        return self._scan_cache

    def query(
        self,
        query_mat: Any,
        k: int,
        budget: float | None = None,
        query_block: int = 1024,
        exact_fallback: bool = True,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """``budget``: the fraction of n scanned (default 0.05, the
        reference's 5%·n). Small batches take one exact scan unless
        ``exact_fallback=False``."""
        r = self._f64_roundtrip(query_mat, k, budget=budget, query_block=query_block,
                                exact_fallback=exact_fallback)
        if r is not None:
            return r
        q = self._prep_queries(query_mat)
        k = self._clamp_k(k)
        if exact_fallback and self._exact_fallback_ok(q.shape[0]):
            return self._exact_query_small(q, k)
        budget = 0.05 if budget is None else budget
        nq = q.shape[0]
        scan = self._scan_setup() if self.n < (1 << 24) else None
        if scan is not None and fused_eligible("f32", scan["cell"], self.dim, k):
            nseg = scan["nseg"]
            beam = min(nseg, max(1, math.ceil(budget * self.n / scan["cell"])))
            maxq, R = device_probe_shapes(nq, beam, nseg, 1)
            d, ids = _ball_fused_e2e(q, scan, self.n, beam=beam, maxq=maxq, R=R, k=k,
                                     kb=fold_kb(k), metric=self.metric)
            return ids, d
        beam = max(1, math.ceil(budget * self.n / self.leaf))
        return self._gather_query(q, k, beam, min(query_block, max(nq, 8)))

    def _gather_query(self, q, k, beam, qb):
        """The gather route: the ``beam`` nearest leaves (by centre)
        reranked exactly, in blocks of ``qb`` queries."""
        t = self.tree
        cent = t.centers[-1]
        leaves = t.order.reshape(-1, t.leaf)
        keep = min(beam, cent.shape[0])
        ids, dists = [], []
        for s in range(0, q.shape[0], qb):
            qq = q[s : s + qb]
            with fp32_matmul():
                dots = qq @ cent.T
            d2 = sq_norms(qq)[:, None] + sq_norms(cent)[None, :] - 2.0 * dots
            nodes = torch.sort(d2, dim=1, stable=True).indices[:, :keep]
            cand = leaves[nodes].reshape(qq.shape[0], -1)
            d, i = rerank_exact(qq, self.vectors[torch.clamp(cand, max=self.n)],
                                torch.clamp(cand, max=self.n - 1), cand < self.n, k,
                                self.metric)
            ids.append(i)
            dists.append(d)
        return torch.cat(ids), torch.cat(dists)

    def generate_knn(self, k: int, **kw):
        return self.query(self.vectors[: self.n], k, **kw)

    def vectors_original_order(self) -> torch.Tensor:
        return self.vectors[: self.n]

    def memory_usage_bytes(self) -> int:
        t = self.tree
        total = (self.vectors.numel() + self.sqnorms.numel()) * 4 + t.order.numel() * 4
        for part in (t.normals, t.thresholds, t.centers, t.radii):
            total += sum(x.numel() * 4 for x in part)
        return total

    # -- persistence: the JAX package's npz layout -------------------------

    def save(self, path: str) -> None:
        t = self.tree
        arrays = {"vectors": self.vectors[: self.n].cpu().numpy(),
                  "order": t.order.cpu().numpy().astype(np.int32)}
        for lv in range(t.n_levels):
            arrays[f"normal{lv}"] = t.normals[lv].cpu().numpy()
            arrays[f"thr{lv}"] = t.thresholds[lv].cpu().numpy()
        for lv in range(len(t.centers)):
            arrays[f"center{lv}"] = t.centers[lv].cpu().numpy()
            arrays[f"radius{lv}"] = t.radii[lv].cpu().numpy()
        arrays["meta"] = np.array([self.n, self.dim, self.leaf,
                                   1 if self.metric == Dist.COSINE else 0])
        np.savez(path, **arrays)

    @classmethod
    def load(cls, path: str, device="cuda") -> "BallTreeIndex":
        """Load a ball tree saved by either package's ``save`` (npz)."""
        from ..interop import balltree_from_jax_arrays

        with np.load(path if path.endswith(".npz") else path + ".npz") as z:
            arrays = {f: z[f] for f in z.files}
        meta = arrays.pop("meta")

        def levels(name):
            out, lv = [], 0
            while f"{name}{lv}" in arrays:
                out.append(arrays[f"{name}{lv}"])
                lv += 1
            return out

        tree = {"order": arrays["order"], "normals": levels("normal"),
                "thresholds": levels("thr"), "centers": levels("center"),
                "radii": levels("radius")}
        return balltree_from_jax_arrays(
            arrays["vectors"], tree, int(meta[2]),
            "cosine" if int(meta[3]) == 1 else "euclidean", device,
        )


def _tree_from_arrays(tree: dict, leaf: int, dev) -> PartitionTree:
    """A :class:`PartitionTree` on ``dev`` from numpy arrays (``order``,
    ``normals``, ``thresholds`` and, for a ball tree, ``centers`` and
    ``radii``)."""
    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    ball = tree.get("centers") is not None
    return PartitionTree(
        torch.as_tensor(np.asarray(tree["order"]), device=dev).long(),
        [f32(a) for a in tree["normals"]], [f32(a) for a in tree["thresholds"]],
        [f32(a) for a in tree["centers"]] if ball else None,
        [f32(a) for a in tree["radii"]] if ball else None,
        leaf,
    )


def _index_shell(cls, vectors: np.ndarray, metric: str, device):
    """An instance of ``cls`` holding ``vectors`` (stored as the JAX index
    holds them: normalised for cosine) with the sentinel row appended."""
    obj = cls.__new__(cls)
    obj.device = torch.device(device)
    obj.metric = parse_ann_dist(metric)
    v = np.array(vectors, np.float32)
    obj.n, obj.dim = v.shape
    obj.vectors = _sentinel_rows(torch.as_tensor(v, device=obj.device))
    obj.sqnorms = sq_norms(obj.vectors)
    obj._scan_cache = None
    return obj
