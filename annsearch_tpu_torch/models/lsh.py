"""LSH index: multi-probe SimHash tables scanned as segmented cells (port
of ``annsearch_tpu.models.lsh``).

``num_tables`` tables of ``bits_per_hash`` orthogonalised Gaussian
hyperplanes (drawn on the host with numpy's ``default_rng(seed)`` and a QR,
as the JAX package draws them, so both packages hash with identical
projections); euclidean indexes hash L2-normalised copies and rerank raw
rows; multi-probe flips the least certain bits (smallest |projection|),
all single flips first, then pairs; queries whose probes find only empty
buckets fall back to an exact rerank of 1,000 random rows.

Each table's rows are stored hash-sorted, so a bucket is a contiguous
range: the T tables form one segmented storage of ``T·2^bits`` cells (the
IVF layout) and a probe set is a task list. Two routes scan it, as in the
JAX package: where the segments are a multiple of 128 rows
(``fused_eligible``) the task lists feed the fused scan
(``fused_ivf_scan(mode="f32")``, kernel K1d-f32); elsewhere they feed the
cluster scan (``ops/ivf_scan.py``) with a per-cell width of k (``k_cell``).
Candidates reached through several tables are deduplicated before the
final top-k.

Hash bits are signs of FP32 dots (TF32 off); a row whose projection lies
within rounding of 0 may hash to the other side of the plane than in the
JAX package (its CPU dots sum in another order). Not ported: the packed
``(dists, ids-as-f32)`` result (ids are int64 tensors),
``ANNSEARCH_NO_PALLAS`` and the ``interpret`` plumbing. The fallback's
random rows come from a ``torch.Generator`` seeded with ``seed + 1``, not
the JAX key stream.

Task lists: the JAX package builds the fused route's lists on the device,
padding every probe to the largest bucket's segment count, and the
cluster route's on the host from the real (query, segment) pairs. Both
routes here build them on the device from the real pairs only (the
compact lists of the IVF exact tier); on 1M lowrank rows at 12 bits a
probe pads to 623 slots against about 83 real pairs, and at 16 bits the
host lists of one 10k batch hold 100M pairs. Both take the batch in
blocks of at most ``_PAIR_BUDGET`` pairs.
Each (query, segment) pair is scanned alike, so a query's answer does not
change, except one with fewer than ``k2`` real candidates, whose tail is
(+inf, pad) where the padded JAX lists would surface 3e38 entries.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..ops.ivf_scan import ivf_cluster_scan
from ..ops.ivf_scan_fused import fold_kb, fused_eligible, fused_ivf_scan, repack_blocks
from ..ops.probe_device import build_probe_lists_compact, compact_probe_shapes, route_pair_stats
from ..ops.rerank import rerank_exact
from ..utils.dist import Dist, fp32_matmul, normalise, sq_norms
from .base import BaseIndex
from .kmeans import segment_layout

__all__ = ["LSHIndex"]

#: (query, segment) pairs of one query block (see ``LSHIndex._pair_blocks``)
_PAIR_BUDGET = 1 << 22


def _probe_patterns(bits: int, n_probes: int) -> tuple[tuple[int, ...], ...]:
    """The ``n_probes − 1`` flip patterns over rank positions (0 = the least
    certain bit): Hamming distance 1 in rank order, then distance-2
    pairs."""
    pats: list[tuple[int, ...]] = []
    for r in range(bits):
        if len(pats) >= n_probes - 1:
            return tuple(pats)
        pats.append((r,))
    for i in range(bits):
        for j in range(i + 1, bits):
            if len(pats) >= n_probes - 1:
                return tuple(pats)
            pats.append((i, j))
    return tuple(pats)


def _hashes(x: torch.Tensor, projections: torch.Tensor, t: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(proj [n, bits], hash [n])`` of rows ``x`` in table ``t``: bit b is
    ``proj_b > 0`` (FP32 dots)."""
    bits = projections.shape[2]
    with fp32_matmul():
        proj = x @ projections[t]
    powers = 2 ** torch.arange(bits, device=x.device)
    return proj, ((proj > 0).long() * powers).sum(dim=-1)


def _probe_cells(
    q: torch.Tensor,            # [bq, dim] normalised queries
    projections: torch.Tensor,  # [T, dim, bits]
    bits: int,
    n_probes: int,
    uniform: bool = False,
) -> torch.Tensor:
    """``[bq, T·P]`` global cell ids: per table the base hash, then the
    flip probes, offset into that table's cell range. ``uniform`` flips
    bits in index order instead of by |projection| rank (the reference's
    self-query)."""
    pats = _probe_patterns(bits, n_probes)
    out = []
    for t in range(projections.shape[0]):
        proj, base = _hashes(q, projections, t)
        flip = torch.sort(proj.abs(), dim=-1, stable=True).indices   # rank → bit
        probes = [base]
        for pat in pats:
            h = base
            for r in pat:
                h = h ^ ((1 << r) if uniform else (1 << flip[:, r]))
            probes.append(h)
        out.append(torch.stack(probes, dim=1) + t * (1 << bits))
    return torch.cat(out, dim=1)


def _dedup_topk(d: torch.Tensor, ids: torch.Tensor, k: int):
    """Drop repeated ids (the same row reached through several tables or
    trees, at one distance): every copy after an id's first lane is +inf.
    Then the k smallest, ties to the lower lane."""
    order = torch.sort(ids, dim=-1, stable=True).indices
    s_ids = torch.gather(ids, -1, order)
    dup_s = torch.zeros_like(s_ids, dtype=torch.bool)
    dup_s[..., 1:] = s_ids[..., 1:] == s_ids[..., :-1]
    dup = torch.zeros_like(dup_s).scatter_(-1, order, dup_s)
    d = torch.where(dup, float("inf"), d)
    pos = torch.sort(d, dim=-1, stable=True).indices[..., : min(k, d.shape[-1])]
    return torch.gather(d, -1, pos), torch.gather(ids, -1, pos)


class LSHIndex(BaseIndex):
    """Multi-probe SimHash over segmented hash-sorted tables."""

    _fallback_vectors = BaseIndex._fallback_from_vectors

    def __init__(
        self,
        mat: Any,
        metric: str = "euclidean",
        num_tables: int = 8,
        bits_per_hash: int = 16,
        seed: int = 42,
        verbose: bool = False,
        device="cuda",
    ):
        if bits_per_hash > 30:
            raise ValueError("bits_per_hash must be ≤ 30 (int32 hash space)")
        self._capture_f64(mat)
        super().__init__(mat, metric, device)
        if self.sqnorms is None:
            self.sqnorms = sq_norms(self.vectors)
        self.num_tables, self.bits, self._seed = num_tables, bits_per_hash, seed
        rng = np.random.default_rng(seed)
        projs = []
        for _ in range(num_tables):
            qm, _ = np.linalg.qr(rng.standard_normal((self.dim, bits_per_hash)))
            projs.append(qm[:, :bits_per_hash].astype(np.float32))
        self.projections = torch.as_tensor(np.stack(projs), device=self.device)
        hash_input = self.vectors if self.metric == Dist.COSINE else normalise(self.vectors)
        # table t's bucket h is cell t·2^bits + h; element t·n + r of the
        # concatenated assignment is row r's cell in table t
        assign = torch.cat([
            _hashes(hash_input, self.projections, t)[1] + t * (1 << bits_per_hash)
            for t in range(num_tables)
        ])
        layout = segment_layout(assign.cpu().numpy(), num_tables << bits_per_hash)
        self._set_layout(layout)
        if verbose:
            c = layout.counts[layout.counts > 0]
            print(f"LSH built: T={num_tables} bits={bits_per_hash} nseg={layout.nseg} "
                  f"seg_size={self.seg_size} bucket med/max={int(np.median(c))}/{int(c.max())}")

    def _set_layout(self, layout) -> None:
        """The segmented storage of ``layout`` (its order indexes the T·n
        concatenated assignment)."""
        n, dev = self.n, self.device
        self.seg_size = int(layout.seg_size)
        self._cluster_ptr = np.asarray(layout.cluster_ptr, np.int64)
        self._seg_cluster = np.asarray(layout.seg_cluster, np.int32)
        self.seg_offsets = torch.as_tensor(layout.seg_offsets, device=dev)
        self.seg_counts = torch.as_tensor(layout.seg_counts, device=dev)
        self.original_ids = torch.as_tensor(np.asarray(layout.order) % n, device=dev).long()
        rows = self.vectors[self.original_ids]
        self.storage = torch.cat([rows, torch.zeros((self.seg_size, self.dim), device=dev)])
        self.store_sqnorms = sq_norms(self.storage)
        self.last_fallback_rate = 0.0
        self._derived = {}

    def _s_max(self) -> int:
        return int(np.diff(self._cluster_ptr).max()) if len(self._cluster_ptr) > 1 else 1

    def _cached(self, name, build):
        if name not in self._derived:
            self._derived[name] = build()
        return self._derived[name]

    def _lists(self, probes: torch.Tensor):
        """Task lists of the real (query, segment) pairs of the probes, on
        the device (the compact lists of the IVF exact tier: the JAX
        package's dense expansion pads every probe to the largest bucket's
        segment count)."""
        nseg = int(self.seg_offsets.shape[0])
        ptr = self._ptr_dev()
        total, qmax = route_pair_stats(probes, ptr).tolist()
        P, T_g, maxq, R = compact_probe_shapes(total, qmax, nseg)
        return build_probe_lists_compact(probes, ptr, P, T_g, nseg, maxq, R)

    def _zero_cent(self) -> torch.Tensor:
        return self._cached("zero_cent", lambda: torch.zeros(
            (int(self.seg_offsets.shape[0]), self.dim), device=self.device))

    def _fused_route(self, q, probes, k, k2):
        """Task lists → fused bucket scan (K1d-f32)."""
        cells, sn = self._cached("blocks", lambda: repack_blocks(
            self.storage, self.store_sqnorms, self.seg_offsets, self.seg_size))
        return fused_ivf_scan(q, *self._lists(probes), cells, sn, self.seg_offsets,
                              self.seg_counts, self._zero_cent(), k2, self.metric, "f32", None,
                              fold_kb(k))

    def _cluster_route(self, q, probes, k, k2):
        """Task lists → cluster scan. Each (query, cell) keeps k
        (``k_cell``): a row appears at most once per cell, and the dense
        per-step outputs grow with it."""
        return ivf_cluster_scan(q, *self._lists(probes), self.storage, self.store_sqnorms,
                                self.seg_offsets, self.seg_counts, self._zero_cent(), k2,
                                self.metric, self.seg_size, "f32", k_cell=k)

    def _ptr_dev(self) -> torch.Tensor:
        return self._cached("ptr", lambda: torch.as_tensor(self._cluster_ptr, device=self.device))

    def _pair_blocks(self, probes: torch.Tensor) -> list[tuple[int, int]]:
        """Query blocks of at most ``_PAIR_BUDGET`` (query, segment) pairs
        (at least one query each): a skewed table gives one query thousands
        of pairs, and the lists, the scan outputs and the regroup grow with
        the pairs. Each query's answer depends on its own pairs alone, so
        the blocks do not change it."""
        ptr = self._ptr_dev()
        qcnt = (ptr[probes + 1] - ptr[probes]).sum(dim=1).cpu().numpy()
        blocks, start, acc = [], 0, 0
        for i, c in enumerate(qcnt.tolist()):
            if i > start and acc + c > _PAIR_BUDGET:
                blocks.append((start, i))
                start, acc = i, 0
            acc += c
        blocks.append((start, len(qcnt)))
        return blocks

    def query(
        self,
        query_mat: Any,
        k: int,
        n_probes: int = 4,
        max_bucket: int | None = None,   # unused: whole buckets are scanned
        query_block: int | None = None,  # unused: the scan is global
        exact_fallback: bool = True,
        uniform_probes: bool = False,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Top-k ``(ids, dists)``. ``uniform_probes`` flips probe bits in
        index order (the reference's self-query; ``generate_knn`` sets it).
        Small batches take one exact scan unless ``exact_fallback=False``.
        ``last_fallback_rate`` is the share of the batch whose probes found
        no row."""
        r = self._f64_roundtrip(query_mat, k, n_probes=n_probes, query_block=query_block,
                                exact_fallback=exact_fallback, uniform_probes=uniform_probes)
        if r is not None:
            return r
        q = self._prep_queries(query_mat)
        if exact_fallback and self._exact_fallback_ok(q.shape[0]):
            return self._exact_query_small(q, self._clamp_k(k))
        k = self._clamp_k(k)
        qn = q if self.metric == Dist.COSINE else normalise(q)
        # k·T scan slots: a true neighbour appears once per table it
        # hashes near in, so fewer would let copies crowd out distinct ids
        k2 = min(k * self.num_tables, 192)
        use_fused = (int(self.storage.shape[0]) < (1 << 24)
                     and fused_eligible("f32", self.seg_size, self.dim, min(k, 128)))
        route = self._fused_route if use_fused else self._cluster_route
        probes = _probe_cells(qn, self.projections, self.bits, n_probes, uniform_probes)
        parts = [route(q[s:e], probes[s:e], k, k2) for s, e in self._pair_blocks(probes)]
        d = torch.cat([p[0] for p in parts])
        pos = torch.cat([p[1] for p in parts])
        ids_dup = self.original_ids[torch.clamp(pos, 0, self.original_ids.shape[0] - 1)]
        ids_dup = torch.where(torch.isinf(d), self.n, ids_dup)
        d, ids = _dedup_topk(d, ids_dup, k)
        return self._apply_fallback(q, torch.clamp(ids, 0, self.n - 1), d, k)

    def _apply_fallback(self, q, ids, dists, k):
        """Queries whose best distance is not finite (every probed bucket
        empty) take an exact rerank of 1,000 random rows, drawn from a
        generator seeded with ``seed + 1``."""
        miss = ~torch.isfinite(dists[:, 0])
        nq = q.shape[0]
        self.last_fallback_rate = float(miss.float().mean()) if nq else 0.0
        if bool(miss.any()):
            rows = torch.nonzero(miss)[:, 0]
            gen = torch.Generator().manual_seed(self._seed + 1)
            rnd = torch.randint(0, self.n, (len(rows), 1000), generator=gen).to(self.device)
            fd, fi = rerank_exact(q[rows], self.vectors[rnd], rnd,
                                  torch.ones(rnd.shape, dtype=torch.bool, device=self.device),
                                  k, self.metric)
            ids, dists = ids.clone(), dists.clone()
            ids[rows], dists[rows] = fi, fd
        if self.last_fallback_rate > 0.01:
            print(f"LSH warning: {self.last_fallback_rate:.1%} of queries hit empty "
                  "buckets (random fallback) — consider fewer bits or more probes")
        return ids, dists

    def generate_knn(self, k: int, **kw):
        """Self-query of every row, flipping probe bits in index order."""
        kw.setdefault("uniform_probes", True)
        return self.query(self.vectors[: self.n], k, **kw)

    def vectors_original_order(self) -> torch.Tensor:
        return self.vectors[: self.n]

    def memory_usage_bytes(self) -> int:
        return 4 * (self.vectors.numel() + self.sqnorms.numel() + self.storage.numel()
                    + self.store_sqnorms.numel() + self.projections.numel()
                    + self.original_ids.numel() + self.seg_offsets.numel()
                    + self.seg_counts.numel())

    # -- persistence: the JAX package's npz layout -------------------------

    def save(self, path: str) -> None:
        np.savez(
            path,
            vectors=self.vectors.cpu().numpy(),
            projections=self.projections.cpu().numpy(),
            storage=self.storage.cpu().numpy(),
            original_ids=self.original_ids.cpu().numpy().astype(np.int32),
            seg_offsets=self.seg_offsets.cpu().numpy(),
            seg_counts=self.seg_counts.cpu().numpy(),
            cluster_ptr=self._cluster_ptr,
            seg_cluster=self._seg_cluster,
            meta=np.array([self.n, self.dim, self.num_tables, self.bits, self._seed,
                           1 if self.metric == Dist.COSINE else 0, self.seg_size]),
        )

    @classmethod
    def load(cls, path: str, device="cuda") -> "LSHIndex":
        """Load an index saved by either package's ``save`` (npz)."""
        from ..interop import lsh_from_jax_arrays

        with np.load(path if path.endswith(".npz") else path + ".npz") as z:
            arrays = {f: z[f] for f in z.files}
        meta = arrays.pop("meta")
        return lsh_from_jax_arrays(arrays, {
            "n": int(meta[0]), "dim": int(meta[1]), "num_tables": int(meta[2]),
            "bits": int(meta[3]), "seed": int(meta[4]), "seg_size": int(meta[6]),
            "metric": "cosine" if int(meta[5]) == 1 else "euclidean"}, device)
