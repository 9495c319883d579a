"""RaBitQ indexes: 1-bit residual quantisation with an unbiased estimator
(port of ``annsearch_tpu.models.binary.rabitq``).

* Encoder: a random orthogonal rotation (QR of a Gaussian). Per row, the
  unit residual to its centroid is rotated and its sign bits stored, with
  two scalars: ``‖x − c‖`` (``store_sqnorms``) and the L1 correction
  ``‖R·u‖₁`` (``aux_corr``).
* Estimator: ``⟨q, v⟩̂ = ⟨R·u_q, sign⟩ / ‖R·u‖₁`` clamped to [−1, 1], then
  ``d̂ = sqrt(‖v−c‖² + ‖q−c‖² − 2‖v−c‖‖q−c‖·⟨q, v⟩̂)`` (non-squared, as
  the reference returns it). The sign dot is an exact ±1 product of the
  bf16-rounded unit query residual, f32 sums.

Two tiers. The cluster scan (mode ``rabitq``, ``ops.ivf_scan``) computes
the estimator as it stands. With ``fast_scan`` the fused scan does, by
kernel K1a-bf16 with two bf16 query terms (the JAX package's call takes
``fused_ivf_scan``'s default ``q_split=True``): the rows are stored as
``±1·‖x−c‖/‖R·u‖₁`` in bf16 (0 for a row whose correction is 0, one
sitting on its centroid) with ``sn = ‖x−c‖²``, so the residual ``l2``
epilogue with unit scales gives ``d̂² = ‖q_r‖² + ‖v−c‖² − 2⟨q_r, x′⟩``:
the estimator squared without its clip, after which the returned ``[nq,
k]`` slots are re-estimated exactly (``_rescore_estimator``). ``k_scan``
above 128 still takes the fused tier, its kb capped at 128, the regroup
padding with +inf.

The rotation is drawn from a ``torch.Generator`` seeded with ``seed`` on
the CPU and factored there in f32 (torch cannot repeat ``jax.random``);
the rotation products are float32 with TF32 off (the JAX package's
HIGHEST).

* :class:`ExhaustiveIndexRaBitQ`: 0.5·√n clusters inside, default probe
  20% of them;
* :class:`IvfIndexRaBitQ`: √n cells, √nlist probes.

Both rerank exactly from the vector store on request.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from ...ops.binary import pack_bits, unpack_pm1
from ...ops.ivf_scan_fused import fused_eligible, fused_ivf_scan, repack_blocks
from ...ops.probe_device import build_probe_lists_device, device_probe_shapes
from ...ops.rerank import rerank_from_store
from ...utils.dist import Dist, fp32_matmul
from ..ivf_base import IvfBase, route_to_cells
from .ivf import _PM_CACHE_BYTES, make_store
from .vec_store import DeviceVectorStore

__all__ = ["RaBitQEncoder", "ExhaustiveIndexRaBitQ", "IvfIndexRaBitQ"]


class RaBitQEncoder:
    """Rotation and sign-bit encoding of unit residuals."""

    def __init__(self, rotation: torch.Tensor, dim: int):
        self.rotation = rotation  # [d, d]; applied as v @ rotation.T
        self.dim = int(dim)
        self.n_words = (self.dim + 31) // 32

    @classmethod
    def create(cls, dim: int, seed: int = 42, device="cuda") -> "RaBitQEncoder":
        gen = torch.Generator().manual_seed(int(seed))
        q, _ = torch.linalg.qr(torch.randn((dim, dim), generator=gen, dtype=torch.float32))
        return cls(q.to(device), dim)

    def _rotate(self, v: torch.Tensor) -> torch.Tensor:
        with fp32_matmul():
            return v @ self.rotation.T

    def encode_vectors(self, x: torch.Tensor, owner_centroids: torch.Tensor):
        """``(packed sign bits [n, w] int32, ‖x − c‖ [n], ‖R·u‖₁ [n])``."""
        r = x - owner_centroids
        v_dist = torch.sqrt((r * r).sum(dim=-1))
        u = r / torch.clamp(v_dist, min=1e-12)[:, None]
        ru = self._rotate(u)
        return pack_bits(ru >= 0), v_dist, ru.abs().sum(dim=-1)

    def rotate_padded(self, v: torch.Tensor) -> torch.Tensor:
        """Rotate and zero-pad the columns to ``w·32`` (the scan's layout)."""
        return torch.nn.functional.pad(self._rotate(v), (0, self.n_words * 32 - self.dim))

    def memory_usage_bytes(self) -> int:
        return self.rotation.numel() * 4


class _RaBitQBase(IvfBase):
    """Build and query of the two RaBitQ indexes."""

    mode = "rabitq"
    _state_arrays = IvfBase._state_arrays + ("aux_corr", "rotation", "store_vectors")
    _state_scalars = IvfBase._state_scalars + ("store_path", "fast_scan")

    def __init__(
        self,
        mat: Any,
        metric: str = "euclidean",
        nlist: int | None = None,
        max_iters: int = 30,
        seed: int = 42,
        store: str | bool = True,
        fast_scan: bool = True,
        verbose: bool = False,
        *,
        device="cuda",
    ):
        if nlist is None:
            nlist = self._default_nlist(int(np.shape(mat)[0]))
        self._store_arg = store
        self.fast_scan = bool(fast_scan)
        super().__init__(mat, metric, nlist=nlist, max_iters=max_iters, seed=seed,
                         verbose=verbose, device=device)

    def _default_nlist(self, n: int) -> int:
        raise NotImplementedError

    def _encode_storage(self, x, order, seed):
        x_sorted = x[order]
        self.encoder = RaBitQEncoder.create(self.dim, seed, self.device)
        self.rotation = self.encoder.rotation
        codes, v_dists, dot_corrs = self.encoder.encode_vectors(
            x_sorted, self.centroids[self._owner_clusters()]
        )
        self._pad_storage(codes, v_dists)
        self.aux_corr = torch.cat([dot_corrs, dot_corrs.new_zeros(self.seg_size)])
        self.store, self.store_path = make_store(self._store_arg, x_sorted, self.device)
        self.store_vectors = (
            self.store.vectors if isinstance(self.store, DeviceVectorStore) else None
        )

    def _encode_queries(self, q):
        return self.encoder.rotate_padded(q)

    def _scan_seg_centroids(self):
        return self.encoder.rotate_padded(self.seg_centroids)

    def _aux(self):
        return self.aux_corr

    def _fallback_vectors(self):
        if isinstance(self.store, DeviceVectorStore):
            return self.store.vectors, None, self.original_ids[: self.n]
        return None

    def query(
        self,
        query_mat: Any,
        k: int,
        nprobe: int | None = None,
        rerank: str | None = None,
        rerank_factor: int = 10,
        exact_fallback: bool = True,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """``(ids, dists)``: the estimated distance (non-squared), or with
        ``rerank="exact"`` exact distances of the index's metric."""
        q = self._prep_queries(query_mat)
        k = self._clamp_k(k)
        nprobe = self.default_nprobe() if nprobe is None else nprobe
        nprobe = max(1, min(nprobe, self.nlist))
        if rerank == "exact" and self.store is None:
            raise ValueError("exact rerank requires a vector store")
        if rerank == "exact" and exact_fallback and self._exact_fallback_ok(q.shape[0]):
            return self._exact_query_small(q, k)

        k_scan = k if rerank != "exact" else min(max(k, k * rerank_factor), self.n)
        if self._fused_est_ok(k_scan):
            d, i = self._fused_estimator(q, k_scan, nprobe)
            if rerank != "exact":
                # the fused rows fold sn/corr into storage, which drops the
                # estimator's ±1 clip (its overshoot hits near-duplicates):
                # re-estimate the returned slots with the clipped formula
                d, i = self._rescore_estimator(q, i, d)
        else:
            d, i = self._scan(q, k_scan, nprobe)
        if rerank == "exact":
            d, i = rerank_from_store(q, d, i, self.store, k, self.metric)
        return self.original_ids[torch.clamp(i.long(), 0, self.n - 1)], d

    def _fused_est_ok(self, k_scan: int) -> bool:
        nbits = self.encoder.n_words * 32
        return (
            self.fast_scan
            and self.n * nbits * 2 <= _PM_CACHE_BYTES
            and fused_eligible("i8dec_residual", self.seg_size, nbits, min(k_scan, 128))
        )

    def _est_blocks(self):
        """The estimator's cell blocks (cached): ±1 rows scaled by
        ``sn / corr`` in bf16, the rotation's pad columns zero, and ``sn²``
        blocks (``store_sqnorms`` holds ``sn = ‖x − c‖``)."""
        cached = getattr(self, "_est_blocks_cache", None)
        if cached is None:
            nbits = self.encoder.n_words * 32
            pm = unpack_pm1(self.storage, self.dim, torch.float32)
            pm = torch.nn.functional.pad(pm, (0, nbits - self.dim))
            mult = torch.where(
                self.aux_corr > 1e-6,
                self.store_sqnorms / torch.clamp(self.aux_corr, min=1e-12),
                0.0,
            )
            x_scaled = (pm * mult[:, None]).to(torch.bfloat16)
            cached = repack_blocks(x_scaled, self.store_sqnorms ** 2, self.seg_offsets,
                                   self.seg_size)
            self._est_blocks_cache = cached
        return cached

    def _fused_estimator(self, q, k_scan, nprobe):
        """``(d̂² [nq, k_scan], sorted-storage positions)`` by the fused scan
        (kernel K1a-bf16, unit scales)."""
        nq = q.shape[0]
        nseg = int(self.seg_offsets.shape[0])
        nprobe_seg = self._segment_probes(nprobe)
        maxq, R = device_probe_shapes(nq, nprobe_seg, nseg, 1)
        blocks, sn_blocks = self._est_blocks()
        kb = min(128, max(8, 1 << (min(k_scan, 128) - 1).bit_length()))
        nbits = self.encoder.n_words * 32
        probes = route_to_cells(q, self.seg_centroids, nprobe_seg, self.metric)
        cluster_ids, lists, gmap = build_probe_lists_device(probes, nseg, maxq, R)
        # two bf16 query terms: the JAX package's call takes fused_ivf_scan's
        # default q_split=True here
        return fused_ivf_scan(
            self._encode_queries(q), cluster_ids, lists, gmap, blocks, sn_blocks,
            self.seg_offsets, self.seg_counts, self._scan_seg_centroids(), k_scan,
            Dist.EUCLIDEAN, "i8dec_residual", torch.ones(nbits, device=self.device), kb,
            q_split=True,
        )

    def _owner_j(self) -> torch.Tensor:
        """Owner cluster of every storage row (pad rows: 0), cached."""
        cached = getattr(self, "_owner_j_cache", None)
        if cached is None:
            cached = torch.zeros(int(self.storage.shape[0]), dtype=torch.long,
                                 device=self.device)
            cached[: self.n] = self._owner_clusters()
            self._owner_j_cache = cached
        return cached

    def _rescore_estimator(self, q, pos, d_in):
        """The exact clipped estimator at the given ``[nq, k]`` storage
        positions, ascending (stable); slots whose ``d_in`` is not finite
        stay +inf."""
        owners = self._owner_j()
        q_rot = self._encode_queries(q)
        cent_rot = self.encoder.rotate_padded(self.centroids)
        posc = torch.clamp(pos.long(), 0, self.storage.shape[0] - 1)
        codes = self.storage[posc]                                    # [nq, k, w]
        pm = unpack_pm1(codes.reshape(-1, codes.shape[-1]), self.dim, torch.float32)
        pm = pm.reshape(posc.shape + (self.dim,))
        sn = self.store_sqnorms[posc]
        corr = self.aux_corr[posc]
        qr = q_rot[:, None, : self.dim] - cent_rot[owners[posc]][..., : self.dim]
        qd = torch.sqrt((qr * qr).sum(dim=-1))
        qu = qr / torch.clamp(qd, min=1e-12)[..., None]
        inner = (qu.to(torch.bfloat16).float() * pm).sum(dim=-1)
        est = torch.where(corr > 1e-6,
                          torch.clamp(inner / torch.clamp(corr, min=1e-12), -1.0, 1.0), 0.0)
        d = torch.sqrt(torch.clamp(sn ** 2 + qd ** 2 - 2.0 * sn * qd * est, min=0.0))
        d = torch.where(torch.isfinite(d_in), d, float("inf"))
        d, order = torch.sort(d, dim=-1, stable=True)
        return d, torch.gather(posc, -1, order)

    def generate_knn(self, k: int, nprobe: int | None = None, **kw):
        if isinstance(self.store, DeviceVectorStore):
            return self.query(self.vectors_original_order(), k, nprobe=nprobe, **kw)
        raise ValueError("self-query requires a device vector store")

    def _decoded_sorted(self) -> torch.Tensor:
        if not isinstance(self.store, DeviceVectorStore):
            raise ValueError("no device vector store")
        return self.store.vectors

    def memory_usage_bytes(self) -> int:
        total = (
            self.storage.numel() * 4
            + (self.store_sqnorms.numel() + self.aux_corr.numel()) * 4
            + (self.centroids.numel() + self.seg_centroids.numel()) * 4
            + self.encoder.memory_usage_bytes()
        )
        if self.store is not None:
            total += self.store.memory_usage_bytes()
        return total

    def _save_arrays(self) -> dict[str, np.ndarray]:
        arrays = super()._save_arrays()
        arrays["storage"] = arrays["storage"].view(np.uint32)   # the JAX package's words
        return arrays

    @classmethod
    def load(cls, path: str, device="cuda"):
        """Load an index saved by either package's ``save`` (an mmap store
        is re-opened from its path)."""
        from ... import interop

        arrays, meta = cls._read_npz(path, cls.__name__)
        load = (interop.exhaustive_rabitq_from_jax_arrays if cls is ExhaustiveIndexRaBitQ
                else interop.ivf_rabitq_from_jax_arrays)
        return load(arrays, meta, device)


class ExhaustiveIndexRaBitQ(_RaBitQBase):
    """Flat-API RaBitQ: 0.5·√n clusters inside, default probe 20%."""

    def _default_nlist(self, n: int) -> int:
        return max(1, int(0.5 * math.sqrt(n)))

    def default_nprobe(self) -> int:
        return max(1, int(0.2 * self.nlist))


class IvfIndexRaBitQ(_RaBitQBase):
    """IVF-style RaBitQ: √n cells, √nlist probes."""

    def _default_nlist(self, n: int) -> int:
        return max(1, int(math.isqrt(n)))
