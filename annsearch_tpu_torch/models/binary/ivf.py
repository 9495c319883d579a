"""IVF binary index: f32 centroid routing over packed binary cells (port of
``annsearch_tpu.models.binary.ivf``).

k-means on the float rows routes queries to cells; the cells hold packed
codes. Three query tiers — Hamming, asymmetric and exact rerank — run on
the cluster scan (modes ``hamming`` / ``binary_asym``) and the shared
exact rerank. With ``fast_scan`` the Hamming tier takes the fused scan
instead: the cells unpacked once to ±1 bf16 rows with ``sn = n_bits``,
scored by kernel K1d-bf16 (mode ``bf16``, ``l2``, fold 2), where
``l2 = 2·n_bits − 2·dot = 4·hamming`` exactly (±1 operands are exact in
one bf16 pass, the sums in f32).

Not ported: ``ANNSEARCH_NO_FAST_HAMMING`` (``fast_scan=False`` reaches the
cluster scan) and the fused gate's ``< 2²⁴`` storage rows (it keeps the
JAX package's positions exact in a packed f32 readback; the port returns
integer tensors).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ...ops.binary import unpack_pm1
from ...ops.ivf_scan_fused import fused_eligible, fused_ivf_scan, repack_blocks
from ...ops.probe_device import build_probe_lists_device, device_probe_shapes
from ...ops.rerank import rerank_from_store
from ...utils.dist import Dist
from ..ivf_base import IvfBase, route_to_cells
from .binariser import Binariser
from .vec_store import DeviceVectorStore, MmapVectorStore

__all__ = ["IvfIndexBinary"]

#: the ±1 bf16 cell cache's limit (bytes)
_PM_CACHE_BYTES = 2 << 30

def make_store(store, x_sorted, device):
    """``(store, store_path)`` of a build's ``store`` argument."""
    if store is True:
        return DeviceVectorStore(x_sorted), ""
    if isinstance(store, str):
        return MmapVectorStore.write(store, x_sorted, device), store
    return None, ""


class IvfIndexBinary(IvfBase):
    """IVF routing over binarised cells."""

    mode = "hamming"
    _state_arrays = IvfBase._state_arrays + ("bin_proj", "bin_mean", "store_vectors")
    _state_scalars = IvfBase._state_scalars + ("n_bits", "bin_mode", "store_path", "fast_scan")

    def __init__(
        self,
        mat: Any,
        metric: str = "euclidean",
        nlist: int | None = None,
        n_bits: int | None = None,
        binarisation: str = "simhash",
        max_iters: int = 30,
        seed: int = 42,
        store: str | bool = True,
        fast_scan: bool = True,
        verbose: bool = False,
        *,
        device="cuda",
    ):
        self._n_bits_arg = n_bits
        self._binarisation = binarisation
        self._store_arg = store
        self.fast_scan = bool(fast_scan)
        super().__init__(mat, metric, nlist=nlist, max_iters=max_iters, seed=seed,
                         verbose=verbose, device=device)

    def _encode_storage(self, x, order, seed):
        x_sorted = x[order]
        self.binariser = Binariser.train(x_sorted, self._n_bits_arg, self._binarisation, seed)
        self.n_bits = self.binariser.n_bits
        codes = self.binariser.encode(x_sorted)
        self._pad_storage(codes, torch.zeros(codes.shape[0], device=self.device))
        self.store, self.store_path = make_store(self._store_arg, x_sorted, self.device)
        self.bin_mode = self.binariser.mode
        self._aliases()

    def _aliases(self) -> None:
        self.bin_proj = self.binariser.projections
        self.bin_mean = self.binariser.mean
        self.store_vectors = (
            self.store.vectors if isinstance(self.store, DeviceVectorStore) else None
        )

    def _fallback_vectors(self):
        if isinstance(self.store, DeviceVectorStore):
            # the store holds cluster-sorted rows: map back through original_ids
            return self.store.vectors, None, self.original_ids[: self.n]
        return None

    def query(
        self,
        query_mat: Any,
        k: int,
        nprobe: int | None = None,
        rerank: str | None = None,
        rerank_factor: int = 20,
        exact_fallback: bool = True,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """``(ids, dists)``: Hamming distances (``rerank=None``), the
        negated asymmetric dot (``"asymmetric"``), or exact distances of the
        index's metric (``"exact"``)."""
        q = self._prep_queries(query_mat)
        k = self._clamp_k(k)
        nprobe = self.default_nprobe() if nprobe is None else nprobe
        nprobe = max(1, min(nprobe, self.nlist))
        if rerank == "exact" and self.store is None:
            raise ValueError("exact rerank requires a vector store")
        if rerank == "exact" and exact_fallback and self._exact_fallback_ok(q.shape[0]):
            return self._exact_query_small(q, k)

        k_scan = k if rerank != "exact" else min(max(k, k * rerank_factor), self.n)
        if rerank == "asymmetric":
            q_eff = self.binariser.project(q)
            q_eff = torch.nn.functional.pad(q_eff, (0, (-q_eff.shape[1]) % 32))
            d, i = self._scan(q, k_scan, nprobe, mode="binary_asym", q_eff=q_eff)
        elif self._fused_hamming_ok(k_scan):
            d, i = self._fused_hamming(q, k_scan, nprobe)
            if rerank is None:
                d = d * 0.25  # l2 over ±1 rows = 4·hamming exactly
        else:
            d, i = self._scan(q, k_scan, nprobe, mode="hamming",
                              q_eff=self.binariser.encode(q))
        if rerank == "exact":
            d, i = rerank_from_store(q, d, i, self.store, k, self.metric)
        return self.original_ids[torch.clamp(i.long(), 0, self.n - 1)], d

    def _fused_hamming_ok(self, k_scan: int) -> bool:
        return (
            self.fast_scan
            # the fused scan keeps ≤ 2 survivors per stride class per cell
            # (the depth-2 fold) before kb ≤ 128 extractions: under
            # Hamming's massive ties a k·rerank_factor pool (k_scan 300)
            # silently truncates per cell and IVF recall lands below flat
            # (measured −0.17 at 50k × 256d, nlist 158, on the JAX
            # package). Large rerank pools take the exact cluster scan
            and k_scan <= 128
            and self.n * self.n_bits * 2 <= _PM_CACHE_BYTES
            and fused_eligible("bf16", self.seg_size, self.n_bits, k_scan)
        )

    def _pm_blocks(self):
        """Cell blocks unpacked to ±1 bf16 (cached; ``sn = n_bits``)."""
        cached = getattr(self, "_pm_blocks_cache", None)
        if cached is None:
            pm = unpack_pm1(self.storage, self.n_bits)
            sn = torch.full((pm.shape[0],), float(self.n_bits), device=self.device)
            cached = repack_blocks(pm, sn, self.seg_offsets, self.seg_size)
            self._pm_blocks_cache = cached
        return cached

    def _fused_hamming(self, q, k_scan, nprobe):
        """The Hamming tier by the fused scan over ±1 cell blocks (kernel
        K1d-bf16). Returns (l2 = 4·hamming ``[nq, k_scan]``, sorted-storage
        positions)."""
        nq = q.shape[0]
        nseg = int(self.seg_offsets.shape[0])
        nprobe_seg = self._segment_probes(nprobe)
        maxq, R = device_probe_shapes(nq, nprobe_seg, nseg, 1)
        blocks, sn_blocks = self._pm_blocks()
        kb = min(128, max(8, 1 << (min(k_scan, 128) - 1).bit_length()))
        q_pm = unpack_pm1(self.binariser.encode(q), self.n_bits, torch.float32)
        # the bf16 l2 epilogue reads no centroid; zeros of the scoring width
        zero_cents = torch.zeros((nseg, self.n_bits), device=self.device)
        probes = route_to_cells(q, self.seg_centroids, nprobe_seg, self.metric)
        cluster_ids, lists, gmap = build_probe_lists_device(probes, nseg, maxq, R)
        return fused_ivf_scan(
            q_pm, cluster_ids, lists, gmap, blocks, sn_blocks, self.seg_offsets,
            self.seg_counts, zero_cents, k_scan, Dist.EUCLIDEAN, "bf16", None, kb,
        )

    def generate_knn(self, k: int, nprobe: int | None = None, **kw):
        if isinstance(self.store, DeviceVectorStore):
            return self.query(self.vectors_original_order(), k, nprobe=nprobe, **kw)
        raise ValueError("self-query requires a device vector store")

    def _decoded_sorted(self) -> torch.Tensor:
        if not isinstance(self.store, DeviceVectorStore):
            raise ValueError("binary index without device store keeps no vectors")
        return self.store.vectors

    def memory_usage_bytes(self) -> int:
        total = (
            self.storage.numel() * 4
            + (self.centroids.numel() + self.seg_centroids.numel()) * 4
            + (self.seg_counts.numel() + self.seg_offsets.numel()) * 4
            + self.original_ids.numel() * 4
            + self.binariser.memory_usage_bytes()
        )
        if self.store is not None:
            total += self.store.memory_usage_bytes()
        return total

    def _save_arrays(self) -> dict[str, np.ndarray]:
        arrays = super()._save_arrays()
        arrays["storage"] = arrays["storage"].view(np.uint32)   # the JAX package's words
        return arrays

    @classmethod
    def load(cls, path: str, device="cuda") -> "IvfIndexBinary":
        """Load an index saved by either package's ``save`` (an mmap store
        is re-opened from its path)."""
        from ...interop import ivf_binary_from_jax_arrays

        arrays, meta = cls._read_npz(path, cls.__name__)
        return ivf_binary_from_jax_arrays(arrays, meta, device)
