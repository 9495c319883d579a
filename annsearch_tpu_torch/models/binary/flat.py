"""Flat binary index: a Hamming scan with optional asymmetric or exact
rerank (port of ``annsearch_tpu.models.binary.flat``).

Rows are binarised (SimHash, PCA or sign) and queries scan the codes by
the ±1 product (``ops.binary``). Two refinements:

* ``asymmetric``: the float query projections against the ±1 codes, no
  extra storage;
* ``exact``: the Hamming scan proposes ``k·rerank_factor`` candidates,
  whose f32 rows are gathered from the vector store and scored exactly.

``fast_scan`` keeps the codes unpacked to ±1 (f32, 4 B a bit, off above
2 GB) so that a scan is a plain product; without it each chunk is
unpacked as it is scanned. Both give the same answer. Selection is
tie-exact, so the Hamming tier returns the JAX package's ids. This module
is tensor code, as the JAX module is.

Not ported: the ``ANNSEARCH_NO_FAST_HAMMING`` environment flag
(``fast_scan=False`` reaches the same routes) and ``jax.lax.map`` blocking.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ...ops.binary import chunked_topk_asymmetric, chunked_topk_hamming, topk_pm1, unpack_pm1
from ...ops.rerank import rerank_from_store
from ..base import BaseIndex
from .binariser import Binariser
from .vec_store import DeviceVectorStore, MmapVectorStore

__all__ = ["ExhaustiveIndexBinary"]

#: the ±1 cache's limit (bytes)
_PM_CACHE_BYTES = 2 << 30


class ExhaustiveIndexBinary(BaseIndex):
    """Flat Hamming-scan index over binarised vectors."""

    _state_arrays = ("codes", "bin_proj", "bin_mean", "store_vectors")
    _state_scalars = ("n", "dim", "n_bits", "bin_mode", "store_path", "fast_scan")

    def __init__(
        self,
        mat: Any,
        metric: str = "euclidean",
        n_bits: int | None = None,
        binarisation: str = "simhash",
        seed: int = 42,
        store: str | bool = True,
        fast_scan: bool = True,
        *,
        device="cuda",
    ):
        """``store``: True keeps the f32 rows on the device for the exact
        rerank, a path writes an on-disk store there, False keeps none."""
        self.fast_scan = bool(fast_scan)
        super().__init__(mat, metric, device)
        x = self.vectors  # normalised if cosine
        self.binariser = Binariser.train(x, n_bits, binarisation, seed)
        self.n_bits = self.binariser.n_bits
        self.bin_mode = self.binariser.mode
        self.codes = self.binariser.encode(x)
        if store is True:
            self.store = DeviceVectorStore(x)
        elif isinstance(store, str):
            self.store = MmapVectorStore.write(store, x, self.device)
        else:
            self.store = None
        self.store_path = store if isinstance(store, str) else ""
        self.vectors = self.sqnorms = None
        self._aliases()

    def _aliases(self) -> None:
        """The persisted names of the binariser's and the store's arrays."""
        self.bin_proj = self.binariser.projections
        self.bin_mean = self.binariser.mean
        self.store_vectors = (
            self.store.vectors if isinstance(self.store, DeviceVectorStore) else None
        )

    def _fallback_vectors(self):
        if isinstance(self.store, DeviceVectorStore):
            return self.store.vectors, None, None
        return None

    # -- queries ------------------------------------------------------------

    def query(
        self,
        query_mat: Any,
        k: int,
        rerank: str | None = None,   # None | "asymmetric" | "exact"
        rerank_factor: int = 20,
        query_block: int = 1024,
        exact_fallback: bool = True,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """``(ids, dists)``: Hamming distances (``rerank=None``), the
        negated asymmetric dot (``"asymmetric"``), or exact distances of the
        index's metric (``"exact"``)."""
        q = self._prep_queries(query_mat)
        k = self._clamp_k(k)
        if rerank == "exact" and self.store is None:
            raise ValueError("exact rerank requires a vector store")
        if rerank == "exact" and exact_fallback and self._exact_fallback_ok(q.shape[0]):
            # the exact tier promises exact distances: below the brute
            # budget one scan of the stored rows is faster and exact
            return self._exact_query_small(q, k)
        if rerank is None:
            d, i = self._hamming(q, k, query_block)
            return i, d
        if rerank == "asymmetric":
            d, i = self._blocked(self.binariser.project(q), query_block,
                                 lambda b: self._asymmetric(b, k))
            return i, d
        kc = min(max(k, k * rerank_factor), self.n)
        d_sc, cand = self._hamming(q, kc, query_block)
        d, i = rerank_from_store(q, d_sc, cand, self.store, k, self.metric)
        return i, d

    def _hamming(self, q, k, query_block):
        """Hamming top-k ``(dists, rows)`` of the binarised queries."""
        q_codes = self.binariser.encode(q)
        return self._blocked(q_codes, query_block, lambda b: self._hamming_codes(b, k))

    def _hamming_codes(self, q_codes, k):
        if self._fast_scan_ok():
            pm = self._codes_pm()
            return topk_pm1(unpack_pm1(q_codes, self.n_bits, torch.float32),
                            lambda a, b: pm[a:b], self.n, k, True)
        return chunked_topk_hamming(q_codes, self.codes, k, self.n_bits, self.n)

    def _asymmetric(self, q_proj, k):
        """``−dot`` of the bf16-rounded projections (one bf16 pass, as the
        JAX package's DEFAULT precision) against the ±1 codes."""
        if self._fast_scan_ok():
            pm = self._codes_pm()
            return topk_pm1(q_proj.to(torch.bfloat16).float(), lambda a, b: pm[a:b],
                            self.n, k, False)
        nb = self.codes.shape[1] * 32
        q_pad = torch.nn.functional.pad(q_proj, (0, nb - q_proj.shape[1]))
        return chunked_topk_asymmetric(q_pad, self.codes, k, nb, self.n)

    def generate_knn(self, k: int, **kw):
        """Self-query: through ``query`` where the device store keeps the
        rows, else the Hamming top-k of the stored codes against
        themselves."""
        if isinstance(self.store, DeviceVectorStore):
            return self.query(self.store.vectors, k, **kw)
        k = self._clamp_k(k)
        d, i = self._blocked(self.codes, 1024, lambda b: self._hamming_codes(b, k))
        return i, d

    # -- plumbing -------------------------------------------------------------

    def _fast_scan_ok(self) -> bool:
        return self.fast_scan and self.n * self.n_bits * 4 <= _PM_CACHE_BYTES

    def _codes_pm(self) -> torch.Tensor:
        """The codes unpacked to ±1 f32, cached once."""
        cached = getattr(self, "_codes_pm_cache", None)
        if cached is None:
            cached = unpack_pm1(self.codes, self.n_bits, torch.float32)
            self._codes_pm_cache = cached
        return cached

    @staticmethod
    def _blocked(q, query_block, fn):
        parts = [fn(q[s : s + query_block]) for s in range(0, q.shape[0], query_block)]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])

    def memory_usage_bytes(self) -> int:
        total = self.codes.numel() * 4 + self.binariser.memory_usage_bytes()
        if self.store is not None:
            total += self.store.memory_usage_bytes()
        return total

    def vectors_original_order(self) -> torch.Tensor:
        if isinstance(self.store, DeviceVectorStore):
            return self.store.vectors
        raise ValueError("binary index without device store keeps no vectors")

    def _save_arrays(self) -> dict[str, np.ndarray]:
        arrays = super()._save_arrays()
        arrays["codes"] = arrays["codes"].view(np.uint32)   # the JAX package's words
        return arrays

    @classmethod
    def load(cls, path: str, device="cuda") -> "ExhaustiveIndexBinary":
        """Load an index saved by either package's ``save`` (an mmap store
        is re-opened from its path)."""
        from ...interop import exhaustive_binary_from_jax_arrays

        arrays, meta = cls._read_npz(path, cls.__name__)
        return exhaustive_binary_from_jax_arrays(arrays, meta, device)
