"""Quantised IVF indexes (port of ``annsearch_tpu.models.quantised.ivf``):
bf16 cells (``IvfIndexBf16``), SQ8 cells (``IvfSq8Index``), IVF + residual
PQ (``IvfPqIndex``) and IVF + residual OPQ (``IvfOpqIndex``).

Routing uses the f32 centroids; the cells are stored compressed and
scanned in the quantised domain:

* bf16: rows cast to bf16 (round to nearest even); the exact tier rescores
  its pool in f32 over the bf16 rows (kernels K1c-bf16, K1d-bf16);
* SQ8: per-dimension symmetric int8 codes (``ScalarQuantiser``); queries
  are encoded with the same scales and scored in integer space, where the
  distances are exact (kernels K1c-sq8, K1d-sq8);
* IVF-PQ: codebooks are trained on ``vec − centroid``. With ``m = dim``
  (scalar sub-codebooks) the decoded residuals are requantised per
  dimension to int8 at build (error ≤ absmax/254, far below the PQ error),
  and the scan is a pure int8 × bf16 dot product with no decode work: mode
  ``i8dec_residual`` (kernels K1a, K1b-l2 and, under cosine, K1b-cos; the
  exact tier by the cluster scan). With ``m ≠ dim`` the cells hold the u8
  codes, decoded in the cluster scan: mode ``pq_residual``;
* IVF-OPQ: an orthogonal rotation learned on the residuals comes first;
  cells hold codes of rotated residuals, and queries and centroids are
  rotated at scan time (a rotation preserves distances and norms).

f64 input is cast to f32: quantised storage keeps no f64 copy.
"""

from __future__ import annotations

import torch

from ...utils.dist import Dist, fp32_matmul, sq_norms
from ..ivf_base import IvfBase, route_to_cells
from .quantisers import (
    OptimisedProductQuantiser,
    ProductQuantiser,
    ScalarQuantiser,
    bf16_decode,
    bf16_encode,
)

__all__ = ["IvfIndexBf16", "IvfSq8Index", "IvfPqIndex", "IvfOpqIndex", "route_to_cells"]


class IvfIndexBf16(IvfBase):
    """IVF routing (f32 centroids) + bf16 cells."""

    mode = "bf16"

    def _encode_storage(self, x, order, seed):
        s16 = bf16_encode(x[order])
        self._pad_storage(s16, sq_norms(s16.float()))

    def _decoded_sorted(self) -> torch.Tensor:
        return bf16_decode(self.storage[: self.n])

    @classmethod
    def load(cls, path: str, device="cuda") -> "IvfIndexBf16":
        """Load an index saved by either package's ``save`` (npz; the bf16
        storage is saved as f32 and cast back)."""
        from ...interop import ivf_bf16_from_jax_arrays

        arrays, meta = cls._read_npz(path, cls.__name__)
        return ivf_bf16_from_jax_arrays(arrays, meta, device)


class IvfSq8Index(IvfBase):
    """IVF routing + SQ8 int8 cells, integer-space distances: euclidean is
    the squared distance between the int8 codes of query and row, cosine
    ``1 − codes·codes / (‖q codes‖·‖row codes‖)``."""

    mode = "sq8"
    _state_arrays = IvfBase._state_arrays + ("scales",)

    def _encode_storage(self, x, order, seed):
        x_sorted = x[order]
        self.quantiser = ScalarQuantiser.train(x_sorted)
        self.scales = self.quantiser.scales
        codes = self.quantiser.encode(x_sorted)
        c32 = codes.int()
        # int32 squared norms of the codes (exact), as the JAX package keeps
        self._pad_storage(codes, (c32 * c32).sum(dim=-1, dtype=torch.int32))

    def _encode_queries(self, q: torch.Tensor) -> torch.Tensor:
        return self.quantiser.encode(q)

    def _decoded_sorted(self) -> torch.Tensor:
        return self.quantiser.decode(self.storage[: self.n])

    @classmethod
    def load(cls, path: str, device="cuda") -> "IvfSq8Index":
        """Load an index saved by either package's ``save`` (npz)."""
        from ...interop import ivf_sq8_from_jax_arrays

        arrays, meta = cls._read_npz(path, cls.__name__)
        return ivf_sq8_from_jax_arrays(arrays, meta, device)


class IvfPqIndex(IvfBase):
    """IVF + residual PQ: codebooks trained on ``vec − centroid``.

    ``ds = dim / m == 1`` (scalar sub-codebooks) takes the int8 fast-scan
    mode ``i8dec_residual``: the same bytes per vector as the u8 codes, and
    a scan with no decode work. Other ``m`` keep the u8 codes (mode
    ``pq_residual``)."""

    mode = "pq_residual"
    _state_arrays = IvfBase._state_arrays + ("codebooks", "dec_scales")
    _state_scalars = IvfBase._state_scalars + ("m",)

    #: rows per encode chunk (bounds the f32 residual transients)
    ENCODE_CHUNK = 1 << 19

    def __init__(self, mat, metric="euclidean", nlist=None, m: int = 16, **kw):
        super().__init__(mat, metric, nlist=nlist, m=m, **kw)

    # -- build ---------------------------------------------------------------

    def _train_quantiser(self, residuals: torch.Tensor, m: int, seed: int) -> None:
        """Train on the sampled residuals; sets ``quantiser`` and
        ``codebooks`` (the OPQ index adds its rotation)."""
        self.quantiser = ProductQuantiser.train(residuals, m, seed=seed)
        self.codebooks = self.quantiser.codebooks

    def _to_code_space(self, v: torch.Tensor) -> torch.Tensor:
        """Residuals or centroids in the space the codebooks live in."""
        return v

    def _encode_storage(self, x, order, seed, m: int = 16):
        self.m = m
        self.dec_scales = None
        owner = self._owner_clusters()
        n = order.shape[0]
        # quantiser training: residuals of ≤ 2¹⁸ stride-sampled sorted rows
        idx = torch.arange(0, n, max(1, -(-n // (1 << 18))), device=x.device)
        self._train_quantiser(x[order[idx]] - self.centroids[owner[idx]], m, seed)
        if self.dim == m:
            # per-dim int8 scales from the codebooks (decoded values ARE
            # codebook entries, so their |max| bounds them)
            absmax = torch.clamp(self.codebooks[:, :, 0].abs().max(dim=1).values, min=1e-12)
            self.dec_scales = (absmax / 127.0).float()
            self.mode = "i8dec_residual"
        codes, sns = [], []
        # sorted rows are gathered chunk by chunk: the full [n, d] f32
        # residuals never exist beside the caller's data
        for s in range(0, n, self.ENCODE_CHUNK):
            own = owner[s : s + self.ENCODE_CHUNK]
            res = x[order[s : s + self.ENCODE_CHUNK]] - self.centroids[own]
            code = self.quantiser.encode(self._to_code_space(res))
            dec = self.quantiser.decode(code)
            if self.dec_scales is not None:
                # torch.round rounds half to even, like jnp.round
                code = torch.clamp(torch.round(dec / self.dec_scales), -127, 127).to(torch.int8)
                dec = code.float() * self.dec_scales
            codes.append(code)
            sns.append(self._recon_sqnorms_of(dec, own, code))
        self._pad_storage(torch.cat(codes), torch.cat(sns))

    def _recon_sqnorms_of(self, dec_res, owner, codes) -> torch.Tensor:
        """euclidean: ``‖dec_res‖²`` (the residual-distance identity's
        term); cosine: ``‖centroid + dec_res‖²`` (to renormalise the
        reconstruction), both in the codebooks' space. ``codes`` are the
        stored rows that decode to ``dec_res``."""
        if self.metric == Dist.COSINE:
            return sq_norms(dec_res + self._to_code_space(self.centroids[owner]))
        return sq_norms(dec_res)

    # -- scan hooks ----------------------------------------------------------

    def _codebooks(self) -> torch.Tensor:
        # the scans' codebooks slot carries the [d] scales in fast-scan mode
        return self.dec_scales if self.mode == "i8dec_residual" else self.codebooks

    def _decoded_residuals(self) -> torch.Tensor:
        """The stored rows' decoded residuals in the codebooks' space."""
        if self.mode == "i8dec_residual":
            return self.storage[: self.n].float() * self.dec_scales
        return self.quantiser.decode(self.storage[: self.n])

    def _decoded_sorted(self) -> torch.Tensor:
        return self._decoded_residuals() + self.centroids[self._owner_clusters()]

    def _restore(self) -> None:
        """Rebuild what ``__init__`` derives from the state arrays (after
        a load)."""
        self.quantiser = ProductQuantiser(self.codebooks, self.m, self.dim)
        if self.dec_scales is not None:
            self.mode = "i8dec_residual"

    @classmethod
    def load(cls, path: str, device="cuda") -> "IvfPqIndex":
        """Load an index saved by either package's ``save`` (npz)."""
        from ...interop import ivf_pq_from_jax_arrays

        arrays, meta = cls._read_npz(path, cls.__name__)
        return ivf_pq_from_jax_arrays(arrays, meta, device)


class IvfOpqIndex(IvfPqIndex):
    """IVF + residual OPQ: an orthogonal rotation is learned on the
    residuals; cells hold PQ codes (or, with ``m = dim``, int8
    reconstructions) of rotated residuals, and queries and centroids are
    rotated at scan time. Routing stays in the original space."""

    _state_arrays = IvfPqIndex._state_arrays + ("rotation",)

    def _train_quantiser(self, residuals, m, seed):
        self.opq = OptimisedProductQuantiser.train(residuals, m, seed=seed)
        self.rotation = self.opq.rotation
        self.quantiser = self.opq.pq
        self.codebooks = self.quantiser.codebooks

    def _to_code_space(self, v):
        with fp32_matmul():
            return v @ self.rotation

    def _recon_sqnorms_of(self, dec_res, owner, codes):
        if self.metric == Dist.EUCLIDEAN and self.dec_scales is None:
            # u8 codes: the sub-space squared-norm table, as the JAX package
            return self.quantiser.code_sqnorms(codes)
        return super()._recon_sqnorms_of(dec_res, owner, codes)

    def _encode_queries(self, q):
        return self._to_code_space(q)

    def _scan_seg_centroids(self):
        return self._to_code_space(self.seg_centroids)

    def _decoded_sorted(self) -> torch.Tensor:
        with fp32_matmul():
            dec = self._decoded_residuals() @ self.rotation.T
        return dec + self.centroids[self._owner_clusters()]

    def _restore(self) -> None:
        super()._restore()
        self.opq = OptimisedProductQuantiser(self.quantiser, self.rotation)

    @classmethod
    def load(cls, path: str, device="cuda") -> "IvfOpqIndex":
        """Load an index saved by either package's ``save`` (npz)."""
        from ...interop import ivf_opq_from_jax_arrays

        arrays, meta = cls._read_npz(path, cls.__name__)
        return ivf_opq_from_jax_arrays(arrays, meta, device)
