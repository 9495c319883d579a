"""Quantised IVF indexes (port of ``annsearch_tpu.models.quantised.ivf``):
bf16 cells (``IvfIndexBf16``), SQ8 cells (``IvfSq8Index``) and IVF +
residual PQ (``IvfPqIndex``, int8 fast-scan mode).

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
  ``i8dec_residual`` (kernel K1a).

f64 input is cast to f32: quantised storage keeps no f64 copy.
"""

from __future__ import annotations

import torch

from ...utils.dist import Dist, sq_norms
from ..ivf_base import IvfBase
from .quantisers import ProductQuantiser, ScalarQuantiser, bf16_decode, bf16_encode

__all__ = ["IvfIndexBf16", "IvfSq8Index", "IvfPqIndex"]


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
    """IVF + residual PQ; only ``m == dim`` (``i8dec_residual``) under the
    euclidean metric is ported."""

    mode = "i8dec_residual"
    _state_arrays = IvfBase._state_arrays + ("codebooks", "dec_scales")
    _state_scalars = IvfBase._state_scalars + ("m",)

    #: rows per encode chunk (bounds the f32 residual transients)
    ENCODE_CHUNK = 1 << 19

    def __init__(self, mat, metric="euclidean", nlist=None, m: int = 16, **kw):
        _check_supported(metric, m, mat.shape[1])
        super().__init__(mat, metric, nlist=nlist, m=m, **kw)

    def _encode_storage(self, x, order, seed, m: int = 16):
        self.m = m
        owner = self._owner_clusters()
        n = order.shape[0]
        # quantiser training: residuals of ≤ 2¹⁸ stride-sampled sorted rows
        idx = torch.arange(0, n, max(1, -(-n // (1 << 18))), device=x.device)
        self.quantiser = ProductQuantiser.train(
            x[order[idx]] - self.centroids[owner[idx]], m, seed=seed
        )
        self.codebooks = self.quantiser.codebooks
        # per-dim int8 scales from the codebooks (decoded values ARE
        # codebook entries, so their |max| bounds them)
        absmax = torch.clamp(self.codebooks[:, :, 0].abs().max(dim=1).values, min=1e-12)
        self.dec_scales = (absmax / 127.0).float()
        codes, sns = [], []
        for s in range(0, n, self.ENCODE_CHUNK):
            res = x[order[s : s + self.ENCODE_CHUNK]] - self.centroids[
                owner[s : s + self.ENCODE_CHUNK]
            ]
            dec = self.quantiser.decode(self.quantiser.encode(res))
            # torch.round rounds half to even, like jnp.round
            dec8 = torch.clamp(torch.round(dec / self.dec_scales), -127, 127).to(torch.int8)
            codes.append(dec8)
            sns.append(sq_norms(dec8.float() * self.dec_scales))
        self._pad_storage(torch.cat(codes), torch.cat(sns))

    def _scan_scales(self) -> torch.Tensor:
        return self.dec_scales

    def _decoded_sorted(self) -> torch.Tensor:
        dec = self.storage[: self.n].float() * self.dec_scales
        return dec + self.centroids[self._owner_clusters()]

    @classmethod
    def load(cls, path: str, device="cuda") -> "IvfPqIndex":
        """Load an index saved by either package's ``save`` (npz)."""
        from ...interop import ivf_pq_from_jax_arrays

        arrays, meta = cls._read_npz(path, cls.__name__)
        return ivf_pq_from_jax_arrays(arrays, meta, device)


def _check_supported(metric, m: int, dim: int) -> None:
    from ...utils.dist import parse_ann_dist

    if parse_ann_dist(metric) != Dist.EUCLIDEAN:
        raise NotImplementedError(
            "cosine IVF-PQ needs the cos_renorm epilogue: kernel K1b, "
            "ROADMAP Queue 2"
        )
    if m != dim:
        raise NotImplementedError(
            f"m={m} != dim={dim} is mode pq_residual, which needs the "
            "cluster scan ivf_cluster_scan (ROADMAP Queue 1 item 10)"
        )
