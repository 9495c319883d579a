"""Binarisers: SimHash, PCA-hash and sign encoders (port of
``annsearch_tpu.models.binary.binariser``).

Three modes:

* ``simhash``: orthonormal Gaussian hyperplanes, one QR per block of
  ``dim`` columns when ``n_bits > dim`` so that every block is orthonormal;
* ``pca``: the right singular vectors of a mean-centred sample of at most
  100k rows, padded with orthonormal random projections for bits past
  ``dim``;
* ``sign``: one bit per dimension, ``x > 0`` (``n_bits = dim``).

Bits are packed into int32 words (``ops.binary.pack_bits``). The
projections also serve the asymmetric query path (the float query in
projection space against ±1 codes).

Random draws come from a ``torch.Generator`` seeded with ``seed`` on the
CPU (torch cannot repeat ``jax.random``): the Gaussian blocks, their QR
(f32, on the host, so that one seed gives the same projections on every
device) and PCA's sample. The projections are then moved to the index's
device; the projection product is float32 with TF32 off.
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops.binary import pack_bits
from ...utils.dist import fp32_matmul

__all__ = ["Binariser", "BINARISATION_MODES"]

BINARISATION_MODES = ("simhash", "pca", "sign")
PCA_SAMPLE_CAP = 100_000


def _orthogonal_projections(gen: torch.Generator, dim: int, n_bits: int) -> torch.Tensor:
    """``[dim, n_bits]`` f32 on the CPU; each block of ``dim`` columns is
    orthonormal (the Q of a Gaussian block's QR)."""
    cols = []
    remaining = n_bits
    while remaining > 0:
        w = min(dim, remaining)
        g = torch.randn((dim, w), generator=gen, dtype=torch.float32)
        qm, _ = torch.linalg.qr(g)
        cols.append(qm[:, :w])
        remaining -= w
    return torch.cat(cols, dim=1)


class Binariser:
    """Vector → packed-bit encoder."""

    def __init__(
        self,
        projections: torch.Tensor | None,  # [dim, n_bits] f32, None in sign mode
        mean: torch.Tensor | None,
        n_bits: int,
        mode: str,
    ):
        self.projections = projections
        self.mean = mean
        self.n_bits = int(n_bits)
        self.mode = str(mode)
        self.n_words = (self.n_bits + 31) // 32

    @classmethod
    def train(
        cls,
        x: torch.Tensor,
        n_bits: int | None = None,
        mode: str = "simhash",
        seed: int = 42,
    ) -> "Binariser":
        mode = mode.lower()
        if mode not in BINARISATION_MODES:
            raise ValueError(f"unknown binarisation mode {mode!r}")
        n, dim = x.shape
        if mode == "sign":
            return cls(None, None, dim, "sign")
        if n_bits is None:
            n_bits = dim
        gen = torch.Generator().manual_seed(int(seed))
        if mode == "simhash":
            return cls(_orthogonal_projections(gen, dim, n_bits).to(x.device), None,
                       n_bits, "simhash")

        # pca: loadings of a mean-centred sample, random-padded past dim
        if n > PCA_SAMPLE_CAP:
            idx = torch.randperm(n, generator=gen)[:PCA_SAMPLE_CAP]
            xs = x[idx.to(x.device)]
        else:
            xs = x
        xs = xs.float()
        mean = xs.mean(dim=0)
        _, _, vh = torch.linalg.svd(xs - mean, full_matrices=False)
        v = vh.T[:, : min(dim, n_bits)]
        if n_bits > v.shape[1]:
            extra = _orthogonal_projections(gen, dim, n_bits - v.shape[1])
            v = torch.cat([v, extra.to(v.device)], dim=1)
        return cls(v.contiguous(), mean, n_bits, "pca")

    # -- encoding -----------------------------------------------------------

    def project(self, x: torch.Tensor) -> torch.Tensor:
        """Float projections (the asymmetric query space), FP32."""
        if self.mode == "sign":
            return x
        xc = x - self.mean if self.mean is not None else x
        with fp32_matmul():
            return xc @ self.projections

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """``[n, dim]`` → packed int32 words ``[n, n_words]``."""
        return pack_bits(self.project(x) > 0)

    def memory_usage_bytes(self) -> int:
        total = 0
        if self.projections is not None:
            total += self.projections.numel() * 4
        if self.mean is not None:
            total += self.mean.numel() * 4
        return total

    def state(self) -> dict:
        """The binariser's state as host numpy arrays: the keywords of
        :meth:`from_state` (the JAX package's ``state``)."""
        out = {"n_bits": np.int64(self.n_bits), "mode": self.mode}
        if self.projections is not None:
            out["projections"] = self.projections.cpu().numpy()
        if self.mean is not None:
            out["mean"] = self.mean.cpu().numpy()
        return out

    @classmethod
    def from_state(cls, n_bits, mode, projections=None, mean=None, device="cuda"):
        """A binariser from carried state (numpy arrays, e.g. a JAX
        index's ``bin_proj`` / ``bin_mean``)."""
        def t(a):
            return None if a is None else torch.tensor(np.asarray(a, np.float32), device=device)

        return cls(t(projections), t(mean), int(n_bits), str(mode))
