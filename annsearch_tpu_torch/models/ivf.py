"""IVF (inverted-file) index over f32 cells (port of
``annsearch_tpu.models.ivf.IvfIndex``).

k-means coarse quantiser, rows stored cluster-contiguously as plain f32
(normalised under cosine). Queries take the exact tier by default
(kernel K1c-f32, recall 1.0 within the probed cells, optionally
certified) or the approximate tier with ``approx=True`` (kernel K1d-f32).
Defaults as the JAX package: ``nlist = √n``, ``nprobe = √nlist``.
"""

from __future__ import annotations

import torch

from ..utils.dist import sq_norms
from .ivf_base import IvfBase, route_to_cells

__all__ = ["IvfIndex", "route_to_cells"]


class IvfIndex(IvfBase):
    """Inverted-file index over f32 storage."""

    mode = "f32"

    def _encode_storage(self, x, order, seed):
        x_sorted = x[order]
        self._pad_storage(x_sorted, sq_norms(x_sorted))

    def _decoded_sorted(self) -> torch.Tensor:
        return self.storage[: self.n]

    @classmethod
    def load(cls, path: str, device="cuda") -> "IvfIndex":
        """Load an index saved by either package's ``save`` (npz). A
        loaded index keeps no f64 copy: it answers at f32 grade."""
        from ..interop import ivf_from_jax_arrays

        arrays, meta = cls._read_npz(path, cls.__name__)
        return ivf_from_jax_arrays(arrays, meta, device)
