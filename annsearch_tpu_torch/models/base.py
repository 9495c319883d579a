"""Shared index machinery (port of ``annsearch_tpu.models.base``).

Conventions:
  * ``query`` returns ``(ids [nq, k] int64, dists [nq, k] f32)`` tensors on
    the index's device, ascending by distance; euclidean is *squared*.
  * ``k`` is clamped to the number of stored vectors.
  * cosine indexes store L2-normalised rows, so cosine = ``1 − QXᵀ``.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from ..utils.dist import Dist, normalise, parse_ann_dist, sq_norms

__all__ = ["BaseIndex", "as_f32_matrix"]


def as_f32_matrix(mat: Any, device) -> torch.Tensor:
    """Coerce a numpy array or tensor to a contiguous ``[n, d]`` float32
    tensor on ``device``."""
    t = torch.as_tensor(np.asarray(mat) if not isinstance(mat, torch.Tensor) else mat)
    if t.ndim != 2:
        raise ValueError(f"expected a 2-D matrix, got shape {tuple(t.shape)}")
    return t.to(device=device, dtype=torch.float32).contiguous()


class BaseIndex:
    """Stores vectors on ``device`` and prepares metric-specific state."""

    #: attribute names persisted by save/load (subclasses extend)
    _state_arrays: tuple[str, ...] = ("vectors", "sqnorms")
    _state_scalars: tuple[str, ...] = ("n", "dim")

    def __init__(self, mat: Any, metric: str | Dist, device="cuda"):
        if getattr(mat, "dtype", None) in (np.float64, torch.float64):
            # the JAX package answers f64 inputs to its full-precision
            # indexes at f64 grade (a host rescore of an f32 candidate
            # pool); until that is ported, the port takes float32 only
            raise NotImplementedError(
                "f64 inputs: the host f64 pool rescore is ROADMAP Queue 1 "
                "item 10; pass float32"
            )
        self.device = torch.device(device)
        x = as_f32_matrix(mat, self.device)
        self.metric = parse_ann_dist(metric)
        self.n, self.dim = x.shape
        if self.metric == Dist.COSINE:
            self.vectors = normalise(x)
            self.sqnorms = None
        else:
            self.vectors = x
            self.sqnorms = sq_norms(x)

    def query(self, query_mat: Any, k: int, **kw):
        raise NotImplementedError

    def _prep_queries(self, query_mat: Any) -> torch.Tensor:
        q = as_f32_matrix(query_mat, self.device)
        if q.shape[1] != self.dim:
            raise ValueError(f"query dim {q.shape[1]} != index dim {self.dim}")
        return normalise(q) if self.metric == Dist.COSINE else q

    def _clamp_k(self, k: int) -> int:
        return max(1, min(int(k), self.n))

    # -- persistence: the npz layout of the JAX package's save() ----------

    def _save_arrays(self) -> dict[str, np.ndarray]:
        return {
            name: getattr(self, name).cpu().numpy()
            for name in self._state_arrays
            if getattr(self, name, None) is not None
        }

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        meta = {"cls": type(self).__name__, "metric": self.metric.value}
        for name in self._state_scalars:
            meta[name] = int(getattr(self, name))
        arrays = self._save_arrays()
        arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
        np.savez(path, **arrays)

    @staticmethod
    def _read_npz(path: str, cls_name: str):
        """``(arrays, meta)`` of an npz written by either package's save."""
        with np.load(path if path.endswith(".npz") else path + ".npz") as z:
            meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
            arrays = {f: z[f] for f in z.files if f != "__meta__"}
        if meta["cls"] != cls_name:
            raise ValueError(f"{path} holds a {meta['cls']}, not {cls_name}")
        return arrays, meta
