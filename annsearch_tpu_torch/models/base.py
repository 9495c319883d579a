"""Shared index machinery (port of ``annsearch_tpu.models.base``).

Conventions:
  * ``query`` returns ``(ids [nq, k] int64, dists [nq, k] f32)`` tensors on
    the index's device, ascending by distance; euclidean is *squared*.
    f64 queries to an index built from f64 numpy data answer with f64
    distances (an f32 pool rescored in f64 on the host).
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

__all__ = ["BaseIndex", "as_f32_matrix", "host_f64", "rescore_f64_pool"]


def host_f64(mat: Any) -> np.ndarray | None:
    """A host f64 copy of ``mat`` when it is a float64 numpy array (the
    JAX package's rule for keeping one), else None."""
    if isinstance(mat, np.ndarray) and mat.dtype == np.float64:
        return np.ascontiguousarray(mat)
    return None


def rescore_f64_pool(
    x64: np.ndarray, q64: np.ndarray, pool: np.ndarray, k: int, metric: Dist,
) -> tuple[np.ndarray, np.ndarray]:
    """Host f64 rescore of a device-selected candidate pool.

    f64 grade comes from an f32 pre-selection on the device (pool ≥ 2k)
    and this rescore of the pooled rows in f64 on the host. ``x64`` is the
    raw f64 data in original row order; ``pool [nq, kp]`` holds original
    ids. Returns ``(ids [nq, k], dists [nq, k])`` ascending, distances
    computed fully in f64. A duplicate pool entry (a clipped sentinel
    slot) keeps one copy."""
    if metric == Dist.COSINE:
        xn = x64 / np.maximum(np.linalg.norm(x64, axis=1, keepdims=True), 1e-30)
        qn = q64 / np.maximum(np.linalg.norm(q64, axis=1, keepdims=True), 1e-30)
        dx = 1.0 - np.einsum("qd,qpd->qp", qn, xn[pool])
    else:
        diff = q64[:, None, :] - x64[pool]
        dx = np.einsum("qpd,qpd->qp", diff, diff)
    order_ids = np.argsort(pool, axis=1, kind="stable")
    sorted_pool = np.take_along_axis(pool, order_ids, axis=1)
    dup_sorted = np.zeros(pool.shape, bool)
    dup_sorted[:, 1:] = sorted_pool[:, 1:] == sorted_pool[:, :-1]
    dup = np.zeros(pool.shape, bool)
    np.put_along_axis(dup, order_ids, dup_sorted, axis=1)
    dx = np.where(dup, np.inf, dx)
    # numpy's default sort, as the JAX package takes it: equal f64
    # distances then order alike in both packages
    order = np.argsort(dx, axis=1)[:, :k]
    return (
        np.take_along_axis(pool, order, axis=1),
        np.take_along_axis(dx, order, axis=1),
    )


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

    #: host f64 copy of the build input, kept by the full-precision indexes
    #: (``load`` bypasses ``__init__``: a loaded index answers at f32 grade)
    _x64: np.ndarray | None = None

    def __init__(self, mat: Any, metric: str | Dist, device="cuda"):
        # f64 input is cast to f32 on the device; the indexes that answer
        # f64 queries at f64 grade keep a host copy (host_f64)
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

    def _f64_queries(self, query_mat: Any) -> np.ndarray | None:
        """The f64 query batch when this index keeps f64 data, else None."""
        return host_f64(query_mat) if self._x64 is not None else None

    def _rescore_f64(self, q64: np.ndarray, ids: torch.Tensor, k: int):
        """``(ids, dists)`` of a pool of original ids rescored in f64 on the
        host; tensors on the index's device, distances float64."""
        pool = np.clip(ids.cpu().numpy(), 0, self.n - 1)
        i, d = rescore_f64_pool(self._x64, q64, pool, self._clamp_k(k), self.metric)
        return (torch.as_tensor(i, device=self.device),
                torch.as_tensor(d, device=self.device))

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
