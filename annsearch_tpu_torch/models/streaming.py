"""Exact search over a database larger than the device (port of
``annsearch_tpu.models.streaming``).

The database stays on the host: a numpy array, or a raw ``.vec`` file with
its ``.json`` (the ``MmapVectorStore`` format) read through ``np.memmap``.
Each query batch stays on the device while row chunks are copied there and
folded into a running top-k by the scan of the exhaustive index
(``ops/topk.chunked_topk``, then ``merge_topk``). Each batch moves the whole
database, ``n·d·4`` bytes, to the device once.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from ..ops.topk import chunked_topk, merge_topk
from ..utils.dist import Dist, normalise, parse_ann_dist
from .base import as_f32_matrix

__all__ = ["StreamingExhaustiveIndex"]


class StreamingExhaustiveIndex:
    """Exact top-k over a host-resident (RAM or mmap) database."""

    def __init__(self, mat: Any, metric: str | Dist = "euclidean", device="cuda"):
        """``mat``: an ``[n, d]`` array kept on the host, or the path of a
        raw vector file written by :meth:`write` (``<path>.vec`` and
        ``<path>.json``). Queries run on ``device``; cosine normalises each
        chunk there."""
        self.metric = parse_ann_dist(metric)
        self.device = torch.device(device)
        if isinstance(mat, str):
            with open(mat + ".json") as f:
                meta = json.load(f)
            self._x = np.memmap(mat + ".vec", dtype=np.float32, mode="r",
                                shape=(meta["n"], meta["dim"]))
        elif isinstance(mat, torch.Tensor):
            self._x = mat.detach().to("cpu", torch.float32).numpy()
        else:
            self._x = np.asarray(mat, dtype=np.float32)
        if self._x.ndim != 2:
            raise ValueError(f"expected a 2-D matrix, got shape {self._x.shape}")
        self.n, self.dim = self._x.shape

    @staticmethod
    def write(path: str, vectors: Any, device="cuda") -> "StreamingExhaustiveIndex":
        """Write ``vectors`` as ``<path>.vec`` / ``<path>.json`` and open
        them as an index on ``device``."""
        arr = np.ascontiguousarray(np.asarray(vectors, np.float32))
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
        arr.tofile(path + ".vec")
        with open(path + ".json", "w") as f:
            json.dump({"n": int(arr.shape[0]), "dim": int(arr.shape[1]), "dtype": "float32"}, f)
        return StreamingExhaustiveIndex(path, device=device)

    def query(
        self, query_mat: Any, k: int, chunk_rows: int = 262_144,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Top-k ``(ids [nq, k] int64, dists [nq, k])`` on the device,
        ascending; the database goes through in chunks of ``chunk_rows``
        rows (at least ``k``)."""
        q = as_f32_matrix(query_mat, self.device)
        if q.shape[1] != self.dim:
            raise ValueError(f"query dim {q.shape[1]} != index dim {self.dim}")
        if self.metric == Dist.COSINE:
            q = normalise(q)
        k = max(1, min(int(k), self.n))
        best_d = torch.full((q.shape[0], k), float("inf"), device=self.device)
        best_i = torch.zeros((q.shape[0], k), dtype=torch.int64, device=self.device)
        step = max(k, int(chunk_rows))
        for base in range(0, self.n, step):
            xb = torch.as_tensor(np.array(self._x[base : base + step]), device=self.device)
            if self.metric == Dist.COSINE:
                xb = normalise(xb)
            d, i = chunked_topk(q, xb, k, self.metric)
            best_d, best_i = merge_topk(best_d, best_i, d, i + base, k)
        return best_i, best_d

    def generate_knn(self, k: int, **kw) -> tuple[torch.Tensor, torch.Tensor]:
        """Self-query of every stored row, the queries streamed from the
        host in blocks of 8,192."""
        parts = [self.query(self._x[s : s + 8192], k, **kw) for s in range(0, self.n, 8192)]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])

    def memory_usage_bytes(self) -> int:
        """0: the rows stay on the host; the device holds one chunk at a
        time."""
        return 0
