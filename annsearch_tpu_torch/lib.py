"""Public API facade (port of ``annsearch_tpu.lib``: the exhaustive, IVF
and IVF-PQ rows).

Queries return ``(ids [nq, k], dists [nq, k] | None)`` as tensors on the
index's device: ids int64, distances float32 ascending (euclidean squared).
Build functions take ``device`` (default ``"cuda"``).
"""

from __future__ import annotations

from typing import Any

from .models.exhaustive import ExhaustiveIndex
from .models.ivf import IvfIndex
from .models.quantised.ivf import IvfPqIndex

__all__ = [
    "build_exhaustive_index",
    "query_exhaustive_index",
    "query_exhaustive_self",
    "build_ivf_index",
    "query_ivf_index",
    "query_ivf_self",
    "build_ivf_pq_index",
    "query_ivf_pq_index",
]


def _maybe_dist(idx, dist, return_dist: bool):
    return (idx, dist) if return_dist else (idx, None)


def build_exhaustive_index(
    mat: Any, dist_metric: str = "euclidean", device="cuda"
) -> ExhaustiveIndex:
    return ExhaustiveIndex(mat, dist_metric, device=device)


def query_exhaustive_index(
    query_mat: Any, index: ExhaustiveIndex, k: int, return_dist: bool = False
):
    return _maybe_dist(*index.query(query_mat, k), return_dist)


def query_exhaustive_self(index: ExhaustiveIndex, k: int, return_dist: bool = False):
    return _maybe_dist(*index.generate_knn(k), return_dist)


def build_ivf_index(
    mat: Any, nlist=None, max_iters=None, dist_metric="euclidean", seed=42,
    verbose=False, device="cuda",
) -> IvfIndex:
    return IvfIndex(
        mat, dist_metric, nlist=nlist,
        max_iters=30 if max_iters is None else max_iters, seed=seed,
        verbose=verbose, device=device,
    )


def query_ivf_index(
    query_mat, index: IvfIndex, k: int, nprobe=None, return_dist=False,
    certify: bool = False,
):
    """The exact tier; ``certify=True`` adds the triangle-inequality probe
    certificate (provably exact top-k; ``nprobe`` becomes the starting
    probe count)."""
    return _maybe_dist(
        *index.query(query_mat, k, nprobe=nprobe, certify=certify), return_dist
    )


def query_ivf_self(index: IvfIndex, k: int, nprobe=None, return_dist=False):
    return _maybe_dist(*index.generate_knn(k, nprobe=nprobe), return_dist)


def build_ivf_pq_index(
    mat: Any, nlist=None, m: int = 16, max_iters=None,
    dist_metric="euclidean", seed=42, verbose=False, device="cuda",
) -> IvfPqIndex:
    return IvfPqIndex(
        mat, dist_metric, nlist=nlist, m=m,
        max_iters=30 if max_iters is None else max_iters, seed=seed,
        verbose=verbose, device=device,
    )


def query_ivf_pq_index(
    query_mat, index, k, nprobe=None, return_dist=False, approx: bool = False
):
    """``approx=True`` takes the fused tier, the only one ported for IVF-PQ;
    the default, ``False``, raises ``NotImplementedError``: the exact tier
    of the int8 modes needs the cluster scan ``ivf_cluster_scan``."""
    return _maybe_dist(
        *index.query(query_mat, k, nprobe=nprobe, approx=approx), return_dist
    )
