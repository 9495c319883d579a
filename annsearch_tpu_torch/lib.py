"""Public API facade (port of ``annsearch_tpu.lib``: the exhaustive, IVF,
quantised IVF (bf16, SQ8), IVF-PQ, IVF-OPQ and NNDescent rows, and the
``*_gpu`` names, which the JAX package keeps as aliases of its one
accelerated engine).

Queries return ``(ids [nq, k], dists [nq, k] | None)`` as tensors on the
index's device: ids int64, distances float32 ascending (euclidean squared).
Build functions take ``device`` (default ``"cuda"``).
"""

from __future__ import annotations

from typing import Any

from .models.exhaustive import ExhaustiveIndex
from .models.graph import NNDescentIndex
from .models.ivf import IvfIndex
from .models.quantised.ivf import IvfIndexBf16, IvfOpqIndex, IvfPqIndex, IvfSq8Index

__all__ = [
    "build_exhaustive_index",
    "query_exhaustive_index",
    "query_exhaustive_self",
    "build_ivf_index",
    "query_ivf_index",
    "query_ivf_self",
    "build_ivf_bf16_index",
    "query_ivf_bf16_index",
    "query_ivf_bf16_self",
    "build_ivf_sq8_index",
    "query_ivf_sq8_index",
    "query_ivf_sq8_self",
    "build_ivf_pq_index",
    "query_ivf_pq_index",
    "query_ivf_pq_index_self",
    "build_ivf_opq_index",
    "query_ivf_opq_index",
    "query_ivf_opq_index_self",
    "build_nndescent_index",
    "query_nndescent_index",
    "query_nndescent_self",
    "build_nndescent_index_gpu",
    "query_nndescent_index_gpu",
    "query_nndescent_index_gpu_self",
    "extract_nndescent_knn_gpu",
    "build_exhaustive_index_gpu",
    "query_exhaustive_index_gpu",
    "query_exhaustive_index_gpu_self",
    "build_ivf_index_gpu",
    "query_ivf_index_gpu",
    "query_ivf_index_gpu_self",
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


def build_ivf_bf16_index(
    mat: Any, nlist=None, max_iters=None, dist_metric="euclidean", seed=42,
    verbose=False, device="cuda",
) -> IvfIndexBf16:
    return IvfIndexBf16(
        mat, dist_metric, nlist=nlist,
        max_iters=30 if max_iters is None else max_iters, seed=seed,
        verbose=verbose, device=device,
    )


def query_ivf_bf16_index(query_mat, index: IvfIndexBf16, k: int, nprobe=None, return_dist=False):
    """The exact tier (kernel K1c-bf16 and an f32 rescore over the bf16
    rows), as the JAX row runs it."""
    return _maybe_dist(*index.query(query_mat, k, nprobe=nprobe), return_dist)


def query_ivf_bf16_self(index: IvfIndexBf16, k: int, nprobe=None, return_dist=False):
    return _maybe_dist(*index.generate_knn(k, nprobe=nprobe), return_dist)


def build_ivf_sq8_index(
    mat: Any, nlist=None, max_iters=None, dist_metric="euclidean", seed=42,
    verbose=False, device="cuda",
) -> IvfSq8Index:
    return IvfSq8Index(
        mat, dist_metric, nlist=nlist,
        max_iters=30 if max_iters is None else max_iters, seed=seed,
        verbose=verbose, device=device,
    )


def query_ivf_sq8_index(query_mat, index: IvfSq8Index, k: int, nprobe=None, return_dist=False):
    """The exact tier (kernel K1c-sq8: integer-space distances), as the JAX
    row runs it."""
    return _maybe_dist(*index.query(query_mat, k, nprobe=nprobe), return_dist)


def query_ivf_sq8_self(index: IvfSq8Index, k: int, nprobe=None, return_dist=False):
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
    query_mat, index, k, nprobe=None, return_dist=False, approx: bool = False,
    q_split: bool | None = None,
):
    """The exact tier (the cluster scan over the probed cells) by default,
    as the JAX row; ``approx=True`` takes the fused tier where the index has
    one (``m = dim``: kernels K1a / K1b), with ``q_split=True`` for two bf16
    query terms."""
    return _maybe_dist(
        *index.query(query_mat, k, nprobe=nprobe, approx=approx, q_split=q_split),
        return_dist,
    )


def query_ivf_pq_index_self(index, k: int, nprobe=None, return_dist=False):
    return _maybe_dist(*index.generate_knn(k, nprobe=nprobe), return_dist)


def build_ivf_opq_index(
    mat: Any, nlist=None, m: int = 16, max_iters=None,
    dist_metric="euclidean", seed=42, verbose=False, device="cuda",
) -> IvfOpqIndex:
    return IvfOpqIndex(
        mat, dist_metric, nlist=nlist, m=m,
        max_iters=30 if max_iters is None else max_iters, seed=seed,
        verbose=verbose, device=device,
    )


def query_ivf_opq_index(
    query_mat, index, k, nprobe=None, return_dist=False, approx: bool = False,
    q_split: bool | None = None,
):
    """As :func:`query_ivf_pq_index`, over an :class:`IvfOpqIndex`."""
    return query_ivf_pq_index(query_mat, index, k, nprobe, return_dist, approx, q_split)


def query_ivf_opq_index_self(index, k: int, nprobe=None, return_dist=False):
    return _maybe_dist(*index.generate_knn(k, nprobe=nprobe), return_dist)


def build_nndescent_index(
    mat: Any, dist_metric: str = "euclidean", k: int = 30, n_trees=None,
    max_iters=None, delta: float = 0.001, seed: int = 42, verbose: bool = False,
    device="cuda", **kw,
) -> NNDescentIndex:
    return NNDescentIndex(
        mat, dist_metric, k=k,
        n_trees=4 if n_trees is None else n_trees,
        max_rounds=10 if max_iters is None else max_iters,
        delta=delta, seed=seed, verbose=verbose, device=device, **kw,
    )


def query_nndescent_index(query_mat, index, k, beam=None, iters=None, return_dist=False):
    """Small batches take the exact fallback, the rest the beam search
    (:meth:`NNDescentIndex.query`)."""
    return _maybe_dist(*index.query(query_mat, k, beam=beam, iters=iters), return_dist)


def query_nndescent_self(index, k, return_dist=False, mode="graph"):
    return _maybe_dist(*index.generate_knn(k, mode=mode), return_dist)


build_nndescent_index_gpu = build_nndescent_index
query_nndescent_index_gpu = query_nndescent_index
query_nndescent_index_gpu_self = query_nndescent_self


def extract_nndescent_knn_gpu(index, k, return_dist=False):
    """The built kNN graph (self excluded)."""
    return _maybe_dist(*index.generate_knn(k, mode="graph"), return_dist)


build_exhaustive_index_gpu = build_exhaustive_index


def query_exhaustive_index_gpu(query_mat, index, k, return_dist=False):
    """The flat scan through the running-bins selector (``selector="bins"``)."""
    return _maybe_dist(*index.query(query_mat, k, selector="bins"), return_dist)


def query_exhaustive_index_gpu_self(index, k, return_dist=False):
    return _maybe_dist(*index.generate_knn(k, selector="bins"), return_dist)


build_ivf_index_gpu = build_ivf_index


def query_ivf_index_gpu(query_mat, index, k, nprobe=None, return_dist=False):
    """The fused approximate tier (``approx=True``: kernel K1d-f32)."""
    return _maybe_dist(*index.query(query_mat, k, nprobe=nprobe, approx=True), return_dist)


def query_ivf_index_gpu_self(index, k, nprobe=None, return_dist=False):
    q = index.vectors_original_order()
    return _maybe_dist(*index.query(q, k, nprobe=nprobe, approx=True), return_dist)
