"""Public API facade (port of ``annsearch_tpu.lib``, all of its rows, in
its ``__all__`` order: the exhaustive, flat quantised (bf16, SQ8, PQ,
OPQ), IVF, quantised IVF (bf16, SQ8), IVF-PQ, IVF-OPQ, binary (flat and
IVF), RaBitQ (flat and IVF), NNDescent, HNSW, Vamana, kMkNN, Annoy,
ball-tree, kd-tree and LSH rows, and the ``*_gpu`` names, which the JAX
package keeps as aliases of its one accelerated engine).

Every row takes the JAX row's parameters in the JAX row's order, ``verbose``
included (``_query``: batches of 100k queries or more report their
progress); what the port adds (``device`` on the build rows, the IVF
tiers' ``approx`` / ``q_split``) is keyword-only, so a positional call means
what it means to the JAX package. Queries return ``(ids [nq, k], dists
[nq, k] | None)`` as tensors on the index's device: ids int64, distances
float32 ascending (euclidean squared). Build functions take ``device``
(default ``"cuda"``).
"""

from __future__ import annotations

from typing import Any

import torch

from .models.binary import (
    ExhaustiveIndexBinary,
    ExhaustiveIndexRaBitQ,
    IvfIndexBinary,
    IvfIndexRaBitQ,
)
from .models.exhaustive import ExhaustiveIndex
from .models.graph import NNDescentIndex
from .models.hnsw import HnswIndex
from .models.ivf import IvfIndex
from .models.kmknn import KmknnIndex
from .models.lsh import LSHIndex
from .models.quantised.flat import (
    ExhaustiveIndexBf16,
    ExhaustiveOpqIndex,
    ExhaustivePqIndex,
    ExhaustiveSq8Index,
)
from .models.quantised.ivf import IvfIndexBf16, IvfOpqIndex, IvfPqIndex, IvfSq8Index
from .models.trees import AnnoyIndex, BallTreeIndex, KdTreeIndex
from .models.vamana import VamanaIndex

__all__ = [
    "build_exhaustive_index",
    "query_exhaustive_index",
    "query_exhaustive_self",
    "build_ivf_index",
    "query_ivf_index",
    "query_ivf_self",
    "build_exhaustive_bf16_index",
    "query_exhaustive_bf16_index",
    "query_exhaustive_bf16_self",
    "build_exhaustive_sq8_index",
    "query_exhaustive_sq8_index",
    "query_exhaustive_sq8_self",
    "build_exhaustive_pq_index",
    "query_exhaustive_pq_index",
    "query_exhaustive_pq_index_self",
    "build_exhaustive_opq_index",
    "query_exhaustive_opq_index",
    "query_exhaustive_opq_index_self",
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
    "build_exhaustive_index_binary",
    "query_exhaustive_index_binary",
    "query_exhaustive_index_binary_self",
    "build_ivf_index_binary",
    "query_ivf_index_binary",
    "query_ivf_index_binary_self",
    "build_exhaustive_index_rabitq",
    "query_exhaustive_index_rabitq",
    "query_exhaustive_index_rabitq_self",
    "build_ivf_index_rabitq",
    "query_ivf_index_rabitq",
    "query_ivf_index_rabitq_self",
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
    "build_hnsw_index",
    "query_hnsw_index",
    "query_hnsw_self",
    "build_vamana_index",
    "query_vamana_index",
    "query_vamana_self",
    "build_kmknn_index",
    "query_kmknn_index",
    "query_kmknn_self",
    "build_annoy_index",
    "query_annoy_index",
    "query_annoy_self",
    "build_balltree_index",
    "query_balltree_index",
    "query_balltree_self",
    "build_kd_tree_index",
    "query_kd_tree_index",
    "query_kd_tree_self",
    "build_lsh_index",
    "query_lsh_index",
    "query_lsh_self",
]


def _maybe_dist(idx, dist, return_dist: bool):
    return (idx, dist) if return_dist else (idx, None)


def _query(index, query_mat, verbose, *args, **kw):
    """``index.query`` with the reference's progress report: a verbose batch
    of 100k queries or more runs in chunks of 100k, each followed by
    ``  Processed X / Y samples.`` (underscore-separated counts)."""
    nq = int(query_mat.shape[0])
    if not verbose or nq < 100_000:
        return index.query(query_mat, *args, **kw)
    ids, dists = [], []
    for i0 in range(0, nq, 100_000):
        i, d = index.query(query_mat[i0 : i0 + 100_000], *args, **kw)
        ids.append(i)
        dists.append(d)
        print(f"  Processed {min(i0 + 100_000, nq):_} / {nq:_} samples.")
    return torch.cat(ids), torch.cat(dists)


# -- exhaustive -----------------------------------------------------------------


def build_exhaustive_index(
    mat: Any, dist_metric: str = "euclidean", *, device="cuda"
) -> ExhaustiveIndex:
    return ExhaustiveIndex(mat, dist_metric, device=device)


def query_exhaustive_index(
    query_mat: Any, index: ExhaustiveIndex, k: int, return_dist: bool = False,
    verbose: bool = False,
):
    return _maybe_dist(*_query(index, query_mat, verbose, k), return_dist)


def query_exhaustive_self(
    index: ExhaustiveIndex, k: int, return_dist: bool = False, verbose: bool = False
):
    return _maybe_dist(*index.generate_knn(k), return_dist)


# -- flat quantised indexes -----------------------------------------------------


def build_exhaustive_bf16_index(
    mat: Any, dist_metric: str = "euclidean", *, device="cuda"
) -> ExhaustiveIndexBf16:
    return ExhaustiveIndexBf16(mat, dist_metric, device=device)


def query_exhaustive_bf16_index(query_mat, index, k, return_dist=False, verbose=False):
    return _maybe_dist(*_query(index, query_mat, verbose, k), return_dist)


def query_exhaustive_bf16_self(index, k, return_dist=False, verbose=False):
    return _maybe_dist(*index.generate_knn(k), return_dist)


def build_exhaustive_sq8_index(
    mat: Any, dist_metric: str = "euclidean", *, device="cuda"
) -> ExhaustiveSq8Index:
    return ExhaustiveSq8Index(mat, dist_metric, device=device)


def query_exhaustive_sq8_index(query_mat, index, k, return_dist=False, verbose=False):
    return _maybe_dist(*_query(index, query_mat, verbose, k), return_dist)


def query_exhaustive_sq8_self(index, k, return_dist=False, verbose=False):
    return _maybe_dist(*index.generate_knn(k), return_dist)


def build_exhaustive_pq_index(
    mat: Any, m: int = 16, dist_metric: str = "euclidean", seed: int = 42,
    verbose: bool = False, *, device="cuda",
) -> ExhaustivePqIndex:
    return ExhaustivePqIndex(mat, m=m, metric=dist_metric, seed=seed, device=device)


def query_exhaustive_pq_index(query_mat, index, k, return_dist=False, verbose=False):
    return _maybe_dist(*_query(index, query_mat, verbose, k), return_dist)


def query_exhaustive_pq_index_self(index, k, return_dist=False, verbose=False):
    return _maybe_dist(*index.generate_knn(k), return_dist)


def build_exhaustive_opq_index(
    mat: Any, m: int = 16, dist_metric: str = "euclidean", seed: int = 42,
    verbose: bool = False, *, device="cuda",
) -> ExhaustiveOpqIndex:
    return ExhaustiveOpqIndex(mat, m=m, metric=dist_metric, seed=seed, device=device)


def query_exhaustive_opq_index(query_mat, index, k, return_dist=False, verbose=False):
    return _maybe_dist(*_query(index, query_mat, verbose, k), return_dist)


def query_exhaustive_opq_index_self(index, k, return_dist=False, verbose=False):
    return _maybe_dist(*index.generate_knn(k), return_dist)


# -- IVF ------------------------------------------------------------------------


def build_ivf_index(
    mat: Any, nlist=None, max_iters=None, dist_metric="euclidean", seed=42,
    verbose=False, *, device="cuda",
) -> IvfIndex:
    return IvfIndex(
        mat, dist_metric, nlist=nlist,
        max_iters=30 if max_iters is None else max_iters, seed=seed,
        verbose=verbose, device=device,
    )


def query_ivf_index(
    query_mat, index: IvfIndex, k: int, nprobe=None, return_dist=False,
    verbose: bool = False, certify: bool = False,
):
    """The exact tier; ``certify=True`` adds the triangle-inequality probe
    certificate (provably exact top-k; ``nprobe`` becomes the starting
    probe count)."""
    return _maybe_dist(
        *_query(index, query_mat, verbose, k, nprobe=nprobe, certify=certify), return_dist
    )


def query_ivf_self(index: IvfIndex, k: int, nprobe=None, return_dist=False, verbose=False):
    return _maybe_dist(*index.generate_knn(k, nprobe=nprobe), return_dist)


def build_ivf_bf16_index(
    mat: Any, nlist=None, max_iters=None, dist_metric="euclidean", seed=42,
    verbose=False, *, device="cuda",
) -> IvfIndexBf16:
    return IvfIndexBf16(
        mat, dist_metric, nlist=nlist,
        max_iters=30 if max_iters is None else max_iters, seed=seed,
        verbose=verbose, device=device,
    )


def query_ivf_bf16_index(query_mat, index: IvfIndexBf16, k: int, nprobe=None,
                         return_dist=False, verbose=False):
    """The exact tier (kernel K1c-bf16 and an f32 rescore over the bf16
    rows), as the JAX row runs it."""
    return _maybe_dist(*_query(index, query_mat, verbose, k, nprobe=nprobe), return_dist)


def query_ivf_bf16_self(index: IvfIndexBf16, k: int, nprobe=None, return_dist=False,
                        verbose=False):
    return _maybe_dist(*index.generate_knn(k, nprobe=nprobe), return_dist)


def build_ivf_sq8_index(
    mat: Any, nlist=None, max_iters=None, dist_metric="euclidean", seed=42,
    verbose=False, *, device="cuda",
) -> IvfSq8Index:
    return IvfSq8Index(
        mat, dist_metric, nlist=nlist,
        max_iters=30 if max_iters is None else max_iters, seed=seed,
        verbose=verbose, device=device,
    )


def query_ivf_sq8_index(query_mat, index: IvfSq8Index, k: int, nprobe=None,
                        return_dist=False, verbose=False):
    """The exact tier (kernel K1c-sq8: integer-space distances), as the JAX
    row runs it."""
    return _maybe_dist(*_query(index, query_mat, verbose, k, nprobe=nprobe), return_dist)


def query_ivf_sq8_self(index: IvfSq8Index, k: int, nprobe=None, return_dist=False,
                       verbose=False):
    return _maybe_dist(*index.generate_knn(k, nprobe=nprobe), return_dist)


def build_ivf_pq_index(
    mat: Any, nlist=None, m: int = 16, max_iters=None,
    dist_metric="euclidean", seed=42, verbose=False, *, device="cuda",
) -> IvfPqIndex:
    return IvfPqIndex(
        mat, dist_metric, nlist=nlist, m=m,
        max_iters=30 if max_iters is None else max_iters, seed=seed,
        verbose=verbose, device=device,
    )


def query_ivf_pq_index(
    query_mat, index, k, nprobe=None, return_dist=False, verbose=False, *,
    approx: bool = False, q_split: bool | None = None,
):
    """The exact tier (the cluster scan over the probed cells) by default,
    as the JAX row; ``approx=True`` takes the fused tier where the index has
    one (``m = dim``: kernels K1a / K1b), with ``q_split=True`` for two bf16
    query terms."""
    return _maybe_dist(
        *_query(index, query_mat, verbose, k, nprobe=nprobe, approx=approx, q_split=q_split),
        return_dist,
    )


def query_ivf_pq_index_self(index, k: int, nprobe=None, return_dist=False, verbose=False):
    return _maybe_dist(*index.generate_knn(k, nprobe=nprobe), return_dist)


def build_ivf_opq_index(
    mat: Any, nlist=None, m: int = 16, max_iters=None,
    dist_metric="euclidean", seed=42, verbose=False, *, device="cuda",
) -> IvfOpqIndex:
    return IvfOpqIndex(
        mat, dist_metric, nlist=nlist, m=m,
        max_iters=30 if max_iters is None else max_iters, seed=seed,
        verbose=verbose, device=device,
    )


def query_ivf_opq_index(
    query_mat, index, k, nprobe=None, return_dist=False, verbose=False, *,
    approx: bool = False, q_split: bool | None = None,
):
    """As :func:`query_ivf_pq_index`, over an :class:`IvfOpqIndex`."""
    return query_ivf_pq_index(query_mat, index, k, nprobe, return_dist, verbose,
                              approx=approx, q_split=q_split)


def query_ivf_opq_index_self(index, k: int, nprobe=None, return_dist=False, verbose=False):
    return _maybe_dist(*index.generate_knn(k, nprobe=nprobe), return_dist)



# -- binary indexes ---------------------------------------------------------------


def build_exhaustive_index_binary(
    mat: Any, dist_metric: str = "euclidean", n_bits=None,
    binarisation: str = "simhash", seed: int = 42, store=True,
    verbose: bool = False, *, device="cuda",
) -> ExhaustiveIndexBinary:
    return ExhaustiveIndexBinary(
        mat, dist_metric, n_bits=n_bits, binarisation=binarisation, seed=seed,
        store=store, device=device,
    )


def query_exhaustive_index_binary(
    query_mat, index, k, rerank=None, rerank_factor=20, return_dist=False, verbose=False,
):
    return _maybe_dist(
        *_query(index, query_mat, verbose, k, rerank=rerank, rerank_factor=rerank_factor),
        return_dist,
    )


def query_exhaustive_index_binary_self(
    index, k, rerank=None, rerank_factor=20, return_dist=False, verbose=False
):
    return _maybe_dist(
        *index.generate_knn(k, rerank=rerank, rerank_factor=rerank_factor), return_dist
    )


def build_ivf_index_binary(
    mat: Any, dist_metric: str = "euclidean", nlist=None, n_bits=None,
    binarisation: str = "simhash", max_iters=None, seed: int = 42,
    store=True, verbose: bool = False, *, device="cuda",
) -> IvfIndexBinary:
    return IvfIndexBinary(
        mat, dist_metric, nlist=nlist, n_bits=n_bits, binarisation=binarisation,
        max_iters=30 if max_iters is None else max_iters, seed=seed, store=store,
        verbose=verbose, device=device,
    )


def query_ivf_index_binary(
    query_mat, index, k, nprobe=None, rerank=None, rerank_factor=20,
    return_dist=False, verbose=False,
):
    return _maybe_dist(
        *_query(index, query_mat, verbose, k, nprobe=nprobe, rerank=rerank,
                rerank_factor=rerank_factor),
        return_dist,
    )


def query_ivf_index_binary_self(
    index, k, nprobe=None, rerank=None, rerank_factor=20, return_dist=False, verbose=False,
):
    return _maybe_dist(
        *index.generate_knn(k, nprobe=nprobe, rerank=rerank, rerank_factor=rerank_factor),
        return_dist,
    )


# -- RaBitQ indexes ---------------------------------------------------------------


def build_exhaustive_index_rabitq(
    mat: Any, dist_metric: str = "euclidean", nlist=None, max_iters=None,
    seed: int = 42, store=True, verbose: bool = False, *, device="cuda",
) -> ExhaustiveIndexRaBitQ:
    return ExhaustiveIndexRaBitQ(
        mat, dist_metric, nlist=nlist, max_iters=30 if max_iters is None else max_iters,
        seed=seed, store=store, verbose=verbose, device=device,
    )


def query_exhaustive_index_rabitq(
    query_mat, index, k, nprobe=None, rerank=None, rerank_factor=10,
    return_dist=False, verbose=False,
):
    return _maybe_dist(
        *_query(index, query_mat, verbose, k, nprobe=nprobe, rerank=rerank,
                rerank_factor=rerank_factor),
        return_dist,
    )


def query_exhaustive_index_rabitq_self(
    index, k, nprobe=None, rerank=None, rerank_factor=10, return_dist=False, verbose=False,
):
    return _maybe_dist(
        *index.generate_knn(k, nprobe=nprobe, rerank=rerank, rerank_factor=rerank_factor),
        return_dist,
    )


def build_ivf_index_rabitq(
    mat: Any, dist_metric: str = "euclidean", nlist=None, max_iters=None,
    seed: int = 42, store=True, verbose: bool = False, *, device="cuda",
) -> IvfIndexRaBitQ:
    return IvfIndexRaBitQ(
        mat, dist_metric, nlist=nlist, max_iters=30 if max_iters is None else max_iters,
        seed=seed, store=store, verbose=verbose, device=device,
    )


def query_ivf_index_rabitq(
    query_mat, index, k, nprobe=None, rerank=None, rerank_factor=10,
    return_dist=False, verbose=False,
):
    return _maybe_dist(
        *_query(index, query_mat, verbose, k, nprobe=nprobe, rerank=rerank,
                rerank_factor=rerank_factor),
        return_dist,
    )


def query_ivf_index_rabitq_self(
    index, k, nprobe=None, rerank=None, rerank_factor=10, return_dist=False, verbose=False,
):
    return _maybe_dist(
        *index.generate_knn(k, nprobe=nprobe, rerank=rerank, rerank_factor=rerank_factor),
        return_dist,
    )


# -- graph indexes --------------------------------------------------------------


def build_nndescent_index(
    mat: Any, dist_metric: str = "euclidean", k: int = 30, n_trees=None,
    max_iters=None, delta: float = 0.001, seed: int = 42, verbose: bool = False,
    *, device="cuda", **kw,
) -> NNDescentIndex:
    return NNDescentIndex(
        mat, dist_metric, k=k,
        n_trees=4 if n_trees is None else n_trees,
        max_rounds=10 if max_iters is None else max_iters,
        delta=delta, seed=seed, verbose=verbose, device=device, **kw,
    )


def query_nndescent_index(query_mat, index, k, beam=None, iters=None, return_dist=False,
                          verbose=False):
    """Small batches take the exact fallback, the rest the beam search
    (:meth:`NNDescentIndex.query`)."""
    return _maybe_dist(*_query(index, query_mat, verbose, k, beam=beam, iters=iters),
                       return_dist)


def query_nndescent_self(index, k, return_dist=False, verbose=False, mode="graph"):
    return _maybe_dist(*index.generate_knn(k, mode=mode), return_dist)


build_nndescent_index_gpu = build_nndescent_index
query_nndescent_index_gpu = query_nndescent_index
query_nndescent_index_gpu_self = query_nndescent_self


def extract_nndescent_knn_gpu(index, k, return_dist=False, verbose=False):
    """The built kNN graph (self excluded)."""
    return _maybe_dist(*index.generate_knn(k, mode="graph"), return_dist)


def build_exhaustive_index_gpu(mat: Any, dist_metric: str = "euclidean", *, device="cuda"):
    return build_exhaustive_index(mat, dist_metric, device=device)


def query_exhaustive_index_gpu(query_mat, index, k, return_dist=False, verbose=False):
    """The flat scan through the running-bins selector (``selector="bins"``)."""
    return _maybe_dist(*_query(index, query_mat, verbose, k, selector="bins"), return_dist)


def query_exhaustive_index_gpu_self(index, k, return_dist=False, verbose=False):
    return _maybe_dist(*index.generate_knn(k, selector="bins"), return_dist)


def build_ivf_index_gpu(
    mat: Any, nlist=None, max_iters=None, dist_metric="euclidean", seed=42,
    verbose=False, *, device="cuda",
):
    return build_ivf_index(mat, nlist, max_iters, dist_metric, seed, verbose, device=device)


def query_ivf_index_gpu(query_mat, index, k, nprobe=None, return_dist=False, verbose=False):
    """The fused approximate tier (``approx=True``: kernel K1d-f32)."""
    return _maybe_dist(*_query(index, query_mat, verbose, k, nprobe=nprobe, approx=True),
                       return_dist)


def query_ivf_index_gpu_self(index, k, nprobe=None, return_dist=False, verbose=False):
    q = index.vectors_original_order()
    return _maybe_dist(*_query(index, q, verbose, k, nprobe=nprobe, approx=True), return_dist)


# -- HNSW, Vamana -----------------------------------------------------------------


def build_hnsw_index(
    mat: Any, dist_metric: str = "euclidean", m: int = 16, ef_construction: int = 100,
    seed: int = 42, verbose: bool = False, *, device="cuda",
) -> HnswIndex:
    return HnswIndex(mat, dist_metric, m=m, ef_construction=ef_construction, seed=seed,
                     verbose=verbose, device=device)


def query_hnsw_index(query_mat, index, k, ef_search=None, return_dist=False, verbose=False):
    return _maybe_dist(*_query(index, query_mat, verbose, k, ef_search=ef_search), return_dist)


def query_hnsw_self(index, k, ef_search=None, return_dist=False, verbose=False):
    return _maybe_dist(*index.generate_knn(k, ef_search=ef_search), return_dist)


def build_vamana_index(
    mat: Any, dist_metric: str = "euclidean", r_degree: int = 32, alpha: float = 1.2,
    seed: int = 42, verbose: bool = False, *, device="cuda",
) -> VamanaIndex:
    return VamanaIndex(mat, dist_metric, r_degree=r_degree, alpha=alpha, seed=seed,
                       verbose=verbose, device=device)


def query_vamana_index(query_mat, index, k, beam=None, return_dist=False, verbose=False):
    return _maybe_dist(*_query(index, query_mat, verbose, k, beam=beam), return_dist)


def query_vamana_self(index, k, beam=None, return_dist=False, verbose=False):
    return _maybe_dist(*index.generate_knn(k, beam=beam), return_dist)


# -- kMkNN, Annoy, ball tree, kd-tree, LSH ---------------------------------------


def build_kmknn_index(
    mat: Any, dist_metric: str = "euclidean", nlist=None, max_iters=None,
    seed: int = 42, verbose: bool = False, *, device="cuda",
) -> KmknnIndex:
    return KmknnIndex(
        mat, dist_metric, nlist=nlist,
        max_iters=30 if max_iters is None else max_iters, seed=seed,
        verbose=verbose, device=device,
    )


def query_kmknn_index(query_mat, index, k, return_dist=False, verbose=False):
    """Exact: the two-phase triangle-bound scan (the cluster scan), or the
    small-batch exact fallback."""
    return _maybe_dist(*_query(index, query_mat, verbose, k), return_dist)


def query_kmknn_self(index, k, return_dist=False, verbose=False):
    return _maybe_dist(*index.generate_knn(k), return_dist)


def build_annoy_index(
    mat: Any, dist_metric: str = "euclidean", n_trees: int = 16,
    leaf: int = 64, seed: int = 42, verbose: bool = False, *, device="cuda",
) -> AnnoyIndex:
    return AnnoyIndex(mat, dist_metric, n_trees=n_trees, leaf=leaf, seed=seed, device=device)


def query_annoy_index(
    query_mat, index, k, n_probes: int = 2, search_k=None,
    return_dist=False, verbose=False,
):
    """The fused route (K1d-f32 with a per-tree merge) where the forest's
    cells fit it, else the leaf-union rerank; ``search_k`` is accepted and
    unused, as in the JAX package (``n_probes`` is the budget)."""
    return _maybe_dist(*_query(index, query_mat, verbose, k, n_probes=n_probes), return_dist)


def query_annoy_self(
    index, k, n_probes: int = 2, search_k=None, return_dist=False, verbose=False,
):
    return _maybe_dist(*index.generate_knn(k, n_probes=n_probes), return_dist)


def build_balltree_index(
    mat: Any, dist_metric: str = "euclidean", seed: int = 42, verbose: bool = False,
    *, device="cuda",
) -> BallTreeIndex:
    return BallTreeIndex(mat, dist_metric, seed=seed, device=device)


def query_balltree_index(query_mat, index, k, budget=None, return_dist=False, verbose=False):
    """The cell scan (K1d-f32) over the ``budget`` share of the rows nearest
    by cell centre, or the leaf rerank on small trees."""
    return _maybe_dist(*_query(index, query_mat, verbose, k, budget=budget), return_dist)


def query_balltree_self(index, k, budget=None, return_dist=False, verbose=False):
    return _maybe_dist(*index.generate_knn(k, budget=budget), return_dist)


def build_kd_tree_index(
    mat: Any, dist_metric: str = "euclidean", n_trees: int = 16,
    leaf: int = 64, seed: int = 42, verbose: bool = False, *, device="cuda",
) -> KdTreeIndex:
    return KdTreeIndex(mat, dist_metric, n_trees=n_trees, leaf=leaf, seed=seed, device=device)


def query_kd_tree_index(
    query_mat, index, k, n_probes: int = 2, search_k=None,
    return_dist=False, verbose=False,
):
    """As :func:`query_annoy_index`, over a kd-forest."""
    return _maybe_dist(*_query(index, query_mat, verbose, k, n_probes=n_probes), return_dist)


def query_kd_tree_self(
    index, k, n_probes: int = 2, search_k=None, return_dist=False, verbose=False,
):
    return _maybe_dist(*index.generate_knn(k, n_probes=n_probes), return_dist)


def build_lsh_index(
    mat: Any, dist_metric: str = "euclidean", num_tables: int = 8,
    bits_per_hash: int = 16, seed: int = 42, verbose: bool = False, *, device="cuda",
) -> LSHIndex:
    return LSHIndex(mat, dist_metric, num_tables=num_tables, bits_per_hash=bits_per_hash,
                    seed=seed, device=device)


def query_lsh_index(query_mat, index, k, n_probes: int = 4, return_dist=False, verbose=False):
    """The fused bucket scan (K1d-f32) where the buckets' segments are a
    multiple of 128 rows, else the cluster scan."""
    return _maybe_dist(*_query(index, query_mat, verbose, k, n_probes=n_probes), return_dist)


def query_lsh_self(index, k, n_probes: int = 4, return_dist=False, verbose=False):
    return _maybe_dist(*index.generate_knn(k, n_probes=n_probes), return_dist)
