"""Index state carried across from the JAX package.

``ivf_pq_from_jax_arrays`` builds the port's ``IvfPqIndex`` from the arrays
and scalars of an ``annsearch_tpu`` ``IvfPqIndex`` (int8 storage and
``dec_scales`` in mode ``i8dec_residual``, uint8 codes and no
``dec_scales`` in mode ``pq_residual``), ``ivf_opq_from_jax_arrays`` the
``IvfOpqIndex`` (the same plus ``rotation``), ``ivf_from_jax_arrays`` the
port's ``IvfIndex`` from those of an f32 ``IvfIndex``, and
``ivf_bf16_from_jax_arrays`` / ``ivf_sq8_from_jax_arrays`` the quantised
``IvfIndexBf16`` / ``IvfSq8Index``, as their ``save`` writes them to npz;
each class's ``load`` reads such a file through them.
``nndescent_from_jax_arrays`` builds the port's ``NNDescentIndex`` from the
state of a JAX ``NNDescentIndex`` (the sentinel-padded table, the kNN graph
and, once the JAX index has answered a query, its navigable graph and
routers). Both packages then query the same centroids and cells, or walk
the same graph from the same routers, so differences between their random
streams drop out of a comparison.

Nothing here imports the JAX package: the state arrives as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "ivf_pq_from_jax_arrays", "IVF_PQ_ARRAYS", "IVF_PQ_SCALARS",
    "ivf_opq_from_jax_arrays", "IVF_OPQ_ARRAYS",
    "ivf_from_jax_arrays", "IVF_ARRAYS", "IVF_SCALARS",
    "ivf_bf16_from_jax_arrays", "ivf_sq8_from_jax_arrays", "IVF_SQ8_ARRAYS",
    "nndescent_from_jax_arrays", "NNDESCENT_ARRAYS", "NNDESCENT_SCALARS",
]

IVF_ARRAYS = (
    "storage", "store_sqnorms", "centroids", "seg_centroids", "seg_offsets",
    "seg_counts", "original_ids", "cluster_ptr",
)
IVF_SCALARS = ("n", "dim", "nlist", "seg_size")
IVF_PQ_ARRAYS = IVF_ARRAYS + ("codebooks", "dec_scales")
IVF_PQ_SCALARS = IVF_SCALARS + ("m",)
IVF_OPQ_ARRAYS = IVF_PQ_ARRAYS + ("rotation",)
IVF_SQ8_ARRAYS = IVF_ARRAYS + ("scales",)

#: state of an NNDescentIndex; ``nav_graph`` and ``router_ids`` may be absent
NNDESCENT_ARRAYS = ("vectors", "sqnorms", "knn_ids", "knn_dists", "nav_graph", "router_ids")
NNDESCENT_SCALARS = ("n", "dim", "k_build", "out_deg")

#: device dtypes of the index arrays (``storage`` keeps its own: int8 or
#: float32, unless the caller casts it); the rest are float32
_DTYPES = {
    "seg_offsets": torch.int32, "seg_counts": torch.int32,
    "original_ids": torch.int64,
}


def _ivf_state(cls, arrays, meta, names, scalars, storage_dtype, device, dtypes=None):
    """An instance of ``cls`` (an IVF index) holding the given state;
    ``dtypes`` overrides the device dtype of named arrays."""
    from .utils.dist import parse_ann_dist

    missing = [a for a in names if arrays.get(a) is None]
    missing += [s for s in scalars if s not in meta]
    if missing:
        raise ValueError(f"{cls.__name__} state lacks {missing}")
    storage = np.asarray(arrays["storage"])
    if storage.dtype != storage_dtype:
        raise ValueError(
            f"storage must be {np.dtype(storage_dtype).name}, got {storage.dtype}"
        )
    dev = torch.device(device)
    obj = cls.__new__(cls)
    obj.device = dev
    obj.metric = parse_ann_dist(meta.get("metric", "euclidean"))
    for name in scalars:
        setattr(obj, name, int(meta[name]))
    for name in names:
        if name == "cluster_ptr":
            continue
        t = torch.tensor(np.asarray(arrays[name]))
        dtype = t.dtype if name == "storage" else _DTYPES.get(name, torch.float32)
        dtype = (dtypes or {}).get(name, dtype)
        setattr(obj, name, t.to(device=dev, dtype=dtype))
    obj._cluster_ptr = np.asarray(arrays["cluster_ptr"], dtype=np.int64)
    obj.vectors = None
    obj.sqnorms = None
    return obj


def ivf_from_jax_arrays(arrays: dict[str, np.ndarray], meta: dict, device="cuda"):
    """``IvfIndex`` from a JAX f32 index's state: ``arrays`` holds
    :data:`IVF_ARRAYS` (``storage`` float32), ``meta`` the scalars
    :data:`IVF_SCALARS` and optionally ``metric``."""
    from .models.ivf import IvfIndex

    return _ivf_state(IvfIndex, arrays, meta, IVF_ARRAYS, IVF_SCALARS, np.float32, device)


def _ivf_pq_state(cls, names, arrays, meta, device):
    """``cls`` (``IvfPqIndex`` or ``IvfOpqIndex``) from its state: int8
    storage needs ``dec_scales`` (mode ``i8dec_residual``); uint8 codes
    carry none (mode ``pq_residual``)."""
    dtype = np.asarray(arrays.get("storage", np.empty(0, np.int8))).dtype
    if dtype not in (np.int8, np.uint8):
        raise ValueError(
            f"storage must be int8 (with dec_scales) or uint8 codes, got {dtype}"
        )
    if dtype == np.uint8:
        names = tuple(a for a in names if a != "dec_scales")
        arrays = {a: v for a, v in arrays.items() if a != "dec_scales"}
    obj = _ivf_state(cls, arrays, meta, names, IVF_PQ_SCALARS, dtype, device)
    if "dec_scales" not in names:
        obj.dec_scales = None
    obj._restore()
    return obj


def ivf_pq_from_jax_arrays(
    arrays: dict[str, np.ndarray], meta: dict, device="cuda"
):
    """``IvfPqIndex`` from a JAX index's state: ``arrays`` holds
    :data:`IVF_PQ_ARRAYS` (``storage`` int8 with ``dec_scales``, or uint8
    codes without), ``meta`` the scalars :data:`IVF_PQ_SCALARS` and
    optionally ``metric``."""
    from .models.quantised.ivf import IvfPqIndex

    return _ivf_pq_state(IvfPqIndex, IVF_PQ_ARRAYS, arrays, meta, device)


def ivf_opq_from_jax_arrays(
    arrays: dict[str, np.ndarray], meta: dict, device="cuda"
):
    """``IvfOpqIndex`` from a JAX index's state: as
    :func:`ivf_pq_from_jax_arrays`, with the ``[d, d]`` ``rotation``."""
    from .models.quantised.ivf import IvfOpqIndex

    return _ivf_pq_state(IvfOpqIndex, IVF_OPQ_ARRAYS, arrays, meta, device)


def ivf_bf16_from_jax_arrays(arrays: dict[str, np.ndarray], meta: dict, device="cuda"):
    """``IvfIndexBf16`` from a JAX bf16 index's state: ``arrays`` holds
    :data:`IVF_ARRAYS` with ``storage`` as float32 (npz holds no bf16),
    cast back to bf16 here; ``meta`` the scalars :data:`IVF_SCALARS`."""
    from .models.quantised.ivf import IvfIndexBf16

    return _ivf_state(IvfIndexBf16, arrays, meta, IVF_ARRAYS, IVF_SCALARS,
                      np.float32, device, {"storage": torch.bfloat16})


def ivf_sq8_from_jax_arrays(arrays: dict[str, np.ndarray], meta: dict, device="cuda"):
    """``IvfSq8Index`` from a JAX SQ8 index's state: ``arrays`` holds
    :data:`IVF_SQ8_ARRAYS` (``storage`` int8, ``store_sqnorms`` the int32
    squared norms of the codes, ``scales``), ``meta`` the scalars
    :data:`IVF_SCALARS`. The quantiser is rebuilt from ``scales``."""
    from .models.quantised.ivf import IvfSq8Index
    from .models.quantised.quantisers import ScalarQuantiser

    obj = _ivf_state(IvfSq8Index, arrays, meta, IVF_SQ8_ARRAYS, IVF_SCALARS,
                     np.int8, device, {"store_sqnorms": torch.int32})
    obj.quantiser = ScalarQuantiser(obj.scales)
    return obj


def nndescent_from_jax_arrays(arrays: dict[str, np.ndarray], meta: dict, device="cuda"):
    """``NNDescentIndex`` from a JAX index's state: ``arrays`` holds
    ``vectors [n+1, dim]`` (sentinel row last), ``sqnorms [n+1]``,
    ``knn_ids`` / ``knn_dists [n, k_build]`` and optionally ``nav_graph
    [n+1, deg]`` and ``router_ids`` (both or neither: without them the
    navigable graph is built on the first query, from seed 42 as a loaded
    JAX index does); ``meta`` the scalars :data:`NNDESCENT_SCALARS` and
    optionally ``metric``."""
    from .models.graph import NNDescentIndex
    from .utils.dist import parse_ann_dist

    need = ("vectors", "sqnorms", "knn_ids", "knn_dists")
    missing = [a for a in need if arrays.get(a) is None]
    missing += [s for s in NNDESCENT_SCALARS if s not in meta]
    if (arrays.get("nav_graph") is None) != (arrays.get("router_ids") is None):
        missing.append("nav_graph and router_ids together")
    if missing:
        raise ValueError(f"NNDescentIndex state lacks {missing}")
    dev = torch.device(device)
    obj = NNDescentIndex.__new__(NNDescentIndex)
    obj.device = dev
    obj.metric = parse_ann_dist(meta.get("metric", "euclidean"))
    for name in NNDESCENT_SCALARS:
        setattr(obj, name, int(meta[name]))
    for name in NNDESCENT_ARRAYS:
        a = arrays.get(name)
        dtype = torch.float32 if name in ("vectors", "sqnorms", "knn_dists") else torch.int32
        setattr(obj, name, None if a is None
                else torch.tensor(np.asarray(a)).to(device=dev, dtype=dtype))
    if obj.vectors.shape != (obj.n + 1, obj.dim):
        raise ValueError(
            f"vectors must be [n+1, dim] = {(obj.n + 1, obj.dim)}, got "
            f"{tuple(obj.vectors.shape)}"
        )
    obj._seed = 42
    obj._reverse_extra = obj.out_deg // 2
    return obj
