"""Index state carried across from the JAX package.

``ivf_pq_from_jax_arrays`` builds the port's ``IvfPqIndex`` from the arrays
and scalars of an ``annsearch_tpu`` ``IvfPqIndex`` (in ``i8dec_residual``
mode), and ``ivf_from_jax_arrays`` the port's ``IvfIndex`` from those of an
f32 ``IvfIndex``, as their ``save`` writes them to npz; each class's
``load`` reads such a file through them. Both packages then query the same
centroids and cells, so differences between their random streams drop out
of a comparison.

Nothing here imports the JAX package: the state arrives as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "ivf_pq_from_jax_arrays", "IVF_PQ_ARRAYS", "IVF_PQ_SCALARS",
    "ivf_from_jax_arrays", "IVF_ARRAYS", "IVF_SCALARS",
]

IVF_ARRAYS = (
    "storage", "store_sqnorms", "centroids", "seg_centroids", "seg_offsets",
    "seg_counts", "original_ids", "cluster_ptr",
)
IVF_SCALARS = ("n", "dim", "nlist", "seg_size")
IVF_PQ_ARRAYS = IVF_ARRAYS + ("codebooks", "dec_scales")
IVF_PQ_SCALARS = IVF_SCALARS + ("m",)

#: device dtypes of the index arrays (``storage`` keeps its own: int8 or
#: float32); the rest are float32
_DTYPES = {
    "seg_offsets": torch.int32, "seg_counts": torch.int32,
    "original_ids": torch.int64,
}


def _ivf_state(cls, arrays, meta, names, scalars, storage_dtype, device):
    """An instance of ``cls`` (an IVF index) holding the given state."""
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


def ivf_pq_from_jax_arrays(
    arrays: dict[str, np.ndarray], meta: dict, device="cuda"
):
    """``IvfPqIndex`` from a JAX index's state: ``arrays`` holds
    :data:`IVF_PQ_ARRAYS` (``storage`` int8), ``meta`` the scalars
    :data:`IVF_PQ_SCALARS` and optionally ``metric``."""
    from .models.quantised.ivf import IvfPqIndex, _check_supported
    from .models.quantised.quantisers import ProductQuantiser

    if "m" in meta and "dim" in meta:
        _check_supported(meta.get("metric", "euclidean"), int(meta["m"]), int(meta["dim"]))
    obj = _ivf_state(
        IvfPqIndex, arrays, meta, IVF_PQ_ARRAYS, IVF_PQ_SCALARS, np.int8, device
    )
    obj.quantiser = ProductQuantiser(obj.codebooks, obj.m, obj.dim)
    return obj
