"""Index state carried across from the JAX package.

``ivf_pq_from_jax_arrays`` builds the port's ``IvfPqIndex`` from the arrays
and scalars of an ``annsearch_tpu`` ``IvfPqIndex`` (in ``i8dec_residual``
mode), as its ``save`` writes them to npz; ``IvfPqIndex.load`` reads such a
file through it. Both packages then query the same centroids and codes, so
differences between their random streams drop out of a comparison.

Nothing here imports the JAX package: the state arrives as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["ivf_pq_from_jax_arrays", "IVF_PQ_ARRAYS", "IVF_PQ_SCALARS"]

IVF_PQ_ARRAYS = (
    "storage", "store_sqnorms", "centroids", "seg_centroids", "seg_offsets",
    "seg_counts", "original_ids", "cluster_ptr", "codebooks", "dec_scales",
)
IVF_PQ_SCALARS = ("n", "dim", "nlist", "seg_size", "m")


def ivf_pq_from_jax_arrays(
    arrays: dict[str, np.ndarray], meta: dict, device="cuda"
):
    """``IvfPqIndex`` from a JAX index's state: ``arrays`` holds
    :data:`IVF_PQ_ARRAYS` (``storage`` int8), ``meta`` the scalars
    :data:`IVF_PQ_SCALARS` and optionally ``metric``."""
    from .models.quantised.ivf import IvfPqIndex, _check_supported
    from .utils.dist import parse_ann_dist

    missing = [a for a in IVF_PQ_ARRAYS if arrays.get(a) is None]
    missing += [s for s in IVF_PQ_SCALARS if s not in meta]
    if missing:
        raise ValueError(f"IVF-PQ state lacks {missing}")
    metric = meta.get("metric", "euclidean")
    _check_supported(metric, int(meta["m"]), int(meta["dim"]))
    storage = np.asarray(arrays["storage"])
    if storage.dtype != np.int8:
        raise ValueError(f"storage must be int8 (i8dec_residual), got {storage.dtype}")

    dev = torch.device(device)
    obj = IvfPqIndex.__new__(IvfPqIndex)
    obj.device = dev
    obj.metric = parse_ann_dist(metric)
    for name in IVF_PQ_SCALARS:
        setattr(obj, name, int(meta[name]))
    dtypes = {
        "seg_offsets": torch.int32, "seg_counts": torch.int32,
        "original_ids": torch.int64, "storage": torch.int8,
    }
    for name in IVF_PQ_ARRAYS:
        if name == "cluster_ptr":
            continue
        t = torch.tensor(np.asarray(arrays[name]))
        setattr(obj, name, t.to(device=dev, dtype=dtypes.get(name, torch.float32)))
    obj._cluster_ptr = np.asarray(arrays["cluster_ptr"], dtype=np.int64)
    obj.vectors = None
    obj.sqnorms = None
    from .models.quantised.quantisers import ProductQuantiser

    obj.quantiser = ProductQuantiser(obj.codebooks, obj.m, obj.dim)
    return obj
