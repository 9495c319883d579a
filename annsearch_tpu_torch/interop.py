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
routers). ``annoy_from_jax_arrays``, ``kd_tree_from_jax_arrays`` and
``balltree_from_jax_arrays`` build the tree indexes from a JAX index's
rows and trees (sorted order, splitters, and for the ball tree the centres
and radii), ``lsh_from_jax_arrays`` the LSH index from its projections and
hash-sorted storage, ``kmknn_from_jax_arrays`` the kMkNN index from its
centroids, sorted storage and radii. ``hnsw_from_jax_arrays`` builds the
``HnswIndex`` from the arrays of a JAX HNSW npz (its layers may be padded),
``vamana_from_jax_arrays`` the ``VamanaIndex`` from its graph and medoid
(and, if given, the JAX index's router sample), and
``exhaustive_{bf16,sq8,pq,opq}_from_jax_arrays`` the flat quantised
indexes from their rows, codes, scales, codebooks and rotation.
``exhaustive_binary_from_jax_arrays`` and ``ivf_binary_from_jax_arrays``
build the binary indexes from their binariser (projections, mean, mode),
packed codes (the JAX package's uint32 words, held here as int32 bit
patterns) and IVF layout, ``exhaustive_rabitq_from_jax_arrays`` and
``ivf_rabitq_from_jax_arrays`` the RaBitQ indexes from their rotation,
codes, ``‖x − c‖`` and ``aux_corr``; each with its vector store (the
device rows, or an mmap store re-opened by its path).
``sharded_ivf_from_jax_arrays``, ``sharded_ivf_pq_from_jax_arrays`` and
``sharded_graph_from_jax_arrays`` build the sharded indexes of
``parallel/`` on a grid of logical shards from the global arrays of a JAX
sharded index (``np.asarray`` of its attributes: the JAX classes have no
``save``), each rank keeping its own shards. Both
packages then query the same centroids and cells, trees, tables or codes,
or walk the same graph from the same routers, so differences between their
random streams drop out of a comparison.

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
    "annoy_from_jax_arrays", "kd_tree_from_jax_arrays", "balltree_from_jax_arrays",
    "lsh_from_jax_arrays", "LSH_ARRAYS", "LSH_SCALARS",
    "kmknn_from_jax_arrays", "KMKNN_ARRAYS", "KMKNN_SCALARS",
    "hnsw_from_jax_arrays", "vamana_from_jax_arrays", "VAMANA_ARRAYS", "VAMANA_SCALARS",
    "exhaustive_bf16_from_jax_arrays", "exhaustive_sq8_from_jax_arrays",
    "exhaustive_pq_from_jax_arrays", "exhaustive_opq_from_jax_arrays",
    "exhaustive_binary_from_jax_arrays", "ivf_binary_from_jax_arrays",
    "exhaustive_rabitq_from_jax_arrays", "ivf_rabitq_from_jax_arrays",
    "IVF_BINARY_SCALARS", "RABITQ_ARRAYS",
    "sharded_ivf_from_jax_arrays", "sharded_ivf_pq_from_jax_arrays",
    "sharded_graph_from_jax_arrays", "SHARDED_IVF_ARRAYS", "SHARDED_IVF_SCALARS",
    "SHARDED_GRAPH_ARRAYS", "SHARDED_GRAPH_SCALARS",
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

#: state of an LSHIndex (its npz arrays) and its scalars
LSH_ARRAYS = ("vectors", "projections", "storage", "original_ids", "seg_offsets",
              "seg_counts", "cluster_ptr", "seg_cluster")
LSH_SCALARS = ("n", "dim", "num_tables", "bits", "seed", "seg_size")
#: state of a KmknnIndex (its npz arrays; ``vectors`` is the sorted storage
#: with its pad rows) and its scalars
KMKNN_ARRAYS = ("vectors", "centroids", "seg_offsets", "seg_counts", "original_ids",
                "radii", "cell_counts", "cluster_ptr", "seg_cluster")
KMKNN_SCALARS = ("n", "dim", "nlist", "seg_size")

#: state of a VamanaIndex (its npz arrays) and its scalars
VAMANA_ARRAYS = ("vectors", "sqnorms", "graph", "medoid_arr")
VAMANA_SCALARS = ("n", "dim", "r_degree")

#: the state of an IVF binary index past the IVF layout (the binariser's
#: ``bin_proj`` / ``bin_mean`` and the device store's ``store_vectors`` are
#: optional arrays; ``fast_scan`` and ``store_path`` default to True and "")
IVF_BINARY_SCALARS = IVF_SCALARS + ("n_bits",)
#: the arrays of a RaBitQ index (``store_vectors`` optional)
RABITQ_ARRAYS = IVF_ARRAYS + ("aux_corr", "rotation")

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
    if "seg_counts" in names:
        obj._seg_counts_host = np.asarray(arrays["seg_counts"], np.int64)
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


def _require(what, arrays, meta, names, scalars):
    missing = [a for a in names if arrays.get(a) is None]
    missing += [s for s in scalars if s not in meta]
    if missing:
        raise ValueError(f"{what} state lacks {missing}")


def _forest_state(cls, vectors, trees, leaf, metric, device):
    from .models.trees import _index_shell, _tree_from_arrays

    obj = _index_shell(cls, vectors, metric, device)
    obj.leaf = int(leaf)
    obj.trees = [_tree_from_arrays(t, obj.leaf, obj.device) for t in trees]
    return obj


def annoy_from_jax_arrays(vectors: np.ndarray, trees: list[dict], leaf: int,
                          metric="euclidean", device="cuda"):
    """``AnnoyIndex`` from a JAX forest: ``vectors [n, dim]`` as the JAX
    index stores them (normalised under cosine, no sentinel row), and per
    tree a dict of ``order [n_pad]``, ``normals`` and ``thresholds`` (lists
    over levels)."""
    from .models.trees import AnnoyIndex

    return _forest_state(AnnoyIndex, vectors, trees, leaf, metric, device)


def kd_tree_from_jax_arrays(vectors: np.ndarray, trees: list[dict], leaf: int,
                            metric="euclidean", device="cuda"):
    """``KdTreeIndex`` from a JAX kd-forest: as :func:`annoy_from_jax_arrays`."""
    from .models.trees import KdTreeIndex

    return _forest_state(KdTreeIndex, vectors, trees, leaf, metric, device)


def balltree_from_jax_arrays(vectors: np.ndarray, tree: dict, leaf: int,
                             metric="euclidean", device="cuda"):
    """``BallTreeIndex`` from a JAX ball tree: ``vectors`` as for
    :func:`annoy_from_jax_arrays`; ``tree`` holds ``order``, ``normals``,
    ``thresholds``, ``centers`` and ``radii`` (lists over levels, the leaves'
    last)."""
    from .models.trees import BallTreeIndex, _index_shell, _tree_from_arrays

    obj = _index_shell(BallTreeIndex, vectors, metric, device)
    obj.leaf = int(leaf)
    obj.tree = _tree_from_arrays(tree, obj.leaf, obj.device)
    return obj


def lsh_from_jax_arrays(arrays: dict[str, np.ndarray], meta: dict, device="cuda"):
    """``LSHIndex`` from a JAX index's state: ``arrays`` holds
    :data:`LSH_ARRAYS` (``storage`` the hash-sorted rows with their pad),
    ``meta`` the scalars :data:`LSH_SCALARS` and optionally ``metric``."""
    from .models.lsh import LSHIndex
    from .utils.dist import parse_ann_dist, sq_norms

    _require("LSHIndex", arrays, meta, LSH_ARRAYS, LSH_SCALARS)
    dev = torch.device(device)
    obj = LSHIndex.__new__(LSHIndex)
    obj.device = dev
    obj.metric = parse_ann_dist(meta.get("metric", "euclidean"))
    obj.n, obj.dim, obj.num_tables = int(meta["n"]), int(meta["dim"]), int(meta["num_tables"])
    obj.bits, obj._seed, obj.seg_size = int(meta["bits"]), int(meta["seed"]), int(meta["seg_size"])

    def f32(name):
        return torch.as_tensor(np.array(arrays[name], np.float32), device=dev)

    obj.vectors, obj.projections, obj.storage = f32("vectors"), f32("projections"), f32("storage")
    obj.sqnorms = sq_norms(obj.vectors)
    obj.store_sqnorms = sq_norms(obj.storage)
    obj.original_ids = torch.as_tensor(np.array(arrays["original_ids"], np.int64), device=dev)
    obj.seg_offsets = torch.as_tensor(np.array(arrays["seg_offsets"], np.int32), device=dev)
    obj.seg_counts = torch.as_tensor(np.array(arrays["seg_counts"], np.int32), device=dev)
    obj._cluster_ptr = np.asarray(arrays["cluster_ptr"], np.int64)
    obj._seg_cluster = np.asarray(arrays["seg_cluster"], np.int32)
    obj.last_fallback_rate = 0.0
    obj._derived = {}
    return obj


def kmknn_from_jax_arrays(arrays: dict[str, np.ndarray], meta: dict, device="cuda"):
    """``KmknnIndex`` from a JAX index's state: ``arrays`` holds
    :data:`KMKNN_ARRAYS`, ``meta`` the scalars :data:`KMKNN_SCALARS` and
    optionally ``metric``."""
    from .models.kmknn import KmknnIndex
    from .utils.dist import parse_ann_dist

    _require("KmknnIndex", arrays, meta, KMKNN_ARRAYS, KMKNN_SCALARS)
    dev = torch.device(device)
    obj = KmknnIndex.__new__(KmknnIndex)
    obj.device = dev
    obj.metric = parse_ann_dist(meta.get("metric", "euclidean"))
    obj.n, obj.dim, obj.nlist = int(meta["n"]), int(meta["dim"]), int(meta["nlist"])
    obj.centroids = torch.as_tensor(np.array(arrays["centroids"], np.float32), device=dev)
    x = torch.as_tensor(np.array(arrays["vectors"][: obj.n], np.float32), device=dev)
    obj._set_state(
        x, np.asarray(arrays["original_ids"], np.int64), arrays["seg_offsets"],
        arrays["seg_counts"], arrays["seg_cluster"], arrays["cluster_ptr"],
        int(meta["seg_size"]), np.asarray(arrays["radii"], np.float32), arrays["cell_counts"],
    )
    return obj


def _tensor(a, dtype, device):
    return torch.tensor(np.asarray(a)).to(device=device, dtype=dtype)


def hnsw_from_jax_arrays(arrays: dict[str, np.ndarray], device="cuda"):
    """``HnswIndex`` from the arrays of a JAX HNSW npz: ``vectors [n+1,
    dim]`` (sentinel row last), ``base_graph [n+1, deg]``, ``meta`` = ``[n,
    dim, m, n_layers, entry_global, cosine]`` and per upper layer ``l{i}_ids``
    and ``l{i}_graph`` in local id space. The JAX package pads a layer to a
    power of two with copies of its member 0; such layers are taken as they
    are."""
    from .models.hnsw import HnswIndex
    from .utils.dist import Dist, sq_norms

    _require("HnswIndex", arrays, {}, ("vectors", "base_graph", "meta"), ())
    dev = torch.device(device)
    meta = np.asarray(arrays["meta"]).astype(np.int64)
    obj = HnswIndex.__new__(HnswIndex)
    obj.device = dev
    obj.n, obj.dim, obj.m, obj.n_layers, obj.entry_global = (int(v) for v in meta[:5])
    obj.metric = Dist.COSINE if meta[5] == 1 else Dist.EUCLIDEAN
    obj.vectors = _tensor(arrays["vectors"], torch.float32, dev)
    if obj.vectors.shape != (obj.n + 1, obj.dim):
        raise ValueError(f"vectors must be [n+1, dim] = {(obj.n + 1, obj.dim)}, got "
                         f"{tuple(obj.vectors.shape)}")
    obj.sqnorms = sq_norms(obj.vectors)
    obj.base_graph = _tensor(arrays["base_graph"], torch.int32, dev)
    obj.layers = []
    i = 0
    while f"l{i}_ids" in arrays:
        gids = _tensor(arrays[f"l{i}_ids"], torch.int32, dev)
        graph = _tensor(arrays[f"l{i}_graph"], torch.int32, dev)
        lv_vecs = torch.cat([obj.vectors[gids.long()], torch.zeros((1, obj.dim), device=dev)])
        obj.layers.append((gids, graph, lv_vecs, sq_norms(lv_vecs)))
        i += 1
    obj.build_times = {}
    return obj


def vamana_from_jax_arrays(arrays: dict[str, np.ndarray], meta: dict, device="cuda",
                           router_ids: np.ndarray | None = None):
    """``VamanaIndex`` from a JAX index's state: ``arrays`` holds
    :data:`VAMANA_ARRAYS` (``vectors [n+1, dim]`` with the sentinel row,
    ``graph [n+1, deg]``, ``medoid_arr [1]``), ``meta`` the scalars
    :data:`VAMANA_SCALARS` and optionally ``metric``. ``router_ids`` (the
    JAX index's ``_router_ids``) replaces the port's own router draw."""
    from .models.vamana import VamanaIndex
    from .utils.dist import parse_ann_dist

    _require("VamanaIndex", arrays, meta, VAMANA_ARRAYS, VAMANA_SCALARS)
    dev = torch.device(device)
    obj = VamanaIndex.__new__(VamanaIndex)
    obj.device = dev
    obj.metric = parse_ann_dist(meta.get("metric", "euclidean"))
    for name in VAMANA_SCALARS:
        setattr(obj, name, int(meta[name]))
    obj.vectors = _tensor(arrays["vectors"], torch.float32, dev)
    obj.sqnorms = _tensor(arrays["sqnorms"], torch.float32, dev)
    obj.graph = _tensor(arrays["graph"], torch.int32, dev)
    obj.medoid_arr = _tensor(arrays["medoid_arr"], torch.int32, dev).reshape(1)
    if obj.vectors.shape != (obj.n + 1, obj.dim):
        raise ValueError(f"vectors must be [n+1, dim] = {(obj.n + 1, obj.dim)}, got "
                         f"{tuple(obj.vectors.shape)}")
    obj._router_ids = None if router_ids is None else _tensor(router_ids, torch.int32, dev)
    obj.build_times = {}
    return obj


def _flat_shell(cls, meta, scalars, device):
    from .utils.dist import parse_ann_dist

    obj = cls.__new__(cls)
    obj.device = torch.device(device)
    obj.metric = parse_ann_dist(meta.get("metric", "euclidean"))
    for name in scalars:
        setattr(obj, name, int(meta[name]))
    obj.vectors = obj.sqnorms = None
    return obj


def exhaustive_bf16_from_jax_arrays(arrays: dict[str, np.ndarray], meta: dict, device="cuda"):
    """``ExhaustiveIndexBf16`` from a JAX index's state: ``vectors [n, dim]``
    as float32 (npz holds no bf16; cast back to bf16 here) and ``sqnorms``;
    ``meta`` holds ``n``, ``dim`` and optionally ``metric``."""
    from .models.quantised.flat import ExhaustiveIndexBf16

    _require("ExhaustiveIndexBf16", arrays, meta, ("vectors", "sqnorms"), ("n", "dim"))
    obj = _flat_shell(ExhaustiveIndexBf16, meta, ("n", "dim"), device)
    obj.vectors = _tensor(arrays["vectors"], torch.bfloat16, obj.device)
    obj.sqnorms = _tensor(arrays["sqnorms"], torch.float32, obj.device)
    return obj


def exhaustive_sq8_from_jax_arrays(arrays: dict[str, np.ndarray], meta: dict, device="cuda"):
    """``ExhaustiveSq8Index`` from a JAX index's state: ``codes [n, dim]``
    int8, ``code_sqnorms [n]`` int32 and ``scales [dim]``; ``meta`` holds
    ``n``, ``dim`` and optionally ``metric``. The quantiser is rebuilt
    from ``scales``."""
    from .models.quantised.flat import ExhaustiveSq8Index
    from .models.quantised.quantisers import ScalarQuantiser

    _require("ExhaustiveSq8Index", arrays, meta, ("codes", "code_sqnorms", "scales"),
             ("n", "dim"))
    obj = _flat_shell(ExhaustiveSq8Index, meta, ("n", "dim"), device)
    obj.codes = _tensor(arrays["codes"], torch.int8, obj.device)
    obj.code_sqnorms = _tensor(arrays["code_sqnorms"], torch.int32, obj.device)
    obj.scales = _tensor(arrays["scales"], torch.float32, obj.device)
    obj.quantiser = ScalarQuantiser(obj.scales)
    return obj


def _pq_state(cls, arrays, meta, device, names):
    from .models.quantised.quantisers import ProductQuantiser

    _require(cls.__name__, arrays, meta, names, ("n", "dim", "m"))
    obj = _flat_shell(cls, meta, ("n", "dim", "m"), device)
    obj.codes = _tensor(arrays["codes"], torch.uint8, obj.device)
    obj.code_sqnorms = _tensor(arrays["code_sqnorms"], torch.float32, obj.device)
    obj.codebooks = _tensor(arrays["codebooks"], torch.float32, obj.device)
    obj.quantiser = ProductQuantiser(obj.codebooks, obj.m, obj.dim)
    return obj


def exhaustive_pq_from_jax_arrays(arrays: dict[str, np.ndarray], meta: dict, device="cuda"):
    """``ExhaustivePqIndex`` from a JAX index's state: ``codes [n, m]``
    uint8, ``code_sqnorms [n]`` and ``codebooks [m, 256, dim/m]``; ``meta``
    holds ``n``, ``dim``, ``m`` and optionally ``metric``."""
    from .models.quantised.flat import ExhaustivePqIndex

    return _pq_state(ExhaustivePqIndex, arrays, meta, device,
                     ("codes", "code_sqnorms", "codebooks"))


def exhaustive_opq_from_jax_arrays(arrays: dict[str, np.ndarray], meta: dict, device="cuda"):
    """``ExhaustiveOpqIndex`` from a JAX index's state: as
    :func:`exhaustive_pq_from_jax_arrays`, with the ``[dim, dim]``
    ``rotation``."""
    from .models.quantised.flat import ExhaustiveOpqIndex
    from .models.quantised.quantisers import OptimisedProductQuantiser

    obj = _pq_state(ExhaustiveOpqIndex, arrays, meta, device,
                    ("codes", "code_sqnorms", "codebooks", "rotation"))
    obj.rotation = _tensor(arrays["rotation"], torch.float32, obj.device)
    obj.opq = OptimisedProductQuantiser(obj.quantiser, obj.rotation)
    return obj


def _words(a) -> np.ndarray:
    """Packed code words as int32 bit patterns (the JAX package's uint32
    words viewed, or the port's int32 as they are)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        return a.view(np.int32)
    if a.dtype != np.int32:
        raise ValueError(f"packed codes must be uint32 or int32 words, got {a.dtype}")
    return a


def _binary_extras(obj, arrays, meta, device) -> None:
    """``fast_scan``, ``store_path`` and the vector store: the device rows
    where ``store_vectors`` is given, else the mmap store at ``store_path``,
    else none."""
    from .models.binary.vec_store import DeviceVectorStore, MmapVectorStore

    obj.fast_scan = bool(meta.get("fast_scan", True))
    obj.store_path = str(meta.get("store_path") or "")
    if arrays.get("store_vectors") is not None:
        obj.store = DeviceVectorStore(_tensor(arrays["store_vectors"], torch.float32, obj.device))
    elif obj.store_path:
        obj.store = MmapVectorStore.open(obj.store_path, obj.device)
    else:
        obj.store = None


def _binariser(arrays, meta, device):
    from .models.binary.binariser import Binariser

    return Binariser.from_state(meta["n_bits"], meta["bin_mode"], arrays.get("bin_proj"),
                                arrays.get("bin_mean"), device)


def exhaustive_binary_from_jax_arrays(arrays: dict[str, np.ndarray], meta: dict, device="cuda"):
    """``ExhaustiveIndexBinary`` from a JAX index's state: ``codes [n, w]``
    (uint32 words) and, where the mode and store have them, ``bin_proj [dim,
    n_bits]``, ``bin_mean [dim]`` and ``store_vectors [n, dim]``; ``meta``
    holds ``n``, ``dim``, ``n_bits``, ``bin_mode`` and
    optionally ``metric``, ``fast_scan`` and ``store_path``."""
    from .models.binary.flat import ExhaustiveIndexBinary

    _require("ExhaustiveIndexBinary", arrays, meta, ("codes",),
             ("n", "dim", "n_bits", "bin_mode"))
    obj = _flat_shell(ExhaustiveIndexBinary, meta, ("n", "dim", "n_bits"), device)
    obj.bin_mode = str(meta["bin_mode"])
    obj.codes = torch.tensor(_words(arrays["codes"]), device=obj.device)
    obj.binariser = _binariser(arrays, meta, obj.device)
    _binary_extras(obj, arrays, meta, device)
    obj._aliases()
    return obj


def _ivf_words_state(cls, arrays, meta, names, scalars, device):
    arrays = dict(arrays)
    if arrays.get("storage") is not None:
        arrays["storage"] = _words(arrays["storage"])
    obj = _ivf_state(cls, arrays, meta, names, scalars, np.int32, device)
    _binary_extras(obj, arrays, meta, device)
    return obj


def ivf_binary_from_jax_arrays(arrays: dict[str, np.ndarray], meta: dict, device="cuda"):
    """``IvfIndexBinary`` from a JAX index's state: ``arrays`` holds
    :data:`IVF_ARRAYS` (``storage`` the uint32 code words) and, where
    present, ``bin_proj``, ``bin_mean`` and ``store_vectors``; ``meta`` the
    scalars
    :data:`IVF_BINARY_SCALARS`, ``bin_mode`` and optionally ``metric``,
    ``fast_scan`` and ``store_path``."""
    from .models.binary.ivf import IvfIndexBinary

    _require("IvfIndexBinary", arrays, meta, (), ("bin_mode",))
    obj = _ivf_words_state(IvfIndexBinary, arrays, meta, IVF_ARRAYS, IVF_BINARY_SCALARS,
                           device)
    obj.bin_mode = str(meta["bin_mode"])
    obj.binariser = _binariser(arrays, meta, obj.device)
    obj._aliases()
    return obj


def _rabitq_state(cls, arrays, meta, device):
    from .models.binary.rabitq import RaBitQEncoder
    from .models.binary.vec_store import DeviceVectorStore

    obj = _ivf_words_state(cls, arrays, meta, RABITQ_ARRAYS, IVF_SCALARS, device)
    obj.encoder = RaBitQEncoder(obj.rotation, obj.dim)
    obj.store_vectors = (
        obj.store.vectors if isinstance(obj.store, DeviceVectorStore) else None
    )
    return obj


def exhaustive_rabitq_from_jax_arrays(arrays: dict[str, np.ndarray], meta: dict, device="cuda"):
    """``ExhaustiveIndexRaBitQ`` from a JAX index's state: ``arrays`` holds
    :data:`RABITQ_ARRAYS` (``storage`` the uint32 sign words,
    ``store_sqnorms`` ``‖x − c‖``, ``aux_corr`` ``‖R·u‖₁``, ``rotation [dim,
    dim]``) and optionally ``store_vectors``; ``meta`` the scalars
    :data:`IVF_SCALARS` and optionally ``metric``, ``fast_scan`` and
    ``store_path``."""
    from .models.binary.rabitq import ExhaustiveIndexRaBitQ

    return _rabitq_state(ExhaustiveIndexRaBitQ, arrays, meta, device)


def ivf_rabitq_from_jax_arrays(arrays: dict[str, np.ndarray], meta: dict, device="cuda"):
    """``IvfIndexRaBitQ`` from a JAX index's state: as
    :func:`exhaustive_rabitq_from_jax_arrays`."""
    from .models.binary.rabitq import IvfIndexRaBitQ

    return _rabitq_state(IvfIndexRaBitQ, arrays, meta, device)


#: state of a ShardedIvfIndex: ``np.asarray`` of the JAX index's attributes
#: (the per-shard arrays with their leading shard axis)
SHARDED_IVF_ARRAYS = ("centroids", "storage", "store_sqnorms", "offsets", "counts",
                      "original_ids")
SHARDED_IVF_SCALARS = ("n", "dim", "nlist", "cell_cap")
#: state of a ShardedGraphIndex (``vectors`` and the graphs row-sharded:
#: ``[P·m, ...]``)
SHARDED_GRAPH_ARRAYS = ("vectors", "knn_ids_local", "knn_dists", "nav_local")
SHARDED_GRAPH_SCALARS = ("n", "dim", "k_build", "out_deg", "seed")


def _local_shards(a, mesh, dtype=None):
    """This rank's shards of a global ``[P, ...]`` array, on the mesh's card
    (in ``dtype``, or the array's own)."""
    t = torch.tensor(np.asarray(a))
    t = t if dtype is None else t.to(dtype)
    lo = mesh.rank * mesh.n_local
    return t[lo : lo + mesh.n_local].to(mesh.device).contiguous()


def _sharded_ivf_state(cls, arrays, meta, mesh, mode: str):
    from .utils.dist import parse_ann_dist

    _require(cls.__name__, arrays, meta, SHARDED_IVF_ARRAYS, SHARDED_IVF_SCALARS)
    p = mesh.n_shards
    storage = np.asarray(arrays["storage"])
    if storage.shape[0] != p:
        raise ValueError(f"the state holds {storage.shape[0]} shards, the mesh {p}")
    obj = cls.__new__(cls)
    obj.mesh = mesh
    obj.metric = parse_ann_dist(meta.get("metric", "euclidean"))
    for name in SHARDED_IVF_SCALARS:
        setattr(obj, name, int(meta[name]))
    obj.mode = mode
    obj.centroids = _tensor(arrays["centroids"], torch.float32, mesh.device)
    obj.storage = _local_shards(storage, mesh)
    obj.store_sqnorms = _local_shards(arrays["store_sqnorms"], mesh, torch.float32)
    for name in ("offsets", "counts", "original_ids"):
        setattr(obj, name, _local_shards(arrays[name], mesh, torch.int32))
    obj.shard_rows = int(obj.original_ids.shape[1])
    obj._shard_valid = [min(max(obj.n - s * obj.shard_rows, 0), obj.shard_rows)
                        for s in range(p)]
    return obj


def sharded_ivf_from_jax_arrays(arrays: dict[str, np.ndarray], meta: dict, mesh):
    """``parallel.ShardedIvfIndex`` on ``mesh`` (P equal to the JAX
    index's shard count) from :data:`SHARDED_IVF_ARRAYS` (``storage`` f32)
    and :data:`SHARDED_IVF_SCALARS` (plus ``metric``)."""
    from .parallel import ShardedIvfIndex

    return _sharded_ivf_state(ShardedIvfIndex, arrays, meta, mesh, "f32")


def sharded_ivf_pq_from_jax_arrays(arrays: dict[str, np.ndarray], meta: dict, mesh):
    """``parallel.ShardedIvfPqIndex`` on ``mesh`` from a JAX index's state:
    :data:`SHARDED_IVF_ARRAYS` plus ``codebooks`` (its ``pq.codebooks``)
    and, in mode ``i8dec_residual`` (int8 ``storage``), ``dec_scales``;
    ``meta`` adds ``mode``."""
    from .models.quantised.quantisers import ProductQuantiser
    from .parallel import ShardedIvfPqIndex

    mode = meta["mode"]
    if mode not in ("i8dec_residual", "pq_residual"):
        raise ValueError(f"unknown ShardedIvfPqIndex mode {mode!r}")
    obj = _sharded_ivf_state(ShardedIvfPqIndex, arrays, meta, mesh, mode)
    books = _tensor(arrays["codebooks"], torch.float32, mesh.device)
    obj._m = int(books.shape[0])
    obj.pq = ProductQuantiser(books, obj._m, obj.dim)
    obj.dec_scales = None
    if mode == "i8dec_residual":
        obj.dec_scales = _tensor(arrays["dec_scales"], torch.float32, mesh.device)
    return obj


def sharded_graph_from_jax_arrays(arrays: dict[str, np.ndarray], meta: dict, mesh):
    """``parallel.ShardedGraphIndex`` on ``mesh`` from the JAX index's
    :data:`SHARDED_GRAPH_ARRAYS` (row-sharded ``[P·m, ...]``) and
    :data:`SHARDED_GRAPH_SCALARS` (``seed`` is its ``_seed``, which draws
    the routers; plus ``metric``)."""
    from .parallel import ShardedGraphIndex
    from .utils.dist import parse_ann_dist

    _require("ShardedGraphIndex", arrays, meta, SHARDED_GRAPH_ARRAYS, SHARDED_GRAPH_SCALARS)
    p = mesh.n_shards
    vectors = np.asarray(arrays["vectors"], dtype=np.float32)
    if vectors.shape[0] % p:
        raise ValueError(f"{vectors.shape[0]} rows do not split into {p} shards")
    m = vectors.shape[0] // p
    obj = ShardedGraphIndex.__new__(ShardedGraphIndex)
    obj.mesh = mesh
    obj.metric = parse_ann_dist(meta.get("metric", "euclidean"))
    obj.n, obj.dim = int(meta["n"]), int(meta["dim"])
    obj.k_build, obj.out_deg = int(meta["k_build"]), int(meta["out_deg"])
    obj._seed = int(meta["seed"])
    obj._router_idx = None
    obj.n_pad, obj.shard_rows = vectors.shape[0], m

    def shards(name, dtype):
        a = np.asarray(arrays[name])
        return _local_shards(a.reshape((p, m) + a.shape[1:]), mesh, dtype)

    obj.vectors = shards("vectors", torch.float32)
    obj.knn_ids_local = shards("knn_ids_local", torch.int32)
    obj.knn_dists = shards("knn_dists", torch.float32)
    obj.nav_local = shards("nav_local", torch.int32)
    return obj
