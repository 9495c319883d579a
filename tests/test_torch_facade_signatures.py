"""The port's facade against the JAX package's: every row both ``__all__``
lists share takes the JAX row's parameters, in its order and with its
defaults (``verbose`` included), and whatever the port adds is
keyword-only, so that a positional call means the same in both packages.
The 15 tree, LSH and kMkNN rows, the 18 HNSW, Vamana and flat
quantised rows and the 12 binary and RaBitQ rows are present (the port's
``__all__`` is the JAX package's, in its order), every build row defaults
to the card,
``_query``'s progress report is the reference's, and every
``NotImplementedError`` of the port names a ROADMAP tag.

F12: every public class of the JAX package (each module's ``__all__``,
``parallel`` included) has its methods in the port, whose positional
parameters lead with the JAX method's, by name and position
(``NNDescentIndex.query``'s seventh is ``seed``); ``train_centroids`` and
``route_to_cells`` take the JAX parameters; the functions that take a
``torch.Generator`` for the JAX ``key`` (P5) are listed.

F14: every public function of the JAX package (each module's ``__all__``,
bar ROADMAP's "Not to port") takes the JAX positional parameters first,
by name and position, and ``chunked_topk``, ``blocked_query_topk``,
``ivf_cluster_scan`` and ``expand_probes_to_segments`` called with the
JAX positional tuple give the JAX results."""

import importlib
import inspect
import pkgutil
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import annsearch_tpu as ja
import annsearch_tpu_torch as ta
from annsearch_tpu import lib as jlib
from annsearch_tpu_torch import lib as tlib

SHARED = sorted(set(jlib.__all__) & set(tlib.__all__))
ROWS_P4 = [
    "build_kmknn_index", "query_kmknn_index", "query_kmknn_self",
    "build_annoy_index", "query_annoy_index", "query_annoy_self",
    "build_balltree_index", "query_balltree_index", "query_balltree_self",
    "build_kd_tree_index", "query_kd_tree_index", "query_kd_tree_self",
    "build_lsh_index", "query_lsh_index", "query_lsh_self",
]
ROWS_P1_P2 = [
    "build_hnsw_index", "query_hnsw_index", "query_hnsw_self",
    "build_vamana_index", "query_vamana_index", "query_vamana_self",
] + [f"{verb}_exhaustive_{kind}_{tail}" for kind in ("bf16", "sq8") for verb, tail in
     (("build", "index"), ("query", "index"), ("query", "self"))] + [
    f"{verb}_exhaustive_{kind}_{tail}" for kind in ("pq", "opq") for verb, tail in
    (("build", "index"), ("query", "index"), ("query", "index_self"))]
_POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY, inspect.Parameter.POSITIONAL_OR_KEYWORD)


def _positional(fn):
    return [(p.name, p.default) for p in inspect.signature(fn).parameters.values()
            if p.kind in _POSITIONAL]


def test_the_port_has_the_tree_lsh_and_kmknn_rows():
    assert set(ROWS_P4) <= set(tlib.__all__) and set(ROWS_P4) <= set(ja.__all__)
    assert set(ROWS_P4) <= set(ta.__all__)
    assert len(SHARED) >= 46


def test_the_port_has_the_hnsw_vamana_and_flat_quantised_rows():
    assert len(ROWS_P1_P2) == 18 and set(ROWS_P1_P2) <= set(jlib.__all__)
    assert set(ROWS_P1_P2) <= set(tlib.__all__) and set(ROWS_P1_P2) <= set(ta.__all__)
    assert len(SHARED) >= 64


ROWS_P3 = [f"{verb}_{kind}_index_{fam}{tail}" for fam in ("binary", "rabitq")
           for kind in ("exhaustive", "ivf")
           for verb, tail in (("build", ""), ("query", ""), ("query", "_self"))]


def test_the_facade_is_the_jax_packages():
    """All 76 rows, the 12 binary and RaBitQ rows among them, in the JAX
    package's order."""
    assert len(ROWS_P3) == 12 and set(ROWS_P3) <= set(jlib.__all__)
    assert tlib.__all__ == jlib.__all__ and len(tlib.__all__) == 76
    assert set(ROWS_P3) <= set(ta.__all__)


@pytest.mark.parametrize("name", [n for n in tlib.__all__ if n.startswith("build_")])
def test_every_build_row_defaults_to_the_card(name):
    params = inspect.signature(getattr(tlib, name)).parameters
    assert params["device"].default == "cuda"
    assert params["device"].kind == inspect.Parameter.KEYWORD_ONLY


@pytest.mark.parametrize("name", SHARED)
def test_shared_rows_take_the_jax_leading_parameters(name):
    """The port's positional parameters are the JAX row's (names and
    defaults, in order); any other parameter of the port is keyword-only
    (or ``**kw``, where the JAX row has one too)."""
    jfn, tfn = getattr(jlib, name), getattr(tlib, name)
    assert _positional(tfn) == _positional(jfn), name
    jparams = inspect.signature(jfn).parameters
    for p in inspect.signature(tfn).parameters.values():
        if p.kind == inspect.Parameter.VAR_KEYWORD:
            assert any(q.kind == inspect.Parameter.VAR_KEYWORD for q in jparams.values())
        elif p.kind not in _POSITIONAL:
            assert p.kind == inspect.Parameter.KEYWORD_ONLY and p.name not in jparams


@pytest.mark.parametrize("name", [n for n in SHARED if n.startswith("query_")])
def test_every_query_row_takes_verbose(name):
    params = inspect.signature(getattr(tlib, name)).parameters
    assert "verbose" in params and params["verbose"].default is False


def test_a_sixth_positional_argument_is_verbose_not_a_tier():
    """``query_ivf_pq_index(q, ix, k, nprobe, return_dist, True)`` asks for
    progress output; it does not switch on the approximate tier."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((600, 32)).astype(np.float32)
    ix = ta.build_ivf_pq_index(x, nlist=4, m=8, seed=0, device="cpu")
    q = x[:5]
    pos = ta.query_ivf_pq_index(q, ix, 3, 2, True, True)
    kw = ta.query_ivf_pq_index(q, ix, 3, nprobe=2, return_dist=True)
    assert torch.equal(pos[0], kw[0]) and torch.equal(pos[1], kw[1])
    with pytest.raises(TypeError):
        ta.query_ivf_pq_index(q, ix, 3, 2, True, False, True)   # approx is keyword-only


def test_verbose_queries_report_progress_in_chunks_of_100k(capsys):
    class Echo:
        def query(self, qm, k):
            n = qm.shape[0]
            return torch.arange(n)[:, None].repeat(1, k), torch.zeros((n, k))

    q = torch.zeros((250_000, 1))
    ids, d = tlib._query(Echo(), q, True, 2)
    out = capsys.readouterr().out.splitlines()
    assert out == ["  Processed 100_000 / 250_000 samples.",
                   "  Processed 200_000 / 250_000 samples.",
                   "  Processed 250_000 / 250_000 samples."]
    assert ids.shape == (250_000, 2) and int(ids[-1, 0]) == 49_999
    tlib._query(Echo(), q[:10], True, 2)
    assert capsys.readouterr().out == ""


def test_not_implemented_errors_name_roadmap_tags():
    """F2: each ``NotImplementedError`` of the port names a stable ROADMAP
    tag (P…, K1-…), not a position in a list. The walk must have read the
    package's sources (its facade and the graph build among them)."""
    pkg = Path(tlib.__file__).resolve().parent
    read = set()
    for path in pkg.rglob("*.py"):
        src = path.read_text()
        read.add(path.relative_to(pkg).as_posix())
        for m in re.finditer(r"raise NotImplementedError\((.*?)\n\s*\)", src, re.S):
            assert re.search(r"ROADMAP (P\d|K1-)", m.group(1)), f"{path}: {m.group(1)}"
        assert not re.search(r"item \d", src), path
    assert {"lib.py", "models/graph.py", "ops/graph.py", "models/hnsw.py"} <= read
    assert len(read) >= 30


# -- F12: the public classes and the functions that F12 names --------------------

def _jax_public_classes():
    """Every class of a JAX module's ``__all__`` (keyed by its defining
    module), outside the Pallas kernel modules."""
    out = {}
    for info in pkgutil.walk_packages(ja.__path__, "annsearch_tpu."):
        if info.name.endswith("_pallas"):
            continue
        mod = importlib.import_module(info.name)
        for name in getattr(mod, "__all__", ()):
            obj = getattr(mod, name, None)
            if inspect.isclass(obj) and obj.__module__.startswith("annsearch_tpu."):
                out[f"{obj.__module__}.{name}"] = obj
    return out


JAX_CLASSES = _jax_public_classes()


def _methods(cls):
    return {n: f for n, f in inspect.getmembers(cls, callable)
            if (not n.startswith("_") or n == "__init__") and not inspect.isclass(f)}


def test_the_class_walk_covers_the_indexes():
    names = {k.rsplit(".", 1)[1] for k in JAX_CLASSES}
    assert {"NNDescentIndex", "ExhaustiveIndex", "IvfIndex", "ShardedIvfIndex",
            "ShardedGraphIndex", "Binariser", "MmapVectorStore", "BaseIndex"} <= names
    assert len(JAX_CLASSES) >= 40


@pytest.mark.parametrize("qualname", sorted(JAX_CLASSES))
def test_public_class_methods_take_the_jax_positional_parameters(qualname):
    """Each public method of the JAX class exists in the port's, and the
    JAX method's positional parameters lead the port's, by name and
    position; the port may add parameters after them (``device``,
    ``fold_depth``, a ``chunk``)."""
    import importlib

    jcls = JAX_CLASSES[qualname]
    module, name = qualname.rsplit(".", 1)
    tcls = getattr(importlib.import_module(module.replace("annsearch_tpu", "annsearch_tpu_torch", 1)),
                   name)
    tmethods = _methods(tcls)
    for mname, jfn in _methods(jcls).items():
        assert mname in tmethods, f"{qualname}.{mname} is missing"
        jpos = [p for p, _ in _positional(jfn)]
        tpos = [p for p, _ in _positional(tmethods[mname])]
        assert tpos[: len(jpos)] == jpos, f"{qualname}.{mname}: {tpos} against {jpos}"


def test_a_seventh_positional_argument_of_the_graph_query_is_seed():
    from annsearch_tpu_torch.models.graph import NNDescentIndex

    params = list(inspect.signature(NNDescentIndex.query).parameters)
    assert params[7] == "seed" and params[8:10] == ["query_block", "exact_fallback"]


#: functions whose JAX ``key`` is a ``torch.Generator`` in the port (P5):
#: their draws are apart from the arithmetic, and tests hand them the JAX draws
KEY_AS_GENERATOR = {
    "annsearch_tpu.models.graph.approx_knn_graph", "annsearch_tpu.ops.graph.random_init_graph",
    "annsearch_tpu.ops.graph.rp_forest_round", "annsearch_tpu.ops.graph.nnd_round",
    "annsearch_tpu.ops.graph.diversify_graph", "annsearch_tpu.ops.graph.add_reverse_edges",
    "annsearch_tpu.ops.tree.build_partition_forest",
}


def test_the_f12_functions_take_the_jax_parameters():
    """``train_centroids`` takes ``sample`` and ``chunk`` (honoured),
    ``route_to_cells`` ``precision`` (accepted and ignored: f32 grade)."""
    from annsearch_tpu.models import ivf_base as jivf, kmeans as jk
    from annsearch_tpu_torch.models import ivf_base as tivf, kmeans as tk

    jp, tp = _positional(jk.train_centroids), _positional(tk.train_centroids)
    assert [n for n, _ in tp] == [n for n, _ in jp]
    assert tp[-2:] == jp[-2:] == [("sample", True), ("chunk", 65536)]
    assert [n for n, _ in _positional(tivf.route_to_cells)] == [
        n for n, _ in _positional(jivf.route_to_cells)]
    for qual in KEY_AS_GENERATOR:
        module, name = qual.rsplit(".", 1)
        j = inspect.signature(getattr(importlib.import_module(module), name)).parameters
        t = inspect.signature(getattr(importlib.import_module(module.replace(
            "annsearch_tpu", "annsearch_tpu_torch", 1)), name)).parameters
        assert list(j)[0] == "key" and list(t)[0] == "gen", qual


def test_train_centroids_honours_sample_and_chunk():
    from annsearch_tpu_torch.models.kmeans import train_centroids

    x = torch.as_tensor(np.random.default_rng(0).standard_normal((3000, 8)).astype(np.float32))
    a = train_centroids(x, 4, seed=1, max_iters=5)
    b = train_centroids(x, 4, seed=1, max_iters=5, chunk=257)
    assert torch.equal(a, b)                      # the chunking changes no result
    c = train_centroids(x, 4, seed=1, max_iters=5, sample=False)
    assert c.shape == (4, 8) and torch.isfinite(c).all()


# -- F14: the public functions -------------------------------------------------

#: JAX public functions with no counterpart (ROADMAP, "Not to port": the TPU
#: walk's and rerank's layouts)
NOT_TO_PORT = {
    "annsearch_tpu.ops.graph.nav_hl_split", "annsearch_tpu.ops.graph.pack_neighbor_table",
    "annsearch_tpu.ops.graph.neighbor_pack_bytes", "annsearch_tpu.ops.rerank.rerank_exact_split",
}


def _jax_public_functions():
    """Every function of a JAX module's ``__all__`` (jitted ones included),
    keyed by its defining module, outside the Pallas kernel modules."""
    out = {}
    for info in pkgutil.walk_packages(ja.__path__, "annsearch_tpu."):
        if info.name.endswith("_pallas"):
            continue
        mod = importlib.import_module(info.name)
        for name in getattr(mod, "__all__", ()):
            obj = getattr(mod, name, None)
            if inspect.isclass(obj) or not (inspect.isfunction(obj) or hasattr(obj, "__wrapped__")):
                continue
            qual = f"{obj.__module__}.{name}"
            if obj.__module__.startswith("annsearch_tpu.") and qual not in NOT_TO_PORT:
                out[qual] = obj
    return out


JAX_FUNCTIONS = _jax_public_functions()


def test_the_function_walk_covers_the_f14_functions():
    assert {"annsearch_tpu.ops.topk.chunked_topk", "annsearch_tpu.ops.topk.blocked_query_topk",
            "annsearch_tpu.ops.ivf_scan.ivf_cluster_scan",
            "annsearch_tpu.models.kmeans.expand_probes_to_segments",
            "annsearch_tpu.lib.build_ivf_index"} <= set(JAX_FUNCTIONS)
    assert KEY_AS_GENERATOR <= set(JAX_FUNCTIONS)
    assert len(JAX_FUNCTIONS) >= 150


@pytest.mark.parametrize("qualname", sorted(JAX_FUNCTIONS))
def test_public_functions_take_the_jax_positional_parameters(qualname):
    """The JAX function's positional parameters lead the port's, by name
    and position (after ``key`` / ``gen`` for the P5 draws); the port may
    add parameters after them."""
    module, name = qualname.rsplit(".", 1)
    tfn = getattr(importlib.import_module(module.replace("annsearch_tpu", "annsearch_tpu_torch", 1)),
                  name)
    jpos = [p for p, _ in _positional(JAX_FUNCTIONS[qualname])]
    tpos = [p for p, _ in _positional(tfn)]
    if qualname in KEY_AS_GENERATOR:
        assert (jpos[0], tpos[0]) == ("key", "gen")
        jpos, tpos = jpos[1:], tpos[1:]
    assert tpos[: len(jpos)] == jpos, f"{qualname}: {tpos} against {jpos}"


def _f14_data(n=700, d=16, nq=20, seed=14):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, d)) * 0.5).astype(np.float32)
    q = (rng.standard_normal((nq, d)) * 0.5).astype(np.float32)
    return x, q


@pytest.mark.parametrize("fn", ["chunked_topk", "blocked_query_topk"])
def test_the_topk_functions_take_the_jax_positional_tuple(fn):
    """F14: a call written for the JAX signature (``approx`` the ninth of
    ``chunked_topk``, the tenth of ``blocked_query_topk``, then
    ``selector``) gives the JAX result; ``approx`` is accepted and ignored
    (the JAX package's ``approx_min_k`` is exact off the TPU too)."""
    import jax
    import jax.numpy as jnp

    from annsearch_tpu.ops import topk as jtopk
    from annsearch_tpu.utils.dist import Dist as JDist
    from annsearch_tpu_torch.ops import topk as ttopk
    from annsearch_tpu_torch.utils.dist import Dist

    x, q = _f14_data()
    n_valid = 650
    if fn == "chunked_topk":
        wd, wi = jtopk.chunked_topk(jnp.asarray(q), jnp.asarray(x), 7, JDist.EUCLIDEAN, None,
                                    n_valid, 256, jax.lax.Precision.HIGHEST, True)
        gd, gi = ttopk.chunked_topk(torch.as_tensor(q), torch.as_tensor(x), 7, Dist.EUCLIDEAN,
                                    None, n_valid, 256, "highest", True)
    else:
        wd, wi = jtopk.blocked_query_topk(jnp.asarray(q), jnp.asarray(x), 7, JDist.EUCLIDEAN,
                                          None, n_valid, 8, 256, jax.lax.Precision.HIGHEST,
                                          True, "exact")
        gd, gi = ttopk.blocked_query_topk(torch.as_tensor(q), torch.as_tensor(x), 7,
                                          Dist.EUCLIDEAN, None, n_valid, 8, 256, "highest",
                                          True, "exact")
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-5, atol=1e-5)
    assert int(gi.max()) < n_valid


def test_the_cluster_scan_takes_the_jax_positional_tuple():
    """F14: ``ivf_cluster_scan`` called with the JAX positional tail
    ``codebooks, k_cell, aux, approx, precision, s_rows`` gives the JAX
    result; ``step_bytes`` is keyword-only."""
    import jax.numpy as jnp

    from annsearch_tpu.models.ivf import IvfIndex as JIvf
    from annsearch_tpu.models.kmeans import SegmentLayout as JLayout
    from annsearch_tpu.models.kmeans import expand_probes_to_segments as j_expand
    from annsearch_tpu.ops.ivf_scan import build_probe_lists_from_pairs as j_lists
    from annsearch_tpu.ops.ivf_scan import ivf_cluster_scan as j_scan
    from annsearch_tpu.utils.dist import Dist as JDist
    from annsearch_tpu_torch.ops.ivf_scan import ivf_cluster_scan as t_scan
    from annsearch_tpu_torch.utils.dist import Dist

    x, q = _f14_data()
    j = JIvf(x, "euclidean", nlist=4, seg_size=200)
    probes = np.argsort(((q[:, None, :] - np.asarray(j.centroids)[None]) ** 2).sum(-1), 1)[:, :2]
    layout = JLayout(None, np.asarray(j.seg_offsets), np.asarray(j.seg_counts), None,
                     j._cluster_ptr, j.seg_size, None)
    lists = j_lists(*j_expand(probes, layout), len(np.asarray(j.seg_offsets)), len(q))
    common = (np.asarray(j.storage), np.asarray(j.store_sqnorms), np.asarray(j.seg_offsets),
              np.asarray(j.seg_counts), np.asarray(j._scan_seg_centroids()))
    wd, wi = j_scan(jnp.asarray(q), *(jnp.asarray(a) for a in lists),
                    *(jnp.asarray(a) for a in common), 6, JDist.EUCLIDEAN, j.seg_size, "f32",
                    None, 4, None, False, None, 2)
    gd, gi = t_scan(torch.as_tensor(q), *(torch.as_tensor(np.asarray(a)) for a in lists),
                    *(torch.tensor(a) for a in common), 6, Dist.EUCLIDEAN, j.seg_size, "f32",
                    None, 4, None, False, None, 2)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-5, atol=1e-5)
    params = inspect.signature(t_scan).parameters
    assert params["step_bytes"].kind == inspect.Parameter.KEYWORD_ONLY


def test_expand_probes_takes_the_layout_or_its_cluster_ptr():
    """F14: ``expand_probes_to_segments(probes, layout)`` as in the JAX
    package (the JAX layout, the port's, or the ``cluster_ptr`` array)."""
    from annsearch_tpu.models import kmeans as jk
    from annsearch_tpu_torch.models import kmeans as tk

    rng = np.random.default_rng(15)
    assign = rng.integers(0, 6, 900).astype(np.int32)
    jl = jk.segment_layout(assign, 6, 64)
    tl = tk.segment_layout(assign, 6, 64)
    probes = rng.integers(0, 6, (30, 3))
    wq, ws = jk.expand_probes_to_segments(probes, jl)
    for layout in (jl, tl, np.asarray(tl.cluster_ptr)):
        gq, gs = tk.expand_probes_to_segments(probes, layout)
        np.testing.assert_array_equal(gq, wq)
        np.testing.assert_array_equal(gs, ws)
