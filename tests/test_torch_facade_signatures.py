"""The port's facade against the JAX package's: every row both ``__all__``
lists share takes the JAX row's parameters, in its order and with its
defaults (``verbose`` included), and whatever the port adds is
keyword-only, so that a positional call means the same in both packages.
The 15 tree, LSH and kMkNN rows, the 18 HNSW, Vamana and flat
quantised rows and the 12 binary and RaBitQ rows are present (the port's
``__all__`` is the JAX package's, in its order), every build row defaults
to the card,
``_query``'s progress report is the reference's, and every
``NotImplementedError`` of the port names a ROADMAP tag."""

import inspect
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
