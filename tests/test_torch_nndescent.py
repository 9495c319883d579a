"""``NNDescentIndex`` of the port as a whole: the exact kNN-graph build
(kernel K2's plain version on the CPU), the beam-search query, the
small-regime exact fallback, f64 data, and the JAX package's index carried
across by ``interop`` and by ``save`` → ``load``.

The first block repeats the cases of the JAX package's ``tests/test_graph.py``
that this slice covers, on the same 3,000 × 32d data and with the same
floors. ``tests/conftest.py`` sets ``ANNSEARCH_NO_EXACT_FALLBACK`` for every
test, so ``query`` walks the graph unless a test removes the variable.
Where distances of the two packages are compared the data is scaled by 1/8:
the ``‖q‖² + ‖x‖² − 2q·x`` identity cancels, and its f32 rounding grows
with the norms."""

import numpy as np
import pytest
import torch

import annsearch_tpu_torch as at
import annsearch_tpu_torch.models.base as tbase
import annsearch_tpu_torch.models.graph as tgraph
from annsearch_tpu.models.graph import NNDescentIndex as JNNDescent
from annsearch_tpu_torch.interop import (
    NNDESCENT_ARRAYS,
    NNDESCENT_SCALARS,
    nndescent_from_jax_arrays,
)
from annsearch_tpu_torch.models.graph import NNDescentIndex
from annsearch_tpu_torch.utils.data import generate_clustered_data, subsample_with_noise

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def gdata():
    x, _ = generate_clustered_data(3000, 32, 8, seed=0)
    q = subsample_with_noise(x, 150, seed=0)
    exact = at.build_exhaustive_index(x, device="cpu")
    ti, _ = exact.query(q, 10)
    si, _ = exact.generate_knn(11)      # row i finds i first: dropped below
    return x, q, ti, si


@pytest.fixture(scope="module")
def index(gdata):
    return NNDescentIndex(gdata[0], k=10, seed=0, device="cpu")


def test_knn_graph_recall(gdata, index):
    _, _, _, si = gdata
    gi, gd = index.generate_knn(10, mode="graph")
    assert at.calculate_recall(si[:, 1:11], gi, 10) > 0.95
    finite = torch.where(torch.isfinite(gd), gd, 1e30)
    assert (finite.diff(dim=1) >= -1e-4).all()
    assert (gi != torch.arange(3000)[:, None]).all()
    assert index.nav_graph is None          # the graph alone builds no nav graph


def test_beam_query_recall(gdata, index):
    _, q, ti, _ = gdata
    ai, ad = index.query(q, 10)
    assert index.nav_graph is not None      # the walk ran, not the fallback
    assert at.calculate_recall(ti, ai, 10) > 0.9
    assert (ad.diff(dim=1) >= 0).all()


def test_beam_query_self_finds_self(gdata):
    x = gdata[0]
    index = NNDescentIndex(x[:500], k=10, seed=0, device="cpu")
    ai, ad = index.query(x[:500], 5)
    assert (ai[:, 0] == torch.arange(500)).float().mean() > 0.95
    assert ad[:, 0].nanmedian() < 1e-3


def test_graph_search_mode_self(gdata):
    index = NNDescentIndex(gdata[0][:500], k=10, seed=0, device="cpu")
    ai, _ = index.generate_knn(5, mode="search")
    assert ai.shape == (500, 5)
    assert (ai[:, 0] == torch.arange(500)).float().mean() > 0.95


def test_graph_cosine(gdata):
    x, q, _, _ = gdata
    ti, _ = at.build_exhaustive_index(x, "cosine", device="cpu").query(q, 10)
    index = NNDescentIndex(x, "cosine", k=10, seed=0, device="cpu")
    ai, _ = index.query(q, 10)
    assert at.calculate_recall(ti, ai, 10) > 0.85


def test_beam_larger_beats_smaller(gdata, index):
    _, q, ti, _ = gdata
    small, _ = index.query(q, 10, beam=16, iters=8)
    large, _ = index.query(q, 10, beam=64, iters=48)
    assert at.calculate_recall(ti, large, 10) >= at.calculate_recall(ti, small, 10) - 0.02


def test_graph_tiny_n():
    x = np.random.default_rng(0).standard_normal((20, 8)).astype(np.float32)
    index = NNDescentIndex(x, k=5, seed=0, device="cpu")
    ai, _ = index.query(x[:3], 4)
    assert ai.shape == (3, 4)
    assert (ai[:, 0] == torch.arange(3)).all()


def test_nndescent_has_sentinel_adoption(gdata):
    """A sentinel-padded table is adopted as it is and gives the index of
    the plain path."""
    x, q = gdata[0][:1500], gdata[1][:40]
    xp = np.concatenate([x, np.zeros((1, x.shape[1]), np.float32)])
    ip = NNDescentIndex(xp, k=6, has_sentinel=True, device="cpu")
    i0 = NNDescentIndex(x, k=6, device="cpu")
    assert ip.n == i0.n == 1500 and ip.vectors.shape == (1501, 32)
    assert torch.equal(ip.knn_ids, i0.knn_ids)
    assert torch.equal(ip.query(q, 5)[0], i0.query(q, 5)[0])
    with pytest.raises(ValueError, match="zero last row"):
        NNDescentIndex(x, k=6, has_sentinel=True, device="cpu")


def test_two_builds_agree(gdata, index):
    again = NNDescentIndex(gdata[0], k=10, seed=0, device="cpu")
    assert torch.equal(again.knn_ids, index.knn_ids)
    again._ensure_nav()
    index._ensure_nav()
    assert torch.equal(again.nav_graph, index.nav_graph)
    assert torch.equal(again.router_ids, index.router_ids)
    other = NNDescentIndex(gdata[0], k=10, seed=1, device="cpu")
    other._ensure_nav()
    assert not torch.equal(other.router_ids, index.router_ids)


def test_shapes_and_defaults(index):
    assert index.k_build == 20 and index.out_deg == 16
    assert index.knn_ids.shape == (3000, 20) and index.knn_ids.dtype == torch.int32
    index._ensure_nav()
    assert index.nav_graph.shape == (3001, 16 + 8) and index.nav_graph.dtype == torch.int32
    assert (index.nav_graph[-1] == 3000).all()
    assert index.router_ids.shape == (min(3000, max(256, 4 * 54)),)
    assert index.vectors_original_order().shape == (3000, 32)
    assert index.memory_usage_bytes() > 3001 * 32 * 4


# -- against the JAX package ---------------------------------------------------


def _jax_state(j):
    arrays = {a: (None if getattr(j, a, None) is None else np.asarray(getattr(j, a)))
              for a in NNDESCENT_ARRAYS}
    meta = {s: int(getattr(j, s)) for s in NNDESCENT_SCALARS}
    meta["metric"] = j.metric.value
    return arrays, meta


@pytest.fixture(scope="module", params=["euclidean", "cosine"])
def pair(request, gdata):
    """The JAX index on the data scaled by 1/8, after its first query, and
    the port's own build from the same data."""
    metric = request.param
    x, q = gdata[0] / np.float32(8), gdata[1] / np.float32(8)
    j = JNNDescent(x, metric, k=10, seed=0)
    ji, jd = j.query(q, 10, exact_fallback=False)
    t = NNDescentIndex(x, metric, k=10, seed=0, device="cpu")
    truth, _ = at.build_exhaustive_index(x, metric, device="cpu").query(q, 10)
    return dict(metric=metric, x=x, q=q, j=j, ji=ji, jd=jd, t=t, truth=truth)


def test_built_graph_against_jax(pair):
    j, t = pair["j"], pair["t"]
    gi, gd = t.generate_knn(10, mode="graph")
    ji, jd = j.generate_knn(10, mode="graph")
    assert at.calculate_recall(np.array(ji), gi, 10) >= 0.999
    assert at.calculate_recall(gi, np.array(ji), 10) >= 0.999
    shared = gi.numpy()[:, :, None] == ji[:, None, :]
    dp = np.broadcast_to(gd.numpy()[:, :, None], shared.shape)[shared]
    dj = np.broadcast_to(jd[:, None, :], shared.shape)[shared]
    assert np.all(np.abs(dp - dj) <= 1e-4)
    assert t.k_build == j.k_build and t.out_deg == j.out_deg


def _same_walk(pair, t):
    """The port walking the JAX index's graph from its routers."""
    ti, td = t.query(pair["q"], 10, exact_fallback=False)
    ji, jd = pair["ji"], pair["jd"]
    r_port = at.calculate_recall(pair["truth"], ti, 10)
    r_jax = at.calculate_recall(pair["truth"], np.array(ji), 10)
    assert r_port > 0.85 and abs(r_port - r_jax) <= 0.01
    shared = ti.numpy()[:, :, None] == ji[:, None, :]
    dp = np.broadcast_to(td.numpy()[:, :, None], shared.shape)[shared]
    dj = np.broadcast_to(jd[:, None, :], shared.shape)[shared]
    assert shared.any(axis=2).mean() > 0.95
    # the JAX walk scores from its packed table, two bf16 terms per operand
    # (about 16 mantissa bits): 2⁻¹⁶ of ‖q‖² + max‖x‖² on top of the f32 sums
    if pair["metric"] == "cosine":
        scale = 2.0
    else:
        scale = (pair["q"] ** 2).sum(1).max() + (pair["x"] ** 2).sum(1).max()
    assert np.all(np.abs(dp - dj) <= 1e-4 * (1.0 + dj) + 2.0 ** -16 * scale)


def test_interop_carries_a_jax_index(pair):
    arrays, meta = _jax_state(pair["j"])
    t = nndescent_from_jax_arrays(arrays, meta, device="cpu")
    assert t.nav_graph is not None and t.router_ids is not None
    np.testing.assert_array_equal(t.nav_graph.numpy(), np.asarray(pair["j"].nav_graph))
    _same_walk(pair, t)
    # without a nav graph the port builds its own on the first query
    arrays["nav_graph"] = arrays["router_ids"] = None
    t2 = nndescent_from_jax_arrays(arrays, meta, device="cpu")
    assert t2.nav_graph is None
    ti, _ = t2.query(pair["q"], 10, exact_fallback=False)
    assert at.calculate_recall(pair["truth"], ti, 10) > 0.85
    arrays["router_ids"] = np.zeros(4, np.int32)
    with pytest.raises(ValueError, match="together"):
        nndescent_from_jax_arrays(arrays, meta, device="cpu")


def test_save_load_both_ways(pair, tmp_path):
    pair["j"].save(str(tmp_path / "jax_index"))
    t = NNDescentIndex.load(str(tmp_path / "jax_index"), device="cpu")
    assert t.metric.value == pair["metric"] and t.n == 3000
    _same_walk(pair, t)
    # the port's save, read by the JAX package and by the port
    own = pair["t"]
    before = own.query(pair["q"], 10, exact_fallback=False)
    own.save(str(tmp_path / "torch_index"))
    back = NNDescentIndex.load(str(tmp_path / "torch_index"), device="cpu")
    after = back.query(pair["q"], 10, exact_fallback=False)
    assert torch.equal(before[0], after[0]) and torch.equal(before[1], after[1])
    jback = JNNDescent.load(str(tmp_path / "torch_index"))
    ji, _ = jback.query(pair["q"], 10, exact_fallback=False)
    assert at.calculate_recall(before[0], np.array(ji), 10) > 0.95
    with pytest.raises(ValueError, match="holds a"):
        at.models.ivf.IvfIndex.load(str(tmp_path / "torch_index"), device="cpu")


# -- the small-regime exact fallback -------------------------------------------


@pytest.fixture()
def fallback_enabled(monkeypatch):
    monkeypatch.delenv("ANNSEARCH_NO_EXACT_FALLBACK", raising=False)


@pytest.fixture(scope="module")
def fdata():
    x, _ = generate_clustered_data(3000, 16, 6, seed=3)
    q = subsample_with_noise(x, 64, seed=3)
    ti, td = at.build_exhaustive_index(x, device="cpu").query(q, 10)
    # a weak graph (few neighbours, one entry, a short narrow walk), so that
    # the graph's own answer is visibly not the exact one
    idx = at.build_nndescent_index(x, k=4, seed=1, device="cpu")
    return x, q, ti, td, idx


def _weak_walk(idx, q, **kw):
    return idx.query(q, 10, beam=10, iters=1, expand=1, n_entries=1, **kw)


def test_fallback_is_exact(fdata, fallback_enabled):
    x, q, ti, td, idx = fdata
    ai, ad = at.query_nndescent_index(q, idx, 10, return_dist=True)
    assert at.calculate_recall(ti, ai, 10) >= 0.999
    np.testing.assert_allclose(ad.numpy(), td.numpy(), rtol=1e-3, atol=1e-3)
    assert torch.equal(_weak_walk(idx, q)[0], ti)       # still the fallback


def test_fallback_optout_uses_native_path(fdata, fallback_enabled):
    x, q, ti, _, idx = fdata
    native, _ = _weak_walk(idx, q, exact_fallback=False)
    assert at.calculate_recall(ti, native, 10) < 0.999  # the walk really ran


def test_fallback_respects_budget(fdata, fallback_enabled, monkeypatch):
    x, q, ti, _, idx = fdata
    monkeypatch.setattr(tbase, "BRUTE_QUERY_FLOP_BUDGET", 1)
    small, _ = _weak_walk(idx, q)
    assert at.calculate_recall(ti, small, 10) < 0.999


def test_fallback_env_optout(fdata):
    # conftest's ANNSEARCH_NO_EXACT_FALLBACK is in force here
    x, q, ti, _, idx = fdata
    assert not idx._exact_fallback_ok(q.shape[0])
    assert at.calculate_recall(ti, _weak_walk(idx, q)[0], 10) < 0.999


# -- f64, the unported options, the facade -------------------------------------


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_f64_build_and_queries(gdata, metric):
    x64 = gdata[0][:1200].astype(np.float64) + 1e-9 * np.arange(32)
    q64 = gdata[1][:30].astype(np.float64)
    t = NNDescentIndex(x64, metric, k=10, seed=0, device="cpu")
    j = JNNDescent(x64, metric, k=10, seed=0)
    ti, td = t.query(q64, 5)
    ji, jd = j.query(q64, 5)
    assert td.dtype == torch.float64
    assert at.calculate_recall(np.array(ji), ti, 5) >= 0.99
    same = ti.numpy() == ji
    np.testing.assert_allclose(td.numpy()[same], jd[same], rtol=1e-12, atol=1e-12)
    # f32 queries to the same index answer at f32 grade
    assert t.query(q64.astype(np.float32), 5)[1].dtype == torch.float32


def test_build_options_apply_at_every_size(gdata, monkeypatch):
    """``refine_rounds`` and ``diversify_prob`` build at every size, as in
    the JAX package: below the budget refinement is ignored and
    diversification prunes the exact graph; above it (the budget patched
    to 0) the approximate build takes both."""
    x = gdata[0][:200]
    exact = NNDescentIndex(x, k=5, device="cpu")
    refined = NNDescentIndex(x, k=5, refine_rounds=1, device="cpu")
    assert torch.equal(exact.knn_ids, refined.knn_ids)
    div = NNDescentIndex(x, k=5, diversify_prob=0.5, device="cpu")
    kept = div.knn_ids < 200
    assert 0 < kept.float().mean() < 1 and (kept[:, :-1] >= kept[:, 1:]).all()
    assert torch.isinf(div.knn_dists[~kept]).all()
    monkeypatch.setattr(tgraph, "BRUTE_BUILD_FLOP_BUDGET", 0)
    approx = NNDescentIndex(x, k=5, refine_rounds=1, diversify_prob=0.5, device="cpu")
    assert approx.knn_ids.shape == (200, 10) and (approx.knn_ids < 200).any()


def test_facade_rows(gdata):
    x, q, ti, si = gdata
    idx = at.build_nndescent_index_gpu(x, k=10, seed=0, device="cpu")
    assert isinstance(idx, NNDescentIndex) and idx.k_build == 20
    ids, d = at.query_nndescent_index_gpu(q, idx, 10, return_dist=True)
    assert at.calculate_recall(ti, ids, 10) > 0.9 and d.shape == (150, 10)
    assert at.query_nndescent_index(q, idx, 10, beam=48, iters=12)[1] is None
    gi, gd = at.extract_nndescent_knn_gpu(idx, 10, return_dist=True)
    assert at.calculate_recall(si[:, 1:11], gi, 10) > 0.95
    g2, _ = at.query_nndescent_self(idx, 10)
    g3, _ = at.query_nndescent_index_gpu_self(idx, 10, mode="graph")
    assert torch.equal(gi, g2) and torch.equal(gi, g3)
    s, _ = at.query_nndescent_self(idx, 3, mode="search")
    assert (s[:, 0] == torch.arange(3000)).float().mean() > 0.95
    for name in ("build_nndescent_index", "query_exhaustive_index_gpu",
                 "query_ivf_index_gpu_self", "extract_nndescent_knn_gpu"):
        assert name in at.__all__
