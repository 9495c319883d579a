"""``HnswIndex`` of the port against the JAX package's: the layers one seed
draws, the base kNN graph in both regimes (one ``pairwise_dist`` up to
``EXACT_LAYER_MAX`` rows, kernel K2's plain version above), walks over the
JAX index's own graph and layers carried across by its npz (padded layers
included), the exact fallback, and the port's own builds by the JAX tests'
recall floors and degree bounds.

``tests/conftest.py`` sets ``ANNSEARCH_NO_EXACT_FALLBACK`` for every test,
so ``query`` walks the graph unless a test removes it. Where distances of
the two packages are compared the data is scaled by 1/8; the JAX walk
scores from a packed table of about 16 mantissa bits, hence the slack of
2⁻¹⁶·(‖q‖² + max‖x‖²) on distances (ROADMAP hazards)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import annsearch_tpu.models.hnsw as jhnsw_mod
import annsearch_tpu_torch as at
import annsearch_tpu_torch.models.hnsw as thnsw_mod
from annsearch_tpu.models.hnsw import HnswIndex as JHnsw
from annsearch_tpu.utils.dist import Dist as JDist
from annsearch_tpu_torch.interop import hnsw_from_jax_arrays
from annsearch_tpu_torch.models.hnsw import HnswIndex
from annsearch_tpu_torch.utils.data import generate_clustered_data, subsample_with_noise
from annsearch_tpu_torch.utils.dist import Dist

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def hdata():
    x, _ = generate_clustered_data(3000, 32, 8, seed=0)
    q = subsample_with_noise(x, 150, seed=0)
    ti, _ = at.build_exhaustive_index(x, device="cpu").query(q, 10)
    return x, q, ti


@pytest.fixture(scope="module")
def own(hdata):
    return HnswIndex(hdata[0], m=16, ef_construction=100, seed=0, device="cpu")


def _shared_dists(ti, td, ji, jd):
    shared = ti[:, :, None] == ji[:, None, :]
    dp = np.broadcast_to(td[:, :, None], shared.shape)[shared]
    dj = np.broadcast_to(jd[:, None, :], shared.shape)[shared]
    return shared, dp, dj


# -- the port's own builds (the JAX package's tests/test_vamana_hnsw.py) -------


def test_recall(hdata, own):
    _, q, ti = hdata
    ai, ad = own.query(q, 10, ef_search=100)
    assert at.calculate_recall(ti, ai, 10) > 0.85
    assert ai.dtype == torch.int64 and (ad.diff(dim=1) >= 0).all()


def test_layers_shrink_and_degrees(hdata, own):
    sizes = [len(g[0]) for g in own.layers]
    assert all(a > b for a, b in zip(sizes, sizes[1:])) and sizes[0] < 3000 / 4
    assert own.base_graph.shape == (3001, 32 + 16) and own.base_graph.dtype == torch.int32
    assert (own.base_graph[-1] == 3000).all()
    for gids, graph, lv_vecs, lv_sq in own.layers:
        s = len(gids)
        assert graph.shape == (s + 1, min(16, s - 1)) and (graph[-1] == s).all()
        assert lv_vecs.shape == (s + 1, 32) and torch.equal(lv_vecs[:s], own.vectors[gids.long()])
        assert (graph[:s] < s).all()
    assert own.entry_global == int(own.layers[-1][0][0])


def test_ef_sweep(hdata, own):
    _, q, ti = hdata
    lo, _ = own.query(q, 10, ef_search=20)
    hi, _ = own.query(q, 10, ef_search=150)
    assert at.calculate_recall(ti, hi, 10) >= at.calculate_recall(ti, lo, 10) - 0.02


def test_cosine(hdata):
    x, q, _ = hdata
    ti, _ = at.build_exhaustive_index(x, "cosine", device="cpu").query(q, 10)
    ai, _ = HnswIndex(x, "cosine", m=16, seed=0, device="cpu").query(q, 10, ef_search=100)
    assert at.calculate_recall(ti, ai, 10) > 0.8


def test_self_query_and_facade(hdata):
    x = hdata[0][:600]
    index = at.build_hnsw_index(x, "euclidean", 8, 100, 0, False, device="cpu")
    ai, ad = at.query_hnsw_self(index, 3, return_dist=True)
    assert (ai[:, 0] == torch.arange(600)).float().mean() > 0.95
    i2, d2 = at.query_hnsw_index(x, index, 3, None, True)
    assert torch.equal(ai, i2) and torch.equal(ad, d2)
    assert torch.equal(index.vectors_original_order(), torch.as_tensor(x))


def test_save_load_roundtrip(tmp_path, hdata):
    x, q, _ = hdata
    index = HnswIndex(x[:500], m=8, seed=0, device="cpu")
    p = str(tmp_path / "hnsw.npz")
    index.save(p)
    loaded = HnswIndex.load(p, device="cpu")
    assert loaded.memory_usage_bytes() == index.memory_usage_bytes()
    for a, b in zip((index.query(q[:10], 5)), loaded.query(q[:10], 5)):
        assert torch.equal(a, b)


def test_unreached_slots_come_back_as_n_minus_1():
    """``np.clip`` of the JAX query: a walk that reaches fewer than k nodes
    returns id n − 1 at inf in the empty slots, not the sentinel n."""
    x = np.random.default_rng(0).standard_normal((40, 8)).astype(np.float32)
    index = HnswIndex(x, m=4, seed=0, device="cpu")
    index.base_graph = torch.full_like(index.base_graph, 40)      # no edges at all
    index.layers = []
    ids, d = index.query(x[:3], 5)
    assert (ids[:, 1:] == 39).all() and torch.isinf(d[:, 1:]).all()
    assert torch.isfinite(d[:, 0]).all()


def test_f64_inputs(hdata):
    x, q, _ = hdata
    x64, q64 = x[:800].astype(np.float64), q[:20].astype(np.float64)
    index = HnswIndex(x64, m=8, seed=0, device="cpu")
    ids, d = index.query(q64, 5)
    assert d.dtype == torch.float64
    truth = ((q64[:, None, :] - x64[None]) ** 2).sum(-1)
    np.testing.assert_allclose(d.numpy(), np.take_along_axis(truth, ids.numpy(), 1), rtol=1e-12)
    assert at.calculate_recall(np.argsort(truth, 1)[:, :5], ids, 5) > 0.95


# -- against the JAX package ----------------------------------------------------


def test_levels_and_members_equal_jax(hdata):
    """One seed, one hierarchy: the member set of each upper layer and the
    entry point (the JAX layers carry power-of-two padding that repeats
    member 0)."""
    x = hdata[0]
    j = JHnsw(x, m=16, seed=3)
    t = HnswIndex(x, m=16, seed=3, device="cpu")
    assert t.n_layers == j.n_layers and len(t.layers) == len(j.layers)
    for (tg, *_), (jg, *_) in zip(t.layers, j.layers):
        jg = np.asarray(jg)
        assert tg.numpy().tolist() == sorted(set(jg.tolist()))
        assert (jg[len(tg):] == jg[0]).all()
    assert t.entry_global == j.entry_global


@pytest.mark.parametrize("regime", ["pairwise", "fused"])
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_base_knn_graph_against_jax(hdata, monkeypatch, regime, metric):
    """``_build_knn_graph`` at HNSW's kk (build_k 50 at m 16): the JAX
    package's off-TPU route against the port's. In the fused regime (both
    packages' ``EXACT_LAYER_MAX`` lowered below n) the JAX package takes its
    ``"exact"`` selector and the port K2's plain version at ``passes=6``:
    ≥ 99.9% of ids, distances on shared ids within 1e-4·(1 + |d|)."""
    if regime == "fused":
        monkeypatch.setattr(jhnsw_mod, "EXACT_LAYER_MAX", 1000)
        monkeypatch.setattr(thnsw_mod, "EXACT_LAYER_MAX", 1000)
    x = hdata[0] / np.float32(8)
    if metric == "cosine":
        x = x / np.linalg.norm(x, axis=1, keepdims=True)
    vecs = np.concatenate([x, np.zeros((1, 32), np.float32)])
    sq = (vecs * vecs).sum(1)
    jm = JDist.COSINE if metric == "cosine" else JDist.EUCLIDEAN
    ji, jd = (np.asarray(a) for a in jhnsw_mod._build_knn_graph(
        jax.random.key(0), jnp.asarray(vecs), jnp.asarray(sq), 50, jm, 2, 8))
    ti, td = thnsw_mod._build_knn_graph(torch.as_tensor(vecs), torch.as_tensor(sq), 50,
                                       Dist(metric), 0, 2, 8)
    ti, td = ti.numpy(), td.numpy()
    assert ti.shape == ji.shape == (3000, 50) and ti.dtype == np.int32
    assert (ti == ji).mean() >= 0.999
    assert (ti != np.arange(3000)[:, None]).all()
    _, dp, dj = _shared_dists(ti, td, ji, jd)
    assert np.all(np.abs(dp - dj) <= 1e-4 * (1.0 + np.abs(dj)))


def test_above_the_budget_builds_approximately(monkeypatch):
    """Above ``graph.BRUTE_BUILD_FLOP_BUDGET`` (patched in the graph module,
    read at build time) every layer past ``EXACT_LAYER_MAX`` is built by
    ``approx_knn_graph``: the base layer's kNN graph keeps its shape, no
    self edge, ascending rows, and most of the exact graph's edges."""
    import annsearch_tpu_torch.models.graph as tgraph_mod

    monkeypatch.setattr(thnsw_mod, "EXACT_LAYER_MAX", 10)
    monkeypatch.setattr(tgraph_mod, "BRUTE_BUILD_FLOP_BUDGET", 100)
    x = np.random.default_rng(0).standard_normal((300, 8)).astype(np.float32)
    vecs = torch.cat([torch.as_tensor(x), torch.zeros((1, 8))])
    sq = (vecs * vecs).sum(1)
    ti, td = thnsw_mod._build_knn_graph(vecs, sq, 8, Dist.EUCLIDEAN, 0, 2, 8)
    assert ti.shape == (300, 8) and (ti.long() != torch.arange(300)[:, None]).all()
    assert (td.diff(dim=1) >= 0).all()
    d = ((x[:, None, :] - x[None]) ** 2).sum(-1)
    np.fill_diagonal(d, np.inf)
    exact = np.argsort(d, 1)[:, :8]
    assert np.mean([len(set(a) & set(b)) / 8 for a, b in zip(ti.numpy(), exact)]) >= 0.9
    h = HnswIndex(x, m=4, device="cpu")
    assert h.base_graph.shape[0] == 301


@pytest.fixture(scope="module", params=["euclidean", "cosine"])
def carried(request, hdata, tmp_path_factory):
    """A JAX index (data scaled by 1/8) saved to its npz, its query result,
    and the port's index loaded from that npz."""
    metric = request.param
    x, q = hdata[0] / np.float32(8), hdata[1] / np.float32(8)
    j = JHnsw(x, metric, m=16, seed=0)
    ji, jd = j.query(q, 10, ef_search=100, exact_fallback=False)
    p = str(tmp_path_factory.mktemp("hnsw") / f"j_{metric}.npz")
    j.save(p)
    t = HnswIndex.load(p, device="cpu")
    truth, _ = at.build_exhaustive_index(x, metric, device="cpu").query(q, 10)
    return dict(metric=metric, x=x, q=q, j=j, ji=np.asarray(ji), jd=np.asarray(jd), t=t,
                truth=truth, path=p)


def test_walk_on_the_jax_index(carried):
    """The port walks the JAX graph from the JAX layers: recall within 0.01
    of the JAX walk's, distances on shared ids within 2⁻¹⁶·(‖q‖² + max‖x‖²)
    of the query's own ‖q‖²."""
    t, ji, jd = carried["t"], carried["ji"], carried["jd"]
    ti, td = t.query(carried["q"], 10, ef_search=100)
    r_port = at.calculate_recall(carried["truth"], ti, 10)
    r_jax = at.calculate_recall(carried["truth"], ji, 10)
    assert r_port > 0.9 and abs(r_port - r_jax) <= 0.01
    shared, dp, dj = _shared_dists(ti.numpy(), td.numpy(), ji, jd)
    assert shared.any(axis=2).mean() > 0.95
    if carried["metric"] == "cosine":
        scale = 2.0
    else:
        q_sq = (carried["q"] ** 2).sum(1)[:, None, None]
        q_sq = np.broadcast_to(q_sq, shared.shape)[shared]
        scale = q_sq + (carried["x"] ** 2).sum(1).max()
    assert np.all(np.abs(dp - dj) <= 2.0 ** -16 * scale)


def test_carried_state(carried):
    """The npz's padded layers are read as they are; memory is counted as
    the JAX package counts it; routing may name an entry twice."""
    t, j = carried["t"], carried["j"]
    assert t.memory_usage_bytes() == j.memory_usage_bytes()
    assert t.metric == Dist(carried["metric"]) and t.entry_global == j.entry_global
    for (tg, tgr, tv, _), (jg, jgr, jv, _) in zip(t.layers, j.layers):
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
        np.testing.assert_array_equal(tgr.numpy(), np.asarray(jgr))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    with np.load(carried["path"]) as z:
        again = hnsw_from_jax_arrays({f: z[f] for f in z.files}, device="cpu")
    assert torch.equal(again.base_graph, t.base_graph)


def test_exact_fallback_equals_jax(carried, monkeypatch):
    monkeypatch.delenv("ANNSEARCH_NO_EXACT_FALLBACK", raising=False)
    ti, _ = carried["t"].query(carried["q"], 10)
    ji, _ = carried["j"].query(carried["q"], 10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
