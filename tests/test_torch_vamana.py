"""``VamanaIndex`` and ``robust_prune`` of the port against the JAX
package's: the prune on ``tests/test_vamana_internals.py``'s line fixture
(equal) and on clustered data (kept sets), the medoid, a walk over the JAX
index's graph from its medoid and router sample carried across, the exact
fallback, and the port's own builds by the JAX tests' recall floors,
degree bounds and highway edges.

``tests/conftest.py`` sets ``ANNSEARCH_NO_EXACT_FALLBACK``; distances of
the two packages are compared on data scaled by 1/8, with the JAX walk's
packed-table slack of 2⁻¹⁶·(‖q‖² + max‖x‖²) (ROADMAP hazards)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import annsearch_tpu_torch as at
from annsearch_tpu.models.graph import NNDescentIndex as JNNDescent
from annsearch_tpu.models.vamana import VamanaIndex as JVamana
from annsearch_tpu.models.vamana import robust_prune as jrobust_prune
from annsearch_tpu.utils.dist import Dist as JDist
from annsearch_tpu_torch.interop import VAMANA_ARRAYS, VAMANA_SCALARS, vamana_from_jax_arrays
from annsearch_tpu_torch.models.vamana import VamanaIndex, robust_prune
from annsearch_tpu_torch.utils.data import generate_clustered_data, subsample_with_noise
from annsearch_tpu_torch.utils.dist import Dist

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def vdata():
    x, _ = generate_clustered_data(3000, 32, 8, seed=0)
    q = subsample_with_noise(x, 150, seed=0)
    ti, _ = at.build_exhaustive_index(x, device="cpu").query(q, 10)
    return x, q, ti


# -- robust_prune (the JAX package's tests/test_vamana_internals.py) ---------


def _line_fixture():
    """4 points and the sentinel; every node's candidates a=(1,0) d 1,
    b=(1.05,0.1) d 1.1125, c=(20,0) d 400 (see the JAX test)."""
    pts = np.zeros((5, 2), np.float32)
    pts[1], pts[2], pts[3] = (1.0, 0.0), (1.05, 0.1), (20.0, 0.0)
    ids = np.broadcast_to(np.array([1, 2, 3], np.int32), (4, 3)).copy()
    dists = np.broadcast_to(np.array([1.0, 1.1125, 400.0], np.float32), (4, 3)).copy()
    return pts, (pts * pts).sum(1), ids, dists


def _both(pts, sq, ids, dists, alpha, out_deg, metric="euclidean"):
    """The port's prune, held equal to the JAX package's on the same input."""
    jm = JDist.COSINE if metric == "cosine" else JDist.EUCLIDEAN
    ref = np.asarray(jrobust_prune(jnp.asarray(pts), jnp.asarray(sq), jnp.asarray(ids),
                                   jnp.asarray(dists), alpha, out_deg, jm))
    out = robust_prune(torch.as_tensor(pts), torch.as_tensor(sq), torch.as_tensor(ids),
                       torch.as_tensor(dists), alpha, out_deg, Dist(metric))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    return out.numpy()


def test_robust_prune_drops_dominated_candidate():
    out = _both(*_line_fixture(), 1.2, 2)
    assert out.shape == (4, 2) and out[0].tolist() == [1, 3]


def test_robust_prune_alpha_one_prunes_more_than_large_alpha():
    fx = _line_fixture()
    assert _both(*fx, 10.0, 3)[0].tolist()[:2] == [1, 3]
    assert _both(*fx, 1.0, 3)[0].tolist() == [1, 2, 3]


def test_robust_prune_rank_one_always_kept():
    for alpha in (1.0, 1.2, 2.0):
        assert (_both(*_line_fixture(), alpha, 2)[:, 0] == 1).all()


def test_robust_prune_sentinel_neighbours_sort_last():
    pts, sq, ids, dists = _line_fixture()
    ids[:, 1], dists[:, 1] = 4, np.inf
    assert _both(pts, sq, ids, dists, 1.2, 3)[0].tolist() == [1, 3, 4]


def test_robust_prune_cosine_mode_runs():
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((9, 8)).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    vecs = np.concatenate([pts, np.zeros((1, 8), np.float32)])
    d = 1.0 - pts @ pts.T
    np.fill_diagonal(d, np.inf)
    order = np.argsort(d, axis=1)[:, :4].astype(np.int32)
    out = _both(vecs, (vecs * vecs).sum(1), order, np.take_along_axis(d, order, 1), 1.2, 3,
                "cosine")
    assert out.shape == (9, 3) and (out[:, 0] == order[:, 0]).all()


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_robust_prune_on_clustered_data(vdata, metric):
    """On a JAX-built kNN graph (k 48, with empty slots): ≥ 99.5% of the
    rows equal (the bf16 rows' products are exact in both packages; only
    the order of their f32 sums differs, and a dominance test within that
    rounding can flip); the tile changes no result."""
    x = vdata[0] / np.float32(8)
    j = JNNDescent(x, metric, k=24, build_k=48, seed=0)
    vecs, sq = np.array(j.vectors), np.array(j.sqnorms)
    ids, dists = np.asarray(j.knn_ids).copy(), np.asarray(j.knn_dists).copy()
    ids[::7, -5:], dists[::7, -5:] = 3000, np.inf
    jm = JDist.COSINE if metric == "cosine" else JDist.EUCLIDEAN
    ref = np.asarray(jrobust_prune(jnp.asarray(vecs), jnp.asarray(sq), jnp.asarray(ids),
                                   jnp.asarray(dists), 1.2, 32, jm))
    args = [torch.as_tensor(a) for a in (vecs, sq, ids, dists)]
    out = robust_prune(*args, 1.2, 32, Dist(metric))
    assert (out.numpy() == ref).all(axis=1).mean() >= 0.995
    assert torch.equal(out, robust_prune(*args, 1.2, 32, Dist(metric), tile=77))


# -- the port's own builds (the JAX package's tests/test_vamana_hnsw.py) ------


@pytest.fixture(scope="module")
def own(vdata):
    return VamanaIndex(vdata[0], r_degree=32, seed=0, device="cpu")


def test_recall(vdata, own):
    _, q, ti = vdata
    ai, ad = own.query(q, 10)
    assert at.calculate_recall(ti, ai, 10) > 0.85
    assert (ad.diff(dim=1) >= -1e-4).all() and ai.dtype == torch.int64


def test_recall_high_degree(vdata):
    """r 48: the first-pass graph is 72 wide, past the trail pass's cap of
    48 edges."""
    _, q, ti = vdata
    index = VamanaIndex(vdata[0], r_degree=48, seed=0, device="cpu")
    assert at.calculate_recall(ti, index.query(q, 10)[0], 10) > 0.9


def test_self_query_and_facade(vdata):
    x = vdata[0][:500]
    index = at.build_vamana_index(x, "euclidean", 24, 1.2, 0, False, device="cpu")
    ai, ad = at.query_vamana_self(index, 3, return_dist=True)
    assert (ai[:, 0] == torch.arange(500)).float().mean() > 0.9
    i2, d2 = at.query_vamana_index(x, index, 3, None, True)
    assert torch.equal(ai, i2) and torch.equal(ad, d2)


def test_degree_bound(vdata):
    x = vdata[0]
    index = VamanaIndex(x, r_degree=16, seed=0, device="cpu")
    adj = index.graph[:3000].numpy()
    assert index.graph.shape == (3001, 16 + 8) and (index.graph[-1] == 3000).all()
    real = adj < 3000
    assert real.any(axis=1).all()
    assert not ((adj == np.arange(3000)[:, None]) & real).any()


def test_highway_edges_exist():
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.standard_normal((120, 8)), rng.standard_normal((120, 8)) + 40.0])
    index = VamanaIndex(x.astype(np.float32), r_degree=8, alpha=1.3, device="cpu")
    g = index.graph[:240].numpy()
    labels = np.repeat([0, 1], 120)
    cross = (labels[:, None] != labels[np.clip(g, 0, 239)]) & (g < 240)
    assert cross.sum() > 0


def test_cosine_and_two_builds_agree(vdata):
    x, q, _ = vdata
    ti, _ = at.build_exhaustive_index(x, "cosine", device="cpu").query(q, 10)
    a = VamanaIndex(x, "cosine", r_degree=16, seed=1, device="cpu")
    b = VamanaIndex(x, "cosine", r_degree=16, seed=1, device="cpu")
    assert torch.equal(a.graph, b.graph)
    assert at.calculate_recall(ti, a.query(q, 10)[0], 10) > 0.8


def test_f64_and_save_load(tmp_path, vdata):
    x, q, _ = vdata
    x64, q64 = x[:800].astype(np.float64), q[:20].astype(np.float64)
    index = VamanaIndex(x64, r_degree=16, seed=0, device="cpu")
    ids, d = index.query(q64, 5)
    assert d.dtype == torch.float64
    truth = ((q64[:, None, :] - x64[None]) ** 2).sum(-1)
    np.testing.assert_allclose(d.numpy(), np.take_along_axis(truth, ids.numpy(), 1), rtol=1e-12)
    p = str(tmp_path / "vamana.npz")
    index.save(p)
    loaded = VamanaIndex.load(p, device="cpu")
    assert loaded.memory_usage_bytes() == index.memory_usage_bytes()
    a, b = index.query(q[:10], 5), loaded.query(q[:10], 5)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# -- a walk over the JAX index ------------------------------------------------


@pytest.fixture(scope="module", params=["euclidean", "cosine"])
def carried(request, vdata, tmp_path_factory):
    """A JAX index (data scaled by 1/8) after its first query, and the port
    carrying its graph, medoid and router sample."""
    metric = request.param
    x, q = vdata[0] / np.float32(8), vdata[1] / np.float32(8)
    j = JVamana(x, metric, r_degree=32, seed=0)
    ji, jd = j.query(q, 10, exact_fallback=False)
    arrays = {a: np.asarray(getattr(j, a)) for a in VAMANA_ARRAYS}
    meta = {s: int(getattr(j, s)) for s in VAMANA_SCALARS}
    meta["metric"] = j.metric.value
    t = vamana_from_jax_arrays(arrays, meta, device="cpu",
                               router_ids=np.asarray(j._router_ids))
    truth, _ = at.build_exhaustive_index(x, metric, device="cpu").query(q, 10)
    p = str(tmp_path_factory.mktemp("vamana") / f"j_{metric}.npz")
    j.save(p)
    return dict(metric=metric, x=x, q=q, j=j, ji=np.asarray(ji), jd=np.asarray(jd), t=t,
                truth=truth, path=p)


def test_walk_on_the_jax_index(carried):
    t, ji, jd = carried["t"], carried["ji"], carried["jd"]
    ti, td = t.query(carried["q"], 10)
    r_port = at.calculate_recall(carried["truth"], ti, 10)
    r_jax = at.calculate_recall(carried["truth"], ji, 10)
    assert r_port > 0.9 and abs(r_port - r_jax) <= 0.01
    shared = ti.numpy()[:, :, None] == ji[:, None, :]
    dp = np.broadcast_to(td.numpy()[:, :, None], shared.shape)[shared]
    dj = np.broadcast_to(jd[:, None, :], shared.shape)[shared]
    assert shared.any(axis=2).mean() > 0.95
    if carried["metric"] == "cosine":
        scale = 2.0
    else:
        q_sq = (carried["q"] ** 2).sum(1)[:, None, None]
        q_sq = np.broadcast_to(q_sq, shared.shape)[shared]
        scale = q_sq + (carried["x"] ** 2).sum(1).max()
    assert np.all(np.abs(dp - dj) <= 2.0 ** -16 * scale)


def test_load_of_the_jax_npz(carried):
    """The JAX npz loads (its routers are drawn anew, from seed 7); memory
    is counted as the JAX package counts it."""
    t = VamanaIndex.load(carried["path"], device="cpu")
    j = carried["j"]
    assert t.memory_usage_bytes() == j.memory_usage_bytes()
    assert t.medoid == j.medoid and t.r_degree == j.r_degree == 32
    assert torch.equal(t.graph, carried["t"].graph)
    ti, _ = t.query(carried["q"], 10)
    assert at.calculate_recall(carried["truth"], ti, 10) > 0.9
    assert t._router_ids.shape == carried["t"]._router_ids.shape


def test_medoid_equals_jax_and_numpy(carried, vdata, own):
    x = vdata[0]
    assert own.medoid == int(np.argmin(((x - x.mean(0)) ** 2).sum(1)))
    t = VamanaIndex(carried["x"], carried["metric"], r_degree=8, seed=0, device="cpu")
    assert t.medoid == carried["j"].medoid


def test_exact_fallback_equals_jax(carried, monkeypatch):
    monkeypatch.delenv("ANNSEARCH_NO_EXACT_FALLBACK", raising=False)
    ti, _ = carried["t"].query(carried["q"], 10)
    ji, _ = carried["j"].query(carried["q"], 10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
