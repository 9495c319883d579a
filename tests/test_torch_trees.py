"""Parity of the port's tree indexes (Annoy, kd-forest, ball tree) with the
JAX package's.

The two packages draw their trees from different random streams, so a
torch-built forest is checked by its invariants, and the query paths are
held to the JAX package's on JAX-built trees carried across (``interop``
and ``load`` of the JAX npz). Both routes of each index are compared: the
fused cell scan (the JAX side runs its Pallas kernel in interpret mode;
``_BALL_FUSED_MIN_CELLS`` lowered by ``monkeypatch`` for the ball tree, as
the JAX package's own test does) and the gather route with its exact
rerank (the JAX side with ``ANNSEARCH_NO_PALLAS=1``). Fold selection
differs in near-ties and the JAX fused route scores f32 rows with bf16
hi/lo terms, so results are compared by recall against one exact truth
(within a band) and by distances on the ids both return, not id by id.
The data is scaled by 1/8: ``‖q‖² + ‖x‖² − 2q·x`` cancels near a match, and
its f32 rounding grows with the norms.
"""

import numpy as np
import pytest
import torch

import annsearch_tpu_torch as ta
from annsearch_tpu.models import trees as jtrees
from annsearch_tpu_torch import interop
from annsearch_tpu_torch.models import trees as ttrees
from annsearch_tpu_torch.ops import ivf_scan_fused as tsf
from annsearch_tpu_torch.utils.data import generate_clustered_data, subsample_with_noise

torch.set_num_threads(2)

K = 10
BAND = 0.02


@pytest.fixture(scope="module")
def tdata():
    x, _ = generate_clustered_data(3000, 32, 8, seed=0)
    x = x * np.float32(0.125)
    q = subsample_with_noise(x, 150, seed=0)
    ti, td = ta.build_exhaustive_index(x, device="cpu").query(q, K)
    return x, q, ti.numpy(), td.numpy()


def _recall(truth, ids):
    return ta.calculate_recall(truth, np.asarray(ids), K)


def _shared_dists_agree(ids_a, d_a, ids_b, d_b, tol=1e-4):
    """Distances of the (query, id) pairs both results hold agree within
    ``tol·(1 + d)``; returns the share of pairs shared."""
    ids_a, d_a, ids_b, d_b = (np.asarray(a) for a in (ids_a, d_a, ids_b, d_b))
    shared = 0
    for r in range(ids_a.shape[0]):
        pos_b = {int(i): j for j, i in enumerate(ids_b[r])}
        for j, i in enumerate(ids_a[r]):
            if int(i) in pos_b:
                shared += 1
                db = d_b[r, pos_b[int(i)]]
                assert abs(d_a[r, j] - db) <= tol * (1 + abs(db)), (r, int(i), d_a[r, j], db)
    return shared / ids_a.size


def _forest_state(j):
    return [{"order": np.asarray(t.order), "normals": [np.asarray(a) for a in t.normals],
             "thresholds": [np.asarray(a) for a in t.thresholds]} for t in j.trees]


@pytest.fixture(scope="module")
def jforests(tdata):
    x = tdata[0]
    return {name: cls(x, n_trees=8, seed=0)
            for name, cls in (("annoy", jtrees.AnnoyIndex), ("kd", jtrees.KdTreeIndex))}


# -- build invariants of a torch-built forest ----------------------------------


@pytest.mark.parametrize("mode", ["annoy", "kd", "ball"])
def test_tree_build_invariants(tdata, mode):
    """The order is a permutation (padding, id n, a suffix), every row lies
    in one leaf of each tree and a leaf holds at most ``leaf`` rows, and the
    stored splitters route a row to its own leaf."""
    x = tdata[0]
    n = len(x)
    if mode == "ball":
        trees = [ttrees.BallTreeIndex(x, leaf=64, seed=1, device="cpu").tree]
        ix = None
    else:
        ix = ttrees.AnnoyIndex if mode == "annoy" else ttrees.KdTreeIndex
        ix = ix(x, n_trees=3, leaf=64, seed=1, device="cpu")
        trees = ix.trees
    for t in trees:
        order = t.order.numpy()
        real = order < n
        assert sorted(order[real].tolist()) == list(range(n))
        assert (order[~real] == n).all() and not real[real.argmin():].any() if not real.all() else True
        leaves = order.reshape(-1, t.leaf)
        assert ((leaves < n).sum(1) <= t.leaf).all() and leaves.shape[1] == 64
        # descend the stored rows through the tree's own splitters
        norms = [nm[None] for nm in t.normals]
        thrs = [th[None] for th in t.thresholds]
        node, _ = ttrees._descend(torch.as_tensor(x), norms, thrs)
        leaf_of = np.empty(n, np.int64)
        leaf_of[order[real]] = np.nonzero(real)[0] // t.leaf
        assert (node[:, 0].numpy() == leaf_of).mean() >= 0.99
        if mode == "kd":
            assert all(((nm == 0) | (nm == 1)).all() and (nm.sum(1) == 1).all()
                       for nm in t.normals)
        if mode == "ball":
            assert len(t.centers) == t.n_levels + 1
            c, r = t.centers[-1], t.radii[-1]
            rows = torch.as_tensor(x)[torch.as_tensor(np.minimum(leaves, n - 1))]
            dist = ((rows - c[:, None, :]) ** 2).sum(-1).sqrt()
            assert bool((torch.where(torch.as_tensor(leaves < n), dist, 0.0)
                         <= r[:, None] * (1 + 1e-5) + 1e-5).all())


def test_forest_build_repeats_from_a_seed(tdata):
    x = tdata[0][:500]
    a = ttrees.AnnoyIndex(x, n_trees=2, seed=3, device="cpu")
    b = ttrees.AnnoyIndex(x, n_trees=2, seed=3, device="cpu")
    c = ttrees.AnnoyIndex(x, n_trees=2, seed=4, device="cpu")
    assert all(torch.equal(s.order, t.order) for s, t in zip(a.trees, b.trees))
    assert not all(torch.equal(s.order, t.order) for s, t in zip(a.trees, c.trees))


# -- queries on JAX-built forests ----------------------------------------------


@pytest.mark.parametrize("mode", ["annoy", "kd"])
def test_forest_fused_route_matches_jax(tdata, jforests, mode):
    x, q, ti, _ = tdata
    j = jforests[mode]
    loader = interop.annoy_from_jax_arrays if mode == "annoy" else interop.kd_tree_from_jax_arrays
    port = loader(np.asarray(j.vectors)[: j.n], _forest_state(j), j.leaf, device="cpu")
    scan = port._scan_setup()
    assert scan is not None and scan["cell"] == 128 and int(scan["counts"].sum()) == 3000 * 8
    before = tsf.ivf_cell_scan_f32_fold.launches
    ids, d = port.query(q, K, n_probes=4, exact_fallback=False)
    assert tsf.ivf_cell_scan_f32_fold.launches == before       # CPU: the plain version
    jids, jd = j.query(q, K, n_probes=4, exact_fallback=False)
    assert ids.shape == (150, K) and bool((d.diff(dim=1) >= 0).all())
    assert all(len(set(r.tolist())) == K for r in ids)         # the cross-tree dedup
    assert abs(_recall(ti, ids) - _recall(ti, jids)) <= BAND
    assert _shared_dists_agree(ids, d, jids, jd) >= 0.95


@pytest.mark.parametrize("mode", ["annoy", "kd"])
def test_forest_gather_route_matches_jax(tdata, jforests, mode, monkeypatch):
    x, q, ti, _ = tdata
    j = jforests[mode]
    loader = interop.annoy_from_jax_arrays if mode == "annoy" else interop.kd_tree_from_jax_arrays
    port = loader(np.asarray(j.vectors)[: j.n], _forest_state(j), j.leaf, device="cpu")
    ids, d = port._gather_query(port._prep_queries(q), K, 2, 64)
    monkeypatch.setenv("ANNSEARCH_NO_PALLAS", "1")
    jids, jd = j.query(q, K, n_probes=2, exact_fallback=False)
    # the same leaves, reranked exactly in FP32 by both
    assert (ids.numpy() == np.asarray(jids)).mean() >= 0.99
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-4, atol=1e-4)
    assert abs(_recall(ti, ids) - _recall(ti, jids)) <= 0.005


def test_forest_groups_is_the_per_tree_merge(tdata, jforests):
    """``groups=n_trees`` keeps each tree's own top-k: the forest's answer
    equals the dedup top-k of the trees' answers taken one by one."""
    x, q, _, _ = tdata
    j = jforests["annoy"]
    state = _forest_state(j)
    vec = np.asarray(j.vectors)[: j.n]
    forest = interop.annoy_from_jax_arrays(vec, state, j.leaf, device="cpu")
    ids, d = forest.query(q, K, n_probes=2, exact_fallback=False)
    per_d, per_i = [], []
    for t in state:
        one = interop.annoy_from_jax_arrays(vec, [t], j.leaf, device="cpu")
        i1, d1 = one.query(q, K, n_probes=2, exact_fallback=False)
        per_d.append(d1)
        per_i.append(i1)
    from annsearch_tpu_torch.models.lsh import _dedup_topk

    md, mi = _dedup_topk(torch.cat(per_d, 1), torch.cat(per_i, 1), K)
    np.testing.assert_array_equal(d.numpy(), md.numpy())
    assert (ids.numpy() == mi.numpy()).mean() >= 0.99


def test_forest_save_load_both_ways(tdata, jforests, tmp_path):
    x, q, _, _ = tdata
    j = jforests["kd"]
    j.save(str(tmp_path / "jax_kd"))
    port = ttrees.KdTreeIndex.load(str(tmp_path / "jax_kd.npz"), device="cpu")
    assert port.n == 3000 and port.leaf == j.leaf and len(port.trees) == 8
    ids, d = port.query(q, K, exact_fallback=False)
    port.save(str(tmp_path / "port_kd"))
    back = jtrees.KdTreeIndex.load(str(tmp_path / "port_kd.npz"))
    for a, b in zip(j.trees, back.trees):
        np.testing.assert_array_equal(np.asarray(a.order), np.asarray(b.order))
        np.testing.assert_array_equal(np.asarray(a.thresholds[-1]), np.asarray(b.thresholds[-1]))
    again = ttrees.KdTreeIndex.load(str(tmp_path / "port_kd"), device="cpu")
    i2, d2 = again.query(q, K, exact_fallback=False)
    assert torch.equal(ids, i2) and torch.equal(d, d2)
    assert port.memory_usage_bytes() > 3000 * 32 * 4


def test_forest_cosine_and_f64(tdata):
    x, q, _, _ = tdata
    ci, _ = ta.build_exhaustive_index(x, "cosine", device="cpu").query(q, K)
    ix = ta.build_annoy_index(x, "cosine", n_trees=8, seed=0, device="cpu")
    ids, d = ix.query(q, K, n_probes=4, exact_fallback=False)
    assert _recall(ci.numpy(), ids) >= 0.9
    assert float(d.min()) >= -1e-5 and float(d.max()) <= 2.0
    x64, q64 = x.astype(np.float64), q.astype(np.float64)
    ix64 = ta.build_kd_tree_index(x64, n_trees=8, seed=0, device="cpu")
    i64, d64 = ix64.query(q64, K, n_probes=4, exact_fallback=False)
    assert d64.dtype == torch.float64
    ref = ((q64[:, None, :] - x64[i64.numpy()]) ** 2).sum(-1)
    np.testing.assert_allclose(d64.numpy(), ref, rtol=1e-12, atol=1e-12)


# -- the ball tree ---------------------------------------------------------------


@pytest.fixture(scope="module")
def jball(tdata):
    return jtrees.BallTreeIndex(tdata[0], seed=0)


def _ball_port(j):
    t = j.tree
    tree = {"order": np.asarray(t.order), "normals": [np.asarray(a) for a in t.normals],
            "thresholds": [np.asarray(a) for a in t.thresholds],
            "centers": [np.asarray(a) for a in t.centers],
            "radii": [np.asarray(a) for a in t.radii]}
    return interop.balltree_from_jax_arrays(np.asarray(j.vectors)[: j.n], tree, j.leaf,
                                            device="cpu")


@pytest.mark.parametrize("budget", [0.05, 0.3])
def test_ball_fused_route_matches_jax(tdata, jball, monkeypatch, budget):
    x, q, ti, _ = tdata
    monkeypatch.setattr(jtrees, "_BALL_FUSED_MIN_CELLS", 1)
    monkeypatch.setattr(ttrees, "_BALL_FUSED_MIN_CELLS", 1)
    jball._scan_cache = None
    port = _ball_port(jball)
    scan = port._scan_setup()
    assert scan is not None and scan["cell"] == 128 and int(scan["counts"].sum()) == 3000
    assert bool((scan["counts"].diff() <= 0).all())
    ids, d = port.query(q, K, budget=budget, exact_fallback=False)
    jids, jd = jball.query(q, K, budget=budget, exact_fallback=False)
    assert abs(_recall(ti, ids) - _recall(ti, jids)) <= BAND
    assert _shared_dists_agree(ids, d, jids, jd) >= 0.9
    full, _ = port.query(q, K, budget=1.0, exact_fallback=False)
    assert _recall(ti, full) > 0.999


def test_ball_gather_route_matches_jax(tdata, jball, monkeypatch):
    x, q, ti, _ = tdata
    monkeypatch.setenv("ANNSEARCH_NO_PALLAS", "1")
    jball._scan_cache = None
    port = _ball_port(jball)
    assert port._scan_setup() is None          # 24 cells < _BALL_FUSED_MIN_CELLS
    for budget in (0.05, 0.3):
        ids, d = port.query(q, K, budget=budget, exact_fallback=False)
        jids, jd = jball.query(q, K, budget=budget, exact_fallback=False)
        assert (ids.numpy() == np.asarray(jids)).mean() >= 0.99
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-4, atol=1e-4)


def test_ball_save_load_and_cosine(tdata, jball, tmp_path):
    x, q, _, _ = tdata
    jball.save(str(tmp_path / "ball"))
    port = ttrees.BallTreeIndex.load(str(tmp_path / "ball"), device="cpu")
    ref = _ball_port(jball)
    i1, d1 = port.query(q, K, exact_fallback=False)
    i2, d2 = ref.query(q, K, exact_fallback=False)
    assert torch.equal(i1, i2) and torch.equal(d1, d2)
    port.save(str(tmp_path / "ball2"))
    back = jtrees.BallTreeIndex.load(str(tmp_path / "ball2.npz"))
    np.testing.assert_array_equal(np.asarray(back.tree.order), np.asarray(jball.tree.order))
    ci, _ = ta.build_exhaustive_index(x, "cosine", device="cpu").query(q, K)
    cos = ta.build_balltree_index(x, "cosine", device="cpu")
    ids, _ = ta.query_balltree_index(q, cos, K, budget=0.3)
    assert _recall(ci.numpy(), ids) >= 0.9


def test_tree_exact_fallback(tdata, monkeypatch):
    """Small batches take one exact scan (the environment of the tests
    turns it off; removed here)."""
    monkeypatch.delenv("ANNSEARCH_NO_EXACT_FALLBACK", raising=False)
    x, q, ti, td = tdata
    for ix in (ta.build_annoy_index(x, n_trees=2, device="cpu"),
               ta.build_balltree_index(x, device="cpu")):
        ids, d = ix.query(q, K)
        np.testing.assert_array_equal(ids.numpy(), ti)
        np.testing.assert_allclose(d.numpy(), td, rtol=1e-5, atol=1e-5)


def test_tree_facade_rows(tdata):
    x, q, ti, _ = tdata
    for build, query, self_q in (
        (ta.build_annoy_index, ta.query_annoy_index, ta.query_annoy_self),
        (ta.build_kd_tree_index, ta.query_kd_tree_index, ta.query_kd_tree_self),
    ):
        ix = build(x[:1000], n_trees=4, seed=0, device="cpu")
        ids, none = query(q, ix, 5)
        assert none is None and ids.shape == (150, 5)
        si, sd = self_q(ix, 5, 2, None, True)
        assert (si[:, 0] == torch.arange(1000)).float().mean() >= 0.99
        assert float(sd[:, 0].abs().max()) < 1e-3
    b = ta.build_balltree_index(x[:1000], device="cpu")
    si, sd = ta.query_balltree_self(b, 5, 0.5, True)
    # a row whose own leaf centre ranks past the beam misses itself, in the
    # JAX package too (0.999 of rows find themselves there at this budget)
    assert si.shape == (1000, 5) and float((sd[:, 0] < 1e-3).float().mean()) >= 0.99
