"""The port's approximate graph build (``ops/graph.py``: ``kmeans_leaves``,
``leaf_join_merge``, ``rp_forest_round``, ``_reverse_sample``,
``nnd_round``, ``nnd_round_chunked``, ``diversify_graph``; and
``models/graph.approx_knn_graph`` through ``NNDescentIndex``, ``HnswIndex``
and ``VamanaIndex``) against the JAX package.

torch cannot repeat JAX's key streams, so each function takes the JAX
draws: the projection vectors, the reverse tables ``rev`` / ``rev2`` (the
two packages resolve slot collisions by their own rules), the per-tile
block-selection noise laid out by row, and the occlusion uniforms. On grid
inputs (multiples of 1/8, small) every distance is exact in both packages
(the JAX two-way split and the port's FP32), so those calls agree exactly:
ids, distances, update counts and flags. Where a projection decides an
order (a normal vector's sums round differently) rows are compared by the
share that is equal (≥ 0.99). Whole builds draw their own streams and are
compared by recall against one exact truth: at least 0.95, within 0.01 of
the JAX build's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from annsearch_tpu.models import graph as jmg
from annsearch_tpu.ops import graph as jgraph
from annsearch_tpu.utils.dist import Dist as JDist
from annsearch_tpu_torch.models import graph as tmg
from annsearch_tpu_torch.models import hnsw as thnsw
from annsearch_tpu_torch.models.hnsw import HnswIndex
from annsearch_tpu_torch.models.vamana import VamanaIndex
from annsearch_tpu_torch.ops import graph as tgraph
from annsearch_tpu_torch.utils.data import generate_clustered_data
from annsearch_tpu_torch.utils.dist import Dist, sq_norms
from annsearch_tpu_torch.utils.metrics import calculate_recall

torch.set_num_threads(2)

METRICS = {"euclidean": (Dist.EUCLIDEAN, JDist.EUCLIDEAN), "cosine": (Dist.COSINE, JDist.COSINE)}


def _t(a, dtype=None):
    t = torch.tensor(np.asarray(a))
    return t if dtype is None else t.to(dtype)


def _grid(n, d, seed):
    """Rows on a grid of 1/8 in [-2, 2] with a zero sentinel row: bf16
    holds them exactly and every dot and norm sums exactly in f32."""
    x = np.random.default_rng(seed).integers(-16, 17, size=(n, d)).astype(np.float32) / 8
    return np.concatenate([x, np.zeros((1, d), np.float32)])


def _both(xp):
    """``(torch rows, torch norms, JAX rows, JAX norms)`` of ``xp``."""
    return _t(xp), sq_norms(_t(xp)), jnp.asarray(xp), jnp.sum(jnp.asarray(xp) ** 2, axis=1)


@pytest.fixture(scope="module")
def grid_graph():
    """Grid rows (2,000 × 8), a JAX random init graph (kk 8) on them."""
    n, d, kk = 2000, 8, 8
    xp = _grid(n, d, 0)
    xt, st, xj, sj = _both(xp)
    ji, jd = jgraph.random_init_graph(jax.random.key(1), xj, sj, kk, JDist.EUCLIDEAN)
    return dict(n=n, kk=kk, xt=xt, st=st, xj=xj, sj=sj, ji=ji, jd=jd,
                ti=_t(ji), td=_t(jd))


@pytest.mark.parametrize("jth", [0, 1, 2])
def test_kmeans_leaves_on_the_jax_centroids_and_projection(jth):
    """Cells by one bf16 pass (both operands rounded, f32 sums): on grid
    rows the cells are exact in both packages, so the leaves hold the same
    rows; inside a cell the projection orders them (≥ 0.99 of slots equal)."""
    n, d, nc, leaf = 3000, 8, 24, 32
    xp = _grid(n, d, 1)
    cents = np.random.default_rng(2).integers(-12, 13, size=(nc, d)).astype(np.float32) / 8
    key = jax.random.key(7)
    jl = np.asarray(jgraph.kmeans_leaves(key, jnp.asarray(xp), jnp.asarray(cents), jth, leaf,
                                         JDist.EUCLIDEAN, tile=1024))
    proj = _t(jax.random.normal(key, (d,), jnp.float32))
    tl = tgraph.kmeans_leaves(None, _t(xp), _t(cents), jth, leaf, Dist.EUCLIDEAN,
                              proj=proj).numpy()
    assert tl.shape == jl.shape == (-(-n // leaf), leaf)
    real = tl[tl < n]
    assert sorted(real.tolist()) == list(range(n)) and (tl.reshape(-1)[n:] >= n).all()
    assert (tl == jl).mean() >= 0.99
    # every leaf holds the same rows up to the projection order at the leaf's edges
    assert np.mean([len(set(a) & set(b)) / leaf for a, b in zip(tl, jl)]) >= 0.99


def test_leaf_join_merge_equals_jax(grid_graph):
    """One leaf partition joined into the JAX random graph: exact on grid
    rows, so ids and distances are equal; pads (a whole leaf of them and a
    ragged one) are dropped."""
    g = grid_graph
    n = g["n"]
    perm = np.random.default_rng(3).permutation(n).astype(np.int32)
    leaves = np.concatenate([perm, np.full(2048 - n, n, np.int32)]).reshape(-1, 64)
    ji, jd = jgraph.leaf_join_merge(jnp.asarray(leaves), g["xj"], g["sj"], g["ji"], g["jd"],
                                    g["kk"], JDist.EUCLIDEAN)
    ti, td = tgraph.leaf_join_merge(_t(leaves), g["xt"], g["st"], g["ti"], g["td"], g["kk"],
                                    Dist.EUCLIDEAN)
    assert torch.equal(ti, _t(ji)) and torch.equal(td, _t(jd))
    assert not torch.equal(ti, g["ti"])                  # the join did something


def test_rp_forest_round_on_the_jax_projections(grid_graph):
    """The JAX pass's projection vectors carried across: the sort by
    (group, projection) gives the same leaves up to rows whose projections
    round apart, so ≥ 0.99 of rows are equal, and distances on equal rows
    are equal."""
    g = grid_graph
    levels, leaf = 5, 64
    key = jax.random.key(5)
    projs = jnp.stack([jax.random.normal(k, (8,), jnp.float32)
                       for k in jax.random.split(key, levels)])
    ji, jd = jgraph.rp_forest_round(key, g["xj"], g["sj"], g["ji"], g["jd"], levels, leaf,
                                    g["kk"], JDist.EUCLIDEAN)
    ti, td = tgraph.rp_forest_round(None, g["xt"], g["st"], g["ti"], g["td"], levels, leaf,
                                    g["kk"], Dist.EUCLIDEAN, projs=_t(projs))
    same = (ti == _t(ji)).all(dim=1)
    assert same.float().mean() >= 0.99
    assert torch.equal(td[same], _t(jd)[same])


def test_reverse_sample_filters_equal_jax_on_its_slots():
    """On the JAX slot draw the port's tables equal the JAX CPU tables in
    all three forms (every edge, the new ones, the old ones of rows with a
    new one): a colliding slot keeps the largest edge position in both."""
    n, kk, r = 500, 6, 8
    rng = np.random.default_rng(4)
    gids = rng.integers(0, n + 1, size=(n, kk)).astype(np.int32)     # n: an empty slot
    flags = rng.random((n, kk)) < 0.3
    flags[:50] = False                                               # rows with no new edge
    key = jax.random.key(9)
    slot = _t(jax.random.randint(jax.random.fold_in(key, 0), (n * kk,), 0, r))
    for new_in, invert in ((None, False), (flags, False), (flags, True)):
        j = jgraph._reverse_sample(key, jnp.asarray(gids), n, r,
                                   new_in=None if new_in is None else jnp.asarray(new_in),
                                   invert=invert)
        t = tgraph._reverse_sample(None, _t(gids), n, r,
                                   new_in=None if new_in is None else _t(new_in),
                                   invert=invert, slot=slot)
        assert torch.equal(t, _t(j))


def _jax_round_draws(key, ji, flags, n, kk, tile):
    """The JAX round's reverse tables and its per-tile noise laid out by
    row (``fold_in(k_fof, first row of the tile)``), as ``nnd_round``
    draws them."""
    k_rev, k_fof = jax.random.split(key)
    fl = None if flags is None else jnp.asarray(flags)
    rev = jgraph._reverse_sample(k_rev, ji, n, tgraph.NND_R_NEW, new_in=fl)
    if flags is None:
        return rev, None, None
    rev2 = jgraph._reverse_sample(jax.random.fold_in(k_rev, 1), ji, n, tgraph.NND_R_OLD,
                                  new_in=fl, invert=True)
    base_w = kk + tgraph.NND_R_NEW + tgraph.NND_R_OLD
    noise = jnp.concatenate([jax.random.uniform(jax.random.fold_in(k_fof, t0), (tile, base_w))
                             for t0 in range(0, n, tile)])[:n]
    return rev, rev2, noise


@pytest.mark.parametrize("mode", ["full", "sampled", "unflagged"])
def test_nnd_round_equals_jax_on_its_draws(grid_graph, mode):
    """One round on the JAX rev / rev2 / noise: on grid rows every
    candidate's distance is exact in both packages and every tie breaks to
    the earlier column in both, so ids, distances, the update count and the
    flags are equal. Flags: all new, then a random third; ``sampled``
    expands 4 blocks a row; ``unflagged`` every block without flags."""
    g = grid_graph
    n, kk, tile = g["n"], g["kk"], 256
    rng = np.random.default_rng(6)
    flags = None if mode == "unflagged" else (rng.random((n, kk)) < 0.35)
    c_act = None if flags is None else ((kk + 24) if mode == "full" else 4) * kk
    key = jax.random.key(11)
    rev, rev2, noise = _jax_round_draws(key, g["ji"], flags, n, kk, tile)
    fl = None if flags is None else jnp.asarray(flags)
    j = jgraph.nnd_round(key, g["xj"], g["sj"], g["ji"], g["jd"], kk, JDist.EUCLIDEAN,
                         tile=tile, new_in=fl, c_active=c_act)
    t = tgraph.nnd_round(None, g["xt"], g["st"], g["ti"], g["td"], kk, Dist.EUCLIDEAN,
                         tile=96, new_in=None if flags is None else _t(flags), c_active=c_act,
                         rev=_t(rev), rev2=None if rev2 is None else _t(rev2),
                         noise=None if noise is None else _t(noise))
    assert torch.equal(t[0], _t(j[0])) and torch.equal(t[1], _t(j[1]))
    assert int(t[2]) == int(j[2]) > 0
    assert torch.equal(t[3], _t(j[3]))


def test_nnd_round_unflagged_fof_sample_improves(grid_graph):
    """Without flags, ``fof_sample`` keeps that many random candidate
    columns (drawn from the generator): the round still improves the graph,
    and keeps its rows ascending without self edges."""
    g = grid_graph
    before = g["td"][torch.isfinite(g["td"])].mean()
    ids, d, upd, _ = tgraph.nnd_round(torch.Generator().manual_seed(3), g["xt"], g["st"],
                                      g["ti"], g["td"], g["kk"], Dist.EUCLIDEAN, tile=128,
                                      fof_sample=40)
    assert d[torch.isfinite(d)].mean() < before and int(upd) > 0
    assert (d.diff(dim=1) >= 0).all()
    assert (ids.long() != torch.arange(g["n"])[:, None]).all()


def test_nnd_round_chunked_equals_one_call():
    """Jacobi chunks (1,024 rows, a ragged tail) equal one round bit for
    bit: every chunk reads the round-start snapshot and the noise is drawn
    by row."""
    n, d, kk = 3000, 16, 8
    g = torch.Generator().manual_seed(0)
    x = torch.cat([torch.randn((n, d), generator=g), torch.zeros((1, d))])
    sq = sq_norms(x)
    ids, dists = tgraph.random_init_graph(torch.Generator().manual_seed(1), x, sq, kk,
                                          Dist.EUCLIDEAN)
    flags = torch.ones((n, kk), dtype=torch.bool)
    c_act = (kk + 16) * kk
    a = tgraph.nnd_round(torch.Generator().manual_seed(2), x, sq, ids, dists, kk,
                         Dist.EUCLIDEAN, tile=256, new_in=flags, c_active=c_act)
    b = tgraph.nnd_round_chunked(torch.Generator().manual_seed(2), x, sq, ids, dists, kk,
                                 Dist.EUCLIDEAN, tile=256, new_in=flags, c_active=c_act,
                                 row_chunk=1024)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and torch.equal(a[3], b[3])
    assert int(a[2]) == int(b[2]) > 0


def test_nnd_round_chunked_in_place_improves(monkeypatch):
    """From ``NND_INPLACE_MIN_N`` rows the chunks merge in place
    (Gauss-Seidel): three rounds still improve the graph, and the inputs
    are left as they were."""
    monkeypatch.setattr(tgraph, "NND_INPLACE_MIN_N", 1000)
    n, d, kk = 3000, 16, 8
    g = torch.Generator().manual_seed(0)
    x = torch.cat([torch.randn((n, d), generator=g), torch.zeros((1, d))])
    sq = sq_norms(x)
    gen = torch.Generator().manual_seed(1)
    ids, dists = tgraph.random_init_graph(gen, x, sq, kk, Dist.EUCLIDEAN)
    ids0, d0 = ids.clone(), dists.clone()
    before = dists[torch.isfinite(dists)].mean()
    flags = torch.ones((n, kk), dtype=torch.bool)
    i1, d1, u1, f1 = tgraph.nnd_round_chunked(gen, x, sq, ids, dists, kk, Dist.EUCLIDEAN,
                                              tile=256, new_in=flags,
                                              c_active=(kk + 24) * kk, row_chunk=1024)
    assert torch.equal(ids, ids0) and torch.equal(dists, d0) and bool(flags.all())
    for _ in range(2):
        i1, d1, u1, f1 = tgraph.nnd_round_chunked(gen, x, sq, i1, d1, kk, Dist.EUCLIDEAN,
                                                  tile=256, new_in=f1,
                                                  c_active=(kk + 24) * kk, row_chunk=1024)
    assert d1[torch.isfinite(d1)].mean() < before
    assert i1.shape == (n, kk) and int(u1) > 0
    assert (d1.diff(dim=1) >= 0).all()


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_diversify_graph_equals_jax_on_its_uniforms(metric):
    """The JAX uniforms (one key per tile of 256 rows) carried across: on
    grid rows the pair distances are exact, so the kept sets are equal.
    (Cosine takes the rows as they are, scaled by 1/8 so that ``1 − dot``
    stays positive, as it is between unit rows.)"""
    tm, jm = METRICS[metric]
    n, d, kk, prob = 700, 8, 10, 0.6
    xp = _grid(n, d, 8) / np.float32(8 if metric == "cosine" else 1)
    xt, st, xj, sj = _both(xp)
    dm = jgraph.random_init_graph(jax.random.key(0), xj, sj, 40, jm)    # a pool to sort
    gi = np.asarray(dm[0])[:, :kk]
    gd = np.asarray(dm[1])[:, :kk]
    key = jax.random.key(12)
    j = jgraph.diversify_graph(key, xj, sj, jnp.asarray(gi), jnp.asarray(gd), prob, jm)
    keys = jax.random.split(key, -(-n // 256))
    rand = jnp.concatenate([jax.random.uniform(k, (256, kk, kk)) for k in keys])[:n]
    t = tgraph.diversify_graph(None, xt, st, _t(gi), _t(gd), prob, tm, rand=_t(rand))
    assert torch.equal(t[0], _t(j[0])) and torch.equal(t[1], _t(j[1]))
    kept = (t[0] < n).float().mean()
    assert 0.2 < kept < 0.99


def _truth(x, k):
    """The exact f64 top-k of every row, self excluded."""
    xd = x.astype(np.float64)
    sq = (xd * xd).sum(1)
    dm = sq[:, None] + sq[None, :] - 2.0 * (xd @ xd.T)
    np.fill_diagonal(dm, np.inf)
    return np.argsort(dm, 1)[:, :k]


@pytest.fixture(scope="module")
def forced_data():
    """``tests/test_graph.py``'s forced build shape: 6,000 × 16, 20
    clusters, k 10, and its exact f64 top-10."""
    x, _ = generate_clustered_data(6000, 16, 20, seed=9)
    return x, _truth(x, 10)


def test_forced_build_matches_the_jax_build(forced_data, monkeypatch):
    """Both packages' approximate builds (the budget patched to 0) at
    recall@10 ≥ 0.95, the port within 0.01 of the JAX build; with
    ``refine_rounds=1`` the port's graph is no worse."""
    x, gt = forced_data
    monkeypatch.setattr(jmg, "BRUTE_BUILD_FLOP_BUDGET", 0)
    monkeypatch.setattr(tmg, "BRUTE_BUILD_FLOP_BUDGET", 0)
    j = jmg.NNDescentIndex(x, k=10, n_trees=4, max_rounds=10, seed=3)
    rj = calculate_recall(gt, np.array(j.knn_ids)[:, :10], 10)
    t = tmg.NNDescentIndex(x, k=10, n_trees=4, max_rounds=10, seed=3, device="cpu")
    rt = calculate_recall(gt, t.knn_ids[:, :10].long(), 10)
    assert rt >= 0.95 and abs(rt - rj) <= 0.01, (rt, rj)
    assert t.knn_ids.shape == (6000, 20) and (t.knn_dists.diff(dim=1) >= 0).all()
    r = tmg.NNDescentIndex(x, k=10, n_trees=4, max_rounds=10, seed=3, refine_rounds=1,
                           device="cpu")
    assert calculate_recall(gt, r.knn_ids[:, :10].long(), 10) >= rt - 0.001


def test_forced_build_cosine_and_sentinel(forced_data, monkeypatch):
    """The cosine build reaches recall ≥ 0.95 against the f64 cosine truth;
    a sentinel-padded table gives the build of the plain one."""
    x, _ = forced_data
    x = x[:3000]
    monkeypatch.setattr(tmg, "BRUTE_BUILD_FLOP_BUDGET", 0)
    t = tmg.NNDescentIndex(x, "cosine", k=10, max_rounds=10, seed=3, device="cpu")
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    sim = xn.astype(np.float64) @ xn.T.astype(np.float64)
    np.fill_diagonal(sim, -np.inf)
    gt = np.argsort(-sim, 1)[:, :10]
    assert calculate_recall(gt, t.knn_ids[:, :10].long(), 10) >= 0.95
    a = tmg.NNDescentIndex(x, k=5, max_rounds=3, seed=1, device="cpu")
    b = tmg.NNDescentIndex(np.concatenate([x, np.zeros((1, 16), np.float32)]), k=5,
                           max_rounds=3, seed=1, has_sentinel=True, device="cpu")
    assert torch.equal(a.knn_ids, b.knn_ids) and torch.equal(a.knn_dists, b.knn_dists)


def test_refine_rounds_ignored_below_the_budget(forced_data):
    """Below the budget the graph is exact and ``refine_rounds`` changes
    nothing, as in the JAX package."""
    x = forced_data[0][:1500]
    a = tmg.NNDescentIndex(x, k=8, seed=0, device="cpu")
    b = tmg.NNDescentIndex(x, k=8, seed=0, refine_rounds=2, device="cpu")
    assert torch.equal(a.knn_ids, b.knn_ids) and torch.equal(a.knn_dists, b.knn_dists)


def test_diversify_below_the_budget_as_jax(forced_data):
    """``diversify_prob`` below the budget: the JAX index's exact graph
    diversified by the port on the JAX index's uniforms equals the JAX
    index's result (the exact graphs equal, the pair tests within
    rounding: ≥ 0.99 of rows); the port's own index keeps a share of edges
    within 0.02 of the JAX index's."""
    x = forced_data[0][:1200] / np.float32(8)
    prob = 0.5
    j0 = jmg.NNDescentIndex(x, k=8, seed=4)
    j1 = jmg.NNDescentIndex(x, k=8, seed=4, diversify_prob=prob)
    _, kd = jax.random.split(jax.random.key(4))
    keys = jax.random.split(kd, -(-1200 // 256))
    kk = j0.k_build
    rand = jnp.concatenate([jax.random.uniform(k, (256, kk, kk)) for k in keys])[:1200]
    xt = _t(np.asarray(j0.vectors))
    ti, td = tgraph.diversify_graph(None, xt, sq_norms(xt), _t(j0.knn_ids), _t(j0.knn_dists),
                                    prob, Dist.EUCLIDEAN, rand=_t(rand))
    assert (ti == _t(j1.knn_ids)).all(dim=1).float().mean() >= 0.99
    t1 = tmg.NNDescentIndex(x, k=8, seed=4, diversify_prob=prob, device="cpu")
    share_j = float(np.mean(np.asarray(j1.knn_ids) < 1200))
    share_t = float((t1.knn_ids < 1200).float().mean())
    assert abs(share_j - share_t) <= 0.02 and share_t < 1.0


def test_one_patch_forces_hnsw_and_vamana(forced_data, monkeypatch):
    """Patching ``models.graph.BRUTE_BUILD_FLOP_BUDGET`` alone sends the
    HNSW base and upper layers and Vamana's pool through
    ``approx_knn_graph`` (2 and 8, 1 and 4, Vamana's own ``n_trees`` and
    ``max_rounds``); both answer at recall@10 ≥ 0.9 against f64."""
    x, gt = forced_data
    x, gt = x[:3000], _truth(x[:3000], 10)
    calls = []
    real = tmg.approx_knn_graph

    def spy(gen, vecs, sq, kk, metric, **kw):
        calls.append((vecs.shape[0] - 1, kk, kw["n_trees"], kw["max_rounds"]))
        return real(gen, vecs, sq, kk, metric, **kw)

    monkeypatch.setattr(tmg, "approx_knn_graph", spy)
    monkeypatch.setattr(thnsw, "EXACT_LAYER_MAX", 100)
    monkeypatch.setattr(tmg, "BRUTE_BUILD_FLOP_BUDGET", 0)
    h = HnswIndex(x, m=8, seed=0, device="cpu")
    assert calls[0] == (3000, 50, 2, 8) and all(c[2:] == (1, 4) for c in calls[1:])
    ids, _ = h.query(x[:300], 10, ef_search=64, exact_fallback=False)
    assert calculate_recall(np.concatenate([np.arange(300)[:, None], gt[:300, :9]], 1),
                            ids, 10) >= 0.9
    calls.clear()
    v = VamanaIndex(x, r_degree=16, n_trees=3, max_rounds=5, seed=0, device="cpu")
    assert calls == [(3000, 48, 3, 5)]
    ids, _ = v.query(x[:300], 10, exact_fallback=False)
    assert calculate_recall(np.concatenate([np.arange(300)[:, None], gt[:300, :9]], 1),
                            ids, 10) >= 0.9
