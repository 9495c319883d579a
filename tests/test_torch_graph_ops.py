"""The port's graph operations (``ops/graph.py``) against the JAX package on
one graph: ``_row_dedup_inf``, ``cagra_prune``, ``add_reverse_edges`` and
``beam_search``.

The JAX package builds the kNN graph, the navigable graph and the entry
sets; both packages then prune or walk the same arrays. On grid inputs
(multiples of 1/8) every pair distance is exact in both, so the pruned
graphs are equal; on clustered data the JAX three-term split and the
port's FP32 dots differ in the last bits, and edges whose detour test sits
within rounding may flip (≥ 0.99 of edges equal). The JAX beam search
scores from its packed neighbour table, as its own CPU tests run it; its
bitonic networks order equal distances differently from a stable sort, so
the walks are compared by recall against one exact truth (within 0.01) and
by distances on shared ids (within 1e-4·(1 + d)), not id by id."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from annsearch_tpu.models.graph import NNDescentIndex as JNNDescent
from annsearch_tpu.ops import graph as jgraph
from annsearch_tpu.utils.dist import Dist as JDist
from annsearch_tpu_torch.models.exhaustive import ExhaustiveIndex
from annsearch_tpu_torch.ops.graph import (
    _next_pow2,
    _reverse_sample,
    _row_dedup_inf,
    add_reverse_edges,
    beam_search,
    cagra_prune,
)
from annsearch_tpu_torch.utils.data import generate_clustered_data, subsample_with_noise
from annsearch_tpu_torch.utils.dist import Dist
from annsearch_tpu_torch.utils.metrics import calculate_recall

torch.set_num_threads(2)

METRICS = {"euclidean": (Dist.EUCLIDEAN, JDist.EUCLIDEAN), "cosine": (Dist.COSINE, JDist.COSINE)}
K, BEAM, ITERS, EXPAND = 10, 32, 12, 4


def _t(a, dtype=None):
    t = torch.tensor(np.asarray(a))
    return t if dtype is None else t.to(dtype)


def test_row_dedup_keeps_one_copy():
    ids = torch.tensor([[3, 1, 3, 2, 1]])
    d = torch.tensor([[0.1, 0.2, 0.3, 0.4, 0.5]])
    out = _row_dedup_inf(ids, d)
    assert out[0].tolist() == [pytest.approx(0.1), pytest.approx(0.2), float("inf"),
                               pytest.approx(0.4), float("inf")]


@pytest.mark.parametrize("width", [40, 128, 200])
def test_row_dedup_equals_jax(width):
    """The all-pairs path (C ≤ 128) and the sorting path (wider) both keep
    the first copy, as the JAX function's two paths do."""
    rng = np.random.default_rng(width)
    ids = rng.integers(0, width // 2, (6, 3, width)).astype(np.int32)
    d = rng.random((6, 3, width)).astype(np.float32)
    out = _row_dedup_inf(_t(ids, torch.long), _t(d))
    ref = np.asarray(jgraph._row_dedup_inf(jnp.asarray(ids), jnp.asarray(d)))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert np.isinf(ref).any() and np.isfinite(ref).any()


def test_next_pow2():
    assert [_next_pow2(v) for v in (0, 1, 2, 3, 32, 33, 100)] == [1, 1, 2, 4, 32, 64, 128]


def _grid_data():
    rng = np.random.default_rng(21)
    return (rng.integers(-16, 17, (600, 16)) / 8).astype(np.float32)


def _clustered_data():
    return generate_clustered_data(900, 24, 6, seed=2)[0] / np.float32(8)


# (normalised rows leave the grid: cosine has the clustered case only)
@pytest.mark.parametrize("metric,data,floor", [
    ("euclidean", "grid", 1.0), ("euclidean", "clustered", 0.99), ("cosine", "clustered", 0.99),
])
def test_cagra_prune_on_a_jax_graph(metric, data, floor):
    x = _grid_data() if data == "grid" else _clustered_data()
    tm, jm = METRICS[metric]
    j = JNNDescent(x, metric, k=8, seed=0)
    ref = np.asarray(jgraph.cagra_prune(j.vectors, j.sqnorms, j.knn_ids, j.knn_dists, 8, jm))
    out = cagra_prune(_t(j.vectors), _t(j.sqnorms), _t(j.knn_ids), _t(j.knn_dists), 8, tm,
                      tile=256)
    assert out.shape == ref.shape and out.dtype == torch.int32
    assert (out.numpy() == ref).mean() >= floor
    # every kept edge is one of the node's own neighbours, none twice
    kn = np.asarray(j.knn_ids)
    assert all(set(o) <= set(r) and len(set(o)) == len(o) for o, r in zip(out.numpy(), kn))
    # the tile changes no result
    assert torch.equal(out, cagra_prune(_t(j.vectors), _t(j.sqnorms), _t(j.knn_ids),
                                        _t(j.knn_dists), 8, tm, tile=4096))


def test_add_reverse_edges():
    rng = np.random.default_rng(3)
    n, deg, extra = 500, 6, 4
    graph = torch.tensor(rng.integers(0, n, (n, deg)).astype(np.int32))
    graph[7, 2] = n                                   # an empty slot
    a = add_reverse_edges(torch.Generator().manual_seed(5), graph, n, extra)
    b = add_reverse_edges(torch.Generator().manual_seed(5), graph, n, extra)
    c = add_reverse_edges(torch.Generator().manual_seed(6), graph, n, extra)
    assert a.shape == (n, deg + extra) and a.dtype == torch.int32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(a[:, :deg], graph)
    rev = a[:, deg:].numpy()
    g = graph.numpy()
    filled = 0
    for v in range(n):
        for u in rev[v]:
            if u < n:                                 # a real edge u → v, reversed
                assert v in g[u]
                filled += 1
    assert filled > n * extra * 0.5 and (rev <= n).all()


def test_reverse_sample_collision_rule():
    """All edges point at node 0 and there is one slot: the edge with the
    largest position u·kk + column wins, whatever the draw."""
    graph = torch.zeros((9, 2), dtype=torch.int32)
    rev = _reverse_sample(torch.Generator().manual_seed(0), graph, 9, 1)
    assert rev[0, 0] == 8 and (rev[1:] == 9).all()


@pytest.fixture(scope="module", params=["euclidean", "cosine"])
def walk(request):
    """One JAX index (graph, routers, nav graph, packed table), its entry
    sets for 120 queries, the exact truth, and the JAX beam search's result
    with its trail."""
    metric = request.param
    x = generate_clustered_data(2000, 24, 6, seed=4)[0] / np.float32(8)
    q = subsample_with_noise(x, 120, seed=4)
    j = JNNDescent(x, metric, k=K, seed=0)
    j._ensure_nav()
    j._ensure_packed()
    qj = j._prep_queries(q)
    entries = j._route_entries(qj, 8)
    jm = METRICS[metric][1]
    jd, ji, jtd, jti = jgraph.beam_search(
        qj, j.vectors, j.sqnorms, j.nav_graph, entries, K, BEAM, ITERS, jm, EXPAND,
        packed_nbrs=j._packed_nbrs, return_trail=True)
    truth = ExhaustiveIndex(x, metric, device="cpu").query(q, K)[0]
    args = (_t(qj), _t(j.vectors), _t(j.sqnorms), _t(j.nav_graph), _t(entries))
    return dict(metric=METRICS[metric][0], args=args, truth=truth, n=2000,
                jax=tuple(np.asarray(a) for a in (jd, ji, jtd, jti)))


def test_beam_search_against_jax(walk):
    d, ids = beam_search(*walk["args"], K, BEAM, ITERS, walk["metric"], EXPAND)
    jd, ji = walk["jax"][:2]
    n = walk["n"]
    assert d.shape == (120, K) and ids.dtype == torch.int64
    assert (d.diff(dim=1) >= 0).all()
    r_port = calculate_recall(walk["truth"], ids, K)
    r_jax = calculate_recall(walk["truth"], np.array(ji), K)
    assert r_port > 0.9 and abs(r_port - r_jax) <= 0.01
    # distances of the ids both returned
    shared = ids.numpy()[:, :, None] == ji[:, None, :]
    dp = np.broadcast_to(d.numpy()[:, :, None], shared.shape)[shared]
    dj = np.broadcast_to(jd[:, None, :], shared.shape)[shared]
    assert shared.any(axis=2).mean() > 0.95
    assert np.all(np.abs(dp - dj) <= 1e-4 * (1.0 + dj))
    # reached slots hold real ids
    assert ((ids < n) == torch.isfinite(d)).all()


def test_beam_search_trail(walk):
    d, ids, td, ti = beam_search(*walk["args"], K, BEAM, ITERS, walk["metric"], EXPAND,
                                 return_trail=True)
    n = walk["n"]
    assert td.shape == ti.shape == (120, ITERS * EXPAND)
    d0, ids0 = beam_search(*walk["args"], K, BEAM, ITERS, walk["metric"], EXPAND)
    assert torch.equal(d, d0) and torch.equal(ids, ids0)
    # only expanded nodes: each at most once, with its distance to the query;
    # exhausted slots are (n, inf)
    q, vectors = walk["args"][0], walk["args"][1]
    for row in range(0, 120, 7):
        real = ti[row][ti[row] < n]
        assert len(set(real.tolist())) == len(real)
    assert ((ti == n) == torch.isinf(td)).all()
    rows = vectors[ti.clamp(max=n)]
    if walk["metric"] == Dist.COSINE:
        ref = 1.0 - (rows * q[:, None, :]).sum(-1)
    else:
        ref = ((rows - q[:, None, :]) ** 2).sum(-1)
    ok = ti < n
    assert torch.all((td[ok] - ref[ok]).abs() <= 1e-4 * (1.0 + ref[ok]))
    # the first `expand` expansions are the best entries; the best result is
    # itself expanded unless the walk was cut
    assert torch.equal(td[:, 0], td[:, :EXPAND].min(dim=1).values)
    # the JAX walk expands much the same nodes
    jti = walk["jax"][3]
    assert (ti.numpy() == jti).mean() > 0.9


def test_beam_search_early_exit_and_sentinels(walk):
    """Far past convergence the result no longer changes; a beam wider
    than the reachable set leaves (n, inf) in the unreached slots."""
    args, metric = walk["args"], walk["metric"]
    a = beam_search(*args, K, 16, 60, metric, EXPAND)
    b = beam_search(*args, K, 16, 600, metric, EXPAND)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    # a graph of 4 nodes in a ring, beam 8: 4 real results, then sentinels
    v = torch.tensor([[0.0, 0], [1, 0], [1, 1], [0, 1], [0, 0]])
    sq = (v * v).sum(1)
    ring = torch.tensor([[1, 3], [2, 0], [3, 1], [0, 2], [4, 4]], dtype=torch.int32)
    qd, qi = beam_search(torch.tensor([[0.1, 0.0]]), v, sq, ring, torch.tensor([[2]]), 6, 8, 20,
                         Dist.EUCLIDEAN, expand=1)
    assert qi[0].tolist() == [0, 1, 3, 2, 4, 4]
    assert torch.isinf(qd[0, 4:]).all() and torch.isfinite(qd[0, :4]).all()
    with pytest.raises(ValueError, match="beam"):
        beam_search(torch.tensor([[0.1, 0.0]]), v, sq, ring, torch.tensor([[2]]), 9, 8, 20,
                    Dist.EUCLIDEAN)


# -- _merge_rows and random_init_graph (the Vamana build's pool) --------------


@pytest.mark.parametrize("widths", [(20, 12), (48, 32), (96, 48)])
def test_merge_rows_equals_jax(widths):
    """Duplicates keep their first copy and the k smallest stay, ties to the
    earlier column: equal to the JAX function, on tie-heavy rows (both
    dedup paths: at most 128 and wider)."""
    from annsearch_tpu_torch.ops.graph import _merge_rows

    ka, kb = widths
    rng = np.random.default_rng(ka)
    ids_a = rng.integers(0, 60, (40, ka)).astype(np.int32)
    ids_b = rng.integers(0, 60, (40, kb)).astype(np.int32)
    d_a = np.sort(rng.integers(0, 9, (40, ka)) / 4, axis=1).astype(np.float32)
    d_b = (rng.integers(0, 9, (40, kb)) / 4).astype(np.float32)
    d_a[:, -3:] = np.inf
    k = (ka + kb) // 2
    ji, jd = jgraph._merge_rows(jnp.asarray(ids_a), jnp.asarray(d_a), jnp.asarray(ids_b),
                                jnp.asarray(d_b), k)
    ti, td = _merge_rows(_t(ids_a), _t(d_a), _t(ids_b), _t(d_b), k)
    assert ti.dtype == torch.int32 and ti.shape == (40, k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_random_init_graph_scores_the_jax_draw(metric):
    """The port's scoring of the JAX package's own candidate draw (re-drawn
    here by ``jax.random.randint``) against the JAX ``random_init_graph``:
    the same id sets, self and repeated ids last as ``(n, inf)``. The port's
    distances (one FP32 product) lie within 1e-5·(1 + |d|) of f64; the JAX
    package sums a two-way bf16 split, about 16 bits of each operand, whose
    own error against f64 is ten times that here (‖x‖² up to 15), so the
    two agree within 1e-5·(1 + |d|) beyond the JAX distance's own f64
    error."""
    import jax

    from annsearch_tpu_torch.ops.graph import random_candidates, score_candidates

    tm, jm = METRICS[metric]
    x = _clustered_data()
    j = JNNDescent(x[:10], metric, k=4, seed=0)      # for the metric's row prep
    rows = np.asarray(j._prep_queries(x)) if metric == "cosine" else x
    vecs = np.concatenate([rows, np.zeros((1, rows.shape[1]), np.float32)])
    sq = (vecs.astype(np.float64) ** 2).sum(1).astype(np.float32)
    n, kk = vecs.shape[0] - 1, 24
    key = jax.random.key(7)
    ji, jd = (np.asarray(a) for a in jgraph.random_init_graph(
        key, jnp.asarray(vecs), jnp.asarray(sq), kk, jm))
    cand = np.asarray(jax.random.randint(key, (-(-n // 1024) * 1024, kk), 0, n))[:n]
    ti, td = score_candidates(_t(vecs), _t(sq), _t(cand), tm)
    ti, td = ti.numpy(), td.numpy()
    assert ti.dtype == np.int32 and ti.shape == (n, kk)
    np.testing.assert_array_equal(np.isinf(td), np.isinf(jd))
    np.testing.assert_array_equal(np.sort(ti, axis=1), np.sort(ji, axis=1))
    assert (ti == ji).mean() > 0.999
    fin = np.isfinite(jd)
    x64 = vecs.astype(np.float64)
    u = np.repeat(np.arange(n)[:, None], kk, 1)

    def f64(ids):
        a, b = x64[u], x64[np.minimum(ids, n)]
        if metric == "cosine":
            return 1.0 - (a * b).sum(-1)
        return ((a - b) ** 2).sum(-1)

    tol = 1e-5 * (1.0 + np.abs(jd[fin]))
    assert np.all(np.abs(td[fin] - f64(ti)[fin]) <= tol)
    assert np.all(np.abs(td[fin] - jd[fin]) <= tol + np.abs(jd - f64(ji))[fin])
    assert (ti[~fin] == n).all() and np.isinf(td).any()
    # the draw: from a CPU generator, in range, one seed one graph
    c1 = random_candidates(torch.Generator().manual_seed(3), n, kk, "cpu")
    c2 = random_candidates(torch.Generator().manual_seed(3), n, kk, "cpu")
    assert torch.equal(c1, c2) and c1.shape == (n, kk) and 0 <= c1.min() and c1.max() < n
