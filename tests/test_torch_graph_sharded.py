"""The port's sharded graph index (``parallel/graph_sharded.py``) against the
JAX package's on its 8-device CPU mesh, at P = 8 logical shards, on the JAX
tests' 800 × 16d data.

* ``ring_self_knn`` equals JAX's, and a brute-force self-kNN, up to ties;
* the brute per-shard build's ``knn_ids_local`` equal JAX's up to ties;
* queries on the JAX index's navigation graph carried across (``interop``)
  reach its recall within a band, and agree on the distances of the ids
  both return, with 2⁻¹⁶·(‖q‖² + max ‖x‖²) of slack (the JAX walk scores
  on a two-way bf16 split, the port in FP32);
* approximate builds (``BRUTE_BUILD_FLOP_BUDGET`` patched to 0 in both
  packages) reach the JAX builds' graph recall within a band;
* both ``generate_knn`` rings, and the 2 × 4 grid query."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import annsearch_tpu.parallel as jpar
import annsearch_tpu.parallel.graph_sharded as jgs
import annsearch_tpu_torch.models.graph as tgraph
import annsearch_tpu_torch.parallel as tpar
from annsearch_tpu.utils.dist import Dist as JDist
from annsearch_tpu_torch.interop import SHARDED_GRAPH_ARRAYS, sharded_graph_from_jax_arrays
from annsearch_tpu_torch.parallel.mesh import shard_rows
from annsearch_tpu_torch.utils.data import generate_clustered_data
from annsearch_tpu_torch.utils.dist import Dist
from annsearch_tpu_torch.utils.metrics import calculate_recall

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def gdata():
    x, _ = generate_clustered_data(800, 16, 8, seed=5)
    return x


def _exact_knn(x, k):
    d = ((x[:, None, :].astype(np.float64) - x[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d, np.inf)
    ids = np.argsort(d, axis=1, kind="stable")[:, :k]
    return ids, np.take_along_axis(d, ids, axis=1)


def assert_same_up_to_ties(ids, d, ref_ids, ref_d, tol):
    """Distances within ``tol``; where an id differs, its distance ties
    another of the row."""
    ids, d = np.asarray(ids), np.asarray(d, dtype=np.float64)
    ref_ids, ref_d = np.asarray(ref_ids), np.asarray(ref_d, dtype=np.float64)
    fin = np.isfinite(ref_d)
    assert (np.isfinite(d) == fin).all()
    np.testing.assert_allclose(d[fin], ref_d[fin], rtol=0, atol=tol)
    for r, c in zip(*np.nonzero(ids != ref_ids)):
        others = np.delete(ref_d[r], c)
        assert np.min(np.abs(others - ref_d[r, c])) <= tol or (
            ids[r, c] in ref_ids[r] and ref_ids[r, c] in ids[r]), (r, c)


@pytest.fixture(scope="module")
def indexes(gdata):
    jix = jpar.ShardedGraphIndex(gdata, "euclidean", k=10, mesh=jpar.make_mesh(8))
    tix = tpar.ShardedGraphIndex(gdata, "euclidean", k=10, mesh=tpar.make_mesh(8, device="cpu"))
    return jix, tix


def test_ring_self_knn_equals_jax_and_brute_force(gdata):
    x = gdata[:777]
    xp = np.concatenate([x, np.zeros((7, 16), np.float32)])    # 784 rows: 8 shards of 98
    jm = jpar.make_mesh(8)
    ji, jd = jpar.ring_self_knn(jax.device_put(jnp.asarray(xp), NamedSharding(jm, P("db"))),
                                10, JDist.EUCLIDEAN, 777, jm)
    tm = tpar.make_mesh(8, device="cpu")
    ti, td = tpar.ring_self_knn(shard_rows(torch.as_tensor(xp), tm), 10, Dist.EUCLIDEAN, 777, tm)
    assert ti.shape == (784, 10)
    assert (ti[777:] == 777).all() and torch.isinf(td[777:]).all()
    tol = 1e-5 * float((x**2).sum(1).max())
    assert_same_up_to_ties(ti[:777], td[:777], np.asarray(ji)[:777], np.asarray(jd)[:777], tol)
    gi, gd = _exact_knn(x, 10)
    assert_same_up_to_ties(ti[:777], td[:777], gi, gd, tol)


def test_brute_build_equals_jax_up_to_ties(gdata, indexes):
    jix, tix = indexes
    assert (tix.k_build, tix.out_deg, tix.shard_rows) == (jix.k_build, jix.out_deg, jix.shard_rows)
    kk = tix.k_build
    ti = tix.knn_ids_local.reshape(-1, kk)
    td = tix.knn_dists.reshape(-1, kk)
    tol = 1e-5 * float((gdata**2).sum(1).max())
    assert_same_up_to_ties(ti, td, np.asarray(jix.knn_ids_local), np.asarray(jix.knn_dists), tol)
    assert tix.nav_local.shape == np.asarray(jix.nav_local).reshape(8, 100, -1).shape


def _carried(jix, mesh):
    arrays = {name: np.asarray(getattr(jix, name)) for name in SHARDED_GRAPH_ARRAYS}
    meta = {"n": jix.n, "dim": jix.dim, "k_build": jix.k_build, "out_deg": jix.out_deg,
            "seed": jix._seed, "metric": jix.metric.value}
    return sharded_graph_from_jax_arrays(arrays, meta, mesh)


def test_queries_on_the_jax_graph(gdata, indexes):
    jix, _ = indexes
    tix = _carried(jix, tpar.make_mesh(8, device="cpu"))
    q = gdata[100:200] + 0.01
    gt = np.argsort(((q[:, None, :] - gdata[None, :, :]) ** 2).sum(-1), axis=1)[:, :10]
    ji, jd = jix.query(q, 10, beam=32)
    ti, td = tix.query(q, 10, beam=32)
    r_j, r_t = calculate_recall(gt, ji, 10), calculate_recall(gt, ti, 10)
    assert r_t >= r_j - 0.02 and r_t > 0.9, (r_t, r_j)
    slack = 2.0**-16 * float((q**2).sum(1).max() + (gdata**2).sum(1).max())
    ti, td = ti.numpy(), td.numpy()
    shared = 0
    for r in range(len(q)):
        for c, i in enumerate(ti[r]):
            hit = np.nonzero(ji[r] == i)[0]
            if hit.size:
                shared += 1
                assert abs(td[r, c] - jd[r, hit[0]]) <= slack
    assert shared >= 0.9 * ti.size
    # self-queries find themselves first
    si, sd = tix.query(gdata[:32], 8)
    np.testing.assert_array_equal(si[:, 0].numpy(), np.arange(32))


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_approximate_builds_beside_jax(gdata, monkeypatch, metric):
    """The JAX approximate build compiles for about 20 s on the CPU: it is
    the reference under euclidean; under cosine the port's graph is held to
    the euclidean band's floor."""
    monkeypatch.setattr(jgs, "BRUTE_BUILD_FLOP_BUDGET", 0)
    monkeypatch.setattr(tgraph, "BRUTE_BUILD_FLOP_BUDGET", 0)
    jix = None
    if metric == "euclidean":
        jix = jpar.ShardedGraphIndex(gdata, metric, k=10, mesh=jpar.make_mesh(8))
    tix = tpar.ShardedGraphIndex(gdata, metric, k=10, mesh=tpar.make_mesh(8, device="cpu"))
    monkeypatch.undo()
    exact = tpar.ShardedGraphIndex(gdata, metric, k=10, mesh=tpar.make_mesh(8, device="cpu"))
    kk = exact.k_build
    truth = exact.knn_ids_local.reshape(-1, kk)[:, :10]
    r_t = calculate_recall(truth, tix.knn_ids_local.reshape(-1, kk)[:, :10], 10)
    if jix is not None:
        r_j = calculate_recall(truth, np.asarray(jix.knn_ids_local)[:, :10], 10)
        assert r_t >= r_j - 0.03, (r_t, r_j)
    assert r_t > 0.9, r_t
    assert (tix.knn_ids_local.reshape(-1, kk) != torch.arange(100).repeat(8)[:, None]).all()
    q = gdata[:16]
    ids, d = tix.query(q, 5)
    np.testing.assert_array_equal(ids[:, 0].numpy(), np.arange(16))


def test_generate_knn_rings(gdata, indexes):
    _, tix = indexes
    gt_ids, gt_d = _exact_knn(gdata, 8)
    ids, dists = tix.generate_knn(8, mode="graph")
    tol = 1e-5 * float((gdata**2).sum(1).max())
    assert_same_up_to_ties(ids, dists, gt_ids, gt_d, tol)
    # a budget of 0 takes the beam ring: approximate, no self, ascending
    bi, bd = tix.generate_knn(8, mode="graph", flop_budget=0)
    assert calculate_recall(gt_ids, bi, 8) > 0.9
    assert not (bi == torch.arange(800)[:, None]).any() and (bi < 800).all()
    assert (torch.where(torch.isinf(bd), 1e30, bd).diff(dim=1) >= -1e-6).all()


def test_padding_and_the_grid_query(gdata):
    x = gdata[:701]
    tix = tpar.ShardedGraphIndex(x, k=8, mesh=tpar.make_mesh(8, device="cpu"))
    idx, _ = tix.query(x[:16], 8)
    assert (idx < 701).all()
    np.testing.assert_array_equal(idx[:, 0].numpy(), np.arange(16))
    assert (tix.generate_knn(8)[0] < 701).all()
    grid = tpar.ShardedGraphIndex(gdata, k=10, mesh=tpar.make_mesh2d(2, 4, device="cpu"))
    one = tpar.ShardedGraphIndex(gdata, k=10, mesh=tpar.make_mesh(4, device="cpu"))
    q = gdata[:33] + 0.01
    gi, gd = grid.query(q, 8)
    oi, od = one.query(q, 8)
    assert gi.shape == (33, 8)
    assert torch.equal(gi, oi) and torch.equal(gd, od)
    assert grid.memory_usage_bytes() == one.memory_usage_bytes() > 0
