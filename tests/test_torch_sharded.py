"""The port's sharded exact top-k (``parallel/sharded.py``) against the JAX
package's on its 8-device CPU mesh, at the same P = 8 logical shards: the
three ``*_sharded_topk`` functions and the three exhaustive classes, both
metrics, a row count that is no multiple of P, and the 2 × 4 grid. Ids are
equal up to ties, distances to rtol 1e-5 (plus 1e-6 of the identity's
terms, ‖q‖² + max ‖x‖², where the distance cancels)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import annsearch_tpu.parallel as jpar
import annsearch_tpu_torch.parallel as tpar
from annsearch_tpu.utils.dist import Dist as JDist
from annsearch_tpu_torch.parallel.mesh import gather_shards, ring_shift, shard_rows
from annsearch_tpu_torch.utils.data import generate_clustered_data, subsample_with_noise
from annsearch_tpu_torch.utils.dist import Dist

torch.set_num_threads(2)

N, D, NQ, K = 1995, 16, 100, 10


def assert_same_up_to_ties(ids, d, ref_ids, ref_d, scale):
    """``(ids, d)`` equal ``(ref_ids, ref_d)``: distances within rtol 1e-5
    (+ 1e-6·scale), and where an id differs its distance ties another of
    its row (the two sides broke a tie apart)."""
    ids, d = np.asarray(ids), np.asarray(d, dtype=np.float64)
    ref_ids, ref_d = np.asarray(ref_ids), np.asarray(ref_d, dtype=np.float64)
    tol = 1e-5 * np.abs(ref_d) + 1e-6 * scale
    np.testing.assert_allclose(d, ref_d, rtol=0, atol=float(tol.max()))
    for r, c in zip(*np.nonzero(ids != ref_ids)):
        others = np.delete(ref_d[r], c)
        assert np.min(np.abs(others - ref_d[r, c])) <= tol[r, c] or (
            ids[r, c] in ref_ids[r] and ref_ids[r, c] in ids[r]), (r, c)


@pytest.fixture(scope="module")
def data():
    x, _ = generate_clustered_data(2000, D, 8, seed=0)
    q = subsample_with_noise(x, NQ, seed=0)
    x = x[:N]
    scale = float((q**2).sum(1).max() + (x**2).sum(1).max())
    return x, q, scale


@pytest.fixture(scope="module")
def meshes():
    return (jpar.make_mesh(8), tpar.make_mesh(8, device="cpu"),
            jpar.make_mesh2d(2, 4), tpar.make_mesh2d(2, 4, device="cpu"))


def test_the_mesh_lays_logical_shards_over_the_world():
    m = tpar.make_mesh(8, device="cpu")
    assert m.shape == {"db": 8} and m.world == 1 and list(m.db_shards()) == list(range(8))
    g = tpar.make_mesh2d(2, 4, device="cpu")
    assert g.axis_names == ("batch", "db") and g.n_batch == 2 and g.n_shards == 4
    assert tpar.make_mesh(device="cpu").shape == {"db": 1}    # P = W by default
    with pytest.raises(ValueError):
        tpar.make_mesh2d(2, 0, device="cpu")
    x = torch.arange(24.0).reshape(8, 3)
    s = shard_rows(x, m)
    assert s.shape == (8, 1, 3) and torch.equal(gather_shards(m, s).reshape(8, 3), x)
    assert torch.equal(ring_shift(m, s)[1], s[0]) and torch.equal(ring_shift(m, s)[0], s[7])
    with pytest.raises(ValueError):
        shard_rows(x[:7], m)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_sharded_exhaustive_equals_jax(data, meshes, metric):
    x, q, scale = data
    jm, tm = meshes[:2]
    ji, jd = jpar.ShardedExhaustive(x, metric, mesh=jm).query(q, K)
    ti, td = tpar.ShardedExhaustive(x, metric, mesh=tm).query(q, K)
    assert ti.shape == (NQ, K) and (ti < N).all()
    assert_same_up_to_ties(ti, td, ji, jd, scale if metric == "euclidean" else 2.0)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_batch_sharded_exhaustive_equals_jax(data, meshes, metric):
    x, q, scale = data
    jm, tm = meshes[:2]
    ji, jd = jpar.BatchShardedExhaustive(x, metric, mesh=jm).query(q[:37], K)
    ti, td = tpar.BatchShardedExhaustive(x, metric, mesh=tm).query(q[:37], K)
    assert ti.shape == (37, K)
    assert_same_up_to_ties(ti, td, ji, jd, scale if metric == "euclidean" else 2.0)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_grid_sharded_exhaustive_equals_jax(data, meshes, metric):
    x, q, scale = data
    jg, tg = meshes[2:]
    ji, jd = jpar.GridShardedExhaustive(x, metric, mesh=jg).query(q[:33], K)
    ti, td = tpar.GridShardedExhaustive(x, metric, mesh=tg).query(q[:33], K)
    assert ti.shape == (33, K)
    assert_same_up_to_ties(ti, td, ji, jd, scale if metric == "euclidean" else 2.0)
    # and the grid equals the 1-D sharded answer
    oi, od = tpar.ShardedExhaustive(x, metric, mesh=meshes[1]).query(q[:33], K)
    assert_same_up_to_ties(ti, td, oi, od, scale if metric == "euclidean" else 2.0)


def _jax_put(a, mesh, spec):
    return jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))


def test_the_topk_functions_equal_jax(data, meshes):
    """The three functions on pre-sharded inputs, rows padded to 2,000 with
    ``n_valid`` 1,995: pad rows never win."""
    x, q, scale = data
    jm, tm, jg, tg = meshes
    xp = np.concatenate([x, np.zeros((5, D), np.float32)])
    xt = torch.as_tensor(xp)
    jd, ji = jpar.sharded_topk(jnp.asarray(q), _jax_put(xp, jm, P("db")), K, JDist.EUCLIDEAN,
                               N, jm, db_chunk=128)
    td, ti = tpar.sharded_topk(torch.as_tensor(q), shard_rows(xt, tm), K, Dist.EUCLIDEAN,
                               N, tm, db_chunk=128)
    assert (ti < N).all()
    assert_same_up_to_ties(ti, td, ji, jd, scale)

    qp = q[:96]
    jd, ji = jpar.batch_sharded_topk(_jax_put(qp, jm, P("db")), jnp.asarray(x), K,
                                     JDist.EUCLIDEAN, N, jm)
    td, ti = tpar.batch_sharded_topk(shard_rows(torch.as_tensor(qp), tm), torch.as_tensor(x),
                                     K, Dist.EUCLIDEAN, N, tm)
    assert ti.shape == (96, K)
    assert_same_up_to_ties(ti, td, ji, jd, scale)

    jd, ji = jpar.grid_sharded_topk(_jax_put(qp, jg, P("batch")), _jax_put(xp, jg, P("db")), K,
                                    JDist.EUCLIDEAN, N, jg)
    td, ti = tpar.grid_sharded_topk(shard_rows(torch.as_tensor(qp), tg, "batch"),
                                    shard_rows(xt, tg), K, Dist.EUCLIDEAN, N, tg)
    assert ti.shape == (96, K) and (ti < N).all()
    assert_same_up_to_ties(ti, td, ji, jd, scale)


def test_the_sharded_classes_default_to_the_card():
    import inspect

    for cls in (tpar.ShardedExhaustive, tpar.ShardedIvfIndex, tpar.ShardedGraphIndex):
        assert inspect.signature(cls).parameters["mesh"].default is None
    assert str(tpar.make_mesh().device) == "cuda"
