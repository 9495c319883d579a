"""The port's sharded IVF (``parallel/ivf_sharded.py``) against the JAX
package's on its 8-device CPU mesh, at the same shard count.

* ``train_centroids_sharded`` from one ``init`` equals JAX's to rtol 1e-4;
* ``ShardedIvfIndex`` and ``ShardedIvfPqIndex`` (m = dim: mode
  ``i8dec_residual``; m < dim: ``pq_residual``), both metrics, with the JAX
  index's state carried across (``interop``): ids equal to the JAX query's
  and distances to rtol 1e-5 (plus 1e-6 of ‖q‖² + max ‖x‖², where the
  identity cancels), at partial and full nprobe, on the 1-D mesh and the
  2 × 4 grid;
* indexes the port builds itself reach the JAX builds' recall against the
  exhaustive index, within a band (torch cannot repeat JAX's draws), and
  two builds from one seed are identical;
* ``build_cells`` and ``build_probe_lists`` equal JAX's.

Sizes are the JAX tests': 2,000 × 16d (32d for PQ, which needs dim ≥ 32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import annsearch_tpu.parallel as jpar
import annsearch_tpu_torch.parallel as tpar
from annsearch_tpu.models.kmeans import build_cells as j_build_cells
from annsearch_tpu.ops.ivf_scan import build_probe_lists as j_build_probe_lists
from annsearch_tpu_torch.interop import (
    SHARDED_IVF_ARRAYS,
    sharded_ivf_from_jax_arrays,
    sharded_ivf_pq_from_jax_arrays,
)
from annsearch_tpu_torch.models.exhaustive import ExhaustiveIndex
from annsearch_tpu_torch.models.kmeans import build_cells
from annsearch_tpu_torch.ops.ivf_scan import build_probe_lists
from annsearch_tpu_torch.parallel.mesh import shard_rows
from annsearch_tpu_torch.utils.data import generate_clustered_data, subsample_with_noise
from annsearch_tpu_torch.utils.metrics import calculate_recall

torch.set_num_threads(2)

K = 10


def _state(jix) -> tuple[dict, dict]:
    arrays = {name: np.asarray(getattr(jix, name)) for name in SHARDED_IVF_ARRAYS}
    meta = {"n": jix.n, "dim": jix.dim, "nlist": jix.nlist, "cell_cap": jix.cell_cap,
            "metric": jix.metric.value, "mode": jix.mode}
    if hasattr(jix, "pq"):
        arrays["codebooks"] = np.asarray(jix.pq.codebooks)
        if jix.dec_scales is not None:
            arrays["dec_scales"] = np.asarray(jix.dec_scales)
    return arrays, meta


def _check(ids, d, jids, jd, scale):
    ids, d = np.asarray(ids), np.asarray(d, dtype=np.float64)
    np.testing.assert_array_equal(ids, jids)
    tol = 1e-5 * np.abs(jd) + 1e-6 * scale
    assert (np.abs(d - jd) <= tol).all(), np.abs(d - jd).max()


@pytest.fixture(scope="module")
def data16():
    x, _ = generate_clustered_data(2000, 16, 8, seed=0)
    q = subsample_with_noise(x, 100, seed=0)
    return x, q


@pytest.fixture(scope="module")
def data32():
    x, _ = generate_clustered_data(2000, 32, 8, seed=4)
    q = subsample_with_noise(x, 100, seed=4)
    return x, q


def _scale(x, q, metric):
    return float((q**2).sum(1).max() + (x**2).sum(1).max()) if metric == "euclidean" else 2.0


def test_train_centroids_sharded_equals_jax_from_one_init(data16):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    x, _ = data16
    x = x[:1995]
    xp = np.concatenate([x, np.zeros((5, 16), np.float32)])
    init = x[::125][:16].copy()
    jm = jpar.make_mesh(8)
    jc = jpar.train_centroids_sharded(
        jax.device_put(jnp.asarray(xp), NamedSharding(jm, P("db"))), jnp.asarray(init),
        1995, jm, iters=10)
    tm = tpar.make_mesh(8, device="cpu")
    tc = tpar.train_centroids_sharded(shard_rows(torch.as_tensor(xp), tm), torch.as_tensor(init),
                                      1995, tm, iters=10)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def jax_ivf(data16):
    x, _ = data16
    out = {}
    for metric in ("euclidean", "cosine"):
        out[metric, 8] = jpar.ShardedIvfIndex(x, metric, nlist=16, seed=0, mesh=jpar.make_mesh(8))
    out["euclidean", "grid"] = jpar.ShardedIvfIndex(x, nlist=16, seed=0,
                                                    mesh=jpar.make_mesh2d(2, 4))
    return out


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("nprobe", [4, 16])
def test_sharded_ivf_on_jax_state_equals_jax(data16, jax_ivf, metric, nprobe):
    x, q = data16
    jix = jax_ivf[metric, 8]
    tix = sharded_ivf_from_jax_arrays(*_state(jix), tpar.make_mesh(8, device="cpu"))
    ji, jd = jix.query(q, K, nprobe=nprobe)
    ti, td = tix.query(q, K, nprobe=nprobe)
    _check(ti, td, ji, jd, _scale(x, q, metric))


@pytest.mark.parametrize("nprobe", [4, 16])
def test_sharded_ivf_grid_on_jax_state_equals_jax(data16, jax_ivf, nprobe):
    """2 × 4 grid: 33 queries (padded to the batch axis); the grid query
    equals the 1-D query on the same state."""
    x, q = data16
    jix = jax_ivf["euclidean", "grid"]
    arrays, meta = _state(jix)
    tix = sharded_ivf_from_jax_arrays(arrays, meta, tpar.make_mesh2d(2, 4, device="cpu"))
    ji, jd = jix.query(q[:33], K, nprobe=nprobe)
    ti, td = tix.query(q[:33], K, nprobe=nprobe)
    _check(ti, td, ji, jd, _scale(x, q, "euclidean"))
    one = sharded_ivf_from_jax_arrays(arrays, meta, tpar.make_mesh(4, device="cpu"))
    oi, od = one.query(q[:33], K, nprobe=nprobe)
    assert torch.equal(oi, ti) and torch.equal(od, td)


@pytest.fixture(scope="module")
def jax_pq(data32):
    x, _ = data32
    mesh = jpar.make_mesh(8)
    return {(m, metric): jpar.ShardedIvfPqIndex(x, metric, nlist=16, m=m, seed=0, mesh=mesh)
            for m in (None, 16) for metric in ("euclidean", "cosine")}


@pytest.mark.parametrize("m", [None, 16])
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_sharded_ivf_pq_on_jax_state_equals_jax(data32, jax_pq, m, metric):
    x, q = data32
    jix = jax_pq[m, metric]
    assert jix.mode == ("i8dec_residual" if m is None else "pq_residual")
    tix = sharded_ivf_pq_from_jax_arrays(*_state(jix), tpar.make_mesh(8, device="cpu"))
    nprobe = 4 if metric == "euclidean" else 16     # partial and full
    ji, jd = jix.query(q, K, nprobe=nprobe)
    ti, td = tix.query(q, K, nprobe=nprobe)
    _check(ti, td, ji, jd, _scale(x, q, metric))


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_torch_built_sharded_ivf_recall_beside_jax(data16, jax_ivf, metric):
    x, q = data16
    ti, _ = ExhaustiveIndex(x, metric, device="cpu").query(q, K)
    tix = tpar.ShardedIvfIndex(x, metric, nlist=16, seed=0, mesh=tpar.make_mesh(8, device="cpu"))
    for nprobe in (4, 16):
        r_t = calculate_recall(ti, tix.query(q, K, nprobe=nprobe)[0], K)
        r_j = calculate_recall(ti, jax_ivf[metric, 8].query(q, K, nprobe=nprobe)[0], K)
        assert r_t >= r_j - 0.03, (nprobe, r_t, r_j)
    assert r_t > 0.99        # every cell probed


@pytest.mark.parametrize("m", [None, 16])
def test_torch_built_sharded_ivf_pq_recall_beside_jax(data32, jax_pq, m):
    x, q = data32
    ti, _ = ExhaustiveIndex(x, device="cpu").query(q, K)
    tix = tpar.ShardedIvfPqIndex(x, nlist=16, m=m, seed=0, mesh=tpar.make_mesh(8, device="cpu"))
    assert tix.mode == jax_pq[m, "euclidean"].mode
    ids, d = tix.query(q, K, nprobe=16)
    r_t = calculate_recall(ti, ids, K)
    r_j = calculate_recall(ti, jax_pq[m, "euclidean"].query(q, K, nprobe=16)[0], K)
    assert r_t >= r_j - 0.05, (r_t, r_j)
    assert (d.diff(dim=1) >= -1e-6).all() and (ids >= 0).all() and (ids < 2000).all()


def test_two_builds_from_one_seed_are_identical(data32):
    x, q = data32
    mesh = tpar.make_mesh(8, device="cpu")
    a = tpar.ShardedIvfPqIndex(x[:1993], nlist=16, seed=3, mesh=mesh)
    b = tpar.ShardedIvfPqIndex(x[:1993], nlist=16, seed=3, mesh=mesh)
    for name in ("centroids", "storage", "store_sqnorms", "offsets", "counts", "original_ids",
                 "dec_scales"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    ia, da = a.query(q, K)
    ib, db = b.query(q, K)
    assert torch.equal(ia, ib) and torch.equal(da, db)
    assert (ia < 1993).all()


def test_uneven_rows_never_return_padding(data16):
    x, _ = generate_clustered_data(1003, 8, 4, seed=2)
    tix = tpar.ShardedIvfIndex(x, nlist=8, seed=0, mesh=tpar.make_mesh(8, device="cpu"))
    ai, ad = tix.query(x[:20], 5, nprobe=8)
    assert (ai < 1003).all()
    np.testing.assert_array_equal(ai[:, 0].numpy(), np.arange(20))
    np.testing.assert_allclose(ad[:, 0].numpy(), 0.0, atol=1e-3)


def test_build_cells_and_probe_lists_equal_jax():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 13, 500)
    a[a == 5] = 4                       # an empty cell
    for q in (1.0, 0.5):
        for got, want in zip(build_cells(a, 13, q), j_build_cells(a, 13, q)):
            np.testing.assert_array_equal(got, want)
    probes = rng.integers(0, 40, (300, 6))
    for got, want in zip(build_probe_lists(probes, 40, 300), j_build_probe_lists(probes, 40, 300)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
