"""Parity of the port's distances, exact top-k, exhaustive index, metrics
and data generators with the JAX package, on the same numpy inputs.

Tolerances: distances within rtol 1e-5 / atol 1e-4 (both sides compute
f32 at HIGHEST grade, in different summation orders); ids equal wherever
the gap to the next rank exceeds 1e-5 (closer pairs may swap). The data is
scaled by 1/8 (exactly) so that squared norms stay near 20: the identity
‖q‖² + ‖x‖² − 2q·x cancels, and its f32 rounding grows with the norms."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from annsearch_tpu.models.exhaustive import ExhaustiveIndex as JExhaustive
from annsearch_tpu.ops.topk import blocked_query_topk as j_blocked
from annsearch_tpu.utils import data as jdata
from annsearch_tpu.utils import dist as jdist
from annsearch_tpu.utils.metrics import calculate_recall as j_recall
from annsearch_tpu_torch.models.exhaustive import ExhaustiveIndex
from annsearch_tpu_torch.ops.topk import blocked_query_topk, merge_topk, topk_smallest
from annsearch_tpu_torch.utils import data as tdata
from annsearch_tpu_torch.utils import dist as tdist
from annsearch_tpu_torch.utils.metrics import calculate_recall

torch.set_num_threads(2)

HIGHEST = jax.lax.Precision.HIGHEST
RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def xq():
    x, _ = tdata.generate_clustered_data(1500, 48, 5, seed=7)
    q = tdata.subsample_with_noise(x, 40, seed=8)
    return x * np.float32(0.125), q * np.float32(0.125)


def _ids_match_outside_ties(i_a, i_b, d_ref, gap=1e-5):
    """Ids agree at every rank whose distance is more than ``gap`` from
    both neighbouring ranks."""
    d = np.asarray(d_ref)
    sep = np.ones(d.shape, bool)
    sep[:, 1:] &= np.diff(d, axis=1) > gap
    sep[:, :-1] &= np.diff(d, axis=1) > gap
    assert sep.mean() > 0.9
    np.testing.assert_array_equal(np.asarray(i_a)[sep], np.asarray(i_b)[sep])


@pytest.mark.parametrize(
    "name,kw",
    [("lowrank", dict(intrinsic_dim=8)), ("correlated", {}), ("quantisation", {}),
     ("gaussian", {})],
)
def test_generate_data_suites_match_bit_for_bit(name, kw):
    got = tdata.generate_data(name, 900, 40, 7, seed=11, **kw)
    want = jdata.generate_data(name, 900, 40, 7, seed=11, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_data_generators_match_bit_for_bit():
    x_t, l_t = tdata.generate_clustered_data(777, 33, 9, seed=5)
    x_j, l_j = jdata.generate_clustered_data(777, 33, 9, seed=5)
    np.testing.assert_array_equal(x_t, x_j)
    np.testing.assert_array_equal(l_t, l_j)
    np.testing.assert_array_equal(
        tdata.subsample_with_noise(x_t, 50, seed=2),
        jdata.subsample_with_noise(x_j, 50, seed=2),
    )


def test_parse_ann_dist():
    for name in ("cosine", " COSINE ", "euclidean", "l2", "bogus"):
        assert tdist.parse_ann_dist(name).value == jdist.parse_ann_dist(name).value


@pytest.mark.parametrize("fn", ["sq_norms", "normalise"])
def test_norm_helpers(xq, fn):
    x, _ = xq
    got = getattr(tdist, fn)(torch.as_tensor(x)).numpy()
    want = np.asarray(getattr(jdist, fn)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_pairwise_matches_jax_highest(xq, metric):
    x, q = xq
    if metric == "cosine":
        x = x / np.linalg.norm(x, axis=1, keepdims=True)
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    m_t, m_j = tdist.parse_ann_dist(metric), jdist.parse_ann_dist(metric)
    got = tdist.pairwise_dist(torch.as_tensor(q), torch.as_tensor(x), m_t,
                              precision="highest").numpy()
    want = np.asarray(jdist.pairwise_dist(jnp.asarray(q), jnp.asarray(x), m_j,
                                          precision=HIGHEST))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_matmul_precision_is_explicit(xq):
    x, q = xq
    got = tdist.matmul_t(torch.as_tensor(q), torch.as_tensor(x), "highest").numpy()
    np.testing.assert_allclose(got, q.astype(np.float64) @ x.T, rtol=1e-5, atol=1e-5)
    assert not torch.backends.cuda.matmul.allow_tf32   # restored after the call
    with pytest.raises(ValueError, match="highest"):
        tdist.matmul_t(torch.as_tensor(q), torch.as_tensor(x), "default")


def test_topk_smallest_breaks_ties_to_lower_index():
    d = torch.tensor([[3.0, 1.0, 1.0, 0.5, 1.0], [2.0, 2.0, 2.0, 2.0, 2.0]])
    v, i = topk_smallest(d, 3)
    jv, ji = jax.lax.top_k(-jnp.asarray(d.numpy()), 3)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), -np.asarray(jv))


def test_merge_topk():
    da, ia = torch.tensor([[0.1, 0.5]]), torch.tensor([[7, 3]])
    db, ib = torch.tensor([[0.2, 0.5]]), torch.tensor([[9, 1]])
    v, i = merge_topk(da, ia, db, ib, 3)
    assert i.tolist() == [[7, 9, 3]] and v[0].tolist() == pytest.approx([0.1, 0.2, 0.5])


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("db_chunk,query_block", [(16384, 1024), (96, 16)])
def test_blocked_query_topk_matches_jax(xq, metric, db_chunk, query_block):
    x, q = xq
    m_t, m_j = tdist.parse_ann_dist(metric), jdist.parse_ann_dist(metric)
    xt, qt = torch.as_tensor(x), torch.as_tensor(q)
    xj, qj = jnp.asarray(x), jnp.asarray(q)
    if metric == "cosine":
        xt, qt = tdist.normalise(xt), tdist.normalise(qt)
        xj, qj = jdist.normalise(xj), jdist.normalise(qj)
    d, i = blocked_query_topk(qt, xt, 10, m_t, db_chunk=db_chunk,
                              query_block=query_block)
    dj, ij = j_blocked(qj, xj, 10, m_j, db_chunk=db_chunk,
                       query_block=query_block, precision=HIGHEST)
    np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=RTOL, atol=ATOL)
    _ids_match_outside_ties(i.numpy(), ij, dj)


def test_blocked_query_topk_other_selectors_raise(xq):
    x, q = xq
    for sel in ("fused", "bins", "approx"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            blocked_query_topk(torch.as_tensor(q), torch.as_tensor(x), 5,
                               tdist.Dist.EUCLIDEAN, selector=sel)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_exhaustive_index_matches_jax(xq, metric):
    x, q = xq
    ti, td = ExhaustiveIndex(x, metric, device="cpu").query(q, 10)
    ji, jd = JExhaustive(x, metric).query(q, 10)
    assert ti.dtype == torch.int64 and td.dtype == torch.float32
    np.testing.assert_allclose(td.numpy(), jd, rtol=RTOL, atol=ATOL)
    _ids_match_outside_ties(ti.numpy(), ji, jd)


def test_exhaustive_contract(small_points):
    idx = ExhaustiveIndex(small_points, "euclidean", device="cpu")
    ids, d = idx.query(small_points, 50)          # k clamps to n
    assert ids.shape == (5, 5)
    assert (ids[:, 0] == torch.arange(5)).all()   # self first, at 0
    assert torch.all(d[:, 1:] >= d[:, :-1])
    diff = small_points[:, None, :] - small_points[ids.numpy()]
    np.testing.assert_allclose(d.numpy(), (diff ** 2).sum(-1), atol=1e-6)
    with pytest.raises(ValueError, match="dim"):
        idx.query(np.zeros((2, 4), np.float32), 1)
    # f64 data: f64 queries answer in f64, f32 queries in f32
    idx64 = ExhaustiveIndex(small_points.astype(np.float64), device="cpu")
    assert idx64.query(small_points.astype(np.float64), 2)[1].dtype == torch.float64
    assert idx64.query(small_points, 2)[1].dtype == torch.float32


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_exhaustive_f64_matches_jax(xq, metric):
    """A 2k pool from the f32 scan, rescored in f64 on the host: the same
    ids and f64 distances as the JAX package's."""
    x, q = xq
    x64, q64 = x.astype(np.float64) + 1e-9, q.astype(np.float64)
    ti, td = ExhaustiveIndex(x64, metric, device="cpu").query(q64, 10)
    ji, jd = JExhaustive(x64, metric).query(q64, 10)
    assert td.dtype == torch.float64
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_allclose(td.numpy(), jd, rtol=1e-12, atol=1e-12)
    dx = ((q64[:, None, :] - x64[ti.numpy()]) ** 2).sum(-1)
    if metric == "euclidean":
        np.testing.assert_allclose(td.numpy(), dx, rtol=1e-12, atol=1e-12)


def test_rescore_f64_pool_matches_jax():
    """Duplicate pool entries keep one copy; the rest rank by f64 distance."""
    from annsearch_tpu.models.base import rescore_f64_pool as j_rescore
    from annsearch_tpu_torch.models.base import rescore_f64_pool

    rng = np.random.default_rng(3)
    x, q = rng.standard_normal((50, 6)), rng.standard_normal((4, 6))
    pool = rng.integers(0, 50, (4, 12))
    pool[:, 5] = pool[:, 0]                       # a clipped sentinel slot
    for metric in ("euclidean", "cosine"):
        got = rescore_f64_pool(x, q, pool, 8, tdist.parse_ann_dist(metric))
        want = j_rescore(x, q, pool, 8, jdist.parse_ann_dist(metric))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_calculate_recall_matches_jax():
    rng = np.random.default_rng(0)
    t = rng.integers(0, 30, (50, 10))
    a = rng.integers(0, 30, (50, 10))
    a[:5, 1] = a[:5, 0]                           # repeated ids count once
    for k in (1, 5, 10):
        assert calculate_recall(t, a, k) == pytest.approx(j_recall(t, a, k), abs=1e-12)
    u = np.argsort(rng.random((50, 30)), axis=1)[:, :10]   # distinct ids
    assert calculate_recall(torch.as_tensor(u), torch.as_tensor(u[:, ::-1].copy()), 10) == 1.0
