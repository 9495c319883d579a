"""The flat scan's selectors (``"exact"``, ``"approx"``, ``"bins"``,
``"fused"``, ``"certified"``) and ``n_valid``, port against the JAX package
on the same numpy inputs (``"certified"``, which the JAX package lacks,
against its ``"exact"``).

Inputs lie on a coarse grid (multiples of 1/8) wherever ids are compared
one for one: every distance is then exact in f32 in both packages, so the
selections see the same values and break the same ties. The JAX ``"fused"``
selector runs its Pallas kernel in interpret mode off the TPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import annsearch_tpu_torch as at
from annsearch_tpu.models.exhaustive import ExhaustiveIndex as JExhaustive
from annsearch_tpu.ops.flat_scan_pallas import flat_topk_fused as jax_fused
from annsearch_tpu.ops.topk import blocked_query_topk as jax_blocked
from annsearch_tpu.ops.topk import chunked_topk as jax_chunked
from annsearch_tpu.ops.topk import chunked_topk_bins as jax_bins
from annsearch_tpu.utils.dist import Dist as JDist
from annsearch_tpu_torch.ops.topk import blocked_query_topk, chunked_topk, chunked_topk_bins
from annsearch_tpu_torch.utils.data import generate_clustered_data
from annsearch_tpu_torch.utils.dist import Dist

torch.set_num_threads(2)

METRICS = {"euclidean": (Dist.EUCLIDEAN, JDist.EUCLIDEAN), "cosine": (Dist.COSINE, JDist.COSINE)}
SELECTORS = ["exact", "approx", "bins", "fused"]


def _grid(rng, shape):
    return (rng.integers(-16, 17, shape) / 8).astype(np.float32)


@pytest.fixture(scope="module")
def grid():
    rng = np.random.default_rng(11)
    return _grid(rng, (90, 24)), _grid(rng, (1100, 24))


@pytest.mark.parametrize("metric", list(METRICS))
@pytest.mark.parametrize("n_valid", [None, 1000])
def test_chunked_topk_bins_equals_jax(grid, metric, n_valid):
    q, x = grid
    tm, jm = METRICS[metric]
    dt, it = chunked_topk_bins(torch.tensor(q), torch.tensor(x), 12, tm, n_valid=n_valid,
                               bins=256)
    dj, ij = jax_bins(jnp.asarray(q), jnp.asarray(x), 12, jm, n_valid=n_valid, bins=256)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    if n_valid is not None:
        assert it.max() < n_valid


def test_chunked_topk_n_valid_equals_jax(grid):
    q, x = grid
    dt, it = chunked_topk(torch.tensor(q), torch.tensor(x), 7, Dist.EUCLIDEAN, n_valid=333,
                          db_chunk=256)
    dj, ij = jax_chunked(jnp.asarray(q), jnp.asarray(x), 7, JDist.EUCLIDEAN, n_valid=333,
                         db_chunk=256)
    assert it.max() < 333
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    # grid inputs tie exactly: a tie at the 7th rank may name either row
    assert at.calculate_recall(np.array(ij), it, 7) >= 0.99


@pytest.mark.parametrize("metric", list(METRICS))
@pytest.mark.parametrize("selector", SELECTORS + ["certified"])
@pytest.mark.parametrize("n_valid", [None, 1000])
def test_blocked_selectors_equal_jax(grid, metric, selector, n_valid):
    q, x = grid
    tm, jm = METRICS[metric]
    dt, it = blocked_query_topk(torch.tensor(q), torch.tensor(x), 10, tm, n_valid=n_valid,
                                query_block=64, db_chunk=512, selector=selector)
    if selector == "fused" and n_valid is not None:
        # the JAX blocked_query_topk traces n_valid, which its kernel's
        # wrapper needs static: the wrapper itself is the reference here
        dj, ij = jax_fused(jnp.asarray(q), jnp.asarray(x), 10, jm, n_valid=n_valid,
                           passes=6, interpret=True)
    else:
        dj, ij = jax_blocked(jnp.asarray(q), jnp.asarray(x), 10, jm, n_valid=n_valid,
                             query_block=64, db_chunk=512,
                             selector="exact" if selector == "certified" else selector)
    assert dt.shape == (90, 10) and it.dtype == torch.int64
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    if selector in ("bins", "fused", "certified"):
        # the bins break ties by column in both packages, as lax.top_k does
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    else:
        # exact ties at the 10th rank may name either row
        assert at.calculate_recall(np.array(ij), it, 10) >= 0.99
    if n_valid is not None:
        assert it.max() < n_valid


@pytest.mark.parametrize("k", [10, 40])
@pytest.mark.parametrize("n_valid", [None, 5500])
def test_certified_through_ties_equals_jax_exact(k, n_valid):
    """Grid rows past K2's 2,048 classes, where most queries tie at the
    k-th rank and some classes collide: ``"certified"`` (K2's certificate,
    ties included, and the rescans) gives the JAX ``"exact"`` selector's
    answer bit for bit, ties to the lower id, as ``lax.top_k`` orders."""
    from annsearch_tpu_torch.utils import profiling

    rng = np.random.default_rng(13)
    q = (rng.integers(-4, 5, (300, 8)) / 8).astype(np.float32)
    x = (rng.integers(-4, 5, (6000, 8)) / 8).astype(np.float32)
    profiling.enable()
    try:
        dt, it = blocked_query_topk(torch.tensor(q), torch.tensor(x), k, Dist.EUCLIDEAN,
                                    n_valid=n_valid, selector="certified")
        counts = profiling.snapshot()["topk.certified"]["counts"]
    finally:
        profiling.disable()
        profiling.reset()
    dj, ij = jax_blocked(jnp.asarray(q), jnp.asarray(x), k, JDist.EUCLIDEAN, n_valid=n_valid,
                         selector="exact")
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    # most queries tie at the k-th rank (the grid's distances are exact in f64)
    full = ((q[:, None, :].astype(np.float64) - x[None, : n_valid or len(x)]) ** 2).sum(-1)
    full.sort(axis=1)
    assert counts["rescanned"] > 0 and (full[:, k - 1] == full[:, k]).sum() > len(q) // 2


@pytest.mark.parametrize("k", [15, 40])
def test_certified_equals_exact_on_gaussian_rows(k):
    """2,000 Gaussian queries against 20,000 rows (B 2,048: about 5% of the
    queries collide at k 15, about 30% at k 40): ``"certified"`` answers as
    ``"exact"`` does. The two sum their products in other orders, so ids
    may differ only at near-ties: each id ``"certified"`` returns lies, in
    float64, within the identity's f32 rounding of the distance
    ``"exact"`` returns at that rank."""
    from annsearch_tpu_torch.utils import profiling

    g = torch.Generator().manual_seed(29)
    q, x = torch.randn(2000, 16, generator=g), torch.randn(20000, 16, generator=g)
    profiling.enable()
    try:
        dc, ic = blocked_query_topk(q, x, k, Dist.EUCLIDEAN, selector="certified")
        counts = profiling.snapshot()["topk.certified"]["counts"]
    finally:
        profiling.disable()
        profiling.reset()
    de, ie = blocked_query_topk(q, x, k, Dist.EUCLIDEAN, selector="exact")
    assert counts["queries"] == 2000 and counts["rescanned"] > 0
    assert ic.dtype == torch.int64 and dc.shape == (2000, k)
    # 8 ulps of ‖q‖² + max‖x‖², the terms the identity rounds
    tol = 2.0**-20 * ((q * q).sum(1) + (x * x).sum(1).max())[:, None].double()
    true = ((q.double()[:, None, :] - x.double()[ic]) ** 2).sum(-1)
    assert ((true - de.double()).abs() <= tol).all()
    assert ((dc.double() - de.double()).abs() <= tol).all()
    assert (ic == ie).all(1).float().mean() >= 0.995


def test_fused_wide_k_takes_bins(grid):
    q, x = grid
    tq, tx = torch.tensor(q), torch.tensor(x)
    d65, i65 = blocked_query_topk(tq, tx, 65, Dist.EUCLIDEAN, selector="fused")
    db, ib = blocked_query_topk(tq, tx, 65, Dist.EUCLIDEAN, selector="bins")
    assert torch.equal(d65, db) and torch.equal(i65, ib)
    assert torch.isfinite(d65).all()           # the fused kernel stops at its kb
    dj, ij = jax_blocked(jnp.asarray(q), jnp.asarray(x), 65, JDist.EUCLIDEAN, selector="fused")
    np.testing.assert_array_equal(i65.numpy(), np.asarray(ij))


def test_fused_precision_sets_the_grade():
    """"highest" is f32 grade (six cross terms of a three-way bf16 split on
    the card, the fp32 product in the plain version), "high" sums the three
    of a two-way split (about 16 mantissa bits), anything else one bf16
    pass: off the bf16 grid the distances move away from the FP32 scan's in
    that order, by about 2⁻²⁴, 2⁻¹⁶ and 2⁻⁸ of them."""
    rng = np.random.default_rng(12)
    q = torch.tensor(rng.standard_normal((6, 16)).astype(np.float32))
    x = torch.tensor(rng.standard_normal((300, 16)).astype(np.float32))
    hi = blocked_query_topk(q, x, 5, Dist.EUCLIDEAN, selector="fused", precision="highest")
    mid = blocked_query_topk(q, x, 5, Dist.EUCLIDEAN, selector="fused", precision="high")
    lo = blocked_query_topk(q, x, 5, Dist.EUCLIDEAN, selector="fused", precision="default")
    assert not torch.equal(hi[0], lo[0])
    ex = blocked_query_topk(q, x, 5, Dist.EUCLIDEAN)
    torch.testing.assert_close(hi[0], ex[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(mid[0], ex[0], rtol=2.0 ** -14, atol=1e-5)
    err = [(d[0] - ex[0]).abs().max().item() for d in (hi, mid, lo)]
    assert err[0] < err[1] < err[2]


def test_unknown_selector_raises(grid):
    q, x = grid
    with pytest.raises(ValueError, match="selector"):
        blocked_query_topk(torch.tensor(q), torch.tensor(x), 5, Dist.EUCLIDEAN, selector="heap")


@pytest.fixture(scope="module")
def flat():
    x, _ = generate_clustered_data(1500, 24, 6, seed=5)
    x = np.round(x * 8) / np.float32(64)       # the 1/64 grid, |x| < 2
    return x, x[:40] + np.float32(1 / 64)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("selector", SELECTORS)
def test_exhaustive_index_selectors(flat, metric, selector):
    x, q = flat
    t = at.build_exhaustive_index(x, metric, device="cpu")
    j = JExhaustive(x, metric)
    it, dt = t.query(q, 10, selector=selector)
    ij, dj = j.query(q, 10, selector=selector)
    assert at.calculate_recall(np.array(ij), it, 10) >= 0.995
    np.testing.assert_allclose(dt.numpy(), dj, rtol=1e-5, atol=1e-5)
    gi, gd = t.generate_knn(5, selector=selector)
    gj, _ = j.generate_knn(5, selector=selector)
    assert gi.shape == (1500, 5)
    assert (gd[:, 0] < 1e-5).all()
    assert at.calculate_recall(np.array(gj), gi, 5) >= 0.995


@pytest.mark.parametrize("selector", ["bins", "fused"])
def test_exhaustive_f64_pool_with_selector(flat, selector):
    x, q = flat
    x64 = x.astype(np.float64) + 1e-9 * np.arange(x.shape[1])
    q64 = q.astype(np.float64)
    t = at.build_exhaustive_index(x64, device="cpu")
    j = JExhaustive(x64)
    it, dt = t.query(q64, 8, selector=selector)
    ij, dj = j.query(q64, 8, selector=selector)
    assert dt.dtype == torch.float64
    np.testing.assert_array_equal(it.numpy(), ij)
    np.testing.assert_allclose(dt.numpy(), dj, rtol=1e-12, atol=1e-12)


def test_gpu_facade_rows(flat):
    """The ``*_gpu`` rows: the flat scan through ``"bins"``, the IVF index
    through its approximate tier."""
    x, q = flat
    ex = at.build_exhaustive_index_gpu(x, device="cpu")
    ids, d = at.query_exhaustive_index_gpu(q, ex, 10, return_dist=True)
    ref, dref = ex.query(q, 10, selector="bins")
    assert torch.equal(ids, ref) and torch.equal(d, dref)
    assert at.query_exhaustive_index_gpu(q, ex, 10)[1] is None
    si, sd = at.query_exhaustive_index_gpu_self(ex, 4, return_dist=True)
    assert (si[:, 0] == torch.arange(1500)).float().mean() > 0.99 and (sd[:, 0] < 1e-5).all()

    ivf = at.build_ivf_index_gpu(x, nlist=8, seed=3, device="cpu")
    ids, d = at.query_ivf_index_gpu(q, ivf, 10, nprobe=3, return_dist=True)
    ref, dref = ivf.query(q, 10, nprobe=3, approx=True)
    assert torch.equal(ids, ref) and torch.equal(d, dref)
    assert at.calculate_recall(ex.query(q, 10)[0], ids, 10) > 0.9
    si, _ = at.query_ivf_index_gpu_self(ivf, 3, nprobe=3)
    assert (si[:, 0] == torch.arange(1500)).float().mean() > 0.99


def _tie_heavy(rows, width, seed, specials):
    """Grid values with many exact ties; with ``specials``, ``-0.0``, ``0.0``,
    ``inf`` and NaN of both signs sprinkled in."""
    rng = np.random.default_rng(seed)
    d = rng.integers(-8, 9, (rows, width)).astype(np.float32) / 4
    if specials:
        pick = rng.integers(0, 6, (rows, width))
        vals = np.array([-0.0, 0.0, np.inf, np.nan, -np.nan, 1.0], np.float32)
        d = np.where(rng.random((rows, width)) < 0.3, vals[pick], d).astype(np.float32)
    return d


@pytest.mark.parametrize("specials", [False, True])
@pytest.mark.parametrize("width,k", [(20, 10), (80, 10), (1024, 10), (4096, 64), (300, 300), (8192, 10)])
def test_topk_smallest_routes_agree(width, k, specials):
    """``topk_smallest``'s keyed ``torch.topk`` and its stable sort give the
    same values and ids, bit for bit (ties by column, ``-0.0`` as ``0.0``,
    NaN after ``inf``)."""
    from annsearch_tpu_torch.ops import topk

    d = torch.as_tensor(_tie_heavy(64, width, width + k, specials))
    sv, si = topk._topk_sorted(d, k)
    kv, ki = topk._topk_keyed(d, k)
    assert torch.equal(si, ki)
    np.testing.assert_array_equal(sv.numpy().view(np.int32), kv.numpy().view(np.int32))
    tv, ti = topk.topk_smallest(d, k)
    assert torch.equal(ti, si) and torch.equal(tv.isnan(), sv.isnan())


@pytest.mark.parametrize("width,k", [(20, 10), (1024, 10), (4096, 64)])
def test_topk_smallest_equals_lax_top_k(width, k):
    """Both routes order ties as ``lax.top_k`` does (the lower index first)."""
    import jax

    from annsearch_tpu_torch.ops.topk import topk_smallest

    d = _tie_heavy(64, width, 7 * width, False)
    jv, ji = jax.lax.top_k(-jnp.asarray(d), k)
    tv, ti = topk_smallest(torch.as_tensor(d), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), -np.asarray(jv))
