"""The flat quantised indexes of the port (bf16, SQ8, PQ, OPQ) and their
scans (``ops/quantised.py``) against the JAX package's, on its
``tests/test_quantised_flat.py`` data (3,000 × 32d, 150 queries).

bf16 rows are the same in both packages (one rounding); SQ8 is compared
bit for bit on the JAX index's codes and scales carried across; PQ and
OPQ on its codebooks, codes and rotation carried across, with distances
within 2⁻⁸·(‖q‖² + max‖x̂‖²): both round the decoded rows and the query to
bf16, and the products of bf16 values are exact in f32, but the two sum
them in other orders, and ‖q‖² + ‖x̂‖² − 2q·x̂ cancels. The port's own
builds are held to the JAX tests' recall floors."""

import numpy as np
import pytest
import torch

import annsearch_tpu_torch as at
from annsearch_tpu.models.quantised import flat as jflat
from annsearch_tpu.ops import quantised as jq
from annsearch_tpu.utils.dist import Dist as JDist
from annsearch_tpu_torch import interop
from annsearch_tpu_torch.models.quantised.flat import (
    ExhaustiveIndexBf16,
    ExhaustiveOpqIndex,
    ExhaustivePqIndex,
    ExhaustiveSq8Index,
)
from annsearch_tpu_torch.ops import quantised as tq
from annsearch_tpu_torch.utils.data import generate_clustered_data, subsample_with_noise
from annsearch_tpu_torch.utils.dist import Dist

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def data():
    x, _ = generate_clustered_data(3000, 32, 8, seed=0)
    q = subsample_with_noise(x, 150, seed=0)
    ti, _ = at.build_exhaustive_index(x, device="cpu").query(q, 10)
    return x, q, ti


def _state(j, names, scalars=("n", "dim")):
    arrays = {a: np.asarray(getattr(j, a)).astype(
        np.float32 if str(getattr(j, a).dtype) == "bfloat16" else getattr(j, a).dtype)
        for a in names}
    meta = {s: int(getattr(j, s)) for s in scalars}
    meta["metric"] = j.metric.value
    return arrays, meta


def _shared(ti, td, ji, jd):
    shared = ti[:, :, None] == ji[:, None, :]
    dp = np.broadcast_to(td[:, :, None], shared.shape)[shared]
    dj = np.broadcast_to(jd[:, None, :], shared.shape)[shared]
    return dp, dj


# -- the port's own builds (the JAX package's tests/test_quantised_flat.py) ----


def test_bf16_recall_and_memory(data):
    x, q, ti = data
    index = at.build_exhaustive_bf16_index(x, device="cpu")
    ai, ad = at.query_exhaustive_bf16_index(q, index, 10, True)
    assert at.calculate_recall(ti, ai, 10) > 0.95
    assert ad.dtype == torch.float32 and (ad.diff(dim=1) >= -1e-5).all()
    f32 = at.build_exhaustive_index(x, device="cpu")
    assert index.memory_usage_bytes() == 3000 * 32 * 2 + 3000 * 4
    assert index.memory_usage_bytes() < f32.memory_usage_bytes() * 0.8


def test_sq8_recall_memory_and_integer_space(data):
    """The SQ8 scan reproduces the ideal integer-space distances: an int64
    numpy computation over the same codes, equal."""
    x, q, ti = data
    index = at.build_exhaustive_sq8_index(x, device="cpu")
    ai, ad = at.query_exhaustive_sq8_index(q, index, 10, True)
    assert at.calculate_recall(ti, ai, 10) > 0.78
    assert index.memory_usage_bytes() < at.build_exhaustive_index(
        x, device="cpu").memory_usage_bytes() * 0.5
    maxabs = np.abs(x).max(0)
    scales = np.where(maxabs > 0, maxabs / np.float32(128), np.float32(1)).astype(np.float32)

    def enc(v):
        s = v / scales
        return np.clip(np.trunc(s + 0.5 * np.sign(s)), -128, 127).astype(np.int64)

    full = ((enc(x)[None, :, :] - enc(q)[:, None, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(ad.numpy(), np.sort(full, 1)[:, :10].astype(np.float32))
    np.testing.assert_array_equal(np.take_along_axis(full, ai.numpy(), 1), ad.numpy())


def test_sq8_cosine(data):
    x, q, _ = data
    ti, _ = at.build_exhaustive_index(x, "cosine", device="cpu").query(q, 10)
    ai, _ = ExhaustiveSq8Index(x, "cosine", device="cpu").query(q, 10)
    assert at.calculate_recall(ti, ai, 10) > 0.7


@pytest.mark.parametrize("kind", ["pq", "opq"])
def test_pq_opq_recall_and_self_query(data, kind):
    x, q, ti = data
    build = getattr(at, f"build_exhaustive_{kind}_index")
    index = build(x, 8, "euclidean", 0, device="cpu")
    ai, _ = getattr(at, f"query_exhaustive_{kind}_index")(q, index, 10)
    assert at.calculate_recall(ti, ai, 10) > 0.5
    small = build(x[:500], 8, seed=0, device="cpu")
    si, _ = small.generate_knn(3)
    assert (si[:, 0] == torch.arange(500)).float().mean() > 0.9
    assert small.vectors_original_order().shape == (500, 32)


@pytest.mark.parametrize("kind", ["bf16", "sq8", "pq", "opq"])
def test_save_load_roundtrip_and_f64_input(tmp_path, data, kind):
    """An index saved and loaded answers as before; f64 input is cast to
    f32 (quantised storage keeps no f64 copy), so it builds the f32
    index."""
    x, q, _ = data
    cls = {"bf16": ExhaustiveIndexBf16, "sq8": ExhaustiveSq8Index,
           "pq": ExhaustivePqIndex, "opq": ExhaustiveOpqIndex}[kind]
    kw = {"m": 8, "seed": 0} if kind in ("pq", "opq") else {}
    index = cls(x[:500], device="cpu", **kw)
    p = str(tmp_path / f"{kind}.npz")
    index.save(p)
    loaded = cls.load(p, device="cpu")
    a, b = index.query(q[:10], 5), loaded.query(q[:10], 5)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert loaded.memory_usage_bytes() == index.memory_usage_bytes()
    if kind in ("bf16", "sq8"):
        c = cls(x[:500].astype(np.float64), device="cpu").query(q[:10], 5)
        assert torch.equal(a[0], c[0]) and torch.equal(a[1], c[1])


# -- the scans ------------------------------------------------------------------


def test_scans_mask_n_valid_and_ignore_the_chunk(data):
    """Rows at or past ``n_valid`` never win, and the chunk size changes no
    result, ties included (SQ8's integer distances tie often)."""
    x, q, _ = data
    idx = ExhaustiveSq8Index(x, device="cpu")
    qi = idx.quantiser.encode(torch.as_tensor(q))
    a = tq.chunked_topk_sq8(qi, idx.codes, idx.code_sqnorms, 10, Dist.EUCLIDEAN, 2500)
    b = tq.chunked_topk_sq8(qi, idx.codes, idx.code_sqnorms, 10, Dist.EUCLIDEAN, 2500,
                            db_chunk=97)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and a[1].max() < 2500
    ref = jq.chunked_topk_sq8(np.asarray(qi), idx.codes.numpy(), idx.code_sqnorms.numpy(),
                              10, JDist.EUCLIDEAN, 2500)
    np.testing.assert_array_equal(a[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(a[1].numpy(), np.asarray(ref[1]))


def test_sq8_wide_rows_sum_exact_blocks():
    """Past 1,024 columns the int8 dots sum exact FP32 blocks in int64:
    equal to an int64 product at 2,100 columns of extreme codes."""
    rng = np.random.default_rng(5)
    a = rng.choice([-128, 127], (7, 2100)).astype(np.int8)
    b = rng.choice([-128, 127], (9, 2100)).astype(np.int8)
    out = tq._int8_dots(torch.as_tensor(a), torch.as_tensor(b))
    assert out.dtype == torch.int64
    np.testing.assert_array_equal(out.numpy(), a.astype(np.int64) @ b.astype(np.int64).T)


# -- against the JAX package ------------------------------------------------------


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_bf16_against_jax(data, tmp_path, metric):
    """Both packages round the rows to bf16 (under cosine each normalises
    them itself first, so a few elements round apart): ≥ 99.9% of ids
    equal, distances within 1e-5 relative to the terms of ‖q‖² + ‖x‖² −
    2q·x (a near-zero distance is a cancellation of those terms); the JAX
    npz loads and answers the same."""
    x, q, _ = data
    j = jflat.ExhaustiveIndexBf16(x, metric)
    ji, jd = j.query(q, 10)
    t = ExhaustiveIndexBf16(x, metric, device="cpu")
    ti, td = t.query(q, 10)
    same_rows = (t.vectors.float().numpy() == np.asarray(j.vectors, np.float32)).mean()
    assert same_rows == 1.0 if metric == "euclidean" else same_rows >= 0.9999
    assert (ti.numpy() == ji).mean() >= 0.999
    dp, dj = _shared(ti.numpy(), td.numpy(), ji, jd)
    if metric == "cosine":
        terms = 2.0
    else:
        terms = (q.astype(np.float64) ** 2).sum(1).max() + float(t.sqnorms.max())
    assert np.all(np.abs(dp - dj) <= 1e-5 * (np.abs(dj) + terms))
    assert td.dtype == torch.float32
    p = str(tmp_path / "jbf16.npz")
    j.save(p)
    loaded = ExhaustiveIndexBf16.load(p, device="cpu")
    assert loaded.vectors.dtype == torch.bfloat16
    assert loaded.memory_usage_bytes() == j.memory_usage_bytes()
    li, ld = loaded.query(q, 10)
    assert (li.numpy() == ji).mean() >= 0.999


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_sq8_against_jax_bit_for_bit(data, metric):
    """On the JAX index's codes and scales, carried across: the ids and
    distances of the JAX query bit for bit. The port's own build encodes
    the same codes (euclidean: one IEEE step each); under cosine the
    distances are also the reference's IEEE f32 steps in numpy (``1 − dot
    / (√‖q̂‖² · √‖ĉ‖²)``), bit for bit."""
    x, q, _ = data
    j = jflat.ExhaustiveSq8Index(x, metric)
    ji, jd = j.query(q, 10)
    arrays, meta = _state(j, ("codes", "code_sqnorms", "scales"))
    t = interop.exhaustive_sq8_from_jax_arrays(arrays, meta, device="cpu")
    ti, td = t.query(q, 10)
    assert t.memory_usage_bytes() == j.memory_usage_bytes()
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    if metric == "euclidean":
        own = ExhaustiveSq8Index(x, device="cpu")
        np.testing.assert_array_equal(own.codes.numpy(), np.asarray(j.codes))
        np.testing.assert_array_equal(own.code_sqnorms.numpy(), np.asarray(j.code_sqnorms))
    else:
        qc = t.quantiser.encode(t._prep_queries(q)).numpy().astype(np.int64)
        c = arrays["codes"].astype(np.int64)
        dots = np.take_along_axis(qc @ c.T, ti.numpy(), 1).astype(np.float32)
        qn = np.sqrt((qc * qc).sum(1).astype(np.float32))[:, None]
        cn = np.sqrt(arrays["code_sqnorms"].astype(np.float32))[ti.numpy()]
        ref = np.where(qn * cn > 0, np.float32(1) - dots / (qn * cn), np.float32(1))
        np.testing.assert_array_equal(td.numpy(), ref)
    gi, _ = t.generate_knn(1)
    assert (gi[:, 0] == torch.arange(3000)).float().mean() > 0.9


@pytest.mark.parametrize("kind,metric", [("pq", "euclidean"), ("pq", "cosine"),
                                         ("opq", "euclidean")])
def test_pq_opq_against_jax(data, tmp_path, kind, metric):
    """On the JAX index's codebooks, codes and rotation: the recall of the
    two queries within 0.01, distances on shared ids within 2⁻⁸·(‖q‖² +
    max‖x̂‖²); the JAX npz loads; memory is counted alike."""
    x, q, ti_truth = data
    cls = jflat.ExhaustivePqIndex if kind == "pq" else jflat.ExhaustiveOpqIndex
    j = cls(x, m=8, metric=metric, seed=0)
    ji, jd = j.query(q, 10)
    names = ("codes", "code_sqnorms", "codebooks") + (("rotation",) if kind == "opq" else ())
    arrays, meta = _state(j, names, ("n", "dim", "m"))
    load = getattr(interop, f"exhaustive_{kind}_from_jax_arrays")
    t = load(arrays, meta, device="cpu")
    ti, td = t.query(q, 10)
    if metric == "cosine":
        truth, _ = at.build_exhaustive_index(x, "cosine", device="cpu").query(q, 10)
        qn = 1.0
    else:
        truth = ti_truth
        qn = (q.astype(np.float64) ** 2).sum(1).max()
    assert abs(at.calculate_recall(truth, ti, 10) - at.calculate_recall(truth, ji, 10)) <= 0.01
    assert (ti.numpy() == ji).mean() >= 0.95
    dp, dj = _shared(ti.numpy(), td.numpy(), ji, jd)
    xhat = float(t.code_sqnorms.max())
    assert np.all(np.abs(dp - dj) <= 2.0 ** -8 * (qn + xhat))
    assert t.memory_usage_bytes() == j.memory_usage_bytes()
    p = str(tmp_path / f"j{kind}.npz")
    j.save(p)
    loaded = (ExhaustivePqIndex if kind == "pq" else ExhaustiveOpqIndex).load(p, device="cpu")
    li, ld = loaded.query(q, 10)
    assert torch.equal(li, ti) and torch.equal(ld, td)
    np.testing.assert_allclose(loaded.vectors_original_order().numpy(),
                               np.asarray(j.vectors_original_order()), rtol=0, atol=1e-5)
