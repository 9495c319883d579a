"""Kernel K2's plain version (``flat_topk_fused`` on CPU tensors) against the
JAX package's ``flat_topk_fused`` in interpret mode, on the same numpy
inputs.

* On inputs from a coarse grid (multiples of 1/8, |v| ≤ 2) every product
  and partial sum is exact in f32, and in bf16 for ``passes=1``, so the JAX
  split-bf16 dots equal the port's FP32 dots: ids and distances agree bit
  for bit, for both metrics, ``passes`` 1, 3 and 6, depth 1 and 2.
* On clustered data the JAX test's own floors hold for the port: recall
  ≥ 0.99 (0.9 for ``passes=1``) against the exact scan and distances within
  rtol 1e-3, atol 1e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from annsearch_tpu.ops.flat_scan_pallas import flat_topk_fused as jax_fused
from annsearch_tpu.utils.dist import Dist as JDist
from annsearch_tpu_torch.ops.flat_scan_fused import (
    flat_topk_fused,
    flat_topk_fused_plain,
    fused_shapes,
    scan_plan,
    slab_rows,
)
from annsearch_tpu_torch.ops.topk import blocked_query_topk
from annsearch_tpu_torch.utils.data import generate_clustered_data
from annsearch_tpu_torch.utils.dist import Dist, normalise
from annsearch_tpu_torch.utils.metrics import calculate_recall

torch.set_num_threads(2)

METRICS = {"euclidean": (Dist.EUCLIDEAN, JDist.EUCLIDEAN), "cosine": (Dist.COSINE, JDist.COSINE)}
GRADES = [(6, 2), (3, 2), (1, 1), (1, 2), (6, 1)]


def _grid(rng, shape):
    return (rng.integers(-16, 17, shape) / 8).astype(np.float32)


def _both(q, x, k, metric, block_q=32, **kw):
    """(port ids, port dists, JAX ids, JAX dists) as numpy arrays."""
    tm, jm = METRICS[metric]
    dt, it = flat_topk_fused(torch.tensor(q), torch.tensor(x), k, tm, **kw)
    dj, ij = jax_fused(jnp.asarray(q), jnp.asarray(x), k, jm, block_q=block_q,
                       interpret=True, **kw)
    return it.numpy(), dt.numpy(), np.asarray(ij), np.asarray(dj)


@pytest.mark.parametrize("metric", list(METRICS))
@pytest.mark.parametrize("passes,depth", GRADES)
def test_grid_inputs_bit_for_bit(metric, passes, depth):
    rng = np.random.default_rng(1)
    it, dt, ij, dj = _both(_grid(rng, (50, 32)), _grid(rng, (700, 32)), 10, metric,
                           passes=passes, depth=depth, block_db=128)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(dt, dj)


@pytest.mark.parametrize("metric", list(METRICS))
def test_grid_n_valid_bit_for_bit(metric):
    rng = np.random.default_rng(2)
    x = _grid(rng, (150, 32))
    it, dt, ij, dj = _both(x[:10], x, 5, metric, block_q=16, n_valid=100, passes=3,
                           block_db=128)
    assert it.max() < 100
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(dt, dj)


def test_grid_k_exceeds_rows_bit_for_bit():
    """k 20 of 40 rows and n < 128: 40 bins are filled, the extraction's
    tail and the clamps come out as in the JAX package."""
    rng = np.random.default_rng(3)
    x = _grid(rng, (40, 32))
    it, dt, ij, dj = _both(x[:4], x, 20, "euclidean", block_q=8, passes=3, block_db=128)
    assert dt.shape == (4, 20)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(dt, dj)
    # more ranks than rows: the unfilled bins' 3e38 and clamped id 0
    it, dt, ij, dj = _both(x[:4, :8], x[:12, :8], 16, "euclidean", block_q=8, passes=6,
                           block_db=128)
    assert dt[0, 12] > 1e38
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(dt, dj)


def test_k_past_kb_pads_with_inf():
    rng = np.random.default_rng(4)
    x = _grid(rng, (300, 16))
    it, dt, ij, dj = _both(x[:3], x, 130, "euclidean", block_q=8, passes=6, block_db=128)
    assert np.isinf(dt[:, 128:]).all() and (it[:, 128:] == 0).all()
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(dt, dj)


@pytest.mark.parametrize("d", [100, 30, 160, 256])
def test_grid_odd_widths_bit_for_bit(d):
    rng = np.random.default_rng(5)
    it, dt, ij, dj = _both(_grid(rng, (20, d)), _grid(rng, (333, d)), 10, "euclidean",
                           passes=6, block_db=128)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(dt, dj)


@pytest.mark.parametrize("metric", list(METRICS))
@pytest.mark.parametrize("passes,depth", [(6, 2), (3, 2), (6, 1)])
def test_gaussian_inputs_match_jax_by_shared_cross_terms(metric, passes, depth):
    """Off the grid: at ``passes=3`` the two packages sum the same three
    bf16 cross terms of the same two-way split, in f32, in other orders; at
    ``passes=6`` the JAX kernel sums six of a three-way split and the port's
    plain version takes the fp32 product (the six terms hold all 24 bits,
    the three dropped are under 2⁻²⁴ of each product). A sum of m products
    rounds by at most m·2⁻²⁴ of the sum of their magnitudes, here under
    2⁻¹⁶ of ‖q‖² + ‖x‖² (m ≤ 6·32), so each returned distance (ascending)
    agrees within 2⁻¹⁵·(‖q‖² + max ‖x‖²), and near-ties may swap ids."""
    rng = np.random.default_rng(10)
    q = rng.standard_normal((40, 32)).astype(np.float32)
    x = rng.standard_normal((900, 32)).astype(np.float32)
    if metric == "cosine":
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    it, dt, ij, dj = _both(q, x, 10, metric, passes=passes, depth=depth, block_db=128)
    scale = (q * q).sum(1)[:, None] + (x * x).sum(1).max()
    assert (np.abs(dt - dj) <= 2.0 ** -15 * scale).all()
    assert (it == ij).mean() >= 0.98
    # the grade is the split's: one bf16 pass lies much farther off
    _, d1, _, _ = _both(q, x, 10, metric, passes=1, depth=depth, block_db=128)
    assert np.abs(d1 - dj).max() > 8 * np.abs(dt - dj).max()


@pytest.fixture(scope="module")
def clustered():
    x, _ = generate_clustered_data(700, 32, 5, seed=7)
    return x, x[:50] + np.float32(0.01)


@pytest.mark.parametrize("metric", list(METRICS))
@pytest.mark.parametrize("passes,depth", [(6, 2), (3, 2), (1, 1)])
def test_clustered_recall_and_tolerance(clustered, metric, passes, depth):
    """The three cases of the JAX package's parity test, for the port."""
    x, q = (torch.tensor(a) for a in clustered)
    tm = METRICS[metric][0]
    if tm == Dist.COSINE:
        x, q = normalise(x), normalise(q)
    de, ie = blocked_query_topk(q, x, 10, tm)
    df, i_f = flat_topk_fused(q, x, 10, tm, passes=passes, depth=depth, block_db=128)
    assert calculate_recall(ie, i_f, 10) >= (0.99 if passes >= 3 else 0.9)
    if passes >= 3:
        assert np.allclose(de.numpy(), df.numpy(), rtol=1e-3, atol=1e-2)
    assert (df.diff(dim=1) >= -1e-6).all()
    # and beside the JAX kernel: the same neighbours up to near-ties
    dj, ij = jax_fused(jnp.asarray(q.numpy()), jnp.asarray(x.numpy()), 10,
                       METRICS[metric][1], passes=passes, depth=depth, block_q=32,
                       block_db=128, interpret=True)
    assert calculate_recall(np.array(ij), i_f, 10) >= (0.99 if passes >= 3 else 0.9)


def test_three_of_the_top_share_a_class():
    """Rows 5, 133 and 261 fall in class 5 (B = 128) and are the three
    nearest: depth 2 keeps the nearest two and loses exactly the third, in
    both packages; depth 1 keeps only the nearest."""
    rng = np.random.default_rng(6)
    x = _grid(rng, (400, 16)) + np.float32(8.0)
    q = np.zeros((1, 16), np.float32)
    for rank, row in enumerate((261, 5, 133)):
        x[row] = 0
        x[row, 0] = (rank + 1) / 8
    it, dt, ij, dj = _both(q, x, 8, "euclidean", block_q=8, passes=6, block_db=128)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(dt, dj)
    assert it[0, :2].tolist() == [261, 5] and 133 not in it[0]
    exact = blocked_query_topk(torch.tensor(q), torch.tensor(x), 8, Dist.EUCLIDEAN)[1]
    assert exact[0, :3].tolist() == [261, 5, 133]
    assert len(set(exact[0].tolist()) - set(it[0].tolist())) == 1
    it1 = flat_topk_fused(torch.tensor(q), torch.tensor(x), 8, Dist.EUCLIDEAN, passes=6,
                          depth=1, block_db=128)[1]
    assert it1[0, 0] == 261 and 5 not in it1[0] and 133 not in it1[0]


def test_shapes_and_plain_alias():
    assert fused_shapes(1_000_000, 16) == (16, 2048)
    assert fused_shapes(40, 3, 128) == (8, 128)
    assert fused_shapes(700, 65) == (128, 1024)
    assert slab_rows(2048) == 16_384 and slab_rows(128, 1) == 524_288
    assert scan_plan(30) == scan_plan(32) == (0, 6, 8, 13_312, 116_736)   # six one-term tiles
    assert scan_plan(32, passes=6) == (0, 2, 8, 13_312, 133_120)    # three terms a side
    assert scan_plan(128, passes=6) == (0, 2, 2, 50_176, 200_704)
    assert scan_plan(160, passes=3)[:3] == (0, 2, 3) and scan_plan(160, passes=6)[0] == 1
    assert scan_plan(256, passes=6) == (1, 4, 3, 50_176, 201_728)   # the wide scan
    assert scan_plan(1024) == (1, 4, 8, 17_408, 190_464)
    rng = np.random.default_rng(8)
    q, x = torch.tensor(_grid(rng, (5, 8))), torch.tensor(_grid(rng, (200, 8)))
    a = flat_topk_fused(q, x, 4, Dist.EUCLIDEAN, passes=6)
    b = flat_topk_fused_plain(q, x, 4, Dist.EUCLIDEAN, passes=6)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert a[1].dtype == torch.int64 and flat_topk_fused.launches == 0


def _c_constants() -> dict:
    """The integer constants of ``csrc/flat_scan.cu`` (``constexpr int kX =
    <expression of earlier constants>;``), evaluated in order."""
    import re
    from pathlib import Path

    from annsearch_tpu_torch.ops import _cuda

    src = (Path(_cuda.SOURCE_DIR) / "flat_scan.cu").read_text()
    env: dict = {}
    for name, expr in re.findall(r"^constexpr int (k\w+) = ([^;]+);", src, re.M):
        env[name] = eval(expr.replace("/", "//"), {}, dict(env))
    return env


def _c_plan(dk: int, terms: int, c: dict) -> tuple:
    """``csrc/flat_scan.cu::scan_plan`` / ``wide_plan`` written out from the
    source's constants: the narrow scan where the query terms and two
    stages of two tiles fit, else the wide scan."""
    def stage_of(b):
        return (b + 1023) // 1024 * 1024

    nch = (dk + c["kChunk"] - 1) // c["kChunk"]
    tile = nch * terms * c["kBox"] + c["kCS"] * 4
    fixed = 2048 + 2 * nch * terms * c["kQBox"]
    tps = max(2, c["kStageTarget"] // tile // 2 * 2)
    stages = (c["kSmemMax"] - fixed) // stage_of(tps * tile)
    if stages >= 2:
        s = min(stages, c["kMaxStages"])
        return 0, tps, s, stage_of(tps * tile), fixed + s * stage_of(tps * tile)
    stage = stage_of(terms * (c["kXUnit"] + 2 * c["kQBox"]) + c["kUnit"] * c["kCS"] * 4)
    s = min((c["kSmemMax"] - 2048 - c["kWideBins"]) // stage, c["kMaxStages"])
    return 1, c["kUnit"], s, stage, 2048 + c["kWideBins"] + s * stage


def test_scan_plan_mirrors_the_c_plan():
    """``scan_plan`` (which scan, tiles a stage or unit, stages, bytes a
    stage, shared memory) is the C plan for every width and term count, the
    C plan computed from ``csrc/flat_scan.cu``'s own constants; every plan
    fits 227 KiB with at least two stages, and the wide scan takes exactly
    the widths the narrow one cannot (the card test
    ``test_k2_plans_agree_with_the_library`` asks the built library)."""
    c = _c_constants()
    assert c["kUnit"] == 4 and c["kXUnit"] == 4 * c["kBox"] and c["kWideBins"] == 3 * 16 * 256 * 4
    for dk in range(32, 4128, 32):
        for passes, terms in ((1, 1), (3, 2), (6, 3)):
            plan = scan_plan(dk, passes)
            assert plan == _c_plan(dk, terms, c), (dk, passes)
            assert plan[2] >= 2 and plan[4] <= c["kSmemMax"]
            assert plan[0] == (dk > {1: 416, 2: 192, 3: 128}[terms])


def test_given_sqnorms_are_used():
    rng = np.random.default_rng(9)
    q, x = torch.tensor(_grid(rng, (5, 8))), torch.tensor(_grid(rng, (200, 8)))
    sn = (x * x).sum(1)
    a = flat_topk_fused(q, x, 4, Dist.EUCLIDEAN, x_sqnorm=sn, passes=6)
    b = flat_topk_fused(q, x, 4, Dist.EUCLIDEAN, passes=6)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    far = sn.clone()
    far[b[1][0, 0]] += 1000.0          # the nearest row pushed away
    c = flat_topk_fused(q, x, 4, Dist.EUCLIDEAN, x_sqnorm=far, passes=6)
    assert c[1][0, 0] != b[1][0, 0]
