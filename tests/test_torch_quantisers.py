"""Parity of the port's scalar-codebook product quantiser with the JAX
package's, on the same residuals.

Codebook training is deterministic in both packages (sorted rows,
quantile init, midpoint Lloyd), so codebooks agree within rtol/atol 1e-5.
Codes, and their int8 requantisation, agree on ≥ 99.9% of entries; the
rest are off by one (f32 near-ties at a midpoint)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from annsearch_tpu.models.quantised import quantisers as jq
from annsearch_tpu_torch.models.quantised import quantisers as tq
from annsearch_tpu_torch.utils.data import generate_clustered_data

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def residuals():
    """Residuals of clustered 128-d data against its cluster means."""
    x, labels = generate_clustered_data(1800, 128, 6, seed=3)
    means = np.stack([x[labels == c].mean(0) for c in range(6)])
    return (x - means[labels]).astype(np.float32)


def _agree_or_off_by_one(a, b, min_equal=0.999):
    a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
    assert (a == b).mean() >= min_equal, (a == b).mean()
    assert np.abs(a - b).max() <= 1


@pytest.mark.parametrize("n", [5, 300, 1200, 5000])
def test_prefix_sum_matches_jax_cumsum_bit_for_bit(n):
    v = np.random.default_rng(n).standard_normal((4, n)).astype(np.float32) * 3
    np.testing.assert_array_equal(
        tq._prefix_sum(torch.as_tensor(v)).numpy(),
        np.asarray(jnp.cumsum(jnp.asarray(v), axis=1)),
    )


@pytest.mark.parametrize("n,k", [(1200, 256), (5000, 256), (400, 64)])
def test_train_scalar_codebooks_matches_jax(n, k):
    rng = np.random.default_rng(n)
    v = (rng.standard_normal((16, n)) * rng.uniform(0.5, 3, (16, 1))).astype(np.float32)
    ct = tq._train_scalar_codebooks(torch.as_tensor(v), k)
    cj = jq._train_scalar_codebooks(jnp.asarray(v), k)
    assert ct.shape == (16, k, 1)
    assert torch.all(ct[:, 1:] >= ct[:, :-1])
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def quantisers(residuals):
    pt = tq.ProductQuantiser.train(torch.as_tensor(residuals), 128, seed=42)
    pj = jq.ProductQuantiser.train(jnp.asarray(residuals), 128, seed=42)
    return pt, pj


def test_train_matches_jax(quantisers):
    pt, pj = quantisers
    assert pt.codebooks.shape == (128, 256, 1)
    np.testing.assert_allclose(
        pt.codebooks.numpy(), np.asarray(pj.codebooks), rtol=1e-5, atol=1e-5
    )


def test_train_pads_small_training_sets():
    x = np.random.default_rng(1).standard_normal((100, 32)).astype(np.float32)
    pt = tq.ProductQuantiser.train(torch.as_tensor(x), 32)
    pj = jq.ProductQuantiser.train(jnp.asarray(x), 32)
    assert pt.codebooks.shape == (32, 256, 1)
    np.testing.assert_allclose(pt.codebooks.numpy(), np.asarray(pj.codebooks),
                               rtol=1e-5, atol=1e-5)


def test_encode_decode_matches_jax(residuals, quantisers):
    pt, pj = quantisers
    # both encode with the SAME codebooks (the JAX ones)
    pt_same = tq.ProductQuantiser(torch.tensor(np.asarray(pj.codebooks)), 128, 128)
    ct = pt_same.encode(torch.as_tensor(residuals), chunk=500)
    cj = pj.encode(jnp.asarray(residuals))
    assert ct.dtype == torch.uint8 and ct.shape == (1800, 128)
    _agree_or_off_by_one(ct.numpy(), cj)
    np.testing.assert_array_equal(
        pt_same.decode(torch.tensor(np.asarray(cj))).numpy(),
        np.asarray(pj.decode(cj)),
    )


def test_int8_requantisation_matches_jax(residuals, quantisers):
    """The IVF-PQ fast-scan requantisation (round half to even in both)."""
    _, pj = quantisers
    books = np.array(pj.codebooks)
    scales = np.maximum(np.abs(books[:, :, 0]).max(1), 1e-12) / 127.0
    pt = tq.ProductQuantiser(torch.as_tensor(books), 128, 128)
    dec_t = pt.decode(pt.encode(torch.as_tensor(residuals)))
    q_t = torch.clamp(torch.round(dec_t / torch.as_tensor(scales, dtype=torch.float32)),
                      -127, 127).to(torch.int8)
    dec_j = pj.decode(pj.encode(jnp.asarray(residuals)))
    q_j = jnp.clip(jnp.round(dec_j / jnp.asarray(scales, jnp.float32)), -127, 127).astype(jnp.int8)
    _agree_or_off_by_one(q_t.numpy(), q_j)


def test_round_half_to_even():
    v = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5], np.float32)
    np.testing.assert_array_equal(torch.round(torch.as_tensor(v)).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(v))))


def test_unported_and_invalid_configurations_raise():
    x = torch.zeros((300, 64))
    # ds = 4 trains since the batched subspace k-means was ported
    assert tq.ProductQuantiser.train(x, 16).codebooks.shape == (16, 256, 4)
    with pytest.raises(ValueError, match="divisible"):
        tq.ProductQuantiser.train(x, 48)
    with pytest.raises(ValueError, match="dim >= 32"):
        tq.ProductQuantiser.train(torch.zeros((300, 16)), 16)


# -- the bf16 codec and the scalar quantiser (SQ8) -----------------------------


def _sq8_data():
    """Clustered rows, an all-zero column, and values exactly on the ±0.5
    steps of the quantisation grid (and at ±128 steps, which clamp)."""
    x, _ = generate_clustered_data(1500, 48, 6, seed=7)
    x[:, 5] = 0.0
    s = np.abs(x).max(0) / 128.0
    x[:40, 7] = (np.arange(-20, 20) + 0.5) * s[7]
    x[40, 8], x[41, 8] = 128 * s[8], -128 * s[8]
    return x.astype(np.float32)


def test_scalar_quantiser_matches_jax_bit_for_bit():
    x = _sq8_data()
    qt = tq.ScalarQuantiser.train(torch.as_tensor(x))
    qj = jq.ScalarQuantiser.train(jnp.asarray(x))
    np.testing.assert_array_equal(qt.scales.numpy(), np.asarray(qj.scales))
    assert qt.scales[5] == 1.0                       # the all-zero column
    probe = np.concatenate([x, x * np.float32(1.7), -x[:100]])   # clamps too
    ct = qt.encode(torch.as_tensor(probe))
    cj = np.asarray(qj.encode(jnp.asarray(probe)))
    assert ct.dtype == torch.int8
    np.testing.assert_array_equal(ct.numpy(), cj)
    assert ct.min() == -128 and ct.max() == 127
    np.testing.assert_array_equal(qt.decode(ct).numpy(), np.asarray(qj.decode(jnp.asarray(cj))))
    assert qt.memory_usage_bytes() == qj.memory_usage_bytes() == 48 * 4


def test_scalar_quantiser_rounds_half_away_from_zero():
    q = tq.ScalarQuantiser(torch.ones(6))
    codes = q.encode(torch.tensor([[-2.5, -1.5, -0.5, 0.5, 1.5, 2.5]]))
    np.testing.assert_array_equal(codes.numpy()[0], [-3, -2, -1, 1, 2, 3])


def test_bf16_codec_matches_jax_bit_for_bit():
    x = np.random.default_rng(2).standard_normal((200, 33)).astype(np.float32) * 7
    t = tq.bf16_encode(torch.as_tensor(x))
    j = jq.bf16_encode(jnp.asarray(x))
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(tq.bf16_decode(t).numpy(), np.asarray(jq.bf16_decode(j)))


# -- PQ with ds > 1, the code tile decode and OPQ ---------------------------------
#
# Codebooks of ds > 1 are seeded from random draws, so the two packages'
# differ in value: encode, decode and the code norms are compared on the
# JAX codebooks carried over, training by its quantisation error.


@pytest.fixture(scope="module")
def jax_pq16(residuals):
    return jq.ProductQuantiser.train(jnp.asarray(residuals), 16, seed=42)


def test_encode_pq_matches_jax_on_carried_codebooks(residuals, jax_pq16):
    books = torch.tensor(np.asarray(jax_pq16.codebooks))
    assert books.shape == (16, 256, 8)
    ct = tq._encode_pq(torch.as_tensor(residuals), books, chunk=700)   # a ragged last chunk
    cj = np.asarray(jax_pq16.encode(jnp.asarray(residuals)))
    assert ct.dtype == torch.uint8 and ct.shape == (1800, 16)
    # codes equal, near-ties of the f32 argmin aside
    assert (ct.numpy() == cj).mean() >= 0.999


def test_pq_decode_tile_and_decode_match_jax_bit_for_bit(residuals, jax_pq16):
    from annsearch_tpu.ops.quantised import pq_decode_tile as j_tile
    from annsearch_tpu_torch.ops.quantised import pq_decode_tile as t_tile

    cj = jax_pq16.encode(jnp.asarray(residuals))
    books = torch.tensor(np.asarray(jax_pq16.codebooks))
    codes = torch.tensor(np.asarray(cj))
    got = t_tile(codes, books)
    assert got.shape == (1800, 128) and got.dtype == torch.float32
    # the JAX tile decode is a one-hot matmul in f32 on the CPU: exact
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_tile(cj, jax_pq16.codebooks)))
    pt = tq.ProductQuantiser(books, 16, 128)
    np.testing.assert_array_equal(pt.decode(codes).numpy(), np.asarray(jax_pq16.decode(cj)))


def test_code_sqnorms_match_jax_bit_for_bit(residuals, jax_pq16):
    cj = jax_pq16.encode(jnp.asarray(residuals))
    pt = tq.ProductQuantiser(torch.tensor(np.asarray(jax_pq16.codebooks)), 16, 128)
    got = pt.code_sqnorms(torch.tensor(np.asarray(cj)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_pq16.code_sqnorms(cj)))
    # and they are the squared norms of the decoded rows
    np.testing.assert_allclose(got.numpy(), (np.asarray(jax_pq16.decode(cj)) ** 2).sum(1),
                               rtol=1e-5)


def _quantisation_error(pq, x):
    return float(((pq.decode(pq.encode(x)) - x) ** 2).sum(-1).mean())


@pytest.mark.parametrize("n,m", [(1800, 16), (1800, 32), (12000, 16)],
                         ids=["lloyd-m16", "lloyd-m32", "minibatch-m16"])
def test_subspace_training_quality_matches_jax(n, m):
    """Full Lloyd (n ≤ 10,000) and mini-batch (above): the port's mean
    squared quantisation error is within 10% of the JAX package's on the
    same rows (random streams differ)."""
    rng = np.random.default_rng(m)
    mix = rng.standard_normal((128, 128)).astype(np.float32) / np.sqrt(128)
    x = (rng.standard_normal((n, 128)).astype(np.float32) @ mix).astype(np.float32)
    pt = tq.ProductQuantiser.train(torch.as_tensor(x), m, seed=1)
    pj = jq.ProductQuantiser.train(jnp.asarray(x), m, seed=1)
    assert pt.codebooks.shape == (m, 256, 128 // m)
    et = _quantisation_error(pt, torch.as_tensor(x))
    ej = float(((np.asarray(pj.decode(pj.encode(jnp.asarray(x)))) - x) ** 2).sum(-1).mean())
    assert et <= 1.1 * ej, (et, ej)
    # the same seed gives the same codebooks
    again = tq.ProductQuantiser.train(torch.as_tensor(x), m, seed=1)
    assert torch.equal(again.codebooks, pt.codebooks)


def test_subspace_training_pads_small_training_sets():
    x = torch.as_tensor(np.random.default_rng(3).standard_normal((100, 64)).astype(np.float32))
    pt = tq.ProductQuantiser.train(x, 16)
    assert pt.codebooks.shape == (16, 256, 4) and (pt.codebooks[:, 100:] == 1e30).all()
    assert pt.encode(x).max() < 100


def _correlated(n, d, seed):
    """Rows with strongly correlated dimensions (a random rotation of axes
    with decaying variances), where a learned rotation helps PQ."""
    rng = np.random.default_rng(seed)
    basis, _ = np.linalg.qr(rng.standard_normal((d, d)))
    var = np.exp(-np.arange(d) / 6.0)
    return ((rng.standard_normal((n, d)) * np.sqrt(var)) @ basis.T).astype(np.float32)


def test_opq_rotation_is_orthogonal_and_beats_pq():
    x = _correlated(3000, 64, 5)
    xt = torch.as_tensor(x)
    opq = tq.OptimisedProductQuantiser.train(xt, 8, seed=3)
    r = opq.rotation
    assert r.shape == (64, 64)
    assert (r @ r.T - torch.eye(64)).abs().max() <= 1e-4
    pq = tq.ProductQuantiser.train(xt, 8, seed=3)
    e_opq = float(((opq.decode(opq.encode(xt)) - xt) ** 2).sum(-1).mean())
    e_pq = _quantisation_error(pq, xt)
    assert e_opq <= e_pq, (e_opq, e_pq)
    # and about as good as the JAX package's OPQ on the same rows
    oj = jq.OptimisedProductQuantiser.train(jnp.asarray(x), 8, seed=3)
    e_j = float(((np.asarray(oj.decode(oj.encode(jnp.asarray(x)))) - x) ** 2).sum(-1).mean())
    assert e_opq <= 1.15 * e_j, (e_opq, e_j)
    assert opq.memory_usage_bytes() == oj.memory_usage_bytes()


def test_opq_on_carried_state_matches_jax():
    """The JAX rotation and codebooks carried over: rotate, encode and
    decode agree (codes up to f32 near-ties)."""
    x = _correlated(1500, 64, 6)
    oj = jq.OptimisedProductQuantiser.train(jnp.asarray(x), 16, seed=0)
    pt = tq.ProductQuantiser(torch.tensor(np.asarray(oj.pq.codebooks)), 16, 64)
    ot = tq.OptimisedProductQuantiser(pt, torch.tensor(np.asarray(oj.rotation)))
    xt = torch.as_tensor(x)
    np.testing.assert_allclose(ot.rotate(xt).numpy(), np.asarray(oj.rotate(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    cj = np.asarray(oj.encode(jnp.asarray(x)))
    assert (ot.encode(xt).numpy() == cj).mean() >= 0.999
    np.testing.assert_allclose(ot.decode(torch.tensor(cj)).numpy(),
                               np.asarray(oj.decode(jnp.asarray(cj))), rtol=1e-5, atol=1e-5)
