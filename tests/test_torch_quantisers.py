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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tq.ProductQuantiser.train(x, 16)
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
