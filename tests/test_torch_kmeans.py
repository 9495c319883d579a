"""Parity of the port's k-means and segment layout with the JAX package.

The two packages draw from different random streams (a torch.Generator
against jax.random keys), so trained centroids are compared by quality:
inertia within 2% of JAX's on the same data. Assignment on the same
centroids agrees on ≥ 99.9% of rows (f32 near-ties may differ); the
segment layout is host integer work and must be identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from annsearch_tpu.models import kmeans as jk
from annsearch_tpu_torch.models import kmeans as tk
from annsearch_tpu_torch.utils.data import generate_clustered_data
from annsearch_tpu_torch.utils.dist import Dist

torch.set_num_threads(2)


def _inertia(x, c) -> float:
    x, c = torch.tensor(np.asarray(x)), torch.tensor(np.asarray(c))
    return float(torch.cdist(x.double(), c.double()).pow(2).min(dim=1).values.sum())


@pytest.mark.parametrize(
    "n,d,n_clusters,k",
    [
        (4000, 32, 4, 8),     # subsampled training set, D² seeding
        (3000, 32, 10, 64),   # full training set, D² seeding
        (4000, 16, 4, 256),   # k > KMEANS_SEED_CAP: random-row init
    ],
)
def test_train_centroids_inertia_matches_jax(n, d, n_clusters, k):
    x, _ = generate_clustered_data(n, d, n_clusters, seed=11)
    ct = tk.train_centroids(torch.as_tensor(x), k, seed=42)
    cj = jk.train_centroids(jnp.asarray(x), k, seed=42)
    assert ct.shape == (k, d) and torch.isfinite(ct).all()
    ratio = _inertia(x, ct) / _inertia(x, cj)
    assert abs(ratio - 1.0) <= 0.02, ratio


def test_train_sample_size_and_seed_cap():
    assert tk.KMEANS_SEED_CAP == jk.KMEANS_SEED_CAP
    for n, k in ((100, 4), (10**6, 1024), (10**6, 8), (3000, 300)):
        assert tk.train_sample_size(n, k) == jk.train_sample_size(n, k)


def test_train_centroids_is_seeded():
    x, _ = generate_clustered_data(2000, 16, 5, seed=1)
    a = tk.train_centroids(torch.as_tensor(x), 12, seed=3)
    b = tk.train_centroids(torch.as_tensor(x), 12, seed=3)
    c = tk.train_centroids(torch.as_tensor(x), 12, seed=4)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_train_centroids_cosine_is_spherical():
    x, _ = generate_clustered_data(1500, 16, 5, seed=2)
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    c = tk.train_centroids(torch.as_tensor(xn), 10, Dist.COSINE, seed=0)
    np.testing.assert_allclose(c.norm(dim=1).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("chunk", [65536, 500])
def test_assign_clusters_matches_jax(chunk):
    x, _ = generate_clustered_data(3000, 32, 8, seed=5)
    c = x[np.random.default_rng(0).choice(3000, 40, replace=False)] + 0.1
    at, dt = tk.assign_clusters(torch.as_tensor(x), torch.as_tensor(c), chunk=chunk)
    aj, dj = jk.assign_clusters(jnp.asarray(x), jnp.asarray(c), jk.Dist.EUCLIDEAN)
    assert (at.numpy() == np.asarray(aj)).mean() >= 0.999
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize(
    "n,nlist,seg_size,empty",
    [
        (1200, 8, 256, False),     # no split cells
        (1200, 4, 128, False),     # every cell split
        (5000, 30, None, True),    # default seg_size, empty clusters
        (700, 3, 64, True),
    ],
)
def test_segment_layout_identical(n, nlist, seg_size, empty):
    rng = np.random.default_rng(n + nlist)
    p = rng.random(nlist) ** 3
    if empty:
        p[::4] = 0.0
    a = rng.choice(nlist, n, p=p / p.sum())
    lt = tk.segment_layout(a, nlist, seg_size)
    lj = jk.segment_layout(a, nlist, seg_size)
    assert lt.seg_size == lj.seg_size and lt.nseg == lj.nseg
    for name in ("order", "seg_offsets", "seg_counts", "seg_cluster",
                 "cluster_ptr", "counts"):
        got, want = getattr(lt, name), getattr(lj, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("k", [1, 7, 64])
def test_cluster_sums_in_a_fixed_order(k):
    """Per-cluster sums by a stable sort and a segmented sum (no float
    atomics), empty clusters included: numpy's sums within f32 rounding,
    and bit-identical from one call to the next."""
    rng = np.random.default_rng(k)
    x = torch.as_tensor(rng.standard_normal((3000, 16)).astype(np.float32))
    a = torch.as_tensor(rng.integers(0, k, 3000) * (rng.random(3000) < 0.9))
    sums, counts = tk.cluster_sums(x, a, k)
    want = np.zeros((k, 16))
    np.add.at(want, a.numpy(), x.numpy().astype(np.float64))
    assert counts.tolist() == np.bincount(a.numpy(), minlength=k).tolist()
    np.testing.assert_allclose(sums.numpy(), want, rtol=1e-5, atol=1e-4)
    again, _ = tk.cluster_sums(x, a, k)
    assert torch.equal(sums, again)


def test_lowrank_cells_are_balanced_in_both_packages():
    """On lowrank data (12 blobs in 16 of 64 dimensions) the f32 k-means of
    both packages splits the blobs into cells of similar size (random
    init, k > 200): no cell many times the median, none empty."""
    from annsearch_tpu.utils.dist import Dist as JDist
    from annsearch_tpu_torch.utils.data import generate_data

    x, _ = generate_data("lowrank", 60_000, 64, 12, seed=42, intrinsic_dim=16)
    jc = jk.train_centroids(jnp.asarray(x), 240, seed=42)
    ja, _ = jk.assign_clusters(jnp.asarray(x), jc, JDist.EUCLIDEAN)
    tc = tk.train_centroids(torch.as_tensor(x), 240, seed=42)
    ta, _ = tk.assign_clusters(torch.as_tensor(x), tc)
    for a in (np.asarray(ja), ta.numpy()):
        counts = np.bincount(a, minlength=240)
        assert counts.min() > 0 and counts.max() < 3 * np.median(counts)
