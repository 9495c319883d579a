"""Parity of the port's kMkNN index with the JAX package's: with the JAX
index's centroids, cells and radii carried across
(``interop.kmknn_from_jax_arrays``, ``load`` of its npz), both packages are
exact, so the port's ids equal an exact scan up to ties (equal k-th
distances), under both metrics and with f64 queries; the port's own build
is held to the same. The data is scaled by 1/8 (see ``test_torch_trees``).
"""

import numpy as np
import pytest
import torch

import annsearch_tpu_torch as ta
from annsearch_tpu.models.kmknn import KmknnIndex as JKmknn
from annsearch_tpu_torch import interop
from annsearch_tpu_torch.models import kmknn as tkm
from annsearch_tpu_torch.utils.data import generate_clustered_data, subsample_with_noise

torch.set_num_threads(2)
K = 10


@pytest.fixture(scope="module")
def kdata():
    x, _ = generate_clustered_data(3000, 32, 8, seed=0)
    x = x * np.float32(0.125)
    q = subsample_with_noise(x, 150, seed=0)
    return x, q


def _carry(j):
    arrays = {name: np.asarray(getattr(j, name)) for name in (
        "vectors", "centroids", "seg_offsets", "seg_counts", "original_ids", "radii",
        "cell_counts")}
    arrays["cluster_ptr"] = np.asarray(j._layout.cluster_ptr)
    arrays["seg_cluster"] = np.asarray(j._layout.seg_cluster)
    meta = {"n": j.n, "dim": j.dim, "nlist": j.nlist, "seg_size": j.seg_size,
            "metric": j.metric.value}
    return interop.kmknn_from_jax_arrays(arrays, meta, device="cpu")


def _assert_exact(ids, d, x, q, metric):
    """``ids`` are an exact top-k: each row's distances are the k smallest
    (f64 recomputation; equal k-th distances may swap ids)."""
    ids, d = np.asarray(ids), np.asarray(d, np.float64)
    x64, q64 = x.astype(np.float64), q.astype(np.float64)
    if metric == "cosine":
        xn = x64 / np.linalg.norm(x64, axis=1, keepdims=True)
        qn = q64 / np.linalg.norm(q64, axis=1, keepdims=True)
        full = 1.0 - qn @ xn.T
    else:
        full = ((q64[:, None, :] - x64[None]) ** 2).sum(-1)
    kth = np.sort(full, axis=1)[:, K - 1]
    got = np.take_along_axis(full, ids, axis=1)
    scale = 1e-4 * (1.0 + np.abs(kth))
    assert np.all(got <= kth[:, None] + scale[:, None])          # nothing past the k-th
    np.testing.assert_allclose(d, got, rtol=1e-4, atol=1e-4)
    assert all(len(set(r)) == K for r in ids.tolist())


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_carried_index_is_exact_and_matches_jax(kdata, metric):
    x, q = kdata
    j = JKmknn(x, metric, seed=0)
    t = _carry(j)
    ids, d = t.query(q, K, exact_fallback=False)
    jids, jd = j.query(q, K, exact_fallback=False)
    _assert_exact(ids, d, x, q, metric)
    assert (ids.numpy() == np.asarray(jids)).mean() >= 0.999
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-4, atol=1e-4)
    # a one-cell first phase leaves the rest to the triangle bound
    i1, d1 = t.query(q, K, p0=1, exact_fallback=False)
    _assert_exact(i1, d1, x, q, metric)


def test_own_build_is_exact_with_f64_queries(kdata):
    x, q = kdata
    x64, q64 = x.astype(np.float64), q.astype(np.float64)
    t = ta.build_kmknn_index(x64, nlist=32, seed=0, device="cpu")
    assert t.nlist == 32 and float(t.radii.max()) > 0
    ids, d = t.query(q64, K, exact_fallback=False)
    assert d.dtype == torch.float64
    full = ((q64[:, None, :] - x64[None]) ** 2).sum(-1)
    np.testing.assert_allclose(d.numpy(), np.sort(full, axis=1)[:, :K], rtol=1e-12, atol=1e-12)
    i32, d32 = ta.query_kmknn_index(q, t, K, True)
    _assert_exact(i32, d32, x, q, "euclidean")


def test_phase2_scans_only_what_the_bound_needs(kdata):
    x, q = kdata
    t = ta.build_kmknn_index(x, nlist=32, seed=0, device="cpu")
    qp = t._prep_queries(q)
    d1, i1, need = tkm._kmknn_phase1(t, qp, K, 1)
    cd2, probes = tkm._route_kmknn(qp, t.centroids, 1)
    assert need.dtype == torch.bool and not bool(need.gather(1, probes).any())
    assert 0 < float(need.float().mean()) < 1.0
    lb = torch.clamp(cd2.sqrt() - t.radii[None, :], min=0.0) ** 2
    assert bool((lb[need] < d1[:, K - 1][:, None].expand_as(lb)[need]).all())


def test_self_query_save_load_and_fallback(kdata, tmp_path, monkeypatch):
    x, q = kdata
    j = JKmknn(x[:1000], seed=0)
    j.save(str(tmp_path / "km"))
    t = tkm.KmknnIndex.load(str(tmp_path / "km.npz"), device="cpu")
    ids, d = ta.query_kmknn_self(t, 5, True)
    assert (ids[:, 0] == torch.arange(1000)).float().mean() >= 0.99
    assert torch.equal(t.vectors_original_order(), torch.as_tensor(x[:1000]))
    t.save(str(tmp_path / "km_port"))
    back = JKmknn.load(str(tmp_path / "km_port.npz"))
    np.testing.assert_array_equal(np.asarray(back.radii), np.asarray(j.radii))
    monkeypatch.delenv("ANNSEARCH_NO_EXACT_FALLBACK", raising=False)
    fi, fd = t.query(q, K)
    _assert_exact(fi, fd, x[:1000], q, "euclidean")
    assert t.memory_usage_bytes() > 1000 * 32 * 4
