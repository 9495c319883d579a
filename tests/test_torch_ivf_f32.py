"""The plain IVF index (f32 cells) as a whole, port against the JAX package:
the exact tier (kernel K1c-f32 and the elementwise f32 rescore), its
certificate, the approximate tier (kernel K1d-f32) and the f64 path.

* Index state carried over (``interop``, or ``save`` → the port's
  ``load``), so that both packages query the same centroids and cells. The
  JAX side runs with ``ANNSEARCH_FUSED_EXACT=1``: its fused exact tier then
  runs in interpret mode on the CPU, as on the TPU. Ids agree on ≥ 99.9%
  of entries and distances within rtol 1e-5 / atol 1e-5. The euclidean
  data is scaled by 1/8 and put on the 1/64 grid: its values are then
  exact in bf16, so the JAX side's split-bf16 dots and the port's f32 dots
  are both exact (the approximate tier's distances come straight from the
  scan, with no f32 rescore).
* Two layouts: split cells (128-row segments: the compact pair lists) and
  unsplit ones (the dense expansion).
* The f64 path against the JAX package at 1e-12, and the certificate
  against a numpy f64 brute force.
"""

import numpy as np
import pytest
import torch

import annsearch_tpu_torch as at
from annsearch_tpu.models.exhaustive import ExhaustiveIndex as JExhaustive
from annsearch_tpu.models.ivf import IvfIndex as JIvf
from annsearch_tpu_torch.interop import IVF_ARRAYS, IVF_SCALARS, ivf_from_jax_arrays
from annsearch_tpu_torch.models.ivf import IvfIndex
from annsearch_tpu_torch.models.quantised.ivf import IvfPqIndex
from annsearch_tpu_torch.ops import ivf_scan_fused as tsf
from annsearch_tpu_torch.utils.data import generate_clustered_data, subsample_with_noise

torch.set_num_threads(2)

K = 10
#: query kinds, as both packages' ``query`` takes them
QUERIES = {
    "exact": dict(nprobe=2),
    "approx": dict(nprobe=2, approx=True),
    "certified": dict(nprobe=1, certify=True),
}
# (nlist, seg_size, most segments of one cell)
LAYOUTS = {"split": (6, 128, 2), "unsplit": (8, 512, 1)}


def _jax_state(j):
    arrays = {name: np.asarray(getattr(j, name)) for name in IVF_ARRAYS if name != "cluster_ptr"}
    arrays["cluster_ptr"] = np.asarray(j._cluster_ptr)
    meta = {name: int(getattr(j, name)) for name in IVF_SCALARS}
    meta["metric"] = j.metric.value
    return arrays, meta


@pytest.fixture(scope="module")
def data48():
    x, _ = generate_clustered_data(1500, 48, 6, seed=3)
    q = subsample_with_noise(x, 30, seed=4)
    # the 1/64 grid: |x| < 15, so 8·x rounds to ≤ 8-bit integers
    return np.round(x * 8) / np.float32(64), np.round(q * 8) / np.float32(64)


@pytest.fixture(
    scope="module",
    params=[(m, lay) for m in ("euclidean", "cosine") for lay in LAYOUTS],
    ids=lambda p: "-".join(p),
)
def carried(request, data48):
    """A JAX ``IvfIndex``, its answers to each query kind, and the port's
    index built from its state."""
    metric, lay = request.param
    nlist, seg_size, s_min = LAYOUTS[lay]
    x, q = data48
    j = JIvf(x, metric, nlist=nlist, seg_size=seg_size)
    s_max = int(np.diff(np.asarray(j._cluster_ptr)).max())
    assert (s_max == 1) if s_min == 1 else (s_max >= s_min)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ANNSEARCH_FUSED_EXACT", "1")
        answers = {kind: j.query(q, K, **kw) for kind, kw in QUERIES.items()}
    return j, q, answers


def _assert_same_answers(ids, d, jids, jd):
    assert ids.dtype == torch.int64 and d.dtype == torch.float32
    assert ids.shape == jids.shape
    assert (ids.numpy() == np.asarray(jids)).mean() >= 0.999
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", QUERIES)
def test_interop_index_answers_like_jax(carried, kind):
    j, q, answers = carried
    port = ivf_from_jax_arrays(*_jax_state(j), device="cpu")
    assert port.mode == "f32" and port.seg_size == j.seg_size
    assert port.storage.dtype == torch.float32
    ids, d = port.query(q, K, **QUERIES[kind])
    _assert_same_answers(ids, d, *answers[kind])


@pytest.mark.parametrize("kind", QUERIES)
def test_jax_save_then_port_load(carried, kind, tmp_path):
    j, q, answers = carried
    path = str(tmp_path / "jax_ivf.npz")
    j.save(path)
    port = IvfIndex.load(path, device="cpu")
    via_interop = ivf_from_jax_arrays(*_jax_state(j), device="cpu")
    ids, d = port.query(q, K, **QUERIES[kind])
    ids2, d2 = via_interop.query(q, K, **QUERIES[kind])
    assert torch.equal(ids, ids2) and torch.equal(d, d2)
    _assert_same_answers(ids, d, *answers[kind])


def test_port_save_loads_in_both_packages(carried, tmp_path):
    j, q, answers = carried
    port = ivf_from_jax_arrays(*_jax_state(j), device="cpu")
    path = str(tmp_path / "port_ivf.npz")
    port.save(path)
    again = IvfIndex.load(path, device="cpu")
    a = port.query(q, K, nprobe=2)
    b = again.query(q, K, nprobe=2)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    jj = JIvf.load(path)
    np.testing.assert_array_equal(np.asarray(jj.storage), port.storage.numpy())
    _assert_same_answers(*a, *answers["exact"])


def test_exact_tier_launches_the_f32_kernels_only_on_the_card(carried):
    j, q, _ = carried
    port = ivf_from_jax_arrays(*_jax_state(j), device="cpu")
    before = (tsf.ivf_cell_scan_f32_exact.launches, tsf.ivf_cell_scan_f32_fold.launches)
    port.query(q, K, nprobe=2)
    port.query(q, K, nprobe=2, approx=True)
    assert (tsf.ivf_cell_scan_f32_exact.launches, tsf.ivf_cell_scan_f32_fold.launches) == before


def test_short_pool_repeats_ids_as_jax():
    """A query whose probed cells hold fewer than k + 8 rows: the exact
    selection pads its pool with (3e38, lane 0), the rescore keeps those
    finite entries and scores them as the segment's first row, so the
    answer repeats that id — in the JAX package as in the port."""
    x, _ = generate_clustered_data(60, 16, 4, seed=11)
    x = np.round(x * 8) / np.float32(64)
    j = JIvf(x, "euclidean", nlist=6, seg_size=128)
    q = x[:5] + np.float32(1 / 64)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ANNSEARCH_FUSED_EXACT", "1")
        jids, jd = j.query(q, 15, nprobe=1)
    ids, d = ivf_from_jax_arrays(*_jax_state(j), device="cpu").query(q, 15, nprobe=1)
    np.testing.assert_array_equal(ids.numpy(), jids)
    np.testing.assert_allclose(d.numpy(), jd, rtol=1e-5, atol=1e-5)
    assert any(len(set(row)) < 15 for row in ids.tolist())


# -- f64 ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def data64():
    x, _ = generate_clustered_data(800, 24, 4, seed=21)
    q = subsample_with_noise(x, 20, seed=22)
    return x.astype(np.float64) * 0.125 + 1e-9, q.astype(np.float64) * 0.125


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_f64_ivf_matches_jax(data64, metric, monkeypatch):
    """Every cell probed: both packages' f32 scans pool the exact 2k
    nearest, and the host f64 rescores agree to 1e-12."""
    x, q = data64
    port = IvfIndex(x, metric, nlist=4, seg_size=128, device="cpu")
    ids, d = port.query(q, K, nprobe=4)
    monkeypatch.setenv("ANNSEARCH_FUSED_EXACT", "1")
    jids, jd = JIvf(x, metric, nlist=4, seg_size=128).query(q, K, nprobe=4)
    assert d.dtype == torch.float64
    np.testing.assert_array_equal(ids.numpy(), jids)
    np.testing.assert_allclose(d.numpy(), jd, rtol=1e-12, atol=1e-12)
    # f32 queries to the same index answer at f32 grade
    assert port.query(q.astype(np.float32), K, nprobe=4)[1].dtype == torch.float32


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_f64_certified_is_exact(data64, metric):
    x, q = data64
    port = IvfIndex(x, metric, nlist=8, seg_size=128, device="cpu")
    ids, d = port.query(q, K, nprobe=1, certify=True)
    bi, bd = _brute_f64(x, q, K, metric)
    np.testing.assert_array_equal(ids.numpy(), bi)
    np.testing.assert_allclose(d.numpy(), bd, rtol=1e-12, atol=1e-12)


def test_ivf_pq_accepts_f64_as_its_f32_build():
    x, _ = generate_clustered_data(600, 32, 4, seed=5)
    a = IvfPqIndex(x, nlist=4, m=32, seg_size=128, device="cpu")
    b = IvfPqIndex(x.astype(np.float64), nlist=4, m=32, seg_size=128, device="cpu")
    assert b._x64 is None                              # quantised: no f64 copy
    assert torch.equal(a.storage, b.storage) and torch.equal(a.centroids, b.centroids)
    ra = a.query(x[:10], 5, nprobe=2, approx=True)
    rb = b.query(x[:10].astype(np.float64), 5, nprobe=2, approx=True)
    assert torch.equal(ra[0], rb[0]) and torch.equal(ra[1], rb[1])


# -- certificate --------------------------------------------------------------


def _brute_f64(x, q, k, metric):
    """Numpy f64 brute force (cosine: 1 − similarity of unit rows)."""
    x, q = np.asarray(x, np.float64), np.asarray(q, np.float64)
    if metric == "cosine":
        x = x / np.linalg.norm(x, axis=1, keepdims=True)
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
        dist = 1.0 - q @ x.T
    else:
        dist = ((q[:, None, :] - x[None]) ** 2).sum(-1)
    ids = np.argsort(dist, axis=1, kind="stable")[:, :k]
    return ids, np.take_along_axis(dist, ids, axis=1)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_certificate_reaches_recall_one(metric):
    x, _ = generate_clustered_data(3000, 32, 12, seed=8)
    q = subsample_with_noise(x, 60, seed=9)
    idx = at.build_ivf_index(x, nlist=24, dist_metric=metric, seed=1, device="cpu")
    truth, _ = _brute_f64(x, q, K, metric)
    plain, _ = at.query_ivf_index(q, idx, K, nprobe=1)
    cert, dc = at.query_ivf_index(q, idx, K, nprobe=1, return_dist=True, certify=True)
    assert at.calculate_recall(truth, plain, K) < 1.0    # nprobe 1 is starved
    assert at.calculate_recall(truth, cert, K) == 1.0
    assert torch.all(dc[:, 1:] >= dc[:, :-1])


def test_cell_radii_bound_every_row():
    x, _ = generate_clustered_data(1000, 16, 5, seed=2)
    idx = IvfIndex(x, nlist=6, seg_size=128, device="cpu")
    owner = idx._owner_clusters()
    rows = idx.storage[: idx.n]
    dist = (rows - idx.centroids[owner]).norm(dim=1)
    assert torch.all(dist <= idx._cell_radii()[owner])


# -- the facade and the contract ----------------------------------------------


def test_facade_and_self_queries(data48):
    x, q = data48
    idx = at.build_ivf_index(x, nlist=6, device="cpu")
    ids, none = at.query_ivf_index(q, idx, 5, nprobe=2)
    assert none is None and ids.shape == (len(q), 5)
    ids2, d = at.query_ivf_index(q, idx, 5, nprobe=2, return_dist=True)
    assert torch.equal(ids, ids2) and torch.all(d[:, 1:] >= d[:, :-1])
    sids, sd = at.query_ivf_self(idx, 3, nprobe=2, return_dist=True)
    assert sids.shape == (len(x), 3) and (sids[:, 0] == torch.arange(len(x))).all()
    assert torch.all(sd[:, 0] <= 1e-5)
    ex = at.build_exhaustive_index(x, device="cpu")
    eids, ed = at.query_exhaustive_self(ex, 3, return_dist=True)
    jids, jd = JExhaustive(x, "euclidean").generate_knn(3)
    assert (eids.numpy() == jids).mean() >= 0.999
    np.testing.assert_allclose(ed.numpy(), jd, rtol=1e-5, atol=1e-5)


def test_result_contract_and_k_clamp(data48):
    x, q = data48
    idx = IvfIndex(x, nlist=6, seed=0, device="cpu")
    ids, d = idx.query(q, K, nprobe=6)               # every cell: exact
    bi, bd = _brute_f64(x, q, K, "euclidean")
    assert (ids.numpy() == bi).mean() >= 0.999
    np.testing.assert_allclose(d.numpy(), bd, rtol=1e-5, atol=1e-5)
    small = IvfIndex(x[:40], nlist=2, seed=0, seg_size=128, device="cpu")
    ids, d = small.query(x[:3], 50, nprobe=2)        # k clamps to n
    assert ids.shape == (3, 40) and (ids[:, 0] == torch.arange(3)).all()
    assert torch.isfinite(d).all() and torch.all(d[:, 1:] >= d[:, :-1])
    wide, _ = idx.query(q, K, nprobe=2, k_scan=2 * K)
    assert wide.shape == (len(q), 2 * K)


@pytest.mark.parametrize("approx", [False, True], ids=["exact", "approx"])
@pytest.mark.parametrize("cls", ["IvfIndex", "IvfIndexBf16", "IvfSq8Index"])
def test_q_split_is_ignored_outside_the_int8_decode_tier(data48, cls, approx):
    """As in the JAX package, ``q_split`` picks the query terms only in the
    approximate tier of the int8-decode modes (IVF-PQ, where ``True`` is
    kernel K1b); every other index and tier ignores it."""
    from annsearch_tpu_torch.models.quantised import ivf as qivf

    x, q = data48
    index_cls = IvfIndex if cls == "IvfIndex" else getattr(qivf, cls)
    idx = index_cls(x, nlist=6, device="cpu")
    ids, d = idx.query(q, 5, nprobe=2, approx=approx, q_split=True)
    ids0, d0 = idx.query(q, 5, nprobe=2, approx=approx)
    assert torch.equal(ids, ids0) and torch.equal(d, d0)


def test_unported_options_raise(data48):
    x, q = data48
    idx = IvfIndex(x, nlist=6, device="cpu")
    with pytest.raises(ValueError, match="exact f32 tier"):
        idx.query(q, 5, approx=True, certify=True)
    # k > 128 is not fused: it takes the cluster scan, as the JAX package
    ids, d = idx.query(q, 129, nprobe=6)
    ti, td = at.build_exhaustive_index(x, device="cpu").query(q, 129)
    assert at.calculate_recall(ti, ids, 129) >= 0.999
    np.testing.assert_allclose(d.numpy(), td.numpy(), rtol=1e-4, atol=1e-4)
