"""The quantised IVF indexes with dense cells, port against the JAX
package: ``IvfIndexBf16`` (kernels K1c-bf16, K1d-bf16) and ``IvfSq8Index``
(K1c-sq8, K1d-sq8), both tiers, both metrics.

* Index state carried over (``interop``), so that both packages query the
  same centroids and cells. The JAX side runs its fused exact tier with
  ``ANNSEARCH_FUSED_EXACT=1`` (interpret mode on the CPU, as on the TPU),
  and, for SQ8, also its XLA exact tier.
* SQ8 scores in integer space, where every euclidean distance is an
  integer below 2²⁴: the exact tier's distances are equal and its ids
  equal up to ties. Under cosine the JAX package's CPU rsqrt is not
  correctly rounded (the port's is), so distances agree within 1e-6.
* bf16: the exact tier rescores its pool in f32 over the bf16 rows in both
  packages; ids equal up to ties, distances within 1e-6·max(1, |d|).
* The approximate tiers: recall@10 against one exhaustive ground truth
  within 0.005 of the JAX package's, and distances on shared ids equal
  (SQ8) or within the f32 rounding of the ``‖q‖² + ‖x‖² − 2q·x`` identity
  (bf16).
"""

import numpy as np
import pytest
import torch

import annsearch_tpu_torch as at
from annsearch_tpu.models.quantised.ivf import IvfIndexBf16 as JBf16
from annsearch_tpu.models.quantised.ivf import IvfSq8Index as JSq8
from annsearch_tpu.utils.metrics import calculate_recall as j_recall
from annsearch_tpu_torch.interop import (
    IVF_ARRAYS,
    IVF_SCALARS,
    IVF_SQ8_ARRAYS,
    ivf_bf16_from_jax_arrays,
    ivf_sq8_from_jax_arrays,
)
from annsearch_tpu_torch.models.quantised.ivf import IvfIndexBf16, IvfSq8Index
from annsearch_tpu_torch.utils.data import generate_clustered_data, subsample_with_noise

torch.set_num_threads(2)

K = 10
KINDS = {
    "bf16": (JBf16, IvfIndexBf16, ivf_bf16_from_jax_arrays, IVF_ARRAYS),
    "sq8": (JSq8, IvfSq8Index, ivf_sq8_from_jax_arrays, IVF_SQ8_ARRAYS),
}
#: (nlist, seg_size): split cells (the compact pair lists) under euclidean,
#: unsplit ones (the dense expansion) under cosine
LAYOUTS = {"euclidean": (8, 256), "cosine": (8, 1024)}
QUERIES = {"exact": dict(nprobe=3), "approx": dict(nprobe=3, approx=True)}


@pytest.fixture(scope="module")
def data():
    x, _ = generate_clustered_data(3000, 40, 8, seed=1)
    return x, subsample_with_noise(x, 60, seed=2)


def _jax_state(j, names):
    arrays = {name: np.asarray(getattr(j, name)) for name in names
              if name not in ("cluster_ptr", "storage")}
    # npz holds no bf16: the JAX package saves bf16 storage as f32
    arrays["storage"] = np.asarray(j.storage.astype("float32") if j.mode == "bf16" else j.storage)
    arrays["cluster_ptr"] = np.asarray(j._cluster_ptr)
    meta = {name: int(getattr(j, name)) for name in IVF_SCALARS}
    meta["metric"] = j.metric.value
    return arrays, meta


@pytest.fixture(
    scope="module",
    params=[(kind, m) for kind in KINDS for m in LAYOUTS],
    ids=lambda p: "-".join(p),
)
def carried(request, data):
    """A JAX index, its answers to each query kind, the ground truth, and the
    port's index built from its state."""
    kind, metric = request.param
    jcls, _, from_jax, names = KINDS[kind]
    x, q = data
    nlist, seg_size = LAYOUTS[metric]
    j = jcls(x, metric, nlist=nlist, seg_size=seg_size)
    s_max = int(np.diff(np.asarray(j._cluster_ptr)).max())
    assert (s_max > 1) == (metric == "euclidean")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ANNSEARCH_FUSED_EXACT", "1")
        answers = {name: j.query(q, K, **kw) for name, kw in QUERIES.items()}
    if kind == "sq8" and metric == "euclidean":
        answers["xla_exact"] = j.query(q, K, **QUERIES["exact"])
    truth, _ = at.build_exhaustive_index(x, metric, device="cpu").query(q, K)
    port = from_jax(*_jax_state(j, names), device="cpu")
    return kind, metric, j, q, answers, truth.numpy(), port


def _same_up_to_ties(ids, d, jids, jd):
    """Ids agree wherever the distances do not tie."""
    ids, d = np.asarray(ids), np.asarray(d)
    differ = ids != np.asarray(jids)
    tie = (d[:, :, None] == d[:, None, :]).sum(-1) > 1
    assert not (differ & ~tie).any()


def test_exact_tier_answers_like_jax(carried):
    kind, metric, _, q, answers, _, port = carried
    assert port.mode == kind and port.storage.dtype == (
        torch.bfloat16 if kind == "bf16" else torch.int8)
    ids, d = port.query(q, K, **QUERIES["exact"])
    jids, jd = answers["exact"]
    assert ids.dtype == torch.int64 and d.dtype == torch.float32 and ids.shape == (len(q), K)
    if kind == "sq8" and metric == "euclidean":
        np.testing.assert_array_equal(d.numpy(), jd)
        # and the JAX package's XLA exact tier, which scans the same codes
        xids, xd = answers["xla_exact"]
        np.testing.assert_array_equal(d.numpy(), xd)
        _same_up_to_ties(ids, xd, xids, xd)
    else:
        tol = 1e-6 * np.maximum(1.0, np.abs(jd))
        assert (np.abs(d.numpy() - jd) <= tol).all()
    _same_up_to_ties(ids, jd, jids, jd)


def test_approx_tier_recall_and_distances_like_jax(carried):
    kind, metric, j, q, answers, truth, port = carried
    ids, d = port.query(q, K, **QUERIES["approx"])
    jids, jd = answers["approx"]
    r_port = j_recall(truth, ids.numpy(), K)
    r_jax = j_recall(truth, np.asarray(jids), K)
    assert abs(r_port - r_jax) <= 0.005
    shared = ids.numpy() == np.asarray(jids)
    assert shared.mean() >= 0.99
    got, want = d.numpy()[shared], np.asarray(jd)[shared]
    if kind == "sq8" and metric == "euclidean":
        np.testing.assert_array_equal(got, want)
    elif kind == "sq8":       # cos_qnorm: the JAX package's CPU rsqrt
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        # the identity's terms are ‖q‖² + ‖x‖² (≤ 2·max‖x‖²): f32 sums in
        # another order differ by a few ulps of them
        scale = 1.0 if metric == "cosine" else 2.0 * float(np.asarray(j.store_sqnorms).max())
        assert (np.abs(got - want) <= 1e-6 * scale).all()


def test_jax_save_then_port_load(carried, tmp_path):
    kind, _, j, q, _, _, port = carried
    path = str(tmp_path / f"jax_{kind}.npz")
    j.save(path)
    loaded = KINDS[kind][1].load(path, device="cpu")
    for name in KINDS[kind][3]:
        if name != "cluster_ptr":
            assert torch.equal(getattr(loaded, name), getattr(port, name)), name
    for kw in QUERIES.values():
        a, b = loaded.query(q, K, **kw), port.query(q, K, **kw)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_port_save_loads_in_both_packages(carried, tmp_path):
    kind, _, j, q, answers, _, port = carried
    path = str(tmp_path / f"port_{kind}.npz")
    port.save(path)
    again = KINDS[kind][1].load(path, device="cpu")
    a, b = port.query(q, K, nprobe=3), again.query(q, K, nprobe=3)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    jj = KINDS[kind][0].load(path)
    assert jj.storage.dtype == j.storage.dtype
    np.testing.assert_array_equal(np.asarray(jj.storage, np.float32), np.asarray(j.storage, np.float32))
    np.testing.assert_array_equal(np.asarray(jj.store_sqnorms), np.asarray(j.store_sqnorms))
    if kind == "sq8":
        np.testing.assert_array_equal(np.asarray(jj.scales), np.asarray(j.scales))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ANNSEARCH_FUSED_EXACT", "1")
        jids, jd = jj.query(q, K, **QUERIES["approx"])
    np.testing.assert_array_equal(jids, answers["approx"][0])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_builds_in_the_port_reach_jax_recall(data, kind, metric):
    """Built from the same numpy data in each package (k-means streams
    differ, so centroids are compared by recall, not by value)."""
    jcls, pcls, _, _ = KINDS[kind]
    x, q = data
    truth, _ = at.build_exhaustive_index(x, metric, device="cpu").query(q, K)
    port = pcls(x, metric, nlist=8, seed=0, device="cpu")
    j = jcls(x, metric, nlist=8, seed=0)
    if kind == "sq8" and metric == "euclidean":
        # a per-column max of the same data: equal bit for bit
        np.testing.assert_array_equal(port.scales.numpy(), np.asarray(j.scales))
    elif kind == "sq8":       # of rows each package normalised itself
        np.testing.assert_allclose(port.scales.numpy(), np.asarray(j.scales), rtol=1e-6)
    r_port = at.calculate_recall(truth, port.query(q, K, nprobe=3, approx=True)[0], K)
    r_jax = j_recall(truth.numpy(), np.asarray(j.query(q, K, nprobe=3, approx=True)[0]), K)
    assert r_port >= r_jax - 0.05, (r_port, r_jax)
    # the cells count at their stored width: 2 bytes (bf16) or 1 (int8)
    cell_bytes = port.storage.numel() * (2 if kind == "bf16" else 1)
    assert cell_bytes < port.memory_usage_bytes() < 2 * cell_bytes


@pytest.mark.parametrize("kind", KINDS)
def test_facade_rows_and_self_queries(data, kind):
    x, q = data
    build = getattr(at, f"build_ivf_{kind}_index")
    query = getattr(at, f"query_ivf_{kind}_index")
    self_query = getattr(at, f"query_ivf_{kind}_self")
    idx = build(x, nlist=8, device="cpu")
    ids, none = query(q, idx, 5, nprobe=3)
    assert none is None and ids.shape == (len(q), 5)
    ids2, d = query(q, idx, 5, nprobe=3, return_dist=True)
    assert torch.equal(ids, ids2) and torch.all(d[:, 1:] >= d[:, :-1])
    # the facade rows run the exact tier, as the JAX rows do
    eids, ed = idx.query(q, 5, nprobe=3)
    assert torch.equal(ids, eids) and torch.equal(d, ed)
    sids, sd = self_query(idx, 3, nprobe=3, return_dist=True)
    assert sids.shape == (len(x), 3) and (sids[:, 0] == torch.arange(len(x))).all()
    assert torch.all(sd[:, 0] <= 1e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_result_contract_f64_cast_and_certify(data, kind):
    x, q = data
    pcls = KINDS[kind][1]
    small = pcls(x[:40], nlist=2, seed=0, seg_size=128, device="cpu")
    ids, d = small.query(x[:3], 50, nprobe=2)              # k clamps to n
    assert ids.shape == (3, 40) and (ids[:, 0] == torch.arange(3)).all()
    assert torch.isfinite(d).all() and torch.all(d[:, 1:] >= d[:, :-1])
    a = pcls(x, nlist=8, seed=0, device="cpu")
    b = pcls(x.astype(np.float64), nlist=8, seed=0, device="cpu")
    assert b._x64 is None                                  # quantised: no f64 copy
    assert torch.equal(a.storage, b.storage)
    ra = a.query(q, K, nprobe=3)
    rb = b.query(q.astype(np.float64), K, nprobe=3)
    assert rb[1].dtype == torch.float32
    assert torch.equal(ra[0], rb[0]) and torch.equal(ra[1], rb[1])
    for approx in (False, True):
        with pytest.raises(ValueError, match="exact f32 tier"):
            a.query(q, K, approx=approx, certify=True)
