"""The main path as a whole: IVF-PQ with m = d (int8 residual cells)
queried through the fused approximate tier, port against JAX package.

* Index state carried over (``interop``, or ``save`` → the port's
  ``load``): both packages then query the same centroids and codes, and
  answer with ids ≥ 99% equal and distances within rtol 1e-5 / atol 1e-4
  (data scaled by 1/8 to keep the f32 cancellation in
  ``qadd + sn − 2·dots`` below that tolerance).
* Built by each package from the same data (different random streams):
  the port's recall@10 against its exact scan is ≥ 0.91 and within 0.03
  of the JAX index's recall against the JAX exact scan.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import annsearch_tpu_torch as at
from annsearch_tpu.models.exhaustive import ExhaustiveIndex as JExhaustive
from annsearch_tpu.models.quantised.ivf import IvfPqIndex as JIvfPq
from annsearch_tpu.utils.metrics import calculate_recall as j_recall
from annsearch_tpu_torch.interop import IVF_PQ_ARRAYS, IVF_PQ_SCALARS, ivf_pq_from_jax_arrays
from annsearch_tpu_torch.models.quantised.ivf import IvfPqIndex
from annsearch_tpu_torch.utils.data import generate_clustered_data, subsample_with_noise

torch.set_num_threads(2)

K = 10


def _jax_state(j):
    arrays = {name: np.asarray(getattr(j, name)) for name in IVF_PQ_ARRAYS if name != "cluster_ptr"}
    arrays["cluster_ptr"] = np.asarray(j._cluster_ptr)
    meta = {name: int(getattr(j, name)) for name in IVF_PQ_SCALARS}
    meta["metric"] = j.metric.value
    return arrays, meta


@pytest.fixture(scope="module")
def data128():
    x, _ = generate_clustered_data(1200, 128, 6, seed=3)
    q = subsample_with_noise(x, 25, seed=4)
    return x, q


# (nlist, seg_size, nprobe): unsplit cells; split cells with partial segments
LAYOUTS = [(8, 256, 4), (4, 128, 2)]


@pytest.fixture(scope="module", params=LAYOUTS, ids=["unsplit", "split"])
def carried(request, data128):
    nlist, seg_size, nprobe = request.param
    x, q = data128
    s = np.float32(0.125)
    j = JIvfPq(x * s, "euclidean", nlist=nlist, m=128, seg_size=seg_size)
    return j, q * s, nprobe


def _assert_same_answers(ids, d, jids, jd):
    assert ids.dtype == torch.int64 and d.dtype == torch.float32
    assert (ids.numpy() == np.asarray(jids)).mean() >= 0.99
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-4)


def test_interop_index_answers_like_jax(carried):
    j, q, nprobe = carried
    port = ivf_pq_from_jax_arrays(*_jax_state(j), device="cpu")
    assert port.mode == "i8dec_residual" and port.seg_size == j.seg_size
    ids, d = port.query(q, K, nprobe=nprobe, approx=True)
    jids, jd = j.query(q, K, nprobe=nprobe, approx=True)
    _assert_same_answers(ids, d, jids, jd)
    np.testing.assert_allclose(
        port.vectors_original_order().numpy(), j.vectors_original_order(),
        rtol=1e-5, atol=1e-5,
    )


def test_jax_save_then_port_load(carried, tmp_path):
    j, q, nprobe = carried
    path = str(tmp_path / "jax_ivfpq.npz")
    j.save(path)
    port = IvfPqIndex.load(path, device="cpu")
    via_interop = ivf_pq_from_jax_arrays(*_jax_state(j), device="cpu")
    ids, d = port.query(q, K, nprobe=nprobe, approx=True)
    ids2, d2 = via_interop.query(q, K, nprobe=nprobe, approx=True)
    assert torch.equal(ids, ids2) and torch.equal(d, d2)
    jids, jd = j.query(q, K, nprobe=nprobe, approx=True)
    _assert_same_answers(ids, d, jids, jd)


def test_port_save_loads_in_both_packages(carried, tmp_path):
    j, q, nprobe = carried
    port = ivf_pq_from_jax_arrays(*_jax_state(j), device="cpu")
    path = str(tmp_path / "port_ivfpq.npz")
    port.save(path)
    again = IvfPqIndex.load(path, device="cpu")
    a = port.query(q, K, nprobe=nprobe, approx=True)
    b = again.query(q, K, nprobe=nprobe, approx=True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    jj = JIvfPq.load(path)
    jids, jd = jj.query(q, K, nprobe=nprobe, approx=True)
    _assert_same_answers(a[0], a[1], jids, jd)


def test_port_built_recall_matches_jax(data128):
    x, q = data128
    port = at.build_ivf_pq_index(x, nlist=8, m=128, seed=42, device="cpu")
    ti, _ = at.build_exhaustive_index(x, device="cpu").query(q, K)
    ai, _ = port.query(q, K, nprobe=4, approx=True)
    r_port = at.calculate_recall(ti, ai, K)

    j = JIvfPq(x, "euclidean", nlist=8, m=128, seed=42, seg_size=256)
    jti, _ = JExhaustive(x, "euclidean").query(q, K)
    jai, _ = j.query(q, K, nprobe=4, approx=True)
    r_jax = j_recall(jti, jai, K)
    assert r_port >= 0.91, r_port
    assert abs(r_port - r_jax) <= 0.03, (r_port, r_jax)


def test_result_contract(data128):
    x, q = data128
    idx = at.build_ivf_pq_index(x, nlist=8, m=128, seed=0, device="cpu")
    ids, d = idx.query(q, K, nprobe=8, approx=True)
    assert ids.shape == (len(q), K) and torch.all(d[:, 1:] >= d[:, :-1])
    assert ids.min() >= 0 and ids.max() < len(x)
    # squared euclidean to the decoded vectors, up to the bf16 query term:
    # each of its components is off by ≤ 2⁻⁹ relative, so the distance by
    # ≤ 2⁻⁸·‖q − c‖·‖x − c‖ (c = the row's centroid), plus f32 rounding
    owner = torch.empty(len(x), dtype=torch.long)
    owner[idx.original_ids] = idx._owner_clusters()
    qt = torch.as_tensor(q)[:, None, :]
    recon = idx.vectors_original_order()[ids]
    cent = idx.centroids[owner[ids]]
    dref = ((qt - recon) ** 2).sum(-1)
    bound = 2.0 ** -8 * (qt - cent).norm(dim=-1) * (recon - cent).norm(dim=-1)
    assert torch.all((d - dref).abs() <= bound + 1e-3 * (1 + dref))
    # self-queries find themselves first
    sids, _ = idx.query(x[:20], 5, nprobe=4, approx=True)
    assert (sids[:, 0] == torch.arange(20)).float().mean() >= 0.95


def test_k_clamps_to_n():
    x, _ = generate_clustered_data(40, 32, 2, seed=9)
    idx = IvfPqIndex(x, nlist=2, m=32, seed=0, seg_size=128, device="cpu")
    ids, d = idx.query(x[:3], 50, nprobe=2, approx=True)
    assert ids.shape == (3, 40)
    assert all(sorted(row) == list(range(40)) for row in ids.tolist())
    assert torch.isfinite(d).all() and torch.all(d[:, 1:] >= d[:, :-1])


def test_facade(data128):
    x, q = data128
    idx = at.build_ivf_pq_index(x, nlist=8, m=128, device="cpu")
    ids, none = at.query_ivf_pq_index(q, idx, 5, nprobe=2, approx=True)
    assert none is None and ids.shape == (len(q), 5)
    ids2, d = at.query_ivf_pq_index(q, idx, 5, nprobe=2, return_dist=True, approx=True)
    assert torch.equal(ids, ids2) and d.shape == (len(q), 5)
    ei, ed = at.query_exhaustive_index(q, at.build_exhaustive_index(x, device="cpu"),
                                       5, return_dist=True)
    assert ei.shape == ed.shape == (len(q), 5)
    # the default is the exact tier (the cluster scan), as the JAX row
    ids3, d3 = at.query_ivf_pq_index(q, idx, 5, nprobe=2, return_dist=True)
    assert ids3.shape == (len(q), 5) and torch.all(d3[:, 1:] >= d3[:, :-1])
    assert at.calculate_recall(ids3, ids, 5) >= 0.95


def test_unported_options_raise(data128):
    """What is still refused, and what answers since the cluster scan, the
    K1b kernels and ``pq_residual`` were ported."""
    x, q = data128
    idx = at.build_ivf_pq_index(x, nlist=8, m=128, device="cpu")
    with pytest.raises(ValueError, match="exact f32 tier"):
        idx.query(q, 5, approx=True, certify=True)   # quantised cells
    with pytest.raises(ValueError, match="exact f32 tier"):
        idx.query(q, 5, certify=True)
    with pytest.raises(ValueError, match="dim"):
        idx.query(q[:, :64], 5, approx=True)
    with pytest.raises(ValueError, match="divisible"):
        at.build_ivf_pq_index(x, nlist=8, m=48, device="cpu")
    exact, _ = idx.query(q, 5)                        # the exact tier
    split, _ = idx.query(q, 5, approx=True, q_split=True)
    assert at.calculate_recall(exact, split, 5) >= 0.95
    cos = at.build_ivf_pq_index(x, nlist=8, m=128, dist_metric="cosine", device="cpu")
    assert cos.mode == "i8dec_residual" and cos.query(q, 5, approx=True)[0].shape == (len(q), 5)
    m16 = at.build_ivf_pq_index(x, nlist=8, m=16, device="cpu")
    assert m16.mode == "pq_residual" and m16.storage.dtype == torch.uint8
    assert m16.query(q, 5)[0].shape == (len(q), 5)


def test_interop_rejects_incomplete_state(carried):
    j, _, _ = carried
    arrays, meta = _jax_state(j)
    del arrays["dec_scales"]
    with pytest.raises(ValueError, match="dec_scales"):
        ivf_pq_from_jax_arrays(arrays, meta, device="cpu")
    arrays, meta = _jax_state(j)
    arrays["storage"] = arrays["storage"].astype(np.float32)
    with pytest.raises(ValueError, match="int8"):
        ivf_pq_from_jax_arrays(arrays, meta, device="cpu")
