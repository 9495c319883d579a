"""IVF-PQ and IVF-OPQ as whole indexes, port against the JAX package: every
``(metric, m, approx, q_split)`` the JAX package accepts.

* Index state carried over (``interop``, or ``save`` → ``load``), so both
  packages query the same centroids, codes, codebooks and rotation. The
  exact tier (``approx=False``) is the cluster scan in both: ids equal up
  to ties (≥ 99%), distances within 1e-4·(1 + |d|): f32 sums in another
  order. The data is scaled by 1/8 where distances are compared, since
  ``qadd + sn − 2·dots`` cancels near a match and its f32 rounding grows
  with the norms. The approximate tier of ``m = dim`` is the fused scan in
  both (the JAX one in interpret mode), one bf16 query term or two; for
  ``m ≠ dim`` it is the cluster scan again, where the JAX package's
  ``approx_min_k`` is exact on the CPU.
* Between the tiers of the port: recall ≥ 0.95 and distances against the
  decoded reconstructions, as ``tests/test_ivf_scan_pallas.py`` holds the
  JAX package.
* Built by the port alone (codebooks and rotations differ by random
  stream): recall@10 against the port's exact scan within 0.06 of the JAX
  index's against its own.
* The shapes the fused scan's gate refuses (k > 128, a ``seg_size`` that is
  no multiple of 128) answer through the cluster scan, as in the JAX
  package; rows wider than 4,096 take the fused tiers, as there.
"""

import numpy as np
import pytest
import torch

import annsearch_tpu_torch as at
from annsearch_tpu.models.exhaustive import ExhaustiveIndex as JExhaustive
from annsearch_tpu.models.quantised import ivf as jqivf
from annsearch_tpu.utils.metrics import calculate_recall as j_recall
from annsearch_tpu_torch.interop import (
    IVF_OPQ_ARRAYS,
    IVF_PQ_ARRAYS,
    IVF_PQ_SCALARS,
    ivf_opq_from_jax_arrays,
    ivf_pq_from_jax_arrays,
)
from annsearch_tpu_torch.models.quantised import ivf as tqivf
from annsearch_tpu_torch.ops.ivf_scan_fused import fused_eligible
from annsearch_tpu_torch.utils.data import generate_clustered_data, subsample_with_noise

torch.set_num_threads(2)

K, NPROBE = 10, 4
KINDS = {
    "pq": (jqivf.IvfPqIndex, tqivf.IvfPqIndex, ivf_pq_from_jax_arrays, IVF_PQ_ARRAYS),
    "opq": (jqivf.IvfOpqIndex, tqivf.IvfOpqIndex, ivf_opq_from_jax_arrays, IVF_OPQ_ARRAYS),
}
CONFIGS = [(kind, m, metric) for kind in KINDS for m in (128, 32)
           for metric in ("euclidean", "cosine")]
CONFIG_IDS = [f"{k}-m{m}-{metric}" for k, m, metric in CONFIGS]


@pytest.fixture(scope="module")
def data128():
    x, _ = generate_clustered_data(1200, 128, 6, seed=3)
    q = subsample_with_noise(x, 25, seed=4)
    s = np.float32(0.125)
    return x * s, q * s


def _jax_state(j, names):
    arrays = {name: np.asarray(getattr(j, name)) for name in names
              if name != "cluster_ptr" and getattr(j, name) is not None}
    arrays["cluster_ptr"] = np.asarray(j._cluster_ptr)
    meta = {name: int(getattr(j, name)) for name in IVF_PQ_SCALARS}
    meta["metric"] = j.metric.value
    return arrays, meta


@pytest.fixture(scope="module")
def carried(data128):
    """``get(kind, m, metric)`` → (JAX index, the port's index holding its
    state), built once each; unsplit 256-row segments."""
    x, _ = data128
    cache = {}

    def get(kind, m, metric):
        key = (kind, m, metric)
        if key not in cache:
            jcls, _, from_jax, names = KINDS[kind]
            j = jcls(x, metric, nlist=8, m=m, seg_size=256)
            cache[key] = (j, from_jax(*_jax_state(j, names), device="cpu"))
        return cache[key]

    return get


def _assert_same_answers(ids, d, jids, jd, min_ids=0.99):
    assert ids.dtype == torch.int64 and d.dtype == torch.float32
    jd = np.asarray(jd)
    assert np.all(np.abs(d.numpy() - jd) <= 1e-4 * (1.0 + np.abs(jd)))
    assert (ids.numpy() == np.asarray(jids)).mean() >= min_ids


@pytest.mark.parametrize("q_split", [None, True], ids=["q_split-auto", "q_split"])
@pytest.mark.parametrize("approx", [False, True], ids=["exact", "approx"])
@pytest.mark.parametrize("kind,m,metric", CONFIGS, ids=CONFIG_IDS)
def test_carried_index_answers_like_jax(carried, data128, kind, m, metric, approx, q_split):
    j, port = carried(kind, m, metric)
    _, q = data128
    assert port.mode == j.mode == ("i8dec_residual" if m == 128 else "pq_residual")
    assert port.storage.dtype == (torch.int8 if m == 128 else torch.uint8)
    ids, d = port.query(q, K, nprobe=NPROBE, approx=approx, q_split=q_split)
    jids, jd = j.query(q, K, nprobe=NPROBE, approx=approx, q_split=q_split)
    assert torch.all(d[:, 1:] >= d[:, :-1])
    _assert_same_answers(ids, d, jids, jd)


@pytest.mark.parametrize("kind,m,metric", CONFIGS, ids=CONFIG_IDS)
def test_decoded_vectors_match_jax(carried, kind, m, metric):
    j, port = carried(kind, m, metric)
    np.testing.assert_allclose(
        port.vectors_original_order().numpy(), j.vectors_original_order(),
        rtol=1e-5, atol=1e-5,
    )
    assert port.memory_usage_bytes() > 0


@pytest.mark.parametrize("kind,m,metric", [c for c in CONFIGS if c[1] == 128],
                         ids=[i for i, c in zip(CONFIG_IDS, CONFIGS) if c[1] == 128])
def test_fused_tier_matches_the_cluster_scan(carried, data128, kind, m, metric):
    """Between the port's own tiers, as ``tests/test_ivf_scan_pallas.py``
    holds the JAX package's: recall ≥ 0.95 against the exact tier, and each
    returned distance against an f32 recomputation from the decoded
    reconstruction, within that test's tolerance (2e-2·(1 + |d|) plus
    1.5e-2·‖q‖·‖x‖ of bf16 scoring error)."""
    _, port = carried(kind, m, metric)
    _, q = data128
    assert fused_eligible(port.mode, port.seg_size, port.dim, K)
    ie, _ = port.query(q, K, nprobe=NPROBE)
    recon = port.vectors_original_order()
    qt = torch.as_tensor(q)
    if metric == "cosine":
        qt = qt / qt.norm(dim=1, keepdim=True)
    for q_split in (None, True):
        ia, da = port.query(q, K, nprobe=NPROBE, approx=True, q_split=q_split)
        assert at.calculate_recall(ie, ia, K) >= 0.95
        rsel = recon[ia]
        if metric == "cosine":
            dtrue = 1.0 - (qt[:, None, :] * rsel).sum(-1) / rsel.norm(dim=-1).clamp_min(1e-12)
        else:
            dtrue = ((qt[:, None, :] - rsel) ** 2).sum(-1)
        mag = qt.norm(dim=1)[:, None] * rsel.norm(dim=-1)
        assert torch.all((da - dtrue).abs() <= 2e-2 + 2e-2 * dtrue.abs() + 1.5e-2 * mag)


@pytest.mark.parametrize("kind,m,metric", CONFIGS, ids=CONFIG_IDS)
def test_port_built_recall_matches_jax(carried, data128, kind, m, metric):
    """Each package builds from the same rows; recall@10 of the exact tier
    against each package's own exhaustive scan."""
    x, q = data128
    j, _ = carried(kind, m, metric)
    build = at.build_ivf_pq_index if kind == "pq" else at.build_ivf_opq_index
    port = build(x, nlist=8, m=m, dist_metric=metric, seed=42, device="cpu")
    assert port.mode == j.mode
    ti, _ = at.build_exhaustive_index(x, metric, device="cpu").query(q, K)
    r_port = at.calculate_recall(ti, port.query(q, K, nprobe=NPROBE)[0], K)
    jti, _ = JExhaustive(x, metric).query(q, K)
    r_jax = j_recall(jti, j.query(q, K, nprobe=NPROBE)[0], K)
    assert abs(r_port - r_jax) <= 0.06, (r_port, r_jax)
    if m == 128:
        assert r_port >= 0.9, r_port
    if kind == "opq":
        r = port.rotation
        assert (r @ r.T - torch.eye(128)).abs().max() <= 1e-4


@pytest.mark.parametrize("kind,m,metric",
                         [("pq", 32, "euclidean"), ("opq", 128, "cosine"), ("opq", 32, "euclidean")])
def test_save_and_load_both_ways(carried, data128, tmp_path, kind, m, metric):
    j, port = carried(kind, m, metric)
    jcls, tcls = KINDS[kind][:2]
    _, q = data128
    want = port.query(q, K, nprobe=NPROBE)
    # the JAX package's file, read by the port
    jpath = str(tmp_path / "jax.npz")
    j.save(jpath)
    a = tcls.load(jpath, device="cpu").query(q, K, nprobe=NPROBE)
    assert torch.equal(a[0], want[0]) and torch.equal(a[1], want[1])
    # the port's file, read by both
    ppath = str(tmp_path / "port.npz")
    port.save(ppath)
    b = tcls.load(ppath, device="cpu").query(q, K, nprobe=NPROBE)
    assert torch.equal(b[0], want[0]) and torch.equal(b[1], want[1])
    jids, jd = jcls.load(ppath).query(q, K, nprobe=NPROBE)
    _assert_same_answers(want[0], want[1], jids, jd)
    with pytest.raises(ValueError, match="holds a"):
        (tqivf.IvfOpqIndex if kind == "pq" else tqivf.IvfPqIndex).load(ppath, device="cpu")


def test_interop_rejects_incomplete_opq_state(carried):
    j, _ = carried("opq", 32, "euclidean")
    arrays, meta = _jax_state(j, IVF_OPQ_ARRAYS)
    del arrays["rotation"]
    with pytest.raises(ValueError, match="rotation"):
        ivf_opq_from_jax_arrays(arrays, meta, device="cpu")
    arrays, meta = _jax_state(j, IVF_OPQ_ARRAYS)
    arrays["storage"] = arrays["storage"].astype(np.int16)
    with pytest.raises(ValueError, match="int8"):
        ivf_opq_from_jax_arrays(arrays, meta, device="cpu")


# -- the facade and the result contract ---------------------------------------


@pytest.mark.parametrize("kind", ["pq", "opq"])
def test_facade_rows(data128, kind):
    """``build_* / query_* / query_*_self`` with the facade's own defaults:
    m = 16 (mode pq_residual) and the exact tier."""
    x, q = data128
    build = getattr(at, f"build_ivf_{kind}_index")
    query = getattr(at, f"query_ivf_{kind}_index")
    query_self = getattr(at, f"query_ivf_{kind}_index_self")
    idx = build(x, nlist=8, device="cpu")
    assert idx.m == 16 and idx.mode == "pq_residual"
    ids, none = query(q, idx, 5, nprobe=NPROBE)
    assert none is None and ids.shape == (len(q), 5)
    ids2, d = query(q, idx, 5, nprobe=NPROBE, return_dist=True)
    assert torch.equal(ids, ids2) and torch.all(d[:, 1:] >= d[:, :-1])
    ids3, _ = query(q, idx, 5, nprobe=NPROBE, approx=True, q_split=True)
    assert torch.equal(ids, ids3)     # one scan behind both tiers of pq_residual
    sids, sd = query_self(idx, 3, nprobe=8, return_dist=True)
    assert sids.shape == (len(x), 3) and torch.all(sd[:, 1:] >= sd[:, :-1])
    # a stored row's nearest reconstruction is mostly its own
    assert (sids[:, 0] == torch.arange(len(x))).float().mean() >= 0.6


@pytest.mark.parametrize("kind,m,metric", CONFIGS, ids=CONFIG_IDS)
def test_result_contract(data128, kind, m, metric):
    """Ascending finite distances that are the metric's distance to the
    decoded vectors, ids in range, k clamped to n."""
    x, q = data128
    build = at.build_ivf_pq_index if kind == "pq" else at.build_ivf_opq_index
    idx = build(x[:300], nlist=3, m=m, dist_metric=metric, seed=1, device="cpu")
    ids, d = idx.query(q, 400, nprobe=3)             # every cell: k clamps to n
    assert ids.shape == (len(q), 300) and torch.isfinite(d).all()
    assert torch.all(d[:, 1:] >= d[:, :-1])
    assert all(sorted(row) == list(range(300)) for row in ids.tolist())
    qt = torch.as_tensor(q)
    recon = idx.vectors_original_order()[ids[:, :K]]
    if metric == "cosine":
        qt = qt / qt.norm(dim=1, keepdim=True)
        dref = 1.0 - (qt[:, None, :] * recon).sum(-1) / recon.norm(dim=-1)
    else:
        dref = ((qt[:, None, :] - recon) ** 2).sum(-1)
    assert torch.all((d[:, :K] - dref).abs() <= 1e-4 * (1.0 + dref.abs()))


# -- shapes the fused scan's gate refuses: the cluster scan answers ----------


def test_k_above_128_takes_the_cluster_scan(carried, data128):
    j, port = carried("pq", 128, "euclidean")
    _, q = data128
    assert not fused_eligible(port.mode, port.seg_size, port.dim, 130)
    for approx in (False, True):
        ids, d = port.query(q, 130, nprobe=NPROBE, approx=approx)
        jids, jd = j.query(q, 130, nprobe=NPROBE, approx=approx)
        assert ids.shape == (len(q), 130)
        _assert_same_answers(ids, d, jids, jd, min_ids=0.98)


@pytest.mark.parametrize("cls", ["IvfPqIndex", "IvfIndexBf16", "IvfSq8Index"])
def test_ragged_seg_size_takes_the_cluster_scan(data128, cls):
    """``seg_size=200`` is no multiple of 128: both tiers answer through the
    cluster scan, and equal the JAX index carried over."""
    from annsearch_tpu_torch import interop

    x, q = data128
    kw = {"m": 128} if cls == "IvfPqIndex" else {}
    j = getattr(jqivf, cls)(x, "euclidean", nlist=8, seg_size=200, **kw)
    assert not fused_eligible(j.mode, 200, 128, K)
    names = {"IvfPqIndex": IVF_PQ_ARRAYS, "IvfIndexBf16": interop.IVF_ARRAYS,
             "IvfSq8Index": interop.IVF_SQ8_ARRAYS}[cls]
    from_jax = {"IvfPqIndex": ivf_pq_from_jax_arrays,
                "IvfIndexBf16": interop.ivf_bf16_from_jax_arrays,
                "IvfSq8Index": interop.ivf_sq8_from_jax_arrays}[cls]
    arrays = {n: np.asarray(getattr(j, n), np.float32 if (n == "storage" and j.mode == "bf16")
                            else None) for n in names if n != "cluster_ptr"}
    arrays["cluster_ptr"] = np.asarray(j._cluster_ptr)
    meta = {n: int(getattr(j, n)) for n in ("n", "dim", "nlist", "seg_size")}
    meta.update(metric="euclidean", m=128)
    port = from_jax(arrays, meta, device="cpu")
    for approx in (False, True):
        ids, d = port.query(q, K, nprobe=NPROBE, approx=approx)
        jids, jd = j.query(q, K, nprobe=NPROBE, approx=approx)
        _assert_same_answers(ids, d, jids, jd)
    built = getattr(tqivf, cls)(x, "euclidean", nlist=8, seg_size=200, device="cpu", **kw)
    assert built.seg_size == 200 and built.query(q, K, nprobe=NPROBE)[0].shape == (len(q), K)


def test_rows_wider_than_the_kernel_take_the_cluster_scan():
    """Rows wider than 4,096 after padding, which the fused kernels once
    left to the cluster scan: they now take the fused tiers, as in the JAX
    package (the kernel stages the query rows in column blocks), and both
    tiers equal the exhaustive scan at full probe."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((300, 4100)).astype(np.float32) * np.float32(0.05)
    q = x[:8] + np.float32(0.001)
    idx = at.build_ivf_index(x, nlist=2, seed=0, device="cpu")
    assert fused_eligible(idx.mode, idx.seg_size, idx.dim, 5)
    ti, td = at.build_exhaustive_index(x, device="cpu").query(q, 5)
    for approx in (False, True):
        ids, d = idx.query(q, 5, nprobe=2, approx=approx)
        assert torch.equal(ids, ti)
        np.testing.assert_allclose(d.numpy(), td.numpy(), rtol=1e-4, atol=1e-4)
