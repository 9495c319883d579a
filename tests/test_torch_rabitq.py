"""RaBitQ, port against the JAX package on the same numpy inputs: the
encoder, the cluster scan's estimator (mode ``rabitq``), kernel K1a-bf16's
plain version against the JAX fused scan in interpret mode, the fused
estimator tier, ``_rescore_estimator``, the stores, cosine, self-queries,
the facade rows and JAX-saved npz files.

Tolerances, and why:

* sign bits from the carried rotation: bit for bit, save where the rotated
  component lies within 1e-6 of 0 (a unit residual's component; two f32
  products may round a sign apart there), counted and none expected;
  ``‖x − c‖`` and ``‖R·u‖₁`` within 1e-5 relative (f32 sums in other
  orders).
* estimates: ``d̂² = sn² + qd² − 2·sn·qd·est`` cancels near a match, so
  the squared estimates agree within 1e-5·(1 + (sn + qd)²) ≥ f32 rounding
  of the identity's terms, i.e. ``|d̂_port² − d̂_jax²| ≤ 1e-5·(1 + (‖q‖ +
  max‖x‖)²)`` per query; ids equal on ≥ 99% of entries (the rare near-tie
  swaps with the sums' order).
* K1a-bf16's plain version against the Pallas kernel (interpret): the same
  bf16 products, f32 sums in other orders: the l2 values within 1e-5·(1 +
  ‖q − c‖² + sn²), ids on ≥ 99% of entries.
* the fused estimator tier folds: recall against the exact scan within
  0.01 of the JAX package's, estimates on shared ids as above.
* exact reranks: as the binary tests, 1e-5·(1 + ‖q‖² + max‖x‖²).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import annsearch_tpu as ja
import annsearch_tpu_torch as at
from annsearch_tpu.models.binary.rabitq import ExhaustiveIndexRaBitQ as JExh
from annsearch_tpu.models.binary.rabitq import IvfIndexRaBitQ as JIvf
from annsearch_tpu.models.binary.rabitq import RaBitQEncoder as JEncoder
from annsearch_tpu.models.ivf_base import route_to_cells as j_route
from annsearch_tpu.ops import ivf_scan_pallas as jsp
from annsearch_tpu.ops.probe_device import build_probe_lists_device as j_build
from annsearch_tpu.ops.probe_device import device_probe_shapes
from annsearch_tpu.utils.dist import Dist as JDist
from annsearch_tpu_torch import interop
from annsearch_tpu_torch.models.binary import ExhaustiveIndexRaBitQ, IvfIndexRaBitQ, RaBitQEncoder
from annsearch_tpu_torch.models.binary import DeviceVectorStore, MmapVectorStore
from annsearch_tpu_torch.ops import ivf_scan_fused as tsf
from annsearch_tpu_torch.utils.data import generate_clustered_data, subsample_with_noise
from annsearch_tpu_torch.utils.dist import Dist

torch.set_num_threads(2)

K = 10
LOADERS = {"exhaustive": (JExh, interop.exhaustive_rabitq_from_jax_arrays),
           "ivf": (JIvf, interop.ivf_rabitq_from_jax_arrays)}


def jax_state(j):
    """``(arrays, meta)`` of a JAX RaBitQ index as its ``save`` writes them."""
    arrays = {name: np.asarray(getattr(j, name))
              for name in j._state_arrays + j._persist_extra_arrays
              if getattr(j, name, None) is not None}
    arrays["cluster_ptr"] = np.asarray(j._cluster_ptr)
    meta = {name: getattr(j, name) if isinstance(getattr(j, name), (str, bool))
            else int(getattr(j, name)) for name in j._state_scalars}
    meta["metric"] = j.metric.value
    return arrays, meta


def assert_rerank_close(td, jd, q, x) -> None:
    """Exact-rerank distances within 1e-5·(1 + ‖q‖² + max‖x‖²): the f32
    rounding of ``‖q‖² + ‖x‖² − 2q·x``'s terms, however small the
    distance."""
    tol = 1e-5 * (1.0 + (np.asarray(q, np.float64) ** 2).sum(axis=1, keepdims=True)
                  + (np.asarray(x, np.float64) ** 2).sum(axis=1).max())
    diff = np.abs(np.asarray(td, np.float64) - np.asarray(jd, np.float64))
    assert (diff <= tol).all(), float((diff / tol).max())


def assert_estimates_close(td, jd, q, x) -> None:
    """Squared estimates within 1e-5·(1 + (‖q‖ + max‖x‖)²) per query."""
    qn = np.linalg.norm(np.asarray(q, np.float64), axis=1, keepdims=True)
    tol = 1e-5 * (1.0 + (qn + np.linalg.norm(np.asarray(x, np.float64), axis=1).max()) ** 2)
    td2, jd2 = np.asarray(td, np.float64) ** 2, np.asarray(jd, np.float64) ** 2
    both = np.isfinite(td2) & np.isfinite(jd2)
    assert (np.isfinite(td2) == np.isfinite(jd2)).all()
    diff = np.abs(td2 - jd2)
    assert (diff[both] <= np.broadcast_to(tol, diff.shape)[both]).all()


def assert_reranks_agree(ti, td, ji, jd, q, x) -> None:
    """Exact reranks of the estimator's candidates: ids on ≥ 99% of entries
    (a near-tie at the pool's edge may take another row in), distances
    within the rerank tolerance where the ids agree."""
    shared = ti.numpy() == np.asarray(ji)
    assert shared.mean() >= 0.99
    assert_rerank_close(np.where(shared, td.numpy(), 0), np.where(shared, np.asarray(jd), 0),
                        q, x)


@pytest.fixture(scope="module")
def data():
    x, _ = generate_clustered_data(2000, 64, 8, seed=11)
    q = subsample_with_noise(x, 100, seed=12)
    ti, _ = at.build_exhaustive_index(x, device="cpu").query(q, K)
    return x, q, ti


@pytest.fixture(scope="module")
def exh(data):
    """A JAX ExhaustiveIndexRaBitQ (22 cells of 128-row segments: the fused
    tier) and the port's carried copy."""
    j = JExh(data[0], seed=0)
    t = interop.exhaustive_rabitq_from_jax_arrays(*jax_state(j), device="cpu")
    assert j._fused_est_ok(K) and t._fused_est_ok(K)
    return j, t


# -- the encoder --------------------------------------------------------------------


def test_encoder_with_the_jax_rotation(data, exh):
    j, _ = exh
    x = data[0]
    rot = np.asarray(j.rotation)
    owner = np.asarray(j._owner_clusters())
    xs = x[np.asarray(j.original_ids)[: j.n]]
    cents = np.asarray(j.centroids)[owner]
    jbits, jdist, jcorr = (np.asarray(a) for a in JEncoder(j.rotation, j.dim).encode_vectors(
        xs, cents))
    tbits, tdist, tcorr = RaBitQEncoder(torch.tensor(rot), j.dim).encode_vectors(
        torch.tensor(xs), torch.tensor(cents))
    np.testing.assert_allclose(tdist.numpy(), jdist, rtol=1e-5)
    np.testing.assert_allclose(tcorr.numpy(), jcorr, rtol=1e-5)
    got = np.unpackbits(tbits.numpy().view(np.uint8), axis=1, bitorder="little")
    want = np.unpackbits(jbits.view(np.uint8), axis=1, bitorder="little")
    differ = np.nonzero(got[:, : j.dim] != want[:, : j.dim])
    r = xs.astype(np.float64) - cents
    ru = (r / np.linalg.norm(r, axis=1, keepdims=True)) @ rot.astype(np.float64).T
    assert (np.abs(ru[differ]) < 1e-6).all()
    assert len(differ[0]) == 0, f"{len(differ[0])} near-zero components rounded apart"


def test_the_ports_rotation_is_orthogonal():
    e = RaBitQEncoder.create(48, seed=5, device="cpu")
    r = e.rotation.double()
    torch.testing.assert_close(r @ r.T, torch.eye(48, dtype=torch.float64), atol=1e-5, rtol=0)
    assert torch.equal(RaBitQEncoder.create(48, seed=5, device="cpu").rotation, e.rotation)
    v = torch.randn(5, 48)
    assert e.rotate_padded(v).shape == (5, 64) and (e.rotate_padded(v)[:, 48:] == 0).all()


# -- the cluster scan (mode rabitq) ---------------------------------------------------


@pytest.mark.parametrize("kind", ["exhaustive", "ivf"])
def test_cluster_scan_estimator_matches_jax(data, kind):
    x, q, _ = data
    jcls, load = LOADERS[kind]
    j = jcls(x, seed=0, fast_scan=False)
    t = load(*jax_state(j), device="cpu")
    assert not t._fused_est_ok(K)
    ji, jd = j.query(q, K)
    ti, td = t.query(q, K)
    shared = ti.numpy() == np.asarray(ji)
    assert shared.mean() >= 0.99
    assert_estimates_close(td.numpy()[shared][:, None], np.asarray(jd)[shared][:, None],
                           np.repeat(q, K, axis=0)[shared.reshape(-1)], x)


# -- kernel K1a-bf16's plain version against the Pallas kernel -----------------------


@pytest.mark.parametrize("selection,fold_depth", [("fold", 2), ("fold", 1), ("exact", 2)],
                         ids=["fold2", "fold1", "exact"])
def test_k1a_bf16_plain_matches_the_pallas_kernel(data, exh, selection, fold_depth):
    """The port's ``fused_ivf_scan`` over the estimator's bf16 cells (mode
    ``i8dec_residual``, unit scales, two query terms: K1a-bf16's plain
    version) against the JAX ``fused_ivf_scan`` in interpret mode, on the
    JAX router's task lists and the same cells."""
    j, t = exh
    _, q, _ = data
    jblocks, jsn = j._est_blocks()
    cells, sn = t._est_blocks()
    assert cells.dtype == torch.bfloat16
    jcells = np.asarray(jblocks[0], np.float32)    # lane-padded to 128 columns
    dp = cells.shape[2]
    np.testing.assert_array_equal(cells.float().numpy(), jcells[:, :, :dp])
    assert (jcells[:, :, dp:] == 0).all()
    np.testing.assert_array_equal(sn.numpy(), np.asarray(jsn)[:, 0, :])
    nseg = int(j.seg_offsets.shape[0])
    nprobe_seg = min(nseg, max(4, -(-4 * nseg) // j.nlist))
    maxq, R = device_probe_shapes(len(q), nprobe_seg, nseg, 1)
    probes = j_route(jnp.asarray(q), j.seg_centroids, nprobe_seg, JDist.EUCLIDEAN)
    cids, lists, gmap = j_build(probes.astype(np.int32), nseg, maxq, R)
    nbits = j.encoder.n_words * 32
    k = 40
    jd, ji = jsp.fused_ivf_scan(
        j._encode_queries(q), cids, lists, gmap, jblocks, jsn, j.seg_offsets, j.seg_counts,
        j._scan_seg_centroids(), k, JDist.EUCLIDEAN, "i8dec_residual",
        np.ones(nbits, np.float32), 64, interpret=True, fold_depth=fold_depth,
        selection=selection,
    )
    tsf.ivf_cell_scan_bf16_residual.launches = 0
    td, ti = tsf.fused_ivf_scan(
        t._encode_queries(torch.tensor(q)), torch.tensor(np.asarray(cids)),
        torch.tensor(np.asarray(lists)), torch.tensor(np.asarray(gmap)), cells, sn,
        t.seg_offsets, t.seg_counts, t._scan_seg_centroids(), k, Dist.EUCLIDEAN,
        "i8dec_residual", torch.ones(nbits), 64, q_split=True, fold_depth=fold_depth,
        selection=selection,
    )
    assert tsf.ivf_cell_scan_bf16_residual.launches == 0   # the plain version counts none
    jd, ji = np.asarray(jd), np.asarray(ji)
    assert (ti.numpy() == ji).mean() >= 0.99
    # a bound on the identity's terms ‖q − c‖² + sn² (rotations keep norms)
    c_max = float(t.seg_centroids.norm(dim=1).max())
    scale = 1.0 + (np.linalg.norm(q, axis=1, keepdims=True) + c_max) ** 2 + float(sn.max())
    fin = np.isfinite(jd)
    assert (np.isfinite(td.numpy()) == fin).all()
    assert (np.abs(td.numpy() - jd)[fin] <= (1e-5 * np.broadcast_to(scale, jd.shape))[fin]).all()


@pytest.mark.parametrize("mode,cosine,q_split,selection,fold_depth", [
    ("i8dec", False, False, "fold", 2),
    ("i8dec", False, True, "fold", 1),
    ("i8dec", True, False, "fold", 2),
    ("i8dec", True, True, "exact", 2),
    ("i8dec_residual", True, False, "fold", 2),
    ("i8dec_residual", True, True, "exact", 2),
    ("i8dec_residual", False, False, "fold", 2),
    ("i8dec_residual", False, False, "exact", 2),
], ids=["i8dec-l2", "i8dec-l2-split-fold1", "i8dec-cos", "i8dec-cos-split-exact",
        "residual-cos", "residual-cos-split-exact", "residual-l2-one-term",
        "residual-l2-one-term-exact"])
def test_bf16_decode_plain_matches_the_pallas_kernel(data, exh, mode, cosine, q_split,
                                                      selection, fold_depth):
    """K1-bf16-decode: ``fused_ivf_scan`` over the estimator's bf16 cells
    under the modes, epilogues and term counts K1a-bf16 does not take (its
    plain version on the CPU) against the JAX ``fused_ivf_scan`` in
    interpret mode, which casts any cell type, on the same queries (unit
    under cosine), scales, task lists and cells: ids on ≥ 99% of entries,
    distances on shared ids within 1e-5 of the identity's terms (l2:
    ``‖q − c‖² + sn``; cos_renorm: 1 + |1 − d|, the renormalised dot's
    size). The fold is approximate, so both are also held to the same
    recall band against the exact scan."""
    j, t = exh
    _, q, ti_true = data
    jblocks, jsn = j._est_blocks()
    cells, sn = t._est_blocks()
    nbits = j.encoder.n_words * 32
    qe = t._encode_queries(torch.tensor(q))
    if cosine:
        qe = qe / qe.norm(dim=1, keepdim=True)
    scales = np.random.default_rng(3).uniform(0.5, 1.5, nbits).astype(np.float32)
    metric, jmetric = (Dist.COSINE, JDist.COSINE) if cosine else (Dist.EUCLIDEAN,
                                                                   JDist.EUCLIDEAN)
    nseg = int(j.seg_offsets.shape[0])
    nprobe_seg = min(nseg, max(4, -(-4 * nseg) // j.nlist))
    maxq, R = device_probe_shapes(len(q), nprobe_seg, nseg, 1)
    probes = j_route(jnp.asarray(q), j.seg_centroids, nprobe_seg, JDist.EUCLIDEAN)
    cids, lists, gmap = j_build(probes.astype(np.int32), nseg, maxq, R)
    k = 20
    jd, ji = jsp.fused_ivf_scan(
        jnp.asarray(qe.numpy()), cids, lists, gmap, jblocks, jsn, j.seg_offsets,
        j.seg_counts, j._scan_seg_centroids(), k, jmetric, mode, jnp.asarray(scales), 32,
        interpret=True, q_split=q_split, fold_depth=fold_depth, selection=selection,
    )
    tsf.ivf_cell_scan_bf16_decode.launches = 0
    td, ti = tsf.fused_ivf_scan(
        qe, torch.tensor(np.asarray(cids)), torch.tensor(np.asarray(lists)),
        torch.tensor(np.asarray(gmap)), cells, sn, t.seg_offsets, t.seg_counts,
        t._scan_seg_centroids(), k, metric, mode, torch.tensor(scales), 32, q_split=q_split,
        fold_depth=fold_depth, selection=selection,
    )
    assert tsf.ivf_cell_scan_bf16_decode.launches == 0   # the plain version counts none
    jd, ji, td, ti = np.asarray(jd), np.asarray(ji), td.numpy(), ti.numpy()
    shared = ti == ji
    assert shared.mean() >= 0.99
    fin = np.isfinite(jd)
    assert (np.isfinite(td) == fin).all()
    if cosine:
        scale = 1.0 + np.abs(1.0 - np.where(fin, jd, 1.0))
    else:
        c_max = float(t.seg_centroids.norm(dim=1).max())
        qn = np.linalg.norm(qe.numpy(), axis=1, keepdims=True)
        scale = np.broadcast_to(1.0 + (qn + c_max) ** 2 + float(sn.max()), jd.shape)
    ok = fin & shared
    assert (np.abs(td - jd)[ok] <= 1e-5 * scale[ok]).all()
    # the two packages' recall against the exact scan, in one band
    orig = np.concatenate([t.original_ids.numpy(), np.full(cells.numel(), -1)])
    r_t = at.calculate_recall(ti_true, torch.tensor(orig[ti]), K)
    r_j = at.calculate_recall(ti_true, torch.tensor(orig[ji]), K)
    assert abs(r_t - r_j) <= 0.01


# -- the fused estimator tier -----------------------------------------------------------


def test_fused_estimator_against_jax_interpret(data, exh, monkeypatch):
    """Both packages take the fused tier, then re-estimate the returned slots
    exactly: recall within 0.01, estimates on shared ids close."""
    x, q, ti_true = data
    j, t = exh
    calls = []
    plain = tsf.ivf_cell_scan_bf16_residual
    monkeypatch.setattr(tsf, "ivf_cell_scan_bf16_residual",
                        lambda *a, **kw: calls.append(kw) or plain(*a, **kw))
    ji, jd = j.query(q, K, nprobe=4)
    ti, td = t.query(q, K, nprobe=4)
    assert calls   # RaBitQ's two query terms over bf16 cells: K1a-bf16
    r_j = at.calculate_recall(ti_true, torch.tensor(np.asarray(ji)), K)
    r_t = at.calculate_recall(ti_true, ti, K)
    assert abs(r_j - r_t) <= 0.01
    shared = ti.numpy() == np.asarray(ji)
    assert shared.mean() >= 0.9
    qq = np.repeat(q, K, axis=0)[shared.reshape(-1)]
    assert_estimates_close(td.numpy()[shared][:, None], np.asarray(jd)[shared][:, None], qq, x)


def test_rescore_estimator_matches_jax(data, exh):
    """The exact clipped estimator at the same storage positions (some
    marked invalid, some in the pad rows)."""
    x, q, _ = data
    j, t = exh
    rng = np.random.default_rng(13)
    pos = rng.integers(0, j.storage.shape[0], (len(q), 12)).astype(np.int32)
    d_in = np.ones((len(q), 12), np.float32)
    d_in[:, -2:] = np.inf
    jd, jp = j._rescore_estimator(np.asarray(q), pos, d_in)
    td, tp = t._rescore_estimator(torch.tensor(q), torch.tensor(pos), torch.tensor(d_in))
    jd, jp = np.asarray(jd), np.asarray(jp)
    assert (tp.numpy() == jp).mean() >= 0.99
    assert np.isinf(td.numpy()[:, -2:]).all()
    same = tp.numpy() == jp
    assert_estimates_close(td.numpy()[same][:, None], jd[same][:, None],
                           np.repeat(q, 12, axis=0)[same.reshape(-1)], x)


def test_k_scan_above_128_keeps_the_fused_tier(data, exh, monkeypatch):
    """``rerank="exact"`` at k 10 and factor 20 asks 200 of the scan: the
    fused tier still runs (kb 128) and the exact rerank equals the JAX
    package's."""
    x, q, _ = data
    j, t = exh
    kbs = []
    plain = tsf.ivf_cell_scan_bf16_residual
    monkeypatch.setattr(tsf, "ivf_cell_scan_bf16_residual",
                        lambda *a, **kw: kbs.append(a[8]) or plain(*a, **kw))
    ji, jd = j.query(q, K, nprobe=4, rerank="exact", rerank_factor=20, exact_fallback=False)
    ti, td = t.query(q, K, nprobe=4, rerank="exact", rerank_factor=20, exact_fallback=False)
    assert kbs == [128]
    assert_reranks_agree(ti, td, ji, jd, q, x)


def test_a_row_on_its_centroid_scores_as_a_zero_row():
    """A row sitting on its centroid has correction 0: its estimator row is
    zero (``mult = 0``), its estimate ``sqrt(sn² + qd²)`` = ``qd``."""
    rng = np.random.default_rng(14)
    x = rng.standard_normal((300, 32)).astype(np.float32)
    t = ExhaustiveIndexRaBitQ(x, nlist=3, seed=0, device="cpu")
    pos = int(t.seg_offsets[0])
    t.aux_corr[pos] = 0.0
    t.store_sqnorms[pos] = 0.0
    cells, _ = t._est_blocks()
    assert (cells[0, 0].float() == 0).all() and (cells[0, 1].float() != 0).any()
    q = torch.tensor(x[:4])
    d, p = t._rescore_estimator(q, torch.full((4, 1), pos), torch.zeros(4, 1))
    c = t.centroids[t._owner_j()[pos]]
    torch.testing.assert_close(d[:, 0], (q - c).norm(dim=1), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["exhaustive", "ivf"])
def test_exact_rerank_matches_jax(data, kind):
    x, q, ti_true = data
    jcls, load = LOADERS[kind]
    j = jcls(x, seed=0, fast_scan=False)
    t = load(*jax_state(j), device="cpu")
    ji, jd = j.query(q, K, nprobe=6, rerank="exact", exact_fallback=False)
    ti, td = t.query(q, K, nprobe=6, rerank="exact", exact_fallback=False)
    assert_reranks_agree(ti, td, ji, jd, q, x)
    assert at.calculate_recall(ti_true, ti, K) > 0.9


# -- stores, cosine, self-queries, the facade, npz files ------------------------------


def test_device_and_mmap_stores_answer_alike(data, tmp_path):
    x, q, _ = data
    a = IvfIndexRaBitQ(x, seed=1, device="cpu")
    b = IvfIndexRaBitQ(x, seed=1, store=str(tmp_path / "s"), device="cpu")
    assert isinstance(a.store, DeviceVectorStore) and b.store.route == "native"
    ra = a.query(q, K, rerank="exact", exact_fallback=False)
    rb = b.query(q, K, rerank="exact", exact_fallback=False)
    assert torch.equal(ra[0], rb[0]) and torch.equal(ra[1], rb[1])


def test_cosine_matches_jax(data):
    x, q, _ = data
    j = JExh(x, "cosine", seed=0)
    t = interop.exhaustive_rabitq_from_jax_arrays(*jax_state(j), device="cpu")
    ji, jd = j.query(q, K, nprobe=4, rerank="exact", exact_fallback=False)
    ti, td = t.query(q, K, nprobe=4, rerank="exact", exact_fallback=False)
    assert_reranks_agree(ti, td, ji, jd, np.ones((len(q), 1)), np.ones((1, 1)))  # unit rows


def test_self_queries(exh):
    _, t = exh
    ids, d = t.generate_knn(5, nprobe=6, rerank="exact", exact_fallback=False)
    assert ids.shape == (t.n, 5)
    assert (ids[:, 0] == torch.arange(t.n)).float().mean() > 0.99
    assert (d[:, 0] < 1e-3).float().mean() > 0.99


@pytest.mark.parametrize("kind", ["exhaustive", "ivf"])
def test_facade_rows_match_jax(data, kind):
    x, q, _ = data
    jcls, load = LOADERS[kind]
    j = getattr(ja, f"build_{kind}_index_rabitq")(x, seed=0)
    t = load(*jax_state(j), device="cpu")
    built = getattr(at, f"build_{kind}_index_rabitq")(x, "euclidean", 20, device="cpu")
    assert isinstance(built, ExhaustiveIndexRaBitQ if kind == "exhaustive" else IvfIndexRaBitQ)
    assert built.nlist == 20
    qrow = getattr(at, f"query_{kind}_index_rabitq")
    ji, jd = getattr(ja, f"query_{kind}_index_rabitq")(q, j, K, 4, "exact", return_dist=True)
    ti, td = qrow(q, t, K, 4, "exact", return_dist=True)
    assert_reranks_agree(ti, td, ji, jd, q, x)
    ti, td = qrow(q, built, K)
    assert td is None and ti.shape == (len(q), K)
    si, _ = getattr(at, f"query_{kind}_index_rabitq_self")(t, 3, 6, "exact")
    assert si.shape == (t.n, 3) and (si[:, 0] == torch.arange(t.n)).float().mean() > 0.99


@pytest.mark.parametrize("kind", ["exhaustive", "ivf"])
def test_jax_npz_loads(data, tmp_path, kind):
    x, q, _ = data
    jcls, _ = LOADERS[kind]
    cls = ExhaustiveIndexRaBitQ if kind == "exhaustive" else IvfIndexRaBitQ
    for store in (True, str(tmp_path / f"{kind}_store")):
        j = jcls(x, seed=0, store=store)
        path = str(tmp_path / f"{kind}.npz")
        j.save(path)
        t = cls.load(path, device="cpu")
        assert isinstance(t.store, DeviceVectorStore if store is True else MmapVectorStore)
        ji, jd = j.query(q, K, nprobe=4, rerank="exact", exact_fallback=False)
        ti, td = t.query(q, K, nprobe=4, rerank="exact", exact_fallback=False)
        assert_reranks_agree(ti, td, ji, jd, q, x)
        t.save(str(tmp_path / "again.npz"))
        again = cls.load(str(tmp_path / "again.npz"), device="cpu")
        assert torch.equal(again.query(q, K, nprobe=4)[0], t.query(q, K, nprobe=4)[0])
