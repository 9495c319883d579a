"""The binary family's bit layer and binary indexes, port against the JAX
package on the same numpy inputs (the JAX fused Hamming tier runs in
interpret mode, as on the TPU).

Tolerances, and why:

* packing, unpacking, popcount and the Hamming tier are integer work: bit
  for bit, ids and distances equal (both packages select ties to the lower
  row: ``lax.top_k``'s order, ``topk_smallest`` in the port). The JAX
  words are uint32, the port's int32 bit patterns of the same words.
* binariser codes from the JAX projections: bit for bit, save where the
  projection lies within 1e-6·‖row‖ of 0 (two f32 products may round a
  sign apart there); such bits are counted, and none is expected here.
* the asymmetric tier is one bf16 pass in both packages' packed route (the
  query rounded to bf16, exact ±1 codes, f32 sums): ids equal, distances
  within the f32 rounding of the sums, 2⁻²⁰·Σ|q|. The JAX fast route
  scores the f32 query through the l2 identity: within 2⁻⁸·Σ|q| (bf16's
  rounding of the query) plus 1e-6·(‖q‖² + nbits) on shared ids.
* exact reranks: the same candidates rescored in f32 in both packages, the
  sums in other orders: ids equal, distances within 1e-5·(1 + ‖q‖² +
  max‖x‖²) (``‖q‖² + ‖x‖² − 2q·x`` rounds in f32 to a few ulps of its
  terms, however small the distance).
* the fused Hamming tier's fold is approximate: recall against the exact
  scan within 0.01 of the JAX package's, distances on shared ids equal,
  and every returned distance equal to an int64 popcount of the codes.
  The cluster scan (``fast_scan=False``) is exact: ids and distances equal.
"""

import numpy as np
import pytest
import torch

import annsearch_tpu as ja
import annsearch_tpu_torch as at
from annsearch_tpu.models.binary import Binariser as JBinariser
from annsearch_tpu.models.binary import ExhaustiveIndexBinary as JFlat
from annsearch_tpu.models.binary import IvfIndexBinary as JIvf
from annsearch_tpu.ops import binary as jb
from annsearch_tpu.ops.rerank import rerank_from_store as j_rerank_from_store
from annsearch_tpu.utils.dist import Dist as JDist
from annsearch_tpu_torch import interop
from annsearch_tpu_torch.models.binary import (
    Binariser,
    DeviceVectorStore,
    ExhaustiveIndexBinary,
    IvfIndexBinary,
    MmapVectorStore,
)
from annsearch_tpu_torch.ops import binary as tb
from annsearch_tpu_torch.ops.rerank import rerank_from_store
from annsearch_tpu_torch.utils.data import generate_clustered_data, subsample_with_noise
from annsearch_tpu_torch.utils.dist import Dist

torch.set_num_threads(2)

K = 10


def jax_state(j, ivf: bool):
    """``(arrays, meta)`` of a JAX index as its ``save`` writes them."""
    arrays = {}
    for name in j._state_arrays + j._persist_extra_arrays:
        v = getattr(j, name, None)
        if v is not None:
            arrays[name] = np.asarray(v)
    if ivf:
        arrays["cluster_ptr"] = np.asarray(j._cluster_ptr)
    meta = {}
    for name in j._state_scalars:
        v = getattr(j, name)
        meta[name] = v if isinstance(v, (str, bool)) else int(v)
    meta["metric"] = j.metric.value
    return arrays, meta


def words(a) -> np.ndarray:
    """JAX uint32 words as the port's int32 bit patterns."""
    return np.asarray(a).view(np.int32)


def assert_rerank_close(td, jd, q, x) -> None:
    """Exact-rerank distances within 1e-5·(1 + ‖q‖² + max‖x‖²)."""
    tol = 1e-5 * (1.0 + (np.asarray(q, np.float64) ** 2).sum(axis=1, keepdims=True)
                  + (np.asarray(x, np.float64) ** 2).sum(axis=1).max())
    diff = np.abs(np.asarray(td, np.float64) - np.asarray(jd, np.float64))
    assert (diff <= tol).all(), float((diff / tol).max())


def popcount_rows(q_words, x_words) -> np.ndarray:
    """int64 Hamming distances ``[nq, k]`` of query codes against the
    gathered code rows ``[nq, k, w]`` (numpy, unsigned words)."""
    x = np.bitwise_xor(q_words.view(np.uint32)[:, None, :], x_words.view(np.uint32))
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(axis=-1).astype(np.int64)


@pytest.fixture(scope="module")
def data():
    x, _ = generate_clustered_data(2000, 64, 8, seed=1)
    q = subsample_with_noise(x, 100, seed=2)
    ti, _ = at.build_exhaustive_index(x, device="cpu").query(q, K)
    return x, q, ti


@pytest.fixture(scope="module")
def flat(data):
    """A JAX flat binary index (128 bits) and the port's carried copy."""
    x, _, _ = data
    j = JFlat(x, n_bits=128, seed=0)
    return j, interop.exhaustive_binary_from_jax_arrays(*jax_state(j, False), device="cpu")


@pytest.fixture(scope="module")
def ivf(data):
    """A JAX IVF binary index (nlist 8, segments of 256: fused-eligible) and
    the port's carried copy."""
    x, _, _ = data
    j = JIvf(x, nlist=8, n_bits=128, seed=0)
    t = interop.ivf_binary_from_jax_arrays(*jax_state(j, True), device="cpu")
    assert j._fused_hamming_ok(K) and t._fused_hamming_ok(K)
    return j, t


# -- the bit layer ----------------------------------------------------------------


@pytest.mark.parametrize("nbits", [32, 77, 256])
def test_pack_unpack_match_jax_bit_for_bit(nbits):
    bits = np.random.default_rng(nbits).integers(0, 2, (19, nbits)).astype(bool)
    packed = tb.pack_bits(torch.tensor(bits))
    assert packed.dtype == torch.int32 and packed.shape == (19, -(-nbits // 32))
    np.testing.assert_array_equal(packed.numpy(), words(jb.pack_bits(bits)))
    np.testing.assert_array_equal(tb.unpack_bits(packed, nbits).numpy(), bits.astype(np.int32))
    pm = tb.unpack_pm1(packed, nbits)
    assert pm.dtype == torch.bfloat16
    np.testing.assert_array_equal(pm.float().numpy(),
                                  np.asarray(jb.unpack_pm1(jb.pack_bits(bits), nbits), np.float32))


def test_popcount_matches_jax_and_numpy():
    rng = np.random.default_rng(3)
    a, b = rng.integers(0, 2, (7, 96)).astype(bool), rng.integers(0, 2, (41, 96)).astype(bool)
    pa, pb = tb.pack_bits(torch.tensor(a)), tb.pack_bits(torch.tensor(b))
    got = tb.hamming_popcount(pa, pb).numpy()
    np.testing.assert_array_equal(got, (a[:, None, :] != b[None, :, :]).sum(-1))
    np.testing.assert_array_equal(got, np.asarray(jb.hamming_popcount(jb.pack_bits(a),
                                                                      jb.pack_bits(b))))


@pytest.mark.parametrize("n_valid", [300, 257])
def test_chunked_topk_hamming_matches_jax(n_valid):
    """Ties at every rank (48 bits over 300 rows), chunks of 64: the ids and
    distances are the JAX package's, rows past ``n_valid`` never win."""
    rng = np.random.default_rng(4)
    qb, xb = rng.integers(0, 2, (9, 48)).astype(bool), rng.integers(0, 2, (300, 48)).astype(bool)
    jq, jx = jb.pack_bits(qb), jb.pack_bits(xb)
    jd, ji = jb.chunked_topk_hamming(jq, jx, 40, 48, n_valid, db_chunk=64)
    td, ti = tb.chunked_topk_hamming(torch.tensor(words(jq)), torch.tensor(words(jx)), 40, 48,
                                     n_valid, db_chunk=64)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert ti.max() < n_valid


def test_chunked_topk_asymmetric_matches_jax():
    rng = np.random.default_rng(5)
    qp = rng.standard_normal((9, 64)).astype(np.float32)
    jx = jb.pack_bits(rng.integers(0, 2, (300, 64)).astype(bool))
    jd, ji = jb.chunked_topk_asymmetric(qp, jx, 20, 64, 300, db_chunk=64)
    td, ti = tb.chunked_topk_asymmetric(torch.tensor(qp), torch.tensor(words(jx)), 20, 64,
                                        300, db_chunk=64)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    tol = 2.0 ** -20 * np.abs(qp).sum(axis=1, keepdims=True)
    assert (np.abs(td.numpy() - np.asarray(jd)) <= tol).all()


# -- binariser --------------------------------------------------------------------


@pytest.mark.parametrize("mode,n_bits", [("simhash", 64), ("simhash", 160), ("pca", 48),
                                         ("pca", 96), ("sign", None)])
def test_binariser_codes_with_jax_projections(data, mode, n_bits):
    """The JAX projections carried across encode every row bit for bit, but
    where |projection| < 1e-6·‖row‖ (counted; none expected)."""
    x = data[0]
    j = JBinariser.train(x, n_bits, mode, seed=0)
    st = j.state()
    t = Binariser.from_state(st["n_bits"], st["mode"], st.get("projections"), st.get("mean"),
                             device="cpu")
    assert t.n_bits == j.n_bits and t.n_words == j.n_words
    got = t.encode(torch.tensor(x)).numpy()
    want = words(j.encode(x))
    bits_got = np.unpackbits(got.view(np.uint8), axis=1, bitorder="little")
    bits_want = np.unpackbits(want.view(np.uint8), axis=1, bitorder="little")
    differ = np.nonzero(bits_got[:, : t.n_bits] != bits_want[:, : t.n_bits])
    if mode == "sign":
        proj = x.astype(np.float64)
    else:
        mean = 0.0 if st.get("mean") is None else st["mean"].astype(np.float64)
        proj = (x - mean) @ st["projections"].astype(np.float64)
    near = np.abs(proj[differ]) < 1e-6 * np.linalg.norm(x[differ[0]], axis=1)
    assert near.all(), f"{(~near).sum()} bits differ away from the hyperplane"
    assert len(differ[0]) == 0, f"{len(differ[0])} near-zero projections rounded apart"


def test_simhash_blocks_orthonormal():
    x = torch.randn(300, 24)
    b = Binariser.train(x, 60, "simhash", seed=3)
    p = b.projections
    assert p.shape == (24, 60)
    for s in range(0, 60, 24):
        blk = p[:, s : s + 24].double()
        torch.testing.assert_close(blk.T @ blk, torch.eye(blk.shape[1], dtype=torch.float64),
                                   atol=1e-5, rtol=0)
    again = Binariser.train(x, 60, "simhash", seed=3)
    assert torch.equal(again.projections, p)


def test_pca_loadings_match_numpy_svd_up_to_sign():
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((500, 16)) * np.linspace(4, 0.5, 16)).astype(np.float32)
    b = Binariser.train(torch.tensor(x), 24, "pca", seed=0)
    xc = x.astype(np.float64) - x.astype(np.float64).mean(axis=0)
    _, _, vh = np.linalg.svd(xc, full_matrices=False)
    v = b.projections[:, :16].double().numpy()
    np.testing.assert_allclose(np.abs((v * vh.T).sum(axis=0)), 1.0, atol=1e-4)
    pad = b.projections[:, 16:].double()
    torch.testing.assert_close(pad.T @ pad, torch.eye(8, dtype=torch.float64), atol=1e-5, rtol=0)
    np.testing.assert_allclose(b.mean.numpy(), x.mean(axis=0), atol=1e-5)


# -- the flat binary index --------------------------------------------------------


@pytest.mark.parametrize("fast_scan", [True, False], ids=["fast", "packed"])
def test_flat_hamming_matches_jax(data, flat, fast_scan):
    _, q, _ = data
    j, t = flat
    t.fast_scan = fast_scan
    ji, jd = j.query(q, K)
    ti, td = t.query(q, K)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    codes = words(j.codes)
    q_codes = words(j.binariser.encode(q))
    np.testing.assert_array_equal(td.numpy(), popcount_rows(q_codes, codes[ti.numpy()]))


def test_flat_asymmetric_tier(data, flat):
    """Against the JAX packed route (one bf16 pass) and its fast route (the
    f32 query through the l2 identity)."""
    x, q, _ = data
    j, t = flat
    ti, td = t.query(q, K, rerank="asymmetric")
    t.fast_scan = False
    ti2, td2 = t.query(q, K, rerank="asymmetric")
    t.fast_scan = True
    assert torch.equal(ti, ti2) and torch.equal(td, td2)
    qp = np.asarray(j.binariser.project(q))
    absq = np.abs(qp).sum(axis=1, keepdims=True)
    packed = JFlat(x, n_bits=128, seed=0, fast_scan=False)
    pi, pd = packed.query(q, K, rerank="asymmetric")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(pi))
    assert (np.abs(td.numpy() - np.asarray(pd)) <= 2.0 ** -20 * absq).all()
    fi, fd = j.query(q, K, rerank="asymmetric")
    shared = ti.numpy() == np.asarray(fi)
    assert shared.mean() >= 0.9
    tol = 2.0 ** -8 * absq + 1e-6 * ((qp * qp).sum(axis=1, keepdims=True) + 128)
    assert (np.abs(td.numpy() - np.asarray(fd)) <= tol)[shared].all()


def test_flat_exact_rerank_matches_jax(data, flat):
    _, q, ti_true = data
    j, t = flat
    ji, jd = j.query(q, K, rerank="exact", exact_fallback=False)
    ti, td = t.query(q, K, rerank="exact", exact_fallback=False)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert_rerank_close(td, jd, q, data[0])
    assert at.calculate_recall(ti_true, ti, K) > 0.8


# -- rerank_from_store ----------------------------------------------------------


@pytest.mark.parametrize("nq", [37, 600], ids=["one-short-block", "two-blocks"])
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_rerank_from_store_matches_jax(nq, metric):
    """nq smaller than the 512-query block and past it; ids past the store
    clamped into it; slots at +inf left out."""
    rng = np.random.default_rng(nq)
    store = rng.standard_normal((400, 24)).astype(np.float32)
    if metric == "cosine":
        store /= np.linalg.norm(store, axis=1, keepdims=True)
    q = rng.standard_normal((nq, 24)).astype(np.float32)
    cand = rng.integers(0, 460, (nq, 30)).astype(np.int32)
    cand_d = rng.random((nq, 30)).astype(np.float32)
    cand_d[:, -4:] = np.inf
    jd, ji = j_rerank_from_store(q, cand_d, cand, store, K, JDist(metric))
    td, ti = rerank_from_store(torch.tensor(q), torch.tensor(cand_d), torch.tensor(cand),
                               torch.tensor(store), K, Dist(metric))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert_rerank_close(td, jd, q, store)
    assert ti.max() <= 399


# -- the IVF binary index -------------------------------------------------------


def test_ivf_cluster_scan_modes_match_jax(data):
    """``fast_scan=False``: the Hamming tier, the asymmetric tier (both the
    cluster scan) and the exact rerank equal the JAX package's."""
    x, q, _ = data
    j = JIvf(x, nlist=8, n_bits=128, seed=0, fast_scan=False)
    t = interop.ivf_binary_from_jax_arrays(*jax_state(j, True), device="cpu")
    assert not t._fused_hamming_ok(K)
    ji, jd = j.query(q, K, nprobe=3)
    ti, td = t.query(q, K, nprobe=3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    ji, jd = j.query(q, K, nprobe=3, rerank="asymmetric")
    ti, td = t.query(q, K, nprobe=3, rerank="asymmetric")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    absq = np.abs(np.asarray(j.binariser.project(q))).sum(axis=1, keepdims=True)
    assert (np.abs(td.numpy() - np.asarray(jd)) <= 2.0 ** -20 * absq).all()
    ji, jd = j.query(q, K, nprobe=3, rerank="exact", exact_fallback=False)
    ti, td = t.query(q, K, nprobe=3, rerank="exact", exact_fallback=False)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert_rerank_close(td, jd, q, x)


def test_ivf_fused_hamming_tier_against_jax_interpret(data, ivf, monkeypatch):
    """The fused tier (K1d-bf16's plain version here, the Pallas kernel in
    interpret mode there): recall within 0.01, distances on shared ids
    equal, every distance the popcount of the codes."""
    from annsearch_tpu_torch.ops import ivf_scan_fused as tsf

    _, q, ti_true = data
    j, t = ivf
    calls = []
    plain = tsf.ivf_cell_scan_bf16_fold
    monkeypatch.setattr(tsf, "ivf_cell_scan_bf16_fold",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    ji, jd = j.query(q, K, nprobe=3)
    ti, td = t.query(q, K, nprobe=3)
    assert calls, "the fused Hamming tier did not reach K1d-bf16"
    r_j = at.calculate_recall(ti_true, torch.tensor(np.asarray(ji)), K)
    r_t = at.calculate_recall(ti_true, ti, K)
    assert abs(r_j - r_t) <= 0.01
    shared = ti.numpy() == np.asarray(ji)
    assert shared.mean() >= 0.9
    np.testing.assert_array_equal(td.numpy()[shared], np.asarray(jd)[shared])
    inv = np.argsort(np.asarray(j.original_ids)[: j.n])
    q_codes = words(j.binariser.encode(q))
    codes = words(j.storage)[inv[ti.numpy()]]
    np.testing.assert_array_equal(td.numpy(), popcount_rows(q_codes, codes))


def test_ivf_large_rerank_pool_takes_the_cluster_scan(data, ivf, monkeypatch):
    """k 10 at ``rerank_factor`` 20 is a pool of 200 > 128: the cluster
    scan's Hamming mode, then the exact rerank, equal to the JAX
    package's."""
    from annsearch_tpu_torch.ops import ivf_scan_fused as tsf

    _, q, _ = data
    j, t = ivf
    assert not t._fused_hamming_ok(200)
    monkeypatch.setattr(tsf, "ivf_cell_scan_bf16_fold", None)   # would fail if called
    ji, jd = j.query(q, K, nprobe=3, rerank="exact", exact_fallback=False)
    ti, td = t.query(q, K, nprobe=3, rerank="exact", exact_fallback=False)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert_rerank_close(td, jd, q, data[0])


# -- stores, cosine, self-queries, the facade, npz files ------------------------


def test_native_store_gathers_as_the_memmap(tmp_path):
    rows = np.random.default_rng(7).standard_normal((50, 12)).astype(np.float32)
    s = MmapVectorStore.write(str(tmp_path / "v"), rows, device="cpu")
    assert s.route == "native"
    ids = np.array([[3, 49, 0], [7, 7, 1]])
    got = s.gather(ids)
    np.testing.assert_array_equal(got.numpy(), rows[ids])
    s.close()
    assert s.route == "memmap"
    np.testing.assert_array_equal(s.gather(ids).numpy(), rows[ids])


@pytest.mark.parametrize("kind", ["flat", "ivf"])
def test_device_and_mmap_stores_answer_alike(data, tmp_path, kind):
    x, q, _ = data
    if kind == "flat":
        dev_ix = ExhaustiveIndexBinary(x, n_bits=64, seed=1, device="cpu")
        mm_ix = ExhaustiveIndexBinary(x, n_bits=64, seed=1, store=str(tmp_path / "s"),
                                      device="cpu")
        kw = {}
    else:
        dev_ix = IvfIndexBinary(x, nlist=8, n_bits=64, seed=1, device="cpu")
        mm_ix = IvfIndexBinary(x, nlist=8, n_bits=64, seed=1, store=str(tmp_path / "s"),
                               device="cpu")
        kw = {"nprobe": 3}
    assert isinstance(dev_ix.store, DeviceVectorStore) and mm_ix.store.route == "native"
    a = dev_ix.query(q, K, rerank="exact", exact_fallback=False, **kw)
    b = mm_ix.query(q, K, rerank="exact", exact_fallback=False, **kw)
    assert torch.equal(a[0], b[0])
    torch.testing.assert_close(a[1], b[1], rtol=0, atol=0)


def test_cosine_matches_jax(data):
    x, q, _ = data
    jf = JFlat(x, "cosine", n_bits=96, seed=2)
    tf = interop.exhaustive_binary_from_jax_arrays(*jax_state(jf, False), device="cpu")
    for kw in ({}, {"rerank": "exact", "exact_fallback": False}):
        ji, jd = jf.query(q, K, **kw)
        ti, td = tf.query(q, K, **kw)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        assert_rerank_close(td, jd, np.ones((len(q), 1)), np.ones((1, 1)))
    jv = JIvf(x, "cosine", nlist=8, n_bits=96, seed=2, fast_scan=False)
    tv = interop.ivf_binary_from_jax_arrays(*jax_state(jv, True), device="cpu")
    ji, jd = jv.query(q, K, nprobe=3, rerank="exact", exact_fallback=False)
    ti, td = tv.query(q, K, nprobe=3, rerank="exact", exact_fallback=False)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert_rerank_close(td, jd, np.ones((len(q), 1)), np.ones((1, 1)))   # unit rows


def test_self_queries(flat, ivf):
    """Every row finds itself first (the exact rerank), and the codes-only
    flat self-query equals the JAX package's."""
    _, tf = flat
    ids, d = tf.generate_knn(5, rerank="exact", exact_fallback=False)
    assert (ids[:, 0] == torch.arange(tf.n)).float().mean() > 0.99
    assert (d[:, 0] < 1e-3).float().mean() > 0.99
    _, tv = ivf
    ids, d = tv.generate_knn(5, nprobe=3, rerank="exact", exact_fallback=False)
    assert (ids[:, 0] == torch.arange(tv.n)).float().mean() > 0.99
    jf = JFlat(np.asarray(flat[0].store.vectors), n_bits=128, seed=0, store=False)
    tcodes = interop.exhaustive_binary_from_jax_arrays(*jax_state(jf, False), device="cpu")
    ji, jd = jf.generate_knn(K)
    ti, td = tcodes.generate_knn(K)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("kind", ["exhaustive", "ivf"])
def test_facade_rows_match_jax(data, kind):
    """Each binary facade row once: build in both packages, carry the JAX
    state across (random streams differ), then the query and self rows."""
    x, q, _ = data
    if kind == "exhaustive":
        j = ja.build_exhaustive_index_binary(x, n_bits=64, seed=0)
        t = interop.exhaustive_binary_from_jax_arrays(*jax_state(j, False), device="cpu")
        built = at.build_exhaustive_index_binary(x, "euclidean", 64, device="cpu")
        args = ()
    else:
        j = ja.build_ivf_index_binary(x, nlist=8, n_bits=64, seed=0)
        t = interop.ivf_binary_from_jax_arrays(*jax_state(j, True), device="cpu")
        built = at.build_ivf_index_binary(x, "euclidean", 8, 64, device="cpu")
        args = (3,)
    assert isinstance(built, ExhaustiveIndexBinary if kind == "exhaustive" else IvfIndexBinary)
    qrow = getattr(at, f"query_{kind}_index_binary")
    srow = getattr(at, f"query_{kind}_index_binary_self")
    ji, jd = getattr(ja, f"query_{kind}_index_binary")(q, j, K, *args, return_dist=True)
    ti, td = qrow(q, t, K, *args, return_dist=True)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    ti, td = qrow(q, built, K, *args)
    assert td is None and ti.shape == (len(q), K)
    si, _ = srow(t, 3, *args, "exact")
    assert si.shape == (t.n, 3) and (si[:, 0] == torch.arange(t.n)).float().mean() > 0.99


@pytest.mark.parametrize("kind", ["flat", "ivf"])
def test_jax_npz_loads(data, tmp_path, kind):
    """A JAX-saved npz loads into the port: with the device store, and with
    an mmap store re-opened by its path."""
    x, q, _ = data
    for store in (True, str(tmp_path / f"{kind}_store")):
        if kind == "flat":
            j = JFlat(x, n_bits=64, seed=0, store=store)
            cls, kw = ExhaustiveIndexBinary, {}
        else:
            j = JIvf(x, nlist=8, n_bits=64, seed=0, store=store)
            cls, kw = IvfIndexBinary, {"nprobe": 3}
        path = str(tmp_path / f"{kind}.npz")
        j.save(path)
        t = cls.load(path, device="cpu")
        assert isinstance(t.store, DeviceVectorStore if store is True else MmapVectorStore)
        for rerank in (None, "exact"):
            ji, jd = j.query(q, K, rerank=rerank, exact_fallback=False, **kw)
            ti, td = t.query(q, K, rerank=rerank, exact_fallback=False, **kw)
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
            assert_rerank_close(td, jd, q, x)
        t.save(str(tmp_path / "again.npz"))
        again = cls.load(str(tmp_path / "again.npz"), device="cpu")
        assert torch.equal(again.query(q, K, **kw)[0], t.query(q, K, **kw)[0])
