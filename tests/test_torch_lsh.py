"""Parity of the port's LSH index with the JAX package's.

Both packages draw the hyperplanes on the host from numpy's
``default_rng(seed)`` with a QR, so the projections are identical. A hash
bit is the sign of an f32 dot, which the two packages sum in different
orders: bucket assignments agree on ≥ 0.999 of rows (rows within rounding
of a plane may fall on either side), and are identical where every
projection sits away from 0. Query parity runs on the JAX index's tables
carried across (``interop.lsh_from_jax_arrays``, ``load`` of its npz): the
cluster-scan route (16 bits: 64-row segments) and the fused route (5 bits:
128-row segments; the JAX side in interpret mode), compared by recall
against one exact truth and by distances on shared ids. The empty-bucket
fallback draws its random rows from another stream than the JAX package's,
so it is checked by its rate and by the exactness of its rerank over its
own candidates. The data is scaled by 1/8 (see ``test_torch_trees``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import annsearch_tpu_torch as ta
from annsearch_tpu.models.lsh import LSHIndex as JLsh
from annsearch_tpu.models.lsh import _probe_cells as j_probe_cells
from annsearch_tpu.models.lsh import _probe_patterns as j_patterns
from annsearch_tpu_torch import interop
from annsearch_tpu_torch.models import lsh as tlsh
from annsearch_tpu_torch.ops import ivf_scan_fused as tsf
from annsearch_tpu_torch.utils.data import generate_clustered_data, subsample_with_noise
from annsearch_tpu_torch.utils.dist import Dist

torch.set_num_threads(2)
K = 10


@pytest.fixture(scope="module")
def ldata():
    x, _ = generate_clustered_data(3000, 32, 8, seed=0)
    x = x * np.float32(0.125)
    q = subsample_with_noise(x, 150, seed=0)
    ti, td = ta.build_exhaustive_index(x, device="cpu").query(q, K)
    return x, q, ti.numpy(), td.numpy()


def _carry(j):
    meta = {"n": j.n, "dim": j.dim, "num_tables": j.num_tables, "bits": j.bits,
            "seed": j._seed, "seg_size": j.seg_size,
            "metric": "cosine" if j.metric.value == "cosine" else "euclidean"}
    arrays = {"vectors": np.asarray(j.vectors), "projections": np.asarray(j.projections),
              "storage": np.asarray(j.storage), "original_ids": np.asarray(j.original_ids),
              "seg_offsets": np.asarray(j.seg_offsets), "seg_counts": np.asarray(j.seg_counts),
              "cluster_ptr": np.asarray(j._layout.cluster_ptr),
              "seg_cluster": np.asarray(j._layout.seg_cluster)}
    return interop.lsh_from_jax_arrays(arrays, meta, device="cpu")


def _shared_dists_agree(ids_a, d_a, ids_b, d_b):
    ids_a, d_a, ids_b, d_b = (np.asarray(a) for a in (ids_a, d_a, ids_b, d_b))
    shared = 0
    for r in range(ids_a.shape[0]):
        pos_b = {int(i): j for j, i in enumerate(ids_b[r])}
        for j, i in enumerate(ids_a[r]):
            if int(i) in pos_b and np.isfinite(d_a[r, j]):
                shared += 1
                db = d_b[r, pos_b[int(i)]]
                assert abs(d_a[r, j] - db) <= 1e-4 * (1 + abs(db))
    return shared / ids_a.size


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_projections_and_buckets_match_jax(ldata, metric):
    x = ldata[0]
    j = JLsh(x, metric, num_tables=4, bits_per_hash=12, seed=3)
    t = ta.build_lsh_index(x, metric, num_tables=4, bits_per_hash=12, seed=3, device="cpu")
    np.testing.assert_array_equal(t.projections.numpy(), np.asarray(j.projections))
    assert t.seg_size == j.seg_size and t.seg_offsets.shape[0] == j.seg_offsets.shape[0]
    # each row's bucket in each table: the storage holds row r in table t
    # within that bucket's segments
    def buckets(orig_ids, ptr, seg_counts, n):
        cells = np.repeat(np.arange(len(ptr) - 1), np.diff(ptr))     # segment → cell
        seg = np.repeat(np.arange(len(seg_counts)), seg_counts)
        return np.sort(cells[seg] * n + np.asarray(orig_ids)[: len(seg)])
    jb = buckets(np.asarray(j.original_ids), np.asarray(j._layout.cluster_ptr),
                 np.asarray(j.seg_counts), j.n)
    tb = buckets(t.original_ids.numpy(), t._cluster_ptr, t.seg_counts.numpy(), t.n)
    assert np.isin(tb, jb).mean() >= 0.999


def test_buckets_identical_away_from_the_planes():
    """Grid rows whose every projection lies clear of 0 hash alike bit for
    bit in both packages."""
    rng = np.random.default_rng(5)
    x = (rng.integers(-15, 16, (800, 16)) / np.float32(8)).astype(np.float32)
    j = JLsh(x, num_tables=3, bits_per_hash=8, seed=1)
    t = ta.build_lsh_index(x, num_tables=3, bits_per_hash=8, seed=1, device="cpu")
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    clear = np.all(np.abs(np.einsum("nd,tdb->ntb", xn.astype(np.float64),
                                    np.asarray(j.projections, np.float64))) > 1e-5, axis=(1, 2))
    assert clear.mean() > 0.99
    for tt in range(3):
        _, th = tlsh._hashes(torch.as_tensor(xn), t.projections, tt)
        jh = np.asarray((jnp.asarray(xn) @ j.projections[tt] > 0).astype(jnp.int32)
                        @ (2 ** jnp.arange(8)))
        np.testing.assert_array_equal(th.numpy()[clear], jh[clear])


@pytest.mark.parametrize("uniform", [False, True])
def test_probe_cells_match_jax(ldata, uniform):
    x, q, _, _ = ldata
    rng = np.random.default_rng(2)
    proj = np.linalg.qr(rng.standard_normal((32, 32)))[0][:, :10].astype(np.float32)[None]
    proj = np.concatenate([proj, proj[:, ::-1]])
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    got = tlsh._probe_cells(torch.as_tensor(qn), torch.as_tensor(proj.copy()), 10, 12, uniform)
    want = np.asarray(j_probe_cells(jnp.asarray(qn), jnp.asarray(proj), 10, 12, uniform))
    assert (got.numpy() == want).mean() >= 0.999
    assert tlsh._probe_patterns(10, 12) == j_patterns(10, 12)


@pytest.mark.parametrize("bits,route", [(16, "cluster"), (5, "fused")])
def test_both_routes_match_jax_on_carried_tables(ldata, bits, route):
    x, q, ti, _ = ldata
    j = JLsh(x, num_tables=8, bits_per_hash=bits, seed=0)
    t = _carry(j)
    assert (t.seg_size % 128 == 0) == (route == "fused")
    before = tsf.ivf_cell_scan_f32_fold.launches
    ids, d = t.query(q, K, exact_fallback=False)
    jids, jd = j.query(q, K, exact_fallback=False)
    assert tsf.ivf_cell_scan_f32_fold.launches == before
    assert ids.shape == (150, K) and bool((d.diff(dim=1) >= 0).all())
    assert all(len(set(r.tolist())) == K for r in ids)          # the cross-table dedup
    assert abs(ta.calculate_recall(ti, ids, K) - ta.calculate_recall(ti, np.asarray(jids), K)) \
        <= 0.01
    assert _shared_dists_agree(ids, d, jids, jd) >= 0.95
    assert t.last_fallback_rate == j.last_fallback_rate == 0.0


def test_self_query_and_save_load(ldata, tmp_path):
    x, q, _, _ = ldata
    j = JLsh(x[:1000], num_tables=4, bits_per_hash=6, seed=0)
    j.save(str(tmp_path / "lsh"))
    t = tlsh.LSHIndex.load(str(tmp_path / "lsh.npz"), device="cpu")
    ids, d = ta.query_lsh_self(t, 5, return_dist=True)
    jids, _ = j.generate_knn(5)
    assert (ids[:, 0] == torch.arange(1000)).float().mean() >= 0.99
    assert ta.calculate_recall(np.asarray(jids), ids, 5) >= 0.98
    t.save(str(tmp_path / "lsh_port"))
    back = JLsh.load(str(tmp_path / "lsh_port.npz"))
    np.testing.assert_array_equal(np.asarray(back.storage), np.asarray(j.storage))
    assert t.memory_usage_bytes() > 0


def test_empty_bucket_fallback(ldata):
    """Queries far from every row find only empty buckets: the rate counts
    the queries whose probed buckets (the JAX package's probes on the same
    tables) are all empty, and their answer is the exact top-k over the
    fallback's own random rows."""
    x, q, _, _ = ldata
    j = JLsh(x, num_tables=2, bits_per_hash=20, seed=0)
    t = _carry(j)
    rng = np.random.default_rng(9)
    far = (rng.standard_normal((40, 32)) * 5.0).astype(np.float32)
    ids, d = t.query(far, K, n_probes=1, exact_fallback=False)
    fn = far / np.linalg.norm(far, axis=1, keepdims=True)
    cells = np.asarray(j_probe_cells(jnp.asarray(fn), j.projections, 20, 1))
    sizes = np.diff(np.asarray(j._layout.cluster_ptr))        # segments per bucket
    empty = (sizes[cells] == 0).all(axis=1)
    assert empty.mean() > 0.5
    assert abs(t.last_fallback_rate - empty.mean()) <= 0.05
    miss_rows = torch.nonzero(torch.as_tensor(_missed(t, far)))[:, 0]
    assert len(miss_rows) == round(t.last_fallback_rate * len(far))
    gen = torch.Generator().manual_seed(t._seed + 1)
    rnd = torch.randint(0, t.n, (len(miss_rows), 1000), generator=gen)
    qf = torch.as_tensor(far)[miss_rows]
    full = ((qf[:, None, :] - t.vectors[rnd]) ** 2).sum(-1)
    want = torch.gather(rnd, 1, torch.sort(full, dim=1, stable=True).indices)
    for r, row in enumerate(miss_rows.tolist()):
        uniq = list(dict.fromkeys(want[r].tolist()))[:K]
        assert ids[row].tolist() == uniq
        np.testing.assert_allclose(d[row].numpy(), ((qf[r] - t.vectors[uniq]) ** 2).sum(-1),
                                   rtol=1e-4, atol=1e-4)


def _missed(t, qm):
    """Which queries find no row through their probes (before the
    fallback), from the index's own probe route."""
    q = t._prep_queries(qm)
    probes = tlsh._probe_cells(q / q.norm(dim=1, keepdim=True), t.projections, t.bits, 1)
    d, _ = t._cluster_route(q, probes, K, K * t.num_tables)
    return (~torch.isfinite(d[:, 0])).numpy()


def test_lsh_exact_fallback_and_f64(ldata, monkeypatch):
    x, q, ti, td = ldata
    monkeypatch.delenv("ANNSEARCH_NO_EXACT_FALLBACK", raising=False)
    x64, q64 = x.astype(np.float64), q.astype(np.float64)
    t = ta.build_lsh_index(x64, device="cpu")
    ids, d = t.query(q64, K)
    assert d.dtype == torch.float64
    d64 = ((q64[:, None, :] - x64[None]) ** 2).sum(-1)
    np.testing.assert_allclose(d.numpy(), np.sort(d64, axis=1)[:, :K], rtol=1e-12, atol=1e-12)
    assert ta.calculate_recall(np.argsort(d64, axis=1)[:, :K], ids, K) >= 0.999
    c = ta.build_lsh_index(x, "cosine", bits_per_hash=10, device="cpu")
    ci, _ = ta.build_exhaustive_index(x, "cosine", device="cpu").query(q, K)
    monkeypatch.setenv("ANNSEARCH_NO_EXACT_FALLBACK", "1")
    ids, d = ta.query_lsh_index(q, c, K, 8, True)
    assert c.metric == Dist.COSINE and ta.calculate_recall(ci, ids, K) >= 0.9


def test_pair_blocks_and_compact_lists_keep_the_answer(ldata, monkeypatch):
    """Blocks of the batch by the pair budget, and the fused route's compact
    lists over split buckets, give the unblocked answer."""
    x, q, _, _ = ldata
    q = q[:40]
    t = ta.build_lsh_index(x, bits_per_hash=4, device="cpu")
    assert t.seg_size % 128 == 0 and t._s_max() > 1            # the compact lists
    ids, d = t.query(q, K, exact_fallback=False)
    monkeypatch.setattr(tlsh, "_PAIR_BUDGET", 200)
    qn = t._prep_queries(q)
    blocks = t._pair_blocks(tlsh._probe_cells(qn / qn.norm(dim=1, keepdim=True),
                                               t.projections, t.bits, 4))
    assert len(blocks) > 3 and blocks[0][0] == 0 and blocks[-1][1] == 40
    bi, bd = t.query(q, K, exact_fallback=False)
    assert torch.equal(ids, bi) and torch.equal(d, bd)
    j = JLsh(x, num_tables=8, bits_per_hash=4, seed=42)
    np.testing.assert_array_equal(t.storage.numpy(), np.asarray(j.storage))
    jids, jd = j.query(q, K, exact_fallback=False)
    assert _shared_dists_agree(ids, d, jids, jd) >= 0.95
