"""Parity of the port's fused IVF cell scan (K1a: int8 residual cells, l2,
depth-2 fold, one bf16 query term) with the JAX package's Pallas scan,
which runs here in interpret mode.

Both sides get the same task inputs: the cell scan alone against
``_fused_cell_scan``, and the host side end to end against
``fused_ivf_scan``. Distances agree within rtol 1e-5 / atol 1e-4 (the f32
dot sums run in different orders); ids on ≥ 99% of entries (orders can
swap near-ties). The data is scaled by 1/8 so that the residual norms
stay small: ``qadd + sn − 2·dots`` cancels near a match, and its f32
rounding grows with the norms."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from annsearch_tpu.models.ivf_base import route_to_cells as j_route
from annsearch_tpu.models.quantised.ivf import IvfPqIndex as JIvfPq
from annsearch_tpu.ops import ivf_scan_pallas as jsp
from annsearch_tpu.ops.probe_device import build_probe_lists_device as j_build
from annsearch_tpu.ops.probe_device import device_probe_shapes
from annsearch_tpu.utils.dist import Dist as JDist
from annsearch_tpu_torch.ops import ivf_scan_fused as tsf
from annsearch_tpu_torch.utils.data import generate_clustered_data, subsample_with_noise
from annsearch_tpu_torch.utils.dist import Dist

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-4
K, KB = 10, 16


def _t(a, dtype=None):
    return torch.tensor(np.asarray(a), dtype=dtype)


@pytest.fixture(scope="module")
def jindex():
    """JAX IVF-PQ (m = d: int8 residual cells) whose cells are split into
    128-row segments, several of them partial."""
    x, _ = generate_clustered_data(1200, 128, 6, seed=3)
    x = x * np.float32(0.125)
    q = subsample_with_noise(x, 25, seed=4)
    j = JIvfPq(x, "euclidean", nlist=4, m=128, seg_size=128)
    assert j.mode == "i8dec_residual"
    counts = np.asarray(j.seg_counts)
    assert len(counts) > 4 and (counts < 128).any()   # split and partial
    return j, q


@pytest.fixture(scope="module")
def tasks(jindex):
    """Task lists from the JAX router and inversion (nprobe 2 → segments)."""
    j, q = jindex
    nseg = int(j.seg_offsets.shape[0])
    nprobe_seg = min(nseg, max(2, -(-2 * nseg) // j.nlist))
    maxq, R = device_probe_shapes(len(q), nprobe_seg, nseg, 1)
    probes = j_route(jnp.asarray(q), j.seg_centroids, nprobe_seg, JDist.EUCLIDEAN)
    cids, lists, gmap = j_build(probes.astype(jnp.int32), nseg, maxq, R)
    return cids, lists, gmap


def _jax_cell_scan(lists, task_seg, cnt, queries_x, cent_x, scales, cells, sn, kb):
    """The JAX scan on port-style task inputs: the prologue as
    ``fused_ivf_scan`` computes it for i8dec_residual/l2 without q_split,
    then ``_fused_cell_scan`` in interpret mode."""
    qg = jnp.asarray(queries_x)[jnp.asarray(lists)]
    qr = qg - jnp.asarray(cent_x)[jnp.asarray(task_seg)][:, None, :]
    qadd = jnp.sum(qr * qr, axis=-1)
    qk = (qr * jnp.asarray(scales)[None, None, :]).astype(jnp.bfloat16)
    R, maxq = lists.shape
    seg = cells.shape[1]
    cd, ci = jsp._fused_cell_scan(
        (qk,), jnp.broadcast_to(qadd[:, None, :], (R, 8, maxq)),
        jnp.asarray(task_seg), jnp.asarray(cnt), (jnp.asarray(cells),),
        jnp.broadcast_to(jnp.asarray(sn)[:, None, :], (sn.shape[0], 8, seg)),
        kb, "l2", True, fold_depth=2, selection="fold",
    )
    return np.asarray(cd), np.asarray(ci)


def _assert_scan_parity(got_d, got_i, want_d, want_i, min_ids=0.99):
    np.testing.assert_allclose(got_d, want_d, rtol=RTOL, atol=ATOL)
    assert (np.asarray(got_i) == np.asarray(want_i)).mean() >= min_ids


def test_repack_blocks_matches_jax(jindex):
    j, _ = jindex
    cells, sn = tsf.repack_blocks(
        _t(j.storage), _t(j.store_sqnorms), _t(j.seg_offsets), j.seg_size
    )
    jcells, jsn = jsp.repack_blocks(j.storage, j.store_sqnorms, j.seg_offsets, j.seg_size)
    assert cells.dtype == torch.int8
    np.testing.assert_array_equal(cells.numpy(), np.asarray(jcells[0]))
    np.testing.assert_array_equal(sn.numpy(), np.asarray(jsn)[:, 0, :])


def test_repack_blocks_pads_columns_to_16():
    storage = torch.randint(-127, 128, (300, 40), dtype=torch.int8)
    cells, sn = tsf.repack_blocks(storage, torch.rand(300), torch.tensor([0, 128]), 128)
    assert cells.shape == (3, 128, 48)
    assert (cells[:, :, 40:] == 0).all() and (cells[-1] == 0).all() and (sn[-1] == 0).all()
    assert torch.equal(cells[1, :, :40], storage[128:256])


def test_cell_scan_matches_jax_on_index_tasks(jindex, tasks):
    j, q = jindex
    cids, lists, _ = tasks
    nseg = int(j.seg_offsets.shape[0])
    cnt_x = np.concatenate([np.asarray(j.seg_counts), [0]]).astype(np.int32)
    task_seg = np.minimum(np.asarray(cids), nseg)
    cnt = cnt_x[task_seg]
    assert (cnt == 0).any() and ((cnt > 0) & (cnt < 128)).any()
    queries_x = np.concatenate([q, np.zeros((1, 128), np.float32)])
    cent_x = np.concatenate([np.asarray(j.seg_centroids), np.zeros((1, 128), np.float32)])
    cells, sn = tsf.repack_blocks(
        _t(j.storage), _t(j.store_sqnorms), _t(j.seg_offsets), j.seg_size
    )
    args = (np.asarray(lists), task_seg, cnt, queries_x, cent_x,
            np.asarray(j.dec_scales), cells.numpy(), sn.numpy())
    gd, gi = tsf.ivf_cell_scan_plain(*(_t(a) for a in args), KB)
    wd, wi = _jax_cell_scan(*args, KB)
    assert gd.shape == (len(task_seg), lists.shape[1], KB) and gi.dtype == torch.int32
    _assert_scan_parity(gd.numpy(), gi.numpy(), wd, wi)


def _random_tasks(seed, R=24, maxq=32, seg=256, d=128, nseg=6, nq=50):
    """Task inputs with sentinel rows (cnt 0), partial rows (cnt below and
    above kb) and pad query slots."""
    rng = np.random.default_rng(seed)
    cells = rng.integers(-127, 128, (nseg + 1, seg, d)).astype(np.int8)
    cells[-1] = 0
    scales = (rng.random(d) * 0.02 + 0.005).astype(np.float32)
    sn = ((cells.astype(np.float32) * scales) ** 2).sum(-1).astype(np.float32)
    queries_x = (rng.standard_normal((nq + 1, d)) * 0.5).astype(np.float32)
    queries_x[-1] = 0
    cent_x = (rng.standard_normal((nseg + 1, d)) * 0.2).astype(np.float32)
    cent_x[-1] = 0
    task_seg = rng.integers(0, nseg, R).astype(np.int32)
    cnt = np.full(R, seg, np.int32)
    cnt[1::5] = rng.integers(1, seg, len(cnt[1::5]))
    cnt[2 % R] = 5                   # fewer valid lanes than kb
    cnt[3::7] = 0
    task_seg[3::7] = nseg
    lists = rng.integers(0, nq + 1, (R, maxq)).astype(np.int32)
    return lists, task_seg, cnt, queries_x, cent_x, scales, cells, sn


@pytest.mark.parametrize("seed,kb", [(0, 16), (1, 8), (2, 128)])
def test_cell_scan_matches_jax_on_sentinel_and_partial_rows(seed, kb):
    args = _random_tasks(seed)
    gd, gi = tsf.ivf_cell_scan_plain(*(torch.as_tensor(a) for a in args), kb)
    wd, wi = _jax_cell_scan(*args, kb)
    _assert_scan_parity(gd.numpy(), gi.numpy(), wd, wi)
    cnt = args[2]
    # sentinel rows emit (3e38, 0) only; the short row's tail is 3e38
    assert (gd.numpy()[cnt == 0] == np.float32(3e38)).all()
    assert (gi.numpy()[cnt == 0] == 0).all()
    assert (gd.numpy()[2, :, 5:] == np.float32(3e38)).all()


def test_ivf_cell_scan_on_cpu_is_the_plain_version():
    args = tuple(torch.as_tensor(a) for a in _random_tasks(3, R=6))
    before = tsf.ivf_cell_scan.launches
    gd, gi = tsf.ivf_cell_scan(*args, 16)
    pd, pi = tsf.ivf_cell_scan_plain(*args, 16)
    assert torch.equal(gd, pd) and torch.equal(gi, pi)
    assert tsf.ivf_cell_scan.launches == before    # no kernel launched


def test_fused_ivf_scan_matches_jax(jindex, tasks):
    j, q = jindex
    cids, lists, gmap = tasks
    jcells, jsn = jsp.repack_blocks(j.storage, j.store_sqnorms, j.seg_offsets, j.seg_size)
    wd, wi = jsp.fused_ivf_scan(
        jnp.asarray(q), cids, lists, gmap, jcells, jsn, j.seg_offsets, j.seg_counts,
        j.seg_centroids, K, JDist.EUCLIDEAN, "i8dec_residual", j.dec_scales, KB,
        interpret=True, q_split=False,
    )
    cells, sn = tsf.repack_blocks(
        _t(j.storage), _t(j.store_sqnorms), _t(j.seg_offsets), j.seg_size
    )
    gd, gi = tsf.fused_ivf_scan(
        torch.as_tensor(q), _t(cids), _t(lists), _t(gmap), cells, sn,
        _t(j.seg_offsets), _t(j.seg_counts), _t(j.seg_centroids), K,
        Dist.EUCLIDEAN, "i8dec_residual", _t(j.dec_scales), KB,
    )
    assert gd.shape == (len(q), K) and torch.all(gd[:, 1:] >= gd[:, :-1])
    _assert_scan_parity(gd.numpy(), gi.numpy(), np.asarray(wd), np.asarray(wi))


def test_fused_ivf_scan_pads_when_fewer_candidates_than_k():
    """A gather width below k pads with (+inf, 0), as in the JAX package."""
    lists, task_seg, cnt, queries_x, cent_x, scales, cells, sn = _random_tasks(
        4, R=2, maxq=32, nseg=2, nq=3
    )
    q = queries_x[:3]
    cids = np.array([0, 2], np.int32)
    lists = np.full((2, 32), 3, np.int32)
    lists[0, :3] = [0, 1, 2]
    gmap = np.array([[0], [1], [2]])
    kw = dict(k=20, mode="i8dec_residual", kb=16)
    offs, counts = np.array([0, 256], np.int32), np.array([256, 100], np.int32)
    gd, gi = tsf.fused_ivf_scan(
        torch.as_tensor(q), torch.as_tensor(cids), torch.as_tensor(lists),
        torch.as_tensor(gmap), torch.as_tensor(cells[[0, 1, 2]]),
        torch.as_tensor(sn[[0, 1, 2]]), torch.as_tensor(offs), torch.as_tensor(counts),
        torch.as_tensor(cent_x[:2]), metric=Dist.EUCLIDEAN,
        scales=torch.as_tensor(scales), **kw,
    )
    wd, wi = jsp.fused_ivf_scan(
        jnp.asarray(q), jnp.asarray(cids), jnp.asarray(lists), jnp.asarray(gmap),
        (jnp.asarray(cells[[0, 1, 2]]),),
        jnp.broadcast_to(jnp.asarray(sn[[0, 1, 2]])[:, None, :], (3, 8, 256)),
        jnp.asarray(offs), jnp.asarray(counts), jnp.asarray(cent_x[:2]),
        metric=JDist.EUCLIDEAN, scales=jnp.asarray(scales), interpret=True,
        q_split=False, **kw,
    )
    assert gd.shape == (3, 20) and torch.isinf(gd[:, 16:]).all()
    assert (gi[:, 16:] == 0).all()
    _assert_scan_parity(gd.numpy(), gi.numpy(), np.asarray(wd), np.asarray(wi), 1.0)


def test_fused_eligible():
    assert tsf.fused_eligible("i8dec_residual", 1024, 128, 10)
    assert tsf.fused_eligible("i8dec_residual", 128, 384, 128)
    assert not tsf.fused_eligible("i8dec_residual", 1000, 128, 10)   # seg % 128
    assert not tsf.fused_eligible("i8dec_residual", 1024, 128, 129)  # k > 128
    assert not tsf.fused_eligible("i8dec_residual", 1024, 400, 10)   # wide rows
    for mode in ("f32", "bf16", "sq8", "i8dec", "pq_residual"):
        assert not tsf.fused_eligible(mode, 1024, 128, 10)


def test_fused_ivf_scan_unported_variants_raise():
    z = torch.zeros(1)
    for mode, metric in (("sq8", Dist.EUCLIDEAN), ("i8dec_residual", Dist.COSINE)):
        with pytest.raises(NotImplementedError, match="K1"):
            tsf.fused_ivf_scan(torch.zeros((1, 8)), z, z, z, z, z, z, z, z, 1,
                               metric, mode, z, 8)
