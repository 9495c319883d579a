"""Parity of the port's fused IVF cell scan with the JAX package's Pallas
scan, which runs here in interpret mode: K1a (int8 residual cells, l2,
depth-2 fold, one bf16 query term), K1c-f32 (f32 cells, exact selection)
and K1d-f32 (f32 cells, fold); K1c/K1d-bf16 and K1c/K1d-sq8 (tolerances
in their own section below).

K1c-f32 and K1d-f32 are held to the Pallas kernel bit for bit: their
cells and queries are multiples of 1/8 in [−15/8, 15/8], so each value is
exact in bf16 (the JAX side's hi/lo mantissa split has a zero lo term),
and every product and every sum of up to 128 of them is exact in f32.

Both sides get the same task inputs: the cell scan alone against
``_fused_cell_scan``, and the host side end to end against
``fused_ivf_scan``. Distances agree within rtol 1e-5 / atol 1e-4 (the f32
dot sums run in different orders); ids on ≥ 99% of entries (orders can
swap near-ties). The data is scaled by 1/8 so that the residual norms
stay small: ``qadd + sn − 2·dots`` cancels near a match, and its f32
rounding grows with the norms."""

import jax
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
from annsearch_tpu.utils.dist import mantissa_split
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
    """The JAX package's rule on a grid of (mode, seg, d, k): rows of any
    width are eligible (the kernel stages wide query rows in column
    blocks)."""
    for mode in ("i8dec", "i8dec_residual", "f32", "bf16", "sq8", "pq", "pq_residual",
                 "hamming"):
        for seg in (64, 128, 256, 1000, 1024):
            for d in (8, 40, 128, 4096, 4100, 8192):
                for k in (1, 10, 128, 129):
                    assert tsf.fused_eligible(mode, seg, d, k) == jsp.fused_eligible(
                        mode, seg, d, k), (mode, seg, d, k)
    assert tsf.fused_eligible("f32", 1024, 4100, 10)      # wide rows


def test_fused_ivf_scan_unported_variants_raise():
    """Every (mode, selection) of the JAX scan's dense modes answers; the
    PQ-coded modes belong to the cluster scan and an unknown selection is
    refused, each with a ValueError."""
    z = torch.zeros(1)
    for mode, sel in (("pq_residual", "fold"), ("pq", "exact"), ("f32", "approx")):
        with pytest.raises(ValueError, match="cluster scan"):
            tsf.fused_ivf_scan(torch.zeros((1, 8)), z, z, z, z, z, z, z, z, 1,
                               Dist.EUCLIDEAN, mode, z, 8, selection=sel)


# -- K1c-f32 and K1d-f32 ------------------------------------------------------


def _grid_tasks(seed, d, R=24, maxq=32, seg=256, nseg=6, nq=50):
    """f32 task inputs on the 1/8 grid, with sentinel rows (cnt 0), rows
    shorter than kb and partial rows; ``cells`` padded to 16 columns."""
    rng = np.random.default_rng(seed)
    dp = -(-d // 16) * 16
    cells = np.zeros((nseg + 1, seg, dp), np.float32)
    cells[:-1, :, :d] = rng.integers(-15, 16, (nseg, seg, d)) / np.float32(8)
    sn = (cells * cells).sum(-1).astype(np.float32)
    queries_x = (rng.integers(-15, 16, (nq + 1, d)) / np.float32(8)).astype(np.float32)
    queries_x[-1] = 0
    task_seg = rng.integers(0, nseg, R).astype(np.int32)
    cnt = np.full(R, seg, np.int32)
    cnt[1::5] = rng.integers(1, seg, len(cnt[1::5]))
    cnt[2] = 5                       # fewer valid lanes than kb
    cnt[3::7] = 0
    task_seg[3::7] = nseg
    lists = rng.integers(0, nq + 1, (R, maxq)).astype(np.int32)
    return lists, task_seg, cnt, queries_x, cells, sn


def _jax_f32_cell_scan(lists, task_seg, cnt, queries_x, cells, sn, kb, cosine, selection,
                       fold_depth=2):
    """The JAX scan on port-style task inputs, as ``fused_ivf_scan`` runs it
    for f32 cells (layout "plain"): hi/lo mantissa terms of queries and
    cells, qadd = ‖q‖² (l2) or 0 (cos_plain), ``_fused_cell_scan`` in
    interpret mode."""
    R, maxq = lists.shape
    seg, dp = cells.shape[1:]
    qg = jnp.asarray(queries_x)[jnp.asarray(lists)]
    qadd = jnp.zeros((R, maxq), jnp.float32) if cosine else jnp.sum(qg * qg, axis=-1)
    qg = jnp.pad(qg, ((0, 0), (0, 0), (0, dp - qg.shape[-1])))
    cd, ci = jsp._fused_cell_scan(
        mantissa_split(qg, 2), jnp.broadcast_to(qadd[:, None, :], (R, 8, maxq)),
        jnp.asarray(task_seg), jnp.asarray(cnt), mantissa_split(jnp.asarray(cells), 2),
        jnp.broadcast_to(jnp.asarray(sn)[:, None, :], (sn.shape[0], 8, seg)),
        kb, "cos_plain" if cosine else "l2", True, fold_depth=fold_depth,
        selection=selection,
    )
    return np.asarray(cd), np.asarray(ci)


@pytest.mark.parametrize(
    "seed,d,kb,selection,cosine",
    [
        (0, 64, 24, "exact", False),     # the exact tier's kb at k = 15
        (1, 128, 24, "exact", True),
        (2, 40, 8, "exact", False),      # columns padded to 48
        (3, 64, 128, "exact", True),     # kb = 128: every lane of a chunk
        (4, 128, 16, "fold", False),
        (5, 64, 16, "fold", True),
        (6, 40, 8, "fold", False),
    ],
)
def test_f32_cell_scan_matches_jax_bit_for_bit(seed, d, kb, selection, cosine):
    args = _grid_tasks(seed, d)
    gd, gi = tsf.ivf_cell_scan_f32_plain(
        *(torch.as_tensor(a) for a in args), kb, cosine, exact=selection == "exact"
    )
    wd, wi = _jax_f32_cell_scan(*args, kb, cosine, selection)
    assert gd.shape == (24, 32, kb) and gi.dtype == torch.int32
    np.testing.assert_array_equal(gd.numpy(), wd)
    np.testing.assert_array_equal(gi.numpy(), wi)
    cnt = args[2]
    assert (gd.numpy()[cnt == 0] == np.float32(3e38)).all()
    assert (gi.numpy()[cnt == 0] == 0).all()
    if selection == "exact":
        # past the valid rows: (3e38, lane 0), the Pallas extraction's rule
        assert (gd.numpy()[2, :, 5:] == np.float32(3e38)).all()
        assert (gi.numpy()[2, :, 5:] == 0).all()


@pytest.mark.parametrize("selection", ["exact", "fold"])
@pytest.mark.parametrize("cosine", [False, True], ids=["l2", "cos_plain"])
def test_f32_cell_scan_matches_jax_on_gaussian_rows(selection, cosine):
    """Off the grid: the port scores f32 cells at f32 grade (the kernel's
    six cross terms of a three-way split; the plain version's fp32
    product), the JAX kernel splits them in two (hi·hi + hi·lo + lo·hi, and
    lo·lo in the exact tier: about 16 mantissa bits). Each operand's two
    terms lie within 2⁻¹⁷ of it, so the dots differ by at most about
    2⁻¹⁶·‖q‖‖x‖ and each returned distance (ascending) within
    2⁻¹⁴·(‖q‖² + max sn); near-ties may swap lanes."""
    rng = np.random.default_rng(9)
    lists, task_seg, cnt, queries_x, cells, sn = _grid_tasks(9, 64)
    cells[:-1, :, :64] = rng.standard_normal(cells[:-1, :, :64].shape)
    queries_x[:-1] = rng.standard_normal(queries_x[:-1].shape)
    if cosine:
        cells /= np.maximum(np.linalg.norm(cells, axis=-1, keepdims=True), 1e-30)
        queries_x /= np.maximum(np.linalg.norm(queries_x, axis=-1, keepdims=True), 1e-30)
    sn = (cells * cells).sum(-1).astype(np.float32)
    args = (lists, task_seg, cnt, queries_x, cells, sn)
    gd, gi = tsf.ivf_cell_scan_f32_plain(*(torch.as_tensor(a) for a in args), 16, cosine,
                                         exact=selection == "exact")
    wd, wi = _jax_f32_cell_scan(*args, 16, cosine, selection)
    scale = (queries_x * queries_x).sum(1)[lists] + sn.max()
    assert (np.abs(gd.numpy() - wd) <= 2.0 ** -14 * scale[..., None]).all()
    assert (gi.numpy() == wi).mean() >= 0.98
    np.testing.assert_array_equal(gd.numpy() == np.float32(3e38), wd == np.float32(3e38))


def test_f32_exact_selection_takes_the_lowest_lane_on_ties():
    """Equal distances order by lane; a row's tail past cnt is (3e38, 0)."""
    lists, task_seg, cnt, queries_x, cells, sn = _grid_tasks(7, 16, R=3, seg=128)
    cells[0] = cells[0, :1]          # every row of segment 0 alike
    sn = (cells * cells).sum(-1).astype(np.float32)
    task_seg[:] = [0, 0, 6]
    cnt[:] = [128, 10, 0]
    args = (lists, task_seg, cnt, queries_x, cells, sn)
    gd, gi = tsf.ivf_cell_scan_f32_plain(*(torch.as_tensor(a) for a in args), 16,
                                         False, exact=True)
    wd, wi = _jax_f32_cell_scan(*args, 16, False, "exact")
    np.testing.assert_array_equal(gi.numpy(), wi)
    np.testing.assert_array_equal(gd.numpy(), wd)
    assert (gi.numpy()[0] == np.arange(16)).all()
    assert (gi.numpy()[1, :, :10] == np.arange(10)).all()
    assert (gi.numpy()[1, :, 10:] == 0).all()


@pytest.mark.parametrize("exact", [True, False])
def test_f32_wrappers_on_cpu_are_the_plain_version(exact):
    args = tuple(torch.as_tensor(a) for a in _grid_tasks(8, 64, R=6))
    wrapper = tsf.ivf_cell_scan_f32_exact if exact else tsf.ivf_cell_scan_f32_fold
    before = wrapper.launches
    gd, gi = wrapper(*args, 16, cosine=True)
    pd, pi = tsf.ivf_cell_scan_f32_plain(*args, 16, True, exact=exact)
    assert torch.equal(gd, pd) and torch.equal(gi, pi)
    assert wrapper.launches == before    # no kernel launched


def test_repack_blocks_keeps_f32_cells():
    storage = torch.randn(300, 40)
    cells, sn = tsf.repack_blocks(storage, (storage ** 2).sum(1), torch.tensor([0, 128]), 128)
    assert cells.dtype == torch.float32 and cells.shape == (3, 128, 48)
    assert torch.equal(cells[1, :, :40], storage[128:256]) and (cells[:, :, 40:] == 0).all()


def test_repack_blocks_keeps_bf16_and_int8_cells():
    storage = torch.randn(300, 40).to(torch.bfloat16)
    cells, sn = tsf.repack_blocks(storage, (storage.float() ** 2).sum(1),
                                  torch.tensor([0, 128]), 128)
    assert cells.dtype == torch.bfloat16 and cells.shape == (3, 128, 48)
    assert torch.equal(cells[1, :, :40], storage[128:256]) and sn.dtype == torch.float32
    codes = torch.randint(-128, 128, (300, 40), dtype=torch.int8)
    sq = (codes.int() ** 2).sum(1, dtype=torch.int32)
    cells, sn = tsf.repack_blocks(codes, sq, torch.tensor([0, 128]), 128)
    assert cells.dtype == torch.int8 and torch.equal(sn[1], sq[128:256].float())


# -- K1c-bf16, K1d-bf16, K1c-sq8 and K1d-sq8 ------------------------------------
#
# sq8: query codes and cell codes are integers with |v| ≤ 128, so every
# product and partial sum is an integer below 2²⁴ and the dots, and the l2
# distances, are exact in both packages: they agree bit for bit. Under
# cos_qnorm the JAX package's CPU rsqrt is not correctly rounded (it
# differs from the IEEE 1/√x, which the kernel and the plain version take,
# by up to 2 ulp) and XLA fuses 1 − a·b into one FMA: bit for bit on rows
# whose squared norms are powers of 4 (every factor then exact), within
# 1e-6 otherwise.
# bf16: the fold rounds the query to bf16 in both packages, so the products
# are exact and only the order of the f32 sums differs; the exact
# selection scores the f32 query, which the JAX package splits into hi/lo
# bf16 terms (about 16 of its bits). Distances within 1e-5 relative, lanes
# on ≥ 99.99% of (task, slot, rank), sentinel entries equal.


def _quant_tasks(seed, d, cell_dtype, R=24, maxq=32, seg=256, nseg=6, nq=50, pow4=False,
                 unit=False):
    """Task inputs over bf16 or int8 cells (padded to 16 columns), with
    sentinel rows (cnt 0), rows shorter than kb and partial rows. int8:
    query codes as f32; ``pow4`` puts one nonzero ±2^j per row, so every
    squared norm is a power of 4. bf16: ``unit`` rows and queries (the
    cosine index stores them normalised)."""
    rng = np.random.default_rng(seed)
    dp = -(-d // 16) * 16
    if cell_dtype == "int8":
        if pow4:
            cells = np.zeros((nseg + 1, seg, dp), np.int8)
            cols = rng.integers(0, d, (nseg, seg))
            vals = rng.choice([-64, -16, -4, -1, 1, 2, 8, 32], (nseg, seg))
            np.put_along_axis(cells[:-1], cols[..., None], vals[..., None].astype(np.int8), axis=2)
            queries_x = np.zeros((nq + 1, d), np.float32)
            queries_x[np.arange(nq), rng.integers(0, d, nq)] = rng.choice([-32, -2, 1, 4, 16], nq)
            queries_x[0, :4] = 8             # ‖q‖² = 256
            queries_x[1] = 0                 # a zero query: qadd = 0
        else:
            cells = np.zeros((nseg + 1, seg, dp), np.int8)
            cells[:-1, :, :d] = rng.integers(-128, 128, (nseg, seg, d))
            queries_x = rng.integers(-128, 128, (nq + 1, d)).astype(np.float32)
        sn = (cells.astype(np.float32) ** 2).sum(-1).astype(np.float32)
    else:
        cells32 = np.zeros((nseg + 1, seg, dp), np.float32)
        cells32[:-1, :, :d] = rng.standard_normal((nseg, seg, d))
        queries_x = rng.standard_normal((nq + 1, d)).astype(np.float32)
        if unit:
            cells32 /= np.maximum(np.linalg.norm(cells32, axis=-1, keepdims=True), 1e-30)
            queries_x /= np.linalg.norm(queries_x, axis=-1, keepdims=True)
        cells = np.asarray(jnp.asarray(cells32).astype(jnp.bfloat16))
        sn = (np.asarray(cells, np.float32) ** 2).sum(-1).astype(np.float32)
    queries_x[-1] = 0
    task_seg = rng.integers(0, nseg, R).astype(np.int32)
    cnt = np.full(R, seg, np.int32)
    cnt[1::5] = rng.integers(1, seg, len(cnt[1::5]))
    cnt[2] = 5                       # fewer valid lanes than kb
    cnt[3::7] = 0
    task_seg[3::7] = nseg
    lists = rng.integers(0, nq + 1, (R, maxq)).astype(np.int32)
    return lists, task_seg, cnt, queries_x, cells, sn


def _jax_quant_cell_scan(lists, task_seg, cnt, queries_x, cells, sn, kb, mode, cosine, selection,
                         fold_depth=2):
    """The JAX scan on port-style task inputs, with the query terms, qadd and
    epilogue that ``fused_ivf_scan`` picks for mode bf16 or sq8;
    ``_fused_cell_scan`` in interpret mode."""
    R, maxq = lists.shape
    seg, dp = cells.shape[1:]
    qg = jnp.asarray(queries_x)[jnp.asarray(lists)]
    q_sq = jnp.sum(qg * qg, axis=-1)
    if mode == "sq8":
        epilogue = "cos_qnorm" if cosine else "l2"
        qadd = jnp.where(q_sq > 0, jax.lax.rsqrt(jnp.maximum(q_sq, 1e-12)), 0.0) if cosine else q_sq
    else:
        epilogue = "cos_plain" if cosine else "l2"
        qadd = jnp.zeros((R, maxq), jnp.float32) if cosine else q_sq
    qg = jnp.pad(qg, ((0, 0), (0, 0), (0, dp - qg.shape[-1])))
    if mode == "bf16" and selection == "exact":
        qk_t = mantissa_split(qg, 2)
    else:
        qk_t = (qg.astype(jnp.bfloat16),)
    cd, ci = jsp._fused_cell_scan(
        qk_t, jnp.broadcast_to(qadd[:, None, :], (R, 8, maxq)),
        jnp.asarray(task_seg), jnp.asarray(cnt), (jnp.asarray(cells),),
        jnp.broadcast_to(jnp.asarray(sn)[:, None, :], (sn.shape[0], 8, seg)),
        kb, epilogue, True, fold_depth=fold_depth, selection=selection,
    )
    return np.asarray(cd), np.asarray(ci)


def _port_quant_plain(args, kb, mode, cosine, selection, fold_depth=2):
    lists, task_seg, cnt, queries_x, cells, sn = args
    cells_t = (torch.tensor(np.asarray(cells, np.float32)).to(torch.bfloat16)
               if mode == "bf16" else torch.as_tensor(cells))
    plain = tsf.ivf_cell_scan_bf16_plain if mode == "bf16" else tsf.ivf_cell_scan_sq8_plain
    return plain(torch.as_tensor(lists), torch.as_tensor(task_seg), torch.as_tensor(cnt),
                 torch.as_tensor(queries_x), cells_t, torch.as_tensor(sn), kb, cosine,
                 exact=selection == "exact", fold_depth=fold_depth)


def _assert_sentinels(gd, gi, wd, wi, cnt, selection):
    big = np.float32(3e38)
    np.testing.assert_array_equal(gd == big, wd == big)
    np.testing.assert_array_equal(gi[wd == big], wi[wd == big])
    assert (gd[cnt == 0] == big).all() and (gi[cnt == 0] == 0).all()
    if selection == "exact":         # past the valid rows: (3e38, lane 0)
        assert (gd[2, :, 5:] == big).all() and (gi[2, :, 5:] == 0).all()


@pytest.mark.parametrize("selection", ["exact", "fold"], ids=["K1c-sq8", "K1d-sq8"])
@pytest.mark.parametrize(
    "seed,d,kb,cosine,pow4",
    [
        (0, 40, 8, False, False),     # l2, columns padded to 48
        (1, 64, 16, False, False),
        (2, 40, 16, True, True),      # cos_qnorm, powers-of-4 norms
        (3, 64, 8, True, True),
    ],
)
def test_sq8_cell_scan_matches_jax_bit_for_bit(seed, d, kb, cosine, pow4, selection):
    args = _quant_tasks(seed, d, "int8", pow4=pow4)
    gd, gi = _port_quant_plain(args, kb, "sq8", cosine, selection)
    wd, wi = _jax_quant_cell_scan(*args, kb, "sq8", cosine, selection)
    assert gd.shape == (24, 32, kb) and gi.dtype == torch.int32
    np.testing.assert_array_equal(gd.numpy(), wd)
    np.testing.assert_array_equal(gi.numpy(), wi)
    _assert_sentinels(gd.numpy(), gi.numpy(), wd, wi, args[2], selection)


@pytest.mark.parametrize("selection", ["exact", "fold"], ids=["K1c-sq8", "K1d-sq8"])
def test_sq8_cos_qnorm_matches_jax_on_any_codes(selection):
    args = _quant_tasks(4, 40, "int8")
    gd, gi = _port_quant_plain(args, 16, "sq8", True, selection)
    wd, wi = _jax_quant_cell_scan(*args, 16, "sq8", True, selection)
    np.testing.assert_allclose(gd.numpy(), wd, rtol=0, atol=1e-6)
    assert (gi.numpy() == wi).mean() >= 0.9999
    _assert_sentinels(gd.numpy(), gi.numpy(), wd, wi, args[2], selection)


@pytest.mark.parametrize("selection", ["exact", "fold"], ids=["K1c-bf16", "K1d-bf16"])
@pytest.mark.parametrize(
    "seed,d,kb,cosine", [(5, 40, 8, False), (6, 64, 16, False), (7, 40, 16, True), (8, 64, 8, True)]
)
def test_bf16_cell_scan_matches_jax(seed, d, kb, cosine, selection):
    args = _quant_tasks(seed, d, "bf16", unit=cosine)
    gd, gi = _port_quant_plain(args, kb, "bf16", cosine, selection)
    wd, wi = _jax_quant_cell_scan(*args, kb, "bf16", cosine, selection)
    real = wd != np.float32(3e38)
    np.testing.assert_allclose(gd.numpy()[real], wd[real], rtol=1e-5, atol=0)
    assert (gi.numpy() == wi).mean() >= 0.9999
    _assert_sentinels(gd.numpy(), gi.numpy(), wd, wi, args[2], selection)


@pytest.mark.parametrize("mode", ["bf16", "sq8"])
@pytest.mark.parametrize("exact", [True, False])
def test_quantised_wrappers_on_cpu_are_the_plain_version(mode, exact):
    lists, task_seg, cnt, queries_x, cells, sn = _quant_tasks(9, 48, "int8" if mode == "sq8" else "bf16", R=6)
    cells_t = (torch.tensor(np.asarray(cells, np.float32)).to(torch.bfloat16)
               if mode == "bf16" else torch.as_tensor(cells))
    args = (torch.as_tensor(lists), torch.as_tensor(task_seg), torch.as_tensor(cnt),
            torch.as_tensor(queries_x), cells_t, torch.as_tensor(sn))
    wrapper = getattr(tsf, f"ivf_cell_scan_{mode}_{'exact' if exact else 'fold'}")
    plain = getattr(tsf, f"ivf_cell_scan_{mode}_plain")
    before = wrapper.launches
    gd, gi = wrapper(*args, 16, cosine=True)
    pd, pi = plain(*args, 16, True, exact=exact)
    assert torch.equal(gd, pd) and torch.equal(gi, pi)
    assert wrapper.launches == before    # no kernel launched


# -- K1b-l2, K1b-cos and K1d-i8dec ------------------------------------------------
#
# The int8-decode variants with two bf16 query terms (q_split) and with the
# cos_renorm epilogue. Both packages build the terms alike (hi by integer
# add-then-mask, lo = bf16(v − hi)), so the query values agree bit for bit;
# the JAX kernel sums two separately accumulated dots where the port
# accumulates (hi + lo)·x in one pass, so the f32 sums differ in order and
# rounding count. l2 distances agree within 1e-5·(1 + |d|). Under
# cos_renorm the queries are unit vectors, so the terms are ≤ 1 and the
# distances agree within 2e-6: the f32 sums of 128 products, and the JAX
# CPU rsqrt, which is a few ulp off the IEEE 1/√x the port takes. Lanes
# agree on ≥ 99.9% of (task, slot, rank): near-ties can swap. Sentinel
# entries (3e38, and their lanes) agree exactly.

I8_CASES = [
    # (mode, cosine, q_split)
    ("i8dec_residual", False, True),     # K1b-l2
    ("i8dec_residual", True, False),     # K1b-cos, one term
    ("i8dec_residual", True, True),      # K1b-cos, two terms
    ("i8dec", False, False),             # K1d-i8dec l2
    ("i8dec", False, True),
    ("i8dec", True, False),              # K1d-i8dec cos_renorm
    ("i8dec", True, True),
]
I8_IDS = [f"{m}-{'cos' if c else 'l2'}-nq_t{2 if s else 1}" for m, c, s in I8_CASES]


def test_bf16_terms_match_jax_mantissa_split():
    rng = np.random.default_rng(0)
    v = (rng.standard_normal(4096) * 10.0 ** rng.integers(-6, 6, 4096)).astype(np.float32)
    v[:6] = [0.0, -0.0, 1.0, -1.0, 1.00390625, -3.0e-39]     # a tie, a denormal
    hi, lo = mantissa_split(jnp.asarray(v), 2)
    want = np.asarray(hi, np.float32) + np.asarray(lo, np.float32)
    np.testing.assert_array_equal(tsf._bf16_terms(torch.as_tensor(v), True).numpy(), want)
    one = np.asarray(jnp.asarray(v).astype(jnp.bfloat16), np.float32)
    np.testing.assert_array_equal(tsf._bf16_terms(torch.as_tensor(v), False).numpy(), one)


def _jax_i8_cell_scan(lists, task_seg, cnt, queries_x, cent_x, scales, cells, sn, kb,
                      mode, cosine, q_split, fold_depth=2, selection="fold"):
    """The JAX scan on port-style task inputs: the prologue as
    ``fused_ivf_scan`` computes it for the int8-decode modes, then
    ``_fused_cell_scan`` in interpret mode."""
    qg = jnp.asarray(queries_x)[jnp.asarray(lists)]
    cent = jnp.asarray(cent_x)[jnp.asarray(task_seg)]
    sc = jnp.asarray(scales)[None, None, :]
    R, maxq = lists.shape
    if mode == "i8dec_residual" and cosine:
        qadd, qk = jnp.einsum("rmd,rd->rm", qg, cent), qg * sc
    elif mode == "i8dec_residual":
        qr = qg - cent[:, None, :]
        qadd, qk = jnp.sum(qr * qr, axis=-1), qr * sc
    else:
        qadd = jnp.zeros((R, maxq), jnp.float32) if cosine else jnp.sum(qg * qg, axis=-1)
        qk = qg * sc
    qk_t = mantissa_split(qk, 2) if q_split else (qk.astype(jnp.bfloat16),)
    seg = cells.shape[1]
    cd, ci = jsp._fused_cell_scan(
        qk_t, jnp.broadcast_to(qadd[:, None, :], (R, 8, maxq)),
        jnp.asarray(task_seg), jnp.asarray(cnt), (jnp.asarray(cells),),
        jnp.broadcast_to(jnp.asarray(sn)[:, None, :], (sn.shape[0], 8, seg)),
        kb, "cos_renorm" if cosine else "l2", True, fold_depth=fold_depth,
        selection=selection,
    )
    return np.asarray(cd), np.asarray(ci)


def _assert_i8_parity(gd, gi, wd, wi, cosine):
    big = np.float32(3e38)
    np.testing.assert_array_equal(gd == big, wd == big)
    np.testing.assert_array_equal(gi[wd == big], wi[wd == big])
    real = wd != big
    tol = 2e-6 if cosine else 1e-5 * (1.0 + np.abs(wd[real]))
    assert np.all(np.abs(gd[real] - wd[real]) <= tol)
    assert (gi == wi).mean() >= 0.999


@pytest.mark.parametrize("mode,cosine,q_split", I8_CASES, ids=I8_IDS)
def test_i8dec_cell_scans_match_jax(mode, cosine, q_split):
    lists, task_seg, cnt, queries_x, cent_x, scales, cells, sn = _random_tasks(11)
    if cosine:   # the cosine index scores unit queries against sn = ‖c + dec‖²
        queries_x = queries_x / np.maximum(np.linalg.norm(queries_x, axis=1, keepdims=True), 1e-30)
        dec = cells.astype(np.float32) * scales
        if mode == "i8dec_residual":
            dec = dec + cent_x[:, None, :]
        sn = (dec * dec).sum(-1).astype(np.float32)
    args = (lists, task_seg, cnt, queries_x, cent_x, scales, cells, sn)
    t = [torch.as_tensor(a) for a in args]
    if mode == "i8dec":
        t[4] = None
    gd, gi = tsf.ivf_cell_scan_plain(*t, KB, cosine=cosine, q_split=q_split)
    wd, wi = _jax_i8_cell_scan(*args, KB, mode, cosine, q_split)
    assert gd.shape == (24, 32, KB) and gi.dtype == torch.int32
    _assert_i8_parity(gd.numpy(), gi.numpy(), wd, wi, cosine)
    assert (gd.numpy()[cnt == 0] == np.float32(3e38)).all() and (gi.numpy()[cnt == 0] == 0).all()


@pytest.fixture(scope="module")
def jindex_cos():
    """JAX cosine IVF-PQ (m = d) with split and partial segments."""
    x, _ = generate_clustered_data(1200, 128, 6, seed=3)
    q = subsample_with_noise(x, 25, seed=4)
    j = JIvfPq(x, "cosine", nlist=4, m=128, seg_size=128)
    assert j.mode == "i8dec_residual" and (np.asarray(j.seg_counts) < 128).any()
    return j, q / np.linalg.norm(q, axis=1, keepdims=True)


@pytest.mark.parametrize("mode,cosine,q_split", I8_CASES, ids=I8_IDS)
def test_fused_ivf_scan_i8dec_variants_match_jax(jindex, jindex_cos, tasks, mode, cosine, q_split):
    """The host side end to end on carried state: ``fused_ivf_scan`` of both
    packages on one index's cells, task lists and gather map. Mode i8dec
    scans the same cells without the centroids."""
    j, q = jindex_cos if cosine else jindex
    cids, lists, gmap = tasks
    jcells, jsn = jsp.repack_blocks(j.storage, j.store_sqnorms, j.seg_offsets, j.seg_size)
    wd, wi = jsp.fused_ivf_scan(
        jnp.asarray(q), cids, lists, gmap, jcells, jsn, j.seg_offsets, j.seg_counts,
        j.seg_centroids, K, JDist.COSINE if cosine else JDist.EUCLIDEAN, mode,
        j.dec_scales, KB, interpret=True, q_split=q_split,
    )
    cells, sn = tsf.repack_blocks(
        _t(j.storage), _t(j.store_sqnorms), _t(j.seg_offsets), j.seg_size
    )
    gd, gi = tsf.fused_ivf_scan(
        torch.as_tensor(q), _t(cids), _t(lists), _t(gmap), cells, sn,
        _t(j.seg_offsets), _t(j.seg_counts), _t(j.seg_centroids), K,
        Dist.COSINE if cosine else Dist.EUCLIDEAN, mode, _t(j.dec_scales), KB,
        q_split=q_split,
    )
    assert gd.shape == (len(q), K) and torch.all(gd[:, 1:] >= gd[:, :-1])
    if cosine:
        np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=0, atol=2e-6)
        assert (gi.numpy() == np.asarray(wi)).mean() >= 0.99
    else:
        _assert_scan_parity(gd.numpy(), gi.numpy(), np.asarray(wd), np.asarray(wi))


@pytest.mark.parametrize(
    "wrapper,kw",
    [("ivf_cell_scan_split", {}), ("ivf_cell_scan_cos", {"q_split": False}),
     ("ivf_cell_scan_cos", {"q_split": True}),
     ("ivf_cell_scan_i8dec", {"cosine": False, "q_split": True}),
     ("ivf_cell_scan_i8dec", {"cosine": True, "q_split": False})],
)
def test_i8dec_wrappers_on_cpu_are_the_plain_version(wrapper, kw):
    args = [torch.as_tensor(a) for a in _random_tasks(3, R=6)]
    fn = getattr(tsf, wrapper)
    plain_kw = {"q_split": True} if wrapper == "ivf_cell_scan_split" else dict(kw)
    if wrapper == "ivf_cell_scan_cos":
        plain_kw["cosine"] = True
    plain_args = list(args)
    if wrapper == "ivf_cell_scan_i8dec":
        plain_args[4] = None
        del args[4]
    before = fn.launches
    gd, gi = fn(*args, 16, **kw)
    pd, pi = tsf.ivf_cell_scan_plain(*plain_args, 16, **plain_kw)
    assert torch.equal(gd, pd) and torch.equal(gi, pi)
    assert fn.launches == before    # no kernel launched


# -- K1-fold1, K1-exact-i8, wide rows (F6) and K1-groups ------------------------
#
# The same references as above with the Pallas kernel's other arguments:
# fold_depth=1 (one survivor per stride class), selection="exact" over the
# int8-decode modes, and padded rows wider than the kernel's single-block
# limit of 4,096 columns; the tolerances are those of each mode's section.


@pytest.mark.parametrize("seed,d,cosine", [(20, 64, False), (21, 40, True)])
def test_f32_fold1_matches_jax_bit_for_bit(seed, d, cosine):
    args = _grid_tasks(seed, d)
    t = [torch.as_tensor(a) for a in args]
    gd, gi = tsf.ivf_cell_scan_f32_plain(*t, 16, cosine, exact=False, fold_depth=1)
    wd, wi = _jax_f32_cell_scan(*args, 16, cosine, "fold", fold_depth=1)
    np.testing.assert_array_equal(gd.numpy(), wd)
    np.testing.assert_array_equal(gi.numpy(), wi)
    # one survivor per class: two of a class's lanes never both return
    d2, _ = tsf.ivf_cell_scan_f32_plain(*t, 16, cosine, exact=False, fold_depth=2)
    assert (gd.numpy() != d2.numpy()).any()
    assert (gd.numpy() >= d2.numpy()).all()
    lanes = gi.numpy()[gd.numpy() < np.float32(3e38)]
    assert lanes.max() < 256


@pytest.mark.parametrize("mode", ["sq8", "bf16"])
def test_quantised_fold1_matches_jax(mode):
    args = _quant_tasks(22, 40, "int8" if mode == "sq8" else "bf16")
    gd, gi = _port_quant_plain(args, 16, mode, False, "fold", fold_depth=1)
    wd, wi = _jax_quant_cell_scan(*args, 16, mode, False, "fold", fold_depth=1)
    if mode == "sq8":
        np.testing.assert_array_equal(gd.numpy(), wd)
        np.testing.assert_array_equal(gi.numpy(), wi)
    else:
        real = wd != np.float32(3e38)
        np.testing.assert_allclose(gd.numpy()[real], wd[real], rtol=1e-5, atol=0)
        assert (gi.numpy() == wi).mean() >= 0.9999
    _assert_sentinels(gd.numpy(), gi.numpy(), wd, wi, args[2], "fold")


K1A_CASE = ("i8dec_residual", False, False)
I8_ALL = [K1A_CASE] + I8_CASES
I8_ALL_IDS = ["i8dec_residual-l2-nq_t1"] + I8_IDS


def _i8_args(mode, cosine, seed=11, **kw):
    """``_random_tasks`` as the index of ``mode`` would hold them (unit
    queries and sn = ‖c + dec‖² under cosine); ``(numpy args, tensors)``,
    the tensors with ``cent_x`` None for mode i8dec."""
    lists, task_seg, cnt, queries_x, cent_x, scales, cells, sn = _random_tasks(seed, **kw)
    if cosine:
        queries_x = queries_x / np.maximum(np.linalg.norm(queries_x, axis=1, keepdims=True), 1e-30)
        dec = cells.astype(np.float32) * scales
        if mode == "i8dec_residual":
            dec = dec + cent_x[:, None, :]
        sn = (dec * dec).sum(-1).astype(np.float32)
    args = (lists, task_seg, cnt, queries_x, cent_x, scales, cells, sn)
    t = [torch.as_tensor(a) for a in args]
    if mode == "i8dec":
        t[4] = None
    return args, t


@pytest.mark.parametrize("mode,cosine,q_split", I8_ALL, ids=I8_ALL_IDS)
@pytest.mark.parametrize("selection,fold_depth", [("fold", 1), ("exact", 2)],
                         ids=["K1-fold1", "K1-exact-i8"])
def test_i8dec_fold1_and_exact_match_jax(mode, cosine, q_split, selection, fold_depth):
    args, t = _i8_args(mode, cosine)
    gd, gi = tsf.ivf_cell_scan_plain(*t, KB, cosine=cosine, q_split=q_split,
                                     fold_depth=fold_depth, exact=selection == "exact")
    wd, wi = _jax_i8_cell_scan(*args, KB, mode, cosine, q_split, fold_depth=fold_depth,
                               selection=selection)
    _assert_i8_parity(gd.numpy(), gi.numpy(), wd, wi, cosine)
    cnt = args[2]
    assert (gd.numpy()[cnt == 0] == np.float32(3e38)).all() and (gi.numpy()[cnt == 0] == 0).all()
    if selection == "exact":         # past the valid rows: (3e38, lane 0)
        assert (gd.numpy()[2, :, 5:] == np.float32(3e38)).all()
        assert (gi.numpy()[2, :, 5:] == 0).all()


@pytest.mark.parametrize("mode,cosine,q_split", I8_ALL, ids=I8_ALL_IDS)
def test_i8_exact_wrapper_on_cpu_is_the_plain_version(mode, cosine, q_split):
    _, t = _i8_args(mode, cosine, seed=12, R=6)
    before = tsf.ivf_cell_scan_i8_exact.launches
    gd, gi = tsf.ivf_cell_scan_i8_exact(*t, 16, cosine=cosine, q_split=q_split)
    pd, pi = tsf.ivf_cell_scan_plain(*t, 16, cosine=cosine, q_split=q_split, exact=True)
    assert torch.equal(gd, pd) and torch.equal(gi, pi)
    assert tsf.ivf_cell_scan_i8_exact.launches == before    # no kernel launched


@pytest.mark.parametrize("wrapper,kw", [
    ("ivf_cell_scan", {}), ("ivf_cell_scan_split", {}), ("ivf_cell_scan_cos", {}),
    ("ivf_cell_scan_i8dec", {"cosine": True}),
])
def test_i8dec_fold1_wrappers_on_cpu_are_the_plain_version(wrapper, kw):
    cosine = wrapper == "ivf_cell_scan_cos" or kw.get("cosine", False)
    mode = "i8dec" if wrapper == "ivf_cell_scan_i8dec" else "i8dec_residual"
    _, t = _i8_args(mode, cosine, seed=13, R=6)
    fn = getattr(tsf, wrapper)
    before = fn.launches
    gd, gi = fn(*(t[:4] + t[5:] if mode == "i8dec" else t), 16, fold_depth=1, **kw)
    pd, pi = tsf.ivf_cell_scan_plain(*t, 16, cosine=cosine,
                                     q_split=wrapper == "ivf_cell_scan_split", fold_depth=1)
    assert torch.equal(gd, pd) and torch.equal(gi, pi)
    assert fn.launches == before


def test_fold_depth_outside_1_and_2_is_refused():
    args = [torch.as_tensor(a) for a in _grid_tasks(23, 16, R=4)]
    for depth in (0, 3):
        with pytest.raises(ValueError, match="fold_depth"):
            tsf._sel(depth)
    gd, _ = tsf.ivf_cell_scan_f32_fold(*args, 8, fold_depth=1)
    assert gd.shape == (4, 32, 8)


@pytest.mark.parametrize("selection", ["exact", "fold"])
def test_wide_f32_rows_match_jax_bit_for_bit(selection):
    """F6: padded rows past 4,096 columns (4,224: the kernel stages the
    query in column blocks) give the Pallas kernel's result."""
    args = _grid_tasks(24, 4224, R=6, maxq=8, seg=128, nseg=3, nq=10)
    gd, gi = tsf.ivf_cell_scan_f32_plain(*(torch.as_tensor(a) for a in args), 8, False,
                                         exact=selection == "exact")
    wd, wi = _jax_f32_cell_scan(*args, 8, False, selection)
    assert gd.shape == (6, 8, 8)
    np.testing.assert_array_equal(gd.numpy(), wd)
    np.testing.assert_array_equal(gi.numpy(), wi)


def test_wide_sq8_and_i8dec_rows_match_jax():
    """sq8's integer dots pass 2²⁴ at this width, so the f32 sums round in
    both packages, each in its own order: a relative tolerance."""
    args = _quant_tasks(25, 4200, "int8", R=6, maxq=8, seg=128, nseg=3, nq=10)
    gd, gi = _port_quant_plain(args, 8, "sq8", False, "fold")
    wd, wi = _jax_quant_cell_scan(*args, 8, "sq8", False, "fold")
    np.testing.assert_allclose(gd.numpy(), wd, rtol=1e-6, atol=0)
    assert (gi.numpy() == wi).mean() >= 0.99
    a, t = _i8_args("i8dec_residual", False, seed=26, R=6, maxq=8, seg=128, d=4160, nseg=3,
                    nq=10)
    gd, gi = tsf.ivf_cell_scan_plain(*t, 8)
    wd, wi = _jax_i8_cell_scan(*a, 8, "i8dec_residual", False, False)
    _assert_i8_parity(gd.numpy(), gi.numpy(), wd, wi, False)


def test_regroup_topk_groups_is_a_top_k_per_group():
    """K1-groups: each query's lanes split into equal runs in gather-map
    order, each run's own top-k, group-major; pad lanes read (+inf, 0)."""
    rng = np.random.default_rng(27)
    nq, T, kb, groups, k = 5, 8, 4, 4, 3
    flat_d = torch.as_tensor(rng.integers(0, 50, (60, kb)).astype(np.float32))
    flat_i = torch.as_tensor(rng.integers(0, 1000, (60, kb)))
    gmap = torch.as_tensor(rng.permutation(60)[: nq * T].reshape(nq, T))
    gmap[0, :2] = -1                 # query 0's first group is all padding
    gd, gi = tsf.regroup_topk(flat_d, flat_i, gmap, k, groups)
    assert gd.shape == (nq, groups * k) and gi.shape == (nq, groups * k)
    pad_d = torch.cat([flat_d, torch.full((1, kb), float("inf"))])
    pad_i = torch.cat([flat_i, torch.zeros((1, kb), dtype=torch.long)])
    gm = torch.where(gmap < 0, 60, gmap)
    for q in range(nq):
        for g in range(groups):
            lanes = gm[q, g * (T // groups):(g + 1) * (T // groups)]
            vals, pos = torch.sort(pad_d[lanes].reshape(-1), stable=True)
            np.testing.assert_array_equal(gd[q, g * k:(g + 1) * k].numpy(), vals[:k].numpy())
            np.testing.assert_array_equal(gi[q, g * k:(g + 1) * k].numpy(),
                                          pad_i[lanes].reshape(-1)[pos[:k]].numpy())
    assert torch.isinf(gd[0, :k]).all() and (gi[0, :k] == 0).all()
    one_d, _ = tsf.regroup_topk(flat_d, flat_i, gmap, k)
    assert one_d.shape == (nq, k)
    with pytest.raises(ValueError, match="groups"):
        tsf.regroup_topk(flat_d, flat_i, gmap, k, 3)


def test_fused_ivf_scan_groups_matches_jax():
    """``groups=2`` over f32 grid cells, two probes per group with a
    duplicate probe masked to the pad segment (as the forests mask them):
    both packages' ``fused_ivf_scan`` on the same task lists."""
    from annsearch_tpu_torch.ops.probe_device import build_probe_lists_device as t_build

    rng = np.random.default_rng(28)
    nseg, seg, d, nq, k, kb = 8, 128, 16, 12, 5, 8
    storage = (rng.integers(-15, 16, (nseg * seg + seg, d)) / np.float32(8)).astype(np.float32)
    storage[nseg * seg:] = 0
    sqn = (storage * storage).sum(1).astype(np.float32)
    offs = (np.arange(nseg) * seg).astype(np.int32)
    counts = np.full(nseg, seg, np.int32)
    counts[-1] = 70
    q = (rng.integers(-15, 16, (nq, d)) / np.float32(8)).astype(np.float32)
    probes = rng.integers(0, nseg, (nq, 4)).astype(np.int32)
    probes[:, 1] = np.where(probes[:, 1] == probes[:, 0], nseg, probes[:, 1])
    probes[0, 3] = nseg
    maxq, R = device_probe_shapes(nq, 4, nseg, 1)
    jl = j_build(jnp.asarray(probes), nseg, maxq, R)
    tl = t_build(torch.as_tensor(probes), nseg, maxq, R)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jcells, jsn = jsp.repack_blocks(jnp.asarray(storage), jnp.asarray(sqn),
                                    jnp.asarray(offs), seg)
    wd, wi = jsp.fused_ivf_scan(
        jnp.asarray(q), *jl, jcells, jsn, jnp.asarray(offs), jnp.asarray(counts),
        jnp.zeros((nseg, d), jnp.float32), k, JDist.EUCLIDEAN, "f32", None, kb,
        interpret=True, groups=2,
    )
    cells, sn = tsf.repack_blocks(torch.as_tensor(storage), torch.as_tensor(sqn),
                                  torch.as_tensor(offs), seg)
    gd, gi = tsf.fused_ivf_scan(
        torch.as_tensor(q), *tl, cells, sn, torch.as_tensor(offs), torch.as_tensor(counts),
        torch.zeros((nseg, d)), k, Dist.EUCLIDEAN, "f32", None, kb, groups=2,
    )
    assert gd.shape == (nq, 2 * k)
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    assert (gi.numpy() == np.asarray(wi)).mean() >= 0.99


def test_fused_ivf_scan_fold1_matches_jax_and_the_index_passes_it(jindex, tasks):
    """``fused_ivf_scan(fold_depth=1)`` end to end against the JAX scan's,
    and ``IvfBase.query(fold_depth=1)`` reaches it (the JAX package's
    ``ANNSEARCH_IVF_FOLD1``)."""
    from annsearch_tpu_torch.interop import ivf_pq_from_jax_arrays

    j, q = jindex
    cids, lists, gmap = tasks
    jcells, jsn = jsp.repack_blocks(j.storage, j.store_sqnorms, j.seg_offsets, j.seg_size)
    wd, wi = jsp.fused_ivf_scan(
        jnp.asarray(q), cids, lists, gmap, jcells, jsn, j.seg_offsets, j.seg_counts,
        j.seg_centroids, K, JDist.EUCLIDEAN, "i8dec_residual", j.dec_scales, KB,
        interpret=True, q_split=False, fold_depth=1,
    )
    cells, sn = tsf.repack_blocks(
        _t(j.storage), _t(j.store_sqnorms), _t(j.seg_offsets), j.seg_size
    )
    gd, gi = tsf.fused_ivf_scan(
        torch.as_tensor(q), _t(cids), _t(lists), _t(gmap), cells, sn,
        _t(j.seg_offsets), _t(j.seg_counts), _t(j.seg_centroids), K,
        Dist.EUCLIDEAN, "i8dec_residual", _t(j.dec_scales), KB, fold_depth=1,
    )
    _assert_scan_parity(gd.numpy(), gi.numpy(), np.asarray(wd), np.asarray(wi))
    arrays = {a: np.asarray(getattr(j, a)) for a in (
        "storage", "store_sqnorms", "centroids", "seg_centroids", "seg_offsets",
        "seg_counts", "original_ids", "codebooks", "dec_scales")}
    arrays["cluster_ptr"] = np.asarray(j._cluster_ptr)
    port = ivf_pq_from_jax_arrays(arrays, {"n": j.n, "dim": j.dim, "nlist": j.nlist,
                                           "seg_size": j.seg_size, "m": j.m}, device="cpu")
    i1, d1 = port.query(q, K, nprobe=2, approx=True, fold_depth=1)
    i2, d2 = port.query(q, K, nprobe=2, approx=True)
    assert bool((d1 >= d2 - 1e-5).all())       # fewer survivors: never better
    assert (i1 == i2).float().mean() >= 0.9


@pytest.mark.parametrize("fold_depth", [1, 2])
def test_k1a_bf16_plain_matches_jax_at_kb_128_on_short_rows(fold_depth):
    """K1a-bf16's plain version (``ivf_cell_scan_plain(q_split=True)`` over
    bf16 cells) against the Pallas kernel in interpret mode at kb 128, bit
    for bit: ±1 cells, integer queries and centroids, so every distance is
    an exact small integer with many ties. Most rows hold fewer finite
    survivors than kb, so the rounds' tail ((3e38, m), m the least lane
    then at 3e38) fills most slots, as the card's selection must."""
    rng = np.random.default_rng(31)
    R, maxq, seg, d, nseg, nq = 10, 8, 512, 32, 4, 20
    cells = (rng.integers(0, 2, (nseg + 1, seg, d)) * 2 - 1).astype(np.float32)
    cells[-1] = 0
    sn = (cells * cells).sum(-1).astype(np.float32)
    queries_x = rng.integers(-2, 3, (nq + 1, d)).astype(np.float32)
    queries_x[-1] = 0
    cent_x = rng.integers(-1, 2, (nseg + 1, d)).astype(np.float32)
    cent_x[-1] = 0
    task_seg = rng.integers(0, nseg, R).astype(np.int32)
    cnt = np.array([0, 1, 5, 37, 100, 129, 200, 300, 512, 128], np.int32)
    task_seg[0] = nseg
    lists = rng.integers(0, nq + 1, (R, maxq)).astype(np.int32)
    scales = np.ones(d, np.float32)
    args = (lists, task_seg, cnt, queries_x, cent_x, scales, cells, sn)
    t = [torch.as_tensor(a) for a in args]
    t[6] = t[6].to(torch.bfloat16)
    gd, gi = tsf.ivf_cell_scan_plain(*t, 128, q_split=True, fold_depth=fold_depth)
    wd, wi = _jax_i8_cell_scan(*args, 128, "i8dec_residual", False, True,
                               fold_depth=fold_depth)
    np.testing.assert_array_equal(gd.numpy(), wd)
    np.testing.assert_array_equal(gi.numpy(), wi)
    big = np.float32(3e38)
    assert (wd[1:8] == big).any() and (wd[:, :, 0] < big)[1:].all()
    assert (wd[0] == big).all() and (wi[0] == 0).all()
