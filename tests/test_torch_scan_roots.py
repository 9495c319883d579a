"""The square roots of K1's plain versions, as the kernel takes them.

The kernel computes ``__fdiv_rn(1, __fsqrt_rn(x))``: an IEEE square root and
quotient. torch's vectorised CPU ``sqrt`` of f32 is off by one ulp on about
0.7% of inputs, so the plain versions (``cos_renorm`` of the int8-decode
variants, ``cos_qnorm`` of K1c-/K1d-sq8) take the f64 root rounded once
(``utils.dist._sqrt_f32``), which equals a numpy reference bit for bit.
"""

import numpy as np
import torch

from annsearch_tpu_torch.ops import ivf_scan_fused as tsf
from annsearch_tpu_torch.utils.dist import _sqrt_f32

F32 = np.float32


def _root(x):
    """numpy's correctly rounded f32 square root."""
    return np.sqrt(np.asarray(x, dtype=np.float64)).astype(F32)


def _misrounded(n=128, seed=0):
    """``n`` f32 values in [1, 1e4) whose vectorised torch square root is
    not the correctly rounded one."""
    x = np.random.default_rng(seed).uniform(1.0, 1e4, 200_000).astype(F32)
    bad = torch.sqrt(torch.tensor(x)).numpy() != _root(x)
    assert bad.sum() >= n
    return x[bad][:n]


def test_torch_cpu_sqrt_is_off_by_an_ulp_and_the_helper_is_not():
    x = np.random.default_rng(1).uniform(1e-6, 1e6, 100_000).astype(F32)
    ref = _root(x)
    t = torch.sqrt(torch.tensor(x)).numpy()
    off = (t.view(np.int32) - ref.view(np.int32))[t != ref]
    assert off.size > 0 and set(np.abs(off)) == {1}
    np.testing.assert_array_equal(_sqrt_f32(torch.tensor(x)).numpy().view(np.uint32),
                                  ref.view(np.uint32))


def _tasks(sn_row, d=16, nq=40, seed=2):
    """One segment of 128 int8 rows with the given ``sn``, every query in
    one task row, integer query values (every dot exact)."""
    rng = np.random.default_rng(seed)
    seg = sn_row.shape[0]
    cells = np.zeros((2, seg, d), dtype=np.int8)
    cells[0] = rng.integers(-20, 21, (seg, d))
    sn = np.zeros((2, seg), dtype=F32)
    sn[0] = sn_row
    q = np.zeros((nq + 1, d), dtype=F32)
    q[:nq] = rng.integers(-9, 10, (nq, d))
    lists = np.arange(nq, dtype=np.int32)[None]
    return (torch.tensor(lists), torch.tensor([0], dtype=torch.int32),
            torch.tensor([seg], dtype=torch.int32), torch.tensor(q), torch.tensor(cells),
            torch.tensor(sn)), q[:nq], cells[0].astype(F32)


def _sorted(dist):
    order = np.argsort(dist, axis=-1, kind="stable")
    return np.take_along_axis(dist, order, -1), order.astype(np.int32)


def _same(got, want):
    np.testing.assert_array_equal(got[0].numpy()[0].view(np.uint32), want[0].view(np.uint32))
    np.testing.assert_array_equal(got[1].numpy()[0], want[1])


def test_cos_qnorm_takes_ieee_roots():
    """K1c-sq8's plain version under cosine: ``1 − (dot · 1/√‖q‖²) · 1/√sn``
    with IEEE roots and quotients, against numpy bit for bit, on ``sn``
    values whose torch root is off by an ulp (the old plain version's
    factor differs there)."""
    sn_row = _misrounded()
    t, q, x = _tasks(sn_row)
    dots = q @ x.T                                       # exact integers
    qadd = np.where((q * q).sum(1) > 0, F32(1) / _root((q * q).sum(1)), F32(0))
    want = _sorted(F32(1) - (dots * qadd[:, None]) * (F32(1) / _root(sn_row))[None])
    _same(tsf.ivf_cell_scan_sq8_plain(*t, 128, True, exact=True), want)
    old = (1.0 / torch.sqrt(torch.tensor(sn_row))).numpy()
    assert (old != F32(1) / _root(sn_row)).any()


def test_cos_renorm_takes_ieee_roots():
    """K1-exact-i8's plain version under ``cos_renorm`` (mode i8dec, unit
    scales, integer queries: the bf16 terms and every dot exact):
    ``1 − dot · 1/√sn`` against numpy bit for bit."""
    sn_row = _misrounded(seed=3)
    t, q, x = _tasks(sn_row)
    lists, task_seg, cnt, qx, cells, sn = t
    got = tsf.ivf_cell_scan_i8_exact(lists, task_seg, cnt, qx, None, torch.ones(16), cells,
                                     sn, 128, cosine=True)
    want = _sorted(F32(1) - (q @ x.T) * (F32(1) / _root(sn_row))[None])
    _same(got, want)
