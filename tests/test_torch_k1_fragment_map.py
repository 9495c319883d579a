"""K1's scan on ``wgmma``, its layouts emulated in numpy: the accumulator
map that the fold and the exact selection read, and the order of K that
the cells' A fragments and the query terms' B layout share.

``csrc/ivf_scan.cu`` runs each 128-row chunk of a segment against a block's
32 query slots as ``wgmma`` m64n32 products, one consumer warpgroup per 64
rows. Consumer thread T (warp w = T // 32 of 8, lane = 4 g + t) holds
accumulator element 4 i + e at stride class 64 (w // 4) + 16 (w % 4) + g +
8 (e // 2) and slot 8 i + 2 t + e % 2, in every chunk. The fold keeps each
element's (best, runner-up) there and writes the survivors to
``[slot][depth · 128]``; the exact selection writes each chunk's filtered
distances into a ``[slot][class]`` tile that the slot's warp merges
(``tests/test_torch_exact_merge.py`` emulates that merge). The A operand
(cells, from registers) of f32 and widened int8 rows takes columns 4t ..
4t + 3 of each 16 in thread t, so the query terms are written in the same
order of K (``q_offset``).
"""

import numpy as np
import pytest
import torch

from annsearch_tpu_torch.ops import ivf_scan_fused as tsf
from test_torch_exact_merge import EMPTY, FMAX, U32, _key, _value, exact_merge

LANES = 128
SLOTS = 32
BIG = np.float32(3e38)
NO_CHUNK = 0xFFFF


def element_map():
    """(slot, class) of every consumer thread's 16 accumulator elements:
    two arrays [256, 16]."""
    T = np.arange(256)[:, None]
    k = np.arange(16)[None, :]
    w, lane = T // 32, T % 32
    g, t = lane // 4, lane % 4
    i, e = k // 4, k % 4
    cls = 64 * (w // 4) + 16 * (w % 4) + g + 8 * (e // 2)
    slot = 8 * i + 2 * t + e % 2
    return np.broadcast_to(slot, (256, 16)), np.broadcast_to(cls, (256, 16))


def test_every_element_is_held_once():
    slot, cls = element_map()
    held = np.zeros((SLOTS, LANES), dtype=np.int64)
    np.add.at(held, (slot, cls), 1)
    assert (held == 1).all()


def _fold_kernel(vals, n_valid, depth, kb):
    """The fold of ``csrc/ivf_scan.cu`` over one block: each thread's
    elements through the chunks in order (strict <), the survivors written
    to ``[slot][depth · 128]`` by the map, then the kb rounds (what
    ``fold_select`` computes at once, held to them on the card; its keys
    take -0 as +0)."""
    slot, cls = element_map()
    v1 = np.zeros((256, 16), dtype=np.float32)
    v2 = np.zeros((256, 16), dtype=np.float32)
    c1 = np.zeros((256, 16), dtype=np.int64)
    c2 = np.zeros((256, 16), dtype=np.int64)
    for ch in range(-(-n_valid // LANES)):
        lane = ch * LANES + cls
        d = np.where(lane >= n_valid, BIG, vals[slot, np.minimum(lane, vals.shape[1] - 1)])
        if ch == 0:
            v1, c1 = d.copy(), np.zeros_like(c1)
            v2, c2 = np.full_like(v2, BIG), np.full_like(c2, NO_CHUNK)
            continue
        upd = d < v1
        lose_v = np.where(upd, v1, d)
        lose_c = np.where(upd, c1, ch)
        v1, c1 = np.where(upd, d, v1), np.where(upd, ch, c1)
        if depth == 2:
            upd2 = lose_v < v2
            v2, c2 = np.where(upd2, lose_v, v2), np.where(upd2, lose_c, c2)
    sv = np.full((SLOTS, depth * LANES), np.nan, dtype=np.float32)
    si = np.full((SLOTS, depth * LANES), -1, dtype=np.int64)
    sv[slot, cls] = v1
    si[slot, cls] = c1 * LANES + cls
    if depth == 2:
        sv[slot, LANES + cls] = v2
        si[slot, LANES + cls] = np.where(c2 == NO_CHUNK, 0, c2 * LANES + cls)
    assert not np.isnan(sv).any() and (si >= 0).all()
    out_d = np.empty((SLOTS, kb), dtype=np.float32)
    out_i = np.empty((SLOTS, kb), dtype=np.int64)
    seg = vals.shape[1]
    for r in range(kb):
        v = sv.min(axis=1, keepdims=True)
        hit = sv == v
        li = np.where(hit, si, seg).min(axis=1, keepdims=True)
        out_d[:, r], out_i[:, r] = v[:, 0], li[:, 0]
        sv = np.where(hit & (si == li), BIG, sv)
    return out_d, out_i


def _values(rng, case, seg):
    if case == "ties":
        return rng.integers(0, 9, (SLOTS, seg)).astype(np.float32)
    if case == "zeros":        # ±0 among small integers
        v = rng.integers(0, 3, (SLOTS, seg)).astype(np.float32)
        v[(v == 0) & (rng.random((SLOTS, seg)) < 0.5)] = np.float32(-0.0)
        return v
    if case == "big":          # 3e38 on valid lanes
        v = rng.integers(0, 50, (SLOTS, seg)).astype(np.float32)
        v[rng.random((SLOTS, seg)) < 0.4] = BIG
        return v
    return (rng.standard_normal((SLOTS, seg)) ** 2 * 100).astype(np.float32)


def _plain_dist(vals, n_valid):
    """The plain versions' distances: lanes at or past ``cnt`` at 3e38."""
    seg = vals.shape[1]
    return torch.where(torch.arange(seg) < n_valid, torch.tensor(vals), float(BIG))


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("case", ["gauss", "ties", "zeros", "big"])
@pytest.mark.parametrize("chunks,short", [(1, 0), (3, 0), (3, 50), (8, 127)])
def test_fold_through_the_map_is_the_plain_fold(depth, case, chunks, short):
    rng = np.random.default_rng(depth * 100 + chunks * 10 + short + len(case))
    seg = chunks * LANES
    vals = _values(rng, case, seg)
    n_valid = seg - short
    kb = 24 if depth == 1 else 64
    kd, ki = _fold_kernel(vals, n_valid, depth, kb)
    pd, pi = tsf._fold_extract(_plain_dist(vals, n_valid), kb, depth)
    # bit for bit, but for the sign of a zero (the sort keys make -0 +0)
    np.testing.assert_array_equal((kd + 0).view(np.uint32), (pd.numpy() + 0).view(np.uint32))
    np.testing.assert_array_equal(ki, pi.numpy())


def _exact_kernel(vals, n_valid, kb):
    """The exact selection with the tiles written through the map: every
    tile cell written once per chunk, filtered by the slot's list as it
    stands, merged by ``exact_merge``."""
    slot, cls = element_map()
    lists = [np.full(kb, EMPTY) for _ in range(SLOTS)]
    pending = None
    for ch in range(-(-n_valid // LANES)):
        if pending is not None:
            lists = [exact_merge(pending[s], (ch - 1) * LANES, lists[s], kb, [])
                     for s in range(SLOTS)]
        lane = ch * LANES + cls
        d = vals[slot, np.minimum(lane, vals.shape[1] - 1)]
        thr = np.array([lst[kb - 1] >> np.uint64(32) for lst in lists])[slot]
        with np.errstate(invalid="ignore"):
            ok = (lane < n_valid) & (d <= FMAX) & ((_key(d, lane) >> np.uint64(32)) <= thr)
        tile = np.full((SLOTS, LANES), np.float32(7.0))
        writes = np.zeros((SLOTS, LANES), dtype=np.int64)
        tile[slot, cls] = np.where(ok, d, np.float32(np.nan))
        np.add.at(writes, (slot, cls), 1)
        assert (writes == 1).all()
        pending = tile
    if pending is not None:
        lists = [exact_merge(pending[s], ch * LANES, lists[s], kb, []) for s in range(SLOTS)]
    keys = np.stack(lists)
    real = keys != EMPTY
    return (np.where(real, _value(keys), BIG).astype(np.float32),
            np.where(real, (keys & U32) >> np.uint64(1), 0).astype(np.int64))


@pytest.mark.parametrize("kb", [8, 24, 128])
@pytest.mark.parametrize("case", ["gauss", "ties", "zeros", "big"])
@pytest.mark.parametrize("chunks,short", [(1, 0), (2, 37), (4, 0)])
def test_exact_tiles_through_the_map_are_the_plain_selection(kb, case, chunks, short):
    rng = np.random.default_rng(kb + chunks * 7 + short + len(case))
    seg = chunks * LANES
    vals = _values(rng, case, seg)
    n_valid = seg - short
    kd, ki = _exact_kernel(vals, n_valid, kb)
    pd, pi = tsf._exact_extract(_plain_dist(vals, n_valid)[:, None], kb,
                                torch.full((SLOTS,), n_valid, dtype=torch.int32))
    np.testing.assert_array_equal(kd.view(np.uint32), pd[:, 0].numpy().view(np.uint32))
    np.testing.assert_array_equal(ki, pi[:, 0].numpy())


# -- the order of K: the cells' A fragments and the query terms' B layout ------


def _sw64(row, unit):
    return row * 64 + ((unit ^ ((row >> 1) & 3)) << 4)


def _q_offset(slot, c, es, perm):
    """``q_offset``: the byte of column c of a slot's query term."""
    k = c
    if perm:
        w, e = c & 15, c & 3
        k = (c & ~15) | ((e & 2) << 2) | ((w >> 2) << 1) | (e & 1)
    byte = k * es
    return (byte >> 6) * 2048 + _sw64(slot, (byte >> 4) & 3) + (byte & 15)


def _a_columns(kind, kstep):
    """For one k step (16 columns, 32 for sq8) of a warp's 16 rows: the
    cell column each (row, k) position of the A operand holds, by the
    fragment each thread loads (``frag``) and the fragment's meaning
    (mma.sync's A layout: a[0] row g, k 2t, 2t + 1; a[1] row g + 8; a[2],
    a[3] k 8 on; in int8, four k a register and 16 on)."""
    cols = np.full((16, kstep), -1)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for h in range(2):                     # rows g, g + 8: a[h], a[h + 2]
            r = g + 8 * h
            if kind == "sq8":                  # standard k32: cols 4t.., 16 + 4t..
                for j in range(4):
                    cols[r, 4 * t + j] = 4 * t + j
                    cols[r, 16 + 4 * t + j] = 16 + 4 * t + j
            elif kind == "bf16":               # standard k16: cols 2t.., 8 + 2t..
                for j in range(2):
                    cols[r, 2 * t + j] = 2 * t + j
                    cols[r, 8 + 2 * t + j] = 8 + 2 * t + j
            else:                              # f32 / widened int8: cols 4t .. 4t + 3
                for j in range(2):
                    cols[r, 2 * t + j] = 4 * t + j
                    cols[r, 8 + 2 * t + j] = 4 * t + 2 + j
    assert (cols >= 0).all()
    return cols


@pytest.mark.parametrize("kind", ["f32", "i8", "bf16", "sq8"])
@pytest.mark.parametrize("d", [16, 48, 128])
def test_products_pair_the_same_columns(kind, d):
    """The query terms written by ``q_offset`` and read as wgmma reads a
    K-major B in the 64-byte swizzle, against A's columns: each k step's
    sum over k is the dot over those columns."""
    rng = np.random.default_rng(d + len(kind))
    es, kstep = (1, 32) if kind == "sq8" else (2, 16)
    perm = kind in ("f32", "i8")
    dk = -(-d // 128) * 128
    x = rng.integers(-50, 50, (16, dk)).astype(np.int64)       # a warp's 16 rows
    q = rng.integers(-50, 50, (SLOTS, dk)).astype(np.int64)
    x[:, d:] = 0
    q[:, d:] = 0
    smem = np.full(dk * es // 64 * 2048 // es, -10**9, dtype=np.int64)   # element slots
    for s in range(SLOTS):
        for c in range(dk):
            o = _q_offset(s, c, es, perm)
            assert o % es == 0 and smem[o // es] == -10**9
            smem[o // es] = q[s, c]
    a_cols = _a_columns(kind, kstep)
    got = np.zeros((16, SLOTS), dtype=np.int64)
    for step in range(dk // kstep):                            # 32 bytes of K a step
        base = (step >> 1) * 2048
        for n in range(SLOTS):
            bk = np.array([smem[(base + _sw64(n, ((step & 1) * 32 + k * es) >> 4)
                                 + (((step & 1) * 32 + k * es) & 15)) // es]
                           for k in range(kstep)])
            got[:, n] += (x[np.arange(16)[:, None], step * kstep + a_cols] * bk[None, :]).sum(1)
    np.testing.assert_array_equal(got, x @ q.T)


@pytest.mark.parametrize("dp,kb,sel", [(64, 24, 0), (32, 16, 2), (256, 24, 0), (4224, 24, 0),
                                       (4224, 16, 2), (128, 128, 2), (128, 128, 0)])
def test_plan_fits_shared_memory(dp, kb, sel):
    """Every plan of the four cell kinds fits one block's shared memory;
    the query terms stay whole wherever two blocks an SM hold them."""
    for cell_bytes, terms, int8 in ((4, 3, False), (2, 3, False), (2, 1, False), (2, 2, False),
                                    (1, 1, True), (1, 1, False), (1, 2, False)):
        wide, stages, stage, smem = tsf.scan_plan(cell_bytes, terms, int8, sel, dp, kb)
        assert 2 <= stages <= 4 and smem <= 231_424
        if not wide:
            assert stage == 33 * 512
        dk = -(-dp // (128 // cell_bytes)) * (128 // cell_bytes)
        q_whole = terms * dk * (1 if int8 else 2) * SLOTS
        if 512 + q_whole + 2 * 33 * 512 + (0 if sel else 25_000) + kb * 256 <= 115_200:
            assert not wide
