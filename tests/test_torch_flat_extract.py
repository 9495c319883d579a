"""K2's extraction as the card runs it, emulated in numpy, against the kb
rounds of its plain version, bit for bit.

``csrc/flat_scan.cu::flat_extract_kernel`` replaces the rounds (each the
lexicographic minimum (value, column) of a query's depth·B bins, written as
value + qadd, the bins equal to it then set to 3e38) by a sort network:
each warp sorts its 512 keys in registers (``csrc/bitonic.cuh``: 32 lanes ×
4 keys a group, partner distances 1 and 2 within a lane, 4 .. 64 by
``__shfl_xor_sync``), keeps the 128 smallest, and the warps' lists merge
in a tree through shared memory; the result's first kb keys, with the
rounds' (3e38 + qadd, m) tail past the bins below 3e38, are the output.
The emulation below follows the kernel lane by lane (a shuffle is an index
permutation of the lane axis) and is held against
``flat_scan_fused._extract_plain`` on exact values: many ties, ±0, short
and empty rows, bins at column 0, 3e38 bins with later columns (after a
merge of runs), and the bins the plain scan itself leaves at ``n_valid``
edges.
"""

import numpy as np
import pytest
import torch

from annsearch_tpu_torch.ops import flat_scan_fused as ff
from annsearch_tpu_torch.utils.dist import Dist

BIG = np.float32(3e38)
PAD = np.uint64((0xFF800000 << 32) | 0x7FFFFFFF)     # (inf, INT_MAX)
LANE = np.arange(32)[:, None]
UNIT = np.arange(4)[None, :]


def _sort_key(v, col):
    """``bitonic.cuh::sort_key``: the value's order-preserving bits (-0 as
    +0) above the column."""
    b = (v.astype(np.float32) + np.float32(0)).view(np.uint32).astype(np.uint64)
    b = np.where(b >> np.uint64(31) == 1, b ^ np.uint64(0xFFFFFFFF), b ^ np.uint64(0x80000000))
    return (b << np.uint64(32)) | col.astype(np.uint32).astype(np.uint64)


def _key_value(k):
    b = k >> np.uint64(32)
    b = np.where(b >> np.uint64(31) == 1, b ^ np.uint64(0x80000000), b ^ np.uint64(0xFFFFFFFF))
    return b.astype(np.uint32).view(np.float32)


def _stage(x, K, J):
    """``bitonic_stage<kH, K, J>`` on x [..., kH, 32 lanes, 4]: odd groups
    run the other way."""
    odd = (np.arange(x.shape[-3]) % 2 == 1)[:, None, None]
    if J < 4:
        up = (((4 * LANE + UNIT) & K) == 0)[None] != odd
        out = x.copy()
        for u in range(4):
            if u & J:
                continue
            a, b = x[..., u], x[..., u | J]
            keep = (a < b) == up[..., u]
            out[..., u] = np.where(keep, a, b)
            out[..., u | J] = np.where(keep, b, a)
        return out
    up = (((4 * LANE) & K) == 0)[None] != odd
    keep_min = ((LANE & (J // 4)) == 0)[None] == up
    other = x[..., LANE[:, 0] ^ (J // 4), :]          # __shfl_xor_sync
    return np.where((x < other) == keep_min, x, other)


def _merge(x, K, J):
    while J >= 1:
        x = _stage(x, K, J)
        J //= 2
    return x


def _sort(x, K):
    k = 2
    while k <= K:
        x = _merge(x, k, k // 2)
        k *= 2
    return x


def network(vals, cols, qadd, kb):
    """``flat_extract_kernel`` on bins [rows, width] (numpy): (d, i)."""
    rows, width = vals.shape
    warps = 1
    while 512 * warps < width:
        warps *= 2
    keys = np.full((rows, 512 * warps), PAD, dtype=np.uint64)
    keys[:, :width] = _sort_key(vals, cols)
    # warp w, group h, lane l, key u: bin 512 w + 128 h + 4 l + u
    x = _sort(keys.reshape(rows, warps, 4, 32, 4), 128)
    m = _merge(np.minimum(x[:, :, [0, 2]], x[:, :, [1, 3]]), 256, 64)
    s = _merge(np.minimum(m[:, :, :1], m[:, :, 1:]), 256, 64)
    s[:, 512 * np.arange(warps) >= width] = PAD      # warps past the bins sort nothing
    half = warps // 2
    while half >= 1:
        lists = s[:, half : 2 * half].reshape(rows, half, 128)
        partner = lists[:, :, 127 - (4 * LANE + UNIT)][:, :, None]   # read reversed
        s = s.copy()
        s[:, :half] = _merge(np.minimum(partner, s[:, :half]), 256, 64)
        half //= 2
    best = s[:, 0, 0].reshape(rows, 128)
    big = np.uint64(int(np.array(BIG).view(np.uint32)) ^ 0x80000000)
    hi = best >> np.uint64(32)
    n_fin = (hi < big).sum(1, keepdims=True)
    low = np.where(hi <= big, best & np.uint64(0xFFFFFFFF), np.uint64(0xFFFFFFFF)).min(1)
    real = np.arange(128)[None] < n_fin
    d = np.where(real, _key_value(best), BIG) + qadd[:, None].astype(np.float32)
    i = np.where(real, best & np.uint64(0xFFFFFFFF), low[:, None]).astype(np.int64)
    return d[:, :kb].astype(np.float32), i[:, :kb].astype(np.int32)


def _rounds(vals, cols, qadd, kb):
    d, i = ff._extract_plain(torch.tensor(vals), torch.tensor(cols), torch.tensor(qadd), kb)
    return d.numpy(), i.numpy()


def _same(a, b):
    (ad, ai), (bd, bi) = a, b
    np.testing.assert_array_equal(ad.view(np.uint32), bd.view(np.uint32))
    np.testing.assert_array_equal(ai, bi)


def _bins(rng, rows, width, kb, case):
    """Bins as the scan leaves them, on exact values (see the card test
    ``test_k2_extraction_is_the_rounds_bit_for_bit``): distinct columns where
    filled, (3e38, 0) where not."""
    vals = rng.integers(-20, 21, (rows, width)).astype(np.float32)
    cols = np.stack([rng.permutation(1 << 20)[:width] + 1 for _ in range(rows)]).astype(np.int32)
    empty = rng.random((rows, width)) < 0.2
    if case == "tail":
        keep = rng.integers(0, kb, (rows, 1))
        empty = rng.random((rows, width)).argsort(1).argsort(1) >= keep
        empty[::5] = True                        # all-empty rows
    if case == "zeros":
        vals = rng.integers(-2, 3, (rows, width)).astype(np.float32) * np.float32(0.5)
        vals[(vals == 0) & (rng.random((rows, width)) < 0.5)] = np.float32(-0.0)
        cols[:, 0] = 0
    vals[empty] = BIG
    if case != "late":
        cols[empty] = 0
    return vals, cols, rng.integers(0, 50, rows).astype(np.float32)


WIDTH_KB = [(32, 8), (32, 32), (64, 16), (96, 64), (256, 100), (512, 128), (1024, 16),
            (2048, 16), (2560, 64), (4096, 128), (4096, 8)]


@pytest.mark.parametrize("case", ["ties", "tail", "zeros", "late"])
@pytest.mark.parametrize("width,kb", WIDTH_KB)
def test_network_is_the_rounds(width, kb, case):
    rng = np.random.default_rng(width * 131 + kb)
    vals, cols, qadd = _bins(rng, 24, width, kb, case)
    _same(network(vals, cols, qadd, kb), _rounds(vals, cols, qadd, kb))


@pytest.mark.parametrize("kb", [8, 64, 128])
def test_network_tail_of_empty_rows(kb):
    """Every bin at 3e38: each round emits (3e38 + qadd, m), m the least
    column (0 where a bin was never filled)."""
    vals = np.full((3, 256), BIG, dtype=np.float32)
    cols = np.zeros((3, 256), dtype=np.int32)
    cols[1] = np.arange(256) + 7         # a later run's bins, no column 0
    cols[2, 5:] = np.arange(251) + 1
    qadd = np.array([0.0, 2.5, -1.0], dtype=np.float32)
    d, i = network(vals, cols, qadd, kb)
    _same((d, i), _rounds(vals, cols, qadd, kb))
    assert (i[1] == 7).all() and (i[0] == 0).all() and (i[2] == 0).all()


@pytest.mark.parametrize("n_valid", [None, 0, 1, 37, 299])
@pytest.mark.parametrize("depth,k,block_db", [(2, 10, 128), (1, 10, 128), (2, 100, 128),
                                              (1, 40, 32), (2, 20, 32)])
def test_network_on_the_plain_scans_bins(n_valid, depth, k, block_db):
    """The bins the plain scan itself hands to its rounds (grid rows, many
    exact ties; classes with no row below ``n_valid`` never filled)."""
    rng = np.random.default_rng(depth * 7 + k)
    q = torch.tensor((rng.integers(-16, 17, (20, 16)) / 8).astype(np.float32))
    x = torch.tensor((rng.integers(-16, 17, (300, 16)) / 8).astype(np.float32))
    seen = []
    rounds = ff._extract_plain

    def record(vals, idx, qadd, kb):
        out = rounds(vals, idx, qadd, kb)
        seen.append((vals.numpy().copy(), idx.numpy().copy(), qadd.numpy().copy(), kb, out))
        return out

    ff._extract_plain = record
    try:
        ff.flat_topk_fused_plain(q, x, k, Dist.EUCLIDEAN, n_valid=n_valid, depth=depth,
                                 passes=6, block_db=block_db)
    finally:
        ff._extract_plain = rounds
    (vals, idx, qadd, kb, (d, i)), = seen
    assert vals.shape[1] == depth * ff.fused_shapes(300, k, block_db)[1]
    _same(network(vals, idx, qadd, kb), (d.numpy(), i.numpy()))


def test_flat_extract_on_the_cpu_is_the_rounds():
    rng = np.random.default_rng(3)
    vals, cols, qadd = _bins(rng, 6, 128, 16, "ties")
    before = ff.flat_extract.launches
    d, i = ff.flat_extract(torch.tensor(vals), torch.tensor(cols), torch.tensor(qadd), 16)
    _same((d.numpy(), i.numpy()), _rounds(vals, cols, qadd, 16))
    assert ff.flat_extract.launches == before


def test_sort_key_orders_as_lex_less():
    v = np.array([-1.5, -0.0, 0.0, 0.0, 2.0, BIG, np.inf], dtype=np.float32)
    c = np.array([9, 4, 3, 5, 0, 0, 2**31 - 1], dtype=np.int32)
    k = _sort_key(v, c)
    assert list(np.argsort(k, kind="stable")) == [0, 2, 1, 3, 4, 5, 6]
    assert k[-1] == PAD
    np.testing.assert_array_equal(_key_value(k[[0, 4, 5]]), v[[0, 4, 5]])
