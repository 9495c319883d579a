"""K1's exact selection as the card runs it, emulated in numpy, against the
kb rounds it replaced and against the plain version, bit for bit.

``csrc/ivf_scan.cu`` keeps each query slot's kb smallest (value, lane)
pairs as a sorted list of 64-bit keys (``exact_key``: the value's
order-preserving bits above the lane shifted left by one, whose low bit
marks a -0). A chunk's epilogue writes its distances into a tile, an
entrant's value where the lane is valid, the value at most FLT_MAX and its
value bits at most those of the list's kb-th key as last merged (possibly
one merge behind), NaN elsewhere; the slot's warp merges the tile row
during the next chunk (``exact_merge``): the entrants rechecked against the
kb-th key, then one a lane (up to 32 / ⌈kb / 32⌉: each placed by counting
the list's keys and the other entrants below it, the list's keys moved up
by the entrants below them) or a bitonic sort of the chunk's 128 keys
merged with the list read backwards. The emulation follows the warp lane by lane (a
ballot is a mask, a shuffle an index permutation of the lane axis).

The rounds are the selection before it (one warp-wide lexicographic arg-min
of (value, lane) after another, with the ballot skip), emulated likewise.
"""

import numpy as np
import pytest
import torch

from annsearch_tpu_torch.ops import ivf_scan_fused as tsf

LANES = 128
BIG = np.float32(3e38)
FMAX = np.float32(np.finfo(np.float32).max)
INT_MAX = 2**31 - 1
EMPTY = np.uint64(0xFF7FFFFFFFFFFFFE)       # exact_key(FLT_MAX, INT_MAX)
LANE = np.arange(32)[:, None]
UNIT = np.arange(4)[None, :]
U32 = np.uint64(0xFFFFFFFF)


def _key(v, lane):
    """``exact_key``."""
    b = np.asarray(v, dtype=np.float32).view(np.uint32).astype(np.uint64)
    neg0 = b == np.uint64(0x80000000)
    b = np.where(neg0, np.uint64(0), b)
    b = np.where(b >> np.uint64(31) == 1, b ^ U32, b ^ np.uint64(0x80000000))
    return (b << np.uint64(32)) | (np.asarray(lane).astype(np.uint64) << np.uint64(1)) \
        | neg0.astype(np.uint64)


def _value(k):
    """``exact_value``."""
    b = k >> np.uint64(32)
    b = np.where(b >> np.uint64(31) == 1, b ^ np.uint64(0x80000000), b ^ U32)
    v = b.astype(np.uint32).view(np.float32)
    return np.where(k & np.uint64(1) == 1, np.float32(-0.0), v)


def _stage(x, K, J):
    """``bitonic_stage<1, K, J>`` on x [32 lanes, 4]."""
    if J < 4:
        up = ((4 * LANE + UNIT) & K) == 0
        out = x.copy()
        for u in range(4):
            if u & J:
                continue
            a, b = x[:, u], x[:, u | J]
            keep = (a < b) == up[:, u]
            out[:, u] = np.where(keep, a, b)
            out[:, u | J] = np.where(keep, b, a)
        return out
    up = ((4 * LANE) & K) == 0
    keep_min = ((LANE & (J // 4)) == 0) == up
    other = x[LANE[:, 0] ^ (J // 4)]                 # __shfl_xor_sync
    return np.where((x < other) == keep_min, x, other)


def _merge_net(x, K, J):
    while J >= 1:
        x = _stage(x, K, J)
        J //= 2
    return x


def _sort_net(x):
    k = 2
    while k <= LANES:
        x = _merge_net(x, k, k // 2)
        k *= 2
    return x


def exact_merge(row, lbase, lst, kb, seen):
    """``exact_merge`` on one slot's tile row [128] and its list [kb] of
    keys: the new list. Records each merge's entrant count in ``seen``."""
    v = row.reshape(32, 4)                           # lane l, element u: 4 l + u
    x = _key(v, lbase + 4 * LANE + UNIT)
    with np.errstate(invalid="ignore"):
        inn = (v <= FMAX) & (x < lst[kb - 1])        # NaN: no entrant
    n = int(inn.sum())
    seen.append(n)
    if n == 0:
        return lst
    if n * -(-kb // 32) > 32:                       # the sort; else one a lane
        y = _sort_net(np.where(inn, x, EMPTY))
        r = LANES - 1 - (4 * LANE + UNIT)
        y = np.minimum(y, np.where(r < kb, lst[np.minimum(r, kb - 1)], EMPTY))
        y = _merge_net(y, 2 * LANES, LANES // 2)
        return y.reshape(-1)[:kb].copy()
    ecomp = x[inn]                                   # compacted in (lane, element) order
    e = np.full(32, EMPTY)
    e[:n] = ecomp
    p = LANE + 32 * UNIT                             # list entry p of lane l, element u
    lk = np.where(p < kb, lst[np.minimum(p, kb - 1)], EMPTY)
    up = (ecomp[None, None, :] < lk[:, :, None]).sum(-1)
    rank = (ecomp[None, :] < e[:, None]).sum(-1)
    below = np.array([int((lk < ej).sum()) for ej in ecomp], dtype=np.int64)
    out = np.zeros(kb, dtype=np.uint64)
    hits = np.zeros(kb, dtype=np.int64)
    for j in range(n):
        if below[j] + rank[j] < kb:
            out[below[j] + rank[j]] = e[j]
            hits[below[j] + rank[j]] += 1
    dest = p + up
    keep = (p < kb) & (dest < kb)
    out[dest[keep]] = lk[keep]
    np.add.at(hits, dest[keep], 1)
    assert (hits == 1).all(), "the new positions are not a permutation"
    return out


def kernel(vals, n_valid, kb, stale=False, seen=None):
    """The exact selection of ``csrc/ivf_scan.cu`` over one task row:
    ``vals [S, seg]`` the distances of S slots (lanes at or past
    ``n_valid`` are never read). With ``stale``, each chunk is filtered by
    the list as it stood one merge earlier (the merge that runs beside the
    chunk's products may not have reached it). Returns (d, i) [S, kb]."""
    S, seg = vals.shape
    seen = [] if seen is None else seen
    lists = [np.full(kb, EMPTY) for _ in range(S)]
    older = [lst.copy() for lst in lists]
    pending = None
    for c in range(-(-n_valid // LANES)):
        if pending is not None:                      # chunk c - 1 merged beside chunk c
            older = [lst.copy() for lst in lists]
            lists = [exact_merge(pending[s], (c - 1) * LANES, lists[s], kb, seen)
                     for s in range(S)]
        lane = c * LANES + np.arange(LANES)
        v = vals[:, c * LANES : (c + 1) * LANES]
        thr = np.array([(lst if not stale else old)[kb - 1] >> np.uint64(32)
                        for lst, old in zip(lists, older)])
        with np.errstate(invalid="ignore"):
            ok = (lane < n_valid) & (v <= FMAX) & ((_key(v, lane) >> np.uint64(32))
                                                   <= thr[:, None])
        pending = np.where(ok, v, np.float32(np.nan))
    if pending is not None:
        lists = [exact_merge(pending[s], (c) * LANES, lists[s], kb, seen) for s in range(S)]
    keys = np.stack(lists)
    real = keys != EMPTY
    d = np.where(real, _value(keys), BIG).astype(np.float32)
    i = np.where(real, (keys & U32) >> np.uint64(1), 0).astype(np.int32)
    return d, i


def _lex_less(va, ia, vb, ib):
    with np.errstate(invalid="ignore"):
        return (va < vb) | ((va == vb) & (ia < ib))


def rounds(vals, n_valid, kb):
    """The selection it replaced (``ivf_scan.cu`` before: sorted lists of
    128 (value, lane) entries, a ballot skip, then kb rounds of the
    warp-wide lexicographic arg-min over list and chunk)."""
    S, seg = vals.shape
    lv = np.full((S, LANES), FMAX, dtype=np.float32)
    li = np.full((S, LANES), INT_MAX, dtype=np.int64)
    lanes = LANE[:, 0]
    for c in range(-(-n_valid // LANES)):
        lane = c * LANES + np.arange(LANES)
        valid = lane < n_valid
        cv = np.where(valid, vals[:, c * LANES : (c + 1) * LANES], FMAX).astype(np.float32)
        ci = np.broadcast_to(np.where(valid, lane, INT_MAX), cv.shape)
        beats = _lex_less(cv, ci, lv[:, kb - 1 : kb], li[:, kb - 1 : kb]).any(1)
        for s in np.flatnonzero(beats):
            # entry lane + 32 u of the list and of the tile row, at [lane, u]
            ev, ei = lv[s].reshape(4, 32).T.copy(), li[s].reshape(4, 32).T.copy()
            cvs, cis = cv[s].reshape(4, 32).T.copy(), ci[s].reshape(4, 32).T.copy()
            nv = np.full((32, 4), FMAX, dtype=np.float32)
            ni = np.full((32, 4), INT_MAX, dtype=np.int64)
            for t2 in range(kb):
                bv, bi = ev[:, 0].copy(), ei[:, 0].copy()
                for u in range(4):
                    for av, ai in ((ev[:, u], ei[:, u]), (cvs[:, u], cis[:, u])):
                        m = _lex_less(av, ai, bv, bi)
                        bv, bi = np.where(m, av, bv), np.where(m, ai, bi)
                for o in (16, 8, 4, 2, 1):
                    ov, oi = bv[lanes ^ o], bi[lanes ^ o]
                    m = _lex_less(ov, oi, bv, bi)
                    bv, bi = np.where(m, ov, bv), np.where(m, oi, bi)
                assert (bi == bi[0]).all()
                if bi[0] == INT_MAX:
                    break
                nv[t2 % 32, t2 // 32], ni[t2 % 32, t2 // 32] = bv[0], bi[0]
                hit = ei == bi[0]
                ev[hit], ei[hit] = FMAX, INT_MAX
                hit = cis == bi[0]
                cvs[hit], cis[hit] = FMAX, INT_MAX
            lv[s], li[s] = nv.T.reshape(-1), ni.T.reshape(-1)
    real = li[:, :kb] != INT_MAX
    return (np.where(real, lv[:, :kb], BIG).astype(np.float32),
            np.where(real, li[:, :kb], 0).astype(np.int32))


def plain(vals, n_valid, kb):
    """``ivf_scan_fused._exact_extract`` as the plain versions call it (lanes
    at or past ``cnt`` set to 3e38 first)."""
    seg = vals.shape[-1]
    dist = torch.where(torch.arange(seg) < n_valid, torch.tensor(vals), float(BIG))
    d, i = tsf._exact_extract(dist[None, None], kb, torch.tensor([n_valid], dtype=torch.int32))
    return d[0, 0].numpy(), i[0, 0].numpy()


def _same(a, b):
    (ad, ai), (bd, bi) = a, b
    np.testing.assert_array_equal(ad.view(np.uint32), bd.view(np.uint32))
    np.testing.assert_array_equal(ai, bi)


def _values(rng, case, S, seg):
    if case == "ties":
        return rng.integers(-6, 7, (S, seg)).astype(np.float32)
    if case == "zeros":        # ±0 among a few small integers
        v = rng.integers(-1, 2, (S, seg)).astype(np.float32)
        v[(v == 0) & (rng.random((S, seg)) < 0.5)] = np.float32(-0.0)
        return v
    if case == "equal":        # every lane the same distance
        return np.full((S, seg), np.float32(2.5))
    if case == "fltmax":       # FLT_MAX and 3e38 on valid lanes
        v = rng.integers(0, 40, (S, seg)).astype(np.float32)
        v[rng.random((S, seg)) < 0.3] = FMAX
        v[rng.random((S, seg)) < 0.05] = BIG
        return v
    # "gauss": distinct values, l2-like, first chunks worse than later ones
    return (rng.standard_normal((S, seg)) ** 2 * 100).astype(np.float32)


# (kb, chunks, case): every kb at 1, 2 and 9 chunks in every case; segments
# of 64 chunks at three kb
SEGMENTS = [(kb, c, case) for kb in (8, 16, 24, 64, 128) for c in (1, 2, 9)
            for case in ("gauss", "ties", "zeros", "equal", "fltmax")] + [
    (8, 64, "gauss"), (24, 64, "ties"), (128, 16, "gauss")]


@pytest.mark.parametrize("kb,chunks,case", SEGMENTS)
def test_merge_is_the_rounds_and_the_plain_version(kb, chunks, case):
    rng = np.random.default_rng(kb * 1000 + chunks * 10 + len(case))
    seg = chunks * LANES
    vals = _values(rng, case, 3, seg)
    # a full row, and one that is not a multiple of 128
    for n_valid in (seg, seg - 37 if seg > 37 else seg):
        got = kernel(vals, n_valid, kb)
        _same(got, kernel(vals, n_valid, kb, stale=True))
        _same(got, rounds(vals, n_valid, kb))
        for s in range(vals.shape[0]):
            _same((got[0][s], got[1][s]), plain(vals[s], n_valid, kb))


@pytest.mark.parametrize("kb", [8, 24, 128])
@pytest.mark.parametrize("m", [0, 1, 2, 31, 32, 33, 128])
def test_chunks_with_m_entrants(kb, m):
    """Chunk 0 fills the list (128 entrants, the sort), chunk 1 brings m
    keys below its kb-th (one a lane up to 32 / ⌈kb / 32⌉, more the sort),
    chunk 2 none."""
    rng = np.random.default_rng(m)
    vals = np.full((2, 3 * LANES), np.float32(5000.0))
    vals[:, :LANES] = 1000 + rng.permutation(LANES)
    for s in range(2):
        vals[s, LANES + rng.permutation(LANES)[:m]] = 500 + rng.permutation(m)
    seen = []
    got = kernel(vals, 3 * LANES, kb, seen=seen)
    assert seen == [LANES, LANES, m, m, 0, 0]
    _same(got, rounds(vals, 3 * LANES, kb))
    for s in range(2):
        _same((got[0][s], got[1][s]), plain(vals[s], 3 * LANES, kb))


@pytest.mark.parametrize("kb", [8, 24, 128])
def test_short_rows(kb):
    """Rows of 0, 1, kb − 1, kb and 200 valid lanes: the slots past them are
    (3e38, 0); a row of none is (3e38, 0) throughout (the kernel's early
    exit writes the same)."""
    rng = np.random.default_rng(kb)
    vals = rng.integers(0, 30, (3, 2 * LANES)).astype(np.float32)
    for n_valid in (0, 1, kb - 1, kb, 200):
        got = kernel(vals, n_valid, kb)
        _same(got, rounds(vals, n_valid, kb))
        for s in range(3):
            _same((got[0][s], got[1][s]), plain(vals[s], n_valid, kb))
        assert (got[0][:, n_valid:] == BIG).all() and (got[1][:, n_valid:] == 0).all()


@pytest.mark.parametrize("kb", [8, 24, 128])
@pytest.mark.parametrize("n_valid", [3 * LANES, 3 * LANES - 50])
def test_inf_and_nan_against_the_rounds(kb, n_valid):
    """inf and NaN distances on valid lanes never enter a list, -inf does;
    the kernel gives the rounds' result."""
    rng = np.random.default_rng(kb + n_valid)
    vals = rng.integers(-5, 20, (4, 3 * LANES)).astype(np.float32)
    for bad, share in ((np.inf, 0.2), (np.nan, 0.2), (-np.inf, 0.01), (FMAX, 0.1)):
        vals[rng.random(vals.shape) < share] = bad
    vals[3, :] = np.nan                        # a slot of NaN alone
    got = kernel(vals, n_valid, kb)
    _same(got, rounds(vals, n_valid, kb))
    _same(got, kernel(vals, n_valid, kb, stale=True))
    for s in range(vals.shape[0]):
        _same((got[0][s], got[1][s]), plain(vals[s], n_valid, kb))
    assert (got[0][3] == BIG).all() and (got[1][3] == 0).all()
    assert not np.isnan(got[0]).any() and not (got[0] == np.inf).any()


def test_plain_version_differs_past_flt_max_and_3e38():
    """F15, repaired: ``_exact_extract`` once sorted every valid lane, so a
    valid inf (or NaN) distance came out with its lane where the kernel, as
    the rounds before it, writes (3e38, 0), and a valid distance above 3e38
    ranked after the lanes past ``cnt``, which the plain version masks to
    3e38. It now follows the kernel's contract (the kb smallest over the
    valid lanes at most FLT_MAX, then (3e38, 0)) and agrees with it on
    both."""
    vals = np.array([[1.0, np.inf, 2.0, np.nan] + [7.0] * (LANES - 4)], dtype=np.float32)
    kd, ki = kernel(vals, LANES, LANES)
    _same((kd[0], ki[0]), plain(vals[0], LANES, LANES))
    np.testing.assert_array_equal(kd[0, 126:], [BIG, BIG])
    np.testing.assert_array_equal(ki[0, 126:], [0, 0])
    vals = np.array([[1.0, FMAX] + [7.0] * (LANES - 2)], dtype=np.float32)
    kd, ki = kernel(vals, 2, 3)
    _same((kd[0], ki[0]), plain(vals[0], 2, 3))
    np.testing.assert_array_equal(kd[0], [1.0, FMAX, BIG])
    np.testing.assert_array_equal(ki[0], [0, 1, 0])


def test_keys_order_as_lex_less_and_come_back():
    v = np.array([-np.inf, -1.5, -0.0, 0.0, 0.0, 2.0, BIG, FMAX], dtype=np.float32)
    lane = np.array([9, 4, 3, 5, 1, 0, 0, 7])
    k = _key(v, lane)
    assert list(np.argsort(k, kind="stable")) == [0, 1, 4, 2, 3, 5, 6, 7]
    assert (k < EMPTY).all() and _key(FMAX, INT_MAX) == EMPTY
    np.testing.assert_array_equal(_value(k).view(np.uint32), v.view(np.uint32))
    np.testing.assert_array_equal((k & U32) >> np.uint64(1), lane)
    assert _key(np.float32(np.inf), 0) > EMPTY
