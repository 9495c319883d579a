"""Running top-k over database tiles (port of ``annsearch_tpu.ops.topk``).

Queries stream through in blocks, the database in chunks, so ``[nq, n]``
is never materialised. ``blocked_query_topk`` selects by one of

* ``"exact"``: each chunk's local top-k merges into a running ``[bq, k]``
  (distance, index) state;
* ``"approx"``: the same scan. The JAX package takes ``lax.approx_min_k``
  for the per-tile selection there; the port has no approximate per-tile
  selection and keeps the exact one, as its cluster scan does;
* ``"bins"``: :func:`chunked_topk_bins`, the running-bins scan in tensor
  operations (the JAX function reaches no kernel either);
* ``"fused"``: kernel K2, ``ops.flat_scan_fused.flat_topk_fused`` (the
  kernel on a CUDA tensor, its plain version on a CPU tensor);
* ``"certified"``: the exact answer from K2 and a certificate
  (:func:`_certified_topk`): K2 at f32 grade for ``k + 1`` ranks, and an
  exact rescan of the column classes where K2 may have dropped a true
  neighbour.

All results are ascending; ties go to the lower index, as ``lax.top_k``
breaks them. Rows at or past ``n_valid`` never win.
"""

from __future__ import annotations

import torch

from ..utils import profiling
from ..utils.dist import Dist, pairwise_dist, sq_norms

__all__ = [
    "topk_smallest",
    "merge_topk",
    "chunked_topk",
    "chunked_topk_bins",
    "blocked_query_topk",
    "DEFAULT_DB_CHUNK",
    "DEFAULT_QUERY_BLOCK",
]

DEFAULT_DB_CHUNK = 16384
DEFAULT_QUERY_BLOCK = 1024


#: ``topk_smallest`` selects by keyed ``torch.topk`` from rows this wide (and
#: at least 8k), by a stable sort below: on the H100 the sort is faster up
#: to rows of 4,096 and the keyed route from 8,192 (``chip_smoke.py`` phase 17)
KEYED_MIN_WIDTH = 8192


def topk_smallest(d: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k smallest along the last axis, ascending, ties to the
    lower index (``lax.top_k``'s order; ``torch.topk`` alone promises no
    tie order). Returns (vals, idx). f32 rows of ``KEYED_MIN_WIDTH`` or more
    take :func:`_topk_keyed`, the rest a stable sort; both give the same
    answer."""
    if d.dtype == torch.float32 and max(KEYED_MIN_WIDTH, 8 * k) <= d.shape[-1] < 2**31:
        return _topk_keyed(d, k)
    return _topk_sorted(d, k)


def _topk_sorted(d: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    vals, idx = torch.sort(d, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def _topk_keyed(d: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``torch.topk`` over one int64 per value: its order-preserving 32-bit
    key above its column, so every key is distinct and equal values come
    out by column without a full sort. ``-0.0`` counts as ``0.0``; every
    NaN takes the largest key, after ``inf``, as the sort places it."""
    b = (d + 0.0).view(torch.int32)                  # -0.0 + 0.0 = +0.0
    key = torch.where(b < 0, b ^ 0x7FFFFFFF, b)
    key = torch.where(torch.isnan(d), 0x7FFFFFFF, key).long()
    col = torch.arange(d.shape[-1], device=d.device)
    _, idx = torch.topk((key << 32) | col, k, dim=-1, largest=False, sorted=True)
    return torch.gather(d, -1, idx), idx


def merge_topk(d_a, i_a, d_b, i_b, k: int):
    """Merge two (dists, idx) top-k sets along the last axis → best k."""
    vals, pos = topk_smallest(torch.cat([d_a, d_b], dim=-1), k)
    return vals, torch.gather(torch.cat([i_a, i_b], dim=-1), -1, pos)


def chunked_topk(
    q: torch.Tensor,
    x: torch.Tensor,
    k: int,
    metric: Dist,
    x_sqnorm: torch.Tensor | None = None,
    n_valid: int | None = None,
    db_chunk: int = DEFAULT_DB_CHUNK,
    precision: str = "highest",
    approx: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k nearest rows of ``x`` for one query block; ``(dists [bq, k],
    indices [bq, k])`` ascending. Rows at or past ``n_valid`` are padding:
    their distance is +inf. ``approx`` (the JAX package's ``approx_min_k``
    per-tile selection) is accepted and ignored: the selection is exact."""
    del approx
    n = x.shape[0]
    n_valid = n if n_valid is None else n_valid
    if metric == Dist.EUCLIDEAN and x_sqnorm is None:
        x_sqnorm = sq_norms(x)
    bq = q.shape[0]
    best_d = torch.full((bq, k), float("inf"), device=q.device)
    best_i = torch.zeros((bq, k), dtype=torch.int64, device=q.device)
    for base in range(0, n, db_chunk):
        xc = x[base : base + db_chunk]
        xs = None if x_sqnorm is None else x_sqnorm[base : base + db_chunk]
        d = pairwise_dist(q, xc, metric, x_sqnorm=xs, precision=precision)
        if base + xc.shape[0] > n_valid:
            col = base + torch.arange(xc.shape[0], device=q.device)
            d = torch.where(col < n_valid, d, float("inf"))
        # per-chunk selection: torch.topk is far cheaper than a full sort of
        # the chunk; the tie order it leaves matters only for exact ties
        # at the chunk's k-th rank
        kk = min(k, xc.shape[0])
        cd, ci = torch.topk(d, kk, dim=-1, largest=False, sorted=True)
        best_d, best_i = merge_topk(best_d, best_i, cd, base + ci, k)
    return best_d, best_i


def chunked_topk_bins(
    q: torch.Tensor,
    x: torch.Tensor,
    k: int,
    metric: Dist,
    x_sqnorm: torch.Tensor | None = None,
    n_valid: int | None = None,
    bins: int = 4096,
    precision: str = "highest",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Selection-free running top-k for one query block: the database is
    scanned in tiles of width ``bins``; column class ``col mod bins`` keeps
    its best two distances by an elementwise min-update (strict ``<``, so
    of equal distances the earlier column stays), and one final exact
    top-k over the ``[bq, 2·bins]`` survivors gives the answer. A true
    top-k entry is lost only when three or more of the top-k share a
    class."""
    n = x.shape[0]
    n_valid = n if n_valid is None else n_valid
    if metric == Dist.EUCLIDEAN and x_sqnorm is None:
        x_sqnorm = sq_norms(x)
    bins = min(bins, max(128, n))
    bq, dev, inf = q.shape[0], q.device, float("inf")
    m1 = torch.full((bq, bins), inf, device=dev)
    m2 = m1.clone()
    i1 = torch.zeros((bq, bins), dtype=torch.int64, device=dev)
    i2 = i1.clone()
    lane = torch.arange(bins, device=dev)
    for base in range(0, n, bins):
        xc = x[base : base + bins]
        w = xc.shape[0]      # a short last tile: its missing columns never win
        xs = None if x_sqnorm is None else x_sqnorm[base : base + w]
        d = pairwise_dist(q, xc, metric, x_sqnorm=xs, precision=precision)
        col = (base + lane[:w]).expand_as(d)
        d = torch.where(col < n_valid, d, inf)
        a1, j1, a2 = m1[:, :w], i1[:, :w], m2[:, :w]
        b1 = d < a1
        spill = torch.where(b1, a1, d)          # displaced or non-best value
        spi = torch.where(b1, j1, col)
        b2 = spill < a2
        i2[:, :w] = torch.where(b2, spi, i2[:, :w])
        m2[:, :w] = torch.where(b2, spill, a2)
        i1[:, :w] = torch.where(b1, col, j1)
        m1[:, :w] = torch.where(b1, d, a1)
    all_d = torch.cat([m1, m2], dim=1)
    vals, pos = topk_smallest(all_d, min(k, all_d.shape[1]))
    return vals, torch.gather(torch.cat([i1, i2], dim=1), 1, pos)


#: ``selector="fused"`` passes (the grade of K2's dots) by precision
_FUSED_PASSES = {"highest": 6, "high": 3}

#: bytes of gathered rows a step of the certified rescan holds: colliding
#: queries go through in groups whose candidates' rows fit
_RESCAN_BYTES = 256 * 1024 * 1024


def _colliding_pairs(ids: torch.Tensor, B: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(rows [P], classes [P])``: each (query, class) pair where two or
    more of a row of ``ids`` share the class ``col mod B``, once, in row
    order."""
    cls, _ = torch.sort(ids % B, dim=1)
    same = cls[:, 1:] == cls[:, :-1]
    first = same.clone()
    first[:, 1:] &= ~same[:, :-1]
    r, j = first.nonzero(as_tuple=True)
    return r, cls[r, j + 1]


def _rescan(q, x, k, metric, x_sqnorm, n_valid: int, B: int, ids, rows, classes):
    """The exact top-k of the queries ``rows`` (ascending, repeated per
    class) over their candidates: their K2 ids ``ids [nq, k+1]`` and every
    row below ``n_valid`` of each colliding class ``classes``, scored
    together in fp32 (one distance matrix per group of queries), each id
    once, ties to the lower id. ``(queries [R], dists [R, k], ids [R,
    k])``."""
    dev, n = q.device, x.shape[0]
    uq, inv, counts = torch.unique_consecutive(rows, return_inverse=True, return_counts=True)
    R, cmax = uq.numel(), int(counts.max())
    slot = torch.arange(rows.numel(), device=dev) - (torch.cumsum(counts, 0) - counts)[inv]
    pcls = torch.full((R, cmax), -1, dtype=torch.long, device=dev)
    pcls[inv, slot] = classes
    # every row of each colliding class (n marks no row), then K2's ids
    # outside those classes
    members = pcls[:, :, None] + B * torch.arange(-(-n_valid // B), device=dev)
    members = torch.where((pcls[:, :, None] >= 0) & (members < n_valid), members, n)
    own = ids[uq]
    own = torch.where(((own % B)[:, :, None] == pcls[:, None, :]).any(-1), n, own)
    cand, _ = torch.sort(torch.cat([own, members.view(R, -1)], dim=1), dim=1)
    g = max(1, _RESCAN_BYTES // (cand.shape[1] * x.shape[1] * 4))
    out_d = torch.empty((R, k), device=dev)
    out_i = torch.empty((R, k), dtype=torch.long, device=dev)
    for s in range(0, R, g):
        c = cand[s : s + g]
        valid = c < n
        safe = torch.where(valid, c, 0)
        xs = None if x_sqnorm is None else x_sqnorm[safe]
        d = pairwise_dist(q[uq[s : s + g], None, :], x[safe], metric, x_sqnorm=xs,
                          precision="highest")[:, 0]
        vals, pos = topk_smallest(torch.where(valid, d, float("inf")), k)
        out_d[s : s + g], out_i[s : s + g] = vals, torch.gather(c, 1, pos)
    return uq, out_d, out_i


def _certified_topk(
    q: torch.Tensor,
    x: torch.Tensor,
    k: int,
    metric: Dist,
    x_sqnorm: torch.Tensor | None = None,
    n_valid: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The exact top-k at f32 grade from one K2 scan and a certificate;
    ``k + 1`` at most K2's 128 ranks and at most ``n_valid``.

    K2 (``passes=6``, depth 2) keeps of each column class ``col mod B`` the
    best two rows in the order of ``(score, col)``, as the sequential scan
    keeps them, exact ties included, and extracts the first ``k + 1`` of
    those bins in the same order. A row K2 dropped ranks after both bins of
    its class; had it been among the true top k, both bins would be too,
    and so among K2's first k. So where no class holds two of a query's
    first k ids, they are the exact answer, ties at the k-th rank included.
    A query where some class does is rescanned: every row of each such
    class and K2's ``k + 1`` candidates, scored together in fp32
    (:func:`pairwise_dist`, TF32 off), and the top k taken by
    :func:`topk_smallest`, ties to the lower id. With ``n ≤ B`` every
    column is its own class and nothing is rescanned. Stage
    ``topk.certified``, counts ``queries`` and ``rescanned`` (queries with
    a colliding class). Result as ``"exact"``'s: ``(dists [nq, k], ids
    [nq, k] int64)``."""
    from .flat_scan_fused import flat_topk_fused, fused_shapes

    n = x.shape[0]
    nv = n if n_valid is None else max(0, min(int(n_valid), n))
    if metric == Dist.EUCLIDEAN and x_sqnorm is None:
        x_sqnorm = sq_norms(x)
    with profiling.stage("topk.certified", q) as st:
        d, i = flat_topk_fused(q, x, k + 1, metric, x_sqnorm=x_sqnorm, n_valid=nv, passes=6)
        best_d, best_i = d[:, :k].contiguous(), i[:, :k].contiguous()
        B = fused_shapes(n, k + 1)[1]
        rescanned = 0
        if n > B:
            rows, classes = _colliding_pairs(best_i, B)
            if rows.numel():
                redo, rd, ri = _rescan(q, x, k, metric, x_sqnorm, nv, B, i, rows, classes)
                best_d[redo], best_i[redo] = rd, ri
                rescanned = redo.numel()
        if st:
            st.count(queries=q.shape[0], rescanned=rescanned)
    return best_d, best_i


def blocked_query_topk(
    q: torch.Tensor,
    x: torch.Tensor,
    k: int,
    metric: Dist,
    x_sqnorm: torch.Tensor | None = None,
    n_valid: int | None = None,
    query_block: int = DEFAULT_QUERY_BLOCK,
    db_chunk: int = DEFAULT_DB_CHUNK,
    precision: str = "highest",
    approx: bool = False,
    selector: str = "exact",   # "exact" | "approx" | "bins" | "fused" | "certified"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k for any number of queries, streamed in query blocks; see the
    module docstring for the selectors.

    ``selector="fused"`` with ``k > 64`` takes ``"bins"``: the JAX package
    made that rule because the TPU compiler could not build the kernel's
    unrolled extraction at ``kb = 128``; the port keeps it, since it fixes
    which selection a caller gets. Under ``"fused"``, ``precision`` sets
    the grade of the dots: ``"highest"`` → ``passes=6``, ``"high"`` → 3,
    anything else → 1 (bf16 operands). ``"certified"``
    (:func:`_certified_topk`) takes ``"exact"`` where ``k + 1`` passes K2's
    128 ranks or the ``n_valid`` rows; it and ``"exact"`` take only
    ``precision="highest"``. ``approx`` is accepted and ignored, as in
    :func:`chunked_topk`. The selectors but ``"fused"`` and ``"certified"``
    are stage ``topk.exact``, whose count ``steps`` is the (query block,
    database chunk) steps."""
    del approx
    if selector not in ("exact", "approx", "bins", "fused", "certified"):
        raise ValueError(f"unknown selector {selector!r}")
    if selector == "fused" and k > 64:
        selector = "bins"
    if selector == "certified":
        if precision != "highest":
            raise ValueError(f"precision must be 'highest', got {precision!r}")
        nv = x.shape[0] if n_valid is None else n_valid
        if k + 1 > min(nv, 128):
            selector = "exact"
        else:
            return _certified_topk(q, x, k, metric, x_sqnorm=x_sqnorm, n_valid=n_valid)
    if selector == "fused":
        from .flat_scan_fused import flat_topk_fused

        return flat_topk_fused(
            q, x, k, metric, x_sqnorm=x_sqnorm, n_valid=n_valid,
            passes=_FUSED_PASSES.get(precision, 1),
        )
    with profiling.stage("topk.exact", q) as st:
        if st:
            n = x.shape[0]
            chunk = min(db_chunk, 2048, max(128, n)) if selector == "bins" else db_chunk
            st.count(steps=-(-q.shape[0] // query_block) * -(-n // chunk))
        parts = []
        for s in range(0, q.shape[0], query_block):
            block = q[s : s + query_block]
            if selector == "bins":
                parts.append(chunked_topk_bins(
                    block, x, k, metric, x_sqnorm=x_sqnorm, n_valid=n_valid,
                    bins=min(db_chunk, 2048), precision=precision,
                ))
            else:
                parts.append(chunked_topk(
                    block, x, k, metric, x_sqnorm=x_sqnorm, n_valid=n_valid,
                    db_chunk=db_chunk, precision=precision,
                ))
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
