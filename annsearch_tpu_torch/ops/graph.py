"""Graph kernels in tensor operations (port of ``annsearch_tpu.ops.graph``):
the approximate kNN-graph build, CAGRA detour pruning, sampled reverse
edges, occlusion pruning and the batched beam search. The JAX functions
reach no Pallas kernel, and neither do these.

Ported: ``_row_dedup_inf``, ``_merge_rows``, ``_next_pow2``,
``_tile_dists``, ``random_init_graph`` (split into the draw,
:func:`random_candidates`, and the scoring, :func:`score_candidates`),
``rp_forest_round``, ``leaf_join_merge``, ``kmeans_leaves``,
``_reverse_sample``, ``nnd_round``, ``nnd_round_chunked``,
``cagra_prune``, ``diversify_graph``, ``add_reverse_edges`` and
``beam_search`` with ``return_trail``. Not ported (ROADMAP, not to port):
``nav_hl_split``, ``pack_neighbor_table`` / ``maybe_pack_neighbors`` and
the bitonic networks, which are bf16 and DMA-granularity layouts of the
TPU. The port scores candidates in FP32 from the f32 table (TF32 off),
finer than the JAX package's two-way bf16 split, so the single-pass bf16
walk and its final f32 pool rescore are not needed either.

Random draws stay apart from the arithmetic: every function that draws
takes a ``torch.Generator`` and draws on the generator's device, and takes
the draw itself as an optional argument (``rev`` / ``rev2`` / ``noise``,
``proj`` / ``projs``, ``rand``, ``slot``), so a test can hand it the JAX
package's draws. torch cannot repeat JAX's key streams.

Graphs are ``int32`` (as the JAX package saves them); ids inside the beam
and the rounds are ``int64``. The sentinel id ``n`` marks an empty slot;
row ``n`` of ``vectors`` and of ``graph`` is the sentinel row.
"""

from __future__ import annotations

import torch

from ..utils.dist import Dist, fp32_matmul, sq_norms
from .topk import _topk_keyed, topk_smallest

__all__ = [
    "cagra_prune", "add_reverse_edges", "beam_search", "random_init_graph",
    "random_candidates", "score_candidates", "rp_forest_round",
    "leaf_join_merge", "kmeans_leaves", "nnd_round", "nnd_round_chunked",
    "nnd_draws", "nnd_cand_width", "diversify_graph",
    "NND_R_NEW", "NND_R_OLD", "NND_INPLACE_MIN_N",
]

_INF = float("inf")
_BIG = 1e30

#: default reverse-sample widths of :func:`nnd_round`: NEW-edge reverse
#: slots (hop blocks and sibling lists) and OLD-edge reverse slots (the
#: second half of two-sided new × old joins)
NND_R_NEW = 16
NND_R_OLD = 8

#: rows from which chunked NN-descent rounds merge IN PLACE (Gauss-Seidel);
#: see :func:`nnd_round_chunked`
NND_INPLACE_MIN_N = 8_000_000

#: bytes of the gathered ``[rows, C, d]`` member rows and ``[rows, C, C]``
#: distance and mask tiles one leaf block of :func:`leaf_join_merge` builds
_LEAF_BUDGET = 1 << 28
#: bytes of the ``[rows, nc]`` cell-distance tile of :func:`kmeans_leaves`
_CELL_BUDGET = 1 << 28
#: bytes of the [rows, C, C] pair masks one step of ``_merge_rows`` builds
_MERGE_BUDGET = 1 << 28
#: bytes of the gathered [rows, kk, d] rows and [rows, kk, kk] pair masks
#: one step of ``score_candidates`` builds
_SCORE_BUDGET = 1 << 28


def _next_pow2(v: int) -> int:
    return 1 << max(v - 1, 0).bit_length()


def _row_dedup_inf(ids: torch.Tensor, dists: torch.Tensor) -> torch.Tensor:
    """``dists`` with +inf at every id that already stands earlier in its
    row (the first copy keeps its distance). ``ids`` / ``dists``:
    ``[..., C]``. Narrow rows compare all pairs; wide rows sort."""
    C = ids.shape[-1]
    if C <= 128:
        earlier = torch.ones((C, C), dtype=torch.bool, device=ids.device).tril(-1)
        dup = ((ids[..., None, :] == ids[..., :, None]) & earlier).any(dim=-1)
        return torch.where(dup, _INF, dists)
    sorted_ids, order = torch.sort(ids, dim=-1, stable=True)
    dup_sorted = torch.zeros_like(sorted_ids, dtype=torch.bool)
    dup_sorted[..., 1:] = sorted_ids[..., 1:] == sorted_ids[..., :-1]
    dup = torch.zeros_like(dup_sorted).scatter_(-1, order, dup_sorted)
    return torch.where(dup, _INF, dists)


def _merge_rows(ids_a, d_a, ids_b, d_b, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge two candidate row sets ``[n, ka]`` and ``[n, kb]``: duplicate
    ids keep their first copy, and the ``k`` smallest stay, ascending, ties
    to the earlier column (as ``lax.top_k`` breaks them). Returns ``(ids
    [n, k]``, in the dtype of ``ids_a``, ``dists [n, k])``. Rows go through
    in steps that keep the dedup's pair masks within ``_MERGE_BUDGET``."""
    C = ids_a.shape[-1] + ids_b.shape[-1]
    step = max(1, _MERGE_BUDGET // (C * C))
    out_i, out_d = [], []
    for r in range(0, ids_a.shape[0], step):
        ids = torch.cat([ids_a[r : r + step], ids_b[r : r + step].to(ids_a.dtype)], dim=-1)
        d = _row_dedup_inf(ids, torch.cat([d_a[r : r + step], d_b[r : r + step]], dim=-1))
        vals, pos = torch.sort(d, dim=-1, stable=True)
        out_i.append(torch.gather(ids, -1, pos[:, :k]))
        out_d.append(vals[:, :k])
    return torch.cat(out_i), torch.cat(out_d)


def _pair_dists(nv: torch.Tensor, nsq: torch.Tensor, metric: Dist) -> torch.Tensor:
    """All-pairs distances ``[t, kk, kk]`` within each row's neighbour set
    (FP32 dots; the JAX package sums three bf16 split terms)."""
    with fp32_matmul():
        dots = torch.bmm(nv, nv.transpose(1, 2))
    if metric == Dist.COSINE:
        return 1.0 - dots
    return torch.clamp(nsq[:, :, None] + nsq[:, None, :] - 2.0 * dots, min=0.0)


def cagra_prune(
    vectors: torch.Tensor,      # [n+1, d]
    sqnorms: torch.Tensor,      # [n+1]
    graph_ids: torch.Tensor,    # [n, kk] ascending by distance
    graph_dists: torch.Tensor,  # [n, kk]
    out_deg: int,
    metric: Dist,
    tile: int = 4096,
) -> torch.Tensor:
    """Rank-based detour pruning: edge (u→v) is detourable when some closer
    neighbour w of u has d(w, v) < d(u, v). The first ``out_deg`` survivors
    stay, in rank order, backfilled with the best pruned edges. Returns
    ``[n, out_deg]`` int32. ``tile`` rows go through at a time; it changes
    no result."""
    n, kk = graph_ids.shape
    dev = graph_ids.device
    rank = torch.arange(kk, device=dev)
    rank_lt = rank[:, None] < rank[None, :]          # [w, v]
    out = torch.empty((n, out_deg), dtype=torch.int32, device=dev)
    for u0 in range(0, n, tile):
        nbrs = graph_ids[u0 : u0 + tile].long()
        nd = graph_dists[u0 : u0 + tile]
        safe = torch.clamp(nbrs, max=n)
        pair = _pair_dists(vectors[safe], sqnorms[safe], metric)
        closer = pair < nd[:, None, :]
        invalid = nbrs >= n
        detour = (rank_lt & closer & ~invalid[:, :, None]).any(dim=1) | invalid
        # distinct keys: survivors in rank order, then the pruned in rank order
        keep_key = detour.float() * 1e6 + rank
        order = torch.argsort(keep_key, dim=-1)[:, :out_deg]
        out[u0 : u0 + tile] = torch.gather(nbrs, 1, order).int()
    return out


def _reverse_sample(
    gen: torch.Generator, graph_ids: torch.Tensor, n: int, r_slots: int,
    new_in: torch.Tensor | None = None, invert: bool = False,
    slot: torch.Tensor | None = None,
) -> torch.Tensor:
    """``[n, r_slots]`` reverse-neighbour sample: each edge (u→v) is
    scattered into a random slot of v's reverse list; empty slots hold
    ``n``. ``new_in [n, kk]`` filters the edges: the NEW ones only, or with
    ``invert`` the OLD edges of rows that hold at least one new edge (the
    old-edge reverse channel of :func:`nnd_round`). Where several edges
    draw one slot, the JAX package keeps the last write of its backend;
    here the edge with the largest position ``u·kk + column`` wins, so
    one draw gives one table on every device. ``slot`` (``[n·kk]`` in
    ``[0, r_slots)``) is the draw; without it the slots are drawn from
    ``gen`` on its device."""
    kk = graph_ids.shape[1]
    dev = graph_ids.device
    if slot is None:
        slot = torch.randint(0, r_slots, (n * kk,), generator=gen, device=gen.device)
    g = graph_ids[:n].long()
    keep = g < n
    if new_in is not None:
        keep &= (~new_in & new_in.any(dim=1, keepdim=True)) if invert else new_in
    # only the kept edges are scattered: routed to a dump row instead, the
    # filtered ones (most of a late round's) would all contend for its slots
    pos = torch.nonzero(keep.reshape(-1)).squeeze(1)
    key = g.reshape(-1)[pos] * r_slots + slot.to(dev).long()[pos]
    winner = torch.full((n * r_slots,), -1, dtype=torch.long, device=dev)
    winner.scatter_reduce_(0, key, pos, "amax")
    rev = torch.where(winner >= 0, winner // kk, n)
    return rev.reshape(n, r_slots).int()


def add_reverse_edges(
    gen: torch.Generator, graph: torch.Tensor, n: int, extra: int
) -> torch.Tensor:
    """``graph [n, deg]`` with ``extra`` sampled reverse edges appended per
    node: ``[n, deg + extra]`` int32. Duplicate and self entries are left
    in (the beam de-duplicates)."""
    return torch.cat([graph.int(), _reverse_sample(gen, graph, n, extra)], dim=1)


def beam_search(
    q: torch.Tensor,           # [bq, d]
    vectors: torch.Tensor,     # [n+1, d] (sentinel row n)
    sqnorms: torch.Tensor,     # [n+1]
    graph: torch.Tensor,       # [n+1, deg] (sentinel row n)
    entries: torch.Tensor,     # [bq, e0] entry node ids
    k: int,
    beam: int,
    iters: int,
    metric: Dist,
    expand: int = 2,
    vectors_hl=None,
    packed_nbrs=None,
    return_trail: bool = False,
):
    """Batched greedy beam search of at most ``iters`` iterations.

    The beam is kept sorted ascending at width ``P = pow2(beam)`` with the
    lanes at or past ``beam`` parked at ``(inf, n, expanded)``, so the kept
    set is the best ``beam`` seen. An iteration selects the first
    ``expand`` unexpanded lanes, gathers their neighbours, scores them in
    FP32, masks those already in the beam, de-duplicates keeping the first
    copy, and merges them into the beam by a stable sort (of equal
    distances the beam's entry stays ahead). Sentinels ``(inf, n)`` count
    as expanded; the loop ends early once every lane is expanded.

    Returns ``(dists [bq, k], ids [bq, k])`` ascending; unreached slots
    have id ``n`` and distance inf. With ``return_trail`` it runs all
    ``iters`` iterations and also returns ``(trail_d, trail_ids)`` of shape
    ``[bq, iters·expand]``: every node the walk expanded, with its
    distance (``n`` / inf for exhausted slots).

    ``vectors_hl`` and ``packed_nbrs`` hold the JAX package's places for
    its TPU layouts (bf16 hi/lo rows, a packed neighbour table: ROADMAP,
    "Not to port"); they are accepted and ignored, and the walk scores the
    f32 rows."""
    del vectors_hl, packed_nbrs
    bq = q.shape[0]
    n = vectors.shape[0] - 1
    deg = graph.shape[1]
    dev = q.device
    C = expand * deg
    P = _next_pow2(beam)
    if k > P:
        raise ValueError(f"k={k} exceeds the beam's width {P}")
    q_sq = sq_norms(q)
    lane = torch.arange(P, device=dev)
    parked = lane >= beam

    def cand_dists(cand):
        safe = torch.clamp(cand, max=n)
        with fp32_matmul():
            dots = torch.bmm(vectors[safe], q[:, :, None])[:, :, 0]
        if metric == Dist.COSINE:
            d = 1.0 - dots
        else:
            d = torch.clamp(q_sq[:, None] + sqnorms[safe] - 2.0 * dots, min=0.0)
        return torch.where(cand >= n, _INF, d)

    def trim(d, ids, exp):
        return (torch.where(parked, _INF, d), torch.where(parked, n, ids), exp | parked)

    e0 = entries.shape[1]
    ids = torch.full((bq, P), n, dtype=torch.long, device=dev)
    ids[:, :e0] = entries.long()
    d = torch.where(lane < e0, cand_dists(ids), _INF)
    d = _row_dedup_inf(ids, d)
    d, order = torch.sort(d, dim=1, stable=True)
    ids = torch.gather(ids, 1, order)
    d, ids, exp = trim(d, ids, ids >= n)

    trail_ids, trail_d = [], []
    for _ in range(iters):
        if not return_trail and bool(exp.all()):
            break
        # the first `expand` unexpanded lanes of the sorted beam
        unexp = ~exp
        first = unexp & (torch.cumsum(unexp, dim=1) <= expand)
        sel_pos = torch.sort(torch.where(first, lane, P), dim=1).values[:, :expand]
        found = sel_pos < P
        at = torch.where(found, sel_pos, 0)
        sel_ids = torch.where(found, torch.gather(ids, 1, at), n)
        if return_trail:
            trail_ids.append(sel_ids)
            trail_d.append(torch.where(found, torch.gather(d, 1, at), _INF))
        exp = exp | first

        nbrs = graph[sel_ids].long().reshape(bq, C)
        nd = cand_dists(nbrs)
        in_beam = (nbrs[:, :, None] == ids[:, None, :]).any(dim=-1)
        nd = _row_dedup_inf(nbrs, torch.where(in_beam, _INF, nd))

        md, order = torch.sort(torch.cat([d, nd], dim=1), dim=1, stable=True)
        order = order[:, :P]
        d = md[:, :P]
        ids = torch.gather(torch.cat([ids, nbrs], dim=1), 1, order)
        exp = torch.gather(
            torch.cat([exp, torch.zeros_like(nbrs, dtype=torch.bool)], dim=1), 1, order)
        d, ids, exp = trim(d, ids, exp | (ids >= n) | torch.isinf(d))

    out = d[:, :k], ids[:, :k]
    if return_trail:
        return (*out, torch.cat(trail_d, dim=1), torch.cat(trail_ids, dim=1))
    return out


def random_candidates(gen: torch.Generator, n: int, kk: int, device) -> torch.Tensor:
    """``[n, kk]`` random node ids in ``[0, n)``, drawn from ``gen`` on its
    device and moved to ``device``: the draw of ``random_init_graph`` (the
    JAX package draws from its key stream, which torch cannot repeat; a
    test can hand that draw to :func:`score_candidates`)."""
    return torch.randint(0, n, (n, kk), generator=gen, device=gen.device).to(device)


def score_candidates(
    vectors: torch.Tensor,   # [n+1, d] (last row = sentinel zeros)
    sqnorms: torch.Tensor,   # [n+1]
    cand: torch.Tensor,      # [n, kk] candidate ids in [0, n)
    metric: Dist,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Each row's candidates with their true distances, ascending: ``(ids
    [n, kk] int32, dists [n, kk])``; the row itself and repeated ids are
    masked and come last as ``(n, inf)``. The dots are one FP32 product
    with TF32 off, finer than the two-way bf16 split of the JAX package's
    ``_tile_dists``. Rows go through in steps within ``_SCORE_BUDGET``."""
    n, kk = cand.shape
    tile = max(1, _SCORE_BUDGET // (kk * (4 * vectors.shape[1] + kk)))
    ids_out = torch.empty((n, kk), dtype=torch.int32, device=cand.device)
    d_out = torch.empty((n, kk), dtype=torch.float32, device=cand.device)
    for u0 in range(0, n, tile):
        c = cand[u0 : u0 + tile].long()
        u = torch.arange(u0, u0 + c.shape[0], device=c.device)
        with fp32_matmul():   # f32 grade (the JAX package: a two-way split)
            dots = torch.bmm(vectors[c], vectors[u][:, :, None])[:, :, 0]
        if metric == Dist.COSINE:
            d = 1.0 - dots
        else:
            d = torch.clamp(sqnorms[u][:, None] + sqnorms[c] - 2.0 * dots, min=0.0)
        d = _row_dedup_inf(c, torch.where(c == u[:, None], _INF, d))
        d, pos = torch.sort(d, dim=1, stable=True)
        ids = torch.gather(c, 1, pos)
        ids_out[u0 : u0 + tile] = torch.where(torch.isinf(d), n, ids).int()
        d_out[u0 : u0 + tile] = d
    return ids_out, d_out


def random_init_graph(
    gen: torch.Generator, vectors: torch.Tensor, sqnorms: torch.Tensor, kk: int, metric: Dist,
    tile: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor]:
    """A random ``kk``-NN graph with true distances (the JAX package's
    ``random_init_graph``): :func:`random_candidates` scored by
    :func:`score_candidates`. ``vectors [n+1, d]`` carries the sentinel
    row. ``tile`` (the JAX package's rows per ``lax.map`` step) is accepted
    and ignored: :func:`score_candidates` sets its own blocks."""
    del tile
    n = vectors.shape[0] - 1
    return score_candidates(
        vectors, sqnorms, random_candidates(gen, n, kk, vectors.device), metric)


# ---------------------------------------------------------------------------
# the approximate build: partition joins and NN-descent rounds
# ---------------------------------------------------------------------------


def _tile_dists(q_vecs, cand_vecs, q_sq, cand_sq, metric: Dist) -> torch.Tensor:
    """Distances ``[t, C]`` of each row ``q_vecs [t, d]`` to its candidates
    ``cand_vecs [t, C, d]``: one FP32 product with TF32 off (f32 grade;
    the JAX package sums three bf16 terms of a two-way split)."""
    with fp32_matmul():
        dots = torch.bmm(cand_vecs, q_vecs[:, :, None])[:, :, 0]
    if metric == Dist.COSINE:
        return 1.0 - dots
    return torch.clamp(q_sq[:, None] + cand_sq - 2.0 * dots, min=0.0)


def _lex_order(major: torch.Tensor, minor: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts by ``(major, minor)`` lexicographically:
    two stable sorts, minor key first. (A float composite ``major·BIG +
    minor`` loses the minor key to rounding: the JAX package records a
    1M build that stalled at recall 0.64 from one.)"""
    o1 = torch.sort(minor, stable=True).indices
    return o1[torch.sort(major[o1], stable=True).indices]


def rp_forest_round(
    gen: torch.Generator,
    vectors: torch.Tensor,      # [n+1, d]
    sqnorms: torch.Tensor,      # [n+1]
    graph_ids: torch.Tensor,    # [n, kk]
    graph_dists: torch.Tensor,  # [n, kk]
    levels: int,
    leaf: int,
    kk: int,
    metric: Dist,
    projs: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One random-projection tree pass merged into the graph: ``levels``
    rounds of a sort by (group, projection on a fresh normal vector), each
    halving the groups, give contiguous leaves of ``leaf`` rows, and
    :func:`leaf_join_merge` joins them. Sorting by projection inside a
    group is the median split, taken for all groups at once. ``projs
    [levels, d]`` is the draw; without it it is drawn from ``gen``."""
    n, d = graph_ids.shape[0], vectors.shape[1]
    dev = graph_ids.device
    if projs is None:
        projs = torch.randn((levels, d), generator=gen, device=gen.device)
    projs = projs.to(dev, torch.float32)
    n_pad = -(-n // leaf) * leaf
    ids = torch.arange(n_pad, device=dev)
    group = (ids >= n).long()                  # pads sort to the end
    for lv in range(levels):
        with fp32_matmul():
            proj = vectors[torch.clamp(ids, max=n)] @ projs[lv]
        proj = torch.where(ids < n, proj, _BIG)
        ids = ids[_lex_order(group, proj)]
        group = torch.arange(n_pad, device=dev) // max(n_pad // 2 ** (lv + 1), leaf)
    return leaf_join_merge(
        ids.reshape(-1, leaf), vectors, sqnorms, graph_ids, graph_dists, kk, metric)


def leaf_join_merge(
    leaves: torch.Tensor,       # [g, leaf] member ids (≥ n: pad)
    vectors: torch.Tensor,      # [n+1, d]
    sqnorms: torch.Tensor,      # [n+1]
    graph_ids: torch.Tensor,    # [n, kk]
    graph_dists: torch.Tensor,  # [n, kk]
    kk: int,
    metric: Dist,
) -> tuple[torch.Tensor, torch.Tensor]:
    """All pairs inside each leaf, merged into the members' graph rows:
    ``(ids [n, kk] int32, dists [n, kk])``. Each member pre-selects its
    best ``min(kk, leaf − 1)`` leaf mates before the merge (top-kk of the
    row and the leaf equals top-kk of the row and the leaf's top-kk).
    Leaves partition the rows, so no row is written twice; pad members are
    dropped, never clamped onto row n − 1. Blocks of leaves are sized by
    ``_LEAF_BUDGET``; they change no result."""
    n = graph_ids.shape[0]
    g, leaf = leaves.shape
    ksel = min(kk, leaf - 1)
    per_leaf = leaf * (4 * vectors.shape[1] + 24 * leaf + (kk + ksel) ** 2)
    bg = max(1, min(g, _LEAF_BUDGET // per_leaf))
    gi, gd = graph_ids.clone(), graph_dists.clone()
    for b in range(0, g, bg):
        _leaf_step(leaves[b : b + bg].long(), gi, gd, vectors, sqnorms, kk, ksel, metric)
    return gi, gd


def _leaf_step(lv, gi, gd, vectors, sqnorms, kk: int, ksel: int, metric: Dist) -> None:
    """One block of :func:`leaf_join_merge`, merged into ``gi`` / ``gd`` in
    place: the join as one FP32 batched product, the top-``ksel``
    pre-select, the merge into the members' rows."""
    n = gi.shape[0]
    leaf = lv.shape[1]
    safe = torch.clamp(lv, max=n)
    x = vectors[safe]                                   # [bg, leaf, d]
    sq = sqnorms[safe]
    with fp32_matmul():
        dots = torch.bmm(x, x.transpose(1, 2))
    if metric == Dist.COSINE:
        d = 1.0 - dots
    else:
        d = torch.clamp(sq[:, :, None] + sq[:, None, :] - 2.0 * dots, min=0.0)
    eye = torch.eye(leaf, dtype=torch.bool, device=lv.device)
    d = torch.where((lv[:, None, :] >= n) | (lv[:, :, None] >= n) | eye, _INF, d)
    nd, pos = topk_smallest(d, ksel)                    # [bg, leaf, ksel]
    cid = torch.gather(lv[:, None, :].expand(-1, leaf, -1), 2, pos)
    m = lv.reshape(-1)
    real = m < n
    m = m[real]
    new_ids, new_d = _merge_rows(gi[m], gd[m], cid.reshape(-1, ksel)[real],
                                 nd.reshape(-1, ksel)[real], kk)
    gi[m] = new_ids
    gd[m] = new_d


def kmeans_leaves(
    gen: torch.Generator,
    vectors: torch.Tensor,      # [n+1, d]
    centroids: torch.Tensor,    # [nc, d]
    jth: int,
    leaf: int,
    metric: Dist,
    proj: torch.Tensor | None = None,
) -> torch.Tensor:
    """Contiguous leaves ``[ceil(n / leaf), leaf]`` (pads ``≥ n`` at the
    tail) grouped by each row's (jth+1)-nearest k-means cell and ordered
    inside a cell by a random projection. Rotating ``jth`` across passes
    catches pairs on cell boundaries; the projection moves the leaf
    boundaries inside large cells.

    The cells are scored as the JAX package scores them, in one bf16 pass:
    rows and centroids rounded to bf16, then one FP32 product of the
    rounded values with TF32 off (each product exact, the sums f32; a bf16
    ``matmul`` would round its output to bf16). The (jth+1)-nearest cell
    is taken by ``jth`` masked argmin rounds. ``proj [d]`` is the draw;
    without it it is drawn from ``gen``."""
    n, d = vectors.shape[0] - 1, vectors.shape[1]
    dev = vectors.device
    nc = centroids.shape[0]
    j = min(jth, nc - 1)
    if proj is None:
        proj = torch.randn((d,), generator=gen, device=gen.device)
    proj = proj.to(dev, torch.float32)
    cb = centroids.to(torch.bfloat16).float()
    csq = sq_norms(centroids)
    tile = max(1, _CELL_BUDGET // (8 * nc))
    cells = torch.empty(n, dtype=torch.long, device=dev)
    projs = torch.empty(n, dtype=torch.float32, device=dev)
    for r in range(0, n, tile):
        x = vectors[r : min(r + tile, n)]
        with fp32_matmul():
            dots = x.to(torch.bfloat16).float() @ cb.T
            projs[r : r + x.shape[0]] = x @ proj
        dc = -dots if metric == Dist.COSINE else csq[None, :] - 2.0 * dots
        rows = torch.arange(x.shape[0], device=dev)
        for _ in range(j):
            dc[rows, torch.argmin(dc, dim=1)] = _INF
        cells[r : r + x.shape[0]] = torch.argmin(dc, dim=1)
    n_pad = -(-n // leaf) * leaf
    cellp = torch.cat([cells, torch.full((n_pad - n,), nc, dtype=torch.long, device=dev)])
    projp = torch.cat([projs, torch.full((n_pad - n,), _BIG, device=dev)])
    return _lex_order(cellp, projp).int().reshape(-1, leaf)


def nnd_cand_width(kk: int, c_active: int, r_slots: int = NND_R_NEW,
                   r_old: int = NND_R_OLD) -> int:
    """Candidates a row of a flagged :func:`nnd_round` scores: the width
    that sizes its row tile (``models.graph._nnd_tile``)."""
    base_w = kk + r_slots + r_old
    s_blk = max(1, min(c_active // kk, base_w))
    return s_blk * (kk + r_slots) + r_slots + r_old


def nnd_draws(
    gen: torch.Generator, graph_ids: torch.Tensor, new_in: torch.Tensor,
    r_slots: int = NND_R_NEW, r_old: int = NND_R_OLD,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The draws of one flagged round, in the order :func:`nnd_round` takes
    them: ``rev [n, r_slots]`` (the reverse sample of the new edges),
    ``rev2 [n, r_old]`` (of the old edges of rows with a new one) and the
    block-selection noise ``[n, kk + r_slots + r_old]``, uniform in [0, 1)
    and drawn per row, so a round's result does not depend on how its rows
    are split. On the generator's device; the tables move to the graph's."""
    n, kk = graph_ids.shape
    rev = _reverse_sample(gen, graph_ids, n, r_slots, new_in=new_in)
    rev2 = _reverse_sample(gen, graph_ids, n, r_old, new_in=new_in, invert=True)
    noise = torch.rand((n, kk + r_slots + r_old), generator=gen, device=gen.device)
    return rev, rev2, noise.to(graph_ids.device)


def nnd_round(
    gen: torch.Generator,
    vectors: torch.Tensor,      # [n+1, d]
    sqnorms: torch.Tensor,      # [n+1]
    graph_ids: torch.Tensor,    # [n, kk]
    graph_dists: torch.Tensor,  # [n, kk]
    kk: int,
    metric: Dist,
    tile: int = 256,
    fof_sample: int = 0,
    r_slots: int = NND_R_NEW,
    r_old: int = NND_R_OLD,
    new_in: torch.Tensor | None = None,
    c_active: int | None = None,
    n_rows: int | None = None,
    row_start: int | None = None,
    rev: torch.Tensor | None = None,
    rev2: torch.Tensor | None = None,
    noise: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One NN-descent expansion round in gather form: row u scores the
    candidates of ``B(B(u))``, ``B(v) = N(v) ∪ R(v)``, and merges them into
    its own row. Three channels carry them:

      * forward blocks: the lists of u's blocks (its edges, its new-edge
        reverse slots ``rev``, its old-edge reverse slots ``rev2``);
      * sibling lists: the reverse slots of those blocks;
      * the blocks themselves (a reverse hop v→u never put v in u's row).

    With ``new_in [n, kk]`` (the edges that are new since the last round)
    the round is incremental: each row ranks its blocks (2: a new edge or
    a reverse slot; 1: an old edge whose target row gained a new one; 0:
    nothing untried) with ``noise`` added, expands the best ``c_active //
    kk`` of them, keeps of an old block only its new edges, flips the
    expanded new edges to old, and carries the newness of the rest.
    Without flags every block is expanded (``fof_sample`` > 0 then keeps
    that many random candidate columns).

    Each row's candidates are scored in FP32 (:func:`_tile_dists`), its
    best ``2·kk`` pre-selected (keyed ``torch.topk``: ties to the earlier
    column, as ``lax.top_k``), and merged with its row, duplicates keeping
    their first copy. Returns ``(ids [rows, kk] int32, dists, n_updates,
    new_flags)``: ``n_updates`` counts edges that were not in the row
    before (a set difference), ``new_flags`` feeds the next round.

    ``n_rows`` / ``row_start`` process rows ``[row_start, row_start +
    n_rows)`` of the snapshot only, and return those rows that exist.
    ``rev``, ``rev2`` and ``noise`` are the round's draws
    (:func:`nnd_draws`); those not given are drawn from ``gen``, in that
    order. Rows go through in tiles of ``tile`` rows; the tiling changes
    no row's result where the tiles of two calls start at the same rows."""
    n = graph_ids.shape[0]
    dev = graph_ids.device
    flagged = new_in is not None
    if rev is None:
        rev = _reverse_sample(gen, graph_ids, n, r_slots, new_in=new_in)
    rev = rev.to(dev).long()
    base_w = kk + r_slots + (r_old if flagged else 0)
    if flagged:
        if rev2 is None:
            rev2 = _reverse_sample(gen, graph_ids, n, r_old, new_in=new_in, invert=True)
        rev2 = rev2.to(dev).long()
        if noise is None:
            noise = torch.rand((n, base_w), generator=gen, device=gen.device)
        noise = noise.to(dev)
        row_any_new = torch.cat([new_in.any(dim=1), torch.zeros(1, dtype=torch.bool, device=dev)])
        s_blk = max(1, min((c_active if c_active else 4 * kk) // kk, base_w))
        ext = torch.cat([torch.ones(r_slots, dtype=torch.bool, device=dev),
                         torch.zeros(r_old, dtype=torch.bool, device=dev)])
    cols = None
    width = base_w * (kk + r_slots)
    if not flagged and fof_sample and fof_sample < width:
        cols = torch.randint(0, width, (fof_sample,), generator=gen, device=gen.device).to(dev)

    r0 = 0 if row_start is None else int(row_start)
    r1 = n if n_rows is None else min(n, r0 + int(n_rows))
    ids_out = torch.empty((r1 - r0, kk), dtype=torch.int32, device=dev)
    d_out = torch.empty((r1 - r0, kk), dtype=torch.float32, device=dev)
    f_out = torch.empty((r1 - r0, kk), dtype=torch.bool, device=dev)
    upd = torch.zeros((), dtype=torch.long, device=dev)
    lanes = torch.arange(kk, device=dev)
    for t0 in range(r0, r1, tile):
        u = torch.arange(t0, min(t0 + tile, r1), device=dev)
        t = u.shape[0]
        fwd = graph_ids[u].long()                       # [t, kk]
        rv = rev[u]                                     # [t, r_slots]
        expanded = None
        if flagged:
            rv2 = rev2[u]
            base = torch.cat([fwd, rv, rv2], dim=1)     # [t, base_w]
            new1 = new_in[u]
            pri_fwd = torch.where(
                fwd < n,
                torch.where(new1, 2.0, torch.where(row_any_new[torch.clamp(fwd, max=n)],
                                                   1.0, 0.0)),
                0.0)
            pri = torch.cat([pri_fwd, torch.where(rv < n, 2.0, 0.0),
                             torch.where(rv2 < n, 2.0, 0.0)], dim=1)
            score = torch.where(pri > 0, pri + noise[u], 0.0)
            _, bidx = _topk_keyed(-score, s_blk)        # the largest, ties to the earlier
            sel = torch.gather(pri, 1, bidx) > 0
            sel_c = torch.clamp(torch.gather(base, 1, bidx), max=n - 1)
            sel_new1 = torch.gather(torch.cat([new1, ext.expand(t, -1)], dim=1), 1, bidx)
            # of an old block only its new edges are untried; an old-edge
            # reverse block delivers exactly the new edges of its row
            rel = (sel_new1[:, :, None] | new_in[sel_c]) & sel[:, :, None]
            fof_f = torch.where(rel, graph_ids[sel_c].long(), n)
            # sibling lists: every entry is the source of a new edge
            fof_s = torch.where(sel[:, :, None], rev[sel_c], n)
            fof = torch.cat([fof_f, fof_s], dim=2).reshape(t, s_blk * (kk + r_slots))
            expanded = ((bidx[:, :, None] == lanes) & sel[:, :, None]).any(dim=1)
            hops = [fof, rv, rv2]
        else:
            base = torch.cat([fwd, rv], dim=1)
            bsc = torch.clamp(base, max=n - 1)
            fof3 = torch.cat([graph_ids[bsc].long(), rev[bsc]], dim=2)
            fof = torch.where((base < n)[:, :, None], fof3, n).reshape(t, width)
            if cols is not None:
                fof = fof[:, cols]
            hops = [fof, rv]
        cand = torch.cat(hops, dim=1)                   # [t, C]
        safe_c = torch.clamp(cand, max=n)
        d = _tile_dists(vectors[u], vectors[safe_c], sqnorms[u], sqnorms[safe_c], metric)
        d = torch.where((cand >= n) | (cand == u[:, None]), _INF, d)
        # the best 2·kk before the dedup merge: a candidate reached along
        # several paths fills a kk-wide pre-select with its own copies
        ncd, ci = _topk_keyed(d, min(2 * kk, d.shape[1]))
        cur_ids, cur_d = fwd, graph_dists[u]
        new_ids, new_d = _merge_rows(cur_ids, cur_d, torch.gather(cand, 1, ci), ncd, kk)
        eq = new_ids[:, :, None] == cur_ids[:, None, :]
        fresh = ~eq.any(dim=2)
        flags = fresh
        if expanded is not None:
            # surviving new edges not expanded this round stay new
            flags = fresh | (eq & (new1 & ~expanded)[:, None, :]).any(dim=2)
        upd += (fresh & (new_ids < n)).sum()
        ids_out[t0 - r0 : t0 - r0 + t] = new_ids.int()
        d_out[t0 - r0 : t0 - r0 + t] = new_d
        f_out[t0 - r0 : t0 - r0 + t] = flags
    return ids_out, d_out, upd, f_out


def nnd_round_chunked(
    gen: torch.Generator,
    vectors: torch.Tensor,
    sqnorms: torch.Tensor,
    graph_ids: torch.Tensor,
    graph_dists: torch.Tensor,
    kk: int,
    metric: Dist,
    *,
    tile: int,
    c_active: int,
    new_in: torch.Tensor,
    row_chunk: int = 131_072,
    rev: torch.Tensor | None = None,
    rev2: torch.Tensor | None = None,
    noise: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One flagged NN-descent round over row chunks of ``row_chunk`` rows
    (rounded up to whole tiles), with the round's draws taken once
    (:func:`nnd_draws`, unless given).

    Below ``NND_INPLACE_MIN_N`` rows the chunks are Jacobi: every chunk
    expands from the round-start snapshot and writes only its own rows, so
    the result equals one :func:`nnd_round` call bit for bit. From
    ``NND_INPLACE_MIN_N`` the chunks update the graph in place
    (Gauss-Seidel: later chunks expand from earlier chunks' rows, as
    NN-descent's parallel joins see mixed state), which keeps one graph
    in memory instead of two; the chunk size then sets the result.
    ``n_updates`` sums over the chunks either way."""
    n = graph_ids.shape[0]
    if rev is None:
        rev, rev2, noise = nnd_draws(gen, graph_ids, new_in)
    kw = dict(tile=tile, new_in=new_in, c_active=c_active, rev=rev, rev2=rev2, noise=noise)
    if n <= row_chunk:
        return nnd_round(gen, vectors, sqnorms, graph_ids, graph_dists, kk, metric, **kw)
    row_chunk = -(-row_chunk // tile) * tile
    if n >= NND_INPLACE_MIN_N:
        ids_b, d_b, f_b = graph_ids.clone(), graph_dists.clone(), new_in.clone()
        upd = 0
        for r0 in range(0, n, row_chunk):
            kw["new_in"] = f_b
            ci, cd, cu, cf = nnd_round(gen, vectors, sqnorms, ids_b, d_b, kk, metric,
                                       n_rows=row_chunk, row_start=r0, **kw)
            ids_b[r0 : r0 + ci.shape[0]] = ci
            d_b[r0 : r0 + ci.shape[0]] = cd
            f_b[r0 : r0 + ci.shape[0]] = cf
            upd = upd + cu
        return ids_b, d_b, upd, f_b
    parts = [nnd_round(gen, vectors, sqnorms, graph_ids, graph_dists, kk, metric,
                       n_rows=row_chunk, row_start=r0, **kw)
             for r0 in range(0, n, row_chunk)]
    return (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]),
            sum(p[2] for p in parts), torch.cat([p[3] for p in parts]))


def diversify_graph(
    gen: torch.Generator,
    vectors: torch.Tensor,      # [n+1, d] (sentinel row n)
    sqnorms: torch.Tensor,      # [n+1]
    graph_ids: torch.Tensor,    # [n, kk] ascending by distance
    graph_dists: torch.Tensor,  # [n, kk]
    prune_prob: float,
    metric: Dist,
    tile: int = 4096,
    rand: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Probabilistic occlusion pruning of a kNN graph: scanning each row's
    neighbours in ascending distance, v is dropped with probability
    ``prune_prob`` when an already KEPT closer neighbour w lies nearer to v
    than the row does (``d(w, v) < d(u, v)``, and ``d(u, w)`` above f32
    epsilon). Kept edges stay in rank order; pruned slots become ``(n,
    inf)`` at the tail. The kept-set scan is a loop over the kk columns
    with all rows of a tile batched. ``rand [n, kk, kk]`` (uniform, indexed
    ``[u, w, v]``) is the draw; without it each tile of ``tile`` rows draws
    its own from ``gen``."""
    n, kk = graph_ids.shape
    dev = graph_ids.device
    eps = float(torch.finfo(torch.float32).eps)
    lanes = torch.arange(kk, device=dev)
    ids_out = torch.empty((n, kk), dtype=torch.int32, device=dev)
    d_out = torch.empty((n, kk), dtype=torch.float32, device=dev)
    for u0 in range(0, n, tile):
        nbrs = graph_ids[u0 : u0 + tile].long()
        nd = graph_dists[u0 : u0 + tile]
        t = nbrs.shape[0]
        safe = torch.clamp(nbrs, max=n)
        pair = _pair_dists(vectors[safe], sqnorms[safe], metric)
        valid = nbrs < n
        r = (rand[u0 : u0 + t].to(dev) if rand is not None
             else torch.rand((t, kk, kk), generator=gen, device=gen.device).to(dev))
        occludes = (pair < nd[:, None, :]) & (nd[:, :, None] > eps) & (r < prune_prob)
        kept = torch.zeros_like(valid)
        kept[:, 0] = valid[:, 0]
        for i in range(1, kk):
            kept[:, i] = valid[:, i] & ~(kept & occludes[:, :, i]).any(dim=1)
        # kept edges to the front, rank order kept
        order = torch.sort((~kept).int() * kk + lanes, dim=1).indices
        kept_s = torch.gather(kept, 1, order)
        ids_out[u0 : u0 + t] = torch.where(kept_s, torch.gather(nbrs, 1, order), n).int()
        d_out[u0 : u0 + t] = torch.where(kept_s, torch.gather(nd, 1, order), _INF)
    return ids_out, d_out
