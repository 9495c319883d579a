"""Graph kernels in tensor operations (port of the query side of
``annsearch_tpu.ops.graph``): CAGRA detour pruning, sampled reverse edges
and the batched beam search. The JAX functions reach no Pallas kernel, and
neither do these.

Ported: ``_row_dedup_inf``, ``_merge_rows``, ``_next_pow2``,
``cagra_prune``, ``_reverse_sample`` (the ``new_in=None`` form),
``add_reverse_edges``, ``random_init_graph`` (split into the draw,
:func:`random_candidates`, and the scoring, :func:`score_candidates`) and
``beam_search`` with ``return_trail``. Not ported: the rest of the
approximate graph build (``rp_forest_round``, ``kmeans_leaves``,
``leaf_join_merge``, ``nnd_round_chunked``) and ``diversify_graph``
(ROADMAP P5); ``nav_hl_split``, ``pack_neighbor_table`` /
``maybe_pack_neighbors`` and the bitonic networks (ROADMAP, not to port):
they are bf16 and DMA-granularity layouts of the TPU. The port scores
candidates in FP32 from the f32 table, the grade the JAX package's packed
path gives with its four-term split, so the single-pass bf16 walk and its
final f32 pool rescore are not needed either.

Graphs are ``int32`` (as the JAX package saves them); ids inside the beam
are ``int64``. The sentinel id ``n`` marks an empty slot; row ``n`` of
``vectors`` and of ``graph`` is the sentinel row.
"""

from __future__ import annotations

import torch

from ..utils.dist import Dist, fp32_matmul, sq_norms

__all__ = [
    "cagra_prune", "add_reverse_edges", "beam_search", "random_init_graph",
    "random_candidates", "score_candidates",
]

_INF = float("inf")
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
    gen: torch.Generator, graph_ids: torch.Tensor, n: int, r_slots: int
) -> torch.Tensor:
    """``[n, r_slots]`` reverse-neighbour sample: each edge (u→v) is
    scattered into a random slot of v's reverse list; empty slots hold
    ``n``. Where several edges draw one slot, the JAX package keeps the
    last write of its backend; here the edge with the largest position
    ``u·kk + column`` wins, so one seed gives one graph on every device.
    The slots are drawn on the CPU from ``gen`` and moved to the graph's
    device."""
    kk = graph_ids.shape[1]
    dev = graph_ids.device
    slot = torch.randint(0, r_slots, (n * kk,), generator=gen).to(dev)
    dst = torch.clamp(graph_ids[:n].reshape(-1).long(), max=n)
    key = dst * r_slots + slot
    pos = torch.arange(n * kk, device=dev)
    winner = torch.full(((n + 1) * r_slots,), -1, dtype=torch.long, device=dev)
    winner.scatter_reduce_(0, key, pos, "amax")
    rev = torch.where(winner >= 0, winner // kk, n)
    return rev.reshape(n + 1, r_slots)[:n].int()


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
    distance (``n`` / inf for exhausted slots)."""
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
    """``[n, kk]`` random node ids in ``[0, n)``, drawn on the CPU from
    ``gen`` and moved to ``device``: the draw of ``random_init_graph`` (the
    JAX package draws from its key stream, which torch cannot repeat; a
    test can hand that draw to :func:`score_candidates`)."""
    return torch.randint(0, n, (n, kk), generator=gen).to(device)


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
) -> tuple[torch.Tensor, torch.Tensor]:
    """A random ``kk``-NN graph with true distances (the JAX package's
    ``random_init_graph``): :func:`random_candidates` scored by
    :func:`score_candidates`. ``vectors [n+1, d]`` carries the sentinel
    row."""
    n = vectors.shape[0] - 1
    return score_candidates(
        vectors, sqnorms, random_candidates(gen, n, kk, vectors.device), metric)
