"""On-device probe-list construction for the fused IVF scan (port of
``annsearch_tpu.ops.probe_device``).

Inverts ``[nq, T]`` segment probes into per-task-row query lists with
tensor ops on the probes' device. ``maxq`` comes from the mean occupancy
(nq·nprobe / nseg); segments with more queries are chunked across several
task rows, so the row count is bounded by ``R = total/maxq + nseg``. The
shapes are kept identical to the JAX package's so that the task rows match
its rows one for one.

Two expansions of cluster probes into (query, segment) pairs:

* dense (``expand_probes_device``): ``[nq, nprobe·s_max]`` slots, those
  past a cluster's segment count holding the sentinel segment ``nseg``;
* compact (``route_pair_stats`` → ``compact_probe_shapes`` →
  ``build_probe_lists_compact``): exactly the real pairs, sized from two
  scalars read back to the host. On skewed layouts (a few cells split into
  many segments) the dense expansion is mostly sentinels.
"""

from __future__ import annotations

import torch

__all__ = [
    "device_probe_shapes",
    "expand_probes_device",
    "build_probe_lists_device",
    "route_pair_stats",
    "compact_probe_shapes",
    "build_probe_lists_compact",
]


def _next_pow2(v: int) -> int:
    return 1 << (max(v, 1) - 1).bit_length()


def device_probe_shapes(
    nq: int, nprobe: int, nseg: int, s_max: int
) -> tuple[int, int]:
    """``(maxq, R)`` for the task lists: ``maxq`` a power of two in
    [32, 1024] near half the mean segment occupancy, ``R`` a multiple of 64
    that bounds the task rows."""
    total = nq * nprobe * s_max
    mean = max(1, (nq * nprobe) // max(nseg, 1))
    maxq = min(_next_pow2(-(-mean // 2)), 1024, _next_pow2(nq))
    maxq = max(maxq, 32)
    rows = -(-total // maxq) + nseg + 2
    R = -(-rows // 64) * 64
    return maxq, R


def _exclusive_cumsum(v: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(v, 0) - v


def expand_probes_device(
    probes: torch.Tensor,       # [nq, nprobe] cluster ids
    cluster_ptr: torch.Tensor,  # [nlist+1] segment CSR
    s_max: int,                 # most segments of one cluster
    nseg: int,
) -> torch.Tensor:
    """Cluster probes → segment probes ``[nq, nprobe·s_max]`` int64;
    expansion slots past a cluster's segment count hold ``nseg``."""
    ptr = cluster_ptr.long()
    c = probes.long()
    first = ptr[c]
    count = ptr[c + 1] - first
    j = torch.arange(s_max, device=probes.device)[None, None, :]
    seg = torch.where(j < count[:, :, None], first[:, :, None] + j, nseg)
    return seg.reshape(probes.shape[0], -1)


def build_probe_lists_device(
    seg_probes: torch.Tensor,  # [nq, T] segment ids (sentinel = nseg)
    nseg: int,
    maxq: int,
    R: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns ``(cluster_ids [R] int32, lists [R, maxq] int32,
    gather_map [nq, T] int64)``: ``lists`` padded with ``nq``,
    ``cluster_ids`` padded with ``nseg``, and ``gather_map[q, t]`` the flat
    scan lane ``row·maxq + col`` of pair ``(q, t)``."""
    nq, T = seg_probes.shape
    dev = seg_probes.device
    n_pairs = nq * T
    flat_c = seg_probes.reshape(-1).long()
    flat_q = torch.arange(nq, device=dev).repeat_interleave(T)

    # stable: within a segment, pairs keep query order (the JAX rows)
    order = torch.argsort(flat_c, stable=True)
    cs = flat_c[order]
    qs = flat_q[order]
    counts = torch.bincount(flat_c, minlength=nseg + 1)
    rank = torch.arange(n_pairs, device=dev) - _exclusive_cumsum(counts)[cs]
    nchunks = -(-counts // maxq)
    rows = torch.clamp(_exclusive_cumsum(nchunks)[cs] + rank // maxq, max=R - 1)
    cols = rank % maxq

    # (rows, cols) are unique while the R bound holds, and all pairs of one
    # row carry one segment id, so both scatters are deterministic
    lists = torch.full((R, maxq), nq, dtype=torch.int32, device=dev)
    lists[rows, cols] = qs.int()
    cluster_ids = torch.full((R,), nseg, dtype=torch.int32, device=dev)
    cluster_ids[rows] = cs.int()
    gather_map = torch.empty(n_pairs, dtype=torch.int64, device=dev)
    gather_map[order] = rows * maxq + cols
    return cluster_ids, lists, gather_map.reshape(nq, T)


def route_pair_stats(probes: torch.Tensor, cluster_ptr: torch.Tensor) -> torch.Tensor:
    """``[2]`` int64: (real (query, segment) pairs, most pairs of one
    query)."""
    ptr = cluster_ptr.long()
    c = probes.long()
    qcnt = (ptr[c + 1] - ptr[c]).sum(dim=1)
    return torch.stack([qcnt.sum(), qcnt.max()])


def compact_probe_shapes(total: int, qmax: int, nseg: int) -> tuple[int, int, int, int]:
    """``(P, T_g, maxq, R)`` of the compact lists from the routing stats:
    ``P`` (pair slots) and ``T_g`` (gather width per query) powers of two,
    ``maxq`` near half the mean segment occupancy, ``R`` a multiple of 64."""
    P = _next_pow2(int(total) + 1)
    T_g = _next_pow2(max(int(qmax), 1))
    mean = max(1, int(total) // max(nseg, 1))
    maxq = max(min(_next_pow2(-(-mean // 2)), 1024), 32)
    rows = -(-int(total) // maxq) + nseg + 3
    R = -(-rows // 64) * 64
    return P, T_g, maxq, R


def build_probe_lists_compact(
    probes: torch.Tensor,       # [nq, nprobe] cluster ids
    cluster_ptr: torch.Tensor,  # [nlist+1] segment CSR
    P: int,                     # pair slots (≥ total + 1)
    T_g: int,                   # gather width per query (≥ most pairs of one query)
    nseg: int,
    maxq: int,
    R: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Expand cluster probes to the real (query, segment) pairs and invert
    them into task rows. Returns ``(cluster_ids [R] int32, lists [R, maxq]
    int32, gather_map [nq, T_g] int64)``, the gather map padded with -1.

    The JAX package writes its scatters with ``mode="drop"``; torch raises
    on out-of-range indices instead, so the slots past the real pairs are
    masked out explicitly."""
    nq, np_ = probes.shape
    dev = probes.device
    m = nq * np_
    ptr = cluster_ptr.long()
    c = probes.reshape(-1).long()
    first = ptr[c]
    cnt = ptr[c + 1] - first                       # [m] run lengths
    ends = torch.cumsum(cnt, 0)
    starts = ends - cnt
    total = ends[-1]

    # run-length expansion: slot p belongs to the last run starting ≤ p
    # (a zero-length run shares its start with the next run)
    mark = torch.bincount(starts[starts < P], minlength=P)
    run = torch.clamp(torch.cumsum(mark, 0) - 1, max=m - 1)
    pos = torch.arange(P, device=dev)
    valid = pos < total
    seg = torch.where(valid, first[run] + (pos - starts[run]), nseg)
    q = torch.where(valid, run // np_, nq)

    # invert: pairs sorted by segment (stable), each segment's queries cut
    # into rows of maxq; the sentinel pairs sort last and all go to row
    # R − 1 (they write the pad values there, so any writer wins)
    order = torch.argsort(seg, stable=True)
    cs = seg[order]
    qs = q[order]
    counts = torch.bincount(seg, minlength=nseg + 1)
    rank = pos - _exclusive_cumsum(counts)[cs]
    nchunks = torch.where(
        torch.arange(nseg + 1, device=dev) < nseg, -(-counts // maxq), 0
    )
    rows = torch.where(
        cs < nseg,
        torch.clamp(_exclusive_cumsum(nchunks)[cs] + rank // maxq, max=R - 1),
        R - 1,
    )
    cols = rank % maxq
    lists = torch.full((R, maxq), nq, dtype=torch.int32, device=dev)
    lists[rows, cols] = qs.int()
    cluster_ids = torch.full((R,), nseg, dtype=torch.int32, device=dev)
    cluster_ids[rows] = cs.int()

    # per-query gather map, pairs in their original (query-major) order
    lanes = torch.empty(P, dtype=torch.int64, device=dev)
    lanes[order] = rows * maxq + cols
    qcnt = cnt.reshape(nq, np_).sum(dim=1)
    pos_in_q = pos - _exclusive_cumsum(qcnt)[torch.clamp(run // np_, max=nq - 1)]
    gather_map = torch.full((nq, T_g), -1, dtype=torch.int64, device=dev)
    gather_map[q[valid], pos_in_q[valid]] = lanes[valid]
    return cluster_ids, lists, gather_map
