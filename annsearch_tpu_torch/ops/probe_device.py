"""On-device probe-list construction for the fused IVF scan (port of
``annsearch_tpu.ops.probe_device``, the dense path).

Inverts ``[nq, T]`` segment probes into per-task-row query lists with
tensor ops on the probes' device. ``maxq`` comes from the mean occupancy
(nq·nprobe / nseg); segments with more queries are chunked across several
task rows, so the row count is bounded by ``R = total/maxq + nseg``. The
shapes are kept identical to the JAX package's so that the task rows match
its rows one for one.
"""

from __future__ import annotations

import torch

__all__ = ["device_probe_shapes", "build_probe_lists_device"]


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
