"""Roofline counts: the work a call must do, whatever does it.

A roofline share is the least time the card could take over the time it
took: the larger of the operations at the peak rate and the bytes at the
memory bandwidth, divided by the device time. Operations count one
multiply-add (two operations) per (query, row, dimension) the search must
score, at the dense bf16 tensor-core rate: no pass of a split-precision
scheme is counted, so a version that reaches the same grade in fewer
passes is measured against the same work. Bytes count each input read
once and each output written once.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from .reference.exact import no_tf32, unit_rows

__all__ = [
    "PEAKS_FILE", "peaks_for", "least_time", "share_pct", "nearest_centroid_sizes",
    "ivf_probe_work", "flat_self_knn_work", "flat_query_work",
]

PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"

#: bytes of one result: an int32 id and an f32 distance
RESULT_BYTES = 8


def peaks_for(kind: str, path: Path = PEAKS_FILE) -> dict | None:
    """The published peaks of the card named ``kind``
    (``torch.cuda.get_device_name()``), or None for a card not in the
    table: no share is then given."""
    return json.loads(path.read_text()).get(kind)


def least_time(flop: float, nbytes: float, flop_s: float, byte_s: float) -> tuple[float, str]:
    """``(seconds, bound)``: the least time, and which of ``"operations"``
    and ``"bytes"`` sets it."""
    t_op, t_by = flop / flop_s, nbytes / byte_s
    return (t_op, "operations") if t_op >= t_by else (t_by, "bytes")


def share_pct(flop: float, nbytes: float, device_s: float, flop_s: float,
              byte_s: float) -> float:
    """The roofline share, in %, of ``device_s`` seconds of device time."""
    if device_s <= 0.0:
        raise ValueError(f"device time {device_s}")
    return 100.0 * least_time(flop, nbytes, flop_s, byte_s)[0] / device_s


def _dist(a: torch.Tensor, b: torch.Tensor, metric: str) -> torch.Tensor:
    """Distances ``[len(a), len(b)]`` under ``metric`` in f32, TF32 off:
    squared euclidean, or cosine as ``1 − â·b̂``."""
    cos = metric == "cosine"
    if cos:
        a, b = unit_rows(a), unit_rows(b)
    with no_tf32():
        dots = a @ b.T
    if cos:
        return 1.0 - dots
    return (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * dots


def nearest_centroid_sizes(x: torch.Tensor, centroids: torch.Tensor,
                           block: int = 65_536, metric: str = "euclidean") -> torch.Tensor:
    """``[nlist]`` int64: how many rows of ``x`` lie nearest each centroid
    under ``metric``."""
    c = centroids.float()
    owner = torch.cat([_dist(x[a : a + block], c, metric).argmin(1)
                       for a in range(0, x.shape[0], block)])
    return torch.bincount(owner, minlength=c.shape[0])


def ivf_probe_work(q: torch.Tensor, centroids: torch.Tensor, sizes: torch.Tensor,
                   nprobe: int, code_bytes: int, k: int,
                   metric: str = "euclidean") -> tuple[float, float]:
    """``(operations, bytes)`` of scoring ``q`` against the rows of each
    query's ``nprobe`` nearest cells under ``metric`` (``sizes``: rows per
    cell, no padding): two operations per (query, row, dimension); the
    codes and squared norms of every probed row read once, the queries
    (f32) read once, ``k`` results a query written once."""
    nq, d = q.shape
    probe = _dist(q.float(), centroids.float(), metric).topk(nprobe, dim=1, largest=False).indices
    pairs = float(sizes[probe].sum())
    probed = torch.zeros(sizes.shape[0], dtype=torch.bool, device=sizes.device)
    probed[probe.reshape(-1)] = True
    rows = float(sizes[probed].sum())
    return 2.0 * pairs * d, rows * (d * code_bytes + 4) + nq * d * 4.0 + nq * k * RESULT_BYTES


def flat_self_knn_work(n: int, d: int, k: int) -> tuple[float, float]:
    """``(operations, bytes)`` of the exact kNN graph of ``n`` f32 rows:
    n·n pairs; the rows and their squared norms read once, ``k`` results a
    row written once."""
    return 2.0 * n * n * d, n * (d * 4.0 + 4.0) + n * k * RESULT_BYTES


def flat_query_work(nq: int, n: int, d: int, k: int) -> tuple[float, float]:
    """``(operations, bytes)`` of an exact scan of ``nq`` f32 queries over
    ``n`` f32 rows: nq·n pairs; rows, their norms and the queries read
    once, ``k`` results a query written once."""
    return 2.0 * nq * n * d, n * (d * 4.0 + 4.0) + nq * d * 4.0 + nq * k * RESULT_BYTES
