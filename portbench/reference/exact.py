"""The plain reference: exact k nearest neighbours under the configuration's
metric, and the control, the same search at the next lower precision.

The metrics a configuration may state (``METRICS``): ``"euclidean"``, the
squared euclidean distance, and ``"cosine"``, ``1 − q·x / (‖q‖‖x‖)`` with
each norm clamped at 1e-30, so that a zero row lies at distance 1 from
every query.

Plain torch on whatever device the inputs are on, in blocks of queries.
It imports nothing of the program and takes nothing the program made: the
benchmark hands it the data and the queries it made from the seed.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["exact_knn", "distances_of", "control_knn", "round_tf32", "int4_rows",
           "unit_rows", "no_tf32", "check_metric", "METRICS", "LOWER_PRECISION"]

#: the distances a configuration may state
METRICS = ("euclidean", "cosine")

#: the control's precision for each precision a configuration states
LOWER_PRECISION = {"float32": "tf32", "int8": "int4"}

#: query rows per block: a block holds [rows, n] f64 distances
_BLOCK_ELEMS = 1 << 28


def check_metric(metric: str) -> str:
    if metric not in METRICS:
        raise ValueError(f"metric {metric!r} is none of {METRICS}")
    return metric


def _rows_per_block(n: int) -> int:
    return max(1, _BLOCK_ELEMS // max(n, 1))


@contextlib.contextmanager
def no_tf32():
    """Matrix products in full f32 (TF32 off) inside the block."""
    keep = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = keep


def unit_rows(t: torch.Tensor) -> torch.Tensor:
    """Rows (the last dimension) over their L2 norms, each norm clamped at
    1e-30: a zero row stays zero. Computed in ``t``'s type."""
    return t / torch.linalg.vector_norm(t, dim=-1, keepdim=True).clamp_min(1e-30)


def _select(d: torch.Tensor, k: int, rows, exclude) -> tuple[torch.Tensor, torch.Tensor]:
    if exclude is not None:
        d.scatter_(1, exclude[rows][:, None].long(), float("inf"))
    v, i = torch.topk(d, k, dim=1, largest=False, sorted=True)
    return i, v


def exact_knn(q: torch.Tensor, x: torch.Tensor, k: int, exclude: torch.Tensor | None = None,
              metric: str = "euclidean") -> tuple[torch.Tensor, torch.Tensor]:
    """``(ids [nq, k] int64, dists [nq, k] f64)``, ascending, computed in
    float64 under ``metric``. ``exclude[i]`` is a row that query i may not
    return (a self-query's own row)."""
    cos = check_metric(metric) == "cosine"
    x64 = unit_rows(x.double()) if cos else x.double()
    xn = None if cos else (x64 * x64).sum(1)
    ids, dists = [], []
    step = _rows_per_block(x.shape[0])
    for a in range(0, q.shape[0], step):
        qb = q[a : a + step].double()
        if cos:
            d = 1.0 - unit_rows(qb) @ x64.T
        else:
            d = (qb * qb).sum(1)[:, None] + xn[None, :] - 2.0 * (qb @ x64.T)
        i, v = _select(d, k, slice(a, a + step), exclude)
        ids.append(i)
        dists.append(v)
    return torch.cat(ids), torch.cat(dists)


def distances_of(q: torch.Tensor, x: torch.Tensor, ids: torch.Tensor,
                 metric: str = "euclidean") -> torch.Tensor:
    """``[nq, k]`` f64 distances under ``metric`` from each query to the
    rows ``ids`` names (ids outside ``0..n-1`` are clamped into it)."""
    cos = check_metric(metric) == "cosine"
    ids = ids.long().clamp(0, x.shape[0] - 1)
    out = []
    step = max(1, _BLOCK_ELEMS // max(ids.shape[1] * x.shape[1], 1))
    for a in range(0, q.shape[0], step):
        rows, qb = x[ids[a : a + step]].double(), q[a : a + step, None, :].double()
        if cos:
            out.append(1.0 - (unit_rows(rows) * unit_rows(qb)).sum(-1))
        else:
            diff = rows - qb
            out.append((diff * diff).sum(-1))
    return torch.cat(out)


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32's 10 mantissa bits (nearest, ties away
    from zero), as a tensor core takes its operands."""
    b = t.float().contiguous().view(torch.int32)
    return ((b + (1 << 12)) & ~((1 << 13) - 1)).view(torch.float32)


def int4_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` stored as int4: per dimension a symmetric scale (the largest
    |value| over 7) and codes in -7..7, returned decoded to f32."""
    scale = x.abs().amax(0).clamp_min(1e-30) / 7.0
    return torch.clamp(torch.round(x / scale), -7, 7) * scale


def control_knn(q: torch.Tensor, x: torch.Tensor, k: int, precision: str,
                exclude: torch.Tensor | None = None, metric: str = "euclidean"
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference in the program's place at ``precision`` (a value of
    ``LOWER_PRECISION``), under ``metric``: ``"tf32"`` takes the products'
    operands at TF32 (norms and sums f32; under cosine the rows are
    normalised in f32 first), ``"int4"`` stores the rows as int4 and scores
    f32 queries against them in f32 (under cosine the stored rows are
    normalised). Returns ``(ids, dists f32)`` as the program would."""
    cos = check_metric(metric) == "cosine"
    if precision == "tf32":
        x = unit_rows(x.float()) if cos else x
        xs = round_tf32(x)
    elif precision == "int4":
        xs = x = int4_rows(x.float())
        if cos:
            xs = x = unit_rows(x)
    else:
        raise ValueError(f"no control at precision {precision!r}")
    xn = None if cos else (x.float() ** 2).sum(1)
    ids, dists = [], []
    step = _rows_per_block(x.shape[0])
    with no_tf32():
        for a in range(0, q.shape[0], step):
            qb = q[a : a + step].float()
            if cos:
                qb = unit_rows(qb)
            qs = round_tf32(qb) if precision == "tf32" else qb
            if cos:
                d = 1.0 - qs @ xs.T
            else:
                d = (qb * qb).sum(1)[:, None] + xn[None, :] - 2.0 * (qs @ xs.T)
            i, v = _select(d, k, slice(a, a + step), exclude)
            ids.append(i)
            dists.append(v)
    return torch.cat(ids), torch.cat(dists)
