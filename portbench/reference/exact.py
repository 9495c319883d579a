"""The plain reference: exact k nearest neighbours by squared euclidean
distance, and the control, the same search at the next lower precision.

Plain torch on whatever device the inputs are on, in blocks of queries.
It imports nothing of the program and takes nothing the program made: the
benchmark hands it the data and the queries it made from the seed.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["exact_knn", "distances_of", "control_knn", "round_tf32", "int4_rows",
           "no_tf32", "LOWER_PRECISION"]

#: the control's precision for each precision a configuration states
LOWER_PRECISION = {"float32": "tf32", "int8": "int4"}

#: query rows per block: a block holds [rows, n] f64 distances
_BLOCK_ELEMS = 1 << 28


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


def _select(d: torch.Tensor, k: int, rows, exclude) -> tuple[torch.Tensor, torch.Tensor]:
    if exclude is not None:
        d.scatter_(1, exclude[rows][:, None].long(), float("inf"))
    v, i = torch.topk(d, k, dim=1, largest=False, sorted=True)
    return i, v


def exact_knn(q: torch.Tensor, x: torch.Tensor, k: int, exclude: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(ids [nq, k] int64, dists [nq, k] f64)``, ascending, computed in
    float64. ``exclude[i]`` is a row that query i may not return (a
    self-query's own row)."""
    x64 = x.double()
    xn = (x64 * x64).sum(1)
    ids, dists = [], []
    step = _rows_per_block(x.shape[0])
    for a in range(0, q.shape[0], step):
        qb = q[a : a + step].double()
        d = (qb * qb).sum(1)[:, None] + xn[None, :] - 2.0 * (qb @ x64.T)
        i, v = _select(d, k, slice(a, a + step), exclude)
        ids.append(i)
        dists.append(v)
    return torch.cat(ids), torch.cat(dists)


def distances_of(q: torch.Tensor, x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``[nq, k]`` f64 squared distances from each query to the rows
    ``ids`` names (ids outside ``0..n-1`` are clamped into it)."""
    ids = ids.long().clamp(0, x.shape[0] - 1)
    out = []
    step = max(1, _BLOCK_ELEMS // max(ids.shape[1] * x.shape[1], 1))
    for a in range(0, q.shape[0], step):
        diff = x[ids[a : a + step]].double() - q[a : a + step, None, :].double()
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
                exclude: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference in the program's place at ``precision`` (a value of
    ``LOWER_PRECISION``): ``"tf32"`` takes the products' operands at TF32
    (norms and sums f32), ``"int4"`` stores the rows as int4 and scores f32
    queries against them in f32. Returns ``(ids, dists f32)`` as the
    program would."""
    if precision == "tf32":
        xs = round_tf32(x)
    elif precision == "int4":
        xs = x = int4_rows(x.float())
    else:
        raise ValueError(f"no control at precision {precision!r}")
    xn = (x.float() ** 2).sum(1)
    ids, dists = [], []
    step = _rows_per_block(x.shape[0])
    with no_tf32():
        for a in range(0, q.shape[0], step):
            qb = q[a : a + step].float()
            qs = round_tf32(qb) if precision == "tf32" else qb
            d = (qb * qb).sum(1)[:, None] + xn[None, :] - 2.0 * (qs @ xs.T)
            i, v = _select(d, k, slice(a, a + step), exclude)
            ids.append(i)
            dists.append(v)
    return torch.cat(ids), torch.cat(dists)
