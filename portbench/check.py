"""The comparison that decides ``correct``: the answers the timed calls
returned, against the plain reference's exact answers for the same
queries over the same data, under the configuration's metric (squared
euclidean or cosine, ``reference.METRICS``).

The numbers, over the sampled query rows:

* ``miss``: 1 − recall@k against the reference's exact top k;
* ``dist_err``: the widest gap between a returned distance and the
  reference's float64 distance to the row the answer names, over the
  reference's k-th distance of that query;
* ``gap``: the widest amount by which the j-th answer's true distance lies
  above the reference's j-th, over the reference's k-th distance;
* ``bad``: rows that name an id outside the data, an id twice, the row
  itself where a self-query excludes it, or distances that are not finite
  and ascending.

A cell's limits file says which numbers it holds and each one's limit.
"""

from __future__ import annotations

import torch

from . import stats
from .reference import distances_of, exact_knn

__all__ = ["NUMBERS", "compare", "judge"]

NUMBERS = ("miss", "dist_err", "gap", "bad")


def _bad_rows(ids: torch.Tensor, dists: torch.Tensor, n: int, exclude) -> int:
    ids = ids.long()
    bad = (ids < 0).any(1) | (ids >= n).any(1)
    s = torch.sort(ids, dim=1).values
    bad |= (s[:, 1:] == s[:, :-1]).any(1)
    if exclude is not None:
        bad |= (ids == exclude.long()[:, None]).any(1)
    d = dists.double()
    bad |= ~torch.isfinite(d).all(1)
    bad |= (d[:, 1:] < d[:, :-1]).any(1)
    return int(bad.sum())


def compare(q: torch.Tensor, x: torch.Tensor, ids: torch.Tensor, dists: torch.Tensor,
            exclude: torch.Tensor | None = None, metric: str = "euclidean") -> dict[str, float]:
    """The numbers of answers ``(ids, dists) [nq, k]`` to queries ``q``
    over rows ``x`` under ``metric`` (``exclude[i]``: the row query i may
    not return)."""
    k = ids.shape[1]
    t_ids, t_d = exact_knn(q, x, k, exclude, metric)
    d_of = distances_of(q, x, ids, metric)
    scale = t_d[:, -1:].clamp_min(1e-30)
    return {
        "miss": 1.0 - stats.recall(t_ids, ids),
        "dist_err": float(((dists.double() - d_of).abs() / scale).max()),
        "gap": float(((d_of - t_d) / scale).max()),
        "bad": float(_bad_rows(ids, dists, x.shape[0], exclude)),
    }


def judge(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})``: correct when every number
    the limits name is at or under its limit (a number that is not a
    number fails)."""
    out, ok = {}, True
    for name, lim in limits.items():
        v = numbers[name]
        out[name] = {"value": v, "limit": lim}
        ok &= v == v and v <= lim
    return ok, out
