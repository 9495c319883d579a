"""The benchmark's arithmetic: rates, recall, spreads, and the
device's busy time and idle gaps read from a profiler timeline.

Plain Python and torch; every function is pinned by
``test_portbench_counts.py`` on inputs worked by hand.
"""

from __future__ import annotations

import statistics

import torch

__all__ = [
    "rate", "spread", "recall", "union_length", "idle_pct", "idle_gaps",
    "held_bytes", "top_by_total",
]


def rate(work: float, seconds: float) -> float:
    """Work per second over a window of ``seconds``."""
    if seconds <= 0.0:
        raise ValueError(f"window of {seconds} s")
    return work / seconds


def spread(values) -> float:
    """The distance between the first and third quartiles as a share of the
    median (``statistics.quantiles(values, n=4)``, its default method)."""
    q1, q2, q3 = statistics.quantiles([float(x) for x in values], n=4)
    return (q3 - q1) / q2


def recall(truth: torch.Tensor, found: torch.Tensor) -> float:
    """Mean over rows of |truth ∩ found| / k, a repeated id in ``found``
    counting once (``[rows, k]`` id tensors)."""
    k = truth.shape[1]
    f = torch.sort(found.to(truth.device).long(), dim=1).values
    first = torch.ones_like(f, dtype=torch.bool)
    first[:, 1:] = f[:, 1:] != f[:, :-1]
    hit = (f[:, :, None] == truth.long()[:, None, :]).any(dim=-1) & first
    return float(hit.sum(dim=1).double().mean()) / k


def _merged(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """``intervals`` clipped to ``[lo, hi]`` and merged where they overlap."""
    out: list[list[float]] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def union_length(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``(start, end)`` intervals inside ``[lo, hi]``."""
    return sum(b - a for a, b in _merged(intervals, lo, hi))


def idle_pct(busy: float, window: float) -> float:
    """The share of a window, in %, in which no device operation ran."""
    if window <= 0.0:
        raise ValueError(f"window of {window}")
    return 100.0 * (1.0 - busy / window)


def idle_gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    gaps, t = [], lo
    for a, b in _merged(intervals, lo, hi):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def held_bytes(obj, device) -> int:
    """Bytes of the tensors on ``device`` that ``obj`` holds in its
    attributes, and one level into the lists, tuples and dicts among them;
    each storage counted once, whole."""
    dev = torch.device(device)
    seen: dict[int, int] = {}

    def add(t):
        if isinstance(t, torch.Tensor) and t.device.type == dev.type:
            s = t.untyped_storage()
            seen[s.data_ptr()] = s.nbytes()

    for v in vars(obj).values():
        items = v.values() if isinstance(v, dict) else v if isinstance(v, (list, tuple)) else (v,)
        for t in items:
            add(t)
    return sum(seen.values())


def top_by_total(pairs, n: int = 10) -> list[list]:
    """``[[name, total], ...]``: the ``n`` names with the largest sums of
    ``(name, value)`` pairs, largest first (ties by name)."""
    tot: dict[str, float] = {}
    for name, v in pairs:
        tot[name] = tot.get(name, 0.0) + v
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: (-kv[1], kv[0]))[:n]]
