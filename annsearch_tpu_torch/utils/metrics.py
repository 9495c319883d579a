"""Benchmark metrics."""

from __future__ import annotations

import torch

__all__ = ["calculate_recall"]


def calculate_recall(true_neighbors, approx_neighbors, k: int) -> float:
    """Mean |top-k(true) ∩ top-k(approx)| / k over queries.

    Vectorised over queries; like ``np.intersect1d`` a repeated id counts
    once. Accepts numpy arrays or tensors on any device."""
    t = torch.as_tensor(true_neighbors)[:, :k]
    a = torch.as_tensor(approx_neighbors, device=t.device)[:, :k]
    a = torch.sort(a, dim=1).values
    first = torch.ones_like(a, dtype=torch.bool)
    first[:, 1:] = a[:, 1:] != a[:, :-1]
    hit = (a[:, :, None] == t[:, None, :]).any(dim=-1) & first
    return float(hit.sum(dim=1).double().mean()) / k
