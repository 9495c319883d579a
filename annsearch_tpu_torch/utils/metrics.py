"""Benchmark metrics: recall@k, mean distance ratio, cluster purity (port
of ``annsearch_tpu.utils.metrics``). Inputs are ``[nq, k]`` id or distance
arrays, numpy or tensors on any device."""

from __future__ import annotations

import torch

__all__ = [
    "calculate_recall",
    "calculate_mean_distance_ratio",
    "calculate_cluster_purity",
]


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


def calculate_mean_distance_ratio(true_dist, approx_dist, k: int) -> float:
    """Mean over queries of Σ approx-dist / Σ true-dist over the top k, in
    f64; queries whose true sum is 1e-12 or less are left out (NaN when
    none is left). 1.0 is perfect."""
    td = torch.as_tensor(true_dist).double()[:, :k]
    ad = torch.as_tensor(approx_dist, device=td.device).double()[:, :k]
    st, sa = td.sum(dim=1), ad.sum(dim=1)
    valid = st > 1e-12
    if not bool(valid.any()):
        return float("nan")
    return float((sa[valid] / st[valid]).mean())


def calculate_cluster_purity(knn_graph, cluster_labels) -> float:
    """Mean share of each row's neighbours that carry the row's own cluster
    label."""
    g = torch.as_tensor(knn_graph).long()
    labels = torch.as_tensor(cluster_labels, device=g.device)
    same = labels[g] == labels[: g.shape[0], None]
    return float(same.double().mean())
