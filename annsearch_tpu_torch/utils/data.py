"""Synthetic benchmark data (host numpy).

The same draws as ``annsearch_tpu.utils.data``, bit for bit, so that both
packages see identical inputs from one seed:

  * ``generate_clustered_data`` — Gaussian clusters, centres U(-7.5, 7.5),
    std U(0.5, 2.5), variable cluster sizes (weight U(0.5, 2.5) / 1.25);
  * ``subsample_with_noise`` — noisy query subsample, σ = 0.05, seed + 1000.
"""

from __future__ import annotations

import numpy as np

__all__ = ["generate_clustered_data", "subsample_with_noise"]


def _variable_cluster_assignments(
    rng: np.random.Generator, n_samples: int, n_clusters: int
) -> np.ndarray:
    """Variable cluster sizes: weight U(0.5, 2.5), n·w/(k·1.25) per
    cluster, remainder uniform, shuffled."""
    parts = []
    for c in range(n_clusters):
        w = rng.uniform(0.5, 2.5)
        n_in = int(n_samples * w / (n_clusters * 1.25))
        parts.append(np.full(n_in, c, dtype=np.int64))
    a = np.concatenate(parts) if parts else np.zeros(0, np.int64)
    if a.size < n_samples:
        a = np.concatenate(
            [a, rng.integers(0, n_clusters, n_samples - a.size)]
        )
    rng.shuffle(a)
    return a[:n_samples]


def generate_clustered_data(
    n_samples: int, dim: int, n_clusters: int, seed: int = 42
) -> tuple[np.ndarray, np.ndarray]:
    """Gaussian-cluster data ``[n, dim]`` f32 and its cluster labels."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-7.5, 7.5, (n_clusters, dim))
    stds = rng.uniform(0.5, 2.5, n_clusters)
    labels = _variable_cluster_assignments(rng, n_samples, n_clusters)
    noise = rng.standard_normal((n_samples, dim))
    data = centres[labels] + noise * stds[labels][:, None]
    return data.astype(np.float32), labels


def subsample_with_noise(
    data: np.ndarray, n_samples: int, seed: int = 42
) -> np.ndarray:
    """Noisy query subsample: σ = 0.05 Gaussian noise, seed offset +1000."""
    rng = np.random.default_rng(seed + 1000)
    n = min(n_samples, data.shape[0])
    idx = rng.permutation(data.shape[0])[:n]
    out = data[idx] + rng.standard_normal((n, data.shape[1])) * 0.05
    return out.astype(np.float32)
