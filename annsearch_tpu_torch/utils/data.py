"""Synthetic benchmark data (host numpy).

The same draws as ``annsearch_tpu.utils.data``, bit for bit, so that both
packages see identical inputs from one seed:

  * ``generate_clustered_data`` — Gaussian clusters, centres U(-7.5, 7.5),
    std U(0.5, 2.5), variable cluster sizes (weight U(0.5, 2.5) / 1.25);
  * ``subsample_with_noise`` — noisy query subsample, σ = 0.05, seed + 1000;
  * ``generate_data`` — the suites by name: ``correlated``
    (``generate_clustered_data_high_dim``), ``lowrank``
    (``generate_low_rank_rotated_data``), ``quantisation``
    (``generate_quantisation_stress``), anything else Gaussian clusters.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "generate_clustered_data",
    "generate_clustered_data_high_dim",
    "generate_low_rank_rotated_data",
    "generate_quantisation_stress",
    "generate_data",
    "subsample_with_noise",
]

#: default ρ of the correlated suite
DEFAULT_COR_STRENGTH = 0.5


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


def _separated_centres(
    rng: np.random.Generator,
    n_clusters: int,
    dim: int,
    scale: float,
    min_sep: float,
) -> np.ndarray:
    """Rejection-sample centres with pairwise separation ≥ min_sep."""
    centres: list[np.ndarray] = []
    while len(centres) < n_clusters:
        cand = rng.uniform(-scale, scale, dim)
        if all(np.sum((cand - c) ** 2) >= min_sep**2 for c in centres):
            centres.append(cand)
    return np.stack(centres)


def generate_clustered_data_high_dim(
    n_samples: int,
    dim: int,
    n_clusters: int,
    correlation_strength: float = DEFAULT_COR_STRENGTH,
    seed: int = 42,
) -> tuple[np.ndarray, np.ndarray]:
    """Correlated suite (commons/mod.rs:208-331)."""
    rng = np.random.default_rng(seed)
    scale = np.sqrt(dim) * 2.0
    centres = _separated_centres(rng, n_clusters, dim, scale, scale * 0.8)

    active_per_cluster = max(dim // 2, 3)
    active = np.stack(
        [rng.permutation(dim)[:active_per_cluster] for _ in range(n_clusters)]
    )
    stds = rng.uniform(0.3, 1.0, n_clusters) * scale / 10.0
    labels = _variable_cluster_assignments(rng, n_samples, n_clusters)

    noise_scale = np.full((n_clusters, dim), 0.1)
    for c in range(n_clusters):
        noise_scale[c, active[c]] = 1.0
    noise_scale *= stds[:, None]

    data = centres[labels] + rng.standard_normal((n_samples, dim)) * noise_scale[labels]

    # correlated dimension groups: target = source·coeff·ρ + original·(1−ρ)
    n_groups = dim // 8
    dims_per_group = 4
    nw = 1.0 - correlation_strength
    for g in range(n_groups):
        src = g * 8
        if src >= dim:
            break
        coeffs = rng.uniform(-2.0, 2.0, dims_per_group)
        for off in range(1, dims_per_group + 1):
            tgt = src + off
            if tgt >= dim:
                break
            data[:, tgt] = (
                data[:, src] * coeffs[off - 1] * correlation_strength
                + data[:, tgt] * nw
            )
    return data.astype(np.float32), labels


def _orthonormal_rows(rng: np.random.Generator, rows: int, cols: int) -> np.ndarray:
    """Random matrix with orthonormal structure (QR on a Gaussian)."""
    g = rng.standard_normal((max(rows, cols), min(rows, cols)))
    q, _ = np.linalg.qr(g)
    q = q[: max(rows, cols), : min(rows, cols)]
    return q.T if rows < cols else q  # shape [rows, cols]


def generate_low_rank_rotated_data(
    n_samples: int,
    embedding_dim: int,
    intrinsic_dim: int,
    n_clusters: int,
    seed: int = 42,
) -> tuple[np.ndarray, np.ndarray]:
    """LowRank suite (commons/mod.rs:349-477)."""
    assert intrinsic_dim <= embedding_dim
    rng = np.random.default_rng(seed)
    sep = np.sqrt(intrinsic_dim) * 3.0
    centres = _separated_centres(rng, n_clusters, intrinsic_dim, sep, sep * 0.5)

    labels = np.concatenate(
        [np.full(n_samples // n_clusters, c, np.int64) for c in range(n_clusters)]
    )
    if labels.size < n_samples:
        labels = np.concatenate(
            [labels, rng.integers(0, n_clusters, n_samples - labels.size)]
        )
    rng.shuffle(labels)
    labels = labels[:n_samples]

    low = centres[labels] + rng.standard_normal((n_samples, intrinsic_dim)) * 0.3
    rotation = _orthonormal_rows(rng, intrinsic_dim, embedding_dim)
    high = low @ rotation
    high += rng.standard_normal((n_samples, embedding_dim)) * 0.01
    return high.astype(np.float32), labels


def generate_quantisation_stress(
    n_samples: int,
    dim: int,
    n_clusters: int,
    spectral_decay: float = 1.5,
    seed: int = 42,
) -> tuple[np.ndarray, np.ndarray]:
    """QuantisationStress suite (commons/mod.rs:547-632)."""
    rng = np.random.default_rng(seed)
    eig = 1.0 / np.power(np.arange(1, dim + 1, dtype=np.float64), spectral_decay)
    sqrt_eig = np.sqrt(eig)

    n_directions = -(-n_clusters // 2)
    radii = np.array([2.0, 8.0, 20.0])
    dirs = rng.standard_normal((n_directions, dim))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)

    centres = np.stack(
        [
            dirs[c % n_directions] * radii[c % 3] * sqrt_eig
            for c in range(n_clusters)
        ]
    )
    labels = _variable_cluster_assignments(rng, n_samples, n_clusters)

    radius = np.maximum(np.linalg.norm(centres, axis=1), 1.0)
    base_std = radius * 0.06
    std = base_std[labels][:, None] * sqrt_eig[None, :]
    data = centres[labels] + rng.standard_normal((n_samples, dim)) * std

    q, _ = np.linalg.qr(rng.standard_normal((dim, dim)))
    return (data @ q).astype(np.float32), labels


def generate_data(
    data: str,
    n_samples: int,
    dim: int,
    n_clusters: int,
    seed: int = 42,
    intrinsic_dim: int = 16,
    spectral_decay: float = 1.5,
    correlation_strength: float = DEFAULT_COR_STRENGTH,
) -> tuple[np.ndarray, np.ndarray]:
    """Dispatch by suite name (commons/mod.rs ``generate_data``)."""
    name = data.lower()
    if name == "correlated":
        return generate_clustered_data_high_dim(
            n_samples, dim, n_clusters, correlation_strength, seed
        )
    if name == "lowrank":
        return generate_low_rank_rotated_data(
            n_samples, dim, intrinsic_dim, n_clusters, seed
        )
    if name in ("quantisation", "quantization"):
        return generate_quantisation_stress(
            n_samples, dim, n_clusters, spectral_decay, seed
        )
    return generate_clustered_data(n_samples, dim, n_clusters, seed)


def subsample_with_noise(
    data: np.ndarray, n_samples: int, seed: int = 42
) -> np.ndarray:
    """Noisy query subsample: σ = 0.05 Gaussian noise, seed offset +1000."""
    rng = np.random.default_rng(seed + 1000)
    n = min(n_samples, data.shape[0])
    idx = rng.permutation(data.shape[0])[:n]
    out = data[idx] + rng.standard_normal((n, data.shape[1])) * 0.05
    return out.astype(np.float32)
