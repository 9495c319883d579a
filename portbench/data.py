"""The benchmark's own data: vectors and query pools made from a seed.

Frozen copies, in plain torch, of the generators the repository's
benchmarks use (``annsearch_tpu_torch/utils/data.py``), so that a change
to the program cannot change what the benchmark feeds it:

* ``clusters``: Gaussian clusters, centres U(-7.5, 7.5), stds U(0.5, 2.5),
  each row's cluster drawn with weight U(0.5, 2.5);
* ``lowrank``: the upstream LowRank suite, ``n_clusters`` centres
  separated by at least half of 3·sqrt(intrinsic_dim) in the intrinsic
  space, balanced labels, σ 0.3 within a cluster, an orthonormal lift to
  ``dim`` and σ 0.01 of noise on top;
* ``noisy_subsample``: queries that are rows of the data plus Gaussian
  noise (σ 0.05 in the configurations).

Everything is drawn on the device by a ``torch.Generator`` in a few large
calls. The structure of a data set (centres, stds, weights, the lift, and
which cluster each row belongs to) comes from the configuration's
``structure_seed``: it is part of the deployment.

``clusters`` rows are one draw from ``structure_seed`` too, and the run's
seed permutes their coordinates: every squared distance, and so every
index cell, its size and the work of a query, is the same for every seed,
while the vectors the program sees differ (an IVF index partitions data by
its values, so rows drawn anew would change the work from seed to seed).
``lowrank`` rows are drawn about their centres from the run's seed: a flat
scan's work does not depend on the values. The queries come from the
run's seed.
"""

from __future__ import annotations

import math

import torch

__all__ = ["make_data", "noisy_subsample", "clusters", "lowrank", "seed_of"]

#: rows drawn per call where a draw is scaled by a per-row parameter
_STEP = 1 << 20


def seed_of(seed: int, stream: int) -> int:
    """A generator seed for one stream of draws of a run: any whole number
    (seeds past 2**31 included) mapped into 0 .. 2**63 - 1."""
    return (int(seed) * 1_000_003 + stream * 7_919) % (1 << 63)


def _gen(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def clusters(n: int, dim: int, n_clusters: int, structure_seed: int, seed: int,
             device) -> torch.Tensor:
    """``[n, dim]`` f32 Gaussian-cluster rows on ``device``: one draw from
    ``structure_seed``, their coordinates permuted by ``seed``."""
    g = _gen("cpu", structure_seed)
    centres = (torch.rand((n_clusters, dim), generator=g) * 15.0 - 7.5).to(device)
    stds = (torch.rand((n_clusters,), generator=g) * 2.0 + 0.5).to(device)
    w = torch.rand((n_clusters,), generator=g) * 2.0 + 0.5
    labels = torch.multinomial(w, n, replacement=True, generator=g).to(device)
    x = torch.empty((n, dim), device=device)
    x.normal_(generator=_gen(device, structure_seed))
    for a in range(0, n, _STEP):
        lab = labels[a : a + _STEP]
        x[a : a + lab.shape[0]].mul_(stds[lab][:, None]).add_(centres[lab])
    return x[:, torch.randperm(dim, generator=_gen("cpu", seed)).to(device)]


def _separated_centres(g: torch.Generator, n_clusters: int, dim: int, scale: float,
                       min_sep: float) -> torch.Tensor:
    """Rejection-sampled centres U(-scale, scale) pairwise at least
    ``min_sep`` apart (float64, host)."""
    out: list[torch.Tensor] = []
    while len(out) < n_clusters:
        cand = (torch.rand((dim,), generator=g, dtype=torch.float64) * 2.0 - 1.0) * scale
        if all(float(((cand - c) ** 2).sum()) >= min_sep**2 for c in out):
            out.append(cand)
    return torch.stack(out)


def lowrank(n: int, dim: int, intrinsic_dim: int, n_clusters: int, structure_seed: int,
            seed: int, device) -> torch.Tensor:
    """``[n, dim]`` f32 LowRank rows on ``device``."""
    if not 0 < intrinsic_dim <= dim:
        raise ValueError(f"intrinsic_dim {intrinsic_dim} not in 1..{dim}")
    g = _gen("cpu", structure_seed)
    sep = math.sqrt(intrinsic_dim) * 3.0
    centres = _separated_centres(g, n_clusters, intrinsic_dim, sep, sep * 0.5)
    q, _ = torch.linalg.qr(torch.randn((dim, intrinsic_dim), generator=g, dtype=torch.float64))
    lift = q.T.float().to(device)                      # [intrinsic, dim], orthonormal rows
    centres = centres.float().to(device)
    labels = (torch.arange(n) % n_clusters)[torch.randperm(n, generator=g)].to(device)
    gen = _gen(device, seed)
    x = torch.empty((n, dim), device=device)
    low = torch.empty((min(n, _STEP), intrinsic_dim), device=device)
    for a in range(0, n, _STEP):
        lab = labels[a : a + _STEP]
        part = low[: lab.shape[0]]
        part.normal_(generator=gen).mul_(0.3).add_(centres[lab])
        torch.matmul(part, lift, out=x[a : a + lab.shape[0]])
    noise = torch.empty_like(x).normal_(generator=gen)
    return x.add_(noise, alpha=0.01)


def make_data(spec: dict, seed: int, device) -> torch.Tensor:
    """The data set a configuration's ``data`` block describes."""
    kind = spec["generator"]
    s = seed_of(seed, 1)
    if kind == "clusters":
        return clusters(spec["n"], spec["dim"], spec["n_clusters"], spec["structure_seed"],
                        s, device)
    if kind == "lowrank":
        return lowrank(spec["n"], spec["dim"], spec["intrinsic_dim"], spec["n_clusters"],
                       spec["structure_seed"], s, device)
    raise ValueError(f"unknown data generator {kind!r}")


def noisy_subsample(x: torch.Tensor, m: int, noise_std: float, seed: int) -> tuple[
        torch.Tensor, torch.Tensor]:
    """``(queries [m, d], source rows [m])``: ``m`` distinct rows of ``x``
    (``m`` at most ``n``) plus N(0, noise_std²) noise."""
    if m > x.shape[0]:
        raise ValueError(f"{m} queries from {x.shape[0]} rows")
    gen = _gen(x.device, seed_of(seed, 2))
    rows = torch.randperm(x.shape[0], generator=gen, device=x.device)[:m]
    noise = torch.empty((m, x.shape[1]), device=x.device).normal_(generator=gen)
    return x[rows] + noise * noise_std, rows
