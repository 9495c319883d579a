"""k-means coarse quantiser and the segmented cell layout (port of
``annsearch_tpu.models.kmeans``).

One Lloyd loop: blocked distance matmul → argmin → per-cluster sums. Init
follows the reference's split: D²-weighted seeding for k ≤ 200, random row
picks above. Random draws come from one ``torch.Generator`` seeded from
``seed``; they differ from the JAX package's key stream, so the two
packages' centroids agree in quality (inertia), not in value.

Every matmul here is float32 with TF32 off (``"highest"``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.dist import Dist, matmul_t, normalise, sq_norms

__all__ = [
    "KMEANS_SEED_CAP",
    "train_sample_size",
    "train_centroids",
    "assign_clusters",
    "cluster_sums",
    "SegmentLayout",
    "segment_layout",
]

#: above this k, D²-seeding is replaced by random row picks
KMEANS_SEED_CAP = 200


def train_sample_size(n: int, k: int) -> int:
    """Training-sample cap: min(256·k, 250k) rows."""
    return min(n, min(256 * k, 250_000))


def _assign_chunked(
    x: torch.Tensor, c: torch.Tensor, x_sqnorm: torch.Tensor, chunk: int = 65536
) -> tuple[torch.Tensor, torch.Tensor]:
    """argmin_c ‖x − c‖² per row, blocked over rows; ties go to the first
    centroid. Returns (assignment [n] int64, min squared distance [n])."""
    c_sqnorm = sq_norms(c)
    a, dmin = [], []
    for s in range(0, x.shape[0], chunk):
        d = (
            x_sqnorm[s : s + chunk, None]
            + c_sqnorm[None, :]
            - 2.0 * matmul_t(x[s : s + chunk], c, "highest")
        )
        m, i = torch.min(d, dim=1)
        a.append(i)
        dmin.append(torch.clamp(m, min=0.0))
    return torch.cat(a), torch.cat(dmin)


def assign_clusters(
    x: torch.Tensor, centroids: torch.Tensor, metric: Dist = Dist.EUCLIDEAN,
    chunk: int = 65536,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest centroid of every row. For cosine, callers pass normalised
    rows and centroids: nearest by dot equals nearest by euclidean there."""
    return _assign_chunked(x, centroids, sq_norms(x), chunk=chunk)


def _dsq_seed_init(
    gen: torch.Generator, x: torch.Tensor, k: int
) -> torch.Tensor:
    """D²-weighted sequential seeding: k rounds, each picking a row with
    probability ∝ its squared distance to the chosen set."""
    n = x.shape[0]
    xs = sq_norms(x)
    first = int(torch.randint(0, n, (1,), generator=gen, device=x.device))
    centroids = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    centroids[0] = x[first]
    dmin = ((x - x[first]) ** 2).sum(dim=1)
    for i in range(1, k):
        pick = torch.multinomial(
            torch.clamp(dmin, min=1e-30), 1, generator=gen
        )[0]
        cnew = x[pick]
        centroids[i] = cnew
        d_new = xs + (cnew * cnew).sum() - 2.0 * matmul_t(x, cnew[None], "highest")[:, 0]
        dmin = torch.minimum(dmin, torch.clamp(d_new, min=0.0))
    return centroids


def _random_init(gen: torch.Generator, x: torch.Tensor, k: int) -> torch.Tensor:
    """Shuffle-pick k unique rows."""
    idx = torch.randperm(x.shape[0], generator=gen, device=x.device)[:k]
    return x[idx]


def cluster_sums(
    x: torch.Tensor, a: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster row sums ``[k, d]`` and counts ``[k]`` (int64), in a
    fixed order: rows sorted by cluster (stable), then one segmented sum
    per cluster. ``index_add_`` would add with float atomics on the card,
    in an order that changes from run to run, so two builds from one seed
    would differ."""
    counts = torch.bincount(a, minlength=k)
    order = torch.argsort(a, stable=True)
    sums = torch.segment_reduce(x[order], "sum", lengths=counts, axis=0)
    return sums, counts


def _lloyd(
    x: torch.Tensor,
    init_centroids: torch.Tensor,
    k: int,
    max_iters: int,
    tol: float,
    spherical: bool,
) -> torch.Tensor:
    """Full-GEMM Lloyd iterations; empty clusters keep their centroid,
    ``spherical`` renormalises each iteration. Stops when the total squared
    centroid shift falls to ``tol``."""
    xs = sq_norms(x)
    c = init_centroids
    it = 0
    shift = float("inf")
    while it < max_iters and shift > tol:
        a, _ = _assign_chunked(x, c, xs)
        sums, counts = cluster_sums(x, a, k)
        counts = counts.to(x.dtype)
        new_c = torch.where(
            counts[:, None] > 0, sums / torch.clamp(counts, min=1.0)[:, None], c
        )
        if spherical:
            new_c = normalise(new_c)
        shift = float(((new_c - c) ** 2).sum())
        c = new_c
        it += 1
    return c


def train_centroids(
    x: torch.Tensor,
    k: int,
    metric: Dist = Dist.EUCLIDEAN,
    max_iters: int = 30,
    seed: int = 42,
    tol: float = 1e-4,
) -> torch.Tensor:
    """Train ``k`` centroids on a sample of at most min(256k, 250k) rows of
    ``x``: seed, then Lloyd. Cosine expects normalised ``x`` and returns
    unit centroids (spherical k-means)."""
    n = x.shape[0]
    k = min(k, n)
    gen = torch.Generator(device=x.device).manual_seed(seed)
    x_train = x
    m = train_sample_size(n, k)
    if m < n:
        idx = torch.randperm(n, generator=gen, device=x.device)[:m]
        x_train = x[idx]
    if k <= KMEANS_SEED_CAP:
        init = _dsq_seed_init(gen, x_train, k)
    else:
        init = _random_init(gen, x_train, k)
    return _lloyd(x_train, init, k, max_iters, tol, spherical=metric == Dist.COSINE)


class SegmentLayout:
    """Cluster-sorted storage split into segments of at most ``seg_size``
    rows; a large cell becomes several segments that share its centroid.

    Attributes:
      order:        [n] cluster-sorted permutation of row ids
      seg_offsets:  [nseg] int32 start of each segment in sorted order
      seg_counts:   [nseg] int32 valid rows per segment (≤ seg_size)
      seg_cluster:  [nseg] int32 owner cluster of each segment
      cluster_ptr:  [nlist+1] int64 CSR of segments per cluster
      seg_size:     scan cap
      counts:       [nlist] int32 full cell sizes
    """

    def __init__(self, order, seg_offsets, seg_counts, seg_cluster,
                 cluster_ptr, seg_size, counts):
        self.order = order
        self.seg_offsets = seg_offsets
        self.seg_counts = seg_counts
        self.seg_cluster = seg_cluster
        self.cluster_ptr = cluster_ptr
        self.seg_size = seg_size
        self.counts = counts

    @property
    def nseg(self) -> int:
        return len(self.seg_offsets)


def segment_layout(
    assignments: np.ndarray, nlist: int, seg_size: int | None = None
) -> SegmentLayout:
    """Build the segmented cell layout from cluster assignments (host
    numpy; the same arrays as the JAX package's ``segment_layout``)."""
    a = np.asarray(assignments, dtype=np.int64)
    n = a.shape[0]
    counts = np.bincount(a, minlength=nlist).astype(np.int64)
    order = np.argsort(a, kind="stable").astype(np.int32)
    if seg_size is None:
        mean = max(1, n // max(nlist, 1))
        seg_size = 1 << int(np.ceil(np.log2(max(64, mean))))
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    nseg_c = -(-counts // seg_size)
    cluster_ptr = np.concatenate([[0], np.cumsum(nseg_c)]).astype(np.int64)
    seg_cluster = np.repeat(np.arange(nlist), nseg_c)
    s_in_c = np.arange(len(seg_cluster)) - cluster_ptr[seg_cluster]
    seg_offsets = starts[seg_cluster] + s_in_c * seg_size
    seg_counts = np.minimum(seg_size, counts[seg_cluster] - s_in_c * seg_size)
    return SegmentLayout(
        order,
        seg_offsets.astype(np.int32),
        seg_counts.astype(np.int32),
        seg_cluster.astype(np.int32),
        cluster_ptr,
        seg_size,
        counts.astype(np.int32),
    )
