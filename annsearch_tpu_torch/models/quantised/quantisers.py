"""Quantisers (port of ``annsearch_tpu.models.quantised.quantisers``): the
bf16 codec, the scalar quantiser (SQ8), the product quantiser (PQ) and the
optimised product quantiser (OPQ).

PQ: ``m`` sub-spaces × 256 centroids. With one dimension per subspace
(``ds = dim / m == 1``) each codebook is a 1-d k-means over one column,
trained for all columns at once on the sorted rows; wider subspaces train
by D²-seeded Lloyd (full batch up to 10,000 rows, mini-batch above), all m
subspaces in one batched program. The encode is a per-subspace argmin of
``‖c‖² − 2·x·c``. OPQ alternates a rotation (Procrustes by SVD) with PQ
training on a sample, then trains the final codebooks on the rotated data.

Random draws come from one ``torch.Generator`` seeded from ``seed``; they
differ from the JAX package's key stream, so codebooks of ``ds > 1`` and
rotations agree with it in quality, not in value.
"""

from __future__ import annotations

import torch

from ...ops.quantised import pq_decode_tile
from ...utils.dist import fp32_matmul, matmul_t, sq_norms
from ..kmeans import cluster_sums, train_centroids_minibatch

__all__ = [
    "bf16_encode", "bf16_decode", "ScalarQuantiser", "ProductQuantiser",
    "OptimisedProductQuantiser", "N_CLUSTERS_PQ",
]

#: sub-codebook size (fits u8 codes)
N_CLUSTERS_PQ = 256

#: training rows kept for the scalar codebooks (stride sample above this)
SCALAR_TRAIN_CAP = 262_144

#: full-batch Lloyd up to this many training rows, mini-batch above
PQ_FULL_LLOYD_MAX_N = 10_000

#: OPQ: alternating rounds, and the cap of their training sample
OPQ_ITER = 3
OPQ_SAMPLE_CAP = 50_000


def bf16_encode(x: torch.Tensor) -> torch.Tensor:
    """f32 → bf16, round to nearest even (the JAX package's cast)."""
    return x.to(torch.bfloat16)


def bf16_decode(x: torch.Tensor) -> torch.Tensor:
    return x.float()


class ScalarQuantiser:
    """Per-dimension symmetric int8 quantiser: ``scales[d] = max|x[:, d]| /
    128`` (1.0 for an all-zero dim); encode rounds half away from zero and
    clamps to [-128, 127]. Every step is one IEEE f32 operation, so the
    codes equal the JAX package's bit for bit."""

    def __init__(self, scales: torch.Tensor):
        self.scales = scales  # [d] f32

    @classmethod
    def train(cls, x: torch.Tensor) -> "ScalarQuantiser":
        maxabs = x.abs().max(dim=0).values
        return cls(torch.where(maxabs > 0, maxabs / 128.0, 1.0).float())

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        scaled = x / self.scales
        rounded = torch.trunc(scaled + 0.5 * torch.sign(scaled))
        return torch.clamp(rounded, -128, 127).to(torch.int8)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        return codes.float() * self.scales

    def memory_usage_bytes(self) -> int:
        return self.scales.numel() * 4


def _prefix_sum(v: torch.Tensor, base: int = 16) -> torch.Tensor:
    """Inclusive f32 prefix sum along the last axis, associated as the JAX
    package's CPU ``cumsum`` associates it: left to right within blocks of
    ``base``, plus the prefix of the block totals (recursively). The
    per-bin means are differences of this sum, so the association decides
    their last bits, and with it which side of a midpoint a value falls.
    (``torch.cumsum`` accumulates float32 in float64 on the CPU.)"""
    n = v.shape[-1]
    nb = -(-n // base)
    blocks = torch.nn.functional.pad(v, (0, nb * base - n)).reshape(
        v.shape[:-1] + (nb, base)
    )
    cols = [blocks[..., 0]]
    for i in range(1, base):
        cols.append(cols[-1] + blocks[..., i])
    loc = torch.stack(cols, dim=-1)
    if nb > 1:
        inc = _prefix_sum(loc[..., -1], base)
        loc = loc + torch.nn.functional.pad(inc[..., :-1], (1, 0))[..., None]
    return loc.reshape(v.shape[:-1] + (nb * base,))[..., :n]


def _train_scalar_codebooks(v: torch.Tensor, k: int, iters: int = 25) -> torch.Tensor:
    """Batched 1-d k-means over every row of ``v`` at once.

    Sort once; each Lloyd iteration then needs only the bin boundaries'
    positions in the sorted rows (``searchsorted`` of the midpoints, the
    count of values strictly below each), and per-bin sums are differences
    of a prefix sum. Quantile init, deterministic.

    v: [m, n] → codebooks [m, k, 1], sorted ascending per row.
    """
    m, n = v.shape
    vs = torch.sort(v, dim=1).values.contiguous()
    cums = torch.cat(
        [torch.zeros((m, 1), dtype=torch.float32, device=v.device),
         _prefix_sum(vs)],
        dim=1,
    )
    # quantile init (float32, as in the JAX package; its linspace may differ
    # from torch's in the last place, which can move an index by one row)
    q = torch.linspace(0.5 / k, 1.0 - 0.5 / k, k, dtype=torch.float32)
    qidx = torch.clamp((q * (n - 1)).to(torch.int64), 0, n - 1).to(v.device)
    c = vs[:, qidx]
    edge_lo = torch.zeros((m, 1), dtype=torch.int64, device=v.device)
    edge_hi = torch.full((m, 1), n, dtype=torch.int64, device=v.device)
    for _ in range(iters):
        bounds = ((c[:, 1:] + c[:, :-1]) * 0.5).contiguous()
        pos = torch.cat(
            [edge_lo, torch.searchsorted(vs, bounds, side="left"), edge_hi], dim=1
        )
        cnt = (pos[:, 1:] - pos[:, :-1]).float()
        csel = torch.gather(cums, 1, pos)
        sums = csel[:, 1:] - csel[:, :-1]
        c_new = torch.where(cnt > 0, sums / torch.clamp(cnt, min=1.0), c)
        c = torch.sort(c_new, dim=1).values
    return c[:, :, None]


def _dsq_seed_init_batched(gen: torch.Generator, xs: torch.Tensor, k: int) -> torch.Tensor:
    """D²-weighted sequential seeding of every subspace at once: ``xs [m,
    n, ds]`` → ``[m, k, ds]``; each of the k rounds picks, per subspace, a
    row with probability ∝ its squared distance to the rows chosen so far."""
    m, n, ds = xs.shape
    sub = torch.arange(m, device=xs.device)
    sq = sq_norms(xs)
    first = torch.randint(0, n, (m,), generator=gen, device=xs.device)
    c = torch.zeros((m, k, ds), dtype=xs.dtype, device=xs.device)
    c[:, 0] = xs[sub, first]
    dmin = ((xs - c[:, :1]) ** 2).sum(dim=-1)
    for i in range(1, k):
        pick = torch.multinomial(torch.clamp(dmin, min=1e-30), 1, generator=gen)[:, 0]
        cnew = xs[sub, pick]
        c[:, i] = cnew
        d_new = sq + sq_norms(cnew)[:, None] - 2.0 * matmul_t(xs, cnew[:, None, :], "highest")[:, :, 0]
        dmin = torch.minimum(dmin, torch.clamp(d_new, min=0.0))
    return c


def _lloyd_batched(
    xs: torch.Tensor, c: torch.Tensor, max_iters: int, tol: float = 1e-5, chunk: int = 4096
) -> torch.Tensor:
    """Full Lloyd iterations of every subspace at once (``xs [m, n, ds]``,
    ``c [m, k, ds]``). A subspace stops moving once its total squared
    centroid shift falls to ``tol``; empty clusters keep their centroid."""
    m, n, ds = xs.shape
    k = c.shape[1]
    sq = sq_norms(xs)
    base = torch.arange(m, device=xs.device)[:, None] * k
    active = torch.ones(m, dtype=torch.bool, device=xs.device)
    for _ in range(max_iters):
        csq = sq_norms(c)
        a = torch.cat([
            torch.argmin(
                sq[:, s : s + chunk, None] + csq[:, None, :]
                - 2.0 * matmul_t(xs[:, s : s + chunk], c, "highest"),
                dim=2,
            )
            for s in range(0, n, chunk)
        ], dim=1)
        sums, counts = cluster_sums(xs.reshape(-1, ds), (a + base).reshape(-1), m * k)
        counts = counts.reshape(m, k, 1).to(xs.dtype)
        new_c = torch.where(counts > 0, sums.reshape(m, k, ds) / torch.clamp(counts, min=1.0), c)
        shift = ((new_c - c) ** 2).sum(dim=(1, 2))
        c = torch.where(active[:, None, None], new_c, c)
        active = active & (shift > tol)
        if not bool(active.any()):
            break
    return c


def _train_subspace_codebooks_batched(
    xs: torch.Tensor, k: int, seed: int, max_iters: int = 25
) -> torch.Tensor:
    """Train all m sub-codebooks in one batched program: ``xs [m, n, ds]``
    → ``[m, k, ds]``. D² seeding, then full Lloyd for n ≤ 10,000 rows, else
    Sculley mini-batch steps of 10,240 rows."""
    gen = torch.Generator(device=xs.device).manual_seed(seed)
    init = _dsq_seed_init_batched(gen, xs, k)
    if xs.shape[1] <= PQ_FULL_LLOYD_MAX_N:
        return _lloyd_batched(xs, init, max_iters)
    return train_centroids_minibatch(xs, init, k, gen, iters=max_iters, batch=10_240)


def _encode_pq(x: torch.Tensor, codebooks: torch.Tensor, chunk: int = 4096) -> torch.Tensor:
    """Per-subspace argmin of ``‖c‖² − 2·x·c`` (``‖x‖²`` is constant per
    argmin), fp32 with TF32 off; ties go to the lower code. ``x [n, d]``,
    ``codebooks [m, 256, ds]`` → codes ``[n, m]`` uint8."""
    m, _, ds = codebooks.shape
    c_sq = (codebooks * codebooks).sum(dim=-1)            # [m, 256]
    out = []
    with fp32_matmul():
        for s in range(0, x.shape[0], chunk):
            xb = x[s : s + chunk].reshape(-1, m, ds)
            if ds == 1:
                # one product per entry: elementwise (a batched matmul of
                # depth 1 is a poor shape for the library)
                dots = xb * codebooks[None, :, :, 0]
            else:
                dots = torch.einsum("cjd,jkd->cjk", xb, codebooks)
            out.append(torch.argmin(c_sq[None] - 2.0 * dots, dim=-1).to(torch.uint8))
    return torch.cat(out)


class ProductQuantiser:
    """``m`` sub-spaces × 256 centroids; ``dim % m == 0`` and ``dim ≥ 32``."""

    def __init__(self, codebooks: torch.Tensor, m: int, dim: int):
        self.codebooks = codebooks  # [m, 256, dim // m] f32
        self.m = m
        self.dim = dim

    @classmethod
    def train(
        cls, x: torch.Tensor, m: int, seed: int = 42, max_iters: int = 25
    ) -> "ProductQuantiser":
        n, d = x.shape
        if d % m != 0:
            raise ValueError(f"dim {d} not divisible by m={m}")
        if d < 32:
            raise ValueError("PQ requires dim >= 32")
        ds = d // m
        k = min(N_CLUSTERS_PQ, n)
        if ds == 1:
            if n > SCALAR_TRAIN_CAP:
                x = x[:: n // SCALAR_TRAIN_CAP][:SCALAR_TRAIN_CAP]
            books = _train_scalar_codebooks(x.T.contiguous(), k, iters=max_iters)
        else:
            xs = x.reshape(n, m, ds).transpose(0, 1).contiguous()   # [m, n, ds]
            books = _train_subspace_codebooks_batched(xs, k, seed, max_iters)
        if k < N_CLUSTERS_PQ:
            # unused rows sit far away, so they are never the argmin
            pad = torch.full(
                (m, N_CLUSTERS_PQ - k, ds), 1e30, dtype=torch.float32, device=x.device
            )
            books = torch.cat([books, pad], dim=1)
        return cls(books, m, d)

    def encode(self, x: torch.Tensor, chunk: int = 4096) -> torch.Tensor:
        """[n, d] → codes [n, m] uint8."""
        return _encode_pq(x, self.codebooks, chunk)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """Gather decode, [n, m] → [n, d] f32."""
        return pq_decode_tile(codes, self.codebooks)

    def code_sqnorms(self, codes: torch.Tensor) -> torch.Tensor:
        """``‖decode(code)‖²`` per row from the sub-space squared-norm
        table, summed subspace by subspace in order (the JAX package's
        order, so the f32 sums agree)."""
        sn = (self.codebooks * self.codebooks).sum(dim=-1)   # [m, 256]
        total = torch.zeros(codes.shape[0], device=codes.device)
        for j in range(self.m):
            total = total + sn[j][codes[:, j].long()]
        return total

    def memory_usage_bytes(self) -> int:
        return self.codebooks.numel() * 4


class OptimisedProductQuantiser:
    """OPQ: a learned orthogonal rotation, then PQ. ``OPQ_ITER`` rounds on
    a sample of at most ``OPQ_SAMPLE_CAP`` rows, each of rotate → train PQ
    (10 iterations) → reconstruct → Procrustes (``min_R ‖XR − Y‖`` by the
    SVD of ``XᵀY``), then the final codebooks on all the rotated rows."""

    def __init__(self, pq: ProductQuantiser, rotation: torch.Tensor):
        self.pq = pq
        self.rotation = rotation  # [d, d]
        self.m = pq.m
        self.dim = pq.dim

    @classmethod
    def train(
        cls, x: torch.Tensor, m: int, seed: int = 42, max_iters: int = 25
    ) -> "OptimisedProductQuantiser":
        n, d = x.shape
        xs = x
        if n > OPQ_SAMPLE_CAP:
            gen = torch.Generator(device=x.device).manual_seed(seed)
            xs = x[torch.randperm(n, generator=gen, device=x.device)[:OPQ_SAMPLE_CAP]]
        rot = torch.eye(d, dtype=torch.float32, device=x.device)
        with fp32_matmul():
            for it in range(OPQ_ITER):
                xr = xs @ rot
                pq = ProductQuantiser.train(xr, m, seed=seed + 1000 * it, max_iters=10)
                y = pq.decode(pq.encode(xr))
                u, _, vh = torch.linalg.svd(xs.T @ y, full_matrices=False)
                rot = u @ vh
            pq = ProductQuantiser.train(x @ rot, m, seed=seed, max_iters=max_iters)
        return cls(pq, rot)

    def rotate(self, x: torch.Tensor) -> torch.Tensor:
        with fp32_matmul():
            return x @ self.rotation

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.pq.encode(self.rotate(x))

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """Decode to the original (un-rotated) space."""
        with fp32_matmul():
            return self.pq.decode(codes) @ self.rotation.T

    def memory_usage_bytes(self) -> int:
        return self.pq.memory_usage_bytes() + self.rotation.numel() * 4
