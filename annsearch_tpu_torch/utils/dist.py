"""Distance metric plumbing (PyTorch port of ``annsearch_tpu.utils.dist``).

Every distance funnels into one matmul identity

    euclidean²(q, x) = ‖q‖² + ‖x‖² − 2 q·x
    cosine(q, x)     = 1 − q·x           (rows stored pre-normalised)

with the reference's semantics: ``euclidean`` is the *squared* L2 distance,
``cosine`` is ``1 − similarity``, unknown metric strings fall back to
euclidean.

Precision is an explicit argument of every matmul. The one value in use
is ``"highest"``: a float32 product with TF32 off (f32 grade). The fused
scan kernels take their products on the tensor cores as the JAX package's
kernels take them on the MXU: bf16 terms of a mantissa split
(:func:`mantissa_split`), summed over the cross terms of :data:`CROSS`.
"""

from __future__ import annotations

import contextlib
import enum

import torch

__all__ = [
    "Dist",
    "parse_ann_dist",
    "sq_norms",
    "norms",
    "normalise",
    "matmul_t",
    "fp32_matmul",
    "mantissa_split",
    "CROSS",
    "cross_packed",
    "pairwise_sq_euclidean",
    "pairwise_cosine",
    "pairwise_dist",
]


class Dist(enum.Enum):
    """Supported distance metrics."""

    EUCLIDEAN = "euclidean"
    COSINE = "cosine"


def parse_ann_dist(name: str | Dist) -> Dist:
    """Parse a metric string; anything but ``"cosine"`` is euclidean."""
    if isinstance(name, Dist):
        return name
    if str(name).strip().lower() == "cosine":
        return Dist.COSINE
    return Dist.EUCLIDEAN


@contextlib.contextmanager
def fp32_matmul():
    """Run float32 matmuls at full fp32 inside the block (TF32 off), and
    restore the caller's setting after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


#: cross terms of the mantissa split summed per term count — (a, b) means
#: q_part[a] · x_part[b] (the JAX package's ``flat_scan_pallas._CROSS``):
#: 2-way drops lo·lo (~2⁻³⁰ relative), 3-way keeps the six largest of nine
CROSS = {
    1: ((0, 0),),
    2: ((0, 0), (0, 1), (1, 0)),
    3: ((0, 0), (0, 1), (1, 0), (0, 2), (2, 0), (1, 1)),
}


def mantissa_split(x: torch.Tensor, parts: int) -> tuple[torch.Tensor, ...]:
    """Split f32 into ``parts`` bf16 terms, ``x ≈ Σ terms``, as the JAX
    package's ``mantissa_split``: each head term is the residual rounded to
    bf16 by integer add-then-mask (``(bits + 0x8000) & 0xFFFF0000``, half-way
    cases away from zero), the last term the residual rounded to nearest
    even. One term is ``bf16_rne(x)``; three are exact for normal f32."""
    terms = []
    r = x.float()
    for _ in range(parts - 1):
        hi = ((r.view(torch.int32) + 0x8000) & -65536).view(torch.float32)
        terms.append(hi.to(torch.bfloat16))
        r = r - hi
    terms.append(r.to(torch.bfloat16))
    return tuple(terms)


def cross_packed(q: torch.Tensor, x: torch.Tensor, parts: int):
    """``(qp, xp)`` f32 with ``qp · xpᵀ`` the sum of the :data:`CROSS`
    products of the ``parts``-way splits of ``q [.., d]`` and ``x [.., d]``:
    the pairs' terms side by side along the last axis, so one matmul sums
    them (in f32, every product of two bf16 terms exact)."""
    qs, xs = mantissa_split(q, parts), mantissa_split(x, parts)
    pairs = CROSS[parts]
    return (torch.cat([qs[a].float() for a, _ in pairs], dim=-1),
            torch.cat([xs[b].float() for _, b in pairs], dim=-1))


def sq_norms(x: torch.Tensor) -> torch.Tensor:
    """Row-wise squared L2 norms, f32 accumulate."""
    x = x.float()
    return (x * x).sum(dim=-1)


def _sqrt_f32(v: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root of the f32 value of ``v``: the
    f64 root rounded once. torch's CPU ``sqrt`` of f32 misrounds about 0.6%
    of inputs by an ulp; the card's ``__fsqrt_rn`` is IEEE."""
    return torch.sqrt(v.float().double()).float()


def norms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(sq_norms(x))


def normalise(x: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    """L2-normalise rows (zero rows stay zero)."""
    return x / torch.clamp(norms(x), min=eps)[..., None]


def matmul_t(q: torch.Tensor, x: torch.Tensor, precision: str) -> torch.Tensor:
    """``q · xᵀ`` in float32 at the stated precision."""
    if precision != "highest":
        raise ValueError(f"precision must be 'highest', got {precision!r}")
    with fp32_matmul():
        return q.float() @ x.float().transpose(-1, -2)


def pairwise_sq_euclidean(
    q: torch.Tensor,
    x: torch.Tensor,
    x_sqnorm: torch.Tensor | None = None,
    q_sqnorm: torch.Tensor | None = None,
    precision: str = "highest",
) -> torch.Tensor:
    """Squared euclidean distance matrix ``[nq, nx]``, clamped at 0."""
    if x_sqnorm is None:
        x_sqnorm = sq_norms(x)
    if q_sqnorm is None:
        q_sqnorm = sq_norms(q)
    d = q_sqnorm[..., :, None] + x_sqnorm[..., None, :] - 2.0 * matmul_t(
        q, x, precision
    )
    return torch.clamp(d, min=0.0)


def pairwise_cosine(
    q_normed: torch.Tensor, x_normed: torch.Tensor, precision: str = "highest"
) -> torch.Tensor:
    """Cosine distance matrix ``1 − QXᵀ`` for pre-normalised inputs."""
    return 1.0 - matmul_t(q_normed, x_normed, precision)


def pairwise_dist(
    q: torch.Tensor,
    x: torch.Tensor,
    metric: Dist,
    x_sqnorm: torch.Tensor | None = None,
    precision: str = "highest",
) -> torch.Tensor:
    """Distance matrix under ``metric`` (cosine inputs pre-normalised)."""
    if metric == Dist.COSINE:
        return pairwise_cosine(q, x, precision)
    return pairwise_sq_euclidean(q, x, x_sqnorm=x_sqnorm, precision=precision)
