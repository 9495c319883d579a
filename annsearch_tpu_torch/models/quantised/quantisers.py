"""Quantisers (port of ``annsearch_tpu.models.quantised.quantisers``): the
bf16 codec, the scalar quantiser (SQ8) and the product quantiser in its
scalar-codebook case (``ds = dim / m == 1``).

With one dimension per subspace, each of the m PQ codebooks is a 1-d
k-means over one column, trained for all columns at once on the sorted
rows; the encode is a per-subspace argmin of ``c² − 2·x·c``.
"""

from __future__ import annotations

import torch

__all__ = [
    "bf16_encode", "bf16_decode", "ScalarQuantiser", "ProductQuantiser",
    "N_CLUSTERS_PQ",
]

#: sub-codebook size (fits u8 codes)
N_CLUSTERS_PQ = 256

#: training rows kept for the scalar codebooks (stride sample above this)
SCALAR_TRAIN_CAP = 262_144


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


class ProductQuantiser:
    """``m`` sub-spaces × 256 centroids; only ``ds = dim/m == 1`` is
    ported."""

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
        if d // m != 1:
            raise NotImplementedError(
                "PQ with ds = dim/m > 1 needs the batched subspace k-means "
                "(ROADMAP Queue 1 item 8: _train_subspace_codebooks_batched)"
            )
        if n > SCALAR_TRAIN_CAP:
            x = x[:: n // SCALAR_TRAIN_CAP][:SCALAR_TRAIN_CAP]
        books = _train_scalar_codebooks(
            x.T.contiguous(), min(N_CLUSTERS_PQ, n), iters=max_iters
        )
        if books.shape[1] < N_CLUSTERS_PQ:
            # unused rows sit far away, so they are never the argmin
            pad = torch.full(
                (m, N_CLUSTERS_PQ - books.shape[1], 1), 1e30,
                dtype=torch.float32, device=x.device,
            )
            books = torch.cat([books, pad], dim=1)
        return cls(books, m, d)

    def encode(self, x: torch.Tensor, chunk: int = 2048) -> torch.Tensor:
        """Per-subspace argmin of ``c² − 2·x·c`` (``‖x‖²`` is constant per
        argmin); ties go to the lower code. [n, d] → codes [n, m] uint8."""
        cb = self.codebooks[:, :, 0]          # [m, 256]
        c_sq = cb * cb
        out = [
            torch.argmin(
                c_sq[None] - 2.0 * (x[s : s + chunk, :, None] * cb[None]), dim=-1
            ).to(torch.uint8)
            for s in range(0, x.shape[0], chunk)
        ]
        return torch.cat(out)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        cb = self.codebooks[:, :, 0]
        return cb[torch.arange(self.m, device=cb.device)[None, :], codes.long()]
