"""Quantised flat scans and PQ code tiles (port of
``annsearch_tpu.ops.quantised``): ``chunked_topk_bf16``,
``chunked_topk_sq8``, ``chunked_topk_pq`` and ``pq_decode_tile``.

The scans stream the database in chunks with a running top-k, as the JAX
functions do; none of them reaches a Pallas kernel there, and none is a
hand-written kernel here. Each chunk's selection breaks ties by the lower
index and the running merge keeps earlier chunks first, so a result does
not depend on the chunk size (``lax.top_k``'s order). Rows at or past
``n_valid`` never win. Numerics, as the JAX package takes them:

* bf16: the query rounded to bf16, the bf16 rows' products exact in f32,
  summed in FP32 (TF32 off; a bf16 ``matmul`` would return bf16 sums);
* SQ8: integer space, bit for bit: the int8 codes' dots are integers whose
  partial sums stay below 2²⁴ over 1,024 columns, so an FP32 product (TF32
  off) is exact there; wider rows sum such column blocks in int64;
* PQ: the decoded rows (a gather of f32 codebook entries) and the query
  rounded to bf16, summed in FP32.

The JAX package decodes a code tile with a one-hot × codebook einsum, so
that the decode rides the MXU (in bf16 on an accelerator). On the card a
decode is a gather: each output value is one codebook entry, read in f32,
with no rounding at all.
"""

from __future__ import annotations

import torch

from ..utils.dist import Dist, _sqrt_f32, fp32_matmul, sq_norms
from .topk import merge_topk, topk_smallest

__all__ = ["chunked_topk_bf16", "chunked_topk_sq8", "chunked_topk_pq", "pq_decode_tile"]

#: columns of one exact FP32 block of an int8 dot (1,024 · 128² = 2²⁴)
SQ8_EXACT_COLS = 1024


def pq_decode_tile(codes_tile: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Decode a ``[t, m]`` uint8 code tile with ``codebooks [m, 256, ds]``
    to ``[t, m·ds]`` f32: subspace j of row i is ``codebooks[j, codes[i,
    j]]``."""
    m = codebooks.shape[0]
    sub = torch.arange(m, device=codebooks.device)[None, :]
    return codebooks[sub, codes_tile.long()].reshape(codes_tile.shape[0], -1)


def _scan(score, n: int, bq: int, k: int, n_valid, db_chunk: int, device):
    """Running top-k over chunks: ``score(base, w)`` gives the ``[bq, w]``
    distances of rows ``base … base + w``. Returns ``(dists [bq, k], ids
    [bq, k])`` ascending."""
    n_valid = n if n_valid is None else int(n_valid)
    best_d = torch.full((bq, k), float("inf"), device=device)
    best_i = torch.zeros((bq, k), dtype=torch.int64, device=device)
    for base in range(0, n, db_chunk):
        w = min(db_chunk, n - base)
        d = score(base, w)
        if base + w > n_valid:
            col = base + torch.arange(w, device=device)
            d = torch.where(col < n_valid, d, float("inf"))
        cd, ci = topk_smallest(d, min(k, w))
        best_d, best_i = merge_topk(best_d, best_i, cd, base + ci, k)
    return best_d, best_i


def chunked_topk_bf16(
    q: torch.Tensor,          # [bq, d] f32 (normalised under cosine)
    x: torch.Tensor,          # [n, d] bf16
    x_sqnorm: torch.Tensor,   # [n] f32, ‖x‖² of the bf16 rows (euclidean)
    k: int,
    metric: Dist,
    n_valid=None,
    db_chunk: int = 16384,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over bf16 rows: the query rounded to bf16, products exact and
    sums f32; ``‖q‖²`` of the unrounded query."""
    q16 = q.to(torch.bfloat16).float()
    q_sq = sq_norms(q)

    def score(base, w):
        with fp32_matmul():     # bf16 products, exact in f32; f32 sums
            dots = q16 @ x[base : base + w].float().T
        if metric == Dist.COSINE:
            return 1.0 - dots
        return torch.clamp(q_sq[:, None] + x_sqnorm[None, base : base + w] - 2.0 * dots, min=0.0)

    return _scan(score, x.shape[0], q.shape[0], k, n_valid, db_chunk, q.device)


def _int8_dots(q_i8: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """``q_i8 · codesᵀ`` exactly, int64: FP32 products (TF32 off) of column
    blocks of at most ``SQ8_EXACT_COLS``, each exact, summed in int64."""
    out = None
    for c in range(0, q_i8.shape[1], SQ8_EXACT_COLS):
        with fp32_matmul():
            part = (q_i8[:, c : c + SQ8_EXACT_COLS].float()
                    @ codes[:, c : c + SQ8_EXACT_COLS].float().T).long()
        out = part if out is None else out + part
    return out


def chunked_topk_sq8(
    q_i8: torch.Tensor,         # [bq, d] int8 (the quantised query)
    codes: torch.Tensor,        # [n, d] int8
    code_sqnorm: torch.Tensor,  # [n] int32 (Σ c², quantised space)
    k: int,
    metric: Dist,
    n_valid=None,
    db_chunk: int = 16384,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Integer-space distances (the reference's SQ8 semantics): euclidean
    ``Σ(q̂ − ĉ)²`` rounded once to f32, cosine ``1 − q̂·ĉ / (‖q̂‖·‖ĉ‖)`` in
    IEEE f32 steps, 1 where either norm is 0."""
    qi = q_i8.long()
    q_sq = (qi * qi).sum(dim=-1)

    def score(base, w):
        dots = _int8_dots(q_i8, codes[base : base + w])
        xs = code_sqnorm[base : base + w].long()
        if metric == Dist.COSINE:
            # IEEE f32 roots: the f64 root rounded once (torch's CPU sqrt
            # of f32 is not correctly rounded for every input)
            denom = _sqrt_f32(q_sq)[:, None] * _sqrt_f32(xs)[None, :]
            return torch.where(denom > 0, 1.0 - dots.float() / denom, 1.0)
        return torch.clamp((q_sq[:, None] + xs[None, :] - 2 * dots).float(), min=0.0)

    return _scan(score, codes.shape[0], q_i8.shape[0], k, n_valid, db_chunk, q_i8.device)


def chunked_topk_pq(
    q: torch.Tensor,            # [bq, d] f32 in codebook space (rotated for OPQ)
    codes: torch.Tensor,        # [n, m] uint8
    code_sqnorm: torch.Tensor,  # [n] f32 = ‖x̂‖²
    codebooks: torch.Tensor,    # [m, 256, d/m] f32
    k: int,
    metric: Dist,
    n_valid=None,
    db_chunk: int = 16384,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over PQ codes: each chunk decoded by :func:`pq_decode_tile`,
    rows and query rounded to bf16, products exact and sums f32 (the JAX
    package rounds the codebooks to bf16 before its decode on the TPU and
    after it on the CPU: both give bf16 of the codebook value). Under
    cosine the dot is divided by ``‖x̂‖`` (x̂ is only about unit)."""
    q16 = q.to(torch.bfloat16).float()
    q_sq = sq_norms(q)

    def score(base, w):
        dec = pq_decode_tile(codes[base : base + w], codebooks).to(torch.bfloat16).float()
        sn = code_sqnorm[base : base + w]
        with fp32_matmul():
            dots = q16 @ dec.T
        if metric == Dist.COSINE:
            return 1.0 - dots / torch.sqrt(torch.clamp(sn, min=1e-12))[None, :]
        return torch.clamp(q_sq[:, None] + sn[None, :] - 2.0 * dots, min=0.0)

    return _scan(score, codes.shape[0], q.shape[0], k, n_valid, db_chunk, q.device)
