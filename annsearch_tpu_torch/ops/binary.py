"""Binary codes: bit packing, Hamming scans, asymmetric scoring (port of
``annsearch_tpu.ops.binary``).

Codes are unpacked per chunk to ±1 and the Hamming distance falls out of a
dense product, ``dot±(q, x) = nbits − 2·hamming(q, x)``: products of ±1
are exact and their sums are integers below 2²⁴, exact in f32. The scan is
then the same product-and-running-top-k shape as every other index. The
XOR + popcount form (``hamming_popcount``) is the parity reference.

Words: the JAX package packs bits into uint32 words (little-endian bits
within a word). PyTorch has no uint32 arithmetic on every backend, so the
port holds each word's 32 bits as an **int32** bit pattern (the same bits:
``uint32.view(int32)``); the top bit is the sign. Every caller passes
words as int32 and reads bit ``b`` of a word as ``(w >> b) & 1``, which
the arithmetic shift leaves right.

Selection is tie-exact (``ops.topk.topk_smallest``: ascending, ties to the
lower row, ``lax.top_k``'s order): Hamming distances are small integers,
so nearly every query ties at its k-th rank, and the ids must be the JAX
package's.

Precision: the products are float32 with TF32 off. For the Hamming scan
the ±1 operands make any grade exact. The asymmetric scan is the JAX
package's DEFAULT precision, "one bf16 pass with f32 accumulation": the
query is rounded to bf16 (as ``chunked_topk_asymmetric`` rounds it) and
the ±1 codes are exact, so every product is exact and the sums are f32.
"""

from __future__ import annotations

import torch

from ..utils.dist import fp32_matmul
from .topk import merge_topk, topk_smallest

__all__ = [
    "pack_bits",
    "unpack_bits",
    "unpack_pm1",
    "hamming_popcount",
    "chunked_topk_hamming",
    "chunked_topk_asymmetric",
    "topk_pm1",
]

_SHIFTS = torch.arange(32, dtype=torch.int64)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack a boolean ``[n, nbits]`` matrix into ``[n, w]`` words held as
    int32 bit patterns (little-endian bits within a word); nbits is padded
    to a multiple of 32 with zero bits."""
    b = torch.as_tensor(bits).to(torch.int64)
    n, nbits = b.shape
    pad = (-nbits) % 32
    if pad:
        b = torch.nn.functional.pad(b, (0, pad))
    words = (b.reshape(n, -1, 32) << _SHIFTS.to(b.device)).sum(dim=-1)   # [0, 2³²)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def unpack_bits(codes: torch.Tensor, nbits: int) -> torch.Tensor:
    """Unpack ``[t, w]`` int32 words → ``[t, nbits]`` {0, 1} int32."""
    t, w = codes.shape
    shifts = _SHIFTS.to(device=codes.device, dtype=torch.int32)
    bits = (codes[:, :, None] >> shifts) & 1
    return bits.reshape(t, w * 32)[:, :nbits]


def unpack_pm1(codes: torch.Tensor, nbits: int, dtype=torch.bfloat16) -> torch.Tensor:
    """Unpack to ±1 (bfloat16 as the JAX package's matmul operand, or the
    given ``dtype``: every value is exact in any float type)."""
    return unpack_bits(codes, nbits).to(dtype) * 2 - 1


def _popcount32(v: torch.Tensor) -> torch.Tensor:
    """Bits set in each int32 word (SWAR on the word's unsigned value)."""
    v = v.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_popcount(q_codes: torch.Tensor, x_codes: torch.Tensor) -> torch.Tensor:
    """Hamming distances by XOR and popcount: ``[bq, w] × [t, w] → [bq, t]``
    int32. The parity reference of the ±1 product."""
    x = q_codes[:, None, :] ^ x_codes[None, :, :]
    return _popcount32(x).sum(dim=-1).to(torch.int32)


def topk_pm1(
    q: torch.Tensor,      # [bq, nbits] f32: ±1 query codes, or (bf16-valued) projections
    rows,                 # callable (start, stop) → [stop − start, nbits] f32 ±1 rows
    n: int,
    k: int,
    hamming: bool,
    n_valid: int | None = None,
    db_chunk: int = 8192,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Running top-k of the ±1 product over ``n`` rows, chunk by chunk:
    ``(nbits − dot)/2`` (the Hamming distance) when ``hamming``, else
    ``−dot`` (the asymmetric score, higher dot = closer). Rows at or past
    ``n_valid`` never win. Returns ``(dists [bq, k] f32, rows [bq, k]
    int64)`` ascending, ties to the lower row."""
    n_valid = n if n_valid is None else n_valid
    bq, nbits = q.shape
    best_d = torch.full((bq, k), float("inf"), device=q.device)
    best_i = torch.zeros((bq, k), dtype=torch.int64, device=q.device)
    qf = q.float()
    for base in range(0, n, db_chunk):
        xc = rows(base, min(base + db_chunk, n))
        with fp32_matmul():
            dot = qf @ xc.T
        d = (nbits - dot) * 0.5 if hamming else -dot
        if base + xc.shape[0] > n_valid:
            col = base + torch.arange(xc.shape[0], device=q.device)
            d = torch.where(col < n_valid, d, float("inf"))
        cd, ci = topk_smallest(d, min(k, xc.shape[0]))
        best_d, best_i = merge_topk(best_d, best_i, cd, base + ci, k)
    return best_d, best_i


def chunked_topk_hamming(
    q_codes: torch.Tensor,   # [bq, w] int32 words
    codes: torch.Tensor,     # [n, w] int32 words
    k: int,
    nbits: int,
    n_valid: int | None = None,
    db_chunk: int = 8192,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k smallest Hamming distances by the ±1 product, the codes
    unpacked a chunk at a time. Returns ``(dists, rows)`` ascending."""
    q_pm = unpack_pm1(q_codes, nbits, torch.float32)
    return topk_pm1(
        q_pm, lambda a, b: unpack_pm1(codes[a:b], nbits, torch.float32),
        codes.shape[0], k, True, n_valid, db_chunk,
    )


def chunked_topk_asymmetric(
    q_proj: torch.Tensor,    # [bq, nbits] f32 query in projection space
    codes: torch.Tensor,     # [n, w] int32 words
    k: int,
    nbits: int,
    n_valid: int | None = None,
    db_chunk: int = 8192,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Asymmetric scoring: the float query projections (rounded to bf16:
    the JAX package's single bf16 pass) × ±1 codes, f32 sums. Returns the
    negated dot as the distance (higher dot = closer), ascending."""
    q16 = q_proj.to(torch.bfloat16).float()
    return topk_pm1(
        q16, lambda a, b: unpack_pm1(codes[a:b], nbits, torch.float32),
        codes.shape[0], k, False, n_valid, db_chunk,
    )
