"""PQ code tiles (port of ``annsearch_tpu.ops.quantised.pq_decode_tile``).

The JAX package decodes a code tile with a one-hot × codebook einsum, so
that the decode rides the MXU (in bf16 on an accelerator). On the card a
decode is a gather: each output value is one codebook entry, read in f32,
with no rounding at all.
"""

from __future__ import annotations

import torch

__all__ = ["pq_decode_tile"]


def pq_decode_tile(codes_tile: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Decode a ``[t, m]`` uint8 code tile with ``codebooks [m, 256, ds]``
    to ``[t, m·ds]`` f32: subspace j of row i is ``codebooks[j, codes[i,
    j]]``."""
    m = codebooks.shape[0]
    sub = torch.arange(m, device=codebooks.device)[None, :]
    return codebooks[sub, codes_tile.long()].reshape(codes_tile.shape[0], -1)
