"""Index self-validation: recall@k of an index against an exact scan (port
of ``annsearch_tpu.utils.validation``).

Samples at most ``n_samples`` stored rows, takes their exact top-k from the
port's ``ExhaustiveIndex`` over the index's rows in original order, queries
the index with the same rows, and reports recall@k.
"""

from __future__ import annotations

import numpy as np

from .metrics import calculate_recall

__all__ = ["validate_index"]


def validate_index(
    index,
    k: int = 15,
    seed: int = 42,
    n_samples: int = 1000,
    **query_kwargs,
) -> float:
    """Recall@k of ``index.query`` against the exact scan on sampled stored
    rows (``np.random.default_rng(seed)``, as the JAX package samples them).
    The exact scan runs on the index's device."""
    from ..models.exhaustive import ExhaustiveIndex

    vecs = index.vectors_original_order()
    n = vecs.shape[0]
    sample = np.random.default_rng(seed).permutation(n)[: min(n_samples, n)]
    queries = vecs[sample]
    exact = ExhaustiveIndex(vecs, index.metric.value, device=vecs.device)
    true_idx, _ = exact.query(queries, k)
    approx_idx, _ = index.query(queries, k, **query_kwargs)
    return calculate_recall(true_idx, approx_idx, k)
