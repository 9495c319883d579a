"""Kernel layer: distance matmuls, running top-k, the fused scans (CUDA),
quantised and binary scans, graph operations."""

from .topk import blocked_query_topk, chunked_topk, merge_topk, topk_smallest

__all__ = [
    "topk_smallest",
    "merge_topk",
    "chunked_topk",
    "blocked_query_topk",
]
