"""Utility layer: distances, data generators, metrics, validation."""

from .dist import (
    Dist,
    normalise,
    norms,
    pairwise_cosine,
    pairwise_dist,
    pairwise_sq_euclidean,
    parse_ann_dist,
    sq_norms,
)
from .metrics import (
    calculate_cluster_purity,
    calculate_mean_distance_ratio,
    calculate_recall,
)
from .validation import validate_index

__all__ = [
    "Dist",
    "parse_ann_dist",
    "sq_norms",
    "norms",
    "normalise",
    "pairwise_sq_euclidean",
    "pairwise_cosine",
    "pairwise_dist",
    "calculate_recall",
    "calculate_mean_distance_ratio",
    "calculate_cluster_purity",
    "validate_index",
]
