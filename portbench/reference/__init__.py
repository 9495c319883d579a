"""The benchmark's plain reference (``exact``): plain torch, no import of the
program or of JAX."""

from .exact import (LOWER_PRECISION, METRICS, check_metric, control_knn, distances_of,
                    exact_knn)

__all__ = ["LOWER_PRECISION", "METRICS", "check_metric", "control_knn", "distances_of",
           "exact_knn"]
