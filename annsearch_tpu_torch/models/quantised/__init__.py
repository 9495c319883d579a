"""Quantised indexes: bf16 / SQ8 / PQ / OPQ storage."""

from .flat import (
    ExhaustiveIndexBf16,
    ExhaustiveOpqIndex,
    ExhaustivePqIndex,
    ExhaustiveSq8Index,
)
from .ivf import IvfIndexBf16, IvfOpqIndex, IvfPqIndex, IvfSq8Index
from .quantisers import (
    OptimisedProductQuantiser,
    ProductQuantiser,
    ScalarQuantiser,
    bf16_decode,
    bf16_encode,
)

__all__ = [
    "ExhaustiveIndexBf16",
    "ExhaustiveSq8Index",
    "ExhaustivePqIndex",
    "ExhaustiveOpqIndex",
    "IvfIndexBf16",
    "IvfSq8Index",
    "IvfPqIndex",
    "IvfOpqIndex",
    "ScalarQuantiser",
    "ProductQuantiser",
    "OptimisedProductQuantiser",
    "bf16_encode",
    "bf16_decode",
]
