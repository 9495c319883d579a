"""Index implementations (the JAX package's list of 23 classes)."""

from .exhaustive import ExhaustiveIndex
from .streaming import StreamingExhaustiveIndex
from .ivf import IvfIndex
from .quantised import (
    ExhaustiveIndexBf16,
    ExhaustiveOpqIndex,
    ExhaustivePqIndex,
    ExhaustiveSq8Index,
    IvfIndexBf16,
    IvfOpqIndex,
    IvfPqIndex,
    IvfSq8Index,
)
from .binary import (
    ExhaustiveIndexBinary,
    ExhaustiveIndexRaBitQ,
    IvfIndexBinary,
    IvfIndexRaBitQ,
)
from .graph import NNDescentIndex
from .hnsw import HnswIndex
from .vamana import VamanaIndex
from .kmknn import KmknnIndex
from .lsh import LSHIndex
from .trees import AnnoyIndex, BallTreeIndex, KdTreeIndex

__all__ = [
    "ExhaustiveIndex",
    "StreamingExhaustiveIndex",
    "IvfIndex",
    "ExhaustiveIndexBf16",
    "ExhaustiveSq8Index",
    "ExhaustivePqIndex",
    "ExhaustiveOpqIndex",
    "IvfIndexBf16",
    "IvfSq8Index",
    "IvfPqIndex",
    "IvfOpqIndex",
    "ExhaustiveIndexBinary",
    "IvfIndexBinary",
    "ExhaustiveIndexRaBitQ",
    "IvfIndexRaBitQ",
    "NNDescentIndex",
    "HnswIndex",
    "VamanaIndex",
    "KmknnIndex",
    "LSHIndex",
    "AnnoyIndex",
    "KdTreeIndex",
    "BallTreeIndex",
]
