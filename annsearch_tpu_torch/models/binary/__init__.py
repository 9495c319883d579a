"""Binary indexes: SimHash / PCA / sign binarisation and RaBitQ (port of
``annsearch_tpu.models.binary``)."""

from .binariser import Binariser
from .flat import ExhaustiveIndexBinary
from .ivf import IvfIndexBinary
from .rabitq import ExhaustiveIndexRaBitQ, IvfIndexRaBitQ, RaBitQEncoder
from .vec_store import DeviceVectorStore, MmapVectorStore

__all__ = [
    "Binariser",
    "ExhaustiveIndexBinary",
    "IvfIndexBinary",
    "DeviceVectorStore",
    "MmapVectorStore",
    "RaBitQEncoder",
    "ExhaustiveIndexRaBitQ",
    "IvfIndexRaBitQ",
]
