from .flat import (  # noqa: F401
    ExhaustiveIndexBf16,
    ExhaustiveOpqIndex,
    ExhaustivePqIndex,
    ExhaustiveSq8Index,
)
from .ivf import IvfIndexBf16, IvfOpqIndex, IvfPqIndex, IvfSq8Index  # noqa: F401
from .quantisers import ProductQuantiser  # noqa: F401
