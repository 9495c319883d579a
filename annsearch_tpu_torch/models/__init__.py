from .exhaustive import ExhaustiveIndex  # noqa: F401
from .quantised.ivf import IvfPqIndex  # noqa: F401
