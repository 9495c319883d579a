from .ivf import IvfPqIndex  # noqa: F401
from .quantisers import ProductQuantiser  # noqa: F401
