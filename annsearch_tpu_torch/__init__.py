"""annsearch_tpu_torch — the PyTorch and CUDA port of ``annsearch_tpu``.

The JAX package stays the reference; module names here mirror it. Plain
tensor code is PyTorch; each Pallas kernel of the JAX package becomes a
CUDA kernel written for Hopper (``csrc/``), built at first use into
``_build/``.

Layout:
  * ``ops``     — running top-k, task-list inversion, the fused IVF scan
  * ``models``  — indexes (exhaustive, IVF, IVF-PQ) and k-means
  * ``utils``   — distances, synthetic data, metrics
  * ``interop`` — index state carried over from the JAX package
"""

from .lib import *  # noqa: F401,F403
from .lib import __all__ as _lib_all
from .utils import Dist, parse_ann_dist  # noqa: F401
from .utils.metrics import calculate_recall  # noqa: F401

__all__ = list(_lib_all) + ["Dist", "parse_ann_dist", "calculate_recall"]
