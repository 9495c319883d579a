"""annsearch_tpu_torch — the PyTorch and CUDA port of ``annsearch_tpu``.

The JAX package stays the reference; module names here mirror it. Plain
tensor code is PyTorch; each Pallas kernel of the JAX package becomes a
CUDA kernel written for Hopper (``csrc/``), built at first use into
``_build/``.

Layout:
  * ``ops``     — running top-k (exact, bins and fused selectors), the
    fused flat scan, the quantised flat scans, task-list inversion, the
    fused IVF scan, the cluster scan, PQ decode, the binary scans, the
    approximate graph build (partition joins, NN-descent rounds), graph
    pruning and beam search
  * ``models``  — indexes (exhaustive, streaming exhaustive, flat bf16 /
    SQ8 / PQ / OPQ, IVF, bf16 / SQ8 IVF, IVF-PQ, IVF-OPQ, binary and
    RaBitQ, NNDescent, HNSW, Vamana, trees, LSH, kMkNN), quantisers and
    k-means
  * ``utils``   — distances, synthetic data (host and device), metrics,
    validation, profiling
  * ``parallel`` — the sharding layer: grids of logical shards on one card,
    carried across ``torch.distributed`` ranks (sharded exhaustive, IVF,
    IVF-PQ and graph indexes)
  * ``interop`` — index state carried over from the JAX package
"""

from .lib import *  # noqa: F401,F403
from .lib import __all__ as _lib_all
from .utils import Dist, parse_ann_dist  # noqa: F401
from .utils.metrics import calculate_recall  # noqa: F401
from .utils.validation import validate_index  # noqa: F401

__all__ = list(_lib_all) + ["Dist", "parse_ann_dist", "validate_index", "calculate_recall"]
