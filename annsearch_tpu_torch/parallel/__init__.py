"""The sharding layer: grids of logical shards on one card, carried across
``torch.distributed`` ranks (port of ``annsearch_tpu.parallel``)."""

from .graph_sharded import ShardedGraphIndex, ring_self_knn
from .ivf_sharded import (
    ShardedIvfIndex,
    ShardedIvfPqIndex,
    train_centroids_sharded,
)
from .mesh import BATCH_AXIS, DB_AXIS, make_mesh, make_mesh2d
from .sharded import (
    BatchShardedExhaustive,
    GridShardedExhaustive,
    ShardedExhaustive,
    batch_sharded_topk,
    grid_sharded_topk,
    sharded_topk,
)

__all__ = [
    "BATCH_AXIS",
    "DB_AXIS",
    "make_mesh",
    "make_mesh2d",
    "ShardedExhaustive",
    "BatchShardedExhaustive",
    "GridShardedExhaustive",
    "ShardedGraphIndex",
    "ShardedIvfIndex",
    "ShardedIvfPqIndex",
    "ring_self_knn",
    "sharded_topk",
    "batch_sharded_topk",
    "grid_sharded_topk",
    "train_centroids_sharded",
]
