"""The graph-sharded engine: row partitioning, the shard devices, and the
one-shot indexed top-k over the ring exchange (P1, P2)."""

from .mesh import make_mesh
from .partition import (PartitionedGraph, PartitionedIndex, partition_index,
                        partition_rows)
from .sharded import (EXCHANGE_MODES, ShardedForaEngine, ShardedTopkResult,
                      exchange_bytes_model)

__all__ = ["make_mesh", "PartitionedGraph", "PartitionedIndex",
           "partition_rows", "partition_index", "ShardedForaEngine",
           "ShardedTopkResult", "EXCHANGE_MODES", "exchange_bytes_model"]
