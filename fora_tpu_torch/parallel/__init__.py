"""The graph-sharded engines: row partitioning, the shard devices and
query groups, the frontier exchange, the one-shot indexed top-k and the
refinement pool, and the sharded graph store."""

from .graph_store import ShardedGraphStore, save_sharded_graph
from .mesh import make_mesh
from .partition import (PartitionedGraph, PartitionedIndex, host_groups,
                        needed_host_masks, needed_masks, partition_index,
                        partition_rows)
from .sharded import (ShardedForaEngine, ShardedTopkResult,
                      ShardedTopkRunner, exchange_bytes_model)
from ..ops.exchange import hier_ici_bytes_model

__all__ = ["make_mesh", "PartitionedGraph", "PartitionedIndex",
           "partition_rows", "partition_index", "needed_masks",
           "needed_host_masks", "host_groups", "ShardedForaEngine",
           "ShardedTopkRunner", "ShardedTopkResult",
           "exchange_bytes_model", "hier_ici_bytes_model",
           "ShardedGraphStore", "save_sharded_graph"]
