from .build import (BUCKET_BASE, NUM_BUCKETS, WalkIndex, build_walk_index,
                    dedup_index, index_counts, pack_index)
from .store import (ShardedIndexStore, check_compatible, graph_fingerprint,
                    load, load_meta, save, save_sharded)

__all__ = ["BUCKET_BASE", "NUM_BUCKETS", "WalkIndex", "build_walk_index",
           "dedup_index", "index_counts", "pack_index", "check_compatible",
           "graph_fingerprint", "load", "load_meta", "save", "save_sharded",
           "ShardedIndexStore"]
