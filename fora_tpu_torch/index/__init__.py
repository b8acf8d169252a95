from .build import (BUCKET_BASE, NUM_BUCKETS, WalkIndex, build_walk_index,
                    dedup_index, index_counts, pack_index, pack_index_plain,
                    run_walk_chunks)
from .build_sharded import build_walk_index_sharded, sharded_build_bytes
from .store import (ShardedIndexStore, check_compatible, graph_fingerprint,
                    load, load_meta, save, save_sharded)

__all__ = ["BUCKET_BASE", "NUM_BUCKETS", "WalkIndex", "build_walk_index",
           "dedup_index", "index_counts", "pack_index", "pack_index_plain",
           "run_walk_chunks", "check_compatible",
           "graph_fingerprint", "load", "load_meta", "save", "save_sharded",
           "ShardedIndexStore", "build_walk_index_sharded",
           "sharded_build_bytes"]
