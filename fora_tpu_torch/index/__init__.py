from .build import (BUCKET_BASE, NUM_BUCKETS, WalkIndex, build_walk_index,
                    dedup_index, index_counts, pack_index)
from .store import check_compatible, graph_fingerprint, load, load_meta, save

__all__ = ["BUCKET_BASE", "NUM_BUCKETS", "WalkIndex", "build_walk_index",
           "dedup_index", "index_counts", "pack_index", "check_compatible",
           "graph_fingerprint", "load", "load_meta", "save"]
