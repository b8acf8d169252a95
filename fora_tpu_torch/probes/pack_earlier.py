"""The index pack's earlier form: the numpy packed-key branch that
``index/build.py::pack_index`` ran on the host before K7 (PRs 1-22), a
copy of ``fora_tpu/index/build.py``'s numpy branch (436-458).  No path
runs it; ``chip_smoke.py`` phase 4 times it on the build's endpoints
beside K7 and holds K7's arrays equal to it.

    pack_index_numpy(endpoints, counts, out_deg, rcfg) -> WalkIndex
"""

from __future__ import annotations

import numpy as np

from ..config import ResolvedConfig
from ..index.build import (NUM_BUCKETS, WalkIndex, _bucket_per_entry,
                           _offsets, pack_tables, with_indptr)


def pack_index_numpy(endpoints: np.ndarray, counts: np.ndarray,
                     out_deg: np.ndarray, rcfg: ResolvedConfig) -> WalkIndex:
    """The packed-key pack in numpy: one np.sort of int64 keys and a
    run-length merge by bincount (keys of 2 nb + 4 <= 63 bits)."""
    t = pack_tables(counts, out_deg)
    n, nb, nd, total = len(t.counts), t.nb, len(t.dang), t.total
    src32 = np.repeat(np.arange(n, dtype=np.int32), t.counts)
    bucket = _bucket_per_entry(t.counts, t.offsets, t.cut, total, src32)
    key = np.empty(total + nd, dtype=np.int64)
    km = key[:total]
    np.left_shift(bucket, 2 * nb, out=km)
    np.bitwise_or(km, np.asarray(endpoints).astype(np.int64) << nb, out=km)
    np.bitwise_or(km, src32.astype(np.int64), out=km)
    key[total:] = ((np.int64(NUM_BUCKETS - 1) << (2 * nb))
                   | (t.dang << nb) | t.dang)
    del bucket, src32
    key = np.sort(key)
    first = np.empty(len(key), dtype=bool)
    if len(key):
        first[0] = True
        first[1:] = key[1:] != key[:-1]
    group = np.cumsum(first) - 1
    mult = np.bincount(group).astype(np.float32)
    key = key[first]
    src = key & ((1 << nb) - 1)
    dst = (key >> nb) & ((1 << nb) - 1)
    bucket = (key >> (2 * nb)).astype(np.int8)
    return with_indptr(WalkIndex(
        edge_src=src.astype(np.int32), edge_dst=dst.astype(np.int32),
        bucket_offsets=_offsets(bucket), counts_cum=t.counts_cum,
        omega_unit_built=rcfg.omega_unit, rmax_built=rcfg.rmax,
        edge_mult=mult))
