"""FORA+ walk index: counts, the walk loop and the host pack.

Port of ``fora_tpu/index/build.py`` (60-136, 252-484) without JAX, whose
module imports ``jax`` at load time.  The layout is the same: every pool
entry (v -> walk endpoint) is an index edge, edges are split into
NUM_BUCKETS prefix buckets and sorted by (bucket, endpoint, source), and
``counts_cum[v, q]`` counts v's pool entries visible at depth q.  Because
each bucket is endpoint-sorted, it is a CSR by endpoint: ``dst_indptr[q]``
holds its [n+1] row pointers, which the index SpMV kernel (K2) walks.

Arrays stay on the host (numpy, or mmap views after ``store.load``);
``algo.fora.StagedForaPrograms`` moves one bucket at a time to the device.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import ResolvedConfig
from ..graph.csr import DeviceGraph, dst_indptr
from ..ops.walk import walk_endpoints

NUM_BUCKETS = 8          # prefix fractions 4^0 .. 4^-(NUM_BUCKETS-1)
BUCKET_BASE = 4


class WalkIndex(NamedTuple):
    """Multi-resolution endpoint index (host arrays).

    Depth q serves queries whose rmax * omega_unit is at most
    4^-q of the built one; they read buckets q..NUM_BUCKETS-1 and weight
    each edge by mult / counts_cum[src, q].
    """

    edge_src: np.ndarray          # [E] i32
    edge_dst: np.ndarray          # [E] i32, endpoint-sorted per bucket
    bucket_offsets: np.ndarray    # [NUM_BUCKETS+1] i64
    counts_cum: np.ndarray        # [n, NUM_BUCKETS] i32
    omega_unit_built: float
    rmax_built: float
    edge_mult: Optional[np.ndarray] = None   # [E] f32 multiplicity
    dst_indptr: Optional[Tuple] = None       # per bucket [n+1] i32, or None

    @property
    def total_edges(self) -> int:
        return int(self.edge_src.shape[0])

    @property
    def n(self) -> int:
        return int(self.counts_cum.shape[0])

    def depth_for(self, omega_unit_query: float,
                  rmax_query: Optional[float] = None) -> int:
        """Deepest bucket depth whose prefix still covers the query's
        per-node demand, which scales with rmax * omega_unit (see
        fora_tpu.index.build.WalkIndex.depth_for)."""
        ratio = omega_unit_query / self.omega_unit_built
        if rmax_query is not None:
            ratio *= rmax_query / self.rmax_built
        if ratio > 1.0 + 1e-9:
            raise ValueError(
                f"index too coarse: built rmax*omega_unit covers "
                f"{self.rmax_built * self.omega_unit_built:.3g} < query "
                f"demand ratio {ratio:.3g}x")
        q = int(-math.log(max(ratio, 1e-300)) // math.log(BUCKET_BASE))
        return min(max(q, 0), NUM_BUCKETS - 1)

    def edges_at_depth(self, q: int):
        """(src, dst, mult-or-None) of buckets q..deepest (contiguous)."""
        lo = int(self.bucket_offsets[q])
        mult = self.edge_mult[lo:] if self.edge_mult is not None else None
        return self.edge_src[lo:], self.edge_dst[lo:], mult


def with_indptr(index: WalkIndex) -> WalkIndex:
    """``index`` with each bucket's [n+1] row pointers by endpoint (None
    for an empty bucket)."""
    ptrs = []
    for q in range(NUM_BUCKETS):
        lo = int(index.bucket_offsets[q])
        hi = int(index.bucket_offsets[q + 1])
        ptrs.append(dst_indptr(index.edge_dst[lo:hi], index.n)
                    if hi > lo else None)
    return index._replace(dst_indptr=tuple(ptrs))


def index_counts(out_deg: np.ndarray, rcfg: ResolvedConfig,
                 max_per_node: Optional[int] = None) -> np.ndarray:
    """K_v = ceil(rmax * deg_v * omega_unit) + 1 walks per node (0 for
    dangling nodes, served by an analytic self-edge)."""
    deg = np.asarray(out_deg, dtype=np.float64)
    k = np.ceil(rcfg.rmax * deg * rcfg.omega_unit).astype(np.int64) + 1
    k[deg == 0] = 0
    if max_per_node is not None:
        k = np.minimum(k, max_per_node)
    return k


def build_walk_index(graph: DeviceGraph, rcfg: ResolvedConfig, seed: int,
                     chunk_lanes: int = 1 << 23) -> WalkIndex:
    """Run every index walk on the graph's device, ``chunk_lanes`` walks per
    launch, then pack the bucketed layout on the host.  Chunk i draws its
    random numbers from seed ``seed + i * 2^32``."""
    n = graph.n
    deg = graph.out_deg.cpu().numpy()
    counts = index_counts(deg, rcfg)
    total = int(counts.sum())
    if total + n >= 2**31:
        raise ValueError(f"walk index ({total} endpoints) exceeds int32 "
                         "range")
    starts = np.repeat(np.arange(n, dtype=np.int32), counts)
    endpoints = np.empty(total, dtype=np.int32)
    for i, lo in enumerate(range(0, total, chunk_lanes)):
        hi = min(lo + chunk_lanes, total)
        s = torch.from_numpy(starts[lo:hi]).to(graph.device)
        endpoints[lo:hi] = walk_endpoints(
            graph, s, seed + (i << 32), rcfg.alpha,
            rcfg.max_walk_hops).cpu().numpy()
    return pack_index(endpoints, counts, deg, rcfg)


def _merge_bucket_duplicates(src: np.ndarray, dst: np.ndarray,
                             bucket: np.ndarray):
    """Merge identical (src, dst) pairs within a bucket into one edge with
    a multiplicity; output is (bucket, dst, src)-sorted.  Returns (src,
    dst, bucket, mult)."""
    if len(src) == 0:
        return src, dst, bucket, np.ones(0, np.float32)
    order = np.lexsort((src, dst, bucket))
    src, dst, bucket = src[order], dst[order], bucket[order]
    first = np.empty(len(src), dtype=bool)
    first[0] = True
    first[1:] = ((src[1:] != src[:-1]) | (dst[1:] != dst[:-1])
                 | (bucket[1:] != bucket[:-1]))
    group = np.cumsum(first) - 1
    mult = np.bincount(group).astype(np.float32)
    return src[first], dst[first], bucket[first], mult


def _offsets(bucket: np.ndarray) -> np.ndarray:
    sizes = np.bincount(bucket, minlength=NUM_BUCKETS)
    off = np.zeros(NUM_BUCKETS + 1, dtype=np.int64)
    np.cumsum(sizes, out=off[1:])
    return off


def dedup_index(index: WalkIndex) -> WalkIndex:
    """Upgrade an unmerged index to the multiplicity-merged layout
    (lossless; counts_cum unchanged)."""
    if index.edge_mult is not None:
        return index
    src = np.asarray(index.edge_src, dtype=np.int64)
    dst = np.asarray(index.edge_dst, dtype=np.int64)
    boff = np.asarray(index.bucket_offsets, dtype=np.int64)
    bucket = np.repeat(np.arange(NUM_BUCKETS, dtype=np.int8), np.diff(boff))
    src, dst, bucket, mult = _merge_bucket_duplicates(src, dst, bucket)
    return with_indptr(index._replace(
        edge_src=src.astype(np.int32), edge_dst=dst.astype(np.int32),
        bucket_offsets=_offsets(bucket), edge_mult=mult))


def _bucket_per_entry(counts, offsets, cut, total, src32):
    """Per-entry bucket: entries of a node are j-ascending, so the bucket
    starts at NUM_BUCKETS-1 and drops by one at each within-node cutoff."""
    if not total:
        return np.empty(0, np.int64)
    pos = [offsets[sel] + cut[sel, q]
           for q in range(1, NUM_BUCKETS)
           for sel in (cut[:, q] < counts,)]
    dec = np.bincount(np.concatenate(pos) if pos else
                      np.empty(0, np.int64), minlength=total)
    dinc = np.cumsum(dec, dtype=np.int64)
    off_c = np.minimum(offsets, total - 1)
    base = dinc[off_c] - dec[off_c]
    return (NUM_BUCKETS - 1) - (dinc - base[src32])


def pack_index(endpoints: np.ndarray, counts: np.ndarray,
               out_deg: np.ndarray, rcfg: ResolvedConfig,
               dedup: bool = True) -> WalkIndex:
    """Host-side packing of raw pools into the bucketed layout, as
    ``fora_tpu.index.build.pack_index``: its numpy packed-key branch (one
    sort and a run-length merge) and its legacy lexsort branch, which give
    the same arrays as its native radix sort.  The native branch is not
    carried over: it lives in ``fora_tpu._native``, inside the JAX
    package."""
    n = counts.shape[0]
    total = int(counts.sum())
    counts = np.asarray(counts, dtype=np.int64)
    offsets = np.zeros(n, dtype=np.int64)
    np.cumsum(counts[:-1], out=offsets[1:])
    dang = np.nonzero(np.asarray(out_deg) == 0)[0].astype(np.int64)

    # cut[v, q] = ceil(K_v * 4^-q): entry j of v is in bucket
    # #{q >= 1 : j < cut[v, q]}, and counts_cum is the cutoff table itself
    # (+1 at every depth for a dangling node's self-edge)
    cut = np.ceil(counts[:, None].astype(np.float64)
                  * float(BUCKET_BASE) ** -np.arange(NUM_BUCKETS,
                                                     dtype=np.float64)
                  ).astype(np.int64)
    cut[:, 0] = counts
    counts_cum = cut.astype(np.int32)
    if len(dang):
        counts_cum[dang] += 1
    counts_cum = np.ascontiguousarray(counts_cum)

    nd = len(dang)
    nb = max(int(n - 1).bit_length(), 1)
    mult = None
    if dedup and 2 * nb + 4 <= 63:
        # numpy packed-key path: one np.sort + run-length merge
        src32 = np.repeat(np.arange(n, dtype=np.int32), counts)
        bucket = _bucket_per_entry(counts, offsets, cut, total, src32)
        key = np.empty(total + nd, dtype=np.int64)
        km = key[:total]
        np.left_shift(bucket, 2 * nb, out=km)
        np.bitwise_or(km, endpoints.astype(np.int64) << nb, out=km)
        np.bitwise_or(km, src32.astype(np.int64), out=km)
        key[total:] = ((np.int64(NUM_BUCKETS - 1) << (2 * nb))
                       | (dang << nb) | dang)
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
    else:
        # legacy path: (bucket, dst) sort, optional merge
        src32 = np.repeat(np.arange(n, dtype=np.int32), counts)
        bucket = _bucket_per_entry(counts, offsets, cut, total, src32)
        src = np.concatenate([src32.astype(np.int64), dang])
        dst = np.concatenate([endpoints.astype(np.int64), dang])
        bucket = np.concatenate([bucket, np.full(nd, NUM_BUCKETS - 1)])
        order = np.lexsort((dst, bucket))
        src, dst, bucket = src[order], dst[order], bucket[order]
        if dedup:
            src, dst, bucket, mult = _merge_bucket_duplicates(src, dst,
                                                              bucket)
    return with_indptr(WalkIndex(
        edge_src=np.asarray(src).astype(np.int32),
        edge_dst=np.asarray(dst).astype(np.int32),
        bucket_offsets=_offsets(bucket),
        counts_cum=counts_cum,
        omega_unit_built=rcfg.omega_unit,
        rmax_built=rcfg.rmax,
        edge_mult=mult,
    ))
