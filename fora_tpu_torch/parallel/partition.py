"""Host-side row partitioning for the sharded engine.

A numpy copy of ``fora_tpu/parallel/partition.py``: ``PartitionedGraph``
(33-76), ``partition_rows`` (79-191), the routing masks ``needed_masks``,
``needed_host_masks`` and ``host_groups`` (193-251), ``PartitionedIndex``
(254-268) and ``partition_index`` (271-326), carried here so that the port
loads nothing of the JAX package (``tests/test_torch_partition.py`` and
``tests/test_torch_exchange.py`` hold them array-equal to the originals).
The graph's rows are split into G contiguous ranges of a common
``n_loc``; shard g owns

  * the in-edges whose destination falls in its rows, destinations local,
    sources global, padded to a common ``m_loc`` (pads: ``src = n_pad``,
    ``dst = n_loc``);
  * the FORA+ index edges whose SOURCE falls in its rows, sources local,
    endpoints global, padded per bucket (pads: ``src = n_loc``,
    ``dst = n_pad``), and its rows of ``counts_cum``.

Arrays are flat with a leading ``G * size`` axis, as the JAX engine places
them.  The sharded engine (``parallel/sharded.py``) turns each shard's
slice into CSRs by destination and drops every pad.

Weighted graphs shard their per-edge weights and per-row out-weights,
which the push reads; ``alias_prob``/``alias_other`` stay None here: the
sharded raw walk takes its alias tables with the out-CSR's slices from
``index/build_sharded.py::_shard_csr`` (or the store's walk side).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np

from ..graph.csr import CSRGraph


class PartitionedGraph(NamedTuple):
    """Host-side numpy arrays; shard g owns slice [g*k, (g+1)*k) of each
    flat sharded array."""

    n_shards: int
    n_loc: int            # rows per shard (padded)
    m_loc: int            # in-edges per shard (padded)
    in_src_global: np.ndarray   # [G * m_loc] i32, pad -> n_pad
    in_dst_local: np.ndarray    # [G * m_loc] i32, pad -> n_loc
    out_deg_sharded: np.ndarray  # [G * n_loc] i32 (pad rows: 0)
    # replicated walk-side arrays
    out_indptr: np.ndarray      # [n_pad + 1] i32 (pad rows: empty)
    out_indices: np.ndarray     # [m] i32
    out_deg: np.ndarray         # [n_pad] i32
    # weighted-graph extras (None on unweighted graphs)
    in_w_sharded: Optional[np.ndarray] = None    # [G * m_loc] f32, pad 0
    out_wsum_sharded: Optional[np.ndarray] = None  # [G * n_loc] f32, pad 0
    alias_prob: Optional[np.ndarray] = None      # always None (no sharded
    alias_other: Optional[np.ndarray] = None     # raw walk yet)
    # hub-split in-edges (partition_rows(hub_rows=H)): edges whose source
    # is a global top-H out-degree node, gathered from a compact [H, B]
    # slice of the exchanged contribution vector; the tail arrays above
    # then hold only the other edges
    hub_ids: Optional[np.ndarray] = None           # [H] i32 global
    mh_loc: int = 0                                # hub edges/shard (padded)
    hub_src_slot_sharded: Optional[np.ndarray] = None  # [G*mh_loc] i32, pad 0
    hub_dst_local_sharded: Optional[np.ndarray] = None  # [G*mh_loc] i32, pad n_loc
    hub_w_sharded: Optional[np.ndarray] = None     # [G*mh_loc] f32, pad 0

    @property
    def n_pad(self) -> int:
        return self.n_shards * self.n_loc

    @property
    def weighted(self) -> bool:
        return self.out_wsum_sharded is not None

    @property
    def hub_split(self) -> bool:
        return self.hub_ids is not None


def partition_rows(g: CSRGraph, n_shards: int,
                   row_multiple: int = 8,
                   hub_rows: int = 0) -> PartitionedGraph:
    """Split ``g``'s rows over ``n_shards``; ``hub_rows`` > 0 also splits
    each shard's in-edges by global source out-degree, with the selection
    rule of ``graph.csr.to_device``.  ``g`` is a CSRGraph of either
    package (the fields are the same)."""
    n = g.n
    n_loc = math.ceil(n / n_shards)
    n_loc = -(-n_loc // row_multiple) * row_multiple
    n_pad = n_shards * n_loc

    in_dst = np.asarray(g.in_dst, dtype=np.int64)
    in_src = np.asarray(g.in_src, dtype=np.int64)
    in_w = np.asarray(g.in_w, np.float32) if g.weighted else None

    hub_ids = hub_slot = None
    hub_src = hub_dst = hub_w = None
    if hub_rows > 0 and n > hub_rows and g.m:
        deg64 = np.asarray(g.out_deg, np.int64)
        hub_ids = np.sort(np.argsort(-deg64, kind="stable")[:hub_rows]
                          ).astype(np.int32)
        hub_slot = np.full(n, -1, np.int32)
        hub_slot[hub_ids] = np.arange(hub_rows, dtype=np.int32)
        is_hub = hub_slot[in_src] >= 0
        # a stable partition keeps both subsets dst-sorted
        hub_src = hub_slot[in_src[is_hub]].astype(np.int64)
        hub_dst = in_dst[is_hub]
        if in_w is not None:
            hub_w = in_w[is_hub]
            in_w = in_w[~is_hub]
        in_src = in_src[~is_hub]
        in_dst = in_dst[~is_hub]

    m_tail = len(in_src)
    shard_of_edge = in_dst // n_loc
    counts = np.bincount(shard_of_edge, minlength=n_shards)
    m_loc = int(counts.max()) if m_tail else 1

    src_flat = np.full(n_shards * m_loc, n_pad, dtype=np.int32)
    dst_flat = np.full(n_shards * m_loc, n_loc, dtype=np.int32)
    w_flat = (np.zeros(n_shards * m_loc, dtype=np.float32)
              if g.weighted else None)
    # in-edges are dst-sorted, so each shard's edges are contiguous; one
    # vectorized scatter places every edge
    edge_start = np.zeros(n_shards + 1, dtype=np.int64)
    np.cumsum(counts, out=edge_start[1:])
    if m_tail:
        pos = (shard_of_edge * m_loc
               + np.arange(m_tail, dtype=np.int64)
               - edge_start[shard_of_edge])
        src_flat[pos] = in_src
        dst_flat[pos] = in_dst - shard_of_edge * n_loc
        if w_flat is not None:
            w_flat[pos] = in_w

    mh_loc = 0
    hsrc_flat = hdst_flat = hw_flat = None
    if hub_ids is not None:
        h_shard = hub_dst // n_loc
        h_counts = np.bincount(h_shard, minlength=n_shards)
        mh_loc = max(int(h_counts.max()), 1)
        hsrc_flat = np.zeros(n_shards * mh_loc, dtype=np.int32)  # pad slot 0
        hdst_flat = np.full(n_shards * mh_loc, n_loc, dtype=np.int32)
        hw_flat = (np.zeros(n_shards * mh_loc, dtype=np.float32)
                   if g.weighted else None)
        h_start = np.zeros(n_shards + 1, dtype=np.int64)
        np.cumsum(h_counts, out=h_start[1:])
        if len(hub_dst):
            hpos = (h_shard * mh_loc
                    + np.arange(len(hub_dst), dtype=np.int64)
                    - h_start[h_shard])
            hsrc_flat[hpos] = hub_src
            hdst_flat[hpos] = hub_dst - h_shard * n_loc
            if hw_flat is not None:
                hw_flat[hpos] = hub_w

    deg = np.zeros(n_pad, dtype=np.int32)
    deg[:n] = np.asarray(g.out_deg)
    indptr = np.zeros(n_pad + 1, dtype=np.int32)
    indptr[: n + 1] = np.asarray(g.out_indptr)
    indptr[n + 1:] = indptr[n]

    wsum = None
    if g.weighted:
        srcs = np.repeat(np.arange(n, dtype=np.int64),
                         np.asarray(g.out_deg, np.int64))
        wsum = np.zeros(n_pad, dtype=np.float32)
        wsum[:n] = np.bincount(srcs, weights=np.asarray(g.out_w, np.float64),
                               minlength=n).astype(np.float32)

    return PartitionedGraph(
        n_shards=n_shards, n_loc=n_loc, m_loc=m_loc,
        in_src_global=src_flat, in_dst_local=dst_flat,
        out_deg_sharded=deg.copy(),
        out_indptr=indptr, out_indices=np.asarray(g.out_indices),
        out_deg=deg,
        in_w_sharded=w_flat, out_wsum_sharded=wsum,
        hub_ids=hub_ids, mh_loc=mh_loc,
        hub_src_slot_sharded=hsrc_flat,
        hub_dst_local_sharded=hdst_flat,
        hub_w_sharded=hw_flat,
    )


def needed_masks(pg: PartitionedGraph) -> np.ndarray:
    """Routing masks of the routed exchange: [G * G, n_loc] bool, shard s's
    [G, n_loc] block at rows [s*G, (s+1)*G); ``needed[s*G + t, i]`` = shard
    t has an in-edge (tail or hub) whose source is shard s's local row i,
    so row i goes to t whenever it is active."""
    G, n_loc = pg.n_shards, pg.n_loc
    need = np.zeros((G, G, n_loc), dtype=bool)
    for t in range(G):
        src = pg.in_src_global[t * pg.m_loc:(t + 1) * pg.m_loc]
        src = src[src < pg.n_pad].astype(np.int64)
        if pg.hub_split:
            # hub edges gather from a slice of the same exchanged vector
            hd = pg.hub_dst_local_sharded[t * pg.mh_loc:(t + 1) * pg.mh_loc]
            hs = pg.hub_src_slot_sharded[t * pg.mh_loc:(t + 1) * pg.mh_loc]
            hsrc = pg.hub_ids[hs[hd < n_loc]].astype(np.int64)
            src = np.concatenate([src, hsrc])
        s, i = np.divmod(src, n_loc)
        need[s, t, i] = True
    return need.reshape(G * G, n_loc)


def needed_host_masks(pg: PartitionedGraph, chips_per_host: int
                      ) -> np.ndarray:
    """Routing masks of the hier exchange: [G * H, n_loc] bool (H = G /
    chips_per_host), shard s's [H, n_loc] block at rows [s*H, (s+1)*H);
    ``needed_host[s*H + h, i]`` = some chip of host h references shard s's
    local row i."""
    G, n_loc = pg.n_shards, pg.n_loc
    if G % chips_per_host:
        raise ValueError(f"{chips_per_host} chips/host must divide G={G}")
    H = G // chips_per_host
    need = needed_masks(pg).reshape(G, H, chips_per_host, n_loc)
    return need.any(axis=2).reshape(G * H, n_loc)


def host_groups(G: int, chips_per_host: int):
    """(cross_host_groups, intra_host_groups) over G = H hosts x C chips,
    host-major shard ids: a cross group holds one chip position across the
    hosts (the first stage's peers), an intra group one host's chips (the
    second stage's)."""
    H = G // chips_per_host
    cross = [[h * chips_per_host + c for h in range(H)]
             for c in range(chips_per_host)]
    intra = [[h * chips_per_host + c for c in range(chips_per_host)]
             for h in range(H)]
    return cross, intra


class PartitionedIndex(NamedTuple):
    """FORA+ index edges sharded by SOURCE row.  Per shard, buckets occupy
    the same local offsets (padded to the largest shard's bucket); pad
    entries carry src = n_loc and dst = n_pad."""

    e_loc_total: int
    bucket_local_offsets: np.ndarray  # [Q+1] i64, shared by all shards
    edge_src_local: np.ndarray        # [G * e_loc_total] i32, pad = n_loc
    edge_dst: np.ndarray              # [G * e_loc_total] i32 global, pad = n_pad
    counts_cum: np.ndarray            # [G * n_loc, Q] i32
    edge_mult: Optional[np.ndarray] = None  # [G * e_loc_total] f32, pad = 0


def partition_index(index, n_shards: int, n_loc: int) -> PartitionedIndex:
    """``index`` is a WalkIndex of either package (bucketed layout).  One
    stable argsort groups edges by (bucket, shard) and keeps each group's
    endpoint order; one scatter writes every group to its padded slot."""
    src = np.asarray(index.edge_src, dtype=np.int64)
    dst = np.asarray(index.edge_dst, dtype=np.int64)
    boff = np.asarray(index.bucket_offsets, dtype=np.int64)
    cc = np.asarray(index.counts_cum)
    n, Q = cc.shape
    n_pad = n_shards * n_loc
    E = src.shape[0]

    shard_of = src // n_loc
    bucket_of = np.searchsorted(boff[1:], np.arange(E), side="right")
    group = bucket_of * n_shards + shard_of            # (q, s) group id
    sizes = np.bincount(group, minlength=Q * n_shards).reshape(Q, n_shards)
    bucket_loc = sizes.max(axis=1)                     # padded per bucket
    bucket_local_offsets = np.zeros(Q + 1, dtype=np.int64)
    np.cumsum(bucket_loc, out=bucket_local_offsets[1:])
    e_loc_total = int(bucket_local_offsets[-1])

    # destination slot of each edge: group base + rank within the group
    order = np.argsort(group, kind="stable")
    group_starts = np.zeros(Q * n_shards, dtype=np.int64)
    np.cumsum(sizes.reshape(-1)[:-1], out=group_starts[1:])
    rank = np.arange(E, dtype=np.int64) - group_starts[group[order]]
    base = (shard_of[order] * e_loc_total
            + bucket_local_offsets[bucket_of[order]])
    pos = base + rank

    mult = (np.asarray(index.edge_mult, dtype=np.float32)
            if index.edge_mult is not None else None)
    src_flat = np.full(n_shards * e_loc_total, n_loc, dtype=np.int32)
    dst_flat = np.full(n_shards * e_loc_total, n_pad, dtype=np.int32)
    src_flat[pos] = src[order] - shard_of[order] * n_loc
    dst_flat[pos] = dst[order]
    mult_flat = None
    if mult is not None:
        mult_flat = np.zeros(n_shards * e_loc_total, dtype=np.float32)
        mult_flat[pos] = mult[order]

    # row v of shard s sits at s * n_loc + (v - s * n_loc) == v
    cc_flat = np.zeros((n_shards * n_loc, Q), dtype=np.int32)
    cc_flat[:n] = cc
    return PartitionedIndex(e_loc_total=e_loc_total,
                            bucket_local_offsets=bucket_local_offsets,
                            edge_src_local=src_flat, edge_dst=dst_flat,
                            counts_cum=cc_flat, edge_mult=mult_flat)
