"""The graph-sharded, indexed engines: the one-shot top-k and the
refinement pool.

Port of ``fora_tpu/parallel/sharded.py``: ``_ShardedPlacement`` (600-812,
without the walk side), ``_push_loop`` (244-296), ``_shard_level_step``
(460-540), ``ShardedForaEngine`` (819-900) on its indexed path and
``ShardedTopkRunner`` (903-991).  Rows are split over G graph shards
(``partition.partition_rows``, or a ``ShardedGraphStore``); each shard
lives on one device of its query group (``mesh.make_mesh``), and one
process loops over the shards where JAX runs one ``shard_map`` program.
A level, per query group:

  1. each shard pushes over its own in-edges (the K1 pre-pass and K1's
     gather, tail and hub edges, weighted or not) to the level's per-node
     threshold; every superstep's frontier, each shard's [n_loc, B]
     contribution block, reaches the shards that read it through the
     frontier exchange (``ops.exchange``: the ring P1, or the compaction
     kernel, the copies and P3);
  2. each shard runs the index SpMV (K2, one launch over the level's
     buckets) over the index edges whose source it owns, into an [n_pad,
     B] partial over all endpoints;
  3. the ring reduce-scatter (P2) sums the partials into the owning shards;
  4. each shard takes its top-(k+1) of ``p + walk`` (K3's selection) with
     ``p`` at those rows, and a stable sort merges the G candidate lists
     (the earlier shard first on ties, as ``lax.top_k`` over the gathered
     candidates); the refinement pool's Bernstein epilogue runs on the
     merged list (``algo.bounds._bounds``).

The host reads one small status tensor per superstep: each shard's "some
residue is over its threshold" flag and, for a compacted exchange, its
counts per destination.  To read both at once, the next superstep's
pre-pass and compaction run before the read; when the flags then say
stop, that pre-pass found no active entry and changed nothing.

A query axis of Q groups splits each batch's columns over Q groups of G
shard devices; groups on the same devices share one placement.  CPU
tensors run the plain version of every kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..algo import bounds as bounds_mod
from ..algo.topk import TopkRunner
from ..config import ResolvedConfig
from ..graph.csr import dst_indptr, host_to_device
from ..index.build import NUM_BUCKETS
from ..index.store import ShardedIndexStore
from ..kernels.schedule import gather_schedule
from ..ops import exchange as xch_ops
from ..ops import ring
from ..ops.gather import gather_scatter_add, index_spmv_level
from ..ops.push import push_prepass
from ..ops.topk import topk_rows_chunked, topk_sum
from . import partition as part
from .graph_store import ShardedGraphStore


class ShardedTopkResult(NamedTuple):
    values: np.ndarray        # [B, k] f32, descending
    node_ids: np.ndarray      # [B, k] i32, global ids
    push_iters: int           # supersteps run (summed over query groups)
    walk_overflow: np.ndarray  # [B] bool (all False on the indexed path)


def exchange_bytes_model(mode: str, *, n_loc: int, batch: int, G: int,
                         cap: int = 0, active_rows=None,
                         chips_per_host: int = 1) -> int:
    """Bytes leaving ONE shard per superstep under each exchange mode
    (f32 rows + i32 ids; capacity-padded for the static-shape modes), as
    ``fora_tpu/parallel/sharded.py:210-233``.  ``active_rows``:
    per-destination actual counts (ragged mode's wire volume); defaults to
    the worst case.  For "hier" this is the cross-host bytes."""
    row = batch * 4
    if mode == "dense":
        return (G - 1) * n_loc * row
    if mode == "compact":
        return (G - 1) * cap * (row + 4)
    if mode == "routed":
        return (G - 1) * cap * (row + 4)
    if mode == "ragged":
        a = (G - 1) * cap if active_rows is None else int(np.sum(active_rows))
        return a * (row + 4)
    if mode == "hier":
        H = G // chips_per_host
        return (H - 1) * cap * (row + 4)
    raise ValueError(mode)


def _sorted(a: np.ndarray, what: str) -> np.ndarray:
    if len(a) > 1 and not bool(np.all(a[1:] >= a[:-1])):
        raise ValueError(f"{what} are not sorted by destination")
    return a


class _Shard:
    """One shard's arrays on its device: the tail in-edges as a CSR by
    local destination (global sources) with K1's work list and weights,
    the hub edges likewise over slots of ``hub_ids``, degrees and
    out-weights, its routing block, the index rows it owns and the index
    edges whose source it owns (local sources), in bucket order with each
    bucket's CSR by global endpoint stacked into ``idx_indptr``.  Every
    pad entry is dropped."""

    def __init__(self, device, row0: int, n_loc: int, n_pad: int,
                 graph: dict, hub: Optional[dict], index: dict,
                 boff: np.ndarray, needed: Optional[np.ndarray]):
        self.device = device
        self.row0 = row0
        src = np.asarray(graph["in_src_global"])
        dst = np.asarray(graph["in_dst_local"])
        real = dst < n_loc
        in_dst = _sorted(dst[real], f"shard at row {row0}: in-edges")
        self.in_indptr = host_to_device(dst_indptr(in_dst, n_loc), device,
                                        np.int32)
        self.in_src = host_to_device(src[real], device, np.int32)
        self.in_sched = gather_schedule(self.in_indptr)
        w = graph.get("in_w")
        self.in_w = (None if w is None else
                     host_to_device(np.asarray(w)[real], device, np.float32))
        self.out_deg = host_to_device(graph["out_deg"], device, np.int32)
        wsum = graph.get("out_wsum")
        self.wsum = (self.out_deg.to(torch.float32) if wsum is None else
                     host_to_device(wsum, device, np.float32))
        self.hub_ids = None
        if hub is not None:
            hd = np.asarray(hub["dst"])
            hreal = hd < n_loc
            self.hub_ids = host_to_device(hub["ids"], device, np.int32)
            self.hub_indptr = host_to_device(
                dst_indptr(_sorted(hd[hreal], "hub edges"), n_loc), device,
                np.int32)
            self.hub_src = host_to_device(np.asarray(hub["slot"])[hreal],
                                          device, np.int32)
            self.hub_w = (None if hub["w"] is None else host_to_device(
                np.asarray(hub["w"])[hreal], device, np.float32))
            self.hub_sched = gather_schedule(self.hub_indptr)
        self.needed = (None if needed is None else
                       host_to_device(needed, device, np.uint8))

        isrc_all = np.asarray(index["edge_src_local"])
        idst_all = np.asarray(index["edge_dst"])
        mult_all = index.get("edge_mult")
        ptrs, srcs, mults, off = [], [], [], [0]
        for q in range(NUM_BUCKETS):
            lo, hi = int(boff[q]), int(boff[q + 1])
            isrc = isrc_all[lo:hi]
            keep = isrc < n_loc
            idst = _sorted(idst_all[lo:hi][keep],
                           f"shard at row {row0}: index bucket {q}")
            ptrs.append(dst_indptr(idst, n_pad))
            srcs.append(isrc[keep])
            if mult_all is not None:
                mults.append(np.asarray(mult_all[lo:hi])[keep])
            off.append(off[-1] + int(keep.sum()))
        self.counts_cum = host_to_device(index["counts_cum"], device,
                                         np.int32)   # [n_loc, Q]
        self.idx_indptr = host_to_device(np.stack(ptrs), device, np.int32)
        self.idx_src = host_to_device(np.concatenate(srcs), device, np.int32)
        self.idx_mult = (None if mult_all is None else host_to_device(
            np.concatenate(mults), device, np.float32))
        # the first edge of each bucket, on the host and the device
        self.idx_off = off
        self.idx_off_dev = torch.tensor(off[:NUM_BUCKETS], dtype=torch.int32,
                                        device=device)
        self._inv, self._walk_sched, self._thr = {}, {}, {}

    @property
    def buckets(self) -> list:
        """Per bucket: (indptr [n_pad+1], src, mult-or-None) views, or None
        for a bucket without edges on this shard."""
        o = self.idx_off
        return [None if o[q + 1] <= o[q] else
                (self.idx_indptr[q], self.idx_src[o[q]:o[q + 1]],
                 None if self.idx_mult is None
                 else self.idx_mult[o[q]:o[q + 1]])
                for q in range(NUM_BUCKETS)]

    def thr(self, depth: int, omega_unit: float) -> torch.Tensor:
        """[n_loc] f32 coverage threshold counts_cum[:, depth] / omega_unit
        (f32), as ``fora_tpu/parallel/sharded.py:489-490``."""
        key = (depth, float(np.float32(omega_unit)))
        if key not in self._thr:
            self._thr[key] = (self.counts_cum[:, depth].to(torch.float32)
                              / key[1])
        return self._thr[key]

    def inv(self, depth: int) -> torch.Tensor:
        if depth not in self._inv:
            self._inv[depth] = 1.0 / self.counts_cum[:, depth].clamp_min(
                1).to(torch.float32)
        return self._inv[depth]

    def walk_sched(self, depth: int):
        """K2's work list over buckets depth.. (None on the CPU)."""
        if self.device.type == "cpu":
            return None
        if depth not in self._walk_sched:
            self._walk_sched[depth] = gather_schedule(self.idx_indptr[depth:])
        return self._walk_sched[depth]


class _StoreMeta(NamedTuple):
    """What the engines read of a PartitionedGraph when the graph comes
    from a ShardedGraphStore."""
    n_shards: int
    n_loc: int
    m_loc: int
    weighted: bool

    @property
    def n_pad(self) -> int:
        return self.n_shards * self.n_loc


def _graph_shards(g, G: int, hub_rows: int):
    """(pg or _StoreMeta, per shard (graph dict, hub dict or None), routing
    masks [G, G, n_loc] or None) from an in-RAM graph or a store."""
    if isinstance(g, ShardedGraphStore):
        if g.n_shards != G:
            raise ValueError(f"graph store is {g.n_shards}-way, the mesh has "
                             f"{G} graph shards; re-save with "
                             f"save_sharded_graph(..., {G})")
        if hub_rows:
            raise ValueError(
                "hub_rows is not supported with a ShardedGraphStore: the "
                "per-shard hub partition needs a global max over the "
                "shards' hub-edge counts (ROADMAP C5); partition in RAM "
                "for the hub split, or store without it")
        meta = _StoreMeta(n_shards=G, n_loc=g.n_loc, m_loc=g.m_loc,
                          weighted=g.weighted)
        shards = [(g.shard(s), None) for s in range(G)]
        need = np.stack([np.asarray(sh["needed"]).astype(bool)
                         for sh, _ in shards])
        return meta, shards, need
    pg = part.partition_rows(g, G, hub_rows=hub_rows)
    n_loc, m_loc, mh = pg.n_loc, pg.m_loc, pg.mh_loc
    shards = []
    for s in range(G):
        e, r = slice(s * m_loc, (s + 1) * m_loc), slice(s * n_loc,
                                                       (s + 1) * n_loc)
        gd = {"in_src_global": pg.in_src_global[e],
              "in_dst_local": pg.in_dst_local[e],
              "out_deg": pg.out_deg_sharded[r],
              "in_w": None if pg.in_w_sharded is None else pg.in_w_sharded[e],
              "out_wsum": (None if pg.out_wsum_sharded is None
                           else pg.out_wsum_sharded[r])}
        hub = None
        if pg.hub_split:
            h = slice(s * mh, (s + 1) * mh)
            hub = {"ids": pg.hub_ids, "slot": pg.hub_src_slot_sharded[h],
                   "dst": pg.hub_dst_local_sharded[h],
                   "w": (None if pg.hub_w_sharded is None
                         else pg.hub_w_sharded[h])}
        shards.append((gd, hub))
    return pg, shards, None


class _ShardedPlacement:
    """Partitions the graph and the index over one group's G shard devices
    and places each shard's arrays there, with the group's frontier
    exchange; the push, the walk phase and the candidate merge run here.
    ``g`` is a CSRGraph of either package or a ``ShardedGraphStore``;
    ``index`` a WalkIndex of either package or a ``ShardedIndexStore``."""

    def __init__(self, g, devices: Sequence[torch.device], index, *,
                 exchange: Optional[str] = None,
                 chips_per_host: Optional[int] = None, hub_rows: int = 0):
        G = len(devices)
        self.devices, self.G, self.n = list(devices), G, g.n
        pg, graph_shards, need_store = _graph_shards(g, G, hub_rows)
        self.pg = pg
        n_loc = self.n_loc = pg.n_loc
        n_pad = G * n_loc
        # checks the mode before any array is placed
        xch = self.exchange = xch_ops.FrontierExchange(
            exchange, self.devices, n_loc, chips_per_host=chips_per_host)

        needed = [None] * G
        if xch.mode in ("routed", "hier"):
            need = (need_store if need_store is not None else
                    part.needed_masks(pg).reshape(G, G, n_loc))
            if xch.mode == "hier":
                need = need.reshape(G, xch.H, xch.C, n_loc).any(axis=2)
            needed = [need[s] for s in range(G)]

        if isinstance(index, ShardedIndexStore):
            if index.n_shards != G:
                raise ValueError(
                    f"sharded index is {index.n_shards}-way, the mesh has "
                    f"{G} graph shards; re-save with save_sharded(..., {G})")
            if index.n_loc != n_loc:
                raise ValueError(
                    f"sharded index n_loc={index.n_loc} != partition "
                    f"n_loc={n_loc} (row_multiple mismatch)")
            boff = index.bucket_local_offsets
            idx_shards = [index.shard(s) for s in range(G)]
        else:
            pi = part.partition_index(index, G, n_loc)
            boff = pi.bucket_local_offsets
            e = pi.e_loc_total
            idx_shards = [{
                "edge_src_local": pi.edge_src_local[s * e:(s + 1) * e],
                "edge_dst": pi.edge_dst[s * e:(s + 1) * e],
                "counts_cum": pi.counts_cum[s * n_loc:(s + 1) * n_loc],
                "edge_mult": (None if pi.edge_mult is None
                              else pi.edge_mult[s * e:(s + 1) * e])}
                for s in range(G)]
        self.e_loc_total = int(boff[-1])
        self.shards = [
            _Shard(dev, s * n_loc, n_loc, n_pad, graph_shards[s][0],
                   graph_shards[s][1], idx_shards[s], boff, needed[s])
            for s, dev in enumerate(devices)]
        if xch.mode in ("routed", "hier"):
            xch.needed = [sh.needed for sh in self.shards]

    @property
    def n_pad(self) -> int:
        return self.G * self.n_loc

    # --- state and the push ---------------------------------------------

    def init_state(self, sources) -> tuple:
        """Per-shard (p, r) [n_loc, B] f32: the one-hot residue of each
        query on the shard that owns its source."""
        src = np.asarray(sources, dtype=np.int64)
        if src.ndim != 1 or (src < 0).any() or (src >= self.n).any():
            raise ValueError("sources must be a 1-D array of node ids")
        B = src.shape[0]
        ps, rs = [], []
        for sh in self.shards:
            p = torch.zeros((self.n_loc, B), dtype=torch.float32,
                            device=sh.device)
            r = torch.zeros_like(p)
            cols = np.nonzero((src >= sh.row0)
                              & (src < sh.row0 + self.n_loc))[0]
            if len(cols):
                r[torch.as_tensor(src[cols] - sh.row0, device=sh.device),
                  torch.as_tensor(cols, device=sh.device)] = 1.0
            ps.append(p)
            rs.append(r)
        return ps, rs

    def _status(self, width: int):
        """Per shard an int32 [width] row (its flag, then its counts per
        destination), and a function that reads them all as a [G, width]
        array (a copy: the rows are zeroed for the next superstep): one
        read when every shard shares a device."""
        if self.exchange.one_device:
            st = torch.zeros((self.G, width), dtype=torch.int32,
                             device=self.devices[0])
            return list(st), lambda: st.cpu().numpy().copy(), [st]
        rows = [torch.zeros(width, dtype=torch.int32, device=d)
                for d in self.devices]
        return rows, lambda: np.stack([r.cpu().numpy() for r in rows]), rows

    def prepass(self, ps, rs, bufs, thr, alpha: float) -> None:
        """The K1 pre-pass of every shard: ``p`` += the absorbed mass, in
        place, and the shard's contribution into its own block of its
        exchange buffer."""
        n_loc = self.n_loc
        for h, sh in enumerate(self.shards):
            push_prepass(ps[h], rs[h], bufs[h][h * n_loc:(h + 1) * n_loc],
                         thr[h], sh.out_deg, sh.wsum, alpha)

    def _gather(self, rs, bufs, thr, flags) -> None:
        """Every shard's K1 gather: tail edges (masking), then hub edges
        from the compact ``buf[hub_ids]`` operand (flagging)."""
        for h, sh in enumerate(self.shards):
            hub = sh.hub_ids is not None
            gather_scatter_add(rs[h], bufs[h], sh.in_indptr, sh.in_src,
                               edge_w=sh.in_w, thr=thr[h], mask=True,
                               flag=None if hub else flags[h],
                               sched=sh.in_sched)
            if hub:
                gather_scatter_add(rs[h], bufs[h].index_select(0, sh.hub_ids),
                                   sh.hub_indptr, sh.hub_src,
                                   edge_w=sh.hub_w, thr=thr[h],
                                   flag=flags[h], sched=sh.hub_sched)

    def push(self, ps, rs, thr, alpha: float, max_iters: int) -> int:
        """Push supersteps in place on the per-shard (p, r) until no entry
        of any shard's r exceeds its threshold ``thr[h]``, or ``max_iters``
        supersteps ran; returns the supersteps run.  A superstep is the
        pre-pass, the frontier exchange and every shard's gather; the host
        reads the flags (and the exchange's counts) once per superstep."""
        xch = self.exchange
        bufs = xch.buffers(rs[0].shape[1])
        rows, read, whole = self._status(1 + xch.D)
        flags = [r[0:1] for r in rows]
        counts = [r[1:] for r in rows]
        for h in range(self.G):
            flags[h].copy_((rs[h] > thr[h][:, None]).any().reshape(1))
        ahead = xch.D > 0   # pre-pass and compaction before the read
        if ahead:
            self.prepass(ps, rs, bufs, thr, alpha)
            xch.send(bufs, counts)
        st = read()
        iters = 0
        while iters < max_iters and st[:, 0].any():
            for t in whole:
                t.zero_()
            if not ahead:
                self.prepass(ps, rs, bufs, thr, alpha)
            xch.exchange(bufs, st[:, 1:] if ahead else None)
            self._gather(rs, bufs, thr, flags)
            iters += 1
            if ahead and iters < max_iters:
                self.prepass(ps, rs, bufs, thr, alpha)
                xch.send(bufs, counts)
            st = read()
        return iters

    # --- the walk phase and the candidates --------------------------------

    def walk_partials(self, rs, depth: int) -> list:
        """Per shard, the [n_pad, B] f32 endpoint mass of its residues: one
        K2 launch over the buckets from ``depth`` on, as
        ``fora_tpu/parallel/sharded.py::_indexed_contrib`` (299-320)."""
        return [index_spmv_level(rs[h], sh.idx_indptr[depth:],
                                 sh.idx_off_dev[depth:], sh.idx_src,
                                 sh.idx_mult, sh.inv(depth),
                                 sched=sh.walk_sched(depth))
                for h, sh in enumerate(self.shards)]

    def candidates(self, ps, walk_loc, kk: int) -> tuple:
        """(vals [B, G*kk], global ids [B, G*kk] int64, p there [B, G*kk])
        on the first shard's device, ranked by value descending, the
        earlier shard first on ties: each shard's top-``kk`` of p + walk
        (K3's selection; ``kk`` = n_loc takes the whole column, which only
        a graph of fewer than k + 1 rows per shard reaches), merged by a
        stable sort as ``lax.top_k`` over the gathered candidates."""
        dev0 = self.devices[0]
        cand_v, cand_i, cand_p = [], [], []
        for h, sh in enumerate(self.shards):
            p, w = ps[h], walk_loc[h]
            if kk >= self.n_loc:
                # the whole column: a branch of the function, outside
                # K3's 0 < k < n (JAX's clamp, sharded.py:515-519)
                v, i = topk_rows_chunked(p, kk, addend=w)
            else:
                v, i = topk_sum(p, w, kk)
            cand_v.append(v.to(dev0))
            cand_i.append((i + sh.row0).to(dev0))
            cand_p.append(torch.gather(p, 0, i.T).T.to(dev0))
        vals, sel = torch.sort(torch.cat(cand_v, dim=1), dim=1,
                               descending=True, stable=True)
        return (vals, torch.gather(torch.cat(cand_i, dim=1), 1, sel),
                torch.gather(torch.cat(cand_p, dim=1), 1, sel))

    def level(self, ps, rs, depth: int, omega_unit: float, *, k: int,
              t: float, eps: float, alpha: float, max_iters: int):
        """One delta level of the refinement pool from (ps, rs), advanced
        in place: ``(vals, idx, lb, ub, accept, info)`` as
        ``_shard_level_step`` computes them."""
        xch = self.exchange
        c0, f0 = xch.compacted, xch.fell_back
        thr = [sh.thr(depth, omega_unit) for sh in self.shards]
        iters = self.push(ps, rs, thr, alpha, max_iters)
        walk_loc = ring.ring_reduce_scatter(self.walk_partials(rs, depth))
        kk_loc = min(k + 1, self.n_loc)
        vals, idx, p_at = self.candidates(ps, walk_loc, kk_loc)
        kk = min(k + 1, self.G * kk_loc)
        out = bounds_mod._bounds(vals[:, :kk], idx[:, :kk], p_at[:, :kk],
                                 omega_unit, k, t, eps)
        vals_k, idx_k, lb, ub, _, _, accept = out
        return vals_k, idx_k, lb, ub, accept, {
            "supersteps": iters, "compacted": xch.compacted - c0,
            "fell_back": xch.fell_back - f0}


def _mesh_groups(mesh) -> list:
    """The query groups of ``mesh``: a flat list of G devices is one group,
    a list of Q lists of G devices is Q groups."""
    mesh = list(mesh)
    if mesh and all(isinstance(d, (list, tuple)) for d in mesh):
        groups = [[torch.device(d) for d in grp] for grp in mesh]
    elif any(isinstance(d, (list, tuple)) for d in mesh):
        raise ValueError("mesh: give one list of devices or a list of "
                         "query groups")
    else:
        groups = [[torch.device(d) for d in mesh]]
    if not groups[0] or any(len(grp) != len(groups[0]) for grp in groups):
        raise ValueError("mesh: every query group needs the same number of "
                         "graph shards")
    return groups


def _placements(g, groups, index, **kw) -> list:
    """One placement per query group; groups on the same devices share
    one (on one card, every group)."""
    by_devices: dict = {}
    out = []
    for grp in groups:
        key = tuple(grp)
        if key not in by_devices:
            by_devices[key] = _ShardedPlacement(g, grp, index, **kw)
        out.append(by_devices[key])
    return out


def _split(n: int, Q: int, what: str) -> int:
    if n % Q:
        raise ValueError(f"{what} of {n} must divide by the query-axis size "
                         f"{Q}")
    return n // Q


class ShardedForaEngine:
    """The sharded graph and index on the mesh's devices, and the one-shot
    indexed top-k over them.

    ``mesh`` is a list of G shard devices, or a list of Q query groups of
    G (``make_mesh``); the batch must divide by Q.  ``g`` may be a
    ``ShardedGraphStore`` and ``index`` a ``ShardedIndexStore``.  Unlike
    ``fora_tpu``'s engine this one takes no ``pallas_ring`` or
    ``pallas_interpret``: its dense exchange is always the ring (P1, P2).
    Without an index (the raw-walk lockstep walk) it raises
    ``NotImplementedError`` (ROADMAP Queue 1 item 4), and for the
    ``ragged`` exchange (ROADMAP C5).  ``placement`` is the first query
    group's ``_ShardedPlacement``: its ``prepass``, ``walk_partials`` and
    ``candidates`` are the phases of ``topk``.
    """

    def __init__(self, g, mesh, rcfg: ResolvedConfig, *,
                 k: Optional[int] = None, index=None,
                 exchange: Optional[str] = None,
                 chips_per_host: Optional[int] = None, hub_rows: int = 0):
        if index is None:
            raise NotImplementedError(
                "the sharded raw-walk path (lockstep walk) is not ported "
                "(ROADMAP Queue 1 item 4): pass a FORA+ index")
        groups = _mesh_groups(mesh)
        self.devices = groups[0]
        self.rcfg = rcfg
        self.k = k if k is not None else rcfg.k
        self.G, self.Q = len(groups[0]), len(groups)
        self.chips_per_host = chips_per_host
        self._groups = _placements(g, groups, index, exchange=exchange,
                                   chips_per_host=chips_per_host,
                                   hub_rows=hub_rows)
        self.placement = self._groups[0]
        self.exchange_mode = self.placement.exchange.mode
        self.pg, self.e_loc_total = (self.placement.pg,
                                     self.placement.e_loc_total)
        self.n_loc, self.n_pad = self.placement.n_loc, self.placement.n_pad
        if not 0 < self.k < self.n_loc:
            raise ValueError(f"k = {self.k} must lie in (0, n_loc = "
                             f"{self.n_loc})")
        self.index_depth = index.depth_for(rcfg.omega_unit, rcfg.rmax)
        self._thr = [sh.thr(self.index_depth, rcfg.omega_unit)
                     for sh in self.shards]

    @property
    def shards(self) -> list:
        return self.placement.shards

    @property
    def exchange(self):
        """The first group's ``ops.exchange.FrontierExchange``."""
        return self.placement.exchange

    def exchange_bytes(self, batch: int) -> int:
        """Bytes leaving one shard per superstep in this engine's exchange
        (``exchange_bytes_model``; the cross-host stage for hier)."""
        return exchange_bytes_model(
            self.exchange_mode, n_loc=self.n_loc, batch=batch, G=self.G,
            cap=self.exchange.cap, chips_per_host=self.chips_per_host or 1)

    # --- the phases of topk, on the first query group ---------------------

    def init_state(self, sources) -> tuple:
        return self.placement.init_state(sources)

    def push(self, ps, rs, max_iters: Optional[int] = None) -> int:
        """Push supersteps in place until no residue of any shard exceeds
        its coverage threshold, or ``max_iters`` (default
        ``rcfg.max_push_iters``) ran; returns the supersteps run."""
        if max_iters is None:
            max_iters = self.rcfg.max_push_iters
        return self.placement.push(ps, rs, self._thr, self.rcfg.alpha,
                                   max_iters)

    def merge_topk(self, ps, walk_loc, placement=None) -> tuple:
        """(values [B, k], node ids [B, k] int64) on the group's first
        shard device: the first k of the group's merged candidates
        (``_ShardedPlacement.candidates`` with k per shard)."""
        k = self.k
        vals, ids, _ = (placement or self.placement).candidates(
            ps, walk_loc, k)
        return vals[:, :k], ids[:, :k]

    def topk(self, sources, key=None) -> ShardedTopkResult:
        """Top-k of every source's approximate PPR (``key`` is ignored: the
        indexed path is deterministic); the batch's columns split over the
        query groups."""
        del key
        src = np.asarray(sources)
        c = _split(len(src), self.Q, "a batch")
        vals, ids, iters = [], [], 0
        dev0 = self.devices[0]
        for q, pl in enumerate(self._groups):
            ps, rs = pl.init_state(src[q * c:(q + 1) * c])
            thr = [sh.thr(self.index_depth, self.rcfg.omega_unit)
                   for sh in pl.shards]
            iters += pl.push(ps, rs, thr, self.rcfg.alpha,
                             self.rcfg.max_push_iters)
            walk_loc = ring.ring_reduce_scatter(
                pl.walk_partials(rs, self.index_depth))
            v, i = self.merge_topk(ps, walk_loc, pl)
            vals.append(v.to(dev0))
            ids.append(i.to(dev0))
        vals, ids = torch.cat(vals), torch.cat(ids)
        return ShardedTopkResult(
            values=vals.cpu().numpy(),
            node_ids=ids.to(torch.int32).cpu().numpy(),
            push_iters=iters, walk_overflow=np.zeros(len(src), dtype=bool))


class ShardedTopkRunner(TopkRunner):
    """The delta-halving refinement pool over the sharded graph and index.

    The same host-side loop as ``TopkRunner.query_pool`` and
    ``flush_deferred`` (resumed push state, per-depth index slices,
    adaptive widths, the threshold rule or the Bernstein separation), with
    each block's (p, r) state row-sharded: per query group, one [n_loc,
    width / Q] pair per shard.  ``mesh``, ``g`` and ``index`` as for
    ``ShardedForaEngine``; a batch must divide by the query-axis size Q.
    Requires a FORA+ index, as the reference does.  Each level's
    ``last_level_stats`` record adds the supersteps that took the
    compacted exchange (``compacted``) and those that fell back to the
    ring (``fell_back``).
    """

    def __init__(self, g, mesh, rcfg: ResolvedConfig, index, *,
                 k: Optional[int] = None, delta_stride: float = 2.0,
                 accept_slack: float = 1.0, exchange: Optional[str] = None,
                 chips_per_host: Optional[int] = None, hub_rows: int = 0):
        if index is None:
            raise ValueError("ShardedTopkRunner requires a walk index")
        super().__init__(None, rcfg, k=k, index=index,
                         delta_stride=delta_stride,
                         accept_slack=accept_slack)
        groups = _mesh_groups(mesh)
        self.G, self.Q = len(groups[0]), len(groups)
        self.WIDTH_FLOOR = max(128, self.Q)
        self._groups = _placements(g, groups, index, exchange=exchange,
                                   chips_per_host=chips_per_host,
                                   hub_rows=hub_rows)
        self._dev = [list(pl.devices) for pl in self._groups]

    # --- block state: [Q][G] per-shard [n_loc, cols] pairs -------------

    def _new_block(self, sources):
        c = _split(len(sources), self.Q, "a block")
        p, r = [], []
        for q, pl in enumerate(self._groups):
            ps, rs = pl.init_state(np.asarray(sources)[q * c:(q + 1) * c])
            p.append(ps)
            r.append(rs)
        return p, r

    def _flat(self, x) -> list:
        """Per shard, every group's columns side by side on the first
        group's device for that shard."""
        if len(x) == 1:
            return x[0]
        return [torch.cat([x[q][h].to(self._dev[0][h])
                           for q in range(len(x))], dim=1)
                for h in range(self.G)]

    def _select_cols(self, p, r, sel):
        fp, fr = self._flat(p), self._flat(r)
        idx = [torch.as_tensor(np.asarray(sel), device=d)
               for d in self._dev[0]]
        return ([[t.index_select(1, i) for t, i in zip(fp, idx)]],
                [[t.index_select(1, i) for t, i in zip(fr, idx)]])

    def _concat_cols(self, pairs):
        if len(pairs) == 1:
            return pairs[0]
        fps = [self._flat(p) for p, _ in pairs]
        frs = [self._flat(r) for _, r in pairs]
        return ([[torch.cat([fp[h] for fp in fps], dim=1)
                  for h in range(self.G)]],
                [[torch.cat([fr[h] for fr in frs], dim=1)
                  for h in range(self.G)]])

    def _split_cols(self, p, r, width: int) -> list:
        fp, fr = self._flat(p), self._flat(r)
        total = fp[0].shape[1]
        if self.Q == 1 and total == width:
            return [([fp], [fr])]
        c = _split(width, self.Q, "a block")
        blocks = []
        for lo in range(0, total, width):
            def cut(f):
                return [[f[h][:, lo + q * c: lo + (q + 1) * c]
                         .to(self._dev[q][h]).contiguous()
                         for h in range(self.G)] for q in range(self.Q)]
            blocks.append((cut(fp), cut(fr)))
        return blocks

    # --- one level ----------------------------------------------------

    def _level_step(self, ckey: Optional[int]):
        """``(p, r, rmax, omega_unit, seed, live) -> (vals, idx, lb, ub,
        bacc, p, r, info)`` at index depth ``ckey``, each query group in
        turn; the outputs on the first shard's device."""
        if ckey not in self._lsteps:
            rc, k = self.rcfg, self.k
            dev0 = self._dev[0][0]

            def fn(p, r, rmax, omega_unit, seed, live):
                del rmax, seed, live   # indexed mode is deterministic
                outs, info = [], {}
                for q, pl in enumerate(self._groups):
                    *o, inf = pl.level(
                        p[q], r[q], ckey, omega_unit, k=k, t=self._t,
                        eps=rc.epsilon, alpha=rc.alpha,
                        max_iters=rc.max_push_iters)
                    outs.append([x.to(dev0) for x in o])
                    for name, v in inf.items():
                        info[name] = info.get(name, 0) + v
                vals, idx, lb, ub, bacc = (torch.cat(z) for z in zip(*outs))
                return vals, idx, lb, ub, bacc, p, r, info

            self._lsteps[ckey] = fn
        return self._lsteps[ckey]
