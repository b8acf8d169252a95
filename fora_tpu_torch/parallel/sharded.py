"""The graph-sharded, indexed, one-shot top-k engine.

Port of ``fora_tpu/parallel/sharded.py``'s ``ShardedForaEngine`` (819-900)
on its indexed (FORA+) path with the dense frontier exchange.  Rows are
split over G graph shards (``partition.partition_rows``); each shard lives
on one device of the mesh (``mesh.make_mesh``), and one process loops over
the shards where JAX runs one ``shard_map`` program.  Per query batch:

  1. each shard pushes over its own in-edges (K1); every superstep's
     frontier, the [n_loc, B] contribution block of each shard, reaches
     every shard through the ring all-gather (P1, ``ops.ring``);
  2. each shard runs the index SpMV (K2, one launch over the level's
     buckets) over the index edges whose source it owns, into an [n_pad, B]
     partial over all endpoints;
  3. the ring reduce-scatter (P2) sums the partials into the owning shards;
  4. each shard takes the top-k of ``p + walk`` over its rows (K3's
     selection), and a stable sort merges the G * k candidates, as
     ``lax.top_k`` over [B, G * k] does (the earlier shard first on ties).

The dense exchange is always the ring: JAX's ``pallas_ring`` and
``pallas_interpret`` switches are gone, since the port has no XLA
collective to switch to.  CPU tensors run the plain version of every
kernel, the ring included.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..config import ResolvedConfig
from ..graph.csr import dst_indptr, host_to_device
from ..index.build import NUM_BUCKETS
from ..kernels.schedule import gather_schedule
from ..ops import ring
from ..ops.gather import gather_scatter_add, index_spmv_level
from ..ops.push import push_prepass
from ..ops.topk import topk_sum
from . import partition as part

EXCHANGE_MODES = ("dense", "compact", "routed", "ragged", "hier")


class ShardedTopkResult(NamedTuple):
    values: np.ndarray        # [B, k] f32, descending
    node_ids: np.ndarray      # [B, k] i32, global ids
    push_iters: int           # supersteps run
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


class _Shard:
    """One shard's arrays on its device: the in-edge CSR by local
    destination (global sources) with its K1 work list, degrees, the index
    rows it owns and the index edges whose source it owns (local sources),
    in bucket order with each bucket's CSR by global endpoint stacked into
    ``idx_indptr``.  Every pad entry is dropped."""

    def __init__(self, device, row0, in_indptr, in_src, out_deg, counts_cum,
                 idx_indptr, idx_off, idx_src, idx_mult):
        self.device = device
        self.row0 = row0
        self.in_indptr = in_indptr     # [n_loc + 1] i32
        self.in_src = in_src           # [m_real] i32 global
        self.in_sched = gather_schedule(in_indptr)
        self.out_deg = out_deg         # [n_loc] i32
        self.wsum = out_deg.to(torch.float32)
        self.counts_cum = counts_cum   # [n_loc, Q] i32
        self.idx_indptr = idx_indptr   # [Q, n_pad + 1] i32 per bucket
        self.idx_src = idx_src         # [e] i32 local, bucket order
        self.idx_mult = idx_mult       # [e] f32 or None
        # the first edge of each bucket, on the host and the device
        self.idx_off = idx_off
        self.idx_off_dev = torch.tensor(idx_off[:NUM_BUCKETS],
                                        dtype=torch.int32, device=device)

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


def _sorted(a: np.ndarray, what: str) -> np.ndarray:
    if len(a) > 1 and not bool(np.all(a[1:] >= a[:-1])):
        raise ValueError(f"{what} are not sorted by destination")
    return a


class _ShardedPlacement:
    """Partitions the graph and the index over the shards and places each
    shard's arrays on its device: the in-RAM, dense-exchange branch of
    ``fora_tpu``'s ``_ShardedPlacement.__init__`` (605-760) and
    ``_place_index`` (761-812)."""

    def __init__(self, g, devices: Sequence[torch.device], index):
        G = len(devices)
        pg = part.partition_rows(g, G)
        self.pg = pg
        self.G, self.n_loc = G, pg.n_loc
        n_loc, n_pad, m_loc = pg.n_loc, pg.n_pad, pg.m_loc
        pi = part.partition_index(index, G, n_loc)
        boff = pi.bucket_local_offsets
        e = self.e_loc_total = pi.e_loc_total
        self.shards = []
        for s, dev in enumerate(devices):
            src = pg.in_src_global[s * m_loc:(s + 1) * m_loc]
            dst = pg.in_dst_local[s * m_loc:(s + 1) * m_loc]
            real = dst < n_loc
            in_dst = _sorted(dst[real], f"shard {s} in-edges")
            ptrs, srcs, mults, off = [], [], [], [0]
            for q in range(NUM_BUCKETS):
                lo, hi = s * e + int(boff[q]), s * e + int(boff[q + 1])
                isrc = pi.edge_src_local[lo:hi]
                keep = isrc < n_loc
                idst = _sorted(pi.edge_dst[lo:hi][keep],
                               f"shard {s} index bucket {q}")
                ptrs.append(dst_indptr(idst, n_pad))
                srcs.append(isrc[keep])
                if pi.edge_mult is not None:
                    mults.append(pi.edge_mult[lo:hi][keep])
                off.append(off[-1] + int(keep.sum()))
            self.shards.append(_Shard(
                dev, s * n_loc,
                host_to_device(dst_indptr(in_dst, n_loc), dev, np.int32),
                host_to_device(src[real], dev, np.int32),
                host_to_device(
                    pg.out_deg_sharded[s * n_loc:(s + 1) * n_loc], dev,
                    np.int32),
                host_to_device(pi.counts_cum[s * n_loc:(s + 1) * n_loc],
                               dev, np.int32),
                host_to_device(np.stack(ptrs), dev, np.int32), off,
                host_to_device(np.concatenate(srcs), dev, np.int32),
                None if pi.edge_mult is None else
                host_to_device(np.concatenate(mults), dev, np.float32)))

    @property
    def n_pad(self) -> int:
        return self.G * self.n_loc


def _mesh_devices(mesh) -> list:
    """The shard devices of ``mesh``, a flat list; a 2-D ('graph',
    'query') layout raises."""
    if any(isinstance(d, (list, tuple)) for d in mesh):
        raise NotImplementedError("fora_tpu_torch has no query axis yet: "
                                  "pass one device per graph shard")
    return [torch.device(d) for d in mesh]


class ShardedForaEngine:
    """The sharded graph and index on the mesh's devices, and the one-shot
    indexed top-k over them.

    ``mesh`` is the list of G shard devices (``make_mesh``).  Unlike
    ``fora_tpu``'s engine this one takes no ``pallas_ring`` or
    ``pallas_interpret``: its dense exchange is always the ring (P1, P2).
    It raises ``NotImplementedError`` where the port has not caught up:
    without an index (the raw-walk lockstep walk), on weighted graphs,
    with ``hub_rows`` > 0, for an exchange other than ``dense``, and for
    a query axis (ROADMAP, "Still to port").
    """

    def __init__(self, g, mesh, rcfg: ResolvedConfig, *,
                 k: Optional[int] = None, index=None,
                 exchange: str = "dense", hub_rows: int = 0):
        if index is None:
            raise NotImplementedError(
                "the sharded raw-walk path (lockstep walk) is not ported: "
                "pass a FORA+ index")
        if g.weighted:
            raise NotImplementedError("weighted graphs on shards are not "
                                      "ported")
        if hub_rows > 0:
            raise NotImplementedError("the hub split on shards is not "
                                      "ported")
        if exchange not in EXCHANGE_MODES:
            raise ValueError(f"exchange must be one of {EXCHANGE_MODES}")
        if exchange != "dense":
            raise NotImplementedError(
                f"the {exchange!r} exchange is not ported: only 'dense' "
                "(the ring all-gather)")
        devices = _mesh_devices(mesh)
        self.devices = devices
        self.rcfg = rcfg
        self.k = k if k is not None else rcfg.k
        self.G = len(devices)
        self._data = _ShardedPlacement(g, devices, index)
        self.pg, self.e_loc_total = self._data.pg, self._data.e_loc_total
        self.n_loc, self.n_pad = self._data.n_loc, self._data.n_pad
        if not 0 < self.k < self.n_loc:
            raise ValueError(f"k = {self.k} must lie in (0, n_loc = "
                             f"{self.n_loc})")
        self.index_depth = index.depth_for(rcfg.omega_unit, rcfg.rmax)
        depth = self.index_depth
        omega = float(np.float32(rcfg.omega_unit))
        self._thr, self._inv, self._walk_sched = [], [], []
        for sh in self.shards:
            counts = sh.counts_cum[:, depth]
            # per-node coverage threshold count_v / omega_unit (f32), as
            # fora_tpu/parallel/sharded.py:372-373
            self._thr.append(counts.to(torch.float32) / omega)
            self._inv.append(1.0 / counts.clamp_min(1).to(torch.float32))
            self._walk_sched.append(gather_schedule(sh.idx_indptr[depth:]))
        self._one_device = all(d == devices[0] for d in devices)

    @property
    def shards(self) -> list:
        return self._data.shards

    def exchange_bytes(self, batch: int) -> int:
        """Dense-exchange bytes leaving one shard per superstep."""
        return exchange_bytes_model("dense", n_loc=self.n_loc, batch=batch,
                                    G=self.G)

    # --- the phases of topk ---------------------------------------------

    def init_state(self, sources) -> tuple:
        """Per-shard (p, r) [n_loc, B] f32: the one-hot residue of each
        query on the shard that owns its source."""
        src = np.asarray(sources, dtype=np.int64)
        if src.ndim != 1 or (src < 0).any() or (src >= self.rcfg.n).any():
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

    def _flags(self):
        """One int32 [1] flag per shard: views of one [G] tensor when every
        shard shares a device (one host read), else one per device."""
        if self._one_device:
            flags = torch.zeros(self.G, dtype=torch.int32,
                                device=self.devices[0])
            return [flags[h:h + 1] for h in range(self.G)], \
                lambda: bool(flags.any())
        fl = [torch.zeros(1, dtype=torch.int32, device=d)
              for d in self.devices]
        return fl, lambda: any(bool(f.item()) for f in fl)

    def exchange_buffers(self, batch: int) -> list:
        """Per shard, an uninitialised [n_pad, B] f32 exchange buffer."""
        return [torch.empty((self.n_pad, batch), dtype=torch.float32,
                            device=sh.device) for sh in self.shards]

    def prepass(self, ps, rs, bufs) -> None:
        """The K1 pre-pass of every shard: ``p`` += the absorbed mass, in
        place, and the shard's contribution into its own block of its
        exchange buffer (P1 fills the other blocks)."""
        n_loc = self.n_loc
        for h, sh in enumerate(self.shards):
            push_prepass(ps[h], rs[h], bufs[h][h * n_loc:(h + 1) * n_loc],
                         self._thr[h], sh.out_deg, sh.wsum, self.rcfg.alpha)

    def push(self, ps, rs, max_iters: Optional[int] = None) -> int:
        """Push supersteps in place on the per-shard (p, r) until no entry
        of any shard's r exceeds its coverage threshold, or ``max_iters``
        (default ``rcfg.max_push_iters``) supersteps ran; returns the
        supersteps run.  A superstep is :meth:`prepass`, then P1 over the
        exchange buffers, then every shard's K1 masked gather with its
        flag; the host reads the flags once per superstep."""
        if max_iters is None:
            max_iters = self.rcfg.max_push_iters
        bufs = self.exchange_buffers(rs[0].shape[1])
        flags, read = self._flags()
        for h in range(self.G):
            flags[h].copy_((rs[h] > self._thr[h][:, None]).any().reshape(1))
        more = read()
        iters = 0
        while iters < max_iters and more:
            for f in flags:
                f.zero_()
            self.prepass(ps, rs, bufs)
            ring.ring_all_gather(bufs)
            for h, sh in enumerate(self.shards):
                gather_scatter_add(rs[h], bufs[h], sh.in_indptr, sh.in_src,
                                   thr=self._thr[h], mask=True,
                                   flag=flags[h], sched=sh.in_sched)
            iters += 1
            more = read()
        return iters

    def walk_partials(self, rs) -> list:
        """Per shard, the [n_pad, B] f32 endpoint mass of its residues: one
        K2 launch over the buckets from the index depth on, as
        ``fora_tpu/parallel/sharded.py::_indexed_contrib`` (299-320)."""
        d = self.index_depth
        return [index_spmv_level(rs[h], sh.idx_indptr[d:],
                                 sh.idx_off_dev[d:], sh.idx_src,
                                 sh.idx_mult, self._inv[h],
                                 sched=self._walk_sched[h])
                for h, sh in enumerate(self.shards)]

    def merge_topk(self, ps, walk_loc) -> tuple:
        """(values [B, k], node ids [B, k] int64) on the first shard's
        device: each shard's top-k of p + walk, then the top-k of the
        G * k candidates in shard order (stable: the earlier shard, then
        the better local rank, wins a tie)."""
        k, dev0 = self.k, self.devices[0]
        cand_v, cand_i = [], []
        for h, sh in enumerate(self.shards):
            v, i = topk_sum(ps[h], walk_loc[h], k)
            cand_v.append(v.to(dev0))
            cand_i.append((i + sh.row0).to(dev0))
        vals, sel = torch.sort(torch.cat(cand_v, dim=1), dim=1,
                               descending=True, stable=True)
        ids = torch.gather(torch.cat(cand_i, dim=1), 1, sel[:, :k])
        return vals[:, :k], ids

    def topk(self, sources, key=None) -> ShardedTopkResult:
        """Top-k of every source's approximate PPR (``key`` is ignored: the
        indexed path is deterministic)."""
        del key
        ps, rs = self.init_state(sources)
        iters = self.push(ps, rs)
        walk_loc = ring.ring_reduce_scatter(self.walk_partials(rs))
        vals, ids = self.merge_topk(ps, walk_loc)
        B = vals.shape[0]
        return ShardedTopkResult(
            values=vals.cpu().numpy(),
            node_ids=ids.to(torch.int32).cpu().numpy(),
            push_iters=iters, walk_overflow=np.zeros(B, dtype=bool))
