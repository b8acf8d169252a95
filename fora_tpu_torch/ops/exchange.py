"""The frontier exchange of the sharded push: every shard's [n_loc, B]
contribution block reaches the shards whose in-edges read it.

Port of ``fora_tpu/parallel/sharded.py::_frontier_exchange`` (93-207) and
``hier_ici_bytes_model`` (236-241).  Each shard h owns rows [h * n_loc,
(h + 1) * n_loc) of the graph and an [n_pad, B] exchange buffer; the K1
pre-pass writes its contribution into its own block of that buffer, and
after the exchange the shard's gather reads the rows it needs.  The modes:

  * ``dense``:   the ring all-gather of every block (P1, ``ops.ring``);
  * ``compact``: each shard's active rows (a non-zero entry), up to ``cap``
    of them, to every shard;
  * ``routed``:  per destination t, the active rows that t's in-edges read
    (``partition.needed_masks``), up to ``cap``, one copy per (source,
    destination) pair;
  * ``hier``:    per destination host, the active rows some chip of that
    host reads (``needed_host_masks``): first to the same chip position of
    the host, then shared among the host's chips (``host_groups``).

A compacted superstep is three steps.  The send side is the frontier
compaction (``kernels/csrc/exchange.cu``) on each shard: ids and rows of
the rows due to each destination, and their count.  The copies are the
all-to-all (routed), the all-gather (compact) and the two hier stages,
XLA collectives in JAX.  With every shard on one device the senders write
straight into a [D, G, cap] slot array whose block for a destination is
what that destination receives, so nothing is copied; with shards on
several devices each stage is a ``copy_`` of the rows sent.  The receive
is P3 (``kernels.row_scatter_add``) into the zeroed buffer, skipping the
pad slots, so each row lands at its id once and the buffer's needed rows
equal the dense exchange's bit for bit.

Zeroing by rows.  The receive needs a buffer that is zero on every row it
does not receive, and a shard's [n_pad, B] buffer is G times the block the
pre-pass writes.  So ``FrontierExchange`` keeps track of what was written
since each buffer was last zero: the shard's own block (the pre-pass
writes it every superstep) and the real ids of the previous compacted
receive; or everything, after the ring filled the buffer or after
``buffers`` made new ones.  Nothing else may write the buffers: a
write the exchange does not see would survive the next zeroing.  Before
a receive it clears every buffer's own block and those ids in one launch
per card (``exchange_clear``, ``kernels/csrc/row_scatter.cu``), or
zeroes the whole buffers when everything may have been written.  On one device the ids of the
previous receive must outlive the next send, which writes the slot
arrays in place, so the id slots are double-buffered: each send writes
the half that the last receive did not read.

Across processes (a ``parallel.multihost.ProcessComm``) each process
holds L of the G shards' buffers.  The dense exchange is the ring among
the L, then one all-gather across the processes
(``ring.all_gather_processes``).  A compacted superstep compacts the L
local shards only; the status read has already given every process every
shard's counts, so each process knows which rows every other one sends
and receives.  The rows that cross the boundary, ``counts`` of them per
(sender shard, destination) and no pad slot, go in one ``all_to_all``,
each row with its global id in an int32 column beside it: per other
process, the blocks of the local senders for the destinations that
process's shards read (routed: its L shards; compact: the one block; hier:
its host, for a host is a process, so ``chips_per_host`` must be L and
the all-to-all is hier's first stage across hosts).  The received blocks
take the place of the remote senders' slots (the rest of their id slots
pad), and the share among the process's shards (hier's second stage) is
the one-device layout's views or the several devices' copies, as in one
process.  While ``sent`` is a list, each superstep appends what this
process sent to the others: (rows, B, compacted), a compacted row being
B + 1 words (the row and its id) and a dense one (the fall-back's
all-gather) B.

When some shard has more than ``cap`` rows due to a destination, every
shard takes the dense exchange for that superstep, as JAX's ``pmax`` and
``lax.cond`` do; the counts come back to the host with the push's flag
(``parallel/sharded.py``).  ``ragged`` is refused: the reference never
ran it (ROADMAP C5).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .. import kernels
from . import ring
from .gather import row_scatter_add, row_zero_plain

# the reference's exchanges; ``ragged`` is refused (ROADMAP C5)
MODES = ("dense", "compact", "routed", "ragged", "hier")

# the share of a shard's rows it may send to one destination
CAP_FRAC = 0.125


def exchange_cap(n_loc: int, frac: float = CAP_FRAC) -> int:
    """Rows a shard may send to one destination in a compacted superstep,
    as ``fora_tpu/parallel/sharded.py:639-641``."""
    return max(64, int(n_loc * frac) // 8 * 8)


def hier_ici_bytes_model(*, batch: int, G: int, cap: int,
                         chips_per_host: int) -> int:
    """Bytes per shard of the hier exchange's second (intra-host) stage:
    the [H, cap] blocks received, gathered among C chips."""
    H = G // chips_per_host
    return (chips_per_host - 1) * H * cap * (batch * 4 + 4)


def frontier_compact_plain(contrib: torch.Tensor,
                           needed: Optional[torch.Tensor], cap: int,
                           row0: int, pad_id: int, ids: torch.Tensor,
                           rows: torch.Tensor, counts: torch.Tensor) -> None:
    """Plain version of :func:`frontier_compact`, the slots in row order
    as ``jnp.nonzero`` fills them."""
    active = (contrib != 0).any(dim=1)
    for d in range(ids.shape[0]):
        act = active if needed is None else active & needed[d].bool()
        idx = torch.nonzero(act).flatten()
        counts[d] = idx.numel()
        take = idx[:cap]
        ids[d, :cap] = pad_id
        ids[d, :take.numel()] = (take + row0).to(torch.int32)
        rows[d, :take.numel()] = contrib.index_select(0, take)


def frontier_compact(contrib: torch.Tensor, needed: Optional[torch.Tensor],
                     cap: int, row0: int, pad_id: int, ids: torch.Tensor,
                     rows: torch.Tensor, counts: torch.Tensor) -> None:
    """In place: the first ``min(counts[d], cap)`` slots of ``ids[d]`` and
    ``rows[d]`` get the global id and the row of each row of ``contrib``
    with a non-zero entry that destination d needs (``needed[d]``, or
    every such row when ``needed`` is None); ``counts[d]`` the number of
    such rows, past ``cap`` included; the other slots of ``ids`` the pad
    id.  A CPU tensor takes the plain version (row order); a CUDA tensor
    launches the compaction kernel (slot order varies)."""
    if contrib.device.type == "cpu":
        frontier_compact_plain(contrib, needed, cap, row0, pad_id, ids, rows,
                               counts)
    else:
        kernels.frontier_compact(contrib, needed, cap, row0, pad_id, ids,
                                 rows, counts)


def exchange_clear_plain(bufs: list, n_loc: int, ids: list,
                         own: Optional[Sequence[int]] = None) -> None:
    """Plain version of :func:`exchange_clear`: per buffer a ``zero_`` of
    its own block and ``row_zero_plain`` over its ids."""
    own = range(len(bufs)) if own is None else own
    for buf, o, i in zip(bufs, own, ids):
        buf[o * n_loc:(o + 1) * n_loc].zero_()
        row_zero_plain(buf, i)


def exchange_clear(bufs: list, n_loc: int, ids: list,
                   own: Optional[Sequence[int]] = None) -> None:
    """In place, before a compacted receive: buffer t's own block (rows
    ``own[t]`` * n_loc to (``own[t]`` + 1) * n_loc - 1; ``own`` defaults to
    0, 1, ...) and the rows named by ``ids[t]`` (int32; an id outside the
    rows, a pad slot, is skipped) set to zero.  CPU tensors take the plain
    version; CUDA tensors launch the clear kernel once per card that holds
    buffers."""
    own = list(range(len(bufs)) if own is None else own)
    if bufs[0].device.type == "cpu":
        exchange_clear_plain(bufs, n_loc, ids, own)
        return
    by_device: dict = {}
    for t, buf in enumerate(bufs):
        by_device.setdefault(buf.device, []).append(t)
    for ts in by_device.values():
        kernels.exchange_clear([bufs[t] for t in ts], n_loc,
                               [ids[t] for t in ts], own=[own[t] for t in ts])


class FrontierExchange:
    """The exchange of one set of shards, with its buffers: the per-shard
    [n_pad, B] exchange buffers and the slot arrays, allocated for one
    batch width and reused across supersteps and levels.

    ``mode`` None is ``dense``; ``cap`` None is ``exchange_cap(n_loc)``.
    ``needed`` holds per shard the [D, n_loc] uint8 routing block (routed:
    D = G destinations; hier: D = H hosts) on the shard's device, or None
    (dense, compact); a caller may set it after construction, before the
    first ``send``.  ``compacted`` and ``fell_back`` count the supersteps
    that took each exchange, ``cleared`` the compacted ones whose buffers
    were cleared by rows (those that follow a compacted one).

    ``comm`` (a ``parallel.multihost.ProcessComm``): the shards are this
    process's L of ``n_shards`` (G), global shards ``shard0`` .. ``shard0``
    + L - 1 on ``devices``; the buffers hold all G blocks.  ``hier`` then
    needs ``chips_per_host`` = L.  ``sent``, None (nothing recorded) or a
    list that a caller sets, gets per superstep (rows, B, compacted): the
    rows this process sent to the others, the width and whether the
    superstep took the compacted exchange.

    The buffers' invariant (the module docstring's zeroing by rows): before
    each compacted receive, shard t's buffer is zero outside its own block
    and the rows the previous compacted receive wrote, unless it is new or
    the ring filled it since; only the pre-pass (its own block) and
    ``exchange`` write it otherwise.
    """

    def __init__(self, mode: Optional[str], devices: Sequence[torch.device],
                 n_loc: int, cap: Optional[int] = None,
                 needed: Optional[list] = None,
                 chips_per_host: Optional[int] = None, comm=None,
                 shard0: int = 0, n_shards: Optional[int] = None):
        mode = mode or "dense"
        if mode not in MODES:
            raise ValueError(f"exchange must be one of {MODES}")
        if mode == "ragged":
            raise NotImplementedError(
                "exchange 'ragged' is not ported: the reference never ran "
                "it (ROADMAP C5); 'routed' routes the same rows")
        L = len(devices)
        G = L if n_shards is None else n_shards
        self.comm, self.shard0 = comm, shard0
        # the global shards of this process
        self.local = list(range(shard0, shard0 + L))
        self.mode, self.devices, self.G, self.n_loc = mode, devices, G, n_loc
        if cap is None:
            cap = exchange_cap(n_loc)
        self.cap = cap if mode != "dense" else 0
        if mode != "dense" and cap < 1:
            raise ValueError(f"exchange {mode!r} needs a capacity >= 1")
        self.needed = needed
        self.C = chips_per_host or 1
        if mode == "hier":
            if chips_per_host is None or G % chips_per_host:
                raise ValueError("exchange='hier' needs chips_per_host "
                                 f"dividing the graph-axis size {G}")
            if comm is not None and chips_per_host != L:
                raise ValueError(
                    f"exchange='hier' across processes needs chips_per_host "
                    f"= {L}, the shards of one process (a host is a "
                    f"process), not {chips_per_host}")
        self.H = G // self.C
        # destinations of a sender's compaction
        self.D = {"dense": 0, "compact": 1, "routed": G, "hier": self.H}[mode]
        self.one_device = all(d == devices[0] for d in devices)
        self.compacted = 0
        self.fell_back = 0
        self.cleared = 0
        self.sent: Optional[list] = None
        self._B = None
        # per shard, the ids of the previous compacted receive; None: any
        # row of the buffers may hold data
        self._written = None

    @property
    def n_pad(self) -> int:
        return self.G * self.n_loc

    def _region(self, t: int) -> int:
        """The destination index of shard t's receive."""
        return {"compact": 0, "routed": t, "hier": t // self.C}[self.mode]

    def _regions(self, q: int) -> list:
        """The destinations whose blocks process q's shards receive."""
        L = len(self.local)
        return sorted({self._region(t) for t in range(q * L, (q + 1) * L)})

    def buffers(self, B: int) -> list:
        """Per shard, the [n_pad, B] f32 exchange buffer (contents
        undefined), reused while the width stays B.  A caller writes only
        shard h's own block of buffer h (rows h * n_loc to (h + 1) *
        n_loc), as the pre-pass does: the zeroing by rows before a
        compacted receive does not see other writes."""
        if self._B != B:
            # the old width's buffers go before the new ones are made
            self.bufs = self.send_ids = self.send_rows = None
            self.recv_ids = self.recv_rows = self.slot_src = None
            self.stage_ids = self.stage_rows = None
            self._ids = self._rows = self._recv = None
            self.bufs = [torch.empty((self.n_pad, B), dtype=torch.float32,
                                     device=d) for d in self.devices]
            if self.D:
                self._slots(B)
            self._B = B
            self._written = None
        return self.bufs

    def _slots(self, B: int) -> None:
        G, D, cap, dev0 = self.G, self.D, self.cap, self.devices[0]
        local = self.local
        if self.one_device:
            # sender s writes its block for destination d at [d, s] (a
            # remote sender's block lands there after the transfer); the
            # receiver of destination d reads [d] as one list of G * cap;
            # two halves of id slots, one for the send, one holding the
            # ids of the last receive
            ids = torch.empty((2, D, G, cap), dtype=torch.int32, device=dev0)
            rows = torch.empty((D, G, cap, B), dtype=torch.float32,
                               device=dev0)
            self._ids, self._rows = ids, rows
            self._id_halves = [
                ([ids[p, :, s] for s in local],
                 [ids[p, self._region(t)].reshape(-1) for t in local])
                for p in range(2)]
            self._half = 0
            self.send_ids, self.recv_ids = self._id_halves[0]
            self.send_rows = [rows[:, s] for s in local]
            self.recv_rows = [rows[self._region(t)].reshape(G * cap, B)
                              for t in local]
        else:
            self.send_ids = [torch.empty((D, cap), dtype=torch.int32,
                                         device=d) for d in self.devices]
            self.send_rows = [torch.empty((D, cap, B), dtype=torch.float32,
                                          device=d) for d in self.devices]
            self.recv_ids = [torch.empty((G, cap), dtype=torch.int32,
                                         device=d) for d in self.devices]
            self.recv_rows = [torch.empty((G, cap, B), dtype=torch.float32,
                                          device=d) for d in self.devices]
            if self.mode == "hier":
                H = self.H
                self.stage_ids = [torch.empty((H, cap), dtype=torch.int32,
                                              device=d) for d in self.devices]
                self.stage_rows = [torch.empty((H, cap, B),
                                               dtype=torch.float32, device=d)
                                   for d in self.devices]
        self.slot_src = {}
        for d in set(self.devices):
            self.slot_src[d] = torch.arange(G * cap, dtype=torch.int32,
                                            device=d)

    def send(self, bufs: list, counts: list) -> None:
        """The send side of every local shard: the compaction of its own
        block of its buffer, ``counts[h]`` ([D] int32) the rows due to
        each destination."""
        n_loc = self.n_loc
        for h, s in enumerate(self.local):
            frontier_compact(
                bufs[h][s * n_loc:(s + 1) * n_loc],
                None if self.needed is None else self.needed[h], self.cap,
                s * n_loc, self.n_pad, self.send_ids[h], self.send_rows[h],
                counts[h])

    def fits(self, counts: np.ndarray) -> bool:
        """Whether every shard's count for every destination is within the
        capacity (the host's ``pmax`` of JAX's ``lax.cond``)."""
        return int(counts.max(initial=0)) <= self.cap

    def exchange(self, bufs: list, counts: Optional[np.ndarray] = None
                 ) -> None:
        """Fill every local shard's buffer (``bufs``, as ``buffers`` gave
        them): compacted when ``counts`` ([G, D] of every shard, read from
        the send side) fit the capacity, else the ring (and across
        processes its all-gather)."""
        if self.mode == "dense" or counts is None or not self.fits(counts):
            if self.mode != "dense":
                self.fell_back += 1
            if self.comm is None:
                ring.ring_all_gather(bufs)
            else:
                ring.all_gather_processes(bufs, self.comm, self.shard0,
                                          self.n_loc)
                self._sent((self.comm.size - 1) * len(bufs) * self.n_loc,
                           False)
            self._written = None
            return
        self.compacted += 1
        self._clear(bufs)
        if self.comm is not None and self.comm.size == 1:
            self._sent(0, True)
        elif self.comm is not None:
            self._transfer(counts)
            if self.one_device:
                for s, d in self._recv_off:
                    self._put(self._ids[self._half, d, s], self._rows[d, s],
                              s, d, counts)
        if not self.one_device:
            self._copies(counts)
        self._recv = None
        G, cap = self.G, self.cap
        for t in range(len(bufs)):
            row_scatter_add(bufs[t], self.recv_rows[t].view(G * cap, -1),
                            self.slot_src[bufs[t].device],
                            self.recv_ids[t].view(-1))
        self._written = self.recv_ids
        if self.one_device:
            # the next send writes the other half of the id slots
            self._half = 1 - self._half
            self.send_ids, self.recv_ids = self._id_halves[self._half]

    def _sent(self, rows: int, compacted: bool) -> None:
        """Record one superstep's rows sent across processes."""
        if self.sent is not None:
            self.sent.append((int(rows), self._B, compacted))

    def _clear(self, bufs: list) -> None:
        """Zero what was written since each buffer was last zero: its own
        block and the previous receive's rows (one clear; ``cleared``
        counts them), or all of it."""
        if self._written is None:
            for buf in bufs:
                buf.zero_()
            return
        exchange_clear(bufs, self.n_loc, [w.view(-1) for w in self._written],
                       own=self.local)
        self.cleared += 1

    def _transfer(self, counts: np.ndarray) -> None:
        """The rows of a compacted superstep that cross the process
        boundary, in one ``all_to_all``: to each other process q, per local
        sender s (ascending) and destination d that q's shards read
        (``_regions(q)``, ascending), the ``counts[s, d]`` rows of s's
        block for d, each row an int32 [B + 1] line (the f32 row's bits,
        then its global id).  The received lines stay in ``_recv``, and
        ``_recv_off`` maps each remote (sender, destination) block to its
        first line."""
        comm, L, B = self.comm, len(self.local), self._B
        P, me = comm.size, comm.rank
        n = counts.astype(np.int64)
        sends = [[] if q == me else [(h, s, d) for h, s in enumerate(
            self.local) for d in self._regions(q)] for q in range(P)]
        send_n = [sum(int(n[s, d]) for _, s, d in blk) for blk in sends]
        packed = torch.empty((sum(send_n), B + 1), dtype=torch.int32,
                             device=self.devices[0])
        rows = packed.view(torch.float32)
        off = 0
        for blk in sends:
            for h, s, d in blk:
                k = int(n[s, d])
                if k:
                    rows[off:off + k, :B].copy_(self.send_rows[h][d, :k])
                    packed[off:off + k, B].copy_(self.send_ids[h][d, :k])
                off += k
        mine = self._regions(me)
        self._recv_off, recv_n, off = {}, [], 0
        for q in range(P):
            start = off
            if q != me:
                for s in range(q * L, (q + 1) * L):
                    for d in mine:
                        self._recv_off[(s, d)] = off
                        off += int(n[s, d])
            recv_n.append(off - start)
        self._recv = comm.all_to_all(packed, send_n, recv_n)
        self._sent(sum(send_n), True)

    def _put(self, dst_ids, dst_rows, s: int, d: int,
             counts: np.ndarray) -> None:
        """Sender s's block for destination d into one receive slot
        (``dst_ids`` [cap], ``dst_rows`` [cap, B]): a local sender's from
        its send slots (every id slot), a remote one's from the lines
        ``_transfer`` received (its ``counts[s, d]`` rows and ids, the
        other id slots pad)."""
        n = min(int(counts[s, d]), self.cap)
        h = s - self.shard0
        if 0 <= h < len(self.local):
            dst_ids.copy_(self.send_ids[h][d])
            if n:
                dst_rows[:n].copy_(self.send_rows[h][d, :n])
            return
        off = self._recv_off[(s, d)]
        dst_ids[n:].fill_(self.n_pad)
        if n:
            dst_ids[:n].copy_(self._recv[off:off + n, -1])
            dst_rows[:n].copy_(
                self._recv.view(torch.float32)[off:off + n, :-1])

    def _copies(self, counts: np.ndarray) -> None:
        """The collectives of a compacted superstep, with the local shards
        on several devices, as copies into each receiver's slots: the rows
        sent (``counts`` of them) and every id slot, a remote sender's
        from the transfer."""
        G, C, H = self.G, self.C, self.H
        if self.mode != "hier":
            for i, t in enumerate(self.local):
                for s in range(G):
                    self._put(self.recv_ids[i][s], self.recv_rows[i][s], s,
                              self._region(t), counts)
            return
        # stage A: to the same chip position of the receiving host
        for i, t in enumerate(self.local):
            h, c = divmod(t, C)
            for hs in range(H):
                self._put(self.stage_ids[i][hs], self.stage_rows[i][hs],
                          hs * C + c, h, counts)
        # stage B: shared among the host's chips, all local (whole slots:
        # the pads of stage A travel as ids, their rows are never read)
        for i, t in enumerate(self.local):
            h = t // C
            for c2 in range(C):
                src = h * C + c2 - self.shard0
                self.recv_ids[i][c2 * H:(c2 + 1) * H].copy_(
                    self.stage_ids[src])
                self.recv_rows[i][c2 * H:(c2 + 1) * H].copy_(
                    self.stage_rows[src])
