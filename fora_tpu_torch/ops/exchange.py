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
from .gather import row_scatter_add

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


class FrontierExchange:
    """The exchange of one set of shards, with its buffers: the per-shard
    [n_pad, B] exchange buffers and the slot arrays, allocated for one
    batch width and reused across supersteps and levels.

    ``mode`` None is ``dense``; ``cap`` None is ``exchange_cap(n_loc)``.
    ``needed`` holds per shard the [D, n_loc] uint8 routing block (routed:
    D = G destinations; hier: D = H hosts) on the shard's device, or None
    (dense, compact); a caller may set it after construction, before the
    first ``send``.  ``compacted`` and ``fell_back`` count the supersteps
    that took each exchange.
    """

    def __init__(self, mode: Optional[str], devices: Sequence[torch.device],
                 n_loc: int, cap: Optional[int] = None,
                 needed: Optional[list] = None,
                 chips_per_host: Optional[int] = None):
        mode = mode or "dense"
        if mode not in MODES:
            raise ValueError(f"exchange must be one of {MODES}")
        if mode == "ragged":
            raise NotImplementedError(
                "exchange 'ragged' is not ported: the reference never ran "
                "it (ROADMAP C5); 'routed' routes the same rows")
        G = len(devices)
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
        self.H = G // self.C
        # destinations of a sender's compaction
        self.D = {"dense": 0, "compact": 1, "routed": G, "hier": self.H}[mode]
        self.one_device = all(d == devices[0] for d in devices)
        self.compacted = 0
        self.fell_back = 0
        self._B = None

    @property
    def n_pad(self) -> int:
        return self.G * self.n_loc

    def _region(self, t: int) -> int:
        """The destination index of shard t's receive."""
        return {"compact": 0, "routed": t, "hier": t // self.C}[self.mode]

    def buffers(self, B: int) -> list:
        """Per shard, the [n_pad, B] f32 exchange buffer (contents
        undefined), reused while the width stays B."""
        if self._B != B:
            # the old width's buffers go before the new ones are made
            self.bufs = self.send_ids = self.send_rows = None
            self.recv_ids = self.recv_rows = self.slot_src = None
            self.stage_ids = self.stage_rows = None
            self.bufs = [torch.empty((self.n_pad, B), dtype=torch.float32,
                                     device=d) for d in self.devices]
            if self.D:
                self._slots(B)
            self._B = B
        return self.bufs

    def _slots(self, B: int) -> None:
        G, D, cap, dev0 = self.G, self.D, self.cap, self.devices[0]
        if self.one_device:
            # sender s writes its block for destination d at [d, s]; the
            # receiver of destination d reads [d] as one list of G * cap
            ids = torch.empty((D, G, cap), dtype=torch.int32, device=dev0)
            rows = torch.empty((D, G, cap, B), dtype=torch.float32,
                               device=dev0)
            self.send_ids = [ids[:, s] for s in range(G)]
            self.send_rows = [rows[:, s] for s in range(G)]
            self.recv_ids = [ids[self._region(t)].reshape(-1)
                             for t in range(G)]
            self.recv_rows = [rows[self._region(t)].reshape(G * cap, B)
                              for t in range(G)]
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
        """The send side of every shard: the compaction of its own block of
        its buffer, ``counts[h]`` ([D] int32) the rows due to each
        destination."""
        n_loc = self.n_loc
        for h in range(self.G):
            frontier_compact(
                bufs[h][h * n_loc:(h + 1) * n_loc],
                None if self.needed is None else self.needed[h], self.cap,
                h * n_loc, self.n_pad, self.send_ids[h], self.send_rows[h],
                counts[h])

    def fits(self, counts: np.ndarray) -> bool:
        """Whether every shard's count for every destination is within the
        capacity (the host's ``pmax`` of JAX's ``lax.cond``)."""
        return int(counts.max(initial=0)) <= self.cap

    def exchange(self, bufs: list, counts: Optional[np.ndarray] = None
                 ) -> None:
        """Fill every shard's buffer: compacted when ``counts`` ([G, D],
        read from the send side) fit the capacity, else the ring."""
        if self.mode == "dense" or counts is None or not self.fits(counts):
            if self.mode != "dense":
                self.fell_back += 1
            ring.ring_all_gather(bufs)
            return
        self.compacted += 1
        if not self.one_device:
            self._copies(counts)
        G, cap = self.G, self.cap
        for t in range(G):
            bufs[t].zero_()
            row_scatter_add(bufs[t], self.recv_rows[t].view(G * cap, -1),
                            self.slot_src[bufs[t].device],
                            self.recv_ids[t].view(-1))

    def _copies(self, counts: np.ndarray) -> None:
        """The collectives of a compacted superstep as copies between
        devices: the rows sent (``counts`` of them) and every id slot."""
        G, C, H = self.G, self.C, self.H

        def put(dst_ids, dst_rows, s, d):
            n = min(int(counts[s, d]), self.cap)
            dst_ids.copy_(self.send_ids[s][d])
            if n:
                dst_rows[:n].copy_(self.send_rows[s][d, :n])

        if self.mode != "hier":
            for t in range(G):
                for s in range(G):
                    put(self.recv_ids[t][s], self.recv_rows[t][s], s,
                        self._region(t))
            return
        # stage A: to the same chip position of the receiving host
        for t in range(G):
            h, c = divmod(t, C)
            for hs in range(H):
                put(self.stage_ids[t][hs], self.stage_rows[t][hs],
                    hs * C + c, h)
        # stage B: shared among the host's chips (whole slots: the pads of
        # stage A travel as ids, their rows are never read)
        for t in range(G):
            h = t // C
            for c2 in range(C):
                src = h * C + c2
                self.recv_ids[t][c2 * H:(c2 + 1) * H].copy_(
                    self.stage_ids[src])
                self.recv_rows[t][c2 * H:(c2 + 1) * H].copy_(
                    self.stage_rows[src])
