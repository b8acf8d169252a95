"""Ring collectives over the graph shards: the frontier all-gather (P1)
and the endpoint-mass reduce-scatter (P2).

Port of ``fora_tpu/ops/ring.py`` (32-156).  JAX calls each collective
inside ``shard_map``, one shard's view at a time, and loops over the G - 1
hops inside one Pallas kernel.  The port holds every shard's tensor in
one process, so each function takes the list of per-shard tensors (shard
h on ``bufs[h].device``; several shards may share a card) and runs the
hop loop itself: one launch per hop per shard, in pull form, each on the
receiving shard's card (``kernels/csrc/ring.cu``).

The reduce-scatter of shards that share one card needs no hops: every
partial lies in one memory, so :func:`reduce_scatter_onepass` sums each
output block over the G partials in one launch, in the ring's order of
adds, and moves (G + 1) G blocks where the hops move 3 (G - 1) G.
:func:`ring_reduce_scatter` takes it whenever all shards share a device,
and the hop loop (:func:`ring_reduce_scatter_hops`) otherwise.

Ordering.  With every shard on one card all launches go to that card's
current stream, and stream order is the whole protocol: hop s of every
shard completes before hop s + 1 of any.  With shards on several cards,
hop s of shard h waits on CUDA events recorded after hop s - 1 on shards
h - 1 (the data it reads) and h + 1 (the reduce-scatter's double buffer:
hop s overwrites the slot that h + 1 read at hop s - 1); on return each
shard's stream also waits for its right neighbour's last hop, the last
read of its buffer.  Peer access is enabled once per pair and refused
pairs raise.

Across processes (``parallel/multihost.py``) each process holds L of the
G shards: :func:`all_gather_processes` runs the ring among its L, then
one all-gather across the processes; :func:`reduce_scatter_processes`
sums the local partials in one pass (:func:`partial_sum`, the one-pass
kernel over the whole partials), then one reduce-scatter across them.

CPU tensors take the plain versions below, the same hop loop in torch
(``copy_``, ``torch.add(..., out=)``) and the same one-pass sum.  Every
hop is one f32 copy or one f32 add in the same order, so kernel and plain
version agree bit for bit, and the one pass adds in the hops' order, so
it equals them too.
"""

from __future__ import annotations

import torch

from .. import kernels


def _block(t: torch.Tensor, b: int, n_loc: int) -> torch.Tensor:
    return t[b * n_loc:(b + 1) * n_loc]


def _n_loc(ts, G: int) -> int:
    total = ts[0].shape[0]
    if total % G or any(t.shape != ts[0].shape for t in ts):
        raise ValueError(f"ring: {G} shards need equal [G * n_loc, B] "
                         f"tensors, got {[tuple(t.shape) for t in ts]}")
    return total // G


def _on_cuda(ts) -> bool:
    kinds = {t.device.type for t in ts}
    if len(kinds) != 1:
        raise ValueError(f"ring: shards on mixed device types {kinds}")
    return kinds == {"cuda"}


def _run_hops(devices, hops: int, launch) -> None:
    """``launch(s, h)`` for hop s = 0..hops-1 and shard h, ordered as the
    module docstring says."""
    G = len(devices)
    if all(d == devices[0] for d in devices):
        for s in range(hops):
            for h in range(G):
                launch(s, h)
        return
    streams = [torch.cuda.current_stream(d) for d in devices]

    def record():
        evs = []
        for st in streams:
            ev = torch.cuda.Event()
            ev.record(st)
            evs.append(ev)
        return evs

    done = record()   # what each shard's stream had queued on entry
    for s in range(hops):
        for h in range(G):
            streams[h].wait_event(done[h - 1])
            streams[h].wait_event(done[(h + 1) % G])
            launch(s, h)
        done = record()
    for h in range(G):
        streams[h].wait_event(done[(h + 1) % G])


def ring_all_gather_plain(bufs: list) -> list:
    """Plain version of :func:`ring_all_gather`."""
    G = len(bufs)
    n_loc = _n_loc(bufs, G)
    for s in range(G - 1):
        for h in range(G):
            b = (h - 1 - s) % G
            _block(bufs[h], b, n_loc).copy_(_block(bufs[h - 1], b, n_loc))
    return bufs


def ring_all_gather(bufs: list) -> list:
    """P1, in place: ``bufs[h]`` ([G * n_loc, B] f32) holds shard h's own
    block at rows [h * n_loc, (h + 1) * n_loc); afterwards every buffer
    holds every shard's block.  Over G - 1 hops shard h copies from its
    left neighbour the block that neighbour received on the hop before
    (its own block on hop 0), into the same slot.  G = 1 returns the
    input.  Returns ``bufs``."""
    G = len(bufs)
    n_loc = _n_loc(bufs, G)
    if not _on_cuda(bufs):
        return ring_all_gather_plain(bufs)

    def hop(s, h):
        b = (h - 1 - s) % G
        kernels.ring_all_gather_hop(_block(bufs[h], b, n_loc),
                                    _block(bufs[h - 1], b, n_loc))

    _run_hops([t.device for t in bufs], G - 1, hop)
    return bufs


def _comm_buffers(xs, n_loc: int):
    B = xs[0].shape[1]
    return [torch.empty((2, n_loc, B), dtype=x.dtype, device=x.device)
            for x in xs]


def ring_reduce_scatter_plain(xs: list) -> list:
    """Plain version of :func:`ring_reduce_scatter`."""
    G = len(xs)
    n_loc = _n_loc(xs, G)
    if G == 1:
        return list(xs)
    comm = _comm_buffers(xs, n_loc)
    for s in range(G - 1):
        for h in range(G):
            b = (h - s - 2) % G
            recv = (_block(xs[h - 1], b, n_loc) if s == 0
                    else comm[h - 1][s % 2])
            torch.add(recv.to(xs[h].device), _block(xs[h], b, n_loc),
                      out=comm[h][(s + 1) % 2])
    return [c[(G - 1) % 2] for c in comm]


def ring_reduce_scatter_hops(xs: list) -> list:
    """P2 as the ring: ``xs[h]`` is shard h's full-length [G * n_loc, B]
    f32 partial; returns, per shard h, the [n_loc, B] sum over shards of
    block h.  Partial sums pass right through a double-buffered [2, n_loc,
    B] slot per shard, and each receiver adds its own block: at hop s,
    ``comm_h[(s+1)%2] = comm_{h-1}[s%2] + x_h[block (h-s-2) mod G]``, the
    received partial first as in ``fora_tpu/ops/ring.py:69-70``; hop 0
    reads the left neighbour's block of ``x`` directly.  G = 1 returns
    the input."""
    G = len(xs)
    n_loc = _n_loc(xs, G)
    if not _on_cuda(xs):
        return ring_reduce_scatter_plain(xs)
    if G == 1:
        return list(xs)
    comm = _comm_buffers(xs, n_loc)

    def hop(s, h):
        b = (h - s - 2) % G
        recv = (_block(xs[h - 1], b, n_loc) if s == 0
                else comm[h - 1][s % 2])
        kernels.ring_reduce_scatter_hop(comm[h][(s + 1) % 2], recv,
                                        _block(xs[h], b, n_loc))

    _run_hops([x.device for x in xs], G - 1, hop)
    return [c[(G - 1) % 2] for c in comm]


def partial_sum_plain(xs: list) -> torch.Tensor:
    """Plain version of :func:`partial_sum`."""
    G = len(xs)
    n_loc = _n_loc(xs, G)
    if G == 1:
        return xs[0]
    out = torch.empty_like(xs[0])
    for h in range(G):
        o = _block(out, h, n_loc)
        torch.add(_block(xs[(h + 1) % G], h, n_loc),
                  _block(xs[(h + 2) % G], h, n_loc), out=o)
        for j in range(3, G + 1):
            o.add_(_block(xs[(h + j) % G], h, n_loc))
    return out


def partial_sum(xs: list) -> torch.Tensor:
    """The sum of the G partials ``xs`` (one shape [R, B], R dividing by
    G, one device) in one pass: row block h (R / G rows) is ``((x_{h+1}[h]
    + x_{h+2}[h]) + ...) + x_{h+G}[h]`` (shards mod G), the order in which
    the ring's hops add.  A CPU tensor takes the plain version; a CUDA
    tensor launches the one-pass kernel once.  G = 1 returns the
    input."""
    G = len(xs)
    _n_loc(xs, G)
    if any(x.device != xs[0].device for x in xs):
        raise ValueError("partial_sum: every partial must share one device")
    if not _on_cuda(xs) or G == 1:
        return partial_sum_plain(xs)
    out = torch.empty_like(xs[0])
    kernels.reduce_scatter_onepass(out, xs)
    return out


def reduce_scatter_onepass_plain(xs: list) -> list:
    """Plain version of :func:`reduce_scatter_onepass`."""
    G = len(xs)
    n_loc = _n_loc(xs, G)
    if G == 1:
        return list(xs)
    out = partial_sum_plain(xs)
    return [_block(out, h, n_loc) for h in range(G)]


def reduce_scatter_onepass(xs: list) -> list:
    """P2 with every shard on one device, in one pass: the same result as
    :func:`ring_reduce_scatter_hops`, shard h's block ``((x_{h+1}[h] +
    x_{h+2}[h]) + ...) + x_{h+G}[h]`` (shards mod G; the order in which
    the hops add), as G row blocks (views) of one [G * n_loc, B] tensor
    (:func:`partial_sum`).  G = 1 returns the input."""
    G = len(xs)
    n_loc = _n_loc(xs, G)
    out = partial_sum(xs)
    return list(xs) if G == 1 else [_block(out, h, n_loc) for h in range(G)]


def ring_reduce_scatter(xs: list) -> list:
    """P2: ``xs[h]`` is shard h's full-length [G * n_loc, B] f32 partial;
    returns, per shard h, the [n_loc, B] sum over shards of block h, on
    shard h's device.  Shards that share one device take the one pass
    (:func:`reduce_scatter_onepass`), shards on several the ring
    (:func:`ring_reduce_scatter_hops`); both give the same bits.  G = 1
    returns the input."""
    if all(x.device == xs[0].device for x in xs):
        return reduce_scatter_onepass(xs)
    return ring_reduce_scatter_hops(xs)


def all_gather_processes(bufs: list, comm, shard0: int, n_loc: int
                         ) -> list:
    """P1 across processes, in place: ``bufs`` are this process's L
    shards' [G * n_loc, B] buffers (global shards shard0 .. shard0 + L -
    1), each holding its own block.  The ring (:func:`ring_all_gather`)
    runs among the L over the process's rows, then one ``all_gather`` of
    those rows (``comm``, a ``parallel.multihost.ProcessComm``) fills
    buffer 0, and the other processes' rows are copied into the other L -
    1 buffers: every buffer ends holding all G blocks, as the ring leaves
    them in one process.  Returns ``bufs``."""
    L = len(bufs)
    lo, hi = shard0 * n_loc, (shard0 + L) * n_loc
    ring_all_gather([b[lo:hi] for b in bufs])
    comm.all_gather(bufs[0][lo:hi], out=bufs[0])
    for b in bufs[1:]:
        b[:lo].copy_(bufs[0][:lo])
        b[hi:].copy_(bufs[0][hi:])
    return bufs


def reduce_scatter_processes(xs: list, comm, L: int) -> list:
    """P2 across processes: ``xs`` are this process's [G * n_loc, B]
    partials (one per local shard, or one for the process); their one-pass
    sum (:func:`partial_sum`), then one ``reduce_scatter`` across the
    processes (``comm``) gives the process's rows of the total, split into
    its L shards' [n_loc, B] blocks (views)."""
    mine = comm.reduce_scatter(partial_sum(xs))
    n_loc = mine.shape[0] // L
    return [_block(mine, h, n_loc) for h in range(L)]
