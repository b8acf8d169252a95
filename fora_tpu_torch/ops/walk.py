"""Alpha-terminating random walks: the index build's hot loop and the walk
phase of raw-walk FORA and Monte Carlo.

Port of ``fora_tpu/ops/walk.py``: ``allocate_walks`` (35-86),
``geometric_lengths`` (89-99), the lockstep ``run_walks`` (102-135),
``accumulate_endpoints`` (323-328) and ``walk_lane_budget`` (331-345).
``walk_endpoints`` takes the place of ``run_walks_scheduled`` +
``hop_widths`` (138-222) and dispatches a CUDA tensor to K4
(``kernels/csrc/walk.cu``), where each warp runs a queue of walks that it
owns, one live walk per lane, so the TPU's length sort, static prefix
widths and overflow fallback are gone.  On a weighted graph both walks
take the graph's own alias tables, as JAX's do: the hop draws a second
uniform and picks between the slot's edge and its alias.
``run_walks_philox`` is K4 in plain PyTorch: the same Philox-4x32-10
words, so the same endpoints bit for bit (on a card; the tests and
``chip_smoke.py`` hold the kernel to it).

Lane allocation is two steps here: the demand (``walk_demand``: omega_v,
its int32 cumsum and the per-column total; ``walk_demands`` the shards'
demands, one launch a card) and the expansion of a range of
lanes onto nodes (``expand_lanes``; ``expand_chunk_lanes`` expands a
chunk of the sharded raw walk over every shard's demand).  On a card they,
``accumulate_endpoints`` and ``accumulate_chunk_endpoints`` launch K6
(``kernels/csrc/walk_alloc.cu``); the ``*_plain`` functions are the CPU
path and the reference the kernels are held to.  On a card the walk
phases run each chunk as one launch of K6+K4 (``raw_walk_chunk``,
``raw_walk_sharded_chunk``: ``kernels/csrc/walk.cu``'s raw_walk_kernel),
which finds each lane's start node and weight, walks it, and adds the
weight at its endpoint, with no [W, B] array between them; its endpoints
are those of the chain expansion -> K4 -> accumulate bit for bit
(``raw_walk_chunk_plain`` is that chain in plain PyTorch, with Philox
walks).  Monte Carlo's and HubPPR's walks from their sources run alike
(``source_walk_chunk``: on a card one launch of K6+K4-src, walk.cu's
source_walk_kernel): walk t * B + b starts at sources[b], ends where K4
(K4-hub for HubPPR) ends walk t * B + b of ``sources.repeat(rows)``, and
adds a constant weight there, with no [W, B] array; on the CPU it runs
that chain, and ``source_walk_chunk_plain`` is the chain with Philox
walks.  ``walk_phase`` sizes the lanes by the measured demand, one host
read per call, and splits the columns (and, for a column too large
alone, its lanes) into chunks of ``chunk_lanes`` lanes, so a query never
loses walks: JAX's static lane count drops the walks past it and only
raises ``overflow``.

Every walk path (the walk phases, Monte Carlo, HubPPR's queries and pool,
BiPPR's walk term) plans its chunks from constants, ``CHUNK_LANES`` on a
card and ``CPU_LANE_BUDGET`` on the CPU, and chunk i draws from
``derive_seed(seed, i)``: the walks a seed draws never depend on how much
memory the device has free.  A chunk that does not fit the card fails
with the allocator's out-of-memory error; nothing plans smaller chunks
and draws other walks.

The sharded raw one-shot and the sharded index build walk an out-CSR
split into G row slices (``ShardedOutCSR``, the arrays of
``index/build_sharded.py::_shard_csr``), in place of JAX's
``sharded_lockstep_walk`` (225-266) and ``sharded_lockstep_walk_scheduled``
(269-320), whose one psum per hop combines the shards' samples: every walk
function here also takes the slices and reads each row through its owner
(shard ``v // n_loc``), which on a card is K4's sharded form, so the
endpoints are those of the unsharded graph bit for bit.
``sharded_walk_phase`` is the raw one-shot's walk phase over the shards'
residues.  ``sharded_walk_phase_xp`` is the same with the shards spread
over processes (``parallel/multihost.py``): each process walks its own
shards' lanes over its own slices, and a walk whose node lies in another
process's rows is handed to that process as a 16-byte record (its Philox
key, node, hops taken with its length, and weight), so every walk ends
where it ends in one process (``raw_walk_xp_chunk``: on a card K6+K4-xp,
walk.cu's xp_own_kernel for a process's own lanes and xp_inbox_kernel for
the records handed to it; ``raw_walk_xp_plain`` their plain version).
The index build across processes (``index/build_sharded.py``) hands its
walks on alike, records of no weight, over a window of whole chunks at
once (``index_walk_xp_chunk``: on a card K4-xp, walk.cu's
index_xp_own_kernel for a process's own starts of the window and
index_xp_inbox_kernel for the records; ``index_walk_xp_plain`` their
plain version), so every walk ends where K4's sharded form ends it.

Dangling convention: a walk at an out-degree-0 node is absorbed there.
Random numbers come from a ``torch.Generator`` (``run_walks``, the CPU
path) or the kernel's Philox stream (K4, ``run_walks_philox``); neither
replays JAX's threefry bits, so endpoints agree with JAX in distribution
only.  Streams are keyed by 64-bit seeds from ``derive_seed``, one per
(call, level, block, chunk).
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import kernels
from ..graph.csr import DeviceGraph

LANE_MULTIPLE = 1024
# lanes of one chunk on a card, on every walk path: K6+K4 and K6+K4-src
# hold no array a lane, the hub pool's build and BiPPR's walk term a start
# and an endpoint (and the term's sort keys), a few GB at 2^27 lanes
CHUNK_LANES = 1 << 27
# on the CPU, whose chain holds up to 40 bytes a lane in host memory
CPU_LANE_BUDGET = 1 << 24


class ShardedOutCSR(NamedTuple):
    """The out-CSR as G row slices: shard s holds rows s * n_loc .. (s + 1)
    * n_loc - 1 as localized row pointers ``indptr[s]`` [n_loc + 1] i32
    and their edges ``indices[s]`` (global node ids), with its slices of
    the alias tables on a weighted graph; each shard's tensors on its
    device (``index.build_sharded.place_out_csr``)."""

    indptr: tuple
    indices: tuple
    alias_prob: Optional[tuple]
    alias_other: Optional[tuple]
    n_loc: int

    def shards(self, a: int, b: int) -> "ShardedOutCSR":
        """Shards a .. b - 1's slices."""
        return ShardedOutCSR(
            self.indptr[a:b], self.indices[a:b],
            None if self.alias_prob is None else self.alias_prob[a:b],
            None if self.alias_other is None else self.alias_other[a:b],
            self.n_loc)


class _Rows:
    """The plain walks' row lookup over a DeviceGraph's out-CSR or a
    ShardedOutCSR's slices, on ``device``: ``rows(v)`` gives each row's
    first edge and degree, the edge numbered in one list (the slices' edge
    lists end to end, shard s's from the lengths of those before it), and
    ``indices``, ``alias_prob``, ``alias_other`` (or None) that list's
    tables.  A sliced row is read through its owner, shard v // n_loc."""

    def __init__(self, csr, device):
        if isinstance(csr, ShardedOutCSR):
            self.n_loc = csr.n_loc
            self.ptr = torch.stack([p.to(device) for p in csr.indptr]).long()
            sizes = [x.numel() for x in csr.indices]
            self.off = torch.tensor([0] + sizes[:-1],
                                    device=device).cumsum(0)
            self.indices = torch.cat([x.to(device) for x in csr.indices])
            self.alias_prob = self.alias_other = None
            if csr.alias_prob is not None:
                self.alias_prob = torch.cat([x.to(device)
                                             for x in csr.alias_prob])
                self.alias_other = torch.cat([x.to(device)
                                              for x in csr.alias_other])
        else:
            self.n_loc = None
            self.ptr = csr.out_indptr.long()
            self.indices = csr.out_indices
            self.alias_prob, self.alias_other = csr.alias_prob, csr.alias_other

    def __call__(self, v: torch.Tensor):
        if self.n_loc is None:
            p0 = self.ptr[v]
            return p0, self.ptr[v + 1] - p0
        s = torch.div(v, self.n_loc, rounding_mode="floor")
        row = v - s * self.n_loc
        p0 = self.ptr[s, row]
        return p0 + self.off[s], self.ptr[s, row + 1] - p0


def derive_seed(seed: int, *path: int) -> int:
    """A 64-bit seed for the stream at ``path`` under ``seed`` (numpy's
    SeedSequence hash): distinct paths give unrelated seeds, so no two
    levels, blocks or chunks share a random stream.  The path's length
    enters too (SeedSequence ignores trailing zero words)."""
    words = np.random.SeedSequence([int(seed), *map(int, path),
                                    len(path) + 1]
                                   ).generate_state(2, np.uint32)
    return int(words[0]) | (int(words[1]) << 32)


class WalkAllocation(NamedTuple):
    """Lane -> (start node, weight) for the walk phase: node v gets
    omega_v = ceil(r_v * omega_unit) walks, each weighing r_v / omega_v."""

    start: torch.Tensor     # [W, B] i32 start node per lane
    walk_idx: torch.Tensor  # [W, B] i32 walk number within its start node
    weight: torch.Tensor    # [W, B] f32 (0 on invalid lanes)
    valid: torch.Tensor     # [W, B] bool lane < total walks of the column
    total: torch.Tensor     # [B] i32 walks demanded
    overflow: torch.Tensor  # [B] bool demanded more than W lanes


class WalkDemand(NamedTuple):
    omega_v: Optional[torch.Tensor]   # [n, B] i32 walks per node (None: K6)
    cum: torch.Tensor       # [n, B] i32 inclusive cumsum over nodes
    total: torch.Tensor     # [B] i32

    def columns(self, c0: int, c1: int) -> "WalkDemand":
        """The demand of columns c0 .. c1 - 1."""
        return WalkDemand(None if self.omega_v is None
                          else self.omega_v[:, c0:c1],
                          self.cum[:, c0:c1], self.total[c0:c1])


def walk_demand(r: torch.Tensor, omega_unit: float) -> WalkDemand:
    """omega_v = ceil(r * omega_unit) in f32 (0 where r <= 0), its int32
    cumsum over nodes and the per-column total, as JAX computes them.  A
    CUDA tensor launches K6-demand (``kernels.walk_demand``: cum and total
    bit for bit :func:`walk_demand_plain`'s, ``omega_v`` None); a CPU one
    runs the plain version."""
    if r.device.type == "cpu":
        return walk_demand_plain(r, omega_unit)
    cum, total = kernels.walk_demand(r, float(np.float32(omega_unit)))
    return WalkDemand(None, cum, total)


def walk_demands(rs: list, omega_unit: float) -> tuple:
    """:func:`walk_demand` of each of the G shards' residues ``rs`` (one
    shape): ``(demands, total)``, ``total`` [G, B] int32 the shards' totals
    on ``rs[0]``'s device.  On a card one launch per card (the shards of
    a card in one ``kernels.walk_demand`` call, their cum in one [G, B, n]
    buffer), on the CPU the plain version per shard."""
    if rs[0].device.type == "cpu":
        ds = [walk_demand_plain(r, omega_unit) for r in rs]
        return ds, torch.stack([d.total for d in ds])
    unit = float(np.float32(omega_unit))
    ds, totals = [None] * len(rs), [None] * len(rs)
    devs = list(dict.fromkeys(r.device for r in rs))
    for dev in devs:
        idx = [h for h, r in enumerate(rs) if r.device == dev]
        cum, total = kernels.walk_demand([rs[h] for h in idx], unit)
        for i, h in enumerate(idx):
            ds[h], totals[h] = WalkDemand(None, cum[i], total[i]), total[i]
    if len(devs) == 1:
        return ds, total
    return ds, torch.stack([t.to(rs[0].device) for t in totals])


def walk_demand_plain(r: torch.Tensor, omega_unit: float) -> WalkDemand:
    """:func:`walk_demand` in plain PyTorch, ``omega_v`` included.  The
    cumsum runs along the innermost dimension of a [B, n] copy (``cum`` is
    its transposed view): a scan along dim 0 of [n, B] runs one thread per
    column on a card (183 ms at n = 2^19, B = 16 on an H100 80GB HBM3 at
    700 W)."""
    w = torch.ceil(r * float(np.float32(omega_unit))).to(torch.int32)
    omega_v = torch.where(r > 0, w, 0)
    cum = torch.cumsum(omega_v.T.contiguous(), dim=1, dtype=torch.int32).T
    return WalkDemand(omega_v, cum, cum[-1])


def _lane_nodes(d: WalkDemand, lane_lo: int, num_lanes: int
                ) -> torch.Tensor:
    """[W, B] int64 node of lanes ``lane_lo .. lane_lo + W - 1``: node v
    owns lanes cum_v - omega_v .. cum_v - 1, so each column is its node
    ids repeated by their lane counts within the range (one
    ``repeat_interleave`` over all columns, with a padding entry per
    column); a lane past the column's total takes the node of its last
    walk (JAX's forward fill), and an empty column takes node 0."""
    n, B = d.omega_v.shape
    hi = lane_lo + num_lanes
    reps = (d.cum.clamp(max=hi) - (d.cum - d.omega_v).clamp(min=lane_lo)
            ).clamp_min_(0)                                        # [n, B]
    pad = num_lanes - (d.total.clamp(max=hi) - lane_lo).clamp(0, num_lanes)
    reps = torch.cat([reps.T, pad[:, None]], dim=1)                # [B, n+1]
    flat = torch.repeat_interleave(reps.view(-1),
                                   output_size=B * num_lanes)
    del reps
    row0 = torch.arange(0, B * (n + 1), n + 1, dtype=flat.dtype,
                        device=flat.device)
    v = flat.view(B, num_lanes) - row0[:, None]                    # [B, W]
    del flat
    ids = torch.arange(n, dtype=v.dtype, device=v.device)[:, None]
    last = torch.where(d.omega_v > 0, ids, 0).amax(dim=0)          # [B]
    node = torch.where(v == n, last[:, None], v)
    return node.T.contiguous().long()


def expand_lanes(r: torch.Tensor, d: WalkDemand, lane_lo: int,
                 num_lanes: int):
    """(start [W, B] i32, weight [W, B] f32) of lanes ``lane_lo .. lane_lo
    + num_lanes - 1``: the node each lane walks from, and r_v / omega_v in
    f32 on lanes below the column's total, else 0.  A CUDA tensor launches
    K6-expand (``kernels.expand_lanes``), array-equal to
    :func:`expand_lanes_plain`, which a CPU one runs."""
    if r.device.type == "cpu":
        return expand_lanes_plain(r, d, lane_lo, num_lanes)[:2]
    B = r.shape[1]
    start = torch.empty((num_lanes, B), dtype=torch.int32, device=r.device)
    weight = torch.empty((num_lanes, B), dtype=torch.float32,
                         device=r.device)
    kernels.expand_lanes(r, d.cum, d.total, start, weight, lane_lo=lane_lo)
    return start, weight


def expand_lanes_plain(r: torch.Tensor, d: WalkDemand, lane_lo: int,
                       num_lanes: int):
    """:func:`expand_lanes` in plain PyTorch (``d`` with ``omega_v``):
    (start, weight, lanes [W] i32, node [W, B] i64)."""
    lanes = torch.arange(lane_lo, lane_lo + num_lanes, dtype=torch.int32,
                         device=r.device)
    node = _lane_nodes(d, lane_lo, num_lanes)
    r_v = r.gather(0, node)
    w_v = d.omega_v.gather(0, node).clamp_min(1).to(torch.float32)
    valid = lanes[:, None] < d.total[None, :]
    weight = torch.where(valid, r_v / w_v, 0.0)
    return node.to(torch.int32), weight, lanes, node


def expand_chunk_lanes(rs: list, ds: list, bounds: torch.Tensor,
                       lane_lo: int, num_lanes: int, n_loc: int):
    """(start [W, B] i32, weight [W, B] f32) of lanes ``lane_lo .. lane_lo
    + W - 1`` of a chunk of the sharded raw walk, on ``bounds``' device:
    ``rs`` and ``ds`` are the G shards' residues [n_loc, B] and demands,
    ``bounds`` [G + 1, B] int64 the running sums of their totals, so lane
    l of column b is shard h's lane l - bounds[h, b] where bounds[h, b] <=
    l < bounds[h + 1, b] and starts at its node + h * ``n_loc`` with
    :func:`expand_lanes`' weight; a lane past bounds[G, b] gets node 0,
    weight 0.  A CUDA ``bounds`` launches K6-expand's sharded form (one
    launch for every shard), a CPU one runs
    :func:`expand_chunk_lanes_plain`."""
    if bounds.device.type == "cpu":
        return expand_chunk_lanes_plain(rs, ds, bounds, lane_lo, num_lanes,
                                        n_loc)
    B = rs[0].shape[1]
    start = torch.empty((num_lanes, B), dtype=torch.int32,
                        device=bounds.device)
    weight = torch.empty((num_lanes, B), dtype=torch.float32,
                         device=bounds.device)
    kernels.expand_lanes(rs, [d.cum for d in ds], None, start, weight,
                         lane_lo=lane_lo, bounds=bounds, n_loc=n_loc)
    return start, weight


def expand_chunk_lanes_plain(rs: list, ds: list, bounds: torch.Tensor,
                             lane_lo: int, num_lanes: int, n_loc: int):
    """:func:`expand_chunk_lanes` in plain PyTorch: each shard's lanes
    found by ``torch.searchsorted`` over its columns of ``cum``."""
    dev = bounds.device
    B = rs[0].shape[1]
    start = torch.zeros((num_lanes, B), dtype=torch.int32, device=dev)
    weight = torch.zeros((num_lanes, B), dtype=torch.float32, device=dev)
    lane = lane_lo + torch.arange(num_lanes, device=dev)[:, None]
    for h, (r, d) in enumerate(zip(rs, ds)):
        lo, hi = bounds[h].to(r.device), bounds[h + 1].to(r.device)
        x = lane.to(r.device) - lo[None, :]
        own = (x >= 0) & (x < (hi - lo)[None, :])
        if not bool(own.any()):
            continue
        cum_t = d.cum.T.contiguous().long()                        # [B, n]
        x = torch.where(own, x, 0).T.contiguous()
        node = torch.searchsorted(cum_t, x, right=True).T
        node = node.clamp_max(cum_t.shape[1] - 1)
        prev = torch.where(node > 0, d.cum.long().gather(
            0, (node - 1).clamp_min(0)), 0)
        omega = (d.cum.long().gather(0, node) - prev).clamp_min(1)
        w = r.gather(0, node) / omega.to(torch.float32)
        own = own.to(dev)
        start[own] = (node + h * n_loc).to(torch.int32).to(dev)[own]
        weight[own] = w.to(dev)[own]
    return start, weight


def allocate_walks(r: torch.Tensor, omega_unit: float, num_lanes: int
                   ) -> WalkAllocation:
    """JAX's allocation of ``num_lanes`` lanes per column (walks past
    ``num_lanes`` are dropped and ``overflow`` set); array-equal to
    ``fora_tpu.ops.walk.allocate_walks``.  The port's own paths size the
    lanes by the demand instead (``walk_phase``); this runs the plain
    versions, for tests and measurements."""
    d = walk_demand_plain(r, omega_unit)
    start, weight, lanes, node = expand_lanes_plain(r, d, 0, num_lanes)
    first_lane = (d.cum - d.omega_v).gather(0, node)
    valid = lanes[:, None] < torch.clamp_max(d.total, num_lanes)[None, :]
    return WalkAllocation(start=start, walk_idx=lanes[:, None] - first_lane,
                          weight=weight, valid=valid, total=d.total,
                          overflow=d.total > num_lanes)


def geometric_lengths(shape, alpha: float, max_hops: int, *,
                      generator: torch.Generator) -> torch.Tensor:
    """Hops before the alpha-coin stops a walk: floor(log u / log(1-alpha))
    ~ Geometric(alpha), capped at ``max_hops``; int32."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    u.clamp_min_(torch.finfo(torch.float32).tiny)
    len_f = torch.floor(torch.log(u) * (1.0 / math.log1p(-alpha)))
    return len_f.clamp_max(max_hops).to(torch.int32)


def run_walks(graph, start: torch.Tensor, *,
              generator: torch.Generator, alpha: float,
              max_hops: int = 64) -> torch.Tensor:
    """Lockstep walks from ``start`` (any shape) over ``graph``, a
    DeviceGraph or a ShardedOutCSR (the same draws, so the same endpoints
    as on the unsharded graph); endpoints, int32, same shape.  Hop h draws
    one uniform per walk and moves the walks still alive to a uniform
    out-neighbour; where the graph has alias tables (a weighted graph) it
    draws a second uniform ``u2`` and takes the slot's own edge if ``u2 <
    alias_prob[slot]``, else ``alias_other[slot]``."""
    length = geometric_lengths(start.shape, alpha, max_hops,
                               generator=generator)
    rows = _Rows(graph, start.device)
    indices = rows.indices.long()
    alias = rows.alias_prob is not None
    if alias:
        other = rows.alias_other.long()
    last_slot = max(indices.numel() - 1, 0)
    cur = start.long()
    for h in range(int(length.max()) if length.numel() else 0):
        u = torch.rand(start.shape, generator=generator,
                       device=generator.device)
        p0, d = rows(cur)
        alive = (length > h) & (d > 0)          # dangling absorbs
        j = torch.minimum((u * d.to(torch.float32)).long(),
                          (d - 1).clamp_min(0))
        # a dead walk's slot may point past the last edge: clamp (unused)
        slot = (p0 + j).clamp_max(last_slot)
        nxt = indices[slot]
        if alias:
            u2 = torch.rand(start.shape, generator=generator,
                            device=generator.device)
            nxt = torch.where(u2 < rows.alias_prob[slot], nxt, other[slot])
        cur = torch.where(alive, nxt, cur)
    return cur.to(torch.int32)


def walk_endpoints(graph, start: torch.Tensor, seed: int,
                   alpha: float, max_hops: int,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One walk per entry of ``start`` ([W] int32) over ``graph``, a
    DeviceGraph or a ShardedOutCSR; endpoints [W] int32, written into
    ``out`` where given.  CPU tensors run the plain ``run_walks``; CUDA
    tensors launch K4, its alias branch on a graph with alias tables, its
    sharded form over slices."""
    if start.device.type == "cpu":
        gen = torch.Generator(device="cpu").manual_seed(seed % 2**63)
        ends = run_walks(graph, start, generator=gen, alpha=alpha,
                         max_hops=max_hops)
        return ends if out is None else out.copy_(ends)
    if isinstance(graph, ShardedOutCSR):
        if graph.alias_prob is not None:
            return kernels.index_walk_sharded_alias(
                start, graph.indptr, graph.indices, graph.alias_prob,
                graph.alias_other, graph.n_loc, seed, alpha, max_hops,
                out=out)
        return kernels.index_walk_sharded(start, graph.indptr, graph.indices,
                                          graph.n_loc, seed, alpha, max_hops,
                                          out=out)
    if graph.alias_prob is not None:
        return kernels.index_walk_alias(
            start, graph.out_indptr, graph.out_indices, graph.alias_prob,
            graph.alias_other, seed, alpha, max_hops, out=out)
    return kernels.index_walk(start, graph.out_indptr, graph.out_indices,
                              seed, alpha, max_hops, out=out)


_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)     # multipliers
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)     # key increments


def _mulhilo32(a: int, b):
    """(hi, lo) 32-bit words of a * b for a 32-bit constant ``a`` and
    ``b`` (int64 tensor or int) in [0, 2^32): ``b`` is split into 16-bit
    halves, so no product passes 2^48 and nothing overflows int64."""
    p_lo = a * (b & 0xFFFF)
    p_hi = a * (b >> 16)
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & _M32


def philox4x32_10(ctr, key):
    """Philox-4x32-10 as ``kernels/csrc/philox.cuh`` computes it, in int64
    arithmetic: ``ctr`` four words and ``key`` two, each an int64 tensor of
    32-bit values or an int (they broadcast); returns the four words of
    the block."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo32(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo32(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _M32
        k1 = (k1 + _PHILOX_W[1]) & _M32
    return c0, c1, c2, c3


def _unit(word: torch.Tensor) -> torch.Tensor:
    """[0, 1) float32 from a word's top 24 bits, as walk.cu's unit()."""
    return (word >> 8).to(torch.float32) * 2.0**-24


def walk_lengths(seed: int, W: int, alpha: float, max_hops: int,
                 device) -> torch.Tensor:
    """[W] int64 lengths of K4's walks 0 .. W - 1 under ``seed``:
    min(floor(log(u0) * inv_log1m_alpha), max_hops) in float32, u0 in
    (0, 1] from the first word of each walk's Philox block 0."""
    return lengths_of(seed, torch.arange(W, dtype=torch.int64,
                                         device=device), alpha, max_hops)


def chunk_draws(seed: int, walk: torch.Tensor,
                chunk_lanes: Optional[int] = None) -> tuple:
    """(the seed's low word, its high word, the Philox key) of the walks
    numbered ``walk`` (int64): under ``seed`` itself, or with
    ``chunk_lanes`` as a build's walks draw them, walk w as walk w %
    chunk_lanes of chunk c = w // chunk_lanes at seed + c 2^32 (the high
    word and the key then per walk)."""
    seed = int(seed) % 2**64
    lo, hi = seed & _M32, seed >> 32
    if chunk_lanes is None:
        return lo, hi, walk
    c = torch.div(walk, chunk_lanes, rounding_mode="floor")
    return lo, (hi + c) & _M32, walk - c * chunk_lanes


def lengths_of(seed: int, walk: torch.Tensor, alpha: float,
               max_hops: int, chunk_lanes: Optional[int] = None
               ) -> torch.Tensor:
    """:func:`walk_lengths` of the walks numbered ``walk`` (int64 in 0 ..
    2^32 - 1, any shape), drawn as :func:`chunk_draws` gives them."""
    lo, hi, key = chunk_draws(seed, walk, chunk_lanes)
    u0 = ((philox4x32_10((0, hi, 0, 0), (lo, key))[0]
           >> 8) + 1).to(torch.float32) * 2.0**-24
    inv = torch.tensor(kernels.inv_log1m_alpha(alpha), dtype=torch.float32,
                       device=walk.device)
    return torch.floor(torch.log(u0) * inv).clamp_max(max_hops).long()


def run_walks_philox(graph, start: torch.Tensor, seed: int,
                     alpha: float, max_hops: int, hub=None) -> torch.Tensor:
    """K4 in plain PyTorch, over a DeviceGraph or a ShardedOutCSR (K4's
    sharded form): one walk per entry of ``start`` (any shape),
    endpoints int32 of its shape, from the kernel's Philox-4x32-10 words
    (walk w keyed by (seed low word, w), hop h's block counted (h + 1,
    seed high word); u0 of block 0 sets the length in float32 with the
    kernel's ``kernels.inv_log1m_alpha``).  Lockstep over hops, each on
    the walks still moving.  Alias hops where the graph has tables; with
    ``hub`` (an ``algo.hubppr.HubIndex``) a hop's landing on a hub ends the
    walk at the pool entry picked by the hop's third word.  On a card
    ``torch.log`` is the kernel's ``logf``, so the endpoints are the
    kernel's bit for bit; this runs for tests and measurements, never on a
    path."""
    flat = start.reshape(-1)
    seed = int(seed) % 2**64
    lo, hi = seed & _M32, seed >> 32
    length = walk_lengths(seed, flat.numel(), alpha, max_hops, start.device)
    rows = _Rows(graph, start.device)
    alias = rows.alias_prob is not None
    cur = flat.long().clone()
    live = torch.nonzero(length > 0).squeeze(1)
    h = 0
    while live.numel():
        p0, d = rows(cur[live])
        moving = d > 0                          # dangling absorbs
        live, p0, d = live[moving], p0[moving], d[moving]
        r = philox4x32_10((h + 1, hi, 0, 0), (lo, live))
        slot = p0 + torch.minimum((_unit(r[0]) * d.to(torch.float32)).long(),
                                  d - 1)
        nxt = rows.indices[slot]
        if alias:
            nxt = torch.where(_unit(r[1]) < rows.alias_prob[slot], nxt,
                              rows.alias_other[slot])
        nxt = nxt.long()
        h += 1
        keep = length[live] > h
        if hub is not None:
            hid = hub.hub_id[nxt].long()
            at = hid >= 0
            j = torch.clamp_max((_unit(r[2][at]) * float(hub.pool_size)
                                 ).long(), hub.pool_size - 1)
            nxt[at] = hub.pool[hid[at], j].long()
            keep &= ~at
        cur[live] = nxt
        live = live[keep]
    return cur.to(torch.int32).view(start.shape)


def accumulate_endpoints(endpoints: torch.Tensor, weight, n: int,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per column, add each lane's weight at its endpoint: [W, B] ->
    [n, B] f32 (a scatter-add along nodes).  ``weight`` is [W, B] f32 or
    one number that every lane weighs.  With ``out`` ([n, B], its columns
    adjacent) the weights are added into it.  A CUDA tensor launches
    K6-accum (``kernels.accumulate_endpoints``: f32 atomics, so the sums
    match :func:`accumulate_endpoints_plain`'s up to their order); a CPU
    one runs the plain version."""
    if out is None:
        out = torch.zeros((n, endpoints.shape[1]), dtype=torch.float32,
                          device=endpoints.device)
    if endpoints.device.type == "cpu":
        return accumulate_endpoints_plain(endpoints, weight, n, out)
    kernels.accumulate_endpoints(endpoints, weight, out)
    return out


def accumulate_endpoints_plain(endpoints: torch.Tensor, weight, n: int,
                               out: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """:func:`accumulate_endpoints` in plain PyTorch: ``scatter_add_``
    over int64 endpoints (a number weight becomes a [W, B] f32 array)."""
    if out is None:
        out = torch.zeros((n, endpoints.shape[1]), dtype=torch.float32,
                          device=endpoints.device)
    if not isinstance(weight, torch.Tensor):
        weight = torch.full(endpoints.shape, weight, dtype=torch.float32,
                            device=endpoints.device)
    return out.scatter_add_(0, endpoints.long(), weight)


def accumulate_chunk_endpoints(endpoints: torch.Tensor, weight: torch.Tensor,
                               outs: list, bounds: torch.Tensor,
                               lane_lo: int) -> None:
    """A chunk of the sharded raw walk: row t of ``endpoints`` /
    ``weight`` [W, B] is lane lane_lo + t, which ``bounds`` (as
    :func:`expand_chunk_lanes` takes it) gives to a shard h, and adds its
    weight at its endpoint into ``outs[h]`` ([n, B] each, columns
    adjacent); lanes past bounds[G, b] add nowhere.  A CUDA tensor
    launches K6-accum's sharded form (one launch for every shard), a CPU
    one runs :func:`accumulate_chunk_endpoints_plain`."""
    if endpoints.device.type == "cpu":
        accumulate_chunk_endpoints_plain(endpoints, weight, outs, bounds,
                                         lane_lo)
    else:
        kernels.accumulate_endpoints(endpoints, weight, outs, lane_lo=lane_lo,
                                     bounds=bounds)


def accumulate_chunk_endpoints_plain(endpoints: torch.Tensor,
                                     weight: torch.Tensor, outs: list,
                                     bounds: torch.Tensor,
                                     lane_lo: int) -> None:
    """:func:`accumulate_chunk_endpoints` in plain PyTorch: per shard one
    ``scatter_add_`` of the chunk's weights, 0 outside its lanes."""
    lane = lane_lo + torch.arange(endpoints.shape[0],
                                  device=bounds.device)[:, None]
    for h, out in enumerate(outs):
        own = (lane >= bounds[h][None, :]) & (lane < bounds[h + 1][None, :])
        w = torch.where(own.to(weight.device), weight, 0.0)
        out.scatter_add_(0, endpoints.long().to(out.device), w.to(out.device))


def raw_walk_chunk(graph: DeviceGraph, r: torch.Tensor, d: WalkDemand,
                   lane_lo: int, num_lanes: int, seed: int, alpha: float,
                   max_hops: int, out: torch.Tensor,
                   ends: Optional[torch.Tensor] = None, clock=None) -> None:
    """One chunk of the raw walk phase: lane lane_lo + t of each column b
    of ``r`` [n, Bc] (t < ``num_lanes``) starts where :func:`expand_lanes`
    puts it, walks under ``seed`` and adds its weight into ``out`` [n, Bc]
    at its endpoint.  ``ends`` (tests and checks only) [W, Bc] int32 gets
    the endpoints of the lanes below the column's total.  A CUDA tensor
    launches K6+K4 (``kernels.raw_walk``, its alias branch on a graph with
    alias tables), whose walk t * Bc + b draws from :func:`walk_endpoints`'
    Philox stream and whose lanes past the total are not walked: the
    endpoints of the chain expand_lanes -> walk_endpoints ->
    accumulate_endpoints bit for bit, the sums up to the order of the f32
    adds.  A CPU one runs that chain (the Generator's walks of
    walk_endpoints).  ``clock`` (a ``utils.timing.StageClock``) times the
    launch as ``walks``, the CPU's chain as ``alloc``, ``walks`` and
    ``accum``."""
    from ..utils.timing import StageClock
    clock = clock or StageClock(None)
    if r.device.type == "cpu":
        with clock.stage("alloc"):
            start, weight = expand_lanes(r, d, lane_lo, num_lanes)
        with clock.stage("walks"):
            got = walk_endpoints(graph, start.view(-1), seed, alpha,
                                 max_hops).view(start.shape)
            del start
        with clock.stage("accum"):
            accumulate_endpoints(got, weight, r.shape[0], out=out)
        if ends is not None:
            _keep_walked(ends, got, lane_lo, d.total)
        return
    with clock.stage("walks"):
        kernels.raw_walk(r, d.cum, d.total, out, num_lanes, graph.out_indptr,
                         graph.out_indices, graph.alias_prob,
                         graph.alias_other, seed, alpha, max_hops,
                         lane_lo=lane_lo, ends=ends)


def raw_walk_sharded_chunk(csr: ShardedOutCSR, rs: list, ds: list,
                           bounds: torch.Tensor, lane_lo: int,
                           num_lanes: int, seed: int, alpha: float,
                           max_hops: int, outs: list,
                           ends: Optional[torch.Tensor] = None) -> None:
    """:func:`raw_walk_chunk` of a chunk of the sharded raw walk: ``rs``,
    ``ds`` and ``bounds`` as :func:`expand_chunk_lanes` takes them, the
    walks over the out-CSR's slices ``csr``, each lane's weight into its
    shard's partial ``outs[h]`` ([G * n_loc, Bc]).  A CUDA ``bounds``
    launches ``kernels.raw_walk``'s sharded form (one launch for every
    shard; lanes past bounds[G, b] are not walked): the chain
    expand_chunk_lanes -> walk_endpoints -> accumulate_chunk_endpoints bit
    for bit in its endpoints.  A CPU one runs that chain."""
    if bounds.device.type == "cpu":
        start, weight = expand_chunk_lanes(rs, ds, bounds, lane_lo, num_lanes,
                                           csr.n_loc)
        got = walk_endpoints(csr, start.view(-1), seed, alpha,
                             max_hops).view(start.shape)
        del start
        accumulate_chunk_endpoints(got, weight, outs, bounds, lane_lo)
        if ends is not None:
            _keep_walked(ends, got, lane_lo, bounds[-1])
        return
    kernels.raw_walk(rs, [d.cum for d in ds], None, outs, num_lanes,
                     csr.indptr, csr.indices, csr.alias_prob,
                     csr.alias_other, seed, alpha, max_hops, lane_lo=lane_lo,
                     bounds=bounds, n_loc=csr.n_loc, ends=ends)


def _keep_walked(ends: torch.Tensor, got: torch.Tensor, lane_lo: int,
                 total: torch.Tensor) -> None:
    """``ends`` [W, Bc] takes ``got``'s endpoints on the lanes lane_lo + t
    below their column's ``total`` [Bc] (the lanes K6+K4 walks)."""
    lane = lane_lo + torch.arange(got.shape[0], device=total.device)
    walked = (lane[:, None] < total[None, :]).to(ends.device)
    ends[walked] = got.to(ends.device)[walked]


def raw_walk_chunk_plain(graph, rs: list, ds: list, bounds: torch.Tensor,
                         lane_lo: int, num_lanes: int, n_loc: int, seed: int,
                         alpha: float, max_hops: int, outs: list,
                         ends: Optional[torch.Tensor] = None) -> None:
    """K6+K4 in plain PyTorch over G >= 1 shards (``bounds`` [G + 1, Bc]
    the running sums of their totals; G = 1 with bounds [0, total] is the
    unsharded chunk): each lane's node by ``torch.searchsorted`` over its
    shard's cum and its weight (:func:`expand_chunk_lanes_plain`), every
    lane's walk by :func:`run_walks_philox` on the [W, Bc] starts (walk t
    * Bc + b; a lane past the demand walks from node 0 and weighs 0), and
    one ``scatter_add_`` per shard (:func:`accumulate_chunk_endpoints_plain`).
    The reference the kernel is held to; no path runs it."""
    start, weight = expand_chunk_lanes_plain(rs, ds, bounds, lane_lo,
                                             num_lanes, n_loc)
    got = run_walks_philox(graph, start, seed, alpha, max_hops)
    accumulate_chunk_endpoints_plain(got, weight, outs, bounds, lane_lo)
    if ends is not None:
        _keep_walked(ends, got, lane_lo, bounds[-1])


XP_RECORD = 4   # int32 words of a handed-over walk: w, cur, h | len << 16,
#                 weight's bits


def own_lanes(bounds: np.ndarray, lane_lo: int, rows: int) -> tuple:
    """(walks, extent) of a process's own lanes in a chunk of ``rows`` lane
    rows from ``lane_lo``: ``bounds`` [L + 1, Bc] its rows of the chunk's
    running totals (host int64); per column the lanes from max(bounds[0],
    lane_lo) up to min(bounds[L], lane_lo + rows), their sum and the
    most in one column."""
    per = (np.minimum(bounds[-1], lane_lo + rows)
           - np.maximum(bounds[0], lane_lo)).clip(min=0)
    return int(per.sum()), int(per.max(initial=0))


def raw_walk_xp_chunk(csr: ShardedOutCSR, rs: list, ds: list,
                      bounds: torch.Tensor, lane_lo: int, num_lanes: int,
                      extent: int, shard0: int, G: int, seed: int,
                      alpha: float, max_hops: int, out: torch.Tensor,
                      inbox: torch.Tensor, outbox: torch.Tensor,
                      counts: torch.Tensor,
                      ends: Optional[torch.Tensor] = None) -> None:
    """One launch of a process's share of a chunk of the sharded raw walk
    with the G shards spread over processes of L each.  The process holds
    shards ``shard0`` .. ``shard0`` + L - 1: ``rs`` and ``ds`` their
    residues and demands (column slices), ``csr`` their out-CSR slices,
    ``bounds`` [L + 1, Bc] int64 its rows of the chunk's running totals
    (:func:`sharded_walk_phase`'s, rows shard0 .. shard0 + L).  A launch
    walks one source: its own lanes (``extent`` > 0: the most of them in a
    column), which start and weigh as :func:`raw_walk_sharded_chunk`'s and
    draw as walk t * Bc + b, or the walks of ``inbox`` [n_in, 4] int32 (w,
    cur, h | len << 16, weight's bits), which go on from where they
    stopped.  A walk advances while its node lies in the process's rows;
    one that ends adds its weight into ``out`` [G * n_loc, Bc] at its
    endpoint (column w % Bc) and, with ``ends`` [num_lanes, Bc] int32,
    writes its endpoint at w; one whose next hop starts at another
    process's node is written to ``outbox`` [P, cap, 4] at that process as
    such a record, ``counts`` [P] int32 the number for each (a count past
    cap would mean records were lost: cap must be the launch's walks).  A
    CUDA ``bounds`` launches K6+K4-xp's own-lane form
    (``kernels.raw_walk_xp``) or its inbox form
    (``kernels.raw_walk_xp_inbox``), a CPU one runs
    :func:`raw_walk_xp_plain`.  Every walk's endpoint is
    :func:`raw_walk_sharded_chunk`'s on a card (and
    :func:`raw_walk_chunk_plain`'s), bit for bit."""
    if extent > 0 and inbox.shape[0]:
        raise ValueError("raw_walk_xp_chunk: one source of walks a launch, "
                         "own lanes or an inbox")
    if not 0 <= max_hops < 2**15:
        raise ValueError(f"raw_walk_xp_chunk: max_hops {max_hops}; a record "
                         f"holds lengths below 2^15")
    if bounds.device.type == "cpu":
        raw_walk_xp_plain(csr, rs, ds, bounds, lane_lo, num_lanes, extent,
                          shard0, G, seed, alpha, max_hops, out, inbox,
                          outbox, counts, ends=ends)
    elif extent > 0:
        kernels.raw_walk_xp(rs, [d.cum for d in ds], bounds, out, num_lanes,
                            lane_lo, extent, csr.indptr, csr.indices,
                            csr.alias_prob, csr.alias_other, seed, alpha,
                            max_hops, shard0, G, outbox, counts, ends=ends)
    else:
        kernels.raw_walk_xp_inbox(inbox, out, csr.indptr, csr.indices,
                                  csr.alias_prob, csr.alias_other, seed,
                                  shard0, G, outbox, counts, ends=ends)


def raw_walk_xp_plain(csr: ShardedOutCSR, rs: list, ds: list,
                      bounds: torch.Tensor, lane_lo: int, num_lanes: int,
                      extent: int, shard0: int, G: int, seed: int,
                      alpha: float, max_hops: int, out: torch.Tensor,
                      inbox: torch.Tensor, outbox: torch.Tensor,
                      counts: torch.Tensor,
                      ends: Optional[torch.Tensor] = None) -> None:
    """K6+K4-xp in plain PyTorch (:func:`raw_walk_xp_chunk`'s arguments):
    the own lanes by :func:`expand_chunk_lanes_plain` over the local
    shards (their lengths by :func:`lengths_of`), the inbox's records
    (their lengths from the record), then a hop loop in
    :func:`run_walks_philox`'s arithmetic (``_xp_hops``: each walk's
    counter h + 1, key (seed's low word, w)) that stops a walk at a foreign
    row, then one scatter-add of the ended walks' weights; each
    destination's records in the order of w."""
    L, n_loc = len(rs), csr.n_loc
    dev = out.device
    Bc = out.shape[1]
    w, cur, h, wt, length = [], [], [], [], []
    if extent > 0 and num_lanes > 0:
        start, weight = expand_chunk_lanes_plain(rs, ds, bounds, lane_lo,
                                                 num_lanes, n_loc)
        lane = lane_lo + torch.arange(num_lanes, device=dev)[:, None]
        own = (lane >= bounds[0][None, :]) & (lane < bounds[-1][None, :])
        t, b = torch.nonzero(own, as_tuple=True)
        w.append(t * Bc + b)
        cur.append(start[t, b].long() + shard0 * n_loc)
        h.append(torch.zeros_like(t))
        wt.append(weight[t, b])
        length.append(lengths_of(seed, w[-1], alpha, max_hops))
    if inbox.shape[0]:
        for x, y in zip((w, cur, h, length), _xp_records(inbox)):
            x.append(y)
        wt.append(inbox[:, 3].contiguous().view(torch.float32))
    counts.zero_()
    if not w:
        return
    w, cur, h, wt, length = (torch.cat(x) for x in (w, cur, h, wt, length))
    gone = _xp_hops(csr, shard0, seed, w, cur, h, length)
    end = ~gone
    out.index_put_((cur[end], w[end] % Bc), wt[end], accumulate=True)
    if ends is not None:
        ends.view(-1)[w[end]] = cur[end].to(torch.int32)
    _xp_send(gone, w, cur, h, length, wt.view(torch.int32), L * n_loc,
             outbox, counts)


def _xp_records(inbox: torch.Tensor) -> tuple:
    """(w, cur, h, length) int64 of records (w, cur, h | len << 16, .)."""
    return (inbox[:, 0].long() & _M32, inbox[:, 1].long(),
            inbox[:, 2].long() & 0xFFFF, inbox[:, 2].long() >> 16)


def _xp_hops(csr: ShardedOutCSR, shard0: int, seed: int, w: torch.Tensor,
             cur: torch.Tensor, h: torch.Tensor, length: torch.Tensor,
             chunk_lanes: Optional[int] = None) -> torch.Tensor:
    """The hop loop of K6+K4-xp's and K4-xp's plain versions, in place on
    the walks' nodes ``cur`` and hops taken ``h`` (int64, each walk w's
    draws by :func:`chunk_draws`, hop h's counter h + 1, as
    :func:`run_walks_philox`): a walk hops over ``csr``, the L slices of
    shards ``shard0`` .. ``shard0`` + L - 1, while its node lies in this
    process's rows and hops remain; returns the walks that stopped at
    another process's node before their last hop (handed over)."""
    L, n_loc = len(csr.indptr), csr.n_loc
    rank, rows_p = shard0 // L, L * n_loc
    lo, hi, key = chunk_draws(seed, w, chunk_lanes)
    per_walk = torch.is_tensor(hi)
    rows = _Rows(csr, w.device)
    alias = rows.alias_prob is not None
    gone = torch.zeros_like(w, dtype=torch.bool)      # handed over
    live = torch.nonzero(h < length).squeeze(1)
    while live.numel():
        p0, d = rows(cur[live] - shard0 * n_loc)
        moving = d > 0                          # dangling absorbs
        live, p0, d = live[moving], p0[moving], d[moving]
        r = philox4x32_10((h[live] + 1, hi[live] if per_walk else hi, 0, 0),
                          (lo, key[live]))
        slot = p0 + torch.minimum((_unit(r[0]) * d.to(torch.float32)).long(),
                                  d - 1)
        nxt = rows.indices[slot]
        if alias:
            nxt = torch.where(_unit(r[1]) < rows.alias_prob[slot], nxt,
                              rows.alias_other[slot])
        cur[live] = nxt.long()
        h[live] += 1
        going = h[live] < length[live]
        leave = going & (torch.div(cur[live], rows_p, rounding_mode="floor")
                         != rank)
        gone[live[leave]] = True
        live = live[going & ~leave]
    return gone


def _xp_send(gone: torch.Tensor, w: torch.Tensor, cur: torch.Tensor,
             h: torch.Tensor, length: torch.Tensor, word3: torch.Tensor,
             rows_p: int, outbox: torch.Tensor, counts: torch.Tensor) -> None:
    """The records (w, cur, h | len << 16, word3) of the walks ``gone``
    into ``outbox`` [P, cap, 4] at their node's process (``rows_p`` rows
    each), each destination's in the order of w; ``counts`` [P] the number
    for each (past cap, records were not written)."""
    dest = torch.div(cur, rows_p, rounding_mode="floor")
    for q in range(outbox.shape[0]):
        sel = torch.nonzero(gone & (dest == q)).squeeze(1)
        sel = sel[torch.argsort(w[sel])]
        counts[q] = sel.numel()
        k = min(sel.numel(), outbox.shape[1])
        if k:
            key = w[sel[:k]]
            outbox[q, :k, 0] = torch.where(key >= 2**31, key - 2**32,
                                           key).to(torch.int32)
            outbox[q, :k, 1] = cur[sel[:k]].to(torch.int32)
            outbox[q, :k, 2] = (h[sel[:k]] | length[sel[:k]] << 16).to(
                torch.int32)
            outbox[q, :k, 3] = word3[sel[:k]]


def index_walk_xp_chunk(csr: ShardedOutCSR, start: torch.Tensor, w0: int,
                        wlo: int, chunk_lanes: int, shard0: int, G: int,
                        seed: int, alpha: float, max_hops: int,
                        inbox: torch.Tensor, outbox: torch.Tensor,
                        counts: torch.Tensor, ends: torch.Tensor) -> None:
    """One launch of a process's share of a window of the index build
    (whole chunks of ``chunk_lanes`` walks from walk ``wlo``; ``ends``
    [n_ends] int32 its endpoints) with the G shards spread over processes
    of L each (the sharded build across processes,
    ``index/build_sharded.py``).  The process holds shards ``shard0`` ..
    ``shard0`` + L - 1, ``csr`` their out-CSR slices.  Walk w (its number
    in the build's starts) draws as walk w % chunk_lanes of chunk c = w //
    chunk_lanes at ``seed`` + c 2^32.  A launch walks one source: its own
    starts of the window, ``start`` [W] int32, walks ``w0`` .. ``w0`` + W
    - 1 (the starts are sorted by node, so they are one run), or the walks
    of ``inbox`` [n_in, 4] int32 (w, cur, h | len << 16, 0), which go on
    from where they stopped.  A walk advances while its node lies in the
    process's rows; one that ends writes its endpoint at ``ends[w - wlo]``;
    an own walk that leaves writes -1 there; one whose next hop starts at
    another process's node is written to ``outbox`` [P, cap, 4] at that
    process as such a record, ``counts`` [P + 1] int32 (zero at the call;
    the last word the inbox form's cursor) the number for each (cap must
    be the launch's walks).  A CUDA ``ends`` launches K4-xp's own-start
    form (``kernels.index_walk_xp``) or its inbox form
    (``kernels.index_walk_xp_inbox``), a CPU one runs
    :func:`index_walk_xp_plain`.  Every walk w ends where
    :func:`run_walks_philox` ends walk w % chunk_lanes of its chunk's
    starts at the chunk's seed, bit for bit (on a card: where K4's sharded
    form ends it)."""
    if start.shape[0] and inbox.shape[0]:
        raise ValueError("index_walk_xp_chunk: one source of walks a "
                         "launch, own starts or an inbox")
    if not 0 <= max_hops < 2**15:
        raise ValueError(f"index_walk_xp_chunk: max_hops {max_hops}; a "
                         f"record holds lengths below 2^15")
    if ends.device.type == "cpu":
        index_walk_xp_plain(csr, start, w0, wlo, chunk_lanes, shard0, G,
                            seed, alpha, max_hops, inbox, outbox, counts,
                            ends)
    elif start.shape[0]:
        kernels.index_walk_xp(start, ends, w0, wlo, chunk_lanes, csr.indptr,
                              csr.indices, csr.alias_prob, csr.alias_other,
                              seed, alpha, max_hops, shard0, G, outbox,
                              counts)
    else:
        kernels.index_walk_xp_inbox(inbox, ends, wlo, chunk_lanes,
                                    csr.indptr, csr.indices, csr.alias_prob,
                                    csr.alias_other, seed, shard0, G, outbox,
                                    counts)


def index_walk_xp_plain(csr: ShardedOutCSR, start: torch.Tensor, w0: int,
                        wlo: int, chunk_lanes: int, shard0: int, G: int,
                        seed: int, alpha: float, max_hops: int,
                        inbox: torch.Tensor, outbox: torch.Tensor,
                        counts: torch.Tensor, ends: torch.Tensor) -> None:
    """K4-xp in plain PyTorch (:func:`index_walk_xp_chunk`'s arguments):
    the own starts walks ``w0`` + i (their lengths by :func:`lengths_of`
    with ``chunk_lanes``), the inbox's records (their lengths from the
    record), then :func:`run_walks_philox`'s hop loop stopping a walk at a
    foreign row (K6+K4-xp's, ``_xp_hops``, each walk drawing as its
    chunk's); the ended walks' endpoints at ``ends[w - wlo]``, -1 at the
    own walks that left; each destination's records in the order of w;
    counts[:P] theirs, counts[P] 0."""
    dev = ends.device
    W = start.shape[0]
    if W:
        w = int(w0) + torch.arange(W, device=dev)
        cur, h = start.long(), torch.zeros(W, dtype=torch.long, device=dev)
        length = lengths_of(seed, w, alpha, max_hops, chunk_lanes)
    else:
        w, cur, h, length = _xp_records(inbox)
    counts.zero_()
    if not w.numel():
        return
    gone = _xp_hops(csr, shard0, seed, w, cur, h, length, chunk_lanes)
    ends[w[~gone] - wlo] = cur[~gone].to(torch.int32)
    if W:       # an own walk that left: -1, as the kernel's staged ends
        ends[w[gone] - wlo] = -1
    _xp_send(gone, w, cur, h, length, torch.zeros_like(w, dtype=torch.int32),
             len(csr.indptr) * csr.n_loc, outbox, counts)


# rounds whose counts one zeroed table holds (a build's rounds are at most
# max_hops + 1, 65 at the default)
_ROUND_BLOCK = 64


def xp_chunk_rounds(launch, exchange, own: dict, P: int, device,
                    words: int = 0) -> list:
    """The rounds of one chunk of the raw walk, or one window of the index
    build, across P processes, for the processes run here: ``own`` maps
    each one's rank to its own walks (:func:`own_lanes`, a window's own
    run).  Each round gives every process q here an outbox [P, cap,
    XP_RECORD] int32, cap its round's walks (its own in round 0, then none,
    plus its inbox's), and counts [P + ``words``] int32, zero (a row of a
    table zeroed once for _ROUND_BLOCK rounds, so no launch zeroes its
    own; the ``words`` past P the launch's scratch), and calls
    ``launch(q, r, inbox, outbox, counts)`` (round r, the inbox the records
    sent to q in the round before); then ``exchange(boxes)`` ({q: (outbox,
    counts)}: :func:`process_exchange` or :func:`local_exchange`) gives the
    round's [P, P] counts of every process, m[s, d] the records s sent d,
    and the next inboxes, None when no process sent a walk: the rounds
    end, after at most max_hops + 1.  Returns every round's counts."""
    inbox = {q: torch.empty((0, XP_RECORD), dtype=torch.int32, device=device)
             for q in own}
    counts_by_round = []
    zeros = None
    while inbox is not None:
        r = len(counts_by_round)
        if r % _ROUND_BLOCK == 0:
            zeros = torch.zeros((_ROUND_BLOCK, len(own), P + words),
                                dtype=torch.int32, device=device)
        boxes = {}
        for i, q in enumerate(own):
            cap = (own[q] if r == 0 else 0) + inbox[q].shape[0]
            boxes[q] = (torch.empty((P, cap, XP_RECORD), dtype=torch.int32,
                                    device=device),
                        zeros[r % _ROUND_BLOCK, i])
            launch(q, r, inbox[q], *boxes[q])
        m, inbox = exchange(boxes)
        counts_by_round.append(m)
    return counts_by_round


def _counted(m: np.ndarray) -> np.ndarray:
    """The [P, P] counts of [P, P + 1] rows (each process's counts per
    destination and its outbox's capacity); raises where a count passed
    its capacity (records were lost), alike on every process."""
    P = m.shape[0]
    if (m[:, :P] > m[:, P:]).any():
        raise RuntimeError("raw walk across processes: a count of records "
                           f"passed its outbox's capacity: {m.tolist()}")
    return m[:, :P]


def process_exchange(comm, part=None):
    """:func:`xp_chunk_rounds`' exchange over ``comm`` (a
    ``parallel.multihost.ProcessComm``; the one process here is
    ``comm.rank``): one all-gather of every process's counts and outbox
    capacity (one host read: the receive sizes, the capacity check and
    whether any process still holds a walk, alike everywhere; an
    all-to-all of the counts would leave a process that received nothing
    unaware of the others), then, while walks were sent, one all-to-all of
    the records.  ``part(name)``, where given, is a context that times the
    two ("gather", "all_to_all")."""
    P, q = comm.size, comm.rank
    part = part or (lambda name: contextlib.nullcontext())

    def exchange(boxes):
        (outbox, counts), = boxes.values()
        with part("gather"):
            m = _counted(comm.all_gather(torch.cat([
                counts[:P], counts.new_tensor([outbox.shape[1]])])
                ).view(P, P + 1).cpu().numpy())
        if not m.any():
            return m, None
        with part("all_to_all"):
            send = torch.cat([outbox[d, :int(m[q, d])] for d in range(P)])
            recv = comm.all_to_all(send, m[q], m[:, q])
        return m, {q: recv}
    return exchange


def local_exchange(boxes: dict) -> tuple:
    """:func:`xp_chunk_rounds`' exchange among processes simulated in one
    (``boxes`` holds every rank): the counts read, and each process's inbox
    the records sent to it, in rank order."""
    P = len(boxes)
    m = _counted(np.stack([np.append(c[:P].cpu().numpy(), b.shape[1])
                           for b, c in (boxes[s] for s in range(P))]))
    if not m.any():
        return m, None
    return m, {d: torch.cat([boxes[s][0][d, :int(m[s, d])]
                             for s in range(P)]) for d in range(P)}


def source_walk_chunk(graph: DeviceGraph, sources: torch.Tensor, rows: int,
                      seed: int, alpha: float, max_hops: int, weight: float,
                      out: torch.Tensor, hub=None,
                      ends: Optional[torch.Tensor] = None) -> None:
    """One chunk of source-rooted walks (Monte Carlo, HubPPR's queries):
    ``rows`` walks from each of the B ``sources`` ([B] int32), walk t * B +
    b from sources[b] under ``seed``, each adding ``weight`` (a number)
    into ``out`` [n, B] f32 (adjacent columns) at its endpoint.  With
    ``hub`` (an ``algo.hubppr.HubIndex``) a hop that lands on a hub ends
    the walk at one of its pool's entries.  ``ends`` (tests and checks
    only) [rows, B] int32 gets every endpoint.  A CUDA tensor launches
    K6+K4-src (``kernels.source_walk``: K4's walks, its alias branch on a
    graph with alias tables, its hub branch with ``hub``; the endpoints of
    walk_endpoints (hub_walks) on ``sources.repeat(rows)`` bit for bit, the
    sums up to the order of the f32 adds); a CPU one runs that chain, the
    Generator's walks then accumulate_endpoints."""
    if sources.device.type == "cpu":
        start = sources.repeat(rows)
        if hub is None:
            got = walk_endpoints(graph, start, seed, alpha, max_hops)
        else:
            from ..algo.hubppr import hub_walks
            got = hub_walks(graph, start, seed, hub, alpha=alpha,
                            max_hops=max_hops)
        got = got.view(rows, sources.shape[0])
        accumulate_endpoints(got, weight, out.shape[0], out=out)
        if ends is not None:
            ends.copy_(got)
        return
    kernels.source_walk(
        sources, out, rows, graph.out_indptr, graph.out_indices,
        graph.alias_prob, graph.alias_other,
        None if hub is None else hub.hub_id,
        None if hub is None else hub.pool, seed, alpha, max_hops, weight,
        ends=ends)


def source_walk_chunk_plain(graph, sources: torch.Tensor, rows: int,
                            seed: int, alpha: float, max_hops: int, weight,
                            out: torch.Tensor, hub=None,
                            ends: Optional[torch.Tensor] = None) -> None:
    """K6+K4-src in plain PyTorch: :func:`run_walks_philox` (with ``hub``)
    on ``sources.repeat(rows)`` viewed as [rows, B], then
    :func:`accumulate_endpoints_plain` of ``weight`` (a number, or a
    float64 one for a float64 ``out``).  The reference the kernel is held
    to; no path runs it."""
    B = sources.shape[0]
    got = run_walks_philox(graph, sources.repeat(rows), seed, alpha,
                           max_hops, hub=hub).view(rows, B)
    w = torch.full((rows, B), weight, dtype=out.dtype, device=out.device)
    accumulate_endpoints_plain(got, w, out.shape[0], out)
    if ends is not None:
        ends.copy_(got)


def walk_lane_budget(omega_unit: float, rmax: float, m: int, n: int,
                     cap: Optional[int] = None, slack: float = 1.10,
                     lane_multiple: int = LANE_MULTIPLE) -> int:
    """JAX's static lane count for a (config, graph) pair: rsum <= min(1,
    rmax * m) after push, plus one walk per touched node for the ceil."""
    rsum_bound = min(1.0, rmax * m)
    w = int(slack * omega_unit * rsum_bound) + min(n, int(omega_unit))
    w = -(-w // lane_multiple) * lane_multiple
    if cap is not None:
        w = min(w, cap)
    return max(w, lane_multiple)


def chunk_lanes(device) -> int:
    """Lanes one chunk of a walk path takes on ``device``: CHUNK_LANES on
    a card, CPU_LANE_BUDGET on the CPU.  Both are constants, so the
    chunks, and with them the walks a seed draws, never depend on the
    memory a device has free."""
    return CPU_LANE_BUDGET if torch.device(device).type == "cpu" \
        else CHUNK_LANES


def _round_up(x: int) -> int:
    return -(-int(x) // LANE_MULTIPLE) * LANE_MULTIPLE


def plan_chunks(total, budget: int) -> list:
    """Chunks ``(c0, c1, lane_lo, lane_hi)`` covering every walk of
    ``total`` ([B] walks per column): runs of adjacent columns whose lane
    count (the run's largest total, rounded up to LANE_MULTIPLE) times
    their number fits ``budget``; a column over the budget alone is split
    into lane ranges.  Columns without walks get none."""
    total = [int(t) for t in total]
    budget = max(LANE_MULTIPLE, budget // LANE_MULTIPLE * LANE_MULTIPLE)
    chunks, b = [], 0
    while b < len(total):
        w = _round_up(total[b])
        if w > budget:
            chunks += [(b, b + 1, lo, min(lo + budget, w))
                       for lo in range(0, total[b], budget)]
            b += 1
            continue
        c1 = b + 1
        while c1 < len(total) and \
                max(w, _round_up(total[c1])) * (c1 + 1 - b) <= budget:
            w = max(w, _round_up(total[c1]))
            c1 += 1
        if w:
            chunks.append((b, c1, 0, w))
        b = c1
    return chunks


class WalkPhase(NamedTuple):
    """What one walk phase did."""

    total: torch.Tensor     # [B] i32 walks demanded (0 past ``live``)
    overflow: torch.Tensor  # [B] bool: always False (lanes fit the demand)
    walks_max: int          # largest column demand
    walks_total: int        # walks demanded, all columns
    lanes: int              # lanes walked, over all chunks
    chunks: int


def walk_phase(graph: DeviceGraph, r: torch.Tensor, omega_unit: float,
               seed: int, alpha: float, max_hops: int,
               live: Optional[int] = None, clock=None):
    """FORA's walk phase on the residue ``r`` [n, B]: ``(contrib [n, B]
    f32, WalkPhase)``.  Only the first ``live`` columns walk (the rest are
    a pool's padding; their contrib stays 0).  Chunk i of ``plan_chunks``
    draws from ``derive_seed(seed, i)`` (:func:`raw_walk_chunk`: on a card
    one launch of K6+K4).  ``clock`` (a ``utils.timing.StageClock``) times
    the allocation (the demand; the CPU's expansion), walks (on a card
    K6+K4, with the expansion and the accumulate) and the CPU's
    accumulation."""
    from ..utils.timing import StageClock
    clock = clock or StageClock(None)
    B = r.shape[1]
    live = B if live is None else live
    contrib = torch.zeros_like(r)
    with clock.stage("alloc"):
        d = walk_demand(r[:, :live], omega_unit)
    tot = d.total.cpu().numpy()          # one host read per phase
    chunks = plan_chunks(tot, chunk_lanes(r.device))
    lanes = 0
    for i, (c0, c1, lo, hi) in enumerate(chunks):
        raw_walk_chunk(graph, r[:, c0:c1], d.columns(c0, c1), lo, hi - lo,
                       derive_seed(seed, i), alpha, max_hops,
                       contrib[:, c0:c1], clock=clock)
        lanes += (hi - lo) * (c1 - c0)
    total = torch.zeros(B, dtype=torch.int32, device=r.device)
    total[:live] = d.total
    return contrib, WalkPhase(
        total=total, overflow=torch.zeros_like(total, dtype=torch.bool),
        walks_max=int(tot.max(initial=0)), walks_total=int(tot.sum()),
        lanes=lanes, chunks=len(chunks))



def sharded_walk_phase(csr: ShardedOutCSR, rs: list, omega_unit: float,
                       seed: int, alpha: float, max_hops: int):
    """The walk phase of the sharded raw one-shot on the shards' residues
    ``rs`` (G x [n_loc, B] f32, shard h's rows h * n_loc ..): per shard the
    [G * n_loc, B] f32 endpoint mass of the walks its residues demand, on
    its device, for P2 to sum into the owners; and a ``WalkPhase``.

    The walks are ``walk_phase``'s on the concatenation of ``rs``: per
    column the shards' demands concatenate, so shard h's lanes follow
    shard h - 1's (lane ``off[h, b] + i``, ``off[h, b]`` the walks the
    shards before h demand in column b), and the chunks are
    ``plan_chunks``' over the columns' totals.  Each shard's demand is
    ``walk_demand`` on its own residues, all of them in one launch a card
    (:func:`walk_demands`); per chunk, on the first shard's
    device, lane l of column b is shard h's where off[h, b] <= l < off[h +
    1, b], starts at its node made global by + h * n_loc, walks over the
    slices with ``derive_seed(seed, i)``, and adds its weight at its
    endpoint into its shard's partial (:func:`raw_walk_sharded_chunk`: on
    a card one launch of K6+K4's sharded form).  Both plan their
    chunks under :func:`chunk_lanes`, so every walk is ``walk_phase``'s,
    and after P2 the contribution is ``walk_phase``'s up to the order of
    the float32 sums.  JAX's static per-shard lane count and the walks it
    drops past it (ROADMAP C7) are not copied."""
    G = len(rs)
    n_loc, B = rs[0].shape
    n_pad, dev0 = G * n_loc, rs[0].device
    ds, tot = walk_demands(rs, omega_unit)
    tot = tot.cpu().numpy().astype(np.int64)         # [G, B], one read
    total = tot.sum(axis=0)
    partials = [torch.zeros((n_pad, B), dtype=torch.float32, device=r.device)
                for r in rs]
    chunks = plan_chunks(total, chunk_lanes(dev0))
    # the running sums of the shards' totals: column b's lanes bounds[h,
    # b] .. bounds[h + 1, b] - 1 are shard h's
    bounds = torch.as_tensor(np.concatenate([np.zeros((1, B), np.int64),
                                             np.cumsum(tot, axis=0)]),
                             device=dev0)
    lanes = 0
    for i, (c0, c1, lo, hi) in enumerate(chunks):
        W, Bc = hi - lo, c1 - c0
        part = bounds[:, c0:c1].contiguous()
        raw_walk_sharded_chunk(csr, [r[:, c0:c1] for r in rs],
                               [d.columns(c0, c1) for d in ds], part, lo, W,
                               derive_seed(seed, i), alpha, max_hops,
                               [p[:, c0:c1] for p in partials])
        lanes += W * Bc
    return partials, WalkPhase(
        total=torch.as_tensor(total, dtype=torch.int32, device=dev0),
        overflow=torch.zeros(B, dtype=torch.bool, device=dev0),
        walks_max=int(total.max(initial=0)), walks_total=int(total.sum()),
        lanes=lanes, chunks=len(chunks))


def sharded_walk_phase_xp(csr: ShardedOutCSR, rs: list, omega_unit: float,
                          seed: int, alpha: float, max_hops: int, comm,
                          shard0: int, G: int, log: Optional[dict] = None):
    """:func:`sharded_walk_phase` with the G shards spread over the
    processes of ``comm`` (a ``parallel.multihost.ProcessComm``), this one
    holding shards ``shard0`` .. ``shard0`` + L - 1 (``rs`` their
    residues, ``csr`` their out-CSR slices): ``([partial], WalkPhase)``,
    the process's one [G * n_loc, B] f32 endpoint mass, for P2 to sum.

    Every process takes its shards' demands (:func:`walk_demands`), and
    one all-gather of the [L, B] totals gives each the [G + 1, B] running
    sums and so :func:`sharded_walk_phase`'s chunks and seeds.  Per chunk,
    the rounds of :func:`xp_chunk_rounds` over :func:`process_exchange`:
    round 0 walks the process's own lanes; each round is one launch
    (:func:`raw_walk_xp_chunk`), one all-gather of every process's counts
    and outbox capacity, then one all-to-all of the records; the rounds
    end when no process sent a walk.  ``log``, where given, gets per
    chunk the rounds and per round the records this process sent and
    received (``rounds``, ``sent``, ``received``), and with ``log["ends"]
    = True`` the first chunk's endpoints of the walks that ended here
    ([W, Bc] int32, -1 elsewhere)."""
    L = len(rs)
    n_loc, B = rs[0].shape
    P, q = comm.size, comm.rank
    dev = rs[0].device
    ds, tot = walk_demands(rs, omega_unit)
    # [G, B]: every process's [L, B] totals, one read
    tot = comm.all_gather(tot).cpu().numpy().astype(np.int64)
    total = tot.sum(axis=0)
    chunks = plan_chunks(total, chunk_lanes(dev))
    bounds_np = np.concatenate([np.zeros((1, B), np.int64),
                                np.cumsum(tot, axis=0)])
    mine = bounds_np[shard0:shard0 + L + 1]
    bounds = torch.as_tensor(mine, device=dev)
    partial = torch.zeros((G * n_loc, B), dtype=torch.float32, device=dev)
    exchange = process_exchange(comm)
    want_ends = log is not None and log.get("ends") is True
    if log is not None:
        log.update(rounds=[], sent=[], received=[])
    lanes = 0
    for i, (c0, c1, lo, hi) in enumerate(chunks):
        W, Bc = hi - lo, c1 - c0
        part = bounds[:, c0:c1].contiguous()
        own, extent = own_lanes(mine[:, c0:c1], lo, W)
        ends = None
        if want_ends and i == 0:
            ends = log["ends"] = torch.full((W, Bc), -1, dtype=torch.int32,
                                            device=dev)
        rsc = [r[:, c0:c1] for r in rs]
        dsc = [d.columns(c0, c1) for d in ds]
        out, seed_i = partial[:, c0:c1], derive_seed(seed, i)

        def launch(_, r, inbox, outbox, counts):
            raw_walk_xp_chunk(csr, rsc, dsc, part, lo, W,
                              extent if r == 0 else 0, shard0, G, seed_i,
                              alpha, max_hops, out, inbox, outbox, counts,
                              ends=ends)
        ms = xp_chunk_rounds(launch, exchange, {q: own}, P, dev)
        if log is not None:
            log["rounds"].append(len(ms))
            log["sent"].append([int(m[q].sum()) for m in ms])
            log["received"].append([int(m[:, q].sum()) for m in ms])
        lanes += W * Bc
    return [partial], WalkPhase(
        total=torch.as_tensor(total, dtype=torch.int32, device=dev),
        overflow=torch.zeros(B, dtype=torch.bool, device=dev),
        walks_max=int(total.max(initial=0)), walks_total=int(total.sum()),
        lanes=lanes, chunks=len(chunks))
