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
its int32 cumsum and the per-column total) and the expansion of a range of
lanes onto nodes (``expand_lanes``; ``expand_chunk_lanes`` expands a
chunk of the sharded raw walk over every shard's demand).  On a card they,
``accumulate_endpoints`` and ``accumulate_chunk_endpoints`` launch K6
(``kernels/csrc/walk_alloc.cu``); the ``*_plain`` functions are the CPU
path and the reference the kernels are held to.  ``walk_phase`` sizes
the lanes by the measured demand, one host read per call, and splits the
columns (and, for a column too large alone, its lanes) into chunks that
fit the device's free memory, so a query never loses walks: JAX's static
lane count drops the walks past it and only raises ``overflow``.

The sharded raw one-shot and the sharded index build walk an out-CSR
split into G row slices (``ShardedOutCSR``, the arrays of
``index/build_sharded.py::_shard_csr``), in place of JAX's
``sharded_lockstep_walk`` (225-266) and ``sharded_lockstep_walk_scheduled``
(269-320), whose one psum per hop combines the shards' samples: every walk
function here also takes the slices and reads each row through its owner
(shard ``v // n_loc``), which on a card is K4's sharded form, so the
endpoints are those of the unsharded graph bit for bit.
``sharded_walk_phase`` is the raw one-shot's walk phase over the shards'
residues.

Dangling convention: a walk at an out-degree-0 node is absorbed there.
Random numbers come from a ``torch.Generator`` (``run_walks``, the CPU
path) or the kernel's Philox stream (K4, ``run_walks_philox``); neither
replays JAX's threefry bits, so endpoints agree with JAX in distribution
only.  Streams are keyed by 64-bit seeds from ``derive_seed``, one per
(call, level, block, chunk).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import kernels
from ..graph.csr import DeviceGraph

LANE_MULTIPLE = 1024
LANE_BYTES = 40          # device bytes a lane holds at the walk phase's peak
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
                   alpha: float, max_hops: int) -> torch.Tensor:
    """One walk per entry of ``start`` ([W] int32) over ``graph``, a
    DeviceGraph or a ShardedOutCSR; endpoints [W] int32.  CPU tensors run
    the plain ``run_walks``; CUDA tensors launch K4, its alias branch on a
    graph with alias tables, its sharded form over slices."""
    if start.device.type == "cpu":
        gen = torch.Generator(device="cpu").manual_seed(seed % 2**63)
        return run_walks(graph, start, generator=gen, alpha=alpha,
                         max_hops=max_hops)
    if isinstance(graph, ShardedOutCSR):
        if graph.alias_prob is not None:
            return kernels.index_walk_sharded_alias(
                start, graph.indptr, graph.indices, graph.alias_prob,
                graph.alias_other, graph.n_loc, seed, alpha, max_hops)
        return kernels.index_walk_sharded(start, graph.indptr, graph.indices,
                                          graph.n_loc, seed, alpha, max_hops)
    if graph.alias_prob is not None:
        return kernels.index_walk_alias(
            start, graph.out_indptr, graph.out_indices, graph.alias_prob,
            graph.alias_other, seed, alpha, max_hops)
    return kernels.index_walk(start, graph.out_indptr, graph.out_indices,
                              seed, alpha, max_hops)


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
    seed = int(seed) % 2**64
    walk = torch.arange(W, dtype=torch.int64, device=device)
    u0 = ((philox4x32_10((0, seed >> 32, 0, 0), (seed & _M32, walk))[0]
           >> 8) + 1).to(torch.float32) * 2.0**-24
    inv = torch.tensor(kernels.inv_log1m_alpha(alpha), dtype=torch.float32,
                       device=device)
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


def lane_budget(device: torch.device, lane_bytes: int = LANE_BYTES) -> int:
    """Lanes one walk-phase chunk may hold: half of the card's free memory
    (``mem_get_info``'s free bytes plus the allocator's cached ones) at
    ``lane_bytes`` a lane; CPU_LANE_BUDGET on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return CPU_LANE_BUDGET
    free, _ = torch.cuda.mem_get_info(device)
    free += torch.cuda.memory_reserved(device) - \
        torch.cuda.memory_allocated(device)
    return max(LANE_MULTIPLE, free // 2 // lane_bytes)


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
    draws from ``derive_seed(seed, i)``.  ``clock`` (a
    ``utils.timing.StageClock``) times the allocation, walks and
    accumulation."""
    from ..utils.timing import StageClock
    clock = clock or StageClock(None)
    n, B = r.shape
    live = B if live is None else live
    contrib = torch.zeros_like(r)
    with clock.stage("alloc"):
        d = walk_demand(r[:, :live], omega_unit)
    tot = d.total.cpu().numpy()          # one host read per phase
    chunks = plan_chunks(tot, lane_budget(r.device))
    lanes = 0
    for i, (c0, c1, lo, hi) in enumerate(chunks):
        with clock.stage("alloc"):
            start, weight = expand_lanes(r[:, c0:c1], d.columns(c0, c1), lo,
                                         hi - lo)
        with clock.stage("walks"):
            ends = walk_endpoints(graph, start.view(-1), derive_seed(seed, i),
                                  alpha, max_hops)
            del start
        with clock.stage("accum"):
            accumulate_endpoints(ends.view(hi - lo, c1 - c0), weight, n,
                                 out=contrib[:, c0:c1])
        lanes += (hi - lo) * (c1 - c0)
    total = torch.zeros(B, dtype=torch.int32, device=r.device)
    total[:live] = d.total
    return contrib, WalkPhase(
        total=total, overflow=torch.zeros_like(total, dtype=torch.bool),
        walks_max=int(tot.max(initial=0)), walks_total=int(tot.sum()),
        lanes=lanes, chunks=len(chunks))



SHARDED_CHUNK_LANES = 1 << 27


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
    ``walk_demand`` on its own residues; per chunk, every shard's lanes go
    straight into the chunk's start and weight arrays on the first
    shard's device (``expand_chunk_lanes``: lane l of column b is shard
    h's where off[h, b] <= l < off[h + 1, b], its start made global by +
    h * n_loc), the walks run once over the slices with
    ``derive_seed(seed, i)``, and every lane's weight goes at its endpoint
    into its shard's partial (``accumulate_chunk_endpoints``).  So every
    walk is ``walk_phase``'s where the two plan the same chunks (always on
    the CPU; on a card ``walk_phase``'s chunks may be larger), and after
    P2 the contribution is ``walk_phase``'s up to the order of the float32
    sums.  JAX's static per-shard lane count and the walks it drops past
    it (ROADMAP C7) are not copied."""
    G = len(rs)
    n_loc, B = rs[0].shape
    n_pad, dev0 = G * n_loc, rs[0].device
    ds = [walk_demand(r, omega_unit) for r in rs]
    tot = torch.stack([d.total.to(dev0) for d in ds]).cpu().numpy()
    tot = tot.astype(np.int64)                       # [G, B], one read
    total = tot.sum(axis=0)
    partials = [torch.zeros((n_pad, B), dtype=torch.float32, device=r.device)
                for r in rs]
    # a chunk's lane holds its start, weight and endpoint (12 bytes) and
    # at most LANE_BYTES of an expansion; a chunk takes at most
    # SHARDED_CHUNK_LANES lanes, so that on a card with room for more the
    # chunks, and with them the walks a seed draws, do not depend on its
    # free memory (two runs of one batch walk the same walks)
    budget = lane_budget(dev0, LANE_BYTES + 12)
    chunks = plan_chunks(total, min(budget, SHARDED_CHUNK_LANES))
    # the running sums of the shards' totals: column b's lanes bounds[h,
    # b] .. bounds[h + 1, b] - 1 are shard h's
    bounds = torch.as_tensor(np.concatenate([np.zeros((1, B), np.int64),
                                             np.cumsum(tot, axis=0)]),
                             device=dev0)
    lanes = 0
    for i, (c0, c1, lo, hi) in enumerate(chunks):
        W, Bc = hi - lo, c1 - c0
        part = bounds[:, c0:c1].contiguous()
        start, weight = expand_chunk_lanes(
            [r[:, c0:c1] for r in rs], [d.columns(c0, c1) for d in ds], part,
            lo, W, n_loc)
        ends = walk_endpoints(csr, start.view(-1), derive_seed(seed, i),
                              alpha, max_hops).view(W, Bc)
        del start
        accumulate_chunk_endpoints(ends, weight,
                                   [p[:, c0:c1] for p in partials], part, lo)
        del ends, weight
        lanes += W * Bc
    return partials, WalkPhase(
        total=torch.as_tensor(total, dtype=torch.int32, device=dev0),
        overflow=torch.zeros(B, dtype=torch.bool, device=dev0),
        walks_max=int(total.max(initial=0)), walks_total=int(total.sum()),
        lanes=lanes, chunks=len(chunks))
