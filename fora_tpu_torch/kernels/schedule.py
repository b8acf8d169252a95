"""The work list of the destination-row gather (K1, K2): edge-balanced
tasks built once per CSR from its row degrees; the walk kernel's (K4)
plan: walks per lane and the grid (``walk_plan``); and K6+K4's, a warp tile
of one column's lanes (``raw_walk_plan``, at the end).

One warp of ``csrc/gather_scatter.cu`` takes one task.  A row of up to
``task_edges`` edges is one task; a longer row is split evenly into
``ceil(deg / task_edges)`` tasks, so no warp walks more than
``task_edges`` edges and a launch no longer lasts as long as its longest
row.  Every row has at least one task, an empty row too: the gather masks,
flags or overwrites every row of ``acc``.

A task of a split row writes its partial [B] sum into its own slot of a
scratch buffer; the row's last task to finish (a per-row counter) adds the
partials in task order, which is edge order, and finishes the row (mask,
add, flag).  The sum is therefore the same from run to run, with no float
atomics on ``acc``.

The tasks cover a row's edges in the order of its segments: K1's CSR has
one segment, a level of K2 has one per index bucket (``seg_degrees``), and
the task's bounds are offsets into the row's edges over all segments.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# Edges per task: the longest chain of row loads one warp walks.  The
# shortest tried measured fastest on the card (gather_probe's sweep).
TASK_EDGES = 128


class GatherSchedule(NamedTuple):
    tasks: torch.Tensor       # [T, 4] i32: row, first edge, end edge, slot
    #                           (edges are offsets into the row's edges;
    #                           slot -1 for a row that is one task)
    slot_row: torch.Tensor    # [P] i32: the split row (0..R-1) of each slot
    split_ptr: torch.Tensor   # [R + 1] i32: split row r owns slots
    #                           split_ptr[r]:split_ptr[r + 1]
    counters: torch.Tensor    # [R] i32: tasks of row r finished so far;
    #                           zero between launches (the last task resets
    #                           it), so one launch at a time per schedule
    n_rows: int
    task_edges: int

    @property
    def n_tasks(self) -> int:
        return self.tasks.shape[0]

    @property
    def n_slots(self) -> int:
        return self.slot_row.shape[0]

    @property
    def device(self) -> torch.device:
        return self.tasks.device


def degrees(indptr: torch.Tensor) -> torch.Tensor:
    """Row degrees of one CSR ([n+1] row pointers) or of the segments of
    one ([S, n+1], summed over the segments), as int64."""
    ptr = indptr.long()
    deg = ptr[..., 1:] - ptr[..., :-1]
    return deg if deg.dim() == 1 else deg.sum(dim=0)


def gather_schedule(indptr: torch.Tensor,
                    task_edges: int = TASK_EDGES) -> GatherSchedule:
    """The tasks of a CSR by destination (``indptr`` [n+1], or [S, n+1]
    for S segments whose rows are concatenated), on ``indptr``'s
    device."""
    if task_edges < 1:
        raise ValueError(f"task_edges must be positive, got {task_edges}")
    deg = degrees(indptr)
    dev = deg.device
    n = deg.shape[0]
    per_row = torch.clamp((deg + task_edges - 1) // task_edges, min=1)
    row = torch.repeat_interleave(torch.arange(n, device=dev), per_row)
    first = torch.cumsum(per_row, 0) - per_row
    k = torch.arange(row.shape[0], device=dev) - first[row]
    d, m = deg[row], per_row[row]
    lo, hi = k * d // m, (k + 1) * d // m     # even split, each <= task_edges
    split = m > 1
    slot = torch.full_like(row, -1)
    slot[split] = torch.arange(int(split.sum()), device=dev)
    split_sizes = per_row[per_row > 1]
    R = split_sizes.shape[0]
    split_ptr = torch.zeros(R + 1, dtype=torch.int64, device=dev)
    torch.cumsum(split_sizes, 0, out=split_ptr[1:])
    slot_row = torch.repeat_interleave(torch.arange(R, device=dev),
                                       split_sizes)
    tasks = torch.stack([row, lo, hi, slot], dim=1).to(torch.int32)
    return GatherSchedule(
        tasks=tasks.contiguous(), slot_row=slot_row.to(torch.int32),
        split_ptr=split_ptr.to(torch.int32),
        counters=torch.zeros(R, dtype=torch.int32, device=dev),
        n_rows=n, task_edges=int(task_edges))


# ---- the walk kernel (K4, csrc/walk.cu) -----------------------------------
#
# A warp owns a contiguous range of 32 k walks (k walks per lane); each lane
# runs one walk at a time and takes the range's next walk when its own ends.
# A larger k keeps more of a warp's lanes busy until its range is done, and
# leaves fewer warps.  The kernel is bound by its loads, not by idle lanes.
# The rule below follows the sweep of chip_smoke.py's phase 3 (K4 from one
# source and from the index build's starts, every k, 2^14 .. 2^23 walks) on
# the H100: from the index build's starts k = 4 is the fastest or within 3%
# of it at 2^21 .. 2^23 walks; at 2^18 walks and fewer every k takes the same
# few hundredths of a millisecond.  Its measured cost: from one source k = 8
# beats the rule's k = 4 by 9% at 2^20 walks (0.0823 against 0.0904 ms) and
# by 2% at 2^23, where k = 4 is 3% faster from the index build's starts.

WALK_BLOCK_WARPS = 8        # warps of a block (256 threads)
WALK_RESIDENT_WARPS = 64    # warps an SM holds at __launch_bounds__(256, 8)
WALKS_PER_LANE = 4          # k where the walks fill the card
WALKS_PER_LANE_MAX = 48     # a block's staged endpoints within 48 KiB


class WalkPlan(NamedTuple):
    walks_per_lane: int     # k
    warps: int              # warps that own walks: ceil(W / (32 k))
    blocks: int             # blocks of WALK_BLOCK_WARPS warps

    @property
    def range_walks(self) -> int:
        """Walks a warp owns."""
        return 32 * self.walks_per_lane

    def warp_range(self, warp: int, W: int) -> tuple:
        """Walks ``lo .. hi - 1`` of warp ``warp`` (block * 8 + warp in
        its block), as the kernel computes them; empty past the last."""
        lo = warp * self.range_walks
        return min(lo, W), min(lo + self.range_walks, W)


def walk_grid(W: int, walks_per_lane: int) -> WalkPlan:
    """The grid of warps that covers ``W`` walks (1 .. 2^32 - 1) at
    ``walks_per_lane`` (1 .. WALKS_PER_LANE_MAX) walks a lane."""
    if not 0 < W < 2**32:
        raise ValueError(f"walk_plan: W = {W} not in 1 .. 2^32 - 1")
    k = int(walks_per_lane)
    if not 1 <= k <= WALKS_PER_LANE_MAX:
        raise ValueError(f"walk_plan: walks_per_lane {k} not in 1 .. "
                         f"{WALKS_PER_LANE_MAX}")
    warps = -(-W // (32 * k))
    return WalkPlan(walks_per_lane=k, warps=warps,
                    blocks=-(-warps // WALK_BLOCK_WARPS))


def walk_plan(W: int, sm_count: int) -> WalkPlan:
    """K4's plan for ``W`` walks (1 .. 2^32 - 1) on a card of ``sm_count``
    SMs: the largest k of 1, 2, 4 (WALKS_PER_LANE) whose warps fill at
    least half of the card's resident warps, else 1, and its grid."""
    if not 0 < W < 2**32:
        raise ValueError(f"walk_plan: W = {W} not in 1 .. 2^32 - 1")
    if sm_count < 1:
        raise ValueError(f"walk_plan: sm_count = {sm_count}")
    half = sm_count * WALK_RESIDENT_WARPS // 2
    k = WALKS_PER_LANE
    while k > 1 and W < 32 * k * half:
        k //= 2
    return walk_grid(W, k)


# ---- K6+K4 (csrc/walk.cu, raw_walk_kernel) --------------------------------
#
# A warp owns a tile of one column: 32 k consecutive lane rows of the chunk.
# Tile j of column b is warp b * tiles + j of the grid.  k follows walk_plan's
# rule from RAW_WALKS_PER_LANE down (uniform hops; alias hops from K4's
# WALKS_PER_LANE), at the kernel's residency.  On the H100
# (probes/raw_walk_probe.py, phase 9's allocation of 196 M walks over 4
# shards): uniform hops took 15.57 ms at k = 16 against 18.28 at K4's 4,
# 16.17 at 8 and 15.65 at 32; on the weighted graph's allocation (188 M
# walks) alias hops took 37.50 ms at k = 4 against 38.97 at 8 and 40.59
# at 16.

RAW_WALKS_PER_LANE = 16     # k where uniform walks fill the card
RAW_BLOCKS_PER_SM = 6       # walk.cu's kRawBlocksPerSM, its __launch_bounds__
RAW_RESIDENT_WARPS = RAW_BLOCKS_PER_SM * WALK_BLOCK_WARPS   # warps an SM holds


class RawWalkPlan(NamedTuple):
    walks_per_lane: int     # k
    tiles: int              # warp tiles of a column: ceil(rows / (32 k))
    blocks: int             # blocks of WALK_BLOCK_WARPS warps over them all

    def tile_rows(self, tile: int, rows: int) -> tuple:
        """Rows ``lo .. hi - 1`` of a column's tile ``tile``."""
        lo = tile * 32 * self.walks_per_lane
        return min(lo, rows), min(lo + 32 * self.walks_per_lane, rows)


def _fill_k(work: int, k: int, blocks_per_sm: int, sm_count: int) -> int:
    """The largest k of k, k / 2, ..., 1 whose warps over ``work`` walks
    fill at least half of the card's resident warps, else 1."""
    half = sm_count * blocks_per_sm * WALK_BLOCK_WARPS // 2
    while k > 1 and work < 32 * k * half:
        k //= 2
    return k


def raw_walk_plan(rows: int, Bc: int, sm_count: int,
                  alias: bool = False) -> RawWalkPlan:
    """K6+K4's plan for a chunk of ``rows`` lane rows of ``Bc`` columns
    (rows * Bc in 1 .. 2^32 - 1) on a card of ``sm_count`` SMs: the
    largest k of 1, 2, 4, 8, 16 (RAW_WALKS_PER_LANE; with ``alias`` hops
    of 1, 2, 4, WALKS_PER_LANE) whose warps fill at least half of the
    card's resident warps, else 1; its tiles per column and the grid over
    the Bc columns' tiles."""
    if rows < 1 or Bc < 1 or rows * Bc >= 2**32:
        raise ValueError(f"raw_walk_plan: {rows} rows, {Bc} columns")
    if sm_count < 1:
        raise ValueError(f"raw_walk_plan: sm_count = {sm_count}")
    k = _fill_k(rows * Bc, WALKS_PER_LANE if alias else RAW_WALKS_PER_LANE,
                RAW_BLOCKS_PER_SM, sm_count)
    tiles = -(-rows // (32 * k))
    return RawWalkPlan(walks_per_lane=k, tiles=tiles,
                       blocks=-(-(tiles * Bc) // WALK_BLOCK_WARPS))


# ---- K6+K4-xp (csrc/walk.cu, xp_own_kernel and xp_inbox_kernel) ----------
#
# A launch runs one form.  The own-lane form (round 0) is K6+K4's plan over
# a process's own lanes: tile j of column b is warp b * tiles + j, k by
# raw_walk_plan's rule at the form's residency.  The inbox form (later
# rounds) gives each warp 32 k consecutive records, k by the same rule from
# XP_INBOX_WALKS_PER_LANE down at its own residency.  On the H100
# (probes/xp_walk_probe.py, the rounds after the first of the raw
# one-shot's first chunk over 2 processes): a largest k of 16 took 10.20 ms
# against 12.52 at 4, 10.95 at 8 and 10.22 at 32 (weighted, alias hops:
# 17.30 against 19.00, 18.04 and 17.43).

XP_OWN_BLOCKS_PER_SM = 4    # walk.cu's kXpOwnBlocksPerSM, its __launch_bounds__
XP_INBOX_BLOCKS_PER_SM = 4  # walk.cu's kXpInboxBlocksPerSM, its __launch_bounds__
XP_INBOX_WALKS_PER_LANE = 16    # k where the records fill the card


class XpWalkPlan(NamedTuple):
    own: RawWalkPlan        # tiles of a column's own lanes, blocks over Bc columns
    inbox: RawWalkPlan      # tiles: warps of 32 k records; blocks over them


def xp_walk_plan(extent: int, Bc: int, n_in: int, sm_count: int,
                 alias: bool = False) -> XpWalkPlan:
    """K6+K4-xp's plan for each form on a card of ``sm_count`` SMs: the
    own-lane form over ``extent`` own lane rows at most in a column of
    ``Bc`` (k of 1, 2, 4, 8, 16; alias 1, 2, 4: raw_walk_plan's rule at
    XP_OWN_BLOCKS_PER_SM), the inbox form over ``n_in`` records (k from
    XP_INBOX_WALKS_PER_LANE, alias hops too, down by the same rule at
    XP_INBOX_BLOCKS_PER_SM).  A form with no walk gets no block."""
    if extent < 0 or Bc < 0 or n_in < 0 or extent * Bc >= 2**32:
        raise ValueError(f"xp_walk_plan: {extent} rows, {Bc} columns, "
                         f"{n_in} records")
    if sm_count < 1:
        raise ValueError(f"xp_walk_plan: sm_count = {sm_count}")
    k = _fill_k(extent * Bc, WALKS_PER_LANE if alias else RAW_WALKS_PER_LANE,
                XP_OWN_BLOCKS_PER_SM, sm_count)
    tiles = -(-extent // (32 * k)) if Bc else 0
    own = RawWalkPlan(walks_per_lane=k, tiles=tiles,
                      blocks=-(-(tiles * Bc) // WALK_BLOCK_WARPS))
    k = _fill_k(n_in, XP_INBOX_WALKS_PER_LANE, XP_INBOX_BLOCKS_PER_SM,
                sm_count)
    tiles = -(-n_in // (32 * k))
    inbox = RawWalkPlan(walks_per_lane=k, tiles=tiles,
                        blocks=-(-tiles // WALK_BLOCK_WARPS))
    return XpWalkPlan(own=own, inbox=inbox)


# ---- K4-xp (csrc/walk.cu, index_xp_own_kernel and index_xp_inbox_kernel) -
#
# The build across processes runs its rounds over a window of whole chunks
# (``build_windows``): XP_BUILD_WALKS walks, rounded down to whole chunks of
# ``chunk_lanes`` and at least one, a constant that never reads the card's
# free memory.  Its bytes on a process: the window's ends, 4 B a walk (128
# MiB), its own starts, 4 B each, and round 0's outbox, P x own walks x 16
# B (at P = 2 and every walk its own, 1 GiB).  The own-start form (round 0)
# is K4's plan over the process's own starts of the window: k from
# WALKS_PER_LANE down by walk_plan's rule, at the form's residency; a
# warp's range (at most walk.cu's kWarpStage, 128 walks) fits its part of
# the stage, which holds every record the range hands on.  The inbox form
# (later rounds) is a grid of resident blocks, at most
# INDEX_XP_INBOX_BLOCKS_PER_SM an SM and no more than one warp a 32
# records, whose warps claim 32 k records at a time (``inbox_claim``: 32 k
# what is left over the warps, k 1 .. INDEX_XP_CLAIM_MAX; every warp's
# first claim its own, the later ones
# from a cursor) and go on into the next claim while the last walks of
# one run; the stage goes out whenever a step could overfill it.  On the
# H100 (probes/index_xp_probe.py on phase 15's build, PERF.md) the
# own-start form took about the same time at 4, 6 and 8 blocks an SM, the
# inbox form least at 4 (at 6 and 8 its drain, a call while walks are
# live, spills), larger claims less time (a claim of all that is left
# over the warps against a half and a quarter of it; 48 groups against 8
# and 16).

XP_BUILD_WALKS = 1 << 25    # walks of a window (phase 17's build is one)
INDEX_XP_BLOCKS_PER_SM = 8  # walk.cu's kIndexXpBlocksPerSM, its __launch_bounds__
INDEX_XP_INBOX_BLOCKS_PER_SM = 4    # walk.cu's kIndexXpInboxBlocksPerSM
INDEX_XP_CLAIM_MAX = 48     # the largest claim: 32 x 48 records


def chunk_divisor(chunk_lanes: int) -> tuple:
    """(magic, shift) with w // chunk_lanes == (w * magic) >> shift for
    every 0 <= w < 2^31 (chunk_lanes in 1 .. 2^31 - 1), magic below 2^32:
    K4-xp's division of a walk's number by its chunk's walks.  magic =
    ceil(2^(31 + l) / chunk_lanes), l = ceil(log2(chunk_lanes)), shift =
    31 + l (Granlund and Montgomery's multiplier for 31-bit numerators)."""
    if not 1 <= chunk_lanes < 2**31:
        raise ValueError(f"chunk_divisor: {chunk_lanes} walks a chunk")
    shift = 31 + (chunk_lanes - 1).bit_length()
    return -(-(1 << shift) // chunk_lanes), shift


def build_windows(total: int, chunk_lanes: int) -> list:
    """The windows (lo, hi) of a build of ``total`` walks in chunks of
    ``chunk_lanes``: whole chunks, max(1, XP_BUILD_WALKS // chunk_lanes) of
    them a window (the last may be short), covering 0 .. total - 1 once."""
    if total < 0 or chunk_lanes < 1:
        raise ValueError(f"build_windows: {total} walks, chunks of "
                         f"{chunk_lanes}")
    step = max(1, XP_BUILD_WALKS // chunk_lanes) * chunk_lanes
    return [(lo, min(lo + step, total)) for lo in range(0, total, step)]


class InboxPlan(NamedTuple):
    claim_max: int          # the largest claim, in 32-record groups
    warps: int              # the grid's warps
    blocks: int             # resident blocks of WALK_BLOCK_WARPS warps


class IndexXpPlan(NamedTuple):
    own: WalkPlan           # K4's grid over the own starts
    inbox: InboxPlan        # the resident grid over the records


def inbox_claim(seen: int, n_in: int, plan: InboxPlan) -> int:
    """The inbox form's next claim in records, as walk.cu's inbox_claim
    reads it after ``seen`` records were claimed: 32 k, 32 k the records
    left over the warps, k at least 1 and at most ``plan.claim_max``."""
    left = max(n_in - seen, 0)
    return 32 * max(1, min(left // (32 * plan.warps), plan.claim_max))


def inbox_claims(n_in: int, plan: InboxPlan) -> list:
    """The claims (first record, records) that the inbox form's warps make
    over ``n_in`` records: warp g's first claim records g * first ..
    (first = inbox_claim(0, ...), none past the records), then claims from
    the cursor past the first claims, taken in turn as the kernel's
    atomicAdd orders them: each warp's next claim reads the cursor, adds
    its claim, and stops at the first that starts past the records."""
    if n_in == 0:
        return []
    first = inbox_claim(0, n_in, plan)
    claims = [(g * first, min(first, n_in - g * first))
              for g in range(plan.warps) if g * first < n_in]
    cursor = plan.warps * first
    live = list(range(plan.warps))
    while live:
        nxt = []
        for w in live:
            step = inbox_claim(cursor, n_in, plan)
            base, cursor = cursor, cursor + step
            if base < n_in:
                claims.append((base, min(step, n_in - base)))
                nxt.append(w)
        live = nxt
    return claims


def index_xp_plan(W: int, n_in: int, sm_count: int) -> IndexXpPlan:
    """K4-xp's plan for each form on a card of ``sm_count`` SMs: the
    own-start form over ``W`` own starts (k of 1, 2, 4 by walk_plan's rule
    at INDEX_XP_BLOCKS_PER_SM), the inbox form over ``n_in`` records
    (resident blocks, a warp for each 32 records at most).  A form with no
    walk gets no block."""
    if not 0 <= W < 2**32 or not 0 <= n_in < 2**31:
        raise ValueError(f"index_xp_plan: {W} starts, {n_in} records")
    if sm_count < 1:
        raise ValueError(f"index_xp_plan: sm_count = {sm_count}")
    k = _fill_k(W, WALKS_PER_LANE, INDEX_XP_BLOCKS_PER_SM, sm_count)
    own = walk_grid(W, k) if W else WalkPlan(walks_per_lane=k, warps=0,
                                              blocks=0)
    blocks = min(sm_count * INDEX_XP_INBOX_BLOCKS_PER_SM,
                 -(-n_in // (32 * WALK_BLOCK_WARPS)))
    return IndexXpPlan(own=own, inbox=InboxPlan(
        claim_max=INDEX_XP_CLAIM_MAX, warps=blocks * WALK_BLOCK_WARPS,
        blocks=blocks))
