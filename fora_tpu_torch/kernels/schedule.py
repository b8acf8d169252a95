"""The work list of the destination-row gather (K1, K2): edge-balanced
tasks built once per CSR from its row degrees.

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
