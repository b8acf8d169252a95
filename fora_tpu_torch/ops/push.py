"""Forward push as batched masked SpMV supersteps on [n, B] state.

Port of ``fora_tpu/ops/push.py`` (36-47, 283-450).  One superstep, with
``thr`` the per-node termination threshold
(``rmax * out_deg`` by default):

    active  = r > thr                       (dangling: active iff r > thr = 0)
    p      += active ? (dangling ? r : alpha r) : 0
    contrib = active and not dangling ? (1 - alpha) r / out_deg : 0
    r       = (active ? 0 : r) + sum_{u -> v} w_e contrib[u]

It is two launches on the device: the elementwise pre-pass (K1 pre-pass,
``kernels/csrc/push_prepass.cu``) and the destination-row gather (K1,
``ops.gather.gather_scatter_add``), which also masks the old residue and
raises a 4-byte "some row is still over its threshold" flag.  With the hub
split the gather is two launches: the tail edges (masking) and the hub
edges from the compact ``contrib[hub_ids]`` operand (flagging).  The host
reads the flag once per superstep.

The frontier-compacted push (``forward_push_from(compact_edges=)``, JAX's
``active_edge_segment_sum`` branch) drives a superstep from the rows that
push instead: K5's pre-pass (``kernels/csrc/frontier_push.cu``) computes
the same ``p`` and ``contrib``, masks ``r`` and lists the active rows'
out-edge ranges as tasks (row, first edge, mask of the row's non-zero
chunks, edges), and K5 adds each active row's non-zero chunks of
``contrib`` into ``r`` along its out-edges; a superstep whose active
out-edges exceed the cap takes K1's gather over every in-edge instead.
The next superstep's pre-pass runs right after a superstep and reports
[any active entry, active out-edges, tasks] in one read.  Only a graph
without ``in_w`` (not merged, not weighted) and without the hub split
compacts, as in JAX.

The port updates ``p`` and ``r`` IN PLACE where JAX donated them: a
caller's state tensors hold the advanced state after the call.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import kernels
from ..graph.csr import DeviceGraph
from .gather import gather_scatter_add

TASK_EDGES = 1024   # out-edges of one K5 task: a hub row spreads over warps
TASK_FIELDS = 4     # a K5 task: (row, first edge, mask, edges), int32


class PushState(NamedTuple):
    p: torch.Tensor   # [n, B] f32 settled mass
    r: torch.Tensor   # [n, B] f32 residue
    iters: int        # supersteps run by the last call


class SuperstepCounts:
    """Supersteps that :func:`forward_push_from` ran, by path: ``compacted``
    took K5 (the active rows' out-edges), ``dense`` K1's gather over every
    in-edge (every superstep of a push without ``compact_edges``, and those
    of a compacted push whose active out-edges exceeded the cap).  Host
    integers, like ``FrontierExchange.compacted`` / ``fell_back``."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.compacted = 0
        self.dense = 0


superstep_counts = SuperstepCounts()


def init_state(n: int, sources: torch.Tensor) -> PushState:
    """One-hot residue at each query's source. sources: [B] int."""
    B = sources.shape[0]
    dev = sources.device
    r = torch.zeros((n, B), dtype=torch.float32, device=dev)
    r[sources.long(), torch.arange(B, device=dev)] = 1.0
    return PushState(p=torch.zeros_like(r), r=r, iters=0)


def push_prepass_plain(p, r, contrib, thr, deg, wsum, alpha: float) -> None:
    """Plain version of the K1 pre-pass (same f32 arithmetic as JAX)."""
    active = r > thr[:, None]
    ar = torch.where(active, r, 0.0)
    dangling = (deg == 0)[:, None]
    p += torch.where(dangling, ar, alpha * ar)
    contrib.copy_(torch.where(dangling, 0.0,
                              (1.0 - alpha) * ar
                              / wsum.clamp_min(1e-30)[:, None]))


def push_prepass(p, r, contrib, thr, deg, wsum, alpha: float) -> None:
    """In place: ``p`` += the absorbed mass of the active entries,
    ``contrib`` = what each active row sends down one unit of
    out-weight."""
    if r.device.type == "cpu":
        push_prepass_plain(p, r, contrib, thr, deg, wsum, alpha)
    else:
        kernels.push_prepass(p, r, contrib, thr, deg, wsum, alpha)


def out_weight(graph: DeviceGraph) -> torch.Tensor:
    """Per-node total out-weight W(v): out_deg as f32 when unweighted."""
    if graph.out_wsum is not None:
        return graph.out_wsum
    return graph.out_deg.to(torch.float32)


def superstep(graph: DeviceGraph, state: PushState, *, alpha: float,
              thr: torch.Tensor, contrib: Optional[torch.Tensor] = None,
              flag: Optional[torch.Tensor] = None,
              wsum: Optional[torch.Tensor] = None) -> PushState:
    """One superstep, in place on ``state.p``/``state.r``.  ``contrib``
    ([n, B] f32) is scratch the caller may reuse across supersteps;
    ``flag`` (int32 [1]) is set to 1 if some entry of the new residue is
    over its threshold."""
    p, r = state.p, state.r
    if contrib is None:
        contrib = torch.empty_like(r)
    if wsum is None:
        wsum = out_weight(graph)
    push_prepass(p, r, contrib, thr, graph.out_deg, wsum, alpha)
    hub = graph.hub_split
    gather_scatter_add(r, contrib, graph.in_indptr, graph.in_src,
                       edge_w=graph.in_w, thr=thr, mask=True,
                       flag=None if hub else flag, sched=graph.in_sched)
    if hub:
        # hub edges read the compact [H, B] operand (one shared-index take)
        gather_scatter_add(r, contrib.index_select(0, graph.hub_ids),
                           graph.hub_indptr, graph.hub_src_local,
                           edge_w=graph.hub_w, thr=thr, flag=flag,
                           sched=graph.hub_sched)
    return PushState(p=p, r=r, iters=state.iters + 1)


def task_rows(n: int, m: int, task_edges: int = TASK_EDGES) -> int:
    """Room a task list needs: every row one task, and one more for each
    ``task_edges`` of the ``m`` out-edges."""
    return n + m // task_edges + 1


def mask_span(B: int) -> int:
    """Columns one bit of a task's mask covers (``frontier_push.cu``'s
    ``mask_span``): a float4 chunk where B is a multiple of 4, else one
    column, times as many as 32 bits need to cover a row of B."""
    unit = 4 if B % 4 == 0 else 1
    return -(-(B // unit) // 32) * unit


def chunk_masks(contrib: torch.Tensor) -> torch.Tensor:
    """[n] int32: bit i of row v set where ``contrib[v, i * span:(i + 1) *
    span]`` (``span = mask_span(B)``) holds a non-zero."""
    n, B = contrib.shape
    span = mask_span(B)
    bits = -(-B // span)
    nz = torch.zeros((n, bits * span), dtype=torch.bool, device=contrib.device)
    nz[:, :B] = contrib.ne(0)
    weight = torch.ones(bits, dtype=torch.int64, device=contrib.device) \
        << torch.arange(bits, device=contrib.device)
    m = (nz.view(n, bits, span).any(2).long() * weight).sum(1)
    return (m - (m >= 2**31).long() * 2**32).to(torch.int32)


def frontier_prepass_plain(p, r, contrib, thr, deg, indptr, wsum,
                           alpha: float, tasks, status,
                           task_edges: int = TASK_EDGES) -> None:
    """Plain version of K5's pre-pass: K1's pre-pass, ``r``'s active entries
    set to 0, the tasks (row, first, mask, edges) of the rows with a
    non-zero ``contrib`` in row order (``edges`` out-edges of the row from
    ``first``, one task for each ``task_edges`` of the ``deg[row]`` from
    ``indptr[row]``; ``mask`` the row's :func:`chunk_masks`), and
    ``status`` = [any entry active, their out-edges, tasks]."""
    active = r > thr[:, None]
    push_prepass_plain(p, r, contrib, thr, deg, wsum, alpha)
    r.masked_fill_(active, 0.0)
    rows = contrib.ne(0).any(dim=1).nonzero()[:, 0]
    d = deg[rows].long()
    k = (d + task_edges - 1) // task_edges
    nt = int(k.sum())
    first = torch.cumsum(k, 0) - k
    j = (torch.arange(nt, device=r.device) - first.repeat_interleave(k))
    tasks[:nt, 0] = rows.repeat_interleave(k).to(tasks.dtype)
    tasks[:nt, 1] = (indptr[rows].long().repeat_interleave(k)
                     + j * task_edges).to(tasks.dtype)
    tasks[:nt, 2] = chunk_masks(contrib[rows]).repeat_interleave(k)
    tasks[:nt, 3] = (d.repeat_interleave(k) - j * task_edges).clamp_max(
        task_edges).to(tasks.dtype)
    status.copy_(torch.stack([active.any().long(), d.sum(),
                              torch.tensor(nt, device=r.device)]))


def frontier_prepass(p, r, contrib, thr, deg, indptr, wsum, alpha: float,
                     tasks, status, n_edges: int,
                     task_edges: int = TASK_EDGES) -> None:
    """K5's pre-pass in place (see :func:`frontier_prepass_plain`; ``deg``
    and ``indptr`` the out-CSR's) into ``tasks`` ([>= task_rows(n,
    n_edges), TASK_FIELDS] int32); the kernel lists the tasks in an order
    that varies from run to run."""
    if r.device.type == "cpu":
        frontier_prepass_plain(p, r, contrib, thr, deg, indptr, wsum, alpha,
                               tasks, status, task_edges)
    else:
        kernels.frontier_prepass(p, r, contrib, thr, deg, indptr, wsum,
                                 alpha, tasks, status, task_edges, n_edges)


def active_edge_segment_sum_plain(r, contrib, in_src, in_dst,
                                  row_active) -> torch.Tensor:
    """Plain version of K5 (JAX's ``active_edge_segment_sum`` on the
    compacted edges): the in-edges whose source row is active, in
    destination order, summed into a zero delta by ``index_add_``, then
    added to the masked residue ``r`` in place."""
    sel = row_active[in_src.long()]
    src, dst = in_src[sel].long(), in_dst[sel].long()
    delta = torch.zeros_like(r).index_add_(0, dst, contrib[src])
    return r.add_(delta)


def frontier_push(graph: DeviceGraph, r, contrib, tasks,
                  n_tasks: int) -> None:
    """K5 in place: ``r`` += the active rows' ``contrib`` along their
    out-edges, for the first ``n_tasks`` tasks of the pre-pass (the kernel
    adds the chunks the tasks' masks name, the others being zero).  On the
    CPU the plain version over the tasks' rows."""
    if n_tasks == 0:
        return
    if r.device.type == "cpu":
        row_active = torch.zeros(graph.n, dtype=torch.bool)
        row_active[tasks[:n_tasks, 0].long()] = True
        active_edge_segment_sum_plain(r, contrib, graph.in_src, graph.in_dst,
                                      row_active)
    else:
        kernels.frontier_push(r, contrib, tasks, n_tasks, graph.out_indices)


def default_edge_cap(m: int, frac: float = 0.25,
                     min_edges: int = 1 << 16) -> int:
    """Capacity of the frontier-compacted push (JAX's, ``push.py:365``);
    0 (never compact) for graphs small enough that the dense superstep is
    already trivial."""
    if m <= min_edges:
        return 0
    return max(min_edges, int(m * frac) // 8 * 8)


def edge_cap(graph: DeviceGraph, compact_edges: int) -> int:
    """The cap a push uses: ``compact_edges`` (-1: ``default_edge_cap``),
    0 where it covers every in-edge or where the graph cannot compact (a
    merged or weighted graph carries ``in_w``; the hub split), as JAX's
    ``forward_push_from`` and ``_superstep`` decide."""
    m = graph.m_in
    cap = default_edge_cap(m) if compact_edges < 0 else compact_edges
    if cap >= m or graph.in_w is not None or graph.hub_split:
        return 0
    return cap


def _push_compacted(graph: DeviceGraph, p, r, thr, alpha: float,
                    max_iters: int, e_cap: int) -> int:
    """The superstep loop of a compacted push; returns its supersteps."""
    contrib = torch.empty_like(r)
    wsum = out_weight(graph)
    tasks = torch.empty((task_rows(graph.n, graph.m), TASK_FIELDS),
                        dtype=torch.int32, device=r.device)
    status = torch.zeros(3, dtype=torch.int32, device=r.device)

    def prepass():
        frontier_prepass(p, r, contrib, thr, graph.out_deg, graph.out_indptr,
                         wsum, alpha, tasks, status, graph.m)
        return status.tolist()   # one 12-byte device -> host read

    iters = 0
    more, edges, n_tasks = prepass() if max_iters > 0 else (0, 0, 0)
    while more:
        if edges <= e_cap:
            frontier_push(graph, r, contrib, tasks, n_tasks)
            superstep_counts.compacted += 1
        else:
            # r is masked already: K1 adds every in-edge's row into it
            gather_scatter_add(r, contrib, graph.in_indptr, graph.in_src,
                               sched=graph.in_sched)
            superstep_counts.dense += 1
        iters += 1
        if iters >= max_iters:
            break
        more, edges, n_tasks = prepass()
    return iters


def node_threshold(graph: DeviceGraph, rmax: float,
                   thr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[n] f32 termination threshold: ``thr`` flattened, else
    rmax * out_deg in f32 (as JAX computes it)."""
    if thr is not None:
        return thr.reshape(-1).to(torch.float32)
    return graph.out_deg.to(torch.float32) * float(np.float32(rmax))


def forward_push_from(graph: DeviceGraph, state0: PushState, *, rmax: float,
                      alpha: float, max_iters: int = 200,
                      thr: Optional[torch.Tensor] = None,
                      compact_edges: int = 0) -> PushState:
    """Push from (p, r) until no entry of r exceeds its node's threshold or
    ``max_iters`` supersteps ran; ``iters`` counts this call's supersteps.

    ``thr`` ([n] or [n, 1], optional) overrides ``rmax * out_deg`` (the
    per-node coverage threshold count_v / omega_unit of the indexed path).
    ``compact_edges``: the cap of the frontier-compacted superstep (0, the
    default: always dense; -1: ``default_edge_cap(m_in)``); a superstep
    whose active rows have at most that many out-edges takes K5, the
    others K1's gather.  A cap of at least ``m_in``, and any cap on a graph
    with ``in_w`` (merged or weighted) or the hub split, means dense.  The
    two paths differ only in the order of float additions.
    ``superstep_counts`` counts the supersteps by path.
    ``state0.p``/``state0.r`` are advanced in place.
    """
    thr = node_threshold(graph, rmax, thr)
    p, r = state0.p, state0.r
    e_cap = edge_cap(graph, compact_edges)
    if e_cap > 0:
        return PushState(p=p, r=r, iters=_push_compacted(
            graph, p, r, thr, alpha, max_iters, e_cap))
    contrib = torch.empty_like(r)
    flag = torch.zeros(1, dtype=torch.int32, device=r.device)
    wsum = out_weight(graph)
    state = PushState(p=p, r=r, iters=0)
    more = bool((r > thr[:, None]).any())
    while state.iters < max_iters and more:
        flag.zero_()
        state = superstep(graph, state, alpha=alpha, thr=thr,
                          contrib=contrib, flag=flag, wsum=wsum)
        superstep_counts.dense += 1
        more = bool(flag.item())   # one 4-byte device -> host read
    return state


def forward_push(graph: DeviceGraph, sources: torch.Tensor, *, rmax: float,
                 alpha: float, max_iters: int = 200) -> PushState:
    """Push from one-hot sources until r <= rmax * out_deg everywhere."""
    return forward_push_from(graph, init_state(graph.n, sources), rmax=rmax,
                             alpha=alpha, max_iters=max_iters)


def push_only_estimate(graph: DeviceGraph, sources: torch.Tensor, *,
                       rmax: float, alpha: float,
                       max_iters: int = 200) -> torch.Tensor:
    """Forward-push baseline (reference ``--algo fwdpush``): p alone."""
    return forward_push(graph, sources, rmax=rmax, alpha=alpha,
                        max_iters=max_iters).p
