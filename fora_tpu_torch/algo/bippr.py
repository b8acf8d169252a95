"""BiPPR: the bidirectional PPR competitor (reference ``--algo bippr``).

Port of ``fora_tpu/algo/bippr.py``, whose docstring derives the estimator
(Lofgren et al.):

  pi_hat(s, t) = p_t(s) + (1/W) * sum_w r_t(endpoint_w),

with (p_t, r_t) from a backward push from each target t down to ``rmax_b``
and W forward walks from s.  Dangling nodes absorb: backward push settles
a dangling node's whole residue and spreads it with (1 - alpha) / alpha.

The backward superstep is a forward superstep on the out-CSR: the
elementwise half is its own kernel (K1-back pre-pass,
``kernels.backward_prepass``), and edge u -> v carrying spread[v] *
w(u, v) / W(u) back to u, summed per u in out-CSR order, is K1's gather
with ``indptr = out_indptr``, ``src = out_indices``, ``edge_w`` that
per-edge factor, ``thr = rmax_b`` on every row, the mask on, and the
flag as the loop's exit (``DeviceGraph.out_sched`` is its work list).
The walk term is not gathered as JAX's ``st.r[ends, :]``, a [W, S, T]
array (4.3 GB at the bench's scale): it is (1/W) C r with C the [S, n]
endpoint histogram, a CSR by source with counts as edge weights, so K1's
gather again.  ``make_bippr_fn`` pushes once per target set and keeps
the state, where JAX's pushes again at every call.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import kernels
from ..config import ResolvedConfig
from ..graph.csr import DeviceGraph, out_schedule
from ..ops.gather import gather_scatter_add
from ..ops.walk import derive_seed, walk_endpoints
from .montecarlo import source_chunks


class BackwardPushState(NamedTuple):
    p: torch.Tensor   # [n, T] f32, settled pi(., t) lower estimates
    r: torch.Tensor   # [n, T] f32, backward residues
    iters: int        # supersteps run


def backward_prepass_plain(p, r, spread, rmax_b: float, deg,
                           alpha: float) -> None:
    """Plain version of the K1-back pre-pass (the f32 arithmetic of
    ``fora_tpu``'s ``backward_push`` body, 67-72)."""
    f32 = dict(dtype=torch.float32, device=r.device)
    ar = torch.where(r > torch.tensor(rmax_b, **f32), r, 0.0)
    dangling = (deg == 0)[:, None]
    p += torch.where(dangling, ar, torch.tensor(alpha, **f32) * ar)
    spread.copy_(torch.where(
        dangling, torch.tensor((1.0 - alpha) / alpha, **f32) * ar,
        torch.tensor(1.0 - alpha, **f32) * ar))


def backward_prepass(p, r, spread, rmax_b: float, deg, alpha: float) -> None:
    """In place: ``p`` += the settled mass of the entries over ``rmax_b``,
    ``spread`` = what they send back along their in-edges."""
    if r.device.type == "cpu":
        backward_prepass_plain(p, r, spread, rmax_b, deg, alpha)
    else:
        kernels.backward_prepass(p, r, spread, rmax_b, deg, alpha)


def backward_edge_weights(graph: DeviceGraph) -> torch.Tensor:
    """[m] f32 per-edge factor in out-CSR order: w(u, v) / W(u) on a
    weighted graph, 1 / out_deg(u) otherwise (JAX's ``inv_deg_edge``)."""
    src = torch.repeat_interleave(
        torch.arange(graph.n, device=graph.device), graph.out_deg.long())
    if graph.weighted:
        return graph.out_w / graph.out_wsum[src].clamp_min(1e-30)
    return 1.0 / graph.out_deg.to(torch.float32)[src].clamp_min(1.0)


def backward_superstep(graph: DeviceGraph, st: BackwardPushState, *,
                       rmax_b: float, alpha: float, thr, spread, edge_w,
                       flag=None) -> BackwardPushState:
    """One backward superstep, in place on ``st.p``/``st.r``: the pre-pass,
    then ``r = where(active, 0, r) + sum_{u -> v} edge_w * spread[v]`` per
    row u by K1's gather over the out-CSR; ``flag`` is set where a residue
    ends over ``rmax_b``."""
    backward_prepass(st.p, st.r, spread, rmax_b, graph.out_deg, alpha)
    sched = None if st.r.device.type == "cpu" else out_schedule(graph)
    gather_scatter_add(st.r, spread, graph.out_indptr, graph.out_indices,
                       edge_w=edge_w, thr=thr, mask=True, flag=flag,
                       sched=sched)
    return BackwardPushState(st.p, st.r, st.iters + 1)


def backward_push(graph: DeviceGraph, targets, *, rmax_b: float,
                  alpha: float, max_iters: int = 500) -> BackwardPushState:
    """Batched reverse push from each target (one column each) until no
    residue exceeds ``rmax_b`` or ``max_iters`` supersteps ran; the
    invariant pi(s, t) = p_t(s) + sum_v pi(s, v) r_t(v) holds at every
    superstep."""
    dev = graph.device
    tgt = torch.as_tensor(targets, dtype=torch.long, device=dev)
    n, T = graph.n, tgt.shape[0]
    r = torch.zeros((n, T), dtype=torch.float32, device=dev)
    r[tgt, torch.arange(T, device=dev)] = 1.0
    st = BackwardPushState(torch.zeros_like(r), r, 0)
    thr = torch.full((n,), rmax_b, dtype=torch.float32, device=dev)
    spread = torch.empty_like(r)
    edge_w = backward_edge_weights(graph)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    more = bool((r > thr[:, None]).any())
    while st.iters < max_iters and more:
        flag.zero_()
        st = backward_superstep(graph, st, rmax_b=rmax_b, alpha=alpha,
                                thr=thr, spread=spread, edge_w=edge_w,
                                flag=flag)
        more = bool(flag.item())   # one 4-byte device -> host read
    return st


def default_bippr_params(rcfg: ResolvedConfig) -> tuple:
    """Balanced (rmax_b, num_walks), as ``fora_tpu``'s (85-97): equating
    backward-push cost (m/n)/rmax_b with walk cost c0 rmax_b /
    (eps^2 delta) gives rmax_b = eps sqrt(delta m / (n c0))."""
    c0 = (2.0 * rcfg.epsilon / 3.0 + 2.0) * math.log(2.0 / rcfg.pfail)
    rmax_b = rcfg.epsilon * math.sqrt(
        rcfg.delta * rcfg.m / (rcfg.n * c0))
    num_walks = max(64, int(c0 * rmax_b /
                            (rcfg.epsilon ** 2 * rcfg.delta)))
    return rmax_b, num_walks


def add_walk_term(acc: torch.Tensor, r: torch.Tensor, ends: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """``acc[s] += scale * sum_w r[ends[w, s]]`` for ``ends`` [W, S]: the
    endpoint counts of each column as a CSR by column (row s, sources the
    distinct endpoints, weights their counts times ``scale``), gathered
    from ``r`` [n, T] by K1's gather on a card.  Returns ``acc`` [S, T]."""
    n = r.shape[0]
    S = ends.shape[1]
    col = torch.arange(S, device=ends.device)[None, :]
    keys, counts = torch.unique(col * n + ends.long(), return_counts=True)
    row = keys // n
    indptr = torch.zeros(S + 1, dtype=torch.long, device=ends.device)
    torch.cumsum(torch.bincount(row, minlength=S), 0, out=indptr[1:])
    return gather_scatter_add(
        acc, r, indptr.to(torch.int32), (keys % n).to(torch.int32),
        edge_w=counts.to(torch.float32) * float(scale))


def walk_term(graph: DeviceGraph, r: torch.Tensor, sources: torch.Tensor,
              seed: int, *, alpha: float, max_hops: int, num_walks: int,
              walk=walk_endpoints) -> torch.Tensor:
    """[S, T] (1/W) sum over W walks from each source of r at the walk's
    endpoint, the walks in the chunks of ``montecarlo.source_chunks``
    (chunk i from ``derive_seed(seed, i)``); ``walk(graph, start, seed,
    alpha, max_hops)`` runs one chunk's walks."""
    S = sources.shape[0]
    acc = torch.zeros((S, r.shape[1]), dtype=torch.float32, device=r.device)
    for i, w in enumerate(source_chunks(num_walks, S, r.device)):
        ends = walk(graph, sources.repeat(w), derive_seed(seed, i), alpha,
                    max_hops)
        add_walk_term(acc, r, ends.view(w, S), 1.0 / num_walks)
    return acc


def bippr_pairs(graph: DeviceGraph, sources, targets, seed: int, *,
                rcfg: ResolvedConfig, rmax_b: float, num_walks: int,
                state: BackwardPushState = None) -> torch.Tensor:
    """Estimate pi(s_i, t_j) for all source/target pairs: [S, T] f32.
    ``state`` is the targets' backward push when the caller has it."""
    st = state if state is not None else backward_push(
        graph, targets, rmax_b=rmax_b, alpha=rcfg.alpha)
    src = torch.as_tensor(sources, dtype=torch.int32, device=graph.device)
    return st.p[src.long()] + walk_term(
        graph, st.r, src, seed, alpha=rcfg.alpha,
        max_hops=rcfg.max_walk_hops, num_walks=num_walks)


def make_bippr_fn(graph: DeviceGraph, rcfg: ResolvedConfig, targets,
                  rmax_b: float = None, num_walks: int = None,
                  lane_cap: int = 1 << 22):
    """``(sources, seed) -> [S, T]`` pair estimates against a fixed target
    set (the reference's ``--algo bippr`` surface).  The backward push
    runs at the first call and is kept (``fn.state``)."""
    if rmax_b is None or num_walks is None:
        d_rmax_b, d_walks = default_bippr_params(rcfg)
        rmax_b = d_rmax_b if rmax_b is None else rmax_b
        num_walks = d_walks if num_walks is None else num_walks
    num_walks = min(num_walks, lane_cap)
    tgt = torch.as_tensor(targets, dtype=torch.int32, device=graph.device)

    def fn(sources, seed):
        if fn.state is None:
            fn.state = backward_push(graph, tgt, rmax_b=rmax_b,
                                     alpha=rcfg.alpha)
        return bippr_pairs(graph, sources, tgt, seed, rcfg=rcfg,
                           rmax_b=rmax_b, num_walks=num_walks,
                           state=fn.state)

    fn.rmax_b, fn.num_walks, fn.state = rmax_b, num_walks, None
    return fn
