"""Forward push as batched masked SpMV supersteps on [n, B] state.

Port of ``fora_tpu/ops/push.py`` (36-47, 315-362, 374-450), dense path.
One superstep, with ``thr`` the per-node termination threshold
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


class PushState(NamedTuple):
    p: torch.Tensor   # [n, B] f32 settled mass
    r: torch.Tensor   # [n, B] f32 residue
    iters: int        # supersteps run by the last call


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


def node_threshold(graph: DeviceGraph, rmax: float,
                   thr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[n] f32 termination threshold: ``thr`` flattened, else
    rmax * out_deg in f32 (as JAX computes it)."""
    if thr is not None:
        return thr.reshape(-1).to(torch.float32)
    return graph.out_deg.to(torch.float32) * float(np.float32(rmax))


def forward_push_from(graph: DeviceGraph, state0: PushState, *, rmax: float,
                      alpha: float, max_iters: int = 200,
                      thr: Optional[torch.Tensor] = None) -> PushState:
    """Push from (p, r) until no entry of r exceeds its node's threshold or
    ``max_iters`` supersteps ran; ``iters`` counts this call's supersteps.

    ``thr`` ([n] or [n, 1], optional) overrides ``rmax * out_deg`` (the
    per-node coverage threshold count_v / omega_unit of the indexed path).
    ``state0.p``/``state0.r`` are advanced in place.
    """
    thr = node_threshold(graph, rmax, thr)
    p, r = state0.p, state0.r
    contrib = torch.empty_like(r)
    flag = torch.zeros(1, dtype=torch.int32, device=r.device)
    wsum = out_weight(graph)
    state = PushState(p=p, r=r, iters=0)
    more = bool((r > thr[:, None]).any())
    while state.iters < max_iters and more:
        flag.zero_()
        state = superstep(graph, state, alpha=alpha, thr=thr,
                          contrib=contrib, flag=flag, wsum=wsum)
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
