"""HubPPR: the hub-indexed Monte Carlo competitor (reference ``--algo
hubppr``; Wang et al., VLDB 2016).

Port of ``fora_tpu/algo/hubppr.py``, whose docstring gives the algorithm:
a forward hub index holds, for the H highest-degree nodes, P endpoints of
alpha-walks from each; a query walk that arrives at a hub ends at one
uniformly drawn entry of that hub's pool (memorylessness keeps the
endpoint distribution), never at hop 0.  ``hub_walks`` runs on K4's hub
branch on a card (``kernels.index_walk_hub``: after every hop a
``hub_id`` lookup, and at a hub one pool read) and on the lockstep
``hub_walks_plain`` on the CPU.  ``hubppr_query`` runs a chunk's walks and
their endpoint frequencies through ``ops.walk.source_walk_chunk``: on a
card one launch of K6+K4-src's hub branch (the same hops and pool draws,
no [W, B] array), on the CPU ``hub_walks`` and the plain accumulate.

On a weighted graph the query walk takes the alias hop, as the pool's
walks do: the JAX function hops uniformly there while its pool follows
w/W (ROADMAP C14), so its weighted estimate mixes two chains; the port's
is held to the weighted oracle.  The queries' walks and the pool's run in
chunks of a constant lane count, as Monte Carlo's do.  The default pool holds
as many entries as a query walks, up to ``POOL_BYTES`` for all hubs,
where the JAX function stops at 2^15 (ROADMAP C15): walks that reach a
hub share its pool's entries, and at 2^22 walks a query against 2^15
entries the estimate's error grows well past Monte Carlo's.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import kernels
from ..config import ResolvedConfig
from ..graph.csr import DeviceGraph
from ..ops.walk import (chunk_lanes, derive_seed, geometric_lengths,
                        source_walk_chunk, walk_endpoints)
from .bippr import backward_push, walk_term
from .montecarlo import source_chunks

# the default pool's device memory: 256 hubs x 2^22 entries
POOL_BYTES = 1 << 32


class HubIndex(NamedTuple):
    """Forward hub index (tensors on the graph's device): ``hub_id[v]`` is
    v's row in ``pool`` or -1; ``pool[h, j]`` is the endpoint of the j-th
    precomputed alpha-walk from hub h."""

    hub_nodes: torch.Tensor   # [H] i32 node id of each hub
    hub_id: torch.Tensor      # [n] i32 hub slot of node v, or -1
    pool: torch.Tensor        # [H, P] i32 precomputed walk endpoints

    @property
    def num_hubs(self) -> int:
        return self.pool.shape[0]

    @property
    def pool_size(self) -> int:
        return self.pool.shape[1]


def select_hubs(out_deg: np.ndarray, in_deg: np.ndarray,
                num_hubs: int) -> np.ndarray:
    """Top-H nodes by total degree, dangling nodes excluded (a walk there
    is already finished); sorted int32, as ``fora_tpu``'s (70-84)."""
    score = out_deg.astype(np.int64) + in_deg.astype(np.int64)
    score = np.where(out_deg > 0, score, -1)
    h = min(num_hubs, int((out_deg > 0).sum()))
    hubs = np.argpartition(-score, h - 1)[:h]
    return np.sort(hubs).astype(np.int32)


def graph_in_degree(graph: DeviceGraph) -> np.ndarray:
    """The in-degree ``fora_tpu``'s ``build_hub_index`` (93-105) selects
    by: in-edges counted with their ``in_w`` (a merged graph's
    multiplicity; a weighted graph's weight), the hub partition's too,
    truncated to int64."""
    def count(dst, w):
        return np.bincount(dst.cpu().numpy(),
                           weights=None if w is None else w.cpu().numpy(),
                           minlength=graph.n).astype(np.int64)
    in_deg = count(graph.in_dst, graph.in_w)
    if graph.hub_split:
        in_deg += count(graph.hub_dst, graph.hub_w)
    return in_deg


def build_hub_index(graph: DeviceGraph, seed: int, *, alpha: float,
                    num_hubs: int = 256, pool_size: int = 4096,
                    max_hops: int = 64,
                    in_deg: Optional[np.ndarray] = None) -> HubIndex:
    """Select the hubs and run ``pool_size`` alpha-walks from each (K4, or
    its alias branch on a weighted graph), :func:`pool_chunk_hubs` hubs
    per launch; chunk i from ``derive_seed(seed, i)``."""
    dev = graph.device
    if in_deg is None:
        in_deg = graph_in_degree(graph)
    hubs = select_hubs(graph.out_deg.cpu().numpy(), np.asarray(in_deg),
                       num_hubs)
    H = len(hubs)
    hub_id = np.full(graph.n, -1, np.int32)
    hub_id[hubs] = np.arange(H, dtype=np.int32)
    hubs_t = torch.as_tensor(hubs, device=dev)
    pool = torch.empty((H, pool_size), dtype=torch.int32, device=dev)
    per = pool_chunk_hubs(pool_size, dev)
    for ci, lo in enumerate(range(0, H, per)):
        hs = hubs_t[lo: lo + per]
        c = hs.shape[0]
        ends = walk_endpoints(graph, hs.repeat(pool_size),
                              derive_seed(seed, ci), alpha, max_hops)
        pool[lo: lo + c] = ends.view(pool_size, c).T
    return HubIndex(hub_nodes=hubs_t,
                    hub_id=torch.as_tensor(hub_id, device=dev), pool=pool)


def pool_chunk_hubs(pool_size: int, device) -> int:
    """Hubs whose pools one launch of the pool build walks on ``device``:
    ``ops.walk.chunk_lanes(device) // pool_size`` (at least one), as the
    reference's ``hub_chunk = (1 << 22) // pool_size``; a constant of the
    device's type, never of its free memory."""
    return max(1, chunk_lanes(device) // max(pool_size, 1))


def default_pool_size(rcfg: ResolvedConfig, num_walks: int,
                      num_hubs: int) -> int:
    """Pool sized so the variance inflation (1 + U/P) stays below ~2 even
    if every query walk finished at one hub: P >= num_walks, capped where
    ``num_hubs`` pools of P int32 entries would pass ``POOL_BYTES``.  The
    JAX function caps P at 2^15 whatever the card holds, which at 2^22
    walks a query gives up its own rule (ROADMAP C15); the port never caps
    below that, so up to 2^15 walks both give the same P."""
    cap = max(1 << 15, 1 << int(math.log2(max(POOL_BYTES // (4 * num_hubs),
                                              1))))
    return max(1024, min(cap, 1 << math.ceil(math.log2(max(num_walks, 2)))))


def hub_walks_plain(graph: DeviceGraph, start: torch.Tensor, hub: HubIndex,
                    *, generator: torch.Generator, alpha: float,
                    max_hops: int = 64) -> torch.Tensor:
    """Plain version of the hub walk: ``ops.walk.run_walks``'s lockstep
    hops (alias hops where the graph has tables), then, for the walks that
    took hop h and landed on a hub, one uniform pool entry that ends the
    walk.  Endpoints, int32, shaped as ``start``."""
    length = geometric_lengths(start.shape, alpha, max_hops,
                               generator=generator)
    deg = graph.out_deg.long()
    indptr = graph.out_indptr.long()
    indices = graph.out_indices.long()
    alias = graph.alias_prob is not None
    if alias:
        other = graph.alias_other.long()
    hub_id = hub.hub_id.long()
    pool = hub.pool.long()
    P = hub.pool_size
    last_slot = max(graph.m - 1, 0)
    cur = start.long()
    done = torch.zeros(start.shape, dtype=torch.bool, device=start.device)

    def rand():
        return torch.rand(start.shape, generator=generator,
                          device=generator.device)
    for h in range(int(length.max()) if length.numel() else 0):
        u = rand()
        d = deg[cur]
        alive = ~done & (length > h) & (d > 0)
        j = torch.minimum((u * d.to(torch.float32)).long(),
                          (d - 1).clamp_min(0))
        slot = (indptr[cur] + j).clamp_max(last_slot)
        nxt = indices[slot]
        if alias:
            nxt = torch.where(rand() < graph.alias_prob[slot], nxt,
                              other[slot])
        nxt = torch.where(alive, nxt, cur)
        hid = hub_id[nxt]
        at_hub = alive & (hid >= 0)
        pj = torch.clamp_max((rand() * P).long(), P - 1)
        cur = torch.where(at_hub, pool[hid.clamp_min(0), pj], nxt)
        done |= at_hub
    return cur.to(torch.int32)


def hub_walks(graph: DeviceGraph, start: torch.Tensor, seed: int,
              hub: HubIndex, *, alpha: float,
              max_hops: int = 64) -> torch.Tensor:
    """Alpha-walks with hub short-circuit from ``start`` (any shape);
    endpoints int32 of the same shape, in distribution those of
    ``ops.walk.run_walks``.  CPU tensors run :func:`hub_walks_plain`;
    CUDA tensors launch K4-hub."""
    if start.device.type == "cpu":
        gen = torch.Generator(device="cpu").manual_seed(seed % 2**63)
        return hub_walks_plain(graph, start, hub, generator=gen, alpha=alpha,
                               max_hops=max_hops)
    ends = kernels.index_walk_hub(
        start.reshape(-1).contiguous(), graph.out_indptr, graph.out_indices,
        graph.alias_prob, graph.alias_other, hub.hub_id, hub.pool, seed,
        alpha, max_hops)
    return ends.view(start.shape)


def hubppr_query(graph: DeviceGraph, sources, seed: int, hub: HubIndex, *,
                 rcfg: ResolvedConfig, num_walks: int) -> torch.Tensor:
    """Hub-accelerated Monte Carlo SSPPR: [n, B] endpoint frequencies of
    ``num_walks`` hub-short-circuited walks per source (walk w * B + b
    walks from ``sources[b]``)."""
    src = torch.as_tensor(sources, dtype=torch.int32, device=graph.device)
    out = torch.zeros((graph.n, src.shape[0]), dtype=torch.float32,
                      device=graph.device)
    source_walk_chunk(graph, src, num_walks, seed, rcfg.alpha,
                      rcfg.max_walk_hops, 1.0 / num_walks, out, hub=hub)
    return out


def hubppr_pairs(graph: DeviceGraph, sources, targets, seed: int,
                 hub: HubIndex, *, rcfg: ResolvedConfig, rmax_b: float,
                 num_walks: int) -> torch.Tensor:
    """Pairwise pi(s_i, t_j): [S, T], BiPPR's estimator with the forward
    walks served by the hub index."""
    st = backward_push(graph, targets, rmax_b=rmax_b, alpha=rcfg.alpha)
    src = torch.as_tensor(sources, dtype=torch.int32, device=graph.device)

    def walk(g, start, s, alpha, max_hops):
        return hub_walks(g, start, s, hub, alpha=alpha, max_hops=max_hops)
    return st.p[src.long()] + walk_term(
        graph, st.r, src, seed, alpha=rcfg.alpha,
        max_hops=rcfg.max_walk_hops, num_walks=num_walks, walk=walk)


def make_hubppr_fn(graph: DeviceGraph, rcfg: ResolvedConfig, seed: int, *,
                   num_hubs: int = 256, max_walks: int = 1 << 22,
                   pool_size: Optional[int] = None):
    """CLI entry: build the hub index once (from ``derive_seed(seed,
    0x48554250)``), return ``(sources, seed) -> [n, B]`` at the config's
    guarantee, min(omega_unit + 1, max_walks) walks per query in the
    chunks of ``montecarlo.source_chunks`` (chunk i from ``derive_seed(seed,
    i)``, its estimate weighted by its share of the walks)."""
    num_walks = min(int(rcfg.omega_unit) + 1, max_walks)
    if pool_size is None:
        pool_size = default_pool_size(rcfg, num_walks, num_hubs)
    hub = build_hub_index(graph, derive_seed(seed, 0x48554250),
                          alpha=rcfg.alpha, num_hubs=num_hubs,
                          pool_size=pool_size)

    def fn(sources, seed):
        src = torch.as_tensor(sources, dtype=torch.int32,
                              device=graph.device)
        est = None
        for i, w in enumerate(source_chunks(num_walks, src.shape[0],
                                            graph.device)):
            e = hubppr_query(graph, src, derive_seed(seed, i), hub,
                             rcfg=rcfg, num_walks=w)
            e *= w / num_walks
            est = e if est is None else est.add_(e)
        return est

    fn.hub_index, fn.num_walks = hub, num_walks
    return fn
