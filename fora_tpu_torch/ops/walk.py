"""Alpha-terminating random walks: the hot loop of the index build.

Port of ``fora_tpu/ops/walk.py``: ``geometric_lengths`` (89-99) and the
lockstep ``run_walks`` (102-135) are the plain versions; ``walk_endpoints``
takes the place of ``run_walks_scheduled`` + ``hop_widths`` (138-222) and
dispatches a CUDA tensor to K4 (``kernels/csrc/walk.cu``), where one
thread runs one walk to its own length, so the TPU's length sort, static
prefix widths and overflow fallback are gone.

Dangling convention: a walk at an out-degree-0 node is absorbed there.
Random numbers come from a ``torch.Generator`` (plain versions) or the
kernel's Philox stream; neither replays JAX's threefry bits, so endpoints
agree with JAX in distribution only.
"""

from __future__ import annotations

import math

import torch

from .. import kernels
from ..graph.csr import DeviceGraph


def geometric_lengths(shape, alpha: float, max_hops: int, *,
                      generator: torch.Generator) -> torch.Tensor:
    """Hops before the alpha-coin stops a walk: floor(log u / log(1-alpha))
    ~ Geometric(alpha), capped at ``max_hops``; int32."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    u.clamp_min_(torch.finfo(torch.float32).tiny)
    len_f = torch.floor(torch.log(u) * (1.0 / math.log1p(-alpha)))
    return len_f.clamp_max(max_hops).to(torch.int32)


def run_walks(graph: DeviceGraph, start: torch.Tensor, *,
              generator: torch.Generator, alpha: float,
              max_hops: int = 64) -> torch.Tensor:
    """Lockstep walks from ``start`` (any shape); endpoints, int32, same
    shape.  Hop h draws one uniform per walk and moves the walks still
    alive to a uniform out-neighbour."""
    length = geometric_lengths(start.shape, alpha, max_hops,
                               generator=generator)
    deg = graph.out_deg.long()
    indptr = graph.out_indptr.long()
    indices = graph.out_indices.long()
    last_slot = max(graph.m - 1, 0)
    cur = start.long()
    for h in range(int(length.max()) if length.numel() else 0):
        u = torch.rand(start.shape, generator=generator,
                       device=generator.device)
        d = deg[cur]
        alive = (length > h) & (d > 0)          # dangling absorbs
        j = torch.minimum((u * d.to(torch.float32)).long(),
                          (d - 1).clamp_min(0))
        # a dead walk's slot may point past the last edge: clamp (unused)
        nxt = indices[(indptr[cur] + j).clamp_max(last_slot)]
        cur = torch.where(alive, nxt, cur)
    return cur.to(torch.int32)


def walk_endpoints(graph: DeviceGraph, start: torch.Tensor, seed: int,
                   alpha: float, max_hops: int) -> torch.Tensor:
    """One walk per entry of ``start`` ([W] int32); endpoints [W] int32.
    CPU tensors run the plain ``run_walks``; CUDA tensors launch K4."""
    if start.device.type == "cpu":
        gen = torch.Generator(device="cpu").manual_seed(seed % 2**63)
        return run_walks(graph, start, generator=gen, alpha=alpha,
                         max_hops=max_hops)
    return kernels.index_walk(start, graph.out_indptr, graph.out_indices,
                              graph.out_deg, seed, alpha, max_hops)
