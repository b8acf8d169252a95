"""The graph shards' devices, and the query groups.

Counterpart of ``fora_tpu/parallel/mesh.py::make_mesh`` (21-35).  JAX runs
one program over a ('graph', 'query') mesh under ``shard_map``; the port is
one process that holds the shard devices and loops over the shards itself.
It is not ``torch.distributed``: NCCL refuses two ranks on one GPU, and the
engine must run all its shards on a single card.  So a mesh may repeat a
device, and every shard of a one-card run lands on ``cuda:0``.

A mesh is the list of G shard devices, or, with a query axis of Q > 1, a
list of Q query groups of G devices each: the engines split a batch's
columns over the groups, as JAX's ``P('graph', 'query')`` layout does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def make_mesh(n_graph: int, n_query: Optional[int] = None,
              devices: Optional[Sequence] = None) -> list:
    """The shard devices of ``n_graph`` graph shards: a list of G
    ``torch.device`` (``n_query`` None or 1), else a list of ``n_query``
    groups of G.

    With ``devices`` given it must hold G * Q entries in JAX's graph-major
    order (shard g of group q is ``devices[g * Q + q]``); repeats are
    allowed (on the CPU, ``['cpu'] * (G * Q)``).  Without it shard g of
    group q goes to CUDA device (g * Q + q) modulo the visible cards, so
    one card takes all of them; with no CUDA device this raises rather
    than fall back to the CPU.
    """
    Q = 1 if n_query is None else n_query
    if n_graph < 1 or Q < 1:
        raise ValueError(f"mesh {n_graph} x {Q}: both sizes must be >= 1")
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if len(devs) != n_graph * Q:
            raise ValueError(f"{len(devs)} devices for {n_graph} graph "
                             f"shards x {Q} query groups")
    else:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("make_mesh: no CUDA device; pass devices= "
                               "(for example ['cpu'] * n_graph) to run on "
                               "the CPU")
        devs = [torch.device("cuda", i % count) for i in range(n_graph * Q)]
    groups = [[devs[g * Q + q] for g in range(n_graph)] for q in range(Q)]
    return groups[0] if n_query in (None, 1) else groups
