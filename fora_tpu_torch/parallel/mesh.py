"""The graph shards' devices, and the query groups.

Counterpart of ``fora_tpu/parallel/mesh.py::make_mesh`` (21-35).  JAX runs
one program over a ('graph', 'query') mesh under ``shard_map``; the port
is one process that holds its shard devices and loops over the shards
itself, so a mesh may repeat a device, and every shard of a one-card run
lands on ``cuda:0``.

A mesh is the list of G shard devices, or, with a query axis of Q > 1, a
list of Q query groups of G devices each: the engines split a batch's
columns over the groups, as JAX's ``P('graph', 'query')`` layout does.

With a process group started (``multihost.init``), G is global: P
processes hold L = G / P shards each, process q shards q * L .. q * L + L
- 1 (JAX's order: ``jax.devices()`` lists the devices process by process,
so the graph axis is contiguous per process).  ``make_mesh`` then returns
a ``ProcessMesh``: the G entries, this process's shards' devices and None
for the others', with the group's transport.  A query axis of Q groups is
Q such meshes of the same local devices: JAX lists device g * Q + q as
shard g of group q, so each process holds its L shards of every group,
and the engines place them once for all groups.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import multihost


class ProcessMesh(list):
    """The G graph shards of a process group: entry g is shard g's device
    where this process holds the shard, else None; ``comm`` is the group's
    ``multihost.ProcessComm``."""

    def __init__(self, devices: Sequence, comm: "multihost.ProcessComm"):
        super().__init__(devices)
        self.comm = comm
        G, P = len(self), comm.size
        if G % P:
            raise ValueError(f"{G} graph shards over {P} processes: G must "
                             "divide by the processes")
        self.per_process = G // P
        held = [g for g, d in enumerate(self) if d is not None]
        if held != list(self.local):
            raise ValueError(f"process {comm.rank} must hold shards "
                             f"{list(self.local)}, holds {held}")

    @property
    def local(self) -> range:
        """This process's shards: rank * L .. rank * L + L - 1."""
        L = self.per_process
        return range(self.comm.rank * L, (self.comm.rank + 1) * L)


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

    With a process group started: a ``ProcessMesh`` of the G global
    shards, this process's L = G / P on ``devices`` (L entries) or, by
    default, on the group's device; with ``n_query`` Q > 1, a list of Q
    such meshes, each with this process's shards on the same devices.
    """
    Q = 1 if n_query is None else n_query
    if n_graph < 1 or Q < 1:
        raise ValueError(f"mesh {n_graph} x {Q}: both sizes must be >= 1")
    comm = multihost.comm()
    if comm is not None:
        if n_graph % comm.size:
            raise ValueError(f"{n_graph} graph shards over {comm.size} "
                             "processes: G must divide by the processes")
        L = n_graph // comm.size
        local = ([comm.device] * L if devices is None
                 else [torch.device(d) for d in devices])
        if len(local) != L:
            raise ValueError(f"{len(local)} devices for this process's {L} "
                             "shards")
        q0 = comm.rank * L
        groups = [ProcessMesh([local[g - q0] if q0 <= g < q0 + L else None
                               for g in range(n_graph)], comm)
                  for _ in range(Q)]
        return groups[0] if n_query in (None, 1) else groups
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
