"""The graph shards' devices.

Counterpart of ``fora_tpu/parallel/mesh.py::make_mesh`` (21-35).  JAX runs
one program over a ('graph', 'query') mesh under ``shard_map``; the port is
one process that holds a list of G shard devices and loops over the shards
itself.  It is not ``torch.distributed``: NCCL refuses two ranks on one
GPU, and the engine must run all its shards on a single card.  So the list
may repeat a device, and every shard of a one-card run lands on
``cuda:0``.  There is no query axis yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def make_mesh(n_graph: int, n_query: Optional[int] = None,
              devices: Optional[Sequence] = None) -> list:
    """The G = ``n_graph`` shard devices, a list of ``torch.device``.

    With ``devices`` given it must hold G entries (repeats allowed: on the
    CPU, G x ``cpu``).  Without it the shards go round-robin over the
    visible CUDA devices, so one card takes all of them; with no CUDA
    device this raises rather than fall back to the CPU.
    """
    if n_query not in (None, 1):
        raise NotImplementedError(
            "fora_tpu_torch has no query axis yet: the sharded engine runs "
            "one batch over the graph shards")
    if n_graph < 1:
        raise ValueError(f"n_graph must be >= 1, got {n_graph}")
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if len(devs) != n_graph:
            raise ValueError(f"{len(devs)} devices for {n_graph} graph "
                             "shards")
        return devs
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("make_mesh: no CUDA device; pass devices= (for "
                           "example ['cpu'] * n_graph) to run on the CPU")
    return [torch.device("cuda", g % count) for g in range(n_graph)]
