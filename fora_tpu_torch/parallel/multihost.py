"""Results of the sharded engines on the host.

Counterpart of ``fora_tpu/parallel/multihost.py``.  ``gather_to_host``
(41-45) gives the host a numpy copy of a row-sharded result, as JAX's
``process_allgather(tiled=True)`` does.  ``init`` (24-38) starts
``jax.distributed`` across processes; the port has no counterpart: it
runs as one process that holds every shard's device itself
(``parallel/mesh.py``), since NCCL refuses two ranks on one GPU and the
engines must run all their shards on a single card.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch


def init(*args, **kwargs) -> None:
    """Not applicable: the port runs as one process over all its shard
    devices, so there is no process group to start."""
    raise NotImplementedError(
        "fora_tpu_torch runs its shards in one process (parallel/mesh.py); "
        "there is no multi-process initialisation")


def gather_to_host(x: Union[torch.Tensor, Sequence[torch.Tensor]]
                   ) -> np.ndarray:
    """A host numpy copy of ``x``: one tensor, or the shards' tensors (on
    any devices) concatenated along rows in shard order."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.concatenate([t.detach().cpu().numpy() for t in x], axis=0)
