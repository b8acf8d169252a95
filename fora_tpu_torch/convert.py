"""State carried across from the JAX package, as numpy arrays.

The tests build ``fora_tpu`` objects, convert them here and compare the two
packages like with like.  Nothing here imports JAX: callers pass
``np.asarray`` of the JAX arrays (or JAX objects whose fields ``np.asarray``
accepts).
"""

from __future__ import annotations

import numpy as np
import torch

from .algo.bippr import BackwardPushState
from .algo.hubppr import HubIndex
from .graph.csr import from_numpy_fields
from .index.build import WalkIndex, with_indptr
from .ops.push import PushState
from .parallel.partition import PartitionedGraph, PartitionedIndex


# ``{name: np.asarray(field)}`` of a fora_tpu DeviceGraph -> DeviceGraph,
# a weighted graph's out_wsum, out_w and alias tables included
graph_from_numpy = from_numpy_fields


def index_from_numpy(jidx) -> WalkIndex:
    """A host WalkIndex (with per-bucket dst_indptr) from a fora_tpu
    WalkIndex."""
    mult = None if jidx.edge_mult is None else \
        np.asarray(jidx.edge_mult, np.float32)
    return with_indptr(WalkIndex(
        edge_src=np.asarray(jidx.edge_src, np.int32),
        edge_dst=np.asarray(jidx.edge_dst, np.int32),
        bucket_offsets=np.asarray(jidx.bucket_offsets, np.int64),
        counts_cum=np.asarray(jidx.counts_cum, np.int32),
        omega_unit_built=float(jidx.omega_unit_built),
        rmax_built=float(jidx.rmax_built),
        edge_mult=mult))


def push_state_from_numpy(p, r, *, device) -> PushState:
    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)
    return PushState(p=t(p), r=t(r), iters=0)


def hub_index_from_numpy(jhub, *, device):
    """The port's HubIndex (int32 tensors on ``device``) from a fora_tpu
    HubIndex (hub_nodes, hub_id, pool)."""
    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.int32)).to(device)
    return HubIndex(hub_nodes=t(jhub.hub_nodes), hub_id=t(jhub.hub_id),
                    pool=t(jhub.pool))


def backward_push_state_from_numpy(jst, *, device):
    """The port's BackwardPushState from a fora_tpu BackwardPushState
    (p, r as f32 on ``device``, iters as an int)."""
    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)
    return BackwardPushState(p=t(jst.p), r=t(jst.r), iters=int(jst.iters))


def _fields_from_numpy(cls, obj):
    """``cls`` built from the same-named fields of ``obj``: arrays through
    ``np.asarray``, ints and None as they are."""
    def conv(v):
        return v if v is None or isinstance(v, (int, np.integer)) \
            else np.asarray(v)
    return cls(**{f: conv(getattr(obj, f)) for f in cls._fields})


def partitioned_graph_from_numpy(jpg) -> PartitionedGraph:
    """The port's PartitionedGraph from a fora_tpu PartitionedGraph."""
    return _fields_from_numpy(PartitionedGraph, jpg)


def partitioned_index_from_numpy(jpi) -> PartitionedIndex:
    """The port's PartitionedIndex from a fora_tpu PartitionedIndex."""
    return _fields_from_numpy(PartitionedIndex, jpi)
