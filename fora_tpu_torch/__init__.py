"""fora_tpu_torch: the FORA approximate-PPR engine on PyTorch and CUDA.

A port of ``fora_tpu`` (JAX) that runs the top-k query paths on an
NVIDIA H100: forward push as masked SpMV supersteps, the walk phase from
sampled walks (raw-walk FORA, Monte Carlo) or from the FORA+ walk index
(built by a walk kernel, served as a weighted SpMV), and top-k refinement
with Bernstein-bound acceptance, on unweighted and weighted graphs (w/W
transitions, alias-table walks); and the graph-sharded one-shot top-k
(``parallel``), whose shards exchange over a ring all-gather and a ring
reduce-scatter; the competitors BiPPR (``algo/bippr.py``), HubPPR
(``algo/hubppr.py``) and push-only; the frontier-compacted push
(``ops.push.forward_push_from(compact_edges=)``) and node relabelling
(``graph/relabel.py``); and the reference's CLI (``cli``) with
its TCP server (``serve``) and dataset files (``graph/io.py``).  Its hot
loops, the two ring hops and the gather probe's per-edge accumulate
(``probes``) are hand-written CUDA kernels (``kernels/csrc``) built at
first use; CPU tensors run plain
PyTorch versions of the same functions.  Every function takes its device
from an explicit argument or from the tensors it is given.  The package
imports torch and numpy only: nothing of JAX and nothing of ``fora_tpu``.
"""

from .algo.topk import TopkResult, TopkRunner, delta_schedule
from .config import ForaConfig, ResolvedConfig
from .graph.csr import CSRGraph, DeviceGraph, from_edges, to_device
from .parallel import (ShardedForaEngine, ShardedTopkResult, make_mesh,
                       partition_index, partition_rows)

__all__ = ["ForaConfig", "ResolvedConfig", "TopkResult", "TopkRunner",
           "delta_schedule", "CSRGraph", "DeviceGraph", "from_edges",
           "to_device", "ShardedForaEngine", "ShardedTopkResult",
           "make_mesh", "partition_index", "partition_rows"]
