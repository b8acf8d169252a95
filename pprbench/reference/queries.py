"""Query sources: a frozen copy of ``fora_tpu_torch/eval/queries.py``'s
``generate_sources`` (itself the JAX package's draw), so a seed picks the
same sources the program's own tools would."""

from __future__ import annotations

import numpy as np


def generate_sources(out_deg, count: int, seed: int = 0,
                     require_outdeg: bool = True) -> np.ndarray:
    """``count`` source ids drawn uniformly from the nodes with out-degree
    > 0 (all nodes when not ``require_outdeg``).  Takes the out-degrees
    where the original takes the graph."""
    rng = np.random.default_rng(seed)
    out_deg = np.asarray(out_deg)
    if require_outdeg:
        pool = np.nonzero(out_deg > 0)[0]
    else:
        pool = np.arange(len(out_deg))
    return rng.choice(pool, size=count,
                      replace=count > len(pool)).astype(np.int64)
