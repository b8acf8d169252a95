"""Query sources: ``fora_tpu/eval/queries.py::generate_sources`` (18-25),
the same draw, so a seed picks the same sources in both packages."""

from __future__ import annotations

import numpy as np


def generate_sources(g, count: int, seed: int = 0,
                     require_outdeg: bool = True) -> np.ndarray:
    """``count`` source ids drawn uniformly from the nodes with out-degree
    > 0 (all nodes when not ``require_outdeg``)."""
    rng = np.random.default_rng(seed)
    if require_outdeg:
        pool = np.nonzero(np.asarray(g.out_deg) > 0)[0]
    else:
        pool = np.arange(g.n)
    return rng.choice(pool, size=count,
                      replace=count > len(pool)).astype(np.int64)
