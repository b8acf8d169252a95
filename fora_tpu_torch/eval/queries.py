"""Query sources: ``fora_tpu/eval/queries.py`` (18-34), the same draw, so a
seed picks the same sources in both packages, and the same
``<dataset>.query`` files (one source id per line)."""

from __future__ import annotations

from pathlib import Path

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


def save_queries(sources: np.ndarray, path: str) -> None:
    Path(path).write_text("".join(f"{int(s)}\n" for s in sources))


def load_queries(path: str) -> np.ndarray:
    return np.array([int(x) for x in Path(path).read_text().split()],
                    dtype=np.int64)
