"""Synthetic graphs: the Erdos-Renyi and RMAT generators of
``fora_tpu/graph/generators.py`` (58-66, 69-93), the same numpy draws, so
a seed gives the same graph in both packages."""

from __future__ import annotations

import numpy as np

from .csr import CSRGraph, from_edges


def erdos_renyi(n: int, m: int, seed: int = 0,
                ensure_no_self_loops: bool = True) -> CSRGraph:
    """m uniform random edges on n nodes; a self-loop moves its head to
    the next node."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=m, dtype=np.int64)
    dst = rng.integers(0, n, size=m, dtype=np.int64)
    if ensure_no_self_loops:
        loop = src == dst
        dst[loop] = (dst[loop] + 1) % n
    return from_edges(src, dst, n)


def rmat(n_log2: int, m: int, seed: int = 0,
         a: float = 0.57, b: float = 0.19, c: float = 0.19) -> CSRGraph:
    """RMAT (Graph500-style) power-law graph on n = 2**n_log2 nodes: each
    edge picks one (a, b, c, d) quadrant per bit; node ids are permuted and
    self-loops moved to the next node."""
    rng = np.random.default_rng(seed)
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for _ in range(n_log2):
        u = rng.random(m)
        # quadrant: 0->(0,0) 1->(0,1) 2->(1,0) 3->(1,1)
        q = np.select([u < a, u < a + b, u < a + b + c], [0, 1, 2],
                      default=3)
        src = (src << 1) | (q >> 1)
        dst = (dst << 1) | (q & 1)
    perm = rng.permutation(1 << n_log2)
    src, dst = perm[src], perm[dst]
    loop = src == dst
    dst[loop] = (dst[loop] + 1) % (1 << n_log2)
    return from_edges(src, dst, 1 << n_log2)
