"""Synthetic graphs: the generators of ``fora_tpu/graph/generators.py``
(17-93), the same numpy code, so a seed gives the same graph in both
packages: the analytic fixtures (cycle, star, complete, Zachary's karate
club), Erdos-Renyi and RMAT."""

from __future__ import annotations

import numpy as np

from .csr import CSRGraph, from_edges


def cycle_graph(n: int) -> CSRGraph:
    """Directed n-cycle: PPR from s is analytic, pi(s, s+j) = a (1-a)^j /
    norm."""
    src = np.arange(n, dtype=np.int64)
    dst = (src + 1) % n
    return from_edges(src, dst, n)


def star_graph(n: int) -> CSRGraph:
    """Node 0 -> {1..n-1}; the leaves are dangling."""
    src = np.zeros(n - 1, dtype=np.int64)
    dst = np.arange(1, n, dtype=np.int64)
    return from_edges(src, dst, n)


def complete_graph(n: int) -> CSRGraph:
    """Every ordered pair of distinct nodes."""
    src, dst = np.nonzero(~np.eye(n, dtype=bool))
    return from_edges(src, dst, n)


def karate_club() -> CSRGraph:
    """Zachary's karate club (34 nodes, 78 undirected edges) as a symmetric
    directed graph."""
    und = [
        (0, 1), (0, 2), (0, 3), (0, 4), (0, 5), (0, 6), (0, 7), (0, 8),
        (0, 10), (0, 11), (0, 12), (0, 13), (0, 17), (0, 19), (0, 21),
        (0, 31), (1, 2), (1, 3), (1, 7), (1, 13), (1, 17), (1, 19), (1, 21),
        (1, 30), (2, 3), (2, 7), (2, 8), (2, 9), (2, 13), (2, 27), (2, 28),
        (2, 32), (3, 7), (3, 12), (3, 13), (4, 6), (4, 10), (5, 6), (5, 10),
        (5, 16), (6, 16), (8, 30), (8, 32), (8, 33), (9, 33), (13, 33),
        (14, 32), (14, 33), (15, 32), (15, 33), (18, 32), (18, 33), (19, 33),
        (20, 32), (20, 33), (22, 32), (22, 33), (23, 25), (23, 27), (23, 29),
        (23, 32), (23, 33), (24, 25), (24, 27), (24, 31), (25, 31), (26, 29),
        (26, 33), (27, 33), (28, 31), (28, 33), (29, 32), (29, 33), (30, 32),
        (30, 33), (31, 32), (31, 33), (32, 33),
    ]
    e = np.array(und, dtype=np.int64)
    src = np.concatenate([e[:, 0], e[:, 1]])
    dst = np.concatenate([e[:, 1], e[:, 0]])
    return from_edges(src, dst, 34)


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
