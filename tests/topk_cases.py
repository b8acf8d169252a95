"""Adversarial inputs for the split accept's selection (K3), shared by the
CPU model's tests and the card's kernel tests.

``CASES`` maps a name to ``(make, k, stride, capacity, dense, jax_ok)``:
``make(rng)`` returns (p, contrib) float32 [n, B]; ``stride``/``capacity``
are handed to the selection (None: its own plan); ``dense`` is the set of
columns that must take the dense path ("all", "none", or a tuple of column
numbers); ``jax_ok`` is False where the input leaves what fora_tpu defines
(negative scores, signed zeros).
"""

import numpy as np


def tied(n, B, levels=32, scale=1.0):
    """Quantized values: many exact ties at and around rank k."""
    def make(rng):
        p = np.floor(rng.random((n, B)) * levels) / 4096 * scale
        c = np.floor(rng.random((n, B)) * 8) / 4096 * scale
        return p.astype(np.float32), c.astype(np.float32)
    return make


def smooth(n, B):
    """Distinct values with a heavy tail, as a PPR column has."""
    def make(rng):
        p = rng.random((n, B)) ** 8
        c = rng.random((n, B)) ** 8 * 0.1
        return p.astype(np.float32), c.astype(np.float32)
    return make


def few_positive(n):
    """Column 0: 18 positive rows and signed zeros elsewhere (a source that
    reaches fewer than k + 1 nodes); column 1: distinct values; column 2:
    all zero."""
    def make(rng):
        p = np.zeros((n, 3), np.float32)
        c = np.zeros((n, 3), np.float32)
        rows = rng.choice(n, 18, replace=False)
        p[rows[:9], 0] = rng.random(9)
        c[rows[5:], 0] = rng.random(13)
        p[rng.choice(n, n // 7, replace=False), 0] = -0.0
        c[(p[:, 0] == 0) & (c[:, 0] == 0), 0] = -0.0   # some sums are -0.0
        p[:, 1], c[:, 1] = (a[:, 0] for a in smooth(n, 1)(rng))
        return p, c
    return make


def all_equal(n, B, value=0.25):
    def make(rng):
        return (np.full((n, B), value, np.float32),
                np.zeros((n, B), np.float32))
    return make


def mixed_ties(n):
    """Column 0: distinct values; column 1: four levels, so the ties at a
    positive threshold overflow a small capacity."""
    def make(rng):
        p, c = smooth(n, 2)(rng)
        p[:, 1] = np.floor(rng.random(n) * 4) / 8
        c[:, 1] = 0.0
        return p, c
    return make


def reversed_hubs(n, B):
    """The largest scores at the highest ids."""
    def make(rng):
        ids = np.arange(n, dtype=np.float64)[:, None]
        p = 1.0 / (n - ids) * (1 + np.arange(B))[None, :]
        c = rng.random((n, B)) * 1e-9
        return p.astype(np.float32), c.astype(np.float32)
    return make


def negatives(n):
    """Column 0: mostly zero, a few positives, negatives among the first
    ids (the zero rule's premise fails: dense); column 1: distinct values
    shifted below zero, threshold negative (no zero rule: selected)."""
    def make(rng):
        p = np.zeros((n, 2), np.float32)
        c = np.zeros((n, 2), np.float32)
        p[rng.choice(n, 20, replace=False), 0] = rng.random(20)
        c[[1, 4, 9], 0] = -0.5
        p[:, 1], c[:, 1] = (a[:, 0] for a in smooth(n, 1)(rng))
        p[:, 1] -= 2.0
        return p, c
    return make


N = 40_000   # ten segments: the selection's own plan samples every 32nd row

CASES = {
    "tied_small": (tied(5000, 4, 64), 10, None, None, "all", True),
    "tied_45_segments": (tied(4096 * 45 + 17, 3, 64), 50, None, None, "none",
                         True),
    "tied_k_near_n": (tied(700, 2, 64), 50, None, None, "all", True),
    "tied_scaled": (tied(N, 8, scale=8.0), 50, None, None, "none", True),
    "few_positive": (few_positive(N), 50, None, None, "none", False),
    "all_equal": (all_equal(N, 2), 50, None, None, "all", True),
    "all_zero": (all_equal(N, 2, 0.0), 50, None, None, "none", True),
    "forced_overflow": (tied(N, 4), 50, 32, 64, "all", True),
    "mixed_ties": (mixed_ties(N), 10, 32, 1024, (1,), True),
    "odd_rows": (smooth(N + 1, 4), 50, None, None, "none", True),
    "odd_stride": (smooth(N + 5, 4), 20, 7, None, "none", True),
    "reversed_hubs": (reversed_hubs(N, 4), 50, None, None, "none", True),
    "negatives": (negatives(N), 10, None, None, (0,), False),
    "B1": (smooth(N // 2, 1), 50, None, None, "none", True),
    "B3": (smooth(N // 2, 3), 50, None, None, "none", True),
    "B130": (smooth(N // 2, 130), 5, None, None, "none", True),
    "k100": (smooth(N, 4), 100, None, None, "none", True),
}


def dense_columns(dense, B):
    """The expected dense flags [B] of a case."""
    want = np.zeros(B, bool)
    if dense == "all":
        want[:] = True
    elif dense != "none":
        want[list(dense)] = True
    return want
