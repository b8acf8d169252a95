"""Walker alias tables for O(1) weighted sampling of out-neighbours.

Port of ``fora_tpu/graph/alias.py`` (24-73).  The tables are per edge slot,
aligned with the out-CSR, so a weighted hop is

    j    = floor(u * deg[cur])
    slot = out_indptr[cur] + j
    next = u2 < alias_prob[slot] ? out_indices[slot] : alias_other[slot]

Two builders give equal tables.  ``build_alias`` is a numpy copy of the
JAX module's Python branch, a loop over rows: the CPU and the tests' small
graphs use it.  ``build_alias_library`` calls the port's copy of
``fora_tpu/_native/graph_io.cpp::fora_build_alias`` (211-260), host code
in ``kernels/csrc/alias.cu`` compiled into the kernel library: ``to_device``
takes it for a CUDA device, where the Python loop would cost tens of
seconds at the bench's scale.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np

from ..kernels import build as kbuild


class AliasTables(NamedTuple):
    prob: np.ndarray   # [m] f32, probability of keeping the slot's own edge
    other: np.ndarray  # [m] i32, the alternative destination node id


def _checked_weights(g, weights, dtype) -> np.ndarray:
    w = np.ascontiguousarray(weights, dtype=dtype)
    if w.shape != (g.m,):
        raise ValueError("weights must be per-edge, out-CSR order")
    return w


def build_alias(g, weights: Optional[np.ndarray] = None) -> AliasTables:
    """Vose's construction per CSR row of ``g`` (a CSRGraph).  ``weights``
    are per edge in out-CSR order; None gives prob 1 and ``other`` the
    slot's own destination everywhere."""
    prob = np.ones(g.m, dtype=np.float32)
    other = np.asarray(g.out_indices, dtype=np.int32).copy()
    if weights is None:
        return AliasTables(prob=prob, other=other)
    w = _checked_weights(g, weights, np.float64)
    indptr = np.asarray(g.out_indptr, dtype=np.int64)
    cols = np.asarray(g.out_indices, dtype=np.int64)
    for v in range(g.n):
        lo, hi = indptr[v], indptr[v + 1]
        d = hi - lo
        if d == 0:
            continue
        p = w[lo:hi] / w[lo:hi].sum() * d      # scaled to mean 1
        small = [i for i in range(d) if p[i] < 1.0]
        large = [i for i in range(d) if p[i] >= 1.0]
        pp = p.copy()
        while small and large:
            s, big = small.pop(), large.pop()
            prob[lo + s] = pp[s]
            other[lo + s] = cols[lo + big]
            pp[big] = (pp[big] + pp[s]) - 1.0
            (small if pp[big] < 1.0 else large).append(big)
        for i in large + small:                # leftovers keep prob 1 / self
            prob[lo + i] = 1.0
            other[lo + i] = cols[lo + i]
    return AliasTables(prob=prob, other=other)


def build_alias_library(g, weights: np.ndarray) -> AliasTables:
    """The same tables from ``fora_build_alias`` in the kernel library
    (built first if needed; a missing ``nvcc`` raises).  Raises where the
    builder fails."""
    w = _checked_weights(g, weights, np.float32)
    indptr = np.ascontiguousarray(g.out_indptr, dtype=np.int64)
    cols = np.ascontiguousarray(g.out_indices, dtype=np.int32)
    prob = np.ones(g.m, dtype=np.float32)
    other = cols.copy()

    def ptr(a):
        return ctypes.c_void_p(a.ctypes.data)
    rc = kbuild.library().fora_build_alias(ptr(indptr), ptr(cols), ptr(w),
                                           g.n, ptr(prob), ptr(other))
    if rc != 0:
        raise RuntimeError(f"fora_build_alias failed (rc={rc}): out of host "
                           "memory for its row stacks")
    return AliasTables(prob=prob, other=other)
