"""The row-sharded out-CSR, on the host.

Port of ``fora_tpu/index/build_sharded.py::_shard_csr`` (48-82): per shard,
a localized slice of the out-CSR's row pointers and its contiguous slice
of ``out_indices`` (and of the alias tables on a weighted graph), padded to
common shapes.  The sharded graph store (``parallel/graph_store.py``)
writes the walk side with it.  The sharded walks and
``build_walk_index_sharded`` (84-185) are not ported yet (ROADMAP Queue 1
item 4, Queue 2 item 4).
"""

from __future__ import annotations

import math

import numpy as np

from ..graph.alias import build_alias


def _shard_csr(g, n_shards: int, row_multiple: int = 8):
    """(n_loc, indptr [G, n_loc+1] i32, indices [G, mo_loc] i32, deg [G,
    n_loc] i32, alias_prob [G, mo_loc] f32 or None, alias_other [G,
    mo_loc] i32 or None) of ``g``, a CSRGraph of either package."""
    n = g.n
    n_loc = -(-math.ceil(n / n_shards) // row_multiple) * row_multiple
    indptr = np.asarray(g.out_indptr, dtype=np.int64)
    bounds = [indptr[min(s * n_loc, n)] for s in range(n_shards + 1)]
    m_loc = max(1, max(int(bounds[s + 1] - bounds[s])
                       for s in range(n_shards)))

    indptr_loc = np.zeros((n_shards, n_loc + 1), dtype=np.int32)
    indices_loc = np.zeros((n_shards, m_loc), dtype=np.int32)
    deg_loc = np.zeros((n_shards, n_loc), dtype=np.int32)
    ap_loc = (np.ones((n_shards, m_loc), dtype=np.float32)
              if g.weighted else None)
    ao_loc = (np.zeros((n_shards, m_loc), dtype=np.int32)
              if g.weighted else None)
    if g.weighted:
        alias = build_alias(g, weights=g.out_w)
    for s in range(n_shards):
        row0, row1 = s * n_loc, min((s + 1) * n_loc, n)
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        if row1 > row0:
            sl = indptr[row0: row1 + 1] - lo
            indptr_loc[s, : row1 - row0 + 1] = sl
            indptr_loc[s, row1 - row0 + 1:] = sl[-1]
            deg_loc[s, : row1 - row0] = np.asarray(g.out_deg[row0:row1])
        indices_loc[s, : hi - lo] = np.asarray(g.out_indices[lo:hi])
        if g.weighted:
            ap_loc[s, : hi - lo] = alias.prob[lo:hi]
            ao_loc[s, : hi - lo] = alias.other[lo:hi]
    return n_loc, indptr_loc, indices_loc, deg_loc, ap_loc, ao_loc
