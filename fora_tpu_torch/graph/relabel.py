"""Node relabelling: renumber the nodes of a graph and of its walk index.

Port of ``fora_tpu/graph/relabel.py`` (40-159) as numpy, through the
port's own ``from_edges`` and ``WalkIndex``.  PPR is label-invariant, so
any permutation gives the same answers under the new names; what changes
is where in the [n, B] operand the push gather (K1) reads each edge's row.

  * ``degree_order``: out-degree descending, so the rows gathered most
    often (the hubs of a power-law graph) lie together at the front.
  * ``bfs_order``: breadth-first over the undirected adjacency from the
    highest-degree node, so neighbours get nearby labels.

``perm[old] = new`` throughout: query sources map forward with ``perm``,
answers map back with ``invert(perm)``.  An index built on the old labels
is carried to the new ones by ``relabel_index``.  Nothing relabels by
default; ``chip_smoke.py`` times K1 per order on the card.
"""

from __future__ import annotations

import numpy as np

from .csr import CSRGraph, from_edges


def invert(perm: np.ndarray) -> np.ndarray:
    """inv[new] = old for perm[old] = new."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0], dtype=perm.dtype)
    return inv


def degree_order(g: CSRGraph) -> np.ndarray:
    """perm[old] = new with nodes numbered by out-degree descending (ties:
    old id ascending)."""
    old_by_rank = np.argsort(-g.out_deg.astype(np.int64), kind="stable")
    return invert(old_by_rank.astype(np.int32))


def bfs_order(g: CSRGraph) -> np.ndarray:
    """perm[old] = new in breadth-first order over the undirected
    adjacency, from the highest-out-degree node; each further component
    starts from its highest-degree unvisited node.  A level's frontier is
    expanded with one gather over its rows' adjacency."""
    n = g.n
    src = np.concatenate([
        np.repeat(np.arange(n, dtype=np.int64), g.out_deg.astype(np.int64)),
        g.in_dst.astype(np.int64)])
    dst = np.concatenate([g.out_indices.astype(np.int64),
                          g.in_src.astype(np.int64)])
    order = np.argsort(src, kind="stable")
    adj = dst[order]
    deg = np.bincount(src, minlength=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])

    visited = np.zeros(n, dtype=bool)
    new_of_old = np.empty(n, dtype=np.int32)
    next_label = 0
    by_degree = np.argsort(-g.out_deg.astype(np.int64), kind="stable")
    unseen_ptr = 0
    while next_label < n:
        while unseen_ptr < n and visited[by_degree[unseen_ptr]]:
            unseen_ptr += 1
        frontier = np.asarray([by_degree[unseen_ptr]], dtype=np.int64)
        visited[frontier] = True
        while frontier.size:
            new_of_old[frontier] = np.arange(
                next_label, next_label + frontier.size, dtype=np.int32)
            next_label += frontier.size
            starts, ends = indptr[frontier], indptr[frontier + 1]
            lens = ends - starts
            total = int(lens.sum())
            if total == 0:
                break
            idx = np.repeat(starts, lens) + (
                np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens))
            nxt = adj[idx]
            nxt = nxt[~visited[nxt]]
            if nxt.size == 0:
                break
            nxt = np.unique(nxt)
            visited[nxt] = True
            frontier = nxt
    return new_of_old


def relabel_graph(g: CSRGraph, perm: np.ndarray) -> CSRGraph:
    """The same multigraph (edges, weights, parallel edges, self-loops)
    with node ids mapped through ``perm`` (old -> new), repacked by
    ``from_edges``."""
    n = g.n
    perm = np.asarray(perm)
    if perm.shape != (n,) or not np.array_equal(
            np.sort(perm), np.arange(n, dtype=perm.dtype)):
        raise ValueError("perm must be a permutation of [0, n)")
    src = np.repeat(np.arange(n, dtype=np.int64), g.out_deg.astype(np.int64))
    return from_edges(perm[src], perm[g.out_indices.astype(np.int64)], n,
                      w=g.out_w)


def relabel_index(index, perm: np.ndarray):
    """A walk index built on the old labels, carried to the new ones: both
    ends of every index edge map through ``perm``, each bucket re-sorts by
    (endpoint, source) as ``pack_index`` sorts it, ``edge_mult`` follows
    its edge, and ``counts_cum``'s rows move to the new ids.  The walk
    counts are unchanged, so the accuracy contract is too.  An index that
    carried per-bucket row pointers (``dst_indptr``) gets them rebuilt for
    the new endpoints."""
    from ..index.build import WalkIndex, with_indptr
    perm = np.asarray(perm, dtype=np.int64)
    src = perm[np.asarray(index.edge_src, dtype=np.int64)]
    dst = perm[np.asarray(index.edge_dst, dtype=np.int64)]
    offs = np.asarray(index.bucket_offsets, dtype=np.int64)
    bucket = np.zeros(src.shape[0], dtype=np.int64)
    for b, lo in enumerate(offs[:-1]):
        bucket[lo:] = b
    order = np.lexsort((src, dst, bucket))
    inv = invert(perm.astype(np.int32)).astype(np.int64)
    mult = index.edge_mult
    out = WalkIndex(
        edge_src=src[order].astype(np.int32),
        edge_dst=dst[order].astype(np.int32),
        bucket_offsets=index.bucket_offsets,
        counts_cum=np.asarray(index.counts_cum)[inv],
        omega_unit_built=index.omega_unit_built,
        rmax_built=index.rmax_built,
        edge_mult=None if mult is None else np.asarray(mult)[order])
    return out if index.dst_indptr is None else with_indptr(out)
