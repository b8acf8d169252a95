"""fora_tpu_torch.graph.relabel against fora_tpu.graph.relabel: the orders,
the inverse, the relabelled graph and the relabelled walk index are
array-equal (exact: both are the same numpy integer code), and a relabelled
graph served with its relabelled index answers the same top-k queries as
the original under the permutation (values within rtol 1e-5: the gathers
add the same terms in another order)."""

import numpy as np
import pytest
import torch

from fora_tpu.graph import generators as jax_generators
from fora_tpu.graph import relabel as jax_relabel
from fora_tpu.graph.csr import from_edges as jax_from_edges
from fora_tpu_torch import ForaConfig
from fora_tpu_torch import index as tidx
from fora_tpu_torch.algo.topk import TopkRunner
from fora_tpu_torch.eval import queries
from fora_tpu_torch.graph import generators, relabel, to_device
from fora_tpu_torch.graph.csr import from_edges

torch.set_num_threads(2)

FIELDS = ("out_indptr", "out_indices", "in_src", "in_dst", "out_deg",
          "in_deg", "out_w", "in_w")


def _weighted(make):
    rng = np.random.default_rng(2)
    src = rng.integers(0, 50, 400)
    dst = rng.integers(0, 50, 400)
    w = rng.random(400).astype(np.float32) + 0.1
    return make(src, dst, 50, w=w)


GRAPHS = {
    "er": (lambda: generators.erdos_renyi(300, 2500, seed=5),
           lambda: jax_generators.erdos_renyi(300, 2500, seed=5)),
    "rmat": (lambda: generators.rmat(9, 1 << 12, seed=7),
             lambda: jax_generators.rmat(9, 1 << 12, seed=7)),
    "weighted": (lambda: _weighted(from_edges),
                 lambda: _weighted(jax_from_edges)),
}


def _equal(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, what
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("order", ["degree", "bfs", "random"])
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_orders_and_relabel_graph_match_jax(graph, order):
    ours, theirs = (make() for make in GRAPHS[graph])
    if order == "random":
        perm = np.random.default_rng(0).permutation(ours.n).astype(np.int32)
    else:
        perm = getattr(relabel, f"{order}_order")(ours)
        _equal(perm, getattr(jax_relabel, f"{order}_order")(theirs), order)
    _equal(relabel.invert(perm), jax_relabel.invert(perm), "invert")
    assert np.array_equal(perm[relabel.invert(perm)], np.arange(ours.n))
    rg, jrg = relabel.relabel_graph(ours, perm), jax_relabel.relabel_graph(
        theirs, perm)
    for f in FIELDS:
        _equal(getattr(rg, f), getattr(jrg, f), f)
    with pytest.raises(ValueError, match="permutation"):
        relabel.relabel_graph(ours, np.zeros(ours.n, np.int32))


def _index():
    g = generators.rmat(9, 1 << 12, seed=7)
    rcfg = ForaConfig(epsilon=0.5, k=8).resolved(g.n, g.m)
    dg = to_device(g, merge_duplicate_edges=True, device="cpu")
    return g, rcfg, tidx.build_walk_index(dg, rcfg, seed=1)


@pytest.mark.parametrize("mult", [True, False])
@pytest.mark.parametrize("order", ["degree", "bfs"])
def test_relabel_index_matches_jax(order, mult):
    """JAX's relabel_index reads the same fields off the port's index; the
    results are array-equal, edge_mult included, and the port rebuilds the
    per-bucket row pointers for the new endpoints."""
    g, _, idx = _index()
    assert idx.dst_indptr is not None and idx.edge_mult is not None
    if not mult:
        idx = idx._replace(edge_mult=None)
    perm = getattr(relabel, f"{order}_order")(g)
    ours, theirs = relabel.relabel_index(idx, perm), \
        jax_relabel.relabel_index(idx, perm)
    for f in ("edge_src", "edge_dst", "bucket_offsets", "counts_cum",
              "edge_mult"):
        _equal(getattr(ours, f), getattr(theirs, f), f)
    assert (ours.omega_unit_built, ours.rmax_built) == (
        theirs.omega_unit_built, theirs.rmax_built)
    assert ours.dst_indptr is not None
    want = tidx.build.with_indptr(ours._replace(dst_indptr=None)).dst_indptr
    for q, (a, b) in enumerate(zip(ours.dst_indptr, want)):
        _equal(a, b, f"dst_indptr[{q}]")
    offs = ours.bucket_offsets
    for q in range(len(offs) - 1):
        seg = ours.edge_dst[offs[q]:offs[q + 1]]
        assert np.all(np.diff(seg) >= 0), q
    assert relabel.relabel_index(idx._replace(dst_indptr=None),
                                 perm).dst_indptr is None


@pytest.mark.parametrize("order", ["degree", "bfs"])
def test_relabelled_runner_answers_as_the_original(order):
    """TopkRunner on the relabelled graph (merged, hub split) and the
    relabelled index, sources mapped by perm and answers mapped back,
    returns the original runner's ids, values and levels."""
    g, rcfg, idx = _index()
    perm = getattr(relabel, f"{order}_order")(g)
    inv = relabel.invert(perm)
    sources = queries.generate_sources(g, 6, seed=3)

    def answers(graph, index, srcs):
        dg = to_device(graph, merge_duplicate_edges=True, hub_rows=32,
                       device="cpu")
        runner = TopkRunner(dg, rcfg, k=8, index=index, delta_stride=8)
        return runner.query_pool(srcs, batch=8)

    want = answers(g, idx, sources)
    got = answers(relabel.relabel_graph(g, perm),
                  relabel.relabel_index(idx, perm), perm[sources])
    np.testing.assert_array_equal(inv[got.node_ids], want.node_ids)
    np.testing.assert_allclose(got.values, want.values, rtol=1e-5,
                               atol=1e-9)
    assert got.levels_used == want.levels_used
    np.testing.assert_array_equal(got.accepted, want.accepted)
