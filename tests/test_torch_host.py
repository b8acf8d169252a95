"""The port's host code against fora_tpu's: config derivation, CSR packing,
the Erdos-Renyi and RMAT generators, query sources, precision@k and the
exact PPR oracle.

The port carries these (numpy) pieces itself so that it imports nothing of
the JAX package; here they are held equal to the originals they copy.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fora_tpu.algo import exact as jax_exact
from fora_tpu.config import ForaConfig as JaxForaConfig
from fora_tpu.eval import metrics as jax_metrics
from fora_tpu.eval import queries as jax_queries
from fora_tpu.graph import generators as jax_generators
from fora_tpu.graph.csr import from_edges as jax_from_edges
from fora_tpu_torch import ForaConfig, from_edges
from fora_tpu_torch.algo import exact
from fora_tpu_torch.eval import metrics, queries
from fora_tpu_torch.graph import generators

torch.set_num_threads(2)


@pytest.mark.parametrize("kw", [
    {}, {"epsilon": 0.2, "k": 100}, {"delta": 1e-4, "pfail": 1e-3},
    {"alpha": 0.15, "rmax_scale": 2.0, "walk_multiplier": 0.5,
     "max_push_iters": 7, "max_walk_hops": 9}])
def test_config_matches_jax(kw):
    ours = ForaConfig(**kw).resolved(4096, 32768)
    theirs = JaxForaConfig(**kw).resolved(4096, 32768)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    for d in (1 / 50, 1 / 3000):
        assert dataclasses.asdict(ours.with_delta(d)) == \
            dataclasses.asdict(theirs.with_delta(d))
    assert ours.omega(0.3) == theirs.omega(0.3)


def _assert_same_graph(ours, theirs):
    for f in ("out_indptr", "out_indices", "in_src", "in_dst", "out_deg",
              "in_deg"):
        a, b = getattr(ours, f), getattr(theirs, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert ours.out_w is None and ours.in_w is None
    assert (ours.n, ours.m, ours.weighted) == (theirs.n, theirs.m, False)


def test_from_edges_matches_jax():
    rng = np.random.default_rng(5)
    n = 300
    src = rng.integers(0, n, 5000)
    dst = rng.integers(0, n, 5000)
    src[:50], dst[:50] = 7, 7          # self-loops and parallel edges
    _assert_same_graph(from_edges(src, dst, n), jax_from_edges(src, dst, n))
    with pytest.raises(ValueError, match="range"):
        from_edges(np.array([0]), np.array([n]), n)


@pytest.mark.parametrize("n_log2,m,seed", [(8, 2048, 0), (12, 32768, 7)])
def test_rmat_matches_jax(n_log2, m, seed):
    _assert_same_graph(generators.rmat(n_log2, m, seed=seed),
                       jax_generators.rmat(n_log2, m, seed=seed))


@pytest.mark.parametrize("n,m,seed,no_loops", [(512, 4096, 3, True),
                                               (50, 2000, 1, False)])
def test_erdos_renyi_matches_jax(n, m, seed, no_loops):
    _assert_same_graph(generators.erdos_renyi(n, m, seed, no_loops),
                       jax_generators.erdos_renyi(n, m, seed, no_loops))


def test_generate_sources_matches_jax():
    g = generators.rmat(10, 4096, seed=3)
    for count, seed, req in ((64, 8, True), (2000, 1, True), (10, 2, False)):
        np.testing.assert_array_equal(
            queries.generate_sources(g, count, seed, req),
            jax_queries.generate_sources(g, count, seed, req))


def test_precision_matches_jax():
    rng = np.random.default_rng(4)
    pred = rng.integers(0, 60, (8, 50))
    ex = rng.integers(0, 60, (8, 50))
    assert metrics.batch_precision_at_k(pred, ex) == \
        jax_metrics.batch_precision_at_k(pred, ex)
    assert metrics.precision_at_k(np.arange(50), np.arange(50)[::-1]) == 1.0


@pytest.mark.parametrize("graph", ["rmat", "star"])
def test_exact_ppr_matches_jax(graph):
    """The oracle on torch (float64 sparse SpMM) against fora_tpu's scipy
    power iteration: the same vectors, and top-k lists whose exact values
    agree (ids may differ only among exact ties)."""
    if graph == "rmat":
        g = generators.rmat(11, 16384, seed=9)   # has dangling nodes
    else:
        g = from_edges(np.zeros(9, np.int64), np.arange(1, 10), 10)
    sources = queries.generate_sources(g, 6, seed=2)
    got = exact.exact_ppr_batch(g, sources, device="cpu").numpy()
    want = jax_exact.exact_ppr_power_batch(g, sources, threads=1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.sum(axis=0), 1.0, atol=1e-9)
    k = 5
    ids = exact.exact_topk_batch(g, sources, k, device="cpu")
    ref = jax_exact.exact_topk_batch(g, sources, k)
    cols = np.arange(len(sources))[:, None]
    np.testing.assert_allclose(want.T[cols, ids], want.T[cols, ref],
                               rtol=0, atol=1e-12)
    assert (np.diff(want.T[cols, ids], axis=1) <= 1e-15).all()


def test_exact_topk_breaks_ties_by_lowest_id():
    """Exact ties at rank k resolve by node id ascending, as every top-k
    of both packages does: 0 -> {1, 2} (1 and 2 tie, dangling) and 5 -> 6;
    each source reaches fewer than k = 5 nodes, so its list ends with the
    lowest-numbered nodes of PPR zero."""
    g = from_edges(np.array([0, 0, 5]), np.array([1, 2, 6]), 10)
    ids = exact.exact_topk_batch(g, [0, 5], 5, device="cpu")
    assert ids.tolist() == [[1, 2, 0, 3, 4], [6, 5, 0, 1, 2]]
