"""Weighted graphs in fora_tpu_torch against fora_tpu, on the CPU: packing,
the device graph's weighted fields, alias tables, the fingerprint, the
weighted oracle, the w/W push, alias-table walks and the three top-k paths.

Deterministic pieces are held to JAX's arrays (array-equal, or the push at
rtol 1e-5 / atol 1e-8 as in tests/test_torch_push.py); walks draw other
random numbers than JAX's threefry, so they are held to w/W and to exact
PPR by chi-square (tests/walk_chisq.py), and the top-k paths to the
weighted oracle by precision@10, as tests/test_weighted.py holds JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from walk_chisq import assert_endpoints_follow, chisquare_pvalue

from fora_tpu import _native
from fora_tpu import index as jax_index
from fora_tpu.algo import exact as jax_exact
from fora_tpu.algo import fora as jax_fora
from fora_tpu.config import ForaConfig as JaxForaConfig
from fora_tpu.graph import alias as jax_alias
from fora_tpu.graph import to_device as jax_to_device
from fora_tpu.graph.csr import from_edges as jax_from_edges
from fora_tpu.ops import push as jax_push
from fora_tpu_torch import ForaConfig, TopkRunner, convert
from fora_tpu_torch import index as tidx
from fora_tpu_torch.algo import exact
from fora_tpu_torch.algo.montecarlo import make_montecarlo_fn
from fora_tpu_torch.eval import metrics
from fora_tpu_torch.graph import alias, from_edges, generators, to_device
from fora_tpu_torch.ops import push
from fora_tpu_torch.ops.topk import topk_nodes
from fora_tpu_torch.ops.walk import run_walks, walk_endpoints

torch.set_num_threads(2)

SOURCES = np.array([3, 17, 42, 99])
FIELDS = ("out_wsum", "in_w", "hub_w", "out_w", "alias_prob", "alias_other",
          "in_src", "in_dst", "hub_ids", "hub_src_local", "hub_dst")


def _edges(g):
    return (np.repeat(np.arange(g.n, dtype=np.int64),
                      np.asarray(g.out_deg, np.int64)),
            np.asarray(g.out_indices, np.int64))


def _er_weighted(n=300, m=3000, seed=11):
    """tests/test_weighted.py's graph: ER, weights U(0.1, 5)."""
    g0 = generators.erdos_renyi(n, m, seed=seed)
    w = np.random.default_rng(seed + 1).uniform(0.1, 5.0, g0.m)
    return _edges(g0) + (w.astype(np.float32),)


def _rmat_weighted(n_log2=10, m=8192, seed=7):
    """An RMAT multigraph (skewed, parallel edges) weighted as bench.py
    weights its graph: exp2(U(-2, 2))."""
    g0 = generators.rmat(n_log2, m, seed=seed)
    w = np.exp2(np.random.default_rng(seed + 31).uniform(-2, 2, g0.m))
    return _edges(g0) + (w.astype(np.float32),)


def _both(src, dst, w, n, dedup=False):
    return (from_edges(src, dst, n, dedup=dedup, w=w),
            jax_from_edges(src, dst, n, dedup=dedup, w=w))


@pytest.mark.parametrize("dedup", [False, True])
def test_from_edges_weighted_matches_jax(dedup):
    src, dst, w = _rmat_weighted()
    ours, theirs = _both(src, dst, w, 1024, dedup)
    for f in theirs._fields:
        a, b = getattr(ours, f), getattr(theirs, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert ours.weighted and (ours.m < len(src)) == dedup
    with pytest.raises(ValueError, match="per-edge"):
        from_edges(src, dst, 1024, w=w[:-1])
    with pytest.raises(ValueError, match="positive"):
        from_edges(src, dst, 1024, w=np.where(np.arange(len(w)) == 5, 0, w))


@pytest.mark.parametrize("merge", [False, True])
@pytest.mark.parametrize("hub_rows", [0, 16])
def test_to_device_weighted_fields_match_jax(merge, hub_rows):
    """out_wsum (f64 sums), in_w (weights summed over merged parallels),
    hub_w, out_w and the alias tables equal JAX's device graph."""
    src, dst, w = _rmat_weighted()
    g, jg = _both(src, dst, w, 1024)
    ours = to_device(g, merge_duplicate_edges=merge, hub_rows=hub_rows,
                     device="cpu")
    theirs = jax_to_device(jg, merge_duplicate_edges=merge,
                           hub_rows=hub_rows)
    assert ours.weighted and ours.hub_split == (hub_rows > 0)
    for f in FIELDS:
        a, b = getattr(ours, f), getattr(theirs, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f)
    if merge:
        assert ours.m_in < g.m                   # parallel edges merged
    total = float(ours.in_w.sum()) + (
        0.0 if ours.hub_w is None else float(ours.hub_w.sum()))
    np.testing.assert_allclose(total, w.sum(dtype=np.float64), rtol=1e-5)


def test_build_alias_matches_jax_python_branch(monkeypatch):
    """The numpy copy against fora_tpu's Python loop (its native builder
    switched off), weighted and uniform, array-equal."""
    monkeypatch.setattr(_native, "native_build_alias", None)
    for src, dst, w in (_rmat_weighted(), _er_weighted()):
        n = int(max(src.max(), dst.max())) + 1
        g, jg = _both(src, dst, w, n)
        for weights in (g.out_w, None):
            ours = alias.build_alias(g, weights)
            theirs = jax_alias.build_alias(jg, weights)
            np.testing.assert_array_equal(ours.prob, theirs.prob)
            np.testing.assert_array_equal(ours.other, theirs.other)
            assert ours.prob.dtype == np.float32
            assert ours.other.dtype == np.int32
    with pytest.raises(ValueError, match="per-edge"):
        alias.build_alias(g, g.out_w[:-1])


def test_alias_induces_w_over_w():
    """Taking slot j of row v uniformly, then its edge w.p. prob[j] else
    other[j], draws u w.p. w(v, u) / W(v) (parallel edges add up)."""
    src, dst, w = _rmat_weighted(9, 4096, seed=3)
    g = from_edges(src, dst, 512, w=w)
    t = alias.build_alias(g, g.out_w)
    indptr = np.asarray(g.out_indptr, np.int64)
    deg = np.diff(indptr)
    row = np.repeat(np.arange(g.n), deg)
    got = np.zeros((g.n, g.n))
    np.add.at(got, (row, g.out_indices), t.prob / deg[row])
    np.add.at(got, (row, t.other), (1.0 - t.prob) / deg[row])
    want = np.zeros((g.n, g.n))
    wsum = np.bincount(row, weights=g.out_w.astype(np.float64),
                       minlength=g.n)
    np.add.at(want, (row, g.out_indices), g.out_w / wsum[row])
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_weighted_fingerprint_matches_jax():
    """A weighted index saved by one package loads in the other only if
    the two fingerprints of the graph agree: host and device graph."""
    g, jg = _both(*_rmat_weighted(), 1024)
    want = jax_index.graph_fingerprint(jg)
    assert tidx.graph_fingerprint(g) == want
    assert tidx.graph_fingerprint(to_device(g, merge_duplicate_edges=True,
                                            device="cpu")) == want
    assert jax_index.graph_fingerprint(jax_to_device(jg)) == want
    unweighted = from_edges(*_rmat_weighted()[:2], 1024)
    assert tidx.graph_fingerprint(unweighted) != want


def test_weighted_oracle_matches_jax():
    src, dst, w = _er_weighted(120, 900)
    g, jg = _both(src, dst, w, 120)
    sources = [0, 7, 64]
    got = exact.exact_ppr_batch(g, sources, tol=1e-13, device="cpu").numpy()
    want = jax_exact.exact_ppr_power_batch(jg, sources, tol=1e-13,
                                           threads=1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    for b, s in enumerate(sources):
        np.testing.assert_allclose(got[:, b], jax_exact.exact_ppr_dense(jg, s),
                                   rtol=0, atol=1e-9)
    # dangling rows keep their self-loop: a weighted star
    star, jstar = _both(np.zeros(5, np.int64), np.arange(1, 6),
                        np.array([1, 2, 4, 8, 1], np.float32), 6)
    np.testing.assert_allclose(
        exact.exact_ppr_batch(star, [0, 3], device="cpu").numpy(),
        jax_exact.exact_ppr_power_batch(jstar, [0, 3], threads=1),
        rtol=0, atol=1e-10)


@pytest.mark.parametrize("merge,hub_rows", [(False, 0), (True, 0),
                                            (True, 16)])
def test_weighted_forward_push_matches_jax(merge, hub_rows):
    """p, r and supersteps of the w/W push (threshold rmax * out_deg, as
    JAX's) against fora_tpu's, at tests/test_torch_push.py's tolerance."""
    g, jg = _both(*_rmat_weighted(), 1024)
    src = np.random.default_rng(5).choice(np.nonzero(g.out_deg)[0], 6,
                                          replace=False).astype(np.int32)
    jst = jax_push.forward_push(
        jax_to_device(jg, merge_duplicate_edges=merge, hub_rows=hub_rows),
        jnp.asarray(src), rmax=1e-4, alpha=0.2)
    tst = push.forward_push(
        to_device(g, merge_duplicate_edges=merge, hub_rows=hub_rows,
                  device="cpu"), torch.as_tensor(src), rmax=1e-4, alpha=0.2)
    np.testing.assert_allclose(tst.p.numpy(), np.asarray(jst.p), rtol=1e-5,
                               atol=1e-8)
    np.testing.assert_allclose(tst.r.numpy(), np.asarray(jst.r), rtol=1e-5,
                               atol=1e-8)
    assert tst.iters == int(jst.iters) > 1
    np.testing.assert_allclose((tst.p + tst.r).sum(0).numpy(), 1.0,
                               rtol=1e-5)


def test_weighted_star_one_hop_chi_square():
    """1-hop walks from a hub with weights 1, 2, 4, 8, 1 end at each leaf
    w.p. w / W (tests/test_weighted.py's star, df = 4)."""
    w = np.array([1.0, 2.0, 4.0, 8.0, 1.0], np.float32)
    g = from_edges(np.zeros(5, np.int64), np.arange(1, 6), 6, w=w)
    gen = torch.Generator().manual_seed(0)
    ends = run_walks(to_device(g, device="cpu"),
                     torch.zeros(20000, dtype=torch.int32), generator=gen,
                     alpha=1e-6, max_hops=1)
    counts = np.bincount(ends.numpy(), minlength=6)[1:]
    assert counts.sum() > 19990
    assert chisquare_pvalue(counts, w) > 1e-3, counts


def test_weighted_walk_endpoints_chi_square_vs_exact():
    """Alpha-terminating alias walks from three sources end in proportion
    to their weighted exact PPR; the same seed replays the same walks."""
    src, dst, w = _er_weighted()
    g, jg = _both(src, dst, w, 300)
    dg = to_device(g, merge_duplicate_edges=True, device="cpu")
    W = 100_000
    for s in (3, 42, 99):
        start = torch.full((W,), s, dtype=torch.int32)
        ends = walk_endpoints(dg, start, s, 0.2, 64)
        assert_endpoints_follow(ends.numpy(), jax_exact.exact_ppr_dense(jg, s))
    assert torch.equal(walk_endpoints(dg, start, 5, 0.2, 64),
                       walk_endpoints(dg, start, 5, 0.2, 64))


def _weighted_setup():
    src, dst, w = _er_weighted()
    g, jg = _both(src, dst, w, 300)
    rcfg = ForaConfig(epsilon=0.3).resolved(g.n, g.m)
    ex = exact.exact_topk_batch(g, SOURCES, 10, device="cpu")
    return g, jg, rcfg, ex


@pytest.mark.parametrize("path", ["indexed", "raw", "montecarlo"])
def test_weighted_precision_vs_oracle(path):
    """precision@10 >= 0.9 against the weighted oracle on each top-k path
    (tests/test_weighted.py's bar for JAX)."""
    g, _, rcfg, ex = _weighted_setup()
    dg = to_device(g, merge_duplicate_edges=True, hub_rows=16, device="cpu")
    if path == "montecarlo":
        ids = topk_nodes(make_montecarlo_fn(dg, rcfg)(SOURCES, 2), 10)[1]
        ids = ids.numpy()
    else:
        index = (tidx.build_walk_index(dg, rcfg, seed=4)
                 if path == "indexed" else None)
        runner = TopkRunner(dg, rcfg, k=10, index=index, delta_stride=8.0)
        ids = runner.query_pool(SOURCES, 1, batch=4, start_level=0).node_ids
    assert (ids[:, 0] == SOURCES).all()
    assert metrics.batch_precision_at_k(ids, ex) >= 0.9


@pytest.mark.parametrize("builder", ["port", "jax"])
def test_cross_serve_weighted_index(builder, tmp_path):
    """Each package serves a weighted index the other built and saved with
    the graph's fingerprint: precision@10 >= 0.9 against the weighted
    oracle."""
    g, jg, rcfg, ex = _weighted_setup()
    jrcfg = JaxForaConfig(epsilon=0.3).resolved(g.n, g.m)
    path = str(tmp_path / "idx")
    jdg = jax_to_device(jg)
    if builder == "port":
        built = tidx.build_walk_index(to_device(g, device="cpu"), rcfg,
                                      seed=4)
        tidx.save(built, rcfg, path, graph=g)
        fn = jax_fora.make_fora_fn(jdg, jrcfg,
                                   index=jax_index.load(path, jrcfg,
                                                        graph=jg))
        res = fn(jnp.asarray(SOURCES, jnp.int32), jax.random.key(0))
        ids = np.asarray(jax.lax.top_k(res.ppr.T, 10)[1])
    else:
        jax_index.save(jax_index.build_walk_index(jdg, jrcfg,
                                                  jax.random.key(4)),
                       jrcfg, path, graph=jdg)
        runner = TopkRunner(to_device(g, device="cpu"), rcfg, k=10,
                            index=tidx.load(path, rcfg, graph=g),
                            delta_stride=8.0)
        ids = runner.query_pool(SOURCES, 1, batch=4, start_level=0).node_ids
    assert metrics.batch_precision_at_k(ids, ex) >= 0.9


def test_graph_from_numpy_carries_alias_tables():
    """A JAX weighted device graph converted: the alias tables, out_w and
    out_wsum arrive (dtypes included), so deterministic parts compare like
    with like; walks on it take the alias branch."""
    g, jg = _both(*_rmat_weighted(), 1024)
    jdg = jax_to_device(jg, merge_duplicate_edges=True, hub_rows=16)
    conv = convert.graph_from_numpy(
        {f: np.asarray(v) for f, v in jdg._asdict().items()
         if v is not None}, device="cpu")
    ours = to_device(g, merge_duplicate_edges=True, hub_rows=16,
                     device="cpu")
    for f in FIELDS + ("in_indptr", "hub_indptr"):
        assert torch.equal(getattr(conv, f), getattr(ours, f)), f
    gen = torch.Generator().manual_seed(3)
    start = torch.zeros(64, dtype=torch.int32)
    ends = run_walks(conv, start, generator=gen, alpha=0.2)
    assert torch.equal(ends, run_walks(ours, start, generator=torch.Generator(
        ).manual_seed(3), alpha=0.2))


def test_sharded_engine_refuses_weighted():
    """The sharded engines used to refuse weighted graphs; they now run
    them.  The one-shot engine (two shards, the routed exchange) on the
    weighted graph gives the one-device weighted level's top-10 at the
    same depth (values within rtol 1e-5), and the sharded pool reaches
    precision@10 >= 0.9 against the weighted oracle."""
    from fora_tpu_torch.algo.fora import StagedForaPrograms
    from fora_tpu_torch.ops.topk import topk_rows_chunked
    from fora_tpu_torch.parallel import (ShardedForaEngine, ShardedTopkRunner,
                                         make_mesh)
    g, _, rcfg, ex = _weighted_setup()
    idx = tidx.build_walk_index(to_device(g, device="cpu"), rcfg, seed=1)
    mesh = make_mesh(2, devices=["cpu"] * 2)
    eng = ShardedForaEngine(g, mesh, rcfg, k=10, index=idx,
                            exchange="routed")
    got = eng.topk(SOURCES)
    st = push.init_state(g.n, torch.as_tensor(SOURCES))
    res, _, _ = StagedForaPrograms(to_device(g, device="cpu"), rcfg,
                                   idx).state_fn(eng.index_depth)(
        st.p, st.r, None, rcfg.rmax, rcfg.omega_unit)
    vals = topk_rows_chunked(res.ppr, 10)[0].numpy()
    assert got.push_iters == res.push_iters
    np.testing.assert_allclose(np.sort(got.values, axis=1),
                               np.sort(vals, axis=1), rtol=1e-5, atol=1e-9)
    pool = ShardedTopkRunner(g, mesh, rcfg, idx, k=10, delta_stride=8.0)
    ids = pool.query_pool(SOURCES, batch=4, start_level=0).node_ids
    assert metrics.batch_precision_at_k(ids, ex) >= 0.9
