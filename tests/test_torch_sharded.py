"""fora_tpu_torch's graph-sharded indexed engine against fora_tpu's, on the
CPU with the plain ring.

The JAX side is ``ShardedForaEngine(g, make_mesh(G, 1, ...), rcfg, k=10,
index=idx)`` on virtual CPU devices: its dense path with XLA's
collectives (the ``pallas_ring`` path cannot run in interpret mode on a
2-axis mesh, test_sharded_ring.py:3-7).  The port gets the same graph and
the same index, carried across by ``convert.index_from_numpy``.  Both
results are sorted by value descending, then id ascending (the shared tie
rule), and must agree: ids wherever adjacent values differ by more than
1e-7 (summation order differs, so an exact tie may come out in either
order), values within rtol 1e-5 / atol 1e-7, and the same number of push
supersteps.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from fora_tpu import index as jax_index
from fora_tpu.algo import exact
from fora_tpu.config import ForaConfig
from fora_tpu.eval import metrics
from fora_tpu.eval import queries as qio
from fora_tpu.graph import generators, to_device as jax_to_device
from fora_tpu.graph.csr import CSRGraph as JaxCSRGraph
from fora_tpu.graph.csr import from_edges as jax_from_edges
from fora_tpu.parallel import ShardedForaEngine as JaxEngine
from fora_tpu.parallel import exchange_bytes_model as jax_bytes_model
from fora_tpu.parallel import make_mesh as jax_make_mesh
from fora_tpu_torch import convert
from fora_tpu_torch.algo.fora import StagedForaPrograms
from fora_tpu_torch.graph import to_device
from fora_tpu_torch.graph.csr import CSRGraph
from fora_tpu_torch.ops import push
from fora_tpu_torch.ops.topk import topk_rows_chunked
from fora_tpu_torch.parallel import (ShardedForaEngine, ShardedTopkRunner,
                                     exchange_bytes_model, make_mesh)

torch.set_num_threads(2)

K = 10
SMOKE_IDX = "bench_data_smoke/rmat12x8s7.idx.e0.5"


def port_graph(g) -> CSRGraph:
    return CSRGraph(**{f: getattr(g, f) for f in CSRGraph._fields})


@functools.lru_cache(maxsize=None)
def setup(name):
    """(fora_tpu graph, rcfg, fora_tpu index, sources) of a test graph."""
    if name == "smoke":
        z = np.load("bench_data_smoke/rmat12x8s7.npz")
        g = JaxCSRGraph(**{k: z[k] for k in JaxCSRGraph._fields
                           if k in z.files})
        rcfg = ForaConfig(epsilon=0.5, k=50).resolved(g.n, g.m)
        idx = jax_index.load(SMOKE_IDX, rcfg, graph=g)
        return g, rcfg, idx, qio.generate_sources(g, 16, seed=8)
    g = generators.erdos_renyi(300, 3000, seed=21)
    rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
    idx = jax_index.build_walk_index(jax_to_device(g), rcfg,
                                     jax.random.key(2))
    return g, rcfg, idx, np.array([3, 17, 42, 99, 123, 200, 250, 287])


def port_engine(name, G):
    g, rcfg, idx, _ = setup(name)
    return ShardedForaEngine(port_graph(g), make_mesh(G, devices=["cpu"] * G),
                             rcfg, k=K, index=convert.index_from_numpy(idx))


def sorted_topk(vals, ids):
    """Each row ordered by value descending, then id ascending."""
    vals, ids = np.asarray(vals), np.asarray(ids)
    order = np.stack([np.lexsort((i, -v.astype(np.float64)))
                      for v, i in zip(vals, ids)])
    return (np.take_along_axis(vals, order, 1),
            np.take_along_axis(ids, order, 1))


def assert_topk_agree(got_v, got_i, want_v, want_i, rtol=1e-5, atol=1e-7,
                      tie=1e-7):
    gv, gi = sorted_topk(got_v, got_i)
    wv, wi = sorted_topk(want_v, want_i)
    np.testing.assert_allclose(gv, wv, rtol=rtol, atol=atol)
    apart = np.abs(np.diff(wv.astype(np.float64), axis=1)) > tie
    sep = np.ones(wv.shape, bool)
    sep[:, :-1] &= apart
    sep[:, 1:] &= apart
    assert sep.mean() > 0.5
    np.testing.assert_array_equal(gi[sep], wi[sep])


@pytest.mark.parametrize("G", [2, 4])
@pytest.mark.parametrize("name", ["er", "smoke"])
def test_sharded_matches_jax(name, G):
    g, rcfg, idx, sources = setup(name)
    jeng = JaxEngine(g, jax_make_mesh(G, 1, devices=jax.devices()[:G]), rcfg,
                     k=K, index=idx)
    want = jeng.topk(np.asarray(sources, np.int32), jax.random.key(3))
    got = port_engine(name, G).topk(sources)
    assert got.values.shape == (len(sources), K)
    assert got.node_ids.dtype == np.int32
    assert not got.walk_overflow.any()
    assert got.push_iters == int(want.push_iters)
    assert_topk_agree(got.values, got.node_ids, want.values, want.node_ids)


@pytest.mark.parametrize("G", [2, 4])
@pytest.mark.parametrize("name", ["er", "smoke"])
def test_sharded_matches_single_device(name, G):
    """The port's own single-device indexed level at the same depth
    (StagedForaPrograms.state_fn plus the top-k) on the unmerged graph."""
    g, rcfg, idx, sources = setup(name)
    eng = port_engine(name, G)
    tidx = convert.index_from_numpy(idx)
    staged = StagedForaPrograms(to_device(port_graph(g), device="cpu"),
                                rcfg, tidx)
    st = push.init_state(g.n, torch.as_tensor(sources))
    res, _, _ = staged.state_fn(eng.index_depth)(
        st.p, st.r, None, rcfg.rmax, rcfg.omega_unit)
    vals, ids = topk_rows_chunked(res.ppr, K)
    got = eng.topk(sources)
    assert got.push_iters == res.push_iters
    assert_topk_agree(got.values, got.node_ids, vals.numpy(), ids.numpy())


@pytest.mark.parametrize("G", [2, 4, 8])
def test_sharded_topk_matches_oracle(G):
    g, _, _, sources = setup("er")
    res = port_engine("er", G).topk(sources)
    assert np.all(np.diff(res.values, axis=1) <= 1e-7)
    exact_ids = np.stack([exact.exact_topk(g, int(s), K)[0]
                          for s in sources])
    assert metrics.batch_precision_at_k(res.node_ids, exact_ids) >= 0.85


def test_sharded_is_deterministic():
    eng = port_engine("er", 4)
    a, b = eng.topk(np.arange(8)), eng.topk(np.arange(8))
    np.testing.assert_array_equal(a.node_ids, b.node_ids)
    np.testing.assert_array_equal(a.values, b.values)


def _weighted(g):
    src = np.repeat(np.arange(g.n), np.diff(g.out_indptr))
    w = np.random.default_rng(1).uniform(0.5, 2.0, g.m).astype(np.float32)
    return jax_from_edges(src, np.asarray(g.out_indices, np.int64), g.n, w=w)


@pytest.mark.parametrize("case", ["no_index", "ragged"])
def test_unported_options_raise(case):
    """What the sharded engines still refuse, as the reference does: the
    refinement pool without an index (the one-shot engine runs the raw
    walk without one, tests/test_torch_sharded_raw.py), and the ragged
    exchange (ROADMAP C5)."""
    g, rcfg, idx, _ = setup("er")
    tidx = convert.index_from_numpy(idx)
    mesh = make_mesh(2, devices=["cpu", "cpu"])
    if case == "no_index":
        with pytest.raises(ValueError, match="requires a walk index"):
            ShardedTopkRunner(port_graph(g), mesh, rcfg, None, k=K)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP C5"):
        ShardedForaEngine(port_graph(g), mesh, rcfg, k=K, index=tidx,
                          exchange="ragged")


ENGINE_OPTIONS = {
    "weighted": (True, 4, 1, {}),
    "hub_rows": (False, 4, 1, {"hub_rows": 16}),
    "compact": (False, 4, 1, {"exchange": "compact"}),
    "routed": (False, 2, 1, {"exchange": "routed"}),
    "hier": (False, 4, 1, {"exchange": "hier", "chips_per_host": 2}),
    "query_axis": (False, 2, 2, {"exchange": "routed"}),
}


@pytest.mark.parametrize("case", list(ENGINE_OPTIONS))
def test_engine_options_match_jax(case):
    """The one-shot engine with the options the port used to refuse:
    weighted graphs, the hub split, the compacted exchanges and a query
    axis, against the JAX engine with the same options."""
    weighted, G, Q, kw = ENGINE_OPTIONS[case]
    g, rcfg, idx, sources = setup("er")
    if weighted:
        g = _weighted(g)
        rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
        idx = jax_index.build_walk_index(jax_to_device(g), rcfg,
                                         jax.random.key(2))
    jeng = JaxEngine(g, jax_make_mesh(G, Q, devices=jax.devices()[:G * Q]),
                     rcfg, k=K, index=idx, **kw)
    want = jeng.topk(np.asarray(sources, np.int32), jax.random.key(3))
    eng = ShardedForaEngine(port_graph(g),
                            make_mesh(G, Q, devices=["cpu"] * (G * Q)), rcfg,
                            k=K, index=convert.index_from_numpy(idx), **kw)
    got = eng.topk(sources)
    # JAX counts the supersteps of the batch's slowest query group
    assert got.push_iters >= int(want.push_iters)
    if Q == 1:
        assert got.push_iters == int(want.push_iters)
    assert_topk_agree(got.values, got.node_ids, want.values, want.node_ids)
    if kw.get("exchange", "dense") != "dense":
        assert eng.exchange.compacted > 0
        assert eng.exchange_bytes(8) == jax_bytes_model(
            kw["exchange"], n_loc=eng.n_loc, batch=8, G=G,
            cap=eng.exchange.cap, chips_per_host=kw.get("chips_per_host", 1))


def test_make_mesh():
    assert make_mesh(3, devices=["cpu"] * 3) == [torch.device("cpu")] * 3
    assert make_mesh(3, 1, devices=["cpu"] * 3) == [torch.device("cpu")] * 3
    with pytest.raises(ValueError):
        make_mesh(3, devices=["cpu"] * 2)
    # a query axis: Q groups of G, graph-major as JAX's mesh
    devs = [f"cuda:{i}" for i in range(6)]
    groups = make_mesh(3, 2, devices=devs)
    assert groups == [[torch.device(devs[g * 2 + q]) for g in range(3)]
                      for q in range(2)]
    with pytest.raises(ValueError):
        make_mesh(3, 2, devices=["cpu"] * 3)
    if torch.cuda.is_available():
        count = torch.cuda.device_count()
        assert make_mesh(4) == [torch.device("cuda", g % count)
                                for g in range(4)]
    else:
        with pytest.raises(RuntimeError):   # no silent CPU fallback
            make_mesh(4)


def test_exchange_bytes_model_matches_jax():
    kw = dict(n_loc=65536, batch=128, G=8)
    for mode, extra in (("dense", {}), ("compact", {"cap": 1024}),
                        ("routed", {"cap": 1024}),
                        ("ragged", {"cap": 1024,
                                    "active_rows": np.full(7, 100)}),
                        ("hier", {"cap": 1024, "chips_per_host": 4})):
        assert exchange_bytes_model(mode, **kw, **extra) == \
            jax_bytes_model(mode, **kw, **extra)
    eng = port_engine("er", 4)
    assert eng.exchange_bytes(8) == 3 * eng.n_loc * 8 * 4
