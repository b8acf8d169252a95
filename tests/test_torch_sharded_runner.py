"""fora_tpu_torch's sharded refinement pool (``ShardedTopkRunner``) against
fora_tpu's, on the CPU.

The JAX side runs on the conftest's virtual CPU devices (``make_mesh(G,
Q)``), the port's on CPU shards (``make_mesh(G, Q, devices=['cpu'] * G *
Q)``, the plain version of every kernel).  Two pools of 16 sources each go
through ``query_pool(batch=8, defer_below=4)``, then ``flush_deferred``.
Per query the two must agree on ids, values and bounds (rtol 1e-5; ids
equal where adjacent values differ by more than 1e-7, since the float
order differs: P2 sums in ring order, XLA's psum_scatter in its own) and
on ``accepted``, except a query whose k-th value sits within 1e-5 of a
level's threshold (ROADMAP C2).  The port's compact, routed and hier
exchanges must equal its dense one bit for bit, levels and supersteps
included.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from fora_tpu import index as jax_index
from fora_tpu.config import ForaConfig
from fora_tpu.graph import generators, to_device as jax_to_device
from fora_tpu.graph.csr import from_edges as jax_from_edges
from fora_tpu.parallel import ShardedTopkRunner as JaxRunner
from fora_tpu.parallel import make_mesh as jax_make_mesh
from fora_tpu_torch import convert
from fora_tpu_torch.algo.topk import TopkRunner
from fora_tpu_torch.graph import to_device
from fora_tpu_torch.graph.csr import CSRGraph
from fora_tpu_torch.parallel import ShardedTopkRunner, make_mesh

torch.set_num_threads(2)

K, EPS = 10, 0.5
POOLS = [np.array([3, 17, 42, 99, 123, 200, 250, 287, 311, 399, 5, 60, 77,
                   140, 222, 333]),
         np.array([1, 8, 30, 64, 101, 150, 177, 205, 260, 301, 350, 371,
                   388, 12, 45, 90])]


def port_graph(g) -> CSRGraph:
    return CSRGraph(**{f: getattr(g, f) for f in CSRGraph._fields})


@functools.lru_cache(maxsize=None)
def setup(weighted: bool):
    g = generators.erdos_renyi(400, 4000, seed=21)
    if weighted:
        w = np.random.default_rng(5).uniform(0.5, 2.0, g.m).astype(np.float32)
        g = jax_from_edges(np.repeat(np.arange(g.n), np.diff(g.out_indptr)),
                           np.asarray(g.out_indices, np.int64), g.n, w=w)
    rcfg = ForaConfig(epsilon=EPS).resolved(g.n, g.m)
    idx = jax_index.build_walk_index(jax_to_device(g), rcfg,
                                     jax.random.key(7))
    return g, rcfg, idx


def run_port(g, rcfg, idx, G, Q=1, **kw):
    """(per-pool results, flush result, runner) of the port's pool."""
    run = ShardedTopkRunner(port_graph(g),
                            make_mesh(G, Q, devices=["cpu"] * (G * Q)),
                            rcfg, convert.index_from_numpy(idx), k=K, **kw)
    res = [run.query_pool(p, batch=8, defer_below=4) for p in POOLS]
    stats = list(run.last_level_stats)
    srcs, flush = run.flush_deferred(batch=8)
    return res, (srcs, flush), run, stats


def run_jax(g, rcfg, idx, G, Q=1, **kw):
    run = JaxRunner(g, jax_make_mesh(G, Q, devices=jax.devices()[:G * Q]),
                    rcfg, idx, k=K, **kw)
    key = jax.random.key(11)
    res = [run.query_pool(p, jax.random.fold_in(key, i), batch=8,
                          defer_below=4) for i, p in enumerate(POOLS)]
    srcs, flush = run.flush_deferred(jax.random.key(12), batch=8)
    return res, (srcs, flush), run


def _at_edge(values, deltas):
    kth = values[:, -1:].astype(np.float64)
    thr = (1 + EPS) * np.asarray(deltas)[None, :]
    return (np.abs(kth - thr) <= 1e-5 * thr).any(axis=1)


def assert_agree(got, want, deltas):
    ok = ~(_at_edge(want.values, deltas) | _at_edge(got.values, deltas))
    assert ok.mean() > 0.9
    np.testing.assert_array_equal(got.accepted[ok], want.accepted[ok])
    if want.deferred is not None:
        np.testing.assert_array_equal(got.deferred, want.deferred)
    for f in ("values", "lower_bounds", "upper_bounds"):
        np.testing.assert_allclose(getattr(got, f)[ok], getattr(want, f)[ok],
                                   rtol=1e-5, atol=1e-12, err_msg=f)
    wv = want.values.astype(np.float64)
    apart = np.abs(np.diff(wv, axis=1)) > 1e-7
    sep = np.ones(wv.shape, bool)
    sep[:, :-1] &= apart
    sep[:, 1:] &= apart
    sep &= ok[:, None]
    np.testing.assert_array_equal(got.node_ids[sep], want.node_ids[sep])


CASES = {
    "G2-dense": (False, 2, 1, {}),
    "G4-dense": (False, 4, 1, {}),
    "G4-compact": (False, 4, 1, {"exchange": "compact"}),
    "G2-routed": (False, 2, 1, {"exchange": "routed"}),
    "G4-routed": (False, 4, 1, {"exchange": "routed"}),
    "G4-hier": (False, 4, 1, {"exchange": "hier", "chips_per_host": 2}),
    "G4-weighted-routed": (True, 4, 1, {"exchange": "routed"}),
    "G2-weighted-dense": (True, 2, 1, {}),
    "G4-hub-dense": (False, 4, 1, {"hub_rows": 32}),
    "G4-hub-weighted-hier": (True, 4, 1, {"hub_rows": 32, "exchange": "hier",
                                          "chips_per_host": 2}),
    "G4-query2-routed": (False, 4, 2, {"exchange": "routed"}),
    "G2-query2-dense": (False, 2, 2, {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_pool_matches_jax(case):
    weighted, G, Q, kw = CASES[case]
    g, rcfg, idx = setup(weighted)
    got, (gsrc, gflush), run, _ = run_port(g, rcfg, idx, G, Q, **kw)
    want, (wsrc, wflush), jrun = run_jax(g, rcfg, idx, G, Q, **kw)
    assert run.deltas == jrun.deltas and run.WIDTH_FLOOR == max(128, Q)
    for a, b in zip(got, want):
        assert a.node_ids.shape == (16, K) and a.node_ids.dtype == np.int32
        assert_agree(a, b, run.deltas)
        assert a.levels_used == b.levels_used
    np.testing.assert_array_equal(gsrc, wsrc)
    if wflush is not None:
        assert_agree(gflush, wflush, run.deltas)
    else:
        assert gflush is None


@pytest.mark.parametrize("weighted,hub", [(False, 0), (True, 32)])
def test_modes_bit_equal_to_dense(weighted, hub):
    """compact, routed and hier with nothing overflowing give the dense
    exchange's pools bit for bit: ids, values, bounds, levels and the
    supersteps of every level; each compacted some supersteps."""
    g, rcfg, idx = setup(weighted)
    base, (bsrc, bflush), _, bstats = run_port(g, rcfg, idx, 4,
                                               hub_rows=hub)
    for kw in ({"exchange": "compact"}, {"exchange": "routed"},
               {"exchange": "hier", "chips_per_host": 2}):
        got, (src, flush), run, stats = run_port(g, rcfg, idx, 4,
                                                 hub_rows=hub, **kw)
        for a, b in zip(got + [flush], base + [bflush]):
            if b is None:
                assert a is None
                continue
            for f in ("node_ids", "values", "lower_bounds", "upper_bounds",
                      "accepted", "deferred"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                              err_msg=f"{kw} {f}")
            assert a.levels_used == b.levels_used
        assert [s["supersteps"] for s in stats] == \
            [s["supersteps"] for s in bstats]
        assert sum(s["compacted"] for s in stats) > 0, kw
        ex = run._groups[0].exchange
        assert ex.compacted > 0 and ex.mode == kw["exchange"]
        np.testing.assert_array_equal(src, bsrc)


def test_matches_single_device_runner():
    """The sharded pool against the port's single-device TopkRunner on the
    same (unmerged) graph and index."""
    g, rcfg, idx = setup(False)
    got, _, run, _ = run_port(g, rcfg, idx, 4, exchange="routed")
    one = TopkRunner(to_device(port_graph(g), device="cpu"), rcfg, k=K,
                     index=convert.index_from_numpy(idx))
    for pool, a in zip(POOLS, got):
        b = one.query_pool(pool, batch=8, defer_below=4)
        assert_agree(a, b, run.deltas)


def test_query_and_level_stats():
    """``query`` (the whole-batch loop) runs on shards too, and the level
    record carries the exchange's counts."""
    g, rcfg, idx = setup(False)
    run = ShardedTopkRunner(port_graph(g), make_mesh(2, devices=["cpu"] * 2),
                            rcfg, convert.index_from_numpy(idx), k=K,
                            exchange="compact")
    res = run.query(POOLS[0][:8])
    assert res.node_ids.shape == (8, K) and res.levels_used >= 1
    run.query_pool(POOLS[0], batch=8)
    st = run.last_level_stats
    assert all({"supersteps", "compacted", "fell_back"} <= set(s)
               for s in st)
    assert sum(s["compacted"] + s["fell_back"] for s in st) == \
        sum(s["supersteps"] for s in st)


def test_runner_refusals():
    g, rcfg, idx = setup(False)
    tidx = convert.index_from_numpy(idx)
    mesh = make_mesh(2, devices=["cpu"] * 2)
    with pytest.raises(ValueError):
        ShardedTopkRunner(port_graph(g), mesh, rcfg, None, k=K)
    with pytest.raises(NotImplementedError, match="ROADMAP C5"):
        ShardedTopkRunner(port_graph(g), mesh, rcfg, tidx, k=K,
                          exchange="ragged")
    with pytest.raises(ValueError):
        ShardedTopkRunner(port_graph(g), mesh, rcfg, tidx, k=K,
                          exchange="hier", chips_per_host=3)
    run = ShardedTopkRunner(port_graph(g),
                            make_mesh(2, 2, devices=["cpu"] * 4), rcfg, tidx,
                            k=K)
    with pytest.raises(ValueError):   # a block must divide by the groups
        run.query_pool(POOLS[0][:5], batch=5)
