"""Raw-walk FORA, its top-k runner, the unsplit accept, Monte Carlo and
``entry()`` of fora_tpu_torch against fora_tpu's, on the CPU.

Push is deterministic and held to JAX's (rtol 1e-5: the two sum in other
orders); the walks draw other random numbers than JAX's threefry, so the
estimates are held to exact PPR (FORA's relative-error guarantee,
chi-square for Monte Carlo) and the runner to JAX's precision@k.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from walk_chisq import chisquare_pvalue

from fora_tpu.algo import bounds as jax_bounds
from fora_tpu.algo import exact as jax_exact
from fora_tpu.algo import fora as jax_fora
from fora_tpu.algo import topk as jax_topk
from fora_tpu.config import ForaConfig
from fora_tpu.eval import metrics
from fora_tpu.eval import queries as qio
from fora_tpu.graph import generators as jax_generators
from fora_tpu.graph import to_device as jax_to_device
from fora_tpu.graph.csr import CSRGraph
from fora_tpu.ops import push as jax_push
from fora_tpu.ops import topk as jax_topk_ops
from fora_tpu.ops import walk as jax_walk
from fora_tpu_torch import ForaConfig as TorchForaConfig
from fora_tpu_torch import index as tidx
from fora_tpu_torch import to_device
from fora_tpu_torch.algo import bounds, fora, montecarlo
from fora_tpu_torch.algo.topk import TopkRunner
from fora_tpu_torch.entry import entry
from fora_tpu_torch.graph import generators
from fora_tpu_torch.ops import topk as topk_ops
from fora_tpu_torch.ops import walk

torch.set_num_threads(2)

SMOKE_EXACT = "bench_data_smoke/rmat12x8s7.exact4.d1975b620f.k50.npz"
K, EPS = 50, 0.5


def test_fora_state_matches_jax_push():
    """One raw level from one-hot state: p, r and the superstep count
    equal JAX's push; the walk demand is JAX's up to the ceil of entries
    whose residue differs in the last bit; no walk is dropped."""
    g = generators.erdos_renyi(500, 5000, seed=11)
    rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
    src = np.array([3, 77, 200, 412], np.int32)
    lanes = jax_walk.walk_lane_budget(rcfg.omega_unit, rcfg.rmax, rcfg.m,
                                      rcfg.n)
    st0 = jax_push.init_state(g.n, jnp.asarray(src))
    want, wp, wr = jax_fora.make_fora_state_fn(jax_to_device(g), rcfg, lanes)(
        st0.p, st0.r, jax.random.key(0), jnp.float32(rcfg.rmax),
        jnp.float32(rcfg.omega_unit))
    tst = push_state(g.n, src)
    got, p, r = fora.make_fora_state_fn(to_device(g, device="cpu"), rcfg)(
        tst.p, tst.r, 5, rcfg.rmax, rcfg.omega_unit)
    assert p is tst.p and r is tst.r           # advanced in place
    np.testing.assert_allclose(p.numpy(), np.asarray(wp), rtol=1e-5,
                               atol=1e-9)
    np.testing.assert_allclose(r.numpy(), np.asarray(wr), rtol=1e-5,
                               atol=1e-9)
    assert got.push_iters == int(want.push_iters)
    np.testing.assert_allclose(got.rsum.numpy(), np.asarray(want.rsum),
                               rtol=1e-5)
    np.testing.assert_allclose(got.walk_total.numpy(),
                               np.asarray(want.walk_total), rtol=1e-3)
    assert not got.walk_overflow.any()
    np.testing.assert_allclose(got.ppr.sum(0).numpy(), 1.0, rtol=1e-5)


def push_state(n, src):
    from fora_tpu_torch.ops.push import init_state
    return init_state(n, torch.as_tensor(src))


def test_fora_query_meets_guarantee():
    """FORA's guarantee: relative error <= eps on every node above delta
    (whp; fixed seeds), on the karate club and an ER graph."""
    for g, sources in ((jax_generators.karate_club(), [0, 16, 33]),
                       (generators.erdos_renyi(500, 5000, seed=11),
                        [3, 77, 200, 412])):
        rcfg = TorchForaConfig(epsilon=0.5).resolved(g.n, g.m)
        dg = to_device(g, device="cpu")
        for seed in (0, 1):
            res = fora.fora_query(dg, torch.tensor(sources), seed, rcfg=rcfg)
            assert not res.walk_overflow.any()
            assert (res.walk_total > 0).all()
            ppr = res.ppr.double().numpy()
            for b, s in enumerate(sources):
                pi = jax_exact.exact_ppr_power_batch(g, [s], threads=1)[:, 0]
                assert metrics.max_relative_error(ppr[:, b], pi,
                                                  rcfg.delta) <= EPS


def _tied_estimate(rng, n, B):
    p = np.floor(rng.random((n, B)) * 64).astype(np.float32) / 4096
    contrib = np.floor(rng.random((n, B)) * 8).astype(np.float32) / 4096
    return p, p + contrib


@pytest.mark.parametrize("n,B,k", [(500, 3, 10), (700, 2, 50), (30, 2, 50)])
def test_unsplit_accept_matches_jax(n, B, k):
    """``topk_with_bounds`` on (ppr, p) against JAX's ``_topk_with_bounds``:
    ids equal under the shared tie rule (value descending, id ascending,
    with exact ties planted), values and bounds within rtol 1e-6."""
    p, ppr = _tied_estimate(np.random.default_rng(n), n, B)
    t = bounds.union_bound_t(n, 3, 1.0 / n)
    omega = 3.0e5
    want = jax_bounds._topk_with_bounds(jnp.asarray(ppr), jnp.asarray(p),
                                        jnp.float32(omega), k=k, t=t, eps=EPS)
    got = bounds.topk_with_bounds(torch.from_numpy(ppr), torch.from_numpy(p),
                                  omega, k, t, EPS)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[6].numpy(), np.asarray(want[6]))
    for i in (0, 2, 3, 4, 5):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   rtol=1e-6, atol=0)
    # the split accept on (p, ppr - p) ranks the same f32 sums
    split = bounds.topk_with_bounds_split(
        torch.from_numpy(p), torch.from_numpy(ppr - p), omega, k, t, EPS)
    assert torch.equal(split[1], got[1])
    kk = min(k, n)
    vals, ids = topk_ops.topk_nodes(torch.from_numpy(ppr), kk)
    jv, ji = jax_topk_ops.topk_nodes(jnp.asarray(ppr), kk)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def _smoke():
    z = np.load("bench_data_smoke/rmat12x8s7.npz")
    g = CSRGraph(**{k: z[k] for k in CSRGraph._fields if k in z.files})
    rcfg = ForaConfig(epsilon=EPS, k=K).resolved(g.n, g.m)
    return g, rcfg, qio.generate_sources(g, 64, seed=8)


def _raw_runner(g, **kw):
    return TopkRunner(to_device(g, merge_duplicate_edges=True, hub_rows=256,
                                device="cpu"),
                      TorchForaConfig(epsilon=EPS, k=K).resolved(g.n, g.m),
                      k=K, delta_stride=8.0, **kw)


def test_raw_runner_precision_vs_jax():
    """The raw-walk runner on the smoke graph: precision@50 of the smoke
    exact file's 4 queries no lower than JAX's raw runner less 0.02 (4 of
    200 ids), every query accepted, no walk dropped."""
    g, rcfg, sources = _smoke()
    src = sources[:8]
    jr = jax_topk.TopkRunner(
        jax_to_device(g, merge_duplicate_edges=True, hub_rows=256), rcfg,
        k=K, delta_stride=8.0)
    want = jr.query_pool(src, jax.random.key(1), batch=8, start_level=0)
    tr = _raw_runner(g)
    got = tr.query_pool(src, 1, batch=8, start_level=0)
    ex = np.load(SMOKE_EXACT)["ids"]
    p_j = metrics.batch_precision_at_k(want.node_ids[:4], ex)
    p_t = metrics.batch_precision_at_k(got.node_ids[:4], ex)
    assert p_t >= p_j - 0.02, (p_t, p_j)
    assert got.accepted.all() and got.values.shape == (8, K)
    assert (got.node_ids[:, 0] == src).all()
    assert (got.lower_bounds <= got.values + 1e-7).all()
    for st in tr.last_level_stats:
        assert st["overflow"] == 0 and st["supersteps"] > 0
        assert st["lanes"] >= st["walks_total"] >= st["walks_max"] > 0
        assert set(st["ms"]) == {"push", "alloc", "walks", "accum",
                                 "accept"}


def test_raw_runner_query_flush_and_seeds():
    """``query`` and a deferred pool + ``flush_deferred`` answer every
    query; a given key replays its walks, and calls without one draw new
    walks."""
    g, _, sources = _smoke()
    src = sources[8:14]
    tr = _raw_runner(g)
    res = tr.query(src, key=3)
    assert res.accepted.all() and (res.node_ids[:, 0] == src).all()
    again = _raw_runner(g).query(src, key=3)
    np.testing.assert_array_equal(again.values, res.values)
    other = tr.query(src)
    assert not np.array_equal(other.values, res.values)
    pool = tr.query_pool(src, batch=4, start_level=0, defer_below=8)
    assert pool.deferred.any()
    dsrcs, dres = tr.flush_deferred(batch=4)
    assert dres is not None and dres.accepted.all()
    answered = set(src[~pool.deferred].tolist()) | set(dsrcs.tolist())
    assert answered == set(src.tolist())


def test_level_stats_keep_modes_apart(tmp_path):
    g, rcfg, sources = _smoke()
    raw = _raw_runner(g)
    raw.query_pool(sources[:4], 0, batch=4)
    raw.save_level_stats(tmp_path / "raw.json", "sha")
    assert _raw_runner(g).load_level_stats(tmp_path / "raw.json", "sha")
    indexed = TopkRunner(
        to_device(g, device="cpu"), raw.rcfg, k=K, delta_stride=8.0,
        index=tidx.load("bench_data_smoke/rmat12x8s7.idx.e0.5", raw.rcfg))
    assert not indexed.load_level_stats(tmp_path / "raw.json", "sha")


@pytest.mark.parametrize("num_walks,B,budget", [(100, 4, 1000), (7, 3, 1),
                                                (1 << 22, 32, 1 << 30)])
def test_montecarlo_chunks(num_walks, B, budget):
    chunks = montecarlo.montecarlo_chunks(num_walks, B, budget)
    assert sum(chunks) == num_walks and min(chunks) >= 1
    assert max(chunks) * B <= max(budget, B)


def test_montecarlo_chunked_weights_and_seeds(monkeypatch):
    """Split into chunks by a small lane budget (the CPU's constant
    patched): each column's estimate sums to 1, and no two chunks share a
    seed."""
    g = generators.rmat(9, 4096, seed=3)
    rcfg = TorchForaConfig(epsilon=0.5, delta=0.01, pfail=0.01).resolved(
        g.n, g.m)
    seeds = []
    real = walk.walk_endpoints

    def recording(graph, start, seed, alpha, max_hops):
        seeds.append(seed)
        return real(graph, start, seed, alpha, max_hops)

    monkeypatch.setattr(walk, "walk_endpoints", recording)
    monkeypatch.setattr(walk, "CPU_LANE_BUDGET", 3 * 1000)
    fn = montecarlo.make_montecarlo_fn(to_device(g, device="cpu"), rcfg,
                                       max_walks=2500)
    est = fn(np.array([1, 2, 5]), 9)
    assert fn.num_walks == 2500 and len(seeds) == 3
    assert len(set(seeds)) == len(seeds)
    np.testing.assert_allclose(est.sum(0).numpy(), 1.0, rtol=1e-5)


def test_montecarlo_chi_square_vs_exact():
    """Endpoint counts (estimate x walks) of each query against its exact
    PPR, and JAX's Monte Carlo on the same config within the same L1 of
    exact PPR."""
    g = jax_generators.karate_club()
    rcfg = TorchForaConfig(epsilon=0.5, delta=0.01, pfail=0.01).resolved(
        g.n, g.m)
    fn = montecarlo.make_montecarlo_fn(to_device(g, device="cpu"), rcfg,
                                       max_walks=100_000)
    sources = [0, 33]
    est = fn(np.array(sources), 4).double().numpy()
    pi = jax_exact.exact_ppr_power_batch(g, sources, threads=1)
    counts = np.rint(est * fn.num_walks)
    np.testing.assert_allclose(counts.sum(0), fn.num_walks)
    for b in range(len(sources)):
        assert chisquare_pvalue(counts[:, b], pi[:, b]) > 1e-3
    from fora_tpu.algo import montecarlo as jax_mc
    jest = np.asarray(jax_mc.make_montecarlo_fn(
        jax_to_device(g), ForaConfig(epsilon=0.5, delta=0.01, pfail=0.01)
        .resolved(g.n, g.m), max_walks=100_000)(jnp.array(sources),
                                                jax.random.key(4)))
    l1 = np.abs(est - pi).sum(0)
    assert (l1 < 0.12).all() and (np.abs(jest - pi).sum(0) < 0.12).all()


def test_entry_step_matches_exact():
    """``entry()``: the raw-walk top-10 of 8 sources on its ER graph, each
    source first in its own list, precision@10 >= 0.9 against exact PPR
    (JAX's entry on the same graph asserts the same)."""
    step, args = entry("cpu")
    vals, ids = step(*args)
    assert vals.shape == ids.shape == (8, 10)
    assert (ids[:, 0].numpy() == np.arange(8)).all()
    g = generators.erdos_renyi(512, 4096, seed=3)
    ex = np.stack([jax_exact.exact_topk(g, s, 10)[0] for s in range(8)])
    assert metrics.batch_precision_at_k(ids.numpy(), ex) >= 0.9
