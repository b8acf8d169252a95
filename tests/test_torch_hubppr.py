"""HubPPR in fora_tpu_torch against fora_tpu, on the CPU: hub selection
(hub_nodes, hub_id array-equal to JAX's, a merged hub-split graph
included); the pool and the hub walks by chi-square against exact PPR
(``tests/walk_chisq.py``), unweighted and against the weighted oracle on a
weighted graph, where JAX's hub walk hops uniformly and fails the same
test (ROADMAP C14); the port's hub walk fed JAX's pool; the substitution
itself; the query and the pair estimates against exact PPR.

The pools here hold many more entries than the walks that reach each hub,
so that sharing a pool entry between walks (HubPPR's variance inflation,
1 + U/P) stays a few per cent and the multinomial chi-square applies."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from walk_chisq import assert_endpoints_follow, chisquare_pvalue

from fora_tpu.algo import exact as jax_exact
from fora_tpu.algo import hubppr as jax_hubppr
from fora_tpu.config import ForaConfig as JaxForaConfig
from fora_tpu.graph import generators as jax_generators
from fora_tpu.graph import to_device as jax_to_device
from fora_tpu_torch import ForaConfig, convert
from fora_tpu_torch.algo import exact, hubppr
from fora_tpu_torch.graph import from_edges, generators, to_device
from fora_tpu_torch.ops import walk as walk_ops
from fora_tpu_torch.ops.walk import run_walks

torch.set_num_threads(2)


def _weighted_rmat(n_log2=9, m=4096, seed=7):
    """An RMAT multigraph with dangling nodes, weighted exp2(U(-2, 2))."""
    g0 = generators.rmat(n_log2, m, seed=seed)
    src = np.repeat(np.arange(g0.n), g0.out_deg)
    w = np.exp2(np.random.default_rng(seed + 31).uniform(-2, 2, g0.m))
    return from_edges(src, g0.out_indices, g0.n, w=w.astype(np.float32))


def _karate():
    g = jax_generators.karate_club()
    return g, to_device(g, device="cpu")


@pytest.mark.parametrize("case", ["karate", "rmat_merged_hub_split",
                                  "weighted_rmat"])
def test_hub_selection_matches_jax(case):
    if case == "karate":
        g, kw = jax_generators.karate_club(), {}
    elif case == "rmat_merged_hub_split":
        g = generators.rmat(10, 8192, seed=3)
        kw = dict(merge_duplicate_edges=True, hub_rows=64)
    else:
        g, kw = _weighted_rmat(), dict(merge_duplicate_edges=True)
    dg = to_device(g, device="cpu", **kw)
    hub = hubppr.build_hub_index(dg, 1, alpha=0.2, num_hubs=12,
                                 pool_size=64)
    jhub = jax_hubppr.build_hub_index(jax_to_device(g, **kw),
                                      jax.random.key(0), alpha=0.2,
                                      num_hubs=12, pool_size=64)
    np.testing.assert_array_equal(hub.hub_nodes.numpy(),
                                  np.asarray(jhub.hub_nodes))
    np.testing.assert_array_equal(hub.hub_id.numpy(), np.asarray(jhub.hub_id))
    assert hub.pool.shape == (hub.num_hubs, 64) and hub.pool_size == 64
    assert hub.pool.dtype == torch.int32
    assert 0 <= int(hub.pool.min()) and int(hub.pool.max()) < g.n
    assert np.all(hub.hub_id.numpy()[hub.hub_nodes.numpy()] ==
                  np.arange(hub.num_hubs))
    np.testing.assert_array_equal(
        hubppr.select_hubs(g.out_deg, g.in_deg, 4),
        jax_hubppr.select_hubs(g.out_deg, g.in_deg, 4))


def test_hub_selection_excludes_dangling():
    g = jax_generators.star_graph(6)
    assert hubppr.select_hubs(g.out_deg, g.in_deg, 4).tolist() == [0]


def test_default_pool_size_matches_jax():
    """Up to 2^15 walks a query the port's default pool is JAX's; past
    that JAX stops at 2^15 entries and the port keeps P >= the walks while
    the hubs' pools fit POOL_BYTES (ROADMAP C15), never below 2^15."""
    for eps, walks in ((0.5, 1), (0.5, 3000), (0.5, 1 << 15)):
        rcfg = ForaConfig(epsilon=eps).resolved(1000, 9000)
        jrc = JaxForaConfig(epsilon=eps).resolved(1000, 9000)
        for hubs in (16, 256, 1 << 20):
            assert hubppr.default_pool_size(rcfg, walks, hubs) == \
                jax_hubppr.default_pool_size(jrc, walks)
    rcfg = ForaConfig(epsilon=0.1).resolved(1000, 9000)
    jrc = JaxForaConfig(epsilon=0.1).resolved(1000, 9000)
    assert jax_hubppr.default_pool_size(jrc, 1 << 22) == 1 << 15
    assert hubppr.default_pool_size(rcfg, 1 << 22, 256) == 1 << 22
    assert hubppr.default_pool_size(rcfg, 10**6, 256) == 1 << 20
    assert hubppr.default_pool_size(rcfg, 1 << 22, 4096) == 1 << 18
    assert hubppr.default_pool_size(rcfg, 1 << 22, 1 << 20) == 1 << 15
    assert 256 * 4 * (1 << 22) <= hubppr.POOL_BYTES


@pytest.mark.parametrize("weighted", [False, True])
def test_pool_follows_exact_ppr(weighted):
    """Each hub's pool: P independent walks from the hub, so a multinomial
    sample of its PPR vector (w/W transitions on the weighted graph)."""
    if weighted:
        g = _weighted_rmat()
        dg = to_device(g, merge_duplicate_edges=True, device="cpu")
    else:
        g, dg = _karate()
    hub = hubppr.build_hub_index(dg, 2, alpha=0.2, num_hubs=4,
                                 pool_size=1 << 14)
    pi = exact.exact_ppr_batch(g, hub.hub_nodes.numpy(), device="cpu").numpy()
    for h in range(hub.num_hubs):
        assert_endpoints_follow(hub.pool[h].numpy(), pi[:, h])


def test_pool_chunks_over_the_lane_budget(monkeypatch):
    """With room for two hubs' pools per launch, five hubs take three
    chunks, each from its own seed; the pools still follow exact PPR."""
    g, dg = _karate()
    starts = []
    real = hubppr.walk_endpoints

    def counted(graph, start, seed, alpha, max_hops):
        starts.append((start.shape[0], seed))
        return real(graph, start, seed, alpha, max_hops)
    monkeypatch.setattr(walk_ops, "CPU_LANE_BUDGET", 2 << 12)
    monkeypatch.setattr(hubppr, "walk_endpoints", counted)
    hub = hubppr.build_hub_index(dg, 3, alpha=0.2, num_hubs=5,
                                 pool_size=1 << 12)
    assert [w for w, _ in starts] == [2 << 12, 2 << 12, 1 << 12]
    assert len({s for _, s in starts}) == 3
    pi = exact.exact_ppr_batch(g, hub.hub_nodes.numpy(), device="cpu").numpy()
    for h in range(5):
        assert_endpoints_follow(hub.pool[h].numpy(), pi[:, h])


def test_hub_walks_follow_exact_ppr():
    """Hub walks from a low-degree node of karate against exact PPR."""
    g, dg = _karate()
    hub = hubppr.build_hub_index(dg, 4, alpha=0.2, num_hubs=4,
                                 pool_size=1 << 17)
    ends = hubppr.hub_walks(dg, torch.full((1 << 14,), 11, dtype=torch.int32),
                            5, hub, alpha=0.2)
    assert ends.dtype == torch.int32 and ends.shape == (1 << 14,)
    assert_endpoints_follow(ends.numpy(), jax_exact.exact_ppr_dense(g, 11))


def test_weighted_hub_walks_follow_weighted_oracle():
    """On a weighted graph the port's hub walk takes the alias hop and
    passes the chi-square against the weighted oracle; JAX's hub_walks
    (uniform hops, weighted pool: ROADMAP C14) fails the same test."""
    g = _weighted_rmat()
    dg = to_device(g, merge_duplicate_edges=True, device="cpu")
    s = int(np.argmax(g.out_deg))
    hub = hubppr.build_hub_index(dg, 6, alpha=0.2, num_hubs=8,
                                 pool_size=1 << 16)
    assert int(hub.hub_id[s]) >= 0
    src = int(np.nonzero((g.out_deg > 3) & (hub.hub_id.numpy() < 0))[0][0])
    pi = exact.exact_ppr_batch(g, [src], device="cpu").numpy()[:, 0]
    W = 1 << 15
    ends = hubppr.hub_walks(dg, torch.full((W,), src, dtype=torch.int32), 7,
                            hub, alpha=0.2)
    assert_endpoints_follow(ends.numpy(), pi)
    jhub = convert_pool_to_jax(hub)
    jends = np.asarray(jax_hubppr.hub_walks(
        jax_to_device(g, merge_duplicate_edges=True),
        jnp.full((W, 1), src, jnp.int32), jax.random.key(8), jhub,
        alpha=0.2)).ravel()
    counts = np.bincount(jends, minlength=g.n)
    assert chisquare_pvalue(counts, pi) < 1e-3


def convert_pool_to_jax(hub):
    return jax_hubppr.HubIndex(jnp.asarray(hub.hub_nodes.numpy()),
                               jnp.asarray(hub.hub_id.numpy()),
                               jnp.asarray(hub.pool.numpy()))


def test_port_hub_walks_on_jax_pool():
    """JAX's hub index (its pool drawn by its own walks) through
    convert.hub_index_from_numpy drives the port's hub walk, which then
    follows exact PPR."""
    g, dg = _karate()
    jhub = jax_hubppr.build_hub_index(jax_to_device(g), jax.random.key(9),
                                      alpha=0.2, num_hubs=4,
                                      pool_size=1 << 15)
    hub = convert.hub_index_from_numpy(jhub, device="cpu")
    assert hub.pool.dtype == torch.int32 and hub.pool.shape == (4, 1 << 15)
    ends = hubppr.hub_walks(dg, torch.full((1 << 13,), 20, dtype=torch.int32),
                            10, hub, alpha=0.2)
    assert_endpoints_follow(ends.numpy(), jax_exact.exact_ppr_dense(g, 20))


def test_hub_walks_cycle_with_hub_on_path():
    """On an 8-cycle every walk from 0 that lives two hops meets the hub at
    node 2; the endpoints still follow the exact chain."""
    n = 8
    g = jax_generators.cycle_graph(n)
    dg = to_device(g, device="cpu")
    hub_id = torch.full((n,), -1, dtype=torch.int32)
    hub_id[2] = 0
    pool = run_walks(dg, torch.full((1 << 16,), 2, dtype=torch.int32),
                     generator=torch.Generator().manual_seed(3),
                     alpha=0.2)[None, :]
    hub = hubppr.HubIndex(torch.tensor([2], dtype=torch.int32), hub_id, pool)
    ends = hubppr.hub_walks(dg, torch.zeros(1 << 13, dtype=torch.int32), 4,
                            hub, alpha=0.2)
    assert_endpoints_follow(ends.numpy(), jax_exact.exact_ppr_dense(g, 0))


def test_hub_walks_substitution_executes():
    """A poisoned pool shows that arriving at the hub reads the pool: on a
    cycle with the hub at node 1 every walk that takes a hop ends at the
    poison node; walks that take none end at the source (P = alpha)."""
    n, poison = 8, 5
    g = jax_generators.cycle_graph(n)
    dg = to_device(g, device="cpu")
    hub_id = torch.full((n,), -1, dtype=torch.int32)
    hub_id[1] = 0
    hub = hubppr.HubIndex(torch.tensor([1], dtype=torch.int32), hub_id,
                          torch.full((1, 16), poison, dtype=torch.int32))
    ends = hubppr.hub_walks(dg, torch.zeros(20_000, dtype=torch.int32), 5,
                            hub, alpha=0.2).numpy()
    assert set(np.unique(ends)) <= {0, poison}
    assert abs((ends == 0).mean() - 0.2) < 0.02


def test_hub_walks_start_never_substitutes():
    """A walk that starts on a hub and takes no hop ends there."""
    g, dg = _karate()
    hub_id = torch.full((g.n,), -1, dtype=torch.int32)
    hub_id[0] = 0
    hub = hubppr.HubIndex(torch.tensor([0], dtype=torch.int32), hub_id,
                          torch.full((1, 4), 9, dtype=torch.int32))
    ends = hubppr.hub_walks(dg, torch.zeros(20_000, dtype=torch.int32), 6,
                            hub, alpha=0.2).numpy()
    assert abs((ends == 0).mean() - 0.2) < 0.02 and (ends != 9).sum() > 0


@pytest.mark.parametrize("budget", [None, 3 * 4096])
def test_make_hubppr_fn_accuracy(monkeypatch, budget):
    """The CLI's estimator on karate (4 hubs, walks = pool size): each
    column within L1 0.1 of exact PPR with its mass exactly 1, whether the
    walks run in one chunk or (a small lane budget) in several."""
    g, dg = _karate()
    if budget is not None:
        monkeypatch.setattr(walk_ops, "CPU_LANE_BUDGET", budget)
    rcfg = ForaConfig(epsilon=0.15).resolved(g.n, g.m)
    fn = hubppr.make_hubppr_fn(dg, rcfg, 6, num_hubs=4, max_walks=1 << 15)
    assert fn.hub_index.num_hubs == 4
    src = [0, 7, 20]
    ppr = fn(np.array(src), 7).numpy()
    assert ppr.shape == (g.n, 3)
    for b, s in enumerate(src):
        assert np.abs(ppr[:, b] - jax_exact.exact_ppr_dense(g, s)).sum() < 0.1
        np.testing.assert_allclose(ppr[:, b].sum(), 1.0, rtol=1e-5)


def test_shared_pool_inflates_error_in_both_packages():
    """Walks that reach a hub share its pool's entries.  At 128 walks a
    query per pool entry (2^22 against JAX's 2^15 cap at bench scale; here
    4096 against 32 on an RMAT 2^9 with 16 hubs) both packages' HubPPR
    estimates miss exact PPR by a squared error at least 4x their own
    Monte Carlo's at the same walks; with a pool as large as the walks,
    under 2x.  Run with -s for the figures."""
    from fora_tpu.algo import montecarlo as jax_mc
    from fora_tpu_torch.algo import montecarlo
    g = jax_generators.rmat(9, 4096, seed=7)
    jdg, dg = jax_to_device(g), to_device(g, device="cpu")
    rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
    jrc = JaxForaConfig(epsilon=0.5).resolved(g.n, g.m)
    H, W = 16, 4096
    hubs = hubppr.select_hubs(g.out_deg, g.in_deg, H)
    cand = np.nonzero((g.out_deg > 0) & ~np.isin(np.arange(g.n), hubs))[0]
    src = np.random.default_rng(1).choice(cand, 16, replace=False)
    src = src.astype(np.int32)
    pi = exact.exact_ppr_batch(g, src, device="cpu").numpy()

    def err(est):
        return float(((np.asarray(est, np.float64) - pi) ** 2).sum(0).mean())
    jquery = jax.jit(jax_hubppr.hubppr_query,
                     static_argnames=("rcfg", "num_walks"))
    mc = {"jax": err(jax_mc.montecarlo_query(
              jdg, jnp.asarray(src), jax.random.key(30), rcfg=jrc,
              num_walks=W)),
          "port": err(montecarlo.montecarlo_query(dg, src, 30, rcfg=rcfg,
                                                  num_walks=W))}
    for P in (W // 128, W):
        jhub = jax_hubppr.build_hub_index(jdg, jax.random.key(10), alpha=0.2,
                                          num_hubs=H, pool_size=P)
        hub = hubppr.build_hub_index(dg, 10, alpha=0.2, num_hubs=H,
                                     pool_size=P)
        ratio = {"jax": err(jquery(jdg, jnp.asarray(src), jax.random.key(20),
                                   jhub, rcfg=jrc, num_walks=W)) / mc["jax"],
                 "port": err(hubppr.hubppr_query(dg, src, 20, hub, rcfg=rcfg,
                                                 num_walks=W)) / mc["port"]}
        print(f"pool {P} for {W} walks: squared error over Monte Carlo's "
              f"jax {ratio['jax']:.2f}, port {ratio['port']:.2f}")
        for pkg, r in ratio.items():
            assert (r > 4.0) if P < W else (r < 2.0), (pkg, P, r)


def test_hubppr_pairs_vs_exact():
    g = jax_generators.erdos_renyi(40, 200, seed=9)
    dg = to_device(g, device="cpu")
    rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
    hub = hubppr.build_hub_index(dg, 8, alpha=rcfg.alpha, num_hubs=6,
                                 pool_size=4096)
    est = hubppr.hubppr_pairs(dg, [0, 3], [1, 7, 11], 10, hub, rcfg=rcfg,
                              rmax_b=1e-3, num_walks=30_000).numpy()
    for i, s in enumerate([0, 3]):
        pi = jax_exact.exact_ppr_dense(g, s)
        for j, t in enumerate([1, 7, 11]):
            assert abs(est[i, j] - pi[t]) < 0.02
