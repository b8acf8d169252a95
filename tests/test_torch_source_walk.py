"""K6+K4-src's plain version and the constant chunk plans of the walk paths,
on the CPU.

``ops.walk.source_walk_chunk_plain`` is the reference that the card's
K6+K4-src (``kernels.source_walk``, Monte Carlo's and HubPPR's chunk in
one launch) is held to: ``run_walks_philox`` on ``sources.repeat(rows)``
(walk t * B + b from sources[b]; with the hub index, K4-hub's pool draws)
then the endpoints' scatter-add.  Here its endpoints and sums are held to
that chain, and its walks to exact PPR and to JAX's ``montecarlo_query``
and ``hubppr_query`` by chi-square.  The chunk plans of every walk path
(``walk_phase``, ``sharded_walk_phase``, ``make_montecarlo_fn``,
``make_hubppr_fn``'s queries and pool, BiPPR's ``walk_term``) are shown to
be constants of the device's type, whatever the card's memory readings
say.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from walk_chisq import chisquare_pvalue

from fora_tpu.algo import hubppr as jax_hubppr
from fora_tpu.algo import montecarlo as jax_mc
from fora_tpu.config import ForaConfig as JaxForaConfig
from fora_tpu.graph import generators as jax_generators
from fora_tpu.graph import to_device as jax_to_device
from fora_tpu_torch import ForaConfig
from fora_tpu_torch.algo import bippr, exact, hubppr, montecarlo
from fora_tpu_torch.graph import from_edges, generators, to_device
from fora_tpu_torch.index.build_sharded import shard_out_csr
from fora_tpu_torch.ops import push, walk

torch.set_num_threads(2)

ALPHA, HOPS = 0.2, 64


def _weighted_rmat(n_log2=9, m=4096, seed=7):
    """An RMAT multigraph with dangling nodes, weighted exp2(U(-2, 2))."""
    g0 = generators.rmat(n_log2, m, seed=seed)
    src = np.repeat(np.arange(g0.n), g0.out_deg)
    w = np.exp2(np.random.default_rng(seed + 31).uniform(-2, 2, g0.m))
    return from_edges(src, g0.out_indices, g0.n, w=w.astype(np.float32))


def _case(branch):
    """(graph, device graph, hub index or None) of a branch: karate
    (uniform, hub with 4 hubs) or a weighted RMAT 2^9 (alias)."""
    if branch == "alias":
        g = _weighted_rmat()
        return g, to_device(g, merge_duplicate_edges=True, device="cpu"), None
    g = jax_generators.karate_club()
    dg = to_device(g, device="cpu")
    hub = (hubppr.build_hub_index(dg, 3, alpha=ALPHA, num_hubs=4,
                                  pool_size=1 << 14)
           if branch == "hub" else None)
    return g, dg, hub


# ---- C16: every walk path plans from constants -----------------------------

def _patch_memory(monkeypatch, reading):
    """The card's free-memory readings, patched to ``reading`` bytes free
    (and that much cached), or to raise."""
    if reading is None:
        def fail(*a, **k):
            raise AssertionError("a chunk plan read the card's memory")
        for name in ("mem_get_info", "memory_reserved", "memory_allocated"):
            monkeypatch.setattr(torch.cuda, name, fail)
        return
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (reading, 80 << 30))
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda device=None: 2 * reading)
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda device=None: reading)


@pytest.mark.parametrize("reading", [1 << 20, 60 << 30, None])
def test_card_chunk_plans_are_constants(monkeypatch, reading):
    """For a CUDA device, under free-memory readings of 1 MiB, 60 GiB or
    ones that raise: the walk phases' chunks (walk_phase,
    sharded_walk_phase: plan_chunks under chunk_lanes), the source-rooted
    paths' (make_montecarlo_fn, make_hubppr_fn's queries, walk_term:
    source_chunks) and the hub pool's hubs a launch (pool_chunk_hubs) are
    the plans of the constant CHUNK_LANES."""
    _patch_memory(monkeypatch, reading)
    cuda = torch.device("cuda")
    cap = walk.CHUNK_LANES
    assert walk.chunk_lanes(cuda) == walk.chunk_lanes("cuda:1") == cap
    tot = np.array([27_000_000, 3 * cap, 0, 5, cap - 7, cap // 3, 1 << 20])
    assert walk.plan_chunks(tot, walk.chunk_lanes(cuda)) == \
        walk.plan_chunks(tot, cap)
    assert len(walk.plan_chunks(tot, cap)) == 7
    for nw, B in ((1 << 22, 32), (1 << 22, 64), (12_700_000, 16), (7, 3)):
        assert montecarlo.source_chunks(nw, B, cuda) == \
            montecarlo.montecarlo_chunks(nw, B, cap)
    assert montecarlo.source_chunks(1 << 22, 32, cuda) == [1 << 22]
    assert montecarlo.source_chunks(1 << 22, 64, cuda) == [1 << 21] * 2
    for P in (1 << 22, 1 << 15, 4096, 3 << 28):
        assert hubppr.pool_chunk_hubs(P, cuda) == max(1, cap // P)
    assert walk.chunk_lanes("cpu") == walk.CPU_LANE_BUDGET


def test_walk_paths_plan_through_the_constants(monkeypatch):
    """Each walk path takes its chunk plan from the planning functions
    above on its own device (recorded on the CPU): walk_phase and
    sharded_walk_phase from chunk_lanes, Monte Carlo, HubPPR's queries and
    BiPPR's walk term from source_chunks, the hub pool from
    pool_chunk_hubs."""
    seen = []

    def spy(name, fn):
        def wrapped(*a):
            seen.append((name, a[-1]))
            return fn(*a)
        return wrapped
    real = montecarlo.source_chunks
    monkeypatch.setattr(walk, "chunk_lanes", spy("walk", walk.chunk_lanes))
    monkeypatch.setattr(montecarlo, "source_chunks", spy("source", real))
    monkeypatch.setattr(bippr, "source_chunks", spy("bippr", real))
    monkeypatch.setattr(hubppr, "source_chunks", spy("hub query", real))
    monkeypatch.setattr(hubppr, "pool_chunk_hubs",
                        spy("hub pool", hubppr.pool_chunk_hubs))
    g = generators.rmat(9, 4096, seed=2)
    rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
    dg = to_device(g, device="cpu")
    st = push.forward_push(dg, torch.tensor([1, 2]), rmax=rcfg.rmax * 4,
                           alpha=ALPHA)
    walk.walk_phase(dg, st.r, rcfg.omega_unit, 5, ALPHA, HOPS)
    csr = shard_out_csr(g, ["cpu"] * 2)
    full = torch.zeros(2 * csr.n_loc, 2)
    full[:g.n] = st.r
    walk.sharded_walk_phase(csr, list(full.split(csr.n_loc)),
                            rcfg.omega_unit, 5, ALPHA, HOPS)
    montecarlo.make_montecarlo_fn(dg, rcfg, max_walks=512)([1, 2], 3)
    hubppr.make_hubppr_fn(dg, rcfg, 4, num_hubs=4, max_walks=512,
                          pool_size=1024)([1, 2], 3)
    bippr.bippr_pairs(dg, [0, 5], [9, 2], 1, rcfg=rcfg, rmax_b=1e-2,
                      num_walks=256)
    names = [n for n, _ in seen]
    for name in ("walk", "source", "hub query", "hub pool", "bippr"):
        assert name in names, name
    assert names.count("walk") >= 2
    assert all(torch.device(d).type == "cpu" for _, d in seen)


@pytest.mark.parametrize("budget", [2048, 1 << 24])
def test_estimates_equal_under_two_memory_readings(monkeypatch, budget):
    """walk_phase and make_montecarlo_fn planning as on a card (the CUDA
    device's chunk_lanes, CHUNK_LANES patched to ``budget``: many chunks
    or one) give bit-equal estimates under two free-memory readings, 64
    KiB and 60 GiB, where a plan read from free memory would cut other
    chunks and draw other walks."""
    real = walk.chunk_lanes

    def card(device):
        return real(torch.device("cuda"))
    monkeypatch.setattr(walk, "chunk_lanes", card)
    monkeypatch.setattr(montecarlo, "chunk_lanes", card)
    monkeypatch.setattr(walk, "CHUNK_LANES", budget)
    g = generators.rmat(9, 4096, seed=2)
    rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
    dg = to_device(g, device="cpu")
    st = push.forward_push(dg, torch.tensor([1, 2, 3]), rmax=rcfg.rmax * 4,
                           alpha=ALPHA)
    mc = montecarlo.make_montecarlo_fn(dg, rcfg, max_walks=3000)
    got = []
    for reading in (64 << 10, 60 << 30):
        _patch_memory(monkeypatch, reading)
        contrib, info = walk.walk_phase(dg, st.r, rcfg.omega_unit, 7, ALPHA,
                                        HOPS)
        got.append((contrib, info.chunks, mc([1, 2, 3], 9)))
    (c0, n0, m0), (c1, n1, m1) = got
    assert n0 == n1 and (n0 > 1) == (budget == 2048)
    assert torch.equal(c0, c1) and torch.equal(m0, m1)
    np.testing.assert_allclose(m0.sum(0).numpy(), 1.0, rtol=1e-5)


# ---- K6+K4-src's plain version ---------------------------------------------

@pytest.mark.parametrize("branch", ["uniform", "alias", "hub"])
def test_plain_source_walk_equals_the_chain(branch):
    """source_walk_chunk_plain: its endpoints equal run_walks_philox's on
    sources.repeat(rows) (walk t * B + b, with the hub index on the hub
    branch) bit for bit, its f32 sums pass PR 14's gate against the
    float64 sums of the same endpoints (each entry's count of adds exact,
    its error within gamma(N - 1) of the sum), and its float64 sums equal
    accumulate_endpoints_plain's."""
    g, dg, hub = _case(branch)
    src = torch.tensor([0, 5, 0, 33 % g.n, 17], dtype=torch.int32)
    rows, B, seed = 6000, 5, 0x5EED
    weight = float(np.float32(1.0 / rows))      # the terms of both sums
    ends = torch.full((rows, B), -1, dtype=torch.int32)
    out = torch.zeros(g.n, B)
    walk.source_walk_chunk_plain(dg, src, rows, seed, ALPHA, HOPS, weight,
                                 out, hub=hub, ends=ends)
    want = walk.run_walks_philox(dg, src.repeat(rows), seed, ALPHA, HOPS,
                                 hub=hub).view(rows, B)
    assert torch.equal(ends, want)
    out64 = torch.zeros(g.n, B, dtype=torch.float64)
    walk.source_walk_chunk_plain(dg, src, rows, seed, ALPHA, HOPS, weight,
                                 out64, hub=hub)
    plain = walk.accumulate_endpoints_plain(
        want, torch.full((rows, B), weight, dtype=torch.float64), g.n,
        torch.zeros(g.n, B, dtype=torch.float64))
    assert torch.equal(out64, plain)
    cnt = torch.zeros(g.n, B)
    walk.source_walk_chunk_plain(dg, src, rows, seed, ALPHA, HOPS, 1.0, cnt,
                                 hub=hub)
    cnt64 = torch.zeros(g.n, B, dtype=torch.float64).scatter_add_(
        0, want.long(), torch.ones(rows, B, dtype=torch.float64))
    assert torch.equal(cnt.double(), cnt64)
    k = (cnt64 - 1).clamp_min(0) * 2.0**-24
    assert bool(((out.double() - out64).abs() <= k / (1 - k) * out64).all())
    np.testing.assert_allclose(out64.sum(0).numpy(), rows * weight,
                               rtol=1e-12)


def test_plain_source_walk_columns_of_one_source_differ():
    """Two columns of one source draw other walks (keys t * B + b differ),
    and a column slice of a wider output takes the sums in place."""
    g, dg, _ = _case("uniform")
    src = torch.tensor([7, 7], dtype=torch.int32)
    ends = torch.empty(4096, 2, dtype=torch.int32)
    big = torch.full((g.n, 5), 3.0)
    walk.source_walk_chunk_plain(dg, src, 4096, 11, ALPHA, HOPS, 0.5,
                                 big[:, 1:3], ends=ends)
    assert not torch.equal(ends[:, 0], ends[:, 1])
    assert (big[:, [0, 3, 4]] == 3.0).all()
    np.testing.assert_allclose(big[:, 1:3].sum(0).numpy(),
                               3.0 * g.n + 2048.0)


def _jax_ends(branch, g, src, W, hub):
    """JAX's query on the same config: endpoint counts [n, B] of W walks
    a source (montecarlo_query, or hubppr_query on the port's pool), jit
    on the CPU, from the estimate x W."""
    jdg = jax_to_device(g, merge_duplicate_edges=branch == "alias")
    jrc = JaxForaConfig(epsilon=0.5).resolved(g.n, g.m)
    if branch == "hub":
        jhub = jax_hubppr.HubIndex(jnp.asarray(hub.hub_nodes.numpy()),
                                   jnp.asarray(hub.hub_id.numpy()),
                                   jnp.asarray(hub.pool.numpy()))
        fn = jax.jit(jax_hubppr.hubppr_query,
                     static_argnames=("rcfg", "num_walks"))
        est = fn(jdg, jnp.asarray(src), jax.random.key(3), jhub, rcfg=jrc,
                 num_walks=W)
    else:
        fn = jax.jit(jax_mc.montecarlo_query,
                     static_argnames=("rcfg", "num_walks"))
        est = fn(jdg, jnp.asarray(src), jax.random.key(3), rcfg=jrc,
                 num_walks=W)
    return np.rint(np.asarray(est, np.float64) * W)


@pytest.mark.parametrize("branch", ["uniform", "alias", "hub"])
def test_plain_source_walk_follows_exact_ppr_and_jax(branch):
    """The plain version's endpoint counts per source against exact PPR
    (the weighted oracle on the alias branch) by chi-square, and JAX's
    montecarlo_query (hubppr_query with the same pool on the hub branch)
    on the same sources passing the same test."""
    g, dg, hub = _case(branch)
    src = np.array([0, 9, 20] if branch != "alias" else [1, 70, 300],
                   np.int32)
    W = 1 << 14
    counts = torch.zeros(g.n, len(src))
    walk.source_walk_chunk_plain(dg, torch.as_tensor(src), W, 21, ALPHA,
                                 HOPS, 1.0, counts, hub=hub)
    pi = exact.exact_ppr_batch(g, src, device="cpu").numpy()
    jcounts = _jax_ends(branch, g, src, W, hub)
    for b in range(len(src)):
        assert chisquare_pvalue(counts[:, b].numpy(), pi[:, b]) > 1e-3
        assert chisquare_pvalue(jcounts[:, b], pi[:, b]) > 1e-3


@pytest.mark.parametrize("branch", ["uniform", "alias", "hub"])
def test_queries_on_the_cpu_keep_the_chain(branch):
    """On the CPU montecarlo_query and hubppr_query (through
    source_walk_chunk) give what the chain gives, bit for bit: the
    Generator's walks (walk_endpoints, hub_walks) on sources.repeat(W),
    then accumulate_endpoints of 1 / W."""
    g, dg, hub = _case(branch)
    rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
    src = torch.tensor([0, 3, 11], dtype=torch.int32)
    W = 3000
    if hub is None:
        got = montecarlo.montecarlo_query(dg, src, 13, rcfg=rcfg, num_walks=W)
        ends = walk.walk_endpoints(dg, src.repeat(W), 13, ALPHA,
                                   rcfg.max_walk_hops)
    else:
        got = hubppr.hubppr_query(dg, src, 13, hub, rcfg=rcfg, num_walks=W)
        ends = hubppr.hub_walks(dg, src.repeat(W), 13, hub, alpha=ALPHA,
                                max_hops=rcfg.max_walk_hops)
    want = walk.accumulate_endpoints(ends.view(W, 3), 1.0 / W, g.n)
    assert torch.equal(got, want)
