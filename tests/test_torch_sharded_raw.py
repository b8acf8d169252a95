"""The sharded raw walk of fora_tpu_torch on the CPU, against the port's
unsharded walks and against fora_tpu's raw-walk ShardedForaEngine.

  - the plain forms of K4's sharded form (``ops.walk.run_walks`` and
    ``run_walks_philox`` over a ``ShardedOutCSR``, the out-CSR cut into G
    row slices by ``index.build_sharded._shard_csr``) bit-equal to the
    same functions on the unsharded graph: G 1, 2, 3, 4 and 8, uniform and
    weighted, n not divisible by G (pad rows), starts on every shard,
    dangling nodes, ``max_hops`` 0;
  - the sharded walk phase (``ops.walk.sharded_walk_phase``) from
    residues whose concatenation is r: after P2 (the plain reduce-scatter)
    the single-device ``walk_phase`` contribution at the same seed, within
    rtol 1e-6 / atol 1e-7 (the float32 sums run in another order), in one
    chunk and in several;
  - ``ShardedForaEngine(index=None)`` against JAX's raw-walk engine on the
    8-device CPU mesh, meshes (8, 1), (4, 2) and (2, 4): top-10 precision
    against JAX's ``exact_topk`` >= 0.85 for both (as
    ``tests/test_sharded.py:69-82``), and the walk terms in distribution:
    the endpoints of the sharded phase's walks from one source against
    JAX's ``run_walks`` (two-sample chi-square) and against exact PPR;
  - determinism at a fixed seed, the store's walk side bit-equal to the
    in-RAM slices, the weighted engine against the weighted oracle, and
    the refusals (a store without its walk side; ``ShardedTopkRunner``
    without an index).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from walk_chisq import chisquare_pvalue, two_sample_pvalue

from fora_tpu.algo import exact as jax_exact
from fora_tpu.config import ForaConfig as JaxForaConfig
from fora_tpu.eval import metrics
from fora_tpu.graph import generators as jax_generators
from fora_tpu.graph import to_device as jax_to_device
from fora_tpu.ops import walk as jax_walk
from fora_tpu.parallel import ShardedForaEngine as JaxEngine
from fora_tpu.parallel import make_mesh as jax_make_mesh
from fora_tpu_torch import ForaConfig
from fora_tpu_torch.algo import exact
from fora_tpu_torch.graph import from_edges, to_device
from fora_tpu_torch.graph.csr import CSRGraph
from fora_tpu_torch.index.build_sharded import shard_out_csr
from fora_tpu_torch.ops import push, ring
from fora_tpu_torch.ops import walk as walk_ops
from fora_tpu_torch.parallel import (ShardedForaEngine, ShardedGraphStore,
                                     ShardedTopkRunner, make_mesh,
                                     save_sharded_graph)

torch.set_num_threads(2)

CPU = torch.device("cpu")
SOURCES = np.array([3, 17, 42, 99, 123, 200, 250, 287])


def _graph(weighted: bool, n: int = 1003, m: int = 9000, seed: int = 5):
    """A random multigraph of ``n`` nodes (not a multiple of 8) whose last
    tenth are dangling, weighted exp2(U(-2, 2)) where asked."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n - n // 10, m)
    dst = rng.integers(0, n, m)
    w = np.exp2(rng.uniform(-2, 2, m)) if weighted else None
    return from_edges(src, dst, n, w=w)


def port_graph(g) -> CSRGraph:
    return CSRGraph(**{f: getattr(g, f) for f in CSRGraph._fields})


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("G", [1, 2, 3, 4, 8])
def test_sharded_walks_bit_equal_unsharded(G, weighted):
    """Both plain walks over the slices give the unsharded endpoints bit
    for bit: run_walks from the same generator draws, run_walks_philox
    from the same Philox words, from every node (so every shard and every
    dangling node) 16 times, and with max_hops 0 every walk ends where it
    starts."""
    g = _graph(weighted)
    dg = to_device(g, device=CPU)
    csr = shard_out_csr(g, [CPU] * G)
    assert G * csr.n_loc > g.n          # pad rows on the last shard
    start = torch.arange(g.n, dtype=torch.int32).repeat(16)
    for hops in (64, 0):
        a = walk_ops.run_walks(dg, start, alpha=0.2, max_hops=hops,
                               generator=torch.Generator().manual_seed(3))
        b = walk_ops.run_walks(csr, start, alpha=0.2, max_hops=hops,
                               generator=torch.Generator().manual_seed(3))
        assert torch.equal(a, b)
        seed = 0x9E3779B97F4A7C15 * (G + 1) % 2**64
        a = walk_ops.run_walks_philox(dg, start, seed, 0.2, hops)
        b = walk_ops.run_walks_philox(csr, start, seed, 0.2, hops)
        assert torch.equal(a, b)
        if hops == 0:
            assert torch.equal(b, start)
    # the public entry takes the slices too, on the CPU the plain walk
    assert torch.equal(walk_ops.walk_endpoints(csr, start, 9, 0.2, 64),
                       walk_ops.walk_endpoints(dg, start, 9, 0.2, 64))
    # dangling nodes absorb
    dang = torch.as_tensor(np.nonzero(np.asarray(g.out_deg) == 0)[0],
                           dtype=torch.int32)
    assert len(dang) and torch.equal(
        walk_ops.run_walks_philox(csr, dang, 4, 0.2, 64), dang)


def _split_residue(r: torch.Tensor, G: int, n_loc: int) -> list:
    full = torch.zeros(G * n_loc, r.shape[1])
    full[:r.shape[0]] = r
    return [full[h * n_loc:(h + 1) * n_loc].clone() for h in range(G)]


@pytest.mark.parametrize("budget", [None, 4096])
@pytest.mark.parametrize("G", [2, 3, 4])
def test_sharded_walk_phase_matches_walk_phase(G, budget, monkeypatch):
    """From the shards' residues (a real push's, cut into G blocks), the
    sharded walk phase's partials summed by P2 equal walk_phase's
    contribution at the same seed (rtol 1e-6, atol 1e-7), with the same
    walks demanded and chunks; ``budget`` forces chunks of few lanes (a
    column's lanes split too)."""
    if budget is not None:
        monkeypatch.setattr(walk_ops, "CPU_LANE_BUDGET", budget)
    g = _graph(False)
    dg = to_device(g, device=CPU)
    rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
    st = push.forward_push(dg, torch.as_tensor(SOURCES, dtype=torch.int32),
                           rmax=rcfg.rmax, alpha=rcfg.alpha)
    want, info = walk_ops.walk_phase(dg, st.r, rcfg.omega_unit, 5, 0.2, 64)
    csr = shard_out_csr(g, [CPU] * G)
    rs = _split_residue(st.r, G, csr.n_loc)
    parts, got_info = walk_ops.sharded_walk_phase(csr, rs, rcfg.omega_unit,
                                                  5, 0.2, 64)
    assert len(parts) == G and parts[0].shape == (G * csr.n_loc, 8)
    got = torch.cat(ring.ring_reduce_scatter(parts))[:g.n]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
    assert (got_info.walks_total, got_info.walks_max, got_info.chunks) == \
        (info.walks_total, info.walks_max, info.chunks)
    assert torch.equal(got_info.total, info.total)
    assert not got_info.overflow.any()
    if budget is not None:
        assert info.chunks > len(SOURCES)


def _jax_setup():
    g = jax_generators.erdos_renyi(300, 3000, seed=21)
    return g, JaxForaConfig(epsilon=0.5).resolved(g.n, g.m)


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2), (2, 4)])
def test_raw_engine_precision_vs_jax(mesh_shape):
    """Top-10 of the port's raw one-shot and of JAX's on the same mesh
    shape: both at precision >= 0.85 against exact top-10, each source
    at the top of its own list, no walk dropped."""
    g, rcfg = _jax_setup()
    exact_ids = np.stack([jax_exact.exact_topk(g, int(s), 10)[0]
                          for s in SOURCES])
    jeng = JaxEngine(g, jax_make_mesh(*mesh_shape), rcfg, k=10)
    jres = jeng.topk(jnp.asarray(SOURCES), jax.random.key(1))
    teng = ShardedForaEngine(port_graph(g),
                             make_mesh(*mesh_shape, devices=["cpu"] * 8),
                             rcfg, k=10)
    tres = teng.topk(SOURCES, 1)
    assert teng.placement.walk is not None and teng.e_loc_total == 0
    assert tres.node_ids.shape == (8, 10) and not tres.walk_overflow.any()
    assert (tres.node_ids[:, 0] == SOURCES).all()
    assert np.all(np.diff(tres.values, axis=1) <= 1e-7)
    p_t = metrics.batch_precision_at_k(tres.node_ids, exact_ids)
    p_j = metrics.batch_precision_at_k(np.asarray(jres.node_ids), exact_ids)
    assert p_t >= 0.85 and p_j >= 0.85, (p_t, p_j)


def test_raw_walk_terms_in_distribution_vs_jax():
    """The sharded walk phase's walks from one source (a one-hot residue
    on shard 2 of 4: every walk weighs 1 / omega, so omega times the
    contribution counts the endpoints) against JAX's lockstep run_walks
    from the same source (two-sample chi-square) and against exact PPR
    (chi-square), both at p > 1e-3; JAX's sharded walk is bit-identical to
    its run_walks (fora_tpu/ops/walk.py:236-241)."""
    g, _ = _jax_setup()
    tg = port_graph(g)
    G, src = 4, 250
    csr = shard_out_csr(tg, [CPU] * G)
    omega = float(1 << 17)         # weights 2^-17: exact float32 sums
    r = torch.zeros(tg.n, 1)
    r[src, 0] = 1.0
    rs = _split_residue(r, G, csr.n_loc)
    assert rs[src // csr.n_loc].sum() == 1.0 and src // csr.n_loc == 3
    parts, info = walk_ops.sharded_walk_phase(csr, rs, omega, 7, 0.2, 64)
    assert info.walks_total == int(omega)
    counts = torch.cat(ring.ring_reduce_scatter(parts))[:tg.n, 0] * omega
    counts = np.rint(counts.double().numpy()).astype(np.int64)
    assert counts.sum() == int(omega)
    ends_t = np.repeat(np.arange(tg.n), counts)
    start = jnp.full((int(omega) // 128, 128), src, jnp.int32)
    ends_j = np.asarray(jax_walk.run_walks(jax_to_device(g), start,
                                           jax.random.key(3), alpha=0.2))
    assert two_sample_pvalue(ends_t, ends_j) > 1e-3
    pi = jax_exact.exact_ppr(g, src)
    assert chisquare_pvalue(counts, pi) > 1e-3


def test_raw_engine_deterministic_and_seeded():
    """A fixed seed gives the same answer twice, another seed another
    answer, and without a seed the engine's own seed sequence advances."""
    g = _graph(False, n=600, m=6000)
    rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
    mesh = make_mesh(4, devices=["cpu"] * 4)
    eng = ShardedForaEngine(g, mesh, rcfg, k=10, exchange="routed")
    a, b = eng.topk(SOURCES, 5), eng.topk(SOURCES, 5)
    np.testing.assert_array_equal(a.node_ids, b.node_ids)
    np.testing.assert_array_equal(a.values, b.values)
    c = eng.topk(SOURCES, 6)
    assert not np.array_equal(a.values, c.values)
    own = [eng.topk(SOURCES).values for _ in range(2)]
    assert not np.array_equal(own[0], own[1]) and eng._calls == 2


@pytest.mark.parametrize("weighted", [False, True])
def test_raw_engine_from_store(weighted, tmp_path):
    """The raw one-shot from a ShardedGraphStore written with its walk
    side equals the in-RAM one bit for bit (the same slices); on the
    weighted graph its top-10 precision against the weighted oracle is at
    least 0.85."""
    g = _graph(weighted, n=600, m=6000)
    rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
    mesh = make_mesh(4, devices=["cpu"] * 4)
    save_sharded_graph(g, str(tmp_path), 4)
    store = ShardedGraphStore(str(tmp_path), 4)
    res = [ShardedForaEngine(x, mesh, rcfg, k=10).topk(SOURCES, 2)
           for x in (g, store)]
    np.testing.assert_array_equal(res[0].node_ids, res[1].node_ids)
    np.testing.assert_array_equal(res[0].values.view(np.uint32),
                                  res[1].values.view(np.uint32))
    x = exact.exact_ppr_batch(g, SOURCES, device="cpu")
    prec = metrics.batch_precision_at_k(res[0].node_ids,
                                        exact.topk_ids(x, 10))
    assert prec >= 0.85, prec


def test_raw_refusals(tmp_path):
    """A graph store written without its walk side cannot serve the raw
    walk, and the refinement pool still requires an index, as the
    reference's do."""
    g = _graph(False, n=400, m=3000)
    rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
    mesh = make_mesh(2, devices=["cpu"] * 2)
    save_sharded_graph(g, str(tmp_path), 2, with_walk_side=False)
    store = ShardedGraphStore(str(tmp_path), 2)
    with pytest.raises(ValueError, match="walk-side"):
        ShardedForaEngine(store, mesh, rcfg, k=10)
    with pytest.raises(ValueError, match="requires a walk index"):
        ShardedTopkRunner(g, mesh, rcfg, None, k=10)


def _xp_case(weighted: bool, G: int = 4):
    """A real push's residues on ``_graph`` over G shards, their demands,
    the chunk's running totals [G + 1, B] and the out-CSR's slices."""
    g = _graph(weighted)
    dg = to_device(g, device=CPU)
    rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
    st = push.forward_push(dg, torch.as_tensor(SOURCES, dtype=torch.int32),
                           rmax=rcfg.rmax, alpha=rcfg.alpha)
    csr = shard_out_csr(g, [CPU] * G)
    rs = _split_residue(st.r, G, csr.n_loc)
    ds, tot = walk_ops.walk_demands(rs, rcfg.omega_unit)
    tot = tot.long()
    bounds = torch.cat([torch.zeros_like(tot[:1]), tot.cumsum(0)])
    return csr, rs, ds, bounds, rcfg


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("L", [1, 2])
def test_xp_records_carry_their_length(L, weighted):
    """Every record that K6+K4-xp's plain version hands on, in every round
    of a chunk over G / L simulated processes, is (w, cur, h | len << 16,
    weight's bits): its length field is lengths_of(seed, w), its h at
    least 1 and below that length, its node in the destination's rows,
    and its walk's endpoint over the rounds is the one-process chunk's."""
    G, P = 4, 4 // L
    csr, rs, ds, bounds, rcfg = _xp_case(weighted, G)
    W, B, n_loc = int(bounds[-1].max()), len(SOURCES), csr.n_loc
    seed, a, hops = 11, rcfg.alpha, rcfg.max_walk_hops
    want = torch.full((W, B), -1, dtype=torch.int32)
    walk_ops.raw_walk_chunk_plain(csr, rs, ds, bounds, 0, W, n_loc, seed, a,
                                  hops, [torch.zeros(G * n_loc, B)] * G,
                                  ends=want)
    bnp = bounds.numpy()
    ends = torch.full((W, B), -1, dtype=torch.int32)
    seen = []

    def launch(q, r, inbox, box, cnt):
        own = bnp[q * L:q * L + L + 1]
        walk_ops.raw_walk_xp_chunk(
            csr.shards(q * L, (q + 1) * L), rs[q * L:(q + 1) * L],
            ds[q * L:(q + 1) * L], bounds[q * L:q * L + L + 1], 0, W,
            walk_ops.own_lanes(own, 0, W)[1] if r == 0 else 0, q * L, G,
            seed, a, hops, torch.zeros(G * n_loc, B), inbox, box, cnt,
            ends=ends)
        for d in range(P):
            rec = box[d, :int(cnt[d])].long()
            w, hl = rec[:, 0] & 0xFFFFFFFF, rec[:, 2]
            length, h = hl >> 16, hl & 0xFFFF
            assert torch.equal(length, walk_ops.lengths_of(seed, w, a, hops))
            assert bool((h >= 1).all() and (h < length).all())
            assert torch.equal(rec[:, 1] // (L * n_loc),
                               torch.full_like(w, d))
            seen.append(rec.shape[0])
    own = {q: walk_ops.own_lanes(bnp[q * L:q * L + L + 1], 0, W)[0]
           for q in range(P)}
    walk_ops.xp_chunk_rounds(launch, walk_ops.local_exchange, own, P, "cpu")
    assert (sum(seen) > 0) == (P > 1)
    assert torch.equal(ends, want)


def test_xp_refusals():
    """K6+K4-xp refuses a max_hops of 2^15 or more (a record holds lengths
    below 2^15), on the CPU's plain path and in the kernel's wrapper before
    it looks at a tensor, and a launch with both sources of walks."""
    from fora_tpu_torch import kernels
    csr, rs, ds, bounds, rcfg = _xp_case(False, 2)
    W, B, n_loc = int(bounds[-1].max()), len(SOURCES), csr.n_loc
    out = torch.zeros(2 * n_loc, B)
    box, cnt = torch.zeros((1, W * B, 4), dtype=torch.int32), \
        torch.zeros(1, dtype=torch.int32)
    empty = torch.zeros((0, 4), dtype=torch.int32)
    args = (csr, rs, ds, bounds, 0, W, W, 0, 2, 3, rcfg.alpha)
    with pytest.raises(ValueError, match="2\\^15"):
        walk_ops.raw_walk_xp_chunk(*args, 2**15, out, empty, box, cnt)
    walk_ops.raw_walk_xp_chunk(*args, 2**15 - 1, out, empty, box, cnt)
    with pytest.raises(ValueError, match="2\\^15"):
        kernels.raw_walk_xp(rs, [d.cum for d in ds], bounds, out, W, 0, W,
                            csr.indptr, csr.indices, None, None, 3,
                            rcfg.alpha, 2**15, 0, 2, box, cnt)
    with pytest.raises(ValueError, match="one source"):
        walk_ops.raw_walk_xp_chunk(*args, 64, out, box[0, :1], box, cnt)
