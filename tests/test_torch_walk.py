"""The port's walk phase against fora_tpu's: lane allocation (array-equal,
truncation included), endpoint accumulation, the static lane budget; and
its random pieces by chi-square against exact PPR (tests/walk_chisq.py):
the plain walk K4 is held to on the card, and the walks of a real raw-walk
allocation.  Also the seeds and chunking that replace JAX's static lanes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from walk_chisq import assert_endpoints_follow

from fora_tpu.algo import exact as jax_exact
from fora_tpu.graph import generators as jax_generators
from fora_tpu.ops import walk as jax_walk
from fora_tpu_torch import ForaConfig, to_device
from fora_tpu_torch.algo import exact
from fora_tpu_torch.graph import generators
from fora_tpu_torch.ops import push, walk

torch.set_num_threads(2)


def _residue(rng, n, B, density=0.3):
    r = rng.random((n, B)).astype(np.float32) * (rng.random((n, B))
                                                 < density)
    r[:, 0] = 0.0          # a column without walks
    return r


@pytest.mark.parametrize("n,B,W,omega_unit", [
    (50, 3, 64, 7.0),        # W below every column's total: truncation
    (200, 4, 4096, 33.3),    # W above: invalid lanes forward-fill
    (300, 5, 2048, 21.7),    # some columns over W, some under
    (64, 2, 1024, 1e-3)])    # ceil(r * omega) = 1 everywhere
def test_allocate_walks_matches_jax(n, B, W, omega_unit):
    r = _residue(np.random.default_rng(n + B), n, B)
    want = jax_walk.allocate_walks(jnp.asarray(r), omega_unit, W)
    got = walk.allocate_walks(torch.from_numpy(r), omega_unit, W)
    for f in want._fields:
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    if W == 64:
        assert got.overflow.any()


@pytest.mark.parametrize("lo,W", [(0, 3000), (1000, 1024), (2048, 4096),
                                  (5000, 64)])
def test_expand_lanes_range_is_a_slice(lo, W):
    """Lanes lo .. lo + W - 1 of a walk phase's chunk are rows lo .. of
    the allocation of every lane (start and weight), past the total
    included."""
    r = _residue(np.random.default_rng(7), 300, 4)
    rt = torch.from_numpy(r)
    d = walk.walk_demand(rt, 21.7)
    full = walk.allocate_walks(rt, 21.7, lo + W)
    start, weight, lanes, _ = walk.expand_lanes_plain(rt, d, lo, W)
    assert torch.equal(lanes, torch.arange(lo, lo + W, dtype=torch.int32))
    assert torch.equal(start, full.start[lo:])
    assert torch.equal(weight, full.weight[lo:])


def test_accumulate_endpoints_matches_jax():
    rng = np.random.default_rng(1)
    n, W, B = 300, 5000, 4
    ends = rng.integers(0, n, (W, B)).astype(np.int32)
    w = rng.random((W, B)).astype(np.float32)
    want = np.asarray(jax_walk.accumulate_endpoints(jnp.asarray(ends),
                                                    jnp.asarray(w), n))
    got = walk.accumulate_endpoints(torch.from_numpy(ends),
                                    torch.from_numpy(w), n).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("args", [(1e6, 1e-5, 10_000, 1000, 1 << 20),
                                  (6.8e7, 4.2e-8, 1 << 23, 1 << 19, None),
                                  (10.0, 1.0, 100, 50, None)])
def test_walk_lane_budget_matches_jax(args):
    assert walk.walk_lane_budget(*args) == jax_walk.walk_lane_budget(*args)


def test_derive_seed_distinct():
    seeds = {walk.derive_seed(call, level, lo, chunk)
             for call in range(3) for level in range(6)
             for lo in (0, 64, 128) for chunk in range(4)}
    assert len(seeds) == 3 * 6 * 3 * 4
    assert all(0 <= s < 2**64 for s in seeds)
    assert walk.derive_seed(5, 1) == walk.derive_seed(5, 1)
    assert walk.derive_seed(5, 1) != walk.derive_seed(5, 1, 0)


@pytest.mark.parametrize("total,budget", [
    ([3000, 0, 10, 5000, 4097], 16384),
    ([100_000, 5, 7], 8192),          # one column over the budget alone
    ([0, 0], 4096), ([2048] * 9, 4096)])
def test_plan_chunks_covers_every_walk(total, budget):
    chunks = walk.plan_chunks(total, budget)
    covered = np.zeros(len(total), np.int64)
    for c0, c1, lo, hi in chunks:
        assert (hi - lo) * (c1 - c0) <= budget and hi > lo
        assert hi % walk.LANE_MULTIPLE == 0
        assert c1 - c0 == 1 or lo == 0
        for b in range(c0, c1):
            assert lo == covered[b]
            covered[b] = min(hi, total[b]) if lo < total[b] else covered[b]
    np.testing.assert_array_equal(covered, total)


def test_walk_phase_chunks_conserve_mass(monkeypatch):
    """Split over many chunks (tiny budget) or not, the walk phase puts
    each column's whole residue mass on endpoints, and reports its demand
    with no overflow."""
    g = generators.rmat(9, 4096, seed=2)
    rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
    dg = to_device(g, device="cpu")
    st = push.forward_push(dg, torch.tensor([1, 2, 3, 4]), rmax=rcfg.rmax,
                           alpha=rcfg.alpha)
    want = walk.walk_demand(st.r, rcfg.omega_unit).total
    for budget in (1 << 24, 2048):
        monkeypatch.setattr(walk, "lane_budget", lambda dev, b=budget: b)
        contrib, info = walk.walk_phase(dg, st.r, rcfg.omega_unit, 7,
                                        rcfg.alpha, rcfg.max_walk_hops,
                                        live=3)
        assert torch.equal(info.total[:3], want[:3]) and info.total[3] == 0
        assert not info.overflow.any()
        assert info.walks_total == int(want[:3].sum())
        assert info.lanes >= info.walks_total
        assert (info.chunks == 1) == (budget > info.lanes)
        np.testing.assert_allclose(contrib.sum(0)[:3].numpy(),
                                   st.r.sum(0)[:3].numpy(), rtol=1e-5)
        assert float(contrib[:, 3].abs().sum()) == 0.0


def test_plain_walks_chi_square_vs_exact():
    """The plain walk (K4's reference on the card) from one node: endpoint
    counts against exact PPR."""
    g = jax_generators.karate_club()
    dg = to_device(g, device="cpu")
    W = 200_000
    ends = walk.walk_endpoints(dg, torch.zeros(W, dtype=torch.int32), 3,
                               0.2, 64)
    assert_endpoints_follow(ends.numpy(), jax_exact.exact_ppr_dense(g, 0))


def test_raw_allocation_walks_chi_square_vs_exact():
    """The walks of a real raw-walk allocation (push residue of one query,
    lanes from ``allocate_walks``): endpoint counts against the mixture
    sum_v omega_v pi_v of their start nodes' exact PPR."""
    g = generators.rmat(9, 4096, seed=5)
    rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
    dg = to_device(g, device="cpu")
    st = push.forward_push(dg, torch.tensor([17]), rmax=rcfg.rmax * 30,
                           alpha=rcfg.alpha)
    omega = rcfg.omega_unit
    total = int(walk.walk_demand(st.r, omega).total[0])
    alloc = walk.allocate_walks(st.r, omega, total)
    assert total > 20_000 and bool(alloc.valid.all())
    ends = walk.walk_endpoints(dg, alloc.start.view(-1), 11, rcfg.alpha,
                               rcfg.max_walk_hops)
    starts, per = np.unique(alloc.start.numpy(), return_counts=True)
    pi = exact.exact_ppr_batch(g, starts, device="cpu").numpy()
    assert_endpoints_follow(ends.numpy(), pi @ per)
