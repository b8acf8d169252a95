"""K4's plain twin and plan on the CPU: ``ops.walk.run_walks_philox``
draws the walk kernel's Philox-4x32-10 words in PyTorch, so on a card the
kernel is held to it bit for bit (tests/test_torch_kernels_cuda.py,
chip_smoke.py); here it is held to Random123's known answers, to exact
PPR and to JAX's walks by chi-square (tests/walk_chisq.py), and the
kernel's warp-owned walk queue (``kernels/csrc/walk.cu``) is emulated lane
by lane against it.  ``kernels.schedule.walk_plan`` is checked to cover
every walk once.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from walk_chisq import (assert_endpoints_follow, chisquare_pvalue,
                        two_sample_pvalue)

from fora_tpu.algo import exact as jax_exact
from fora_tpu.algo import hubppr as jax_hubppr
from fora_tpu.graph import generators as jax_generators
from fora_tpu.graph import to_device as jax_to_device
from fora_tpu.ops import walk as jax_walk
from fora_tpu_torch import kernels
from fora_tpu_torch.algo import exact, hubppr
from fora_tpu_torch.graph import from_edges, generators, to_device
from fora_tpu_torch.kernels import schedule
from fora_tpu_torch.ops import walk

torch.set_num_threads(2)

M32 = 0xFFFFFFFF


# ---- Philox-4x32-10 --------------------------------------------------------

@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((M32,) * 4, (M32, M32),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))],
    ids=["zeros", "ones", "pi"])
def test_philox_known_answers(ctr, key, want):
    """Random123's known answers for philox4x32_10, on int64 tensors (as
    the plain walk computes them) and on Python ints."""
    got = walk.philox4x32_10([torch.tensor([c, c]) for c in ctr],
                             [torch.tensor([k, k]) for k in key])
    for g, w in zip(got, want):
        assert g.dtype == torch.int64 and g.tolist() == [w, w]
    assert tuple(walk.philox4x32_10(ctr, key)) == want


def test_mulhilo32_exact():
    """The 16-bit split gives the exact 64-bit product's words, extremes
    included, without leaving int64."""
    rng = np.random.default_rng(0)
    b = np.concatenate([[0, 1, 0xFFFF, 0x10000, M32],
                        rng.integers(0, 2**32, 2000)]).astype(np.int64)
    for a in (0xD2511F53, 0xCD9E8D57, M32):
        hi, lo = walk._mulhilo32(a, torch.from_numpy(b))
        full = [a * int(x) for x in b]
        assert hi.tolist() == [p >> 32 for p in full]
        assert lo.tolist() == [p & M32 for p in full]


# ---- graphs ------------------------------------------------------------------

def _weighted_rmat(n_log2=9, m=4096, seed=7):
    """An RMAT multigraph with dangling nodes, weighted exp2(U(-2, 2))."""
    g0 = generators.rmat(n_log2, m, seed=seed)
    src = np.repeat(np.arange(g0.n), g0.out_deg)
    w = np.exp2(np.random.default_rng(seed + 31).uniform(-2, 2, g0.m))
    return from_edges(src, g0.out_indices, g0.n, w=w.astype(np.float32))


def _graph(branch):
    """(graph, device graph, hub index or None) of each K4 branch."""
    if "alias" in branch:
        g = _weighted_rmat()
        dg = to_device(g, merge_duplicate_edges=True, device="cpu")
    else:
        g = generators.rmat(9, 4096, seed=5)
        dg = to_device(g, device="cpu")
    hub = (hubppr.build_hub_index(dg, 4, alpha=0.2, num_hubs=6,
                                  pool_size=1 << 14)
           if "hub" in branch else None)
    return g, dg, hub


BRANCHES = ["uniform", "alias", "hub", "hub_alias"]


# ---- the plain walk against exact PPR and JAX --------------------------------

def test_philox_walks_follow_exact_ppr():
    g = jax_generators.karate_club()
    dg = to_device(g, device="cpu")
    ends = walk.run_walks_philox(dg, torch.zeros(1 << 17, dtype=torch.int32),
                                 3, 0.2, 64)
    assert ends.dtype == torch.int32 and ends.shape == (1 << 17,)
    assert_endpoints_follow(ends.numpy(), jax_exact.exact_ppr_dense(g, 0))


def test_philox_alias_walks_follow_weighted_oracle():
    """The alias hop against weighted exact PPR; the same walks with the
    tables dropped (uniform hops) fail it."""
    g = _weighted_rmat()
    dg = to_device(g, merge_duplicate_edges=True, device="cpu")
    src = int(np.argmax(g.out_deg))
    pi = exact.exact_ppr_batch(g, [src], device="cpu").numpy()[:, 0]
    start = torch.full((1 << 16,), src, dtype=torch.int32)
    ends = walk.run_walks_philox(dg, start, 9, 0.2, 64)
    assert_endpoints_follow(ends.numpy(), pi)
    flat = dataclasses.replace(dg, alias_prob=None, alias_other=None)
    uni = walk.run_walks_philox(flat, start, 9, 0.2, 64).numpy()
    assert chisquare_pvalue(np.bincount(uni, minlength=g.n), pi) < 1e-3


@pytest.mark.parametrize("weighted", [False, True])
def test_philox_hub_walks_match_plain_hub_walk(weighted):
    """With a hub index the plain Philox walk agrees with
    hubppr.hub_walks_plain (two-sample chi-square) and with exact PPR
    (weighted: the weighted oracle)."""
    g, dg, hub = _graph("hub_alias" if weighted else "hub")
    src = int(np.nonzero((np.asarray(g.out_deg) > 2)
                         & (hub.hub_id.numpy() < 0))[0][0])
    W = 1 << 14
    start = torch.full((W,), src, dtype=torch.int32)
    ends = walk.run_walks_philox(dg, start, 11, 0.2, 64, hub=hub).numpy()
    plain = hubppr.hub_walks_plain(
        dg, start, hub, generator=torch.Generator().manual_seed(12),
        alpha=0.2).numpy()
    assert two_sample_pvalue(ends, plain) > 1e-3
    pi = exact.exact_ppr_batch(g, [src], device="cpu").numpy()[:, 0]
    assert_endpoints_follow(ends, pi)


@pytest.mark.parametrize("weighted", [False, True])
def test_philox_walks_match_jax_scheduled(weighted):
    """Against JAX's run_walks_scheduled (alias hops on the weighted
    graph) from the same starts: two-sample chi-square on the CPU."""
    g = _weighted_rmat() if weighted else generators.rmat(9, 4096, seed=5)
    kw = dict(merge_duplicate_edges=True) if weighted else {}
    dg = to_device(g, device="cpu", **kw)
    src = int(np.argmax(g.out_deg))
    W = 1 << 15
    ends = walk.run_walks_philox(dg, torch.full((W,), src,
                                                dtype=torch.int32), 4, 0.2, 64)
    jends, ok = jax_walk.run_walks_scheduled(
        jax_to_device(g, **kw), jnp.full((W,), src, jnp.int32),
        jax.random.key(5), alpha=0.2)
    assert bool(ok)
    assert two_sample_pvalue(ends.numpy(), np.asarray(jends).ravel()) > 1e-3


def test_philox_hub_walks_match_jax_hub_walks():
    """Against JAX's hub_walks over the same hub index on an unweighted
    graph (on a weighted one JAX hops uniformly: ROADMAP C14)."""
    g, dg, hub = _graph("hub")
    src = int(np.nonzero((np.asarray(g.out_deg) > 2)
                         & (hub.hub_id.numpy() < 0))[0][0])
    W = 1 << 14
    ends = walk.run_walks_philox(dg, torch.full((W,), src, dtype=torch.int32),
                                 13, 0.2, 64, hub=hub)
    jhub = jax_hubppr.HubIndex(jnp.asarray(hub.hub_nodes.numpy()),
                               jnp.asarray(hub.hub_id.numpy()),
                               jnp.asarray(hub.pool.numpy()))
    jends = jax_hubppr.hub_walks(jax_to_device(g),
                                 jnp.full((W, 1), src, jnp.int32),
                                 jax.random.key(14), jhub, alpha=0.2)
    assert two_sample_pvalue(ends.numpy(), np.asarray(jends).ravel()) > 1e-3


def test_philox_lengths_are_geometric():
    """On a long cycle a walk's distance from its start is its length:
    Geometric(0.2) (mean 4, P(0) = 0.2), capped at max_hops."""
    g = jax_generators.cycle_graph(1000)
    dg = to_device(g, device="cpu")
    W = 1 << 18
    lens = walk.run_walks_philox(dg, torch.zeros(W, dtype=torch.int32), 11,
                                 0.2, 64).numpy() % 1000
    assert abs(lens.mean() - 4.0) < 0.05
    assert abs((lens == 0).mean() - 0.2) < 0.005
    assert lens.max() <= 64
    capped = walk.run_walks_philox(dg, torch.zeros(W, dtype=torch.int32), 11,
                                   0.2, 3).numpy() % 1000
    assert capped.max() == 3 and np.array_equal(np.minimum(lens, 3), capped)


# ---- schedule independence -------------------------------------------------

@pytest.mark.parametrize("branch", BRANCHES)
def test_endpoint_depends_on_seed_walk_and_start_only(branch):
    """Walk w's endpoint is a function of (seed, w, start[w]): changing
    the starts at other positions leaves it bit-equal, a different seed
    or start does not."""
    g, dg, hub = _graph(branch)
    rng = np.random.default_rng(3)
    W = 4096
    a = rng.integers(0, g.n, W).astype(np.int32)
    b = rng.integers(0, g.n, W).astype(np.int32)
    keep = rng.random(W) < 0.5
    b[keep] = a[keep]
    seed = 0x1234_5678_9ABC_DEF0
    ea = walk.run_walks_philox(dg, torch.from_numpy(a), seed, 0.2, 64,
                               hub=hub)
    eb = walk.run_walks_philox(dg, torch.from_numpy(b), seed, 0.2, 64,
                               hub=hub)
    assert torch.equal(ea[keep], eb[keep])
    assert not torch.equal(ea[~keep], eb[~keep])
    # a prefix, a shape and the walks alone at their own positions
    assert torch.equal(walk.run_walks_philox(
        dg, torch.from_numpy(a[:100]), seed, 0.2, 64, hub=hub), ea[:100])
    assert torch.equal(walk.run_walks_philox(
        dg, torch.from_numpy(a).view(64, 64), seed, 0.2, 64, hub=hub),
        ea.view(64, 64))
    other = walk.run_walks_philox(dg, torch.from_numpy(a), seed + 1, 0.2, 64,
                                  hub=hub)
    assert not torch.equal(other, ea)


def _emulate_walk_kernel(dg, start, seed, alpha, max_hops, hub, k):
    """csrc/walk.cu's algorithm lane by lane on the CPU: each warp owns
    32 k consecutive walks; a lookahead holds the next 32 walks' starts
    and lengths; the lanes without a walk take from it in lane order (the
    ballot's prefix count), walks of length 0 end in the refill, and each
    step moves every live walk one hop.  The hub branch looks up the node
    a hop reached right after the hop.  Each walk must be written once."""
    start = start.tolist()
    W = len(start)
    lengths = walk.walk_lengths(seed, W, alpha, max_hops, "cpu").tolist()
    indptr = dg.out_indptr.tolist()
    indices = dg.out_indices.tolist()
    alias = dg.alias_prob is not None
    if alias:
        prob = dg.alias_prob.numpy()
        other = dg.alias_other.tolist()
    if hub is not None:
        hub_id = hub.hub_id.tolist()
        pool = hub.pool.numpy()
        P = np.float32(hub.pool_size)
    lo_s, hi_s = seed & M32, seed >> 32
    unit = lambda x: np.float32(x >> 8) * np.float32(2.0**-24)  # noqa: E731
    out = [None] * W

    def end(w, cur):
        assert out[w] is None, f"walk {w} written twice"
        out[w] = cur

    def pool_entry(hid, u3):
        return int(pool[hid, min(int(u3 * P), hub.pool_size - 1)])
    R = 32 * k
    for lo in range(0, W, R):
        count = min(R, W - lo)
        lanes = [None] * 32          # [w, cur, h, len] or None
        batch = filled = used = 0
        while True:
            while True:
                need = [i for i in range(32) if lanes[i] is None]
                if not need:
                    break
                if used == filled:
                    batch += filled
                    filled = used = 0
                    if batch >= count:
                        break
                    filled = min(32, count - batch)
                for rank, i in enumerate(need):
                    src = used + rank
                    if src < filled:
                        w = lo + batch + src
                        if lengths[w] > 0:
                            lanes[i] = [w, start[w], 0, lengths[w]]
                        else:
                            end(w, start[w])
                used = min(filled, used + len(need))
            if all(s is None for s in lanes):
                break
            for i, s in enumerate(lanes):
                if s is None:
                    continue
                w, cur, h, L = s
                if indptr[cur + 1] == indptr[cur]:
                    end(w, cur)
                    lanes[i] = None
                    continue
                r = walk.philox4x32_10((h + 1, hi_s, 0, 0), (lo_s, w))
                d = indptr[cur + 1] - indptr[cur]
                slot = indptr[cur] + min(int(unit(r[0]) * np.float32(d)),
                                         d - 1)
                nxt = indices[slot]
                if alias and not unit(r[1]) < prob[slot]:
                    nxt = other[slot]
                s[1], s[2] = nxt, h + 1
                if hub is not None and hub_id[nxt] >= 0:
                    end(w, pool_entry(hub_id[nxt], unit(r[2])))
                    lanes[i] = None
                elif h + 1 == L:
                    end(w, nxt)
                    lanes[i] = None
    assert None not in out
    return torch.tensor(out, dtype=torch.int32)


@pytest.mark.parametrize("branch", BRANCHES)
@pytest.mark.parametrize("W,k", [(1, 1), (31, 1), (33, 1), (64, 2),
                                 (129, 2), (512, 16), (513, 16), (1000, 4),
                                 (2047, 8)])
def test_walk_queue_emulation_bit_equal(branch, W, k):
    """The kernel's warp-owned walk queue, emulated, gives
    run_walks_philox's endpoints bit for bit at sizes around a lane and a
    warp's range, at each walks per lane the plan takes and the larger
    ones that chip_smoke.py's sweep times; so no schedule of the walks
    changes a result."""
    g, dg, hub = _graph(branch)
    rng = np.random.default_rng(W + k)
    start = torch.as_tensor(rng.integers(0, g.n, W).astype(np.int32))
    seed = (0x9E3779B97F4A7C15 * (W + 1)) % 2**64
    want = walk.run_walks_philox(dg, start, seed, 0.2, 64, hub=hub)
    got = _emulate_walk_kernel(dg, start, seed, 0.2, 64, hub, k)
    assert torch.equal(got, want)


# ---- the plain walk at the edges ---------------------------------------------

@pytest.mark.parametrize("branch", BRANCHES)
def test_philox_max_hops_zero_and_one(branch):
    """max_hops 0: every walk ends at its start; max_hops 1: at most one
    hop (and a hub branch's lookup of where it landed), so every endpoint
    is the start, an out-neighbour of it or a pool entry."""
    g, dg, hub = _graph(branch)
    start = torch.arange(g.n, dtype=torch.int32).repeat(8)
    assert torch.equal(walk.run_walks_philox(dg, start, 1, 0.2, 0, hub=hub),
                       start)
    one = walk.run_walks_philox(dg, start, 1, 0.2, 1, hub=hub).numpy()
    indptr, indices = dg.out_indptr.numpy(), dg.out_indices.numpy()
    pool = set(hub.pool.numpy().ravel().tolist()) if hub else set()
    for s, e in zip(start.numpy(), one):
        assert (e == s or e in indices[indptr[s]:indptr[s + 1]]
                or e in pool), (s, e)
    assert (one != start.numpy()).mean() > 0.5


def test_philox_dangling_absorbs():
    dg = to_device(jax_generators.star_graph(5), device="cpu")
    leaf = walk.run_walks_philox(dg, torch.full((4096,), 3,
                                                dtype=torch.int32), 2, 0.2, 64)
    assert bool((leaf == 3).all())


def test_philox_hub_on_last_hop_and_hub_start():
    """An 8-cycle with a poisoned pool at node 1: walks capped at one hop
    from node 0 reach the hub on their last hop and end at the poison;
    walks that start on the hub never substitute there: each ends as many
    nodes on as its length."""
    dg = to_device(jax_generators.cycle_graph(8), device="cpu")
    hub_id = torch.full((8,), -1, dtype=torch.int32)
    hub_id[1] = 0
    hub = hubppr.HubIndex(torch.tensor([1], dtype=torch.int32), hub_id,
                          torch.full((1, 16), 5, dtype=torch.int32))
    W = 1 << 14
    last = walk.run_walks_philox(dg, torch.zeros(W, dtype=torch.int32), 2,
                                 0.2, 1, hub=hub)
    assert set(last.unique().tolist()) == {0, 5}
    ends = walk.run_walks_philox(dg, torch.ones(W, dtype=torch.int32), 3,
                                 0.2, 7, hub=hub)
    # within 7 hops no walk comes back to node 1: each ends its length on
    lens = walk.walk_lengths(3, W, 0.2, 7, "cpu")
    assert torch.equal(ends.long(), (1 + lens) % 8)
    assert abs(float((ends == 1).float().mean()) - 0.2) < 0.02


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("layout", ["plain", "merged_hub_split"])
def test_out_deg_is_indptr_difference(weighted, layout):
    """K4 takes a node's degree as out_indptr[v + 1] - out_indptr[v] and
    no longer reads out_deg: the two agree on every graph to_device
    builds."""
    g = _weighted_rmat() if weighted else generators.rmat(9, 4096, seed=5)
    kw = (dict(merge_duplicate_edges=True, hub_rows=16)
          if layout == "merged_hub_split" else {})
    dg = to_device(g, device="cpu", **kw)
    assert torch.equal(dg.out_deg.long(), torch.diff(dg.out_indptr.long()))
    assert (dg.out_deg == 0).any()


# ---- the plan ----------------------------------------------------------------

@settings(max_examples=300, deadline=None)
@given(W=st.integers(1, 2**32 - 1), sms=st.integers(1, 132),
       probe=st.integers(0, 2**32), forced=st.sampled_from([None, 1, 3, 16]))
def test_walk_plan_covers_every_walk_once(W, sms, probe, forced):
    """By range arithmetic: warp i owns [32 k i, min(32 k (i + 1), W)), the
    warps that own walks are contiguous, disjoint and cover 0 .. W - 1
    exactly once, the grid's spare warps own none, and a probed walk lies
    in exactly the warp its index names; with the plan's k or a forced
    one (``walk_grid``, as chip_smoke.py's sweep forces it)."""
    plan = (schedule.walk_plan(W, sms) if forced is None
            else schedule.walk_grid(W, forced))
    R = plan.range_walks
    assert plan.walks_per_lane == (forced or plan.walks_per_lane)
    assert 1 <= plan.walks_per_lane <= schedule.WALKS_PER_LANE_MAX
    assert (plan.warps - 1) * R < W <= plan.warps * R
    grid = plan.blocks * schedule.WALK_BLOCK_WARPS
    assert plan.warps <= grid < plan.warps + schedule.WALK_BLOCK_WARPS
    assert grid * R < 2**63 and plan.blocks < 2**31
    assert plan.warp_range(0, W)[0] == 0
    assert plan.warp_range(plan.warps - 1, W)[1] == W
    for i in {0, plan.warps // 2, max(plan.warps - 2, 0), plan.warps - 1}:
        lo, hi = plan.warp_range(i, W)
        assert lo < hi and hi - lo <= R
        assert hi == plan.warp_range(i + 1, W)[0] or hi == W
    for i in range(plan.warps, grid):
        lo, hi = plan.warp_range(i, W)
        assert lo == hi == W
    w = probe % W
    lo, hi = plan.warp_range(w // R, W)
    assert lo <= w < hi


@pytest.mark.parametrize("sms", [1, 8, 66, 114, 132])
@pytest.mark.parametrize("log2", [22, 23, 26, 30])
def test_walk_plan_at_large_launches(sms, log2):
    """k = 4 from 2^22 walks up (Monte Carlo, HubPPR's queries and pool,
    the index build's 2^23 launches), on any card up to 132 SMs: the
    fastest k there on the H100 or within 3% of it (chip_smoke.py's
    sweep)."""
    assert schedule.walk_plan(1 << log2, sms).walks_per_lane == \
        schedule.WALKS_PER_LANE == 4


@pytest.mark.parametrize("sms", [1, 16, 132])
def test_walk_plan_fills_half_the_card(sms):
    """Below k = 4 the plan takes the largest k whose warps fill half of
    the card's resident warps: the warps at k hold half, at 2 k not; a
    launch too small for that at k = 1 runs one walk per lane."""
    half = sms * schedule.WALK_RESIDENT_WARPS // 2
    for W in [1, 7, 31, 32, 33, 1000] + [1 << e for e in range(10, 26)]:
        plan = schedule.walk_plan(W, sms)
        k = plan.walks_per_lane
        assert k in (1, 2, 4)
        if k > 1:
            assert W >= 32 * k * half
        if k < 4:
            assert W < 32 * 2 * k * half
    ks = [schedule.walk_plan(1 << e, sms).walks_per_lane
          for e in range(0, 28)]
    assert ks == sorted(ks) and ks[0] == 1 and ks[-1] == 4


def test_walk_plan_refuses():
    for bad in (0, 2**32):
        with pytest.raises(ValueError, match="W ="):
            schedule.walk_plan(bad, 132)
    for k in (0, schedule.WALKS_PER_LANE_MAX + 1):
        with pytest.raises(ValueError, match="walks_per_lane"):
            schedule.walk_grid(100, k)
    with pytest.raises(ValueError, match="sm_count"):
        schedule.walk_plan(100, 0)


def test_walk_wrappers_take_cuda_tensors_only():
    """The kernel wrappers refuse CPU tensors and count nothing; the CPU
    path is walk_endpoints' plain run_walks."""
    dg = to_device(jax_generators.cycle_graph(8), device="cpu")
    start = torch.zeros(10, dtype=torch.int32)
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.index_walk(start, dg.out_indptr, dg.out_indices, 1, 0.2, 64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.philox_blocks(torch.zeros(256, dtype=torch.int32))
    assert kernels.launch_counts() == before
    assert kernels.inv_log1m_alpha(0.2) == float(np.float32(
        1.0 / math.log1p(-0.2)))
