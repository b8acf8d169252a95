"""K6's entry points in ``fora_tpu_torch.ops.walk`` on the CPU, where they
run their plain versions: the raw walk's demand, lane expansion and
endpoint accumulate.

  - ``walk_demand`` / ``expand_lanes`` against JAX's
    ``fora_tpu.ops.walk.allocate_walks`` (start, valid, weight and total
    array-equal), with empty columns, lanes past a column's total and
    lane ranges that start past 0; ``accumulate_endpoints`` against JAX's
    at rtol 1e-6, its number weight equal to the array form;
  - ``expand_chunk_lanes``, every shard's lanes of a chunk written
    straight into its start and weight arrays, array-equal to the
    ``scatter_`` composition the sharded walk phase ran before (G = 2 and
    4, chunks that cut the shards' lanes), and
    ``accumulate_chunk_endpoints`` equal to a scatter-add per shard of
    its own lanes;
  - ``walk_phase`` and ``sharded_walk_phase`` bit-equal to their forms
    before K6 (kept below as ``*_before``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fora_tpu.ops import walk as jax_walk
from fora_tpu_torch import ForaConfig
from fora_tpu_torch.graph import generators, to_device
from fora_tpu_torch.index.build_sharded import shard_out_csr
from fora_tpu_torch.ops import push
from fora_tpu_torch.ops import walk

torch.set_num_threads(2)


def _residue(rng, n, B, density=0.3, empty=(0,)):
    r = rng.random((n, B)).astype(np.float32) * (rng.random((n, B))
                                                 < density)
    r[:, list(empty)] = 0.0          # columns without walks
    return r


@pytest.mark.parametrize("n,B,omega_unit", [(300, 5, 21.7), (257, 1, 40.0),
                                            (64, 3, 1e-3), (1000, 9, 3.3)])
def test_walk_demand_matches_jax(n, B, omega_unit):
    """cum and total against the JAX function's omega_v cumsum and total
    (an empty column where B > 1), omega_v against JAX's rule."""
    r = _residue(np.random.default_rng(n), n, B, empty=(0,) if B > 1 else ())
    d = walk.walk_demand(torch.from_numpy(r), omega_unit)
    want = jax_walk.allocate_walks(jnp.asarray(r), omega_unit, 64)
    np.testing.assert_array_equal(d.total.numpy(), np.asarray(want.total))
    omega = np.where(r > 0, np.ceil(r * np.float32(omega_unit)), 0)
    omega = omega.astype(np.int32)
    np.testing.assert_array_equal(d.omega_v.numpy(), omega)
    np.testing.assert_array_equal(d.cum.numpy(), np.cumsum(omega, axis=0))
    assert d.cum.T.is_contiguous()


@pytest.mark.parametrize("lo,W", [(0, 4096), (0, 64), (1000, 1024),
                                  (2048, 4096), (5000, 64), (137, 333)])
def test_expand_lanes_matches_jax(lo, W):
    """Lanes lo .. lo + W - 1 of each column: start and weight equal JAX's
    allocation of lo + W lanes from row lo on, its valid mask is lane <
    total; column 0 is empty (node 0, weight 0), and past a column's
    total the lanes take its last walked node at weight 0."""
    r = _residue(np.random.default_rng(7), 300, 5, empty=(0, 3))
    rt = torch.from_numpy(r)
    d = walk.walk_demand(rt, 21.7)
    start, weight = walk.expand_lanes(rt, d, lo, W)
    want = jax_walk.allocate_walks(jnp.asarray(r), 21.7, lo + W)
    np.testing.assert_array_equal(start.numpy(), np.asarray(want.start)[lo:])
    np.testing.assert_array_equal(weight.numpy(),
                                  np.asarray(want.weight)[lo:])
    lanes = np.arange(lo, lo + W)[:, None]
    np.testing.assert_array_equal(lanes < d.total.numpy()[None, :],
                                  np.asarray(want.valid)[lo:])
    assert (start[:, 0] == 0).all() and (weight[:, 0] == 0).all()
    assert (weight[:, 3] == 0).all()


def test_expand_lanes_of_a_column_slice():
    """Columns c0 .. c1 - 1 of the demand (``WalkDemand.columns``) over the
    residue's column slice expand as those columns of the whole."""
    r = torch.from_numpy(_residue(np.random.default_rng(3), 200, 7))
    d = walk.walk_demand(r, 13.0)
    W = int(d.total.max())
    start, weight = walk.expand_lanes(r, d, 0, W)
    s2, w2 = walk.expand_lanes(r[:, 2:6], d.columns(2, 6), 0, W)
    assert torch.equal(s2, start[:, 2:6]) and torch.equal(w2, weight[:, 2:6])


@pytest.mark.parametrize("B", [1, 4])
def test_accumulate_endpoints_matches_jax(B):
    rng = np.random.default_rng(B)
    n, W = 300, 5000
    ends = rng.integers(0, n, (W, B)).astype(np.int32)
    w = rng.random((W, B)).astype(np.float32)
    w[rng.random((W, B)) < 0.2] = 0.0          # padding lanes carry 0
    want = np.asarray(jax_walk.accumulate_endpoints(jnp.asarray(ends),
                                                    jnp.asarray(w), n))
    got = walk.accumulate_endpoints(torch.from_numpy(ends),
                                    torch.from_numpy(w), n).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_accumulate_endpoints_number_weight():
    """A number weight (Monte Carlo's and HubPPR's 1 / walks) equals the
    [W, B] array of it, into a fresh array and into a strided view."""
    rng = np.random.default_rng(5)
    ends = torch.from_numpy(rng.integers(0, 100, (3000, 6)).astype(np.int32))
    w = 1.0 / 3000
    full = torch.full(ends.shape, w, dtype=torch.float32)
    assert torch.equal(walk.accumulate_endpoints(ends, w, 100),
                       walk.accumulate_endpoints(ends, full, 100))
    a, b = torch.ones(100, 10), torch.ones(100, 10)
    walk.accumulate_endpoints(ends, w, 100, out=a[:, 2:8])
    walk.accumulate_endpoints(ends, full, 100, out=b[:, 2:8])
    assert torch.equal(a, b) and (a[:, :2] == 1).all()


def test_accumulate_chunk_endpoints_by_shard():
    """A chunk's lanes lane_lo + t go into the partial of the shard whose
    lanes (bounds) hold them, nowhere past bounds[G]: equal to each
    shard's own rows added alone, into column slices of wider arrays."""
    rng = np.random.default_rng(9)
    W, B, n, lo = 500, 4, 50, 100
    ends = torch.from_numpy(rng.integers(0, n, (W, B)).astype(np.int32))
    w = torch.from_numpy(rng.random((W, B)).astype(np.float32))
    bounds = torch.tensor([[0, 0, 0, 0], [150, 0, 90, 700],
                           [150, 320, 400, 700], [420, 560, 650, 800]],
                          dtype=torch.int64)
    outs = [torch.zeros(n, B + 2) for _ in range(3)]
    walk.accumulate_chunk_endpoints(ends, w, [o[:, 1:1 + B] for o in outs],
                                    bounds, lo)
    lane = lo + torch.arange(W)[:, None]
    for h in range(3):
        own = (lane >= bounds[h]) & (lane < bounds[h + 1])
        want = walk.accumulate_endpoints(ends, torch.where(own, w, 0.0), n)
        assert torch.equal(outs[h][:, 1:1 + B], want)
        assert (outs[h][:, 0] == 0).all() and (outs[h][:, -1] == 0).all()
    assert (outs[0][:, 2] == 0).all()          # shard 0 owns no lane of b = 1


def _shard_demands(rng, G, n_loc, B, omega):
    rs = [torch.from_numpy(_residue(rng, n_loc, B, empty=(h % B,)))
          for h in range(G)]
    ds = [walk.walk_demand(r, omega) for r in rs]
    tot = torch.stack([d.total for d in ds]).numpy().astype(np.int64)
    return rs, ds, tot, np.cumsum(tot, axis=0) - tot


def _scatter_before(rs, ds, tot, off, c0, c1, lo, hi, n_loc):
    """The sharded walk phase's expansion before K6: per shard
    ``expand_lanes`` over the lanes the chunk cuts, rows by
    ``lane + off - lo`` (row W takes the rest), ``scatter_`` into one start
    array, and each shard's weights kept by lane with its rows."""
    W, Bc = hi - lo, c1 - c0
    start = torch.zeros((W + 1, Bc), dtype=torch.int32)
    mine = []
    for h, (r, d) in enumerate(zip(rs, ds)):
        o = off[h, c0:c1]
        lo_h = max(0, int((lo - o).min()))
        hi_h = min(int(tot[h, c0:c1].max()), int((hi - o).max()))
        if hi_h <= lo_h:
            continue
        part = d.columns(c0, c1)
        st, weight, lane, _ = walk.expand_lanes_plain(r[:, c0:c1], part,
                                                      lo_h, hi_h - lo_h)
        row = lane.long()[:, None] + torch.as_tensor(o - lo)[None, :]
        ok = (lane[:, None] < part.total[None, :]) & (row >= 0) & (row < W)
        row = torch.where(ok, row, W)
        start.scatter_(0, row, st + h * n_loc)
        mine.append((h, row, torch.where(ok, weight, 0.0)))
    return start[:W], mine


def _bounds(tot):
    return torch.as_tensor(np.concatenate([np.zeros((1, tot.shape[1]),
                                                    np.int64),
                                           np.cumsum(tot, axis=0)]))


@pytest.mark.parametrize("G", [2, 4])
@pytest.mark.parametrize("cut", ["whole", "mid", "tail", "columns"])
def test_expand_chunk_lanes_matches_scatter(G, cut):
    """Every shard's lanes written straight into the chunk's start array
    (node + h * n_loc) equal the scatter_ composition, whether the chunk
    holds every lane, cuts the lanes in the middle or at the end (shards'
    ranges split), or takes a run of columns; its weights equal the kept
    weights by lane, and are 0 past the columns' walks."""
    n_loc, B = 150, 5
    rs, ds, tot, off = _shard_demands(np.random.default_rng(G), G, n_loc, B,
                                      17.0)
    total = tot.sum(axis=0)
    c0, c1, lo, hi = {"whole": (0, B, 0, int(total.max())),
                      "mid": (1, 2, int(total[1]) // 3,
                              2 * int(total[1]) // 3),
                      "tail": (2, 3, int(total[2]) // 2, int(total[2]) + 40),
                      "columns": (1, 4, 0, int(total[1:4].max()))}[cut]
    W, Bc = hi - lo, c1 - c0
    want, mine = _scatter_before(rs, ds, tot, off, c0, c1, lo, hi, n_loc)
    start, weight = walk.expand_chunk_lanes(
        [r[:, c0:c1] for r in rs], [d.columns(c0, c1) for d in ds],
        _bounds(tot)[:, c0:c1].contiguous(), lo, W, n_loc)
    assert torch.equal(start, want)
    kept = torch.zeros(W, Bc)
    for h, row, w in mine:
        ok = row < W
        cols = torch.arange(Bc).expand_as(row)
        kept[row[ok], cols[ok]] = w[ok]
    assert torch.equal(weight, kept)
    past = lo + torch.arange(W)[:, None] >= torch.as_tensor(total[c0:c1])
    assert (start[past] == 0).all() and (weight[past] == 0).all()
    assert bool(past.any()) == (cut != "mid")


def test_expand_chunk_lanes_range_is_a_slice():
    """Lanes lo .. hi - 1 of a chunk are rows lo .. of the chunk of every
    lane."""
    rs, ds, tot, _ = _shard_demands(np.random.default_rng(1), 3, 120, 4, 9.0)
    bounds = _bounds(tot)
    W = int(tot.sum(axis=0).max())
    full = walk.expand_chunk_lanes(rs, ds, bounds, 0, W, 120)
    for lo, hi in ((0, 64), (W // 3, W // 2), (W - 5, W + 50)):
        s, w = walk.expand_chunk_lanes(rs, ds, bounds, lo, hi - lo, 120)
        assert torch.equal(s[:W - lo], full[0][lo:hi])
        assert torch.equal(w[:W - lo], full[1][lo:hi])
    assert int((full[0] >= 120).sum()) > 0


def _walk_phase_before(graph, r, omega_unit, seed, alpha, max_hops, live):
    """``ops.walk.walk_phase`` as it ran before K6, on the plain versions
    (the allocation's stage clock left out)."""
    n, B = r.shape
    contrib = torch.zeros_like(r)
    d = walk.walk_demand_plain(r[:, :live], omega_unit)
    tot = d.total.cpu().numpy()
    chunks = walk.plan_chunks(tot, walk.lane_budget(r.device))
    for i, (c0, c1, lo, hi) in enumerate(chunks):
        part = walk.WalkDemand(d.omega_v[:, c0:c1], d.cum[:, c0:c1],
                               d.total[c0:c1])
        start, weight, _, _ = walk.expand_lanes_plain(r[:, c0:c1], part, lo,
                                                      hi - lo)
        ends = walk.walk_endpoints(graph, start.view(-1),
                                   walk.derive_seed(seed, i), alpha, max_hops)
        contrib[:, c0:c1].scatter_add_(0, ends.view(hi - lo, c1 - c0).long(),
                                       weight)
    return contrib, len(chunks)


def _sharded_walk_phase_before(csr, rs, omega_unit, seed, alpha, max_hops):
    """``ops.walk.sharded_walk_phase`` as it ran before K6: the scatter_
    into one start array, a gather of the endpoints back per shard."""
    G = len(rs)
    n_loc, B = rs[0].shape
    ds = [walk.walk_demand_plain(r, omega_unit) for r in rs]
    tot = torch.stack([d.total for d in ds]).numpy().astype(np.int64)
    off = np.cumsum(tot, axis=0) - tot
    partials = [torch.zeros((G * n_loc, B)) for _ in rs]
    chunks = walk.plan_chunks(tot.sum(axis=0), min(
        walk.lane_budget(rs[0].device), walk.SHARDED_CHUNK_LANES))
    for i, (c0, c1, lo, hi) in enumerate(chunks):
        W = hi - lo
        start, mine = _scatter_before(rs, ds, tot, off, c0, c1, lo, hi,
                                      n_loc)
        ends = walk.walk_endpoints(csr, start.contiguous().view(-1),
                                   walk.derive_seed(seed, i), alpha,
                                   max_hops).view(W, c1 - c0)
        for h, row, weight in mine:
            e = ends.gather(0, row.clamp_max(W - 1))
            partials[h][:, c0:c1].scatter_add_(0, e.long(), weight)
    return partials, len(chunks)


@pytest.mark.parametrize("budget", [None, 2048])
def test_walk_phase_bit_equal_before(budget, monkeypatch):
    """walk_phase on the CPU is bit-equal to its form before K6, in one
    chunk and in many (a column's lanes split), with padding columns."""
    if budget is not None:
        monkeypatch.setattr(walk, "CPU_LANE_BUDGET", budget)
    g = generators.rmat(9, 4096, seed=2)
    rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
    dg = to_device(g, device="cpu")
    st = push.forward_push(dg, torch.tensor([1, 2, 3, 4, 5]), rmax=rcfg.rmax,
                           alpha=rcfg.alpha)
    got, info = walk.walk_phase(dg, st.r, rcfg.omega_unit, 7, rcfg.alpha,
                                rcfg.max_walk_hops, live=4)
    want, chunks = _walk_phase_before(dg, st.r, rcfg.omega_unit, 7,
                                      rcfg.alpha, rcfg.max_walk_hops, 4)
    assert info.chunks == chunks and (budget is None) == (chunks == 1)
    assert torch.equal(got, want)


@pytest.mark.parametrize("G,budget", [(2, None), (4, None), (4, 4096)])
def test_sharded_walk_phase_bit_equal_before(G, budget, monkeypatch):
    """sharded_walk_phase on the CPU: every shard's partial bit-equal to
    its form before K6 (the scatter_ / gather round trip), with chunks
    that cut the shards' lanes where ``budget`` is small."""
    if budget is not None:
        monkeypatch.setattr(walk, "CPU_LANE_BUDGET", budget)
    g = generators.rmat(9, 4096, seed=4)
    rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
    dg = to_device(g, device="cpu")
    st = push.forward_push(dg, torch.tensor([7, 70, 140, 210]),
                           rmax=rcfg.rmax, alpha=rcfg.alpha)
    csr = shard_out_csr(g, ["cpu"] * G)
    full = torch.zeros(G * csr.n_loc, 4)
    full[:g.n] = st.r
    rs = [full[h * csr.n_loc:(h + 1) * csr.n_loc].clone() for h in range(G)]
    got, info = walk.sharded_walk_phase(csr, rs, rcfg.omega_unit, 3,
                                        rcfg.alpha, rcfg.max_walk_hops)
    want, chunks = _sharded_walk_phase_before(csr, rs, rcfg.omega_unit, 3,
                                              rcfg.alpha, rcfg.max_walk_hops)
    assert info.chunks == chunks and (budget is None) == (chunks == 1)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
