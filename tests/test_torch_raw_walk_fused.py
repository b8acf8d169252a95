"""K6+K4, the raw walk phase's chunk in one launch on a card, through its
plain version ``fora_tpu_torch.ops.walk.raw_walk_chunk_plain`` (and the
dispatchers ``raw_walk_chunk`` / ``raw_walk_sharded_chunk``, which run the
chain expand_lanes -> walk_endpoints -> accumulate_endpoints on the CPU):

  - its lane -> node map and weight array-equal to JAX's
    ``fora_tpu.ops.walk.allocate_walks`` (empty columns, lanes past a
    column's total, lane ranges from lane_lo > 0), and a walk of no hop
    ending where that map starts it;
  - its contribution equal to the chain the walk phase ran on a card
    before it (``expand_lanes`` -> K4's plain walk ``run_walks_philox`` on
    the [W, Bc] starts -> ``accumulate_endpoints``) at rtol 1e-6, on
    ``walk_phase``'s chunks and seeds: endpoints equal, walk (t, b) drawn
    as walk t * Bc + b; and to JAX's ``accumulate_endpoints`` of the same
    endpoints and weights at rtol 1e-6;
  - the sharded form equal to the unsharded one on the concatenated
    residues (G = 2 and 4, chunks that cut the shards' lanes);
  - the dispatchers on the CPU: the walk phase's chain, chunk by chunk, and
    the sharded one equal to the unsharded one there too;
  - its endpoints against exact PPR by chi-square (``walk_chisq``);
  - a lane-by-lane model of the kernel's start search (warp tiles of
    ``raw_walk_plan``, batches of 32, a gallop from the previous batch's
    last node, a full search for a tile's first lane and for a lane that
    enters the next shard) equal to ``torch.searchsorted``'s nodes, every
    walked lane once and no padding lane, a hub's run a probe a lane,
    the warp's search for a tile's first lane a few steps of 32 probes;
  - ``raw_walk_plan`` and the residency it assumes, ``walk.cu``'s launch
    bounds.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from walk_chisq import assert_endpoints_follow

from fora_tpu.ops import walk as jax_walk
from fora_tpu_torch import ForaConfig
from fora_tpu_torch.algo import exact
from fora_tpu_torch.graph import from_edges, generators, to_device
from fora_tpu_torch.index.build_sharded import shard_out_csr
from fora_tpu_torch.kernels import schedule
from fora_tpu_torch.ops import push, walk

torch.set_num_threads(2)

ALPHA, HOPS = 0.2, 64


def _residue(rng, n, B, density=0.3, empty=(0,)):
    r = rng.random((n, B)).astype(np.float32) * (rng.random((n, B))
                                                 < density)
    r[:, list(empty)] = 0.0          # columns without walks
    return r


def _unsharded_bounds(d):
    return torch.stack([torch.zeros_like(d.total, dtype=torch.int64),
                        d.total.long()])


def _graph(weighted=False, nlog2=10, seed=2):
    g = generators.rmat(nlog2, 8 << nlog2, seed=seed)
    if not weighted:
        return g
    rows = np.repeat(np.arange(g.n), np.asarray(g.out_deg, np.int64))
    w = np.random.default_rng(seed).uniform(0.25, 4.0, g.m)
    return from_edges(rows, np.asarray(g.out_indices, np.int64), g.n,
                      w=w.astype(np.float32))


@pytest.mark.parametrize("lo,W", [(0, 4096), (0, 64), (1000, 1024),
                                  (137, 333), (5000, 64)])
def test_lane_nodes_and_weights_match_jax(lo, W):
    """The plain version's lanes lo .. lo + W - 1: node and weight equal
    JAX's allocation of lo + W lanes from row lo on where the lane is
    below its column's total (JAX's valid mask); columns 0 and 3 are
    empty and walk nowhere."""
    r = _residue(np.random.default_rng(7), 300, 5, empty=(0, 3))
    rt = torch.from_numpy(r)
    d = walk.walk_demand(rt, 21.7)
    start, weight = walk.expand_chunk_lanes_plain(
        [rt], [d], _unsharded_bounds(d), lo, W, 0)
    want = jax_walk.allocate_walks(jnp.asarray(r), 21.7, lo + W)
    valid = np.asarray(want.valid)[lo:]
    np.testing.assert_array_equal(
        valid, np.arange(lo, lo + W)[:, None] < d.total.numpy()[None, :])
    np.testing.assert_array_equal(start.numpy()[valid],
                                  np.asarray(want.start)[lo:][valid])
    np.testing.assert_array_equal(weight.numpy(),
                                  np.asarray(want.weight)[lo:])
    assert not valid[:, 0].any() and not valid[:, 3].any()
    # a walk of no hop ends where the lane starts; lanes past the total
    # keep the caller's fill
    ring = to_device(from_edges(np.arange(300), (np.arange(300) + 1) % 300,
                                300), device="cpu")
    ends = torch.full((W, 5), -1, dtype=torch.int32)
    out = torch.zeros(300, 5)
    walk.raw_walk_chunk_plain(ring, [rt], [d], _unsharded_bounds(d), lo, W,
                              0, 3, ALPHA, 0, [out], ends=ends)
    np.testing.assert_array_equal(ends.numpy()[valid], start.numpy()[valid])
    assert (ends.numpy()[~valid] == -1).all()


def _chain(graph, r, d, lo, W, seed):
    """The walk phase's chain on a card before K6+K4, with K4's plain walk:
    (contribution, endpoints, weights)."""
    start, weight = walk.expand_lanes(r, d, lo, W)
    ends = walk.run_walks_philox(graph, start.reshape(-1), seed, ALPHA,
                                 HOPS).view(start.shape)
    out = walk.accumulate_endpoints(ends, weight, r.shape[0])
    return out, ends, weight


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("budget", [None, 2048])
def test_contribution_equals_chain(weighted, budget):
    """On walk_phase's chunks (one, or many where a column's lanes split:
    lane_lo > 0) and seeds, each chunk's endpoints equal the chain's on
    every lane the column demands (walk t * Bc + b in both), and its
    contribution the chain's at rtol 1e-6 and JAX's accumulate_endpoints
    of those endpoints and weights at rtol 1e-6."""
    g = _graph(weighted)
    rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
    dg = to_device(g, device="cpu")
    st = push.forward_push(dg, torch.tensor([1, 2, 3, 4, 5]),
                           rmax=rcfg.rmax * 4, alpha=rcfg.alpha)
    r = st.r
    d = walk.walk_demand(r, rcfg.omega_unit)
    chunks = walk.plan_chunks(d.total.numpy(),
                              budget or walk.CPU_LANE_BUDGET)
    assert (len(chunks) > 1) == (budget is not None)
    assert any(lo > 0 for _, _, lo, _ in chunks) == (budget is not None)
    for i, (c0, c1, lo, hi) in enumerate(chunks):
        seed = walk.derive_seed(9, i)
        rc, dc = r[:, c0:c1], d.columns(c0, c1)
        W, Bc = hi - lo, c1 - c0
        want, want_ends, weight = _chain(dg, rc, dc, lo, W, seed)
        got = torch.zeros(g.n, Bc)
        ends = torch.full((W, Bc), -1, dtype=torch.int32)
        walk.raw_walk_chunk_plain(dg, [rc], [dc], _unsharded_bounds(dc), lo,
                                  W, 0, seed, ALPHA, HOPS, [got], ends=ends)
        valid = lo + torch.arange(W)[:, None] < dc.total[None, :]
        assert torch.equal(ends[valid], want_ends[valid])
        assert (ends[~valid] == -1).all()
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
        jax_out = np.asarray(jax_walk.accumulate_endpoints(
            jnp.asarray(want_ends.numpy()), jnp.asarray(weight.numpy()),
            g.n))
        np.testing.assert_allclose(got.numpy(), jax_out, rtol=1e-6, atol=0)


@pytest.mark.parametrize("budget", [None, 2048])
def test_walk_phase_keeps_the_chain_on_the_cpu(monkeypatch, budget):
    """walk_phase on the CPU (through raw_walk_chunk) gives what the chain
    expand_lanes -> walk_endpoints (the Generator's walks) ->
    accumulate_endpoints gives on its chunks and seeds, bit for bit, and
    times the chain's three stages."""
    from fora_tpu_torch.utils.timing import StageClock
    if budget is not None:
        monkeypatch.setattr(walk, "CPU_LANE_BUDGET", budget)
    g = _graph()
    rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
    dg = to_device(g, device="cpu")
    st = push.forward_push(dg, torch.tensor([3, 9, 27]), rmax=rcfg.rmax * 4,
                           alpha=rcfg.alpha)
    clock = StageClock("cpu")
    contrib, info = walk.walk_phase(dg, st.r, rcfg.omega_unit, 5,
                                    rcfg.alpha, rcfg.max_walk_hops,
                                    clock=clock)
    d = walk.walk_demand(st.r, rcfg.omega_unit)
    chunks = walk.plan_chunks(d.total.numpy(), walk.chunk_lanes(
        torch.device("cpu")))
    assert info.chunks == len(chunks) and (len(chunks) > 1) == bool(budget)
    want = torch.zeros_like(st.r)
    for i, (c0, c1, lo, hi) in enumerate(chunks):
        start, weight = walk.expand_lanes(st.r[:, c0:c1], d.columns(c0, c1),
                                          lo, hi - lo)
        ends = walk.walk_endpoints(dg, start.view(-1), walk.derive_seed(5, i),
                                   rcfg.alpha, rcfg.max_walk_hops)
        walk.accumulate_endpoints(ends.view(start.shape), weight, g.n,
                                  out=want[:, c0:c1])
    assert torch.equal(contrib, want)
    assert set(clock.ms()) == {"alloc", "walks", "accum"}


def _shard(r_cat, G, n_loc):
    return [r_cat[h * n_loc:(h + 1) * n_loc].clone() for h in range(G)]


def _run_chunk(form, graph, rs, ds, bounds, lo, W, n_loc, seed, outs, ends,
               alpha=ALPHA, hops=HOPS):
    """One chunk by the plain version (``form`` "plain") or by the
    dispatcher on the CPU, the chain ("chain"; G = 1: raw_walk_chunk)."""
    if form == "plain":
        walk.raw_walk_chunk_plain(graph, rs, ds, bounds, lo, W, n_loc, seed,
                                  alpha, hops, outs, ends=ends)
    elif n_loc:
        walk.raw_walk_sharded_chunk(graph, rs, ds, bounds, lo, W, seed, alpha,
                                    hops, outs, ends=ends)
    else:
        walk.raw_walk_chunk(graph, rs[0], ds[0], lo, W, seed, alpha, hops,
                            outs[0], ends=ends)


@pytest.mark.parametrize("form", ["plain", "chain"])
@pytest.mark.parametrize("G", [2, 4])
@pytest.mark.parametrize("cut", ["whole", "mid", "tail", "columns"])
@pytest.mark.parametrize("weighted", [False, True])
def test_sharded_equals_unsharded_on_concatenation(G, cut, weighted, form):
    """The sharded plain form over G shards' residues equals the unsharded
    one on their concatenation: the same endpoints on every walked lane,
    the shards' partials summing to its contribution (both within the f32
    summation bound of the float64 sum of the lanes' weights), each
    partial holding exactly its own shard's lanes; for a whole chunk, one
    that cuts the shards' lanes in the middle or at the end, and a run of
    columns.  The dispatchers on the CPU (the chain) alike."""
    g = _graph(weighted, seed=G)
    rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
    dg = to_device(g, device="cpu")
    csr = shard_out_csr(g, ["cpu"] * G)
    n_loc = csr.n_loc
    st = push.forward_push(dg, torch.tensor([7, 70, 140, 210, 280]),
                           rmax=rcfg.rmax * 4, alpha=rcfg.alpha)
    r_cat = torch.zeros(G * n_loc, 5)
    r_cat[:g.n] = st.r
    rs = _shard(r_cat, G, n_loc)
    omega = rcfg.omega_unit
    ds = [walk.walk_demand(x, omega) for x in rs]
    tot = torch.stack([x.total.long() for x in ds])
    bounds = torch.cat([torch.zeros_like(tot[:1]), tot.cumsum(0)])
    total = bounds[-1].numpy()
    b, t = int(total.argmax()), int(total.max())
    c0, c1, lo, hi = {"whole": (0, 5, 0, t),
                      "mid": (b, b + 1, t // 3, 2 * t // 3),
                      "tail": (b, b + 1, t // 2, t + 40),
                      "columns": (1, 4, 0, int(total[1:4].max()))}[cut]
    W, Bc = hi - lo, c1 - c0
    part = bounds[:, c0:c1].contiguous()
    if cut in ("mid", "tail"):       # the chunk starts inside a shard's lanes
        assert bool(((part[:-1] < lo) & (part[1:] > lo)).any())
    outs = [torch.zeros(G * n_loc, Bc) for _ in range(G)]
    ends = torch.full((W, Bc), -1, dtype=torch.int32)
    _run_chunk(form, csr, [x[:, c0:c1] for x in rs],
               [x.columns(c0, c1) for x in ds], part, lo, W, n_loc, 11, outs,
               ends)
    d_cat = walk.walk_demand(r_cat, omega)
    want = torch.zeros(G * n_loc, Bc)
    want_ends = torch.full((W, Bc), -1, dtype=torch.int32)
    dc = d_cat.columns(c0, c1)
    _run_chunk(form, dg, [r_cat[:, c0:c1]], [dc], _unsharded_bounds(dc), lo,
               W, 0, 11, [want], want_ends)
    assert torch.equal(ends, want_ends)
    walked = ends >= 0
    assert int(walked.sum()) > 0
    _, weight = walk.expand_chunk_lanes_plain(
        [r_cat[:, c0:c1]], [d_cat.columns(c0, c1)],
        torch.stack([torch.zeros_like(part[-1]), part[-1]]), lo, W, 0)
    # one scatter-add against G partials summed: the same terms in another
    # order, so each within the f32 summation bound of their float64 sum
    sum64 = _within_f32_sum(want, ends, weight, G * n_loc)
    assert torch.equal(_within_f32_sum(sum(outs), ends, weight, G * n_loc,
                                       extra=G), sum64)
    lane = lo + torch.arange(W)[:, None]
    for h in range(G):
        mine = (lane >= part[h]) & (lane < part[h + 1])
        alone = torch.zeros(G * n_loc, Bc)
        alone.scatter_add_(0, torch.where(mine, ends, 0).long(),
                           torch.where(mine, weight, 0.0))
        assert torch.equal(outs[h], alone)


def _within_f32_sum(got, ends, weight, n, extra=0):
    """Asserts that every entry of ``got`` [n, Bc] is the float64 sum of
    the non-zero ``weight`` of the walked lanes (``ends`` >= 0) ending
    there within gamma(N - 1 + extra) of it, the bound of any order of N
    f32 adds (``extra`` more adds where partial sums are summed);
    returns the float64 sums."""
    add = (ends >= 0) & (weight != 0)
    e = torch.where(add, ends, 0).long()
    want = torch.zeros(n, ends.shape[1], dtype=torch.float64)
    want.scatter_add_(0, e, torch.where(add, weight.double(), 0.0))
    cnt = torch.zeros_like(want).scatter_add_(0, e, add.double())
    k = (cnt - 1 + extra).clamp_min(0) * 2.0**-24
    bad = (got.double() - want).abs() > k / (1 - k) * want
    assert not bool(bad.any()), f"{int(bad.sum())} entries off"
    return want


@pytest.mark.parametrize("form", ["plain", "chain"])
def test_endpoints_follow_exact_ppr(form):
    """One chunk of a real query's residue: the walked lanes' endpoint
    counts against the mixture sum_v omega_v pi_v of their start nodes'
    exact PPR (chi-square), and the contribution's mass the residue's; by
    the plain version (Philox walks) and the CPU's chain."""
    g = generators.rmat(9, 4096, seed=5)
    rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
    dg = to_device(g, device="cpu")
    st = push.forward_push(dg, torch.tensor([17]), rmax=rcfg.rmax * 30,
                           alpha=rcfg.alpha)
    omega = rcfg.omega_unit
    d = walk.walk_demand(st.r, omega)
    W = int(d.total[0])
    assert W > 20_000
    out = torch.zeros(g.n, 1)
    ends = torch.full((W, 1), -1, dtype=torch.int32)
    _run_chunk(form, dg, [st.r], [d], _unsharded_bounds(d), 0, W, 0, 13,
               [out], ends, rcfg.alpha, rcfg.max_walk_hops)
    assert bool((ends >= 0).all())
    nodes = torch.nonzero(d.omega_v[:, 0] > 0).squeeze(1)
    pi = exact.exact_ppr_batch(g, nodes.numpy(), device="cpu").numpy()
    assert_endpoints_follow(ends.numpy(), pi @ d.omega_v[nodes, 0].numpy())
    torch.testing.assert_close(out.sum(), st.r.sum(), rtol=1e-5, atol=0)


# ---- the kernel's start search, lane by lane ------------------------------

def _upper_bound(col, x, probes):
    """raw_walk_kernel's upper_bound: K6-expand's branchless search."""
    pos, length = 0, len(col)
    while length > 1:
        half = length >> 1
        probes[0] += 1
        if col[pos + half] <= x:
            pos += half
        length -= half
    probes[0] += 1
    return pos + (1 if col[pos] <= x else 0)


def _warp_upper_bound(col, x, probes):
    """raw_walk_kernel's warp_upper_bound: 32 probes a step, one ballot."""
    lo, hi = 0, len(col)
    while hi - lo > 32:
        step = (hi - lo + 31) >> 5
        probes[0] += 1
        k = sum(1 for j in range(32)
                if lo + j * step < hi and col[lo + j * step] <= x)
        if k == 0:
            return lo
        nxt = lo + k * step
        lo += (k - 1) * step + 1
        if nxt < hi:
            hi = nxt + 1
    probes[0] += 1
    return lo + sum(1 for j in range(32) if lo + j < hi and col[lo + j] <= x)


def _gallop(col, p, x, probes):
    """raw_walk_kernel's gallop from p (col[p - 1] <= x < col[-1])."""
    n = len(col)
    probes[0] += 1
    if col[p] > x:
        return p
    lo, step = p, 1
    while True:
        hi = lo + step
        if hi >= n - 1:
            hi = n - 1
            break
        probes[0] += 1
        if col[hi] > x:
            break
        lo, step = hi, step * 2
    while hi - lo > 1:
        mid = lo + ((hi - lo) >> 1)
        probes[0] += 1
        if col[mid] > x:
            hi = mid
        else:
            lo = mid
    return hi


def _kernel_starts(cums, bounds, lane_lo, rows, n_loc, k):
    """The start nodes raw_walk_range hands its lanes: per column b, warp
    tiles of 32 k rows, each walking its rows below bounds[G, b]; a tile's
    first lane searched in full by the warp (32 probes a step), then
    batches of 32 lanes, each lane
    galloping from the node of the previous batch's last lane, or
    searching in full where it enters the next shard.  Returns ([rows,
    Bc] start or -1 where not walked, probes per walked lane)."""
    G, Bc = len(cums), bounds.shape[1]
    rng_ = 32 * k
    tiles = -(-rows // rng_)
    start = np.full((rows, Bc), -1, np.int64)
    probes = [0]
    for b in range(Bc):
        for j in range(tiles):
            t0 = j * rng_
            count = min(rng_, rows - t0, bounds[G, b] - lane_lo - t0)
            if count <= 0:
                continue
            l0 = lane_lo + t0
            base_h = 0
            while bounds[base_h + 1, b] <= l0:
                base_h += 1
            base_v = _warp_upper_bound(cums[base_h][:, b],
                                       l0 - bounds[base_h, b], probes)
            for batch in range(0, count, 32):
                filled = min(32, count - batch)
                for i in range(filled):
                    t = t0 + batch + i
                    lane = lane_lo + t
                    sh = base_h
                    while bounds[sh + 1, b] <= lane:
                        sh += 1
                    col = cums[sh][:, b]
                    x = lane - bounds[sh, b]
                    v = (_gallop(col, base_v, x, probes) if sh == base_h
                         else _upper_bound(col, x, probes))
                    assert start[t, b] == -1
                    start[t, b] = v + sh * n_loc
                    last = (v, sh)
                base_v, base_h = last
    return start, probes[0]


@pytest.mark.parametrize("G,k,lo,W", [(1, 1, 0, None), (1, 4, 300, 700),
                                      (2, 2, 0, None), (4, 1, 50, 900),
                                      (4, 4, 0, None)])
def test_kernel_search_model_equals_searchsorted(G, k, lo, W):
    """The kernel's search, modelled lane by lane, gives every lane below
    its column's demand the node torch.searchsorted gives, once, and no
    padding lane a walk; over G shards (lanes entering the next shard
    mid-batch), tiles of 32 k rows, lane ranges from lo > 0 and cut short,
    an empty column, and a column of one hub's run."""
    rng = np.random.default_rng(G * 10 + k)
    n_loc, B = 400, 6
    rs = []
    for h in range(G):
        r = _residue(rng, n_loc, B, density=0.05 + 0.4 * (h % 2),
                     empty=(0,))
        r[:, 5] = 0.0
        r[n_loc // 2, 5] = 3.0 if h == 0 else 0.0     # one hub's run
        rs.append(torch.from_numpy(r))
    ds = [walk.walk_demand(x, 97.0) for x in rs]
    tot = torch.stack([x.total.long() for x in ds])
    bounds = torch.cat([torch.zeros_like(tot[:1]), tot.cumsum(0)])
    W = int(bounds[-1].max()) - lo + 50 if W is None else W
    want, _ = walk.expand_chunk_lanes_plain(rs, ds, bounds, lo, W, n_loc)
    cums = [x.cum.numpy().astype(np.int64) for x in ds]
    got, probes = _kernel_starts(cums, bounds.numpy(), lo, W, n_loc, k)
    walked = (lo + np.arange(W)[:, None]) < bounds[-1].numpy()[None, :]
    np.testing.assert_array_equal(got >= 0, walked)
    np.testing.assert_array_equal(got[walked], want.numpy()[walked])
    assert not walked[:, 0].any()
    # the hub column: every lane after a tile's first gallops one probe,
    # a tile's first search takes a few warp-wide steps
    hub = walked[:, 5]
    _, hub_probes = _kernel_starts([c[:, 5:6] for c in cums],
                                   bounds.numpy()[:, 5:6], lo, W, n_loc, k)
    full = int(np.ceil(np.log2(n_loc))) + 1
    tiles_walked = -(-int(hub.sum()) // (32 * k)) + 1
    assert hub_probes <= int(hub.sum()) + tiles_walked * full


@pytest.mark.parametrize("alias", [False, True])
@pytest.mark.parametrize("rows,Bc,sms", [(1, 1, 132), (1_798_144, 15, 132),
                                         (12_777_000, 16, 132),
                                         (33, 7, 1), (4096, 130, 16)])
def test_raw_walk_plan_covers_every_lane(rows, Bc, sms, alias):
    """raw_walk_plan: k is the largest of 1 .. 16 (alias hops: 1 .. 4)
    whose warps fill half of the card's resident warps (else 1), a
    column's tiles cover its rows once, and the blocks cover every
    column's tiles."""
    plan = schedule.raw_walk_plan(rows, Bc, sms, alias)
    k = plan.walks_per_lane
    top = 4 if alias else 16
    half = sms * schedule.RAW_RESIDENT_WARPS // 2
    assert k in (1, 2, 4, 8, 16) and k <= top
    assert k == 1 or rows * Bc >= 32 * k * half
    assert k == top or rows * Bc < 64 * k * half
    span = 32 * plan.walks_per_lane
    assert (plan.tiles - 1) * span < rows <= plan.tiles * span
    assert plan.tiles * Bc <= plan.blocks * schedule.WALK_BLOCK_WARPS < \
        plan.tiles * Bc + schedule.WALK_BLOCK_WARPS
    got = [plan.tile_rows(j, rows) for j in range(plan.tiles + 1)]
    assert got[0][0] == 0 and got[-2][1] == rows and got[-1] == (rows, rows)
    assert all(a[1] == b[0] for a, b in zip(got, got[1:]))


def test_raw_walk_plan_residency_is_the_kernels():
    """RAW_RESIDENT_WARPS comes from walk.cu's launch bounds:
    kRawBlocksPerSM blocks of WALK_BLOCK_WARPS warps an SM."""
    src = (Path(schedule.__file__).parent / "csrc" / "walk.cu").read_text()
    assert f"constexpr int kRawBlocksPerSM = {schedule.RAW_BLOCKS_PER_SM};" \
        in src
    assert f"constexpr int kBlockWarps = {schedule.WALK_BLOCK_WARPS};" in src
    assert schedule.RAW_RESIDENT_WARPS == \
        schedule.RAW_BLOCKS_PER_SM * schedule.WALK_BLOCK_WARPS
