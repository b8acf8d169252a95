"""The sharded FORA+ index build of fora_tpu_torch on the CPU.

  - ``build_walk_index_sharded`` (the walks over the out-CSR's shard
    slices, K4's sharded form in its plain version here) array-equal to
    the port's ``build_walk_index`` at the same seed and chunk: edge_src,
    edge_dst, bucket_offsets, counts_cum and edge_mult, G 2 and 4 and a
    mesh with a query axis, weighted included (the contract of
    ``tests/test_build_sharded.py::test_sharded_build_bit_identical``);
  - ``sharded_build_bytes`` equal to fora_tpu's dict on the same graph;
  - the memory-wall check of ``tests/test_build_sharded.py:45-55``: a
    shard's slices fit a budget the replicated out-CSR does not;
  - K4-xp's plain version ``index_walk_xp_plain`` (the build across
    processes' walks) over P = 1, 2, 4 processes simulated by
    ``xp_chunk_rounds`` and ``local_exchange``: every walk of a chunk ends
    where ``run_walks_philox`` ends it on the chunk's starts (uniform and
    alias, dangling rows, max_hops 0), in exactly one process, with the
    records' length field the walk's;
  - the build across processes simulated so, every chunk, packed:
    array-equal to the Philox one-process reference (``philox_index``),
    and against JAX's ``build_walk_index_sharded`` on 4 x 2 virtual CPU
    devices (as ``tests/test_build_sharded.py:33`` runs it): equal
    ``index_counts``, ``omega_unit_built`` and ``rmax_built``; the
    (start, endpoint) pairs of the two indexes from one distribution by
    ``tests/walk_chisq.py``'s two-sample test, and each package's
    endpoints against the exact PPR of their starts (pooled, and the
    walks that end at their own start) by its chi-square test, all at the
    floor 1e-3 the port's walk tests use.
"""

import numpy as np
import pytest
import torch

import jax
from walk_chisq import chisquare_pvalue, two_sample_pvalue

from fora_tpu import index as jax_index
from fora_tpu.config import ForaConfig as JaxConfig
from fora_tpu.graph import generators as jax_generators
from fora_tpu.graph.csr import from_edges as jax_from_edges
from fora_tpu.parallel import make_mesh as jax_make_mesh
from fora_tpu_torch import ForaConfig
from fora_tpu_torch.algo import exact
from fora_tpu_torch.graph import from_edges, to_device
from fora_tpu_torch.graph.csr import CSRGraph
from fora_tpu_torch.index import (build_walk_index, build_walk_index_sharded,
                                  index_counts, sharded_build_bytes)
from fora_tpu_torch.index.build import pack_index
from fora_tpu_torch.index.build_sharded import own_run, shard_out_csr
from fora_tpu_torch.ops import walk
from fora_tpu_torch.parallel import make_mesh

torch.set_num_threads(2)

FIELDS = ("edge_src", "edge_dst", "bucket_offsets", "counts_cum",
          "edge_mult")


def _setup(n=300, m=3000, seed=21, weighted=False):
    """tests/test_build_sharded.py's graphs, in the JAX package's CSR."""
    g = jax_generators.erdos_renyi(n, m, seed=seed)
    if weighted:
        src = np.repeat(np.arange(g.n, dtype=np.int64),
                        np.asarray(g.out_deg, np.int64))
        w = np.random.default_rng(seed).uniform(0.2, 3.0, g.m)
        g = jax_from_edges(src, np.asarray(g.out_indices, np.int64), n,
                           w=w.astype(np.float32))
    return g


def port_graph(g) -> CSRGraph:
    return CSRGraph(**{f: getattr(g, f) for f in CSRGraph._fields})


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("shape", [(2, 1), (4, 1), (4, 2)])
def test_sharded_build_bit_identical(shape, weighted):
    g = port_graph(_setup(weighted=weighted))
    rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
    chunk = 1 << 11
    assert index_counts(g.out_deg, rcfg).sum() > 2 * chunk   # 3+ chunks
    want = build_walk_index(to_device(g, device="cpu"), rcfg, 9,
                            chunk_lanes=chunk)
    mesh = make_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))
    got = build_walk_index_sharded(g, mesh, rcfg, 9, chunk_lanes=chunk)
    for f in FIELDS:
        a, b = getattr(want, f), getattr(got, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), f)
    assert (got.omega_unit_built, got.rmax_built) == \
        (want.omega_unit_built, want.rmax_built)
    # another seed gives another index
    other = build_walk_index_sharded(g, mesh, rcfg, 10, chunk_lanes=chunk)
    assert not np.array_equal(other.edge_dst, got.edge_dst)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("G", [2, 8])
def test_sharded_build_bytes_matches_jax(G, weighted):
    g = _setup(n=500, m=6000, weighted=weighted)
    assert sharded_build_bytes(port_graph(g), G) == \
        jax_index.sharded_build_bytes(g, G)


def test_sharded_build_breaks_memory_wall():
    """Per-shard CSR bytes stay under a simulated per-shard budget that
    the whole out-CSR exceeds; a shard holds at most its contiguous row
    range's edges, not the whole edge list."""
    g = port_graph(_setup(n=4000, m=80000))
    stats = sharded_build_bytes(g, 8)
    budget = stats["replicated_bytes"] // 4
    assert stats["replicated_bytes"] > budget
    assert stats["per_shard_bytes"] < budget, stats
    assert stats["ratio"] < 0.5, stats


# ---- the build across processes: K4-xp's plain version -------------------

XP_G = 4                 # graph shards, over P processes of XP_G / P
XP_CHUNK = 1 << 11       # walks a chunk: ER 300 / 3000 at eps 0.5 has 7,763


def philox_index(g, rcfg, seed: int, chunk: int = XP_CHUNK):
    """The one-process reference of the build across processes: chunk i
    of the starts walked by ``run_walks_philox`` (K4's Philox words, which
    the card's ``build_walk_index`` draws) at seed ``seed + i * 2^32`` on
    the unsharded graph, then packed.  On the CPU ``build_walk_index``
    itself walks with a torch.Generator, so it is not this index."""
    dg = to_device(g, device="cpu")
    deg = np.asarray(g.out_deg)
    counts = index_counts(deg, rcfg)
    total = int(counts.sum())
    starts = torch.from_numpy(np.repeat(np.arange(g.n, dtype=np.int32),
                                        counts))
    ends = np.empty(total, dtype=np.int32)
    for i, lo in enumerate(range(0, total, chunk)):
        ends[lo:lo + chunk] = walk.run_walks_philox(
            dg, starts[lo:lo + chunk], seed + (i << 32), rcfg.alpha,
            rcfg.max_walk_hops).numpy()
    return pack_index(ends, counts, deg, rcfg)


def _dangling(weighted: bool):
    """ER 300 / 3000 with every 7th node's out-edges dropped (dangling
    rows, which absorb the walks that reach them), weighted exp2(U(-2, 2))
    for alias hops."""
    g = port_graph(_setup())
    src = np.repeat(np.arange(g.n), g.out_deg)
    keep = src % 7 != 3
    w = (np.exp2(np.random.default_rng(5).uniform(-2, 2, int(keep.sum())))
         if weighted else None)
    return from_edges(src[keep], np.asarray(g.out_indices)[keep], g.n, w=w)


def xp_window(csr, starts, cum, lo: int, W: int, seed: int, alpha: float,
              hops: int, P: int, chunk: int = XP_CHUNK) -> tuple:
    """The window [lo, lo + W) of the index walks (whole chunks of
    ``chunk``, walk w drawing as walk w % chunk of chunk w // chunk at seed
    + (w // chunk) 2^32) over P processes of XP_G / P shards each,
    simulated by xp_chunk_rounds and local_exchange, each launch K4-xp's
    plain version (``index_walk_xp_chunk`` on CPU tensors): (each
    process's [W] endpoints, -1 where a walk ended elsewhere; the rounds'
    [P, P] counts; the processes' own runs).  Every record's length field
    is its walk's and its hops taken below it."""
    L = XP_G // P
    rows = L * csr.n_loc
    runs = {q: own_run(cum, lo, W, q * rows, (q + 1) * rows)
            for q in range(P)}
    ends = [torch.full((W,), -1, dtype=torch.int32) for _ in range(P)]

    def launch(q, r, inbox, box, cnt):
        a, b = runs[q]
        own = torch.from_numpy(starts[lo + a:lo + b]) if r == 0 else \
            torch.empty(0, dtype=torch.int32)
        walk.index_walk_xp_chunk(csr.shards(q * L, (q + 1) * L), own, lo + a,
                                 lo, chunk, q * L, XP_G, seed, alpha, hops,
                                 inbox, box, cnt, ends[q])
        assert int(cnt[q]) == 0 and int(cnt[P]) == 0
        for d in range(P):      # (w, cur, h | len << 16, 0)
            rec = box[d, :int(cnt[d])].long()
            length, h = rec[:, 2] >> 16, rec[:, 2] & 0xFFFF
            assert torch.equal(length, walk.lengths_of(
                seed, rec[:, 0] & 0xFFFFFFFF, alpha, hops, chunk))
            assert bool((h < length).all()) and not rec[:, 3].any()
            assert bool((rec[:, 1] // rows == d).all())
            assert bool(((rec[:, 0] >= lo) & (rec[:, 0] < lo + W)).all())
    ms = walk.xp_chunk_rounds(launch, walk.local_exchange,
                              {q: b - a for q, (a, b) in runs.items()}, P,
                              "cpu", words=1)
    return ends, ms, runs


@pytest.mark.parametrize("hops", [None, 0])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("P", [1, 2, 4])
def test_index_walk_xp_plain_simulated_processes(P, weighted, hops):
    """K4-xp's plain version over P simulated processes on a window of one
    chunk, the build's second (walks 2,048 .. 4,095, so every process's
    run starts past walk 0): each walk ends in exactly one process, where
    run_walks_philox ends it on the chunk's starts at the chunk's seed;
    more than one round exactly where P > 1 and walks hop; max_hops 0
    ends every walk at its start in round 0."""
    g = _dangling(weighted)
    rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
    hops = rcfg.max_walk_hops if hops is None else hops
    counts = index_counts(g.out_deg, rcfg)
    starts = np.repeat(np.arange(g.n, dtype=np.int32), counts)
    cum = np.concatenate([[0], np.cumsum(counts)])
    lo = XP_CHUNK
    W = min(XP_CHUNK, len(starts) - lo)
    csr = shard_out_csr(g, ["cpu"] * XP_G)
    ends, ms, _ = xp_window(csr, starts, cum, lo, W, 9, rcfg.alpha, hops, P)
    want = walk.run_walks_philox(to_device(g, device="cpu"),
                                 torch.from_numpy(starts[lo:lo + W]),
                                 9 + (1 << 32), rcfg.alpha, hops)
    assert torch.equal(sum((e >= 0).int() for e in ends),
                       torch.ones(W, dtype=torch.int32))
    assert torch.equal(torch.stack(ends).max(0).values, want)
    assert (len(ms) > 1) == (P > 1 and hops > 0)
    assert len(ms) <= hops + 1
    if hops == 0:
        assert torch.equal(want, torch.from_numpy(starts[lo:lo + W]))
    else:       # some walks were absorbed at a dangling row
        assert int((g.out_deg[want.numpy()] == 0).sum()) > 0


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("P", [1, 2, 4])
def test_index_walk_xp_plain_window_of_chunks(P, weighted):
    """K4-xp's plain version over a window of three chunks (walks 2,048 ..
    8,191 of the build's, so it starts past walk 0 and ends short), P
    simulated processes: the endpoints array-equal to each chunk walked
    as a window of its own and to run_walks_philox on each chunk's starts
    at its seed; a chunk boundary falls inside a process's own run; the
    window's rounds are the most that one of its chunks takes."""
    g = _dangling(weighted)
    rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
    a_, hops = rcfg.alpha, rcfg.max_walk_hops
    counts = index_counts(g.out_deg, rcfg)
    starts = np.repeat(np.arange(g.n, dtype=np.int32), counts)
    cum = np.concatenate([[0], np.cumsum(counts)])
    lo, hi = XP_CHUNK, min(4 * XP_CHUNK, len(starts))
    assert hi < 4 * XP_CHUNK      # the last chunk is short
    csr = shard_out_csr(g, ["cpu"] * XP_G)
    ends, ms, runs = xp_window(csr, starts, cum, lo, hi - lo, 9, a_, hops, P)
    got = torch.stack(ends).max(0).values
    assert torch.equal(sum((e >= 0).int() for e in ends),
                       torch.ones(hi - lo, dtype=torch.int32))
    assert any(a < c - lo < b for a, b in runs.values()
               for c in range(lo + XP_CHUNK, hi, XP_CHUNK))
    dg = to_device(g, device="cpu")
    rounds = []
    for c0 in range(lo, hi, XP_CHUNK):
        c1 = min(c0 + XP_CHUNK, hi)
        one, m1, _ = xp_window(csr, starts, cum, c0, c1 - c0, 9, a_, hops, P)
        assert torch.equal(torch.stack(one).max(0).values, got[c0 - lo:c1 - lo])
        want = walk.run_walks_philox(dg, torch.from_numpy(starts[c0:c1]),
                                     9 + ((c0 // XP_CHUNK) << 32), a_, hops)
        assert torch.equal(got[c0 - lo:c1 - lo], want)
        rounds.append(len(m1))
    assert len(ms) == max(rounds)
    assert (len(ms) > 1) == (P > 1)


def xp_build(g, rcfg, seed: int, P: int, chunk: int = XP_CHUNK):
    """The build across P processes simulated in one: every window's
    walks (``schedule.build_windows``) by ``xp_window``, each walk's
    endpoint from the process where it ended (the max over the processes'
    endpoints, as the build's all-reduce takes it), then packed."""
    from fora_tpu_torch.kernels import schedule
    counts = index_counts(g.out_deg, rcfg)
    total = int(counts.sum())
    starts = np.repeat(np.arange(g.n, dtype=np.int32), counts)
    cum = np.concatenate([[0], np.cumsum(counts)])
    csr = shard_out_csr(g, ["cpu"] * XP_G)
    ends = np.empty(total, dtype=np.int32)
    for lo, hi in schedule.build_windows(total, chunk):
        got, _, _ = xp_window(csr, starts, cum, lo, hi - lo, seed,
                              rcfg.alpha, rcfg.max_walk_hops, P, chunk)
        ends[lo:hi] = torch.stack(got).max(0).values.numpy()
    return pack_index(ends, counts, np.asarray(g.out_deg), rcfg)


@pytest.mark.parametrize("weighted", [False, True])
def test_xp_build_matches_philox_and_jax(weighted):
    """The build across 2 simulated processes of 2 shards, four chunks:
    array-equal to ``philox_index``; against JAX's sharded build at the
    configuration of its own test (``tests/test_build_sharded.py:33``: 4 x
    2 virtual devices, key 9, chunk 2^12), equal walk counts per node and
    equal built omega_unit and rmax; the (start, endpoint) pairs (each
    index edge's multiplicity) of both from one distribution
    (``two_sample_pvalue`` > 1e-3), and each package's endpoints against
    the exact PPR of their starts (``chisquare_pvalue`` > 1e-3): pooled,
    against the mixture of the starts' PPR vectors (its variance is below
    the multinomial's, so that test is conservative), and per start, the
    walks that end at their own start against sum_v K_v PPR_v(v), which
    refuses alpha 0.18 for 0.2 on this graph."""
    jg = _setup(weighted=weighted)
    g = port_graph(jg)
    rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
    got = xp_build(g, rcfg, 9, 2)
    want = philox_index(g, rcfg, 9)
    for f in FIELDS:
        a, b = getattr(want, f), getattr(got, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, f)
    jrcfg = JaxConfig(epsilon=0.5).resolved(jg.n, jg.m)
    jidx = jax_index.build_walk_index_sharded(
        jg, jax_make_mesh(4, 2), jrcfg, jax.random.key(9), chunk=1 << 12)
    counts = index_counts(g.out_deg, rcfg)
    np.testing.assert_array_equal(
        counts, jax_index.index_counts(np.asarray(jg.out_deg), jrcfg))
    assert (got.omega_unit_built, got.rmax_built) == \
        (jidx.omega_unit_built, jidx.rmax_built)

    def pairs(idx):
        mult = (np.ones(idx.total_edges, np.int64) if idx.edge_mult is None
                else np.asarray(idx.edge_mult).astype(np.int64))
        src = np.repeat(np.asarray(idx.edge_src, np.int64), mult)
        dst = np.repeat(np.asarray(idx.edge_dst, np.int64), mult)
        assert np.array_equal(np.bincount(src, minlength=g.n), counts)
        return src, dst
    (ps, pd), (js, jd) = pairs(got), pairs(jidx)
    assert two_sample_pvalue(ps * g.n + pd, js * g.n + jd) > 1e-3
    ppr = exact.exact_ppr_batch(g, np.arange(g.n), rcfg.alpha,
                                device="cpu").numpy()
    mix = ppr @ counts.astype(np.float64)
    home = float(np.diag(ppr) @ counts) / counts.sum()
    for src, dst in ((ps, pd), (js, jd)):
        assert chisquare_pvalue(np.bincount(dst, minlength=g.n), mix) > 1e-3
        at = int((src == dst).sum())
        assert chisquare_pvalue([at, len(src) - at], [home, 1 - home]) > 1e-3


@pytest.mark.parametrize("W,n_in", [(0, 0), (1, 0), (33, 5), (4096, 100),
                                    (1 << 23, 0), (0, 65001865)])
def test_index_xp_plan_covers_the_walks(W, n_in):
    """K4-xp's plan, each form: the own-start form's warps of 32 k walks
    cover its starts (k of 1, 2, 4, the largest whose warps fill half of
    the card's resident warps at its residency); the inbox form's grid is
    resident blocks, at most INDEX_XP_INBOX_BLOCKS_PER_SM an SM and a warp
    for each 32 records at most; a form with no walk gets no block."""
    from fora_tpu_torch.kernels import schedule
    plan = schedule.index_xp_plan(W, n_in, 132)
    own, k = plan.own, plan.own.walks_per_lane
    assert k in (1, 2, 4)
    assert own.blocks * schedule.WALK_BLOCK_WARPS * 32 * k >= W
    assert (own.blocks == 0) == (W == 0)
    if W:
        assert own == schedule.walk_grid(W, k)
    half = 132 * schedule.INDEX_XP_BLOCKS_PER_SM * 8 // 2
    assert k == 4 or W < 32 * 2 * k * half
    inbox = plan.inbox
    assert inbox.blocks == min(132 * schedule.INDEX_XP_INBOX_BLOCKS_PER_SM,
                               -(-n_in // 256))
    assert inbox.warps == 8 * inbox.blocks
    assert (inbox.blocks == 0) == (n_in == 0)


def test_index_xp_blocks_per_sm_is_the_launch_bound():
    """The plan's blocks an SM of K4-xp's forms are walk.cu's launch bounds
    of the kernels its entry points launch."""
    import re
    from pathlib import Path
    from fora_tpu_torch.kernels import schedule
    src = (Path(schedule.__file__).parent / "csrc" / "walk.cu").read_text()
    for const, want in (("kIndexXpBlocksPerSM",
                         schedule.INDEX_XP_BLOCKS_PER_SM),
                        ("kIndexXpInboxBlocksPerSM",
                         schedule.INDEX_XP_INBOX_BLOCKS_PER_SM)):
        got = re.findall(rf"constexpr int {const} = (\d+);", src)
        assert [int(x) for x in got] == [want]
    for kernel in ("index_xp_own_kernel", "index_xp_inbox_kernel"):
        assert re.search(r"__launch_bounds__\(kBlockThreads, kBlocks\)"
                         rf"\s+{kernel}\(", src)
    assert re.search(r"launch_index_xp_own<kIndexXpBlocksPerSM>\(X, xa\)",
                     src)
    assert re.search(r"launch_index_xp_inbox<kIndexXpInboxBlocksPerSM>"
                     r"\(X, xa\)", src)


@pytest.mark.parametrize("total,chunk_lanes,window", [
    (0, 1 << 11, None), (1, 1 << 11, None), (7763, 1 << 11, None),
    (24255412, 1 << 23, None), (100, 1 << 26, None), (7763, 1 << 11, 4096),
    (7763, 1 << 11, 5000), (7763, 1 << 11, 1), (8192, 1 << 11, 8192),
    (10, 3, 7)])
def test_build_windows_cover_every_walk(monkeypatch, total, chunk_lanes,
                                        window):
    """The build's windows cover its walks once, in order, each of whole
    chunks (a window of one chunk where XP_BUILD_WALKS holds less than
    two), the last perhaps short; phase 17's build (24,255,412 walks in
    chunks of 2^23) is one window."""
    from fora_tpu_torch.kernels import schedule
    if window is not None:
        monkeypatch.setattr(schedule, "XP_BUILD_WALKS", window)
    wins = schedule.build_windows(total, chunk_lanes)
    chunks = max(1, schedule.XP_BUILD_WALKS // chunk_lanes)
    assert [lo for lo, _ in wins] == list(range(0, total,
                                                chunks * chunk_lanes))
    assert all(hi == min(lo + chunks * chunk_lanes, total)
               for lo, hi in wins)
    assert sum(hi - lo for lo, hi in wins) == total
    if total == 24255412:
        assert wins == [(0, total)]


@pytest.mark.parametrize("n_in", [0, 1, 5, 31, 32, 33, 1000, 270335,
                                  270336 * 16 + 7, 13 * 2**20])
def test_inbox_claims_cover_every_record(n_in):
    """The persistent inbox form's claims, every warp's first its own and
    the later ones as its warps take them from the cursor, cover the
    records once: each 32 k records (k from 1 to the plan's largest, the
    later ones shrinking as the inbox drains), the last one cut at the
    inbox's end, from an empty inbox to many grids' worth."""
    from fora_tpu_torch.kernels import schedule
    plan = schedule.index_xp_plan(0, n_in, 132).inbox
    claims = schedule.inbox_claims(n_in, plan)
    seen = 0
    for base, c in sorted(claims):
        assert base == seen
        seen += c
    assert seen == n_in
    last = max(claims)[0] if claims else 0
    assert all(c % 32 == 0 and 32 <= c <= 32 * plan.claim_max
               for b, c in claims if b != last)
    first = [c for _, c in claims[:plan.warps]]
    assert len(set(first[:-1])) <= 1        # every warp's first claim alike
    later = [c for b, c in claims[plan.warps:] if b != last]
    assert later == sorted(later, reverse=True)
    if n_in >= 32 * plan.warps * plan.claim_max > 0:
        assert first[0] == 32 * plan.claim_max
    assert len(claims) <= -(-n_in // 32)


@pytest.mark.parametrize("chunk_lanes", [1, 2, 3, 7, 1 << 11, 1553, 3104,
                                         (1 << 23) - 1, 1 << 23,
                                         (1 << 23) + 1, 12345678,
                                         (1 << 31) - 1])
def test_chunk_divisor_divides_every_walk(chunk_lanes):
    """K4-xp's division of a walk's number by its chunk's walks, a
    multiply and a shift (walk.cu's chunk_draw): exact for walk numbers at
    and around every multiple of chunk_lanes and at random below 2^31,
    its multiplier below 2^32."""
    from fora_tpu_torch.kernels import schedule
    magic, shift = schedule.chunk_divisor(chunk_lanes)
    assert 0 < magic < 2**32 and 31 <= shift <= 62
    k = np.arange(0, 2**31 // chunk_lanes + 1, max(1, 2**31 // chunk_lanes
                                                   // 4096), dtype=object)
    w = np.concatenate([k * chunk_lanes + d for d in (-1, 0, 1)] + [
        np.random.default_rng(chunk_lanes).integers(0, 2**31, 4096).astype(
            object), np.array([0, 2**31 - 1], dtype=object)])
    w = w[(w >= 0) & (w < 2**31)]
    assert np.array_equal((w * magic) >> shift, w // chunk_lanes)
