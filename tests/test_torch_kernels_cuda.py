"""The hand-written CUDA kernels of fora_tpu_torch against their plain
PyTorch versions, on the card.

These tests need an NVIDIA GPU and nvcc; elsewhere they skip.  They need
no JAX (the ``fora_tpu`` fixtures they use load without it), so on a
machine without it run them without the suite's conftest:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch
from topk_cases import CASES, dense_columns
from walk_chisq import (assert_endpoints_follow, chisquare_pvalue,
                        two_sample_pvalue)

from fora_tpu.algo import exact
from fora_tpu.config import ForaConfig
from fora_tpu.graph import generators

pytestmark = pytest.mark.cuda

torch.set_num_threads(2)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _random_csr(rng, n, n_src, E):
    dst = np.sort(rng.integers(0, n, E))
    indptr = np.searchsorted(dst, np.arange(n + 1)).astype(np.int32)
    src = rng.integers(0, n_src, E).astype(np.int32)
    return indptr, src


def _skewed_csr(rng, n, n_src, E):
    """One 50,000-edge row, the other E edges on 5% of the rows, the rest
    empty."""
    deg = np.zeros(n, np.int64)
    deg[n // 3] = 50_000
    some = rng.choice(n, n // 20, replace=False)
    np.add.at(deg, rng.choice(some, E), 1)
    indptr = np.zeros(n + 1, np.int32)
    np.cumsum(deg, out=indptr[1:])
    src = rng.integers(0, n_src, int(deg.sum())).astype(np.int32)
    return indptr, src


@pytest.mark.parametrize("B", [1, 3, 32, 128, 130])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("layout", ["random", "skewed"])
def test_gather_scatter_kernel_matches_plain(dev, B, masked, layout):
    """K1 against its plain version: the masked acc and the flag, with a
    split row (the skewed layout) and every lane layout (B = 1 and 3:
    scalar lanes in groups; 32 and 128: float4; 130: scalar, five column
    passes); then a second launch from the same state is bit-equal.  The
    plain version runs in float64: a float32 sum of the 50,000-edge row
    in any order is off by more than rtol 1e-5 of the exact sum, and
    index_add_'s order on the card changes from run to run."""
    from fora_tpu_torch import kernels
    from fora_tpu_torch.kernels.schedule import gather_schedule
    from fora_tpu_torch.ops.gather import gather_scatter_add_plain
    rng = np.random.default_rng(B + 7 * masked)
    n, n_src, E = 3000, 2500, 40000
    make = _random_csr if layout == "random" else _skewed_csr
    indptr, src = make(rng, n, n_src, E)
    E = len(src)
    t = lambda a: torch.as_tensor(a, device=dev)   # noqa: E731
    values = t(rng.random((n_src, B), dtype=np.float32))
    acc0 = t(rng.random((n, B), dtype=np.float32))
    edge_w = t(rng.integers(1, 4, E).astype(np.float32))
    src_w = t(rng.random(n_src, dtype=np.float32))
    thr = t(rng.random(n, dtype=np.float32) * 5)
    sched = gather_schedule(t(indptr), 512)
    assert (sched.n_slots > 0) == (layout == "skewed")
    outs = []
    for _ in range(2):
        acc = acc0.clone()
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        kernels.gather_scatter_add(acc, values, t(indptr), t(src), edge_w,
                                   src_w, thr, masked, flag, sched=sched)
        outs.append((acc, int(flag.item())))
    acc = acc0.double()
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    gather_scatter_add_plain(acc, values.double(), t(indptr), t(src),
                             edge_w.double(), src_w.double(), thr.double(),
                             masked, flag)
    outs.append((acc.float(), int(flag.item())))
    torch.testing.assert_close(outs[0][0], outs[2][0], rtol=1e-5, atol=1e-6)
    assert outs[0][1] == outs[2][1]
    assert torch.equal(outs[0][0], outs[1][0]) and outs[0][1] == outs[1][1]
    assert not sched.counters.any()       # reset for the next launch


@pytest.mark.parametrize("B", [4, 130])
def test_level_spmv_kernel_matches_bucket_loop(dev, B):
    """K2 over a level in one launch (buckets depth.., acc overwritten)
    against the per-bucket plain loop in float64, on an index built on the
    CPU; two launches bit-equal."""
    from fora_tpu_torch import ForaConfig as TorchForaConfig
    from fora_tpu_torch import kernels
    from fora_tpu_torch.algo.fora import StagedForaPrograms
    from fora_tpu_torch.graph import generators as tgen
    from fora_tpu_torch.graph import to_device
    from fora_tpu_torch.index import build_walk_index
    from fora_tpu_torch.kernels.schedule import gather_schedule
    from fora_tpu_torch.ops import gather
    g = tgen.rmat(12, 1 << 15, seed=3)
    rcfg = TorchForaConfig(epsilon=0.5, k=20).resolved(g.n, g.m)
    idx = build_walk_index(to_device(g, device="cpu"), rcfg, seed=4)
    staged = StagedForaPrograms(to_device(g, device=dev), rcfg, idx)
    r = torch.as_tensor(np.random.default_rng(B).random(
        (g.n, B), dtype=np.float32), device=dev)
    for depth in (0, 2):
        for task_edges in (16, 512):     # with and without split rows
            args = (r, staged._indptr[depth:], staged._seg_off[depth:],
                    staged._src, staged._mult, staged._inv_cnt(depth))
            sched = gather_schedule(args[1], task_edges)
            before = kernels.index_spmv.launches
            got = gather.index_spmv_level(*args, sched=sched)
            again = gather.index_spmv_level(*args, sched=sched)
            assert kernels.index_spmv.launches == before + 2
            # a float32 plain sum in index_add_'s varying order drifts
            # past rtol 1e-5 on long rows: hold the kernel to float64
            want = gather.index_spmv_level_plain(
                r.double(), *args[1:4],
                None if args[4] is None else args[4].double(),
                args[5].double()).float()
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-9)
            assert torch.equal(got, again)
        assert torch.equal(staged.walk_contrib(r, depth),
                           gather.index_spmv_level(
                               *args, sched=staged.level_schedule(depth)))


def test_push_kernels_match_plain_split_and_unsplit(dev):
    from fora_tpu_torch.graph import to_device
    from fora_tpu_torch.ops import push
    from fora_tpu_torch.ops.gather import gather_scatter_add_plain
    g = generators.rmat(12, 1 << 15, seed=3)
    rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
    src = torch.arange(0, 64 * 61, 61, dtype=torch.int32, device=dev)
    got = {}
    for hub in (0, 256):
        dg = to_device(g, merge_duplicate_edges=True, hub_rows=hub,
                       device=dev)
        st = push.forward_push(dg, src, rmax=rcfg.rmax, alpha=0.2)
        got[hub] = st
        # one superstep from the converged-minus-some state, kernel vs plain
        thr = push.node_threshold(dg, rcfg.rmax / 4)
        p, r = st.p.clone(), st.r.clone()
        push.superstep(dg, push.PushState(p, r, 0), alpha=0.2, thr=thr)
        pp, pr = st.p.clone(), st.r.clone()
        contrib = torch.empty_like(pr)
        push.push_prepass_plain(pp, pr, contrib, thr, dg.out_deg,
                                push.out_weight(dg), 0.2)
        gather_scatter_add_plain(pr, contrib, dg.in_indptr, dg.in_src,
                                 edge_w=dg.in_w, thr=thr, mask=True)
        if dg.hub_split:
            gather_scatter_add_plain(pr, contrib.index_select(0, dg.hub_ids),
                                     dg.hub_indptr, dg.hub_src_local,
                                     edge_w=dg.hub_w)
        torch.testing.assert_close(p, pp, rtol=1e-5, atol=1e-7)
        torch.testing.assert_close(r, pr, rtol=1e-5, atol=1e-7)
    assert got[0].iters == got[256].iters
    torch.testing.assert_close(got[0].p, got[256].p, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(got[0].r, got[256].r, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", list(CASES))
def test_topk_bounds_kernel_matches_plain(dev, name):
    """K3 against its plain version on the adversarial inputs of
    ``topk_cases``: ids and accept equal, values and bounds at rtol 1e-6;
    the columns that took the dense path as the case expects (the forced
    overflow: all of them, so the counter is positive); the candidate
    counts as the CPU model's; a second launch bit-equal."""
    from fora_tpu_torch import kernels
    from fora_tpu_torch.algo import bounds
    from fora_tpu_torch.kernels import select
    make, k, stride, capacity, dense, _ = CASES[name]
    p, contrib = make(np.random.default_rng(len(name)))
    n, B = p.shape
    p_t, c_t = torch.as_tensor(p, device=dev), torch.as_tensor(contrib,
                                                               device=dev)
    omega, eps = 3.0e5, 0.5
    t = bounds.union_bound_t(n, 3, 1.0 / n)
    s2 = float(np.float32(2.0 * t) * bounds._c(omega))
    want = bounds.topk_with_bounds_split_plain(p_t, c_t, omega, k, t, eps)
    runs = []
    for _ in range(2):
        runs.append(kernels.topk_bounds(p_t, c_t, k, s2, 1.0 + eps,
                                        stride=stride, capacity=capacity))
        stats = kernels.topk_bounds_stats()
        assert stats["dense_columns"] == int(dense_columns(dense, B).sum())
    got = runs[0]
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[6], want[6])
    for i in (0, 2, 3, 4, 5):
        # a negative (k+1)-th score has no Bernstein bound: NaN both ways
        torch.testing.assert_close(got[i], want[i], rtol=1e-6, atol=0.0,
                                   equal_nan=True)
    for a, b in zip(*runs):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    model = select.select_topk(torch.as_tensor(p), torch.as_tensor(contrib),
                               k, stride=stride,
                               capacity=capacity or select.SEGMENT)
    np.testing.assert_array_equal(stats["candidates"], model.counts.numpy())
    if name == "forced_overflow":
        assert stats["dense_columns"] == B > 0
    if stride is None and capacity is None:     # the accept's own entry
        auto = bounds.topk_with_bounds_split(p_t, c_t, omega, k, t, eps)
        for a, b in zip(auto, got):
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def test_walk_kernel_endpoints_match_exact_ppr(dev):
    from fora_tpu_torch.graph import to_device
    from fora_tpu_torch.ops.walk import walk_endpoints
    g = generators.karate_club()
    dg = to_device(g, device=dev)
    W = 1 << 20
    ends = walk_endpoints(dg, torch.zeros(W, dtype=torch.int32, device=dev),
                          seed=5, alpha=0.2, max_hops=64)
    freq = np.bincount(ends.cpu().numpy(), minlength=g.n) / W
    assert np.abs(freq - exact.exact_ppr_dense(g, 0)).sum() < 0.01


def test_walk_kernel_dangling_absorbs(dev):
    from fora_tpu_torch.graph import to_device
    from fora_tpu_torch.ops.walk import walk_endpoints
    g = generators.star_graph(5)
    dg = to_device(g, device=dev)
    W = 1 << 18
    leaf = walk_endpoints(dg, torch.full((W,), 3, dtype=torch.int32,
                                         device=dev), 9, 0.2, 64)
    assert bool((leaf == 3).all())
    hub = walk_endpoints(dg, torch.zeros(W, dtype=torch.int32, device=dev),
                         10, 0.2, 64)
    freq = np.bincount(hub.cpu().numpy(), minlength=g.n) / W
    np.testing.assert_allclose(freq, exact.exact_ppr_dense(g, 0), atol=0.01)


def test_walk_kernel_geometric_lengths(dev):
    """Walks on a long cycle never revisit a node within 64 hops, so the
    endpoint's distance from the start is the walk length: Geometric(0.2)
    (mean 4, P(0) = 0.2), capped at max_hops."""
    from fora_tpu_torch.graph import to_device
    from fora_tpu_torch.ops.walk import walk_endpoints
    g = generators.cycle_graph(1000)
    dg = to_device(g, device=dev)
    W = 1 << 20
    ends = walk_endpoints(dg, torch.zeros(W, dtype=torch.int32, device=dev),
                          11, 0.2, 64).cpu().numpy()
    lens = ends % 1000
    assert abs(lens.mean() - 4.0) < 0.02
    assert abs((lens == 0).mean() - 0.2) < 0.002
    assert lens.max() <= 64


def test_sector_probe_reads_and_refuses(dev):
    """The measuring kernel launches, reports what it read, and refuses a
    read count its unrolled loop cannot do."""
    from fora_tpu_torch import kernels
    buf = torch.zeros(1 << 20, dtype=torch.int32, device=dev)
    assert kernels.sector_reads(buf, reads=16, threads=1000) == 1024 * 16
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError, match="sector_reads"):
        kernels.sector_reads(buf, reads=12)


def test_row_probe_reads_and_refuses(dev):
    """The row-read instrument: rows read reported (8 warps a block), a
    read count its loop cannot do and a ragged buffer refused."""
    from fora_tpu_torch import kernels
    buf = torch.ones(1024 * 128, dtype=torch.float32, device=dev)
    assert kernels.row_reads(buf, reads=16, threads=1000) == 4 * 8 * 16
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError, match="row_reads"):
        kernels.row_reads(buf, reads=12)
    with pytest.raises(ValueError):
        kernels.row_reads(buf[:100])


@pytest.mark.parametrize("B", [32, 64, 128, 5])
@pytest.mark.parametrize("hot", [False, True])
def test_row_scatter_kernel_matches_plain(dev, B, hot):
    """P3 against index_add_: float4 rows (B % 4 == 0) and scalar rows
    (B = 5); ``hot`` sends every edge to one of 8 rows, so many atomics
    hit one address at once.  The add order varies: rtol 1e-4."""
    from fora_tpu_torch import kernels
    from fora_tpu_torch.ops.gather import row_scatter_add_plain
    rng = np.random.default_rng(B + hot)
    H, n_dst, E = 3000, 2000, 50_000
    src = torch.as_tensor(rng.integers(0, H, E).astype(np.int32), device=dev)
    dst = torch.as_tensor(rng.integers(0, 8 if hot else n_dst, E)
                          .astype(np.int32), device=dev)
    tile = torch.as_tensor(rng.random((H, B), np.float32), device=dev)
    acc0 = torch.as_tensor(rng.random((n_dst, B), np.float32), device=dev)
    before = kernels.row_scatter_add.launches
    got = kernels.row_scatter_add(acc0.clone(), tile, src, dst)
    torch.cuda.synchronize()
    assert kernels.row_scatter_add.launches == before + 1
    want = row_scatter_add_plain(acc0.clone(), tile, src, dst)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_k4_on_flat_starts_chi_square(dev):
    """K4 on the flattened [W, B] starts of three queries (lane w * B + b
    walks from source b): each column's endpoints against exact PPR."""
    from fora_tpu_torch.graph import to_device
    from fora_tpu_torch.ops.walk import walk_endpoints
    g = generators.karate_club()
    dg = to_device(g, device=dev)
    sources, W = [0, 16, 33], 1 << 18
    start = torch.tensor(sources, dtype=torch.int32, device=dev).repeat(W)
    ends = walk_endpoints(dg, start, 21, 0.2, 64).view(W, len(sources))
    for b, s in enumerate(sources):
        assert_endpoints_follow(ends[:, b].cpu().numpy(),
                                exact.exact_ppr_dense(g, s))


def test_raw_level_on_card_matches_cpu(dev):
    """One raw-walk level on the card (K1 push, allocation, K4, scatter-
    add) against the CPU's plain path: p, r and supersteps within float
    order, the allocation of the same residue array-equal, each column's
    walk mass equal to its residue mass."""
    from fora_tpu_torch import ForaConfig as TorchForaConfig
    from fora_tpu_torch import kernels
    from fora_tpu_torch.algo.fora import raw_lean_state
    from fora_tpu_torch.graph import generators as tgen
    from fora_tpu_torch.graph import to_device
    from fora_tpu_torch.ops import push
    from fora_tpu_torch.ops.walk import allocate_walks
    g = tgen.rmat(12, 1 << 15, seed=3)
    rcfg = TorchForaConfig(epsilon=0.5).resolved(g.n, g.m)
    src = torch.arange(0, 8 * 61, 61, dtype=torch.int32)
    out = {}
    for d in ("cpu", dev):
        dg = to_device(g, merge_duplicate_edges=True, device=d)
        st = push.init_state(g.n, src.to(d))
        kernels.reset_launch_counts()
        out[str(d)] = raw_lean_state(dg, st.p, st.r, 5, rcfg.rmax,
                                     rcfg.omega_unit, rcfg=rcfg)
        counts = kernels.launch_counts()
        on_card = torch.device(d).type == "cuda"
        assert (counts["index_walk"] > 0) == on_card
        assert (counts["push_prepass"] > 0) == on_card
    (cp, cr, cc, ci, cw), (kp, kr, kc, ki, kw) = out["cpu"], out[str(dev)]
    assert ci == ki
    torch.testing.assert_close(kp.cpu(), cp, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(kr.cpu(), cr, rtol=1e-5, atol=1e-7)
    assert not kw.overflow.any()
    torch.testing.assert_close(kc.sum(0).cpu(), kr.sum(0).cpu(), rtol=1e-4,
                               atol=0)
    want = allocate_walks(cr, rcfg.omega_unit, 1 << 16)
    got = allocate_walks(cr.to(dev), rcfg.omega_unit, 1 << 16)
    for f in want._fields:
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


def _ring_inputs(G, n_loc, B, devices, seed):
    """P1 buffers (own block set, NaN elsewhere) and P2 partials, one per
    shard on ``devices[h]``."""
    rng = np.random.default_rng(seed)
    bufs, xs = [], []
    for h in range(G):
        b = np.full((G * n_loc, B), np.nan, np.float32)
        b[h * n_loc:(h + 1) * n_loc] = rng.standard_normal((n_loc, B))
        bufs.append(torch.as_tensor(b, device=devices[h]))
        xs.append(torch.as_tensor(
            rng.standard_normal((G * n_loc, B)).astype(np.float32),
            device=devices[h]))
    return bufs, xs


def _check_ring_kernels(devices, n_loc, B):
    from fora_tpu_torch import kernels
    from fora_tpu_torch.ops import ring
    G = len(devices)
    bufs, xs = _ring_inputs(G, n_loc, B, devices, seed=G * n_loc + B)
    want = ring.ring_all_gather_plain([b.clone() for b in bufs])
    before = kernels.launch_counts()
    got = ring.ring_all_gather([b.clone() for b in bufs])
    for d in set(devices):
        torch.cuda.synchronize(d)
    after = kernels.launch_counts()
    assert after["ring_all_gather_hop"] - before["ring_all_gather_hop"] == \
        (G - 1) * G
    for h in range(G):
        assert got[h].device == devices[h]
        assert not torch.isnan(got[h]).any()
        assert torch.equal(got[h], want[h])          # bit for bit
        assert torch.equal(got[h].cpu(), got[0].cpu())
    want = ring.ring_reduce_scatter_plain(xs)
    got = ring.ring_reduce_scatter_hops(xs)
    for d in set(devices):
        torch.cuda.synchronize(d)
    after2 = kernels.launch_counts()
    assert after2["ring_reduce_scatter_hop"] - \
        after["ring_reduce_scatter_hop"] == (G - 1) * G
    total = sum(x.cpu().double() for x in xs)
    for h in range(G):
        assert got[h].shape == (n_loc, B) and got[h].device == devices[h]
        assert torch.equal(got[h], want[h])          # bit for bit
        torch.testing.assert_close(
            got[h].cpu().double(), total[h * n_loc:(h + 1) * n_loc],
            rtol=1e-5, atol=1e-5)
    # the dispatcher: one launch of the one pass on one card, the hops
    # across cards; the same bits either way
    got = ring.ring_reduce_scatter(xs)
    for d in set(devices):
        torch.cuda.synchronize(d)
    after3 = kernels.launch_counts()
    one_card = len(set(devices)) == 1
    assert after3["reduce_scatter_onepass"] - \
        after2["reduce_scatter_onepass"] == (1 if one_card else 0)
    assert after3["ring_reduce_scatter_hop"] - \
        after2["ring_reduce_scatter_hop"] == (0 if one_card else (G - 1) * G)
    for h in range(G):
        assert got[h].device == devices[h]
        assert torch.equal(got[h], want[h])


@pytest.mark.parametrize("n_loc,B", [(1000, 4), (1001, 3), (131072, 128)])
@pytest.mark.parametrize("G", [2, 4])
def test_ring_kernels_match_plain_one_card(dev, G, n_loc, B):
    """P1 and P2 with all G shards on one card: stream order is the whole
    protocol.  (1001, 3) leaves the blocks unaligned for float4."""
    _check_ring_kernels([dev] * G, n_loc, B)


@pytest.mark.parametrize("n_loc,B", [(1000, 4), (1001, 3), (7, 1),
                                     (131072, 128)])
@pytest.mark.parametrize("G", [2, 3, 4, 8])
def test_reduce_scatter_onepass_kernel(dev, G, n_loc, B):
    """The one-pass P2 kernel: one launch, bit-equal to its plain version
    and to the hop kernels' ring on the same partials, and within float
    rounding of a float64 sum; partials that are not 16-byte aligned take
    the scalar path.  (1001, 3) and (7, 1) leave the blocks unaligned."""
    from fora_tpu_torch import kernels
    from fora_tpu_torch.ops import ring
    _, xs = _ring_inputs(G, n_loc, B, [dev] * G, seed=G * 31 + n_loc)
    want = ring.reduce_scatter_onepass_plain([x.cpu() for x in xs])
    hops = ring.ring_reduce_scatter_hops(xs)
    before = kernels.launch_counts()
    got = ring.reduce_scatter_onepass(xs)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["reduce_scatter_onepass"] - \
        before["reduce_scatter_onepass"] == 1
    assert after["ring_reduce_scatter_hop"] == \
        before["ring_reduce_scatter_hop"]
    total = sum(x.cpu().double() for x in xs)
    for h in range(G):
        assert got[h].shape == (n_loc, B) and got[h].device == dev
        assert torch.equal(got[h].cpu(), want[h])
        assert torch.equal(got[h], hops[h])
        torch.testing.assert_close(
            got[h].cpu().double(), total[h * n_loc:(h + 1) * n_loc],
            rtol=1e-5, atol=1e-5)
    # a partial one float off 16-byte alignment: the scalar path
    base = torch.empty(G * n_loc * B + 1, device=dev)
    odd = base[1:].view(G * n_loc, B)
    odd.copy_(xs[0])
    got = ring.reduce_scatter_onepass([odd] + xs[1:])
    for h in range(G):
        assert torch.equal(got[h], hops[h])
    with pytest.raises(ValueError):
        kernels.reduce_scatter_onepass(torch.empty_like(xs[0]),
                                       [xs[0], xs[1][:-1]])


@pytest.mark.parametrize("cards", [2, 4])
def test_ring_kernels_match_plain_across_cards(dev, cards):
    """P1 and P2 with one shard on each of ``cards`` cards: peer reads,
    ordered by CUDA events."""
    if torch.cuda.device_count() < cards:
        pytest.skip(f"needs {cards} CUDA devices")
    _check_ring_kernels([torch.device("cuda", c) for c in range(cards)],
                        4096, 128)


@pytest.mark.parametrize("cards", [1, 4])
def test_sharded_engine_on_card_matches_cpu(dev, cards):
    """Four shards on ``cards`` cards (K1, K2, K3, P1, P2) against the same
    engine on the CPU with the plain versions."""
    if torch.cuda.device_count() < cards:
        pytest.skip(f"needs {cards} CUDA devices")
    from fora_tpu_torch import ForaConfig as TorchForaConfig
    from fora_tpu_torch import kernels
    from fora_tpu_torch.graph import generators as tgen
    from fora_tpu_torch.graph import to_device
    from fora_tpu_torch.index import build_walk_index
    from fora_tpu_torch.parallel import ShardedForaEngine, make_mesh
    g = tgen.rmat(12, 1 << 15, seed=3)
    rcfg = TorchForaConfig(epsilon=0.5, k=20).resolved(g.n, g.m)
    idx = build_walk_index(to_device(g, device="cpu"), rcfg, seed=4)
    src = np.arange(0, 64 * 61, 61)
    res = {}
    cuda = [torch.device("cuda", h % cards) for h in range(4)]
    for name, devs in (("cpu", ["cpu"] * 4), ("cuda", cuda)):
        eng = ShardedForaEngine(g, make_mesh(4, devices=devs), rcfg, index=idx)
        kernels.reset_launch_counts()
        res[name] = eng.topk(src)
        counts = kernels.launch_counts()
        if name == "cuda":
            it = res[name].push_iters
            assert it > 0 and counts["index_spmv"] > 0
            assert counts["push_prepass"] == 4 * it
            assert counts["gather_scatter_add"] == 4 * it
            assert counts["ring_all_gather_hop"] == 12 * it
            # P2: the one pass on one card, the ring's hops across cards
            assert counts["reduce_scatter_onepass"] == (cards == 1)
            assert counts["ring_reduce_scatter_hop"] == 12 * (cards > 1)
            assert counts["topk_bounds"] == 4
        else:
            assert all(n == 0 for n in counts.values())
    assert res["cuda"].push_iters == res["cpu"].push_iters
    np.testing.assert_allclose(res["cuda"].values, res["cpu"].values,
                               rtol=1e-5, atol=1e-7)
    same = (res["cuda"].node_ids == res["cpu"].node_ids).mean()
    assert same > 0.95


def _compact_inputs(rng, n_loc, B, D, frac):
    contrib = np.zeros((n_loc, B), np.float32)
    act = rng.random(n_loc) < frac
    contrib[act] = rng.random((int(act.sum()), B)) * (
        rng.random((int(act.sum()), B)) < 0.5)
    contrib[act, rng.integers(0, B)] = 0.25     # every active row non-zero
    contrib[rng.integers(0, n_loc, 5)] = -0.0   # negative zeros: no entry
    needed = None if D is None else (rng.random((D, n_loc)) < 0.5
                                     ).astype(np.uint8)
    return contrib, needed


@pytest.mark.parametrize("B", [1, 3, 128, 130])
@pytest.mark.parametrize("D", [None, 1, 4, 32])
@pytest.mark.parametrize("frac,cap", [(0.1, 600), (0.5, 64)])
def test_frontier_compact_kernel_matches_plain(dev, B, D, frac, cap):
    """The compaction kernel (slot claims aggregated per block) against its
    plain version: the counts equal (past cap too), and per destination
    the same (id, row) pairs bit for bit once ordered by id (the slot
    order varies across the kernel's blocks); unused id slots hold the pad
    id.  With frac 0.5 and cap 64 every destination overflows: the kernel
    then fills cap slots with rows of its choice, each a real row at its
    id.  n_loc is not a multiple of the kernel's 256-row tile."""
    from fora_tpu_torch import kernels
    from fora_tpu_torch.ops.exchange import frontier_compact_plain
    rng = np.random.default_rng(B + (D or 0))
    n_loc, row0, pad = 4133, 8192, 16384
    c_np, n_np = _compact_inputs(rng, n_loc, B, D, frac)
    Dn = 1 if D is None else D
    contrib = torch.as_tensor(c_np, device=dev)
    needed = None if n_np is None else torch.as_tensor(n_np, device=dev)
    out = {}
    for name, t in (("kernel", dev), ("plain", "cpu")):
        ids = torch.full((Dn, cap + 3), -5, dtype=torch.int32, device=t)
        rows = torch.full((Dn, cap + 3, B), float("nan"), device=t)
        counts = torch.full((Dn,), 77, dtype=torch.int32, device=t)
        args = (contrib.to(t), None if needed is None else needed.to(t), cap,
                row0, pad, ids, rows, counts)
        if name == "kernel":
            before = kernels.frontier_compact.launches
            kernels.frontier_compact(*args)
            torch.cuda.synchronize()
            assert kernels.frontier_compact.launches == before + 1
        else:
            frontier_compact_plain(*args)
        out[name] = (ids.cpu().numpy(), rows.cpu().numpy(),
                     counts.cpu().numpy())
    (ki, kr, kc), (pi, pr, pc) = out["kernel"], out["plain"]
    np.testing.assert_array_equal(kc, pc)
    for d in range(Dn):
        n = min(int(pc[d]), cap)
        assert (ki[d, n:cap] == pad).all() and (ki[d, cap:] == -5).all()
        kid = ki[d, :n]
        assert len(np.unique(kid)) == n and (kid >= row0).all()
        np.testing.assert_array_equal(
            kr[d, :n].view(np.uint32), c_np[kid - row0].view(np.uint32))
        if pc[d] <= cap:
            order = np.argsort(kid)
            np.testing.assert_array_equal(kid[order], pi[d, :n])
            np.testing.assert_array_equal(kr[d, :n][order].view(np.uint32),
                                          pr[d, :n].view(np.uint32))
        else:
            want = set(np.nonzero(np.abs(c_np).sum(axis=1))[0] + row0)
            if n_np is not None:
                want &= set(np.nonzero(n_np[d])[0] + row0)
            assert set(kid.tolist()) <= want


def test_row_scatter_add_skips_pad_ids(dev):
    """P3 skips every edge whose destination lies outside acc (the pad id
    n_pad, and any negative id): bit-equal to the plain version, and a
    receive of unique ids into zeros holds each row exactly."""
    from fora_tpu_torch import kernels
    from fora_tpu_torch.ops.gather import row_scatter_add_plain
    rng = np.random.default_rng(5)
    rows_n, B, E = 1000, 128, 4096
    tile = torch.as_tensor(rng.random((E, B), np.float32), device=dev)
    src = torch.arange(E, dtype=torch.int32, device=dev)
    ids = np.full(E, rows_n, np.int32)              # pads everywhere
    real = rng.choice(E, 600, replace=False)
    ids[real] = rng.choice(rows_n, 600, replace=False)
    ids[real[:10]] = -3                              # also skipped
    dst = torch.as_tensor(ids, device=dev)
    got = kernels.row_scatter_add(torch.zeros(rows_n, B, device=dev), tile,
                                  src, dst)
    want = row_scatter_add_plain(torch.zeros(rows_n, B), tile.cpu(),
                                 src.cpu(), dst.cpu())
    assert torch.equal(got.cpu(), want)
    keep = real[10:]
    assert torch.equal(got[torch.as_tensor(ids[keep], device=dev).long()],
                       tile[torch.as_tensor(keep, device=dev)])
    acc = torch.ones(rows_n, B, device=dev)
    kernels.row_scatter_add(acc, tile, src,
                            torch.full_like(dst, rows_n))
    assert bool((acc == 1).all())


def test_row_zero_kernel_matches_plain(dev):
    """The compacted exchange's clear (``kernels.exchange_clear``) on the
    card: per buffer its own block and the real ids' rows zeroed (repeats,
    ids inside the own block allowed), pads and negative ids skipped,
    bit-equal to its plain version (a ``zero_`` of the own block and
    ``row_zero_plain``); B = 3 takes scalar stores; one launch a call for
    1, 2 or 4 buffers; a bad id dtype or own block refused."""
    from fora_tpu_torch import kernels
    from fora_tpu_torch.ops.exchange import exchange_clear_plain
    rng = np.random.default_rng(8)
    for G, n_loc, B, n_ids in ((1, 1000, 128, 65536), (2, 500, 3, 4096),
                               (4, 131072, 128, 65536)):
        rows_n = G * n_loc
        bufs = [torch.as_tensor(rng.uniform(1, 2, (rows_n, B)).astype(
            np.float32), device=dev) for _ in range(G)]
        ids = []
        for _ in range(G):
            a = np.full(n_ids, rows_n, np.int32)
            real = rng.choice(n_ids, n_ids // 3, replace=False)
            a[real] = rng.integers(0, rows_n, len(real))
            a[real[:7]] = -2
            ids.append(torch.as_tensor(a, device=dev))
        want = [b.cpu() for b in bufs]
        exchange_clear_plain(want, n_loc, [i.cpu() for i in ids])
        before = kernels.exchange_clear.launches
        kernels.exchange_clear(bufs, n_loc, ids)
        torch.cuda.synchronize()
        assert kernels.exchange_clear.launches == before + 1
        for b, w in zip(bufs, want):
            assert torch.equal(b.cpu(), w)
    with pytest.raises(TypeError):
        kernels.exchange_clear(bufs, n_loc, [i.long() for i in ids])
    with pytest.raises(ValueError):
        kernels.exchange_clear(bufs, n_loc, ids, own=[0, 1, 2, 4])


@pytest.mark.parametrize("mode,C", [("compact", 1), ("routed", 1),
                                    ("hier", 2)])
def test_zeroing_by_rows_on_card(dev, mode, C):
    """The exchange's zeroing by rows on the card (the aggregated
    compaction, the clear, P3) over compacted, compacted, fallen-back and
    compacted supersteps: every buffer bit-equal to the same exchange
    with its whole buffer zeroed by hand before each compacted receive,
    and to the ring's on
    every needed row; the clear launched once on each compacted
    superstep that follows a compacted one, and on no other."""
    from fora_tpu_torch import kernels
    from fora_tpu_torch.ops import exchange as xops
    from fora_tpu_torch.ops import ring
    G, n_loc, B, cap = 4, 4096, 128, 512
    rng = np.random.default_rng(12)
    needed = None
    if mode != "compact":
        D = G if mode == "routed" else G // C
        needed = [torch.as_tensor((rng.random((D, n_loc)) < 0.5).astype(
            np.uint8), device=dev) for _ in range(G)]
    xchs = [xops.FrontierExchange(mode, [dev] * G, n_loc, cap, needed,
                                  C if mode == "hier" else None)
            for _ in range(2)]
    kept, whole = xchs
    bufs = [x.buffers(B) for x in xchs]
    fracs = (0.05, 0.1, 0.9, 0.02, 0.08)
    for i, frac in enumerate(fracs):
        blocks = []
        for h in range(G):
            c = np.zeros((n_loc, B), np.float32)
            act = rng.random(n_loc) < frac
            c[act] = rng.random((int(act.sum()), B)) + 0.5
            blocks.append(torch.as_tensor(c, device=dev))
        dense = None
        for x, b in zip(xchs, bufs):
            for h in range(G):
                b[h][h * n_loc:(h + 1) * n_loc] = blocks[h]
            if dense is None:
                dense = ring.ring_all_gather_plain([t.clone() for t in b])
            cnt = [torch.zeros(x.D, dtype=torch.int32, device=dev)
                   for _ in range(G)]
            x.send(b, cnt)
            counts = np.stack([t.cpu().numpy() for t in cnt])
            assert x.fits(counts) == (i != 2)
            if x is whole and x.fits(counts):
                for t in b:    # the send has read the own blocks
                    t.zero_()
            before = kernels.exchange_clear.launches
            x.exchange(b, counts)
            if x is kept:
                zeroed = kernels.exchange_clear.launches - before
        torch.cuda.synchronize()
        assert zeroed == (1 if i in (1, 4) else 0)
        for t in range(G):
            assert torch.equal(bufs[0][t], bufs[1][t])
            need = torch.cat([
                needed[s][kept._region(t)].bool() if needed is not None
                else torch.ones(n_loc, dtype=torch.bool, device=dev)
                for s in range(G)])
            if i != 2:
                assert torch.equal(bufs[0][t][need], dense[t][need])
                assert bool((bufs[0][t][~need] == 0).all())
    assert (kept.compacted, kept.fell_back) == (4, 1)


def test_sharded_pool_modes_on_card(dev):
    """ShardedTopkRunner with four shards on one card: compact, routed and
    hier bit-equal to dense (ids, values, bounds, levels), the compaction
    kernel and P3 launched on the compacted runs only, P1 and P2 on every
    run, K3 once per shard and level run; dense against the CPU pool
    (rtol 1e-5)."""
    from fora_tpu_torch import ForaConfig as TorchForaConfig
    from fora_tpu_torch import kernels
    from fora_tpu_torch.graph import generators as tgen
    from fora_tpu_torch.graph import to_device
    from fora_tpu_torch.index import build_walk_index
    from fora_tpu_torch.parallel import ShardedTopkRunner, make_mesh
    g = tgen.rmat(12, 1 << 15, seed=3)
    rcfg = TorchForaConfig(epsilon=0.5, k=20).resolved(g.n, g.m)
    idx = build_walk_index(to_device(g, device="cpu"), rcfg, seed=4)
    src = np.arange(0, 64 * 61, 61)
    res, counts = {}, {}
    for mode in ("dense", "compact", "routed", "hier", "cpu"):
        devs = ["cpu"] * 4 if mode == "cpu" else [dev] * 4
        run = ShardedTopkRunner(
            g, make_mesh(4, devices=devs), rcfg, idx, k=20,
            delta_stride=8, exchange="dense" if mode == "cpu" else mode,
            chips_per_host=2 if mode == "hier" else None)
        kernels.reset_launch_counts()
        res[mode] = run.query_pool(src, batch=32)
        counts[mode] = kernels.launch_counts()
        levels = sum(st["batches"] for st in run.last_level_stats)
        if mode == "cpu":
            assert all(n == 0 for n in counts[mode].values())
            continue
        c = counts[mode]
        assert c["topk_bounds"] == 4 * levels
        assert c["index_spmv"] == 4 * levels
        assert c["reduce_scatter_onepass"] == levels
        assert c["ring_reduce_scatter_hop"] == 0
        compacted = sum(st["compacted"] for st in run.last_level_stats)
        cleared = sum(st["cleared"] for st in run.last_level_stats)
        if mode == "dense":
            assert c["frontier_compact"] == c["row_scatter_add"] == 0
            assert c["exchange_clear"] == cleared == 0
        else:
            assert compacted > 0
            assert c["row_scatter_add"] == 4 * compacted
            assert c["frontier_compact"] >= 4 * compacted
            assert 0 < c["exchange_clear"] == cleared <= compacted
    for mode in ("compact", "routed", "hier"):
        for f in ("node_ids", "values", "lower_bounds", "upper_bounds",
                  "accepted"):
            np.testing.assert_array_equal(getattr(res[mode], f),
                                          getattr(res["dense"], f))
        assert res[mode].levels_used == res["dense"].levels_used
    np.testing.assert_allclose(res["dense"].values, res["cpu"].values,
                               rtol=1e-5, atol=1e-7)
    assert (res["dense"].node_ids == res["cpu"].node_ids).mean() > 0.95


def _weighted_rmat(n_log2, m, seed):
    """An RMAT multigraph weighted as bench.py weights its graph."""
    from fora_tpu_torch.graph import from_edges
    from fora_tpu_torch.graph import generators as tgen
    g0 = tgen.rmat(n_log2, m, seed=seed)
    src = np.repeat(np.arange(g0.n), g0.out_deg)
    w = np.exp2(np.random.default_rng(seed + 31).uniform(-2, 2, g0.m))
    return from_edges(src, g0.out_indices, g0.n, w=w)


def test_alias_library_matches_numpy_copy(dev):
    """The library's host-side alias builder (csrc/alias.cu) array-equal
    to the numpy copy on a skewed weighted RMAT; to_device on the card
    takes the library's tables."""
    from fora_tpu_torch.graph import alias, to_device
    g = _weighted_rmat(14, 1 << 18, seed=5)
    assert np.diff(g.out_indptr).max() > 1000          # a skewed row
    want = alias.build_alias(g, g.out_w)
    got = alias.build_alias_library(g, g.out_w)
    np.testing.assert_array_equal(got.prob, want.prob)
    np.testing.assert_array_equal(got.other, want.other)
    dg = to_device(g, device=dev)
    np.testing.assert_array_equal(dg.alias_prob.cpu().numpy(), want.prob)
    np.testing.assert_array_equal(dg.alias_other.cpu().numpy(), want.other)


def test_walk_kernel_alias_star(dev):
    """One hop from a hub with weights 1, 2, 4, 8, 1 on the card's alias
    branch ends at each leaf w.p. w / W; the uniform branch is not
    launched."""
    from fora_tpu_torch import kernels
    from fora_tpu_torch.graph import from_edges, to_device
    from fora_tpu_torch.ops.walk import walk_endpoints
    w = np.array([1.0, 2.0, 4.0, 8.0, 1.0], np.float32)
    dg = to_device(from_edges(np.zeros(5, np.int64), np.arange(1, 6), 6,
                              w=w), device=dev)
    before = kernels.launch_counts()
    ends = walk_endpoints(dg, torch.zeros(1 << 18, dtype=torch.int32,
                                          device=dev), 3, 1e-6, 1)
    after = kernels.launch_counts()
    assert after["index_walk_alias"] == before["index_walk_alias"] + 1
    assert after["index_walk"] == before["index_walk"]
    counts = np.bincount(ends.cpu().numpy(), minlength=6)[1:]
    assert counts.sum() > (1 << 18) - 20
    assert chisquare_pvalue(counts, w) > 1e-3, counts


def test_walk_kernel_alias_matches_plain_and_exact(dev):
    """K4's alias branch against the plain alias run_walks (two-sample
    chi-square) and both against weighted exact PPR, on a weighted RMAT
    with dangling nodes."""
    from fora_tpu_torch.algo import exact as texact
    from fora_tpu_torch.graph import to_device
    from fora_tpu_torch.ops.walk import run_walks, walk_endpoints
    from fora_tpu_torch.eval.queries import generate_sources
    g = _weighted_rmat(10, 8192, seed=7)
    assert (g.out_deg == 0).any()
    dg = to_device(g, merge_duplicate_edges=True, device=dev)
    sources = generate_sources(g, 2, seed=1)
    pi = texact.exact_ppr_batch(g, sources, device="cpu").numpy()
    W = 1 << 20
    for b, s in enumerate(sources):
        start = torch.full((W,), s, dtype=torch.int32, device=dev)
        ends_k = walk_endpoints(dg, start, 11 + b, 0.2, 64).cpu().numpy()
        gen = torch.Generator(device=dev).manual_seed(b)
        ends_p = run_walks(dg, start, generator=gen, alpha=0.2,
                           max_hops=64).cpu().numpy()
        assert two_sample_pvalue(ends_k, ends_p) > 1e-3
        assert_endpoints_follow(ends_k, pi[:, b])
        assert_endpoints_follow(ends_p, pi[:, b])


def test_weighted_push_superstep_kernel(dev):
    """A weighted K1 superstep (w/W pre-pass, weighted tail and hub
    gathers) bit-equal over two launches and close to the plain version
    in float64."""
    from fora_tpu_torch.graph import to_device
    from fora_tpu_torch.ops import push
    from fora_tpu_torch.ops.gather import gather_scatter_add_plain
    g = _weighted_rmat(12, 1 << 15, seed=3)
    dg = to_device(g, merge_duplicate_edges=True, hub_rows=256, device=dev)
    assert dg.weighted and dg.hub_split
    thr = push.node_threshold(dg, 1e-5)
    st = push.init_state(g.n, torch.arange(0, 64 * 61, 61, dtype=torch.int32,
                                           device=dev))
    for _ in range(3):
        st = push.superstep(dg, st, alpha=0.2, thr=thr)
    runs = []
    for _ in range(2):
        p, r = st.p.clone(), st.r.clone()
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        push.superstep(dg, push.PushState(p, r, 0), alpha=0.2, thr=thr,
                       flag=flag)
        runs.append((p, r, int(flag.item())))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1]) and runs[0][2] == runs[1][2]
    pp, pr = st.p.double(), st.r.double()
    contrib = torch.empty_like(pr)
    push.push_prepass_plain(pp, pr, contrib, thr, dg.out_deg, dg.out_wsum,
                            0.2)
    gather_scatter_add_plain(pr, contrib, dg.in_indptr, dg.in_src,
                             edge_w=dg.in_w, thr=thr, mask=True)
    gather_scatter_add_plain(pr, contrib.index_select(0, dg.hub_ids),
                             dg.hub_indptr, dg.hub_src_local, edge_w=dg.hub_w)
    torch.testing.assert_close(runs[0][0], pp.float(), rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(runs[0][1], pr.float(), rtol=1e-5, atol=1e-7)


def test_backward_prepass_kernel_bit_equal_plain(dev):
    """K1-back pre-pass against its plain version, bit for bit, dangling
    rows included; a second launch bit-equal; its own launch count."""
    from fora_tpu_torch import kernels
    from fora_tpu_torch.algo.bippr import backward_prepass_plain
    rng = np.random.default_rng(17)
    for n, T in ((5000, 2048), (3001, 7), (1, 1)):
        r = torch.as_tensor(rng.random((n, T), dtype=np.float32) * 1e-3,
                            device=dev)
        p0 = torch.as_tensor(rng.random((n, T), dtype=np.float32),
                             device=dev)
        deg = torch.as_tensor(rng.integers(0, 3, n).astype(np.int32),
                              device=dev)
        assert n == 1 or bool((deg == 0).any())
        want_p, want_s = p0.clone(), torch.empty_like(r)
        backward_prepass_plain(want_p, r, want_s, 4.9e-4, deg, 0.2)
        before = kernels.backward_prepass.launches
        for _ in range(2):
            p, s = p0.clone(), torch.full_like(r, float("nan"))
            kernels.backward_prepass(p, r, s, 4.9e-4, deg, 0.2)
            assert torch.equal(p, want_p) and torch.equal(s, want_s)
        assert kernels.backward_prepass.launches == before + 2


def test_backward_push_on_card_matches_cpu_and_float64(dev):
    """BiPPR's backward push on the card (K1-back pre-pass, K1's gather
    over the out-CSR) against the CPU's plain push (p, r at rtol 1e-5,
    the same supersteps), and one more superstep on the card against the
    plain one in float64; weighted and unweighted, with dangling nodes."""
    from fora_tpu_torch import kernels
    from fora_tpu_torch.algo import bippr
    from fora_tpu_torch.graph import generators as tgen
    from fora_tpu_torch.graph import to_device
    from fora_tpu_torch.ops.gather import gather_scatter_add_plain
    for g in (tgen.rmat(12, 1 << 15, seed=3), _weighted_rmat(12, 1 << 15, 5)):
        assert (g.out_deg == 0).any()
        targets = np.arange(0, 130 * 31, 31)
        out = {}
        for d in ("cpu", dev):
            dg = to_device(g, device=d)
            kernels.reset_launch_counts()
            out[str(d)] = bippr.backward_push(dg, targets, rmax_b=1e-4,
                                              alpha=0.2)
            counts = kernels.launch_counts()
            if d != "cpu":
                it = out[str(d)].iters
                assert counts["backward_prepass"] == it > 0
                assert counts["gather_scatter_add"] == it
                assert dg.out_sched is not None
        cpu, card = out["cpu"], out[str(dev)]
        assert cpu.iters == card.iters
        torch.testing.assert_close(card.p.cpu(), cpu.p, rtol=1e-5, atol=1e-7)
        torch.testing.assert_close(card.r.cpu(), cpu.r, rtol=1e-5, atol=1e-7)
        # one superstep from a state with active entries, float64 plain
        st = bippr.backward_push(dg, targets, rmax_b=1e-3, alpha=0.2,
                                 max_iters=2)
        thr = torch.full((g.n,), 1e-4, dtype=torch.float32, device=dev)
        edge_w = bippr.backward_edge_weights(dg)
        p, r = st.p.clone(), st.r.clone()
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        bippr.backward_superstep(dg, bippr.BackwardPushState(p, r, 0),
                                 rmax_b=1e-4, alpha=0.2, thr=thr,
                                 spread=torch.empty_like(r), edge_w=edge_w,
                                 flag=flag)
        pp, pr = st.p.double(), st.r.double()
        spread = torch.empty_like(pr)
        bippr.backward_prepass_plain(pp, pr, spread, 1e-4, dg.out_deg, 0.2)
        pflag = torch.zeros(1, dtype=torch.int32, device=dev)
        gather_scatter_add_plain(pr, spread, dg.out_indptr, dg.out_indices,
                                 edge_w=edge_w.double(), thr=thr.double(),
                                 mask=True, flag=pflag)
        torch.testing.assert_close(p, pp.float(), rtol=1e-5, atol=1e-7)
        torch.testing.assert_close(r, pr.float(), rtol=1e-5, atol=1e-7)
        assert int(flag.item()) == int(pflag.item())


def _hub_on_path():
    """An 8-cycle whose node 2 is a hub with an honest pool of 2^16 plain
    walks: every walk from 0 that lives two hops substitutes there."""
    from fora_tpu_torch.algo.hubppr import HubIndex
    from fora_tpu_torch.graph import to_device
    from fora_tpu_torch.ops.walk import run_walks
    g = generators.cycle_graph(8)
    dg = to_device(g, device="cpu")
    pool = run_walks(dg, torch.full((1 << 16,), 2, dtype=torch.int32),
                     generator=torch.Generator().manual_seed(3), alpha=0.2)
    hub_id = torch.full((8,), -1, dtype=torch.int32)
    hub_id[2] = 0
    return g, HubIndex(torch.tensor([2], dtype=torch.int32), hub_id,
                       pool[None, :])


def test_walk_kernel_hub_matches_plain_and_exact(dev):
    """K4-hub on a graph where a hub sits on most paths against the plain
    hub walk (two-sample chi-square) and exact PPR; a poisoned pool shows
    the substitution; only index_walk_hub counts the launches."""
    from fora_tpu_torch import kernels
    from fora_tpu_torch.algo import hubppr
    from fora_tpu_torch.graph import to_device
    g, hub = _hub_on_path()
    dg = to_device(g, device=dev)
    hub = hubppr.HubIndex(*(t.to(dev) for t in hub))
    W = 1 << 20
    start = torch.zeros(W, dtype=torch.int32, device=dev)
    before = kernels.launch_counts()
    ends_k = hubppr.hub_walks(dg, start, 5, hub, alpha=0.2)
    after = kernels.launch_counts()
    assert after["index_walk_hub"] == before["index_walk_hub"] + 1
    assert all(after[k] == before[k] for k in after if k != "index_walk_hub")
    gen = torch.Generator(device=dev).manual_seed(6)
    ends_p = hubppr.hub_walks_plain(dg, start, hub, generator=gen, alpha=0.2)
    assert two_sample_pvalue(ends_k.cpu().numpy(), ends_p.cpu().numpy()) \
        > 1e-3
    assert np.abs(np.bincount(ends_k.cpu().numpy(), minlength=8) / W
                  - exact.exact_ppr_dense(g, 0)).sum() < 0.01
    poison = hubppr.HubIndex(hub.hub_nodes, hub.hub_id,
                             torch.full((1, 16), 5, dtype=torch.int32,
                                        device=dev))
    hub_id1 = torch.full((8,), -1, dtype=torch.int32, device=dev)
    hub_id1[1] = 0
    ends = hubppr.hub_walks(dg, start, 7, poison._replace(hub_id=hub_id1),
                            alpha=0.2).cpu().numpy()
    assert set(np.unique(ends)) <= {0, 5}
    assert abs((ends == 0).mean() - 0.2) < 0.002


def test_walk_kernel_hub_alias_branch(dev):
    """K4-hub on a weighted graph takes the alias hop: against the plain
    alias hub walk and both against the weighted oracle, with a pool far
    larger than the walks that reach each hub."""
    from fora_tpu_torch.algo import exact as texact
    from fora_tpu_torch.algo import hubppr
    from fora_tpu_torch.graph import to_device
    g = _weighted_rmat(10, 8192, seed=7)
    dg = to_device(g, merge_duplicate_edges=True, device=dev)
    hub = hubppr.build_hub_index(dg, 2, alpha=0.2, num_hubs=16,
                                 pool_size=1 << 18)
    hub_id = hub.hub_id.cpu().numpy()
    src = int(np.nonzero((g.out_deg > 3) & (hub_id < 0))[0][0])
    pi = texact.exact_ppr_batch(g, [src], device="cpu").numpy()[:, 0]
    W = 1 << 18
    start = torch.full((W,), src, dtype=torch.int32, device=dev)
    ends_k = hubppr.hub_walks(dg, start, 3, hub, alpha=0.2).cpu().numpy()
    gen = torch.Generator(device=dev).manual_seed(4)
    ends_p = hubppr.hub_walks_plain(dg, start, hub, generator=gen,
                                    alpha=0.2).cpu().numpy()
    assert two_sample_pvalue(ends_k, ends_p) > 1e-3
    assert_endpoints_follow(ends_k, pi)
    assert_endpoints_follow(ends_p, pi)


@pytest.mark.parametrize("weighted", [False, True])
def test_load_dataset_library_parser_matches_numpy(dev, tmp_path, weighted):
    """graph/io's library parser (csrc/graph_io.cu, host code) against the
    numpy branch: the same arrays, and the same CSRGraph through
    load_dataset for the card and for the CPU; a mixed-width file and a
    missing one raise."""
    from fora_tpu_torch.graph import generators as tgen
    from fora_tpu_torch.graph import io as tio
    g = _weighted_rmat(12, 40000, 3) if weighted else \
        tgen.rmat(12, 40000, seed=3)
    tio.save_dataset(g, str(tmp_path), "d")
    path = tmp_path / "d" / "graph.txt"
    a = tio.parse_edges_library(path, weighted)
    b = tio.parse_edges_numpy(path, weighted)
    for x, y in zip(a, b):
        assert (x is None) == (y is None)
        if x is not None:
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    card = tio.load_dataset(str(tmp_path), "d", use_cache=False, device=dev)
    cpu = tio.load_dataset(str(tmp_path), "d", use_cache=False, device="cpu")
    for f in cpu._fields:
        x, y = getattr(card, f), getattr(cpu, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=f)
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "graph.txt").write_text("# c\n0 1\n1 2 0.5\n")
    for cols in (False, True):
        with pytest.raises(ValueError, match="not"):
            tio.parse_edges_library(bad / "graph.txt", cols)
    with pytest.raises(OSError):
        tio.parse_edges_library(tmp_path / "none" / "graph.txt", False)


def test_server_over_cuda_runner(dev):
    """ForaServer over a CUDA TopkRunner: query_fn runs on the server's
    worker thread and launches there; the answers agree with the runner's
    own from the main thread (values at rtol 1e-4, at least 9 of the 10
    ids: the batches group the sources differently)."""
    import asyncio
    import json
    import threading
    from fora_tpu_torch import ForaConfig as TorchForaConfig
    from fora_tpu_torch import TopkRunner, kernels
    from fora_tpu_torch.graph import generators as tgen
    from fora_tpu_torch.graph import to_device
    from fora_tpu_torch.index import build_walk_index
    from fora_tpu_torch.serve import ForaServer
    g = tgen.rmat(12, 1 << 15, seed=3)
    rcfg = TorchForaConfig(epsilon=0.5, k=10).resolved(g.n, g.m)
    idx = build_walk_index(to_device(g, device="cpu"), rcfg, seed=4)
    runner = TopkRunner(to_device(g, device=dev), rcfg, k=10, index=idx,
                        delta_stride=4.0)
    sources = [3, 61, 122, 500, 901, 1200, 2047, 4000]
    want = runner.query_pool(np.asarray(sources), 1, batch=4, start_level=0)
    threads = set()

    def query_fn(src, seed):
        threads.add(threading.get_ident())
        res = runner.query_pool(np.asarray(src), int(seed), batch=4,
                                start_level=0)
        return res.node_ids, res.values

    async def roundtrip(port, reqs):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        out = []
        for req in reqs:
            writer.write((json.dumps(req) + "\n").encode())
            await writer.drain()
            out.append(json.loads(await reader.readline()))
        writer.close()
        return out

    async def main():
        srv = ForaServer(query_fn, batch=4, k=10, max_wait_ms=20,
                         inflight=1)
        port = await srv.start(port=0)
        outs = await asyncio.gather(*[
            roundtrip(port, [{"id": i, "source": s}])
            for i, s in enumerate(sources)])
        stats = (await roundtrip(port, [{"cmd": "stats"}]))[0]
        await srv.stop()
        return [o[0] for o in outs], stats

    kernels.reset_launch_counts()
    out, stats = asyncio.run(main())
    counts = kernels.launch_counts()
    assert threading.get_ident() not in threads
    assert stats["errors"] == 0 and stats["queries"] == len(sources)
    for name in ("push_prepass", "gather_scatter_add", "index_spmv",
                 "topk_bounds"):
        assert counts[name] > 0, name
    for i, r in enumerate(out):
        assert r["id"] == i
        assert len(set(r["nodes"]) & set(want.node_ids[i].tolist())) >= 9
        np.testing.assert_allclose(r["scores"], want.values[i], rtol=1e-4)


def _philox_graph(dev, branch):
    """The graph (and hub index) of each K4 branch for the bit-equality
    tests: an RMAT 2^10 with dangling nodes, weighted for the alias
    branches, with a hub index of 8 hubs for the hub branches."""
    from fora_tpu_torch.algo import hubppr
    from fora_tpu_torch.graph import generators as tgen
    from fora_tpu_torch.graph import to_device
    g = (_weighted_rmat(10, 8192, seed=7) if "alias" in branch
         else tgen.rmat(10, 8192, seed=7))
    assert (np.asarray(g.out_deg) == 0).any()
    dg = to_device(g, merge_duplicate_edges=True, device=dev)
    hub = (hubppr.build_hub_index(dg, 3, alpha=0.2, num_hubs=8,
                                  pool_size=4096)
           if "hub" in branch else None)
    return g, dg, hub


def _kernel_walks(dg, start, seed, alpha, max_hops, hub, plan=None):
    """The branch's public wrapper, or with ``plan`` (a forced walks per
    lane, as chip_smoke.py's sweep runs it) the launch under it."""
    from fora_tpu_torch import kernels
    if plan is not None:
        return kernels._index_walk(
            start, dg.out_indptr, dg.out_indices, dg.alias_prob,
            dg.alias_other, seed, alpha, max_hops, "index_walk",
            hub_id=None if hub is None else hub.hub_id,
            pool=None if hub is None else hub.pool, plan=plan)
    if hub is not None:
        return kernels.index_walk_hub(start, dg.out_indptr, dg.out_indices,
                                      dg.alias_prob, dg.alias_other,
                                      hub.hub_id, hub.pool, seed, alpha,
                                      max_hops)
    if dg.alias_prob is not None:
        return kernels.index_walk_alias(start, dg.out_indptr, dg.out_indices,
                                        dg.alias_prob, dg.alias_other, seed,
                                        alpha, max_hops)
    return kernels.index_walk(start, dg.out_indptr, dg.out_indices, seed,
                              alpha, max_hops)


BRANCHES = ["uniform", "alias", "hub", "hub_alias"]


@pytest.mark.parametrize("branch", BRANCHES)
@pytest.mark.parametrize("W,k", [(1, None), (31, None), (33, None),
                                 (32 * 16, 16), (32 * 16 + 1, 16),
                                 (32 * 4 + 1, 4), (1 << 20, None)])
def test_walk_kernel_bit_equal_to_philox_plain(dev, branch, W, k):
    """K4 (each branch) bit-equal to run_walks_philox at sizes around a
    lane, a warp's range (32 k walks, the plan's k or a forced one) and a
    large launch, from random starts over dangling and hub nodes."""
    from fora_tpu_torch.kernels import schedule
    from fora_tpu_torch.ops.walk import run_walks_philox
    g, dg, hub = _philox_graph(dev, branch)
    rng = np.random.default_rng(W)
    start = torch.as_tensor(rng.integers(0, g.n, W).astype(np.int32),
                            device=dev)
    seed = (0x9E3779B97F4A7C15 * (W + 1)) % 2**64     # both seed words set
    want = run_walks_philox(dg, start, seed, 0.2, 64, hub=hub)
    plan = None if k is None else schedule.walk_grid(W, k)
    got = _kernel_walks(dg, start, seed, 0.2, 64, hub, plan=plan)
    torch.cuda.synchronize()
    diff = int((got != want).sum())
    assert diff == 0, f"{diff} of {W} walks differ"


@pytest.mark.parametrize("branch", BRANCHES)
@pytest.mark.parametrize("max_hops", [0, 1, 3])
def test_walk_kernel_short_caps_bit_equal(dev, branch, max_hops):
    """max_hops 0 (every walk ends at its start) and 1 (at most one hop,
    then a hub branch's one lookup) bit-equal to the plain walk."""
    from fora_tpu_torch.ops.walk import run_walks_philox
    g, dg, hub = _philox_graph(dev, branch)
    start = torch.arange(g.n, dtype=torch.int32, device=dev).repeat(64)
    got = _kernel_walks(dg, start, 5, 0.2, max_hops, hub)
    want = run_walks_philox(dg, start, 5, 0.2, max_hops, hub=hub)
    assert torch.equal(got, want)
    if max_hops == 0:
        assert torch.equal(got, start)


def test_walk_kernel_dangling_bit_equal(dev):
    """A star whose leaves are dangling: walks from a leaf never move,
    walks from the centre end at a leaf or the centre, bit-equal to the
    plain walk."""
    from fora_tpu_torch.graph import to_device
    from fora_tpu_torch.ops.walk import run_walks_philox
    dg = to_device(generators.star_graph(5), device=dev)
    start = torch.tensor([0, 3] * 5000, dtype=torch.int32, device=dev)
    got = _kernel_walks(dg, start, 8, 0.2, 64, None)
    assert torch.equal(got, run_walks_philox(dg, start, 8, 0.2, 64))
    assert bool((got[1::2] == 3).all())


def test_walk_kernel_hub_on_last_hop_and_hub_start(dev):
    """K4-hub on a 8-cycle with a poisoned pool at node 1: walks capped at
    one hop from node 0 reach the hub on their last hop and end at the
    poison node (the final lookup); walks that start on the hub never
    substitute there (each ends as many nodes on as its length); all
    bit-equal to the plain walk."""
    from fora_tpu_torch.algo.hubppr import HubIndex
    from fora_tpu_torch.graph import to_device
    from fora_tpu_torch.ops.walk import run_walks_philox, walk_lengths
    dg = to_device(generators.cycle_graph(8), device=dev)
    hub_id = torch.full((8,), -1, dtype=torch.int32, device=dev)
    hub_id[1] = 0
    hub = HubIndex(torch.tensor([1], dtype=torch.int32, device=dev), hub_id,
                   torch.full((1, 16), 5, dtype=torch.int32, device=dev))
    W = 1 << 16
    from_0 = torch.zeros(W, dtype=torch.int32, device=dev)
    last = _kernel_walks(dg, from_0, 2, 0.2, 1, hub)
    assert torch.equal(last, run_walks_philox(dg, from_0, 2, 0.2, 1, hub=hub))
    assert set(last.unique().tolist()) == {0, 5}
    from_hub = torch.ones(W, dtype=torch.int32, device=dev)
    ends = _kernel_walks(dg, from_hub, 3, 0.2, 7, hub)    # never back at 1
    assert torch.equal(ends,
                       run_walks_philox(dg, from_hub, 3, 0.2, 7, hub=hub))
    lens = walk_lengths(3, W, 0.2, 7, dev)
    assert torch.equal(ends.long(), (1 + lens) % 8)


@pytest.mark.parametrize("branch", ["uniform", "alias"])
@pytest.mark.parametrize("G", [2, 4, 8])
@pytest.mark.parametrize("W", [1, 33, 32 * 16 + 1, 1 << 20])
def test_walk_kernel_sharded_bit_equal_to_philox_plain(dev, branch, G, W):
    """K4's sharded form (the out-CSR as a table of G shard slices, the
    alias tables sliced beside it) bit-equal to run_walks_philox on the
    unsharded graph, from starts on every shard (dangling nodes
    included), and its plain form (run_walks_philox over the slices) too;
    one launch, counted apart from the unsharded branches."""
    from fora_tpu_torch import kernels
    from fora_tpu_torch.index.build_sharded import shard_out_csr
    from fora_tpu_torch.ops.walk import run_walks_philox, walk_endpoints
    g, dg, _ = _philox_graph(dev, branch)
    csr = shard_out_csr(g, [dev] * G)
    rng = np.random.default_rng(W + G)
    start = rng.integers(0, g.n, W).astype(np.int32)
    start[:min(W, G)] = np.arange(min(W, G)) * csr.n_loc % g.n
    start = torch.as_tensor(start, device=dev)
    seed = (0x9E3779B97F4A7C15 * (W + G)) % 2**64
    want = run_walks_philox(dg, start, seed, 0.2, 64)
    name = ("index_walk_sharded_alias" if branch == "alias"
            else "index_walk_sharded")
    before = kernels.launch_counts()
    got = walk_endpoints(csr, start, seed, 0.2, 64)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after[name] == before[name] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    diff = int((got != want).sum())
    assert diff == 0, f"{diff} of {W} walks differ"
    assert torch.equal(run_walks_philox(csr, start, seed, 0.2, 64), want)


def test_sharded_raw_engine_on_card(dev):
    """ShardedForaEngine without an index, four shards on the card under
    dense and routed: each launches K4's sharded form, K1, K3's selection
    and P2's one pass once, never K2; both exchanges give the same top-k
    (the walks are the same, the push bit-equal across exchanges: values
    within rtol 1e-4, as the endpoints' scatter-add adds in no fixed
    order on the card, and ids equal at 95% of the positions or more); the
    walk phase's contribution after P2 equals walk_phase's on the one
    device at the same seed within float32 summation order."""
    from fora_tpu_torch import ForaConfig as TorchForaConfig
    from fora_tpu_torch import kernels
    from fora_tpu_torch.graph import generators as tgen
    from fora_tpu_torch.graph import to_device
    from fora_tpu_torch.ops.walk import walk_phase
    from fora_tpu_torch.parallel import ShardedForaEngine, make_mesh
    g = tgen.rmat(12, 1 << 15, seed=3)
    rcfg = TorchForaConfig(epsilon=0.5, k=20).resolved(g.n, g.m)
    src = np.arange(0, 32 * 61, 61)
    res = {}
    for mode in ("dense", "routed"):
        eng = ShardedForaEngine(g, make_mesh(4, devices=[dev] * 4), rcfg,
                                k=20, exchange=mode)
        kernels.reset_launch_counts()
        res[mode] = eng.topk(src, 11)
        c = kernels.launch_counts()
        assert c["index_walk_sharded"] > 0 and c["index_spmv"] == 0
        assert c["reduce_scatter_onepass"] == 1
        assert c["topk_bounds"] == 4
        assert c["index_walk"] == c["index_walk_sharded_alias"] == 0
        assert min(c["walk_demand"], c["expand_lanes"],
                   c["accumulate_endpoints"]) > 0
    np.testing.assert_allclose(res["routed"].values, res["dense"].values,
                               rtol=1e-4, atol=1e-9)
    assert (res["routed"].node_ids == res["dense"].node_ids).mean() >= 0.95
    ps, rs = eng.init_state(src)
    eng.push(ps, rs)
    got = torch.cat(eng.walk_loc(rs, 5))[:g.n]
    want, _ = walk_phase(to_device(g, device=dev), torch.cat(rs)[:g.n],
                         rcfg.omega_unit, 5, rcfg.alpha, rcfg.max_walk_hops)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)


def test_walk_kernel_refuses_bad_plan(dev):
    """A plan whose warps do not cover W, or whose walks per lane would
    stage more than 48 KiB a block, is refused by the C entry (no launch
    runs)."""
    from fora_tpu_torch.graph import to_device
    from fora_tpu_torch.kernels import schedule
    dg = to_device(generators.cycle_graph(8), device=dev)
    start = torch.zeros(100000, dtype=torch.int32, device=dev)
    short = schedule.walk_grid(100000, 4)._replace(blocks=1)
    with pytest.raises(RuntimeError, match="index_walk"):
        _kernel_walks(dg, start, 1, 0.2, 64, None, plan=short)
    wide = schedule.WalkPlan(walks_per_lane=schedule.WALKS_PER_LANE_MAX + 1,
                             warps=1, blocks=1)
    with pytest.raises(RuntimeError, match="index_walk"):
        _kernel_walks(dg, start[:1000], 1, 0.2, 64, None, plan=wide)


def test_philox_probe_counts_and_refuses(dev):
    from fora_tpu_torch import kernels
    out = torch.empty(1024, dtype=torch.int32, device=dev)
    before = kernels.philox_blocks.launches
    assert kernels.philox_blocks(out, per_thread=8) == 1024 * 8
    torch.cuda.synchronize()
    assert kernels.philox_blocks.launches == before + 1
    with pytest.raises(RuntimeError, match="philox_blocks"):
        kernels.philox_blocks(out, per_thread=6)


def _frontier_graph():
    """The port's from_edges: node 0 with 5,000 out-edges (five K5 tasks),
    parallel edges, self-loops and dangling nodes."""
    from fora_tpu_torch.graph import from_edges
    rng = np.random.default_rng(17)
    n = 4000
    src = np.concatenate([np.zeros(5000, np.int64),
                          rng.integers(0, n - 100, 40_000)])
    dst = rng.integers(0, n, src.size)
    src = np.concatenate([src, src[::7], np.arange(50)])
    dst = np.concatenate([dst, dst[::7], np.arange(50)])
    return from_edges(src, dst, n)


@pytest.mark.parametrize("B", [1, 3, 8, 32, 128, 130])
def test_frontier_push_kernels_match_plain(dev, B):
    """K5's pre-pass against its plain version (p and contrib bit-equal to
    K1's pre-pass, the masked r equal, status equal, the tasks with their
    masks of non-zero chunks equal as a set), then K5 against the plain sum
    in float64 (rtol 1e-5, atol 1e-9: the atomics' order varies), on
    float4 rows (8, 32, 128: a lane a chunk), scalar rows (1, 3: a lane a
    column) and a wide row (130: a warp a row, a mask bit for 5 columns);
    the hub pushes one chunk, a row every chunk, the rest a few."""
    from fora_tpu_torch import kernels
    from fora_tpu_torch.graph import to_device
    from fora_tpu_torch.ops import push
    g = _frontier_graph()
    dg = to_device(g, device=dev)
    rng = np.random.default_rng(B)
    r0 = rng.random((g.n, B), np.float32) * (rng.random((g.n, B)) < 0.05)
    r0[0] = 0.0
    r0[0, B // 2] = 10.0                 # the hub pushes (thr 5.7)
    r0[1] = 1.0                          # every chunk of a row pushes
    r0[g.n - 1] = 0.7                    # and a dangling row absorbs
    r0 = torch.as_tensor(r0.astype(np.float32), device=dev)
    thr = push.node_threshold(dg, 1e-3)
    wsum = push.out_weight(dg)
    tasks = torch.empty((push.task_rows(g.n, g.m), push.TASK_FIELDS),
                        dtype=torch.int32, device=dev)
    status = torch.zeros(3, dtype=torch.int32, device=dev)
    p, r, c = torch.zeros_like(r0), r0.clone(), torch.empty_like(r0)
    before = kernels.frontier_prepass.launches
    kernels.frontier_prepass(p, r, c, thr, dg.out_deg, dg.out_indptr, wsum,
                             0.2, tasks, status, push.TASK_EDGES, g.m)
    assert kernels.frontier_prepass.launches == before + 1
    pp, pr, pc = torch.zeros_like(r0), r0.clone(), torch.empty_like(r0)
    ptasks, pstatus = torch.empty_like(tasks), torch.zeros_like(status)
    push.frontier_prepass_plain(pp, pr, pc, thr, dg.out_deg, dg.out_indptr,
                                wsum, 0.2, ptasks, pstatus)
    kp, kc = torch.zeros_like(r0), torch.empty_like(r0)
    kernels.push_prepass(kp, r0, kc, thr, dg.out_deg, wsum, 0.2)
    assert torch.equal(p, pp) and torch.equal(p, kp)
    assert torch.equal(c, pc) and torch.equal(c, kc)
    assert torch.equal(r, pr)
    assert status.tolist() == pstatus.tolist()
    nt = int(status[2])
    assert nt > 5 and int(status[1]) > 5000
    assert torch.equal(torch.unique(tasks[:nt], dim=0),
                       torch.unique(ptasks[:nt], dim=0))
    full = ptasks[:nt][ptasks[:nt, 0] == 1, 2]
    assert full.tolist() == push.chunk_masks(torch.ones(1, B)).tolist()
    # K5 against the float64 plain sum, r masked by the pre-pass
    row_active = torch.zeros(g.n, dtype=torch.bool, device=dev)
    row_active[tasks[:nt, 0].long()] = True
    want = push.active_edge_segment_sum_plain(
        r.double(), c.double(), dg.in_src, dg.in_dst, row_active)
    got = r.clone()
    before = kernels.frontier_push.launches
    kernels.frontier_push(got, c, tasks, nt, dg.out_indices)
    torch.cuda.synchronize()
    assert kernels.frontier_push.launches == before + 1
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-9)


def test_frontier_compacted_push_on_card(dev):
    """Whole pushes on the card at caps that always compact, sometimes fall
    back (the supersteps' active out-edges run 5746, 313, 1384, 2134, 198,
    48, 0 on the CPU) and fall back on every superstep with edges, against
    the CPU's plain push: p and r within rtol 1e-5 and one threshold's mass
    (an entry at its threshold may flip under another order of adds),
    supersteps within one, and the same branches where the supersteps
    agree."""
    from fora_tpu_torch import kernels
    from fora_tpu_torch.graph import to_device
    from fora_tpu_torch.ops import push
    g = _frontier_graph()
    srcs = torch.tensor([0, 5, 3999, 77], dtype=torch.int32)
    cpu = to_device(g, device="cpu")
    card = to_device(g, device=dev)
    for cap in (g.m - 1, 1000, 8):
        push.superstep_counts.reset()
        want = push.forward_push_from(cpu, push.init_state(g.n, srcs),
                                      rmax=1e-4, alpha=0.2,
                                      compact_edges=cap)
        plain = (push.superstep_counts.compacted, push.superstep_counts.dense)
        push.superstep_counts.reset()
        k5 = kernels.frontier_push.launches
        got = push.forward_push_from(card, push.init_state(g.n, srcs.to(dev)),
                                     rmax=1e-4, alpha=0.2,
                                     compact_edges=cap)
        comp, dense = (push.superstep_counts.compacted,
                       push.superstep_counts.dense)
        assert abs(got.iters - want.iters) <= 1 and comp + dense == got.iters
        assert (comp > 0, dense > 0) == {g.m - 1: (True, False),
                                         1000: (True, True),
                                         8: (True, True)}[cap]
        assert got.iters != want.iters or (comp, dense) == plain
        assert kernels.frontier_push.launches - k5 <= comp
        slack = push.node_threshold(cpu, 1e-4).clamp_min(1e-6)[:, None]
        torch.testing.assert_close(got.p.cpu(), want.p, rtol=1e-5,
                                   atol=float(slack.max()))
        assert ((got.p.cpu() - want.p).abs()
                <= 1e-5 * want.p.abs() + slack).all()
        assert ((got.r.cpu() - want.r).abs()
                <= 1e-5 * want.r.abs() + slack).all()


def _k6_residue(rng, n, B, omega):
    """r [n, B] f32: 30% of the entries positive, some exactly on an
    integer over omega (ceil's edge), some negative; column 0 empty."""
    r = rng.random((n, B), dtype=np.float32) * (rng.random((n, B)) < 0.3)
    edge = rng.random((n, B)) < 0.02
    r[edge] = (rng.integers(1, 50, int(edge.sum())) / np.float32(omega)
               ).astype(np.float32)
    r[rng.random((n, B)) < 0.01] = -0.5
    r[:, 0] = 0.0
    return r


@pytest.mark.parametrize("n,B,cols", [(1000, 1, (0, 1)), (70001, 64, (0, 37)),
                                      (513, 130, (0, 130)),
                                      (300, 40, (5, 38)), (256, 8, (0, 8))])
def test_walk_demand_kernel_equal_plain(dev, n, B, cols):
    """K6-demand's cum and total torch.equal to the plain version's on the
    card, at n not a multiple of the 256-node tile, B = 1, over 32
    columns (two and five column groups) and on a strided slice of the
    live columns; omega_v is not written."""
    from fora_tpu_torch import kernels
    from fora_tpu_torch.ops import walk
    omega = 37.3
    r = torch.as_tensor(_k6_residue(np.random.default_rng(n), n, B, omega),
                        device=dev)[:, cols[0]:cols[1]]
    k = kernels.walk_demand.launches
    got = walk.walk_demand(r, omega)
    assert kernels.walk_demand.launches == k + 1 and got.omega_v is None
    want = walk.walk_demand_plain(r, omega)
    assert torch.equal(got.cum, want.cum) and torch.equal(got.total,
                                                          want.total)
    assert got.cum.T.is_contiguous()


@pytest.mark.parametrize("lo,W", [(0, None), (0, 64), (3000, 4096),
                                  (1, 100_000)])
@pytest.mark.parametrize("B,cols", [(1, (0, 1)), (16, (0, 16)),
                                    (70, (3, 70))])
def test_expand_lanes_kernel_equal_plain(dev, lo, W, B, cols):
    """K6-expand's start and weight torch.equal to the plain expansion's
    on the card: every lane, a range cut short, a range starting past 0,
    lanes past every column's total; B = 1, 16 and a strided column slice
    over three column groups with an empty column."""
    from fora_tpu_torch import kernels
    from fora_tpu_torch.ops import walk
    omega = 211.0
    r = torch.as_tensor(_k6_residue(np.random.default_rng(B), 5000, B,
                                    omega), device=dev)[:, cols[0]:cols[1]]
    d = walk.walk_demand(r, omega)
    dp = walk.walk_demand_plain(r, omega)
    W = int(dp.total.max()) if W is None else W
    k = kernels.expand_lanes.launches
    start, weight = walk.expand_lanes(r, d, lo, W)
    assert kernels.expand_lanes.launches == k + 1
    want_s, want_w, _, _ = walk.expand_lanes_plain(r, dp, lo, W)
    assert torch.equal(start, want_s) and torch.equal(weight, want_w)


def test_expand_lanes_kernel_hub_column(dev):
    """A hub node owning over 2^24 lanes of one column, the column's lanes
    expanded in three ranges (the last past its total): each torch.equal
    to the plain expansion of the same range."""
    from fora_tpu_torch.ops import walk
    omega = float(1 << 25)
    r = torch.zeros(5000, 2, device=dev)
    r[1234, 0] = 0.6                  # 20,132,660 lanes
    r[17, 0] = 1e-6
    r[4000, 0] = 0.01
    r[::7, 1] = 1e-4
    d = walk.walk_demand(r, omega)
    dp = walk.walk_demand_plain(r, omega)
    assert torch.equal(d.cum, dp.cum)
    total = int(dp.total[0])
    assert total > 1 << 24
    for lo, hi in ((0, 1 << 23), (1 << 23, 1 << 24),
                   (1 << 24, total + 1000)):
        s, w = walk.expand_lanes(r, d, lo, hi - lo)
        ps, pw, _, _ = walk.expand_lanes_plain(r, dp, lo, hi - lo)
        assert torch.equal(s, ps) and torch.equal(w, pw), (lo, hi)


@pytest.mark.parametrize("G", [2, 4])
def test_expand_chunk_lanes_kernel_equal_plain(dev, G):
    """K6-expand's sharded form: a chunk's lanes over G shards' demands,
    lane l of column b shard h's where bounds[h, b] <= l < bounds[h + 1,
    b], node + h * n_loc, and node 0 / weight 0 past the columns' walks,
    torch.equal to the plain sharded expansion, for a whole chunk and for
    one that cuts the shards' lanes and a run of columns; on the lanes
    below the totals equal to the expansion of the concatenated
    residues."""
    from fora_tpu_torch import kernels
    from fora_tpu_torch.ops import walk
    rng = np.random.default_rng(G)
    n_loc, B, omega = 3000, 6, 97.0
    rs = [torch.as_tensor(_k6_residue(rng, n_loc, B, omega), device=dev)
          for _ in range(G)]
    ds = [walk.walk_demand(r, omega) for r in rs]
    dps = [walk.walk_demand_plain(r, omega) for r in rs]
    tot = torch.stack([d.total.long() for d in dps])
    bounds = torch.cat([torch.zeros_like(tot[:1]), tot.cumsum(0)])
    total = bounds[-1].cpu().numpy()
    r_cat = torch.cat(rs)
    d_cat = walk.walk_demand_plain(r_cat, omega)
    for c0, c1, lo, hi in ((0, B, 0, int(total.max())),
                           (2, 5, int(total[2:5].min()) // 3,
                            int(total[2:5].max()) + 10)):
        part = bounds[:, c0:c1].contiguous()
        k = kernels.expand_lanes.launches
        got = walk.expand_chunk_lanes([r[:, c0:c1] for r in rs],
                                      [d.columns(c0, c1) for d in ds], part,
                                      lo, hi - lo, n_loc)
        assert kernels.expand_lanes.launches == k + 1
        want = walk.expand_chunk_lanes_plain(
            [r[:, c0:c1] for r in rs], [d.columns(c0, c1) for d in dps],
            part, lo, hi - lo, n_loc)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        cat_s, cat_w, _, _ = walk.expand_lanes_plain(
            r_cat[:, c0:c1], d_cat.columns(c0, c1), lo, hi - lo)
        valid = lo + torch.arange(hi - lo, device=dev)[:, None] < \
            bounds[-1, c0:c1]
        assert torch.equal(got[0][valid], cat_s[valid])
        assert torch.equal(got[1][valid], cat_w[valid])


@pytest.mark.parametrize("weight_kind", ["array", "number", "shards"])
@pytest.mark.parametrize("B", [1, 5, 64])
def test_accumulate_endpoints_kernel_float64(dev, weight_kind, B):
    """K6-accum into a strided view (columns 3 .. 3 + B of a wider array)
    against a float64 scatter-add of the same lanes: rtol 1e-4, atol 1e-6
    (f32 atomics in no fixed order, a hot endpoint taking a third of the
    lanes); padding lanes of weight 0 and the columns outside the view
    untouched; the sharded form (three partials, bounds from lane 100 on)
    puts each lane into its shard's partial and none past the last."""
    from fora_tpu_torch.ops import walk
    rng = np.random.default_rng(B)
    n, W = 4000, 40_000
    ends = rng.integers(0, n, (W, B)).astype(np.int32)
    ends[rng.random((W, B)) < 0.33] = 123
    w = rng.random((W, B), dtype=np.float32) * 1e-3
    w[rng.random((W, B)) < 0.1] = 0.0
    if weight_kind == "number":
        weight, w64 = 2.5e-4, np.full((W, B), np.float32(2.5e-4), np.float64)
    else:
        weight, w64 = torch.as_tensor(w, device=dev), w.astype(np.float64)
    G = 3 if weight_kind == "shards" else 1
    bigs = [torch.full((n, B + 7), 2.0, device=dev) for _ in range(G)]
    outs = [big[:, 3:3 + B] for big in bigs]
    ends_t = torch.as_tensor(ends, device=dev)
    if weight_kind == "shards":
        cuts = np.sort(rng.integers(0, W + 200, (G, B)), axis=0)
        bounds = np.concatenate([np.zeros((1, B), np.int64), cuts])
        walk.accumulate_chunk_endpoints(
            ends_t, weight, outs, torch.as_tensor(bounds, device=dev), 100)
        lane = 100 + np.arange(W)[:, None]
        masks = [(lane >= bounds[h]) & (lane < bounds[h + 1])
                 for h in range(G)]
    else:
        walk.accumulate_endpoints(ends_t, weight, n, out=outs[0])
        masks = [np.ones((W, B), bool)]
    for h in range(G):
        want = np.full((n, B), 2.0)
        for b in range(B):
            np.add.at(want[:, b], ends[:, b], np.where(masks[h], w64, 0)[:, b])
        torch.testing.assert_close(outs[h].double().cpu(),
                                   torch.as_tensor(want), rtol=1e-4,
                                   atol=1e-6)
        assert (bigs[h][:, :3] == 2.0).all() and \
            (bigs[h][:, 3 + B:] == 2.0).all()


def test_walk_phase_on_card_runs_k6(dev):
    """walk_phase on the card launches K6-demand once, K6-expand and
    K6-accum once per chunk and no plain expansion: its columns' mass
    equals their residue's, its demand the plain version's."""
    from fora_tpu_torch import ForaConfig as TorchForaConfig
    from fora_tpu_torch import kernels
    from fora_tpu_torch.graph import generators as tgen
    from fora_tpu_torch.graph import to_device
    from fora_tpu_torch.ops import push, walk
    g = tgen.rmat(12, 1 << 15, seed=3)
    rcfg = TorchForaConfig(epsilon=0.5).resolved(g.n, g.m)
    dg = to_device(g, device=dev)
    src = torch.arange(0, 16 * 61, 61, dtype=torch.int32, device=dev)
    st = push.forward_push(dg, src, rmax=rcfg.rmax, alpha=rcfg.alpha)
    kernels.reset_launch_counts()
    contrib, info = walk.walk_phase(dg, st.r, rcfg.omega_unit, 3,
                                    rcfg.alpha, rcfg.max_walk_hops, live=12)
    c = kernels.launch_counts()
    assert c["walk_demand"] == 1
    assert c["expand_lanes"] == c["accumulate_endpoints"] == info.chunks
    want = walk.walk_demand_plain(st.r[:, :12], rcfg.omega_unit).total
    assert torch.equal(info.total[:12], want)
    torch.testing.assert_close(contrib.sum(0)[:12], st.r.sum(0)[:12],
                               rtol=1e-4, atol=0)
    assert float(contrib[:, 12:].abs().sum()) == 0.0
