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
from pack_cases import NAMES as PACK_NAMES
from pack_cases import case as pack_case
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
    """One raw-walk level on the card (K1 push, the demand, K6+K4: the
    lanes' starts, walks and scatter-add in one launch, K4 not launched
    alone) against the CPU's plain path: p, r and supersteps within float
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
        assert (counts["raw_walk"] > 0) == on_card
        assert counts["index_walk"] == 0
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
    dense and routed: each launches K6+K4's sharded form (the demand of
    every shard in one launch, no K6-expand, K6-accum or K4 launch of its
    own), K1, K3's
    selection and P2's one pass once, never K2; both exchanges give the
    same top-k
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
        assert c["index_spmv"] == 0
        assert c["reduce_scatter_onepass"] == 1
        assert c["topk_bounds"] == 4
        assert c["index_walk"] == c["index_walk_sharded_alias"] == 0
        assert c["index_walk_sharded"] == 0
        assert c["walk_demand"] == 1 and c["raw_walk"] > 0
        assert c["expand_lanes"] == c["accumulate_endpoints"] == 0
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


@pytest.mark.parametrize("n,B,cols,case", [
    (1000, 1, (0, 1), "one"), (70001, 64, (0, 37), "one"),
    (513, 130, (0, 130), "one"), (300, 40, (5, 38), "one"),
    (256, 8, (0, 8), "one"), (1 << 19, 64, (0, 15), "one"),
    (1 << 19, 64, (0, 64), "one"), (1 << 19, 64, (3, 4), "one"),
    (1 << 19, 3, (0, 3), "one"), (9000, 40, (2, 40), "twice"),
    (4000, 20, (0, 20), "empty"), (70001, 16, (1, 16), "list1"),
    (70001, 16, (1, 16), "list3"), (1 << 17, 24, (0, 16), "list4"),
    (1 << 17, 128, (0, 128), "list4"), (1 << 17, 16, (0, 16), "threads")])
def test_walk_demand_kernel_equal_plain(dev, n, B, cols, case):
    """K6-demand's cum and total torch.equal to the plain version's on the
    card, one launch a call: at n not a multiple of the tile, B = 1,
    over 32 columns (two and five column groups), on a strided slice of
    the live columns, and at n = 2^19 (long look-back chains; 15, 64, 3
    columns and one column of 64); ``twice``: two calls back to back on
    other residues and widths, each right (a status word or ticket left
    by the first would break the second); ``empty``: every column
    without a walk; ``list<G>``: the list form over G shards' column
    slices (and at the sharded raw one-shot's shape, four shards' 2^17 x
    128), one launch, each shard's cum and total equal to its own
    plain demand and its cum laid out as the single form's; ``threads``:
    four host threads calling it at once on one stream, many times, each
    call right (no scratch shared between calls)."""
    from fora_tpu_torch import kernels
    from fora_tpu_torch.ops import walk
    omega = 37.3
    rng = np.random.default_rng(n)

    def residue(n, B, cols):
        return torch.as_tensor(_k6_residue(rng, n, B, omega),
                               device=dev)[:, cols[0]:cols[1]]

    def check(got, r):
        want = walk.walk_demand_plain(r, omega)
        assert torch.equal(got.cum, want.cum) and torch.equal(got.total,
                                                              want.total)
        assert got.cum.T.is_contiguous() and got.omega_v is None

    if case.startswith("list"):
        G = int(case[4:])
        rs = [residue(n, B, cols) for _ in range(G)]
        k = kernels.walk_demand.launches
        ds, total = walk.walk_demands(rs, omega)
        assert kernels.walk_demand.launches == k + 1
        for r, d in zip(rs, ds):
            check(d, r)
        assert torch.equal(total, torch.stack([d.total for d in ds]))
        assert all(d.cum.stride() == ds[0].cum.stride() for d in ds)
        return
    if case == "threads":
        from concurrent.futures import ThreadPoolExecutor
        rs = [residue(n, B, cols) for _ in range(4)]
        wants = [walk.walk_demand_plain(x, omega) for x in rs]

        def calls(i):
            return [walk.walk_demand(rs[i], omega) for _ in range(20)]
        with ThreadPoolExecutor(4) as ex:
            gots = list(ex.map(calls, range(4)))
        torch.cuda.synchronize()
        for want, got in zip(wants, gots):
            assert all(torch.equal(d.cum, want.cum)
                       and torch.equal(d.total, want.total) for d in got)
        return
    r = residue(n, B, cols)
    if case == "empty":
        r = r.clamp(max=0.0)
    runs = [r] + ([residue(n // 3, 7, (0, 7))] if case == "twice" else [])
    for x in runs:
        k = kernels.walk_demand.launches
        got = walk.walk_demand(x, omega)
        assert kernels.walk_demand.launches == k + 1
        check(got, x)
    if case == "empty":
        assert not bool(got.total.any()) and not bool(got.cum.any())


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
    """walk_phase on the card launches K6-demand once and K6+K4 once per
    chunk, and neither K6-expand, K6-accum nor K4 alone: its columns'
    mass equals their residue's, its demand the plain version's."""
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
    assert c["raw_walk"] == info.chunks
    assert c["expand_lanes"] == c["accumulate_endpoints"] == 0
    assert c["index_walk"] == 0
    want = walk.walk_demand_plain(st.r[:, :12], rcfg.omega_unit).total
    assert torch.equal(info.total[:12], want)
    torch.testing.assert_close(contrib.sum(0)[:12], st.r.sum(0)[:12],
                               rtol=1e-4, atol=0)
    assert float(contrib[:, 12:].abs().sum()) == 0.0


# ---- K6+K4 (raw_walk_kernel) against the chain it replaced ----------------

def _f32_gate(got, ends, weight, n):
    """Each entry of ``got`` [n, Bc] (one f32 sum, or the shards'
    partials summed) against the float64 sum of the non-zero weights of
    the walked lanes (``ends`` >= 0) ending there: within gamma(N - 1) of
    it for N adds, the bound of any order of f32 adds (the kernel's REDs
    come in no fixed order, a warp's group of lanes summed before one)."""
    add = (ends >= 0) & (weight != 0)
    e = torch.where(add, ends, 0).long()
    want = torch.zeros(n, ends.shape[1], dtype=torch.float64,
                       device=ends.device)
    want.scatter_add_(0, e, torch.where(add, weight.double(), 0.0))
    cnt = torch.zeros_like(want).scatter_add_(0, e, add.double())
    k = (cnt - 1).clamp_min(0) * 2.0**-24
    bad = (got.double() - want).abs() > k / (1 - k) * want
    assert not bool(bad.any()), f"{int(bad.sum())} entries off the f32 bound"
    return cnt


def _raw_case(dev, branch, G):
    """A graph (weighted for the alias branches) and a residue [n, 6] with
    an empty column and a column of one node's long run (a hub source),
    as G shards of n_loc rows where ``branch`` is sharded."""
    from fora_tpu_torch.index.build_sharded import shard_out_csr
    g, dg, _ = _philox_graph(dev, "alias" if "alias" in branch else
                             "uniform")
    rng = np.random.default_rng(G)
    csr = shard_out_csr(g, [dev] * G) if "sharded" in branch else None
    rows = G * csr.n_loc if csr is not None else g.n
    r = np.zeros((rows, 6), np.float32)
    r[:g.n] = _k6_residue(rng, g.n, 6, 1000.0)
    r[:, 5] = 0.0
    r[123, 5] = 40.0                 # 40,000 lanes on one node
    return g, dg, csr, torch.as_tensor(r, device=dev)


RAW_BRANCHES = ["uniform", "alias", "sharded", "sharded_alias"]


@pytest.mark.parametrize("branch", RAW_BRANCHES)
@pytest.mark.parametrize("cut", ["whole", "mid", "tail"])
def test_raw_walk_kernel_bit_equal_chain(dev, branch, cut):
    """K6+K4 (one launch) against the chain K6-expand -> K4 -> K6-accum on
    the same chunk, for the uniform, alias and sharded (G = 4) branches:
    every lane below its column's demand ends where K4 ends it from
    K6-expand's start (walk t * Bc + b), the lanes past it are not walked
    (``ends`` keeps -1), and the contribution passes the f32 gate against
    the float64 sum of the chain's endpoints and weights, its count of
    adds per entry exact (the same chunk with r = omega_v, every weight
    1.0); a whole chunk, lanes from lo > 0 that cut the shards' lanes,
    and a chunk past every column's demand."""
    from fora_tpu_torch import kernels
    from fora_tpu_torch.ops import walk
    G = 4 if "sharded" in branch else 1
    g, dg, csr, r = _raw_case(dev, branch, G)
    omega = 1000.0
    seed = 0x5DEECE66D * 977
    rs = list(r.split(r.shape[0] // G)) if csr is not None else [r]
    ds = [walk.walk_demand(x, omega) for x in rs]
    tot = torch.stack([d.total.long() for d in ds])
    bounds = torch.cat([torch.zeros_like(tot[:1]), tot.cumsum(0)])
    t = int(bounds[-1].max())
    lo, hi = {"whole": (0, t), "mid": (t // 5, 3 * t // 5),
              "tail": (t // 2, t + 3000)}[cut]
    W, Bc = hi - lo, r.shape[1]
    n_out = r.shape[0]
    if csr is None:
        start, weight = walk.expand_lanes(r, ds[0], lo, W)
        chain = walk.walk_endpoints(dg, start.view(-1), seed, 0.2,
                                    64).view(W, Bc)
    else:
        start, weight = walk.expand_chunk_lanes(rs, ds, bounds, lo, W,
                                                csr.n_loc)
        chain = walk.walk_endpoints(csr, start.view(-1), seed, 0.2,
                                    64).view(W, Bc)

    def fused(res, ends=None):
        outs = [torch.zeros(n_out, Bc, device=dev) for _ in range(G)]
        before = kernels.launch_counts()
        if csr is None:
            walk.raw_walk_chunk(dg, res[0], ds[0], lo, W, seed, 0.2, 64,
                                outs[0], ends=ends)
        else:
            walk.raw_walk_sharded_chunk(csr, res, ds, bounds, lo, W, seed,
                                        0.2, 64, outs, ends=ends)
        after = kernels.launch_counts()
        assert after["raw_walk"] == before["raw_walk"] + 1
        assert sum(after.values()) == sum(before.values()) + 1
        return sum(outs)
    ends = torch.full((W, Bc), -1, dtype=torch.int32, device=dev)
    got = fused(rs, ends)
    torch.cuda.synchronize()
    valid = lo + torch.arange(W, device=dev)[:, None] < bounds[-1][None, :]
    assert torch.equal(ends[valid], chain[valid])
    assert bool((ends[~valid] == -1).all())
    assert bool(valid.any()) and not bool(valid[:, 0].any())
    cnt = _f32_gate(got, torch.where(valid, chain, -1), weight, n_out)
    omegas = [walk.walk_demand_plain(x, omega).omega_v.float() for x in rs]
    ones = fused(omegas)
    assert torch.equal(ones.double(), cnt)


def _xp_records(box, cnt, d):
    """Destination d's records of an outbox, sorted by walk key."""
    rec = box[d, :int(cnt[d])].cpu()
    return rec[torch.argsort(rec[:, 0].long() & 0xFFFFFFFF)]


def _xp_launch_pair(dev, args, q, P, log=None):
    """One K6+K4-xp launch (``args`` raw_walk_xp_chunk's arguments up to
    the inbox) against raw_walk_xp_plain on fresh outboxes and partials:
    one launch of the form its source takes, equal counts per destination,
    each destination's records equal as a set (the kernel's slots come in
    no fixed order), equal endpoints of the walks that end there, the
    partials within rtol 1e-4 (f32 atomics in no fixed order, up to 40,000
    adds an entry).  Returns the kernel's (outbox, counts, partial,
    endpoints)."""
    from fora_tpu_torch import kernels
    from fora_tpu_torch.ops import walk
    head, inbox, box, cnt = args[:-3], args[-3], args[-2], args[-1]
    W, Bc = head[5], head[12].shape[1]
    got = []
    for form in ("kernel", "plain"):
        if form == "kernel":
            x = (box.fill_(-7), cnt.fill_(-7))
        else:
            x = (torch.full_like(box, -7), torch.full_like(cnt, -7))
        part = torch.zeros_like(head[12])
        e = torch.full((W, Bc), -1, dtype=torch.int32, device=dev)
        call = head[:12] + (part, inbox, *x)
        before = kernels.launch_counts()
        if form == "kernel":
            walk.raw_walk_xp_chunk(*call, ends=e)
        else:
            walk.raw_walk_xp_plain(*call, ends=e)
        after = kernels.launch_counts()
        name = "raw_walk_xp" if head[6] > 0 else "raw_walk_xp_inbox"
        assert {k: after[k] - before[k] for k in after} == {
            k: int(form == "kernel" and k == name and box.shape[1] > 0)
            for k in after}
        got.append((*x, part, e))
    (box, cnt, part, e), (pbox, pcnt, ppart, pe) = got
    assert torch.equal(cnt, pcnt) and int(cnt[q]) == 0
    assert int(cnt.sum()) <= box.shape[1]
    for d in range(P):
        assert torch.equal(_xp_records(box, cnt, d),
                           _xp_records(pbox, pcnt, d))
    assert torch.equal(e, pe)
    torch.testing.assert_close(part, ppart, rtol=1e-4, atol=1e-7)
    if log is not None:     # (own lanes?, records in, out, blocks, inbox)
        from fora_tpu_torch.kernels import schedule, sm_count
        plan = schedule.xp_walk_plan(head[6], Bc, inbox.shape[0],
                                     sm_count(dev),
                                     head[0].alias_prob is not None)
        log.append((head[6] > 0, inbox.shape[0], int(cnt.sum()),
                    (plan.own if head[6] > 0 else plan.inbox).blocks, inbox))
    return box, cnt, part, e


def _xp_rounds(dev, csr, rs, ds, bounds, lo, W, seed, hops, L, log=None):
    """K6+K4-xp with G shards over G / L processes simulated on the card by
    xp_chunk_rounds and local_exchange, every launch held to
    raw_walk_xp_plain (_xp_launch_pair) and its kernel's records handed
    on; every lane's endpoint over the rounds is K6+K4's sharded form's
    (raw_walk_sharded_chunk) bit for bit, the partials' sum its mass within
    rtol 1e-4, and no walk is lost."""
    from fora_tpu_torch.ops import walk
    G, Bc, n_loc = len(rs), rs[0].shape[1], csr.n_loc
    P = G // L
    want = torch.full((W, Bc), -1, dtype=torch.int32, device=dev)
    want_out = [torch.zeros(G * n_loc, Bc, device=dev) for _ in range(G)]
    walk.raw_walk_sharded_chunk(csr, rs, ds, bounds, lo, W, seed, 0.2, hops,
                                want_out, ends=want)
    bnp = bounds.cpu().numpy()
    parts = [torch.zeros(G * n_loc, Bc, device=dev) for _ in range(P)]
    ends = [torch.full((W, Bc), -1, dtype=torch.int32, device=dev)
            for _ in range(P)]

    def launch(q, r, inbox, box, cnt):
        sl = slice(q * L, (q + 1) * L)
        ext = walk.own_lanes(bnp[q * L:q * L + L + 1], lo, W)[1]
        args = (csr.shards(q * L, (q + 1) * L), rs[sl], ds[sl],
                bounds[q * L:q * L + L + 1].contiguous(), lo, W,
                ext if r == 0 else 0, q * L, G, seed, 0.2, hops,
                parts[q], inbox, box, cnt)
        _, _, part, e = _xp_launch_pair(dev, args, q, P, log)
        parts[q] += part
        ends[q] = torch.maximum(ends[q], e)
    own = {q: walk.own_lanes(bnp[q * L:q * L + L + 1], lo, W)[0]
           for q in range(P)}
    rounds = len(walk.xp_chunk_rounds(launch, walk.local_exchange, own, P,
                                      dev))
    assert rounds <= hops + 1 and (rounds > 1) == (P > 1)
    assert int(sum((x >= 0).int() for x in ends).max()) <= 1
    assert torch.equal(torch.stack(ends).max(0).values, want)
    torch.testing.assert_close(sum(parts), sum(want_out), rtol=1e-4,
                               atol=1e-7)


@pytest.mark.parametrize("alias", [False, True])
@pytest.mark.parametrize("L", [1, 2, 4])
@pytest.mark.parametrize("cut", ["whole", "mid"])
def test_raw_walk_xp_kernel_matches_plain(dev, alias, L, cut):
    """K6+K4-xp's two forms with G = 4 shards over 4 / L processes
    simulated on the card by xp_chunk_rounds and local_exchange: per
    process and round, one launch (the own-lane form in round 0, the inbox
    form after it) against raw_walk_xp_plain on the same own lanes and
    inbox: equal counts per destination, each destination's records equal
    as a set (the kernel's slots come in no fixed order), equal endpoints
    of the walks that end there, and the partials within rtol 1e-4 (f32
    atomics in no fixed order, up to 40,000 adds an entry); the records of
    the kernel go on to the next round.  Across the rounds every lane's
    endpoint is K6+K4's sharded form's (raw_walk_sharded_chunk) bit for
    bit, and no walk is lost."""
    from fora_tpu_torch.ops import walk
    G = 4
    g, dg, csr, r = _raw_case(dev, "sharded_alias" if alias else "sharded",
                              G)
    omega, seed, hops = 1000.0, 0x5DEECE66D * 31, 64
    rs = list(r.split(r.shape[0] // G))
    ds, tot = walk.walk_demands(rs, omega)
    tot = tot.long()
    bounds = torch.cat([torch.zeros_like(tot[:1]), tot.cumsum(0)])
    t = int(bounds[-1].max())
    lo, hi = (0, t) if cut == "whole" else (t // 5, 3 * t // 5)
    _xp_rounds(dev, csr, rs, ds, bounds, lo, hi - lo, seed, hops, L)


def _cross_graph(n, G, L, alias):
    """A graph of n nodes over G shards of n / G rows whose every edge
    leads from a node of process p into process p + 1's rows (mod P = G /
    L): every hop that does not end a walk hands it over, all of a
    process's to one destination.  Eight out-edges a node, the last 64
    nodes dangling; weighted exp2(U(-2, 2)) for alias hops."""
    from fora_tpu_torch.graph import from_edges
    rng = np.random.default_rng(n + G + L)
    rows_p = n // (G // L)
    src = np.repeat(np.arange(n - 64), 8)
    dst = ((src // rows_p + 1) * rows_p) % n + rng.integers(0, rows_p,
                                                           src.size)
    w = np.exp2(rng.uniform(-2, 2, src.size)) if alias else None
    return from_edges(src, dst, n, w=w)


@pytest.mark.parametrize("alias,L,G", [(False, 2, 4), (False, 1, 4),
                                        (True, 1, 4), (False, 1, 8)])
def test_raw_walk_xp_stage_overflows(dev, alias, L, G):
    """K6+K4-xp's staged outbox filled and flushed many times over: on a
    graph whose every edge leads into the next process's rows (P = 2, 4
    and 8; at P = 8 a warp's bin holds 18 records, fewer than a group of
    lanes may hand over at once, which then goes out by itself), a chunk
    of about 8 M walks whose largest launch of each form hands over more
    records than the launch's warps' bins hold, so that bins fill, flush
    and start again, every launch held to raw_walk_xp_plain and every
    endpoint to K6+K4's sharded form (as
    test_raw_walk_xp_kernel_matches_plain); then an inbox of 5 records,
    below a warp, against the plain version alike."""
    from fora_tpu_torch.index.build_sharded import shard_out_csr
    from fora_tpu_torch.ops import walk
    n, Bc, seed = 1 << 16, 4, 0x5DEECE66D * 7
    P = G // L
    csr = shard_out_csr(_cross_graph(n, G, L, alias), [dev] * G)
    r = torch.full((G * csr.n_loc, Bc), 0.032, device=dev)  # 32 lanes a node
    rs = list(r.split(csr.n_loc))
    ds, tot = walk.walk_demands(rs, 1000.0)
    tot = tot.long()
    bounds = torch.cat([torch.zeros_like(tot[:1]), tot.cumsum(0)])
    W = int(bounds[-1].max())
    log = []
    _xp_rounds(dev, csr, rs, ds, bounds, 0, W, seed, 64, L, log)
    bin_cap = 128 // (P - 1)    # walk.cu's kWarpStage / (P - 1)
    for own in (True, False):
        _, _, sent, blocks, _ = max((x for x in log if x[0] == own),
                                    key=lambda x: x[2])
        assert sent > blocks * 8 * bin_cap, (own, sent, blocks, bin_cap)
    inbox = next(x[4] for x in log if not x[0] and x[1] >= 5)[:5]
    q = int(inbox[0, 1]) // (L * csr.n_loc)
    sl = slice(q * L, (q + 1) * L)
    args = (csr.shards(q * L, (q + 1) * L), rs[sl], ds[sl],
            bounds[q * L:q * L + L + 1].contiguous(), 0, W, 0, q * L, G,
            seed, 0.2, 64, torch.zeros(G * csr.n_loc, Bc, device=dev),
            inbox.contiguous(),
            torch.empty((P, 5, 4), dtype=torch.int32, device=dev),
            torch.empty(P, dtype=torch.int32, device=dev))
    _xp_launch_pair(dev, args, q, P)


# ---- K4-xp (index_xp_own_kernel, index_xp_inbox_kernel) against its plain
#      version


def _ixp_launch_pair(dev, csr, start, w0, wlo, cl, q, L, G, seed, hops,
                     inbox, box, cnt, n_ends):
    """One K4-xp launch (process q's, ``csr`` its L slices, a window of
    ``n_ends`` walks from ``wlo`` in chunks of ``cl``; ``cnt`` [P + 1]
    its zeroed counts) against index_walk_xp_plain on fresh outboxes,
    zeroed counts and endpoints:
    one launch of the form its source takes, counted on that form's
    wrapper only, equal counts per destination, each destination's
    records equal as a set (the kernel's slots come in no fixed order),
    equal endpoints (-1 at the own walks that left), the inbox form's
    claims past every warp's first covering the records.  Returns the kernel's (outbox, counts,
    endpoints)."""
    from fora_tpu_torch import kernels
    from fora_tpu_torch.kernels import schedule, sm_count
    from fora_tpu_torch.ops import walk
    P = G // L
    got = []
    assert not cnt.any()
    for form in ("kernel", "plain"):
        x = ((box.fill_(-7), cnt) if form == "kernel" else
             (torch.full_like(box, -7), torch.zeros_like(cnt)))
        e = torch.full((n_ends,), -1, dtype=torch.int32, device=dev)
        fn = (walk.index_walk_xp_chunk if form == "kernel"
              else walk.index_walk_xp_plain)
        before = kernels.launch_counts()
        fn(csr, start, w0, wlo, cl, q * L, G, seed, 0.2, hops, inbox, *x, e)
        after = kernels.launch_counts()
        name = "index_walk_xp" if start.shape[0] else "index_walk_xp_inbox"
        assert {k: after[k] - before[k] for k in after} == {
            k: int(form == "kernel" and k == name and box.shape[1] > 0)
            for k in after}
        got.append((*x, e))
    (box, cnt, e), (pbox, pcnt, pe) = got
    assert torch.equal(cnt[:P], pcnt[:P]) and int(cnt[q]) == 0
    assert int(cnt[:P].sum()) <= box.shape[1]
    if start.shape[0]:
        assert int(cnt[P]) == 0
    elif inbox.shape[0]:    # the claims past every warp's first covered it
        plan = schedule.index_xp_plan(0, inbox.shape[0], sm_count(dev)).inbox
        first = schedule.inbox_claim(0, inbox.shape[0], plan)
        assert plan.warps * first + int(cnt[P]) >= inbox.shape[0]
    for d in range(P):
        assert torch.equal(_xp_records(box, cnt, d),
                           _xp_records(pbox, pcnt, d))
    assert torch.equal(e, pe)
    return box, cnt, e


def _ixp_rounds(dev, g, csr, starts, lo, W, cl, seed, hops, L, log=None):
    """The window [lo, lo + W) of ``starts`` (sorted by node; whole chunks
    of ``cl`` walks, chunk c at seed + c 2^32) with G shards over G / L
    processes simulated on the card by xp_chunk_rounds and local_exchange,
    every launch held to index_walk_xp_plain (_ixp_launch_pair) and the
    kernel's records handed on: each walk ends in exactly one process,
    where K4's sharded form and run_walks_philox end it on its chunk.
    ``log`` gets per launch (own starts?, walks in, records out, blocks,
    the inbox)."""
    from fora_tpu_torch.graph import to_device
    from fora_tpu_torch.index.build_sharded import own_run
    from fora_tpu_torch.kernels import schedule, sm_count
    from fora_tpu_torch.ops import walk
    G = len(csr.indptr)
    P, rows = G // L, L * csr.n_loc
    cum = np.searchsorted(starts, np.arange(G * csr.n_loc + 1))
    window = torch.as_tensor(starts[lo:lo + W], device=dev)
    dg = to_device(g, merge_duplicate_edges=False, device=dev)
    want = []
    for c0 in range(lo, lo + W, cl):
        chunk = window[c0 - lo:min(c0 + cl, lo + W) - lo]
        want.append(walk.walk_endpoints(csr, chunk, seed + ((c0 // cl) << 32),
                                        0.2, hops))
        assert torch.equal(want[-1], walk.run_walks_philox(
            dg, chunk, seed + ((c0 // cl) << 32), 0.2, hops))
    want = torch.cat(want)
    runs = {q: own_run(cum, lo, W, q * rows, (q + 1) * rows)
            for q in range(P)}
    ends = [torch.full((W,), -1, dtype=torch.int32, device=dev)
            for _ in range(P)]

    def launch(q, r, inbox, box, cnt):
        a, b = runs[q] if r == 0 else (0, 0)
        own = window[a:b].contiguous()
        _, cnt, e = _ixp_launch_pair(dev, csr.shards(q * L, (q + 1) * L), own,
                                     lo + a, lo, cl, q, L, G, seed, hops,
                                     inbox, box, cnt, W)
        ends[q] = torch.maximum(ends[q], e)
        if log is not None:
            plan = schedule.index_xp_plan(b - a, inbox.shape[0],
                                          sm_count(dev))
            log.append((b > a, max(b - a, inbox.shape[0]),
                        int(cnt[:P].sum()),
                        (plan.own if b > a else plan.inbox).blocks, inbox))
    rounds = len(walk.xp_chunk_rounds(
        launch, walk.local_exchange, {q: b - a for q, (a, b) in runs.items()},
        P, dev, words=1))
    assert rounds <= hops + 1 and (rounds > 1) == (P > 1)
    assert torch.equal(sum((x >= 0).int() for x in ends),
                       torch.ones(W, dtype=torch.int32, device=dev))
    assert torch.equal(torch.stack(ends).max(0).values, want)
    return runs


@pytest.mark.parametrize("alias", [False, True])
@pytest.mark.parametrize("L", [1, 2, 4])
@pytest.mark.parametrize("cut", ["whole", "mid"])
def test_index_walk_xp_kernel_matches_plain(dev, alias, L, cut):
    """K4-xp's two forms with G = 4 shards over 4 / L processes simulated
    on the card, on the index build's starts of an RMAT 2^10 with dangling
    nodes (weighted for alias hops): per process and round, one launch
    (the own-start form in round 0, the inbox form after it) against
    index_walk_xp_plain on the same own starts and inbox: equal counts per
    destination, each destination's records equal as a set, equal
    endpoints; the kernel's records go on to the next round.  Across the
    rounds every walk's endpoint is K4's sharded form's on its chunk, bit
    for bit, and each walk ends in one process.  "whole" is one window of
    one chunk; "mid" a window of chunks 1 and 2 of chunks of a fifth of
    the walks, so each process's own run starts past walk 0, and (L < 4) a
    chunk boundary falls inside one."""
    from fora_tpu_torch import ForaConfig
    from fora_tpu_torch.index import index_counts
    from fora_tpu_torch.index.build_sharded import shard_out_csr
    g, _, _ = _philox_graph(dev, "alias" if alias else "uniform")
    rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
    starts = np.repeat(np.arange(g.n, dtype=np.int32),
                       index_counts(g.out_deg, rcfg))
    csr = shard_out_csr(g, [dev] * 4)
    t = len(starts)
    cl = t if cut == "whole" else t // 5
    lo, hi = (0, t) if cut == "whole" else (cl, 3 * cl)
    runs = _ixp_rounds(dev, g, csr, starts, lo, hi - lo, cl,
                       0x5DEECE66D * 29, rcfg.max_walk_hops, L)
    if cut == "mid" and L < 4:
        assert any(a < cl < b for a, b in runs.values())


@pytest.mark.parametrize("alias,L,G", [(False, 2, 4), (False, 1, 4),
                                        (True, 1, 4), (False, 1, 8)])
def test_index_walk_xp_stage_overflows(dev, alias, L, G):
    """K4-xp's warp stages filled: on a graph whose every edge leads into
    the next process's rows (_cross_graph), 32 walks from each node that
    has out-edges (about 2 M, two chunks in one window), each launch held
    to index_walk_xp_plain and every endpoint to K4's sharded form
    (_ixp_rounds).  Every hop crosses, so more than half of a launch's
    walks leave: a warp's stage fills and goes out, in the inbox form many
    times a launch, to one, three and seven destinations at P = 2, 4 and
    8; at P = 2 the inbox form's largest launch takes several claims a
    warp of its resident grid.  Then inboxes of 0, 1 and 5 records, below a
    warp, against the plain version alike."""
    from fora_tpu_torch.index.build_sharded import shard_out_csr
    n, seed = 1 << 16, 0x5DEECE66D * 11
    P = G // L
    g = _cross_graph(n, G, L, alias)
    csr = shard_out_csr(g, [dev] * G)
    starts = np.repeat(np.arange(n - 64, dtype=np.int32), 32)
    log, cl = [], len(starts) // 2 + 1
    _ixp_rounds(dev, g, csr, starts, 0, len(starts), cl, seed, 64, L, log)
    for own in (True, False):
        _, walks, sent, blocks, _ = max((x for x in log if x[0] == own),
                                        key=lambda x: x[2])
        assert sent > walks / 2, (own, sent, walks)
        if not own and P == 2:     # two claims a warp at the least
            assert walks > 2 * blocks * 8 * 32
    inbox = next(x[4] for x in log if not x[0] and x[1] >= 5)
    q = int(inbox[0, 1]) // (L * csr.n_loc)
    for k in (0, 1, 5):
        _ixp_launch_pair(dev, csr.shards(q * L, (q + 1) * L),
                         torch.empty(0, dtype=torch.int32, device=dev), 0, 0,
                         cl, q, L, G, seed, 64, inbox[:k].contiguous(),
                         torch.empty((P, k, 4), dtype=torch.int32,
                                     device=dev),
                         torch.zeros(P + 1, dtype=torch.int32, device=dev),
                         len(starts))


# ---- K6+K4-src (source_walk_kernel) against the chain it replaced ---------

SOURCE_BRANCHES = ["uniform", "alias", "hub", "hub_alias"]


@pytest.mark.parametrize("branch", SOURCE_BRANCHES)
@pytest.mark.parametrize("rows,B", [(1, 1), (31, 3), (4097, 5),
                                    (50_000, 7)])
def test_source_walk_kernel_bit_equal_chain(dev, branch, rows, B):
    """K6+K4-src (one launch) against the chain K4 (K4-alias, K4-hub) ->
    K6-accum on sources.repeat(rows) and against its plain version
    (source_walk_chunk_plain): every walk's endpoint (its ``ends``) equal
    to K4's and to run_walks_philox's, bit for bit; the sums into a
    column slice of a wider array pass the f32 gate against the float64
    sums of the same weight at K4's endpoints, each entry's count of adds
    exact (weight 1.0), the columns outside the slice untouched.  The
    sources repeat one node (its walks counted once a tile) and take a
    dangling node where the graph has one."""
    from fora_tpu_torch import kernels
    from fora_tpu_torch.algo import hubppr
    from fora_tpu_torch.ops import walk
    g, dg, hub = _philox_graph(dev, branch)
    rng = np.random.default_rng(rows + B)
    dangling = int(np.flatnonzero(np.asarray(g.out_deg) == 0)[0])
    src_np = rng.integers(0, g.n, B).astype(np.int32)
    src_np[-1] = dangling
    if B > 2:
        src_np[1] = src_np[0]
    src = torch.as_tensor(src_np, device=dev)
    seed = 0x5DEECE66D * (rows + 3)
    weight = float(np.float32(1.0 / rows))
    start = src.repeat(rows)
    if hub is None:
        chain = walk.walk_endpoints(dg, start, seed, 0.2, 64)
    else:
        chain = hubppr.hub_walks(dg, start, seed, hub, alpha=0.2,
                                 max_hops=64)
    chain = chain.view(rows, B)
    plain = walk.run_walks_philox(dg, start, seed, 0.2, 64, hub=hub)
    assert torch.equal(chain, plain.view(rows, B))

    def fused(w, ends=None):
        big = torch.full((g.n, B + 5), 2.0, device=dev)
        big[:, 2:2 + B] = 0.0
        before = kernels.launch_counts()
        walk.source_walk_chunk(dg, src, rows, seed, 0.2, 64, w,
                               big[:, 2:2 + B], hub=hub, ends=ends)
        after = kernels.launch_counts()
        assert after["source_walk"] == before["source_walk"] + 1
        assert sum(after.values()) == sum(before.values()) + 1
        assert bool((big[:, :2] == 2.0).all())
        assert bool((big[:, 2 + B:] == 2.0).all())
        return big[:, 2:2 + B]
    ends = torch.full((rows, B), -1, dtype=torch.int32, device=dev)
    got = fused(weight, ends)
    assert torch.equal(ends, chain)
    want = torch.zeros(g.n, B, dtype=torch.float64, device=dev)
    walk.source_walk_chunk_plain(dg, src, rows, seed, 0.2, 64, weight, want,
                                 hub=hub)
    cnt = _f32_gate(got, chain,
                    torch.full((rows, B), weight, device=dev), g.n)
    ones = fused(1.0)
    assert torch.equal(ones.double(), cnt)
    assert float((got.double() - want).abs().max()) <= \
        float(want.max()) * 1e-4


def test_source_walk_on_card_runs_one_launch_a_chunk(dev):
    """make_montecarlo_fn and make_hubppr_fn on the card launch K6+K4-src
    once a chunk (three chunks of 1000 walks a source, CHUNK_LANES set
    small) and no K4
    branch or K6-accum of their own; each column's estimate sums to 1."""
    from fora_tpu_torch import ForaConfig as TorchForaConfig
    from fora_tpu_torch import kernels
    from fora_tpu_torch.algo import hubppr, montecarlo
    from fora_tpu_torch.graph import generators as tgen
    from fora_tpu_torch.graph import to_device
    from fora_tpu_torch.ops import walk
    g = tgen.rmat(12, 1 << 15, seed=3)
    rcfg = TorchForaConfig(epsilon=0.5).resolved(g.n, g.m)
    dg = to_device(g, device=dev)
    old = walk.CHUNK_LANES
    walk.CHUNK_LANES = 4 * 1000
    try:
        for make in (lambda: montecarlo.make_montecarlo_fn(
                         dg, rcfg, max_walks=2500),
                     lambda: hubppr.make_hubppr_fn(dg, rcfg, 5, num_hubs=8,
                                                   max_walks=2500,
                                                   pool_size=2048)):
            fn = make()
            kernels.reset_launch_counts()
            est = fn(np.array([1, 2, 5, 9]), 9)
            c = kernels.launch_counts()
            assert c["source_walk"] == 3
            assert sum(c.values()) == 3
            torch.testing.assert_close(est.sum(0).cpu(), torch.ones(4),
                                       rtol=1e-5, atol=0)
    finally:
        walk.CHUNK_LANES = old


@pytest.mark.parametrize("name", PACK_NAMES + ("bench_size",))
def test_pack_kernels_match_plain(dev, name):
    """K7 (``kernels/csrc/pack.cu``) against its plain version on the
    cases of ``pack_cases.py``, bit for bit: K7-keys' keys (with and
    without the digit counts, whose totals equal the count launch's and
    each digit's bincount), K7-sort's order at each digit width (a pass
    whose digit is the same in every key skipped; with K7-keys' totals
    handed in the same), K7-merge's unique edges, multiplicities, bucket
    counts and row pointers; all three also against their earlier forms
    (``probes/pack_earlier.cu``); then the whole pack on the card against
    ``pack_index_plain`` on the CPU, its pointers against
    ``with_indptr``'s."""
    from fora_tpu_torch import ForaConfig, kernels
    from fora_tpu_torch.index import build as ib
    from fora_tpu_torch.probes.pack_earlier import (earlier_merge,
                                                    earlier_pack_keys,
                                                    earlier_sort)
    ends, counts, deg = pack_case(name)
    t = ib.pack_tables(counts, deg)
    n, bits = len(counts), 2 * t.nb + 4
    e = torch.from_numpy(ends).to(dev)
    offsets, cut, dang = ib._device_tables(t, dev)
    offsets1, _ = ib._card_tables(t, dev)
    keys = kernels.pack_keys(e, offsets1, dang, t.nb)
    want = ib.pack_keys_plain(e, offsets, cut, dang, t.nb)
    torch.cuda.synchronize()
    assert torch.equal(keys, want)
    assert torch.equal(earlier_pack_keys(e, offsets, cut, dang, t.nb), want)
    for digit_bits in kernels.SORT_DIGIT_WIDTHS:
        totals = kernels.digit_totals(bits, dev, digit_bits)
        assert torch.equal(kernels.pack_keys(e, offsets1, dang, t.nb,
                                             totals=totals), want)
        assert torch.equal(totals, kernels.digit_counts(want, bits,
                                                        digit_bits))
        R = 1 << digit_bits
        for p in range(totals.shape[0]):
            assert torch.equal(totals[p].long(), torch.bincount(
                (want >> (p * digit_bits)) & (R - 1), minlength=R)), p
        got = kernels.sort_keys(want.clone(), torch.empty_like(want), bits,
                                totals=totals)
        assert torch.equal(got, ib.sort_keys_plain(want)), digit_bits
    ordered = ib.sort_keys_plain(want)
    k = want.cpu().numpy()
    for digit_bits in kernels.SORT_DIGIT_WIDTHS:
        work, alt = keys.clone(), torch.empty_like(keys)
        got = kernels.sort_keys(work, alt, bits, digit_bits=digit_bits)
        torch.cuda.synchronize()
        assert torch.equal(got, ordered), digit_bits
        passes = -(-bits // digit_bits)
        varied = sum(len(np.unique((k >> (digit_bits * p))
                                   & ((1 << digit_bits) - 1))) > 1
                     for p in range(passes))
        assert kernels.sort_keys.last_passes == varied
        if digit_bits == 8:
            assert (varied < passes) >= (name == "constant_digit")
    old, _ = earlier_sort(keys.clone(), torch.empty_like(keys), bits)
    assert torch.equal(old, ordered)
    merged = kernels.merge_keys(ordered, t.nb, n)
    torch.cuda.synchronize()
    for a, b, what in zip(merged, ib.merge_keys_plain(ordered, t.nb, n),
                          ("src", "dst", "mult", "bucket_counts",
                           "indptr")):
        assert torch.equal(a, b), what
    if len(k):
        for a, b, what in zip(merged, earlier_merge(
                ordered, torch.empty_like(ordered), t.nb),
                ("src", "dst", "mult", "bucket_counts")):
            assert torch.equal(a, b), what
    rcfg = ForaConfig(epsilon=0.5).resolved(len(deg), max(int(deg.sum()), 1))
    before = kernels.launch_counts()
    idx = ib.pack_index(e, counts, deg, rcfg)
    after = kernels.launch_counts()
    assert all(after[k] == before[k] + 1
               for k in ("pack_keys", "sort_keys", "merge_keys"))
    ref = ib.pack_index_plain(torch.from_numpy(ends), counts, deg, rcfg)
    for f in ("edge_src", "edge_dst", "edge_mult", "bucket_offsets",
              "counts_cum"):
        np.testing.assert_array_equal(getattr(idx, f), getattr(ref, f), f)
    for got, w in zip(idx.dst_indptr,
                      ib.with_indptr(idx._replace(dst_indptr=None))
                      .dst_indptr):
        assert (got is None) == (w is None)
        if w is not None:
            np.testing.assert_array_equal(got, w)


@pytest.mark.parametrize("modulus", [4, 4096])
@pytest.mark.parametrize("off", [0, 1, 3])
def test_pack_keys_at_tile_edges(dev, modulus, off):
    """K7-keys with total = 0, 1, 3 mod 4 and mod its 4096-entry tile (a
    node across the tile edge, a few dangling nodes), from 16-byte aligned
    endpoints and from endpoints one int32 past that (loaded without the
    vector loads): bit-equal to the plain version and the earlier form,
    with the digit counts equal to the count launch's, and the sort with
    them handed in equal to the sort without."""
    from fora_tpu_torch import kernels
    from fora_tpu_torch.index import build as ib
    from fora_tpu_torch.probes.pack_earlier import earlier_pack_keys
    rng = np.random.default_rng(modulus * 10 + off)
    total = 5 * modulus + off if modulus == 4 else 3 * modulus + off
    n, k = 300, min(40, total)
    counts = np.zeros(n, np.int64)
    counts[rng.choice(n, k, replace=False)] = rng.multinomial(
        total - k, np.full(k, 1 / k)) + 1
    deg = np.where(counts > 0, rng.integers(1, 6, n), 0)
    t = ib.pack_tables(counts, deg)
    assert t.total == total
    ends = rng.integers(0, n, total + 1).astype(np.int32)
    bits = 2 * t.nb + 4
    offsets, cut, dang = ib._device_tables(t, dev)
    offsets1, _ = ib._card_tables(t, dev)
    base = torch.from_numpy(ends).to(dev)
    for e in (base[:total], base[1:]):
        want = ib.pack_keys_plain(e, offsets, cut, dang, t.nb)
        assert torch.equal(kernels.pack_keys(e, offsets1, dang, t.nb), want)
        assert torch.equal(earlier_pack_keys(e, offsets, cut, dang, t.nb),
                           want)
        totals = kernels.digit_totals(bits, dev)
        assert torch.equal(kernels.pack_keys(e, offsets1, dang, t.nb,
                                             totals=totals), want)
        assert torch.equal(totals, kernels.digit_counts(want, bits))
        assert torch.equal(
            kernels.sort_keys(want.clone(), torch.empty_like(want), bits,
                              totals=totals),
            kernels.sort_keys(want.clone(), torch.empty_like(want), bits))


@pytest.mark.parametrize("digit_bits", [8, 9, 11])
@pytest.mark.parametrize("tiles", [1, 37])
@pytest.mark.parametrize("off", [-1, 0, 1])
def test_pack_sort_stable_at_tile_edges(dev, digit_bits, tiles, off):
    """K7-sort is stable: keys that differ only in their low digits (the
    high digits from a few values, so one pass's order must keep the
    previous pass's), at lengths just below, at and above a multiple of
    the 4096-key tile, bit-equal to ``torch.sort`` and to the earlier
    form; 43-bit keys whose top digits are constant skip those passes."""
    from fora_tpu_torch import kernels
    from fora_tpu_torch.probes.pack_earlier import earlier_sort
    rng = np.random.default_rng(digit_bits * 1000 + tiles * 10 + off)
    L = tiles * kernels.PACK_TILE + off
    high = rng.choice(np.array([3, 5, 6], np.int64) << 36, L)
    keys = torch.from_numpy(high | rng.integers(0, 1 << 14, L)).to(dev)
    want = torch.sort(keys).values
    got = kernels.sort_keys(keys.clone(), torch.empty_like(keys), 43,
                            digit_bits=digit_bits)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert kernels.sort_keys.last_passes < -(-43 // digit_bits)
    old, _ = earlier_sort(keys.clone(), torch.empty_like(keys), 43)
    assert torch.equal(old, want)


@pytest.mark.parametrize("off", [-1, 0, 1])
def test_pack_merge_run_across_look_back(dev, off):
    """K7-merge on sorted keys with one run of 40 tiles (longer than a
    look-back window of 32 tiles) between runs of one to three keys, at
    lengths just below, at and above a tile multiple: unique edges,
    multiplicities, bucket counts and pointers bit-equal to the plain
    merge and to the earlier form."""
    from fora_tpu_torch import kernels
    from fora_tpu_torch.index import build as ib
    from fora_tpu_torch.probes.pack_earlier import earlier_merge
    nb, n = 12, 4000
    rng = np.random.default_rng(40 + off)
    tile = kernels.PACK_TILE
    small = (rng.integers(0, 8, 60_000) << (2 * nb)) | (
        rng.integers(0, n, 60_000) << nb) | rng.integers(0, n, 60_000)
    small = np.repeat(small, rng.integers(1, 4, 60_000))
    run = np.full(40 * tile + 7, (2 << (2 * nb)) | (9 << nb) | 11)
    keys = np.sort(np.concatenate([small, run]))
    keys = keys[:(len(keys) // tile) * tile + off]
    k = torch.from_numpy(keys).to(dev)
    got = kernels.merge_keys(k, nb, n)
    torch.cuda.synchronize()
    for a, b, what in zip(got, ib.merge_keys_plain(k, nb, n),
                          ("src", "dst", "mult", "bucket_counts",
                           "indptr")):
        assert torch.equal(a, b), what
    assert float(got[2].max()) >= 40 * tile
    for a, b, what in zip(got, earlier_merge(k, torch.empty_like(k), nb),
                          ("src", "dst", "mult", "bucket_counts")):
        assert torch.equal(a, b), what


@pytest.mark.parametrize("modulus", [4, 4096])
@pytest.mark.parametrize("off", [0, 1, 3])
def test_pack_key_counts_at_tile_edges(dev, modulus, off):
    """K7-keys' count form with total = 0, 1, 3 mod 4 and mod its 4096-entry
    tile, from 16-byte aligned endpoints and from endpoints one int32 past
    that: the whole key space by its top bits, and the heaviest of those
    bins by its next bits, equal to the plain version (a bincount of the
    plain keys in the range)."""
    from fora_tpu_torch import kernels
    from fora_tpu_torch.index import build as ib
    rng = np.random.default_rng(modulus * 100 + off)
    total = 5 * modulus + off if modulus == 4 else 3 * modulus + off
    n, k = 3000, min(40, total)
    counts = np.zeros(n, np.int64)
    counts[rng.choice(n, k, replace=False)] = rng.multinomial(
        total - k, np.full(k, 1 / k)) + 1
    deg = np.where(counts > 0, rng.integers(1, 6, n), 0)
    t = ib.pack_tables(counts, deg)
    ends = rng.integers(0, n, total + 1).astype(np.int32)
    bits = 2 * t.nb + 4
    offsets, cut, dang = ib._device_tables(t, dev)
    offsets1, _ = ib._card_tables(t, dev)
    base = torch.from_numpy(ends).to(dev)
    top = bits - 14
    for e in (base[:total], base[1:]):
        plain = ib.pack_keys_plain(e, offsets, cut, dang, t.nb)
        whole = kernels.pack_key_counts(e, offsets1, dang, t.nb, 0, 1 << bits,
                                        top)
        assert torch.equal(whole, ib.pack_key_counts_plain(
            plain, 0, 1 << bits, top))
        lo = int(whole.argmax()) << top
        sub = kernels.pack_key_counts(e, offsets1, dang, t.nb, lo,
                                      lo + (1 << top), 0)
        assert torch.equal(sub, ib.pack_key_counts_plain(
            plain, lo, lo + (1 << top), 0))
        assert int(sub.sum()) == int(whole.max())


@pytest.mark.parametrize("windows", [2, 3, 4, 5])
def test_pack_keys_window_matches_plain(dev, windows):
    """K7-keys' window form over ``windows`` windows of the key space on the
    many-tiles case (2.3 M keys): each window's keys, sorted, equal to the
    plain keys filtered to it and sorted; its digit counts equal to the
    count launch's over them; the windows' K7-sort and K7-merge equal the
    plain chain's."""
    from fora_tpu_torch import kernels
    from fora_tpu_torch.index import build as ib
    ends, counts, deg = pack_case("many_tiles")
    t = ib.pack_tables(counts, deg)
    bits = 2 * t.nb + 4
    e = torch.from_numpy(ends).to(dev)
    plain = ib.pack_keys_plain(e, *ib._device_tables(t, dev), t.nb)
    count, _ = ib._card_windows(e, t, False)
    plan = ib.plan_windows(count, t.nb, -(-t.keys // windows) + 20_000)
    assert len(plan) == windows
    offsets1, dang = ib._card_tables(t, dev)
    for lo, hi, length in plan:
        want = ib.pack_keys_window_plain(plain, lo, hi)
        assert length == want.shape[0]
        totals = kernels.digit_totals(bits, dev)
        got = kernels.pack_keys_window(e, offsets1, dang, t.nb, lo, hi, length,
                                       totals=totals)
        assert torch.equal(torch.sort(got).values, torch.sort(want).values)
        assert torch.equal(totals, kernels.digit_counts(got, bits))
        ordered = kernels.sort_keys(got, torch.empty_like(got), bits,
                                    totals=totals)
        assert torch.equal(ordered, ib.sort_keys_plain(want))
        for a, b in zip(kernels.merge_keys(ordered, t.nb, len(counts)),
                        ib.merge_keys_plain(ordered, t.nb, len(counts))):
            assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["long_runs", "gap_buckets", "many_tiles",
                                  "hub_tiles"])
def test_pack_index_windows_equal_one_sort(dev, name, monkeypatch):
    """``pack_index`` on the card in key-range windows (K7-sort's key limit
    ``kernels.SORT_MAX_KEYS`` lowered to a half and a fifth of the keys)
    is sha256-equal, array for array, to the same endpoints packed in one
    sort, with one window-form launch a window and no one-sort K7-keys."""
    import hashlib

    from fora_tpu_torch import ForaConfig as TorchConfig
    from fora_tpu_torch import kernels
    from fora_tpu_torch.index import build as ib
    ends, counts, deg = pack_case(name)
    rcfg = TorchConfig(epsilon=0.5, k=50).resolved(len(deg),
                                                    max(int(deg.sum()), 1))
    t = ib.pack_tables(counts, deg)
    run = int(torch.unique(ib.pack_keys_plain(
        torch.from_numpy(ends), *ib._device_tables(t, "cpu"), t.nb),
        return_counts=True)[1].max())

    def digest(idx):
        h = hashlib.sha256()
        for a in (idx.edge_src, idx.edge_dst, idx.edge_mult,
                  idx.bucket_offsets, idx.counts_cum,
                  *[p for p in idx.dst_indptr if p is not None]):
            h.update(np.ascontiguousarray(a).tobytes())
        return h.hexdigest()
    want = digest(ib.pack_index(torch.from_numpy(ends).to(dev), counts, deg,
                                rcfg))
    for part in (2, 5):
        kernels.reset_launch_counts()
        log = {}
        monkeypatch.setattr(kernels, "SORT_MAX_KEYS",
                            max(run, -(-t.keys // part)))
        idx = ib.pack_index(torch.from_numpy(ends).to(dev), counts, deg, rcfg,
                            log=log)
        c = kernels.launch_counts()
        assert log["windows"] >= 2
        assert c["pack_keys_window"] == log["windows"] and c["pack_keys"] == 0
        assert c["pack_key_counts"] >= 1
        assert c["sort_keys"] == c["merge_keys"] == log["windows"]
        assert digest(idx) == want
