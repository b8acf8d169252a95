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
from walk_chisq import assert_endpoints_follow

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


@pytest.mark.parametrize("B", [1, 3, 32, 128, 130])
@pytest.mark.parametrize("masked", [False, True])
def test_gather_scatter_kernel_matches_plain(dev, B, masked):
    from fora_tpu_torch import kernels
    from fora_tpu_torch.ops.gather import gather_scatter_add_plain
    rng = np.random.default_rng(B + 7 * masked)
    n, n_src, E = 3000, 2500, 40000
    indptr, src = _random_csr(rng, n, n_src, E)
    t = lambda a: torch.as_tensor(a, device=dev)   # noqa: E731
    values = t(rng.random((n_src, B), dtype=np.float32))
    acc0 = t(rng.random((n, B), dtype=np.float32))
    edge_w = t(rng.integers(1, 4, E).astype(np.float32))
    src_w = t(rng.random(n_src, dtype=np.float32))
    thr = t(rng.random(n, dtype=np.float32) * 5)
    outs = []
    for fn in (kernels.gather_scatter_add, gather_scatter_add_plain):
        acc = acc0.clone()
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        fn(acc, values, t(indptr), t(src), edge_w, src_w, thr, masked,
           flag)
        outs.append((acc, int(flag.item())))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=1e-5, atol=1e-6)
    assert outs[0][1] == outs[1][1]


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


@pytest.mark.parametrize("n,B,k", [(5000, 4, 10), (4096 * 45 + 17, 3, 50),
                                   (700, 2, 50)])
def test_topk_bounds_kernel_matches_plain(dev, n, B, k):
    from fora_tpu_torch.algo import bounds
    rng = np.random.default_rng(n)
    # quantized values plant many exact ties at and around rank k
    p = np.floor(rng.random((n, B)) * 64).astype(np.float32) / 4096
    contrib = np.floor(rng.random((n, B)) * 8).astype(np.float32) / 4096
    p_t, c_t = torch.as_tensor(p, device=dev), torch.as_tensor(contrib,
                                                               device=dev)
    t = bounds.union_bound_t(n, 3, 1.0 / n)
    got = bounds.topk_with_bounds_split(p_t, c_t, 3.0e5, k, t, 0.5)
    want = bounds.topk_with_bounds_split_plain(p_t, c_t, 3.0e5, k, t, 0.5)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[6], want[6])
    for i in (0, 2, 3, 4, 5):
        torch.testing.assert_close(got[i], want[i], rtol=1e-6, atol=0.0)


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
    got = ring.ring_reduce_scatter(xs)
    for d in set(devices):
        torch.cuda.synchronize(d)
    assert kernels.launch_counts()["ring_reduce_scatter_hop"] - \
        after["ring_reduce_scatter_hop"] == (G - 1) * G
    total = sum(x.cpu().double() for x in xs)
    for h in range(G):
        assert got[h].shape == (n_loc, B) and got[h].device == devices[h]
        assert torch.equal(got[h], want[h])          # bit for bit
        torch.testing.assert_close(
            got[h].cpu().double(), total[h * n_loc:(h + 1) * n_loc],
            rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_loc,B", [(1000, 4), (1001, 3), (131072, 128)])
@pytest.mark.parametrize("G", [2, 4])
def test_ring_kernels_match_plain_one_card(dev, G, n_loc, B):
    """P1 and P2 with all G shards on one card: stream order is the whole
    protocol.  (1001, 3) leaves the blocks unaligned for float4."""
    _check_ring_kernels([dev] * G, n_loc, B)


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
            assert counts["ring_reduce_scatter_hop"] == 12
            assert counts["topk_bounds"] == 4
        else:
            assert all(n == 0 for n in counts.values())
    assert res["cuda"].push_iters == res["cpu"].push_iters
    np.testing.assert_allclose(res["cuda"].values, res["cpu"].values,
                               rtol=1e-5, atol=1e-7)
    same = (res["cuda"].node_ids == res["cpu"].node_ids).mean()
    assert same > 0.95
