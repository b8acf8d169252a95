"""fora_tpu_torch.index and the walk ops against fora_tpu's, on the tracked
smoke set (bench_data_smoke/rmat12x8s7: n = 4096, m = 32768, FORA+ index
at eps = 0.5).

Deterministic pieces (store, counts, pack, index SpMV) are held to JAX's
arrays; walks draw other random numbers than JAX's threefry, so they are
held to exact PPR in distribution, as tests/test_walk.py does; an index
one package built serves queries in the other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fora_tpu import _native
from fora_tpu import index as jax_index
from fora_tpu.algo import exact
from fora_tpu.algo import fora as jax_fora
from fora_tpu.config import ForaConfig
from fora_tpu.graph import generators
from fora_tpu.graph import to_device as jax_to_device
from fora_tpu.graph.csr import CSRGraph
from fora_tpu.ops import push as jax_push
from fora_tpu_torch import convert
from fora_tpu_torch import index as tidx
from fora_tpu_torch.algo.fora import StagedForaPrograms
from fora_tpu_torch.graph import to_device
from fora_tpu_torch.ops.walk import run_walks, walk_endpoints

torch.set_num_threads(2)

SMOKE_IDX = "bench_data_smoke/rmat12x8s7.idx.e0.5"
ARRAYS = ("edge_src", "edge_dst", "counts_cum", "edge_mult",
          "bucket_offsets")


def _smoke():
    z = np.load("bench_data_smoke/rmat12x8s7.npz")
    g = CSRGraph(**{k: z[k] for k in CSRGraph._fields if k in z.files})
    return g, ForaConfig(epsilon=0.5, k=50).resolved(g.n, g.m)


def _assert_same_index(ours, theirs):
    for f in ARRAYS:
        np.testing.assert_array_equal(np.asarray(getattr(ours, f)),
                                      np.asarray(getattr(theirs, f)),
                                      err_msg=f)
    assert ours.omega_unit_built == theirs.omega_unit_built
    assert ours.rmax_built == theirs.rmax_built


@pytest.mark.parametrize("mmap", [False, True])
def test_store_load_matches_jax(mmap):
    g, rcfg = _smoke()
    ours = tidx.load(SMOKE_IDX, rcfg, graph=g, mmap=mmap)
    _assert_same_index(ours, jax_index.load(SMOKE_IDX, rcfg, graph=g))
    for q, indptr in enumerate(ours.dst_indptr):
        lo, hi = ours.bucket_offsets[q], ours.bucket_offsets[q + 1]
        if hi == lo:
            assert indptr is None
            continue
        counts = np.bincount(ours.edge_dst[lo:hi], minlength=g.n)
        np.testing.assert_array_equal(np.diff(indptr), counts)
    assert tidx.graph_fingerprint(g) == jax_index.graph_fingerprint(g)
    assert tidx.graph_fingerprint(to_device(g, device="cpu")) == \
        jax_index.graph_fingerprint(g)


def test_port_saved_index_loads_in_jax(tmp_path):
    g, rcfg = _smoke()
    ours = tidx.load(SMOKE_IDX, rcfg, graph=g)
    tidx.save(ours, rcfg, str(tmp_path / "idx"), graph=g)
    back = jax_index.load(str(tmp_path / "idx"), rcfg, graph=g)
    _assert_same_index(ours, back)
    assert tidx.load_meta(str(tmp_path / "idx")) == \
        jax_index.load_meta(SMOKE_IDX) | {"graph_sha":
                                          jax_index.graph_fingerprint(g)}


def test_store_refuses_other_graph(tmp_path):
    g, rcfg = _smoke()
    tidx.save(tidx.load(SMOKE_IDX, rcfg), rcfg, str(tmp_path), graph=g)
    other = generators.rmat(12, 32768, seed=8)   # same (n, m), other edges
    with pytest.raises(ValueError, match="fingerprint"):
        tidx.load(str(tmp_path), rcfg, graph=other)
    with pytest.raises(ValueError, match="too coarse"):
        tidx.load(str(tmp_path), rcfg.with_delta(rcfg.delta / 2))


def test_depth_for_and_edges_at_depth_match_jax():
    g, rcfg = _smoke()
    ours = tidx.load(SMOKE_IDX, rcfg)
    theirs = jax_index.load(SMOKE_IDX, rcfg)
    for d in (1 / 50, 1 / 400, 1 / 3200, 1 / g.n):
        rc = rcfg.with_delta(d)
        q = ours.depth_for(rc.omega_unit, rc.rmax)
        assert q == theirs.depth_for(rc.omega_unit, rc.rmax)
        for a, b in zip(ours.edges_at_depth(q), theirs.edges_at_depth(q)):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_state_fn_matches_jax():
    """One indexed level from one-hot state: ppr = p + contrib, the
    residue mass and the superstep count, as fora_tpu's state_fn."""
    g, rcfg = _smoke()
    src = np.arange(5, 4096, 4096 // 8, dtype=np.int32)
    rc = rcfg.with_delta(1 / 400)
    jg = jax_to_device(g, merge_duplicate_edges=True, hub_rows=256)
    jidx = jax_index.load(SMOKE_IDX, rcfg, graph=g)
    depth = jidx.depth_for(rc.omega_unit, rc.rmax)
    st0 = jax_push.init_state(g.n, jnp.asarray(src))
    tst = convert.push_state_from_numpy(st0.p, st0.r, device="cpu")
    # JAX donates the state buffers, so convert them first
    want, _, _ = jax_fora.StagedForaPrograms(jg, rcfg, jidx).state_fn(depth)(
        st0.p, st0.r, None, rc.rmax, rc.omega_unit)
    tg = to_device(g, merge_duplicate_edges=True, hub_rows=256, device="cpu")
    staged = StagedForaPrograms(tg, rcfg, tidx.load(SMOKE_IDX, rcfg))
    got, p, r = staged.state_fn(depth)(tst.p, tst.r, None, rc.rmax,
                                        rc.omega_unit)
    np.testing.assert_allclose(got.ppr.numpy(), np.asarray(want.ppr),
                               rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(got.rsum.numpy(), np.asarray(want.rsum),
                               rtol=1e-5)
    assert got.push_iters == int(want.push_iters)
    assert p is tst.p and r is tst.r       # advanced in place


@pytest.mark.parametrize("builder", ["port", "jax"])
def test_cross_serve_index(builder, tmp_path):
    """Each package's TopkRunner on an index the other built: JAX's on one
    the port built on the CPU and saved, the port's on the smoke index
    JAX built.  Precision@50 of the smoke exact file's 4 queries at least
    the reference's (JAX on its own index) less 0.02 (4 of 200 ids)."""
    from fora_tpu.algo import topk as jax_topk
    from fora_tpu.eval import metrics
    from fora_tpu.eval import queries as qio
    from fora_tpu_torch.algo.topk import TopkRunner
    g, rcfg = _smoke()
    src = qio.generate_sources(g, 64, seed=8)[:4]
    ex = np.load("bench_data_smoke/rmat12x8s7.exact4.d1975b620f.k50.npz")[
        "ids"]
    jg = jax_to_device(g, merge_duplicate_edges=True, hub_rows=256)

    def jax_serves(path):
        runner = jax_topk.TopkRunner(jg, rcfg, k=50, delta_stride=8.0,
                                     index=jax_index.load(path, rcfg,
                                                          graph=g))
        return runner.query_pool(src, jax.random.key(1), batch=4,
                                 start_level=0).node_ids

    ref = metrics.batch_precision_at_k(jax_serves(SMOKE_IDX), ex)
    tg = to_device(g, merge_duplicate_edges=True, hub_rows=256, device="cpu")
    if builder == "port":
        built = tidx.build_walk_index(tg, rcfg, seed=3)
        tidx.save(built, rcfg, str(tmp_path / "idx"), graph=g)
        ids = jax_serves(str(tmp_path / "idx"))
    else:
        runner = TopkRunner(tg, rcfg, k=50, delta_stride=8.0,
                            index=tidx.load(SMOKE_IDX, rcfg, graph=g))
        ids = runner.query_pool(src, batch=4, start_level=0).node_ids
    prec = metrics.batch_precision_at_k(ids, ex)
    assert (ids[:, 0] == src).all()
    assert prec >= ref - 0.02, (prec, ref)


def test_walk_contrib_matches_jax_every_depth():
    g, rcfg = _smoke()
    jg = jax_to_device(g, merge_duplicate_edges=True, hub_rows=256)
    jidx = jax_index.load(SMOKE_IDX, rcfg, graph=g)
    jstaged = jax_fora.StagedForaPrograms(jg, rcfg, jidx)
    src = jnp.asarray(np.arange(3, 4096, 4096 // 16, dtype=np.int32))
    r = np.array(jax_push.forward_push(jg, src, rmax=rcfg.rmax * 30,
                                       alpha=0.2).r)
    tg = to_device(g, merge_duplicate_edges=True, hub_rows=256, device="cpu")
    staged = StagedForaPrograms(tg, rcfg, tidx.load(SMOKE_IDX, rcfg, graph=g))
    for depth in range(tidx.NUM_BUCKETS):
        want = np.asarray(jstaged.walk_contrib(jnp.asarray(r), depth))
        got = staged.walk_contrib(torch.as_tensor(r), depth).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12,
                                   err_msg=f"depth {depth}")
        np.testing.assert_array_equal(
            staged.coverage_thr(depth, rcfg.omega_unit).numpy(),
            np.asarray(jstaged.coverage_thr(depth, rcfg.omega_unit)))


def test_index_counts_match_jax():
    g, rcfg = _smoke()
    for cap in (None, 7):
        np.testing.assert_array_equal(
            tidx.index_counts(g.out_deg, rcfg, cap),
            jax_index.index_counts(g.out_deg, rcfg, cap))


def _pack_inputs():
    g, rcfg = _smoke()
    counts = tidx.index_counts(g.out_deg, rcfg)
    rng = np.random.default_rng(17)
    # endpoints concentrate like real walks: a fifth stay at their source
    starts = np.repeat(np.arange(g.n), counts)
    ends = rng.integers(0, g.n, counts.sum())
    stay = rng.random(counts.sum()) < 0.2
    ends[stay] = starts[stay]
    return ends.astype(np.int32), counts, np.asarray(g.out_deg), rcfg


@pytest.mark.parametrize("branch", ["native", "numpy", "legacy"])
def test_pack_index_matches_jax(branch, monkeypatch):
    """The port's numpy pack against each of fora_tpu's three branches
    (``branch`` names JAX's: its native radix sort, its numpy packed-key
    sort, its legacy lexsort without the merge)."""
    ends, counts, deg, rcfg = _pack_inputs()
    if branch == "native":
        assert _native.native_sort_unique_u64 is not None
    else:
        monkeypatch.setattr(_native, "native_sort_unique_u64", None)
    dedup = branch != "legacy"
    ours = tidx.pack_index(ends, counts, deg, rcfg, dedup=dedup)
    theirs = jax_index.pack_index(ends, counts, deg, rcfg, dedup=dedup)
    if dedup:
        _assert_same_index(ours, theirs)
    else:
        for f in ("edge_src", "edge_dst", "counts_cum", "bucket_offsets"):
            np.testing.assert_array_equal(np.asarray(getattr(ours, f)),
                                          np.asarray(getattr(theirs, f)))
    assert float(np.asarray(ours.edge_mult if dedup else
                            np.ones(ours.total_edges)).sum()) == \
        counts.sum() + (deg == 0).sum()


def test_build_walk_index_cpu_layout():
    """The port's build: counts and per-depth visibility are fixed by the
    degrees, so they equal the smoke index's; the pool sizes add up."""
    g, rcfg = _smoke()
    tg = to_device(g, merge_duplicate_edges=True, device="cpu")
    built = tidx.build_walk_index(tg, rcfg, seed=3, chunk_lanes=1 << 16)
    ref = jax_index.load(SMOKE_IDX, rcfg)
    np.testing.assert_array_equal(built.counts_cum,
                                  np.asarray(ref.counts_cum))
    counts = tidx.index_counts(g.out_deg, rcfg)
    assert built.edge_mult.sum() == counts.sum() + (g.out_deg == 0).sum()
    assert built.dst_indptr[tidx.NUM_BUCKETS - 1] is not None


def test_index_from_numpy_matches_load():
    g, rcfg = _smoke()
    conv = convert.index_from_numpy(jax_index.load(SMOKE_IDX, rcfg))
    ours = tidx.load(SMOKE_IDX, rcfg)
    _assert_same_index(conv, ours)
    for a, b in zip(conv.dst_indptr, ours.dst_indptr):
        assert (a is None and b is None) or np.array_equal(a, b)


def test_run_walks_match_exact_ppr():
    g = generators.karate_club()
    dg = to_device(g, device="cpu")
    W = 100_000
    gen = torch.Generator().manual_seed(1)
    ends = run_walks(dg, torch.zeros(W, dtype=torch.int32), generator=gen,
                     alpha=0.2)
    freq = np.bincount(ends.numpy(), minlength=g.n) / W
    assert np.abs(freq - exact.exact_ppr_dense(g, 0)).sum() < 0.02
    # the CPU walk_endpoints is run_walks under a seeded generator
    again = walk_endpoints(dg, torch.zeros(W, dtype=torch.int32), 1, 0.2, 64)
    assert torch.equal(again, ends)


def test_run_walks_dangling_absorbs():
    n, alpha = 5, 0.2
    g = generators.star_graph(n)
    dg = to_device(g, device="cpu")
    W = 40_000
    gen = torch.Generator().manual_seed(2)
    leaf = run_walks(dg, torch.full((W, 1), 3, dtype=torch.int32),
                     generator=gen, alpha=alpha)
    assert bool((leaf == 3).all())
    hub = run_walks(dg, torch.zeros((W, 1), dtype=torch.int32),
                    generator=gen, alpha=alpha)
    freq = np.bincount(hub.numpy().ravel(), minlength=n) / W
    np.testing.assert_allclose(freq, exact.exact_ppr_dense(g, 0, alpha=alpha),
                               atol=0.01)
