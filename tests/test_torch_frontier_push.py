"""The frontier-compacted push: fora_tpu_torch.ops.push.forward_push_from
(compact_edges=) against fora_tpu's on the same inputs, on the CPU (K5's
plain version; the kernel itself is held to it by the card's tests).

Tolerance: rtol 1e-6, atol 1e-9 on p and r, as tests/test_push.py holds
JAX's own compacted push to its dense one, and ``iters`` equal; graphs that
cannot compact run the dense path, held at test_torch_push.py's rtol 1e-5,
atol 1e-8.  The branch counts, the active out-edge count and the tasks'
masks of non-zero chunks are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fora_tpu.graph import generators as jax_generators
from fora_tpu.graph import to_device as jax_to_device
from fora_tpu.graph.csr import from_edges as jax_from_edges
from fora_tpu.ops import push as jax_push
from fora_tpu_torch.graph import from_edges, to_device
from fora_tpu_torch.ops import push

torch.set_num_threads(2)

RTOL, ATOL = 1e-6, 1e-9
SOURCES = np.array([0, 7, 123, 399], np.int32)


def _er():
    return jax_generators.erdos_renyi(400, 5000, seed=13)


def _loops_and_parallels():
    """A multigraph: every fifth edge repeated, 40 self-loops, and some
    dangling nodes."""
    rng = np.random.default_rng(21)
    n = 300
    src = rng.integers(0, n - 20, 3000)
    dst = rng.integers(0, n, 3000)
    src = np.concatenate([src, src[::5], np.arange(40)])
    dst = np.concatenate([dst, dst[::5], np.arange(40)])
    return jax_from_edges(src, dst, n)


def _both(g, sources, cap, rmax=1e-4, max_iters=200, thr=None, **layout):
    jst = jax_push.forward_push_from(
        jax_to_device(g, **layout),
        jax_push.init_state(g.n, jnp.asarray(sources)), rmax=rmax,
        alpha=0.2, max_iters=max_iters, compact_edges=cap,
        thr=None if thr is None else jnp.asarray(thr))
    push.superstep_counts.reset()
    tst = push.forward_push_from(
        to_device(g, device="cpu", **layout),
        push.init_state(g.n, torch.as_tensor(sources)), rmax=rmax,
        alpha=0.2, max_iters=max_iters, compact_edges=cap,
        thr=None if thr is None else torch.as_tensor(thr))
    counts = (push.superstep_counts.compacted, push.superstep_counts.dense)
    return jst, tst, counts


def _close(jst, tst, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(tst.p.numpy(), np.asarray(jst.p), rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(tst.r.numpy(), np.asarray(jst.r), rtol=rtol,
                               atol=atol)
    assert tst.iters == int(jst.iters)


@pytest.mark.parametrize("cap", [0, -1, 4096, 512, 8])
def test_compacted_push_matches_jax(cap):
    jst, tst, (comp, dense) = _both(_er(), SOURCES, cap)
    _close(jst, tst)
    assert comp + dense == tst.iters
    # m = 5000: the default cap is 0 (dense) below 2^16 edges, as in JAX
    assert (comp > 0) == (cap in (4096, 512))
    assert (dense > 0) == (cap in (0, -1, 512, 8))


def test_both_branches_counted_at_cap_512():
    _, tst, (comp, dense) = _both(_er(), SOURCES, 512)
    assert comp > 0 and dense > 0 and comp + dense == tst.iters


def _jax_active_edges(g, r, thr):
    """JAX's cnt (``active_edge_segment_sum``, push.py:297-298) of the
    superstep from residue ``r``: in-edges whose source row has a non-zero
    contrib."""
    deg = jnp.asarray(g.out_deg, jnp.float32)[:, None]
    active = jnp.asarray(r) > jnp.asarray(thr)[:, None]
    ar = jnp.where(active, jnp.asarray(r), 0.0)
    contrib = jnp.where(deg == 0.0, 0.0, 0.8 * ar / jnp.maximum(deg, 1e-30))
    row_active = jnp.any(contrib != 0.0, axis=1)
    edge_act = row_active.astype(jnp.int8)[jnp.asarray(g.in_src)] > 0
    return int(jnp.sum(edge_act.astype(jnp.int32))), row_active, contrib


def test_active_edge_count_with_loops_and_parallels():
    """The pre-pass counts the active rows' out-edges; on the unmerged
    graph that is JAX's count of active in-edges, self-loops and parallel
    edges included, and a cap at that count compacts the superstep while
    one below it does not, as JAX's ``cnt <= e_cap`` decides."""
    g = _loops_and_parallels()
    rng = np.random.default_rng(3)
    r = (rng.random((g.n, 5)) * (rng.random((g.n, 5)) < 0.2)).astype(
        np.float32)
    r[:40] = 0.5                     # the self-loop rows all push
    thr = g.out_deg.astype(np.float32) * np.float32(1e-3)   # rmax * deg
    want, row_active, contrib = _jax_active_edges(g, r, thr)
    tg = to_device(g, device="cpu")
    p_t, r_t = torch.zeros(g.n, 5), torch.tensor(r)
    contrib_t = torch.empty_like(r_t)
    tasks = torch.empty((push.task_rows(g.n, g.m), push.TASK_FIELDS),
                        dtype=torch.int32)
    status = torch.zeros(3, dtype=torch.int32)
    push.frontier_prepass(p_t, r_t, contrib_t, torch.as_tensor(thr),
                          tg.out_deg, tg.out_indptr, push.out_weight(tg), 0.2,
                          tasks, status, g.m)
    assert 0 < want < g.m and status.tolist() == [1, want,
                                                  int(row_active.sum())]
    np.testing.assert_array_equal(contrib_t.numpy(), np.asarray(contrib))
    np.testing.assert_array_equal(
        tasks[:status[2], 0].numpy(), np.flatnonzero(np.asarray(row_active)))
    # the plain K5 against JAX's active_edge_segment_sum on that state
    delta = jax_push.active_edge_segment_sum(
        contrib, jnp.asarray(g.in_src), jnp.asarray(g.in_dst), g.n,
        row_active, want)
    got = push.active_edge_segment_sum_plain(
        torch.zeros(g.n, 5), contrib_t, tg.in_src, tg.in_dst,
        torch.as_tensor(np.array(row_active)))
    np.testing.assert_allclose(got.numpy(), np.asarray(delta), rtol=RTOL,
                               atol=ATOL)
    # whole pushes from those residues, the cap at the first count and one
    # below it
    for cap, first in ((want, "compacted"), (want - 1, "dense")):
        jst = jax_push.forward_push_from(
            jax_to_device(g), jax_push.PushState(
                p=jnp.zeros((g.n, 5)), r=jnp.asarray(r),
                iters=jnp.zeros((), jnp.int32)),
            rmax=1e-3, alpha=0.2, max_iters=1, compact_edges=cap)
        push.superstep_counts.reset()
        tst = push.forward_push_from(
            tg, push.PushState(p=torch.zeros(g.n, 5),
                               r=torch.as_tensor(r).clone(), iters=0),
            rmax=1e-3, alpha=0.2, max_iters=1, compact_edges=cap)
        _close(jst, tst)
        assert getattr(push.superstep_counts, first) == 1


def _masks_by_hand(contrib, span):
    """Each row's mask of non-zero spans, bit by bit in numpy."""
    n, B = contrib.shape
    out = np.zeros(n, np.int64)
    for i in range(-(-B // span)):
        hit = (contrib[:, i * span:(i + 1) * span] != 0).any(axis=1)
        out |= hit.astype(np.int64) << i
    return np.where(out >= 2**31, out - 2**32, out)


@pytest.mark.parametrize("B,span", [(1, 1), (3, 1), (8, 4), (32, 4),
                                    (128, 4), (130, 5), (256, 8)])
def test_prepass_masks_are_the_nonzero_chunks(B, span):
    """The plain pre-pass's tasks carry each row's mask of non-zero
    chunks (float4 chunks at B = 8, 32, 128; columns at B = 1, 3; groups of
    5 columns at 130 and of 2 chunks at 256, so that 32 bits cover the
    row), one task per 1,024 out-edges of the row with its first edge and
    edge count: a hub row of 2,500 out-edges takes three."""
    rng = np.random.default_rng(B)
    n = 300
    src = np.concatenate([np.zeros(2500, np.int64),
                          rng.integers(1, n - 20, 3000)])
    g = jax_from_edges(src, rng.integers(0, n, src.size), n)
    tg = to_device(g, device="cpu")
    r = (rng.random((n, B)) * (rng.random((n, B)) < 3.0 / B)).astype(
        np.float32)
    r[0] = 0.0
    r[0, -1] = 5.0                   # the hub pushes its last column only
    r[1] = 1.0                       # a row pushes every column
    p_t, r_t = torch.zeros(n, B), torch.tensor(r)
    c_t = torch.empty_like(r_t)
    tasks = torch.full((push.task_rows(n, g.m), push.TASK_FIELDS), -7,
                       dtype=torch.int32)
    status = torch.zeros(3, dtype=torch.int32)
    thr = tg.out_deg.float() * 1e-3
    push.frontier_prepass(p_t, r_t, c_t, thr, tg.out_deg, tg.out_indptr,
                          push.out_weight(tg), 0.2, tasks, status, g.m)
    assert push.mask_span(B) == span
    c = c_t.numpy()
    rows = np.flatnonzero((c != 0).any(axis=1))
    deg = g.out_deg[rows]
    k = -(-deg // push.TASK_EDGES)
    nt = int(status[2])
    assert nt == int(k.sum()) and {0, 1} <= set(rows.tolist())
    got = tasks[:nt].numpy()
    np.testing.assert_array_equal(got[:, 0], np.repeat(rows, k))
    j = np.concatenate([np.arange(x) for x in k])
    np.testing.assert_array_equal(
        got[:, 1], np.repeat(g.out_indptr[rows], k) + j * push.TASK_EDGES)
    np.testing.assert_array_equal(
        got[:, 2], np.repeat(_masks_by_hand(c, span)[rows], k))
    np.testing.assert_array_equal(
        got[:, 3], np.minimum(np.repeat(deg, k) - j * push.TASK_EDGES,
                              push.TASK_EDGES))
    assert (tasks[nt:] == -7).all()
    hub = got[got[:, 0] == 0]
    assert hub[:, 3].tolist() == [1024, 1024, 452]
    assert hub[0, 2] == np.int32(np.int64(1 << ((B - 1) // span)) -
                                 (2**32 if (B - 1) // span == 31 else 0))
    full = got[got[:, 0] == 1, 2][0]
    assert full == _masks_by_hand(np.ones((1, B)), span)[0]


@pytest.mark.parametrize("state", ["few_columns", "every_column"])
def test_compacted_push_from_a_state_matches_jax(state):
    """From a residue where each row holds a few non-zero columns of 32 (K5
    adds one or two chunks of a row) and from one where every column is
    non-zero (every chunk), the compacted push matches JAX's."""
    g = _er()
    rng = np.random.default_rng(5)
    r = rng.random((g.n, 32)).astype(np.float32) * 1e-2
    if state == "few_columns":
        r *= rng.random((g.n, 32)) < 2.0 / 32
    p = np.zeros_like(r)
    jst = jax_push.forward_push_from(
        jax_to_device(g), jax_push.PushState(
            p=jnp.asarray(p), r=jnp.asarray(r),
            iters=jnp.zeros((), jnp.int32)),
        rmax=1e-4, alpha=0.2, compact_edges=4096)
    push.superstep_counts.reset()
    tst = push.forward_push_from(
        to_device(g, device="cpu"), push.PushState(
            p=torch.tensor(p), r=torch.tensor(r), iters=0),
        rmax=1e-4, alpha=0.2, compact_edges=4096)
    _close(jst, tst)
    assert push.superstep_counts.compacted > 0


def test_probe_snapshot_and_lane_use():
    """probes/frontier_probe.py's pieces that run without a card: the
    snapshot (the compacted superstep with the most active out-edges
    within the cap) and the lanes K5 would use on its tasks."""
    from fora_tpu_torch.probes import frontier_probe
    tg = to_device(_er(), device="cpu")
    src = torch.as_tensor(SOURCES)
    (p0, r0, edges, step), counts = frontier_probe.snapshot(
        tg, src, 1e-4, 0.2, 4096)
    assert edges == max(c for c in counts if c <= 4096)
    assert counts[step - 1] == edges
    tasks = torch.empty((push.task_rows(tg.n, tg.m), push.TASK_FIELDS),
                        dtype=torch.int32)
    status = torch.zeros(3, dtype=torch.int32)
    c = torch.empty_like(r0)
    push.frontier_prepass(p0, r0, c, push.node_threshold(tg, 1e-4),
                          tg.out_deg, tg.out_indptr, push.out_weight(tg), 0.2,
                          tasks, status, tg.m)
    assert int(status[1]) == edges
    nt = int(status[2])
    lu = frontier_probe.lane_use(tasks, nt, 4)
    # B = 4: one chunk a row, so one bit a mask and an edge a lane
    assert lu["bits"] == 1.0 and lu["pairs"] == edges
    deg = tasks[:nt, 3].long()
    assert lu["lanes"] == pytest.approx(
        edges / (32 * int(((deg + 31) // 32).sum())))


@pytest.mark.parametrize("cap", [4096, 16])
def test_compacted_push_with_loops_parallels_and_dangling(cap):
    _close(*_both(_loops_and_parallels(), np.array([0, 5, 290, 299]),
                  cap)[:2])


@pytest.mark.parametrize("layout", [
    {"merge_duplicate_edges": True}, {"hub_rows": 16}, "weighted"])
def test_cap_on_a_graph_that_cannot_compact_is_dense(layout):
    """A merged graph (its in_w counts parallel edges), a weighted one and
    one with the hub split take the dense path whatever the cap, as in
    JAX."""
    g = _loops_and_parallels()
    if layout == "weighted":
        src = np.repeat(np.arange(g.n), g.out_deg)
        w = np.random.default_rng(4).uniform(0.5, 2.0, g.m)
        g = jax_from_edges(src, g.out_indices, g.n, w=w)
        layout = {}
    for cap in (512, -1):
        jst, tst, (comp, dense) = _both(g, SOURCES[:3], cap, **layout)
        _close(jst, tst, 1e-5, 1e-8)
        assert comp == 0 and dense == tst.iters > 0
    assert push.edge_cap(to_device(g, device="cpu", **layout), 512) == 0


def test_compacted_push_thr_and_max_iters_match_jax():
    """A per-node threshold override and a superstep cap go through the
    compacted loop as through JAX's while_loop."""
    g = _er()
    thr = (np.random.default_rng(9).random(g.n) * 1e-3).astype(np.float32)
    _close(*_both(g, SOURCES, 512, thr=thr)[:2])
    for iters in (0, 1, 3):
        jst, tst, counts = _both(g, SOURCES, 512, max_iters=iters)
        _close(jst, tst)
        assert sum(counts) == iters


@pytest.mark.parametrize("sources,counts", [([0, 3], (1, 1)),
                                            ([3, 5], (1, 0))])
def test_star_dangling_rows_absorb_under_compaction(sources, counts):
    """The star's leaves are dangling: an active leaf has no out-edges but
    still absorbs its residue, so a superstep with only such rows active
    compacts with no tasks, and is a superstep all the same (from the hub,
    39 out-edges over the cap of 16, the first one is dense)."""
    g = jax_generators.star_graph(40)
    jst, tst, got = _both(g, np.array(sources, np.int32), 16)
    _close(jst, tst)
    assert got == counts and tst.iters == sum(counts)
    torch.testing.assert_close(tst.p.sum(0), torch.ones(2), rtol=0,
                               atol=1e-6)


def test_default_edge_cap_matches_jax():
    for m in [0, 1, 8, 1 << 16, (1 << 16) + 1, 262143, 262144, 1 << 20,
              5_000_003, 1 << 23, 1 << 31]:
        assert push.default_edge_cap(m) == jax_push.default_edge_cap(m), m
    assert push.default_edge_cap(1 << 23) == 2_097_152
    assert push.default_edge_cap(1 << 20, frac=0.5, min_edges=8) == \
        jax_push.default_edge_cap(1 << 20, frac=0.5, min_edges=8)


def test_compacted_push_on_port_graph_from_port_edges():
    """The port's own from_edges and generators give the same push: the
    compacted path reads the port's in-edges and out-CSR."""
    from fora_tpu_torch.graph import generators
    g = generators.erdos_renyi(400, 5000, seed=13)
    assert np.array_equal(g.in_src, _er().in_src)
    dg = to_device(from_edges(np.repeat(np.arange(g.n), g.out_deg),
                              g.out_indices, g.n), device="cpu")
    a = push.forward_push_from(dg, push.init_state(g.n, torch.as_tensor(
        SOURCES)), rmax=1e-4, alpha=0.2, compact_edges=512)
    b = push.forward_push_from(dg, push.init_state(g.n, torch.as_tensor(
        SOURCES)), rmax=1e-4, alpha=0.2)
    torch.testing.assert_close(a.p, b.p, rtol=RTOL, atol=ATOL)
    assert a.iters == b.iters
