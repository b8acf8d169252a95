"""The destination-row gather's work list (``kernels.schedule``) and the
level-wide index SpMV, on the CPU.

The CUDA kernel cannot run here, so ``emulate`` below follows its
algorithm step by step in PyTorch: each task sums its edges, a split
row's tasks leave partial sums in their slots, and the row's last task
adds the partials in slot order, then masks, adds and flags the row.  It
is held against the plain version, against JAX's
``fora_tpu/ops/push.py::gather_scatter_add``, and (over a level's
buckets) against JAX's ``indexed_walk_contrib_from_slices``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fora_tpu import index as jax_index
from fora_tpu.index.build import (index_slices,
                                  indexed_walk_contrib_from_slices)
from fora_tpu.ops import push as jax_push
from fora_tpu_torch import ForaConfig
from fora_tpu_torch import index as tidx
from fora_tpu_torch.algo.fora import StagedForaPrograms
from fora_tpu_torch.graph import generators, to_device
from fora_tpu_torch.graph.csr import CSRGraph
from fora_tpu_torch.kernels.schedule import (TASK_EDGES, degrees,
                                             gather_schedule)
from fora_tpu_torch.ops import gather

torch.set_num_threads(2)

SMOKE = "bench_data_smoke/rmat12x8s7"
SMOKE_IDX = SMOKE + ".idx.e0.5"
TASK_SIZES = (1, 7, 64, TASK_EDGES)


def _rmat_csr():
    g = generators.rmat(12, 1 << 15, seed=3)
    dg = to_device(g, merge_duplicate_edges=True, device="cpu")
    return dg.in_indptr, dg.in_src, dg.in_w, g.n


def _skewed_csr():
    """One 5,000-edge row, a few short rows, mostly empty rows."""
    rng = np.random.default_rng(5)
    n = 3000
    deg = np.zeros(n, np.int64)
    deg[1234] = 5000
    short = rng.choice(n, 200, replace=False)
    deg[short] += rng.integers(1, 40, 200)
    indptr = np.zeros(n + 1, np.int32)
    np.cumsum(deg, out=indptr[1:])
    src = rng.integers(0, n, int(deg.sum())).astype(np.int32)
    w = rng.integers(1, 4, int(deg.sum())).astype(np.float32)
    return torch.from_numpy(indptr), torch.from_numpy(src), \
        torch.from_numpy(w), n


CSRS = {"rmat": _rmat_csr, "skewed": _skewed_csr}


def _row_edges(indptr2d, seg_off, t):
    """Edge ids of row t over its segments, in segment order."""
    return np.concatenate([o + np.arange(indptr2d[s, t], indptr2d[s, t + 1])
                           for s, o in enumerate(seg_off)])


def _assert_covers(sched, indptr, seg_off=(0,), task_edges=TASK_EDGES):
    """Every edge exactly once, in order, no task over ``task_edges``;
    slots, split rows and counters consistent."""
    n = sched.n_rows
    ip = indptr.numpy().reshape(-1, n + 1)
    tasks = sched.tasks.numpy()
    assert sched.tasks.dtype == torch.int32 and tasks.shape[1] == 4
    rows, lo, hi, slot = tasks.T
    assert (np.diff(rows) >= 0).all() and set(rows) == set(range(n))
    assert ((hi - lo) <= task_edges).all() and (hi >= lo).all()
    deg = degrees(indptr).numpy()
    covered = []
    for t in range(n):
        mine = tasks[rows == t]
        assert mine[0, 1] == 0 and mine[-1, 2] == deg[t]
        assert (mine[1:, 1] == mine[:-1, 2]).all()      # contiguous ranges
        split = len(mine) > 1
        assert ((mine[:, 3] >= 0) == split).all()
        edges = _row_edges(ip, seg_off, t)
        covered += [edges[a:b] for _, a, b, _ in mine]
    covered = np.concatenate(covered)
    want = np.concatenate([_row_edges(ip, seg_off, t) for t in range(n)])
    np.testing.assert_array_equal(covered, want)
    # slots: the split tasks numbered in task order, grouped by split row
    sl = slot[slot >= 0]
    np.testing.assert_array_equal(sl, np.arange(sched.n_slots))
    ptr = sched.split_ptr.numpy()
    split_rows = np.unique(rows[slot >= 0])
    assert ptr[0] == 0 and len(ptr) == len(split_rows) + 1
    np.testing.assert_array_equal(np.diff(ptr),
                                  np.bincount(rows[slot >= 0])[split_rows])
    np.testing.assert_array_equal(
        sched.slot_row.numpy(),
        np.repeat(np.arange(len(split_rows)), np.diff(ptr)))
    assert not sched.counters.any() and sched.task_edges == task_edges


@pytest.mark.parametrize("task_edges", TASK_SIZES)
@pytest.mark.parametrize("name", sorted(CSRS))
def test_schedule_covers_every_edge_once(name, task_edges):
    indptr, _, _, n = CSRS[name]()
    sched = gather_schedule(indptr, task_edges)
    assert sched.n_rows == n
    _assert_covers(sched, indptr, task_edges=task_edges)
    deg = degrees(indptr)
    assert sched.n_tasks == int(torch.clamp(
        (deg + task_edges - 1) // task_edges, min=1).sum())


def test_schedule_splits_the_long_row_evenly():
    indptr, _, _, _ = _skewed_csr()
    t = gather_schedule(indptr, 512).tasks.numpy()
    long = t[t[:, 0] == 1234]
    assert len(long) == 10                        # ceil(5000 / 512)
    assert set(long[:, 2] - long[:, 1]) == {500}
    with pytest.raises(ValueError):
        gather_schedule(indptr, 0)


def emulate(acc, values, indptr, src, sched, edge_w=None, src_w=None,
            thr=None, mask=False, flag=None, seg_off=(0,), accumulate=True):
    """The kernel's algorithm on the CPU (float32): per task the sum of its
    edges; a whole-row task finishes its row, a split task stores its
    partial and the row's last task adds the partials in slot order and
    finishes the row.  Returns the new acc; sets ``flag`` as the kernel."""
    n, B = acc.shape
    ip = indptr.numpy().reshape(-1, n + 1)
    out = acc.clone() if accumulate else torch.zeros_like(acc)
    partial = torch.zeros((sched.n_slots, B))
    ptr, slot_row = sched.split_ptr.tolist(), sched.slot_row.tolist()
    done = [0] * (len(ptr) - 1)

    def finish(t, total):
        a = out[t]
        if mask:
            a = torch.where(a > thr[t], 0.0, a)
        a = a + total
        out[t] = a
        if flag is not None and bool((a > thr[t]).any()):
            flag[0] = 1

    for t, lo, hi, slot in sched.tasks.tolist():
        e = torch.from_numpy(_row_edges(ip, seg_off, t)[lo:hi])
        s = src[e].long()
        v = values[s]
        if src_w is not None:
            v = v * src_w[s][:, None]
        if edge_w is not None:
            v = v * edge_w[e][:, None]
        total = torch.zeros(B)
        for x in v:                   # in edge order
            total = total + x
        if slot < 0:
            finish(t, total)
            continue
        partial[slot] = total
        r = slot_row[slot]
        done[r] += 1
        if done[r] == ptr[r + 1] - ptr[r]:
            total = torch.zeros(B)
            for p in partial[ptr[r]:ptr[r + 1]]:
                total = total + p
            finish(t, total)
    return out


def _inputs(n, n_src, B, seed):
    rng = np.random.default_rng(seed)
    values = rng.random((n_src, B), dtype=np.float32)
    acc = rng.random((n, B), dtype=np.float32)
    src_w = rng.random(n_src, dtype=np.float32)
    return values, acc, src_w


@pytest.mark.parametrize("name", sorted(CSRS))
@pytest.mark.parametrize("weights", ["none", "edge", "src", "both"])
@pytest.mark.parametrize("masked", [False, True])
def test_emulation_matches_plain(name, weights, masked):
    indptr, src, w, n = CSRS[name]()
    values, acc, src_w = _inputs(n, n, 3, seed=len(weights) + masked)
    values, acc, src_w = map(torch.from_numpy, (values, acc, src_w))
    edge_w = w if weights in ("edge", "both") else None
    sw = src_w if weights in ("src", "both") else None
    # thresholds that leave some rows over before the add and some after
    thr = torch.from_numpy(np.random.default_rng(1).random(n, np.float32)
                           * float(acc.max()))
    sched = gather_schedule(indptr, 64)
    flags = [torch.zeros(1, dtype=torch.int32) for _ in range(2)]
    got = emulate(acc, values, indptr, src, sched, edge_w, sw, thr, masked,
                  flags[0])
    want = gather.gather_scatter_add_plain(acc.clone(), values, indptr, src,
                                           edge_w, sw, thr, masked, flags[1])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert int(flags[0]) == int(flags[1])
    if masked:
        assert int(flags[0]) == 1


@pytest.mark.parametrize("name", sorted(CSRS))
@pytest.mark.parametrize("weights", ["none", "edge", "src", "both"])
def test_emulation_matches_jax(name, weights):
    indptr, src, w, n = CSRS[name]()
    values, acc, src_w = _inputs(n, n, 5, seed=7)
    edge_w = w.numpy() if weights in ("edge", "both") else None
    sw = src_w if weights in ("src", "both") else None
    dst = np.repeat(np.arange(n, dtype=np.int32), np.diff(indptr.numpy()))
    want = jax_push.gather_scatter_add(
        jnp.asarray(acc), jnp.asarray(values), jnp.asarray(src.numpy()),
        jnp.asarray(dst), edge_w=None if edge_w is None else
        jnp.asarray(edge_w), src_w=None if sw is None else jnp.asarray(sw))
    got = emulate(torch.from_numpy(acc), torch.from_numpy(values), indptr,
                  src, gather_schedule(indptr, 64),
                  None if edge_w is None else torch.from_numpy(edge_w),
                  None if sw is None else torch.from_numpy(sw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_device_graph_carries_its_schedules():
    g = generators.rmat(10, 1 << 13, seed=2)
    dg = to_device(g, merge_duplicate_edges=True, hub_rows=64, device="cpu")
    for indptr, sched in ((dg.in_indptr, dg.in_sched),
                          (dg.hub_indptr, dg.hub_sched)):
        want = gather_schedule(indptr)
        for f in ("tasks", "slot_row", "split_ptr", "counters"):
            assert torch.equal(getattr(sched, f), getattr(want, f)), f
    assert to_device(g, device="cpu").hub_sched is None


def _smoke():
    z = np.load(SMOKE + ".npz")
    g = CSRGraph(**{k: z[k] for k in CSRGraph._fields if k in z.files})
    return g, ForaConfig(epsilon=0.5, k=50).resolved(g.n, g.m)


@pytest.fixture(scope="module")
def smoke_level():
    g, rcfg = _smoke()
    staged = StagedForaPrograms(to_device(g, device="cpu"), rcfg,
                                tidx.load(SMOKE_IDX, rcfg, graph=g))
    jidx = jax_index.load(SMOKE_IDX, rcfg, graph=g)
    r = np.random.default_rng(11).random((g.n, 4), dtype=np.float32)
    return staged, jidx, r


@pytest.mark.parametrize("depth", range(8))
def test_level_spmv_matches_bucket_loop_and_jax(smoke_level, depth):
    staged, jidx, r_np = smoke_level
    r = torch.from_numpy(r_np)
    inv = staged._inv_cnt(depth)
    args = (r, staged._indptr[depth:], staged._seg_off[depth:], staged._src,
            staged._mult, inv)
    level = gather.index_spmv_level(*args)        # CPU: the plain version
    assert torch.equal(level, gather.index_spmv_level_plain(*args))
    loop = torch.zeros_like(r)
    for b in staged._buckets[depth:]:
        if b is not None:
            gather.index_spmv(loop, r, b[0], b[1], b[2], inv)
    assert torch.equal(level, loop)
    assert torch.equal(staged.walk_contrib(r, depth), level)
    buckets, counts_col = index_slices(jidx, depth)
    want = indexed_walk_contrib_from_slices(
        [tuple(None if a is None else jnp.asarray(a) for a in b)
         for b in buckets], jnp.asarray(counts_col), jnp.asarray(r_np))
    np.testing.assert_allclose(level.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("depth", [0, 3, 7])
def test_level_schedule_follows_the_buckets(smoke_level, depth):
    """The level's tasks cover each endpoint's edges over buckets depth..
    in bucket order, and the emulated one-launch level (which overwrites
    acc) equals the plain bucket loop."""
    staged, _, r_np = smoke_level
    sched = staged.level_schedule(depth)
    assert staged.level_schedule(depth) is sched   # built once per depth
    indptr = staged._indptr[depth:]
    seg_off = staged._seg_off[depth:].tolist()
    _assert_covers(sched, indptr, seg_off)
    # a small task size splits rows across bucket boundaries
    small = gather_schedule(indptr, 16)
    _assert_covers(small, indptr, seg_off, task_edges=16)
    assert small.n_slots > 0
    r = torch.from_numpy(r_np)
    inv = staged._inv_cnt(depth)
    got = emulate(torch.full_like(r, float("nan")), r, indptr, staged._src,
                  small, edge_w=staged._mult, src_w=inv, seg_off=seg_off,
                  accumulate=False)
    want = gather.index_spmv_level_plain(r, indptr, staged._seg_off[depth:],
                                         staged._src, staged._mult, inv)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-9)


def test_probe_schedule_line():
    """The gather probe's work-list line on the skewed CSR."""
    from fora_tpu_torch.probes import gather_probe
    indptr, _, _, _ = _skewed_csr()
    line = gather_probe.schedule_line(indptr, 512)
    assert "3000 rows -> 3009 tasks" in line
    assert "1 rows split into 10 partial slots" in line
    assert line.endswith("longest task 500 edges, longest row 5000")
