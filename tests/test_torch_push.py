"""fora_tpu_torch.ops.push against fora_tpu.ops.push on the same inputs.

Mirrors tests/test_push.py.  Tolerances: rtol 1e-5, atol 1e-8 on p and r
(f32 sums taken in another order: index_add_ edge by edge against XLA's
scatter-add); the superstep count must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fora_tpu.algo import exact
from fora_tpu.graph import generators
from fora_tpu.graph import to_device as jax_to_device
from fora_tpu.graph.csr import CSRGraph, from_edges
from fora_tpu.ops import push as jax_push
from fora_tpu_torch import convert
from fora_tpu_torch.graph import to_device
from fora_tpu_torch.ops import push

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-8


def _smoke_graph() -> CSRGraph:
    z = np.load("bench_data_smoke/rmat12x8s7.npz")
    return CSRGraph(**{k: z[k] for k in CSRGraph._fields if k in z.files})


def _multigraph() -> CSRGraph:
    rng = np.random.default_rng(11)
    n, m = 64, 512
    src = rng.integers(0, n, size=m)
    dst = rng.integers(0, n, size=m)
    return from_edges(np.concatenate([src, src[:200]]),
                      np.concatenate([dst, dst[:200]]), n)


def _compare(jst, tst):
    np.testing.assert_allclose(tst.p.numpy(), np.asarray(jst.p),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tst.r.numpy(), np.asarray(jst.r),
                               rtol=RTOL, atol=ATOL)
    assert tst.iters == int(jst.iters)


@pytest.mark.parametrize("graph", ["smoke", "multigraph", "star"])
@pytest.mark.parametrize("merge", [False, True])
@pytest.mark.parametrize("hub_rows", [0, 16])
def test_forward_push_matches_jax(graph, merge, hub_rows):
    g = {"smoke": _smoke_graph, "multigraph": _multigraph,
         "star": lambda: generators.star_graph(40)}[graph]()
    rng = np.random.default_rng(5)
    src = rng.choice(g.n, size=6, replace=False).astype(np.int32)
    rmax = 1e-4
    jst = jax_push.forward_push(
        jax_to_device(g, merge_duplicate_edges=merge, hub_rows=hub_rows),
        jnp.asarray(src), rmax=rmax, alpha=0.2)
    tst = push.forward_push(
        to_device(g, merge_duplicate_edges=merge, hub_rows=hub_rows,
                  device="cpu"),
        torch.as_tensor(src), rmax=rmax, alpha=0.2)
    _compare(jst, tst)


@pytest.mark.parametrize("hub_rows", [0, 256])
def test_forward_push_from_per_node_thr_matches_jax(hub_rows):
    """Resume from a mid-push state with a per-node threshold (the indexed
    path's coverage threshold); dangling rows included."""
    g = _smoke_graph()
    rng = np.random.default_rng(7)
    B = 8
    src = rng.choice(np.nonzero(g.out_deg)[0], size=B).astype(np.int32)
    jg = jax_to_device(g, merge_duplicate_edges=True, hub_rows=hub_rows)
    st0 = jax_push.forward_push(jg, jnp.asarray(src), rmax=1e-3, alpha=0.2)
    thr = (rng.integers(1, 40, g.n) / 3.4e5).astype(np.float32)
    jst = jax_push.forward_push_from(jg, st0, rmax=1e-3, alpha=0.2,
                                     thr=jnp.asarray(thr))
    tg = to_device(g, merge_duplicate_edges=True, hub_rows=hub_rows,
                   device="cpu")
    tst = push.forward_push_from(
        tg, convert.push_state_from_numpy(st0.p, st0.r, device="cpu"),
        rmax=1e-3, alpha=0.2, thr=torch.as_tensor(thr))
    _compare(jst, tst)
    assert (np.asarray(g.out_deg) == 0).any()   # dangling rows exercised


def test_superstep_matches_jax():
    g = _smoke_graph()
    src = np.arange(0, 4096, 512, dtype=np.int32)
    jg = jax_to_device(g, merge_duplicate_edges=True, hub_rows=64)
    jst = jax_push.init_state(g.n, jnp.asarray(src))
    for _ in range(3):
        jst = jax_push._superstep(jg, 1e-5, 0.2, jst)
    tg = to_device(g, merge_duplicate_edges=True, hub_rows=64, device="cpu")
    tst = push.init_state(g.n, torch.as_tensor(src))
    thr = push.node_threshold(tg, 1e-5)
    flag = torch.zeros(1, dtype=torch.int32)
    for _ in range(3):
        tst = push.superstep(tg, tst, alpha=0.2, thr=thr, flag=flag)
    _compare(jst, tst)
    assert int(flag) == 1


def test_push_terminates_below_threshold():
    g = generators.karate_club()
    rmax = 1e-3
    st = push.forward_push(to_device(g, device="cpu"),
                           torch.tensor([0, 5, 33]), rmax=rmax, alpha=0.2)
    deg = np.asarray(g.out_deg, dtype=np.float64)
    assert np.all(st.r.numpy().T <= rmax * deg + 1e-7)
    assert st.iters < 200


def test_push_conserves_mass():
    g = generators.star_graph(8)   # dangling leaves absorb
    st = push.forward_push(to_device(g, device="cpu"), torch.tensor([0, 3]),
                           rmax=1e-4, alpha=0.2)
    np.testing.assert_allclose((st.p + st.r).sum(0).numpy(), 1.0, rtol=1e-5)


def test_push_only_estimate_converges():
    g = generators.karate_club()
    est = push.push_only_estimate(to_device(g, device="cpu"),
                                  torch.tensor([0]), rmax=1e-7, alpha=0.2,
                                  max_iters=500)[:, 0].numpy()
    np.testing.assert_allclose(est, exact.exact_ppr_dense(g, 0), atol=1e-4)


def test_max_iters_caps_supersteps():
    g = _smoke_graph()
    dg = to_device(g, device="cpu")
    st = push.forward_push(dg, torch.tensor([1, 2]), rmax=1e-7, alpha=0.2,
                           max_iters=3)
    assert st.iters == 3
