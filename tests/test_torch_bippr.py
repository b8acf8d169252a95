"""BiPPR in fora_tpu_torch against fora_tpu, on the CPU: the backward push
(p, r and supersteps at rtol 1e-5, atol 1e-7) on a graph without dangling
nodes, one with them and a weighted one; the invariant pi(s, t) = p_t(s) +
sum_v pi(s, v) r_t(v) against the exact oracle; the K1-back pre-pass's
plain version bit-equal to JAX's superstep arithmetic; the walk term as a
gather against the [W, S, T] mean it replaces; and pair estimates against
exact PPR, as tests/test_bippr.py holds JAX."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fora_tpu.algo import bippr as jax_bippr
from fora_tpu.algo import exact as jax_exact
from fora_tpu.config import ForaConfig as JaxForaConfig
from fora_tpu.graph import generators as jax_generators
from fora_tpu.graph import to_device as jax_to_device
from fora_tpu_torch import ForaConfig, convert
from fora_tpu_torch.algo import bippr, exact
from fora_tpu_torch.graph import from_edges, generators, to_device
from fora_tpu_torch.ops import walk

torch.set_num_threads(2)


def _weighted_rmat(n_log2=9, m=4096, seed=7):
    """An RMAT multigraph with dangling nodes, weighted exp2(U(-2, 2))."""
    g0 = generators.rmat(n_log2, m, seed=seed)
    src = np.repeat(np.arange(g0.n), g0.out_deg)
    w = np.exp2(np.random.default_rng(seed + 31).uniform(-2, 2, g0.m))
    return from_edges(src, g0.out_indices, g0.n, w=w.astype(np.float32))


GRAPHS = {
    "karate": (jax_generators.karate_club, [0, 33, 5]),
    "er_dangling": (lambda: jax_generators.erdos_renyi(64, 120, seed=7),
                    None),
    "weighted_rmat": (_weighted_rmat, [1, 2, 3, 77]),
}


def _graph(name):
    make, targets = GRAPHS[name]
    g = make()
    if targets is None:   # a dangling target and an ordinary one
        dang = int(np.nonzero(np.asarray(g.out_deg) == 0)[0][0])
        targets = [3, dang]
    return g, np.asarray(targets)


def _ppr_matrix(g):
    """P[s, v] = pi(s, v), float64, by the port's oracle (w/W on a
    weighted graph)."""
    return exact.exact_ppr_batch(g, np.arange(g.n), device="cpu").numpy().T


@pytest.mark.parametrize("name", list(GRAPHS))
@pytest.mark.parametrize("rmax_b", [1e-3, 1e-4])
def test_backward_push_matches_jax(name, rmax_b):
    g, targets = _graph(name)
    if name == "er_dangling":
        assert (np.asarray(g.out_deg) == 0).any()
    st = bippr.backward_push(to_device(g, device="cpu"), targets,
                             rmax_b=rmax_b, alpha=0.2)
    jst = jax_bippr.backward_push(jax_to_device(g),
                                  jnp.asarray(targets, jnp.int32),
                                  rmax_b=rmax_b, alpha=0.2)
    assert st.iters == int(jst.iters) > 0
    np.testing.assert_allclose(st.p.numpy(), np.asarray(jst.p), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(st.r.numpy(), np.asarray(jst.r), rtol=1e-5,
                               atol=1e-7)
    assert float(st.r.max()) <= rmax_b
    # the converter carries JAX's state over as it is
    cst = convert.backward_push_state_from_numpy(jst, device="cpu")
    assert cst.iters == st.iters and cst.p.dtype == torch.float32
    np.testing.assert_array_equal(cst.r.numpy(), np.asarray(jst.r))


@pytest.mark.parametrize("name", list(GRAPHS))
def test_backward_push_invariant(name):
    g, targets = _graph(name)
    P = _ppr_matrix(g)
    st = bippr.backward_push(to_device(g, device="cpu"), targets,
                             rmax_b=1e-4, alpha=0.2)
    p, r = st.p.double().numpy(), st.r.double().numpy()
    np.testing.assert_allclose(p + P @ r, P[:, targets], atol=1e-5)


def test_backward_push_stops_at_max_iters():
    g, targets = _graph("karate")
    st = bippr.backward_push(to_device(g, device="cpu"), targets,
                             rmax_b=1e-6, alpha=0.2, max_iters=3)
    assert st.iters == 3 and float(st.r.max()) > 1e-6


def test_backward_prepass_plain_matches_jax_body():
    """The plain K1-back pre-pass, bit for bit the f32 arithmetic of JAX's
    superstep body (dangling rows settle everything and spread (1-a)/a)."""
    rng = np.random.default_rng(3)
    n, T, rmax_b, alpha = 500, 7, 0.3, 0.2
    r = rng.random((n, T), dtype=np.float32)
    p = rng.random((n, T), dtype=np.float32)
    deg = rng.integers(0, 3, n).astype(np.int32)
    assert (deg == 0).any()
    pt, spread = torch.tensor(p), torch.empty(n, T)
    bippr.backward_prepass(pt, torch.tensor(r), spread, rmax_b,
                           torch.tensor(deg), alpha)
    ar = jnp.where(jnp.asarray(r) > rmax_b, jnp.asarray(r), 0.0)
    dang = jnp.asarray(deg == 0)[:, None]
    want_p = jnp.asarray(p) + jnp.where(dang, ar, alpha * ar)
    want_s = jnp.where(dang, (1.0 - alpha) / alpha * ar, (1.0 - alpha) * ar)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(spread.numpy(), np.asarray(want_s))


@pytest.mark.parametrize("weighted", [False, True])
def test_backward_edge_weights(weighted):
    g = _weighted_rmat() if weighted else generators.rmat(9, 4096, seed=7)
    dg = to_device(g, device="cpu")
    w = bippr.backward_edge_weights(dg).numpy()
    src = np.repeat(np.arange(g.n), g.out_deg)
    if weighted:
        wsum = np.bincount(src, weights=g.out_w.astype(np.float64),
                           minlength=g.n)
        np.testing.assert_allclose(w, g.out_w / wsum[src], rtol=1e-6)
    else:
        np.testing.assert_array_equal(w, np.float32(1.0) /
                                      g.out_deg[src].astype(np.float32))
    np.testing.assert_allclose(np.bincount(src, weights=w, minlength=g.n),
                               (g.out_deg > 0).astype(float), rtol=1e-5)


def test_walk_term_gather_equals_mean_over_walks():
    """add_walk_term (the endpoint histogram as a CSR, gathered) against
    the [W, S, T] mean of JAX's formulation, on the same endpoints."""
    rng = np.random.default_rng(8)
    n, T, S, W = 300, 5, 4, 2000
    r = torch.tensor(rng.random((n, T), dtype=np.float32))
    ends = torch.tensor(rng.integers(0, 40, (W, S)).astype(np.int32))
    got = bippr.add_walk_term(torch.zeros(S, T), r, ends, 1.0 / W)
    want = r.double()[ends.long()].mean(dim=0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-8)


def test_default_params_match_jax():
    for n, m in ((34, 156), (1 << 19, 1 << 23)):
        ours = bippr.default_bippr_params(
            ForaConfig(epsilon=0.5).resolved(n, m))
        theirs = jax_bippr.default_bippr_params(
            JaxForaConfig(epsilon=0.5).resolved(n, m))
        assert ours == theirs


@pytest.mark.parametrize("name", ["karate", "weighted_rmat"])
def test_bippr_pair_estimates(name):
    """Pairs against exact PPR (w/W on the weighted graph) within rtol 0.15
    and atol 1e-3, as tests/test_bippr.py holds JAX's."""
    g, _ = _graph(name)
    dg = to_device(g, device="cpu")
    rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
    P = _ppr_matrix(g)
    sources, targets = [0, 5], [33 if name == "karate" else 7, 2]
    est = bippr.bippr_pairs(dg, sources, targets, 0, rcfg=rcfg,
                            rmax_b=1e-3, num_walks=20_000).numpy()
    truth = P[np.ix_(sources, targets)]
    np.testing.assert_allclose(est, truth, rtol=0.15, atol=1e-3)


def test_bippr_walks_in_chunks(monkeypatch):
    """With a lane budget of 4096 the 20,000 walks per source run in
    chunks of 2048; the estimate stays within the same tolerance."""
    g, _ = _graph("karate")
    dg = to_device(g, device="cpu")
    rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
    P = _ppr_matrix(g)
    calls = []
    real = bippr.add_walk_term

    def counted(acc, r, ends, scale):
        calls.append(ends.shape)
        return real(acc, r, ends, scale)
    monkeypatch.setattr(walk, "CPU_LANE_BUDGET", 4096)
    monkeypatch.setattr(bippr, "add_walk_term", counted)
    est = bippr.bippr_pairs(dg, [0, 5], [33, 2], 1, rcfg=rcfg, rmax_b=1e-3,
                            num_walks=20_000).numpy()
    assert calls == [(2048, 2)] * 9 + [(20_000 - 9 * 2048, 2)]
    np.testing.assert_allclose(est, P[np.ix_([0, 5], [33, 2])], rtol=0.15,
                               atol=1e-3)


def test_make_bippr_fn_ssppr_topk():
    """make_bippr_fn against every node answers SSPPR top-5 at precision
    0.8 (the CLI's --algo bippr surface); the push runs once and is kept."""
    from fora_tpu_torch.eval import metrics
    g = jax_generators.karate_club()
    dg = to_device(g, device="cpu")
    rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
    fn = bippr.make_bippr_fn(dg, rcfg, np.arange(g.n), num_walks=8192)
    est = fn(np.array([0, 33]), 1).numpy()
    state = fn.state
    assert est.shape == (2, g.n) and state is not None
    fn(np.array([1]), 2)
    assert fn.state is state
    precs = []
    for i, s in enumerate((0, 33)):
        pred = np.argsort(-est[i])[:5]
        ex = np.argsort(-jax_exact.exact_ppr_dense(g, s))[:5]
        precs.append(metrics.precision_at_k(pred, ex))
        assert metrics.recall_at_k(pred, ex) == precs[-1]
    assert np.mean(precs) >= 0.8


def test_jax_state_feeds_port_pairs():
    """bippr_pairs given JAX's backward push state estimates as with the
    port's own (the walk term is the port's in both)."""
    g, targets = _graph("karate")
    dg = to_device(g, device="cpu")
    rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
    jst = jax_bippr.backward_push(jax_to_device(g),
                                  jnp.asarray(targets, jnp.int32),
                                  rmax_b=1e-3, alpha=0.2)
    state = convert.backward_push_state_from_numpy(jst, device="cpu")
    a = bippr.bippr_pairs(dg, [4, 9], targets, 5, rcfg=rcfg, rmax_b=1e-3,
                          num_walks=4096, state=state)
    b = bippr.bippr_pairs(dg, [4, 9], targets, 5, rcfg=rcfg, rmax_b=1e-3,
                          num_walks=4096)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-6)
