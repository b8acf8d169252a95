"""fora_tpu_torch's split top-k accept and chunked top-k against fora_tpu's
``_topk_with_bounds_split`` / ``topk_rows_chunked``.

Inputs carry planted ties (quantized values), so the ids are compared
under the shared tie rule: value descending, then node id ascending.
Bounds at rtol 1e-5; ``accept`` equal except where lbk (1 + eps) and
ub_excluded lie within 1e-6 relative of each other, where f32 rounding
may flip the test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fora_tpu.algo import bounds as jax_bounds
from fora_tpu.ops import topk as jax_topk
from fora_tpu_torch.algo import bounds
from fora_tpu_torch.ops.topk import topk_rows_chunked

torch.set_num_threads(2)


def _tied_inputs(seed, n, B, scale=1.0):
    rng = np.random.default_rng(seed)
    p = (np.floor(rng.random((n, B)) * 32) / 4096 * scale).astype(np.float32)
    contrib = (np.floor(rng.random((n, B)) * 8) / 4096
               * scale).astype(np.float32)
    return p, contrib


@pytest.mark.parametrize("n,B,k", [(4096, 8, 50), (300, 3, 10), (60, 2, 50),
                                   (50, 2, 50)])
def test_topk_with_bounds_split_matches_jax(n, B, k):
    p, contrib = _tied_inputs(n + B, n, B, scale=8.0)
    omega, eps = 3.4e5, 0.5
    t = jax_bounds.union_bound_t(n, 3, 1.0 / n)
    want = [np.asarray(a) for a in jax_bounds._topk_with_bounds_split(
        jnp.asarray(p), jnp.asarray(contrib), jnp.float32(omega), k=k, t=t,
        eps=eps)]
    got = [a.numpy() for a in bounds.topk_with_bounds_split(
        torch.as_tensor(p), torch.as_tensor(contrib), omega, k, t, eps)]
    np.testing.assert_array_equal(got[1], want[1])               # ids
    for i in (0, 2, 3, 4, 5):                 # vals, lb, ub, lbk, ub_excl
        np.testing.assert_allclose(got[i], want[i], rtol=1e-5, atol=0)
    edge = np.abs(want[4] * (1 + eps) - want[5]) <= 1e-6 * np.abs(want[5])
    np.testing.assert_array_equal(got[6][~edge], want[6][~edge])


def test_accept_follows_separation():
    """At eps = 0, a planted gap at rank k accepts; ties across rank k do
    not."""
    n, B, k = 2000, 2, 10
    p = np.zeros((n, B), np.float32)
    contrib = np.full((n, B), 1e-6, np.float32)
    p[:k, 0] = 0.05          # column 0: clear gap after rank k
    p[:k + 5, 1] = 0.05      # column 1: ties across rank k
    got = bounds.topk_with_bounds_split(torch.as_tensor(p),
                                        torch.as_tensor(contrib), 1e7, k,
                                        jax_bounds.union_bound_t(n, 3, 1e-3),
                                        0.0)
    assert got[6].tolist() == [True, False]
    assert got[1].dtype == torch.int32


def test_bernstein_bounds_match_jax():
    rng = np.random.default_rng(1)
    mu = rng.random(100).astype(np.float32) * 1e-3
    c, t = np.float32(1 / 3.4e5), 20.0
    want_ub = np.asarray(jax_bounds.bernstein_ub(jnp.asarray(mu),
                                                 jnp.float32(c), t))
    want_lb = np.asarray(jax_bounds.bernstein_lb(jnp.asarray(mu),
                                                 jnp.float32(c), t))
    c_t = torch.tensor(c)
    np.testing.assert_allclose(
        bounds.bernstein_ub(torch.as_tensor(mu), c_t, t).numpy(), want_ub,
        rtol=1e-6)
    # lb = mu - s2/3 - sqrt(s2 ub) cancels: one ulp of XLA's sqrt shows as
    # ~1e-5 relative (absolute ~3e-11) in lb
    np.testing.assert_allclose(
        bounds.bernstein_lb(torch.as_tensor(mu), c_t, t).numpy(), want_lb,
        rtol=1e-5, atol=1e-10)
    assert bounds.union_bound_t(100, 4, 0.01) == \
        jax_bounds.union_bound_t(100, 4, 0.01)


@pytest.mark.parametrize("chunk", [1 << 19, 1000, 64])
def test_topk_rows_chunked_matches_jax(chunk):
    p, contrib = _tied_inputs(3, 3000, 4)
    want = [np.asarray(a) for a in jax_topk.topk_rows_chunked(
        jnp.asarray(p), 20, jnp.asarray(contrib), chunk=chunk,
        addend=jnp.asarray(contrib))]
    got = [a.numpy() for a in topk_rows_chunked(
        torch.as_tensor(p), 20, torch.as_tensor(contrib), chunk=chunk,
        addend=torch.as_tensor(contrib))]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
