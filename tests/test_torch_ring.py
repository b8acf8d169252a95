"""fora_tpu_torch's ring collectives (P1, P2) against fora_tpu's Pallas
kernels and XLA's collectives, on the CPU.

The JAX side runs exactly as tests/test_sharded_ring.py runs it: the
Pallas kernels in interpret mode under ``shard_map`` on a 1-axis mesh of
virtual CPU devices.  The port's side is the plain hop loop over a list of
per-shard tensors, and the plain one-pass reduce-scatter that shards on
one device take.  Tolerances: the all-gather copies, so it is equal; the
reduce-scatter adds in the Pallas kernel's order (received partial + own
block, ring order), so it is expected equal, held to rtol 1e-6 / atol
1e-7; the one pass adds in the same order, so it equals the hop loop bit
for bit (``torch.equal``); against ``psum_scatter``, which sums in another
order, rtol 1e-5 / atol 1e-5 as in test_sharded_ring.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fora_tpu.ops import ring as jring
from fora_tpu.parallel.mesh import shard_map
from fora_tpu_torch import kernels
from fora_tpu_torch.ops import ring

torch.set_num_threads(2)

P = jax.sharding.PartitionSpec
SHAPES = [(16, 4), (64, 128)]


def _mesh(G):
    return jax.sharding.Mesh(np.asarray(jax.devices()[:G]), ("x",))


def _gather_bufs(blocks, fill=np.nan):
    """Per shard h, an [G * n_loc, B] buffer with its own block in place
    and ``fill`` elsewhere."""
    G, n_loc, B = blocks.shape
    bufs = []
    for h in range(G):
        b = np.full((G * n_loc, B), fill, np.float32)
        b[h * n_loc:(h + 1) * n_loc] = blocks[h]
        bufs.append(torch.from_numpy(b))
    return bufs


@pytest.mark.parametrize("n_loc,B", SHAPES)
@pytest.mark.parametrize("G", [2, 4, 8])
def test_all_gather_matches_pallas(G, n_loc, B):
    x = np.random.default_rng(G * 100 + B).standard_normal(
        (G * n_loc, B)).astype(np.float32)
    # each shard's gathered [G * n_loc, B], stacked over shards
    want = np.asarray(shard_map(
        lambda v: jring.ring_all_gather(v, "x", G, interpret=True),
        _mesh(G), in_specs=P("x"), out_specs=P("x"))(x))
    got = ring.ring_all_gather_plain(_gather_bufs(x.reshape(G, n_loc, B)))
    for h in range(G):
        np.testing.assert_array_equal(
            got[h].numpy(), want[h * G * n_loc:(h + 1) * G * n_loc])


@pytest.mark.parametrize("n_loc,B", SHAPES)
@pytest.mark.parametrize("G", [2, 4, 8])
def test_reduce_scatter_matches_pallas(G, n_loc, B):
    x = np.random.default_rng(G * 10 + B).standard_normal(
        (G * G * n_loc, B)).astype(np.float32)
    want = np.asarray(shard_map(
        lambda v: jring.ring_reduce_scatter(v, "x", G, interpret=True),
        _mesh(G), in_specs=P("x"), out_specs=P("x"))(x))
    xs = [torch.from_numpy(a) for a in x.reshape(G, G * n_loc, B)]
    got = ring.ring_reduce_scatter_plain(xs)
    for h in range(G):
        assert got[h].shape == (n_loc, B)
        np.testing.assert_allclose(got[h].numpy(),
                                   want[h * n_loc:(h + 1) * n_loc],
                                   rtol=1e-6, atol=1e-7)


def _partials(G, n_loc, B, seed):
    """G full-length [G * n_loc, B] partials, as one numpy array (the
    shards' partials stacked along rows) and as the port's list."""
    x = np.random.default_rng(seed).standard_normal(
        (G * G * n_loc, B)).astype(np.float32)
    return x, [torch.from_numpy(a) for a in x.reshape(G, G * n_loc, B)]


@pytest.mark.parametrize("n_loc,B", SHAPES)
@pytest.mark.parametrize("G", [2, 4, 8])
def test_onepass_plain_equals_ring_plain(G, n_loc, B):
    """The one pass sums in the hops' order: bit-equal to the hop loop,
    returned as row blocks of one tensor."""
    _, xs = _partials(G, n_loc, B, seed=G * 7 + B)
    want = ring.ring_reduce_scatter_plain(xs)
    got = ring.reduce_scatter_onepass_plain(xs)
    assert len(got) == G
    for h in range(G):
        assert got[h].shape == (n_loc, B)
        assert torch.equal(got[h], want[h])
        assert got[h].data_ptr() == got[0].data_ptr() + h * n_loc * B * 4
    # the dispatcher takes the one pass for shards on one device
    for a, b in zip(ring.ring_reduce_scatter(xs), got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_loc,B", SHAPES)
@pytest.mark.parametrize("G", [2, 4, 8])
def test_onepass_matches_pallas(G, n_loc, B):
    x, xs = _partials(G, n_loc, B, seed=G * 10 + B)
    want = np.asarray(shard_map(
        lambda v: jring.ring_reduce_scatter(v, "x", G, interpret=True),
        _mesh(G), in_specs=P("x"), out_specs=P("x"))(x))
    got = ring.reduce_scatter_onepass(xs)
    for h in range(G):
        np.testing.assert_allclose(got[h].numpy(),
                                   want[h * n_loc:(h + 1) * n_loc],
                                   rtol=1e-6, atol=1e-7)


def test_onepass_single_shard_and_refusals():
    x = torch.ones(8, 4)
    assert ring.reduce_scatter_onepass_plain([x])[0] is x
    assert ring.reduce_scatter_onepass([x])[0] is x
    before = kernels.launch_counts()
    with pytest.raises(ValueError):       # unequal blocks
        ring.reduce_scatter_onepass_plain([torch.zeros(4, 2),
                                           torch.zeros(6, 2)])
    with pytest.raises(ValueError):
        ring.reduce_scatter_onepass([torch.zeros(4, 2), torch.zeros(6, 2)])
    with pytest.raises(ValueError):       # not G * n_loc rows
        ring.reduce_scatter_onepass([torch.zeros(5, 2), torch.zeros(5, 2)])
    # the kernel wrapper takes CUDA tensors only
    with pytest.raises(ValueError):
        kernels.reduce_scatter_onepass(torch.zeros(4, 2),
                                       [torch.zeros(4, 2)] * 2)
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("G", [2, 4, 8])
def test_ring_matches_xla_collectives(G):
    n_loc, B = 16, 8
    rng = np.random.default_rng(G)
    x = rng.standard_normal((G * n_loc, B)).astype(np.float32)
    gathered = ring.ring_all_gather(_gather_bufs(x.reshape(G, n_loc, B)))
    want_g = np.asarray(shard_map(
        lambda v: jax.lax.all_gather(v, "x", axis=0, tiled=True),
        _mesh(G), in_specs=P("x"), out_specs=P("x"))(x))
    for h in range(G):
        np.testing.assert_allclose(
            gathered[h].numpy(), want_g[h * G * n_loc:(h + 1) * G * n_loc],
            rtol=1e-5, atol=1e-5)
    y = rng.standard_normal((G * G * n_loc, B)).astype(np.float32)
    want_s = np.asarray(shard_map(
        lambda v: jax.lax.psum_scatter(v, "x", scatter_dimension=0,
                                       tiled=True),
        _mesh(G), in_specs=P("x"), out_specs=P("x"))(y))
    got = ring.ring_reduce_scatter(
        [torch.from_numpy(a) for a in y.reshape(G, G * n_loc, B)])
    np.testing.assert_allclose(torch.cat(got).numpy(), want_s, rtol=1e-5,
                               atol=1e-5)


def test_ring_exchange_pipeline_matches_xla():
    """test_sharded_ring.py's push-like step: gather the full
    contributions, every shard produces mass for all rows, reduce-scatter
    back to the owners; the port's ring against XLA's collectives."""
    G, n_loc, B = 8, 16, 4
    contrib = np.asarray(jax.random.normal(jax.random.key(0),
                                           (G * n_loc, B)))

    def xla_step(c_loc):
        full = jax.lax.all_gather(c_loc, "x", axis=0, tiled=True)
        produced = jnp.roll(full, 1, axis=0) * 0.5
        return jax.lax.psum_scatter(produced, "x", scatter_dimension=0,
                                    tiled=True)

    want = np.asarray(shard_map(xla_step, _mesh(G), in_specs=P("x"),
                                out_specs=P("x"))(contrib))
    full = ring.ring_all_gather(_gather_bufs(contrib.reshape(G, n_loc, B)))
    produced = [torch.roll(f, 1, dims=0) * 0.5 for f in full]
    got = torch.cat(ring.ring_reduce_scatter(produced)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_single_shard_is_identity():
    x = torch.ones(8, 4)
    assert ring.ring_all_gather([x])[0] is x
    assert ring.ring_reduce_scatter([x])[0] is x
    assert ring.ring_reduce_scatter_plain([x])[0] is x


def test_ring_refuses_bad_inputs():
    before = kernels.launch_counts()
    with pytest.raises(ValueError):       # not G * n_loc rows
        ring.ring_all_gather([torch.zeros(5, 2), torch.zeros(5, 2)])
    with pytest.raises(ValueError):       # unequal shapes
        ring.ring_reduce_scatter([torch.zeros(4, 2), torch.zeros(6, 2)])
    # the kernel wrappers take CUDA tensors only: no CPU fallback there
    with pytest.raises(ValueError):
        kernels.ring_all_gather_hop(torch.zeros(4, 2), torch.zeros(4, 2))
    with pytest.raises(ValueError):
        kernels.ring_reduce_scatter_hop(torch.zeros(4, 2), torch.zeros(4, 2),
                                        torch.zeros(4, 2))
    assert kernels.launch_counts() == before
