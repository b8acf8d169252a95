"""The frontier exchange of fora_tpu_torch's sharded push against
fora_tpu's, on the CPU.

  - ``needed_masks``, ``needed_host_masks`` and ``host_groups`` of the
    port's ``parallel.partition`` array-equal to the JAX package's, on an
    RMAT and an ER graph, with and without the hub split;
  - each mode's plain exchange (``ops.exchange.FrontierExchange`` over CPU
    shards: the compaction's plain version, the slot arrays, P3's plain
    version) against ``fora_tpu.parallel.sharded._frontier_exchange``
    under ``shard_map`` on the conftest's virtual CPU devices, every
    shard's buffer equal bit for bit (the unneeded rows of the routed and
    hier exchanges are zero in both);
  - the overflow to the dense exchange at ``cap`` + 1 rows and none at
    ``cap`` or ``cap`` - 1, in both packages;
  - the copies of a mesh whose shards sit on several devices (the same
    buffers as the one-device layout);
  - ``hier_ici_bytes_model`` and ``exchange_cap`` equal to JAX's.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from fora_tpu.graph import generators
from fora_tpu.parallel import make_mesh as jax_make_mesh
from fora_tpu.parallel import partition as jpart
from fora_tpu.parallel import sharded as jsharded
from fora_tpu.parallel.mesh import GRAPH_AXIS, shard_map
from fora_tpu_torch.ops import exchange as xops
from fora_tpu_torch.ops.gather import row_scatter_add, row_scatter_add_plain
from fora_tpu_torch.parallel import partition as tpart

torch.set_num_threads(2)
P = jax.sharding.PartitionSpec


def _graph(name):
    if name == "rmat":
        return generators.rmat(10, 8 * 1024, seed=3)
    return generators.erdos_renyi(300, 3000, seed=21)


@pytest.mark.parametrize("hub_rows", [0, 32])
@pytest.mark.parametrize("name", ["rmat", "er"])
@pytest.mark.parametrize("G", [2, 4])
def test_needed_masks_match_jax(name, hub_rows, G):
    g = _graph(name)
    jpg = jpart.partition_rows(g, G, hub_rows=hub_rows)
    tpg = tpart.partition_rows(g, G, hub_rows=hub_rows)
    assert tpg.hub_split == (hub_rows > 0)
    want = jpart.needed_masks(jpg)
    got = tpart.needed_masks(tpg)
    assert got.dtype == want.dtype == bool
    np.testing.assert_array_equal(got, want)
    for c in (1, 2):
        np.testing.assert_array_equal(tpart.needed_host_masks(tpg, c),
                                      jpart.needed_host_masks(jpg, c))
    # the hub split routes the same sources as the unsplit partition
    np.testing.assert_array_equal(
        got, tpart.needed_masks(tpart.partition_rows(g, G)))


@pytest.mark.parametrize("G,C", [(2, 1), (4, 2), (8, 2), (8, 4)])
def test_host_groups_match_jax(G, C):
    assert tpart.host_groups(G, C) == jpart.host_groups(G, C)
    with pytest.raises(ValueError):
        tpart.needed_host_masks(tpart.partition_rows(_graph("er"), 4), 3)


def test_bytes_models_match_jax():
    for B, G, cap, C in ((128, 8, 1024, 4), (64, 4, 64, 2), (8, 2, 16, 1)):
        assert xops.hier_ici_bytes_model(batch=B, G=G, cap=cap,
                                         chips_per_host=C) == \
            jsharded.hier_ici_bytes_model(batch=B, G=G, cap=cap,
                                          chips_per_host=C)
    for n_loc in (8, 100, 512, 131072):
        for frac in (0.125, 0.05, 0.5):
            want = max(64, int(n_loc * frac) // 8 * 8)
            assert xops.exchange_cap(n_loc, frac) == want


def _contrib(G, n_loc, B, active, seed):
    """[G * n_loc, B] f32: ``active[h]`` rows of shard h non-zero (some in
    one column only), the rest zero."""
    rng = np.random.default_rng(seed)
    c = np.zeros((G * n_loc, B), np.float32)
    for h in range(G):
        rows = rng.choice(n_loc, active[h], replace=False) + h * n_loc
        for j, r in enumerate(rows):
            if j % 3 == 0:
                c[r, rng.integers(B)] = rng.uniform(0.1, 1.0)
            else:
                c[r] = rng.uniform(0.0, 1.0, B) * (rng.random(B) < 0.7)
                c[r, 0] = 0.5
    return c


def _needed(G, n_loc, mode, C, seed):
    """(the JAX package's [G * D, n_loc] mask, the port's per-shard [D,
    n_loc] uint8 blocks or None); D = G routed, G / C hier."""
    if mode not in ("routed", "hier"):
        return np.zeros((G, 1), bool), None
    need = np.random.default_rng(seed).random((G, G, n_loc)) < 0.4
    if mode == "hier":
        need = need.reshape(G, G // C, C, n_loc).any(axis=2)
    D = need.shape[1]
    return (need.reshape(G * D, n_loc),
            [torch.as_tensor(need[h].astype(np.uint8)) for h in range(G)])


def _jax_exchange(contrib, needed, mode, cap, G, n_loc, C):
    mesh = jax_make_mesh(G, 1, devices=jax.devices()[:G])
    fn = functools.partial(
        jsharded._frontier_exchange, mode=mode, cap=cap, n_loc=n_loc,
        n_pad=G * n_loc, G=G,
        host_groups=jpart.host_groups(G, C) if mode == "hier" else None)
    mapped = shard_map(lambda c, nd: fn(c, needed=nd), mesh,
                       in_specs=(P(GRAPH_AXIS), P(GRAPH_AXIS)),
                       out_specs=P(GRAPH_AXIS))
    out = jax.jit(mapped)(contrib, needed)
    return np.asarray(out).reshape(G, G * n_loc, contrib.shape[1])


def _port_exchange(contrib, needed, mode, cap, G, n_loc, C,
                   one_device=True):
    xch = xops.FrontierExchange(mode, [torch.device("cpu")] * G, n_loc, cap,
                                needed, C if mode == "hier" else None)
    xch.one_device = one_device
    B = contrib.shape[1]
    bufs = xch.buffers(B)
    for h in range(G):
        bufs[h].fill_(float("nan"))
        bufs[h][h * n_loc:(h + 1) * n_loc] = torch.as_tensor(
            contrib[h * n_loc:(h + 1) * n_loc])
    counts = None
    if xch.D:
        cnt = [torch.zeros(xch.D, dtype=torch.int32) for _ in range(G)]
        xch.send(bufs, cnt)
        counts = np.stack([c.numpy() for c in cnt])
    xch.exchange(bufs, counts)
    return np.stack([b.numpy() for b in bufs]), xch, counts


@pytest.mark.parametrize("mode,G,C", [("dense", 4, 1), ("compact", 2, 1),
                                      ("compact", 4, 1), ("routed", 2, 1),
                                      ("routed", 4, 1), ("hier", 4, 2),
                                      ("hier", 8, 2), ("hier", 8, 4)])
def test_exchange_matches_jax(mode, G, C):
    n_loc, B, cap = 64, 8, 24
    active = [(5 * h + 3) % 20 for h in range(G)]
    contrib = _contrib(G, n_loc, B, active, seed=G)
    jneed, tneed = _needed(G, n_loc, mode, C, seed=G + 1)
    want = _jax_exchange(contrib, jneed, mode, cap, G, n_loc, C)
    got, xch, _ = _port_exchange(contrib, tneed, mode, cap, G, n_loc, C)
    assert not np.isnan(got).any()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    if mode != "dense":
        assert (xch.compacted, xch.fell_back) == (1, 0)


@pytest.mark.parametrize("mode,C", [("compact", 1), ("routed", 1),
                                    ("hier", 2)])
@pytest.mark.parametrize("extra", [-1, 0, 1])
def test_overflow_falls_back_to_dense(mode, C, extra):
    """A shard with cap + 1 rows due to one destination sends the whole
    superstep through the ring; at cap and cap - 1 it stays compacted."""
    G, n_loc, B, cap = 4, 64, 8, 16
    contrib = _contrib(G, n_loc, B, [cap + extra, 3, 0, 7], seed=9)
    jneed, tneed = _needed(G, n_loc, mode, C, seed=10)
    if tneed is not None:
        # shard 0's active rows are all due to destination 1
        rows = np.nonzero(np.abs(contrib[:n_loc]).sum(axis=1))[0]
        tneed[0][1, rows] = 1
        D = tneed[0].shape[0]
        jneed[1, rows] = True
        assert jneed.shape == (G * D, n_loc)
    want = _jax_exchange(contrib, jneed, mode, cap, G, n_loc, C)
    got, xch, counts = _port_exchange(contrib, tneed, mode, cap, G, n_loc, C)
    assert counts.max() == cap + extra
    over = extra > 0
    assert (xch.compacted, xch.fell_back) == ((0, 1) if over else (1, 0))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    if over:   # the dense exchange: every row of every block
        for h in range(G):
            np.testing.assert_array_equal(got[h], contrib)


@pytest.mark.parametrize("mode,C", [("compact", 1), ("routed", 1),
                                    ("hier", 2)])
def test_exchange_copies_across_devices(mode, C):
    """The copies that shards on several devices take (all-to-all,
    all-gather, the two hier stages) fill the same buffers as the
    one-device slot layout."""
    G, n_loc, B, cap = 4, 64, 8, 24
    contrib = _contrib(G, n_loc, B, [11, 0, 19, 4], seed=3)
    _, tneed = _needed(G, n_loc, mode, C, seed=4)
    one, _, _ = _port_exchange(contrib, tneed, mode, cap, G, n_loc, C)
    many, xch, _ = _port_exchange(contrib, tneed, mode, cap, G, n_loc, C,
                                  one_device=False)
    assert xch.compacted == 1
    np.testing.assert_array_equal(one.view(np.uint32), many.view(np.uint32))


def test_compaction_plain_rows_in_order():
    """The compaction's plain version: the rows due to each destination in
    row order (jnp.nonzero's), their global ids, the counts past cap, pads
    in the unused id slots; P3's plain version skips the pads."""
    n_loc, B, cap, row0, pad = 32, 4, 5, 64, 96
    contrib = torch.zeros(n_loc, B)
    active = [1, 2, 7, 9, 10, 20, 31]
    for i in active:
        contrib[i, i % B] = float(i)
    contrib[4, 0] = -0.0      # a negative zero is no entry
    needed = torch.zeros(2, n_loc, dtype=torch.uint8)
    needed[0, [2, 9, 30]] = 1
    needed[1] = 1
    ids = torch.full((2, cap), -7, dtype=torch.int32)
    rows = torch.zeros(2, cap, B)
    counts = torch.zeros(2, dtype=torch.int32)
    xops.frontier_compact(contrib, needed, cap, row0, pad, ids, rows, counts)
    assert counts.tolist() == [2, len(active)]
    assert ids[0].tolist() == [row0 + 2, row0 + 9, pad, pad, pad]
    assert ids[1].tolist() == [row0 + i for i in active[:cap]]
    torch.testing.assert_close(rows[1], contrib[active[:cap]], rtol=0,
                               atol=0)
    acc = torch.zeros(96, B)
    row_scatter_add(acc, rows[0], torch.arange(cap, dtype=torch.int32),
                    ids[0])
    want = torch.zeros(96, B)
    want[[row0 + 2, row0 + 9]] = contrib[[2, 9]]
    assert torch.equal(acc, want)
    # the plain P3 also skips a negative destination
    acc2 = row_scatter_add_plain(torch.zeros(3, 2), torch.ones(3, 2),
                                 torch.tensor([0, 1, 2]),
                                 torch.tensor([-1, 1, 3]))
    assert acc2.tolist() == [[0, 0], [1, 1], [0, 0]]


def test_refusals():
    with pytest.raises(NotImplementedError, match="ROADMAP C5"):
        xops.FrontierExchange("ragged", [torch.device("cpu")] * 2, 8, 4)
    with pytest.raises(ValueError):
        xops.FrontierExchange("hier", [torch.device("cpu")] * 4, 8, 4,
                              None, 3)
    with pytest.raises(ValueError):
        xops.FrontierExchange("routed", [torch.device("cpu")] * 2, 8, 0)
