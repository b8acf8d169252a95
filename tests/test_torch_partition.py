"""fora_tpu_torch's row partitioning against fora_tpu's, and the sharded
engine's per-shard CSRs against the edges they must hold.

``partition_rows`` and ``partition_index`` are a numpy copy of the JAX
package's: array-equal on the tracked smoke graph and its FORA+ index, and
on test_sharded.py's ER graph (n = 300, m = 3,000) with an index built by
JAX, for G in {1, 2, 4, 8}.  The engine's placement turns each shard's
padded slice into CSRs by destination; mirroring test_sharded.py:26-65,
those hold exactly the real in-edges and index edges, with no pad.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from fora_tpu import index as jax_index
from fora_tpu.config import ForaConfig
from fora_tpu.graph import generators, to_device
from fora_tpu.graph.csr import CSRGraph as JaxCSRGraph
from fora_tpu.graph.csr import from_edges as jax_from_edges
from fora_tpu.parallel import partition as jpart
from fora_tpu_torch import convert
from fora_tpu_torch.graph.csr import CSRGraph
from fora_tpu_torch.index import NUM_BUCKETS
from fora_tpu_torch.parallel import partition as tpart
from fora_tpu_torch.parallel.sharded import _ShardedPlacement

torch.set_num_threads(2)

SMOKE_IDX = "bench_data_smoke/rmat12x8s7.idx.e0.5"


def port_graph(g) -> CSRGraph:
    """The port's CSRGraph with a fora_tpu CSRGraph's arrays."""
    return CSRGraph(**{f: getattr(g, f) for f in CSRGraph._fields})


@functools.lru_cache(maxsize=None)
def graph_and_index(name):
    """(fora_tpu CSRGraph, fora_tpu WalkIndex) of a test graph."""
    if name == "smoke":
        z = np.load("bench_data_smoke/rmat12x8s7.npz")
        g = JaxCSRGraph(**{k: z[k] for k in JaxCSRGraph._fields
                           if k in z.files})
        rcfg = ForaConfig(epsilon=0.5, k=50).resolved(g.n, g.m)
        return g, jax_index.load(SMOKE_IDX, rcfg, graph=g)
    g = generators.erdos_renyi(300, 3000, seed=21)
    rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
    return g, jax_index.build_walk_index(to_device(g), rcfg,
                                         jax.random.key(2))


def assert_same_fields(got, want):
    assert type(got)._fields == type(want)._fields
    for f in type(want)._fields:
        a, b = getattr(got, f), getattr(want, f)
        if f in ("alias_prob", "alias_other"):
            continue      # the raw walk's alias tables are not ported
        if b is None or isinstance(b, (int, np.integer)):
            assert a == b, f
        else:
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=f)
            assert np.asarray(a).dtype == np.asarray(b).dtype, f


@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("name", ["smoke", "er"])
def test_partition_matches_jax(name, G):
    g, idx = graph_and_index(name)
    want = jpart.partition_rows(g, G)
    got = tpart.partition_rows(port_graph(g), G)
    assert_same_fields(got, want)
    want_i = jpart.partition_index(idx, G, want.n_loc)
    got_i = tpart.partition_index(convert.index_from_numpy(idx), G,
                                  got.n_loc)
    assert_same_fields(got_i, want_i)
    # the converters carry JAX's partitions across unchanged
    assert_same_fields(convert.partitioned_graph_from_numpy(want), want)
    assert_same_fields(convert.partitioned_index_from_numpy(want_i), want_i)


def test_partition_hub_split_and_weights_match_jax():
    """hub_rows and weighted graphs as far as partition_rows goes (per-edge
    weights and per-row out-weights; the alias tables are not ported)."""
    g, _ = graph_and_index("er")
    assert_same_fields(tpart.partition_rows(port_graph(g), 4, hub_rows=16),
                       jpart.partition_rows(g, 4, hub_rows=16))
    rng = np.random.default_rng(11)
    src = np.repeat(np.arange(g.n), np.diff(g.out_indptr))
    w = rng.uniform(0.5, 2.0, g.m).astype(np.float32)
    gw = jax_from_edges(src, np.asarray(g.out_indices, np.int64), g.n, w=w)
    for hub in (0, 16):
        want = jpart.partition_rows(gw, 4, hub_rows=hub)
        got = tpart.partition_rows(port_graph(gw), 4, hub_rows=hub)
        assert got.weighted and got.alias_prob is None
        assert_same_fields(got, want)


@pytest.mark.parametrize("G", [2, 4])
@pytest.mark.parametrize("name", ["smoke", "er"])
def test_shard_csrs_hold_exactly_the_real_edges(name, G):
    g, jidx = graph_and_index(name)
    idx = convert.index_from_numpy(jidx)
    data = _ShardedPlacement(port_graph(g), ["cpu"] * G, idx)
    n_loc, n_pad = data.n_loc, data.n_pad
    seen = []
    for s, sh in enumerate(data.shards):
        indptr = sh.in_indptr.numpy()
        assert indptr.shape == (n_loc + 1,) and indptr[-1] == len(sh.in_src)
        dst = np.repeat(np.arange(n_loc), np.diff(indptr)) + s * n_loc
        src = sh.in_src.numpy()
        assert (src < g.n).all()          # no pad source (n_pad)
        seen += list(zip(src.tolist(), dst.tolist()))
        assert np.array_equal(sh.out_deg.numpy(),
                              data.pg.out_deg[s * n_loc:(s + 1) * n_loc])
    assert sorted(seen) == sorted(zip(g.in_src.tolist(), g.in_dst.tolist()))

    mult = (np.ones(idx.total_edges, np.float32) if idx.edge_mult is None
            else idx.edge_mult)
    for q in range(NUM_BUCKETS):
        lo, hi = int(idx.bucket_offsets[q]), int(idx.bucket_offsets[q + 1])
        want = sorted(zip(idx.edge_src[lo:hi].tolist(),
                          idx.edge_dst[lo:hi].tolist(),
                          mult[lo:hi].tolist()))
        got = []
        for s, sh in enumerate(data.shards):
            if sh.buckets[q] is None:
                continue
            indptr, src, m = (None if t is None else t.numpy()
                              for t in sh.buckets[q])
            assert indptr.shape == (n_pad + 1,) and indptr[-1] == len(src)
            assert (src < n_loc).all()    # no pad source (n_loc)
            dst = np.repeat(np.arange(n_pad), np.diff(indptr))
            m = np.ones(len(src), np.float32) if m is None else m
            got += list(zip((src + s * n_loc).tolist(), dst.tolist(),
                            m.tolist()))
        assert sorted(got) == want, q
    cc = np.concatenate([sh.counts_cum.numpy() for sh in data.shards])
    np.testing.assert_array_equal(cc[:g.n], idx.counts_cum)
