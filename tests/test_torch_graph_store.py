"""The sharded graph store and the sharded index store of fora_tpu_torch
against fora_tpu's, on the CPU.

  - each package's ``save_sharded_graph`` read by the other's
    ``ShardedGraphStore``, every array of every shard equal (weighted and
    not), and equal to the in-RAM ``partition_rows`` / ``_shard_csr``;
  - each package's ``save_sharded`` index read by the other's
    ``ShardedIndexStore``, likewise;
  - the port's refinement pool from both stores bit-equal to the in-RAM
    pool (dense and routed), and from the JAX package's stores;
  - the hub split refused on a graph store, as the reference does
    (ROADMAP C5), and a store of another shard count refused.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from fora_tpu import index as jax_index
from fora_tpu.config import ForaConfig
from fora_tpu.graph import generators, to_device as jax_to_device
from fora_tpu.graph.csr import from_edges as jax_from_edges
from fora_tpu.index import store as jax_store
from fora_tpu.parallel import graph_store as jax_gs
from fora_tpu_torch import convert
from fora_tpu_torch.graph.csr import CSRGraph
from fora_tpu_torch.index import store as tstore
from fora_tpu_torch.index.build_sharded import _shard_csr
from fora_tpu_torch.parallel import (ShardedForaEngine, ShardedTopkRunner,
                                     make_mesh, partition)
from fora_tpu_torch.parallel import graph_store as tgs

torch.set_num_threads(2)
K, G = 10, 4
SOURCES = np.array([3, 17, 42, 99, 123, 200, 250, 287, 311, 399, 5, 60])


@functools.lru_cache(maxsize=None)
def setup(weighted: bool):
    g = generators.erdos_renyi(400, 4000, seed=21)
    if weighted:
        w = np.random.default_rng(5).uniform(0.5, 2.0, g.m).astype(np.float32)
        g = jax_from_edges(np.repeat(np.arange(g.n), np.diff(g.out_indptr)),
                           np.asarray(g.out_indices, np.int64), g.n, w=w)
    rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
    idx = jax_index.build_walk_index(jax_to_device(g), rcfg,
                                     jax.random.key(7))
    return g, rcfg, idx


def port_graph(g) -> CSRGraph:
    return CSRGraph(**{f: getattr(g, f) for f in CSRGraph._fields})


def assert_stores_equal(a, b):
    assert a.meta == b.meta
    for s in range(a.n_shards):
        sa, sb = a.shard(s), b.shard(s)
        assert sa.keys() == sb.keys()
        for key in sa:
            assert isinstance(sa[key], np.memmap)
            assert sa[key].dtype == sb[key].dtype, key
            np.testing.assert_array_equal(sa[key], sb[key], err_msg=key)


@pytest.mark.parametrize("weighted", [False, True])
def test_graph_store_cross_load(tmp_path, weighted):
    g, _, _ = setup(weighted)
    dj = jax_gs.save_sharded_graph(g, tmp_path / "jax", G)
    dt = tgs.save_sharded_graph(port_graph(g), tmp_path / "port", G)
    assert dj.name == dt.name == f"graph-shards-G{G}"
    assert_stores_equal(tgs.ShardedGraphStore(tmp_path / "jax", G),
                        tgs.ShardedGraphStore(tmp_path / "port", G))
    assert_stores_equal(jax_gs.ShardedGraphStore(tmp_path / "port", G),
                        jax_gs.ShardedGraphStore(tmp_path / "jax", G))
    st = tgs.ShardedGraphStore(tmp_path / "port", G)
    assert (st.n, st.m, st.weighted) == (g.n, g.m, weighted)
    pg = partition.partition_rows(g, G)
    need = partition.needed_masks(pg).reshape(G, G, pg.n_loc)
    n_loc_w, windptr, windices, _, ap, ao = _shard_csr(g, G)
    nl, ml = pg.n_loc, pg.m_loc
    assert st.n_loc == n_loc_w == nl and st.m_loc == ml
    for s in range(G):
        sh = st.shard(s)
        np.testing.assert_array_equal(sh["in_src_global"],
                                      pg.in_src_global[s * ml:(s + 1) * ml])
        np.testing.assert_array_equal(sh["needed"].astype(bool), need[s])
        np.testing.assert_array_equal(sh["walk_indices"], windices[s])
        if weighted:
            np.testing.assert_array_equal(
                sh["out_wsum"], pg.out_wsum_sharded[s * nl:(s + 1) * nl])
            np.testing.assert_array_equal(sh["alias_prob"], ap[s])
            np.testing.assert_array_equal(sh["alias_other"], ao[s])
    with pytest.raises(FileNotFoundError):
        tgs.ShardedGraphStore(tmp_path / "port", 8)


@pytest.mark.parametrize("weighted", [False, True])
def test_index_store_cross_load(tmp_path, weighted):
    g, rcfg, idx = setup(weighted)
    jax_store.save_sharded(idx, rcfg, str(tmp_path / "jax"), G, graph=g)
    tstore.save_sharded(convert.index_from_numpy(idx), rcfg,
                        str(tmp_path / "port"), G, graph=port_graph(g))
    a = tstore.ShardedIndexStore(str(tmp_path / "jax"), G, rcfg, graph=g)
    b = tstore.ShardedIndexStore(str(tmp_path / "port"), G, rcfg,
                                 graph=port_graph(g))
    assert_stores_equal(a, b)
    assert_stores_equal(
        jax_store.ShardedIndexStore(str(tmp_path / "port"), G, rcfg),
        jax_store.ShardedIndexStore(str(tmp_path / "jax"), G, rcfg))
    np.testing.assert_array_equal(a.bucket_local_offsets,
                                  b.bucket_local_offsets)
    assert a.depth_for(rcfg.omega_unit, rcfg.rmax) == \
        idx.depth_for(rcfg.omega_unit, rcfg.rmax)
    assert a.bytes_per_shard(0) == b.bytes_per_shard(0) > 0
    with pytest.raises(FileNotFoundError):
        tstore.ShardedIndexStore(str(tmp_path / "port"), 2)


def _pool(g, idx, rcfg, **kw):
    run = ShardedTopkRunner(g, make_mesh(G, devices=["cpu"] * G), rcfg, idx,
                            k=K, **kw)
    return run.query_pool(SOURCES, batch=8)


def _bit_equal(a, b):
    for f in ("node_ids", "values", "lower_bounds", "upper_bounds",
              "accepted"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    assert a.levels_used == b.levels_used


@pytest.mark.parametrize("exchange", ["dense", "routed", "hier"])
@pytest.mark.parametrize("weighted", [False, True])
def test_store_backed_pool_bit_equal(tmp_path, weighted, exchange):
    g, rcfg, idx = setup(weighted)
    pgr = port_graph(g)
    tidx = convert.index_from_numpy(idx)
    tgs.save_sharded_graph(pgr, tmp_path, G, with_walk_side=False)
    tstore.save_sharded(tidx, rcfg, str(tmp_path / "index"), G, graph=pgr)
    kw = {"exchange": exchange}
    if exchange == "hier":
        kw["chips_per_host"] = 2
    mem = _pool(pgr, tidx, rcfg, **kw)
    st = _pool(tgs.ShardedGraphStore(tmp_path, G),
               tstore.ShardedIndexStore(str(tmp_path / "index"), G, rcfg),
               rcfg, **kw)
    _bit_equal(st, mem)


def test_jax_stores_served_by_port(tmp_path):
    """The JAX package's stores, written by its save functions, serve the
    port's pool with the in-RAM pool's answers bit for bit."""
    g, rcfg, idx = setup(False)
    jax_gs.save_sharded_graph(g, tmp_path, G)
    jax_store.save_sharded(idx, rcfg, str(tmp_path / "index"), G, graph=g)
    mem = _pool(port_graph(g), convert.index_from_numpy(idx), rcfg,
                exchange="compact")
    st = _pool(tgs.ShardedGraphStore(tmp_path, G),
               tstore.ShardedIndexStore(str(tmp_path / "index"), G, rcfg),
               rcfg, exchange="compact")
    _bit_equal(st, mem)
    eng = ShardedForaEngine(tgs.ShardedGraphStore(tmp_path, G),
                            make_mesh(G, devices=["cpu"] * G), rcfg, k=K,
                            index=convert.index_from_numpy(idx))
    ref = ShardedForaEngine(port_graph(g), make_mesh(G, devices=["cpu"] * G),
                            rcfg, k=K, index=convert.index_from_numpy(idx))
    a, b = eng.topk(SOURCES[:8]), ref.topk(SOURCES[:8])
    np.testing.assert_array_equal(a.node_ids, b.node_ids)
    np.testing.assert_array_equal(a.values, b.values)
    assert a.push_iters == b.push_iters


def test_store_refusals(tmp_path):
    g, rcfg, idx = setup(False)
    tgs.save_sharded_graph(port_graph(g), tmp_path, G, with_walk_side=False)
    store = tgs.ShardedGraphStore(tmp_path, G)
    mesh = make_mesh(G, devices=["cpu"] * G)
    tidx = convert.index_from_numpy(idx)
    with pytest.raises(ValueError, match="hub_rows"):
        ShardedTopkRunner(store, mesh, rcfg, tidx, k=K, hub_rows=16)
    with pytest.raises(ValueError, match="hub_rows"):
        ShardedForaEngine(store, mesh, rcfg, k=K, index=tidx, hub_rows=16)
    with pytest.raises(ValueError, match="4-way"):
        ShardedTopkRunner(store, make_mesh(2, devices=["cpu"] * 2), rcfg,
                          tidx, k=K)
    tstore.save_sharded(tidx, rcfg, str(tmp_path / "index"), 2)
    with pytest.raises(ValueError, match="2-way"):
        ShardedTopkRunner(port_graph(g), mesh, rcfg,
                          tstore.ShardedIndexStore(str(tmp_path / "index"),
                                                   2), k=K)
