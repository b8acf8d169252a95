"""The sharded FORA+ index build of fora_tpu_torch on the CPU.

  - ``build_walk_index_sharded`` (the walks over the out-CSR's shard
    slices, K4's sharded form in its plain version here) array-equal to
    the port's ``build_walk_index`` at the same seed and chunk: edge_src,
    edge_dst, bucket_offsets, counts_cum and edge_mult, G 2 and 4 and a
    mesh with a query axis, weighted included (the contract of
    ``tests/test_build_sharded.py::test_sharded_build_bit_identical``);
  - ``sharded_build_bytes`` equal to fora_tpu's dict on the same graph;
  - the memory-wall check of ``tests/test_build_sharded.py:45-55``: a
    shard's slices fit a budget the replicated out-CSR does not.
"""

import numpy as np
import pytest
import torch

from fora_tpu import index as jax_index
from fora_tpu.graph import generators as jax_generators
from fora_tpu.graph.csr import from_edges as jax_from_edges
from fora_tpu_torch import ForaConfig
from fora_tpu_torch.graph import to_device
from fora_tpu_torch.graph.csr import CSRGraph
from fora_tpu_torch.index import (build_walk_index, build_walk_index_sharded,
                                  index_counts, sharded_build_bytes)
from fora_tpu_torch.parallel import make_mesh

torch.set_num_threads(2)

FIELDS = ("edge_src", "edge_dst", "bucket_offsets", "counts_cum",
          "edge_mult")


def _setup(n=300, m=3000, seed=21, weighted=False):
    """tests/test_build_sharded.py's graphs, in the JAX package's CSR."""
    g = jax_generators.erdos_renyi(n, m, seed=seed)
    if weighted:
        src = np.repeat(np.arange(g.n, dtype=np.int64),
                        np.asarray(g.out_deg, np.int64))
        w = np.random.default_rng(seed).uniform(0.2, 3.0, g.m)
        g = jax_from_edges(src, np.asarray(g.out_indices, np.int64), n,
                           w=w.astype(np.float32))
    return g


def port_graph(g) -> CSRGraph:
    return CSRGraph(**{f: getattr(g, f) for f in CSRGraph._fields})


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("shape", [(2, 1), (4, 1), (4, 2)])
def test_sharded_build_bit_identical(shape, weighted):
    g = port_graph(_setup(weighted=weighted))
    rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
    chunk = 1 << 11
    assert index_counts(g.out_deg, rcfg).sum() > 2 * chunk   # 3+ chunks
    want = build_walk_index(to_device(g, device="cpu"), rcfg, 9,
                            chunk_lanes=chunk)
    mesh = make_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))
    got = build_walk_index_sharded(g, mesh, rcfg, 9, chunk_lanes=chunk)
    for f in FIELDS:
        a, b = getattr(want, f), getattr(got, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), f)
    assert (got.omega_unit_built, got.rmax_built) == \
        (want.omega_unit_built, want.rmax_built)
    # another seed gives another index
    other = build_walk_index_sharded(g, mesh, rcfg, 10, chunk_lanes=chunk)
    assert not np.array_equal(other.edge_dst, got.edge_dst)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("G", [2, 8])
def test_sharded_build_bytes_matches_jax(G, weighted):
    g = _setup(n=500, m=6000, weighted=weighted)
    assert sharded_build_bytes(port_graph(g), G) == \
        jax_index.sharded_build_bytes(g, G)


def test_sharded_build_breaks_memory_wall():
    """Per-shard CSR bytes stay under a simulated per-shard budget that
    the whole out-CSR exceeds; a shard holds at most its contiguous row
    range's edges, not the whole edge list."""
    g = port_graph(_setup(n=4000, m=80000))
    stats = sharded_build_bytes(g, 8)
    budget = stats["replicated_bytes"] // 4
    assert stats["replicated_bytes"] > budget
    assert stats["per_shard_bytes"] < budget, stats
    assert stats["ratio"] < 0.5, stats
