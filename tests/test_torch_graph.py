"""fora_tpu_torch.graph.to_device against fora_tpu's to_device: the same
arrays, field for field, plus destination row pointers consistent with the
dst-sorted edge lists."""

import numpy as np
import pytest
import torch

from fora_tpu.graph import generators
from fora_tpu.graph import to_device as jax_to_device
from fora_tpu.graph.csr import CSRGraph, from_edges
from fora_tpu_torch import convert
from fora_tpu_torch.graph import to_device

torch.set_num_threads(2)

FIELDS = ("out_indptr", "out_indices", "in_src", "in_dst", "out_deg", "in_w",
          "out_wsum", "hub_ids", "hub_src_local", "hub_dst", "hub_w")


def _smoke_graph() -> CSRGraph:
    z = np.load("bench_data_smoke/rmat12x8s7.npz")
    return CSRGraph(**{k: z[k] for k in CSRGraph._fields if k in z.files})


def _graphs():
    return {"smoke": _smoke_graph(),
            "er": generators.erdos_renyi(1024, 8192, seed=4)}


def _jax_fields(jg) -> dict:
    return {f: None if getattr(jg, f) is None else np.asarray(getattr(jg, f))
            for f in FIELDS}


@pytest.mark.parametrize("name", ["smoke", "er"])
@pytest.mark.parametrize("merge", [False, True])
@pytest.mark.parametrize("hub_rows", [0, 256])
def test_to_device_matches_jax(name, merge, hub_rows):
    g = _graphs()[name]
    want = _jax_fields(jax_to_device(g, merge_duplicate_edges=merge,
                                     hub_rows=hub_rows))
    got = to_device(g, merge_duplicate_edges=merge, hub_rows=hub_rows,
                    device="cpu")
    for f in FIELDS:
        a = getattr(got, f)
        if want[f] is None:
            assert a is None, f
        else:
            np.testing.assert_array_equal(a.numpy(), want[f], err_msg=f)
    assert got.hub_split == (hub_rows > 0)
    hub_edges = 0 if want["hub_dst"] is None else len(want["hub_dst"])
    assert got.m_in == len(want["in_src"]) + hub_edges


@pytest.mark.parametrize("hub_rows", [0, 256])
def test_dst_indptr_consistent(hub_rows):
    g = _smoke_graph()
    dg = to_device(g, merge_duplicate_edges=True, hub_rows=hub_rows,
                   device="cpu")
    for dst, indptr in ((dg.in_dst, dg.in_indptr),
                        (dg.hub_dst, dg.hub_indptr)):
        if dst is None:
            assert indptr is None
            continue
        counts = np.bincount(dst.numpy(), minlength=g.n)
        assert indptr.dtype == torch.int32 and indptr.shape == (g.n + 1,)
        np.testing.assert_array_equal(np.diff(indptr.numpy()), counts)
        assert int(indptr[0]) == 0 and int(indptr[-1]) == dst.shape[0]


def test_merge_keeps_every_edge():
    rng = np.random.default_rng(11)
    n, m = 64, 512
    src = rng.integers(0, n, size=m)
    dst = rng.integers(0, n, size=m)
    g = from_edges(np.concatenate([src, src[:200]]),
                   np.concatenate([dst, dst[:200]]), n)
    dg = to_device(g, merge_duplicate_edges=True, hub_rows=8, device="cpu")
    assert float(dg.in_w.sum() + dg.hub_w.sum()) == g.m
    assert dg.m_in < g.m


def test_graph_from_numpy_matches_to_device():
    g = _smoke_graph()
    jg = jax_to_device(g, merge_duplicate_edges=True, hub_rows=256)
    conv = convert.graph_from_numpy(
        {f: getattr(jg, f) for f in jg._fields}, device="cpu")
    ours = to_device(g, merge_duplicate_edges=True, hub_rows=256,
                     device="cpu")
    for f in FIELDS + ("in_indptr", "hub_indptr"):
        a, b = getattr(conv, f), getattr(ours, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert torch.equal(a, b), f


def _unit_weighted(g):
    src = np.repeat(np.arange(g.n), np.asarray(g.out_deg, np.int64))
    return from_edges(src, np.asarray(g.out_indices), g.n,
                      w=np.ones(g.m, np.float32))


def test_weighted_graph_not_ported_yet():
    """Weighted graphs on shards, which the sharded engine used to refuse:
    a graph with unit weights gives the sharded engine the same answers
    as its unweighted self (tests/test_torch_weighted.py holds the
    weighted paths against fora_tpu)."""
    from fora_tpu_torch import ForaConfig
    from fora_tpu_torch import index as tidx
    from fora_tpu_torch.parallel import ShardedForaEngine, make_mesh
    g = generators.erdos_renyi(64, 256, seed=1)
    gw = _unit_weighted(g)
    rcfg = ForaConfig(epsilon=0.3).resolved(gw.n, gw.m)
    idx = tidx.build_walk_index(to_device(gw, device="cpu"), rcfg, seed=1)
    res = [ShardedForaEngine(x, make_mesh(2, devices=["cpu"] * 2), rcfg,
                             k=5, index=idx).topk(np.arange(8))
           for x in (g, gw)]
    assert res[0].push_iters == res[1].push_iters
    np.testing.assert_allclose(res[1].values, res[0].values, rtol=1e-6)
    assert (res[1].node_ids == res[0].node_ids).mean() > 0.9


def test_unit_weights_lay_out_as_unweighted():
    """A graph with unit weights lays out as its unweighted self: W(v) =
    out_deg(v), in_w all ones and alias tables that keep every slot's own
    edge."""
    g = generators.erdos_renyi(64, 256, seed=1)
    gw = _unit_weighted(g)
    dg, dgw = to_device(g, device="cpu"), to_device(gw, device="cpu")
    assert dgw.weighted and not dg.weighted
    assert torch.equal(dgw.out_wsum, dg.out_deg.float())
    assert torch.equal(dgw.in_w, torch.ones(g.m))
    assert torch.equal(dgw.alias_prob, torch.ones(g.m))
    assert torch.equal(dgw.alias_other, dg.out_indices)
    for f in ("out_indptr", "out_indices", "in_indptr"):
        assert torch.equal(getattr(dgw, f), getattr(dg, f)), f
