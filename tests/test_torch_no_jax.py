"""fora_tpu_torch runs without JAX and without the JAX package: it imports
and answers CPU queries (indexed, sharded, the sharded raw one-shot,
raw-walk, Monte Carlo, indexed on a weighted graph with its alias tables,
``entry()``), builds a sharded index, runs the sharded dry run, the
gather probe's case, a frontier-compacted push and a relabelled graph and
index, and its CLI (build, batch-topk, query --algo bippr, hubppr
and fwdpush) with ``--device cpu``, whether or not ``import jax`` would
work, loading
no module of ``jax`` or ``fora_tpu``; no file of it (nor ``chip_smoke.py``)
imports either; and CPU tensors never reach a CUDA kernel (every launch
counter stays 0)."""

import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "fora_tpu_torch"

SCRIPT = textwrap.dedent("""
    import sys
    if sys.argv[1] == "blocked":
        sys.modules["jax"] = None      # any import of jax now fails
    import numpy as np
    import torch
    torch.set_num_threads(2)
    import fora_tpu_torch
    from fora_tpu_torch import index as tidx
    from fora_tpu_torch import kernels
    from fora_tpu_torch.eval import queries
    from fora_tpu_torch.graph import generators
    g = generators.rmat(10, 8192, seed=4)
    rcfg = fora_tpu_torch.ForaConfig(epsilon=0.5, k=10).resolved(g.n, g.m)
    dg = fora_tpu_torch.to_device(g, merge_duplicate_edges=True,
                                  hub_rows=64, device="cpu")
    idx = tidx.build_walk_index(dg, rcfg, seed=1)
    runner = fora_tpu_torch.TopkRunner(dg, rcfg, index=idx,
                                       delta_stride=8)
    res = runner.query_pool(queries.generate_sources(g, 3, seed=5), batch=4)
    assert res.node_ids.shape == (3, 10) and res.levels_used >= 1
    assert np.isfinite(res.values).all()
    assert (np.diff(res.values, axis=1) <= 0).all()
    from fora_tpu_torch.parallel import ShardedForaEngine, make_mesh
    eng = ShardedForaEngine(g, make_mesh(2, devices=["cpu"] * 2), rcfg,
                            k=10, index=idx)
    sres = eng.topk(queries.generate_sources(g, 3, seed=5))
    assert sres.node_ids.shape == (3, 10) and sres.push_iters >= 1
    assert np.isfinite(sres.values).all()
    raw_eng = ShardedForaEngine(g, make_mesh(2, devices=["cpu"] * 2), rcfg,
                                k=10, exchange="routed")
    rres = raw_eng.topk(queries.generate_sources(g, 3, seed=5), 1)
    assert rres.node_ids.shape == (3, 10) and np.isfinite(rres.values).all()
    sidx = tidx.build_walk_index_sharded(g, make_mesh(2, devices=["cpu"] * 2),
                                         rcfg, seed=1)
    ref = tidx.build_walk_index(fora_tpu_torch.to_device(g, device="cpu"),
                                rcfg, seed=1)
    assert np.array_equal(sidx.edge_dst, ref.edge_dst)
    from fora_tpu_torch.dryrun import dryrun_multichip
    assert dryrun_multichip(["cpu"] * 4)["store_backed"] == ["routed",
                                                              "hier"]
    from fora_tpu_torch.parallel import ShardedTopkRunner
    pool = ShardedTopkRunner(g, make_mesh(4, devices=["cpu"] * 4), rcfg,
                             idx, k=10, delta_stride=8, exchange="routed")
    pres = pool.query_pool(queries.generate_sources(g, 3, seed=5), batch=4)
    assert pres.node_ids.shape == (3, 10) and np.isfinite(pres.values).all()
    raw = fora_tpu_torch.TopkRunner(dg, rcfg, delta_stride=8)
    rres = raw.query_pool(queries.generate_sources(g, 3, seed=5), batch=4)
    assert rres.node_ids.shape == (3, 10) and rres.accepted.all()
    from fora_tpu_torch.algo.montecarlo import make_montecarlo_fn
    est = make_montecarlo_fn(dg, rcfg, max_walks=2000)(np.array([1, 2]), 3)
    assert est.shape == (g.n, 2) and abs(float(est.sum()) - 2) < 1e-4
    src = np.repeat(np.arange(g.n), g.out_deg)
    w = np.exp2(np.random.default_rng(6).uniform(-2, 2, g.m))
    gw = fora_tpu_torch.from_edges(src, g.out_indices, g.n, w=w)
    dgw = fora_tpu_torch.to_device(gw, merge_duplicate_edges=True,
                                   hub_rows=64, device="cpu")
    assert dgw.weighted and dgw.alias_prob is not None
    wres = fora_tpu_torch.TopkRunner(
        dgw, rcfg, index=tidx.build_walk_index(dgw, rcfg, seed=2),
        delta_stride=8).query_pool(queries.generate_sources(gw, 3, seed=5),
                                   batch=4)
    assert wres.node_ids.shape == (3, 10) and np.isfinite(wres.values).all()
    from fora_tpu_torch.graph import relabel
    from fora_tpu_torch.ops import push
    perm = relabel.bfs_order(g)
    ridx = relabel.relabel_index(idx, perm)
    rdg = fora_tpu_torch.to_device(relabel.relabel_graph(g, perm),
                                   device="cpu")
    push.superstep_counts.reset()
    st = push.forward_push_from(
        rdg, push.init_state(g.n, torch.as_tensor(perm[[1, 2]])),
        rmax=rcfg.rmax, alpha=0.2, compact_edges=2048)
    assert push.superstep_counts.compacted > 0 and st.iters > 0
    assert ridx.total_edges == idx.total_edges
    from fora_tpu_torch.entry import entry
    step, args = entry("cpu")
    assert step(*args)[1].shape == (8, 10)
    import time
    from fora_tpu_torch.probes import gather_probe
    host_ms = lambda fn: (time.perf_counter(), fn())[0]   # noqa: E731
    assert gather_probe.p3_case(32, "cpu", host_ms, e_total=2048)[
        "err_plain"] == 0.0
    from fora_tpu_torch import cli
    from fora_tpu_torch.graph import io as gio
    gio.save_dataset(generators.rmat(8, 2048, seed=6), sys.argv[2], "r")
    base = ["--prefix", sys.argv[2], "--dataset", "r", "--device", "cpu",
            "--k", "5", "--batch", "4"]
    assert cli.main(["generate-ss-query", "--query-size", "4"] + base) == 0
    assert cli.main(["build"] + base) == 0
    assert cli.main(["batch-topk", "--with-idx"] + base) == 0
    assert cli.main(["build", "--index-shards", "2"] + base) == 0
    assert cli.main(["batch-topk", "--with-idx", "--graph-shards", "2",
                     "--exchange", "hier", "--chips-per-host", "1"]
                    + base) == 0
    for algo in ("bippr", "hubppr", "fwdpush"):
        assert cli.main(["query", "--algo", algo, "--num-hubs", "4"]
                        + base) == 0
    assert all(n == 0 for n in kernels.launch_counts().values())
    foreign = sorted(m for m, mod in sys.modules.items() if mod is not None
                     and m.split(".")[0] in ("jax", "jaxlib", "fora_tpu"))
    assert not foreign, foreign
    print("OK", sorted(kernels.launch_counts().items()))
""")


@pytest.mark.parametrize("jax", ["blocked", "importable"])
def test_cpu_query_without_jax(jax, tmp_path):
    out = subprocess.run([sys.executable, "-c", SCRIPT, jax, str(tmp_path)],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("OK")


def test_no_jax_import_in_package():
    pat = re.compile(r"^\s*(import (jax|fora_tpu)\b(?!_torch)"
                     r"|from (jax|fora_tpu)\b(?!_torch))", re.M)
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 2
    for f in files:
        assert not pat.search(f.read_text()), f


def test_cpu_tensors_never_launch_kernels():
    import numpy as np

    from fora_tpu_torch import ForaConfig, kernels
    from fora_tpu_torch.algo import bounds
    from fora_tpu_torch.graph import from_edges, generators, to_device
    from fora_tpu_torch.ops import gather, push, walk
    kernels.reset_launch_counts()
    g = generators.rmat(9, 4096, seed=2)
    rcfg = ForaConfig(epsilon=0.5).resolved(g.n, g.m)
    dg = to_device(g, merge_duplicate_edges=True, hub_rows=16, device="cpu")
    st = push.forward_push(dg, torch.tensor([1, 2, 3]), rmax=rcfg.rmax,
                           alpha=0.2)
    push.forward_push_from(to_device(g, device="cpu"), push.init_state(
        g.n, torch.tensor([1, 2])), rmax=rcfg.rmax, alpha=0.2,
        compact_edges=1024)
    gather.index_spmv(torch.zeros_like(st.r), st.r, dg.in_indptr, dg.in_src,
                      dg.in_w, torch.ones(g.n))
    bounds.topk_with_bounds_split(st.p, st.r, rcfg.omega_unit, 5, 10.0, 0.5)
    walk.walk_endpoints(dg, torch.zeros(100, dtype=torch.int32), 1, 0.2, 64)
    src = np.repeat(np.arange(g.n), g.out_deg)
    gw = from_edges(src, g.out_indices, g.n, w=np.ones(g.m) * 2)
    walk.walk_endpoints(to_device(gw, device="cpu"),
                        torch.zeros(100, dtype=torch.int32), 1, 0.2, 64)
    from fora_tpu_torch.algo import fora, montecarlo
    fora.fora_query(dg, torch.tensor([1, 2]), 4, rcfg=rcfg)
    montecarlo.make_montecarlo_fn(dg, rcfg, max_walks=500)(
        torch.tensor([3]), 5)
    gather.row_scatter_add(torch.zeros(4, 8), torch.ones(6, 8),
                           torch.tensor([0, 5], dtype=torch.int32),
                           torch.tensor([3, 3], dtype=torch.int32))
    from fora_tpu_torch.algo import bippr, hubppr
    bippr.bippr_pairs(dg, [1, 2], [3, 4, 5], 6, rcfg=rcfg, rmax_b=1e-3,
                      num_walks=200)
    hub = hubppr.build_hub_index(dg, 7, alpha=0.2, num_hubs=4, pool_size=64)
    hubppr.hub_walks(dg, torch.zeros(100, dtype=torch.int32), 8, hub,
                     alpha=0.2)
    from fora_tpu_torch.ops import exchange
    exchange.frontier_compact(
        st.r, None, 8, 0, g.n, torch.zeros((1, 8), dtype=torch.int32),
        torch.zeros((1, 8, 3)), torch.zeros(1, dtype=torch.int32))
    from fora_tpu_torch.ops import ring
    ring.ring_reduce_scatter([torch.ones(4, 3), torch.ones(4, 3)])
    exchange.exchange_clear([torch.ones(4, 8), torch.ones(4, 8)], 2,
                            [torch.tensor([1, 4], dtype=torch.int32)] * 2)
    from fora_tpu_torch.index.build_sharded import shard_out_csr
    for graph in (g, gw):
        walk.walk_endpoints(shard_out_csr(graph, ["cpu"] * 3),
                            torch.zeros(100, dtype=torch.int32), 1, 0.2, 64)
    assert np.all(np.array(list(kernels.launch_counts().values())) == 0)
    assert len(kernels.launch_counts()) == len(kernels.WRAPPERS) == 22
