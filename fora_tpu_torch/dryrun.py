"""A dry run of the graph-sharded paths on a mesh of devices.

Counterpart of ``__graft_entry__.py::dryrun_multichip`` (45-): on a
``make_mesh(G, Q, devices=...)`` mesh (Q = 2 query groups where the
device count is even, G = len(devices) / Q graph shards), at toy shapes
(an ER graph of 512 nodes and 4096 edges, eps 0.5):

  1. the raw-walk one-shot engine (``ShardedForaEngine`` without an
     index), each query's source at the top of its list;
  2. the refinement pool (``ShardedTopkRunner``) on a FORA+ index under
     the routed exchange and, where G is even, hier with two shards a host:
     each source tops its list, every query accepted, lb <= values;
  3. the same pool from both sharded stores (the graph's and the index's),
     at the same levels as from RAM.

    python -m fora_tpu_torch.dryrun 8                 # 8 shards on the cards
    python -m fora_tpu_torch.dryrun 8 --device cpu    # 8 CPU devices
"""

from __future__ import annotations

import argparse
import shutil
import sys
import tempfile

import numpy as np


def _toy_setup(eps: float = 0.5):
    from .config import ForaConfig
    from .graph import generators
    g = generators.erdos_renyi(512, 4096, seed=3)
    return g, ForaConfig(epsilon=eps).resolved(g.n, g.m)


def dryrun_multichip(devices) -> dict:
    """The three steps on a mesh over ``devices`` (a list of devices, one
    per shard of every query group; repeats allowed).  Raises on a failed
    check; returns what the reference prints (mesh, push supersteps,
    levels of each pool, exchanges, store-backed exchanges)."""
    import torch
    from .graph import to_device
    from .index import ShardedIndexStore, build_walk_index, save_sharded
    from .parallel import (ShardedForaEngine, ShardedGraphStore,
                           ShardedTopkRunner, make_mesh, save_sharded_graph)
    devices = [torch.device(d) for d in devices]
    n_devices = len(devices)
    n_query = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    G = n_devices // n_query
    mesh = make_mesh(G, n_query, devices=devices)

    g, rcfg = _toy_setup()
    eng = ShardedForaEngine(g, mesh, rcfg, k=10)
    res = eng.topk(np.arange(n_query * 4), 0)
    ids = res.node_ids
    assert ids.shape == (n_query * 4, 10), ids.shape
    # each query's own source must top its list
    assert (ids[:, 0] == np.arange(n_query * 4)).all(), ids[:, 0]

    idx = build_walk_index(to_device(g, device=devices[0]), rcfg, seed=1)
    B = max(2 * n_query, 8)
    exchanges = ("routed",) + (("hier",) if G % 2 == 0 else ())
    levels = {}
    for exchange in exchanges:
        runner = ShardedTopkRunner(
            g, mesh, rcfg, idx, k=10, exchange=exchange,
            chips_per_host=2 if exchange == "hier" else None)
        pool = runner.query_pool(np.arange(B), 2, batch=B)
        assert pool.node_ids.shape == (B, 10)
        assert (pool.node_ids[:, 0] == np.arange(B)).all(), \
            (exchange, pool.node_ids[:, 0])
        assert pool.accepted.all(), exchange
        assert np.all(pool.lower_bounds <= pool.values + 1e-7), exchange
        levels[exchange] = pool.levels_used

    tmp = tempfile.mkdtemp(prefix="fora_torch_dryrun_")
    store_exchanges = []
    try:
        save_sharded_graph(g, tmp + "/graph", G, with_walk_side=False)
        save_sharded(idx, rcfg, tmp + "/index", G, graph=g)
        gst = ShardedGraphStore(tmp + "/graph", G)
        ist = ShardedIndexStore(tmp + "/index", G, rcfg, graph=g)
        for exchange in exchanges:
            runner = ShardedTopkRunner(
                gst, mesh, rcfg, ist, k=10, exchange=exchange,
                chips_per_host=2 if exchange == "hier" else None)
            pool = runner.query_pool(np.arange(B), 2, batch=B)
            assert (pool.node_ids[:, 0] == np.arange(B)).all(), exchange
            assert pool.accepted.all(), ("store", exchange)
            assert pool.levels_used == levels["routed"], ("store", exchange)
            store_exchanges.append(exchange)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"mesh": {"graph": G, "query": n_query},
            "push_iters": int(res.push_iters), "pool_levels": levels,
            "exchanges": list(levels), "store_backed": store_exchanges}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (shard i on card i modulo the visible "
                         "cards) or cpu")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        devices = ["cpu"] * args.n_devices
    else:
        import torch
        count = torch.cuda.device_count()
        if count == 0:
            print("dryrun: no CUDA device", file=sys.stderr)
            return 2
        devices = [f"cuda:{i % count}" for i in range(args.n_devices)]
    out = dryrun_multichip(devices)
    print(f"dryrun_multichip ok: mesh={out['mesh']} "
          f"push_iters={out['push_iters']} pool_levels={out['pool_levels']} "
          f"exchanges={out['exchanges']} store_backed={out['store_backed']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
