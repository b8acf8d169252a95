"""One process of a sharded one-shot run across processes.

    python -m fora_tpu_torch.parallel.multihost_driver --coordinator \
        localhost:PORT --processes P --rank Q [--backend gloo] \
        [--device cpu] --spec SPEC.json --out DIR

Each of the P processes starts the group (``multihost.init``), runs the
jobs of SPEC.json with ``ShardedForaEngine`` on ``make_mesh(G)`` (its L =
G / P shards), writes ``DIR/rank<Q>.json`` and ``DIR/rank<Q>.npz`` and
ends the group (``multihost.shutdown``).  The counterpart of the JAX
package's ``tests/multihost_driver.py``; ``tests/test_torch_multihost.py``
and ``chip_smoke.py``'s phase 17 run it.

SPEC.json holds ``shards`` (G) and ``jobs``, a list of objects with:

  name       the job's key in the outputs
  graph      {"npz": path} (a CSRGraph's arrays), {"er": [n, m, seed]}
             or {"store": dir} (a ShardedGraphStore of G shards: only
             this process's shards' files are opened)
  index      null (the raw one-shot), {"dir": path} (an index saved by
             either package) or {"store": dir} (a ShardedIndexStore)
  epsilon, k the config (ForaConfig(epsilon=, k=)) and the top-k
  sources    the query batch
  seed       the raw walk's seed (null: the engine's own)
  repeat     topk calls; the last is timed, its launch counts kept
  ends       true: the first walk chunk's endpoints of the last call,
             gathered from every process, saved by rank 0 as
             ``DIR/<name>.ends.npy`` (-1 on the lanes not walked)

Per job the outputs hold the answer (``<name>.values``, ``<name>.ids`` in
the npz), the supersteps, the timed call's wall, the kernels' launches, the
raw walk's rounds and records per round.
``gather`` (in the JSON) is ``multihost.gather_to_host`` of each local
shard's row ids, checked against 0 .. G * n_loc - 1.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch


def _graph(spec: dict, G: int, cache: dict):
    from ..graph import generators
    from ..graph.csr import CSRGraph
    from .graph_store import ShardedGraphStore
    key = json.dumps(spec, sort_keys=True)
    if key not in cache:
        if "npz" in spec:
            z = np.load(spec["npz"])
            cache[key] = CSRGraph(**{f: z[f] for f in CSRGraph._fields
                                     if f in z.files})
        elif "er" in spec:
            cache[key] = generators.erdos_renyi(*spec["er"])
        else:
            cache[key] = ShardedGraphStore(spec["store"], G)
    return cache[key]


def _index(spec, G: int, rcfg):
    from ..index import ShardedIndexStore, load
    if spec is None:
        return None
    if "store" in spec:
        return ShardedIndexStore(spec["store"], G, rcfg)
    return load(spec["dir"], rcfg)


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def run_job(job: dict, G: int, comm, out: Path, cache: dict) -> tuple:
    """One job on this process: (its JSON record, its arrays)."""
    from .. import kernels
    from ..config import ForaConfig
    from .mesh import make_mesh
    from .sharded import ShardedForaEngine
    g = _graph(job["graph"], G, cache)
    rcfg = ForaConfig(epsilon=job.get("epsilon", 0.5),
                      k=job["k"]).resolved(g.n, g.m)
    t0 = time.perf_counter()
    eng = ShardedForaEngine(g, make_mesh(G), rcfg, k=job["k"],
                            index=_index(job.get("index"), G, rcfg))
    _sync(comm.device)
    place_s = time.perf_counter() - t0
    src = np.asarray(job["sources"], dtype=np.int64)
    log = None if eng.use_index else {"ends": bool(job.get("ends"))}
    for i in range(job.get("repeat", 1)):
        last = i == job.get("repeat", 1) - 1
        eng.placement.xp_log = log if last else None
        if last:
            kernels.reset_launch_counts()
            _sync(comm.device)
            t0 = time.perf_counter()
        res = eng.topk(src, job.get("seed"))
    _sync(comm.device)
    wall = time.perf_counter() - t0
    rec = {"supersteps": res.push_iters, "wall_s": wall,
           "placement_s": place_s, "launches": kernels.launch_counts(),
           "shards": list(eng.placement.local), "n_loc": eng.n_loc}
    arrays = {f"{job['name']}.values": res.values,
              f"{job['name']}.ids": res.node_ids}
    if log is not None:
        rec.update(rounds=log["rounds"], sent=log["sent"],
                   received=log["received"])
        if job.get("ends"):
            ends = log["ends"]
            # one process ended each walked lane: -1 + 1 is 0 elsewhere
            total = comm.all_reduce(ends + 1)
            if comm.rank == 0:
                np.save(out / f"{job['name']}.ends.npy",
                        (total - 1).cpu().numpy())
            rec["ends_shape"] = list(ends.shape)
    return rec, arrays


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--processes", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--backend", default=None)
    ap.add_argument("--device", default=None)
    ap.add_argument("--spec", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    from . import multihost
    spec = json.loads(Path(args.spec).read_text())
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    comm = multihost.init(args.coordinator, args.processes, args.rank,
                          backend=args.backend, device=args.device)
    try:
        G = spec["shards"]
        record = {"backend": comm.backend, "device": str(comm.device),
                  "init_s": time.perf_counter() - t0, "jobs": {}}
        arrays, cache = {}, {}
        for job in spec["jobs"]:
            rec, arr = run_job(job, G, comm, out, cache)
            record["jobs"][job["name"]] = rec
            arrays.update(arr)
        # every local shard's global row ids, gathered in shard order
        L, n_loc = G // comm.size, 5
        rows = [torch.arange(s * n_loc, (s + 1) * n_loc, device=comm.device)
                for s in range(comm.rank * L, (comm.rank + 1) * L)]
        got = multihost.gather_to_host(rows)
        record["gather"] = bool(np.array_equal(got, np.arange(G * n_loc)))
        record["modules"] = sorted(
            m for m, mod in sys.modules.items() if mod is not None
            and m.split(".")[0] in ("jax", "jaxlib", "fora_tpu"))
        np.savez(out / f"rank{comm.rank}.npz", **arrays)
        (out / f"rank{comm.rank}.json").write_text(json.dumps(record))
    finally:
        multihost.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
