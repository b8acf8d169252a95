"""One process of a sharded run across processes.

    python -m fora_tpu_torch.parallel.multihost_driver --coordinator \
        localhost:PORT --processes P --rank Q [--backend gloo] \
        [--device cpu] --spec SPEC.json --out DIR

Each of the P processes starts the group (``multihost.init``; on a
machine without a card ``--device cpu`` is needed, gloo then the
default), runs the jobs of SPEC.json with ``ShardedForaEngine`` (the
one-shot), ``ShardedTopkRunner`` (the refinement pool) or
``build_walk_index_sharded`` (the index build) on
``make_mesh(G, n_query)`` (its L = G / P shards of every query group),
writes ``DIR/rank<Q>.json`` and ``DIR/rank<Q>.npz`` and ends the group
(``multihost.shutdown``).  The counterpart of the JAX package's
``tests/multihost_driver.py``; ``tests/test_torch_multihost.py`` and
``chip_smoke.py``'s phase 17 run it.

SPEC.json holds ``shards`` (G) and ``jobs``, a list of objects with:

  name       the job's key in the outputs
  graph      {"npz": path} (a CSRGraph's arrays), {"er": [n, m, seed]},
             {"rmat": [n_log2, m, seed]} or {"store": dir} (a
             ShardedGraphStore of G shards: only this process's shards'
             files are opened; not for a build)
  index      null (the raw one-shot), {"dir": path} (an index saved by
             either package) or {"store": dir} (a ShardedIndexStore)
  epsilon, k the config (ForaConfig(epsilon=, k=)) and the top-k
  sources    the query batch
  seed       the raw walk's seed (null: the engine's own)
  repeat     calls; the last is timed, its launch counts kept
  ends       true: the first walk chunk's endpoints of the last call,
             gathered from every process, saved by rank 0 as
             ``DIR/<name>.ends.npy`` (-1 on the lanes not walked)
  exchange, chips_per_host, cap
             the frontier exchange (null: dense), hier's chips per host
             (across processes L), its capacity (null: exchange_cap)
  n_query    query groups (null: 1)
  runner     "pool": ShardedTopkRunner.query_pools (pools of ``pool``
             sources, null: all, through query_pool(batch=``batch``,
             defer_below=``defer_below``), then flush_deferred), with
             ``delta_stride`` and ``accept_slack`` (defaults 2, 1);
             "build": the FORA+ index built across the processes
             (``index.build_sharded.build_across_processes`` at ``seed``
             and ``chunk_lanes``, default 2^23; its record holds the
             build's log: windows, rounds, records per round, and the
             wall's split ``split_s`` and ``walk_device_ms``), then,
             after a barrier,
             rank 0 saves it as ``DIR/<name>.index`` (the index store)
             and, with ``store`` a directory, as a ShardedIndexStore of G
             shards there, and a second barrier lets later jobs open it;
             with ``checkpoint_dir`` (this process's own directory) the
             build checkpoints its chunks there and resumes from them,
             its record listing the chunks it loaded (``cached``); tests
             only: ``window_walks`` sets the walks of a window
             (``schedule.XP_BUILD_WALKS``) in this process, and
             ``stop_after_windows`` k stops the build once its k-th
             window's chunk files are written (the window in flight is
             saved too), its record then holding ``stopped`` and the
             chunk files present, and nothing saved;
             else the one-shot

Per job the outputs hold the answer (``<name>.values``, ``<name>.ids`` in
the npz; a pool adds ``.lb``, ``.ub`` and ``.accepted``, each source's
final row, the flush's for a deferred one), the supersteps, the timed
call's wall, the kernels' launches, the exchange's supersteps compacted,
fallen back and cleared by rows in the timed call, and per superstep of
it the rows and bytes this process sent to the others (``sent_rows``,
``sent_bytes``; ``dense_bytes``, what the dense exchange sends in their
place), a pool's level records, the raw walk's rounds and records per
round.
A build's record holds its wall, the kernels' launches, the shards this
process placed and each slice's edges (``shards``, ``slice_edges``), per
window of chunks its walks, the rounds, the records this process sent
and received per round and its launches of K4-xp's two forms
(``windows``, ``rounds``, ``sent``, ``received``, ``forms``), the wall's
split (``split_s``: placing, the launches, the counts' all-gather, the
all-to-all, the endpoints' all-reduce, the pack; ``walk_device_ms``: the
launches' CUDA events), and the sha256 of each of the index's arrays
(``digest``), so that every process's index can be compared.
``gather`` (in the JSON) is ``multihost.gather_to_host`` of each local
shard's row ids, checked against 0 .. G * n_loc - 1.
"""

from __future__ import annotations

import argparse
import hashlib
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
        elif "rmat" in spec:
            n_log2, m, seed = spec["rmat"]
            cache[key] = generators.rmat(n_log2, m, seed=seed)
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


def _sent(xch, comm) -> dict:
    """Per superstep of ``xch.sent``, the rows and bytes this process sent
    to the others, and the bytes of the dense exchange's all-gather at
    the same width (a compacted row is B + 1 words, a dense one B)."""
    L, n_loc = len(xch.local), xch.n_loc
    sent = xch.sent or []
    return {"sent_rows": [r for r, _, _ in sent],
            "sent_bytes": [r * (B + c) * 4 for r, B, c in sent],
            "dense_bytes": [(comm.size - 1) * L * n_loc * B * 4
                            for _, B, _ in sent]}


INDEX_ARRAYS = ("edge_src", "edge_dst", "bucket_offsets", "counts_cum",
                "edge_mult")


def index_digest(idx) -> dict:
    """The sha256 of each of a WalkIndex's arrays (INDEX_ARRAYS, those it
    has), so that indexes built in several processes can be compared."""
    return {f: hashlib.sha256(np.ascontiguousarray(getattr(idx, f))
                              .tobytes()).hexdigest()
            for f in INDEX_ARRAYS if getattr(idx, f) is not None}


class _Stopped(Exception):
    """A build job's ``stop_after_windows`` was reached."""


def build_job(job: dict, G: int, comm, out: Path, cache: dict) -> tuple:
    """A "build" job on this process: (its JSON record, no arrays)."""
    from .. import kernels
    from ..config import ForaConfig
    from ..graph.csr import CSRGraph
    from ..index import index_counts, save, save_sharded
    from ..index.build_sharded import build_across_processes
    from ..kernels import schedule
    from .mesh import make_mesh
    g = _graph(job["graph"], G, cache)
    if not isinstance(g, CSRGraph):
        raise ValueError("a build needs the host graph, not a graph store")
    rcfg = ForaConfig(epsilon=job.get("epsilon", 0.5),
                      k=job["k"]).resolved(g.n, g.m)
    mesh = make_mesh(G)
    chunk = job.get("chunk_lanes", 1 << 23)
    if job.get("window_walks"):
        schedule.XP_BUILD_WALKS = job["window_walks"]
    ckpt, stop = job.get("checkpoint_dir"), job.get("stop_after_windows")
    # the last chunk of each window: the stop counts the windows saved
    last = {(hi - 1) // chunk for _, hi in schedule.build_windows(
        int(index_counts(g.out_deg, rcfg).sum()), chunk)} if stop else ()
    cached, saved = [], []

    def progress(i, n_chunks, was_cached):
        (cached if was_cached else saved).append(i)
        if not was_cached and sum(c in last for c in saved) == stop:
            raise _Stopped()
    log = {}
    kernels.reset_launch_counts()
    _sync(comm.device)
    t0 = time.perf_counter()
    try:
        idx = build_across_processes(g, mesh, rcfg, job["seed"], chunk, log,
                                     checkpoint_dir=ckpt, progress=progress)
    except _Stopped:
        return {"stopped": True, "cached": cached,
                "files": sorted(p.name for p in Path(ckpt).glob("chunk_*"))}, {}
    _sync(comm.device)
    wall = time.perf_counter() - t0
    rec = {"wall_s": wall, "launches": kernels.launch_counts(),
           "total_edges": idx.total_edges,
           "omega_unit_built": idx.omega_unit_built,
           "rmax_built": idx.rmax_built, **log, "digest": index_digest(idx),
           "cached": cached}
    # every process has built (and packed as many edges) before rank 0
    # writes, and rank 0 has written before any process opens the store
    comm.agree("the built index's edges", idx.total_edges)
    if comm.rank == 0:
        save(idx, rcfg, str(out / f"{job['name']}.index"), graph=g)
        if job.get("store"):
            save_sharded(idx, rcfg, job["store"], G, graph=g)
    comm.agree("the saved index", 0)
    return rec, {}


def run_job(job: dict, G: int, comm, out: Path, cache: dict) -> tuple:
    """One job on this process: (its JSON record, its arrays)."""
    from .. import kernels
    from ..config import ForaConfig
    from .mesh import make_mesh
    from .sharded import ShardedForaEngine, ShardedTopkRunner
    if job.get("runner") == "build":
        return build_job(job, G, comm, out, cache)
    g = _graph(job["graph"], G, cache)
    rcfg = ForaConfig(epsilon=job.get("epsilon", 0.5),
                      k=job["k"]).resolved(g.n, g.m)
    t0 = time.perf_counter()
    mesh = make_mesh(G, job.get("n_query"))
    index = _index(job.get("index"), G, rcfg)
    kw = dict(k=job["k"], exchange=job.get("exchange"),
              chips_per_host=job.get("chips_per_host"))
    pool = job.get("runner") == "pool"
    if pool:
        eng = ShardedTopkRunner(g, mesh, rcfg, index,
                                delta_stride=job.get("delta_stride", 2.0),
                                accept_slack=job.get("accept_slack", 1.0),
                                **kw)
    else:
        eng = ShardedForaEngine(g, mesh, rcfg, index=index, **kw)
    xch = eng.exchange
    if job.get("cap") and xch.mode != "dense":
        xch.cap = job["cap"]
    placement = eng._groups[0]
    _sync(comm.device)
    place_s = time.perf_counter() - t0
    src = np.asarray(job["sources"], dtype=np.int64)
    log = None if index is not None else {"ends": bool(job.get("ends"))}
    for i in range(job.get("repeat", 1)):
        last = i == job.get("repeat", 1) - 1
        placement.xp_log = log if last else None
        if last:
            kernels.reset_launch_counts()
            before = (xch.compacted, xch.fell_back, xch.cleared)
            xch.sent = []
            _sync(comm.device)
            t0 = time.perf_counter()
        res = (eng.query_pools(src, batch=job["batch"], pool=job.get("pool"),
                               defer_below=job.get("defer_below", 0))
               if pool else eng.topk(src, job.get("seed")))
    _sync(comm.device)
    wall = time.perf_counter() - t0
    name = job["name"]
    rec = {"wall_s": wall, "placement_s": place_s,
           "launches": kernels.launch_counts(),
           "shards": list(placement.local), "n_loc": placement.n_loc,
           "exchange": xch.mode, "cap": xch.cap,
           "compacted": xch.compacted - before[0],
           "fell_back": xch.fell_back - before[1],
           "cleared": xch.cleared - before[2], **_sent(xch, comm)}
    if pool:
        res, stats = res
        rec.update(supersteps=sum(st["supersteps"] for st in stats),
                   levels_used=res.levels_used, levels=stats)
        arrays = {f"{name}.ids": res.node_ids,
                  f"{name}.values": res.values,
                  f"{name}.lb": res.lower_bounds,
                  f"{name}.ub": res.upper_bounds,
                  f"{name}.accepted": res.accepted}
        return rec, arrays
    rec["supersteps"] = res.push_iters
    arrays = {f"{name}.values": res.values, f"{name}.ids": res.node_ids}
    if log is not None:
        rec.update(rounds=log["rounds"], sent=log["sent"],
                   received=log["received"])
        if job.get("ends"):
            ends = log["ends"]
            # one process ended each walked lane: -1 + 1 is 0 elsewhere
            total = comm.all_reduce(ends + 1)
            if comm.rank == 0:
                np.save(out / f"{name}.ends.npy", (total - 1).cpu().numpy())
            rec["ends_shape"] = list(ends.shape)
    return rec, arrays


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--processes", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--backend", default=None,
                    help="nccl or gloo (default: nccl on a card, gloo on "
                         "the CPU)")
    ap.add_argument("--device", default=None,
                    help="the device of this process's shards (default: "
                         "card rank modulo the visible cards; without a "
                         "card, pass cpu, else the start fails)")
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
