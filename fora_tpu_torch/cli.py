"""The CLI — the engine's user-facing surface, on one CUDA card.

Port of ``fora_tpu/cli.py``, with the reference's action/flag interface
[R: fora.cpp main — reconstruction, SURVEY.md Sec. 1 L6]:

  python -m fora_tpu_torch.cli <action> --prefix data --dataset dblp [flags]

Actions:
  query              single-source SSPPR over a query set
  topk               top-k queries with iterative refinement
  batch-topk         batched top-k over the whole query set (pools,
                     stragglers deferred and refined together)
  build              build + serialize the FORA+ walk index
  generate-ss-query  sample a query source set to <dataset>.query
  gen-exact-topk     ground-truth exact PPR top-k per query source
  serve              line-oriented TCP JSON server (serve.py)
  sweep              relative error against the exact oracle per epsilon

Algorithms (--algo, for query): fora (default), montecarlo, fwdpush,
hubppr (hub-indexed Monte Carlo; --num-hubs controls the index), bippr
(pairs against a target set).

Weighted graphs: a third column in graph.txt is auto-detected as positive
per-edge weights; every algorithm then runs the weighted kernel (walks step
v -> u w.p. w(v,u)/W(v) via alias tables; push propagates w/W fractions;
gen-exact-topk solves the weighted chain).

The engine runs on ``--device`` (default ``cuda``) and refuses to start
where CUDA is absent unless ``--device cpu`` is given.  The TPU-only flags
of the JAX CLI (--bf16-gather, --gather-chunk, --push-pair,
--stepped-push, --narrow-r, --jax-cache) are not carried.  ``build``
checkpoints its walk chunks as the JAX CLI does: under ``<index
dir>/.build_ckpt``, so that a preempted build run again resumes where it
stopped; a stale checkpoint (another graph, config, seed or random
stream) is discarded and the build starts again; the directory is removed
once the index is saved.

Row-sharded forms, as the JAX CLI's: ``shard-graph`` writes the sharded
graph store (``--shard-counts`` or ``--graph-shards``), ``build
--index-shards`` the sharded index store and the graph store beside it,
and ``batch-topk``/``serve`` with ``--graph-shards`` > 1 run the sharded
refinement pool (``parallel.ShardedTopkRunner``) over ``--graph-shards``
shards and ``--query-shards`` query groups on the card (every shard on it
where there is one card; on the CPU with ``--device cpu``), reading both
stores where they exist, with ``--exchange`` and ``--chips-per-host``.
The sharded pool needs ``--with-idx``, as the JAX CLI does
(``fora_tpu/cli.py:191-193``): the refinement pool runs on an index, and
the sharded raw walk serves only the one-shot engine
(``parallel.ShardedForaEngine`` without an index); the ``ragged``
exchange is not ported (ROADMAP C5).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .config import ForaConfig
from .eval import metrics, queries as query_io
from .graph import io as graph_io
from .graph import to_device
from .ops.exchange import MODES as EXCHANGE_MODES
from .ops.walk import derive_seed
from .utils.logging import RunLog, info
from .utils.profiling import fence
from .utils.timers import Timers

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fora_tpu_torch",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("action", choices=["query", "topk", "batch-topk", "build",
                                      "generate-ss-query", "gen-exact-topk",
                                      "serve", "sweep", "shard-graph"])
    p.add_argument("--shard-counts", default=None,
                   help="shard-graph: comma list of graph-shard counts "
                        "(default: --graph-shards)")
    p.add_argument("--port", type=int, default=8471, help="serve action port")
    p.add_argument("--sweep-eps", default="0.1,0.2,0.35,0.5",
                   help="epsilon grid for the sweep action")
    p.add_argument("--prefix", default="data", help="dataset root dir")
    p.add_argument("--dataset", required=True)
    p.add_argument("--algo", default="fora",
                   choices=["fora", "montecarlo", "fwdpush", "hubppr",
                            "bippr"])
    p.add_argument("--num-hubs", type=int, default=256,
                   help="hubppr: hub count for the forward hub index")
    p.add_argument("--target-file", default=None,
                   help="bippr: file of target node ids (one per line); "
                        "default: all nodes if n<=4096, else a seeded "
                        "sample of --bippr-targets")
    p.add_argument("--bippr-targets", type=int, default=2048,
                   help="bippr: sampled target-set size on large graphs")
    p.add_argument("--epsilon", type=float, default=0.5)
    p.add_argument("--alpha", type=float, default=0.2)
    p.add_argument("--delta", type=float, default=None, help="default 1/n")
    p.add_argument("--pfail", type=float, default=None, help="default 1/n")
    p.add_argument("--k", type=int, default=50)
    p.add_argument("--query-size", type=int, default=20,
                   help="number of sources for generate-ss-query")
    p.add_argument("--batch", type=int, default=16,
                   help="sources per device batch")
    p.add_argument("--with-idx", action="store_true",
                   help="serve walks from the prebuilt FORA+ index")
    p.add_argument("--index-dir", default=None,
                   help="default <prefix>/index/<dataset>")
    p.add_argument("--index-shards", default=None,
                   help="build: also write the row-sharded index and graph "
                        "stores for these graph-shard counts (comma list)")
    p.add_argument("--delta-stride", type=float, default=4.0,
                   help="top-k refinement delta divisor per level")
    p.add_argument("--accept-slack", type=float, default=1.0,
                   help=">1 tightens the top-k stopping rule")
    p.add_argument("--pool", type=int, default=0,
                   help="batch-topk: split the query set into resident "
                        "pools of this many queries (0 = one pool); the "
                        "pool's [n, pool] push state must fit the card")
    p.add_argument("--defer", type=int, default=64,
                   help="batch-topk with --pool: stash a pool's stragglers "
                        "once <= this many remain and refine all pools' "
                        "stragglers together in one final batch "
                        "(0 disables)")
    p.add_argument("--start-level", type=int, default=None,
                   help="pin batch-topk's first delta level (default: "
                        "learned/persisted first-accepting level)")
    p.add_argument("--hub-rows", type=int, default=0,
                   help="split in-edges from the top-H out-degree sources "
                        "into a compact-operand gather (0 disables)")
    p.add_argument("--graph-shards", type=int, default=1,
                   help="row-shard the graph (+ index) over this many "
                        "shards; batch-topk and serve then run the sharded "
                        "refinement pool (requires --with-idx)")
    p.add_argument("--query-shards", type=int, default=None,
                   help="query groups of the sharded pool, each holding "
                        "--graph-shards shards; a batch's columns split "
                        "over them (default 1)")
    p.add_argument("--exchange", default=None,
                   choices=EXCHANGE_MODES,
                   help="frontier exchange of the sharded push (default "
                        "dense; hier needs --chips-per-host; ragged is "
                        "refused, ROADMAP C5)")
    p.add_argument("--chips-per-host", type=int, default=None,
                   help="exchange=hier: shards per host of the two-stage "
                        "exchange")
    p.add_argument("--output", default=None,
                   help="write per-query results (JSONL: source, ids, vals)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the engine (default cuda; cpu "
                        "runs the plain PyTorch versions of the kernels)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--runlog", default=None, help="JSONL metrics path")
    p.add_argument("--eval-exact", action="store_true",
                   help="report precision@k vs the exact oracle (slow)")
    return p


def _query_file(args) -> Path:
    return Path(args.prefix) / args.dataset / f"{args.dataset}.query"


def _index_dir(args) -> str:
    return args.index_dir or str(Path(args.prefix) / "index" / args.dataset)


def _level_stats_path(args) -> Path:
    return Path(_index_dir(args)) / "level_stats.json"


def _device(args) -> torch.device:
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise ValueError("CUDA is not available here; the engine runs on a "
                         "CUDA card (pass --device cpu to run it on the CPU)")
    return dev


def _load(args, dev):
    t0 = time.perf_counter()
    g = graph_io.load_dataset(args.prefix, args.dataset, device=dev)
    info("graph loaded", n=g.n, m=g.m, secs=f"{time.perf_counter()-t0:.2f}")
    return g


def _make_topk_runner(args, g, dg, rcfg, idx, dev):
    """TopkRunner on one device, or ShardedTopkRunner (--graph-shards > 1:
    rows and index sharded over the shard devices) per the CLI flags; ``g``
    is the host graph or its ShardedGraphStore."""
    from .algo.topk import TopkRunner
    if args.graph_shards <= 1:
        return TopkRunner(dg, rcfg, k=args.k, index=idx,
                          delta_stride=args.delta_stride,
                          accept_slack=args.accept_slack)
    from .parallel import ShardedTopkRunner, make_mesh
    if idx is None:
        raise ValueError("--graph-shards > 1 requires --with-idx: the "
                         "sharded refinement pool runs on a FORA+ index, as "
                         "the JAX CLI's does")
    G, Q = args.graph_shards, args.query_shards or 1
    mesh = make_mesh(G, Q, devices=None if dev.type == "cuda"
                     else [dev] * (G * Q))
    if args.batch % Q:
        raise ValueError(f"--batch {args.batch} must divide by the "
                         f"query-axis size {Q}")
    info("sharded mesh", graph=G, query=Q, exchange=args.exchange or "dense")
    return ShardedTopkRunner(
        g, mesh, rcfg, idx, k=args.k, delta_stride=args.delta_stride,
        accept_slack=args.accept_slack, exchange=args.exchange,
        chips_per_host=args.chips_per_host)


def _write_output(path: str, results: dict) -> None:
    """Per-query results as JSONL (source, ids, vals) — the machine-readable
    counterpart of the reference's per-query result files."""
    with open(path, "w") as f:
        for s, (ids, vals) in sorted(results.items()):
            f.write(json.dumps({
                "source": int(s),
                "ids": [int(x) for x in ids],
                "vals": [float(x) for x in vals]}) + "\n")
    info("results written", path=path, count=len(results))


def _batched(sources: np.ndarray, batch: int):
    """Pad the tail batch by repeating the last source (results discarded)."""
    for lo in range(0, len(sources), batch):
        chunk = sources[lo: lo + batch]
        pad = batch - len(chunk)
        yield np.concatenate([chunk, np.repeat(chunk[-1:], pad)]), len(chunk)


def _bippr_targets(args, g) -> np.ndarray:
    if args.target_file:
        return np.array([int(x) for x in
                         Path(args.target_file).read_text().split()])
    if g.n <= 4096:
        return np.arange(g.n)
    return np.sort(np.random.default_rng(args.seed)
                   .choice(g.n, args.bippr_targets, replace=False))


def main(argv=None) -> int:
    try:
        return _main(argv)
    except (ValueError, FileNotFoundError, NotImplementedError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


def _main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = _device(args)
    log = RunLog(args.runlog)
    timers = Timers()

    # sharded batch-topk/serve read the shard-aware graph store where one
    # exists: no global CSR is loaded and no partition pass runs
    g_store = None
    if args.graph_shards > 1 and args.action in ("batch-topk", "serve"):
        from .parallel.graph_store import ShardedGraphStore
        try:
            g_store = ShardedGraphStore(
                str(Path(args.prefix) / args.dataset), args.graph_shards)
            info("sharded graph store", dir=str(g_store.dir),
                 per_shard_mb=round(g_store.bytes_per_shard() / 1e6, 1))
        except FileNotFoundError:
            info("no sharded graph store; loading the graph (persist one "
                 "with the shard-graph action)")
    g = _load(args, dev) if g_store is None else None
    if args.action == "generate-ss-query":
        src = query_io.generate_sources(g, args.query_size, seed=args.seed)
        query_io.save_queries(src, str(_query_file(args)))
        info("query set written", path=str(_query_file(args)), count=len(src))
        return 0

    cfg = ForaConfig(alpha=args.alpha, epsilon=args.epsilon, delta=args.delta,
                     pfail=args.pfail, k=args.k)
    rcfg = cfg.resolved(*((g.n, g.m) if g is not None
                          else (g_store.n, g_store.m)))
    info("config", rmax=f"{rcfg.rmax:.3g}", omega_unit=f"{rcfg.omega_unit:.3g}",
         delta=f"{rcfg.delta:.3g}")

    if args.action == "gen-exact-topk":
        # batched on the device: one power iteration per batch of sources
        from .algo import exact
        sources = query_io.load_queries(str(_query_file(args)))
        out = Path(args.prefix) / args.dataset / "exact"
        out.mkdir(parents=True, exist_ok=True)
        with timers.phase("exact"):
            ids, vals = exact.exact_topk_many(g, sources, max(args.k, 500),
                                              alpha=args.alpha, device=dev)
        for s, i, v in zip(sources, ids, vals):
            np.savez(out / f"{int(s)}.npz", ids=i, vals=v)
        info("exact top-k written", dir=str(out), count=len(sources))
        print(timers.report(), file=sys.stderr)
        return 0

    if args.action == "shard-graph":
        from .parallel.graph_store import save_sharded_graph
        counts = [int(x) for x in
                  (args.shard_counts or str(args.graph_shards)).split(",")]
        for c in counts:
            if c < 2:
                raise ValueError(f"shard count {c} must be >= 2 "
                                 "(pass --shard-counts or --graph-shards)")
            with timers.phase(f"shard-graph-{c}"):
                d = save_sharded_graph(
                    g, str(Path(args.prefix) / args.dataset), c)
            info("sharded graph store written", dir=str(d), shards=c)
        print(timers.report(), file=sys.stderr)
        return 0

    sharded = args.graph_shards > 1
    if sharded and args.action not in ("batch-topk", "serve"):
        raise ValueError("--graph-shards applies to batch-topk and serve")
    # a sharded run places rows per shard and never the whole graph
    dg = None if sharded else to_device(g, hub_rows=args.hub_rows, device=dev)

    if args.action == "build":
        import shutil
        from . import index as widx
        ckpt = Path(_index_dir(args)) / ".build_ckpt"
        # every 8th chunk and always the last, so that a finished build's
        # log ends with a line saying so
        prog = (lambda i, n, cached: None
                if cached or ((i + 1) % 8 and i + 1 != n) else
                info("walk chunks", done=i + 1, total=n))
        with timers.phase("build"):
            try:
                idx = widx.build_walk_index(dg, rcfg, args.seed,
                                            checkpoint_dir=str(ckpt),
                                            progress=prog)
            except ValueError as e:
                if "checkpoint" not in str(e):
                    raise
                info("discarding stale build checkpoint", dir=str(ckpt))
                shutil.rmtree(ckpt, ignore_errors=True)
                idx = widx.build_walk_index(dg, rcfg, args.seed,
                                            checkpoint_dir=str(ckpt),
                                            progress=prog)
        widx.save(idx, rcfg, _index_dir(args), graph=g)
        shutil.rmtree(ckpt, ignore_errors=True)
        info("index built", dir=_index_dir(args), endpoints=idx.total_edges,
             bytes=sum(np.asarray(a).nbytes for a in (
                 idx.edge_src, idx.edge_dst, idx.counts_cum, idx.edge_mult)
                 if a is not None))
        if args.index_shards:
            from .parallel.graph_store import save_sharded_graph
            for gshards in [int(x) for x in args.index_shards.split(",")]:
                d = widx.save_sharded(idx, rcfg, _index_dir(args), gshards,
                                      graph=g)
                info("sharded store written", dir=str(d), shards=gshards)
                # the sharded index is read with the sharded graph store
                dgs = save_sharded_graph(
                    g, str(Path(args.prefix) / args.dataset), gshards)
                info("sharded graph store written", dir=str(dgs),
                     shards=gshards)
        print(timers.report(), file=sys.stderr)
        return 0

    if args.action == "sweep":
        # relative-error sweep vs epsilon (reference experiment protocol;
        # BASELINE config 2): mean/max relative error over pi > delta vs
        # the exact oracle, per epsilon, FORA+ indexed when --with-idx
        from . import index as widx
        from .algo import exact, fora as fora_algo
        from .ops.topk import topk_nodes
        sources = query_io.load_queries(str(_query_file(args)))[: args.batch]
        pad = args.batch - len(sources)
        src = torch.as_tensor(np.concatenate(
            [sources, np.repeat(sources[-1:], pad)]), dtype=torch.int32,
            device=dev)
        with timers.phase("exact-oracle"):
            X = exact.exact_ppr_power_batch(g, sources, alpha=args.alpha,
                                            device=dev)
        exacts = [X[:, b] for b in range(len(sources))]
        exact_topk = [np.argsort(-pi, kind="stable")[: args.k]
                      for pi in exacts]
        for eps in [float(x) for x in args.sweep_eps.split(",")]:
            rc = ForaConfig(alpha=args.alpha, epsilon=eps, delta=args.delta,
                            pfail=args.pfail).resolved(g.n, g.m)
            idx = None
            if args.with_idx:
                idx = widx.load(_index_dir(args), rc, graph=g)
            fn = fora_algo.make_fora_fn(dg, rc, index=idx)
            res = timers.timed(f"eps={eps}", fn, src,
                               derive_seed(args.seed, int(eps * 1e6)))
            ppr = res.ppr.double().cpu().numpy()
            pred_ids = topk_nodes(res.ppr, args.k)[1].cpu().numpy()
            maxres, meanres, precs, recs = [], [], [], []
            for b, pi in enumerate(exacts):
                maxres.append(metrics.max_relative_error(ppr[:, b], pi,
                                                         rc.delta))
                meanres.append(metrics.mean_relative_error(ppr[:, b], pi,
                                                           rc.delta))
                precs.append(metrics.precision_at_k(pred_ids[b],
                                                    exact_topk[b]))
                recs.append(metrics.recall_at_k(pred_ids[b], exact_topk[b]))
            rec = log.event("sweep", epsilon=eps, delta=rc.delta,
                            max_rel_err=float(np.max(maxres)),
                            mean_rel_err=float(np.mean(meanres)),
                            precision_at_k=float(np.mean(precs)),
                            recall_at_k=float(np.mean(recs)), k=args.k,
                            queries=len(sources))
            print(json.dumps(rec), flush=True)
        print(timers.report(), file=sys.stderr)
        return 0

    idx, graph_sha = None, None
    if args.with_idx:
        from . import index as widx
        graph_sha = (widx.graph_fingerprint(g) if g is not None
                     else g_store.graph_sha)
        if sharded:
            # the shard-aware index store where one exists: no global edge
            # array is loaded
            try:
                idx = widx.ShardedIndexStore(_index_dir(args),
                                             args.graph_shards, rcfg, graph=g)
                if g is None and graph_sha is not None \
                        and idx.meta.get("graph_sha") is not None \
                        and idx.meta["graph_sha"] != graph_sha:
                    raise ValueError(
                        "sharded index was built for a different graph "
                        "(fingerprint mismatch against the graph store)")
                info("sharded index store", dir=str(idx.dir),
                     per_shard_mb=round(idx.bytes_per_shard() / 1e6, 1))
            except FileNotFoundError:
                info("no sharded index store; loading the index (build "
                     "with --index-shards to persist shards)")
        if idx is None:
            idx = widx.load(_index_dir(args), rcfg, graph=g)
            info("index loaded", dir=_index_dir(args))

    if args.action == "serve":
        from .serve import serve_forever
        runner = _make_topk_runner(
            args, g_store if g_store is not None else g, dg, rcfg, idx, dev)
        if idx is not None and runner.load_level_stats(
                _level_stats_path(args), graph_sha):
            info("start level from persisted stats",
                 level=runner.auto_start_level)

        def query_fn(sources, seed):
            res = runner.query_pool(np.asarray(sources), int(seed),
                                    batch=args.batch)
            return res.node_ids, res.values

        # inflight=1: TopkRunner.query_pool keeps [n, batch] state and is
        # not thread-safe; the device serializes batches regardless.
        serve_forever(query_fn, batch=args.batch, k=args.k, port=args.port,
                      inflight=1)
        return 0

    # --- query actions ---
    sources = query_io.load_queries(str(_query_file(args)))

    exact_dir = Path(args.prefix) / args.dataset / "exact"
    results = {}

    if args.action in ("query",):
        from .algo import fora as fora_algo
        from .algo import montecarlo as mc_algo
        from .ops import push as push_ops
        from .ops.topk import topk_nodes
        if args.algo == "fora":
            fn = fora_algo.make_fora_fn(dg, rcfg, index=idx)
            run = lambda s, seed: fn(s, seed).ppr   # noqa: E731
        elif args.algo == "montecarlo":
            run = mc_algo.make_montecarlo_fn(dg, rcfg)
        elif args.algo == "bippr":
            from .algo import bippr as bippr_algo
            targets = _bippr_targets(args, g)
            tgt = torch.as_tensor(targets, dtype=torch.long, device=dev)
            bfn = bippr_algo.make_bippr_fn(dg, rcfg, targets)
            info("bippr", targets=len(targets),
                 rmax_b=f"{bfn.rmax_b:.3g}", walks=bfn.num_walks)

            def run(s, seed):
                est = bfn(s, seed)                           # [S, T]
                ppr = torch.zeros((g.n, est.shape[0]), dtype=torch.float32,
                                  device=dev)
                ppr[tgt] = est.T
                return ppr
        elif args.algo == "hubppr":
            from .algo import hubppr as hub_algo
            run = timers.timed("hub-build", hub_algo.make_hubppr_fn, dg,
                               rcfg, args.seed, num_hubs=args.num_hubs)
            fence(run.hub_index.pool)
            info("hub index built", hubs=run.hub_index.num_hubs,
                 pool=run.hub_index.pool_size)
        else:  # fwdpush
            def run(s, seed):
                return push_ops.push_only_estimate(
                    dg, s, rmax=rcfg.rmax / max(rcfg.omega_unit, 1.0),
                    alpha=rcfg.alpha, max_iters=2000)
        for chunk, valid in _batched(sources, args.batch):
            ppr = timers.timed("query", run,
                               torch.as_tensor(chunk, dtype=torch.int32,
                                               device=dev),
                               derive_seed(args.seed, int(chunk[0])))
            vals, ids = topk_nodes(ppr, args.k)
            vals, ids = vals.cpu().numpy(), ids.cpu().numpy()
            for b in range(valid):
                results[int(chunk[b])] = (ids[b], vals[b])
    elif args.action == "batch-topk":
        # level-pipelined pool scheduling: accepted queries exit early,
        # stragglers re-batch at deeper delta levels
        runner = _make_topk_runner(
            args, g_store if g_store is not None else g, dg, rcfg, idx, dev)
        if idx is not None and args.start_level is None and \
                runner.load_level_stats(_level_stats_path(args), graph_sha):
            info("start level from persisted stats",
                 level=runner.auto_start_level)
        pool_w = args.pool if args.pool > 0 else len(sources)
        defer = args.defer if pool_w < len(sources) else 0
        with timers.phase("topk"):
            res, _ = runner.query_pools(
                sources, args.seed, batch=args.batch, pool=pool_w,
                defer_below=defer, start_level=args.start_level)
            for i, s in enumerate(sources):
                results[int(s)] = (res.node_ids[i], res.values[i])
        if idx is not None and args.start_level is None:
            try:
                runner.save_level_stats(_level_stats_path(args), graph_sha)
            except OSError:
                pass  # read-only index dir
    else:  # topk
        runner = _make_topk_runner(args, g, dg, rcfg, idx, dev)
        for chunk, valid in _batched(sources, args.batch):
            res = timers.timed("topk", runner.query, chunk,
                               derive_seed(args.seed, int(chunk[0])))
            for b in range(valid):
                results[int(chunk[b])] = (res.node_ids[b], res.values[b])

    n_q = len(results)
    qps = n_q / max(timers.total.get("query", 0) + timers.total.get("topk", 0),
                    1e-9)
    info("queries done", count=n_q, qps=f"{qps:.2f}")

    if args.output:
        _write_output(args.output, results)

    if args.eval_exact:
        from .algo import exact
        ex = {}
        missing = []
        for s in results:
            f = exact_dir / f"{s}.npz"
            if f.exists():
                ex[s] = np.load(f)["ids"][: args.k]
            else:
                missing.append(s)
        if missing:   # one batched power iteration for the rest
            ids, _ = exact.exact_topk_many(g, missing, args.k,
                                           alpha=args.alpha, device=dev)
            ex.update(zip(missing, ids))
        precs = [metrics.precision_at_k(ids[: args.k], ex[s])
                 for s, (ids, _) in results.items()]
        info("precision", at_k=args.k, mean=f"{float(np.mean(precs)):.4f}")
        log.event("eval", precision_at_k=float(np.mean(precs)), k=args.k,
                  queries=n_q, qps=qps, timers=timers.as_dict())
    else:
        log.event("run", queries=n_q, qps=qps, timers=timers.as_dict())

    print(timers.report(), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
