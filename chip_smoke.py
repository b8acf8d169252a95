#!/usr/bin/env python3
"""Drive fora_tpu_torch's indexed top-k query path once on one NVIDIA GPU.

    python3 chip_smoke.py                 # the checks below
    python3 chip_smoke.py --profile 10    # query-phase profile instead

The graph is bench.py's: RMAT n = 2^19, m = 2^23, seed 7, with the
duplicate-edge merge and a 131,072-row hub split; the queries are
bench.py's defaults (eps 0.5, k 50, delta = p_f = 1/n, alpha 0.2,
delta stride 8).  Phases, each printing its wall time and peak device
memory:

  1. device      refuse to run without CUDA; print the card and its
                 power limit (nvidia-smi)
  2. build       compile the CUDA kernels from fora_tpu_torch/kernels/csrc
                 into build/fora_tpu_torch/ (cached by source hash)
  3. kernels     K1 (push superstep, split and unsplit) and K4 (walks)
                 against their plain PyTorch versions on the card
  4. index       build the FORA+ index on the card (K4 + host pack), save
                 it under bench_data/torch_smoke/, load it back with mmap
  5. queries     256 sources as two pools of 128 through
                 TopkRunner.query_pool(defer_below=64) and flush_deferred
  6. kernels     K2 (every index bucket) and K3 (split accept) against
                 their plain versions on a real level's state
  7. quality     precision@50 of the first 32 queries against the exact
                 oracle (float64 power iteration on the card); must be
                 >= 0.95
  8. proof       every kernel launched in phases 4-5 (counts reset just
                 before phase 4, read just after phase 5), and neither JAX
                 nor the JAX package fora_tpu was imported

It prints one JSON line of per-kernel results, then, only if every phase
passed, the last line {"ok": true, "device": {...}}.  Any failure raises
and exits non-zero.

``--profile PAIRS`` runs phases 1, 2 and 4, then times the query phase
with the hub split on and off in PAIRS alternating pairs, and profiles one
more run of each with torch.profiler: device busy time, idle share and
per-kernel device time, with the full tables under chiprun_out/.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

NLOG2, EDGEF, SEED = 19, 16, 7
HUB_ROWS = 131072
BATCH, POOL, QUERIES, DEFER = 128, 128, 256, 64
K, EPS, DSTRIDE, ACCEPT = 50, 0.5, 8.0, 1.0
EVAL_N = 32
MIN_PRECISION = 0.95
WALK_CHECK = 1 << 22
ROOT = Path(__file__).resolve().parent
INDEX_DIR = ROOT / "bench_data" / "torch_smoke"
PROFILE_DIR = ROOT / "chiprun_out"
DEVICE = "cuda:0"


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def close(name, got, want, rtol, atol):
    """Max |got - want|; fails unless |got - want| <= atol + rtol |want|."""
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    max_err = float(err.max()) if err.numel() else 0.0
    if bool(bad.any()):
        fail(f"{name}: {int(bad.sum())} entries differ beyond rtol {rtol} "
             f"atol {atol} (max abs err {max_err:.3e})")
    return max_err


def foreign_modules() -> set:
    """Loaded modules of JAX or of the JAX package ``fora_tpu``."""
    return {m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "fora_tpu")}


def build_index(g, dg, rcfg):
    """The FORA+ index built on the card (K4 + host pack), saved under
    INDEX_DIR and loaded back through mmap."""
    from fora_tpu_torch import index as tidx
    t0 = time.perf_counter()
    built = tidx.build_walk_index(dg, rcfg, SEED)
    walks = int(tidx.index_counts(g.out_deg, rcfg).sum())
    print(f"index: {walks} walks -> {built.total_edges} index edges in "
          f"{time.perf_counter() - t0:.1f} s")
    tidx.save(built, rcfg, str(INDEX_DIR), graph=g)
    index = tidx.load(str(INDEX_DIR), rcfg, graph=g, mmap=True)
    if index.total_edges != built.total_edges:
        fail("index reload: edge count differs")
    return index


def run_queries(runner, sources, log=print):
    """bench.py's query phase: pools of POOL through query_pool, then
    flush_deferred.  Returns ({source: top-k ids}, accepted, levels used,
    wall seconds)."""
    import torch
    results, n_acc, levels = {}, 0, 0
    pools = [sources[i:i + POOL] for i in range(0, len(sources), POOL)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for pi, pool in enumerate(pools):
        res = runner.query_pool(pool, batch=BATCH, defer_below=DEFER)
        for i, s in enumerate(pool):
            if not res.deferred[i]:
                results[int(s)] = res.node_ids[i]
        n_acc += int(res.accepted.sum())
        levels = max(levels, res.levels_used)
        for st in runner.last_level_stats:
            log(f"  pool {pi} level {st['level']}: pending {st['pending']} "
                f"width {st['width']} batches {st['batches']} accepted "
                f"{st['accepted']} {st['secs']} s")
    dsrcs, dres = runner.flush_deferred(batch=BATCH)
    if dres is not None:
        for i, s in enumerate(dsrcs):
            results[int(s)] = dres.node_ids[i]
        n_acc += int(dres.accepted.sum())
        levels = max(levels, dres.levels_used)
        for st in runner.last_level_stats:
            log(f"  flush({len(dsrcs)}) level {st['level']}: pending "
                f"{st['pending']} width {st['width']} batches "
                f"{st['batches']} accepted {st['accepted']} {st['secs']} s")
    torch.cuda.synchronize()
    return results, n_acc, levels, time.perf_counter() - t0


def profile_queries(pairs, layouts, make_runner, sources):
    """Query-phase wall time per graph layout over ``pairs`` alternating
    pairs, then one torch.profiler run per layout."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    quiet = lambda *a: None   # noqa: E731
    for graph in layouts.values():          # warm-up, one run each
        run_queries(make_runner(graph), sources, quiet)
    walls = {name: [] for name in layouts}
    names = list(layouts)
    for i in range(pairs):
        for name in (names if i % 2 == 0 else names[::-1]):
            walls[name].append(run_queries(make_runner(layouts[name]),
                                           sources, quiet)[3])
    for name, w in walls.items():
        print(f"profile {name}: query wall over {len(w)} runs (s): "
              + " ".join(f"{x:.4f}" for x in w)
              + f"; median {statistics.median(w):.4f} mean "
              f"{statistics.mean(w):.4f}")
    PROFILE_DIR.mkdir(exist_ok=True)
    for name, graph in layouts.items():
        runner = make_runner(graph)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = run_queries(runner, sources, quiet)[3]
        ka = prof.key_averages()

        def dev_us(e):
            return getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0))
        busy_ms = sum(dev_us(e) for e in ka) / 1e3
        table = ka.table(sort_by="self_cuda_time_total", row_limit=30)
        out = PROFILE_DIR / f"profile_{name}.txt"
        out.write_text(table)
        print(f"profile {name}: profiled query wall {wall * 1e3:.1f} ms, "
              f"device busy {busy_ms:.1f} ms, idle share "
              f"{1 - busy_ms / (wall * 1e3):.3f} ({out.name})")
        for e in sorted(ka, key=dev_us, reverse=True)[:8]:
            if dev_us(e) > 0:
                print(f"  {e.key[:60]}: {dev_us(e) / 1e3:.2f} ms, "
                      f"{e.count} calls")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=int, default=0, metavar="PAIRS",
                    help="profile the query phase, hub split on and off, "
                         "instead of the checks")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    import numpy as np

    preloaded = foreign_modules()
    from fora_tpu_torch import ForaConfig
    from fora_tpu_torch import kernels
    from fora_tpu_torch.algo import bounds, exact
    from fora_tpu_torch.algo.topk import TopkRunner
    from fora_tpu_torch.eval import metrics
    from fora_tpu_torch.eval import queries as qio
    from fora_tpu_torch.graph import generators, to_device
    from fora_tpu_torch.kernels import build as kbuild
    from fora_tpu_torch.ops import gather, push, walk
    from fora_tpu_torch.utils.timing import Phase, cuda_ms

    dev = torch.device(DEVICE)
    rows = {}   # kernel name -> {max_abs_err, ms, plain_ms}

    # ---- 1. device -----------------------------------------------------
    with Phase("device"):
        kind = torch.cuda.get_device_name(0)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        print(f"device: {kind}; torch {torch.__version__} cuda "
              f"{torch.version.cuda}; count {torch.cuda.device_count()}")
        print(smi.splitlines()[0])

    # ---- 2. build ------------------------------------------------------
    with Phase("build"):
        lib_path = kbuild.build()
        kbuild.library()
        built = ("cached" if kbuild.last_build_secs is None
                 else f"{kbuild.last_build_secs:.1f} s")
        print(f"build: {lib_path} ({built})")
        log = lib_path.parent / "nvcc.log"
        for line in log.read_text().splitlines():
            if "Used" in line or "Compiling entry" in line:
                print("  ptxas:", line.split("ptxas info    :")[-1].strip())

    # ---- graph (host) ----------------------------------------------------
    with Phase("graph"):
        t0 = time.perf_counter()
        g = generators.rmat(NLOG2, (1 << NLOG2) * EDGEF, seed=SEED)
        print(f"graph: RMAT n={g.n} m={g.m} generated in "
              f"{time.perf_counter() - t0:.1f} s")
        rcfg = ForaConfig(epsilon=EPS, k=K).resolved(g.n, g.m)
        dg = to_device(g, merge_duplicate_edges=True, hub_rows=HUB_ROWS,
                       device=dev)
        dg_flat = to_device(g, merge_duplicate_edges=True, hub_rows=0,
                            device=dev)
        sources = qio.generate_sources(g, QUERIES, seed=SEED + 1)
        print(f"device graph: {dg.m_in} merged in-edges "
              f"({dg.in_src.shape[0]} tail + {dg.hub_dst.shape[0]} hub)")

    if args.profile:
        with Phase("index build"):
            index = build_index(g, dg, rcfg)

        def make_runner(graph):
            return TopkRunner(graph, rcfg, k=K, index=index,
                              delta_stride=DSTRIDE, accept_slack=ACCEPT)
        profile_queries(args.profile, {f"hub{HUB_ROWS}": dg, "flat": dg_flat},
                        make_runner, sources)
        return 0

    # ---- 3. K1 and K4 against their plain versions -----------------------
    with Phase("kernels K1 K4"):
        src128 = torch.as_tensor(sources[:BATCH], dtype=torch.int32,
                                 device=dev)
        thr = push.node_threshold(dg, rcfg.rmax)
        st = push.init_state(g.n, src128)
        for _ in range(4):   # a spread-out frontier, not the one-hot start
            st = push.superstep(dg, st, alpha=rcfg.alpha, thr=thr)

        def plain_superstep(graph, p, r):
            contrib = torch.empty_like(r)
            flag = torch.zeros(1, dtype=torch.int32, device=dev)
            push.push_prepass_plain(p, r, contrib, thr, graph.out_deg,
                                    push.out_weight(graph), rcfg.alpha)
            hub = graph.hub_split
            gather.gather_scatter_add_plain(
                r, contrib, graph.in_indptr, graph.in_src,
                edge_w=graph.in_w, thr=thr, mask=True,
                flag=None if hub else flag)
            if hub:
                gather.gather_scatter_add_plain(
                    r, contrib.index_select(0, graph.hub_ids),
                    graph.hub_indptr, graph.hub_src_local,
                    edge_w=graph.hub_w, thr=thr, flag=flag)
            return p, r, int(flag.item())

        def kernel_superstep(graph, p, r):
            flag = torch.zeros(1, dtype=torch.int32, device=dev)
            push.superstep(graph, push.PushState(p, r, 0), alpha=rcfg.alpha,
                           thr=thr, flag=flag)
            return p, r, int(flag.item())

        k1_err = 0.0
        results = {}
        for name, graph in (("split", dg), ("unsplit", dg_flat)):
            kp, kr, kf = kernel_superstep(graph, st.p.clone(), st.r.clone())
            pp, pr, pf = plain_superstep(graph, st.p.clone(), st.r.clone())
            if kf != pf:
                fail(f"K1 {name}: flag {kf} != plain {pf}")
            k1_err = max(k1_err,
                         close(f"K1 {name} p", kp, pp, 1e-5, 1e-7),
                         close(f"K1 {name} r", kr, pr, 1e-5, 1e-7))
            results[name] = (kp, kr, kf)
        close("K1 split vs unsplit p", results["split"][0],
              results["unsplit"][0], 1e-5, 1e-7)
        close("K1 split vs unsplit r", results["split"][1],
              results["unsplit"][1], 1e-5, 1e-7)
        del results
        # whole pushes from the one-hot start: split and unsplit converge
        # after the same number of supersteps
        iters = {}
        for name, graph in (("split", dg), ("unsplit", dg_flat)):
            s = push.forward_push(graph, src128, rmax=rcfg.rmax,
                                  alpha=rcfg.alpha,
                                  max_iters=rcfg.max_push_iters)
            iters[name] = (s.iters, s.p, s.r)
        if iters["split"][0] != iters["unsplit"][0]:
            fail(f"K1: split push took {iters['split'][0]} supersteps, "
                 f"unsplit {iters['unsplit'][0]}")
        # over a whole push the two summation orders can put an entry on
        # either side of its threshold in some superstep, which moves up to
        # one threshold's worth of mass (rmax * deg, about 1e-6 here)
        close("K1 push p", iters["split"][1], iters["unsplit"][1], 1e-5, 1e-6)
        close("K1 push r", iters["split"][2], iters["unsplit"][2], 1e-5, 1e-6)
        print(f"K1: superstep matches plain (split, unsplit), max abs err "
              f"{k1_err:.3e}; full push {iters['split'][0]} supersteps "
              f"both ways")
        del iters

        # timings at B = 128 on the spread-out state (scratch outputs)
        p_s, contrib_s = st.p.clone(), torch.empty_like(st.r)
        wsum = push.out_weight(dg)
        rows["push_prepass"] = dict(
            max_abs_err=k1_err,
            ms=cuda_ms(lambda: kernels.push_prepass(
                p_s, st.r, contrib_s, thr, dg.out_deg, wsum, rcfg.alpha)),
            plain_ms=cuda_ms(lambda: push.push_prepass_plain(
                p_s, st.r, contrib_s, thr, dg.out_deg, wsum, rcfg.alpha)))
        acc = torch.zeros_like(st.r)
        hub_vals = contrib_s.index_select(0, dg.hub_ids)

        def gather_k():
            kernels.gather_scatter_add(acc, contrib_s, dg.in_indptr,
                                       dg.in_src, edge_w=dg.in_w)
            kernels.gather_scatter_add(acc, hub_vals, dg.hub_indptr,
                                       dg.hub_src_local, edge_w=dg.hub_w)

        def gather_p():
            gather.gather_scatter_add_plain(acc, contrib_s, dg.in_indptr,
                                            dg.in_src, edge_w=dg.in_w)
            gather.gather_scatter_add_plain(acc, hub_vals, dg.hub_indptr,
                                            dg.hub_src_local, edge_w=dg.hub_w)

        rows["gather_scatter_add"] = dict(max_abs_err=k1_err,
                                          ms=cuda_ms(gather_k),
                                          plain_ms=cuda_ms(gather_p, iters=3))
        del p_s, contrib_s, acc, hub_vals, st

        # K4: 2^22 walks from one source, kernel vs plain run_walks
        start = torch.full((WALK_CHECK,), int(sources[0]), dtype=torch.int32,
                           device=dev)
        ends_k = walk.walk_endpoints(dg, start, SEED, rcfg.alpha,
                                     rcfg.max_walk_hops)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        ends_p = walk.run_walks(dg, start, generator=gen, alpha=rcfg.alpha,
                                max_hops=rcfg.max_walk_hops)
        f_k = torch.bincount(ends_k.long(), minlength=g.n).double() / WALK_CHECK
        f_p = torch.bincount(ends_p.long(), minlength=g.n).double() / WALK_CHECK
        top = torch.argsort(f_p, descending=True)[:1000]
        tv = 0.5 * float((f_k[top] - f_p[top]).abs().sum())
        walk_err = float((f_k[top] - f_p[top]).abs().max())
        print(f"K4: {WALK_CHECK} walks from node {int(sources[0])}: total "
              f"variation {tv:.4f} over the top-1000 endpoints (limit 0.01)")
        if not tv < 0.01:
            fail(f"K4 endpoint distribution: total variation {tv:.4f}")
        rows["index_walk"] = dict(
            max_abs_err=walk_err,
            ms=cuda_ms(lambda: walk.walk_endpoints(
                dg, start, SEED, rcfg.alpha, rcfg.max_walk_hops)),
            plain_ms=cuda_ms(lambda: walk.run_walks(
                dg, start, generator=gen, alpha=rcfg.alpha,
                max_hops=rcfg.max_walk_hops), iters=3))
        del start, ends_k, ends_p, f_k, f_p

    # ---- 4.-5. the main path: index build and queries ------------------
    kernels.reset_launch_counts()
    with Phase("index build"):
        index = build_index(g, dg, rcfg)
    with Phase("queries"):
        runner = TopkRunner(dg, rcfg, k=K, index=index, delta_stride=DSTRIDE,
                            accept_slack=ACCEPT)
        results, n_acc, levels, elapsed = run_queries(runner, sources)
        if len(results) != QUERIES:
            fail(f"{len(results)} of {QUERIES} queries answered")
        print(f"queries: {QUERIES} in {elapsed:.3f} s -> "
              f"{QUERIES / elapsed:.2f} q/s; levels used {levels}; "
              f"accepted {n_acc}/{QUERIES}")
    launches = kernels.launch_counts()

    # ---- 6. K2 and K3 against their plain versions -----------------------
    with Phase("kernels K2 K3"):
        level = len(runner.deltas) - 1
        depth, rmax, omega = runner._levels[level]
        staged = runner._staged
        p, r = runner._init_pool_state(src128)
        p, r, contrib, _ = staged.lean_state_fn(depth)(p, r, rmax, omega)
        inv = staged._inv_cnt(depth)
        k2_err, n_buckets = 0.0, 0
        for q, bucket in enumerate(staged._buckets):
            if bucket is None:
                continue
            indptr, src, mult = bucket
            got = kernels.index_spmv(torch.zeros_like(r), r, indptr, src,
                                     mult, inv)
            want = gather.gather_scatter_add_plain(
                torch.zeros_like(r), r, indptr, src, edge_w=mult, src_w=inv)
            k2_err = max(k2_err, close(f"K2 bucket {q}", got, want, 1e-5,
                                       1e-9))
            n_buckets += 1
        print(f"K2: {n_buckets} buckets match plain, max abs err "
              f"{k2_err:.3e}")
        acc = torch.zeros_like(r)

        def spmv(fn):
            def run():
                for q in range(depth, len(staged._buckets)):
                    if staged._buckets[q] is not None:
                        indptr, src, mult = staged._buckets[q]
                        fn(acc, r, indptr, src, mult, inv)
            return run

        rows["index_spmv"] = dict(
            max_abs_err=k2_err, ms=cuda_ms(spmv(kernels.index_spmv)),
            plain_ms=cuda_ms(spmv(
                lambda a, v, ip, s, m, w: gather.gather_scatter_add_plain(
                    a, v, ip, s, edge_w=m, src_w=w)), iters=3))
        del acc

        t = bounds.union_bound_t(rcfg.n, len(runner.deltas), rcfg.pfail)
        got = bounds.topk_with_bounds_split(p, contrib, omega, K, t, EPS)
        want = bounds.topk_with_bounds_split_plain(p, contrib, omega, K, t,
                                                   EPS)
        if not torch.equal(got[1], want[1]):
            fail("K3: top-k ids differ from plain")
        if not torch.equal(got[6], want[6]):
            fail("K3: accept differs from plain")
        k3_err = max(close(f"K3 {nm}", got[i], want[i], 1e-6, 0.0)
                     for i, nm in ((0, "vals"), (2, "lb"), (3, "ub"),
                                   (4, "lbk"), (5, "ub_excluded")))
        print(f"K3: ids and accept equal, max abs err {k3_err:.3e}; "
              f"{int(got[6].sum())}/{BATCH} accept at level {level}")
        rows["topk_bounds"] = dict(
            max_abs_err=k3_err,
            ms=cuda_ms(lambda: bounds.topk_with_bounds_split(
                p, contrib, omega, K, t, EPS)),
            plain_ms=cuda_ms(lambda: bounds.topk_with_bounds_split_plain(
                p, contrib, omega, K, t, EPS), iters=3))
        del p, r, contrib, got, want

    # ---- 7. quality ------------------------------------------------------
    with Phase("quality"):
        ev = sources[:EVAL_N]
        x = exact.exact_ppr_batch(g, ev, device=dev)
        ex = exact.topk_ids(x, K)
        pred = np.stack([results[int(s)] for s in ev])
        prec = metrics.batch_precision_at_k(pred, ex)
        # the exact top-k is ambiguous where rank k ties with nodes below it
        kth = x.T.gather(1, torch.as_tensor(ex[:, -1:], device=dev))
        tied = int(((x.T >= kth).sum(dim=1) > K).sum())
        print(f"precision@{K}: {prec:.4f} over {EVAL_N} queries "
              f"(limit {MIN_PRECISION}); {tied} of them have an exact tie "
              f"across rank {K}")
        if not prec >= MIN_PRECISION:
            fail(f"precision@{K} {prec:.4f} < {MIN_PRECISION}")

    # ---- 8. proof that the main path ran on the kernels ------------------
    print(f"launches in phases 4-5: {launches}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")
    loaded = sorted(foreign_modules() - preloaded)
    if loaded:
        fail(f"the port imported JAX or fora_tpu: {loaded[:5]}")
    meta = {
        "push_prepass": ("push_prepass.cu", "fora_tpu/ops/push.py:315"),
        "gather_scatter_add": ("gather_scatter.cu",
                               "fora_tpu/ops/push.py:142"),
        "index_spmv": ("gather_scatter.cu", "fora_tpu/algo/fora.py:352"),
        "topk_bounds": ("topk_bounds.cu", "fora_tpu/algo/bounds.py:112"),
        "index_walk": ("walk.cu", "fora_tpu/ops/walk.py:159"),
    }
    out = []
    for name, (src_file, replaces) in meta.items():
        row = rows[name]
        out.append({"name": name, "route": "cuda",
                    "source": f"fora_tpu_torch/kernels/csrc/{src_file}",
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                    "plain_ms": row["plain_ms"]})
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
