"""The raw-walk paths' walls and stage times, in this checkout and in
another one on the same card, alternated; and one profile of each.

    python -m fora_tpu_torch.probes.raw_walls --other PATH [--rounds 1]

``PATH`` is the root of another checkout of this repository (for example
the parent commit, unpacked with ``git archive`` into a directory that
``.gitignore`` lists).  Each run is a subprocess that imports
``fora_tpu_torch`` from one checkout (``PYTHONPATH`` and the working
directory set to its root, so it builds that checkout's kernels into its
own ``build/``) and drives, on bench.py's graph (RMAT n = 2^19, m = 2^23,
seed 7) and ``chip_smoke.py``'s configuration (eps 0.5, k 50, delta
stride 8, accept slack 1, sources from seed 8):

  - the raw-walk pool of 64 queries (``chip_smoke.py`` phase 10: merged,
    131,072 hub rows, ``query_pool(batch=64, defer_below=32)`` and
    ``flush_deferred``) and the same on bench.py's weighted graph (phase
    13): wall and the stages' ms (push, alloc, walks, accum, accept,
    summed over the levels);
  - the sharded raw one-shot of 128 queries (phase 9: ``ShardedForaEngine``
    without an index, G = 4 on the one card) under dense and routed, and
    dense on the weighted graph: wall;
  - Monte Carlo of 32 queries (phase 11): wall;
  - HubPPR's queries of the same 32 sources at the CLI's defaults (phase
    14: 256 hubs, the default pool, 2^22 walks a query; the pool built
    once beforehand): wall;

each once to warm and three times timed (medians), then one raw pool, one
dense raw one-shot, one Monte Carlo and one HubPPR batch under
torch.profiler: device busy, idle share and the largest device records.
It prints one JSON line a run; the runs go other, this, this, other for
each round, and the medians over the runs of each checkout are printed
at the end.  It uses only the API both
checkouts share and needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

THIS = Path(__file__).resolve().parents[2]

RUN = r"""
import json, statistics, sys, time
import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
import fora_tpu_torch
from fora_tpu_torch import ForaConfig
from fora_tpu_torch.algo.hubppr import make_hubppr_fn
from fora_tpu_torch.algo.montecarlo import make_montecarlo_fn
from fora_tpu_torch.algo.topk import TopkRunner
from fora_tpu_torch.eval import queries as qio
from fora_tpu_torch.graph import from_edges, generators, to_device
from fora_tpu_torch.parallel import ShardedForaEngine, make_mesh

dev = torch.device("cuda:0")
g = generators.rmat(19, 1 << 23, seed=7)
rcfg = ForaConfig(epsilon=0.5, k=50).resolved(g.n, g.m)
rng = np.random.default_rng(7 + 31)
src_rows = np.repeat(np.arange(g.n, dtype=np.int64),
                     np.asarray(g.out_deg, np.int64))
gw = from_edges(src_rows, np.asarray(g.out_indices, np.int64), g.n,
                w=np.exp2(rng.uniform(-2, 2, g.m)).astype(np.float32))
out = {"package": fora_tpu_torch.__file__}


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def raw_pool(graph, src):
    runner = TopkRunner(graph, rcfg, k=50, index=None, delta_stride=8.0,
                        accept_slack=1.0)

    def once():
        _, stats = runner.query_pools(src, batch=64, defer_below=32)
        ms = {}
        for st in stats:
            for k, v in st["ms"].items():
                ms[k] = ms.get(k, 0.0) + v
        return ms
    return once


def measure(name, fn, stages=False):
    fn()
    walls, ms = [], []
    for _ in range(3):
        box = []
        walls.append(timed(lambda: box.append(fn())))
        ms.append(box[0])
    rec = {"wall_ms": statistics.median(walls), "walls": walls}
    if stages:
        rec["ms"] = {k: statistics.median(m[k] for m in ms) for k in ms[0]}
    out[name] = rec


def profiled(name, fn):
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with prof:
        wall = timed(fn)
    recs = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]

    def us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    busy = sum(us(e) for e in recs) / 1e3
    top = sorted(recs, key=us, reverse=True)[:12]
    out["profile " + name] = {
        "wall_ms": wall, "busy_ms": busy, "idle_share": 1 - busy / wall,
        "top": [[e.key[:70], us(e) / 1e3, e.count] for e in top]}


sources = qio.generate_sources(g, 256, seed=8)
dg = to_device(g, merge_duplicate_edges=True, hub_rows=131072, device=dev)
pool = raw_pool(dg, sources[:64])
measure("raw pool", pool, stages=True)
mc = make_montecarlo_fn(dg, rcfg)
measure("montecarlo", lambda: mc(sources[:32], 7))
profiled("montecarlo", lambda: mc(sources[:32], 7))
hub = make_hubppr_fn(dg, rcfg, 7, num_hubs=256)
measure("hubppr", lambda: hub(sources[:32], 7))
profiled("hubppr", lambda: hub(sources[:32], 7))
del hub
torch.cuda.empty_cache()
for mode in ("dense", "routed"):
    eng = ShardedForaEngine(g, make_mesh(4), rcfg, k=50, exchange=mode)
    one = (lambda e: lambda: e.topk(sources[:128], 7))(eng)
    measure("raw one-shot " + mode, one)
    if mode == "dense":
        profiled("raw one-shot dense", one)
    del eng
profiled("raw pool", pool)
del dg, mc
torch.cuda.empty_cache()
sw = qio.generate_sources(gw, 256, seed=8)
dgw = to_device(gw, merge_duplicate_edges=True, hub_rows=131072, device=dev)
measure("weighted raw pool", raw_pool(dgw, sw[:64]), stages=True)
del dgw
torch.cuda.empty_cache()
eng = ShardedForaEngine(gw, make_mesh(4), rcfg, k=50, exchange="dense")
measure("weighted raw one-shot dense", lambda: eng.topk(sw[:128], 7))
print(json.dumps(out))
"""


def run(tree: Path) -> dict:
    """One subprocess's record in ``tree``."""
    env = dict(os.environ, PYTHONPATH=str(tree))
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=tree, env=env,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"raw_walls in {tree} failed:\n"
                         f"{proc.stderr[-4000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    if not line.pop("package").startswith(str(tree.resolve())):
        raise SystemExit(f"raw_walls: {tree} did not import its own package")
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path, required=True)
    ap.add_argument("--rounds", type=int, default=1)
    a = ap.parse_args(argv)
    trees = {"this": THIS, "other": a.other.resolve()}
    got = {"this": [], "other": []}
    for _ in range(a.rounds):
        for name in ("other", "this", "this", "other"):
            got[name].append(run(trees[name]))
            print(name, json.dumps(got[name][-1]), flush=True)
    for key in got["this"][0]:
        if key.startswith("profile"):
            continue
        for name, runs in got.items():
            med = statistics.median(r[key]["wall_ms"] for r in runs)
            line = f"{key}, {name}: wall median {med:.3f} ms over " \
                   f"{len(runs)} runs"
            if "ms" in runs[0][key]:
                line += "; stages " + " ".join(
                    f"{k} {statistics.median(r[key]['ms'][k] for r in runs):.2f}"
                    for k in runs[0][key]["ms"])
            print(line)
    print(f"other checkout: {trees['other']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
