"""Whole forward pushes, compacted (K5) and dense, timed in this checkout
and in another one on the same card, alternated.

    python -m fora_tpu_torch.probes.push_walls --other PATH \
        [--rounds 2] [--batches 1 8 32]

``PATH`` is the root of another checkout of this repository (for example
the parent commit, unpacked with ``git archive`` into a directory that
``.gitignore`` lists).  Each run is a subprocess that imports
``fora_tpu_torch`` from one checkout (``PYTHONPATH`` and the working
directory set to its root, so it builds that checkout's kernels into its
own ``build/``), generates bench.py's graph (RMAT n = 2^19, m = 2^23, seed
7), lays it out unmerged without the hub split (``chip_smoke.py`` phase
16's layout) and pushes from the first B query sources at the final
delta's rmax: dense, compacted, compacted, dense, dense, compacted after
one warm-up of each, synchronised at both ends.  It prints one JSON line
(each push's median of its three walls, in ms) and the runs go other,
this, this, other for each round; the medians over the runs are printed
at the end.  It uses only the API both checkouts share (``ops.push.
forward_push_from(compact_edges=)``) and needs a CUDA card.
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
import torch
import fora_tpu_torch
from fora_tpu_torch import ForaConfig
from fora_tpu_torch.algo.topk import delta_schedule
from fora_tpu_torch.eval import queries as qio
from fora_tpu_torch.graph import generators, to_device
from fora_tpu_torch.ops import push

dev = torch.device("cuda:0")
g = generators.rmat(19, 1 << 23, seed=7)
rcfg = ForaConfig(epsilon=0.5, k=50).resolved(g.n, g.m)
rmax = rcfg.with_delta(delta_schedule(rcfg, 50, stride=8.0)[-1]).rmax
sources = qio.generate_sources(g, 256, seed=8)
graph = to_device(g, device=dev)
out = {"package": fora_tpu_torch.__file__}
for B in json.loads(sys.argv[1]):
    src = torch.as_tensor(sources[:B], dtype=torch.int32, device=dev)

    def wall(cap):
        st = push.init_state(graph.n, src)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        push.forward_push_from(graph, st, rmax=rmax, alpha=rcfg.alpha,
                               compact_edges=cap)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3
    wall(0), wall(-1)
    walls = {0: [], -1: []}
    for cap in (0, -1, -1, 0, 0, -1):
        walls[cap].append(wall(cap))
    out[B] = {"dense": statistics.median(walls[0]),
              "compacted": statistics.median(walls[-1])}
print(json.dumps(out))
"""


def run(tree: Path, batches) -> dict:
    """One subprocess's walls in ``tree``: {B: {"dense", "compacted"}}."""
    env = dict(os.environ, PYTHONPATH=str(tree))
    proc = subprocess.run([sys.executable, "-c", RUN, json.dumps(batches)],
                          cwd=tree, env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"push_walls in {tree} failed:\n"
                         f"{proc.stderr[-4000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    if not line.pop("package").startswith(str(tree.resolve())):
        raise SystemExit(f"push_walls: {tree} did not import its own package")
    return {int(b): v for b, v in line.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path, required=True)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 8, 32])
    a = ap.parse_args(argv)
    trees = {"this": THIS, "other": a.other.resolve()}
    got = {"this": [], "other": []}
    for _ in range(a.rounds):
        for name in ("other", "this", "this", "other"):
            got[name].append(run(trees[name], a.batches))
            print(name, json.dumps(got[name][-1]), flush=True)
    for B in a.batches:
        med = {name: {k: statistics.median(r[B][k] for r in runs)
                      for k in ("dense", "compacted")}
               for name, runs in got.items()}
        print(f"whole push B={B}, medians over {2 * a.rounds} runs of each "
              f"checkout (each a median of 3): this dense "
              f"{med['this']['dense']:.3f} ms, compacted "
              f"{med['this']['compacted']:.3f}; other dense "
              f"{med['other']['dense']:.3f}, compacted "
              f"{med['other']['compacted']:.3f}")
    print(f"other checkout: {trees['other']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
