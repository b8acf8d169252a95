"""The index build across two gloo workers on one card, in this checkout
and in another one, alternated: each build's wall, and in a checkout whose
build logs it, the wall's split.

    python -m fora_tpu_torch.probes.build_walls --other PATH [--rounds 2]
        [--builds 3]

``PATH`` is the root of another checkout of this repository (for example
the parent commit, unpacked with ``git archive`` into a directory that
``.gitignore`` lists).  Each round starts one world per checkout, in the
order other, this, this, other: two workers of
``parallel.multihost_driver`` over gloo on cuda:0, each importing the
checkout's ``fora_tpu_torch`` (``PYTHONPATH`` and the working directory
its root, so it builds that checkout's kernels into its own ``build/``),
running ``--builds`` build jobs of ``chip_smoke.py`` phase 17 (each
tree's kernels built beforehand): the FORA+
index of bench.py's graph (RMAT n = 2^19, m = 2^23, seed 7, generated by
each worker) at eps 0.5, k 50, seed 7, chunks of 2^23, 4 shards over the
2 workers.  It prints one line a world (each build's wall, the largest
over the ranks, with its rounds and, where logged, rank 0's split: placing,
K4-xp's launches, the counts' all-gather and host read, the all-to-all,
the endpoints' all-reduce, the pack, and the launches' CUDA events), then
per checkout every wall with its min, median and max, and one JSON line.
It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

THIS = Path(__file__).resolve().parents[2]
BUILD = {"runner": "build", "epsilon": 0.5, "k": 50,
         "graph": {"rmat": [19, 1 << 23, 7]}, "seed": 7,
         "chunk_lanes": 1 << 23}


def world(tree: Path, builds: int, timeout: float = 900.0) -> list:
    """One world of two workers in ``tree``: each build's records, one per
    rank."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    spec = {"shards": 4, "jobs": [dict(BUILD, name=f"build_{i}")
                                  for i in range(builds)]}
    env = dict(os.environ, PYTHONPATH=str(tree), OMP_NUM_THREADS="4")
    with tempfile.TemporaryDirectory(dir=THIS / "build") as tmp:
        out = Path(tmp)
        (out / "spec.json").write_text(json.dumps(spec))
        ps = [subprocess.Popen(
            [sys.executable, "-m", "fora_tpu_torch.parallel.multihost_driver",
             "--coordinator", f"localhost:{port}", "--processes", "2",
             "--rank", str(q), "--backend", "gloo", "--device", "cuda:0",
             "--spec", str(out / "spec.json"), "--out", str(out)],
            cwd=tree, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for q in range(2)]
        try:
            logs = [p.communicate(timeout=timeout)[0] for p in ps]
        finally:
            for p in ps:
                if p.poll() is None:
                    p.kill()
        if any(p.returncode for p in ps):
            raise SystemExit(f"build_walls: a worker in {tree} failed:\n"
                             + "\n".join(x[-3000:] for x in logs))
        recs = [json.loads((out / f"rank{q}.json").read_text())["jobs"]
                for q in range(2)]
    return [[r[f"build_{i}"] for r in recs] for i in range(builds)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--builds", type=int, default=3)
    args = ap.parse_args(argv)
    other = Path(args.other).resolve()
    for tree in (other, THIS):      # each tree's kernels, built before timing
        subprocess.run([sys.executable, "-c", "from fora_tpu_torch.kernels "
                        "import build; build.library()"], cwd=tree, check=True,
                       env=dict(os.environ, PYTHONPATH=str(tree)))
    walls = {"other": [], "this": []}
    splits = []
    for _ in range(args.rounds):
        for side in ("other", "this", "this", "other"):
            tree = other if side == "other" else THIS
            for ranks in world(tree, args.builds):
                wall = max(r["wall_s"] for r in ranks)
                walls[side].append(wall)
                split = ranks[0].get("split_s")
                if split:
                    splits.append(split)
                print(f"{side}: wall {wall:.4f} s, rounds "
                      f"{ranks[0]['rounds']}"
                      + (f", rank 0's split (s) "
                         f"{ {k: round(v, 4) for k, v in split.items()} }, "
                         f"launches {ranks[0]['walk_device_ms']:.4f} ms "
                         f"device" if split else ""), flush=True)
    summary = {side: {"walls": w, "min": min(w), "median":
                      statistics.median(w), "max": max(w)}
               for side, w in walls.items()}
    if splits:
        summary["this"]["split_median_s"] = {
            k: statistics.median(x[k] for x in splits) for k in splits[0]}
    for side, rec in summary.items():
        print(f"{side}: {len(rec['walls'])} builds, wall min "
              f"{rec['min']:.4f} median {rec['median']:.4f} max "
              f"{rec['max']:.4f} s")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
