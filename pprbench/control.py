"""The control of the correctness check: a cell's runs with the program
at a looser epsilon than the configuration states (each of ``--factors``
times it: fewer walks, a shallower push), judged by the stated epsilon.
The guarantee it breaks is the configuration's own (relative error at
most epsilon above delta), so ``correct`` has to come out false where
the break is wide enough for the limits to see.  A factor of 1 is the
sound program, for readings of the compared numbers on many seeds in one
process.  Not part of the benchmark's runs.

    python3 pprbench/control.py --workload <name> --seeds <s1,s2,...> \
        --seconds <s> [--factors 2,4,8]

Each factor and seed is a run of its own in this process (the device's
peak memory is the first run's); one JSON line a run: the factor, the
seed, ``correct`` and the compared numbers.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--factors", default="8")
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from pprbench import harness
    spec = harness.cell_spec(args.workload)
    for factor in (float(f) for f in args.factors.split(",")):
        spec.control_factor = factor
        for seed in (int(s) for s in args.seeds.split(",")):
            res = harness.run_cell(spec, seed, args.seconds, False,
                                   args.device, time.perf_counter())
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "factor": factor, "correct": res["correct"],
                              "precision_at_k":
                              res["metrics"]["precision_at_k"]["value"],
                              "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
