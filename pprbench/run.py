"""One run of one cell of fora_tpu_torch's benchmark.

    python3 pprbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the cell's CUDA cards.
Set-up (the graph made on the card from the seed, the program's layout,
its index, a warm-up of the cell's shapes) is timed from the process's
start; then the window runs for ``--seconds``; then the plain reference
judges a sample of the window's answers.  The last line of standard
output is the result; the compared numbers, each with its limit, are the
last lines of standard error.  ``--trace 1`` reports the per-layer
metrics, from a profiled stretch of the window, instead of the
end-to-end ones.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from pprbench import harness
    return harness.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
