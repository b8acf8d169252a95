"""Small cells for the benchmark's CPU tests: a cell of BENCHMARK.json at
a scale a test can hold (the Kronecker graph at 2^scale nodes, the same
edge factor and law), its traffic cut to a few dozen queries."""

import copy
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from pprbench import harness  # noqa: E402


def tiny_spec(workload: str, scale: int = 11, root: Path = ROOT):
    spec = harness.cell_spec(workload, root=root)
    spec.config = copy.deepcopy(spec.config)
    spec.config["graph"]["scale"] = scale
    spec.config["fora"]["hub_rows"] = 64
    spec.traffic = dict(spec.traffic, batch_sources=64, pool=32, block=32,
                        defer_below=8, warmup_batches=1, trace_seconds=0.01,
                        reference_sample=32)
    return spec


def run(spec, seed: int = 12345678901, seconds: float = 0.5,
        trace: bool = False, patch=None) -> dict:
    return harness.run_cell(spec, seed, seconds, trace, "cpu",
                            time.perf_counter(), patch=patch)
