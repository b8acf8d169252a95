"""The frontier compaction on the card against another form of its source,
on the same inputs and timed the same way.

    python -m fora_tpu_torch.probes.compact_probe --against OTHER.cu \
        [--rounds 7] [--device cuda:0]

``OTHER.cu`` is another tree's ``kernels/csrc/exchange.cu`` (for example
the parent commit's, unpacked with ``git archive``); it is compiled alone
with this package's nvcc flags into the build root and loaded with ctypes
beside this tree's library.  Both export ``fora_frontier_compact`` with
the same C interface.

Inputs: one shard's [n_loc, B] block at bench.py's sharded shapes (n_loc
= 2^17, B = 128, 4 destinations, cap = n_loc / 8), made from a seed:

- ``superstep``: a share of the rows active and a share of those due to
  each destination, as on the routed pool's largest compacted superstep
  (about 12,600 rows due to each destination);
- ``all``: every row active and due everywhere, past cap (the counts of a
  superstep that falls back to the ring): the most claims.

Each round times this tree's kernel and the other's, in alternating order,
with ``utils.timing.device_ms`` (the host's enqueue hidden) and with
``cuda_ms`` (as called); it prints the median and the range of each over
the rounds, and checks that both give the same counts and, per
destination within cap, the same set of ids.  The as-called times
include this tree's wrapper (its checks in Python), which the other's
bare ctypes call does not have: only the device times compare the
kernels.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
from pathlib import Path

import numpy as np
import torch

from .. import kernels
from ..kernels import build
from ..utils.timing import cuda_ms, device_ms

N_LOC, B, D = 1 << 17, 128, 4
CASES = {"superstep": (0.15, 0.65), "all": (1.0, 1.0)}   # active, due


def load_other(src: Path) -> ctypes.CDLL:
    """``src`` compiled alone into a shared library (cached by its hash)."""
    name = "fora_frontier_compact"
    return build.load_alone(src, {name: build.SIGNATURES[name]})


def inputs(case: str, dev, seed: int = 3):
    active, due = CASES[case]
    rng = np.random.default_rng(seed)
    block = np.zeros((N_LOC, B), np.float32)
    act = rng.random(N_LOC) < active
    block[act] = rng.random((int(act.sum()), B), np.float32) + 0.5
    needed = (rng.random((D, N_LOC)) < due).astype(np.uint8)
    return (torch.as_tensor(block, device=dev),
            torch.as_tensor(needed, device=dev))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=Path, required=True)
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--device", default="cuda:0")
    a = ap.parse_args()
    dev = torch.device(a.device)
    other = load_other(a.against)
    cap = N_LOC // 8
    sms = kernels.sm_count(dev)
    for case in CASES:
        block, needed = inputs(case, dev)
        out = {}
        for name in ("this", "other"):
            out[name] = (torch.empty((D, cap), dtype=torch.int32, device=dev),
                         torch.empty((D, cap, B), device=dev),
                         torch.empty(D, dtype=torch.int32, device=dev))

        def this():
            ids, rows, cnt = out["this"]
            kernels.frontier_compact(block, needed, cap, 0, N_LOC, ids, rows,
                                     cnt)

        def theirs():
            ids, rows, cnt = out["other"]
            err = other.fora_frontier_compact(
                ctypes.c_void_p(block.data_ptr()), N_LOC, B,
                ctypes.c_void_p(needed.data_ptr()), D, cap, 0, N_LOC,
                ctypes.c_void_p(ids.data_ptr()), ids.stride(0),
                ctypes.c_void_p(rows.data_ptr()), rows.stride(0),
                ctypes.c_void_p(cnt.data_ptr()), sms, ctypes.c_void_p(
                    torch.cuda.current_stream(dev).cuda_stream))
            if err:
                raise RuntimeError(f"the other compaction: CUDA error {err}")

        this()
        theirs()
        torch.cuda.synchronize()
        if not torch.equal(out["this"][2], out["other"][2]):
            raise SystemExit(f"{case}: counts differ")
        for d in range(D):
            # past cap, which rows take the slots depends on the claims
            if int(out["this"][2][d]) > cap:
                continue
            a_ids = torch.sort(out["this"][0][d])[0]
            b_ids = torch.sort(out["other"][0][d])[0]
            if not torch.equal(a_ids, b_ids):
                raise SystemExit(f"{case}: destination {d}'s ids differ")
        times = {(n, how): [] for n in ("this", "other")
                 for how in ("device", "called")}
        for r in range(a.rounds):
            order = (("this", this), ("other", theirs))
            for name, fn in order if r % 2 == 0 else order[::-1]:
                times[(name, "device")].append(device_ms(fn))
                times[(name, "called")].append(cuda_ms(fn))
        counts = out["this"][2].tolist()
        print(f"compaction, {case}: [{N_LOC}, {B}], {D} destinations, cap "
              f"{cap}, counts {counts}, {a.rounds} rounds")
        for (name, how), ts in times.items():
            print(f"  {name:5s} {how:6s}: median {statistics.median(ts):.4f}"
                  f" ms, range {min(ts):.4f}-{max(ts):.4f}")
    print(f"other source: {a.against}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
