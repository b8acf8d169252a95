"""K3's probe on the card: what each pass of the split accept's selection
costs, and how its tunables trade against each other.

    python -m fora_tpu_torch.probes.topk_probe [--device cuda:0]

The state is a real one: the bench graph (RMAT n = 2^19, m = 2^23, seed
7), 128 sources pushed and walked by one raw-walk level at the default
config's final rmax, so p + contrib has a PPR column's zeros and tail.
It prints, each as kernel ms from CUDA events:

- K3 at [n, 128], its dense path alone, and ``torch.topk`` of the sum (a
  yardstick for the selection, not a counterpart: no tie order by id, no
  bounds);
- K3's passes by device time (torch.profiler);
- the threshold sample's stride against the candidates it leaves: a
  denser sample costs more to sort and leaves fewer candidates;
- the shapes of the other paths: B = 64 (the raw-walk pool) and n / 4 rows
  (one shard of four).
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import numpy as np
import torch

from .. import ForaConfig, kernels
from ..algo import bounds
from ..algo.fora import raw_lean_state
from ..graph import generators, to_device
from ..ops import push
from ..utils.timing import cuda_ms

NLOG2, EDGEF, SEED, B, K, EPS = 19, 16, 7, 128, 50, 0.5


def level_state(device):
    """(p, contrib, s2) of one raw-walk level on the bench graph."""
    g = generators.rmat(NLOG2, (1 << NLOG2) * EDGEF, seed=SEED)
    rcfg = ForaConfig(epsilon=EPS, k=K).resolved(g.n, g.m)
    dg = to_device(g, merge_duplicate_edges=True, device=device)
    src = torch.as_tensor(np.random.default_rng(SEED + 1).choice(
        g.n, B, replace=False).astype(np.int32), device=device)
    st = push.init_state(g.n, src)
    p, _, contrib, _, _ = raw_lean_state(dg, st.p, st.r, SEED, rcfg.rmax,
                                         rcfg.omega_unit, rcfg=rcfg)
    t = bounds.union_bound_t(g.n, 5, rcfg.pfail)
    s2 = float(np.float32(2.0 * t) * bounds._c(rcfg.omega_unit))
    return p, contrib.contiguous(), s2


def run(p, contrib, s2, **kw):
    return kernels.topk_bounds(p, contrib, K, s2, 1.0 + EPS, **kw)


def same(a, b) -> bool:
    return all(torch.equal(x.view(torch.uint8), y.view(torch.uint8))
               for x, y in zip(a, b))


def passes(p, contrib, s2, calls: int = 10) -> list:
    """(kernel name, device ms per call) of K3's passes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run(p, contrib, s2)
        torch.cuda.synchronize()
    out = []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
            out.append((e.key, us / 1e3 / calls, e.count // calls))
    return sorted(out, key=lambda x: -x[1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("topk_probe: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device(args.device)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    p, contrib, s2 = level_state(dev)
    n = p.shape[0]
    ref = run(p, contrib, s2)
    stats = kernels.topk_bounds_stats()
    cand = stats["candidates"]
    if stats["dense_columns"] or not same(ref, run(p, contrib, s2)):
        raise SystemExit("topk_probe: a dense column, or two launches differ")
    if not same(ref, run(p, contrib, s2, stride=0)):
        raise SystemExit("topk_probe: the dense path differs")
    print(f"K3 at [{n}, {B}], k = {K}: {cuda_ms(lambda: run(p, contrib, s2)):.4f}"
          f" ms; candidates mean {cand.mean():.1f} largest {cand.max()}; "
          f"dense path alone "
          f"{cuda_ms(lambda: run(p, contrib, s2, stride=0)):.4f} ms; "
          f"torch.topk(p + contrib, {K + 1}, dim=0) "
          f"{cuda_ms(lambda: torch.topk(p + contrib, K + 1, dim=0)):.4f} ms; "
          f"the add alone {cuda_ms(lambda: p + contrib):.4f} ms")
    for name, ms, count in passes(p, contrib, s2):
        print(f"  pass {name[:70]}: {ms:.4f} ms per call, {count} launches")
    for stride in (4, 8, 16, 32, 40, 64):
        got = run(p, contrib, s2, stride=stride)
        st = kernels.topk_bounds_stats()
        ms = cuda_ms(lambda: run(p, contrib, s2, stride=stride))
        print(f"  stride {stride}: {ms:.4f} ms; candidates mean "
              f"{st['candidates'].mean():.1f} largest "
              f"{st['candidates'].max()}; {st['dense_columns']} dense "
              f"columns; bit-equal {same(ref, got)}")
    for label, (pp, cc) in {
            f"[{n}, 64]": (p[:, :64].contiguous(), contrib[:, :64].contiguous()),
            f"[{n // 4}, {B}]": (p[:n // 4], contrib[:n // 4]),
            f"[{n}, 1]": (p[:, :1].contiguous(), contrib[:, :1].contiguous()),
    }.items():
        print(f"  shape {label}: {cuda_ms(lambda: run(pp, cc, s2)):.4f} ms, "
              f"dense path alone "
              f"{cuda_ms(lambda: run(pp, cc, s2, stride=0), iters=3):.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
