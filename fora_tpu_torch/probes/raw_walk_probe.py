"""K6+K4's forms on two raw walk chunks, timed on the card beside the
package's kernel and the chain it replaced.

    python -m fora_tpu_torch.probes.raw_walk_probe [--chunks NAME ...]
        [--forms NAME ...] [--walks-per-lane K ...]

The package's kernel (``kernels/csrc/walk.cu``: a warp-wide search for a
tile's first lane, ``__launch_bounds__(256, 6)``, only the walks of no hop,
ended in the refill, grouped by endpoint and a RED for every other walk)
runs beside the forms that ``raw_walk_forms.cu`` keeps, built alone
(``build.load_alone``), each differing in one choice: ``lane_search`` (a
tile's first lane bisected by each lane alone, 19 dependent probes at 2^19
nodes), ``blocks4`` and ``blocks8`` (4 and 8 blocks an SM in the launch
bounds: at most 64 and 32 registers), ``group_every`` (every step's ends
grouped by endpoint) and ``group_none`` (a RED a walk).  The chunks are on
bench.py's graph (RMAT n = 2^19, m = 2^23, seed 7) at ``chip_smoke.py``'s
configuration (eps 0.5, k 50, sources from seed 8):

  - ``sharded``: the sharded raw one-shot's first 16 queries after the
    push at the final rmax, G = 4 shards on the one card, every lane of
    their demand in one chunk (``chip_smoke.py`` phase 9's allocation);
  - ``pool``: the same 16 queries pushed on the one device to an eighth
    of the final rmax (fewer walks a column, as a pool's deeper levels
    demand), every lane in one chunk, unsharded;
  - ``sharded_alias``: ``sharded`` on bench.py's weighted graph (the same
    edges, weights exp2(U(-2, 2)) from default_rng(7 + 31), as
    ``chip_smoke.py`` phase 13 builds it): the alias hops.

Each form runs at 4 (K4's k, the plan's for alias hops), 8, 16 (the
plan's for uniform hops) and 32 walks per lane (``--walks-per-lane``);
every run's endpoints are held bit-equal to the package's kernel's on the
same chunk.  It prints the device milliseconds (``utils.timing.device_ms``)
of each, beside the chain's three launches (K6-expand, K4, K6-accum), then
one JSON line.  It needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
# form: its number in raw_walk_forms.cu's fora_raw_walk_form (0: the package)
FORMS = {"package": 0, "lane_search": 1, "blocks4": 2, "blocks8": 3,
         "group_every": 4, "group_none": 5}
WALKS_PER_LANE = (4, 8, 16, 32)
CHUNKS = ("sharded", "pool", "sharded_alias")
SEED = 7


def load_forms():
    """raw_walk_forms.cu built alone, its entry point's signature set."""
    from ..kernels import build
    sig = [ctypes.c_int] + build.SIGNATURES["fora_raw_walk"]
    return build.load_alone(HERE / "raw_walk_forms.cu",
                            {"fora_raw_walk_form": sig})


def sharded_chunk(g, rcfg, src) -> dict:
    """The sharded raw one-shot's chunk of ``src`` on ``g``."""
    from ..ops import walk
    from ..parallel import ShardedForaEngine, make_mesh
    eng = ShardedForaEngine(g, make_mesh(4), rcfg, k=50)
    ps, rs = eng.init_state(src)
    eng.push(ps, rs)
    ds, tot = walk.walk_demands(rs, rcfg.omega_unit)
    tot = tot.long()
    bounds = torch.cat([torch.zeros_like(tot[:1]), tot.cumsum(0)])
    return dict(graph=eng.placement.walk, rs=rs, ds=ds, bounds=bounds,
                W=int(bounds[-1].max()), n_out=rs[0].shape[0] * len(rs),
                rcfg=rcfg)


def chunks(dev, names):
    """The chunks of ``names``: {name: dict of what K6+K4 and the chain
    take}."""
    import numpy as np
    from .. import ForaConfig
    from ..eval import queries as qio
    from ..graph import from_edges, generators, to_device
    from ..ops import push, walk
    g = generators.rmat(19, 1 << 23, seed=7)
    rcfg = ForaConfig(epsilon=0.5, k=50).resolved(g.n, g.m)
    src = qio.generate_sources(g, 256, seed=8)[:16]
    omega = rcfg.omega_unit
    out = {}
    if "sharded" in names:
        out["sharded"] = sharded_chunk(g, rcfg, src)
    if "pool" not in names:
        dg = None
    else:
        dg = to_device(g, merge_duplicate_edges=True, device=dev)
    if dg is not None:
        st = push.forward_push(dg, torch.as_tensor(src, dtype=torch.int32,
                                                   device=dev),
                               rmax=rcfg.rmax / 8, alpha=rcfg.alpha,
                               max_iters=rcfg.max_push_iters)
        d = walk.walk_demand(st.r, omega)
        out["pool"] = dict(graph=dg, rs=[st.r], ds=[d], bounds=None,
                           W=int(d.total.max()), n_out=g.n, rcfg=rcfg)
    if "sharded_alias" not in names:
        return out
    rows = np.repeat(np.arange(g.n, dtype=np.int64),
                     np.asarray(g.out_deg, np.int64))
    w = np.exp2(np.random.default_rng(7 + 31).uniform(-2, 2, g.m))
    gw = from_edges(rows, np.asarray(g.out_indices, np.int64), g.n,
                    w=w.astype(np.float32))
    out["sharded_alias"] = sharded_chunk(gw, rcfg, src)
    return out


def launcher(c, forms, form, k, outs, ends=None):
    """One launch of K6+K4's form ``form`` (the package's through its own
    library, another through ``forms``) at ``k`` walks per lane on chunk
    ``c``."""
    from .. import kernels
    from ..kernels import build, schedule
    rs, ds, W = c["rs"], c["ds"], c["W"]
    a, hops = c["rcfg"].alpha, c["rcfg"].max_walk_hops
    g = c["graph"]
    if c["bounds"] is None:
        got = kernels._raw_walk_args(
            rs[0], ds[0].cum, ds[0].total, outs[0], W, g.out_indptr,
            g.out_indices, g.alias_prob, g.alias_other, SEED, a, hops,
            ends=ends)
    else:
        got = kernels._raw_walk_args(
            rs, [d.cum for d in ds], None, outs, W, g.indptr, g.indices,
            g.alias_prob, g.alias_other, SEED, a, hops, bounds=c["bounds"],
            n_loc=g.n_loc, ends=ends)
    dev, Bc, args, stream = got
    tiles = -(-W // (32 * k))
    plan = (k, tiles, -(-(tiles * Bc) // schedule.WALK_BLOCK_WARPS), stream)
    with torch.cuda.device(dev):
        err = (build.library().fora_raw_walk(*args, *plan) if form == 0
               else forms.fora_raw_walk_form(form, *args, *plan))
    kernels._raise_on(err, "raw_walk_probe")


def chain_ms(c) -> dict:
    """Device ms of the chain's three launches on chunk ``c``."""
    from ..ops import walk
    from ..utils.timing import device_ms
    rs, ds, W, g = c["rs"], c["ds"], c["W"], c["graph"]
    a, hops = c["rcfg"].alpha, c["rcfg"].max_walk_hops
    if c["bounds"] is None:
        start, weight = walk.expand_lanes(rs[0], ds[0], 0, W)
        expand = (lambda: walk.expand_lanes(rs[0], ds[0], 0, W))
    else:
        n_loc = g.n_loc
        start, weight = walk.expand_chunk_lanes(rs, ds, c["bounds"], 0, W,
                                                n_loc)
        expand = (lambda: walk.expand_chunk_lanes(rs, ds, c["bounds"], 0, W,
                                                  n_loc))
    ends = walk.walk_endpoints(g, start.view(-1), SEED, a, hops).view(
        start.shape)
    outs = [torch.zeros(c["n_out"], rs[0].shape[1], device=start.device)
            for _ in rs]
    if c["bounds"] is None:
        accum = (lambda: walk.accumulate_endpoints(ends, weight, c["n_out"],
                                                   out=outs[0]))
    else:
        accum = (lambda: walk.accumulate_chunk_endpoints(
            ends, weight, outs, c["bounds"], 0))
    return {"K6-expand": device_ms(expand),
            "K4": device_ms(lambda: walk.walk_endpoints(
                g, start.view(-1), SEED, a, hops)),
            "K6-accum": device_ms(accum)}


def main(argv=None) -> int:
    import argparse
    from ..kernels import schedule, sm_count
    from ..utils.timing import device_ms
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chunks", nargs="+", default=list(CHUNKS),
                    choices=CHUNKS)
    ap.add_argument("--forms", nargs="+", default=list(FORMS),
                    choices=list(FORMS))
    ap.add_argument("--walks-per-lane", nargs="+", type=int,
                    default=list(WALKS_PER_LANE))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("raw_walk_probe: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    forms = load_forms()
    result = {"device": torch.cuda.get_device_name(0)}
    for name, c in chunks(dev, args.chunks).items():
        Bc = c["rs"][0].shape[1]
        k_plan = schedule.raw_walk_plan(
            c["W"], Bc, sm_count(dev),
            c["graph"].alias_prob is not None).walks_per_lane
        walked = int(c["bounds"][-1].sum() if c["bounds"] is not None
                     else c["ds"][0].total.sum())
        print(f"{name}: {c['W']} x {Bc} lane slots, {walked} walks; the "
              f"plan's walks per lane {k_plan}", flush=True)
        outs = [torch.zeros(c["n_out"], Bc, device=dev) for _ in c["rs"]]
        want = torch.full((c["W"], Bc), -1, dtype=torch.int32, device=dev)
        launcher(c, forms, 0, k_plan, outs, want)
        rec = {"walks": walked, "k_plan": k_plan, "chain": chain_ms(c)}
        rec["chain_sum"] = sum(rec["chain"].values())
        for form in args.forms:
            f = FORMS[form]
            for k in args.walks_per_lane:
                got = torch.full_like(want, -1)
                launcher(c, forms, f, k, outs, got)
                if not torch.equal(got, want):
                    raise SystemExit(f"raw_walk_probe: {form} at k = {k} "
                                     f"on {name}: {int((got != want).sum())}"
                                     " endpoints differ from the package's")
                rec[f"{form} k{k}"] = device_ms(
                    lambda: launcher(c, forms, f, k, outs))
                print(f"  {form:12s} k = {k:2d}: {rec[f'{form} k{k}']:.4f} "
                      f"ms device", flush=True)
        print("  the chain: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                          rec["chain"].items())
              + f"; sum {rec['chain_sum']:.4f} ms device", flush=True)
        result[name] = rec
        del c, outs, want
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
