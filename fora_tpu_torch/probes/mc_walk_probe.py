"""K6+K4-src's forms on Monte Carlo's and HubPPR's chunks, timed on the card
beside the package's kernel and the chain it replaced.

    python -m fora_tpu_torch.probes.mc_walk_probe [--chunks NAME ...]
        [--forms NAME ...] [--walks-per-lane K ...]

The chunks are ``chip_smoke.py``'s, on bench.py's graph (RMAT n = 2^19, m
= 2^23, seed 7, merged) at its configuration (eps 0.5, k 50, the first 32
sources from seed 8), 2^22 walks from each source under seed 7:

  - ``mc``: Monte Carlo's chunk (phase 11), uniform hops;
  - ``mc_alias``: the same on bench.py's weighted graph (weights
    exp2(U(-2, 2)) from default_rng(7 + 31), phase 13): alias hops;
  - ``hub``: HubPPR's query chunk at the CLI's defaults (phase 14: 256
    hubs, a pool of 2^22 entries a hub), the hub branch.

For each it prints the device milliseconds (``utils.timing.device_ms``)
of:

  - (a) the chain the paths ran before: K4 (K4-alias, K4-hub) on
    ``sources.repeat(2^22)``, then K6-accum of the constant weight;
  - (b) K6-accum alone on the chain's endpoints with a weight array:
    every lane 1 / 2^22 (``accum_array``), the walks of no hop weighing 0
    (``accum_no_zero_hop``: K6-accum skips a lane of weight 0, so this
    takes the source's hot word away from it) and every walk that ends at
    its source weighing 0 (``accum_no_source``); and the library call,
    ``scatter_add_`` over the int64 endpoints;
  - (c) K6+K4 (the raw walk's fused kernel) on the one-hot residue r =
    e_{sources[b]} with omega_unit = 2^22, the same walks (not for the
    hub branch, which K6+K4 lacks);
  - (d), (e) the package's K6+K4-src (columns interleaved across warp
    tiles, the walks that end at the source counted in a register, the
    other walks that end in one step added by endpoint groups) and the
    other forms of ``mc_walk_forms.cu`` (built alone by
    ``build.load_alone``): ``no_count`` (no count and no groups after a
    hop; the refill's walks grouped, as K6+K4 does), ``alone`` (the count,
    a RED for every other walk), ``none`` (a RED a walk),
    ``column_major`` (``alone`` in K6+K4's tile order, this kernel's first
    form) and ``column_major_group`` (the package's adds in that order),
    ``table`` (``alone`` with a warp's other walks counted in a 256-slot
    table in shared memory, flushed when its tile is done), ``blocks8``
    and ``blocks4`` (``alone`` at 8 or 4 blocks an SM), each at 4, 8, 16
    and 32 walks per lane.

Every form's endpoints (its ``ends`` output) are held bit-equal to the
chain's K4 endpoints.  It ends with one JSON line and needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
FORMS = {"package": 0, "no_count": 1, "alone": 2, "none": 3,
         "column_major": 4, "column_major_group": 5, "table": 6,
         "blocks8": 7, "blocks4": 8}
WALKS_PER_LANE = (4, 8, 16, 32)
CHUNKS = ("mc", "mc_alias", "hub")
SEED = 7
ROWS = 1 << 22
SOURCES = 32
NUM_HUBS = 256


def load_forms():
    """mc_walk_forms.cu built alone, its entry point's signature set."""
    from ..kernels import build
    sig = [ctypes.c_int] + build.SIGNATURES["fora_source_walk"]
    return build.load_alone(HERE / "mc_walk_forms.cu",
                            {"fora_source_walk_form": sig})


def chunks(dev, names):
    """{name: (graph, sources, hub index or None, rcfg)} of ``names``."""
    import numpy as np
    from .. import ForaConfig
    from ..algo import hubppr
    from ..eval import queries as qio
    from ..graph import from_edges, generators, to_device
    g = generators.rmat(19, 1 << 23, seed=7)
    rcfg = ForaConfig(epsilon=0.5, k=50).resolved(g.n, g.m)
    src = torch.as_tensor(qio.generate_sources(g, 256, seed=8)[:SOURCES],
                          dtype=torch.int32, device=dev)
    out = {}
    if "mc" in names or "hub" in names:
        dg = to_device(g, merge_duplicate_edges=True, device=dev)
        if "mc" in names:
            out["mc"] = (dg, src, None, rcfg)
        if "hub" in names:
            P = hubppr.default_pool_size(rcfg, ROWS, NUM_HUBS)
            hub = hubppr.build_hub_index(dg, SEED, alpha=rcfg.alpha,
                                         num_hubs=NUM_HUBS, pool_size=P)
            out["hub"] = (dg, src, hub, rcfg)
    if "mc_alias" in names:
        rows = np.repeat(np.arange(g.n, dtype=np.int64),
                         np.asarray(g.out_deg, np.int64))
        w = np.exp2(np.random.default_rng(7 + 31).uniform(-2, 2, g.m))
        gw = from_edges(rows, np.asarray(g.out_indices, np.int64), g.n,
                        w=w.astype(np.float32))
        out["mc_alias"] = (to_device(gw, merge_duplicate_edges=True,
                                     device=dev), src, None, rcfg)
    return out


def launcher(c, forms, form, k, out, ends=None):
    """One launch of K6+K4-src's form ``form`` (the package's through its
    own library, another through ``forms``) at ``k`` walks per lane on
    chunk ``c``."""
    from .. import kernels
    from ..kernels import build, schedule
    dg, src, hub, rcfg = c
    dev, B, args, stream = kernels._source_walk_args(
        src, out, ROWS, dg.out_indptr, dg.out_indices, dg.alias_prob,
        dg.alias_other, None if hub is None else hub.hub_id,
        None if hub is None else hub.pool, SEED, rcfg.alpha,
        rcfg.max_walk_hops, 1.0 / ROWS, ends)
    tiles = -(-ROWS // (32 * k))
    plan = (k, tiles, -(-(tiles * B) // schedule.WALK_BLOCK_WARPS), stream)
    with torch.cuda.device(dev):
        err = (build.library().fora_source_walk(*args, *plan) if form == 0
               else forms.fora_source_walk_form(form, *args, *plan))
    kernels._raise_on(err, "mc_walk_probe")


def chain_parts(c):
    """The chain's endpoints [ROWS, B] and the device ms of its launches
    and of K6-accum's other weights and the library call on them."""
    from ..algo import hubppr
    from ..ops import walk
    from ..utils.timing import device_ms
    dg, src, hub, rcfg = c
    a, hops = rcfg.alpha, rcfg.max_walk_hops
    B = src.shape[0]
    start = src.repeat(ROWS)

    def k4():
        if hub is None:
            return walk.walk_endpoints(dg, start, SEED, a, hops)
        return hubppr.hub_walks(dg, start, SEED, hub, alpha=a, max_hops=hops)
    ends = k4().view(ROWS, B)
    out = torch.zeros((dg.n, B), device=src.device)
    w = torch.full((ROWS, B), 1.0 / ROWS, device=src.device)
    rec = {"K4": device_ms(k4, iters=5),
           "K6-accum": device_ms(lambda: walk.accumulate_endpoints(
               ends, 1.0 / ROWS, dg.n, out=out), iters=5)}
    rec["chain_sum"] = rec["K4"] + rec["K6-accum"]
    rec["accum_array"] = device_ms(lambda: walk.accumulate_endpoints(
        ends, w, dg.n, out=out), iters=5)
    zero_hop = walk.walk_lengths(SEED, ROWS * B, a, hops,
                                 src.device).view(ROWS, B) == 0
    w0 = torch.where(zero_hop, 0.0, w)
    rec["accum_no_zero_hop"] = device_ms(lambda: walk.accumulate_endpoints(
        ends, w0, dg.n, out=out), iters=5)
    home = ends == src[None, :]
    ws = torch.where(home, 0.0, w)
    rec["accum_no_source"] = device_ms(lambda: walk.accumulate_endpoints(
        ends, ws, dg.n, out=out), iters=5)
    rec["zero_hop_share"] = float(zero_hop.float().mean())
    rec["source_share"] = float(home.float().mean())
    del w0, ws, zero_hop, home
    e64 = ends.long()
    rec["library_scatter_add"] = device_ms(
        lambda: out.scatter_add_(0, e64, w), iters=5)
    del e64, w
    if hub is None:      # (c) K6+K4 on the one-hot residue
        r = torch.zeros((dg.n, B), device=src.device)
        r[src.long(), torch.arange(B, device=src.device)] = 1.0
        d = walk.walk_demand(r, float(ROWS))
        got = torch.full((ROWS, B), -1, dtype=torch.int32, device=src.device)
        walk.raw_walk_chunk(dg, r, d, 0, ROWS, SEED, a, hops, out, ends=got)
        if not torch.equal(got, ends):
            raise SystemExit("mc_walk_probe: K6+K4 on the one-hot residue "
                             f"ends {int((got != ends).sum())} walks "
                             "elsewhere than K4")
        rec["raw_walk_one_hot"] = device_ms(lambda: walk.raw_walk_chunk(
            dg, r, d, 0, ROWS, SEED, a, hops, out), iters=5)
        del got, r, d
    return ends, rec


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
        print("mc_walk_probe: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    forms = load_forms()
    result = {"device": torch.cuda.get_device_name(0)}
    for name, c in chunks(dev, args.chunks).items():
        dg, src, hub, _ = c
        B = src.shape[0]
        alias = dg.alias_prob is not None
        k_plan = schedule.raw_walk_plan(ROWS, B, sm_count(dev),
                                        alias).walks_per_lane
        print(f"{name}: {B} sources x {ROWS} walks"
              + (f", {hub.num_hubs} hubs x {hub.pool_size} pool entries"
                 if hub is not None else "")
              + f"; the plan's walks per lane {k_plan}", flush=True)
        want, rec = chain_parts(c)
        rec["k_plan"] = k_plan
        print("  " + ", ".join(f"{k} {v:.4f}" for k, v in rec.items()
                               if isinstance(v, float)), flush=True)
        out = torch.zeros((dg.n, B), device=dev)
        for form in args.forms:
            f = FORMS[form]
            for k in args.walks_per_lane:
                got = torch.full_like(want, -1)
                launcher(c, forms, f, k, out, got)
                if not torch.equal(got, want):
                    raise SystemExit(f"mc_walk_probe: {form} at k = {k} on "
                                     f"{name}: {int((got != want).sum())} "
                                     "endpoints differ from K4's")
                rec[f"{form} k{k}"] = device_ms(
                    lambda: launcher(c, forms, f, k, out), iters=5)
                print(f"  {form:12s} k = {k:2d}: {rec[f'{form} k{k}']:.4f} "
                      f"ms device", flush=True)
        result[name] = rec
        del c, dg, src, hub, out, want
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
