"""K6+K4-xp's forms on the raw one-shot's first walk chunk across
processes, timed on the card beside the package's two kernels, K6+K4's
sharded form and the earlier kernel.

    python -m fora_tpu_torch.probes.xp_walk_probe [--graphs NAME ...]
        [--forms NAME ...] [--inbox-k K ...] [--out FILE]

The chunk is ``chip_smoke.py`` phase 17's: bench.py's graph (RMAT n =
2^19, m = 2^23, seed 7; ``weighted``: the same edges weighted exp2(U(-2,
2)) from default_rng(7 + 31), phase 13's graph) at eps 0.5, k 50, the
first 32 of phase 9's sources (seed 8), pushed by the one-process
``ShardedForaEngine`` on 4 shards; the shards' demands, the plan's first
chunk and its seed (``first_chunk``); walked by 2 processes of 2 shards
simulated on the card (``ops.walk.xp_chunk_rounds`` over
``local_exchange``).  Each form runs the chunk's rounds itself, and its
endpoints over the rounds are held bit-equal to K6+K4's sharded form's:

  - ``package``: ``kernels.raw_walk_xp`` (round 0) and
    ``raw_walk_xp_inbox`` (the later rounds);
  - ``earlier``: the earlier kernel (``xp_walk_forms.cu``,
    ``fora_raw_walk_xp_earlier``, its plan ``earlier_plan``);
  - ``direct``: the package's two forms with the earlier per-group global
    atomic in place of the stage (what the outbox's atomics cost);
  - ``own6``, ``own5``: the own-lane form at 6 and 5 blocks an SM (the
    inbox form the package's); ``inbox8``, ``inbox6``: the inbox form at
    8 and 6 blocks an SM.

Then the package's inbox form with each ``--inbox-k`` as its plan's largest
walks a lane (``schedule.XP_INBOX_WALKS_PER_LANE``; the plan's rule takes
fewer where a round's records do not fill the card), the
package's rounds with each later round's inbox sorted by node first
(``torch.argsort`` of cur and the gather, their time counted), and the
own-lane form with one process holding all four shards (P = 1: the
chunk's every walk in one launch, as K6+K4's sharded form walks it).
Each launch is timed again on scratch outputs (``utils.timing.device_ms``,
3 launches after 1).  It prints the forms' registers and spills from the
compilers' nvcc.log files, per form round 0's and the later rounds'
device ms, launches and walks, then one JSON line (also written to
``--out`` where given) that also holds every launch's device ms.  It
needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
SHARDS, PROCS, SOURCES, SEED = 4, 2, 32, 7
FORMS = ("package", "earlier", "direct", "own6", "own5", "inbox8", "inbox6")
OWN_FORM = {"direct": 1, "own6": 2, "own5": 3}   # xp_walk_forms.cu's numbers
INBOX_FORM = {"direct": 1, "inbox8": 2, "inbox6": 3}
INBOX_KS = (1, 2, 4, 8, 16, 32)
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
EARLIER_SIG = [_P, _LL, _P, _LL, _P, _I, _LL, _I, _LL, _LL, _I, _I, _I, _I,
               _P, _LL, _P, _P, _LL, _P, _LL, _P, _P, _P, _P, _P,
               ctypes.c_ulonglong, _F, _I, _I, _LL, _LL, _P]


def load_forms():
    """xp_walk_forms.cu built alone, its entry points' signatures set."""
    from ..kernels import build
    sig = build.SIGNATURES
    return build.load_alone(HERE / "xp_walk_forms.cu", {
        "fora_raw_walk_xp_earlier": EARLIER_SIG,
        "fora_raw_walk_xp_form": [_I] + sig["fora_raw_walk_xp"],
        "fora_raw_walk_xp_inbox_form": [_I] + sig["fora_raw_walk_xp_inbox"]})


def registers(lib) -> list:
    """The ptxas lines (entry, registers, spills) of the K6+K4-xp kernels
    in the package's nvcc.log and in ``lib``'s (a load_alone library)."""
    from ..kernels import build
    out = []
    for log in (build.library_path().parent / "nvcc.log",
                Path(lib._name).parent / "nvcc.log"):
        name = None
        for line in log.read_text().splitlines():
            if "Compiling entry function" in line:
                name = line.split("'")[1]
            elif "Function properties for" in line:
                name = line.split("Function properties for")[-1].strip()
            elif name and "xp_" in name and ("Used" in line
                                             or "spill" in line):
                out.append(f"{log.parent.name}: {name}: "
                           + line.split("ptxas info    :")[-1].strip())
    return out


def earlier_plan(extent: int, Bc: int, n_in: int, sm_count: int,
                 alias: bool) -> tuple:
    """The earlier kernel's plan: (k, tiles, blocks), k of 1, 2, 4, 8, 16
    (alias 1, 2, 4) by raw_walk_plan's rule over both sources at its 4
    blocks an SM."""
    half = sm_count * 4 * 8 // 2
    k = 4 if alias else 16
    while k > 1 and extent * Bc + n_in < 32 * k * half:
        k //= 2
    tiles = -(-extent // (32 * k))
    return k, tiles, -(-(tiles * Bc + -(-n_in // (32 * k))) // 8)


def first_chunk(g, rcfg, sources, dev, seed: int = SEED) -> dict:
    """The raw one-shot's first walk chunk of ``sources`` on ``g`` as phase
    17's workers walk it: the one-process engine on SHARDS shards pushes
    them, the shards' demands and the plan give the chunk (columns c0 ..
    c1 - 1, lanes lo .. hi - 1) and its seed (the workers' topk at
    ``seed``, query group 0, chunk 0)."""
    from ..ops import walk
    from ..parallel import ShardedForaEngine, make_mesh
    eng = ShardedForaEngine(g, make_mesh(SHARDS), rcfg, k=50)
    ps, rs = eng.init_state(sources)
    eng.push(ps, rs)
    del ps
    ds, tot = walk.walk_demands(rs, rcfg.omega_unit)
    tot = tot.cpu().numpy().astype(np.int64)
    bnp = np.concatenate([np.zeros((1, tot.shape[1]), np.int64),
                          np.cumsum(tot, axis=0)])
    c0, c1, lo, hi = walk.plan_chunks(bnp[-1], walk.chunk_lanes(dev))[0]
    bnp = bnp[:, c0:c1].copy()
    return dict(csr=eng.placement.walk, rs=[r[:, c0:c1] for r in rs],
                ds=[d.columns(c0, c1) for d in ds], bnp=bnp,
                bounds=torch.as_tensor(bnp, device=dev), lo=lo, W=hi - lo,
                Bc=c1 - c0, chunk=(c0, c1, lo, hi), n_loc=eng.n_loc,
                seed=walk.derive_seed(walk.derive_seed(seed, 0), 0),
                alpha=rcfg.alpha, hops=rcfg.max_walk_hops)


def launch_args(c, q: int, P: int, r: int, inbox, box, cnt, part) -> tuple:
    """``ops.walk.raw_walk_xp_chunk``'s arguments for process q of P in
    round r of chunk ``c``."""
    from ..ops import walk
    L = SHARDS // P
    ext = walk.own_lanes(c["bnp"][q * L:q * L + L + 1], c["lo"], c["W"])[1]
    return (c["csr"].shards(q * L, (q + 1) * L), c["rs"][q * L:(q + 1) * L],
            c["ds"][q * L:(q + 1) * L],
            c["bounds"][q * L:q * L + L + 1].contiguous(), c["lo"], c["W"],
            ext if r == 0 else 0, q * L, SHARDS, c["seed"], c["alpha"],
            c["hops"], part, inbox, box, cnt)


def form_caller(forms, name: str):
    """``call(args, ends)``: one launch of form ``name`` (FORMS) on
    launch_args' ``args``, at its plan."""
    from .. import kernels
    from ..kernels import build, schedule
    from ..ops import walk

    def call(args, ends=None):
        (csr, rs, ds, bounds, lo, W, ext, shard0, G, seed, alpha, hops,
         part, inbox, box, cnt) = args
        if name == "package":
            walk.raw_walk_xp_chunk(*args, ends=ends)
            return
        L, n_loc, Bc = len(rs), csr.n_loc, part.shape[1]
        P, dev = G // L, part.device
        alias = csr.alias_prob is not None
        graph = kernels._xp_graph(csr.indptr, csr.indices, csr.alias_prob,
                                  csr.alias_other)
        out_ld = part.stride(0)
        stream, sm = kernels._stream(part), kernels.sm_count(dev)
        p = kernels._ptr
        own = (kernels._table(rs), rs[0].stride(0),
               kernels._table([d.cum for d in ds]),
               ds[0].cum.stride(1) if Bc > 1 else n_loc, p(bounds), L, n_loc,
               Bc, W, lo, n_loc, shard0, G, P, p(part), out_ld, p(ends))
        seeds = (seed % 2**64, kernels.inv_log1m_alpha(alpha), hops)
        if name == "earlier":
            k, tiles, blocks = earlier_plan(ext, Bc, inbox.shape[0], sm,
                                            alias)
            err = forms.fora_raw_walk_xp_earlier(
                *own, p(inbox), inbox.shape[0], p(box), box.shape[1], p(cnt),
                *graph, *seeds, k, tiles, blocks, stream)
        elif ext > 0:
            plan = schedule.xp_walk_plan(ext, Bc, 0, sm, alias).own
            tail = (p(box), box.shape[1], p(cnt), *graph, *seeds,
                    plan.walks_per_lane, plan.tiles, plan.blocks, stream)
            err = (forms.fora_raw_walk_xp_form(OWN_FORM[name], *own, *tail)
                   if name in OWN_FORM else
                   build.library().fora_raw_walk_xp(*own, *tail))
        else:
            n_in = inbox.shape[0]
            plan = schedule.xp_walk_plan(0, Bc, n_in, sm, alias).inbox
            head = (p(inbox), n_in, Bc, n_loc, shard0, L, G, P, p(part),
                    out_ld, p(ends), p(box), box.shape[1], p(cnt), *graph,
                    seed % 2**64, plan.walks_per_lane, plan.blocks, stream)
            err = (forms.fora_raw_walk_xp_inbox_form(INBOX_FORM[name], *head)
                   if name in INBOX_FORM else
                   build.library().fora_raw_walk_xp_inbox(*head))
        kernels._raise_on(err, f"xp_walk_probe {name}")
    return call


def run_rounds(c, P: int, call, sort: bool = False) -> dict:
    """The chunk's rounds over P simulated processes, every launch through
    ``call`` and timed again on scratch outputs: {"per": [(round, process,
    walks in, device ms)], "ends": every lane's endpoint over the rounds,
    "sent": records handed over per round}; with ``sort`` each later
    round's inbox is also sorted by node and timed so ("sorted": [(sort
    ms, launch ms)])."""
    from ..ops import walk
    from ..utils.timing import device_ms
    dev, W, Bc = c["bounds"].device, c["W"], c["Bc"]
    L = SHARDS // P
    ends = torch.full((W, Bc), -1, dtype=torch.int32, device=dev)
    per, ordered = [], []

    def launch(q, r, inbox, box, cnt):
        part = torch.zeros((SHARDS * c["n_loc"], Bc), device=dev)
        e = torch.full_like(ends, -1)
        call(launch_args(c, q, P, r, inbox, box, cnt, part), e)
        torch.maximum(ends, e, out=ends)
        if not box.shape[1]:
            return
        scratch = launch_args(c, q, P, r, inbox, torch.empty_like(box),
                              torch.empty_like(cnt), torch.zeros_like(part))
        per.append((r, q, box.shape[1],
                    device_ms(lambda: call(scratch), iters=3, warmup=1)))
        if sort and r > 0:
            def order():
                return inbox[torch.argsort(inbox[:, 1])]
            s = launch_args(c, q, P, r, order(), torch.empty_like(box),
                            torch.empty_like(cnt), torch.zeros_like(part))
            ordered.append((device_ms(order, iters=3, warmup=1),
                            device_ms(lambda: call(s), iters=3, warmup=1)))
    own = {q: walk.own_lanes(c["bnp"][q * L:q * L + L + 1], c["lo"], W)[0]
           for q in range(P)}
    counts = walk.xp_chunk_rounds(launch, walk.local_exchange, own, P, dev)
    return {"per": per, "ends": ends, "sorted": ordered,
            "sent": [int(m.sum()) for m in counts]}


def summary(per) -> dict:
    """Round 0's and the later rounds' device ms, launches and walks."""
    first = [x for x in per if x[0] == 0]
    later = [x for x in per if x[0] > 0]
    return {"round0_ms": sum(x[3] for x in first),
            "later_ms": sum(x[3] for x in later),
            "total_ms": sum(x[3] for x in per), "launches": len(per),
            "round0_walks": sum(x[2] for x in first),
            "later_walks": sum(x[2] for x in later),
            "rounds": 1 + max((x[0] for x in per), default=0)}


def reference(c) -> tuple:
    """K6+K4's sharded form on the chunk: its endpoints, device ms and the
    endpoint mass (its shards' partials summed)."""
    from ..ops import walk
    from ..utils.timing import device_ms
    dev, W, Bc = c["bounds"].device, c["W"], c["Bc"]
    outs = [torch.zeros((SHARDS * c["n_loc"], Bc), device=dev)
            for _ in range(SHARDS)]
    ref = torch.full((W, Bc), -1, dtype=torch.int32, device=dev)
    args = (c["csr"], c["rs"], c["ds"], c["bounds"], c["lo"], W, c["seed"],
            c["alpha"], c["hops"], outs)
    walk.raw_walk_sharded_chunk(*args, ends=ref)
    mass = sum(outs)
    return ref, device_ms(lambda: walk.raw_walk_sharded_chunk(*args)), mass


def graphs(names):
    """bench.py's graph, and its weighted form where asked; the config and
    the sources."""
    from .. import ForaConfig
    from ..eval import queries as qio
    from ..graph import from_edges, generators
    g = generators.rmat(19, 1 << 23, seed=SEED)
    rcfg = ForaConfig(epsilon=0.5, k=50).resolved(g.n, g.m)
    src = qio.generate_sources(g, 256, seed=SEED + 1)[:SOURCES]
    for name in names:
        if name == "uniform":
            yield name, g, rcfg, src
        else:
            rows = np.repeat(np.arange(g.n, dtype=np.int64),
                             np.asarray(g.out_deg, np.int64))
            w = np.exp2(np.random.default_rng(SEED + 31).uniform(-2, 2, g.m))
            yield name, from_edges(rows, np.asarray(g.out_indices, np.int64),
                                   g.n, w=w.astype(np.float32)), rcfg, src


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--graphs", nargs="+", default=["uniform", "weighted"],
                    choices=["uniform", "weighted"])
    ap.add_argument("--forms", nargs="+", default=list(FORMS), choices=FORMS)
    ap.add_argument("--inbox-k", nargs="*", type=int, default=list(INBOX_KS))
    ap.add_argument("--out", default=None,
                    help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("xp_walk_probe: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    forms = load_forms()
    result = {"device": torch.cuda.get_device_name(0),
              "registers": registers(forms)}
    for line in result["registers"]:
        print("  ptxas", line, flush=True)
    for gname, g, rcfg, src in graphs(args.graphs):
        c = first_chunk(g, rcfg, src, dev)
        del g
        ref, ref_ms, _ = reference(c)
        walked = int((ref >= 0).sum())
        rec = {"chunk": list(c["chunk"]), "walks": walked,
               "sharded_ms": ref_ms}
        print(f"{gname}: chunk {c['chunk']}, {walked} walks; K6+K4's sharded "
              f"form {ref_ms:.4f} ms device", flush=True)

        def run(label, P, call, sort=False):
            got = run_rounds(c, P, call, sort)
            if not torch.equal(got["ends"], ref):
                raise SystemExit(f"xp_walk_probe: {label} on {gname}: "
                                 f"{int((got['ends'] != ref).sum())} "
                                 "endpoints differ from K6+K4's sharded form")
            s = summary(got["per"])
            s["sent"] = got["sent"]
            s["per_launch"] = got["per"]    # (round, process, walks, ms)
            print(f"  {label:14s} round 0 {s['round0_ms']:.4f} ms "
                  f"({s['round0_walks']} walks), rounds 1-{s['rounds'] - 1} "
                  f"{s['later_ms']:.4f} ms ({s['later_walks']} walks), all "
                  f"{s['total_ms']:.4f} ms in {s['launches']} launches",
                  flush=True)
            rec[label] = s
            return got
        for name in args.forms:
            got = run(name, PROCS, form_caller(forms, name),
                      sort=name == "package")
            if got["sorted"]:
                sort_ms = sum(x[0] for x in got["sorted"])
                launch_ms = sum(x[1] for x in got["sorted"])
                rec["package"]["sorted_later_ms"] = launch_ms
                rec["package"]["sort_ms"] = sort_ms
                print(f"  {'sorted inbox':14s} rounds 1-: launches "
                      f"{launch_ms:.4f} ms + sorts {sort_ms:.4f} ms = "
                      f"{launch_ms + sort_ms:.4f} (unsorted "
                      f"{rec['package']['later_ms']:.4f})", flush=True)
        from ..kernels import schedule
        top = schedule.XP_INBOX_WALKS_PER_LANE
        for k in args.inbox_k:     # the inbox plan's largest walks a lane
            schedule.XP_INBOX_WALKS_PER_LANE = k
            run(f"inbox k{k}", PROCS, form_caller(forms, "package"))
        schedule.XP_INBOX_WALKS_PER_LANE = top
        run("P1 own", 1, form_caller(forms, "package"))
        result[gname] = rec
        del c, ref
        torch.cuda.empty_cache()
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
