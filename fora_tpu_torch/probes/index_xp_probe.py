"""K4-xp's forms on the index build across processes, timed on the card
beside the package's two kernels: the earlier per-chunk forms and the
package's forms at other residencies.

    python -m fora_tpu_torch.probes.index_xp_probe [--graphs NAME ...]
        [--forms NAME ...] [--out FILE]

The build is ``chip_smoke.py`` phase 15's: bench.py's graph (RMAT n =
2^19, m = 2^23, seed 7; ``weighted``: the same edges weighted exp2(U(-2,
2)) from default_rng(7 + 31), phase 13's graph) at eps 0.5, k 50, its
index walks in chunks of 2^23 at seed 7 (``setup``), its 4 shards over 2
processes simulated on the card (``ops.walk.xp_chunk_rounds`` over
``local_exchange``).  Each form walks the whole build, and its endpoints
are held bit-equal to K4's sharded form's on each chunk (``reference``):

  - ``package``: ``kernels.index_walk_xp`` (round 0) and
    ``index_walk_xp_inbox`` (the later rounds), over windows of whole
    chunks (``schedule.build_windows``: the build is one window);
  - ``earlier``: the earlier forms (``index_xp_forms.cu``), a round loop
    a chunk, their plan as it was (``earlier_plan``);
  - ``own4``, ``own6``: the own-start form at 4 and 6 blocks an SM (the
    package's 8; the inbox form the package's); ``inbox6``, ``inbox8``:
    the inbox form at 6 and 8 blocks an SM (the package's 4);
    ``claims``: the inbox form at 8 blocks taking a claim of at most 128
    records at a time and sending its stage out after each (the
    package's streams its claims and loads its next batch ahead).

Then the package's forms with each ``--claim-max`` as its inbox plan's
largest claim in 32-record groups (``schedule.INDEX_XP_CLAIM_MAX``), and
with one process holding all four shards (P = 1).  Each launch is timed again on scratch outputs (``utils.timing.
device_ms``, 3 launches after 1, each with counts of its own zeroed
beforehand).  It prints the forms' registers and spills from the
compilers' nvcc.log files, per form and round the device ms and records,
then one JSON line (also written to ``--out`` where given).  It needs a
CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
SHARDS, PROCS, SEED, CHUNK = 4, 2, 7, 1 << 23
FORMS = ("package", "earlier", "own4", "own6", "inbox6", "inbox8", "claims")
INBOX_FORM = {"inbox6": 6, "inbox8": 8, "claims": 18}  # index_xp_forms.cu's
CLAIMS_MAX = 4      # the claim-at-a-time form's claims fit a warp's stage
_P, _I, _LL, _F, _U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float, ctypes.c_ulonglong)
EARLIER_SIG = [_P, _LL, _LL, _P, _I, _I, _I, _I, _I, _P, _LL, _P, _P, _P, _P,
               _P, _U, _F, _I, _I, _LL, _P]
EARLIER_INBOX_SIG = [_P, _LL, _P, _I, _I, _I, _I, _I, _P, _LL, _P, _P, _P,
                     _P, _P, _U, _I, _LL, _P]


def load_forms():
    """index_xp_forms.cu built alone, its entry points' signatures set."""
    from ..kernels import build
    sig = build.SIGNATURES
    return build.load_alone(HERE / "index_xp_forms.cu", {
        "fora_index_walk_xp_earlier": EARLIER_SIG,
        "fora_index_walk_xp_inbox_earlier": EARLIER_INBOX_SIG,
        "fora_index_walk_xp_form": [_I] + sig["fora_index_walk_xp"],
        "fora_index_walk_xp_inbox_form": [_I] + sig[
            "fora_index_walk_xp_inbox"]})


def setup(g, rcfg, dev, seed: int = SEED, chunk: int = CHUNK) -> dict:
    """The build's walks on ``g``: the out-CSR cut over SHARDS shards on
    ``dev``, the index walks' starts (sorted by node) on the card, their
    running counts ``cum`` [n + 1], the chunk and the seed."""
    from ..index.build import index_counts
    from ..index.build_sharded import shard_out_csr
    counts = index_counts(g.out_deg, rcfg)
    starts = np.repeat(np.arange(g.n, dtype=np.int32), counts)
    return dict(csr=shard_out_csr(g, [dev] * SHARDS), total=len(starts),
                starts=torch.from_numpy(starts).to(dev),
                cum=np.concatenate([[0], np.cumsum(counts)]), chunk=chunk,
                seed=seed, alpha=rcfg.alpha, hops=rcfg.max_walk_hops)


def reference(s) -> tuple:
    """K4's sharded form on each chunk (the one-process sharded build's
    walk): every endpoint of the build, and the chunks' device ms."""
    from ..ops import walk
    from ..utils.timing import device_ms
    ends, ms = [], 0.0
    for i, lo in enumerate(range(0, s["total"], s["chunk"])):
        chunk = s["starts"][lo:lo + s["chunk"]]
        args = (s["csr"], chunk, s["seed"] + (i << 32), s["alpha"],
                s["hops"])
        ends.append(walk.walk_endpoints(*args))
        ms += device_ms(lambda: walk.walk_endpoints(*args), iters=3,
                        warmup=1)
    return torch.cat(ends), ms


def earlier_plan(W: int, n_in: int, sm: int) -> tuple:
    """The earlier forms' plan: (k, blocks) of the own-start form (K4's
    rule at 4 blocks an SM) and of the inbox form (xp_walk_plan's)."""
    from ..kernels import schedule
    k = schedule._fill_k(W, schedule.WALKS_PER_LANE, 4, sm)
    own = schedule.walk_grid(W, k).blocks if W else 0
    inbox = schedule.xp_walk_plan(0, 0, n_in, sm).inbox
    return k, own, inbox.walks_per_lane, inbox.blocks


def form_caller(forms, name: str):
    """``call(args)``: one launch of form ``name`` (FORMS) on the
    arguments of ``ops.walk.index_walk_xp_chunk`` (a window's, or for
    ``earlier`` a chunk's: w0 and wlo chunk-relative, the chunk's seed),
    at its plan."""
    from .. import kernels
    from ..kernels import build, schedule
    from ..ops import walk

    def call(args):
        (csr, start, w0, wlo, cl, shard0, G, seed, alpha, hops, inbox, box,
         cnt, ends) = args
        if name == "package":
            walk.index_walk_xp_chunk(*args)
            return
        L, dev = len(csr.indptr), ends.device
        P, sm, p = G // L, kernels.sm_count(dev), kernels._ptr
        graph = kernels._xp_graph(csr.indptr, csr.indices, csr.alias_prob,
                                  csr.alias_other)
        head = (p(box), box.shape[1], p(cnt))
        W, n_in = start.shape[0], inbox.shape[0]
        stream = kernels._stream(ends)
        if name == "earlier":
            k, blocks, k_in, blocks_in = earlier_plan(W, n_in, sm)
            if W:
                err = forms.fora_index_walk_xp_earlier(
                    p(start), W, w0, p(ends), L, csr.n_loc, shard0, G, P,
                    *head, *graph, seed % 2**64,
                    kernels.inv_log1m_alpha(alpha), hops, k, blocks, stream)
            else:
                err = forms.fora_index_walk_xp_inbox_earlier(
                    p(inbox), n_in, p(ends), csr.n_loc, shard0, L, G, P,
                    *head, *graph, seed % 2**64, k_in, blocks_in, stream)
        elif W:
            plan = schedule.index_xp_plan(W, 0, sm).own
            args = (p(start), W, w0, p(ends), wlo, ends.shape[0], cl,
                    *schedule.chunk_divisor(cl), L, csr.n_loc, shard0, G, P,
                    *head, *graph, seed % 2**64,
                    kernels.inv_log1m_alpha(alpha), hops,
                    plan.walks_per_lane, plan.blocks, stream)
            err = (forms.fora_index_walk_xp_form(int(name[3:]), *args)
                   if name.startswith("own") else
                   build.library().fora_index_walk_xp(*args))
        else:
            plan = schedule.index_xp_plan(0, n_in, sm).inbox
            args = (p(inbox), n_in, p(ends), wlo, ends.shape[0], cl,
                    *schedule.chunk_divisor(cl), csr.n_loc, shard0, L, G, P,
                    *head, *graph, seed % 2**64,
                    CLAIMS_MAX if name == "claims" else plan.claim_max,
                    plan.blocks, stream)
            err = (forms.fora_index_walk_xp_inbox_form(INBOX_FORM[name], *args)
                   if name in INBOX_FORM else
                   build.library().fora_index_walk_xp_inbox(*args))
        kernels._raise_on(err, f"index_xp_probe {name}")
    return call


def run_build(s, P: int, call, per_chunk: bool = False, check=None) -> dict:
    """The build's walks over P simulated processes of SHARDS / P shards,
    every launch through ``call`` (form_caller's) and timed again on
    scratch outputs: over its windows (``schedule.build_windows``), or
    with ``per_chunk`` a round loop a chunk as the earlier forms ran.
    Each launch writes its endpoints into fresh ones (-1 elsewhere), taken
    into the process's by a max; ``check(q, r, args)``, where given, runs
    after each launch (chip_smoke's comparison with the plain version).  Returns {"per": [(window or
    chunk, round, process, walks in, device ms)], "ends": every walk's
    endpoint, "sent": records handed over per round and window,
    "rounds": rounds per window, "once": whether every walk ended in one
    process}, each launch in "per" also with its ms as called."""
    from ..kernels import schedule
    from ..index.build_sharded import own_run
    from ..ops import walk
    from ..utils.timing import cuda_ms, device_ms
    csr, dev, cl = s["csr"], s["starts"].device, s["chunk"]
    L = SHARDS // P
    rows = L * csr.n_loc
    total = s["total"]
    ends = torch.full((total,), -1, dtype=torch.int32, device=dev)
    per, sent, rounds, once = [], [], [], True
    spans = ([(lo, min(lo + cl, total)) for lo in range(0, total, cl)]
             if per_chunk else schedule.build_windows(total, cl))
    for i, (lo, hi) in enumerate(spans):
        W = hi - lo
        runs = {q: own_run(s["cum"], lo, W, q * rows, (q + 1) * rows)
                for q in range(P)}
        e = [torch.full((W,), -1, dtype=torch.int32, device=dev)
             for _ in range(P)]
        # the earlier forms take a chunk's walks keyed from 0 at its seed
        base, seed = ((lo, s["seed"] + ((lo // cl) << 32)) if per_chunk
                      else (0, s["seed"]))

        def args_of(q, r, inbox, box, cnt, ends_q):
            a, b = runs[q] if r == 0 else (0, 0)
            return (csr.shards(q * L, (q + 1) * L),
                    s["starts"][lo + a:lo + b], lo + a - base, lo - base,
                    cl, q * L, SHARDS, seed, s["alpha"], s["hops"], inbox,
                    box, cnt, ends_q)

        def launch(q, r, inbox, box, cnt):
            fresh = torch.full((W,), -1, dtype=torch.int32, device=dev)
            args = args_of(q, r, inbox, box, cnt, fresh)
            called = cuda_ms(lambda: call(args), iters=1, warmup=0)
            if check is not None:
                check(q, r, args)
            torch.maximum(e[q], fresh, out=e[q])
            if not box.shape[1]:
                return
            zeros = iter(torch.zeros((8, cnt.shape[0]), dtype=torch.int32,
                                     device=dev))
            scratch = torch.empty_like(box), torch.full_like(e[q], -1)
            per.append((i, r, q, box.shape[1], device_ms(
                lambda: call(args_of(q, r, inbox, scratch[0], next(zeros),
                                     scratch[1])), iters=3, warmup=1),
                called))
        ms = walk.xp_chunk_rounds(launch, walk.local_exchange,
                                  {q: b - a for q, (a, b) in runs.items()},
                                  P, dev, words=1)
        ends[lo:hi] = torch.stack(e).max(0).values
        once &= bool((sum((x >= 0).int() for x in e) == 1).all())
        sent.append([int(m.sum()) for m in ms])
        rounds.append(len(ms))
    return {"per": per, "ends": ends, "sent": sent, "rounds": rounds,
            "once": once}


def summary(per) -> dict:
    """Round 0's and the later rounds' device ms, launches and walks."""
    first = [x for x in per if x[1] == 0]
    later = [x for x in per if x[1] > 0]
    return {"round0_ms": sum(x[4] for x in first),
            "later_ms": sum(x[4] for x in later),
            "total_ms": sum(x[4] for x in per), "launches": len(per),
            "called_ms": sum(x[5] for x in per),
            "round0_launches": len(first), "later_launches": len(later),
            "round0_walks": sum(x[3] for x in first),
            "later_walks": sum(x[3] for x in later)}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--graphs", nargs="+", default=["uniform", "weighted"],
                    choices=["uniform", "weighted"])
    ap.add_argument("--forms", nargs="+", default=list(FORMS), choices=FORMS)
    ap.add_argument("--claim-max", nargs="*", type=int, default=[8, 16, 32])
    ap.add_argument("--out", default=None,
                    help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("index_xp_probe: needs a CUDA card", file=sys.stderr)
        return 2
    from .xp_walk_probe import graphs, registers
    dev = torch.device("cuda:0")
    forms = load_forms()
    result = {"device": torch.cuda.get_device_name(0),
              "registers": registers(forms)}
    for line in result["registers"]:
        print("  ptxas", line, flush=True)
    for gname, g, rcfg, _ in graphs(args.graphs):
        s = setup(g, rcfg, dev)
        del g
        ref, ref_ms = reference(s)
        rec = {"walks": s["total"], "sharded_ms": ref_ms}
        print(f"{gname}: {s['total']} walks in chunks of {s['chunk']}; K4's "
              f"sharded form {ref_ms:.4f} ms device", flush=True)

        def run(label, P, name):
            got = run_build(s, P, form_caller(forms, name),
                            per_chunk=name == "earlier")
            if not got["once"] or not torch.equal(got["ends"], ref):
                raise SystemExit(f"index_xp_probe: {label} on {gname}: "
                                 f"{int((got['ends'] != ref).sum())} "
                                 "endpoints differ from K4's sharded form")
            x = summary(got["per"])
            x.update(rounds=got["rounds"], sent=got["sent"],
                     per_launch=got["per"])
            print(f"  {label:10s} rounds {got['rounds']}; round 0 "
                  f"{x['round0_ms']:.4f} ms ({x['round0_walks']} walks), "
                  f"later {x['later_ms']:.4f} ms ({x['later_walks']} records"
                  f" in {x['later_launches']} launches), all "
                  f"{x['total_ms']:.4f} ms", flush=True)
            rec[label] = x
        for name in args.forms:
            run(name, PROCS, name)
        from ..kernels import schedule
        top = schedule.INDEX_XP_CLAIM_MAX
        for k in args.claim_max:    # the inbox plan's largest claim
            schedule.INDEX_XP_CLAIM_MAX = k
            run(f"claim max {k}", PROCS, "package")
        schedule.INDEX_XP_CLAIM_MAX = top
        run("P1", 1, "package")
        result[gname] = rec
        del s, ref
        torch.cuda.empty_cache()
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
