"""K5 and its pre-pass on the card against their earlier form and against
other grids of K5, on the same superstep's state and timed the same way.

    python -m fora_tpu_torch.probes.frontier_probe [--batches 1 8 32] \
        [--rounds 5] [--device cuda:0]

The earlier form (``frontier_push_earlier.cu`` beside this file: a lane
a column in the pre-pass, int2 tasks, and K5 adding every float4 chunk of
a pushing row along each edge) and K5's other grids
(``frontier_push_forms.cu``: a warp going on to further tasks over the
blocks the card holds at once, and a warp taking 2 or 4 tasks side by
side) are each compiled alone (``build.load_alone``) and called through
ctypes beside the package's own kernels.  No entry point of the package
reaches this module.

On bench.py's graph (RMAT n = 2^19, m = 2^23, seed 7, unmerged, no hub
split, as ``chip_smoke.py`` phase 16 lays it out), for each batch width B
it pushes from the first B of the query sources at the final delta's rmax
and stops at the compacted superstep with the most active out-edges
within the default cap; on that state (:func:`forms_on_state`) it checks
every form against the plain versions and times each with
``utils.timing.device_ms`` in alternating rounds, and it prints how full
the package's K5 keeps its lanes (:func:`lane_use`).  It needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from .. import ForaConfig, kernels
from ..algo.topk import delta_schedule
from ..eval import queries as qio
from ..graph import generators, to_device
from ..kernels import build
from ..ops import push
from ..utils.timing import device_ms

HERE = Path(__file__).resolve().parent
PUSH_FORMS = ("persistent", "packed2", "packed4")
BENCH_GRAPH = dict(n_log2=19, m=1 << 23, seed=7)
QUERIES, EPS, K, DSTRIDE = 256, 0.5, 50, 8.0   # chip_smoke.py's pools


_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# the earlier form's entry points: the pre-pass without the out-CSR's row
# pointers, K5 reading them
EARLIER_SIGNATURES = {
    "fora_frontier_prepass": [_P, _P, _P, _P, _P, _P, _F, _F, _LL, _I, _I,
                              _P, _P, _P],
    "fora_frontier_push": [_P, _P, _P, _LL, _P, _P, _I, _I, _P]}


def load_forms() -> dict:
    """{"earlier": the earlier source's library (EARLIER_SIGNATURES),
    "forms": K5's other grids (fora_frontier_push_<form> for each of
    PUSH_FORMS, with fora_frontier_push's arguments)}, each built alone,
    the two in parallel."""
    jobs = {"earlier": (HERE / "frontier_push_earlier.cu",
                        EARLIER_SIGNATURES),
            "forms": (HERE / "frontier_push_forms.cu", {
                f"fora_frontier_push_{f}":
                build.SIGNATURES["fora_frontier_push"] for f in PUSH_FORMS})}
    with ThreadPoolExecutor(len(jobs)) as ex:
        libs = {k: ex.submit(build.load_alone, *v) for k, v in jobs.items()}
    return {k: v.result() for k, v in libs.items()}


def _p(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _call(fn, *args, stream_of: torch.Tensor):
    err = fn(*args, ctypes.c_void_p(
        torch.cuda.current_stream(stream_of.device).cuda_stream))
    if err:
        raise RuntimeError(f"{fn.__name__}: CUDA error {err}")


def earlier_prepass(lib, p, r, contrib, thr, deg, wsum, alpha, tasks, status,
                    task_edges: int = push.TASK_EDGES) -> None:
    """The earlier pre-pass (int2 tasks: row, range)."""
    n, B = r.shape
    _call(lib.fora_frontier_prepass, _p(p), _p(r), _p(contrib), _p(thr),
          _p(deg), _p(wsum), alpha, 1.0 - alpha, n, B, task_edges, _p(tasks),
          _p(status), stream_of=r)


def earlier_push(lib, r, contrib, tasks, n_tasks: int, indptr, indices,
                 task_edges: int = push.TASK_EDGES) -> None:
    """The earlier K5 on its own tasks."""
    _call(lib.fora_frontier_push, _p(r), _p(contrib), _p(tasks), n_tasks,
          _p(indptr), _p(indices), task_edges, r.shape[1], stream_of=r)


def form_push(fn, r, contrib, tasks, n_tasks: int, indices) -> None:
    """One of K5's other grids (``fn``, an entry point with
    fora_frontier_push's arguments) on the package's tasks."""
    _call(fn, _p(r), _p(contrib), _p(tasks), n_tasks, _p(indices),
          r.shape[1], stream_of=r)


def lane_use(tasks: torch.Tensor, n_tasks: int, B: int) -> dict:
    """How this K5 lays its lanes over the first ``n_tasks`` tasks: lane
    slots that add (edge, non-zero unit) pairs over the 32 lanes of every
    instruction its warps run, the mean set bits of a mask, and the share
    of tasks of at most 32 edges.  Counts from the tasks, not a device
    measurement."""
    t = tasks[:n_tasks].long()
    masks = t[:, 2] & 0xFFFFFFFF
    nb = torch.zeros_like(masks)
    for b in range(32):
        nb += (masks >> b) & 1
    lg = torch.ceil(torch.log2(nb.clamp_min(1).double())).long()
    per_instr = 32 >> lg
    steps = (t[:, 3] + per_instr - 1) // per_instr
    pairs = int((t[:, 3] * nb).sum())
    return dict(pairs=pairs, lanes=pairs / max(1, int(steps.sum()) * 32),
                bits=float(nb.double().mean()) if n_tasks else 0.0,
                short=float((t[:, 3] <= 32).double().mean()) if n_tasks
                else 0.0, span=push.mask_span(B))


def forms_on_state(graph, p0, r0, thr, wsum, alpha: float, forms: dict,
                   rounds: int = 5) -> dict:
    """This package's pre-pass and K5 against the other forms (``forms``,
    from :func:`load_forms`) on one superstep's state (p0, r0): the
    earlier pre-pass must give the same p, contrib, masked r, status and
    task (row, first edge) set; every K5 form within rtol 1e-4 of the float64
    plain sum.  Returns the median device ms of each over ``rounds``
    alternating rounds: {"prepass": {"this", "earlier"}, "push": {"this",
    "earlier", *PUSH_FORMS}}, with the tasks' ``lane_use``, the active
    out-edges and the tasks."""
    n, B = r0.shape
    dev = r0.device
    T = push.TASK_EDGES
    rows = push.task_rows(n, graph.m)
    deg = graph.out_deg
    tasks = torch.empty((rows, push.TASK_FIELDS), dtype=torch.int32,
                        device=dev)
    tasks2 = torch.empty((rows, 2), dtype=torch.int32, device=dev)
    status = torch.zeros(3, dtype=torch.int32, device=dev)
    status2 = torch.zeros_like(status)
    p, r, c = p0.clone(), r0.clone(), torch.empty_like(r0)
    kernels.frontier_prepass(p, r, c, thr, deg, graph.out_indptr, wsum, alpha,
                             tasks, status, T, graph.m)
    p2, r2, c2 = p0.clone(), r0.clone(), torch.empty_like(r0)
    earlier_prepass(forms["earlier"], p2, r2, c2, thr, deg, wsum, alpha,
                    tasks2, status2)
    torch.cuda.synchronize()
    if not (torch.equal(p, p2) and torch.equal(c, c2) and torch.equal(r, r2)
            and status.tolist() == status2.tolist()):
        raise SystemExit("frontier probe: the earlier pre-pass disagrees")
    nt = int(status[2])

    # the same (row, first edge) set: the earlier tasks name the range
    first2 = graph.out_indptr[tasks2[:nt, 0].long()] + tasks2[:nt, 1] * T
    if not torch.equal(
            (tasks[:nt, 0].long() * graph.m + tasks[:nt, 1]).sort()[0],
            (tasks2[:nt, 0].long() * graph.m + first2).sort()[0]):
        raise SystemExit("frontier probe: the earlier form's tasks differ")
    row_active = torch.zeros(n, dtype=torch.bool, device=dev)
    row_active[tasks[:nt, 0].long()] = True
    want = push.active_edge_segment_sum_plain(
        r.double(), c.double(), graph.in_src, graph.in_dst, row_active)
    scratch = {}
    push_fns = {
        "this": lambda out: kernels.frontier_push(out, c, tasks, nt,
                                                  graph.out_indices),
        "earlier": lambda out: earlier_push(
            forms["earlier"], out, c, tasks2, nt, graph.out_indptr,
            graph.out_indices)}
    for f in PUSH_FORMS:
        push_fns[f] = (lambda fn: lambda out: form_push(
            fn, out, c, tasks, nt, graph.out_indices))(
            getattr(forms["forms"], f"fora_frontier_push_{f}"))
    for name, fn in push_fns.items():
        out = r.clone()
        fn(out)
        torch.cuda.synchronize()
        bad = (out.double() - want).abs() > 1e-9 + 1e-4 * want.abs()
        if bool(bad.any()):
            raise SystemExit(f"frontier probe: K5 {name} differs from the "
                             f"float64 plain sum at {int(bad.sum())} entries")
        scratch[name] = out

    def on_copies(fn):
        copies = iter([(p0.clone(), r0.clone()) for _ in range(22)])
        return lambda: fn(*next(copies))
    c_t, s_t = torch.empty_like(c), torch.empty_like(status)
    pre_fns = {
        "this": lambda cp, cr: kernels.frontier_prepass(
            cp, cr, c_t, thr, deg, graph.out_indptr, wsum, alpha, tasks, s_t,
            T, graph.m),
        "earlier": lambda cp, cr: earlier_prepass(
            forms["earlier"], cp, cr, c_t, thr, deg, wsum, alpha, tasks2,
            s_t)}
    times = {"prepass": {k: [] for k in pre_fns},
             "push": {k: [] for k in push_fns}}
    for i in range(rounds):
        for kind, fns in (("prepass", pre_fns), ("push", push_fns)):
            order = list(fns.items())
            for name, fn in order if i % 2 == 0 else order[::-1]:
                if kind == "prepass":
                    times[kind][name].append(device_ms(on_copies(fn)))
                else:
                    out = scratch[name]
                    times[kind][name].append(device_ms(lambda: fn(out)))
    # the pre-pass above rewrote `tasks`; it lists the same tasks
    return {kind: {k: statistics.median(v) for k, v in d.items()}
            for kind, d in times.items()} | {
        "lanes": lane_use(tasks, nt, B), "edges": int(status[1]),
        "tasks": nt}


def snapshot(graph, src, rmax: float, alpha: float, cap: int):
    """The state (p, r) before the pre-pass of the compacted superstep with
    the most active out-edges within ``cap``, stepping a compacted push
    from ``src`` through the ops' own pieces; and the active out-edges of
    every superstep."""
    from ..ops import gather
    st = push.init_state(graph.n, src)
    p, r = st.p, st.r
    thr = push.node_threshold(graph, rmax)
    contrib = torch.empty_like(r)
    wsum = push.out_weight(graph)
    tasks = torch.empty((push.task_rows(graph.n, graph.m), push.TASK_FIELDS),
                        dtype=torch.int32, device=r.device)
    status = torch.zeros(3, dtype=torch.int32, device=r.device)
    best, counts = None, []
    while True:
        p0, r0 = p.clone(), r.clone()
        push.frontier_prepass(p, r, contrib, thr, graph.out_deg,
                              graph.out_indptr, wsum, alpha, tasks, status,
                              graph.m)
        more, edges, n_tasks = status.tolist()
        if not more:
            return best, counts
        counts.append(edges)
        if edges <= cap:
            if best is None or edges > best[2]:
                best = (p0, r0, edges, len(counts))
            push.frontier_push(graph, r, contrib, tasks, n_tasks)
        else:
            gather.gather_scatter_add(r, contrib, graph.in_indptr,
                                      graph.in_src, sched=graph.in_sched)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 8, 32])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--device", default="cuda:0")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("frontier_probe needs a CUDA card")
    dev = torch.device(a.device)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0])
    forms = load_forms()
    g = generators.rmat(**BENCH_GRAPH)
    rcfg = ForaConfig(epsilon=EPS, k=K).resolved(g.n, g.m)
    rmax = rcfg.with_delta(delta_schedule(rcfg, K, stride=DSTRIDE)[-1]).rmax
    graph = to_device(g, device=dev)
    cap = push.default_edge_cap(graph.m_in)
    sources = np.asarray(qio.generate_sources(g, QUERIES, seed=7 + 1))
    thr = push.node_threshold(graph, rmax)
    wsum = push.out_weight(graph)
    print(f"frontier probe: RMAT n={g.n} m={g.m}, rmax {rmax:.4e}, cap {cap}")
    for B in a.batches:
        src = torch.as_tensor(sources[:B], dtype=torch.int32, device=dev)
        best, counts = snapshot(graph, src, rmax, 0.2, cap)
        p0, r0, edges, step = best
        f = forms_on_state(graph, p0, r0, thr, wsum, 0.2, forms, a.rounds)
        lu = f["lanes"]
        print(f"B={B}: superstep {step} of {len(counts)}, {f['edges']} active"
              f" out-edges in {f['tasks']} tasks; mask bits {lu['bits']:.2f} "
              f"a task (span {lu['span']}), {lu['pairs']} (edge, unit) "
              f"pairs, lanes used {lu['lanes']:.3f}, tasks of <= 32 edges "
              f"{lu['short']:.3f}")
        print("  pre-pass device ms (median of "
              f"{a.rounds}): " + ", ".join(f"{k} {v:.4f}" for k, v in
                                           f["prepass"].items()))
        print("  K5 device ms: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                            f["push"].items()))
        del best, p0, r0
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
