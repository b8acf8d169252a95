"""One run of one cell: set-up, the measured window, the reference, the
result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file found by its name in ``BENCHMARK.json``:

* ``configs/<config>.json``: the deployment (graph, FORA's settings, the
  guarantee), named by the configuration's ``file``;
* ``traffic/<traffic>.json``: the mix's parameters; its ``kind`` names
  the module ``traffic/<kind>.py`` that drives the window;
* ``cells/<workload>.json``: the limits of the cell's correctness check;
* ``metrics/<metric>.py``: a reader, ``read(run) -> value or None``, of
  one per-layer metric from the traced run's records and trace.

From the program (``fora_tpu_torch``) the harness takes only the system
under test: the layout (``to_device``), the index build, ``TopkRunner``,
its level records, and its kernels' names.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
FOREIGN = ("jax", "jaxlib", "flax", "fora_tpu")
SEED_MASK = (1 << 64) - 1
# stream tags under the run's seed
GRAPH, INDEX, WARM, TRAFFIC, SAMPLE = 1, 2, 3, 4, 5


class RunError(RuntimeError):
    """A run that cannot give a result: it prints none and exits non-zero."""


def derive(seed: int, *path: int) -> int:
    """A 64-bit seed for the stream ``path`` under the run's ``seed``."""
    words = np.random.SeedSequence(
        [int(seed) & SEED_MASK, *map(int, path), len(path) + 1]
    ).generate_state(2, np.uint32)
    return int(words[0]) | (int(words[1]) << 32)


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The module in ``path`` (a file named by a metric or traffic kind)."""
    if not path.is_file():
        raise RunError(f"no file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_entries(manifest: dict, workload: str) -> tuple:
    """(end-to-end, per-layer) metric entries that ``workload`` reports: an
    entry with ``workloads`` where it lists the cell; an end-to-end one
    without it everywhere; a per-layer one without it wherever the cell
    reports the end-to-end metric it moves."""
    e2e = [m for m in manifest["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    per = [m for m in manifest["per_layer"]
           if (workload in m["workloads"] if "workloads" in m
               else m["moves"] in names)]
    return e2e, per


def cell_spec(workload: str, root: Path = ROOT) -> SimpleNamespace:
    """The cell's entry, configuration, traffic, limits and metrics, each
    found by name."""
    manifest = read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    bench = root / "pprbench"
    traffic = read_json(bench / "traffic" / f"{cell['traffic']}.json")
    e2e, per = metric_entries(manifest, workload)
    return SimpleNamespace(
        name=workload, cell=cell, config=read_json(root / conf["file"]),
        traffic=traffic, limits=read_json(bench / "cells" / f"{workload}.json"),
        e2e=e2e, per_layer=per, root=root,
        driver=load_module(bench / "traffic" / f"{traffic['kind']}.py",
                           f"pprbench_traffic_{traffic['kind']}"))


# --- set-up ---------------------------------------------------------------

def sync(dev) -> None:
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def set_up(spec, seed: int, device, k: int) -> SimpleNamespace:
    """The system under test for the cell: the configuration's graph made
    on ``device`` from ``seed``, laid out by the program, its index built
    from ``seed``, a TopkRunner.
    Returns the system with its set-up timings (``setup``)."""
    import torch
    from fora_tpu_torch import ForaConfig
    from fora_tpu_torch import index as tidx
    from fora_tpu_torch.algo.topk import TopkRunner
    from fora_tpu_torch.graph import to_device
    from fora_tpu_torch.graph.csr import CSRGraph

    from . import graphgen
    conf, fora = spec.config, spec.config["fora"]
    times = {}
    t = time.perf_counter()
    (src, dst), n = graphgen.make_graph(conf["graph"], device,
                                         derive(seed, GRAPH))
    m_in = graphgen.unique_edges(src, dst, n)
    fields = graphgen.csr_fields(src, dst, n)
    g = CSRGraph(**fields)
    # the edge list the reference reads, kept compact
    edges = (src.to(torch.int32), dst.to(torch.int32))
    del src, dst
    sync(device)
    times["graph_s"] = time.perf_counter() - t

    t = time.perf_counter()
    dg = to_device(g, merge_duplicate_edges=fora["merge_duplicate_edges"],
                   hub_rows=fora["hub_rows"], device=device)
    sync(device)
    times["layout_s"] = time.perf_counter() - t

    # the control (control.py) runs the program at a looser epsilon than
    # the configuration states, and is judged by the stated one
    eps = fora["epsilon"] * getattr(spec, "control_factor", 1.0)
    rcfg = ForaConfig(alpha=fora["alpha"], epsilon=eps,
                      rmax_scale=fora["rmax_scale"], k=k).resolved(g.n, g.m)
    index = None
    if fora["index"]:
        t = time.perf_counter()
        index = tidx.build_walk_index(dg, rcfg, derive(seed, INDEX))
        sync(device)
        times["build_s"] = time.perf_counter() - t
    runner = TopkRunner(dg, rcfg, k=k, index=index,
                        delta_stride=fora["delta_stride"],
                        accept_slack=fora["accept_slack"])
    out_deg = np.asarray(fields["out_deg"])
    index_edges = None
    if index is not None:
        off = np.asarray(index.bucket_offsets, np.int64)
        index_edges = [int(off[-1] - off[q]) for q in range(len(off) - 1)]
    return SimpleNamespace(
        device=torch.device(device), n=g.n, m=g.m, m_in=m_in,
        n_out=int((out_deg > 0).sum()), out_deg=out_deg, edges=edges,
        graph=g, dg=dg, rcfg=rcfg, index=index, runner=runner, k=k,
        index_edges=index_edges, setup=times,
        depth_of=_depth_fn(rcfg, index))


def _depth_fn(rcfg, index):
    """record -> the index depth its level reads (None in raw mode)."""
    if index is None:
        return None

    def depth(st):
        rc = rcfg.with_delta(st["delta"])
        return index.depth_for(rc.omega_unit, rc.rmax)
    return depth


# --- the run --------------------------------------------------------------

def run_cell(spec, seed: int, seconds: float, trace: bool, device,
             t_start: float, patch=None) -> dict:
    """One run of the cell ``spec`` on ``device``; returns the result
    line's object.  ``t_start`` is the process's start on the host clock;
    ``patch(system)``, where given, is applied to the system before the
    warm-up (the tests' broken paths)."""
    import torch

    from . import check
    from .reference import ppr
    from .trace import Tracer
    traffic = spec.traffic
    k = traffic["k"]
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)        # the context, before the reset
        torch.cuda.reset_peak_memory_stats(dev)
    init_s = time.perf_counter() - t_start     # imports, the device's context
    system = set_up(spec, seed, dev, k)
    system.setup["init_s"] = init_s
    if patch is not None:
        patch(system)
    t = time.perf_counter()
    spec.driver.warm_up(system, traffic, derive(seed, WARM))
    sync(dev)
    system.setup["warm_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start

    tracer = Tracer(trace)
    win = spec.driver.window(system, traffic, derive(seed, TRAFFIC),
                             seconds, tracer)
    peak = int(torch.cuda.max_memory_allocated(dev)) \
        if dev.type == "cuda" else 0

    # the program's state goes before the reference runs
    edges, n = system.edges, system.n
    for name in ("runner", "index", "dg", "graph"):
        setattr(system, name, None)
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    answered = np.nonzero(win.ok)[0]
    rng = np.random.default_rng(derive(seed, SAMPLE))
    take = rng.choice(answered, size=min(traffic["reference_sample"],
                                         len(answered)), replace=False) \
        if len(answered) else answered
    missing = int(win.attempted - len(answered)) + sum(
        check.malformed(win.ids[i], win.vals[i], n, k) for i in answered)
    t = time.perf_counter()
    fora = spec.config["fora"]
    exact_top, exact_top_vals, exact_at = ppr.reference_answers(
        edges[0], edges[1], n, win.sources[take], win.ids[take],
        fora["alpha"], k)
    ref_s = time.perf_counter() - t
    delta = 1.0 / n if fora["delta"] == "1/n" else float(fora["delta"])
    correct, checks, prec = check.judge(
        win.ids[take], win.vals[take], exact_top, exact_top_vals, exact_at,
        missing=missing, delta=delta,
        epsilon=fora["epsilon"], mean_limit=spec.limits["err_mean"])

    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": 1, "memory_peak_bytes": peak}
    e2e = dict(win.e2e, setup_s=setup_s, precision_at_k=prec)
    if trace:
        run = SimpleNamespace(
            records=win.records, traced_records=win.traced_records,
            answered=win.answered, traced_answered=win.traced_answered,
            trace=win.trace, setup=system.setup,
            n=n, n_out=system.n_out, m_in=system.m_in,
            index_edges=system.index_edges, depth_of=system.depth_of,
            alpha=fora["alpha"], device_name=device_info["kind"])
        metrics = {}
        for m in spec.per_layer:
            reader = load_module(spec.root / "pprbench" / "metrics"
                                 / f"{m['name']}.py",
                                 "pprbench_metric_"
                                 + m["name"].replace(".", "_"))
            value = reader.read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        if win.trace is not None:
            device_info["busy_s"] = win.trace.busy_s
            device_info["window_s"] = win.trace.window_s
    else:
        metrics = {m["name"]: {"value": float(e2e[m["name"]]),
                               "unit": m["unit"]} for m in spec.e2e}
    result = {"correct": correct, "attempted": int(win.attempted),
              "failed": missing,
              "metrics": metrics, "device": device_info}
    if trace and win.trace is not None:
        result["breakdown"] = {"device_ops": win.trace.device_ops,
                               "idle_gaps": win.trace.idle_gaps}
    result["checks"] = checks
    info = dict(system.setup, setup_s=setup_s, reference_s=ref_s,
                reference_sources=int(len(take)), window_s=win.window_s,
                n=n, m=system.m, m_in=system.m_in, **win.notes)
    print("pprbench: " + json.dumps(info), file=sys.stderr)
    return result


def foreign_modules() -> list:
    """Top-level names of JAX or its package among the loaded modules,
    compared whole (an entry of None is a blocked import, not a module)."""
    return sorted({m.split(".")[0] for m, mod in list(sys.modules.items())
                   if mod is not None and m.split(".")[0] in FOREIGN})


def main(args, t_start: float) -> int:
    """The command: exits non-zero, with no result, where no card or too
    few cards are present, where a file is missing, or where JAX or its
    package is loaded once the window has closed."""
    os.environ["FORA_TPU_TORCH_BUILD_DIR"] = str(ROOT / "build" /
                                                 "fora_tpu_torch")
    try:
        spec = cell_spec(args.workload)
    except (RunError, OSError, KeyError, ValueError) as e:
        print(f"pprbench: {e}", file=sys.stderr)
        return 2
    import torch
    need = spec.cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"pprbench: the cell needs {need} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 3
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                      "cuda:0", t_start)
    foreign = foreign_modules()
    if foreign:
        print(f"pprbench: modules of JAX or its package loaded: {foreign}",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
