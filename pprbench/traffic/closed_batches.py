"""A closed loop of batches through ``TopkRunner.query_pools``.

Each batch draws ``batch_sources`` sources uniformly from the nodes with
out-degree > 0 (the frozen ``generate_sources``, fresh each batch) and
answers them in pools of ``pool`` (blocks of ``block`` columns, stragglers
under ``defer_below`` stashed and flushed at the batch's end); the next
batch starts when the last answer of this one is on the host.  The window
runs batches until ``seconds`` have passed; ``topk_qps`` is every query
answered over the whole time those batches took.  With a tracer, the
profiler covers whole batches from the second on, until ``trace_seconds``
have passed.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np

from pprbench.harness import derive, sync
from pprbench.reference.queries import generate_sources


def _batch(system, traffic, seed: int, i: int):
    src = generate_sources(system.out_deg, traffic["batch_sources"],
                           seed=derive(seed, i))
    res, stats = system.runner.query_pools(
        src, derive(seed, i, 1), batch=traffic["block"], pool=traffic["pool"],
        defer_below=traffic["defer_below"])
    return src, res, stats


def warm_up(system, traffic, seed: int) -> None:
    """Batches of the window's own shapes, from a stream of their own."""
    for i in range(traffic["warmup_batches"]):
        _batch(system, traffic, seed, i)


def window(system, traffic, seed: int, seconds: float, tracer):
    k = traffic["k"]
    sources, ids, vals, records, traced = [], [], [], [], []
    trace, traced_answered, tracing = None, 0, False
    sync(system.device)
    t0 = time.perf_counter()
    i, ends = 0, []
    while True:
        if tracer.enabled and i == 1 and trace is None:
            tracer.start()
            tracing, t_tr = True, time.perf_counter()
        src, res, stats = _batch(system, traffic, seed, i)
        sources.append(src)
        ids.append(res.node_ids.reshape(len(src), k))
        vals.append(res.values.reshape(len(src), k))
        records += stats
        if tracing:
            traced += stats
            traced_answered += len(src)
            if time.perf_counter() - t_tr >= traffic["trace_seconds"]:
                trace, tracing = tracer.stop(), False
        i += 1
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    t1 = time.perf_counter()
    if tracing:
        trace = tracer.stop()
    n = sum(len(s) for s in sources)
    return SimpleNamespace(
        sources=np.concatenate(sources), ids=np.concatenate(ids),
        vals=np.concatenate(vals), ok=np.ones(n, bool), attempted=n,
        e2e={"topk_qps": n / (t1 - t0)}, records=records,
        traced_records=traced, answered=n, traced_answered=traced_answered,
        trace=trace, window_s=t1 - t0,
        notes={"batches": i, "queries": n,
               "batch_ends_s": [round(e, 4) for e in ends]})
