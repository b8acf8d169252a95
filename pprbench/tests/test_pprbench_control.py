"""The correctness check, driven through a whole run on the CPU at a
small size: sound runs come out correct; the control (the program at
eight times the stated epsilon, judged by the stated one) and each fault
a cell can have, planted underneath the timed path, come out not
correct.  A step that returns its state unchanged; half of the batch
left out, its answers taken from the rest; an answer altered where it
is produced; the split accept (K3) selecting ranks k + 1 .. 2k, each
with its own estimate.  (The cells run on one chip: there is no
exchange between chips.)"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pprbench_cases import run, tiny_spec

torch.set_num_threads(4)
CELLS = ("plus-top50-batch512", "raw-top50-batch512")


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    res = run(tiny_spec(workload))
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_control_is_not_correct(seed):
    spec = tiny_spec("plus-top50-batch512", scale=12)
    spec.control_factor = 8.0
    res = run(spec, seed=seed, seconds=0.1)
    assert not res["correct"], res["checks"]
    assert res["checks"]["err_mean"]["value"] > \
        res["checks"]["err_mean"]["limit"]


def unchanged_state(system, mp):
    """Every level step returns its state as it came, nothing added."""
    if system.runner._staged is not None:
        system.runner._staged.lean_state_fn = lambda depth: (
            lambda p, r, rmax, omega: (p, r, torch.zeros_like(r), 0))
    else:
        import fora_tpu_torch.algo.topk as topk

        def lean(graph, p, r, seed, rmax, omega, **kw):
            B = r.shape[1]
            walk = SimpleNamespace(walks_max=0, walks_total=0, lanes=0,
                                   chunks=0, overflow=torch.zeros(B))
            return p, r, torch.zeros_like(r), 0, walk
        mp.setattr(topk, "raw_lean_state", lean)


def half_batch(system, mp):
    """Each call answers the first half of its sources; the rest get
    answers copied from that half."""
    runner = system.runner
    inner = runner.query_pool

    def query_pool(sources, key=None, **kw):
        src = np.asarray(sources)
        h = max(1, len(src) // 2)
        res = inner(src[:h], key, **kw)
        pick = np.arange(len(src)) % h

        def take(a):
            return None if a is None else np.asarray(a)[pick]
        return res._replace(
            node_ids=take(res.node_ids), values=take(res.values),
            accepted=take(res.accepted), lower_bounds=take(res.lower_bounds),
            upper_bounds=take(res.upper_bounds), deferred=take(res.deferred))
    runner.query_pool = query_pool


def altered_answer(system, mp):
    """The split accept's first id of every column moved to the next
    node."""
    import fora_tpu_torch.algo.bounds as bounds
    inner = bounds.topk_with_bounds_split
    n = system.n

    def split(*a, **kw):
        out = list(inner(*a, **kw))
        idx = out[1].clone()
        idx[:, 0] = (idx[:, 0] + 1) % n
        out[1] = idx
        return tuple(out)
    mp.setattr(bounds, "topk_with_bounds_split", split)


def next_ranks(system, mp):
    """The split accept hands out ranks k + 1 .. 2k of every column, each
    with its own estimate and bounds, in place of ranks 1 .. k."""
    import fora_tpu_torch.algo.bounds as bounds
    inner = bounds.topk_with_bounds_split

    def split(p, contrib, omega_unit, k, t, eps):
        out = inner(p, contrib, omega_unit, k, t, eps)
        wide = inner(p, contrib, omega_unit, 2 * k, t, eps)
        return (*(x[:, k:2 * k] for x in wide[:4]), *out[4:])
    mp.setattr(bounds, "topk_with_bounds_split", split)


FAULTS = [("plus-top50-batch512", unchanged_state),
          ("raw-top50-batch512", unchanged_state),
          ("plus-top50-batch512", half_batch),
          ("plus-top50-batch512", altered_answer),
          ("raw-top50-batch512", altered_answer),
          ("plus-top50-batch512", next_ranks),
          ("plus-top100-batch512", next_ranks),
          ("raw-top50-batch512", next_ranks)]


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{w}-{f.__name__}" for w, f in FAULTS])
def test_fault_is_not_correct(workload, fault, monkeypatch):
    res = run(tiny_spec(workload), patch=lambda s: fault(s, monkeypatch))
    assert not res["correct"], res["checks"]


def test_next_ranks_fail_the_topk_gap_alone(monkeypatch):
    """Ranks k + 1 .. 2k, each with an accurate estimate of its own, pass
    the estimate checks and fail the top-k one."""
    res = run(tiny_spec("plus-top50-batch512"),
              patch=lambda s: next_ranks(s, monkeypatch))
    c = res["checks"]
    assert c["err_max"]["value"] <= c["err_max"]["limit"], c
    assert c["topk_gap"]["value"] > c["topk_gap"]["limit"], c


def test_topk_gap_by_hand():
    from pprbench.check import topk_gap
    best = np.array([[0.4, 0.2, 0.1, 1e-9]])
    # the answer's nodes, listed out of order: 0.2, 0.4 and 0.05 at rank 3
    assert topk_gap(np.array([[0.2, 0.4, 0.05, 0.0]]), best, 1e-6) \
        == pytest.approx(0.5)
    # rank 4 lies below delta and is not judged
    assert topk_gap(np.array([[0.4, 0.2, 0.1, 0.0]]), best, 1e-6) == 0.0
    assert topk_gap(np.array([[0.1, 0.05, 0.0, 0.0]]), best, 1e-6) \
        == pytest.approx(1.0)
