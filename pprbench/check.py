"""The comparison that decides ``correct``.

The answers judged are the timed path's own (ids and values), a sample
of them drawn from the run's seed once the window has closed, against
the plain reference's exact PPR of the same sources.  Four numbers,
each beside its limit:

* ``missing``: answers due in the window that never came, came as an
  error, or are malformed (not k distinct ids in range with finite
  values).  An exact comparison: its limit is 0.
* ``err_mean``: the mean of |estimate - exact| / max(exact, delta) over
  every node the sample's answers name: how far the answers sit from
  exact PPR on the whole, steady from seed to seed.  Its limit lies
  between what sound runs read and what the control reads
  (``cells/<workload>.json``; the readings are in PERF.md).
* ``err_max``: the largest |estimate - exact| / max(exact, delta) over
  every node the sample's answers name: the guarantee the configuration
  states (relative error at most epsilon above delta, and so, by the same
  bound, absolute error at most epsilon delta below it), so its limit is
  the configuration's epsilon.  An id altered where it is produced names
  a node whose estimate is another's, and reads far above it.
* ``topk_gap``: the largest shortfall 1 - pi(t_i) / pi(v*_i) over every
  rank i of every sampled answer whose exact i-th largest PPR pi(v*_i)
  is above delta, where pi(t_i) is the i-th largest exact PPR among the
  nodes the answer names: FORA's top-k guarantee (the i-th best node
  returned has at least 1 - epsilon of the exact i-th largest), so its
  limit is the configuration's epsilon.  Taken by the exact values the
  answer's nodes hold, not by the order the answer lists them in, so
  it judges which nodes were selected: wrong nodes, each with an
  accurate estimate of its own, read far above it.
"""

from __future__ import annotations

import numpy as np

from .reference.metrics import precision_at_k


def malformed(ids: np.ndarray, vals: np.ndarray, n: int, k: int) -> bool:
    ids, vals = np.asarray(ids), np.asarray(vals)
    return (ids.shape != (k,) or vals.shape != (k,)
            or len(np.unique(ids)) != k or ids.min() < 0 or ids.max() >= n
            or not np.isfinite(vals).all())


def topk_gap(exact_at, exact_top_vals, delta: float) -> float:
    """The largest 1 - (i-th largest of ``exact_at``'s row) / (the exact
    i-th largest, ``exact_top_vals``'s row, descending) over the ranks
    whose exact value is above ``delta``; 0 where there is none."""
    got = -np.sort(-np.asarray(exact_at, np.float64), axis=1)
    best = np.asarray(exact_top_vals, np.float64)
    due = best > delta
    if not due.any():
        return 0.0
    return float(np.max(1.0 - got[due] / best[due]))


def judge(ids, vals, exact_top, exact_top_vals, exact_at, *, missing: int,
          delta: float, epsilon: float, mean_limit: float) -> tuple:
    """(correct, checks, precision@k): ``ids``/``vals`` [S, k] the sampled
    answers, ``exact_top`` [S, k] their exact top-k and
    ``exact_top_vals`` its exact PPR, descending, ``exact_at`` [S, k] the
    exact PPR of the answered ids; ``missing`` the answers that never
    came or are malformed."""
    ids = np.asarray(ids)
    prec = float(np.mean([precision_at_k(p, e)
                          for p, e in zip(ids, exact_top)])) if len(ids) \
        else 0.0
    ex = np.asarray(exact_at, np.float64)
    err = np.abs(np.asarray(vals, np.float64) - ex) / np.maximum(ex, delta)
    checks = {
        "missing": {"value": int(missing), "limit": 0},
        "err_mean": {"value": float(err.mean()) if err.size else 0.0,
                     "limit": mean_limit},
        "err_max": {"value": float(err.max()) if err.size else 0.0,
                    "limit": epsilon},
        "topk_gap": {"value": topk_gap(ex, exact_top_vals, delta)
                     if err.size else 0.0, "limit": epsilon},
    }
    correct = bool(len(ids)) and all(c["value"] <= c["limit"]
                                     for c in checks.values())
    return correct, checks, prec
