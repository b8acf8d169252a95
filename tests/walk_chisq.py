"""Chi-square tests of random-walk endpoints against exact PPR, shared by
the port's walk tests (CPU and card).

Endpoint counts of W independent walks from one start node are
multinomial with the start's PPR vector as probabilities.  Walks from
several start nodes (a FORA allocation, a Monte Carlo batch pooled over
columns) give counts whose expectation is the mixture of their starts'
PPR vectors; their variance is below the multinomial's, so the test is
conservative there.  Bins whose expected count is under ``min_expected``
are merged into one bin.
"""

import numpy as np
from scipy import stats


def chisquare_pvalue(counts, probs, min_expected: float = 5.0) -> float:
    """p-value of ``scipy.stats.chisquare`` of ``counts`` against the
    distribution ``probs`` (normalised here) scaled to the same total."""
    counts = np.asarray(counts, dtype=np.float64)
    probs = np.asarray(probs, dtype=np.float64)
    expected = probs / probs.sum() * counts.sum()
    big = expected >= min_expected
    obs = np.append(counts[big], counts[~big].sum())
    exp = np.append(expected[big], expected[~big].sum())
    if exp[-1] == 0.0:
        if obs[-1] > 0:
            return 0.0          # endpoints where exact PPR is zero
        obs, exp = obs[:-1], exp[:-1]
    return float(stats.chisquare(obs, exp).pvalue)


def two_sample_pvalue(a, b, min_count: float = 10.0) -> float:
    """p-value of the chi-square test that two samples of node ids come
    from one distribution; nodes with fewer than ``min_count`` draws in
    both samples together are merged into one bin."""
    size = int(max(np.max(a), np.max(b))) + 1
    ca = np.bincount(np.asarray(a).ravel(), minlength=size)
    cb = np.bincount(np.asarray(b).ravel(), minlength=size)
    keep = ca + cb >= min_count
    obs = np.stack([np.append(ca[keep], ca[~keep].sum()),
                    np.append(cb[keep], cb[~keep].sum())])
    return float(stats.chi2_contingency(obs[:, obs.sum(axis=0) > 0])[1])


def assert_endpoints_follow(endpoints, probs, p_min: float = 1e-3) -> float:
    """Fails unless the endpoints' counts over ``len(probs)`` nodes pass
    the chi-square test at level ``p_min``; returns the p-value."""
    counts = np.bincount(np.asarray(endpoints).ravel(),
                         minlength=len(probs))
    pv = chisquare_pvalue(counts, probs)
    assert pv > p_min, f"chi-square p-value {pv:.3e} <= {p_min}"
    return pv
