"""Accuracy metrics against exact PPR, as ``fora_tpu/eval/metrics.py``
(11-55): precision@k, recall@k, and the max and mean relative error over
the guaranteed region."""

from __future__ import annotations

import numpy as np


def precision_at_k(pred_ids, exact_ids) -> float:
    """|pred ∩ exact| / k, both lists of length k."""
    ex = np.asarray(exact_ids).ravel()
    return len(set(np.asarray(pred_ids).ravel().tolist())
               & set(ex.tolist())) / len(ex)


def batch_precision_at_k(pred_ids, exact_ids) -> float:
    """Mean precision@k over a batch: pred [B, k], exact [B, k]."""
    return float(np.mean([precision_at_k(p, e)
                          for p, e in zip(pred_ids, exact_ids)]))


def recall_at_k(pred_ids, exact_ids) -> float:
    """|pred ∩ exact| / |exact|: differs from precision@k when the
    prediction returns fewer than |exact| ids (a candidate-set competitor
    like BiPPR whose target set truncates the answer)."""
    pred = set(np.asarray(pred_ids).ravel().tolist())
    ex = np.asarray(exact_ids).ravel()
    return len(pred & set(ex.tolist())) / max(len(ex), 1)


def batch_recall_at_k(pred_ids, exact_ids) -> float:
    return float(np.mean([recall_at_k(p, e)
                          for p, e in zip(pred_ids, exact_ids)]))


def max_relative_error(pi_hat, pi, delta: float) -> float:
    """max over {t : pi(t) > delta} of |pi_hat - pi| / pi: the quantity the
    (eps, delta, p_f) guarantee bounds."""
    mask = pi > delta
    if not mask.any():
        return 0.0
    return float(np.max(np.abs(pi_hat[mask] - pi[mask]) / pi[mask]))


def mean_relative_error(pi_hat, pi, delta: float) -> float:
    mask = pi > delta
    if not mask.any():
        return 0.0
    return float(np.mean(np.abs(pi_hat[mask] - pi[mask]) / pi[mask]))
