"""precision@k: a frozen copy of ``fora_tpu_torch/eval/metrics.py``'s
``precision_at_k`` and ``batch_precision_at_k``."""

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
