"""Per-node Bernstein confidence bounds and the split top-k accept.

Port of ``fora_tpu/algo/bounds.py`` (57-142); the derivation is in that
module's docstring.  ``topk_with_bounds_split`` ranks the split
estimate p + contrib per column, returns the top-k with per-node bounds
and the separation test, and runs on a CUDA tensor as one hand-written
kernel (K3, ``kernels/csrc/topk_bounds.cu``); a CPU tensor takes the
plain version, built on ``ops.topk.topk_rows_chunked``.
``topk_with_bounds`` is the unsplit accept, plain only.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import kernels
from ..ops.topk import topk_rows_chunked


def bernstein_ub(mu_hat, c, t):
    """Upper confidence bound on mu given estimate mu_hat (elementwise)."""
    s2 = 2.0 * t * c
    root = (torch.sqrt(s2) + torch.sqrt(s2 + 4.0 * (mu_hat + s2 / 3.0))) * 0.5
    return root * root


def bernstein_lb(mu_hat, c, t, ub=None):
    """Lower confidence bound on mu (elementwise, clamped at 0)."""
    if ub is None:
        ub = bernstein_ub(mu_hat, c, t)
    s2 = 2.0 * t * c
    return torch.clamp_min(mu_hat - s2 / 3.0 - torch.sqrt(s2 * ub), 0.0)


def union_bound_t(n: int, num_levels: int, pfail: float) -> float:
    """ln(2 n L / pfail): the failure budget over n nodes, L levels and
    both deviation sides."""
    return math.log(2.0 * n * max(num_levels, 1) / pfail)


def _c(omega_unit: float) -> np.float32:
    """c = 1 / omega_unit in f32, as JAX computes it from the f32 scalar."""
    return np.float32(1.0) / np.float32(omega_unit)


def _bounds(vals, idx, p_all, omega_unit: float, k: int, t: float,
            eps: float):
    """The accept's epilogue on the top-(k+1) ``vals``/``idx`` [B, kk] and
    p at those rows: the 7-tuple of :func:`topk_with_bounds_split`."""
    B, kk = vals.shape
    c = torch.tensor(_c(omega_unit), device=vals.device)
    vals_k, idx_k = vals[:, :k], idx[:, :k].to(torch.int32)
    p_at = p_all[:, :k]
    mu_hat = torch.clamp_min(vals_k - p_at, 0.0)
    ub_mu = bernstein_ub(mu_hat, c, t)
    lb = p_at + bernstein_lb(mu_hat, c, t, ub=ub_mu)
    ub = p_at + ub_mu
    lbk = lb.min(dim=1).values
    if kk > k:
        ub_excluded = bernstein_ub(vals[:, k], c, t)   # worst case p = 0
    else:  # k >= n: nothing is excluded
        ub_excluded = torch.zeros(B, dtype=vals.dtype, device=vals.device)
    accept = lbk * (1.0 + eps) >= ub_excluded
    return vals_k, idx_k, lb, ub, lbk, ub_excluded, accept


def topk_with_bounds(ppr: torch.Tensor, p: torch.Tensor, omega_unit: float,
                     k: int, t: float, eps: float):
    """The unsplit accept (``fora_tpu``'s ``_topk_with_bounds``, 80-109) on
    a whole estimate ``ppr`` and the settled mass ``p``, both [n, B]; plain
    PyTorch on any device.  The raw-walk runner takes the split accept
    instead (K3 forms the same f32 sum p + contrib)."""
    kk = min(k + 1, ppr.shape[0])
    return _bounds(*topk_rows_chunked(ppr, kk, p), omega_unit, k, t, eps)


def topk_with_bounds_split_plain(p: torch.Tensor, contrib: torch.Tensor,
                                 omega_unit: float, k: int, t: float,
                                 eps: float):
    """Plain version of :func:`topk_with_bounds_split`."""
    kk = min(k + 1, p.shape[0])
    return _bounds(*topk_rows_chunked(p, kk, p, addend=contrib), omega_unit,
                   k, t, eps)


def topk_with_bounds_split(p: torch.Tensor, contrib: torch.Tensor,
                           omega_unit: float, k: int, t: float, eps: float):
    """(vals [B, k], idx [B, k] int32, lb [B, k], ub [B, k], lbk [B],
    ub_excluded [B], accept [B] bool) of the estimate p + contrib, ranked
    by value descending then node id ascending; the same 7-tuple as
    fora_tpu's ``_topk_with_bounds_split``."""
    if p.device.type == "cpu":
        return topk_with_bounds_split_plain(p, contrib, omega_unit, k, t,
                                            eps)
    s2 = float(np.float32(2.0 * t) * _c(omega_unit))
    return kernels.topk_bounds(p, contrib, k, s2, 1.0 + eps)
