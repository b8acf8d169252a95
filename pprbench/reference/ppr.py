"""Exact single-source PPR in float64, plain torch, from an edge list.

pi_s = alpha e_s + (1 - alpha) M^T pi_s, where M[v, t] is the number of
edges v -> t over out_deg(v), and a dangling node keeps its mass (a
self-loop), as FORA defines it.  A float64 sparse-CSR times dense power
iteration, run until the L1 change of every column is at most ``tol``,
in blocks of columns so that it fits beside whatever else the device
holds.  Exact ties in the top-k go to the lowest node id.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch


def transition(src: torch.Tensor, dst: torch.Tensor, n: int):
    """A[t, v] = multiplicity(v -> t) / out_deg(v), A[v, v] = 1 for a
    dangling v: [n, n] float64 sparse CSR on the edges' device."""
    src, dst = src.long(), dst.long()
    deg = torch.bincount(src, minlength=n).to(torch.float64)
    dang = torch.nonzero(deg == 0)[:, 0]
    rows = torch.cat([dst, dang])
    cols = torch.cat([src, dang])
    vals = torch.cat([1.0 / deg[src], torch.ones(dang.numel(),
                                                 dtype=torch.float64,
                                                 device=src.device)])
    a = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, (n, n),
                                check_invariants=False)
    del rows, cols, vals
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # CSR "in beta"
        return a.coalesce().to_sparse_csr()   # coalesce sums parallel edges


def exact_ppr(a, sources, alpha: float, tol: float = 1e-10,
              max_iters: int = 1000) -> torch.Tensor:
    """[n, B] float64 PPR of each source under transition ``a``."""
    n = a.shape[0]
    dev = a.device
    src = torch.as_tensor(np.asarray(sources, dtype=np.int64), device=dev)
    cols = torch.arange(src.numel(), device=dev)
    x = torch.zeros((n, src.numel()), dtype=torch.float64, device=dev)
    x[src, cols] = 1.0
    for _ in range(max_iters):
        nxt = (a @ x).mul_(1.0 - alpha)
        nxt[src, cols] += alpha
        err = float((nxt - x).abs().sum(dim=0).max())
        x = nxt
        if err <= tol:
            break
    return x


def topk_exact(x: torch.Tensor, k: int) -> tuple:
    """([B, k] ids, [B, k] values) of each column's k largest, in
    descending order, ties to the lowest id."""
    vals, order = torch.sort(x.T, dim=1, descending=True, stable=True)
    return (order[:, :k].cpu().numpy().astype(np.int64),
            vals[:, :k].cpu().numpy())


def reference_answers(src, dst, n: int, sources, ids, alpha: float, k: int,
                      block: int = 32, tol: float = 1e-10) -> tuple:
    """For each source: its exact top-k ids and their exact PPR, in
    descending order, and the exact PPR of the nodes in ``ids`` (the
    answers to judge, [B, k]): ([B, k] int64, [B, k] float64, [B, k]
    float64)."""
    a = transition(src, dst, n)
    top, top_vals, at = [], [], []
    sources = np.asarray(sources, dtype=np.int64)
    ids = np.asarray(ids, dtype=np.int64)
    for lo in range(0, len(sources), block):
        x = exact_ppr(a, sources[lo:lo + block], alpha, tol)
        t_ids, t_vals = topk_exact(x, k)
        top.append(t_ids)
        top_vals.append(t_vals)
        sel = torch.as_tensor(ids[lo:lo + block], device=x.device)
        at.append(x.T.gather(1, sel.clamp(0, n - 1)).cpu().numpy())
        del x
    del a
    if not len(sources):
        empty = np.zeros((0, k))
        return empty.astype(np.int64), empty, empty
    return np.concatenate(top), np.concatenate(top_vals), np.concatenate(at)
