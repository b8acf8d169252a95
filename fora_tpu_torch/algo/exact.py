"""Exact PPR oracle: batched float64 power iteration, the ground truth that
precision@k is scored against.

Same semantics as ``fora_tpu/algo/exact.py::exact_ppr_power_batch`` and
``exact_topk_batch`` (88-193): pi = alpha e_s + (1 - alpha) M^T pi, where
M[v, t] = w(v, t) / W(v) (1 / out_deg(v) per edge when unweighted) and
M has a self-loop on every dangling row, iterated until the L1 change of
every column is at most ``tol``.  It runs on any device as a float64
sparse-CSR times dense product (a library SpMM, independent of the
engine's kernels).
"""

from __future__ import annotations

import numpy as np
import torch


def transition_matrix(g, device) -> torch.Tensor:
    """A[t, v] = multiplicity(v -> t) / out_deg(v), or on a weighted graph
    w(v, t) / W(v) with W the f64 sum of v's out-weights; A[v, v] = 1 for
    dangling v; [n, n] float64 sparse CSR on ``device``.  ``g`` is a host
    CSRGraph."""
    n = g.n
    deg = np.asarray(g.out_deg, dtype=np.int64)
    dang = np.nonzero(deg == 0)[0]
    in_src = np.asarray(g.in_src, np.int64)
    rows = np.concatenate([np.asarray(g.in_dst, np.int64), dang])
    cols = np.concatenate([in_src, dang])
    if g.weighted:
        wsum = np.bincount(np.repeat(np.arange(n, dtype=np.int64), deg),
                           weights=np.asarray(g.out_w, np.float64),
                           minlength=n)
        vals = np.asarray(g.in_w, np.float64) / wsum[in_src]
    else:
        vals = 1.0 / deg[in_src]
    data = np.concatenate([vals, np.ones(len(dang))])
    a = torch.sparse_coo_tensor(
        torch.from_numpy(np.stack([rows, cols])), torch.from_numpy(data),
        (n, n), check_invariants=True).coalesce()   # sums parallel edges
    return a.to_sparse_csr().to(device)


def exact_ppr_batch(g, sources, alpha: float = 0.2, tol: float = 1e-12,
                    max_iters: int = 2000, *, device) -> torch.Tensor:
    """[n, B] float64 PPR of each source (one column per source)."""
    a = transition_matrix(g, device)
    src = torch.as_tensor(np.asarray(sources, dtype=np.int64), device=device)
    cols = torch.arange(src.shape[0], device=device)
    x = torch.zeros((g.n, src.shape[0]), dtype=torch.float64, device=device)
    x[src, cols] = 1.0
    for _ in range(max_iters):
        nxt = (1.0 - alpha) * (a @ x)
        nxt[src, cols] += alpha
        err = float((nxt - x).abs().sum(dim=0).max())
        x = nxt
        if err <= tol:
            break
    return x


def topk_ids(x: torch.Tensor, k: int) -> np.ndarray:
    """[B, k] int64 top-k ids of each column of ``x`` [n, B], by value
    descending, then node id ascending: the tie rule of every top-k in
    both packages (``lax.top_k``, K3).  ``fora_tpu``'s ``exact_topk_batch``
    resolves exact ties at rank k by numpy's argpartition, whose order is
    unspecified and differs between numpy versions; a source with fewer
    than k nodes of positive PPR fills its list with such ties."""
    order = torch.sort(x.T, dim=1, descending=True, stable=True).indices
    return order[:, :k].cpu().numpy().astype(np.int64)


def exact_topk_batch(g, sources, k: int, alpha: float = 0.2,
                     tol: float = 1e-12, *, device) -> np.ndarray:
    """[B, k] int64 top-k ids per source, by exact PPR descending."""
    return topk_ids(exact_ppr_batch(g, sources, alpha, tol, device=device), k)


def exact_ppr_power_batch(g, sources, alpha: float = 0.2, tol: float = 1e-12,
                          max_iters: int = 2000, *, device) -> np.ndarray:
    """``fora_tpu``'s ``exact_ppr_power_batch`` (88-183): [n, B] float64
    numpy, one column per source, computed on ``device``."""
    return exact_ppr_batch(g, sources, alpha, tol, max_iters,
                           device=device).cpu().numpy()


def exact_topk(g, source: int, k: int, alpha: float = 0.2, *, device
               ) -> tuple[np.ndarray, np.ndarray]:
    """``fora_tpu``'s ``exact_topk`` (203-208): the top-k node ids of one
    source (int64, exact ties to the lowest id) and their float64 PPR."""
    ids, vals = exact_topk_many(g, [source], k, alpha, device=device)
    return ids[0], vals[0]


def exact_topk_many(g, sources, k: int, alpha: float = 0.2,
                    tol: float = 1e-12, batch: int = 64, *, device):
    """``exact_topk`` of every source, ``batch`` columns of the power
    iteration at a time: ([B, min(k, n)] int64 ids, [B, min(k, n)] float64
    values)."""
    ids, vals = [np.empty((0, min(k, g.n)), np.int64)], \
        [np.empty((0, min(k, g.n)))]
    for lo in range(0, len(sources), batch):
        x = exact_ppr_batch(g, np.asarray(sources[lo: lo + batch]), alpha,
                            tol, device=device)
        top = topk_ids(x, k)
        ids.append(top)
        vals.append(x.T.gather(1, torch.as_tensor(top, device=x.device))
                    .cpu().numpy())
    return np.concatenate(ids), np.concatenate(vals)
