"""Node-chunked top-k over a node-major [n, B] estimate (plain version).

Port of ``fora_tpu/ops/topk.py::topk_nodes`` and ``topk_rows_chunked``
(17-21, 30-127).  Ties are
broken by node id ascending, as ``lax.top_k`` does: every selection is a
stable descending sort, and slab candidates are merged in slab order.  The
hand-written kernel for the accept (K3) lives in ``algo.bounds``;
``topk_sum`` (the sharded engine's local top-k) reuses its selection.
"""

from __future__ import annotations

import torch

from .. import kernels


def _top(score: torch.Tensor, k: int):
    """[B, L] -> (values, positions) of the k largest per row, value
    descending then position ascending."""
    vals, pos = torch.sort(score, dim=1, descending=True, stable=True)
    return vals[:, :k], pos[:, :k]


def topk_rows_chunked(ppr: torch.Tensor, k: int, *extra: torch.Tensor,
                      chunk: int = 1 << 19,
                      addend: torch.Tensor = None):
    """Top-k rows per column of ``ppr`` (+ ``addend``, summed per slab).

    Returns (vals [B, k] descending, row ids [B, k] int64, *extra_at
    [B, k]) where each ``extra`` [n, B] array is read at the winning rows.
    """
    n = ppr.shape[0]
    kk = min(k, chunk)
    cand_v, cand_i = [], []
    cand_e = [[] for _ in extra]
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        s = ppr[lo:hi]
        if addend is not None:
            s = s + addend[lo:hi]
        v, i = _top(s.T, min(kk, hi - lo))
        cand_v.append(v)
        cand_i.append(i + lo)
        for j, e in enumerate(extra):
            cand_e[j].append(torch.gather(e[lo:hi].T, 1, i))
    if len(cand_v) == 1:
        return (cand_v[0], cand_i[0], *(ce[0] for ce in cand_e))
    vals, sel = _top(torch.cat(cand_v, dim=1), k)
    idx = torch.gather(torch.cat(cand_i, dim=1), 1, sel)
    outs = [torch.gather(torch.cat(ce, dim=1), 1, sel) for ce in cand_e]
    return (vals, idx, *outs)


def topk_nodes(ppr: torch.Tensor, k: int):
    """(values [B, k] descending, node ids [B, k] int64) of a node-major
    [n, B] estimate (``fora_tpu/ops/topk.py::topk_nodes``, 17-21)."""
    return topk_rows_chunked(ppr, k)


def topk_sum(p: torch.Tensor, addend: torch.Tensor, k: int):
    """(vals [B, k], row ids [B, k] int64) of ``p + addend`` per column,
    value descending then row id ascending.  A CPU tensor takes
    :func:`topk_rows_chunked`; a CUDA tensor takes the selection of the
    split-accept kernel (K3, ``kernels.topk_bounds``), whose sum
    ``p + addend`` is the same f32 value (its bounds are not used)."""
    if p.device.type == "cpu":
        return topk_rows_chunked(p, k, addend=addend)
    vals, idx = kernels.topk_bounds(p, addend, k, 0.0, 1.0)[:2]
    return vals, idx.long()
