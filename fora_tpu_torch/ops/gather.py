"""Destination-row gather-scatter: the SpMV inside the push superstep (K1)
and the index walk phase (K2); and the per-edge row accumulate over an
unsorted edge list (P3, ``row_scatter_add``), the Pallas gather probe's
operation.

Port of ``fora_tpu/ops/push.py::gather_scatter_add`` (142-191) on a CSR by
destination: edges ``indptr[t]:indptr[t+1]`` of ``src`` all land in row
t.  A CPU tensor takes the plain PyTorch version below; a CUDA tensor
launches the hand-written kernel (``kernels/csrc/gather_scatter.cu``) or
raises.  The chunked scan, ``gather_dtype`` and column windows of the JAX
function served XLA and the TPU's memory and are not ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels


def gather_scatter_add_plain(acc: torch.Tensor, values: torch.Tensor,
                             indptr: torch.Tensor, src: torch.Tensor,
                             edge_w: Optional[torch.Tensor] = None,
                             src_w: Optional[torch.Tensor] = None,
                             thr: Optional[torch.Tensor] = None,
                             mask: bool = False,
                             flag: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Plain version of :func:`gather_scatter_add` (index_add_ over the
    gathered, scaled rows)."""
    n = acc.shape[0]
    dst = torch.repeat_interleave(
        torch.arange(n, device=acc.device), torch.diff(indptr.long()))
    s = src.long()
    vals = values[s]
    if src_w is not None:
        vals = vals * src_w[s][:, None]
    if edge_w is not None:
        vals = vals * edge_w[:, None]
    if mask:
        acc.masked_fill_(acc > thr[:, None], 0.0)
    acc.index_add_(0, dst, vals)
    if flag is not None:
        flag |= (acc > thr[:, None]).any().to(flag.dtype)
    return acc


def gather_scatter_add(acc: torch.Tensor, values: torch.Tensor,
                       indptr: torch.Tensor, src: torch.Tensor,
                       edge_w: Optional[torch.Tensor] = None,
                       src_w: Optional[torch.Tensor] = None,
                       thr: Optional[torch.Tensor] = None,
                       mask: bool = False,
                       flag: Optional[torch.Tensor] = None) -> torch.Tensor:
    """In place: ``acc[t] = masked(acc[t]) + sum_e w_e src_w[s_e]
    values[s_e]`` over CSR row t, where with ``mask`` the entries above
    ``thr[t]`` are zeroed first (the superstep's ``where(active, 0, r)``);
    afterwards ``flag`` (an int32 [1] tensor) is set to 1 if any entry of
    ``acc`` exceeds its row's ``thr``, and is never cleared.  Returns
    ``acc``."""
    if acc.device.type == "cpu":
        return gather_scatter_add_plain(acc, values, indptr, src, edge_w,
                                        src_w, thr, mask, flag)
    return kernels.gather_scatter_add(acc, values, indptr, src, edge_w,
                                      src_w, thr, mask, flag)


def index_spmv(acc: torch.Tensor, values: torch.Tensor, indptr: torch.Tensor,
               src: torch.Tensor, mult: Optional[torch.Tensor],
               inv_cnt: torch.Tensor) -> torch.Tensor:
    """One FORA+ index bucket into the walk accumulator (K2):
    ``acc[t] += sum_e mult_e inv_cnt[v_e] values[v_e]``.  The bucket's
    edges are endpoint-sorted, so ``indptr`` is its CSR by endpoint."""
    if acc.device.type == "cpu":
        return gather_scatter_add_plain(acc, values, indptr, src,
                                        edge_w=mult, src_w=inv_cnt)
    return kernels.index_spmv(acc, values, indptr, src, mult, inv_cnt)


def row_scatter_add_plain(acc: torch.Tensor, tile: torch.Tensor,
                          src: torch.Tensor, dst: torch.Tensor
                          ) -> torch.Tensor:
    """Plain version of :func:`row_scatter_add`."""
    return acc.index_add_(0, dst.long(), tile[src.long()])


def row_scatter_add(acc: torch.Tensor, tile: torch.Tensor, src: torch.Tensor,
                    dst: torch.Tensor) -> torch.Tensor:
    """In place: ``acc[dst[e]] += tile[src[e]]`` for every edge e, indices
    in any order (port of ``scripts/pallas_gather_probe.py::kernel``).  A
    CPU tensor takes the plain version; a CUDA tensor launches P3
    (``kernels/csrc/row_scatter.cu``).  Returns ``acc``."""
    if acc.device.type == "cpu":
        return row_scatter_add_plain(acc, tile, src, dst)
    return kernels.row_scatter_add(acc, tile, src, dst)
