"""Destination-row gather-scatter: the SpMV inside the push superstep (K1)
and the index walk phase (K2); and the per-edge row accumulate over an
unsorted edge list (P3, ``row_scatter_add``), the Pallas gather probe's
operation, with ``row_zero_plain``, which clears the rows such a
receive wrote (the plain part of ``ops.exchange.exchange_clear``).

Port of ``fora_tpu/ops/push.py::gather_scatter_add`` (142-191) on a CSR by
destination: edges ``indptr[t]:indptr[t+1]`` of ``src`` all land in row
t.  A CPU tensor takes the plain PyTorch version below; a CUDA tensor
launches the hand-written kernel (``kernels/csrc/gather_scatter.cu``) or
raises.  The kernel walks an edge-balanced work list
(``kernels.schedule.GatherSchedule``) that the caller builds once per CSR
and passes as ``sched``; the plain versions ignore it.  The chunked scan,
``gather_dtype`` and column windows of the JAX function served XLA and
the TPU's memory and are not ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels
from ..kernels.schedule import GatherSchedule


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
                       flag: Optional[torch.Tensor] = None,
                       sched: Optional[GatherSchedule] = None
                       ) -> torch.Tensor:
    """In place: ``acc[t] = masked(acc[t]) + sum_e w_e src_w[s_e]
    values[s_e]`` over CSR row t, where with ``mask`` the entries above
    ``thr[t]`` are zeroed first (the superstep's ``where(active, 0, r)``);
    afterwards ``flag`` (an int32 [1] tensor) is set to 1 if any entry of
    ``acc`` exceeds its row's ``thr``, and is never cleared.  ``sched`` is
    ``indptr``'s work list for the kernel (built per call when absent).
    Returns ``acc``."""
    if acc.device.type == "cpu":
        return gather_scatter_add_plain(acc, values, indptr, src, edge_w,
                                        src_w, thr, mask, flag)
    return kernels.gather_scatter_add(acc, values, indptr, src, edge_w,
                                      src_w, thr, mask, flag, sched)


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


def index_spmv_level_plain(values: torch.Tensor, indptr: torch.Tensor,
                           seg_off, src: torch.Tensor,
                           mult: Optional[torch.Tensor],
                           inv_cnt: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`index_spmv_level`: the per-bucket
    :func:`index_spmv` plain version over the buckets in order, into a
    zero accumulator."""
    n = indptr.shape[1] - 1
    acc = torch.zeros((n, values.shape[1]), dtype=values.dtype,
                      device=values.device)
    for s, lo in enumerate(seg_off.tolist()):
        hi = lo + int(indptr[s, -1])
        gather_scatter_add_plain(
            acc, values, indptr[s], src[lo:hi],
            edge_w=None if mult is None else mult[lo:hi], src_w=inv_cnt)
    return acc


def index_spmv_level(values: torch.Tensor, indptr: torch.Tensor,
                     seg_off: torch.Tensor, src: torch.Tensor,
                     mult: Optional[torch.Tensor], inv_cnt: torch.Tensor,
                     sched: Optional[GatherSchedule] = None) -> torch.Tensor:
    """The walk phase of one index level in one pass (K2): a new [n, B]
    f32 ``acc[t] = sum over buckets s, in order, of sum_e mult_e
    inv_cnt[v_e] values[v_e]`` over bucket s's CSR row t.  ``indptr``
    [S, n+1] holds the S buckets' row pointers by endpoint; their edges
    lie end to end in ``src``/``mult``, bucket s from ``seg_off[s]`` (an
    int32 [S] tensor on ``values``' device).  ``sched`` is the level's
    work list (``gather_schedule(indptr)``)."""
    if values.device.type == "cpu":
        return index_spmv_level_plain(values, indptr, seg_off, src, mult,
                                      inv_cnt)
    acc = torch.empty((indptr.shape[1] - 1, values.shape[1]),
                      dtype=torch.float32, device=values.device)
    return kernels.index_spmv(acc, values, indptr, src, mult, inv_cnt,
                              seg_off=seg_off, sched=sched, accumulate=False)


def row_scatter_add_plain(acc: torch.Tensor, tile: torch.Tensor,
                          src: torch.Tensor, dst: torch.Tensor
                          ) -> torch.Tensor:
    """Plain version of :func:`row_scatter_add`."""
    dst = dst.long()
    keep = (dst >= 0) & (dst < acc.shape[0])
    if not bool(keep.all()):
        dst, src = dst[keep], src[keep]
    return acc.index_add_(0, dst, tile[src.long()])


def row_scatter_add(acc: torch.Tensor, tile: torch.Tensor, src: torch.Tensor,
                    dst: torch.Tensor) -> torch.Tensor:
    """In place: ``acc[dst[e]] += tile[src[e]]`` for every edge e, indices
    in any order (port of ``scripts/pallas_gather_probe.py::kernel``); an
    edge whose ``dst`` lies outside acc's rows is skipped (the pad slots of
    the compacted frontier exchanges, ``ops.exchange``).  A CPU tensor
    takes the plain version; a CUDA tensor launches P3
    (``kernels/csrc/row_scatter.cu``).  Returns ``acc``."""
    if acc.device.type == "cpu":
        return row_scatter_add_plain(acc, tile, src, dst)
    return kernels.row_scatter_add(acc, tile, src, dst)


def row_zero_plain(buf: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """In place: ``buf[ids[e]] = 0`` for every e whose id lies in buf's
    rows; an id outside them (a pad slot of the compacted exchanges) is
    skipped, as P3 skips it.  Returns ``buf``."""
    ids = ids.long().flatten()
    ids = ids[(ids >= 0) & (ids < buf.shape[0])]
    return buf.index_fill_(0, ids, 0.0)
