"""The graph: host CSR packing and the device dataclass of tensors.

Port of ``fora_tpu/graph/csr.py`` (27-61, 135-286).  The host packing
(``CSRGraph``, ``from_edges``) is the same numpy code as JAX's, carried
here so that the port loads nothing of the JAX package; ``to_device``
also accepts a ``fora_tpu`` CSRGraph, which has the same fields.

Beside JAX's fields the port keeps destination row pointers, ``in_indptr``
over the dst-sorted tail in-edges and ``hub_indptr`` over the dst-sorted
hub edges: the CSR by destination that the push gather kernel (K1) walks,
with each one's edge-balanced work list (``in_sched``, ``hub_sched``).
``pad_edges`` is gone: it existed only for XLA's chunk reshape
(``fora_tpu/ops/push.py::_chunked_edges``).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..kernels.schedule import GatherSchedule, gather_schedule
from .alias import build_alias, build_alias_library

log = logging.getLogger(__name__)


class CSRGraph(NamedTuple):
    """Host-side (numpy) packed graph; fields as ``fora_tpu``'s CSRGraph.
    ``out_w``/``in_w`` are per-edge weights in each edge order, or None."""

    out_indptr: np.ndarray   # [n+1] int32, CSR row pointers over out-edges
    out_indices: np.ndarray  # [m]   int32, out-edge destinations (src-sorted)
    in_src: np.ndarray       # [m]   int32, source of each in-edge (dst-sorted)
    in_dst: np.ndarray       # [m]   int32, destination (ascending)
    out_deg: np.ndarray      # [n]   int32
    in_deg: np.ndarray       # [n]   int32
    out_w: np.ndarray = None  # [m] f32 (out-CSR order), or None
    in_w: np.ndarray = None   # [m] f32 (in-edge order), or None

    @property
    def n(self) -> int:
        return int(self.out_indptr.shape[0] - 1)

    @property
    def m(self) -> int:
        return int(self.out_indices.shape[0])

    @property
    def weighted(self) -> bool:
        return self.out_w is not None


def from_edges(src: np.ndarray, dst: np.ndarray, n: int, dedup: bool = False,
               w: Optional[np.ndarray] = None) -> CSRGraph:
    """Pack an edge list into out-CSR + dst-sorted in-edges.  Self-loops
    and parallel edges are kept unless ``dedup`` drops exact duplicates
    (the first of each kept).  ``w`` ([m], positive) are per-edge weights,
    carried as f32 into both edge orders."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if src.shape != dst.shape:
        raise ValueError("src/dst shape mismatch")
    if src.size and (src.min() < 0 or src.max() >= n or dst.min() < 0
                     or dst.max() >= n):
        raise ValueError("edge endpoint out of range")
    if w is not None:
        w = np.asarray(w, dtype=np.float32)
        if w.shape != src.shape:
            raise ValueError("w must be per-edge")
        if w.size and w.min() <= 0:
            raise ValueError("edge weights must be positive")
    if dedup and src.size:
        _, keep = np.unique(src * n + dst, return_index=True)
        src, dst = src[keep], dst[keep]
        if w is not None:
            w = w[keep]
    if src.size >= 2**31:
        raise ValueError("graph exceeds int32 index range")
    order = np.argsort(src, kind="stable")
    out_deg = np.bincount(src, minlength=n)
    out_indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(out_deg, out=out_indptr[1:])
    order_in = np.argsort(dst, kind="stable")
    return CSRGraph(
        out_indptr=out_indptr.astype(np.int32),
        out_indices=dst[order].astype(np.int32),
        in_src=src[order_in].astype(np.int32),
        in_dst=dst[order_in].astype(np.int32),
        out_deg=out_deg.astype(np.int32),
        in_deg=np.bincount(dst, minlength=n).astype(np.int32),
        out_w=None if w is None else w[order],
        in_w=None if w is None else w[order_in])


def dst_indptr(dst: np.ndarray, n: int) -> np.ndarray:
    """[n+1] int32 row pointers of a dst-sorted edge list."""
    return np.searchsorted(np.asarray(dst), np.arange(n + 1),
                           side="left").astype(np.int32)


@dataclasses.dataclass
class DeviceGraph:
    """Device-side graph; field names follow ``fora_tpu``'s DeviceGraph.

    ``in_w`` multiplies each in-edge: merged duplicate multiplicities, or
    on a weighted graph the edge weight w(src, dst) (summed over merged
    parallel edges); with the hub split (``hub_rows`` > 0)
    ``in_src``/``in_dst``/``in_w`` hold only the tail edges and the edges
    from the top-H out-degree sources live in ``hub_*``, gathered from the
    compact ``contrib[hub_ids]`` operand.  A weighted graph also carries
    ``out_wsum`` = W(v), the per-node out-weight the push divides by, its
    weights ``out_w`` in out-CSR order, and the Walker alias tables
    ``alias_prob``/``alias_other`` over the out-CSR slots, with which a
    walk steps v -> u with probability w(v, u) / W(v).
    """

    out_indptr: torch.Tensor            # [n+1] i32
    out_indices: torch.Tensor           # [m] i32
    in_src: torch.Tensor                # [m_tail] i32
    in_dst: torch.Tensor                # [m_tail] i32, ascending
    in_indptr: torch.Tensor             # [n+1] i32 over in_dst
    out_deg: torch.Tensor               # [n] i32
    in_w: Optional[torch.Tensor] = None       # [m_tail] f32
    out_wsum: Optional[torch.Tensor] = None   # [n] f32
    alias_prob: Optional[torch.Tensor] = None   # [m] f32
    alias_other: Optional[torch.Tensor] = None  # [m] i32
    out_w: Optional[torch.Tensor] = None        # [m] f32, out-CSR order
    hub_ids: Optional[torch.Tensor] = None        # [H] i32
    hub_src_local: Optional[torch.Tensor] = None  # [m_hub] i32 slot in hub_ids
    hub_dst: Optional[torch.Tensor] = None        # [m_hub] i32, ascending
    hub_w: Optional[torch.Tensor] = None          # [m_hub] f32
    hub_indptr: Optional[torch.Tensor] = None     # [n+1] i32 over hub_dst
    in_sched: Optional[GatherSchedule] = None     # K1's tasks over in_indptr
    hub_sched: Optional[GatherSchedule] = None    # K1's tasks over hub_indptr
    out_sched: Optional[GatherSchedule] = None    # K1's tasks over out_indptr
    #                                               (out_schedule(), lazily)

    @property
    def n(self) -> int:
        return self.out_indptr.shape[0] - 1

    @property
    def m(self) -> int:
        return self.out_indices.shape[0]

    @property
    def weighted(self) -> bool:
        return self.out_wsum is not None

    @property
    def hub_split(self) -> bool:
        return self.hub_ids is not None

    @property
    def m_in(self) -> int:
        m = self.in_src.shape[0]
        if self.hub_src_local is not None:
            m += self.hub_src_local.shape[0]
        return m

    @property
    def device(self) -> torch.device:
        return self.out_indptr.device


def out_schedule(graph: DeviceGraph) -> GatherSchedule:
    """K1's work list over the out-CSR (BiPPR's backward gather), built at
    the first call and kept on the graph, so that the forward paths never
    pay for it."""
    if graph.out_sched is None:
        graph.out_sched = gather_schedule(graph.out_indptr)
    return graph.out_sched


def host_to_device(a, device, dtype) -> Optional[torch.Tensor]:
    """Copy a host array (numpy, mmap view or read-only buffer) to a
    tensor of ``dtype`` on ``device``; None stays None."""
    if a is None:
        return None
    a = np.ascontiguousarray(a, dtype=dtype)
    if not a.flags.writeable:   # torch does not wrap read-only memory
        a = a.copy()
    return torch.from_numpy(a).to(device)


def from_numpy_fields(fields: dict, *, device) -> DeviceGraph:
    """DeviceGraph from host arrays named as its fields (row pointers are
    derived from the dst-sorted edge lists when absent, and the gather's
    work lists from the row pointers)."""
    n = int(np.asarray(fields["out_indptr"]).shape[0]) - 1
    f = {k: v for k, v in fields.items() if v is not None}
    f.setdefault("in_indptr", dst_indptr(f["in_dst"], n))
    if "hub_dst" in f:
        f.setdefault("hub_indptr", dst_indptr(f["hub_dst"], n))
    ints = {"out_indptr", "out_indices", "in_src", "in_dst", "in_indptr",
            "out_deg", "alias_other", "hub_ids", "hub_src_local", "hub_dst",
            "hub_indptr"}
    names = {fl.name for fl in dataclasses.fields(DeviceGraph)}
    dg = DeviceGraph(**{
        k: host_to_device(v, device, np.int32 if k in ints else np.float32)
        for k, v in f.items() if k in names})
    dg.in_sched = gather_schedule(dg.in_indptr)
    if dg.hub_indptr is not None:
        dg.hub_sched = gather_schedule(dg.hub_indptr)
    return dg


def to_device(g: CSRGraph, merge_duplicate_edges: bool = False,
              hub_rows: int = 0, *, device) -> DeviceGraph:
    """Lay ``g`` out on ``device``; port of fora_tpu's ``to_device``.

    ``merge_duplicate_edges`` collapses parallel in-edges into unique
    (src, dst) pairs with an ``in_w`` multiplicity (on a weighted graph,
    the sum of their weights, taken in f64); ``hub_rows`` > 0 moves the
    in-edges of the top-``hub_rows`` out-degree sources into the hub
    partition.  Both keep every edge list dst-sorted, so each has a CSR by
    destination (``in_indptr``, ``hub_indptr``).

    A weighted graph (``g.out_w`` set) also gets ``out_wsum`` (the f64 sum
    of each node's out-weights, cast to f32), ``out_w`` and its alias
    tables: on a CUDA device from the library's builder
    (``kernels/csrc/alias.cu``, host code), on the CPU from the numpy
    copy; the two give equal tables.  The build's seconds go to this
    module's logger at INFO.
    """
    in_src, in_dst = g.in_src, g.in_dst
    in_w = None if g.in_w is None else np.asarray(g.in_w, np.float32)
    fields = dict(out_indptr=g.out_indptr, out_indices=g.out_indices,
                  out_deg=g.out_deg)
    if g.weighted:
        src = np.repeat(np.arange(g.n, dtype=np.int64),
                        np.asarray(g.out_deg, dtype=np.int64))
        build = (build_alias_library if torch.device(device).type == "cuda"
                 else build_alias)
        t0 = time.perf_counter()
        tables = build(g, g.out_w)
        log.info("alias tables of %d slots built by %s in %.3f s", g.m,
                 build.__name__, time.perf_counter() - t0)
        fields.update(
            out_wsum=np.bincount(src, weights=np.asarray(g.out_w, np.float64),
                                 minlength=g.n).astype(np.float32),
            out_w=g.out_w, alias_prob=tables.prob, alias_other=tables.other)
    if merge_duplicate_edges and g.m:
        # in-edges are dst-sorted; a stable (dst, src) sort keeps dst order
        key = g.in_dst.astype(np.int64) * g.n + g.in_src
        order = np.argsort(key, kind="stable")
        ks = key[order]
        first = np.ones(ks.size, bool)
        first[1:] = ks[1:] != ks[:-1]
        if not first.all():
            starts = np.nonzero(first)[0]
            in_src = g.in_src[order][starts]
            in_dst = g.in_dst[order][starts]
            if g.weighted:
                in_w = np.bincount(
                    np.cumsum(first) - 1,
                    weights=g.in_w[order].astype(np.float64),
                    minlength=len(starts)).astype(np.float32)
            else:
                in_w = np.diff(np.append(starts, ks.size)).astype(np.float32)
    if hub_rows > 0 and g.n > hub_rows and len(in_src):
        deg = np.asarray(g.out_deg, np.int64)
        hub_ids = np.sort(np.argsort(-deg, kind="stable")[:hub_rows]
                          ).astype(np.int32)
        hub_slot = np.full(g.n, -1, np.int32)
        hub_slot[hub_ids] = np.arange(hub_rows, dtype=np.int32)
        is_hub = hub_slot[in_src] >= 0
        # a stable partition keeps each subset dst-sorted
        fields.update(hub_ids=hub_ids, hub_src_local=hub_slot[in_src[is_hub]],
                      hub_dst=in_dst[is_hub])
        if in_w is not None:
            fields["hub_w"] = in_w[is_hub]
            in_w = in_w[~is_hub]
        in_src, in_dst = in_src[~is_hub], in_dst[~is_hub]
    fields.update(in_src=in_src, in_dst=in_dst, in_w=in_w)
    return from_numpy_fields(fields, device=device)
