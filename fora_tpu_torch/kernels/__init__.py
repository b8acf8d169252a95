"""Thin wrappers over the hand-written CUDA kernels in ``csrc/``.

Each wrapper checks device, dtype, shape and contiguity, allocates what
the kernel writes, launches on PyTorch's current stream, raises on a
non-zero ``cudaGetLastError()``, and counts its launches in a plain
integer attribute (``push_prepass.launches`` ...) so that a run can show
that its main path went through the kernel.  The wrappers take CUDA
tensors only; the callers in ``ops``/``algo`` send CPU tensors to the plain
PyTorch versions instead.

| wrapper                 | source                 | kernel |
| ----------------------- | ---------------------- | ------ |
| push_prepass            | csrc/push_prepass.cu   | K1 (elementwise half of a superstep) |
| gather_scatter_add      | csrc/gather_scatter.cu | K1 (push gather, tail and hub edges) |
| index_spmv              | csrc/gather_scatter.cu | K2 (index bucket SpMV, same kernel) |
| topk_bounds             | csrc/topk_bounds.cu    | K3 (split accept, both FORA modes) |
| index_walk              | csrc/walk.cu           | K4 (index build, raw-walk FORA, Monte Carlo) |
| ring_all_gather_hop     | csrc/ring.cu           | P1 (one hop of one shard) |
| ring_reduce_scatter_hop | csrc/ring.cu           | P2 (one hop of one shard) |
| row_scatter_add         | csrc/row_scatter.cu    | P3 (per-edge row accumulate, atomics) |

Every launch runs with its output tensor's device current, so shards on
several cards each launch on their own card.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import build

__all__ = ["push_prepass", "gather_scatter_add", "index_spmv", "topk_bounds",
           "index_walk", "ring_all_gather_hop", "ring_reduce_scatter_hop",
           "row_scatter_add", "enable_peer_access", "WRAPPERS", "reset_launch_counts",
           "launch_counts"]


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _check(name: str, t: torch.Tensor, dtype, shape=None, device=None):
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got "
                         f"{getattr(t, 'device', type(t))}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def _raise_on(err: int, name: str):
    if err != 0:
        msg = build.library().fora_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def push_prepass(p: torch.Tensor, r: torch.Tensor, contrib: torch.Tensor,
                 thr: torch.Tensor, deg: torch.Tensor, wsum: torch.Tensor,
                 alpha: float) -> None:
    """In place: p += absorbed mass of the active entries; contrib = the
    mass each active non-dangling row sends down one unit of out-weight."""
    n, B = r.shape
    dev = r.device
    _check("r", r, torch.float32, (n, B))
    _check("p", p, torch.float32, (n, B), dev)
    _check("contrib", contrib, torch.float32, (n, B), dev)
    _check("thr", thr, torch.float32, (n,), dev)
    _check("deg", deg, torch.int32, (n,), dev)
    _check("wsum", wsum, torch.float32, (n,), dev)
    with torch.cuda.device(dev):
        err = build.library().fora_push_prepass(
            _ptr(p), _ptr(r), _ptr(contrib), _ptr(thr), _ptr(deg),
            _ptr(wsum), alpha, 1.0 - alpha, n, B, _stream(r))
    push_prepass.launches += 1
    _raise_on(err, "push_prepass")


def _gather_scatter(acc, values, indptr, src, edge_w, src_w, thr, mask,
                    flag, name):
    n, B = acc.shape
    dev = acc.device
    _check("acc", acc, torch.float32, (n, B))
    _check("values", values, torch.float32, device=dev)
    if values.dim() != 2 or values.shape[1] != B:
        raise ValueError(f"values: shape {tuple(values.shape)}, expected "
                         f"[*, {B}]")
    _check("indptr", indptr, torch.int32, (n + 1,), dev)
    _check("src", src, torch.int32, device=dev)
    E = src.shape[0]
    if edge_w is not None:
        _check("edge_w", edge_w, torch.float32, (E,), dev)
    if src_w is not None:
        _check("src_w", src_w, torch.float32, (values.shape[0],), dev)
    if thr is not None:
        _check("thr", thr, torch.float32, (n,), dev)
    if flag is not None:
        _check("flag", flag, torch.int32, (1,), dev)
    with torch.cuda.device(dev):
        err = build.library().fora_gather_scatter_add(
            _ptr(acc), _ptr(values), _ptr(indptr), _ptr(src), _ptr(edge_w),
            _ptr(src_w), _ptr(thr), int(mask), _ptr(flag), n, B,
            _stream(acc))
    _raise_on(err, name)


def gather_scatter_add(acc: torch.Tensor, values: torch.Tensor,
                       indptr: torch.Tensor, src: torch.Tensor,
                       edge_w: Optional[torch.Tensor] = None,
                       src_w: Optional[torch.Tensor] = None,
                       thr: Optional[torch.Tensor] = None,
                       mask: bool = False,
                       flag: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1: acc[t] = (masked) acc[t] + sum over CSR row t of the scaled
    values[src] rows; ``mask`` zeroes the entries over ``thr[t]`` first,
    and ``flag[0]`` is set to 1 where a row ends over ``thr``.  Updates
    ``acc`` in place."""
    if (mask or flag is not None) and thr is None:
        raise ValueError("mask and flag need thr")
    _gather_scatter(acc, values, indptr, src, edge_w, src_w, thr, mask,
                    flag, "gather_scatter_add")
    gather_scatter_add.launches += 1
    return acc


def index_spmv(acc: torch.Tensor, values: torch.Tensor, indptr: torch.Tensor,
               src: torch.Tensor, mult: Optional[torch.Tensor],
               inv_cnt: torch.Tensor) -> torch.Tensor:
    """K2: one index bucket, acc[t] += sum over the bucket's CSR row t of
    mult_e * inv_cnt[v] * values[v] (same kernel as K1, no mask/flag)."""
    _gather_scatter(acc, values, indptr, src, mult, inv_cnt, None, False,
                    None, "index_spmv")
    index_spmv.launches += 1
    return acc


def topk_bounds(p: torch.Tensor, contrib: torch.Tensor, k: int, s2: float,
                one_plus_eps: float):
    """K3: (vals, idx, lb, ub, lbk, ub_excluded, accept) of the split
    estimate p + contrib; ``s2`` = 2 t c in f32, as bounds.py computes it."""
    n, B = p.shape
    dev = p.device
    _check("p", p, torch.float32, (n, B))
    _check("contrib", contrib, torch.float32, (n, B), dev)
    if not 0 < k < n:
        raise ValueError(f"topk_bounds needs 0 < k < n (k={k}, n={n})")
    lib = build.library()
    kk = k + 1
    seg = lib.fora_topk_segment()
    if kk > seg:
        raise ValueError(f"topk_bounds: k + 1 = {kk} exceeds the sorted "
                         f"segment ({seg})")
    half = B * math.ceil(n / seg) * kk
    scratch_v = torch.empty(2 * half, dtype=torch.float32, device=dev)
    scratch_i = torch.empty(2 * half, dtype=torch.int32, device=dev)
    vals = torch.empty((B, k), dtype=torch.float32, device=dev)
    idx = torch.empty((B, k), dtype=torch.int32, device=dev)
    lb = torch.empty_like(vals)
    ub = torch.empty_like(vals)
    lbk = torch.empty(B, dtype=torch.float32, device=dev)
    ub_excl = torch.empty_like(lbk)
    accept = torch.empty(B, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        err = lib.fora_topk_bounds(
            _ptr(p), _ptr(contrib), n, B, k, kk, s2, one_plus_eps,
            _ptr(scratch_v), _ptr(scratch_i), half, _ptr(vals), _ptr(idx),
            _ptr(lb), _ptr(ub), _ptr(lbk), _ptr(ub_excl), _ptr(accept),
            _stream(p))
    topk_bounds.launches += 1
    _raise_on(err, "topk_bounds")
    return vals, idx, lb, ub, lbk, ub_excl, accept


def index_walk(start: torch.Tensor, out_indptr: torch.Tensor,
               out_indices: torch.Tensor, out_deg: torch.Tensor, seed: int,
               alpha: float, max_hops: int) -> torch.Tensor:
    """K4: endpoints [W] int32 of one alpha-terminating walk per start."""
    (W,) = start.shape
    dev = start.device
    n = out_deg.shape[0]
    _check("start", start, torch.int32, (W,))
    _check("out_indptr", out_indptr, torch.int32, (n + 1,), dev)
    _check("out_indices", out_indices, torch.int32, device=dev)
    _check("out_deg", out_deg, torch.int32, (n,), dev)
    if W >= 2**32:
        raise ValueError("index_walk: at most 2^32 walks per call")
    out = torch.empty(W, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = build.library().fora_index_walk(
            _ptr(start), _ptr(out), W, _ptr(out_indptr), _ptr(out_indices),
            _ptr(out_deg), seed % 2**64, 1.0 / math.log1p(-alpha), max_hops,
            _stream(start))
    index_walk.launches += 1
    _raise_on(err, "index_walk")
    return out


def _ring_hop_check(out: torch.Tensor, *ins: torch.Tensor):
    """``out`` and ``ins`` are CUDA f32 blocks of one shape; the inputs
    may lie on another card (read through a peer pointer)."""
    _check("out", out, torch.float32)
    for i, t in enumerate(ins):
        _check(f"in{i}", t, torch.float32, out.shape)
        if t.device != out.device:
            enable_peer_access(out.device, t.device)


def ring_all_gather_hop(dst: torch.Tensor, src: torch.Tensor) -> None:
    """P1, one hop of one shard: ``dst[:] = src[:]``, where ``dst`` is a
    block of the receiving shard's exchange buffer and ``src`` the same
    block of its left neighbour's.  Launches on ``dst``'s card."""
    _ring_hop_check(dst, src)
    with torch.cuda.device(dst.device):
        err = build.library().fora_ring_copy(_ptr(dst), _ptr(src),
                                             dst.numel(), _stream(dst))
    ring_all_gather_hop.launches += 1
    _raise_on(err, "ring_all_gather_hop")


def ring_reduce_scatter_hop(out: torch.Tensor, recv: torch.Tensor,
                            own: torch.Tensor) -> None:
    """P2, one hop of one shard: ``out = recv + own`` (one f32 add, the
    received partial first), where ``recv`` is the left neighbour's
    partial and ``own`` this shard's block.  Launches on ``out``'s
    card."""
    if own.device != out.device:
        raise ValueError("ring_reduce_scatter_hop: own block on "
                         f"{own.device}, output on {out.device}")
    _ring_hop_check(out, recv, own)
    with torch.cuda.device(out.device):
        err = build.library().fora_ring_add(_ptr(out), _ptr(recv), _ptr(own),
                                            out.numel(), _stream(out))
    ring_reduce_scatter_hop.launches += 1
    _raise_on(err, "ring_reduce_scatter_hop")


def row_scatter_add(acc: torch.Tensor, tile: torch.Tensor, src: torch.Tensor,
                    dst: torch.Tensor) -> torch.Tensor:
    """P3: for every edge e, ``acc[dst[e]] += tile[src[e]]`` (rows of
    width B, f32 atomics, so the order of the adds varies from run to
    run); indices must lie in range.  Updates ``acc`` in place."""
    B = acc.shape[1] if acc.dim() == 2 else -1
    dev = acc.device
    _check("acc", acc, torch.float32)
    _check("tile", tile, torch.float32, device=dev)
    if acc.dim() != 2 or tile.dim() != 2 or tile.shape[1] != B:
        raise ValueError(f"acc {tuple(acc.shape)} and tile "
                         f"{tuple(tile.shape)} must be [*, B] alike")
    (E,) = src.shape
    _check("src", src, torch.int32, (E,), dev)
    _check("dst", dst, torch.int32, (E,), dev)
    with torch.cuda.device(dev):
        err = build.library().fora_row_scatter_add(
            _ptr(acc), _ptr(tile), _ptr(src), _ptr(dst), E, B, _stream(acc))
    row_scatter_add.launches += 1
    _raise_on(err, "row_scatter_add")
    return acc


_peer_pairs: set = set()   # (reader, owner) card indices with access on


def enable_peer_access(reader: torch.device, owner: torch.device) -> None:
    """Let kernels on card ``reader`` read memory of card ``owner``
    (cudaDeviceEnablePeerAccess, once per pair).  Raises where the pair
    has no peer access: nothing stages through the host instead."""
    pair = (torch.device(reader).index, torch.device(owner).index)
    if pair[0] == pair[1] or pair in _peer_pairs:
        return
    _raise_on(build.library().fora_enable_peer_access(*pair),
              f"peer access from cuda:{pair[0]} to cuda:{pair[1]}")
    _peer_pairs.add(pair)


WRAPPERS = (push_prepass, gather_scatter_add, index_spmv, topk_bounds,
            index_walk, ring_all_gather_hop, ring_reduce_scatter_hop,
            row_scatter_add)
for _w in WRAPPERS:
    _w.launches = 0


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0


def launch_counts() -> dict:
    return {w.__name__: w.launches for w in WRAPPERS}
