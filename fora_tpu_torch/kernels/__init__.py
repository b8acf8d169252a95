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
| backward_prepass        | csrc/push_prepass.cu   | K1-back (the same half of BiPPR's backward superstep) |
| gather_scatter_add      | csrc/gather_scatter.cu | K1 (push gather, tail and hub edges; BiPPR's over the out-CSR) |
| index_spmv              | csrc/gather_scatter.cu | K2 (index SpMV, a level in one launch) |
| topk_bounds             | csrc/topk_bounds.cu    | K3 (split accept, both FORA modes) |
| index_walk              | csrc/walk.cu           | K4 (index build, raw-walk FORA, Monte Carlo, BiPPR, HubPPR's pool; plan in schedule.py) |
| index_walk_alias        | csrc/walk.cu           | K4's alias branch (the same, on weighted graphs) |
| index_walk_hub          | csrc/walk.cu           | K4-hub (HubPPR's query walks, uniform or alias hops) |
| index_walk_sharded      | csrc/walk.cu           | K4's sharded form (the out-CSR as a table of shard slices: the sharded raw one-shot and index build) |
| index_walk_sharded_alias | csrc/walk.cu          | the same, alias hops (weighted graphs) |
| ring_all_gather_hop     | csrc/ring.cu           | P1 (one hop of one shard) |
| ring_reduce_scatter_hop | csrc/ring.cu           | P2 (one hop of one shard; shards on several cards) |
| reduce_scatter_onepass  | csrc/ring.cu           | P2 in one launch (every shard on one card) |
| row_scatter_add         | csrc/row_scatter.cu    | P3 (per-edge row accumulate, atomics; the receive of the compacted exchanges) |
| exchange_clear          | csrc/row_scatter.cu    | the compacted exchange's clear before a receive: every buffer's own block and the rows the previous receive wrote, one launch |
| frontier_compact        | csrc/exchange.cu       | the frontier compaction (the send side of the compact, routed and hier exchanges) |
| frontier_prepass        | csrc/frontier_push.cu  | K5's pre-pass (K1's pre-pass, the residue's mask and the active rows' tasks with their non-zero chunks, for the frontier-compacted push) |
| frontier_push           | csrc/frontier_push.cu  | K5 (the frontier-compacted push: the active rows' non-zero chunks along their out-edges, f32 atomics) |
| walk_demand             | csrc/walk_alloc.cu     | K6-demand (the raw walk's omega_v, its int32 scan over nodes and the column totals: raw pool, sharded raw one-shot) |
| expand_lanes            | csrc/walk_alloc.cu     | K6-expand (a range of lanes onto their start nodes and weights; the sharded form expands a chunk over every shard's demand in one launch) |
| accumulate_endpoints    | csrc/walk_alloc.cu     | K6-accum (the endpoints' scatter-add, f32 atomics: raw pool, sharded raw one-shot, Monte Carlo, HubPPR) |
| sector_reads            | csrc/sector_probe.cu   | none: measures the card's rate of scattered 32-byte reads |
| row_reads               | csrc/sector_probe.cu   | none: measures the card's rate of scattered 512-byte row reads |
| philox_blocks           | csrc/philox_probe.cu   | none: measures the card's rate of Philox-4x32-10 blocks (K4's operations) |

K6's plain versions are ``ops/walk.py``'s ``*_plain`` functions, held to
JAX's ``allocate_walks`` / ``accumulate_endpoints`` on the CPU by
``tests/test_torch_walk_alloc.py``; on a card ``-k "walk_demand or expand
or accumulate or k6"`` of ``tests/test_torch_kernels_cuda.py`` holds the
kernels to them.

``csrc/alias.cu`` and ``csrc/graph_io.cu`` hold no kernel: they are the
host-side alias-table builder that ``graph/alias.py::build_alias_library``
calls and the edge-list parser that ``graph/io.py::parse_edges_library``
calls.

Every launch runs with its output tensor's device current, so shards on
several cards each launch on their own card.  The gather takes its work
list (``schedule.GatherSchedule``) from the caller, or builds it per call;
the walk kernels take their plan (``schedule.walk_plan``) from the number
of walks and the card's SM count.
"""

from __future__ import annotations

import ctypes
import math
import struct
from typing import Optional

import torch

from . import build, schedule, select

__all__ = ["push_prepass", "backward_prepass", "gather_scatter_add",
           "index_spmv", "topk_bounds", "topk_bounds_stats", "index_walk",
           "index_walk_alias", "index_walk_hub", "index_walk_sharded",
           "index_walk_sharded_alias", "ring_all_gather_hop",
           "ring_reduce_scatter_hop", "reduce_scatter_onepass",
           "row_scatter_add", "exchange_clear", "frontier_compact",
           "frontier_prepass", "frontier_push", "walk_demand",
           "expand_lanes", "accumulate_endpoints", "sector_reads",
           "row_reads",
           "philox_blocks", "inv_log1m_alpha", "sm_count",
           "enable_peer_access",
           "WRAPPERS", "reset_launch_counts", "launch_counts"]


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


def _table(ts) -> Optional[ctypes.c_void_p]:
    """A host array of the tensors' device pointers (None for None), for a
    C entry that copies it into a kernel parameter."""
    return None if ts is None else ctypes.cast(
        (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts]),
        ctypes.c_void_p)


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


def backward_prepass(p: torch.Tensor, r: torch.Tensor, spread: torch.Tensor,
                     rmax_b: float, deg: torch.Tensor, alpha: float) -> None:
    """K1-back: in place, ``p`` += the settled mass of the entries over
    ``rmax_b`` (all of it at a dangling row, alpha of it elsewhere);
    ``spread`` = what each such entry sends back along its in-edges
    ((1 - alpha) / alpha of it at a dangling row, 1 - alpha elsewhere)."""
    n, B = r.shape
    dev = r.device
    _check("r", r, torch.float32, (n, B))
    _check("p", p, torch.float32, (n, B), dev)
    _check("spread", spread, torch.float32, (n, B), dev)
    _check("deg", deg, torch.int32, (n,), dev)
    with torch.cuda.device(dev):
        err = build.library().fora_backward_prepass(
            _ptr(p), _ptr(r), _ptr(spread), rmax_b, _ptr(deg), alpha,
            1.0 - alpha, (1.0 - alpha) / alpha, n, B, _stream(r))
    backward_prepass.launches += 1
    _raise_on(err, "backward_prepass")


def _gather_scatter(acc, values, indptr, seg_off, src, edge_w, src_w, thr,
                    mask, accumulate, flag, sched, name):
    """Checks and launches csrc/gather_scatter.cu over the S segments of
    ``indptr`` ([n+1] is one segment; [S, n+1] with ``seg_off`` [S], the
    first edge of each segment in ``src``/``edge_w``)."""
    n, B = acc.shape
    dev = acc.device
    _check("acc", acc, torch.float32, (n, B))
    _check("values", values, torch.float32, device=dev)
    if values.dim() != 2 or values.shape[1] != B:
        raise ValueError(f"values: shape {tuple(values.shape)}, expected "
                         f"[*, {B}]")
    S = 1 if indptr.dim() == 1 else indptr.shape[0]
    if S > 32:
        raise ValueError(f"{name}: at most 32 segments, got {S}")
    _check("indptr", indptr, torch.int32,
           (n + 1,) if indptr.dim() == 1 else (S, n + 1), dev)
    if (seg_off is None) != (indptr.dim() == 1):
        raise ValueError("seg_off goes with a [S, n+1] indptr, and only "
                         "with one")
    if seg_off is not None:
        _check("seg_off", seg_off, torch.int32, (S,), dev)
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
    if sched is None:
        sched = schedule.gather_schedule(indptr)
    if sched.n_rows != n or sched.device != dev:
        raise ValueError(f"{name}: schedule of {sched.n_rows} rows on "
                         f"{sched.device}, expected {n} rows on {dev}")
    partial = torch.empty((sched.n_slots, B), dtype=torch.float32,
                          device=dev)
    with torch.cuda.device(dev):
        err = build.library().fora_gather_scatter_add(
            _ptr(acc), _ptr(values), _ptr(indptr), S, _ptr(seg_off),
            _ptr(src), _ptr(edge_w), _ptr(src_w), _ptr(thr), int(mask),
            int(accumulate), _ptr(flag), _ptr(sched.tasks), sched.n_tasks,
            _ptr(partial) if sched.n_slots else None, _ptr(sched.slot_row),
            _ptr(sched.split_ptr), _ptr(sched.counters), n, B,
            _stream(acc))
    _raise_on(err, name)


def gather_scatter_add(acc: torch.Tensor, values: torch.Tensor,
                       indptr: torch.Tensor, src: torch.Tensor,
                       edge_w: Optional[torch.Tensor] = None,
                       src_w: Optional[torch.Tensor] = None,
                       thr: Optional[torch.Tensor] = None,
                       mask: bool = False,
                       flag: Optional[torch.Tensor] = None,
                       sched: Optional[schedule.GatherSchedule] = None
                       ) -> torch.Tensor:
    """K1: acc[t] = (masked) acc[t] + sum over CSR row t of the scaled
    values[src] rows; ``mask`` zeroes the entries over ``thr[t]`` first,
    and ``flag[0]`` is set to 1 where a row ends over ``thr``.  ``sched``
    is ``indptr``'s work list (``schedule.gather_schedule``), built here
    when absent.  Updates ``acc`` in place."""
    if (mask or flag is not None) and thr is None:
        raise ValueError("mask and flag need thr")
    _gather_scatter(acc, values, indptr, None, src, edge_w, src_w, thr, mask,
                    True, flag, sched, "gather_scatter_add")
    gather_scatter_add.launches += 1
    return acc


def index_spmv(acc: torch.Tensor, values: torch.Tensor, indptr: torch.Tensor,
               src: torch.Tensor, mult: Optional[torch.Tensor],
               inv_cnt: torch.Tensor, seg_off: Optional[torch.Tensor] = None,
               sched: Optional[schedule.GatherSchedule] = None,
               accumulate: bool = True) -> torch.Tensor:
    """K2: acc[t] (+)= sum over the index edges into endpoint t of
    mult_e * inv_cnt[v] * values[v] (same kernel as K1, no mask/flag).
    ``indptr`` is one bucket's [n+1] CSR by endpoint, or a level's [S,
    n+1] over S buckets whose edges lie end to end in ``src``/``mult``
    from ``seg_off`` [S] on; each row sums its buckets in order.  With
    ``accumulate`` False, ``acc`` is overwritten (no zero fill needed)."""
    _gather_scatter(acc, values, indptr, seg_off, src, mult, inv_cnt, None,
                    False, accumulate, None, sched, "index_spmv")
    index_spmv.launches += 1
    return acc


def topk_bounds(p: torch.Tensor, contrib: torch.Tensor, k: int, s2: float,
                one_plus_eps: float, stride: Optional[int] = None,
                capacity: Optional[int] = None):
    """K3: (vals, idx, lb, ub, lbk, ub_excluded, accept) of the split
    estimate p + contrib; ``s2`` = 2 t c in f32, as bounds.py computes it.
    The scores must not be NaN.  ``stride`` (the threshold sample's row
    stride, 0 for the dense path) and ``capacity`` (candidates per column
    before a column goes dense) default to ``select.select_plan``'s and one
    segment; tests set them to force a path.  The call's device-side
    counters stay readable through :func:`topk_bounds_stats`."""
    n, B = p.shape
    dev = p.device
    _check("p", p, torch.float32, (n, B))
    _check("contrib", contrib, torch.float32, (n, B), dev)
    if not 0 < k < n:
        raise ValueError(f"topk_bounds needs 0 < k < n (k={k}, n={n})")
    lib = build.library()
    kk = k + 1
    seg = lib.fora_topk_segment()
    if seg != select.SEGMENT:
        raise RuntimeError(f"topk_bounds.cu sorts {seg} keys a block, "
                           f"select.py plans for {select.SEGMENT}")
    if kk > seg:
        raise ValueError(f"topk_bounds: k + 1 = {kk} exceeds the sorted "
                         f"segment ({seg})")
    cap = seg if capacity is None else int(capacity)
    if not 0 < cap <= seg:
        raise ValueError(f"topk_bounds: capacity {cap} not in 1..{seg}")
    if stride is None:
        stride = select.select_plan(n, kk, cap)
    if stride < 0 or stride == 1:
        raise ValueError(f"topk_bounds: stride {stride} (0: dense, or >= 2)")
    half = B * math.ceil(n / seg) * kk
    scratch_v = torch.empty(2 * half, dtype=torch.float32, device=dev)
    scratch_i = torch.empty(2 * half, dtype=torch.int32, device=dev)
    list_len = B * cap if stride else 0
    list_v = torch.empty(list_len, dtype=torch.float32, device=dev)
    list_i = torch.empty(list_len, dtype=torch.int32, device=dev)
    # written by the call's first kernel: [0] columns on the dense path,
    # [1, 1 + B) candidates per column, then flags and the dense columns
    state = torch.empty(1 + 3 * B, dtype=torch.int32, device=dev)
    vals = torch.empty((B, k), dtype=torch.float32, device=dev)
    idx = torch.empty((B, k), dtype=torch.int32, device=dev)
    lb = torch.empty_like(vals)
    ub = torch.empty_like(vals)
    lbk = torch.empty(B, dtype=torch.float32, device=dev)
    ub_excl = torch.empty_like(lbk)
    accept = torch.empty(B, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        err = lib.fora_topk_bounds(
            _ptr(p), _ptr(contrib), n, B, k, kk, s2, one_plus_eps, stride,
            cap, _ptr(scratch_v), _ptr(scratch_i), half, _ptr(list_v),
            _ptr(list_i), _ptr(state), _ptr(vals), _ptr(idx), _ptr(lb),
            _ptr(ub), _ptr(lbk), _ptr(ub_excl), _ptr(accept), _stream(p))
    topk_bounds.launches += 1
    topk_bounds.last_state = state
    _raise_on(err, "topk_bounds")
    return vals, idx, lb, ub, lbk, ub_excl, accept


def topk_bounds_stats() -> dict:
    """The device-side counters of the last :func:`topk_bounds` call:
    ``candidates`` [B] (what the filter appended per column; zeros when the
    call went dense by shape) and ``dense_columns`` (columns finished by
    the dense path).  Reads the device, so it synchronises: for tests and
    measurements, never on the query path."""
    state = topk_bounds.last_state
    if state is None:
        raise RuntimeError("topk_bounds has not run")
    host = state.cpu()
    B = (host.numel() - 1) // 3
    return dict(candidates=host[1:1 + B].numpy(),
                dense_columns=int(host[0]))


_sm_counts: dict = {}


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (cached)."""
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_counts[idx]


def inv_log1m_alpha(alpha: float) -> float:
    """1 / log(1 - alpha) rounded to float32, as the walk kernel takes it
    (the plain ``ops.walk.run_walks_philox`` uses the same value)."""
    return struct.unpack("f", struct.pack("f", 1.0 / math.log1p(-alpha)))[0]


def _index_walk(start, out_indptr, out_indices, alias_prob, alias_other,
                seed, alpha, max_hops, name, hub_id=None, pool=None,
                plan=None) -> torch.Tensor:
    """Checks and launches csrc/walk.cu; uniform hops where ``alias_prob``
    and ``alias_other`` are None, no hub lookup where ``hub_id`` and
    ``pool`` are None.  ``plan`` defaults to ``schedule.walk_plan``'s; only
    chip_smoke.py's sweep of walks per lane and the card's tests force
    another (``schedule.walk_grid``)."""
    (W,) = start.shape
    dev = start.device
    _check("start", start, torch.int32, (W,))
    _check("out_indptr", out_indptr, torch.int32, device=dev)
    if out_indptr.dim() != 1 or out_indptr.shape[0] < 1:
        raise ValueError(f"{name}: out_indptr must be [n + 1]")
    n = out_indptr.shape[0] - 1
    _check("out_indices", out_indices, torch.int32, device=dev)
    if alias_prob is not None:
        m = out_indices.shape
        _check("alias_prob", alias_prob, torch.float32, m, dev)
        _check("alias_other", alias_other, torch.int32, m, dev)
    pool_size = 0
    if hub_id is not None:
        _check("hub_id", hub_id, torch.int32, (n,), dev)
        _check("pool", pool, torch.int32, device=dev)
        if pool.dim() != 2 or pool.shape[1] < 1:
            raise ValueError(f"{name}: pool must be [H, P], got "
                             f"{tuple(pool.shape)}")
        pool_size = pool.shape[1]
    if W >= 2**32:
        raise ValueError(f"{name}: at most 2^32 - 1 walks per call")
    out = torch.empty(W, dtype=torch.int32, device=dev)
    if W == 0:
        return out
    if plan is None:
        plan = schedule.walk_plan(W, sm_count(dev))
    with torch.cuda.device(dev):
        err = build.library().fora_index_walk(
            _ptr(start), _ptr(out), W, _ptr(out_indptr), _ptr(out_indices),
            _ptr(alias_prob), _ptr(alias_other), _ptr(hub_id), _ptr(pool),
            pool_size, seed % 2**64, inv_log1m_alpha(alpha), max_hops,
            plan.walks_per_lane, plan.blocks, _stream(start))
    _raise_on(err, name)
    return out


def index_walk(start: torch.Tensor, out_indptr: torch.Tensor,
               out_indices: torch.Tensor, seed: int, alpha: float,
               max_hops: int) -> torch.Tensor:
    """K4: endpoints [W] int32 of one alpha-terminating walk per start,
    each hop to a uniform out-neighbour; walk w's endpoint depends on
    (seed, w, start[w]) alone, bit-equal to ``ops.walk.run_walks_philox``."""
    out = _index_walk(start, out_indptr, out_indices, None, None, seed,
                      alpha, max_hops, "index_walk")
    index_walk.launches += 1
    return out


def index_walk_alias(start: torch.Tensor, out_indptr: torch.Tensor,
                     out_indices: torch.Tensor, alias_prob: torch.Tensor,
                     alias_other: torch.Tensor, seed: int, alpha: float,
                     max_hops: int) -> torch.Tensor:
    """K4's alias branch: as :func:`index_walk`, each hop through the
    Walker alias tables over the out-CSR slots (a weighted graph's
    w(v, u) / W(v)).  Counted apart from the uniform branch."""
    out = _index_walk(start, out_indptr, out_indices, alias_prob,
                      alias_other, seed, alpha, max_hops, "index_walk_alias")
    index_walk_alias.launches += 1
    return out


def index_walk_hub(start: torch.Tensor, out_indptr: torch.Tensor,
                   out_indices: torch.Tensor,
                   alias_prob: Optional[torch.Tensor],
                   alias_other: Optional[torch.Tensor], hub_id: torch.Tensor,
                   pool: torch.Tensor, seed: int, alpha: float,
                   max_hops: int) -> torch.Tensor:
    """K4-hub: as :func:`index_walk` (alias hops where the tables are
    given), but a walk whose hop lands on a hub (``hub_id[node] >= 0``)
    ends at a uniform entry of that hub's row of ``pool`` ([H, P] int32
    endpoints).  Counted apart from the other branches."""
    out = _index_walk(start, out_indptr, out_indices, alias_prob,
                      alias_other, seed, alpha, max_hops, "index_walk_hub",
                      hub_id=hub_id, pool=pool)
    index_walk_hub.launches += 1
    return out


def _index_walk_sharded(start, indptr, indices, alias_prob, alias_other,
                        n_loc, seed, alpha, max_hops, name) -> torch.Tensor:
    """Checks and launches K4's sharded form: ``indptr``/``indices`` (and
    both alias lists, or neither) hold one tensor per shard; a slice on
    another card than ``start`` is read through a peer pointer (untested:
    it needs a machine with several cards)."""
    (W,) = start.shape
    dev = start.device
    _check("start", start, torch.int32, (W,))
    G = len(indptr)
    if not 1 <= G <= 32 or len(indices) != G:
        raise ValueError(f"{name}: {G} row-pointer and {len(indices)} edge "
                         "slices; need 1-32 shards, one of each a shard")
    alias = alias_prob is not None
    if alias and not (len(alias_prob) == len(alias_other) == G):
        raise ValueError(f"{name}: alias tables for every shard or none")
    for s in range(G):
        sdev = indptr[s].device
        _check(f"indptr[{s}]", indptr[s], torch.int32, (n_loc + 1,))
        _check(f"indices[{s}]", indices[s], torch.int32, device=sdev)
        if alias:
            m = indices[s].shape
            _check(f"alias_prob[{s}]", alias_prob[s], torch.float32, m, sdev)
            _check(f"alias_other[{s}]", alias_other[s], torch.int32, m, sdev)
        if sdev != dev:
            enable_peer_access(dev, sdev)
    if W >= 2**32:
        raise ValueError(f"{name}: at most 2^32 - 1 walks per call")
    out = torch.empty(W, dtype=torch.int32, device=dev)
    if W == 0:
        return out
    plan = schedule.walk_plan(W, sm_count(dev))
    with torch.cuda.device(dev):
        err = build.library().fora_index_walk_sharded(
            _ptr(start), _ptr(out), W, _table(indptr), _table(indices),
            _table(alias_prob), _table(alias_other), G, n_loc, seed % 2**64,
            inv_log1m_alpha(alpha), max_hops, plan.walks_per_lane,
            plan.blocks, _stream(start))
    _raise_on(err, name)
    return out


def index_walk_sharded(start: torch.Tensor, indptr: list, indices: list,
                       n_loc: int, seed: int, alpha: float,
                       max_hops: int) -> torch.Tensor:
    """K4's sharded form: as :func:`index_walk` over an out-CSR split into
    row slices (shard s holds rows s * n_loc .. (s + 1) * n_loc - 1 as a
    localized ``indptr[s]`` [n_loc + 1] and its edges ``indices[s]``), each
    hop reading its row's owner slice; the endpoints are ``index_walk``'s
    on the unsharded graph bit for bit."""
    out = _index_walk_sharded(start, indptr, indices, None, None, n_loc,
                              seed, alpha, max_hops, "index_walk_sharded")
    index_walk_sharded.launches += 1
    return out


def index_walk_sharded_alias(start: torch.Tensor, indptr: list,
                             indices: list, alias_prob: list,
                             alias_other: list, n_loc: int, seed: int,
                             alpha: float, max_hops: int) -> torch.Tensor:
    """K4's sharded form with alias hops (each shard's slice of the alias
    tables beside its edges): :func:`index_walk_alias`'s endpoints on the
    unsharded graph bit for bit.  Counted apart from the uniform form."""
    out = _index_walk_sharded(start, indptr, indices, alias_prob,
                              alias_other, n_loc, seed, alpha, max_hops,
                              "index_walk_sharded_alias")
    index_walk_sharded_alias.launches += 1
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


def reduce_scatter_onepass(out: torch.Tensor, xs: list) -> None:
    """P2 with every shard on one card, in one launch: ``xs`` holds G
    (2 <= G <= 32) [G * n_loc, B] f32 partials on ``out``'s card and
    ``out`` ([G * n_loc, B] f32) gets, in row block h, the sum over shards
    of block h, added in the ring's order (shard h + 1's partial first,
    shard h's own last), so it equals the hop loop bit for bit."""
    G = len(xs)
    _check("out", out, torch.float32)
    if not 2 <= G <= 32 or out.dim() != 2 or out.shape[0] % G:
        raise ValueError(f"reduce_scatter_onepass: {G} partials into "
                         f"{tuple(out.shape)}; need 2-32 shards and rows "
                         "dividing by them")
    for i, x in enumerate(xs):
        _check(f"xs[{i}]", x, torch.float32, out.shape, out.device)
    ptrs = (ctypes.c_void_p * G)(*[x.data_ptr() for x in xs])
    with torch.cuda.device(out.device):
        err = build.library().fora_reduce_scatter_onepass(
            _ptr(out), ctypes.cast(ptrs, ctypes.c_void_p), G,
            out.numel() // G, _stream(out))
    reduce_scatter_onepass.launches += 1
    _raise_on(err, "reduce_scatter_onepass")


def row_scatter_add(acc: torch.Tensor, tile: torch.Tensor, src: torch.Tensor,
                    dst: torch.Tensor) -> torch.Tensor:
    """P3: for every edge e, ``acc[dst[e]] += tile[src[e]]`` (rows of
    width B, f32 atomics, so the order of the adds varies from run to
    run); an edge whose ``dst`` lies outside acc's rows is skipped (a pad
    slot of the compacted exchanges), and ``src`` must lie in range.
    Updates ``acc`` in place."""
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
            _ptr(acc), _ptr(tile), _ptr(src), _ptr(dst), E, acc.shape[0], B,
            _stream(acc))
    row_scatter_add.launches += 1
    _raise_on(err, "row_scatter_add")
    return acc


def exchange_clear(bufs: list, n_loc: int, ids: list,
                   own: Optional[list] = None) -> None:
    """The compacted exchange's clear, one launch for buffers on one card:
    for each buffer t of ``bufs`` (1-32 [rows, B] f32 buffers of one shape)
    its own block, rows ``own[t] * n_loc`` to ``(own[t] + 1) * n_loc - 1``
    (``own`` defaults to 0, 1, ...), and the rows named by ``ids[t]``
    (int32, one length for all; an id outside the rows, a pad slot, is
    skipped) are set to zero."""
    G = len(bufs)
    if not 1 <= G <= 32 or len(ids) != G:
        raise ValueError(f"exchange_clear: {G} buffers and {len(ids)} id "
                         "lists; need 1-32 of each, one a buffer")
    own = list(range(G)) if own is None else own
    b0 = bufs[0]
    _check("bufs[0]", b0, torch.float32)
    if b0.dim() != 2:
        raise ValueError(f"exchange_clear: buffers of shape "
                         f"{tuple(b0.shape)}, expected [rows, B]")
    dev, n_ids = b0.device, ids[0].numel()
    for t in range(G):
        _check(f"bufs[{t}]", bufs[t], torch.float32, b0.shape, dev)
        _check(f"ids[{t}]", ids[t], torch.int32, (n_ids,), dev)
        if not (0 <= own[t] and (own[t] + 1) * n_loc <= b0.shape[0]):
            raise ValueError(f"exchange_clear: own block {own[t]} of "
                             f"{n_loc} rows outside {b0.shape[0]} rows")
    bptr = (ctypes.c_void_p * G)(*[b.data_ptr() for b in bufs])
    iptr = (ctypes.c_void_p * G)(*[i.data_ptr() for i in ids])
    own0 = (ctypes.c_longlong * G)(*[o * n_loc for o in own])
    with torch.cuda.device(dev):
        err = build.library().fora_exchange_clear(
            ctypes.cast(bptr, ctypes.c_void_p),
            ctypes.cast(iptr, ctypes.c_void_p),
            ctypes.cast(own0, ctypes.c_void_p), G, b0.shape[0], b0.shape[1],
            n_loc, n_ids, _stream(b0))
    exchange_clear.launches += 1
    _raise_on(err, "exchange_clear")


def frontier_compact(contrib: torch.Tensor, needed: Optional[torch.Tensor],
                     cap: int, row0: int, pad_id: int, ids: torch.Tensor,
                     rows: torch.Tensor, counts: torch.Tensor) -> None:
    """The frontier compaction: for every row i of ``contrib`` [n_loc, B]
    with a non-zero entry and every destination d with ``needed[d, i]``
    (``needed`` [D, n_loc] uint8, or None for one destination that takes
    every such row), a slot of ``ids[d]`` ([cap] int32) gets ``row0 + i``
    and the same slot of ``rows[d]`` ([cap, B] f32) the row; ``counts[d]``
    (int32) ends as the rows due to d, past ``cap`` included, and unused
    slots of ``ids`` hold ``pad_id``.  Slots follow row order within each
    block of the kernel; across blocks their order varies from run to
    run.  ``ids`` [D, >= cap] and ``rows`` [D, >= cap, B] may be views
    whose destinations lie apart (their rows must be contiguous)."""
    n_loc, B = contrib.shape
    dev = contrib.device
    _check("contrib", contrib, torch.float32, (n_loc, B))
    D = 1 if needed is None else needed.shape[0]
    if needed is not None:
        _check("needed", needed, torch.uint8, (D, n_loc), dev)
    if not 1 <= D <= 32:
        raise ValueError(f"frontier_compact: {D} destinations, at most 32")
    for name, t, dtype, tail in (("ids", ids, torch.int32, ()),
                                 ("rows", rows, torch.float32, (B,))):
        if not isinstance(t, torch.Tensor) or t.device != dev \
                or t.dtype != dtype:
            raise ValueError(f"frontier_compact: {name} must be {dtype} on "
                             f"{dev}")
        if t.dim() != 2 + len(tail) or t.shape[0] != D \
                or t.shape[1] < cap or tuple(t.shape[2:]) != tail \
                or t[0].stride() != t[0].contiguous().stride() \
                or t.stride(0) < t[0].numel():
            raise ValueError(f"frontier_compact: {name} of shape "
                             f"{tuple(t.shape)} cannot hold [{D}, {cap}"
                             f"{', ' + str(B) if tail else ''}]")
    _check("counts", counts, torch.int32, (D,), dev)
    with torch.cuda.device(dev):
        err = build.library().fora_frontier_compact(
            _ptr(contrib), n_loc, B, _ptr(needed), D, cap, row0, pad_id,
            _ptr(ids), ids.stride(0), _ptr(rows), rows.stride(0),
            _ptr(counts), sm_count(dev), _stream(contrib))
    frontier_compact.launches += 1
    _raise_on(err, "frontier_compact")


def frontier_prepass(p: torch.Tensor, r: torch.Tensor, contrib: torch.Tensor,
                     thr: torch.Tensor, deg: torch.Tensor, indptr: torch.Tensor,
                     wsum: torch.Tensor, alpha: float, tasks: torch.Tensor,
                     status: torch.Tensor, task_edges: int, n_edges: int) -> None:
    """K5's pre-pass, in place: ``p`` and ``contrib`` as
    :func:`push_prepass` computes them (bit for bit), the active entries
    of ``r`` set to 0, and for every row with a non-zero ``contrib`` its
    tasks (row, first edge, mask, edges) for each ``task_edges`` of its
    out-edges (``deg`` of them from ``indptr[row]`` of the out-CSR;
    ``n_edges`` in all; ``edges`` in this range; ``mask`` the row's
    non-zero chunks, ``ops.push.chunk_masks``) appended to ``tasks`` ([>=
    n + n_edges // task_edges + 1, 4] int32, 16-byte aligned, in an order
    that varies from run to run); ``status`` (int32 [3]) ends as [1 if
    any entry was active, those rows' out-edges, tasks appended]."""
    n, B = r.shape
    dev = r.device
    _check("r", r, torch.float32, (n, B))
    _check("p", p, torch.float32, (n, B), dev)
    _check("contrib", contrib, torch.float32, (n, B), dev)
    _check("thr", thr, torch.float32, (n,), dev)
    _check("deg", deg, torch.int32, (n,), dev)
    _check("indptr", indptr, torch.int32, (n + 1,), dev)
    _check("wsum", wsum, torch.float32, (n,), dev)
    _check("status", status, torch.int32, (3,), dev)
    _check("tasks", tasks, torch.int32, device=dev)
    if task_edges < 1:
        raise ValueError(f"frontier_prepass: task_edges {task_edges} < 1")
    need = n + n_edges // task_edges + 1
    if tasks.dim() != 2 or tasks.shape[1] != 4 or tasks.shape[0] < need \
            or tasks.data_ptr() % 16:
        raise ValueError(f"frontier_prepass: tasks of shape "
                         f"{tuple(tasks.shape)}, need [>= {need}, 4] on a "
                         "16-byte boundary")
    with torch.cuda.device(dev):
        err = build.library().fora_frontier_prepass(
            _ptr(p), _ptr(r), _ptr(contrib), _ptr(thr), _ptr(deg),
            _ptr(indptr), _ptr(wsum), alpha, 1.0 - alpha, n, B, task_edges,
            _ptr(tasks), _ptr(status), _stream(r))
    frontier_prepass.launches += 1
    _raise_on(err, "frontier_prepass")


def frontier_push(r: torch.Tensor, contrib: torch.Tensor, tasks: torch.Tensor,
                  n_tasks: int, out_indices: torch.Tensor) -> None:
    """K5: for each of the first ``n_tasks`` tasks (v, first, mask, edges)
    of ``tasks`` (from :func:`frontier_prepass`) and each out-edge v -> u
    at ``out_indices[first:first + edges]`` (the out-CSR's column ids),
    ``r[u] += contrib[v]`` over the chunks ``mask`` names, the rest of the
    row being zero (rows of width B, f32 atomics, so the order of the adds
    varies from run to run).  Updates ``r`` in place."""
    n, B = r.shape
    dev = r.device
    _check("r", r, torch.float32, (n, B))
    _check("contrib", contrib, torch.float32, (n, B), dev)
    _check("out_indices", out_indices, torch.int32, device=dev)
    _check("tasks", tasks, torch.int32, device=dev)
    if tasks.dim() != 2 or tasks.shape[1] != 4 or tasks.data_ptr() % 16 \
            or not 0 <= n_tasks <= tasks.shape[0]:
        raise ValueError(f"frontier_push: {n_tasks} tasks of "
                         f"{tuple(tasks.shape)}")
    with torch.cuda.device(dev):
        err = build.library().fora_frontier_push(
            _ptr(r), _ptr(contrib), _ptr(tasks), n_tasks, _ptr(out_indices),
            B, _stream(r))
    frontier_push.launches += 1
    _raise_on(err, "frontier_push")


def _check_cols(name: str, t: torch.Tensor, dtype, shape):
    """A CUDA tensor of ``shape`` [rows, cols] whose columns are adjacent
    (stride 1; the rows' stride is free): a column slice of a wider
    array.  Returns its row stride."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got "
                         f"{getattr(t, 'device', type(t))}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.shape[1] > 1 and t.stride(1) != 1:
        raise ValueError(f"{name}: its columns must be adjacent (stride "
                         f"{t.stride(1)})")
    return t.stride(0)


def _peer(out_dev: torch.device, *ts) -> None:
    """Inputs on another card than the launch's are read through a peer
    pointer (untested: it needs a machine with several cards)."""
    for t in ts:
        if t is not None and t.device != out_dev:
            enable_peer_access(out_dev, t.device)


def walk_demand(r: torch.Tensor, omega_unit: float):
    """K6-demand: ``(cum, total)`` of the residue ``r`` [n, Bc] f32 (its
    columns adjacent, its rows of any stride): omega_v = ceil(r_v *
    omega_unit) in f32 where r_v > 0 (else 0), ``cum`` [n, Bc] int32 its
    inclusive sum over nodes (a transposed view of a contiguous [Bc, n]
    array, as ``ops.walk.walk_demand_plain`` lays it out) and ``total``
    [Bc] int32, bit for bit the plain version's.  omega_v itself is not
    written (cum[v] - cum[v - 1])."""
    n, Bc = r.shape
    dev = r.device
    ld = _check_cols("r", r, torch.float32, (n, Bc))
    n_tiles = -(-n // 256)
    cum = torch.empty((Bc, n), dtype=torch.int32, device=dev)
    total = torch.zeros(Bc, dtype=torch.int32, device=dev)
    tile = torch.empty((Bc, n_tiles), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = build.library().fora_walk_demand(
            _ptr(r), ld, n, Bc, float(omega_unit), _ptr(tile), n_tiles,
            _ptr(cum), _ptr(total), _stream(r))
    walk_demand.launches += 1
    _raise_on(err, "walk_demand")
    return cum.T, total


def expand_lanes(r, cum, total: Optional[torch.Tensor], start: torch.Tensor,
                 weight: torch.Tensor, lane_lo: int = 0,
                 bounds: Optional[torch.Tensor] = None,
                 n_loc: int = 0) -> None:
    """K6-expand, in place: row t of ``start`` [rows, Bc] int32 and
    ``weight`` [rows, Bc] f32 (contiguous) gets lane l = lane_lo + t of each
    column b: the first node v with cum[v, b] > min(l, total[b] - 1) and
    r[v, b] / omega_v where l < total[b], else 0 (an empty column: node 0),
    equal to ``ops.walk.expand_lanes_plain``'s.  ``r`` [n, Bc] f32 as
    :func:`walk_demand` takes it, ``cum`` [n, Bc] int32 with its nodes
    adjacent (``walk_demand``'s or a column slice of it), ``total`` [Bc]
    int32.  The sharded form: ``r`` and ``cum`` lists of G shards' (1-32,
    one shape and strides), ``total`` None and ``bounds`` [G + 1, Bc]
    int64 on ``start``'s card, the running sums of the shards' totals:
    lane l of column b is shard h's lane l - bounds[h, b] where bounds[h,
    b] <= l < bounds[h + 1, b], written as its node + h * ``n_loc``; a
    lane past bounds[G, b] gets node 0, weight 0 (``ops.walk.
    expand_chunk_lanes_plain``).  Shards may lie on other cards than
    ``start``."""
    sharded = bounds is not None
    rs, cums = (list(r), list(cum)) if sharded else ([r], [cum])
    G = len(rs)
    n, Bc = rs[0].shape
    rows = start.shape[0]
    dev = start.device
    _check("start", start, torch.int32, (rows, Bc))
    _check("weight", weight, torch.float32, (rows, Bc), dev)
    if not 1 <= G <= 32 or len(cums) != G:
        raise ValueError(f"expand_lanes: {G} residues and {len(cums)} "
                         "demands; need 1-32 of each")
    for h in range(G):
        r_ld = _check_cols(f"r[{h}]", rs[h], torch.float32, (n, Bc))
        _check_cols(f"cum[{h}].T", cums[h].T, torch.int32, (Bc, n))
        if rs[h].stride() != rs[0].stride() or \
                cums[h].stride() != cums[0].stride() or \
                cums[h].device != rs[h].device:
            raise ValueError("expand_lanes: the shards' residues and "
                             "demands must share their strides and cards")
        _peer(dev, rs[h])
    if sharded:
        if total is not None:
            raise ValueError("expand_lanes: bounds take the place of total")
        _check("bounds", bounds, torch.int64, (G + 1, Bc), dev)
    else:
        _check("total", total, torch.int32, (Bc,), rs[0].device)
        if lane_lo < 0 or n_loc:
            raise ValueError("expand_lanes: lane_lo >= 0; n_loc only with "
                             "bounds")
    if n == 0 or n >= 2**31 or not 0 <= n_loc * (G - 1) < 2**31 - n:
        raise ValueError(f"expand_lanes: {n} nodes, n_loc {n_loc}")
    with torch.cuda.device(dev):
        err = build.library().fora_expand_lanes(
            _table(rs), r_ld, _table(cums),
            cums[0].stride(1) if Bc > 1 else n, _ptr(total), _ptr(bounds),
            G, n, Bc, rows, int(lane_lo), int(n_loc), _ptr(start),
            _ptr(weight), _stream(start))
    expand_lanes.launches += 1
    _raise_on(err, "expand_lanes")


def accumulate_endpoints(ends: torch.Tensor, weight, out,
                         lane_lo: int = 0,
                         bounds: Optional[torch.Tensor] = None) -> None:
    """K6-accum, in place: ``out[ends[t, b], b] += weight[t, b]`` for every
    lane with a non-zero weight (f32 atomics, in no fixed order).
    ``ends`` [W, Bc] int32 contiguous; ``weight`` [W, Bc] f32 contiguous or
    one number (every lane's weight); ``out`` [n, Bc] f32 with adjacent
    columns (a column slice of a wider array).  The sharded form: ``out``
    a list of G shards' partials (1-32, one shape and strides) and
    ``bounds`` [G + 1, Bc] int64 as :func:`expand_lanes` takes it; row t
    is lane lane_lo + t and adds into the partial of the shard that holds
    it, nowhere past bounds[G, b].  Launches on ``ends``' card; partials
    on other cards are written through peer pointers."""
    sharded = bounds is not None
    outs = list(out) if sharded else [out]
    G = len(outs)
    W, Bc = ends.shape
    n = outs[0].shape[0]
    dev = ends.device
    _check("ends", ends, torch.int32, (W, Bc))
    scalar = not isinstance(weight, torch.Tensor)
    if not scalar:
        _check("weight", weight, torch.float32, (W, Bc), dev)
    if not 1 <= G <= 32:
        raise ValueError(f"accumulate_endpoints: {G} outputs, 1-32")
    for h in range(G):
        ld = _check_cols(f"out[{h}]", outs[h], torch.float32, (n, Bc))
        if outs[h].stride() != outs[0].stride():
            raise ValueError("accumulate_endpoints: the partials must share "
                             "their strides")
        _peer(dev, outs[h])
    if sharded:
        _check("bounds", bounds, torch.int64, (G + 1, Bc), dev)
    elif lane_lo:
        raise ValueError("accumulate_endpoints: lane_lo only with bounds")
    with torch.cuda.device(dev):
        err = build.library().fora_accumulate_endpoints(
            _ptr(ends), None if scalar else _ptr(weight),
            float(weight) if scalar else 0.0, W, Bc, _ptr(bounds), G,
            int(lane_lo), _table(outs), ld, n, sm_count(dev), _stream(ends))
    accumulate_endpoints.launches += 1
    _raise_on(err, "accumulate_endpoints")


def sector_reads(buf: torch.Tensor, reads: int = 64,
                 threads: int = 1 << 20, seed: int = 0) -> int:
    """The measuring kernel of csrc/sector_probe.cu: ``threads`` threads
    (rounded up to blocks of 256) each read ``reads`` (a multiple of 8)
    scattered 32-byte sectors of the int32 buffer ``buf`` past the L1.
    Returns the number of sectors read; time the call to get the card's
    rate for such reads over a buffer of this size.  It is no kernel of
    the port's paths and has no launch count."""
    _check("buf", buf, torch.int32)
    n_sectors = buf.numel() // 8
    blocks = -(-threads // 256)
    out = torch.empty(blocks * 256, dtype=torch.int32, device=buf.device)
    with torch.cuda.device(buf.device):
        err = build.library().fora_sector_reads(
            _ptr(buf), n_sectors, reads, blocks, _ptr(out), seed % 2**32,
            _stream(buf))
    _raise_on(err, "sector_reads")
    return blocks * 256 * reads


def row_reads(buf: torch.Tensor, reads: int = 64, threads: int = 1 << 20,
              seed: int = 0) -> int:
    """The row kernel of csrc/sector_probe.cu: ``threads`` threads (whole
    blocks of 256, 8 warps) whose warps each read ``reads`` (a multiple of
    8) scattered 512-byte rows of the f32 buffer ``buf`` (a multiple of 128
    floats) past the L1, one float4 a lane.  Returns the rows read; time
    the call to get the card's rate for such reads over a buffer of this
    size.  No kernel of the port's paths; no launch count."""
    _check("buf", buf, torch.float32)
    if buf.numel() % 128:
        raise ValueError("row_reads: the buffer must hold whole 128-float "
                         "rows")
    blocks = -(-threads // 256)
    out = torch.empty(blocks * 256, dtype=torch.float32, device=buf.device)
    with torch.cuda.device(buf.device):
        err = build.library().fora_row_reads(
            _ptr(buf), buf.numel() // 128, reads, blocks, _ptr(out),
            seed % 2**32, _stream(buf))
    _raise_on(err, "row_reads")
    return blocks * 8 * reads


def philox_blocks(out: torch.Tensor, per_thread: int = 256) -> int:
    """The measuring kernel of csrc/philox_probe.cu: ``out.numel()``
    threads (a multiple of 256, int32 on the card, one word each) each
    compute ``per_thread`` (a multiple of 4) Philox-4x32-10 blocks of the
    walk kernel's function, every lane busy and no loads.  Returns the
    blocks computed; time the call to get the card's rate, the operations
    term of K4's bound.  On no query path; its launches count apart."""
    _check("out", out, torch.int32)
    if out.numel() % 256:
        raise ValueError(f"philox_blocks: {out.numel()} threads, not a "
                         "multiple of 256")
    with torch.cuda.device(out.device):
        err = build.library().fora_philox_blocks(
            _ptr(out), per_thread, out.numel() // 256, 0x5eed, _stream(out))
    philox_blocks.launches += 1
    _raise_on(err, "philox_blocks")
    return out.numel() * per_thread


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


WRAPPERS = (push_prepass, backward_prepass, gather_scatter_add, index_spmv,
            topk_bounds, index_walk, index_walk_alias, index_walk_hub,
            index_walk_sharded, index_walk_sharded_alias,
            ring_all_gather_hop, ring_reduce_scatter_hop,
            reduce_scatter_onepass, row_scatter_add, exchange_clear,
            frontier_compact, frontier_prepass, frontier_push, walk_demand,
            expand_lanes, accumulate_endpoints, philox_blocks)
for _w in WRAPPERS:
    _w.launches = 0
topk_bounds.last_state = None


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0


def launch_counts() -> dict:
    return {w.__name__: w.launches for w in WRAPPERS}
