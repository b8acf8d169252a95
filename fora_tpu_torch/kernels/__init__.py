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
| index_walk              | csrc/walk.cu           | K4 (index build, BiPPR, HubPPR's pool; plan in schedule.py) |
| index_walk_alias        | csrc/walk.cu           | K4's alias branch (the same, on weighted graphs) |
| index_walk_hub          | csrc/walk.cu           | K4-hub (HubPPR's pair walks, uniform or alias hops; its query walks run K6+K4-src's hub branch) |
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
| walk_demand             | csrc/walk_alloc.cu     | K6-demand (the raw walk's omega_v, its int32 scan over nodes and the column totals, one single-pass launch: raw pool; the sharded raw one-shot's shards in one launch) |
| expand_lanes            | csrc/walk_alloc.cu     | K6-expand (a range of lanes onto their start nodes and weights; the sharded form expands a chunk over every shard's demand in one launch; on no path since K6+K4, kept as its earlier form) |
| accumulate_endpoints    | csrc/walk_alloc.cu     | K6-accum (the endpoints' scatter-add, f32 atomics; on no path since K6+K4-src, kept as the chain both fused forms are held to) |
| raw_walk                | csrc/walk.cu           | K6+K4 (a raw walk phase's chunk in one launch: each lane's start node and weight, its walk, the weight added at the endpoint; raw pool, sharded raw one-shot; its sharded form over every shard's demand and the out-CSR's slices) |
| raw_walk_xp             | csrc/walk.cu           | K6+K4-xp's own-lane form (round 0 of a process's share of a raw walk chunk with the shards spread over processes: its own lanes to endpoint mass and walks that leave, through a staged outbox; the sharded raw one-shot across processes) |
| raw_walk_xp_inbox       | csrc/walk.cu           | K6+K4-xp's inbox form (the later rounds: the walks handed to the process, each record carrying its length, to endpoint mass and walks that leave) |
| index_walk_xp           | csrc/walk.cu           | K4-xp's own-start form (round 0 of a process's share of an index build window of whole chunks with the shards spread over processes: K4's walks over its own starts, each drawing as its chunk's, walks that leave through warp-owned bins; the sharded index build across processes) |
| index_walk_xp_inbox     | csrc/walk.cu           | K4-xp's inbox form (the later rounds: resident blocks whose warps claim the records handed to the process from a cursor, to endpoints and walks that leave) |
| source_walk             | csrc/walk.cu           | K6+K4-src (a chunk of source-rooted walks in one launch: each walk from its column's source, its weight added at its endpoint, the source's own count in a register; Monte Carlo, HubPPR's queries with its hub branch) |
| pack_keys               | csrc/pack.cu           | K7-keys (the index pack's packed (bucket, endpoint, source) key of every pool entry and dangling self-edge, tiles of pool entries; optionally K7-sort's digit counts in the same pass) |
| sort_keys               | csrc/pack.cu           | K7-sort (a stable onesweep LSD radix sort of the keys, 8-, 9- or 11-bit digits, constant-digit passes skipped; a call is 1 + 1 a pass launches, or 1 a pass with K7-keys' counts handed in) |
| digit_counts            | csrc/pack.cu           | K7-sort's count launch alone (checks only: no path calls it; no launch count) |
| merge_keys              | csrc/pack.cu           | K7-merge (the sorted keys' run-length merge in one pass: unique edges unpacked, their multiplicities, the bucket sizes and every bucket's row pointers by endpoint; a call is 2 launches) |
| sector_reads            | csrc/sector_probe.cu   | none: measures the card's rate of scattered 32-byte reads |
| row_reads               | csrc/sector_probe.cu   | none: measures the card's rate of scattered 512-byte row reads |
| philox_blocks           | csrc/philox_probe.cu   | none: measures the card's rate of Philox-4x32-10 blocks (K4's operations) |

K6's plain versions are ``ops/walk.py``'s ``*_plain`` functions, held to
JAX's ``allocate_walks`` / ``accumulate_endpoints`` on the CPU by
``tests/test_torch_walk_alloc.py``; on a card ``-k "walk_demand or expand
or accumulate or k6"`` of ``tests/test_torch_kernels_cuda.py`` holds the
kernels to them.  K6+K4's plain version is ``ops.walk.
raw_walk_chunk_plain`` (``tests/test_torch_raw_walk_fused.py``); on a card
``-k raw_walk`` holds the kernel to the chain K6-expand -> K4 -> K6-accum
(endpoints bit-equal, the contribution by a float64 sum).  K6+K4-xp's
plain version (both forms) is ``ops.walk.raw_walk_xp_plain``
(``tests/test_torch_multihost.py`` holds it, with the processes simulated
by a loop, to ``raw_walk_chunk_plain``); on a card ``-k raw_walk_xp``
holds both kernels to it.  K4-xp's plain version (both forms) is
``ops.walk.index_walk_xp_plain`` (``tests/test_torch_build_sharded.py``
holds it, with the processes simulated, to ``run_walks_philox``); on a card
``-k index_walk_xp`` holds both kernels to it.  K6+K4-src's
plain version is ``ops.walk.source_walk_chunk_plain``
(``tests/test_torch_source_walk.py``); on a card ``-k source_walk`` holds
the kernel to the chain K4 (K4-alias, K4-hub) -> K6-accum alike.

K7's plain versions are ``index/build.py``'s ``pack_keys_plain``,
``sort_keys_plain`` and ``merge_keys_plain`` (together
``pack_index_plain``), held to JAX's ``pack_index`` on the CPU by
``tests/test_torch_pack.py``; on a card ``-k pack`` holds the kernels to
them bit for bit.

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
           "expand_lanes", "accumulate_endpoints", "raw_walk",
           "raw_walk_xp", "raw_walk_xp_inbox", "index_walk_xp",
           "index_walk_xp_inbox", "source_walk",
           "sector_reads",
           "row_reads",
           "philox_blocks", "pack_keys", "sort_keys", "merge_keys",
           "digit_counts", "digit_totals",
           "PACK_TILE", "SORT_DIGIT_WIDTHS", "SORT_MAX_KEYS",
           "sort_digit_bits",
           "sort_scratch_words", "merge_scratch_words",
           "inv_log1m_alpha", "sm_count",
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


def _walk_out(out, W: int, dev) -> torch.Tensor:
    """The endpoints' [W] int32 output: ``out`` where given (a caller's
    slice of a larger buffer), else a new tensor."""
    if out is None:
        return torch.empty(W, dtype=torch.int32, device=dev)
    _check("out", out, torch.int32, (W,), dev)
    return out


def _index_walk(start, out_indptr, out_indices, alias_prob, alias_other,
                seed, alpha, max_hops, name, hub_id=None, pool=None,
                plan=None, out=None) -> torch.Tensor:
    """Checks and launches csrc/walk.cu; uniform hops where ``alias_prob``
    and ``alias_other`` are None, no hub lookup where ``hub_id`` and
    ``pool`` are None; the endpoints into ``out`` where given.  ``plan`` defaults to ``schedule.walk_plan``'s; only
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
    out = _walk_out(out, W, dev)
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
               max_hops: int, out: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """K4: endpoints [W] int32 of one alpha-terminating walk per start,
    each hop to a uniform out-neighbour; walk w's endpoint depends on
    (seed, w, start[w]) alone, bit-equal to ``ops.walk.run_walks_philox``.
    Written into ``out`` ([W] int32) where given."""
    out = _index_walk(start, out_indptr, out_indices, None, None, seed,
                      alpha, max_hops, "index_walk", out=out)
    index_walk.launches += 1
    return out


def index_walk_alias(start: torch.Tensor, out_indptr: torch.Tensor,
                     out_indices: torch.Tensor, alias_prob: torch.Tensor,
                     alias_other: torch.Tensor, seed: int, alpha: float,
                     max_hops: int, out: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """K4's alias branch: as :func:`index_walk`, each hop through the
    Walker alias tables over the out-CSR slots (a weighted graph's
    w(v, u) / W(v)).  Counted apart from the uniform branch."""
    out = _index_walk(start, out_indptr, out_indices, alias_prob,
                      alias_other, seed, alpha, max_hops, "index_walk_alias",
                      out=out)
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
                        n_loc, seed, alpha, max_hops, name,
                        out=None) -> torch.Tensor:
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
    out = _walk_out(out, W, dev)
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
                       max_hops: int, out: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """K4's sharded form: as :func:`index_walk` over an out-CSR split into
    row slices (shard s holds rows s * n_loc .. (s + 1) * n_loc - 1 as a
    localized ``indptr[s]`` [n_loc + 1] and its edges ``indices[s]``), each
    hop reading its row's owner slice; the endpoints are ``index_walk``'s
    on the unsharded graph bit for bit."""
    out = _index_walk_sharded(start, indptr, indices, None, None, n_loc,
                              seed, alpha, max_hops, "index_walk_sharded",
                              out=out)
    index_walk_sharded.launches += 1
    return out


def index_walk_sharded_alias(start: torch.Tensor, indptr: list,
                             indices: list, alias_prob: list,
                             alias_other: list, n_loc: int, seed: int,
                             alpha: float, max_hops: int,
                             out: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """K4's sharded form with alias hops (each shard's slice of the alias
    tables beside its edges): :func:`index_walk_alias`'s endpoints on the
    unsharded graph bit for bit.  Counted apart from the uniform form."""
    out = _index_walk_sharded(start, indptr, indices, alias_prob,
                              alias_other, n_loc, seed, alpha, max_hops,
                              "index_walk_sharded_alias", out=out)
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


DEMAND_TILE_LOG2 = 13      # entries of K6-demand's tile (walk_alloc.cu)
DEMAND_COLUMNS_LOG2 = 3    # its widest column group: 8 columns


def demand_scratch_words(G: int, n: int, Bc: int) -> int:
    """The int64 words of K6-demand's scratch (its ticket counter and
    status words) for G shards' [n, Bc] residues: 1 + G * ceil(Bc / cw) *
    cw * ceil(n / TN), cw = min(8, 2^ceil(log2 Bc)), TN = 8192 / cw."""
    cw_log2 = min(DEMAND_COLUMNS_LOG2, max(0, (Bc - 1).bit_length()))
    cw, tile = 1 << cw_log2, 1 << (DEMAND_TILE_LOG2 - cw_log2)
    return 1 + G * -(-Bc // cw) * cw * -(-n // tile)


def walk_demand(r, omega_unit: float):
    """K6-demand: ``(cum, total)`` of the residue ``r`` [n, Bc] f32 (its
    columns adjacent, its rows of any stride): omega_v = ceil(r_v *
    omega_unit) in f32 where r_v > 0 (else 0), ``cum`` [n, Bc] int32 its
    inclusive sum over nodes (a transposed view of a contiguous [Bc, n]
    array, as ``ops.walk.walk_demand_plain`` lays it out) and ``total``
    [Bc] int32, bit for bit the plain version's.  omega_v itself is not
    written (cum[v] - cum[v - 1]).  The list form: ``r`` a list of G
    shards' residues (1-32, one shape and strides, one card), ``cum`` [G,
    n, Bc] (shard h's ``cum[h]`` laid out as the single form's, all in one
    [G, Bc, n] buffer) and ``total`` [G, Bc].  Either form is one kernel
    launch (none where r has no node or no column) after a
    cudaMemsetAsync of its scratch, the ticket counter and status words
    (:func:`demand_scratch_words`), allocated for the call on the current
    stream: nothing is kept between calls, so no two calls share a word,
    from two streams or two host threads."""
    listed = isinstance(r, (list, tuple))
    rs = list(r) if listed else [r]
    G = len(rs)
    if not 1 <= G <= 32:
        raise ValueError(f"walk_demand: {G} residues, 1-32")
    n, Bc = rs[0].shape
    dev = rs[0].device
    for h in range(G):
        _check_cols(f"r[{h}]", rs[h], torch.float32, (n, Bc))
        if rs[h].stride() != rs[0].stride() or rs[h].device != dev:
            raise ValueError("walk_demand: the shards' residues must share "
                             "their strides and card")
    cum = torch.empty((G, Bc, n), dtype=torch.int32, device=dev)
    total = torch.empty((G, Bc), dtype=torch.int32, device=dev)
    if n * Bc == 0:
        total.zero_()
    else:
        scratch = torch.empty(demand_scratch_words(G, n, Bc),
                              dtype=torch.int64, device=dev)
        with torch.cuda.device(dev):
            err = build.library().fora_walk_demand(
                _table(rs), G, rs[0].stride(0), n, Bc, float(omega_unit),
                _ptr(scratch), scratch.numel(), _ptr(cum), _ptr(total),
                sm_count(dev), _stream(rs[0]))
        walk_demand.launches += 1
        _raise_on(err, "walk_demand")
    cum = cum.transpose(1, 2)
    return (cum, total) if listed else (cum[0], total[0])


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


def _raw_walk_args(r, cum, total, out, rows, indptr, indices, alias_prob,
                   alias_other, seed, alpha, max_hops, lane_lo=0, bounds=None,
                   n_loc=0, ends=None):
    """:func:`raw_walk`'s checks: None where the chunk has no lane slot,
    else (its card, Bc, fora_raw_walk's arguments before the plan's, its
    stream)."""
    sharded = bounds is not None
    rs, cums, outs = ((list(r), list(cum), list(out)) if sharded
                      else ([r], [cum], [out]))
    ips, ixs = (list(indptr), list(indices)) if sharded else \
        ([indptr], [indices])
    alias = alias_prob is not None
    aps, aos = ((list(alias_prob), list(alias_other)) if sharded
                else ([alias_prob], [alias_other])) if alias else (None, None)
    G = len(rs)
    n, Bc = rs[0].shape
    dev = bounds.device if sharded else rs[0].device
    if not (1 <= G <= 32 and len(cums) == len(outs) == len(ips)
            == len(ixs) == G):
        raise ValueError(f"raw_walk: {G} residues, {len(cums)} demands, "
                         f"{len(outs)} outputs, {len(ips)} slices; need 1-32 "
                         "shards, one of each a shard")
    if (alias_other is None) == alias:
        raise ValueError("raw_walk: both alias tables or neither")
    rows, lane_lo = int(rows), int(lane_lo)
    if rows < 0 or lane_lo < 0 or rows * Bc >= 2**32:
        raise ValueError(f"raw_walk: {rows} rows of {Bc} columns from lane "
                         f"{lane_lo}; at most 2^32 - 1 lane slots")
    n_out = G * n_loc if sharded else ips[0].shape[0] - 1
    for h in range(G):
        r_ld = _check_cols(f"r[{h}]", rs[h], torch.float32, (n, Bc))
        _check_cols(f"cum[{h}].T", cums[h].T, torch.int32, (Bc, n))
        out_ld = _check_cols(f"out[{h}]", outs[h], torch.float32,
                             (n_out, Bc))
        if rs[h].stride() != rs[0].stride() or \
                cums[h].stride() != cums[0].stride() or \
                outs[h].stride() != outs[0].stride() or \
                cums[h].device != rs[h].device:
            raise ValueError("raw_walk: the shards' residues, demands and "
                             "outputs must share their strides, and each "
                             "demand its residue's card")
        sdev = ips[h].device
        _check(f"indptr[{h}]", ips[h], torch.int32,
               (n_loc + 1,) if sharded else None)
        if ips[h].dim() != 1 or ips[h].shape[0] < 2:
            raise ValueError("raw_walk: indptr must be [rows + 1]")
        _check(f"indices[{h}]", ixs[h], torch.int32, device=sdev)
        if alias:
            m = ixs[h].shape
            _check(f"alias_prob[{h}]", aps[h], torch.float32, m, sdev)
            _check(f"alias_other[{h}]", aos[h], torch.int32, m, sdev)
        _peer(dev, rs[h], outs[h], ips[h])
    if sharded:
        if total is not None:
            raise ValueError("raw_walk: bounds take the place of total")
        _check("bounds", bounds, torch.int64, (G + 1, Bc), dev)
    else:
        _check("total", total, torch.int32, (Bc,), dev)
        if n_loc:
            raise ValueError("raw_walk: n_loc only with bounds")
    if not 0 < n < 2**31 or not 0 <= n_loc * (G - 1) < 2**31 - n:
        raise ValueError(f"raw_walk: {n} nodes, n_loc {n_loc}")
    if ends is not None:
        _check("ends", ends, torch.int32, (rows, Bc), dev)
    if rows * Bc == 0:
        return None
    return dev, Bc, (
        _table(rs), r_ld, _table(cums), cums[0].stride(1) if Bc > 1 else n,
        _ptr(total), _ptr(bounds), G, n, Bc, rows, lane_lo, int(n_loc),
        _table(outs), out_ld, _ptr(ends), _table(ips), _table(ixs),
        _table(aps), _table(aos), seed % 2**64, inv_log1m_alpha(alpha),
        max_hops), _stream(rs[0])


def raw_walk(r, cum, total: Optional[torch.Tensor], out, rows: int,
             indptr, indices, alias_prob, alias_other, seed: int,
             alpha: float, max_hops: int, lane_lo: int = 0,
             bounds: Optional[torch.Tensor] = None, n_loc: int = 0,
             ends: Optional[torch.Tensor] = None) -> None:
    """K6+K4, in place: one chunk of the raw walk phase in one launch.  Row
    t (0 .. ``rows`` - 1) is lane lane_lo + t of each column b of ``r``
    [n, Bc] f32 (adjacent columns, as :func:`walk_demand` takes it); lane
    l < total[b] walks from the first node v with cum[v, b] > l as walk t
    * Bc + b of K4 (:func:`index_walk`, its alias branch where the tables
    are given) over ``indptr`` / ``indices``, and adds r[v, b] / omega_v
    into ``out`` [n, Bc] f32 (adjacent columns) at its endpoint (f32
    atomics, in no fixed order); lanes at or past total[b] are not
    walked.  ``cum`` [n, Bc] int32 with its nodes adjacent and ``total``
    [Bc] int32 are :func:`walk_demand`'s (or column slices of them).  So
    each endpoint is the one that :func:`expand_lanes`, K4 and
    :func:`accumulate_endpoints` give on the chunk, bit for bit.  The
    sharded form: ``r``, ``cum`` and ``out`` lists of G shards' (1-32,
    ``out`` [G * n_loc, Bc] each), the out-CSR as G slices (``indptr``,
    ``indices`` and the alias tables lists, as :func:`index_walk_sharded`
    takes them), ``total`` None and ``bounds`` [G + 1, Bc] int64 as
    :func:`expand_lanes` takes it: lane l of column b is shard h's, starts
    at its node + h * ``n_loc`` and adds into ``out[h]``.  ``ends`` (tests
    and checks only) [rows, Bc] int32 gets every walked lane's endpoint
    and keeps its other entries.  Launches on ``r``'s card (sharded:
    ``bounds``'); shards on other cards are reached through peer
    pointers."""
    got = _raw_walk_args(r, cum, total, out, rows, indptr, indices,
                         alias_prob, alias_other, seed, alpha, max_hops,
                         lane_lo, bounds, n_loc, ends)
    if got is None:
        return
    dev, Bc, args, stream = got
    plan = schedule.raw_walk_plan(int(rows), Bc, sm_count(dev),
                                  alias_prob is not None)
    with torch.cuda.device(dev):
        err = build.library().fora_raw_walk(
            *args, plan.walks_per_lane, plan.tiles, plan.blocks, stream)
    _raise_on(err, "raw_walk")
    raw_walk.launches += 1


def _xp_slices(name, dev, indptr, indices, alias_prob, alias_other,
               shard0: int, G: int, outbox, counts, words: int = 0) -> tuple:
    """The checks of every K6+K4-xp and K4-xp form on a process's L out-CSR
    slices (shards shard0 .. shard0 + L - 1 of G, on ``dev``) and its
    outbox [P, cap, 4] and counts [P + words]: (L, P, n_loc)."""
    L = len(indptr)
    alias = alias_prob is not None
    if not (1 <= L <= 32 and len(indices) == L and G % L == 0
            and 1 <= G <= 32 and 0 <= shard0 <= G - L and shard0 % L == 0):
        raise ValueError(f"{name}: {L} local shards from {shard0} of {G}; "
                         f"need G = P L <= 32")
    if (alias_other is None) == alias:
        raise ValueError(f"{name}: both alias tables or neither")
    n_loc = indptr[0].shape[0] - 1
    for h in range(L):
        _check(f"indptr[{h}]", indptr[h], torch.int32, (n_loc + 1,), dev)
        _check(f"indices[{h}]", indices[h], torch.int32, device=dev)
        if alias:
            m = indices[h].shape
            _check(f"alias_prob[{h}]", alias_prob[h], torch.float32, m, dev)
            _check(f"alias_other[{h}]", alias_other[h], torch.int32, m, dev)
    P = G // L
    _check("outbox", outbox, torch.int32, device=dev)
    if outbox.dim() != 3 or outbox.shape[0] != P or outbox.shape[2] != 4:
        raise ValueError(f"{name}: outbox must be [{P}, cap, 4]")
    _check("counts", counts, torch.int32, (P + words,), dev)
    return L, P, n_loc


def _xp_common(name, out, indptr, indices, alias_prob, alias_other,
               shard0: int, G: int, outbox, counts, ends, rows: int):
    """Both K6+K4-xp forms' checks: (L, P, n_loc, Bc, out's row stride,
    the card)."""
    dev = out.device
    L, P, n_loc = _xp_slices(name, dev, indptr, indices, alias_prob,
                             alias_other, shard0, G, outbox, counts)
    Bc = out.shape[1]
    out_ld = _check_cols("out", out, torch.float32, (G * n_loc, Bc))
    if ends is not None:
        _check("ends", ends, torch.int32, (rows, Bc), dev)
    return L, P, n_loc, Bc, out_ld, dev


def _xp_graph(indptr, indices, alias_prob, alias_other) -> tuple:
    alias = alias_prob is not None
    return (_table(indptr), _table(indices),
            _table(alias_prob) if alias else None,
            _table(alias_other) if alias else None)


def raw_walk_xp(r: list, cum: list, bounds: torch.Tensor,
                out: torch.Tensor, rows: int, lane_lo: int, extent: int,
                indptr: list, indices: list, alias_prob, alias_other,
                seed: int, alpha: float, max_hops: int, shard0: int, G: int,
                outbox: torch.Tensor, counts: torch.Tensor,
                ends: Optional[torch.Tensor] = None) -> None:
    """K6+K4-xp's own-lane form, in place: round 0 of a process's share of
    a chunk of the raw walk phase, the G graph shards spread over P = G /
    L processes, in one launch.  This process holds shards ``shard0`` ..
    ``shard0`` + L - 1: ``r`` and ``cum`` (L of each, as :func:`raw_walk`'s
    sharded form takes them, column slices [n_loc, Bc]), the out-CSR's L
    slices ``indptr`` / ``indices`` (and the alias tables, or None), and
    ``bounds`` [L + 1, Bc] int64, its rows of the chunk's running totals.
    Its own lanes of rows 0 .. ``rows`` - 1 (lane lane_lo + t; ``extent``
    the most of them in a column, from the host's bounds) walk as
    :func:`raw_walk`'s sharded form walks them (walk t * Bc + b;
    ``max_hops`` below 2^15).  A walk that ends adds its weight into
    ``out`` [G * n_loc, Bc] f32 (adjacent columns) at its endpoint, column
    b, and writes ``ends`` [rows, Bc] int32 there (tests and checks only);
    a walk whose node leaves the process's rows before its last hop is
    written to ``outbox`` [P, cap, 4] int32 at its owner's row as (w, cur,
    h | len << 16, weight's bits), ``counts`` [P] int32 counting them
    (zeroed here).  A count past cap is a fault: the caller sizes cap to
    the launch's walks.  One launch on ``out``'s card, every tensor
    there."""
    if not 0 <= max_hops < 2**15:
        raise ValueError(f"raw_walk_xp: max_hops {max_hops}; a record holds "
                         f"lengths below 2^15")
    rows, lane_lo, extent = int(rows), int(lane_lo), int(extent)
    L, P, n_loc, Bc, out_ld, dev = _xp_common(
        "raw_walk_xp", out, indptr, indices, alias_prob, alias_other, shard0,
        G, outbox, counts, ends, rows)
    if len(r) != L or len(cum) != L:
        raise ValueError(f"raw_walk_xp: {len(r)} residues and {len(cum)} "
                         f"demands for {L} shards")
    if rows < 0 or lane_lo < 0 or not 0 <= extent <= rows or \
            rows * Bc >= 2**32:
        raise ValueError(f"raw_walk_xp: {rows} rows ({extent} own) of {Bc} "
                         f"columns from lane {lane_lo}")
    r_ld = 0
    for h in range(L):
        r_ld = _check_cols(f"r[{h}]", r[h], torch.float32, (n_loc, Bc))
        _check_cols(f"cum[{h}].T", cum[h].T, torch.int32, (Bc, n_loc))
        if r[h].stride() != r[0].stride() or \
                cum[h].stride() != cum[0].stride() or \
                r[h].device != dev or cum[h].device != dev:
            raise ValueError("raw_walk_xp: the shards' residues and demands "
                             "must share their strides and out's card")
    _check("bounds", bounds, torch.int64, (L + 1, Bc), dev)
    plan = schedule.xp_walk_plan(extent, Bc, 0, sm_count(dev),
                                 alias_prob is not None).own
    with torch.cuda.device(dev):
        err = build.library().fora_raw_walk_xp(
            _table(r), r_ld, _table(cum), cum[0].stride(1) if Bc > 1 else
            n_loc, _ptr(bounds), L, n_loc, Bc, rows, lane_lo, n_loc, shard0,
            G, P, _ptr(out), out_ld, _ptr(ends), _ptr(outbox),
            outbox.shape[1], _ptr(counts),
            *_xp_graph(indptr, indices, alias_prob, alias_other),
            seed % 2**64, inv_log1m_alpha(alpha), max_hops,
            plan.walks_per_lane, plan.tiles, plan.blocks, _stream(out))
    _raise_on(err, "raw_walk_xp")
    if plan.blocks:
        raw_walk_xp.launches += 1


def raw_walk_xp_inbox(inbox: torch.Tensor, out: torch.Tensor,
                      indptr: list, indices: list, alias_prob, alias_other,
                      seed: int, shard0: int, G: int, outbox: torch.Tensor,
                      counts: torch.Tensor,
                      ends: Optional[torch.Tensor] = None) -> None:
    """K6+K4-xp's inbox form, in place: a later round of a process's share
    of a chunk, in one launch.  The records of ``inbox`` [n_in, 4] int32
    (w, cur, h | len << 16, weight's bits), handed over by the other
    processes, walk on from where they stopped over this process's
    slices (as :func:`raw_walk_xp` takes them), each ending, adding its
    weight into ``out`` at column w % Bc (and ``ends``, [rows, Bc] int32,
    at w) or leaving into ``outbox`` / ``counts`` (zeroed here) as there.
    One launch on ``out``'s card, every tensor there."""
    rows = -1 if ends is None else ends.shape[0]
    L, P, n_loc, Bc, out_ld, dev = _xp_common(
        "raw_walk_xp_inbox", out, indptr, indices, alias_prob, alias_other,
        shard0, G, outbox, counts, ends, rows)
    _check("inbox", inbox, torch.int32, device=dev)
    if inbox.dim() != 2 or inbox.shape[1] != 4:
        raise ValueError("raw_walk_xp_inbox: inbox must be [n_in, 4]")
    n_in = inbox.shape[0]
    plan = schedule.xp_walk_plan(0, Bc, n_in, sm_count(dev),
                                 alias_prob is not None).inbox
    with torch.cuda.device(dev):
        err = build.library().fora_raw_walk_xp_inbox(
            _ptr(inbox), n_in, Bc, n_loc, shard0, L, G, P, _ptr(out), out_ld,
            _ptr(ends), _ptr(outbox), outbox.shape[1], _ptr(counts),
            *_xp_graph(indptr, indices, alias_prob, alias_other),
            seed % 2**64, plan.walks_per_lane, plan.blocks, _stream(out))
    _raise_on(err, "raw_walk_xp_inbox")
    if plan.blocks:
        raw_walk_xp_inbox.launches += 1


def _window_ends(name, ends, wlo: int, chunk_lanes: int) -> int:
    """K4-xp's checks of a window's ends [n_ends] from walk ``wlo``; wlo."""
    _check("ends", ends, torch.int32)
    wlo = int(wlo)
    if ends.dim() != 1 or wlo < 0 or wlo + ends.shape[0] >= 2**31 or \
            not 1 <= chunk_lanes < 2**31:
        raise ValueError(f"{name}: ends must be [n_ends], walks {wlo} .. of "
                         f"chunks of {chunk_lanes}")
    return wlo


def index_walk_xp(start: torch.Tensor, ends: torch.Tensor, w0: int, wlo: int,
                  chunk_lanes: int, indptr: list, indices: list, alias_prob,
                  alias_other, seed: int, alpha: float, max_hops: int,
                  shard0: int, G: int, outbox: torch.Tensor,
                  counts: torch.Tensor) -> None:
    """K4-xp's own-start form, in place: round 0 of a process's share of a
    window of the index build (whole chunks of ``chunk_lanes`` walks from
    walk ``wlo``), the G graph shards spread over P = G / L processes, in
    one launch.  This process holds shards ``shard0`` .. ``shard0`` + L -
    1, their out-CSR slices ``indptr`` / ``indices`` (and the alias tables,
    or None), and its own starts of the window, ``start`` [W] int32, walks
    ``w0`` .. ``w0`` + W - 1.  Walk w walks as :func:`index_walk_sharded`
    walks walk w % chunk_lanes of chunk c = w // chunk_lanes at seed + c
    2^32 (``max_hops`` below 2^15): one that ends writes its endpoint at
    ``ends[w - wlo]`` ([n_ends] int32); one whose node leaves the process's
    rows before its last hop writes -1 there and goes to ``outbox`` [P,
    cap, 4] int32 at its owner's row as (w, cur, h | len << 16, 0),
    ``counts`` [P + 1] int32 (zero here: the caller zeroes it) counting
    them (cap must hold the launch's walks).  One launch on ``ends``' card,
    every tensor there."""
    if not 0 <= max_hops < 2**15:
        raise ValueError(f"index_walk_xp: max_hops {max_hops}; a record "
                         f"holds lengths below 2^15")
    dev = ends.device
    wlo = _window_ends("index_walk_xp", ends, wlo, chunk_lanes)
    (W,) = start.shape
    _check("start", start, torch.int32, (W,), dev)
    w0 = int(w0)
    if w0 < wlo or w0 + W > wlo + ends.shape[0]:
        raise ValueError(f"index_walk_xp: walks {w0} .. {w0 + W - 1} of a "
                         f"window of {ends.shape[0]} from {wlo}")
    L, P, n_loc = _xp_slices("index_walk_xp", dev, indptr, indices,
                             alias_prob, alias_other, shard0, G, outbox,
                             counts, 1)
    plan = schedule.index_xp_plan(W, 0, sm_count(dev)).own
    with torch.cuda.device(dev):
        err = build.library().fora_index_walk_xp(
            _ptr(start), W, w0, _ptr(ends), wlo, ends.shape[0], chunk_lanes,
            *schedule.chunk_divisor(chunk_lanes), L, n_loc, shard0, G, P,
            _ptr(outbox), outbox.shape[1],
            _ptr(counts), *_xp_graph(indptr, indices, alias_prob,
                                     alias_other),
            seed % 2**64, inv_log1m_alpha(alpha), max_hops,
            plan.walks_per_lane, plan.blocks, _stream(ends))
    _raise_on(err, "index_walk_xp")
    if plan.blocks:
        index_walk_xp.launches += 1


def index_walk_xp_inbox(inbox: torch.Tensor, ends: torch.Tensor, wlo: int,
                        chunk_lanes: int, indptr: list, indices: list,
                        alias_prob, alias_other, seed: int, shard0: int,
                        G: int, outbox: torch.Tensor,
                        counts: torch.Tensor) -> None:
    """K4-xp's inbox form, in place: a later round of a process's share of
    an index build window, in one launch of resident blocks whose warps
    claim the records.  The records of ``inbox`` [n_in, 4] int32 (w, cur,
    h | len << 16, 0), handed over by the other processes, walk on from
    where they stopped over this process's slices (as
    :func:`index_walk_xp` takes them), each ending at ``ends[w - wlo]`` or
    leaving into ``outbox`` as there; ``counts`` [P + 1] int32, zero at
    the call, gets the P counts, and its last word is the claims' cursor.
    One launch on ``ends``' card."""
    dev = ends.device
    wlo = _window_ends("index_walk_xp_inbox", ends, wlo, chunk_lanes)
    L, P, n_loc = _xp_slices("index_walk_xp_inbox", dev, indptr, indices,
                             alias_prob, alias_other, shard0, G, outbox,
                             counts, 1)
    _check("inbox", inbox, torch.int32, device=dev)
    if inbox.dim() != 2 or inbox.shape[1] != 4:
        raise ValueError("index_walk_xp_inbox: inbox must be [n_in, 4]")
    n_in = inbox.shape[0]
    plan = schedule.index_xp_plan(0, n_in, sm_count(dev)).inbox
    with torch.cuda.device(dev):
        err = build.library().fora_index_walk_xp_inbox(
            _ptr(inbox), n_in, _ptr(ends), wlo, ends.shape[0], chunk_lanes,
            *schedule.chunk_divisor(chunk_lanes), n_loc, shard0, L, G, P,
            _ptr(outbox), outbox.shape[1],
            _ptr(counts), *_xp_graph(indptr, indices, alias_prob,
                                     alias_other),
            seed % 2**64, plan.claim_max, plan.blocks, _stream(ends))
    _raise_on(err, "index_walk_xp_inbox")
    if plan.blocks:
        index_walk_xp_inbox.launches += 1


def _source_walk_args(sources, out, rows, indptr, indices, alias_prob,
                      alias_other, hub_id, pool, seed, alpha, max_hops,
                      weight, ends=None):
    """:func:`source_walk`'s checks: None where the chunk has no walk,
    else (its card, B, fora_source_walk's arguments before the plan's, its
    stream)."""
    (B,) = sources.shape
    dev = sources.device
    _check("sources", sources, torch.int32, (B,))
    _check("out_indptr", indptr, torch.int32, device=dev)
    if indptr.dim() != 1 or indptr.shape[0] < 2:
        raise ValueError("source_walk: out_indptr must be [n + 1]")
    n = indptr.shape[0] - 1
    _check("out_indices", indices, torch.int32, device=dev)
    out_ld = _check_cols("out", out, torch.float32, (n, B))
    if out.device != dev:
        raise ValueError(f"source_walk: out on {out.device}, expected {dev}")
    if (alias_prob is None) != (alias_other is None):
        raise ValueError("source_walk: both alias tables or neither")
    if alias_prob is not None:
        m = indices.shape
        _check("alias_prob", alias_prob, torch.float32, m, dev)
        _check("alias_other", alias_other, torch.int32, m, dev)
    if (hub_id is None) != (pool is None):
        raise ValueError("source_walk: both hub_id and pool or neither")
    pool_size = 0
    if hub_id is not None:
        _check("hub_id", hub_id, torch.int32, (n,), dev)
        _check("pool", pool, torch.int32, device=dev)
        if pool.dim() != 2 or pool.shape[1] < 1:
            raise ValueError(f"source_walk: pool must be [H, P], got "
                             f"{tuple(pool.shape)}")
        pool_size = pool.shape[1]
    rows = int(rows)
    if rows < 0 or rows * B >= 2**32 or n >= 2**31:
        raise ValueError(f"source_walk: {rows} walks of {B} sources on {n} "
                         "nodes; at most 2^32 - 1 walks")
    if ends is not None:
        _check("ends", ends, torch.int32, (rows, B), dev)
    if rows * B == 0:
        return None
    return dev, B, (
        _ptr(sources), B, _ptr(out), out_ld, n, _ptr(ends), rows,
        _ptr(indptr), _ptr(indices), _ptr(alias_prob), _ptr(alias_other),
        _ptr(hub_id), _ptr(pool), pool_size, seed % 2**64,
        inv_log1m_alpha(alpha), max_hops, float(weight)), _stream(sources)


def source_walk(sources: torch.Tensor, out: torch.Tensor, rows: int,
                indptr: torch.Tensor, indices: torch.Tensor,
                alias_prob: Optional[torch.Tensor],
                alias_other: Optional[torch.Tensor],
                hub_id: Optional[torch.Tensor], pool: Optional[torch.Tensor],
                seed: int, alpha: float, max_hops: int, weight: float,
                ends: Optional[torch.Tensor] = None) -> None:
    """K6+K4-src, in place: ``rows`` walks from each of the B ``sources``
    ([B] int32) in one launch.  Walk t of column b starts at sources[b] as
    walk t * B + b of K4 over ``indptr`` / ``indices`` (its alias branch
    where the tables are given; K4-hub's where ``hub_id`` [n] and ``pool``
    [H, P] are: a hop that lands on a hub ends at a pool entry), and adds
    ``weight`` (a number) into ``out`` [n, B] f32 (adjacent columns) at
    its endpoint (f32 atomics in no fixed order; the walks that end at
    their source are counted and added once a warp tile).  So each
    endpoint is the one that K4 (K4-alias, K4-hub) gives on
    ``sources.repeat(rows)``, bit for bit.  ``ends`` (tests and checks
    only) [rows, B] int32 gets every endpoint."""
    got = _source_walk_args(sources, out, rows, indptr, indices, alias_prob,
                            alias_other, hub_id, pool, seed, alpha, max_hops,
                            weight, ends)
    if got is None:
        return
    dev, B, args, stream = got
    plan = schedule.raw_walk_plan(int(rows), B, sm_count(dev),
                                  alias_prob is not None)
    with torch.cuda.device(dev):
        err = build.library().fora_source_walk(
            *args, plan.walks_per_lane, plan.tiles, plan.blocks, stream)
    _raise_on(err, "source_walk")
    source_walk.launches += 1


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


PACK_TILE = 4096     # keys a block of K7-sort and K7-merge takes (pack.cu)
# K7-sort's digit widths (pack.cu's onesweep_kernel is a template of
# each); sort_digit_bits picks one a call
SORT_DIGIT_WIDTHS = (8, 9, 11)
SORT_MAX_KEYS = (1 << 30) - 1   # K7-sort's status words count in 30 bits
KEY_COUNT_BINS = 1 << 14   # K7-keys' count form's bins at most (pack.cu)


def _keys_inputs(ends, offsets, dang, nb, name) -> tuple:
    """(total, n, nd) of K7-keys' inputs, checked as ``pack_keys`` takes
    them."""
    (total,) = ends.shape
    dev = ends.device
    _check("ends", ends, torch.int32, (total,))
    n = offsets.shape[0] - 1
    _check("offsets", offsets, torch.int64, (n + 1,), dev)
    (nd,) = dang.shape
    _check("dang", dang, torch.int64, (nd,), dev)
    if n < 0 or not 1 <= nb or 2 * nb + 4 > 63 or total >= 2**31 - 1:
        raise ValueError(f"{name}: {total} entries, {nb} bits a node id, "
                         f"{n + 1} offsets; keys of 2 nb + 4 bits must fit "
                         "63, entries 2^31 - 1")
    return total, n, nd


def pack_keys(ends: torch.Tensor, offsets: torch.Tensor, dang: torch.Tensor,
              nb: int, totals: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K7-keys: the packed sort key of every pool entry, int64 [total +
    nd] (the bits of a uint64 below 2^63): entry j of node v (at
    ``offsets[v] + j`` of ``ends`` [total] int32; ``offsets`` [n + 1]
    int64, node v's entries up to ``offsets[v + 1]``, ``offsets[n]`` =
    total) gets ``bucket << 2 nb | ends[...] << nb | v``, bucket the number
    of q in 1..7 with j < ceil(K_v 4^-q); then the ``dang`` ([nd] int64)
    nodes' self-edges in the deepest bucket.  ``totals`` (from
    :func:`digit_totals`) gets, in the same launch, each K7-sort pass's
    digit counts over the keys, for ``sort_keys(totals=)``."""
    total, n, nd = _keys_inputs(ends, offsets, dang, nb, "pack_keys")
    dev = ends.device
    digit_bits = 0 if totals is None else _totals_bits(totals, 2 * nb + 4,
                                                       dev)
    keys = torch.empty(total + nd, dtype=torch.int64, device=dev)
    if total + nd == 0:
        if totals is not None:
            totals.zero_()
        return keys
    with torch.cuda.device(dev):
        err = build.library().fora_pack_keys(
            _ptr(ends), _ptr(offsets), n, _ptr(dang), nd, total, nb,
            _ptr(keys), _ptr(totals), digit_bits, _stream(ends))
    pack_keys.launches += 1
    _raise_on(err, "pack_keys")
    return keys


def pack_key_counts(ends: torch.Tensor, offsets: torch.Tensor,
                    dang: torch.Tensor, nb: int, lo: int, hi: int,
                    shift: int) -> torch.Tensor:
    """K7-keys' count form: of the keys ``pack_keys`` would give for the
    same inputs, those k with lo <= k < hi counted by bin (k - lo) >>
    shift, int32 [ceil((hi - lo) / 2^shift)] (at most KEY_COUNT_BINS); no
    key is written.  The plan of a pack in key-range windows reads it."""
    total, n, nd = _keys_inputs(ends, offsets, dang, nb, "pack_key_counts")
    bins = -(-(hi - lo) >> shift) if hi > lo else 0
    if not 0 <= lo < hi <= 1 << (2 * nb + 4) or not 0 <= shift <= 62 \
            or bins > KEY_COUNT_BINS:
        raise ValueError(f"pack_key_counts: [{lo}, {hi}) by {shift} bits, "
                         f"{bins} bins of at most {KEY_COUNT_BINS}, keys "
                         f"of {2 * nb + 4} bits")
    out = torch.empty(bins, dtype=torch.int32, device=ends.device)
    with torch.cuda.device(ends.device):
        err = build.library().fora_pack_key_counts(
            _ptr(ends), _ptr(offsets), n, _ptr(dang), nd, total, nb, lo, hi,
            shift, _ptr(out), _stream(ends))
    pack_key_counts.launches += 1
    _raise_on(err, "pack_key_counts")
    return out


def pack_keys_window(ends: torch.Tensor, offsets: torch.Tensor,
                     dang: torch.Tensor, nb: int, lo: int, hi: int,
                     length: int,
                     totals: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K7-keys' window form: the keys in [lo, hi) of those ``pack_keys``
    would give for the same inputs, int64 [length] (``length`` their
    number, from the count form), compacted in no order; ``totals`` (from
    :func:`digit_totals`) gets each K7-sort pass's digit counts over them.
    Synchronises once, to check that the window held ``length`` keys
    (RuntimeError where not)."""
    total, n, nd = _keys_inputs(ends, offsets, dang, nb, "pack_keys_window")
    dev = ends.device
    if not 0 <= lo < hi <= 1 << (2 * nb + 4) or length < 0:
        raise ValueError(f"pack_keys_window: [{lo}, {hi}), {length} keys "
                         f"of {2 * nb + 4} bits")
    digit_bits = 0 if totals is None else _totals_bits(totals, 2 * nb + 4,
                                                       dev)
    keys = torch.empty(length, dtype=torch.int64, device=dev)
    cursor = torch.empty(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = build.library().fora_pack_keys_window(
            _ptr(ends), _ptr(offsets), n, _ptr(dang), nd, total, nb, lo, hi,
            _ptr(keys), length, _ptr(cursor), _ptr(totals), digit_bits,
            _stream(ends))
    pack_keys_window.launches += 1
    _raise_on(err, "pack_keys_window")
    got = int(cursor.item())
    if got != length:
        raise RuntimeError(f"pack_keys_window: [{lo}, {hi}) held {got} keys, "
                           f"its count {length}")
    return keys


def digit_totals(key_bits: int, device,
                 digit_bits: Optional[int] = None) -> torch.Tensor:
    """An int32 [passes, 2^digit_bits] buffer for each K7-sort pass's digit
    counts over keys of ``key_bits`` bits (``digit_bits`` by default
    ``sort_digit_bits(key_bits)``; passes = ceil(key_bits / digit_bits)),
    which ``pack_keys(totals=)`` and :func:`digit_counts` fill and
    ``sort_keys(totals=)`` takes."""
    if digit_bits is None:
        digit_bits = sort_digit_bits(key_bits)
    return torch.empty((-(-key_bits // digit_bits), 1 << digit_bits),
                       dtype=torch.int32, device=device)


def _totals_bits(totals: torch.Tensor, key_bits: int, dev) -> int:
    """The digit width of a :func:`digit_totals` buffer for keys of
    ``key_bits`` bits on ``dev`` (ValueError where it is none)."""
    width = {1 << d: d for d in SORT_DIGIT_WIDTHS}.get(
        totals.shape[-1] if totals.dim() == 2 else 0)
    if width is None:
        raise ValueError(f"totals: shape {tuple(totals.shape)}, expected "
                         f"[passes, 2^d] with d in {SORT_DIGIT_WIDTHS}")
    _check("totals", totals, torch.int32, (-(-key_bits // width), 1 << width),
           dev)
    return width


def sort_digit_bits(key_bits: int) -> int:
    """K7-sort's digit width for keys of ``key_bits`` bits: 9 where it
    takes a pass fewer than 8 (42-bit keys at bench scale: 5 passes, not
    6), else 8.  A pass of 8-bit digits took 0.31 ms and one of 9-bit
    0.35 at bench scale, 11-bit digits (4 passes) 1.0 ms a pass
    (``chip_smoke.py`` phase 8 on an H100)."""
    return 9 if -(-key_bits // 9) < -(-key_bits // 8) else 8


def sort_scratch_words(length: int, digit_bits: int) -> int:
    """int32 words of K7-sort's scratch for ``length`` keys: the digit
    totals of up to ceil(64 / digit_bits) passes, the tiles' ticket (2
    words), then a status word a (tile, digit).  Raises ValueError past
    the 2^30 - 1 keys its 30-bit counts hold."""
    if length > SORT_MAX_KEYS:
        raise ValueError(f"K7-sort: {length} keys; its 30-bit status "
                         f"words count at most 2^30 - 1")
    if digit_bits not in SORT_DIGIT_WIDTHS:
        raise ValueError(f"K7-sort: {digit_bits}-bit digits; 8, 9 or 11")
    radix = 1 << digit_bits
    return (-(-64 // digit_bits) * radix + 2
            + radix * -(-length // PACK_TILE))


def merge_scratch_words(length: int, n: int) -> int:
    """int32 words of K7-merge's scratch for ``length`` keys of ``n``
    nodes: its ticket, a status word a tile and the 9 bucket offsets, 64
    bits each, then the first rank in each 4096-place tile of each
    bucket's n + 1 row pointers."""
    return 2 * (1 + -(-length // PACK_TILE) + 9) + 8 * -(-(n + 1) // 4096)


def sort_keys(keys: torch.Tensor, alt: torch.Tensor, key_bits: int,
              digit_bits: Optional[int] = None,
              totals: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K7-sort: ``keys`` (int64, non-negative, below 2^key_bits) sorted
    ascending by a stable LSD radix sort of ``digit_bits``-bit digits (8,
    9 or 11; by default ``sort_digit_bits(key_bits)``, or the width of
    ``totals``) between ``keys`` and ``alt`` (its ping-pong buffer, of the
    same shape); returns whichever holds the result (the other holds what
    is left of the input).  One launch counts every pass's digits, or
    ``totals`` (a :func:`digit_totals` buffer that ``pack_keys`` or
    :func:`digit_counts` filled from these keys) holds them, then one
    launch a pass (onesweep).  Synchronises the stream once, to read the
    digit totals: a pass whose digit is the same in every key is skipped.
    ``sort_keys.last_passes`` is the number of passes that ran."""
    (L,) = keys.shape
    dev = keys.device
    if totals is not None:
        width = _totals_bits(totals, key_bits, dev)
        if digit_bits not in (None, width):
            raise ValueError(f"sort_keys: {digit_bits}-bit digits, totals "
                             f"of {width}-bit")
        digit_bits = width
    if digit_bits is None:
        digit_bits = sort_digit_bits(key_bits)
    words = sort_scratch_words(L, digit_bits)
    _check("keys", keys, torch.int64, (L,))
    _check("alt", alt, torch.int64, (L,), dev)
    if not 1 <= key_bits <= 63:
        raise ValueError(f"sort_keys: {L} keys of {key_bits} bits")
    sort_keys.last_passes = 0
    if L <= 1:
        return keys
    scratch = torch.empty(words, dtype=torch.int32, device=dev)
    done = ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = build.library().fora_sort_keys(
            _ptr(keys), _ptr(alt), L, key_bits, digit_bits, _ptr(scratch),
            words, _ptr(totals), ctypes.byref(done), _stream(keys))
    sort_keys.launches += 1
    _raise_on(err, "sort_keys")
    sort_keys.last_passes = done.value
    return alt if done.value % 2 else keys


def digit_counts(keys: torch.Tensor, key_bits: int,
                 digit_bits: Optional[int] = None) -> torch.Tensor:
    """The count launch of K7-sort alone (``radix_histogram_kernel``): each
    pass's digit counts over ``keys`` (int64 [L]) into a new
    :func:`digit_totals` buffer.  For checks: no path calls it, and it
    has no launch count."""
    (L,) = keys.shape
    _check("keys", keys, torch.int64, (L,))
    if digit_bits is None:
        digit_bits = sort_digit_bits(key_bits)
    if not 1 <= key_bits <= 63 or digit_bits not in SORT_DIGIT_WIDTHS:
        raise ValueError(f"digit_counts: keys of {key_bits} bits, "
                         f"{digit_bits}-bit digits")
    totals = digit_totals(key_bits, keys.device, digit_bits)
    with torch.cuda.device(keys.device):
        err = build.library().fora_digit_counts(
            _ptr(keys), L, key_bits, digit_bits, _ptr(totals),
            _stream(keys))
    _raise_on(err, "digit_counts")
    return totals


def merge_keys(keys: torch.Tensor, nb: int, n: int) -> tuple:
    """K7-merge: the run-length merge of the sorted ``keys`` ([L] int64)
    of ``nb``-bit ids of ``n`` nodes: (edge_src, edge_dst [U] int32,
    edge_mult [U] float32, bucket_counts [8] int64, indptr [8, n + 1]
    int32) of the U unique keys unpacked (source the low nb bits, endpoint
    the next nb, bucket the rest), each one's run length its multiplicity,
    and each bucket's row pointers by endpoint relative to the bucket's
    start (an empty bucket's zeros).  One pass over the keys, and a launch
    that fills the pointers from the ranks the pass left at each (bucket,
    endpoint) with a key; the three edge arrays are views of [L] buffers.
    Synchronises once, to read U."""
    (L,) = keys.shape
    dev = keys.device
    _check("keys", keys, torch.int64, (L,))
    if not 1 <= nb or 2 * nb + 4 > 63 or L >= 2**31 or not 1 <= n <= 2**nb:
        raise ValueError(f"merge_keys: {L} keys of {nb}-bit ids of {n} "
                         "nodes")
    if keys.data_ptr() % 16:
        raise ValueError("merge_keys: keys must start 16-byte aligned (its "
                         "tiles are copied 16 bytes at a time)")
    if L == 0:
        return (torch.empty(0, dtype=torch.int32, device=dev),
                torch.empty(0, dtype=torch.int32, device=dev),
                torch.empty(0, dtype=torch.float32, device=dev),
                torch.zeros(8, dtype=torch.int64, device=dev),
                torch.zeros((8, n + 1), dtype=torch.int32, device=dev))
    indptr = torch.empty((8, n + 1), dtype=torch.int32, device=dev)
    bucket_counts = torch.empty(8, dtype=torch.int64, device=dev)
    src = torch.empty(L, dtype=torch.int32, device=dev)
    dst = torch.empty(L, dtype=torch.int32, device=dev)
    mult = torch.empty(L, dtype=torch.float32, device=dev)
    words = merge_scratch_words(L, n)
    scratch = torch.empty(words, dtype=torch.int32, device=dev)
    unique = ctypes.c_longlong(0)
    with torch.cuda.device(dev):
        err = build.library().fora_merge_keys(
            _ptr(keys), L, nb, n, _ptr(scratch), words, _ptr(src),
            _ptr(dst), _ptr(mult), _ptr(indptr), _ptr(bucket_counts),
            ctypes.byref(unique), _stream(keys))
    merge_keys.launches += 1
    _raise_on(err, "merge_keys")
    U = unique.value
    return src[:U], dst[:U], mult[:U], bucket_counts, indptr


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
            expand_lanes, accumulate_endpoints, raw_walk, raw_walk_xp,
            raw_walk_xp_inbox, index_walk_xp, index_walk_xp_inbox,
            source_walk, philox_blocks, pack_keys, pack_key_counts,
            pack_keys_window, sort_keys, merge_keys)
for _w in WRAPPERS:
    _w.launches = 0
topk_bounds.last_state = None
sort_keys.last_passes = 0


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0


def launch_counts() -> dict:
    return {w.__name__: w.launches for w in WRAPPERS}
