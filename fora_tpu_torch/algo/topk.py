"""Top-k PPR with iterative guarantee refinement, raw-walk or indexed
(FORA+) mode.

Port of ``fora_tpu/algo/topk.py`` (44-77, 193-766), whose module
docstring explains the delta schedule and the two acceptance tests
(threshold rule and Bernstein-bound separation).  The TPU memory levers
(``push_pair``, ``walk_half``, ``narrow_r``) and the raw mode's lane
buckets are not ported.  A level is push + walk phase + the split accept
(K3, on p + contrib): in raw mode the walk phase samples walks sized by
the measured demand (``ops.walk.walk_phase``), in indexed mode it is the
index SpMV.  ``key`` arguments are optional seeds: a call without one
takes the next seed of the runner's own sequence, and every (call, level,
block) draws from its own ``derive_seed`` stream; indexed mode ignores
them, as JAX's does.

Pool state lives as a list of contiguous [n, width] (p, r) column blocks
on the graph's device; a level step advances a block in place.  Every
operation on a block's columns goes through four hooks (``_new_block``,
``_select_cols``, ``_concat_cols``, ``_split_cols``), so that a subclass
can hold a block otherwise: ``parallel.ShardedTopkRunner`` keeps one
[n_loc, cols] pair per shard device.
"""

from __future__ import annotations

import json
import math
import time
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import ResolvedConfig
from ..graph.csr import DeviceGraph
from ..ops.walk import derive_seed
from ..utils.timing import StageClock
from . import bounds as bounds_mod
from .fora import StagedForaPrograms, raw_lean_state


class TopkResult(NamedTuple):
    node_ids: np.ndarray    # [B, k] i32, descending by estimate
    values: np.ndarray      # [B, k] f32
    levels_used: int        # delta levels executed
    accepted: np.ndarray    # [B] bool: a guarantee test passed
    lower_bounds: Optional[np.ndarray] = None   # [B, k] f32
    upper_bounds: Optional[np.ndarray] = None   # [B, k] f32
    deferred: Optional[np.ndarray] = None       # [B] bool


def delta_schedule(rcfg: ResolvedConfig, k: int, stride: float = 2.0) -> list:
    """delta_0 = 1/k, divided by ``stride`` per level down to the final
    guarantee delta (>= 1/n); a trailing sliver level is merged into the
    floor level."""
    floor_delta = max(rcfg.delta, 1.0 / rcfg.n)
    deltas = []
    d = 1.0 / max(k, 2)
    while d > floor_delta * math.sqrt(stride):
        deltas.append(d)
        d /= stride
    deltas.append(floor_delta)
    return deltas


def _cat_cols(pieces):
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=1)


def _merge_info(acc: dict, info: dict) -> None:
    """Sum one block's level ``info`` into ``acc`` (``walks_max`` takes
    the largest, ``ms`` sums per stage)."""
    for name, v in info.items():
        if name == "ms":
            ms = acc.setdefault("ms", {})
            for stage, t in v.items():
                ms[stage] = ms.get(stage, 0.0) + t
        elif name == "walks_max":
            acc[name] = max(acc.get(name, 0), v)
        else:
            acc[name] = acc.get(name, 0) + v


class TopkRunner:
    """Drives the delta-refinement loop over StagedForaPrograms levels."""

    PROBE_EVERY = 8    # pools between one-level-shallower start probes
    WIDTH_FLOOR = 128  # narrowest adaptive batch (TPU-tuned; re-measure)
    LEVEL_STATS_VERSION = 2

    def __init__(self, graph: DeviceGraph, rcfg: ResolvedConfig,
                 k: Optional[int] = None, index=None,
                 delta_stride: float = 2.0, accept_slack: float = 1.0):
        """``index`` (a fora_tpu_torch WalkIndex) selects the indexed mode;
        None runs raw walks.  accept_slack > 1 tightens the threshold
        rule; the Bernstein separation test is always on."""
        self.graph = graph
        self.rcfg = rcfg
        self.k = k if k is not None else rcfg.k
        self.accept_slack = accept_slack
        self.deltas = delta_schedule(rcfg, self.k, stride=delta_stride)
        self._t = bounds_mod.union_bound_t(rcfg.n, len(self.deltas),
                                           rcfg.pfail)
        self._index = index
        # a subclass without a DeviceGraph (the sharded runner) runs its
        # own level step
        self._staged = (None if index is None or graph is None else
                        StagedForaPrograms(graph, rcfg, index))
        self.auto_start_level = 0
        self._pools_since_probe = 0
        self._deferred = []   # stashed stragglers: {sources, p, r, level}
        self._lsteps = {}
        self._calls = 0       # calls that took the runner's own seed
        # per level: (index depth or None in raw mode, rmax, omega_unit)
        self._levels = []
        for d in self.deltas:
            rc = rcfg.with_delta(d)
            depth = (None if index is None else
                     index.depth_for(rc.omega_unit, rc.rmax))
            self._levels.append((depth, rc.rmax, rc.omega_unit))
        self.last_level_stats = []

    # --- one level ------------------------------------------------------

    def _init_pool_state(self, sources: torch.Tensor):
        """(p, r) for one block of sources: one-hot residue."""
        n, C = self.rcfg.n, sources.shape[0]
        dev = self.graph.device
        p = torch.zeros((n, C), dtype=torch.float32, device=dev)
        r = torch.zeros_like(p)
        r[sources.long(), torch.arange(C, device=dev)] = 1.0
        return p, r

    # --- block state hooks ----------------------------------------------

    def _new_block(self, sources: np.ndarray):
        """(p, r) of a block of sources (host ids), one-hot."""
        return self._init_pool_state(torch.as_tensor(
            np.asarray(sources), dtype=torch.int32, device=self.graph.device))

    @staticmethod
    def _select_cols(p, r, sel: np.ndarray):
        """The columns ``sel`` of a (p, r) state, as one state."""
        s = torch.as_tensor(np.asarray(sel), device=p.device)
        return p.index_select(1, s), r.index_select(1, s)

    @staticmethod
    def _concat_cols(pairs: list):
        """(p, r) states side by side, as one state."""
        return (_cat_cols([p for p, _ in pairs]),
                _cat_cols([r for _, r in pairs]))

    @staticmethod
    def _split_cols(p, r, width: int) -> list:
        """A state cut into blocks of ``width`` contiguous columns."""
        if p.shape[1] == width:
            return [(p, r)]
        return [(p[:, lo: lo + width].contiguous(),
                 r[:, lo: lo + width].contiguous())
                for lo in range(0, p.shape[1], width)]

    def _call_seed(self, key: Optional[int]) -> int:
        """The seed of one call: ``key``, else the next of the runner's."""
        if key is None:
            key = derive_seed(self._calls)
            self._calls += 1
        return int(key)

    def _accept(self, p, contrib, omega_unit):
        vals, idx, lb, ub, _, _, bacc = bounds_mod.topk_with_bounds_split(
            p, contrib, omega_unit, self.k, self._t, self.rcfg.epsilon)
        return vals, idx, lb, ub, bacc

    def _level_step(self, ckey: Optional[int]):
        """``(p, r, rmax, omega_unit, seed, live) -> (vals, idx, lb, ub,
        bacc, p', r', info)`` at index depth ``ckey`` (None: raw walks from
        ``seed`` for the first ``live`` columns; the rest are padding); p
        and r advance in place.  ``info`` holds the level's supersteps and,
        in raw mode, its walk counts and per-stage milliseconds."""
        if ckey not in self._lsteps:
            if ckey is not None:
                lean = self._staged.lean_state_fn(ckey)

                def fn(p, r, rmax, omega_unit, seed, live):
                    del seed, live   # indexed mode is deterministic
                    p2, r2, contrib, iters = lean(p, r, rmax, omega_unit)
                    return (*self._accept(p2, contrib, omega_unit), p2, r2,
                            {"supersteps": iters})
            else:
                def fn(p, r, rmax, omega_unit, seed, live):
                    clock = StageClock(p.device)
                    p2, r2, contrib, iters, walk = raw_lean_state(
                        self.graph, p, r, seed, rmax, omega_unit,
                        rcfg=self.rcfg, live=live, clock=clock)
                    with clock.stage("accept"):
                        out = self._accept(p2, contrib, omega_unit)
                    del contrib
                    info = {"supersteps": iters,
                            "walks_max": walk.walks_max,
                            "walks_total": walk.walks_total,
                            "lanes": walk.lanes, "chunks": walk.chunks,
                            "overflow": int(walk.overflow.sum()),
                            "ms": clock.ms()}
                    return (*out, p2, r2, info)

            self._lsteps[ckey] = fn
        return self._lsteps[ckey]

    # --- whole-batch and pool loops ------------------------------------

    def query(self, sources, key: Optional[int] = None) -> TopkResult:
        """Whole-batch refinement: every query advances levels together
        until all accept."""
        call = self._call_seed(key)
        src = np.asarray(sources)
        B, k, eps = src.shape[0], self.k, self.rcfg.epsilon
        best_vals = np.zeros((B, k), np.float32)
        best_idx = np.zeros((B, k), np.int32)
        best_lb = np.zeros((B, k), np.float32)
        best_ub = np.full((B, k), np.inf, np.float32)
        accepted = np.zeros(B, bool)
        levels = 0
        p, r = self._new_block(src)
        for level, d in enumerate(self.deltas):
            levels = level + 1
            ckey, rmax, omega_unit = self._levels[level]
            vals, idx, lb, ub, bacc, p, r, _ = self._level_step(ckey)(
                p, r, rmax, omega_unit, derive_seed(call, level, 0), B)
            vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
            lb, ub, bacc = lb.cpu().numpy(), ub.cpu().numpy(), \
                bacc.cpu().numpy()
            newly = (vals[:, -1] >= self.accept_slack * (1 + eps) * d) | bacc
            newly = ~accepted & newly
            take = newly | (~accepted & (level == len(self.deltas) - 1))
            best_vals[take], best_idx[take] = vals[take], idx[take]
            best_lb[take], best_ub[take] = lb[take], ub[take]
            accepted |= newly
            if accepted.all():
                break
        return TopkResult(node_ids=best_idx, values=best_vals,
                          levels_used=levels, accepted=accepted,
                          lower_bounds=best_lb, upper_bounds=best_ub)

    def query_pool(self, sources, key: Optional[int] = None, *, batch: int,
                   start_level: Optional[int] = None, defer_below: int = 0,
                   _state=None) -> TopkResult:
        """Level-pipelined batching over a pool of queries with resumed
        push: accepted queries exit at their level, stragglers re-batch
        deeper at an adaptive width (halving down to WIDTH_FLOOR), the
        start level adapts across pools, and with ``defer_below`` > 0 a
        thin straggler set is stashed for ``flush_deferred``.  See
        fora_tpu's ``TopkRunner.query_pool`` for the full rationale.

        ``_state`` (used by flush_deferred): resume from the given
        [n, len(sources)] (p, r) instead of one-hot state.

        ``last_level_stats`` gets one record per level run: widths,
        acceptances, wall seconds and the level's supersteps; in raw mode
        also walks demanded (largest column, all columns), lanes walked,
        walk-phase chunks, overflowing columns (always 0) and the
        milliseconds of push, alloc, walks, accum and accept.
        """
        call = self._call_seed(key)
        sources = np.asarray(sources)
        n_q = len(sources)
        self.last_level_stats = []
        k, eps = self.k, self.rcfg.epsilon
        out_ids = np.zeros((n_q, k), np.int32)
        out_vals = np.zeros((n_q, k), np.float32)
        out_lb = np.zeros((n_q, k), np.float32)
        out_ub = np.full((n_q, k), np.inf, np.float32)
        max_level = 0
        accepted = np.zeros(n_q, bool)
        deferred_mask = np.zeros(n_q, bool)
        pending = np.arange(n_q)

        def pick_width(n_pending: int) -> int:
            w = batch
            while w // 2 >= max(n_pending, 1) and w // 2 >= self.WIDTH_FLOOR:
                w //= 2
            return w

        width = pick_width(n_q)
        pad0 = (-n_q) % width
        if _state is None:
            cols = np.concatenate([pending, np.zeros(pad0, np.int64)])
            blocks = [self._new_block(sources[cols[lo: lo + width]])
                      for lo in range(0, len(cols), width)]
        else:
            # pad by repeating the last column; padding columns are
            # skipped at acceptance time
            idx = np.concatenate([np.arange(n_q),
                                  np.full(pad0, n_q - 1, np.int64)])
            blocks = self._split_cols(*self._select_cols(*_state, idx),
                                      width)
            del _state

        start = self.auto_start_level
        if start_level is None and start > 0 \
                and self._pools_since_probe >= self.PROBE_EVERY:
            start -= 1   # periodic probe one level shallower
            self._pools_since_probe = 0
        elif start_level is not None:
            start = start_level
        start = max(0, min(start, len(self.deltas) - 1))

        for level, d in enumerate(self.deltas):
            if level < start or len(pending) == 0:
                continue
            max_level = level + 1
            t0 = time.perf_counter()
            n_pending = len(pending)
            ckey, rmax, omega_unit = self._levels[level]
            fn = self._level_step(ckey)
            last = level == len(self.deltas) - 1
            keep_cols = []
            n_ok = 0
            n_ok_bound = 0   # accepted by the bound test alone
            work = {}
            for bi in range(len(blocks)):
                pc, rc = blocks[bi]
                lo = bi * width
                vals, idx, lb, ub, bacc, pc, rc, info = fn(
                    pc, rc, rmax, omega_unit, derive_seed(call, level, lo),
                    min(width, len(pending) - lo))
                blocks[bi] = (pc, rc)
                _merge_info(work, info)
                vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
                lb, ub = lb.cpu().numpy(), ub.cpu().numpy()
                bacc = bacc.cpu().numpy()
                for b in range(width):
                    g = lo + b
                    if g >= len(pending):
                        continue
                    q = pending[g]
                    ok_thr = bool(vals[b, -1] >=
                                  self.accept_slack * (1 + eps) * d)
                    ok = ok_thr or bool(bacc[b])
                    n_ok += ok
                    n_ok_bound += ok and not ok_thr
                    if ok or last:
                        out_ids[q] = idx[b]
                        out_vals[q] = vals[b]
                        out_lb[q] = lb[b]
                        out_ub[q] = ub[b]
                        accepted[q] = ok
                    else:
                        keep_cols.append(g)
            self.last_level_stats.append(dict(
                level=level, delta=d, width=width, batches=len(blocks),
                pending=n_pending, accepted=n_ok,
                accepted_bound_only=n_ok_bound,
                secs=round(time.perf_counter() - t0, 3), **work))
            if not keep_cols:
                pending = pending[:0]
                break
            keep = np.asarray(keep_cols)
            if defer_below and len(keep) <= defer_below and not last:
                # too few stragglers to fill a batch: stash their state
                # columns for one shared flush across pools
                p_cols, r_cols = self._extract_cols(blocks, width, keep)
                q_ids = pending[keep]
                self._deferred.append(dict(
                    sources=np.asarray(sources[q_ids]).copy(),
                    p=p_cols, r=r_cols, level=level + 1))
                deferred_mask[q_ids] = True
                pending = pending[:0]
                break
            pending = pending[keep]
            new_width = pick_width(len(keep))
            take = np.concatenate(
                [keep, np.repeat(keep[-1:], (-len(keep)) % new_width)])
            blocks = self._reblock(blocks, width, take, new_width)
            width = new_width

        if start_level is None:
            self._update_start_level(n_q)
            self._pools_since_probe += 1
        return TopkResult(node_ids=out_ids, values=out_vals,
                          levels_used=max_level, accepted=accepted,
                          lower_bounds=out_lb, upper_bounds=out_ub,
                          deferred=deferred_mask)

    def flush_deferred(self, key: Optional[int] = None, *, batch: int):
        """Refine every stashed straggler in one shared pool per distinct
        stashed level, resumed from the stashed push state.  Returns
        ``(sources, TopkResult)``, or ``(empty, None)`` if nothing was
        stashed."""
        if not self._deferred:
            return np.empty(0, np.int64), None
        call = self._call_seed(key)
        groups, self._deferred = self._deferred, []
        by_level: dict = {}
        for g in groups:
            by_level.setdefault(g["level"], []).append(g)
        all_srcs, parts = [], []
        for li, (start, gs) in enumerate(sorted(by_level.items())):
            srcs = np.concatenate([g["sources"] for g in gs])
            state = self._concat_cols([(g["p"], g["r"]) for g in gs])
            for g in gs:
                g.clear()   # release stashed buffers
            parts.append(self.query_pool(srcs, derive_seed(call, li),
                                         batch=batch, start_level=start,
                                         _state=state))
            del state
            all_srcs.append(srcs)
        if len(parts) == 1:
            return all_srcs[0], parts[0]

        def cat(f):
            return np.concatenate([getattr(r, f) for r in parts])

        return np.concatenate(all_srcs), TopkResult(
            node_ids=cat("node_ids"), values=cat("values"),
            levels_used=max(r.levels_used for r in parts),
            accepted=cat("accepted"), lower_bounds=cat("lower_bounds"),
            upper_bounds=cat("upper_bounds"), deferred=cat("deferred"))

    # --- pool state reshaping ----------------------------------------

    def _extract_cols(self, blocks, width, keep):
        """The pool columns at positions ``keep`` as one (p, r) state."""
        pieces = []
        for bi, (pc, rc) in enumerate(blocks):
            sel = keep[(keep >= bi * width) & (keep < (bi + 1) * width)]
            if len(sel):
                pieces.append(self._select_cols(pc, rc, sel - bi * width))
        return self._concat_cols(pieces)

    def _reblock(self, blocks, width, take, new_width):
        """Regroup the surviving columns ``take`` (old layout positions,
        padded to a multiple of new_width) into blocks of new_width
        columns; old blocks are released as their columns are taken."""
        pieces = []
        for bi in range(len(blocks)):
            pc, rc = blocks[bi]
            sel = take[(take >= bi * width) & (take < (bi + 1) * width)]
            if len(sel):
                pieces.append(self._select_cols(pc, rc, sel - bi * width))
            blocks[bi] = None
        return self._split_cols(*self._concat_cols(pieces), new_width)

    def _update_start_level(self, n_total: int) -> None:
        """Next pool's start level: the first level whose acceptances
        changed the pool's downstream work (fora_tpu's rule: keep a level
        that nearly terminates the pool or shrinks later batches, never
        ratchet into the final level)."""
        stats = self.last_level_stats
        if not stats:
            return
        near_term = max(2, n_total // 32)
        start = stats[0]["level"]
        for i, st in enumerate(stats):
            survivors = st["pending"] - st["accepted"]
            if survivors < near_term:
                break
            nxt = stats[i + 1] if i + 1 < len(stats) else None
            if nxt is None:
                break
            if nxt["batches"] * nxt["width"] < st["batches"] * st["width"]:
                break
            if nxt["level"] >= len(self.deltas) - 1:
                break
            start = nxt["level"]
        self.auto_start_level = start

    # --- persisted level stats ----------------------------------------

    def _stats_fingerprint(self, graph_sha: Optional[str]) -> dict:
        return {
            "version": self.LEVEL_STATS_VERSION,
            "graph_sha": graph_sha,
            "n": self.rcfg.n, "m": self.rcfg.m,
            "alpha": self.rcfg.alpha, "epsilon": self.rcfg.epsilon,
            "delta": self.rcfg.delta, "pfail": self.rcfg.pfail,
            "k": self.k, "accept_slack": self.accept_slack,
            "deltas": [float(d) for d in self.deltas],
            "indexed": self._index is not None,
        }

    def save_level_stats(self, path, graph_sha: Optional[str] = None) -> None:
        """Persist the learned start level, keyed by graph content and the
        full derivation (same record as fora_tpu's)."""
        rec = self._stats_fingerprint(graph_sha)
        rec["start_level"] = int(self.auto_start_level)
        rec["last_level_stats"] = self.last_level_stats
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.with_suffix(p.suffix + ".tmp")
        tmp.write_text(json.dumps(rec, indent=1))
        tmp.rename(p)

    def load_level_stats(self, path, graph_sha: Optional[str] = None) -> bool:
        """Adopt a persisted start level if it matches this (graph,
        config); returns whether it did."""
        p = Path(path)
        if not p.exists():
            return False
        try:
            rec = json.loads(p.read_text())
        except (OSError, ValueError):
            return False
        want = self._stats_fingerprint(graph_sha)
        if {k: rec.get(k) for k in want} != want:
            return False
        self.auto_start_level = max(
            0, min(int(rec["start_level"]), len(self.deltas) - 1))
        return True
