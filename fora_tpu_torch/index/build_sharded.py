"""The FORA+ index build over the row-sharded out-CSR.

Port of ``fora_tpu/index/build_sharded.py``: ``_shard_csr`` (48-82), per
shard a localized slice of the out-CSR's row pointers and its contiguous
slice of ``out_indices`` (and of the alias tables on a weighted graph),
padded to common shapes; ``build_walk_index_sharded`` (108-170) and
``sharded_build_bytes`` (173-185).  The sharded graph store
(``parallel/graph_store.py``) writes the walk side with ``_shard_csr``, and
the sharded raw one-shot (``parallel/sharded.py``) walks over it.

Each shard holds only its rows' slice, the memory wall the JAX builder
breaks with one psum per hop of its lockstep walk.  Here the walks read
the slices through a table of their pointers (K4's sharded form,
``ops/walk.py``), so the index is ``index/build.py``'s at the same seed
and chunk, array for array: chunk i of ``chunk_lanes`` walks draws from
``seed + i * 2^32`` on both.  Every builder runs ``index/build.py``'s
chunk loop (``run_walk_chunks``) and pack, so their crash-resume
checkpoints are interchangeable where their random streams agree (one
manifest format, as the JAX builders share theirs).

Over a ``parallel.mesh.ProcessMesh`` (P processes of L shards, JAX's
build over a mesh whose graph axis spans processes) each process places
only its own L slices, and the walks are handed between processes as
records (K4-xp, ``ops/walk.py::index_walk_xp_chunk``, in the rounds of
``xp_chunk_rounds`` over ``process_exchange``), a window of whole chunks
at once (``kernels.schedule.build_windows``), so the build pays the rounds
of its longest chunk; one max all-reduce a window of its endpoints (-1
where a walk ended in another process) gives every process every
endpoint, the end state of JAX's psum a hop, and every process packs the
same index (on a card with K7).  Checkpointing, every process writes each
window's chunk files to its own directory; on resume a min all-reduce
agrees on the windows that every process has whole, and only those are
skipped, so that the processes' rounds stay in step.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import numpy as np
import torch

from .. import kernels
from ..config import ResolvedConfig
from ..graph.alias import AliasTables, build_alias, build_alias_library
from ..kernels import schedule
from ..ops.walk import (ShardedOutCSR, index_walk_xp_chunk, process_exchange,
                        xp_chunk_rounds)
from ..utils.timers import Timers
from ..utils.timing import StageClock
from .build import (PHILOX_STREAM, WalkIndex, _splitter, build_fingerprint,
                    index_endpoints, index_walks, pack_index,
                    run_walk_chunks)


def _shard_csr(g, n_shards: int, row_multiple: int = 8,
               alias: Optional[AliasTables] = None):
    """(n_loc, indptr [G, n_loc+1] i32, indices [G, mo_loc] i32, deg [G,
    n_loc] i32, alias_prob [G, mo_loc] f32 or None, alias_other [G,
    mo_loc] i32 or None) of ``g``, a CSRGraph of either package.  A
    weighted graph's alias tables are ``alias`` where given, else
    ``graph.alias.build_alias``'s (the two builders give equal tables)."""
    n = g.n
    n_loc = -(-math.ceil(n / n_shards) // row_multiple) * row_multiple
    indptr = np.asarray(g.out_indptr, dtype=np.int64)
    bounds = [indptr[min(s * n_loc, n)] for s in range(n_shards + 1)]
    m_loc = max(1, max(int(bounds[s + 1] - bounds[s])
                       for s in range(n_shards)))

    indptr_loc = np.zeros((n_shards, n_loc + 1), dtype=np.int32)
    indices_loc = np.zeros((n_shards, m_loc), dtype=np.int32)
    deg_loc = np.zeros((n_shards, n_loc), dtype=np.int32)
    ap_loc = (np.ones((n_shards, m_loc), dtype=np.float32)
              if g.weighted else None)
    ao_loc = (np.zeros((n_shards, m_loc), dtype=np.int32)
              if g.weighted else None)
    if g.weighted and alias is None:
        alias = build_alias(g, weights=g.out_w)
    for s in range(n_shards):
        row0, row1 = s * n_loc, min((s + 1) * n_loc, n)
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        if row1 > row0:
            sl = indptr[row0: row1 + 1] - lo
            indptr_loc[s, : row1 - row0 + 1] = sl
            indptr_loc[s, row1 - row0 + 1:] = sl[-1]
            deg_loc[s, : row1 - row0] = np.asarray(g.out_deg[row0:row1])
        indices_loc[s, : hi - lo] = np.asarray(g.out_indices[lo:hi])
        if g.weighted:
            ap_loc[s, : hi - lo] = alias.prob[lo:hi]
            ao_loc[s, : hi - lo] = alias.other[lo:hi]
    return n_loc, indptr_loc, indices_loc, deg_loc, ap_loc, ao_loc


def place_out_csr(slices, n_loc: int, devices) -> ShardedOutCSR:
    """A ShardedOutCSR from per-shard host arrays: ``slices`` holds, per
    shard, (indptr [n_loc+1], indices, alias_prob or None, alias_other or
    None), each put on that shard's device."""
    def put(a, dev, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)
    ip, ix, ap, ao = [], [], [], []
    for (p, i, prob, other), dev in zip(slices, devices):
        ip.append(put(p, dev, np.int32))
        ix.append(put(i, dev, np.int32))
        if prob is not None:
            ap.append(put(prob, dev, np.float32))
            ao.append(put(other, dev, np.int32))
    return ShardedOutCSR(indptr=tuple(ip), indices=tuple(ix),
                         alias_prob=tuple(ap) if ap else None,
                         alias_other=tuple(ao) if ao else None, n_loc=n_loc)


def shard_out_csr(g, devices, row_multiple: int = 8,
                  n_shards: Optional[int] = None,
                  local: Optional[Sequence[int]] = None) -> ShardedOutCSR:
    """``g``'s out-CSR cut by ``_shard_csr`` over len(devices) shards, shard
    s on ``devices[s]``; a weighted graph's alias tables from the builder
    ``to_device`` takes for the first device (the kernel library's on a
    card, where numpy's loop would take minutes at the bench's scale).
    With ``n_shards`` and ``local`` (a process's shards): cut over
    ``n_shards``, and only the ``local`` shards' slices placed, on
    ``devices`` (one each)."""
    G = len(devices) if n_shards is None else n_shards
    local = range(G) if local is None else local
    alias = None
    if g.weighted and torch.device(devices[0]).type == "cuda":
        alias = build_alias_library(g, g.out_w)
    n_loc, ip, ix, _deg, ap, ao = _shard_csr(g, G, row_multiple, alias=alias)
    return place_out_csr(
        [(ip[s], ix[s], None if ap is None else ap[s],
          None if ao is None else ao[s]) for s in local], n_loc, devices)


def _walks(g, rcfg: ResolvedConfig,
           max_per_node: Optional[int] = None) -> tuple:
    """(out-degrees, index counts, their total, the starts [total] int32
    sorted by node) of ``g``'s index walks."""
    deg = np.asarray(g.out_deg)
    counts, total = index_walks(deg, rcfg, max_per_node)
    return deg, counts, total, np.repeat(np.arange(g.n, dtype=np.int32),
                                         counts)


def own_run(cum: np.ndarray, lo: int, W: int, row0: int, row1: int) -> tuple:
    """(a, b): walks a .. b - 1 of the W walks from ``lo`` (a chunk, or a
    window of chunks) start in rows ``row0`` .. ``row1`` - 1 (a
    process's), ``cum`` [n + 1] the index walks before each node (the
    starts are sorted by node, so a process's own starts of a chunk or a
    window are one run)."""
    n = cum.shape[0] - 1
    a, b = (int(cum[min(r, n)]) - lo for r in (row0, row1))
    return min(max(a, 0), W), min(max(b, 0), W)


def build_walk_index_sharded(g, mesh, rcfg: ResolvedConfig, seed: int, *,
                             max_per_node: Optional[int] = None,
                             chunk_lanes: int = 1 << 23,
                             checkpoint_dir: Optional[str] = None,
                             progress=None,
                             log: Optional[dict] = None) -> WalkIndex:
    """``build_walk_index`` with the out-CSR sharded over the mesh's graph
    shards (``mesh`` as the sharded engines take it; a query axis is
    ignored): ``g`` (a host CSRGraph) cut by ``_shard_csr``, each slice on
    its shard's device, every index walk run on the first shard's device
    over the slices, ``chunk_lanes`` walks per launch, chunk i from seed
    ``seed + i * 2^32``, through ``run_walk_chunks`` (crash-resume with
    ``checkpoint_dir``, ``progress`` as there); then the pack on that
    device.  The index equals ``build_walk_index(to_device(g), rcfg, seed,
    chunk_lanes=chunk_lanes)`` array for array, and each resumes the
    other's checkpoint; ``log`` gets the split as there.

    Over a ``ProcessMesh`` every process places only its own L slices, on
    its device, walks its own starts of each chunk and the walks handed to
    it (:func:`build_across_processes`), and returns the same index.  Its
    walks draw K4's Philox words on the CPU as on a card, so there the
    index equals the one-process build only where that build draws them
    too: on a card, and not on the CPU, whose one-process build walks with
    a ``torch.Generator`` (``ops.walk.walk_endpoints``); on the CPU it
    equals the packed endpoints of ``ops.walk.run_walks_philox`` run on
    each chunk's starts at the chunk's seed."""
    from ..parallel.mesh import ProcessMesh
    from ..parallel.sharded import _mesh_groups
    devices = _mesh_groups(mesh)[0]
    if isinstance(devices, ProcessMesh):
        return build_across_processes(
            g, devices, rcfg, seed, chunk_lanes, max_per_node=max_per_node,
            checkpoint_dir=checkpoint_dir, progress=progress)
    dev = torch.device(devices[0])
    with _splitter(log, dev)("walk"):
        ends, counts, deg = index_endpoints(
            shard_out_csr(g, devices), g, rcfg, seed, dev,
            max_per_node=max_per_node, chunk_lanes=chunk_lanes,
            checkpoint_dir=checkpoint_dir, progress=progress)
    return pack_index(ends, counts, deg, rcfg, log=log, free_endpoints=True)


def build_across_processes(g, mesh, rcfg: ResolvedConfig,
                           seed: int, chunk_lanes: int = 1 << 23,
                           log: Optional[dict] = None, *,
                           max_per_node: Optional[int] = None,
                           checkpoint_dir: Optional[str] = None,
                           progress=None) -> WalkIndex:
    """:func:`build_walk_index_sharded` over ``mesh``, a ``ProcessMesh``
    (this process's L shards on one device).  ``g``, the host graph, is
    the same on every process; this one places only its shards' slices
    (``shard_out_csr(..., n_shards=G, local=mesh.local)``).  Per window of
    whole chunks (``schedule.build_windows``; each walk draws as the
    one-process build's chunk draws it) the rounds of ``xp_chunk_rounds``
    over ``process_exchange(mesh.comm)``: round 0 walks the process's own
    starts of the window, the later rounds the records handed to it, one
    launch of K4-xp each (``index_walk_xp_chunk``); then one max
    all-reduce of the window's int32 endpoints gives every process every
    endpoint, and every process packs the index.  The windows run through
    ``run_walk_chunks`` (each process's ``checkpoint_dir`` its own; on
    resume a min all-reduce agrees on the windows every process has
    whole, and only those are skipped), drawing K4's Philox stream on the
    CPU as on a card.  ``log``, where given,
    gets the placed slices (``shards``, ``slice_edges``), per window its
    walks, rounds, the records this process sent and received per round
    and its launches of each form (``windows``, ``rounds``, ``sent``,
    ``received``, ``forms``: [own-start, inbox]), and the split of the
    wall (``split_s``: host seconds of placing the graph and each
    window's starts, the launches, the counts' all-gather and host read,
    the all-to-all, the endpoints' all-reduce and the pack, each part
    ended by a device synchronise; ``walk_device_ms``: the launches' CUDA
    events on a card)."""
    comm, local = mesh.comm, list(mesh.local)
    G, L, shard0 = len(mesh), len(mesh.local), mesh.local[0]
    devices = [torch.device(mesh[s]) for s in local]
    dev = devices[0]
    if any(d != dev for d in devices):
        raise ValueError(f"build across processes: process {comm.rank}'s "
                         f"shards lie on {devices}; K4-xp walks a "
                         "process's slices on one device")
    timers, clock = Timers(), StageClock(dev if log is not None else None)
    fence = torch.empty(0, device=dev)

    def part(name):
        if log is None:
            return contextlib.nullcontext()
        return timers.phase(name, block_on=fence)
    with part("place"):
        csr = shard_out_csr(g, devices, n_shards=G, local=local)
        deg, counts, total, starts = _walks(g, rcfg, max_per_node)
        cum = np.concatenate([[0], np.cumsum(counts)])
    row0, row1 = shard0 * csr.n_loc, (shard0 + L) * csr.n_loc
    exchange = process_exchange(comm, part)
    if log is not None:
        log.update(shards=local, slice_edges=[int(x.numel())
                                              for x in csr.indices],
                   windows=[], rounds=[], sent=[], received=[], forms=[])
    forms = (kernels.index_walk_xp, kernels.index_walk_xp_inbox)

    def window(wlo, whi, out):
        a, b = own_run(cum, wlo, whi - wlo, row0, row1)
        with part("place"):
            own = torch.from_numpy(starts[wlo + a:wlo + b]).to(dev)
            ends = torch.full((whi - wlo,), -1, dtype=torch.int32,
                              device=dev)
        before = [f.launches for f in forms]

        def launch(_, r, inbox, outbox, cnt):
            with part("walk"), clock.stage("walk"):
                index_walk_xp_chunk(csr, own if r == 0 else own[:0],
                                    wlo + a, wlo, chunk_lanes, shard0, G,
                                    seed, rcfg.alpha, rcfg.max_walk_hops,
                                    inbox, outbox, cnt, ends)
        ms = xp_chunk_rounds(launch, exchange, {comm.rank: b - a},
                             comm.size, dev, words=1)
        with part("all_reduce"):
            out.copy_(comm.all_reduce(ends, op="max"))
        if log is not None:
            log["windows"].append([wlo, whi])
            log["rounds"].append(len(ms))
            log["sent"].append([int(m[comm.rank].sum()) for m in ms])
            log["received"].append([int(m[:, comm.rank].sum()) for m in ms])
            log["forms"].append([f.launches - n
                                 for f, n in zip(forms, before)])

    def agree(have):
        # a window is skipped only where every process has it whole: min
        # over the processes, as a max of the negated flags
        x = torch.tensor([-int(h) for h in have], dtype=torch.int64)
        return [v < 0 for v in comm.all_reduce(x, op="max").tolist()]
    endpoints = run_walk_chunks(
        window, counts, total, seed, chunk_lanes=chunk_lanes, device=dev,
        stream=PHILOX_STREAM, fingerprint=lambda: build_fingerprint(g, rcfg),
        checkpoint_dir=checkpoint_dir, progress=progress,
        windows=schedule.build_windows(total, chunk_lanes), agree=agree)
    with part("pack"):
        idx = pack_index(endpoints, counts, deg, rcfg, free_endpoints=True)
    if log is not None:
        log["split_s"] = timers.as_dict()
        log["walk_device_ms"] = clock.ms().get("walk", 0.0) \
            if dev.type == "cuda" else None
    return idx


def sharded_build_bytes(g, n_shards: int) -> dict:
    """Per-shard bytes of the sharded build's out-CSR slices against the
    replicated out-CSR (the memory wall), as the JAX package counts
    them."""
    n_loc, indptr_loc, indices_loc, deg_loc, ap, ao = _shard_csr(g, n_shards)
    per_shard = (indptr_loc.nbytes + indices_loc.nbytes + deg_loc.nbytes)
    if ap is not None:
        per_shard += ap.nbytes + ao.nbytes
    per_shard //= n_shards
    full = (g.out_indptr.nbytes + g.out_indices.nbytes + g.out_deg.nbytes)
    if g.weighted:
        full += 2 * g.out_indices.nbytes
    return {"per_shard_bytes": per_shard, "replicated_bytes": full,
            "ratio": per_shard / max(full, 1)}
