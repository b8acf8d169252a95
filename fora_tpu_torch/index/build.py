"""FORA+ walk index: counts, the chunk loop with its checkpoints, and the
pack.

Port of ``fora_tpu/index/build.py`` (60-136, 138-456) without JAX, whose
module imports ``jax`` at load time.  The layout is the same: every pool
entry (v -> walk endpoint) is an index edge, edges are split into
NUM_BUCKETS prefix buckets and sorted by (bucket, endpoint, source), and
``counts_cum[v, q]`` counts v's pool entries visible at depth q.  Because
each bucket is endpoint-sorted, it is a CSR by endpoint: ``dst_indptr[q]``
holds its [n+1] row pointers, which the index SpMV kernel (K2) walks.

Every builder runs :func:`run_walk_chunks`: the walks in chunks into one
endpoint buffer on the walks' device, each finished chunk saved to a
checkpoint directory where one is given (a resumed build is bit-identical
to an uninterrupted one), then :func:`pack_index`: on a card the three
kernels of K7 (``kernels/csrc/pack.cu``, the port of the JAX package's
``_native/radix_sort.cpp``; its merge also counts each bucket's row
pointers), elsewhere their plain versions (:func:`pack_index_plain`), and
the copy of the packed arrays and pointers to the host.

Index arrays stay on the host (numpy, or mmap views after
``store.load``); ``algo.fora.StagedForaPrograms`` moves one bucket at a
time to the device.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import json
import math
import time
from pathlib import Path
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..config import ResolvedConfig
from ..graph.csr import DeviceGraph
from ..ops.walk import walk_endpoints

NUM_BUCKETS = 8          # prefix fractions 4^0 .. 4^-(NUM_BUCKETS-1)
BUCKET_BASE = 4
PIPELINE_DEPTH = 2       # windows launched ahead of a checkpoint's write

# The random stream a build's chunk i draws, named in a checkpoint's
# manifest: a chunk may resume only a build whose chunk i draws exactly
# what it drew.  K4 and K4-xp draw Philox-4x32-10 from seed + i * 2^32 on
# a card, and the build across processes draws the same words on the CPU;
# the one-process CPU build walks with a torch.Generator.  (The JAX
# package's builds name their threefry stream "scheduled-v1".)
PHILOX_STREAM = "philox4x32-10-k4-v1"
GENERATOR_STREAM = "torch-generator-v1"
# device bytes a key of K7 may take: the keys and their ping-pong buffer
# (16), and at most one unique edge's src, dst and mult (12)
PACK_BYTES_PER_KEY = 28
# the pack's arrays come back to pinned host memory, not pageable (.cpu()):
# as fast at the pinned blocks' first use, and 30x faster once PyTorch's
# pinned cache holds them (a later build in the process; chip_smoke.py's
# phase 8 times both)
PINNED_COPY_BACK = True


class WalkIndex(NamedTuple):
    """Multi-resolution endpoint index (host arrays).

    Depth q serves queries whose rmax * omega_unit is at most
    4^-q of the built one; they read buckets q..NUM_BUCKETS-1 and weight
    each edge by mult / counts_cum[src, q].
    """

    edge_src: np.ndarray          # [E] i32
    edge_dst: np.ndarray          # [E] i32, endpoint-sorted per bucket
    bucket_offsets: np.ndarray    # [NUM_BUCKETS+1] i64
    counts_cum: np.ndarray        # [n, NUM_BUCKETS] i32
    omega_unit_built: float
    rmax_built: float
    edge_mult: Optional[np.ndarray] = None   # [E] f32 multiplicity
    dst_indptr: Optional[Tuple] = None       # per bucket [n+1] i32, or None

    @property
    def total_edges(self) -> int:
        return int(self.edge_src.shape[0])

    @property
    def n(self) -> int:
        return int(self.counts_cum.shape[0])

    def depth_for(self, omega_unit_query: float,
                  rmax_query: Optional[float] = None) -> int:
        """Deepest bucket depth whose prefix still covers the query's
        per-node demand, which scales with rmax * omega_unit (see
        fora_tpu.index.build.WalkIndex.depth_for)."""
        ratio = omega_unit_query / self.omega_unit_built
        if rmax_query is not None:
            ratio *= rmax_query / self.rmax_built
        if ratio > 1.0 + 1e-9:
            raise ValueError(
                f"index too coarse: built rmax*omega_unit covers "
                f"{self.rmax_built * self.omega_unit_built:.3g} < query "
                f"demand ratio {ratio:.3g}x")
        q = int(-math.log(max(ratio, 1e-300)) // math.log(BUCKET_BASE))
        return min(max(q, 0), NUM_BUCKETS - 1)

    def edges_at_depth(self, q: int):
        """(src, dst, mult-or-None) of buckets q..deepest (contiguous)."""
        lo = int(self.bucket_offsets[q])
        mult = self.edge_mult[lo:] if self.edge_mult is not None else None
        return self.edge_src[lo:], self.edge_dst[lo:], mult


def with_indptr(index: WalkIndex) -> WalkIndex:
    """``index`` with each bucket's [n+1] row pointers by endpoint (None
    for an empty bucket): ``graph.csr.dst_indptr``'s pointers, counted by
    one bincount and a running sum (its searchsorted of n + 1 nodes in
    each bucket took 0.21-0.26 s of bench.py's 0.5 s build on the card's
    host)."""
    ptrs = []
    for q in range(NUM_BUCKETS):
        lo = int(index.bucket_offsets[q])
        hi = int(index.bucket_offsets[q + 1])
        ptrs.append(_endpoint_indptr(index.edge_dst[lo:hi], index.n)
                    if hi > lo else None)
    return index._replace(dst_indptr=tuple(ptrs))


def _endpoint_indptr(dst: np.ndarray, n: int) -> np.ndarray:
    """[n+1] int32: ptr[v] = the endpoints below v of ``dst`` (each in 0 ..
    n - 1), which for an endpoint-sorted bucket is ``dst_indptr(dst,
    n)``."""
    ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(np.asarray(dst), minlength=n)[:n], out=ptr[1:])
    return ptr.astype(np.int32)


def index_counts(out_deg: np.ndarray, rcfg: ResolvedConfig,
                 max_per_node: Optional[int] = None) -> np.ndarray:
    """K_v = ceil(rmax * deg_v * omega_unit) + 1 walks per node (0 for
    dangling nodes, served by an analytic self-edge), at most
    ``max_per_node``."""
    deg = np.asarray(out_deg, dtype=np.float64)
    k = np.ceil(rcfg.rmax * deg * rcfg.omega_unit).astype(np.int64) + 1
    k[deg == 0] = 0
    if max_per_node is not None:
        k = np.minimum(k, max_per_node)
    return k


def index_walks(out_deg: np.ndarray, rcfg: ResolvedConfig,
                max_per_node: Optional[int] = None) -> tuple:
    """(counts, total) of an index build's walks; refuses an index whose
    ids would pass int32, as the JAX builders do."""
    counts = index_counts(out_deg, rcfg, max_per_node)
    total = int(counts.sum())
    if total + len(counts) >= 2**31:
        raise ValueError(f"walk index ({total} endpoints) exceeds int32 "
                         "range; shard the graph rows first or cap "
                         "max_per_node")
    return counts, total


def walk_stream(device) -> str:
    """The random stream an index build's chunks draw on ``device``:
    K4's Philox words on a card, a torch.Generator's on the CPU."""
    return (PHILOX_STREAM if torch.device(device).type == "cuda"
            else GENERATOR_STREAM)


def build_fingerprint(graph, rcfg: ResolvedConfig) -> dict:
    """What a checkpoint's manifest holds of the graph and config: alpha,
    the walks' hop cap and the graph's content hash."""
    from .store import graph_fingerprint
    return {"alpha": rcfg.alpha, "max_hops": rcfg.max_walk_hops,
            "graph_sha": graph_fingerprint(graph)}


def _open_checkpoint(checkpoint_dir: str, manifest: dict) -> Path:
    """The checkpoint directory, its manifest written, or checked against
    ``manifest`` where one exists (ValueError if it differs)."""
    ckpt = Path(checkpoint_dir)
    ckpt.mkdir(parents=True, exist_ok=True)
    mf = ckpt / "manifest.json"
    if mf.exists():
        if json.loads(mf.read_text()) != manifest:
            raise ValueError(
                f"index-build checkpoint at {ckpt} belongs to a different "
                "graph/config/seed/chunking or random stream; remove it or "
                "point checkpoint_dir elsewhere")
    else:
        tmp = ckpt / ".manifest.json.tmp"
        tmp.write_text(json.dumps(manifest))
        tmp.rename(mf)
    return ckpt


def _load_chunk(path: Path, size: int) -> np.ndarray:
    a = np.load(path)
    if a.dtype != np.int32 or a.shape != (size,):
        raise ValueError(f"index-build checkpoint chunk {path} holds "
                         f"{a.dtype} {a.shape}, expected int32 ({size},)")
    return a


def run_walk_chunks(walk: Callable, counts: np.ndarray, total: int,
                    seed: int, *, chunk_lanes: int, device, stream: str,
                    fingerprint: Callable[[], dict],
                    checkpoint_dir: Optional[str] = None, progress=None,
                    windows: Optional[list] = None,
                    agree: Optional[Callable] = None) -> torch.Tensor:
    """The chunk loop every index builder runs, as
    ``fora_tpu.index.build.run_walk_chunks``: ``walk(lo, hi, out)`` writes
    the endpoints of walks lo .. hi - 1 (whole chunks of ``chunk_lanes``;
    chunk i draws from ``seed + i * 2^32``) into ``out``, its slice of one
    [total] int32 buffer on ``device``, which is returned.  ``windows``
    (default: each chunk alone) are the (lo, hi) spans ``walk`` takes.

    ``checkpoint_dir``: every finished chunk's endpoints go to
    ``chunk_{i:06d}.npy`` (written to a temporary file and renamed), and
    the chunks found there are loaded and not walked again, so an
    interrupted build resumes where it stopped.  A manifest refuses
    (ValueError) a directory of another graph, config, seed, chunking or
    random stream (``stream``: :data:`PHILOX_STREAM` or
    :data:`GENERATOR_STREAM`; ``fingerprint()`` gives alpha, the hop cap
    and the graph's hash), so a checkpoint of the JAX package is refused
    and the JAX package refuses one of the port.  On a card a window's
    endpoints go to pinned host memory on a side stream, and its files are
    written while the next window walks (``PIPELINE_DEPTH``); without a
    checkpoint no endpoint leaves the device.  On an exception the windows
    already launched are saved and the exception is raised again.

    ``agree(have)``: across processes, the windows every process has
    whole (a list of bools in, the agreed list out), so that every process
    walks the same windows.  ``progress(i, n_chunks, cached)`` after each
    chunk (on saving it where checkpointing)."""
    dev = torch.device(device)
    chunk = chunk_lanes
    n_chunks = -(-total // chunk)
    if windows is None:
        windows = [(lo, min(lo + chunk, total))
                   for lo in range(0, total, chunk)]
    ends = torch.empty(total, dtype=torch.int32, device=dev)
    ckpt = None
    if checkpoint_dir is not None:
        manifest = dict(fingerprint())
        manifest.update({
            "counts_sha": hashlib.sha1(np.ascontiguousarray(
                counts, dtype=np.int64).tobytes()).hexdigest(),
            "seed": int(seed), "chunk": chunk, "total": total,
            "n": int(len(counts)), "kernel": stream})
        ckpt = _open_checkpoint(checkpoint_dir, manifest)

    def chunks(lo, hi):
        return range(lo // chunk, -(-hi // chunk))

    def path(i):
        return ckpt / f"chunk_{i:06d}.npy"

    have = [ckpt is not None and all(path(i).exists() for i in chunks(*w))
            for w in windows]
    if agree is not None and windows:
        have = agree(have)
    card = dev.type == "cuda"
    side = torch.cuda.Stream(dev) if card and ckpt is not None else None
    widest = max((hi - lo for lo, hi in windows), default=0)
    pinned = [None] * PIPELINE_DEPTH
    inflight = collections.deque()

    def drain():
        lo, hi, host, event = inflight.popleft()
        if event is not None:
            event.synchronize()
        arr = host.numpy()
        for i in chunks(lo, hi):
            tmp = ckpt / f".chunk_{i:06d}.npy.tmp"
            with open(tmp, "wb") as fh:    # np.save(path) would add .npy
                np.save(fh, arr[i * chunk - lo:min((i + 1) * chunk, hi) - lo])
            tmp.rename(path(i))
            if progress is not None:
                progress(i, n_chunks, False)

    try:
        for w, (lo, hi) in enumerate(windows):
            out = ends[lo:hi]
            if have[w]:
                for i in chunks(lo, hi):
                    a, b = i * chunk, min((i + 1) * chunk, hi)
                    out[a - lo:b - lo].copy_(torch.from_numpy(
                        _load_chunk(path(i), b - a)))
                    if progress is not None:
                        progress(i, n_chunks, True)
                continue
            walk(lo, hi, out)
            if ckpt is None:
                if progress is not None:
                    for i in chunks(lo, hi):
                        progress(i, n_chunks, False)
                continue
            event = None
            if card:
                k = w % PIPELINE_DEPTH
                if pinned[k] is None:
                    pinned[k] = torch.empty(widest, dtype=torch.int32,
                                            pin_memory=True)
                host = pinned[k][:hi - lo]
                side.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(side):
                    host.copy_(out, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record(side)
            else:
                host = out
            inflight.append((lo, hi, host, event))
            if len(inflight) >= PIPELINE_DEPTH:
                drain()
        while inflight:
            drain()
    except BaseException:
        # a preempted build: save what was already launched, so that the
        # resumed build skips it (nothing to save without a checkpoint)
        if ckpt is not None:
            try:
                while inflight:
                    drain()
            except Exception:
                pass
        raise
    return ends


def build_walk_index(graph: DeviceGraph, rcfg: ResolvedConfig, seed: int,
                     *, max_per_node: Optional[int] = None,
                     chunk_lanes: int = 1 << 23,
                     checkpoint_dir: Optional[str] = None, progress=None,
                     log: Optional[dict] = None) -> WalkIndex:
    """Run every index walk on the graph's device, ``chunk_lanes`` walks
    per launch (chunk i from seed ``seed + i * 2^32``), through
    :func:`run_walk_chunks` (crash-resume with ``checkpoint_dir``), then
    :func:`pack_index` on the same device.  ``log``, where given, gets the
    wall's split (``split_s``: the walks, then the pack's parts), each
    part ended by a device synchronise."""
    with _splitter(log, graph.device)("walk"):
        ends, counts, deg = index_endpoints(
            graph, graph, rcfg, seed, graph.device, max_per_node=max_per_node,
            chunk_lanes=chunk_lanes, checkpoint_dir=checkpoint_dir,
            progress=progress)
    return pack_index(ends, counts, deg, rcfg, log=log, free_endpoints=True)


def index_endpoints(walk_graph, graph, rcfg: ResolvedConfig, seed: int,
                    device, *, max_per_node: Optional[int] = None,
                    chunk_lanes: int = 1 << 23,
                    checkpoint_dir: Optional[str] = None,
                    progress=None) -> tuple:
    """The walks of an index build in one process: (endpoints [total]
    int32 on ``device``, counts, out-degrees).  ``walk_graph`` is what
    ``ops.walk.walk_endpoints`` walks on ``device`` (a DeviceGraph, or the
    out-CSR's shard slices), ``graph`` the graph it holds (its degrees and
    fingerprint); chunk i of ``chunk_lanes`` walks draws from ``seed + i *
    2^32``, through :func:`run_walk_chunks`."""
    deg = np.asarray(graph.out_deg.cpu() if isinstance(
        graph.out_deg, torch.Tensor) else graph.out_deg)
    counts, total = index_walks(deg, rcfg, max_per_node)
    starts = np.repeat(np.arange(graph.n, dtype=np.int32), counts)
    dev = torch.device(device)

    def walk(lo, hi, out):
        s = torch.from_numpy(starts[lo:hi]).to(dev)
        walk_endpoints(walk_graph, s, seed + ((lo // chunk_lanes) << 32),
                       rcfg.alpha, rcfg.max_walk_hops, out=out)
    ends = run_walk_chunks(
        walk, counts, total, seed, chunk_lanes=chunk_lanes, device=dev,
        stream=walk_stream(dev),
        fingerprint=lambda: build_fingerprint(graph, rcfg),
        checkpoint_dir=checkpoint_dir, progress=progress)
    return ends, counts, deg


def _splitter(log: Optional[dict], dev):
    """``part(name)``: a context that adds its host seconds, ended by a
    synchronise of ``dev``, to ``log["split_s"][name]`` (nothing without
    a log)."""
    if log is None:
        return lambda name: contextlib.nullcontext()
    split = log.setdefault("split_s", {})
    dev = torch.device(dev)

    @contextlib.contextmanager
    def part(name):
        t0 = time.perf_counter()
        yield
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        split[name] = split.get(name, 0.0) + time.perf_counter() - t0
    return part


def _merge_bucket_duplicates(src: np.ndarray, dst: np.ndarray,
                             bucket: np.ndarray):
    """Merge identical (src, dst) pairs within a bucket into one edge with
    a multiplicity; output is (bucket, dst, src)-sorted.  Returns (src,
    dst, bucket, mult)."""
    if len(src) == 0:
        return src, dst, bucket, np.ones(0, np.float32)
    order = np.lexsort((src, dst, bucket))
    src, dst, bucket = src[order], dst[order], bucket[order]
    first = np.empty(len(src), dtype=bool)
    first[0] = True
    first[1:] = ((src[1:] != src[:-1]) | (dst[1:] != dst[:-1])
                 | (bucket[1:] != bucket[:-1]))
    group = np.cumsum(first) - 1
    mult = np.bincount(group).astype(np.float32)
    return src[first], dst[first], bucket[first], mult


def _offsets(bucket: np.ndarray) -> np.ndarray:
    sizes = np.bincount(bucket, minlength=NUM_BUCKETS)
    off = np.zeros(NUM_BUCKETS + 1, dtype=np.int64)
    np.cumsum(sizes, out=off[1:])
    return off


def dedup_index(index: WalkIndex) -> WalkIndex:
    """Upgrade an unmerged index to the multiplicity-merged layout
    (lossless; counts_cum unchanged)."""
    if index.edge_mult is not None:
        return index
    src = np.asarray(index.edge_src, dtype=np.int64)
    dst = np.asarray(index.edge_dst, dtype=np.int64)
    boff = np.asarray(index.bucket_offsets, dtype=np.int64)
    bucket = np.repeat(np.arange(NUM_BUCKETS, dtype=np.int8), np.diff(boff))
    src, dst, bucket, mult = _merge_bucket_duplicates(src, dst, bucket)
    return with_indptr(index._replace(
        edge_src=src.astype(np.int32), edge_dst=dst.astype(np.int32),
        bucket_offsets=_offsets(bucket), edge_mult=mult))


def _bucket_per_entry(counts, offsets, cut, total, src32):
    """Per-entry bucket: entries of a node are j-ascending, so the bucket
    starts at NUM_BUCKETS-1 and drops by one at each within-node cutoff."""
    if not total:
        return np.empty(0, np.int64)
    pos = [offsets[sel] + cut[sel, q]
           for q in range(1, NUM_BUCKETS)
           for sel in (cut[:, q] < counts,)]
    dec = np.bincount(np.concatenate(pos) if pos else
                      np.empty(0, np.int64), minlength=total)
    dinc = np.cumsum(dec, dtype=np.int64)
    off_c = np.minimum(offsets, total - 1)
    base = dinc[off_c] - dec[off_c]
    return (NUM_BUCKETS - 1) - (dinc - base[src32])


class PackTables(NamedTuple):
    """The host tables of a pack (``pack_tables``)."""
    counts: np.ndarray        # [n] int64, K_v
    offsets: np.ndarray       # [n] int64, node v's first entry
    cut: np.ndarray           # [n, NUM_BUCKETS] int64, ceil(K_v 4^-q)
    counts_cum: np.ndarray    # [n, NUM_BUCKETS] int32
    dang: np.ndarray          # [nd] int64, the dangling nodes
    nb: int                   # bits of a node id in a packed key
    total: int                # pool entries

    @property
    def keys(self) -> int:
        """Keys of the packed branch: every entry and a self-edge a
        dangling node."""
        return self.total + len(self.dang)


def pack_tables(counts: np.ndarray, out_deg: np.ndarray) -> PackTables:
    """The host tables every branch of the pack reads.  cut[v, q] =
    ceil(K_v * 4^-q): entry j of v is in bucket #{q >= 1 : j < cut[v, q]},
    and counts_cum is the cutoff table itself (+1 at every depth for a
    dangling node's self-edge)."""
    counts = np.asarray(counts, dtype=np.int64)
    n = counts.shape[0]
    offsets = np.zeros(n, dtype=np.int64)
    np.cumsum(counts[:-1], out=offsets[1:])
    dang = np.nonzero(np.asarray(out_deg) == 0)[0].astype(np.int64)
    cut = np.ceil(counts[:, None].astype(np.float64)
                  * float(BUCKET_BASE) ** -np.arange(NUM_BUCKETS,
                                                     dtype=np.float64)
                  ).astype(np.int64)
    cut[:, 0] = counts
    counts_cum = cut.astype(np.int32)
    if len(dang):
        counts_cum[dang] += 1
    return PackTables(counts, offsets, np.ascontiguousarray(cut),
                      np.ascontiguousarray(counts_cum), dang,
                      max(int(n - 1).bit_length(), 1), int(counts.sum()))


def pack_keys_plain(ends: torch.Tensor, offsets: torch.Tensor,
                    cut: torch.Tensor, dang: torch.Tensor,
                    nb: int) -> torch.Tensor:
    """K7-keys' plain version: int64 [total + nd], entry j of node v
    keyed ``bucket << 2 nb | endpoint << nb | v`` (bucket the number of
    ``cut[v, 1:]`` above j), then the dangling nodes' self-edges in the
    deepest bucket (``kernels.pack_keys``)."""
    dev = ends.device
    n = cut.shape[0]
    src = torch.repeat_interleave(torch.arange(n, device=dev), cut[:, 0],
                                  output_size=ends.shape[0])
    j = torch.arange(ends.shape[0], device=dev) - offsets[src]
    bucket = torch.zeros_like(j)
    for q in range(1, NUM_BUCKETS):
        bucket += j < cut[src, q]
    keys = (bucket << (2 * nb)) | (ends.long() << nb) | src
    deep = ((NUM_BUCKETS - 1) << (2 * nb)) | (dang << nb) | dang
    return torch.cat([keys, deep])


def sort_keys_plain(keys: torch.Tensor) -> torch.Tensor:
    """K7-sort's plain version: the keys ascending (``kernels.sort_keys``;
    equal keys are equal, so stability does not show)."""
    return torch.sort(keys).values


def merge_keys_plain(keys: torch.Tensor, nb: int, n: int) -> tuple:
    """K7-merge's plain version on sorted keys of ``nb``-bit ids of ``n``
    nodes: (edge_src, edge_dst int32, edge_mult float32, bucket_counts
    [NUM_BUCKETS] int64, indptr [NUM_BUCKETS, n + 1] int32) of the unique
    keys unpacked, each one's run length its multiplicity, and each
    bucket's row pointers by endpoint (``_endpoint_indptr`` of its
    endpoints; an empty bucket's zeros), counted by one bincount of
    ``bucket * (n + 1) + endpoint + 1`` and a running sum a row
    (``kernels.merge_keys``)."""
    u, cnt = torch.unique_consecutive(keys, return_counts=True)
    mask = (1 << nb) - 1
    bucket, dst = u >> (2 * nb), (u >> nb) & mask
    counts = torch.bincount(bucket * (n + 1) + dst + 1,
                            minlength=NUM_BUCKETS * (n + 1))
    return ((u & mask).int(), dst.int(), cnt.float(),
            torch.bincount(bucket, minlength=NUM_BUCKETS),
            counts.view(NUM_BUCKETS, n + 1).cumsum(1).int())


def _device_tables(t: PackTables, dev) -> tuple:
    """The plain version's tables on ``dev``: offsets [n], cut, dang."""
    return tuple(torch.from_numpy(a).to(dev)
                 for a in (t.offsets, t.cut, t.dang))


def _card_tables(t: PackTables, dev) -> tuple:
    """K7-keys' tables on ``dev``: offsets [n + 1] (the last = total) and
    dang; the kernel forms the cutoffs from the offsets."""
    offsets = np.empty(len(t.counts) + 1, dtype=np.int64)
    offsets[:-1] = t.offsets
    offsets[-1] = t.total
    return torch.from_numpy(offsets).to(dev), torch.from_numpy(t.dang).to(dev)


def pack_bytes(t: PackTables, keys: Optional[int] = None,
               windowed: bool = False) -> int:
    """Device bytes K7 may need beside the endpoints to pack ``keys`` keys
    (default all of ``t``'s) in one sort: PACK_BYTES_PER_KEY a key, K7-
    sort's scratch (digit totals, ticket, status words) and K7-merge's
    (ticket, status words, bucket offsets, each pointer tile's first rank),
    the buckets' row pointers (NUM_BUCKETS (n + 1) int32), K7-keys' tables
    (offsets [n + 1] and the dangling nodes, int64) and the digit counts it
    hands K7-sort; ``windowed``, a window of a pack in key-range windows,
    also the windows' running sum of the pointers, the count form's bins
    and the window form's cursor.  Raises ValueError for more keys than
    K7-sort's counts hold."""
    L = t.keys if keys is None else keys
    n1 = len(t.counts) + 1
    bits = 2 * t.nb + 4
    digits = kernels.sort_digit_bits(bits)
    return (PACK_BYTES_PER_KEY * L + 4 * kernels.sort_scratch_words(L, digits)
            + 4 * kernels.merge_scratch_words(L, n1 - 1)
            + 4 * NUM_BUCKETS * n1 + 8 * n1 + t.dang.nbytes
            + 4 * (-(-bits // digits) << digits)
            + (4 * NUM_BUCKETS * n1 + 4 * kernels.KEY_COUNT_BINS + 4
               if windowed else 0))


def free_bytes(dev) -> int:
    """What ``dev`` has free for the pack: what CUDA reports free, and what
    the caching allocator holds unused."""
    return torch.cuda.mem_get_info(dev)[0] + (
        torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev))


def window_cap(t: PackTables, free: int) -> Optional[int]:
    """None where K7 packs ``t`` in one sort, as it always did: its keys
    within K7-sort's ``kernels.SORT_MAX_KEYS`` (read at each call) and
    ``pack_bytes(t)`` within ``free``.  Else the most keys a key-range
    window may hold: at most SORT_MAX_KEYS, and as many as ``pack_bytes(t,
    L, windowed=True)`` lets within ``free``.  Refuses
    (torch.OutOfMemoryError) only where a window of one key does not fit."""
    most = kernels.SORT_MAX_KEYS
    if t.keys <= most and pack_bytes(t) <= free:
        return None
    need = pack_bytes(t, 1, windowed=True)
    if need > free:
        raise torch.OutOfMemoryError(
            f"the index pack needs {need} bytes for its smallest window "
            f"(the scratch, the tables and the row pointers); {free} are "
            "free")
    lo, hi = 1, most
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if pack_bytes(t, mid, windowed=True) <= free:
            lo = mid
        else:
            hi = mid - 1
    return lo


def plan_windows(count: Callable, nb: int, cap: int) -> list:
    """Key-range windows [(lo, hi, keys)] of a pack of keys of ``nb``-bit
    ids, in key order, covering [0, 2^(2 nb + 4)), each of at most ``cap``
    keys: greedy runs of the count form's bins over the keys' top
    KEY_COUNT_BINS bits (``count(lo, hi, shift)``: the keys in [lo, hi) by
    (k - lo) >> shift, numpy), a bin over the cap split by a count over its
    next bits.  A key value held more than ``cap`` times cannot be split:
    ValueError, naming its node."""
    per = kernels.KEY_COUNT_BINS.bit_length() - 1
    bits = 2 * nb + 4
    mask = (1 << nb) - 1
    units = []

    def split(lo, hi, shift):
        for b, k in enumerate(count(lo, hi, shift).tolist()):
            a = lo + (b << shift)
            if k <= cap:
                units.append((a, k))
            elif shift == 0:
                raise ValueError(
                    f"index pack: node {a & mask}'s pool holds endpoint "
                    f"{(a >> nb) & mask} {k} times in bucket {a >> (2 * nb)}, "
                    f"more than a window of {cap} keys")
            else:
                split(a, a + (1 << shift), max(shift - per, 0))
    split(0, 1 << bits, max(bits - per, 0))
    windows, lo, got = [], 0, 0
    for a, k in units:
        if got + k > cap:
            windows.append((lo, a, got))
            lo, got = a, 0
        got += k
    windows.append((lo, 1 << bits, got))
    return windows


def pack_key_counts_plain(keys: torch.Tensor, lo: int, hi: int,
                          shift: int) -> torch.Tensor:
    """K7-keys' count form's plain version over ``pack_keys_plain``'s keys:
    the keys in [lo, hi) counted by bin (k - lo) >> shift
    (``kernels.pack_key_counts``)."""
    sel = keys[(keys >= lo) & (keys < hi)]
    return torch.bincount((sel - lo) >> shift,
                          minlength=-(-(hi - lo) >> shift)).int()


def pack_keys_window_plain(keys: torch.Tensor, lo: int,
                           hi: int) -> torch.Tensor:
    """K7-keys' window form's plain version over ``pack_keys_plain``'s
    keys: those in [lo, hi), in pool order (``kernels.pack_keys_window``
    gives them in no order)."""
    return keys[(keys >= lo) & (keys < hi)]


def _card_windows(ends: torch.Tensor, t: PackTables,
                  free_endpoints: bool) -> tuple:
    """K7's (count, pack) of a pack in windows on ``ends``' card: the count
    form, and a window's K7 (the window form with the sort's digit counts,
    the sort, the merge), the endpoints and tables freed once the last
    window's keys are written (with ``free_endpoints``)."""
    dev = ends.device
    bits = 2 * t.nb + 4
    tables = list(_card_tables(t, dev))

    def count(lo, hi, shift):
        return kernels.pack_key_counts(ends, *tables, t.nb, lo, hi,
                                       shift).cpu().numpy()

    def pack(lo, hi, length, last, part):
        with part("keys"):
            totals = kernels.digit_totals(bits, dev)
            keys = kernels.pack_keys_window(ends, *tables, t.nb, lo, hi,
                                            length, totals=totals)
            if last:
                tables.clear()
                if free_endpoints:
                    ends.set_()
        with part("sort"):
            alt = torch.empty_like(keys)
            keys = kernels.sort_keys(keys, alt, bits, totals=totals)
            del alt, totals
        with part("merge"):
            return kernels.merge_keys(keys, t.nb, len(t.counts))
    return count, pack


def _plain_windows(ends: torch.Tensor, t: PackTables) -> tuple:
    """The plain chain's (count, pack) of a pack in windows: the keys of
    ``pack_keys_plain`` once, then each window filtered, sorted and
    merged by the plain versions."""
    keys = pack_keys_plain(ends, *_device_tables(t, ends.device), t.nb)

    def count(lo, hi, shift):
        return pack_key_counts_plain(keys, lo, hi, shift).cpu().numpy()

    def pack(lo, hi, length, last, part):
        with part("keys"):
            w = pack_keys_window_plain(keys, lo, hi)
        with part("sort"):
            w = sort_keys_plain(w)
        with part("merge"):
            return merge_keys_plain(w, t.nb, len(t.counts))
    return count, pack


def _pack_on_card(ends: torch.Tensor, t: PackTables, part,
                  free_endpoints: bool) -> tuple:
    """K7 on ``ends``' card in one sort: keys (with the sort's digit
    counts), sort, merge (``kernels.pack_keys``, ``sort_keys``,
    ``merge_keys``)."""
    dev = ends.device
    bits = 2 * t.nb + 4
    with part("keys"):
        offsets, dang = _card_tables(t, dev)
        totals = kernels.digit_totals(bits, dev)
        keys = kernels.pack_keys(ends, offsets, dang, t.nb, totals=totals)
        del offsets, dang
        if free_endpoints:
            ends.set_()
    with part("sort"):
        alt = torch.empty_like(keys)
        keys = kernels.sort_keys(keys, alt, bits, totals=totals)
        del alt, totals         # the spare buffer, freed before the merge
    with part("merge"):
        return kernels.merge_keys(keys, t.nb, len(t.counts))


def _pack_plain(ends: torch.Tensor, t: PackTables, part) -> tuple:
    with part("keys"):
        keys = pack_keys_plain(ends, *_device_tables(t, ends.device), t.nb)
    with part("sort"):
        keys = sort_keys_plain(keys)
    with part("merge"):
        return merge_keys_plain(keys, t.nb, len(t.counts))


def host_arrays(xs, pinned: bool = PINNED_COPY_BACK) -> list:
    """The tensors ``xs`` (all on one device) as numpy arrays: a card's
    copied into pinned host memory, the copies queued together and ended
    by one synchronise (``pinned``), or each by ``.cpu()`` into pageable
    memory; a CPU tensor's own memory."""
    if not xs or xs[0].device.type != "cuda" or not pinned:
        return [x.cpu().numpy() for x in xs]
    outs = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True) for x in xs]
    for o, x in zip(outs, xs):
        o.copy_(x, non_blocking=True)
    torch.cuda.current_stream(xs[0].device).synchronize()
    return [o.numpy() for o in outs]


def _index_from(t: PackTables, rcfg: ResolvedConfig, packed: tuple,
                part) -> WalkIndex:
    """The WalkIndex of a packed branch's (src, dst, mult, bucket_counts,
    indptr) on any device: the edge arrays copied to the host, then the
    buckets' row pointers."""
    with part("copy_back"):
        src, dst, mult, bc = host_arrays(packed[:4])
    with part("indptr"):
        (ptr,) = host_arrays(packed[4:])
    return _walk_index(t, rcfg, src, dst, mult, bc, ptr)


def _walk_index(t: PackTables, rcfg: ResolvedConfig, src, dst, mult, bc,
                ptr) -> WalkIndex:
    """The WalkIndex of the host arrays of a pack: its bucket sizes ``bc``
    and [NUM_BUCKETS, n + 1] row pointers ``ptr`` (an empty bucket's None,
    as ``with_indptr`` gives)."""
    off = np.zeros(NUM_BUCKETS + 1, dtype=np.int64)
    np.cumsum(bc, out=off[1:])
    return WalkIndex(
        edge_src=src, edge_dst=dst, bucket_offsets=off,
        counts_cum=t.counts_cum, omega_unit_built=rcfg.omega_unit,
        rmax_built=rcfg.rmax, edge_mult=mult,
        dst_indptr=tuple(ptr[q] if off[q + 1] > off[q] else None
                         for q in range(NUM_BUCKETS)))


# bytes of each of copy_to_host's two pinned staging buffers
COPY_STAGE = 1 << 28


def pinned_stage(nbytes: int) -> list:
    """``copy_to_host``'s two pinned staging buffers, of ``nbytes`` (at most
    COPY_STAGE) each, made once for all the copies of a pack."""
    return [torch.empty(max(min(nbytes, COPY_STAGE), 1), dtype=torch.uint8,
                        pin_memory=True) for _ in range(2)]


def copy_to_host(x: torch.Tensor, out: np.ndarray,
                 stage: Optional[list]) -> None:
    """The 1-D tensor ``x`` into the numpy array ``out``: from a card through
    the two pinned staging buffers ``stage`` (``pinned_stage``'s) in turns
    (a chunk's copy from the card runs while the host copies the chunk
    before), from the CPU directly."""
    if x.device.type != "cuda":
        out[...] = x.numpy()
        return
    n = x.shape[0]
    if n == 0:
        return
    dst = torch.from_numpy(out)
    step = stage[0].shape[0] // x.element_size()
    stream = torch.cuda.current_stream(x.device)
    pending = None
    for i, a in enumerate(range(0, n, step)):
        b = min(n, a + step)
        buf = stage[i % 2].view(x.dtype)[:b - a]
        buf.copy_(x[a:b], non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
        if pending is not None:
            pending[0].synchronize()
            dst[pending[1]:pending[2]].copy_(pending[3])
        pending = (done, a, b, buf)
    pending[0].synchronize()
    dst[pending[1]:pending[2]].copy_(pending[3])


def _pack_windows(t: PackTables, rcfg: ResolvedConfig, windows: list,
                  pack: Callable, part, dev) -> WalkIndex:
    """The pack in key-range windows (``plan_windows``'s, in key order):
    ``pack(lo, hi, keys, last, part)`` gives a window's merged (src, dst,
    mult, bucket_counts, indptr) on ``dev`` (K7 on a card, the plain chain
    on the CPU); its edge arrays go to the index's host arrays at the
    running offset, its bucket sizes and row pointers (on ``dev``) are
    added up.  A window is a contiguous slice of the index, so the result
    equals the pack in one sort.  The host arrays are made for every key
    and shrunk in place to the unique edges at the end."""
    L = sum(k for _, _, k in windows)
    src = np.empty(L, dtype=np.int32)
    dst = np.empty(L, dtype=np.int32)
    mult = np.empty(L, dtype=np.float32)
    stage = (pinned_stage(4 * L) if torch.device(dev).type == "cuda"
             else None)
    bc = np.zeros(NUM_BUCKETS, dtype=np.int64)
    ptr = torch.zeros((NUM_BUCKETS, len(t.counts) + 1), dtype=torch.int32,
                      device=dev)
    at = 0
    for i, (lo, hi, keys) in enumerate(windows):
        w = pack(lo, hi, keys, i == len(windows) - 1, part)
        with part("copy_back"):
            u = w[0].shape[0]
            for x, out in zip(w[:3], (src, dst, mult)):
                copy_to_host(x, out[at:at + u], stage)
            bc += w[3].cpu().numpy()
            ptr += w[4]
            at += u
        del w                   # the window's buffers, before the next's
    del stage
    for a in (src, dst, mult):
        # no view of the arrays is left: the copies' were dropped with them
        a.resize(at, refcheck=False)
    with part("indptr"):
        (host_ptr,) = host_arrays([ptr])
    return _walk_index(t, rcfg, src, dst, mult, bc, host_ptr)


def pack_index_plain(endpoints: torch.Tensor, counts: np.ndarray,
                     out_deg: np.ndarray, rcfg: ResolvedConfig,
                     log: Optional[dict] = None) -> WalkIndex:
    """The packed-key branch of ``fora_tpu.index.build.pack_index`` in
    PyTorch ops on ``endpoints``' device (any): keys by tensor arithmetic,
    ``torch.sort``, a run-length merge by ``unique_consecutive``.  K7's
    plain version; the CPU's pack."""
    t = pack_tables(counts, out_deg)
    if 2 * t.nb + 4 > 63:
        raise ValueError(f"pack_index_plain: {len(t.counts)} nodes do not "
                         "fit a 63-bit packed key")
    part = _splitter(log, endpoints.device)
    return _index_from(t, rcfg, _pack_plain(endpoints, t, part), part)


def pack_index(endpoints, counts: np.ndarray, out_deg: np.ndarray,
               rcfg: ResolvedConfig, dedup: bool = True, *,
               log: Optional[dict] = None,
               free_endpoints: bool = False) -> WalkIndex:
    """Pack raw pools into the bucketed layout, as
    ``fora_tpu.index.build.pack_index``.  ``endpoints`` ([total] int32, a
    tensor or a numpy array) in node order, ``counts[v]`` of them node
    v's.  The branches go by shape, as JAX's do: with ``dedup`` and keys
    of 2 nb + 4 <= 63 bits (about 2^29 nodes), the packed-key branch, on
    a card K7 (:func:`_pack_card`, in key-range windows past K7-sort's
    keys or the card's memory) and elsewhere :func:`pack_index_plain`;
    else the legacy lexsort branch on the host.  The branches give the
    same arrays: the sorted order of a multiset of keys, and its run-length
    merge, do not depend on the algorithm.  ``free_endpoints``: the pack
    may free ``endpoints``' storage once the keys are written (K7's
    memory).  ``log`` gets the split (``split_s``: plan the windows'
    counts, keys, sort, merge, copy_back of the edge arrays, indptr the
    copy of the buckets' row pointers, which the packed branch counts with
    the merge), ``windows``, their number (1 for one sort), and for
    windows ``window_keys``, the most keys a window could hold."""
    ends = (endpoints if isinstance(endpoints, torch.Tensor) else
            torch.from_numpy(np.ascontiguousarray(endpoints,
                                                  dtype=np.int32)))
    if ends.dtype != torch.int32:
        ends = ends.int()
    t = pack_tables(counts, out_deg)
    if not dedup or 2 * t.nb + 4 > 63:
        return _pack_legacy(ends.cpu().numpy(), t, rcfg, dedup)
    part = _splitter(log, ends.device)
    if log is not None:
        log["windows"] = 1
    if ends.device.type == "cuda":
        return _pack_card(ends, t, rcfg, part, free_endpoints, log)
    return _index_from(t, rcfg, _pack_plain(ends, t, part), part)


def _pack_card(ends: torch.Tensor, t: PackTables, rcfg: ResolvedConfig,
               part, free_endpoints: bool,
               log: Optional[dict]) -> WalkIndex:
    """K7 on ``ends``' card: in one sort (:func:`_pack_on_card`, today's
    launches) where ``window_cap`` allows, else in key-range windows; a
    pack whose smallest window does not fit is refused before any
    launch."""
    cap = window_cap(t, free_bytes(ends.device))
    if cap is None:
        return _index_from(t, rcfg, _pack_on_card(ends, t, part,
                                                  free_endpoints), part)
    return _pack_planned(t, rcfg, part, cap,
                         _card_windows(ends, t, free_endpoints), ends.device,
                         log)


def _pack_planned(t: PackTables, rcfg: ResolvedConfig, part, cap: int,
                  forms: tuple, dev, log: Optional[dict]) -> WalkIndex:
    """The windows of at most ``cap`` keys planned over ``forms``' counts,
    then packed by its window function."""
    count, pack = forms
    with part("plan"):
        windows = plan_windows(count, t.nb, cap)
    if log is not None:
        log.update(windows=len(windows), window_keys=cap)
    return _pack_windows(t, rcfg, windows, pack, part, dev)


def _pack_legacy(endpoints: np.ndarray, t: PackTables,
                 rcfg: ResolvedConfig, dedup: bool) -> WalkIndex:
    """JAX's legacy branch: a (bucket, dst) lexsort, the merge only with
    ``dedup``."""
    n = len(t.counts)
    nd = len(t.dang)
    src32 = np.repeat(np.arange(n, dtype=np.int32), t.counts)
    bucket = _bucket_per_entry(t.counts, t.offsets, t.cut, t.total, src32)
    src = np.concatenate([src32.astype(np.int64), t.dang])
    dst = np.concatenate([endpoints.astype(np.int64), t.dang])
    bucket = np.concatenate([bucket, np.full(nd, NUM_BUCKETS - 1)])
    order = np.lexsort((dst, bucket))
    src, dst, bucket = src[order], dst[order], bucket[order]
    mult = None
    if dedup:
        src, dst, bucket, mult = _merge_bucket_duplicates(src, dst, bucket)
    return with_indptr(WalkIndex(
        edge_src=np.asarray(src).astype(np.int32),
        edge_dst=np.asarray(dst).astype(np.int32),
        bucket_offsets=_offsets(bucket),
        counts_cum=t.counts_cum,
        omega_unit_built=rcfg.omega_unit,
        rmax_built=rcfg.rmax,
        edge_mult=mult,
    ))
