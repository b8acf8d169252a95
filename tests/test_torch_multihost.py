"""fora_tpu_torch's sharded one-shot across processes, on the CPU.

P localhost processes over gloo hold L shards each (G = P L = 4), started
through ``fora_tpu_torch.parallel.multihost_driver`` (one spawn of P
workers per world, each with OMP_NUM_THREADS=1, a free port, killed and
failed on its timeout; each ends its group with ``shutdown``).  Each world
runs the indexed one-shot on ``bench_data_smoke/rmat12x8s7`` with its
index, held against the one-process port engine and against JAX's
``ShardedForaEngine`` on 4 virtual CPU devices under
``test_torch_sharded.py``'s rule (ids where adjacent values differ by more
than 1e-7; values within rtol 1e-5 / atol 1e-7; equal supersteps); the
raw one-shot on the JAX package's own multi-process case
(``tests/multihost_driver.py``: ``erdos_renyi(300, 3000, seed=21)``, its 8
sources, k = 10), precision >= 0.85 against the exact top-10 and the
first walk chunk's endpoints ``torch.equal`` to the one-process sharded
chunk's (``raw_walk_chunk_plain``, and ``raw_walk_sharded_chunk`` with
K4's Philox walks, which the card's kernel is held to; on the CPU the
one-process chunk draws from a Generator); ``gather_to_host`` across the
processes; and the indexed one-shot from both sharded stores, each
process given only its own shards' files.  A world of one process holds
all four shards and answers bit for bit as the one-process engine.

The compacted exchanges and the refinement pool across processes, in the
same worlds: the indexed one-shot with ``compact``, ``routed`` and
``hier`` (``chips_per_host`` = L, a host is a process), and with a cap of
CAP_SMALL rows (more supersteps fall back), each bit-equal to the
world's dense one-shot with equal supersteps; ``ShardedTopkRunner`` (16
sources, ``query_pools(batch=8, defer_below=4)``: ``query_pool`` then
``flush_deferred``) with each exchange and the small cap, bit-equal to
the world's dense pool, which is held to the one-process port runner and
to JAX's ``ShardedTopkRunner`` on 4 virtual devices under
``test_torch_sharded_runner.py``'s rule; the hier one-shot against JAX's
hier engine (``chips_per_host`` = L); a query axis of 2 (one-shot and
pool) against the one-process port with 2 query groups and against JAX's
engine and runner on 8 virtual devices.  The index built across the
processes (the driver's "build" job: ``build_walk_index_sharded`` over
the world's ``ProcessMesh``, K4-xp's plain version on the CPU), on ER 300 /
3000 and on its weighted form, four chunks: on every rank array-equal to
the Philox one-process reference (``test_torch_build_sharded.
philox_index``), each rank placing only its own L out-CSR slices; the
indexed one-shot from the sharded store it wrote bit-equal to the one
from the reference's store.  In process:
``raw_walk_xp_plain`` with the processes simulated by a loop against
``raw_walk_chunk_plain``; ``build_walk_index_sharded`` over a
``ProcessMesh`` of P threads whose collectives go through a shared hub,
against the same reference; ``FrontierExchange`` across processes
simulated by threads (each a process of L shards, its collectives
through a shared hub), in the one-device slot layout and with the
several devices' copies, against the one-process exchange of G shards
over compacted and fallen-back supersteps; and the refusals.
"""

import functools
import json
import math
import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
import socket
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from fora_tpu import index as jax_index
from fora_tpu.algo import exact as jax_exact
from fora_tpu.config import ForaConfig as JaxConfig
from fora_tpu.eval import metrics
from fora_tpu.eval import queries as qio
from fora_tpu.graph import generators as jax_generators
from fora_tpu.graph.csr import CSRGraph as JaxCSRGraph
from fora_tpu.parallel import ShardedForaEngine as JaxEngine
from fora_tpu.parallel import ShardedTopkRunner as JaxRunner
from fora_tpu.parallel import make_mesh as jax_make_mesh
from fora_tpu_torch import ForaConfig
from fora_tpu_torch import index as tidx
from fora_tpu_torch.graph import from_edges, generators
from fora_tpu_torch.graph.csr import CSRGraph
from fora_tpu_torch.ops import walk
from fora_tpu_torch.ops.exchange import FrontierExchange
from fora_tpu_torch.parallel import (ShardedForaEngine, ShardedTopkRunner,
                                     make_mesh, multihost,
                                     save_sharded_graph)
from fora_tpu_torch.parallel.mesh import ProcessMesh
from fora_tpu_torch.parallel.multihost_driver import index_digest
# test_torch_sharded_runner.py's rule for two pools: values and bounds
# within rtol 1e-5, ids equal where adjacent values differ by more than
# 1e-7, acceptance equal, off the queries at a level's threshold (C2)
from test_torch_sharded_runner import assert_agree as assert_pools_agree
from test_torch_exchange import _contrib, _needed
from test_torch_build_sharded import FIELDS, XP_CHUNK, philox_index, xp_window

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
G, K = 4, 10
SMOKE = "bench_data_smoke/rmat12x8s7"
ER = (300, 3000, 21)
ER_SOURCES = [3, 17, 42, 99, 123, 200, 250, 287]
RAW_SEED = 5
TIMEOUT_S = 120
WORLDS = [(2, 2), (4, 1)]
CAP_SMALL = 16           # rows a shard may send a destination: some fall back
POOL_KW = {"batch": 8, "defer_below": 4}
COMPACTED = ["compact", "routed", "hier", "routed_cap"]
BUILD_SEED = 9


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def smoke():
    """(the smoke graph as the port's CSRGraph, its config, the port's
    index, 16 sources)."""
    z = np.load(ROOT / f"{SMOKE}.npz")
    g = CSRGraph(**{f: z[f] for f in CSRGraph._fields if f in z.files})
    rcfg = ForaConfig(epsilon=0.5, k=K).resolved(g.n, g.m)
    idx = tidx.load(str(ROOT / f"{SMOKE}.idx.e0.5"), rcfg)
    return g, rcfg, idx, qio.generate_sources(g, 16, seed=8)


def _stores(root: Path) -> Path:
    """Both sharded stores of the smoke graph and index under ``root``."""
    g, rcfg, idx, _ = smoke()
    save_sharded_graph(g, str(root), G)
    tidx.save_sharded(idx, rcfg, str(root / "index"), G, graph=g)
    return root


def _own_files(stores: Path, dest: Path, shards) -> None:
    """``dest`` gets both stores' metadata and only ``shards``' files."""
    for sub in (f"graph-shards-G{G}", f"index/shards-G{G}"):
        (dest / sub).mkdir(parents=True)
        shutil.copy(stores / sub / "meta.json", dest / sub / "meta.json")
        for s in shards:
            for f in (stores / sub).glob(f"shard_{s:04d}.*"):
                shutil.copy(f, dest / sub / f.name)


def run_world(P: int, root: Path) -> dict:
    """One world of P processes over gloo on the CPU: every worker's
    record and arrays, and the raw job's gathered endpoints."""
    _, _, _, sources = smoke()
    stores = _stores(root / "stores")
    out = root / "out"
    jobs = [{"name": "indexed", "graph": {"npz": f"{SMOKE}.npz"},
             "index": {"dir": f"{SMOKE}.idx.e0.5"}, "k": K,
             "sources": sources.tolist()},
            {"name": "raw", "graph": {"er": list(ER)}, "index": None,
             "k": K, "sources": ER_SOURCES, "seed": RAW_SEED,
             "ends": True}]
    jobs += compacted_jobs(jobs[0], G // P)
    jobs += build_jobs(root)
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    procs = []
    for q in range(P):
        mine = root / f"rank{q}"
        _own_files(stores, mine, range(q * G // P, (q + 1) * G // P))
        spec = {"shards": G, "jobs": jobs + [{
            "name": "store", "k": K, "sources": sources.tolist(),
            "graph": {"store": str(mine)},
            "index": {"store": str(mine / "index")}}]}
        (mine / "spec.json").write_text(json.dumps(spec))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "fora_tpu_torch.parallel.multihost_driver",
             "--coordinator", f"localhost:{port}", "--processes", str(P),
             "--rank", str(q), "--backend", "gloo", "--device", "cpu",
             "--spec", str(mine / "spec.json"), "--out", str(out)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    fails = []
    for q, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for x in procs:
                x.kill()
            _, err = p.communicate()
            fails.append(f"rank {q} timed out after {TIMEOUT_S} s")
        if p.returncode != 0:
            fails.append(f"rank {q} exit {p.returncode}: {err[-3000:]}")
    assert not fails, "\n".join(fails)
    return {"records": [json.loads((out / f"rank{q}.json").read_text())
                        for q in range(P)],
            "arrays": [dict(np.load(out / f"rank{q}.npz"))
                       for q in range(P)],
            "ends": np.load(out / "raw.ends.npy"), "out": out}


def er_build_graph(weighted: bool):
    """The build jobs' graph and config: ER 300 / 3000, or its weighted
    form."""
    g = _weighted_er() if weighted else generators.erdos_renyi(*ER)
    return g, ForaConfig(epsilon=0.5, k=K).resolved(g.n, g.m)


def build_jobs(root: Path) -> list:
    """The index built across the world's processes, uniform (its sharded
    store written under ``root``) and weighted (its graph an npz there),
    then the indexed one-shot of ER_SOURCES from the built store and from
    the Philox reference's store, written here."""
    g, rcfg = er_build_graph(False)
    tidx.save_sharded(philox_index(g, rcfg, BUILD_SEED), rcfg,
                      str(root / "ref_store"), G, graph=g)
    gw, _ = er_build_graph(True)
    np.savez(root / "wer.npz", **{f: v for f, v in gw._asdict().items()
                                  if v is not None})
    build = {"runner": "build", "k": K, "seed": BUILD_SEED,
             "chunk_lanes": XP_CHUNK}
    one_shot = {"graph": {"er": list(ER)}, "k": K, "sources": ER_SOURCES}
    return [dict(build, name="build", graph={"er": list(ER)},
                 store=str(root / "built_store")),
            dict(build, name="build_w", graph={"npz": str(root / "wer.npz")}),
            dict(one_shot, name="built",
                 index={"store": str(root / "built_store")}),
            dict(one_shot, name="ref_built",
                 index={"store": str(root / "ref_store")})]


def exchange_kw(mode: str, L: int) -> dict:
    """The job keys of an exchange: ``hier`` takes the process's L shards
    as a host; ``_cap`` runs at CAP_SMALL."""
    name, _, extra = mode.partition("_")
    kw = {"exchange": name}
    if name == "hier":
        kw["chips_per_host"] = L
    if extra == "cap":
        kw["cap"] = CAP_SMALL
    return kw


def compacted_jobs(indexed: dict, L: int) -> list:
    """The indexed one-shot per compacted exchange, the pool per exchange
    (dense first), and both with a query axis of 2."""
    jobs = [dict(indexed, name=m, **exchange_kw(m, L)) for m in COMPACTED]
    jobs += [dict(indexed, name=f"pool_{m}", runner="pool", **POOL_KW,
                  **({} if m == "dense" else exchange_kw(m, L)))
             for m in ["dense"] + COMPACTED]
    jobs += [dict(indexed, name="q2", exchange="routed", n_query=2),
             dict(indexed, name="pool_q2", runner="pool", n_query=2,
                  **POOL_KW)]
    return jobs


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    cache = {}

    def get(P):
        if P not in cache:
            cache[P] = run_world(P, tmp_path_factory.mktemp(f"world{P}"))
        return cache[P]
    return get


def sorted_topk(vals, ids):
    vals, ids = np.asarray(vals), np.asarray(ids)
    order = np.stack([np.lexsort((i, -v.astype(np.float64)))
                      for v, i in zip(vals, ids)])
    return (np.take_along_axis(vals, order, 1),
            np.take_along_axis(ids, order, 1))


def assert_topk_agree(got_v, got_i, want_v, want_i, rtol=1e-5, atol=1e-7,
                      tie=1e-7):
    """``test_torch_sharded.py``'s rule."""
    gv, gi = sorted_topk(got_v, got_i)
    wv, wi = sorted_topk(want_v, want_i)
    np.testing.assert_allclose(gv, wv, rtol=rtol, atol=atol)
    apart = np.abs(np.diff(wv.astype(np.float64), axis=1)) > tie
    sep = np.ones(wv.shape, bool)
    sep[:, :-1] &= apart
    sep[:, 1:] &= apart
    assert sep.mean() > 0.5
    np.testing.assert_array_equal(gi[sep], wi[sep])


def one_process_indexed():
    g, rcfg, idx, sources = smoke()
    return ShardedForaEngine(g, make_mesh(G, devices=["cpu"] * G), rcfg,
                             k=K, index=idx).topk(sources)


@pytest.mark.parametrize("P,L", WORLDS)
def test_indexed_matches_one_process(worlds, P, L):
    w = worlds(P)
    want = one_process_indexed()
    for q in range(P):
        a = w["arrays"][q]
        assert w["records"][q]["jobs"]["indexed"]["supersteps"] == \
            want.push_iters
        assert w["records"][q]["jobs"]["indexed"]["shards"] == \
            list(range(q * L, (q + 1) * L))
        assert_topk_agree(a["indexed.values"], a["indexed.ids"],
                          want.values, want.node_ids)


@pytest.mark.parametrize("P,L", WORLDS)
def test_indexed_matches_jax(worlds, P, L):
    w = worlds(P)
    z = np.load(ROOT / f"{SMOKE}.npz")
    g = JaxCSRGraph(**{f: z[f] for f in JaxCSRGraph._fields if f in z.files})
    rcfg = JaxConfig(epsilon=0.5, k=50).resolved(g.n, g.m)
    idx = jax_index.load(str(ROOT / f"{SMOKE}.idx.e0.5"), rcfg, graph=g)
    sources = smoke()[3]
    want = JaxEngine(g, jax_make_mesh(G, 1, devices=jax.devices()[:G]), rcfg,
                     k=K, index=idx).topk(np.asarray(sources, np.int32),
                                          jax.random.key(3))
    rec = w["records"][0]["jobs"]["indexed"]
    assert rec["supersteps"] == int(want.push_iters)
    a = w["arrays"][0]
    assert_topk_agree(a["indexed.values"], a["indexed.ids"], want.values,
                      want.node_ids)


@pytest.mark.parametrize("P,L", WORLDS)
def test_every_process_returns_the_answer(worlds, P, L):
    w = worlds(P)
    for q in range(1, P):
        for key, x in w["arrays"][0].items():
            assert np.array_equal(w["arrays"][q][key], x), (q, key)


def raw_reference():
    """The one-process raw one-shot's walk phase at the workers' seed: its
    first chunk's endpoints (K4's Philox walks) and the engine."""
    g = generators.erdos_renyi(*ER)
    rcfg = ForaConfig(epsilon=0.5, k=K).resolved(g.n, g.m)
    eng = ShardedForaEngine(g, make_mesh(G, devices=["cpu"] * G), rcfg, k=K)
    ps, rs = eng.init_state(np.asarray(ER_SOURCES))
    iters = eng.push(ps, rs)
    ds, tot = walk.walk_demands(rs, rcfg.omega_unit)
    tot = tot.long()
    bounds = torch.cat([torch.zeros_like(tot[:1]), tot.cumsum(0)])
    c0, c1, lo, hi = walk.plan_chunks(bounds[-1].numpy(),
                                      walk.chunk_lanes("cpu"))[0]
    seed = walk.derive_seed(walk.derive_seed(RAW_SEED, 0), 0)
    args = (eng.placement.walk, [r[:, c0:c1] for r in rs],
            [d.columns(c0, c1) for d in ds], bounds[:, c0:c1].contiguous(),
            lo, hi - lo)
    return g, rcfg, eng, iters, args, seed


@pytest.mark.parametrize("P,L", WORLDS)
def test_raw_endpoints_equal_one_process(worlds, P, L, monkeypatch):
    w = worlds(P)
    g, rcfg, eng, iters, args, seed = raw_reference()
    a, hops = rcfg.alpha, rcfg.max_walk_hops
    W, Bc = args[-1], args[1][0].shape[1]
    ends = torch.from_numpy(w["ends"])
    assert tuple(ends.shape) == (W, Bc)
    want = torch.full((W, Bc), -1, dtype=torch.int32)
    walk.raw_walk_chunk_plain(*args, eng.n_loc, seed, a, hops,
                              [torch.zeros(G * eng.n_loc, Bc)] * G,
                              ends=want)
    assert torch.equal(ends, want)
    # the dispatcher of the one-process chunk, with the card's walks
    monkeypatch.setattr(walk, "walk_endpoints", walk.run_walks_philox)
    got = torch.full((W, Bc), -1, dtype=torch.int32)
    walk.raw_walk_sharded_chunk(*args, seed, a, hops,
                                [torch.zeros(G * eng.n_loc, Bc)
                                 for _ in range(G)], ends=got)
    assert torch.equal(ends, got)
    assert int((ends >= 0).sum()) > 1000
    rec = w["records"][0]["jobs"]["raw"]
    assert rec["supersteps"] == iters
    assert len(rec["rounds"]) >= 1 and rec["rounds"][0] <= hops + 1
    assert rec["sent"][0][0] > 0 and rec["sent"][0][-1] == 0
    assert sum(sum(r["jobs"]["raw"]["sent"][0]) for r in w["records"]) == \
        sum(sum(r["jobs"]["raw"]["received"][0]) for r in w["records"])


@pytest.mark.parametrize("P,L", WORLDS)
def test_raw_precision(worlds, P, L):
    """The JAX package's gate on its own multi-process case."""
    w = worlds(P)
    g = jax_generators.erdos_renyi(*ER)
    pg = generators.erdos_renyi(*ER)
    assert np.array_equal(g.out_indices, pg.out_indices)
    exact_ids = np.stack([jax_exact.exact_topk(g, int(s), K)[0]
                          for s in ER_SOURCES])
    prec = metrics.batch_precision_at_k(w["arrays"][0]["raw.ids"],
                                        exact_ids)
    assert prec >= 0.85, prec


@pytest.mark.parametrize("P,L", WORLDS)
def test_gather_to_host_across_processes(worlds, P, L):
    w = worlds(P)
    for rec in w["records"]:
        assert rec["gather"] is True
        assert rec["backend"] == "gloo" and rec["modules"] == []


@pytest.mark.parametrize("P,L", WORLDS)
def test_store_opens_only_its_shards(worlds, P, L):
    """Each process's store directories hold only its own shards' files
    (a foreign shard's open would fail), and the store-backed answer is
    the in-RAM one bit for bit."""
    w = worlds(P)
    for q in range(P):
        a = w["arrays"][q]
        assert w["records"][q]["jobs"]["store"]["shards"] == \
            list(range(q * L, (q + 1) * L))
        assert np.array_equal(a["store.ids"], a["indexed.ids"])
        assert np.array_equal(a["store.values"].view(np.uint32),
                              a["indexed.values"].view(np.uint32))


def test_world_of_one_process(worlds):
    """A world of one process holding all four shards: the collectives
    run, and the indexed answer is the one-process engine's bit for
    bit."""
    w = worlds(1)
    want = one_process_indexed()
    a = w["arrays"][0]
    assert np.array_equal(a["indexed.ids"], want.node_ids)
    assert np.array_equal(a["indexed.values"].view(np.uint32),
                          want.values.view(np.uint32))
    assert w["records"][0]["jobs"]["raw"]["rounds"] == [1]


def assert_index_equal(got, want) -> None:
    for f in FIELDS:
        a, b = getattr(want, f), getattr(got, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a), f)
    assert (got.omega_unit_built, got.rmax_built) == \
        (want.omega_unit_built, want.rmax_built)


def chunk_rounds(g, rcfg, P: int) -> list:
    """The rounds each chunk of the build's walks takes over P processes
    when it is walked alone (a window of one chunk, K4-xp's plain version
    in processes simulated in one)."""
    from fora_tpu_torch.index.build_sharded import shard_out_csr
    counts = tidx.index_counts(g.out_deg, rcfg)
    starts = np.repeat(np.arange(g.n, dtype=np.int32), counts)
    cum = np.concatenate([[0], np.cumsum(counts)])
    csr = shard_out_csr(g, ["cpu"] * G)
    return [len(xp_window(csr, starts, cum, lo, min(XP_CHUNK,
                                                    len(starts) - lo),
                          BUILD_SEED, rcfg.alpha, rcfg.max_walk_hops, P)[1])
            for lo in range(0, len(starts), XP_CHUNK)]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("P,L", [(1, 4)] + WORLDS)
def test_build_across_processes_matches_philox(worlds, P, L, weighted):
    """The index built across P processes: rank 0's saved index array-equal
    to the Philox one-process reference at the same seed and chunk, every
    rank's arrays the same (their sha256), four chunks in one window,
    whose rounds of records handed over (where P > 1; every record sent
    received) are the most that one of its chunks takes alone, no kernel
    launched on the CPU, and the wall split into its parts."""
    w = worlds(P)
    g, rcfg = er_build_graph(weighted)
    want = philox_index(g, rcfg, BUILD_SEED)
    name = "build_w" if weighted else "build"
    got = tidx.load(str(w["out"] / f"{name}.index"), rcfg)
    assert_index_equal(got, want)
    recs = [r["jobs"][name] for r in w["records"]]
    total = int(tidx.index_counts(g.out_deg, rcfg).sum())
    assert -(-total // XP_CHUNK) >= 3
    parts = {"place", "walk", "gather", "all_reduce", "pack"}
    for rec in recs:
        assert rec["digest"] == index_digest(want)
        assert (rec["total_edges"], rec["omega_unit_built"],
                rec["rmax_built"]) == (want.total_edges,
                                       want.omega_unit_built,
                                       want.rmax_built)
        assert rec["windows"] == [[0, total]]
        assert not any(rec["launches"].values())
        assert rec["forms"] == [[0, 0]]
        assert set(rec["split_s"]) == parts | (
            {"all_to_all"} if P > 1 else set())
        assert rec["walk_device_ms"] is None
    sent = sum(np.asarray(r["sent"][0]) for r in recs)
    assert np.array_equal(sent, sum(np.asarray(r["received"][0])
                                    for r in recs))
    assert (sent[0] > 0) == (P > 1)
    assert all(r["rounds"] == [max(chunk_rounds(g, rcfg, P))] for r in recs)


@pytest.mark.parametrize("P,L", [(1, 4)] + WORLDS)
def test_build_places_only_own_slices(worlds, P, L):
    """Each rank of the build placed only its own L shards' out-CSR slices
    (each of them padded to the largest shard's edges), fewer edges than
    the graph's where P > 1."""
    w = worlds(P)
    g, _ = er_build_graph(False)
    n_loc = math.ceil(math.ceil(g.n / G) / 8) * 8     # _shard_csr's rows
    ptr = np.asarray(g.out_indptr)
    m_loc = max(int(ptr[min((s + 1) * n_loc, g.n)] - ptr[s * n_loc])
                for s in range(G))
    for q in range(P):
        rec = w["records"][q]["jobs"]["build"]
        assert rec["shards"] == list(range(q * L, (q + 1) * L))
        assert rec["slice_edges"] == [m_loc] * L
        assert (L * m_loc < g.m) == (P > 1)


@pytest.mark.parametrize("P,L", [(1, 4)] + WORLDS)
def test_built_store_one_shot_bit_equal(worlds, P, L):
    """The indexed one-shot across the processes from the sharded store the
    build wrote answers as the one from the Philox reference's store, bit
    for bit, after as many supersteps."""
    w = worlds(P)
    for q in range(P):
        a, rec = w["arrays"][q], w["records"][q]["jobs"]
        assert np.array_equal(a["built.ids"], a["ref_built.ids"])
        assert np.array_equal(a["built.values"].view(np.uint32),
                              a["ref_built.values"].view(np.uint32))
        assert rec["built"]["supersteps"] == rec["ref_built"]["supersteps"]


def threaded_build(g, rcfg, P: int, L: int) -> list:
    """``build_walk_index_sharded`` over a ``ProcessMesh`` of P processes
    of L shards, each a thread whose collectives go through a shared hub:
    every process's index."""
    hub = _Hub(P)

    def run(q):
        mesh = ProcessMesh([torch.device("cpu") if q * L <= s < (q + 1) * L
                            else None for s in range(P * L)],
                           _ThreadComm(hub, q, P))
        return tidx.build_walk_index_sharded(g, mesh, rcfg, BUILD_SEED,
                                             chunk_lanes=XP_CHUNK)
    with ThreadPoolExecutor(P) as pool:
        return list(pool.map(run, range(P)))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("P,L", [(1, 4)] + WORLDS)
def test_build_across_threads_matches_philox(P, L, weighted):
    """The build across P processes simulated by threads in one: every
    process's index array-equal to the Philox one-process reference."""
    g, rcfg = er_build_graph(weighted)
    want = philox_index(g, rcfg, BUILD_SEED)
    for got in threaded_build(g, rcfg, P, L):
        assert_index_equal(got, want)


@pytest.mark.parametrize("window", [XP_CHUNK, 2 * XP_CHUNK + 1])
@pytest.mark.parametrize("P,L", [(1, 4), (2, 2)])
def test_build_across_threads_in_windows(monkeypatch, P, L, window):
    """The threads' build with windows of one and of two chunks (the last
    window short): every process's index array-equal to the Philox
    reference, each window's rounds the most that one of its chunks takes
    alone."""
    from fora_tpu_torch.index.build_sharded import build_across_processes
    from fora_tpu_torch.kernels import schedule
    monkeypatch.setattr(schedule, "XP_BUILD_WALKS", window)
    g, rcfg = er_build_graph(False)
    want = philox_index(g, rcfg, BUILD_SEED)
    per = max(1, window // XP_CHUNK)
    rounds = chunk_rounds(g, rcfg, P)
    hub, logs = _Hub(P), [{} for _ in range(P)]

    def run(q):
        mesh = ProcessMesh([torch.device("cpu") if q * L <= s < (q + 1) * L
                            else None for s in range(P * L)],
                           _ThreadComm(hub, q, P))
        return build_across_processes(g, mesh, rcfg, BUILD_SEED,
                                      chunk_lanes=XP_CHUNK, log=logs[q])
    with ThreadPoolExecutor(P) as pool:
        for got in pool.map(run, range(P)):
            assert_index_equal(got, want)
    for log in logs:
        assert len(log["windows"]) == -(-len(rounds) // per)
        assert log["rounds"] == [max(rounds[i:i + per])
                                 for i in range(0, len(rounds), per)]


def _weighted_er():
    g = generators.erdos_renyi(*ER)
    src = np.repeat(np.arange(g.n), g.out_deg)
    wts = np.exp2(np.random.default_rng(4).uniform(-2, 2, g.m))
    return from_edges(src, g.out_indices, g.n, w=wts)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("L", [1, 2, 4])
def test_xp_plain_simulated_processes(L, weighted):
    """raw_walk_xp_plain over G / L processes simulated by xp_chunk_rounds
    and local_exchange: every endpoint is raw_walk_chunk_plain's, the
    partials sum to its mass, no walk is lost."""
    g = _weighted_er() if weighted else generators.erdos_renyi(*ER)
    rcfg = ForaConfig(epsilon=0.5, k=K).resolved(g.n, g.m)
    eng = ShardedForaEngine(g, make_mesh(G, devices=["cpu"] * G), rcfg, k=K)
    ps, rs = eng.init_state(np.asarray(ER_SOURCES))
    eng.push(ps, rs)
    ds, tot = walk.walk_demands(rs, rcfg.omega_unit)
    tot = tot.long()
    bounds = torch.cat([torch.zeros_like(tot[:1]), tot.cumsum(0)])
    W, B, n_loc = int(bounds[-1].max()), len(ER_SOURCES), eng.n_loc
    lo = 64                            # a chunk that starts past lane 0
    csr = eng.placement.walk
    seed, a, hops = 99, rcfg.alpha, rcfg.max_walk_hops
    want_out = [torch.zeros(G * n_loc, B) for _ in range(G)]
    want = torch.full((W - lo, B), -1, dtype=torch.int32)
    walk.raw_walk_chunk_plain(csr, rs, ds, bounds, lo, W - lo, n_loc, seed,
                              a, hops, want_out, ends=want)
    P = G // L
    parts = [torch.zeros(G * n_loc, B) for _ in range(P)]
    ends = [torch.full((W - lo, B), -1, dtype=torch.int32) for _ in range(P)]
    bnp = bounds.numpy()

    def launch(q, r, inbox, box, cnt):
        ext = walk.own_lanes(bnp[q * L:q * L + L + 1], lo, W - lo)[1]
        walk.raw_walk_xp_chunk(csr.shards(q * L, (q + 1) * L),
                               rs[q * L:(q + 1) * L], ds[q * L:(q + 1) * L],
                               bounds[q * L:q * L + L + 1], lo, W - lo,
                               ext if r == 0 else 0, q * L, G, seed, a, hops,
                               parts[q], inbox, box, cnt, ends=ends[q])
        assert int(cnt[q]) == 0
        for d in range(P):      # (w, cur, h | len << 16, weight's bits)
            rec = box[d, :int(cnt[d])].long()
            length, h = rec[:, 2] >> 16, rec[:, 2] & 0xFFFF
            assert torch.equal(length, walk.lengths_of(
                seed, rec[:, 0] & 0xFFFFFFFF, a, hops))
            assert bool((h < length).all())
    own = {q: walk.own_lanes(bnp[q * L:q * L + L + 1], lo, W - lo)[0]
           for q in range(P)}
    rounds = len(walk.xp_chunk_rounds(launch, walk.local_exchange, own, P,
                                      "cpu"))
    assert rounds <= hops + 1
    assert (rounds > 1) == (P > 1)
    # each walked lane ended in exactly one process
    assert int(sum((e >= 0).int() for e in ends).max()) <= 1
    assert torch.equal(torch.stack(ends).max(0).values, want)
    torch.testing.assert_close(sum(parts), sum(want_out), rtol=1e-5,
                               atol=1e-9)


@pytest.mark.parametrize("mode", COMPACTED)
@pytest.mark.parametrize("P,L", WORLDS)
def test_compacted_one_shot_bit_equal_dense(worlds, P, L, mode):
    """Each compacted exchange across processes answers as the world's
    dense one-shot bit for bit, after as many supersteps; some of them
    compacted, and at the small cap some fell back.  Every process agrees
    on the counts, and a compacted superstep sends at most what the dense
    one sends."""
    w = worlds(P)
    for q in range(P):
        a, rec = w["arrays"][q], w["records"][q]["jobs"]
        got, dense = rec[mode], rec["indexed"]
        assert got["supersteps"] == dense["supersteps"]
        assert got["compacted"] + got["fell_back"] == got["supersteps"]
        assert got["compacted"] > 0
        if mode.endswith("_cap"):
            assert got["cap"] == CAP_SMALL and got["fell_back"] > 0
        assert np.array_equal(a[f"{mode}.ids"], a["indexed.ids"])
        assert np.array_equal(a[f"{mode}.values"].view(np.uint32),
                              a["indexed.values"].view(np.uint32))
        for key in ("compacted", "fell_back", "cleared"):
            assert got[key] == w["records"][0]["jobs"][mode][key]
        assert len(got["sent_rows"]) == got["supersteps"]
        assert all(b <= d for b, d in zip(got["sent_bytes"],
                                          got["dense_bytes"]))
        assert dense["sent_bytes"] == dense["dense_bytes"]
        assert min(got["sent_bytes"]) < min(dense["dense_bytes"])


@pytest.mark.parametrize("mode", COMPACTED)
@pytest.mark.parametrize("P,L", WORLDS)
def test_compacted_pool_bit_equal_dense(worlds, P, L, mode):
    """The refinement pool across processes with each compacted exchange
    (and the small cap) gives the dense pool's answer bit for bit: ids,
    values, bounds, acceptance, levels and every level's supersteps."""
    w = worlds(P)
    for q in range(P):
        a, rec = w["arrays"][q], w["records"][q]["jobs"]
        got, dense = rec[f"pool_{mode}"], rec["pool_dense"]
        for f in ("ids", "values", "lb", "ub", "accepted"):
            assert np.array_equal(a[f"pool_{mode}.{f}"],
                                  a[f"pool_dense.{f}"]), f
        assert got["levels_used"] == dense["levels_used"]
        assert [st["supersteps"] for st in got["levels"]] == \
            [st["supersteps"] for st in dense["levels"]]
        assert got["compacted"] > 0
        assert sum(st["compacted"] for st in got["levels"]) == \
            got["compacted"]
        if mode.endswith("_cap"):
            assert got["fell_back"] > 0


def pool_answer(results) -> SimpleNamespace:
    """A pool's per-source answer from its arrays."""
    return SimpleNamespace(node_ids=results["node_ids"],
                           values=results["values"],
                           lower_bounds=results["lower_bounds"],
                           upper_bounds=results["upper_bounds"],
                           accepted=results["accepted"], deferred=None)


def world_pool(w, name, q=0) -> SimpleNamespace:
    a = w["arrays"][q]
    return pool_answer({"node_ids": a[f"{name}.ids"],
                        "values": a[f"{name}.values"],
                        "lower_bounds": a[f"{name}.lb"],
                        "upper_bounds": a[f"{name}.ub"],
                        "accepted": a[f"{name}.accepted"]})


def one_process_pool(Q: int = 1):
    """The port's one-process ShardedTopkRunner on G CPU shards (Q query
    groups), the workers' pool loop: (answer, its deltas)."""
    g, rcfg, idx, sources = smoke()
    run = ShardedTopkRunner(g, make_mesh(G, Q, devices=["cpu"] * (G * Q)),
                            rcfg, idx, k=K)
    res, _ = run.query_pools(np.asarray(sources), **POOL_KW)
    return res._replace(deferred=None), run.deltas


@functools.lru_cache(maxsize=None)
def jax_smoke():
    """The smoke graph, its config and index in the JAX package."""
    z = np.load(ROOT / f"{SMOKE}.npz")
    g = JaxCSRGraph(**{f: z[f] for f in JaxCSRGraph._fields if f in z.files})
    rcfg = JaxConfig(epsilon=0.5, k=K).resolved(g.n, g.m)
    return g, rcfg, jax_index.load(str(ROOT / f"{SMOKE}.idx.e0.5"), rcfg,
                                   graph=g)


def jax_mesh(Q: int = 1):
    return jax_make_mesh(G, Q, devices=jax.devices()[:G * Q])


@functools.lru_cache(maxsize=None)
def jax_pool(Q: int = 1):
    """JAX's ShardedTopkRunner on G * Q virtual devices, the same pool
    loop (query_pool, then flush_deferred)."""
    g, rcfg, idx = jax_smoke()
    sources = np.asarray(smoke()[3])
    run = JaxRunner(g, jax_mesh(Q), rcfg, idx, k=K)
    res = run.query_pool(sources, jax.random.key(1), **POOL_KW)
    rows = {int(s): (res, i) for i, s in enumerate(sources)
            if not res.deferred[i]}
    dsrc, dres = run.flush_deferred(jax.random.key(2), batch=8)
    if dres is not None:
        rows.update({int(s): (dres, i) for i, s in enumerate(dsrc)})
    return pool_answer({f: np.stack([np.asarray(getattr(r, f))[i]
                                     for r, i in (rows[int(s)]
                                                  for s in sources)])
                        for f in ("node_ids", "values", "lower_bounds",
                                  "upper_bounds", "accepted")})


@pytest.mark.parametrize("P,L", WORLDS)
def test_pool_matches_one_process_and_jax(worlds, P, L):
    w = worlds(P)
    got = world_pool(w, "pool_dense")
    want, deltas = one_process_pool()
    assert_pools_agree(got, want, deltas)
    assert_pools_agree(got, jax_pool(), deltas)


@pytest.mark.parametrize("P,L", WORLDS)
def test_hier_one_shot_matches_jax(worlds, P, L):
    """The hier one-shot, each host a process, against JAX's hier engine
    with as many chips a host on 4 virtual devices."""
    w = worlds(P)
    g, rcfg, idx = jax_smoke()
    want = JaxEngine(g, jax_mesh(), rcfg, k=K, index=idx, exchange="hier",
                     chips_per_host=L).topk(
        np.asarray(smoke()[3], np.int32), jax.random.key(3))
    rec = w["records"][0]["jobs"]["hier"]
    assert rec["supersteps"] == int(want.push_iters)
    a = w["arrays"][0]
    assert_topk_agree(a["hier.values"], a["hier.ids"], want.values,
                      want.node_ids)


@pytest.mark.parametrize("P,L", WORLDS)
def test_query_axis_matches_one_process(worlds, P, L):
    """Two query groups across processes (each process holds its shards
    of both) against the one-process port with two query groups and
    against JAX's engine and runner on a mesh of G x 2 virtual devices:
    the routed one-shot under test_torch_sharded.py's rule (supersteps
    equal to the port's, at least JAX's, which counts the slowest
    group's), the dense pool under test_torch_sharded_runner.py's."""
    w = worlds(P)
    g, rcfg, idx, sources = smoke()
    want = ShardedForaEngine(g, make_mesh(G, 2, devices=["cpu"] * (2 * G)),
                             rcfg, k=K, index=idx,
                             exchange="routed").topk(sources)
    jg, jrcfg, jidx = jax_smoke()
    jwant = JaxEngine(jg, jax_mesh(2), jrcfg, k=K, index=jidx,
                      exchange="routed").topk(np.asarray(sources, np.int32),
                                              jax.random.key(3))
    rec, a = w["records"][0]["jobs"]["q2"], w["arrays"][0]
    assert rec["supersteps"] == want.push_iters
    assert rec["supersteps"] >= int(jwant.push_iters)
    for ref in (want, jwant):
        assert_topk_agree(a["q2.values"], a["q2.ids"], ref.values,
                          ref.node_ids)
    pool, deltas = one_process_pool(Q=2)
    got = world_pool(w, "pool_q2")
    assert_pools_agree(got, pool, deltas)
    assert_pools_agree(got, jax_pool(2), deltas)


def test_agree_raises_on_a_mismatch(monkeypatch):
    """``ProcessComm.agree``, the pool's check a level: equal values pass,
    and a process whose value differs from another's raises with both
    (the other process stood for by its all-reduce's contribution)."""
    comm = multihost.ProcessComm(0, 2, "gloo", torch.device("cpu"))
    other = torch.tensor([7, -7])
    monkeypatch.setattr(comm, "all_reduce",
                        lambda t, op="sum": torch.maximum(t, other))
    comm.agree("level 0", 7)
    with pytest.raises(RuntimeError, match="values from 5 to 7"):
        comm.agree("level 0", 5)


class _Hub:
    """The collectives of P simulated processes, each a thread: every
    process posts its part, waits for all, then reads every part."""

    def __init__(self, P: int):
        self.parts = [None] * P
        self.barrier = threading.Barrier(P, timeout=60)

    def swap(self, rank: int, part) -> list:
        self.parts[rank] = part
        self.barrier.wait()
        got = list(self.parts)
        self.barrier.wait()
        return got


class _ThreadComm:
    """``ProcessComm``'s all-gather and all-to-all for one thread of a
    ``_Hub``."""

    backend, device = "gloo", torch.device("cpu")

    def __init__(self, hub: _Hub, rank: int, size: int):
        self.hub, self.rank, self.size = hub, rank, size

    def all_gather(self, t, out=None):
        got = torch.cat(self.hub.swap(self.rank, t.clone()))
        return got if out is None else out.copy_(got)

    def all_to_all(self, send, send_rows, recv_rows):
        got = self.hub.swap(self.rank, torch.split(send, list(send_rows)))
        out = torch.cat([parts[self.rank] for parts in got])
        assert out.shape[0] == sum(recv_rows)
        return out

    def all_reduce(self, t, op="sum"):
        got = torch.stack(self.hub.swap(self.rank, t.clone()))
        return t.copy_(got.amax(0) if op == "max" else got.sum(0))


@pytest.mark.parametrize("one_device", [True, False])
@pytest.mark.parametrize("mode", ["compact", "routed", "hier"])
@pytest.mark.parametrize("P,L", WORLDS)
def test_exchange_across_processes_matches_one_process(P, L, mode,
                                                       one_device):
    """``FrontierExchange`` across P processes of L shards (``comm``), each
    process a thread whose collectives go through a shared hub, in the
    one-device slot layout (the remote blocks laid into the slots) and
    with the several devices' copies (hier's stage B among the local
    shards): after every superstep each process's buffers equal bit for
    bit the one-process exchange's of the same G shards.  The supersteps
    are compacted, compacted, fallen back to the dense exchange, then
    compacted twice (the zeroing by rows of the received ids), each with
    a new frontier in the own blocks.  A compacted superstep sends the
    other processes only its counted rows, each with its id."""
    n_loc, B, cap = 64, 8, 24
    C = L if mode == "hier" else None
    _, need = _needed(G, n_loc, mode, C or 1, seed=31)
    steps = [[(7 * h + 5 * i) % 20 + 1 for h in range(G)] for i in range(5)]
    steps[2][G - 1] = n_loc            # every row: past cap, the ring
    cpu = torch.device("cpu")
    ref = FrontierExchange(mode, [cpu] * G, n_loc, cap, need, C)
    hub = _Hub(P)
    xchs = []
    for q in range(P):
        x = FrontierExchange(mode, [cpu] * L, n_loc, cap,
                             None if need is None else need[q * L:(q + 1) * L],
                             C, comm=_ThreadComm(hub, q, P), shard0=q * L,
                             n_shards=G)
        x.one_device = one_device
        x.sent = []
        xchs.append(x)
    # the destinations that process q's shards read
    regions = {"compact": lambda q: [0],
               "routed": lambda q: range(q * L, (q + 1) * L),
               "hier": lambda q: [q]}[mode]
    for i, active in enumerate(steps):
        contrib = torch.as_tensor(_contrib(G, n_loc, B, active, seed=60 + i))
        want = ref.buffers(B)
        bufs = [x.buffers(B) for x in xchs]
        for h in range(G):
            own = slice(h * n_loc, (h + 1) * n_loc)
            want[h][own] = contrib[own]
            bufs[h // L][h % L][own] = contrib[own]
        cnt = [torch.zeros(ref.D, dtype=torch.int32) for _ in range(G)]
        ref.send(want, cnt)
        counts = np.stack([c.numpy() for c in cnt])
        assert ref.fits(counts) == (i != 2)
        ref.exchange(want, counts)
        for q, x in enumerate(xchs):
            mine = [torch.zeros(x.D, dtype=torch.int32) for _ in range(L)]
            x.send(bufs[q], mine)
            assert np.array_equal(np.stack([c.numpy() for c in mine]),
                                  counts[q * L:(q + 1) * L])
        with ThreadPoolExecutor(P) as pool:
            list(pool.map(lambda q: xchs[q].exchange(bufs[q], counts),
                          range(P)))
        for q, x in enumerate(xchs):
            for h in range(L):
                assert torch.equal(bufs[q][h].view(torch.int32),
                                   want[q * L + h].view(torch.int32))
            rows = (P - 1) * L * n_loc if i == 2 else sum(
                int(counts[s, d]) for s in x.local for q2 in range(P)
                if q2 != q for d in regions(q2))
            assert x.sent[i] == (rows, B, i != 2)
    for x in xchs:
        assert (x.compacted, x.fell_back, x.cleared) == (4, 1, 2)


def test_shared_cards():
    assert multihost.shared_cards(["a", "b", "c"]) == []
    assert multihost.shared_cards(["a", "b", "a", "a"]) == [(0, 2), (0, 3),
                                                            (2, 3)]


def test_refusals():
    with pytest.raises(ValueError, match="NCCL"):
        multihost.init("localhost:1", 2, 0, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="host:port"):
        multihost.init("localhost", 1, 0, backend="gloo", device="cpu")
    if not torch.cuda.is_available():
        # no card and no device="cpu": no start on the CPU behind the
        # caller's back
        with pytest.raises(RuntimeError, match='device="cpu"'):
            multihost.init("localhost:1", 1, 0)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            multihost.init("localhost:1", 1, 0, backend="gloo")
    assert multihost.comm() is None
    fake = SimpleNamespace(rank=1, size=2, backend="gloo",
                           device=torch.device("cpu"))
    mesh = ProcessMesh([None, None, "cpu", "cpu"], fake)
    assert list(mesh.local) == [2, 3]
    with pytest.raises(ValueError, match="must hold"):
        ProcessMesh(["cpu", None, "cpu", None], fake)
    cpus = [torch.device("cpu")] * 2
    with pytest.raises(NotImplementedError, match="ragged"):
        FrontierExchange("ragged", cpus, 8, comm=fake, shard0=2, n_shards=4)
    with pytest.raises(ValueError, match="chips_per_host = 2"):
        FrontierExchange("hier", cpus, 8, chips_per_host=1, comm=fake,
                         shard0=2, n_shards=4)
    # what this refused before now builds: routed across processes
    assert FrontierExchange("routed", cpus, 8, comm=fake, shard0=2,
                            n_shards=4).local == [2, 3]
    # without a group, gather_to_host concatenates the shards
    assert np.array_equal(multihost.gather_to_host(
        [torch.arange(3), torch.arange(3, 5)]), np.arange(5))
    # C18: a weighted build over a ProcessMesh raised a TypeError on rank 1
    # (its devices[0] is None); it now builds across the processes
    g, rcfg = er_build_graph(True)
    want = philox_index(g, rcfg, BUILD_SEED)
    for got in threaded_build(g, rcfg, 2, 2):
        assert_index_equal(got, want)


@pytest.mark.parametrize("alias", [False, True])
@pytest.mark.parametrize("extent,Bc,n_in", [(0, 0, 0), (0, 5, 1), (1, 1, 0),
                                            (33, 3, 100), (4096, 10, 0),
                                            (12776448, 10, 0),
                                            (0, 10, 65001865)])
def test_xp_walk_plan_covers_the_walks(extent, Bc, n_in, alias):
    """K6+K4-xp's plan, each form: the own-lane form's tiles of 32 k rows
    cover a column's own lanes and its blocks' warps every column's tiles,
    k one of K6+K4's (4 at most for alias hops); the inbox form's warps of
    32 k records cover the records, k a power of two up to
    XP_INBOX_WALKS_PER_LANE; each k smaller where
    its walks do not fill half of the card's resident warps at the form's
    own residency."""
    from fora_tpu_torch.kernels import schedule
    plans = schedule.xp_walk_plan(extent, Bc, n_in, 132, alias)
    for form in ("own", "inbox"):
        plan = getattr(plans, form)
        k = plan.walks_per_lane
        if form == "own":
            assert k in ((1, 2, 4) if alias else (1, 2, 4, 8, 16))
            assert plan.tiles * 32 * k >= extent
            warps, work = plan.tiles * Bc, extent * Bc
            per_sm = schedule.XP_OWN_BLOCKS_PER_SM
        else:
            top = schedule.XP_INBOX_WALKS_PER_LANE
            assert k in [2**i for i in range(6) if 2**i <= top]
            assert plan.tiles == -(-n_in // (32 * k))
            warps, work = plan.tiles, n_in
            per_sm = schedule.XP_INBOX_BLOCKS_PER_SM
        assert plan.blocks * schedule.WALK_BLOCK_WARPS >= warps
        assert (plan.blocks - 1) * schedule.WALK_BLOCK_WARPS < warps or \
            plan.blocks == 0
        assert (plan.blocks == 0) == (work == 0)
        if work < 32 * 132 * per_sm * 8 // 2:
            assert k == 1


@pytest.mark.parametrize("form,const", [("Own", "XP_OWN_BLOCKS_PER_SM"),
                                        ("Inbox", "XP_INBOX_BLOCKS_PER_SM")])
def test_xp_blocks_per_sm_are_the_launch_bounds(form, const):
    """Each K6+K4-xp form's blocks an SM in the plan is walk.cu's launch
    bound of that form's kernel."""
    import re
    from pathlib import Path
    from fora_tpu_torch.kernels import schedule
    src = (Path(schedule.__file__).parent / "csrc" / "walk.cu").read_text()
    got = re.findall(rf"constexpr int kXp{form}BlocksPerSM = (\d+);", src)
    assert [int(x) for x in got] == [getattr(schedule, const)]
    kernel = f"xp_{form.lower()}_kernel"
    assert re.search(rf"__launch_bounds__\(kBlockThreads, kBlocks\)\s+"
                     rf"{kernel}\(", src)
    assert re.search(rf"launch_xp_{form.lower()}<kXp{form}BlocksPerSM, "
                     rf"StagedLeave>", src)
