"""Crash-resume checkpoints of fora_tpu_torch's index builds on the CPU
(``index/build.py::run_walk_chunks``), as ``tests/test_index.py:226`` and
``tests/test_build_sharded.py:58`` hold the JAX package's:

  - an interrupted ``build_walk_index`` (a host call made once a chunk
    raises on the third chunk) leaves two chunk files and resumes
    bit-identical to an uninterrupted build, loading those chunks;
  - the in-process sharded build resumes from the one-device build's
    checkpoint (both draw a torch.Generator on the CPU: one stream id);
  - a checkpoint of another seed, graph, chunking or random stream is
    refused with a ValueError naming the checkpoint: a directory the JAX
    package's ``run_walk_chunks`` wrote (threefry, "scheduled-v1") is
    refused by the port, and the port's by JAX; the CPU build's
    (Generator) by the build across processes, which draws K4's Philox
    stream as a card build does;
  - the build across processes (threads through a shared hub): a window
    that one process lacks is walked again by every process (the min
    agreement), equal to the Philox reference;
  - a world of 2 gloo processes (``tests/test_torch_multihost.py``'s
    pattern, ``multihost_driver``'s build job) stops after one window and
    resumes, every rank's arrays equal to the Philox reference's;
  - the CLI's ``build`` discards a stale checkpoint and removes its
    directory once the index is saved.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from test_torch_build_sharded import FIELDS, XP_CHUNK, philox_index
from test_torch_multihost import _Hub, _ThreadComm

from fora_tpu.config import ForaConfig as JaxConfig
from fora_tpu.graph import generators as jax_generators
from fora_tpu.graph import to_device as jax_to_device
from fora_tpu.index import build as jax_build
from fora_tpu_torch import ForaConfig
from fora_tpu_torch import index as tidx
from fora_tpu_torch.graph import generators, to_device
from fora_tpu_torch.index import build as ib
from fora_tpu_torch.index.build_sharded import build_across_processes
from fora_tpu_torch.parallel import make_mesh
from fora_tpu_torch.parallel.mesh import ProcessMesh
from fora_tpu_torch.parallel.multihost_driver import index_digest

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
ER = (300, 3000, 21)
SEED = 12


def _er():
    g = generators.erdos_renyi(*ER)
    return g, ForaConfig(epsilon=0.5).resolved(g.n, g.m)


def assert_same(got, want) -> None:
    for f in FIELDS:
        a, b = getattr(want, f), getattr(got, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a), f)


def test_interrupted_build_resumes_bit_identical(tmp_path, monkeypatch):
    g, rcfg = _er()
    dg = to_device(g, device="cpu")
    assert tidx.index_counts(g.out_deg, rcfg).sum() > 3 * XP_CHUNK
    ref = tidx.build_walk_index(dg, rcfg, SEED, chunk_lanes=XP_CHUNK)
    real, calls = ib.walk_endpoints, {"n": 0}

    def flaky(*a, **kw):        # the walk of one chunk, once a chunk
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("preempted")
        return real(*a, **kw)
    ckpt = tmp_path / "ckpt"
    monkeypatch.setattr(ib, "walk_endpoints", flaky)
    with pytest.raises(RuntimeError, match="preempted"):
        tidx.build_walk_index(dg, rcfg, SEED, chunk_lanes=XP_CHUNK,
                              checkpoint_dir=str(ckpt))
    monkeypatch.setattr(ib, "walk_endpoints", real)
    assert sorted(p.name for p in ckpt.glob("chunk_*.npy")) == [
        "chunk_000000.npy", "chunk_000001.npy"]
    assert not list(ckpt.glob(".*tmp"))
    seen = []
    resumed = tidx.build_walk_index(
        dg, rcfg, SEED, chunk_lanes=XP_CHUNK, checkpoint_dir=str(ckpt),
        progress=lambda i, n, cached: seen.append((i, n, cached)))
    assert_same(resumed, ref)
    n = -(-int(tidx.index_counts(g.out_deg, rcfg).sum()) // XP_CHUNK)
    assert seen == [(i, n, i < 2) for i in range(n)]
    manifest = json.loads((ckpt / "manifest.json").read_text())
    assert manifest["kernel"] == ib.GENERATOR_STREAM
    assert (manifest["seed"], manifest["chunk"], manifest["n"]) == \
        (SEED, XP_CHUNK, g.n)


def test_sharded_build_resumes_one_device_checkpoint(tmp_path):
    g, rcfg = _er()
    ckpt = str(tmp_path / "ckpt")
    ref = tidx.build_walk_index(to_device(g, device="cpu"), rcfg, SEED,
                                chunk_lanes=XP_CHUNK, checkpoint_dir=ckpt)
    seen = []
    got = tidx.build_walk_index_sharded(
        g, make_mesh(2, devices=["cpu"] * 2), rcfg, SEED,
        chunk_lanes=XP_CHUNK, checkpoint_dir=ckpt,
        progress=lambda i, n, cached: seen.append(cached))
    assert seen and all(seen)
    assert_same(got, ref)


@pytest.mark.parametrize("other", ["seed", "graph", "chunk", "max_per_node"])
def test_mismatched_checkpoint_refused(tmp_path, other):
    g, rcfg = _er()
    ckpt = str(tmp_path / "ckpt")
    tidx.build_walk_index(to_device(g, device="cpu"), rcfg, SEED,
                          chunk_lanes=XP_CHUNK, checkpoint_dir=ckpt)
    kw = dict(chunk_lanes=XP_CHUNK, checkpoint_dir=ckpt)
    seed = SEED + 1 if other == "seed" else SEED
    if other == "graph":      # same shape, other edges
        g = generators.erdos_renyi(ER[0], ER[1], ER[2] + 1)
    if other == "chunk":
        kw["chunk_lanes"] = 2 * XP_CHUNK
    if other == "max_per_node":
        kw["max_per_node"] = 4
    with pytest.raises(ValueError, match="checkpoint"):
        tidx.build_walk_index(to_device(g, device="cpu"), rcfg, seed, **kw)


def _jax_graph():
    g = jax_generators.erdos_renyi(*ER)
    return g, JaxConfig(epsilon=0.5).resolved(g.n, g.m)


def test_jax_checkpoint_refused_both_ways(tmp_path):
    """A directory of JAX's ``run_walk_chunks`` (threefry) is refused by
    the port, and the port's by JAX: the two streams never mix."""
    jg, jrcfg = _jax_graph()
    g, rcfg = _er()
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_build.build_walk_index(jax_to_device(jg), jrcfg, jax.random.key(0),
                               chunk=XP_CHUNK, checkpoint_dir=str(jax_dir))
    assert (jax_dir / "manifest.json").exists()
    with pytest.raises(ValueError, match="checkpoint"):
        tidx.build_walk_index(to_device(g, device="cpu"), rcfg, 0,
                              chunk_lanes=XP_CHUNK,
                              checkpoint_dir=str(jax_dir))
    tidx.build_walk_index(to_device(g, device="cpu"), rcfg, 0,
                          chunk_lanes=XP_CHUNK, checkpoint_dir=str(port_dir))
    with pytest.raises(ValueError, match="checkpoint"):
        jax_build.build_walk_index(jax_to_device(jg), jrcfg,
                                   jax.random.key(0), chunk=XP_CHUNK,
                                   checkpoint_dir=str(port_dir))


def _threads(g, rcfg, P: int, L: int, dirs) -> list:
    """The build across P processes of L shards, each a thread through a
    shared hub, process q checkpointing into dirs[q]."""
    hub = _Hub(P)

    def run(q):
        mesh = ProcessMesh([torch.device("cpu") if q * L <= s < (q + 1) * L
                            else None for s in range(P * L)],
                           _ThreadComm(hub, q, P))
        return build_across_processes(g, mesh, rcfg, SEED, XP_CHUNK,
                                      checkpoint_dir=str(dirs[q]))
    with ThreadPoolExecutor(P) as pool:
        return list(pool.map(run, range(P)))


def test_cpu_checkpoint_refused_by_philox_build(tmp_path):
    """The CPU one-process build draws a Generator, the build across
    processes K4's Philox words (as a card build does): another stream,
    refused."""
    g, rcfg = _er()
    ckpt = tmp_path / "ckpt"
    tidx.build_walk_index(to_device(g, device="cpu"), rcfg, SEED,
                          chunk_lanes=XP_CHUNK, checkpoint_dir=str(ckpt))
    with pytest.raises(ValueError, match="checkpoint"):
        _threads(g, rcfg, 1, 4, [ckpt])


def test_processes_walk_a_window_one_lacks(tmp_path, monkeypatch):
    """Windows of one chunk over 2 processes: after a whole build, process
    1 loses chunk 1 and process 0 chunk 2; the resumed build walks both
    windows again in every process and equals the Philox reference."""
    from fora_tpu_torch.kernels import schedule
    monkeypatch.setattr(schedule, "XP_BUILD_WALKS", XP_CHUNK)
    g, rcfg = _er()
    want = philox_index(g, rcfg, SEED)
    dirs = [tmp_path / "p0", tmp_path / "p1"]
    for got in _threads(g, rcfg, 2, 2, dirs):
        assert_same(got, want)
    assert json.loads((dirs[0] / "manifest.json").read_text())["kernel"] \
        == ib.PHILOX_STREAM
    (dirs[1] / "chunk_000001.npy").unlink()
    (dirs[0] / "chunk_000002.npy").unlink()
    walked = ib.run_walk_chunks
    seen = [[], []]

    def spy(walk, *a, **kw):
        q = 0 if kw["checkpoint_dir"] == str(dirs[0]) else 1
        return walked(lambda lo, hi, out: (seen[q].append(lo),
                                           walk(lo, hi, out)),
                      *a, **kw)
    import fora_tpu_torch.index.build_sharded as bs
    monkeypatch.setattr(bs, "run_walk_chunks", spy)
    for got in _threads(g, rcfg, 2, 2, dirs):
        assert_same(got, want)
    assert seen[0] == seen[1] == [XP_CHUNK, 2 * XP_CHUNK]
    for d in dirs:
        assert len(list(d.glob("chunk_*.npy"))) == 4


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_world_stops_and_resumes(tmp_path):
    """Two gloo processes build in windows of one chunk, stop once their
    first window is saved (the window in flight saved too), then resume
    in the same world: the chunks saved are loaded, the rest walked, and
    every rank's index equals the Philox reference."""
    g, rcfg = _er()
    want = philox_index(g, rcfg, SEED)
    total = int(tidx.index_counts(g.out_deg, rcfg).sum())
    P, out, port = 2, tmp_path / "out", _free_port()
    build = {"runner": "build", "k": 10, "seed": SEED, "graph":
             {"er": list(ER)}, "chunk_lanes": XP_CHUNK,
             "window_walks": XP_CHUNK}
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    procs = []
    for q in range(P):
        ckpt = str(tmp_path / f"ckpt{q}")
        spec = {"shards": 4, "jobs": [
            dict(build, name="stop", checkpoint_dir=ckpt,
                 stop_after_windows=1),
            dict(build, name="resume", checkpoint_dir=ckpt)]}
        (tmp_path / f"spec{q}.json").write_text(json.dumps(spec))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "fora_tpu_torch.parallel.multihost_driver",
             "--coordinator", f"localhost:{port}", "--processes", str(P),
             "--rank", str(q), "--backend", "gloo", "--device", "cpu",
             "--spec", str(tmp_path / f"spec{q}.json"), "--out", str(out)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    fails = []
    for q, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for x in procs:
                x.kill()
            _, err = p.communicate()
        if p.returncode != 0:
            fails.append(f"rank {q} exit {p.returncode}: {err[-3000:]}")
    assert not fails, "\n".join(fails)
    for q in range(P):
        jobs = json.loads((out / f"rank{q}.json").read_text())["jobs"]
        stop, resume = jobs["stop"], jobs["resume"]
        assert stop["stopped"] and stop["cached"] == []
        assert stop["files"] == [f"chunk_{i:06d}.npy" for i in range(2)]
        assert resume["cached"] == [0, 1]
        assert resume["windows"] == [[lo, min(lo + XP_CHUNK, total)] for lo
                                     in range(2 * XP_CHUNK, total, XP_CHUNK)]
        assert resume["digest"] == index_digest(want)
    assert_same(tidx.load(str(out / "resume.index"), rcfg), want)


def test_cli_build_discards_stale_checkpoint(tmp_path):
    from fora_tpu_torch import cli
    from fora_tpu_torch.graph import io as gio
    g = generators.rmat(8, 2048, seed=6)
    gio.save_dataset(g, str(tmp_path), "r")
    base = ["--prefix", str(tmp_path), "--dataset", "r", "--device", "cpu",
            "--k", "5"]
    ckpt = tmp_path / "index" / "r" / ".build_ckpt"
    ckpt.mkdir(parents=True)
    (ckpt / "manifest.json").write_text(json.dumps({"kernel": "stale"}))
    assert cli.main(["build"] + base) == 0
    assert not ckpt.exists()
    assert (tmp_path / "index" / "r" / "meta.json").exists()
    shutil.rmtree(tmp_path / "index")
