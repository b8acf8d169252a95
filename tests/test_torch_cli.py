"""The port's CLI against fora_tpu's, on the CPU (``--device cpu``).

One ER dataset (n = 400, m = 4000, seed 13, as ``tests/test_cli.py``) is
written in the reference's on-disk format under two prefixes, one per
package; fora_tpu's CLI samples the query set and builds the FORA+ index
under the first, and the port's CLI runs every action on the CPU:

  - generate-ss-query writes the same file;
  - gen-exact-topk the same ids, apart from exact ties (ROADMAP C8), and
    values within 1e-10;
  - batch-topk --with-idx --start-level 0 serves the JAX-built index (the
    shared v2 store) with the JAX CLI's ids exactly and values at rtol
    1e-5; query --algo fwdpush gives the same ids;
  - raw fora, montecarlo, hubppr and bippr reach precision@8 >= 0.85
    against the exact oracle;
  - sweep prints the same JSON keys, each max relative error within its
    epsilon;
  - the sharded forms: shard-graph and build --index-shards write the
    stores the JAX CLI writes; batch-topk --graph-shards gives the JAX
    CLI's ids, and the same answers again from both stores; serve
    --graph-shards answers over TCP; query --graph-shards, the ragged
    exchange and a sharded raw-walk run exit 2, as does a CUDA run where
    CUDA is absent.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from fora_tpu import cli as jax_cli
from fora_tpu.algo import exact as jax_exact
from fora_tpu.eval import metrics as jax_metrics
from fora_tpu.graph import generators as jax_generators
from fora_tpu.graph.io import save_dataset as jax_save_dataset
from fora_tpu_torch import cli

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
K = 8


def _base(prefix):
    return ["--prefix", str(prefix), "--dataset", "er"]


def _port(*argv, prefix):
    return cli.main(list(argv) + _base(prefix) + ["--device", "cpu"])


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """(JAX prefix, port prefix, graph): the same dataset under both; the
    JAX prefix holds fora_tpu's query set and index."""
    jp = tmp_path_factory.mktemp("jax")
    tp = tmp_path_factory.mktemp("port")
    g = jax_generators.erdos_renyi(400, 4000, seed=13)
    jax_save_dataset(g, str(jp), "er")
    jax_save_dataset(g, str(tp), "er")
    assert jax_cli.main(["generate-ss-query", "--query-size", "12"]
                        + _base(jp)) == 0
    assert jax_cli.main(["build", "--epsilon", "0.5"] + _base(jp)) == 0
    shutil.copy(jp / "er" / "er.query", tp / "er" / "er.query")
    return jp, tp, g


def _rows(path):
    return {r["source"]: r for r in map(json.loads,
                                        Path(path).read_text().splitlines())}


def _precision(g, rows, k=K):
    return float(np.mean([
        jax_metrics.precision_at_k(np.asarray(r["ids"]),
                                   jax_exact.exact_topk(g, int(s), k)[0])
        for s, r in rows.items()]))


def test_generate_ss_query_matches_jax(dataset, tmp_path):
    jp, _, _ = dataset
    shutil.copytree(jp / "er", tmp_path / "er",
                    ignore=shutil.ignore_patterns("er.query"))
    for seed in ("0", "3"):
        assert _port("generate-ss-query", "--query-size", "12", "--seed",
                     seed, prefix=tmp_path) == 0
        assert jax_cli.main(["generate-ss-query", "--query-size", "12",
                             "--seed", seed, "--prefix", str(jp),
                             "--dataset", "er"]) == 0
        assert (tmp_path / "er" / "er.query").read_bytes() == \
            (jp / "er" / "er.query").read_bytes()
    # the fixture's query set again (seed 0)
    assert jax_cli.main(["generate-ss-query", "--query-size", "12"]
                        + _base(jp)) == 0


def test_gen_exact_topk_matches_jax(dataset, tmp_path):
    """Both CLIs' exact/<source>.npz (ids int64, vals float64, top
    max(k, 500) clipped to n): values within 1e-10, ids equal wherever the
    adjacent exact values differ by more than 1e-9 (the rest are ties)."""
    jp, tp, _ = dataset
    assert jax_cli.main(["gen-exact-topk"] + _base(jp)) == 0
    assert _port("gen-exact-topk", prefix=tp) == 0
    sources = np.loadtxt(jp / "er" / "er.query", dtype=np.int64)
    for s in sources:
        want = np.load(jp / "er" / "exact" / f"{s}.npz")
        got = np.load(tp / "er" / "exact" / f"{s}.npz")
        assert sorted(got.files) == sorted(want.files) == ["ids", "vals"]
        assert got["ids"].dtype == want["ids"].dtype == np.int64
        assert got["vals"].dtype == want["vals"].dtype == np.float64
        assert got["ids"].shape == want["ids"].shape == (400,)
        np.testing.assert_allclose(got["vals"], want["vals"], rtol=0,
                                   atol=1e-10)
        wv = want["vals"]
        apart = np.abs(np.diff(wv)) > 1e-9
        sep = np.ones(len(wv), bool)
        sep[:-1] &= apart
        sep[1:] &= apart
        assert sep.sum() > 100
        np.testing.assert_array_equal(got["ids"][sep], want["ids"][sep])


def test_batch_topk_serves_jax_index(dataset, tmp_path):
    """The port's CLI serves the JAX-built index (fora_tpu's index dir,
    its query set) with the JAX CLI's answers: ids exactly, values at rtol
    1e-5; --output rows carry the same keys."""
    jp, _, g = dataset
    flags = ["batch-topk", "--epsilon", "0.5", "--k", str(K), "--with-idx",
             "--batch", "8", "--start-level", "0"]
    assert jax_cli.main(flags + ["--output", str(tmp_path / "jax.jsonl")]
                        + _base(jp)) == 0
    assert _port(*flags, "--output", str(tmp_path / "port.jsonl"),
                 prefix=jp) == 0
    want, got = _rows(tmp_path / "jax.jsonl"), _rows(tmp_path / "port.jsonl")
    assert set(got) == set(want) and len(got) == 12
    for s in want:
        assert set(got[s]) == set(want[s]) == {"source", "ids", "vals"}
        assert got[s]["ids"] == want[s]["ids"], s
        np.testing.assert_allclose(got[s]["vals"], want[s]["vals"],
                                   rtol=1e-5, err_msg=str(s))
    assert _precision(g, got) >= 0.85


def test_batch_topk_pools_and_level_stats(dataset, tmp_path):
    """Pooled and deferred batch-topk on the port's own index returns the
    single pool's ids; the run without --start-level persists
    level_stats.json beside the index, in the record fora_tpu's runner
    reads, and the JAX package's file is adopted by the port's runner."""
    from fora_tpu_torch import ForaConfig, TopkRunner, to_device
    from fora_tpu_torch import index as tidx
    from fora_tpu_torch.graph import io as tio
    _, tp, g = dataset
    assert _port("build", "--epsilon", "0.5", prefix=tp) == 0
    flags = ["batch-topk", "--epsilon", "0.5", "--k", str(K), "--with-idx",
             "--batch", "8"]
    one = tmp_path / "one.jsonl"
    pooled = tmp_path / "pooled.jsonl"
    assert _port(*flags, "--start-level", "0", "--output", str(one),
                 prefix=tp) == 0
    assert _port(*flags, "--start-level", "0", "--pool", "4", "--defer", "3",
                 "--output", str(pooled), prefix=tp) == 0
    a, b = _rows(one), _rows(pooled)
    assert set(a) == set(b)
    for s in a:
        assert a[s]["ids"] == b[s]["ids"], s
    stats = tp / "index" / "er" / "level_stats.json"
    assert not stats.exists()
    assert _port(*flags, prefix=tp) == 0
    rec = json.loads(stats.read_text())
    assert rec["version"] == 2 and rec["indexed"] is True
    from fora_tpu.algo.topk import TopkRunner as JaxTopkRunner
    from fora_tpu.config import ForaConfig as JaxForaConfig
    from fora_tpu.graph import to_device as jax_to_device
    from fora_tpu.index import load as jax_load, graph_fingerprint
    rcfg_j = JaxForaConfig(epsilon=0.5, k=K).resolved(g.n, g.m)
    jrun = JaxTopkRunner(jax_to_device(g), rcfg_j, k=K, delta_stride=4.0,
                         index=jax_load(str(tp / "index" / "er"), rcfg_j,
                                        graph=g))
    sha = graph_fingerprint(g)
    assert jrun.load_level_stats(stats, sha)
    assert jrun.auto_start_level == rec["start_level"]
    # the other way: fora_tpu's file read by the port's runner, and a
    # mismatched record refused
    jrun.auto_start_level = 1
    jstats = tmp_path / "jax_level_stats.json"
    jrun.save_level_stats(jstats, sha)
    gt = tio.load_dataset(str(tp), "er", device="cpu")
    rcfg = ForaConfig(epsilon=0.5, k=K).resolved(gt.n, gt.m)
    run = TopkRunner(to_device(gt, device="cpu"), rcfg, k=K,
                     delta_stride=4.0,
                     index=tidx.load(str(tp / "index" / "er"), rcfg,
                                     graph=gt))
    assert tidx.graph_fingerprint(gt) == sha
    assert run.load_level_stats(jstats, sha) and run.auto_start_level == 1
    assert not run.load_level_stats(jstats, "another graph")
    jstats.write_text("{not json")
    assert not run.load_level_stats(jstats, sha)


def test_query_fwdpush_matches_jax(dataset, tmp_path):
    jp, _, _ = dataset
    flags = ["query", "--algo", "fwdpush", "--k", str(K), "--batch", "8"]
    assert jax_cli.main(flags + ["--output", str(tmp_path / "j.jsonl")]
                        + _base(jp)) == 0
    assert _port(*flags, "--output", str(tmp_path / "t.jsonl"),
                 prefix=jp) == 0
    want, got = _rows(tmp_path / "j.jsonl"), _rows(tmp_path / "t.jsonl")
    assert set(got) == set(want)
    for s in want:
        assert got[s]["ids"] == want[s]["ids"], s
        np.testing.assert_allclose(got[s]["vals"], want[s]["vals"],
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("algo,extra", [
    ("fora", []), ("montecarlo", []), ("hubppr", ["--num-hubs", "8"]),
    ("bippr", []), ("fora", ["--with-idx"])])
def test_query_precision_against_oracle(dataset, tmp_path, algo, extra):
    """Each --algo of the query action on the CPU: 12 answers of k ids in
    descending value, precision@8 >= 0.85 against the exact oracle; the
    --eval-exact path reads the exact files or runs the batched oracle."""
    _, tp, g = dataset
    out = tmp_path / "q.jsonl"
    runlog = tmp_path / "run.jsonl"
    assert _port("query", "--algo", algo, "--k", str(K), "--batch", "8",
                 "--output", str(out), "--eval-exact", "--runlog",
                 str(runlog), *extra, prefix=tp) == 0
    rows = _rows(out)
    assert len(rows) == 12
    for r in rows.values():
        assert len(r["ids"]) == K and np.all(np.diff(r["vals"]) <= 0)
    assert _precision(g, rows) >= 0.85
    ev = [json.loads(l) for l in runlog.read_text().splitlines()]
    assert ev[-1]["kind"] == "eval" and ev[-1]["precision_at_k"] >= 0.85


def test_topk_action(dataset, tmp_path):
    _, tp, g = dataset
    out = tmp_path / "t.jsonl"
    assert _port("topk", "--k", str(K), "--batch", "8", "--output", str(out),
                 prefix=tp) == 0
    assert _precision(g, _rows(out)) >= 0.85


def test_sweep_matches_jax_keys(dataset, capsys):
    """sweep prints one JSON record per epsilon with the JAX CLI's keys;
    every max relative error (over pi > delta) is within its epsilon.  An
    index built at eps 0.5 refuses a finer epsilon (exit 2)."""
    jp, tp, _ = dataset
    argv = ["sweep", "--with-idx", "--batch", "8", "--k", str(K),
            "--sweep-eps", "0.5,0.7"]

    def records():
        return [json.loads(l) for l in capsys.readouterr().out.splitlines()
                if l.startswith("{")]
    assert jax_cli.main(argv + _base(jp)) == 0
    want = records()
    assert _port(*argv, prefix=jp) == 0
    got = records()
    assert [r["epsilon"] for r in got] == [r["epsilon"] for r in want] == \
        [0.5, 0.7]
    for a, b in zip(got, want):
        assert set(a) == set(b)
        assert a["max_rel_err"] <= a["epsilon"]
        assert a["mean_rel_err"] <= a["max_rel_err"]
        assert a["precision_at_k"] >= 0.85
    assert _port("sweep", "--with-idx", "--batch", "8", "--sweep-eps",
                 "0.35,0.5", prefix=jp) == 2


@pytest.mark.parametrize("argv,message", [
    (["query", "--graph-shards", "4"],
     "--graph-shards applies to batch-topk and serve"),
    (["batch-topk", "--with-idx", "--graph-shards", "2", "--exchange",
      "ragged"], "ROADMAP C5"),
    (["batch-topk", "--graph-shards", "2"], "ROADMAP Queue 1 item 4"),
])
def test_sharded_forms_exit_2(dataset, capsys, argv, message):
    """What the sharded CLI refuses: the JAX CLI's own error for query,
    and the two paths the port lacks, each naming its ROADMAP item."""
    _, tp, _ = dataset
    assert _port(*argv, prefix=tp) == 2
    assert message in capsys.readouterr().err
    if argv[0] == "query":
        assert jax_cli.main(argv + _base(tp)) == 2


def test_query_ignores_shard_counts(dataset, tmp_path):
    """--shard-counts belongs to shard-graph; query runs as without it, as
    in the JAX CLI."""
    jp, _, _ = dataset
    flags = ["query", "--algo", "fwdpush", "--k", str(K), "--batch", "8",
             "--shard-counts", "2,4"]
    assert _port(*flags, "--output", str(tmp_path / "a.jsonl"),
                 prefix=jp) == 0
    assert _port(*flags[:-2], "--output", str(tmp_path / "b.jsonl"),
                 prefix=jp) == 0
    assert _rows(tmp_path / "a.jsonl") == _rows(tmp_path / "b.jsonl")


def _prefix_copy(src, dst):
    """A copy of a dataset prefix (graph, query file, index)."""
    shutil.copytree(src, dst)
    return dst


def _same_dirs(a, b):
    fa = sorted(p.name for p in a.iterdir())
    assert fa == sorted(p.name for p in b.iterdir()) and fa
    for name in fa:
        if name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(a / name), np.load(b / name),
                                          err_msg=name)
        else:
            assert json.loads((a / name).read_text()) == \
                json.loads((b / name).read_text())


def test_shard_graph_action(dataset, tmp_path):
    """shard-graph writes, per shard count, the graph store the JAX CLI's
    shard-graph writes, file for file."""
    jp, _, _ = dataset
    a = _prefix_copy(jp, tmp_path / "port")
    b = _prefix_copy(jp, tmp_path / "jax")
    assert _port("shard-graph", "--shard-counts", "2,4", prefix=a) == 0
    assert jax_cli.main(["shard-graph", "--shard-counts", "2,4"]
                        + _base(b)) == 0
    for c in (2, 4):
        _same_dirs(a / "er" / f"graph-shards-G{c}",
                   b / "er" / f"graph-shards-G{c}")
    assert _port("shard-graph", prefix=a) == 2   # one shard is no store


def test_build_index_shards(dataset, tmp_path):
    """build --index-shards writes the sharded index store of the index it
    built (as the JAX package's save_sharded lays it out) and the graph
    store beside it."""
    from fora_tpu.config import ForaConfig as JaxForaConfig
    from fora_tpu.index import store as jax_store
    from fora_tpu_torch import index as tidx
    _, tp, g = dataset
    a = _prefix_copy(tp, tmp_path / "port")
    assert _port("build", "--epsilon", "0.5", "--index-shards", "2",
                 prefix=a) == 0
    assert (a / "er" / "graph-shards-G2" / "meta.json").exists()
    rcfg = JaxForaConfig(epsilon=0.5).resolved(g.n, g.m)
    idx = tidx.load(str(a / "index" / "er"), rcfg)
    jax_store.save_sharded(idx, rcfg, str(tmp_path / "want"), 2, graph=g)
    _same_dirs(a / "index" / "er" / "shards-G2", tmp_path / "want" /
               "shards-G2")
    st = jax_store.ShardedIndexStore(str(a / "index" / "er"), 2, rcfg,
                                     graph=g)
    assert st.n_shards == 2


def test_sharded_batch_topk_matches_jax(dataset, tmp_path):
    """batch-topk --graph-shards 2 --query-shards 4 --exchange routed on
    the JAX-built index: the JAX CLI's ids where adjacent values differ by
    more than 1e-7, values at rtol 1e-5; then from the graph store and the
    sharded index store the same answers bit for bit."""
    jp, _, g = dataset
    flags = ["batch-topk", "--epsilon", "0.5", "--k", str(K), "--with-idx",
             "--batch", "8", "--start-level", "0", "--graph-shards", "2",
             "--query-shards", "4", "--exchange", "routed"]
    assert jax_cli.main(flags + ["--output", str(tmp_path / "jax.jsonl")]
                        + _base(jp)) == 0
    assert _port(*flags, "--output", str(tmp_path / "port.jsonl"),
                 prefix=jp) == 0
    want, got = _rows(tmp_path / "jax.jsonl"), _rows(tmp_path / "port.jsonl")
    assert set(got) == set(want) and len(got) == 12
    for s in want:
        wv = np.asarray(want[s]["vals"], np.float64)
        np.testing.assert_allclose(got[s]["vals"], wv, rtol=1e-5,
                                   err_msg=str(s))
        apart = np.abs(np.diff(wv)) > 1e-7
        sep = np.ones(len(wv), bool)
        sep[:-1] &= apart
        sep[1:] &= apart
        np.testing.assert_array_equal(np.asarray(got[s]["ids"])[sep],
                                      np.asarray(want[s]["ids"])[sep])
    assert _precision(g, got) >= 0.85
    # the stores: the graph store by shard-graph, the index's by the port
    from fora_tpu_torch import ForaConfig
    from fora_tpu_torch import index as tidx
    a = _prefix_copy(jp, tmp_path / "stores")
    assert _port("shard-graph", "--graph-shards", "2", prefix=a) == 0
    rcfg = ForaConfig(epsilon=0.5, k=K).resolved(g.n, g.m)
    idx = tidx.load(str(a / "index" / "er"), rcfg)
    tidx.save_sharded(idx, rcfg, str(a / "index" / "er"), 2, graph=g)
    assert _port(*flags, "--output", str(tmp_path / "stores.jsonl"),
                 prefix=a) == 0
    assert _rows(tmp_path / "stores.jsonl") == got


def test_refuses_cuda_without_cuda(dataset, capsys, monkeypatch):
    """Without --device cpu the CLI runs on CUDA or not at all."""
    _, tp, _ = dataset
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["query", "--k", str(K)] + _base(tp)) == 2
    assert "--device cpu" in capsys.readouterr().err
    assert cli.build_parser().parse_args(["query", "--dataset", "x"]
                                         ).device == "cuda"


def test_dropped_tpu_flags_are_refused(dataset):
    _, tp, _ = dataset
    for flag in ("--bf16-gather", "--push-pair", "--narrow-r",
                 "--stepped-push=on", "--jax-cache=off", "--gather-chunk=19"):
        with pytest.raises(SystemExit):
            cli.build_parser().parse_args(["query", "--dataset", "er", flag])


def _serve_and_ask(prefix, g, extra=()):
    """The port's CLI server as a subprocess on ``prefix``: three queries
    over TCP (precision@8 >= 0.75 each), then its stats."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "fora_tpu_torch.cli", "serve", "--with-idx",
         "--batch", "4", "--k", str(K), "--port", "0", "--device", "cpu",
         *extra] + _base(prefix), stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True, cwd=ROOT,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    try:
        line = proc.stdout.readline()
        assert "serving on" in line, line
        port = int(line.rsplit(":", 1)[1])
        deadline = time.time() + 60
        sock = None
        while sock is None and time.time() < deadline:
            try:
                sock = socket.create_connection(("127.0.0.1", port), 5)
            except OSError:
                time.sleep(0.2)
        assert sock is not None
        sock.settimeout(60)
        f = sock.makefile("rw")
        for i, s in enumerate([3, 99, 200]):
            f.write(json.dumps({"id": i, "source": s}) + "\n")
            f.flush()
            resp = json.loads(f.readline())
            assert resp["id"] == i and len(resp["nodes"]) == K, resp
            ex = jax_exact.exact_topk(g, s, K)[0]
            assert jax_metrics.precision_at_k(np.asarray(resp["nodes"]),
                                              ex) >= 0.75
        f.write('{"cmd": "stats"}\n')
        f.flush()
        stats = json.loads(f.readline())
        assert stats["queries"] >= 3 and stats["errors"] == 0
        sock.close()
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_serve_action_tcp(dataset):
    """The serve action end to end on the CPU: the port's CLI server, as a
    subprocess serving the JAX-built index, answers three queries over TCP
    (precision@8 >= 0.75 each), then its stats."""
    jp, _, g = dataset
    _serve_and_ask(jp, g)


def test_sharded_serve_tcp(dataset, tmp_path):
    """serve --graph-shards 2 --exchange compact: the sharded pool behind
    the server, reading the graph store, answers the same way."""
    jp, _, g = dataset
    a = _prefix_copy(jp, tmp_path / "stores")
    assert _port("shard-graph", "--graph-shards", "2", prefix=a) == 0
    _serve_and_ask(a, g, ("--graph-shards", "2", "--exchange", "compact"))
