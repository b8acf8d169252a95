"""The port's host code against fora_tpu's: config derivation, CSR packing,
the generators (the toy fixtures, Erdos-Renyi and RMAT), query sources,
precision@k and the exact PPR oracle.

The port carries these (numpy) pieces itself so that it imports nothing of
the JAX package; here they are held equal to the originals they copy.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fora_tpu.algo import exact as jax_exact
from fora_tpu.config import ForaConfig as JaxForaConfig
from fora_tpu.eval import metrics as jax_metrics
from fora_tpu.eval import queries as jax_queries
from fora_tpu.graph import generators as jax_generators
from fora_tpu.graph.csr import from_edges as jax_from_edges
from fora_tpu_torch import ForaConfig, from_edges
from fora_tpu_torch.algo import exact
from fora_tpu_torch.eval import metrics, queries
from fora_tpu_torch.graph import generators

torch.set_num_threads(2)


@pytest.mark.parametrize("kw", [
    {}, {"epsilon": 0.2, "k": 100}, {"delta": 1e-4, "pfail": 1e-3},
    {"alpha": 0.15, "rmax_scale": 2.0, "walk_multiplier": 0.5,
     "max_push_iters": 7, "max_walk_hops": 9}])
def test_config_matches_jax(kw):
    ours = ForaConfig(**kw).resolved(4096, 32768)
    theirs = JaxForaConfig(**kw).resolved(4096, 32768)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    for d in (1 / 50, 1 / 3000):
        assert dataclasses.asdict(ours.with_delta(d)) == \
            dataclasses.asdict(theirs.with_delta(d))
    assert ours.omega(0.3) == theirs.omega(0.3)


def _assert_same_graph(ours, theirs):
    for f in ("out_indptr", "out_indices", "in_src", "in_dst", "out_deg",
              "in_deg"):
        a, b = getattr(ours, f), getattr(theirs, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert ours.out_w is None and ours.in_w is None
    assert (ours.n, ours.m, ours.weighted) == (theirs.n, theirs.m, False)


def test_from_edges_matches_jax():
    rng = np.random.default_rng(5)
    n = 300
    src = rng.integers(0, n, 5000)
    dst = rng.integers(0, n, 5000)
    src[:50], dst[:50] = 7, 7          # self-loops and parallel edges
    _assert_same_graph(from_edges(src, dst, n), jax_from_edges(src, dst, n))
    with pytest.raises(ValueError, match="range"):
        from_edges(np.array([0]), np.array([n]), n)


@pytest.mark.parametrize("n_log2,m,seed", [(8, 2048, 0), (12, 32768, 7)])
def test_rmat_matches_jax(n_log2, m, seed):
    _assert_same_graph(generators.rmat(n_log2, m, seed=seed),
                       jax_generators.rmat(n_log2, m, seed=seed))


@pytest.mark.parametrize("n,m,seed,no_loops", [(512, 4096, 3, True),
                                               (50, 2000, 1, False)])
def test_erdos_renyi_matches_jax(n, m, seed, no_loops):
    _assert_same_graph(generators.erdos_renyi(n, m, seed, no_loops),
                       jax_generators.erdos_renyi(n, m, seed, no_loops))


@pytest.mark.parametrize("name,args", [
    ("cycle_graph", (17,)), ("star_graph", (12,)), ("complete_graph", (9,)),
    ("karate_club", ())])
def test_toy_generators_match_jax(name, args):
    g = getattr(generators, name)(*args)
    _assert_same_graph(g, getattr(jax_generators, name)(*args))
    assert g.m == {"cycle_graph": 17, "star_graph": 11,
                   "complete_graph": 72, "karate_club": 156}[name]


def test_generate_sources_matches_jax():
    g = generators.rmat(10, 4096, seed=3)
    for count, seed, req in ((64, 8, True), (2000, 1, True), (10, 2, False)):
        np.testing.assert_array_equal(
            queries.generate_sources(g, count, seed, req),
            jax_queries.generate_sources(g, count, seed, req))


def test_precision_matches_jax():
    rng = np.random.default_rng(4)
    pred = rng.integers(0, 60, (8, 50))
    ex = rng.integers(0, 60, (8, 50))
    assert metrics.batch_precision_at_k(pred, ex) == \
        jax_metrics.batch_precision_at_k(pred, ex)
    assert metrics.precision_at_k(np.arange(50), np.arange(50)[::-1]) == 1.0


@pytest.mark.parametrize("graph", ["rmat", "star"])
def test_exact_ppr_matches_jax(graph):
    """The oracle on torch (float64 sparse SpMM) against fora_tpu's scipy
    power iteration: the same vectors, and top-k lists whose exact values
    agree (ids may differ only among exact ties)."""
    if graph == "rmat":
        g = generators.rmat(11, 16384, seed=9)   # has dangling nodes
    else:
        g = from_edges(np.zeros(9, np.int64), np.arange(1, 10), 10)
    sources = queries.generate_sources(g, 6, seed=2)
    got = exact.exact_ppr_batch(g, sources, device="cpu").numpy()
    want = jax_exact.exact_ppr_power_batch(g, sources, threads=1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.sum(axis=0), 1.0, atol=1e-9)
    k = 5
    ids = exact.exact_topk_batch(g, sources, k, device="cpu")
    ref = jax_exact.exact_topk_batch(g, sources, k)
    cols = np.arange(len(sources))[:, None]
    np.testing.assert_allclose(want.T[cols, ids], want.T[cols, ref],
                               rtol=0, atol=1e-12)
    assert (np.diff(want.T[cols, ids], axis=1) <= 1e-15).all()


def test_exact_topk_breaks_ties_by_lowest_id():
    """Exact ties at rank k resolve by node id ascending, as every top-k
    of both packages does: 0 -> {1, 2} (1 and 2 tie, dangling) and 5 -> 6;
    each source reaches fewer than k = 5 nodes, so its list ends with the
    lowest-numbered nodes of PPR zero."""
    g = from_edges(np.array([0, 0, 5]), np.array([1, 2, 6]), 10)
    ids = exact.exact_topk_batch(g, [0, 5], 5, device="cpu")
    assert ids.tolist() == [[1, 2, 0, 3, 4], [6, 5, 0, 1, 2]]


# ---- the CLI's host modules: copies held to their originals ----------------

def _defs(module, names=None):
    """{name: ast dump} of the module's top-level functions and classes,
    docstrings dropped (the copies say where they come from)."""
    import ast
    import inspect
    tree = ast.parse(inspect.getsource(module))
    out = {}
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and \
                isinstance(body[0], ast.Expr) and \
                isinstance(getattr(body[0], "value", None), ast.Constant) \
                and isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            if names is None or node.name in names:
                out[node.name] = ast.dump(node)
    return out


@pytest.mark.parametrize("pair", ["logging", "timers", "serve"])
def test_host_copies_match_originals(pair):
    """logging (info, RunLog), timers (Timers) and serve (ForaServer,
    serve_forever) are the originals' code, apart from docstrings."""
    import importlib
    ours = importlib.import_module(
        {"logging": "fora_tpu_torch.utils.logging",
         "timers": "fora_tpu_torch.utils.timers",
         "serve": "fora_tpu_torch.serve"}[pair])
    theirs = importlib.import_module(
        {"logging": "fora_tpu.utils.logging",
         "timers": "fora_tpu.utils.timers",
         "serve": "fora_tpu.serve"}[pair])
    a, b = _defs(ours), _defs(theirs)
    assert a and set(a) == set(b)
    for name in a:
        assert a[name] == b[name], name


def test_runlog_and_timers_behave_as_originals(tmp_path, capsys):
    from fora_tpu.utils import logging as jlog
    from fora_tpu.utils import timers as jtimers
    from fora_tpu_torch.utils import logging as tlog
    from fora_tpu_torch.utils import timers as ttimers
    recs = []
    for mod, name in ((tlog, "t"), (jlog, "j")):
        log = mod.RunLog(str(tmp_path / name / "run.jsonl"))
        rec = log.event("eval", precision_at_k=0.5, k=3)
        recs.append({k: v for k, v in rec.items() if k != "ts"})
        line = (tmp_path / name / "run.jsonl").read_text()
        assert json_keys(line) == ["ts", "kind", "precision_at_k", "k"]
        mod.info("hello", a=1)
    assert recs[0] == recs[1]
    err = capsys.readouterr().err.splitlines()
    assert err == ["[fora-tpu] hello  a=1"] * 2
    for mod in (ttimers, jtimers):
        t = mod.Timers()
        assert t.timed("x", lambda v: v + 1, 1) == 2
        with t.phase("y"):
            pass
        assert t.count == {"x": 1, "y": 1} and set(t.as_dict()) == {"x", "y"}
        assert t.report().splitlines()[0] == "---- timers ----"
    assert ttimers.Timers().timed("z", lambda: torch.ones(3)).sum() == 3


def json_keys(line):
    import json
    return list(json.loads(line))


def test_profiling_on_the_cpu(tmp_path):
    """fence passes CPU tensors (and containers of them) through; measure
    returns a median; SpmvRoofline counts JAX's bytes; the memory rate is
    known only for the port's card, by name; trace writes a Chrome trace."""
    from fora_tpu.utils import profiling as jprof
    from fora_tpu_torch.utils import profiling
    x = {"a": (torch.ones(2), [torch.zeros(1)]), "b": 3}
    assert profiling.fence(x) is x
    assert profiling.measure(lambda: torch.ones(4), reps=3) >= 0.0
    ours = profiling.SpmvRoofline(edges=1000, batch=8, nodes=100)
    theirs = jprof.SpmvRoofline(edges=1000, batch=8, nodes=100)
    assert ours.bytes_moved == theirs.bytes_moved
    assert ours.light_speed_secs(3.35e12) == theirs.light_speed_secs(3.35e12)
    assert ours.efficiency(1e-3, 1e12) == theirs.efficiency(1e-3, 1e12)
    with pytest.raises(ValueError):
        profiling.device_hbm_bw("cpu")
    assert profiling.HBM_BW == {"NVIDIA H100 80GB HBM3": 3.35e12}
    with profiling.trace(str(tmp_path / "tr")):
        torch.ones(16).sum()
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0


def test_queries_files_and_metrics_match_originals(tmp_path):
    rng = np.random.default_rng(12)
    src = rng.integers(0, 10**6, 50)
    queries.save_queries(src, str(tmp_path / "t.query"))
    jax_queries.save_queries(src, str(tmp_path / "j.query"))
    assert (tmp_path / "t.query").read_bytes() == \
        (tmp_path / "j.query").read_bytes()
    for f in ("t.query", "j.query"):
        got = queries.load_queries(str(tmp_path / f))
        want = jax_queries.load_queries(str(tmp_path / f))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, src)
    pred = rng.integers(0, 60, (8, 50))
    ex = rng.integers(0, 60, (8, 50))
    short = pred[:, :30]
    for a, b in ((pred, ex), (short, ex)):
        assert metrics.batch_recall_at_k(a, b) == \
            jax_metrics.batch_recall_at_k(a, b)
        assert metrics.recall_at_k(a[0], b[0]) == \
            jax_metrics.recall_at_k(a[0], b[0])
    pi = rng.random(200) * 1e-2
    hat = pi * (1 + rng.normal(0, 0.1, 200))
    for delta in (1e-3, 5e-3, 1.0):
        for f in ("max_relative_error", "mean_relative_error"):
            assert getattr(metrics, f)(hat, pi, delta) == \
                getattr(jax_metrics, f)(hat, pi, delta)


def _write_graph(path, text):
    path.mkdir(parents=True, exist_ok=True)
    (path / "graph.txt").write_text(text)


@pytest.mark.parametrize("weighted", [False, True])
def test_dataset_io_matches_originals(tmp_path, monkeypatch, weighted):
    """save_dataset writes the original's bytes; load_dataset for the CPU
    (the numpy branch) gives the original's arrays with its native parser
    off; each reads the other's csr_cache.npz."""
    from fora_tpu.graph import io as jio
    from fora_tpu_torch.graph import io as tio
    monkeypatch.setattr(jio, "native_parse_edges", None)
    monkeypatch.setattr(jio, "native_parse_edges_w", None)
    g0 = generators.rmat(10, 8192, seed=5)
    g = g0
    if weighted:
        src = np.repeat(np.arange(g0.n), g0.out_deg)
        w = np.exp2(np.random.default_rng(2).uniform(-2, 2, g0.m))
        g = from_edges(src, g0.out_indices, g0.n, w=w.astype(np.float32))
    tio.save_dataset(g, str(tmp_path / "t"), "d")
    jio.save_dataset(g, str(tmp_path / "j"), "d")
    for f in ("graph.txt", "attribute.txt"):
        assert (tmp_path / "t" / "d" / f).read_bytes() == \
            (tmp_path / "j" / "d" / f).read_bytes(), f
    assert tio.load_attribute(tmp_path / "t" / "d") == (g.n, g.m)
    ours = tio.load_dataset(str(tmp_path / "t"), "d", device="cpu")
    theirs = jio.load_dataset(str(tmp_path / "j"), "d")
    for f in theirs._fields:
        a, b = getattr(ours, f), getattr(theirs, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    # each package's cache, read by the other
    assert (tmp_path / "t" / "d" / "csr_cache.npz").exists()
    cross_t = tio.load_dataset(str(tmp_path / "j"), "d", device="cpu")
    cross_j = jio.load_dataset(str(tmp_path / "t"), "d")
    for f in theirs._fields:
        for a in (getattr(cross_t, f), getattr(cross_j, f)):
            if a is not None:
                np.testing.assert_array_equal(a, getattr(theirs, f))


def test_dataset_writer_edge_cases(tmp_path):
    """Zero, large and repeated ids, isolated nodes and an empty graph:
    the vectorised writer's bytes are the original's np.savetxt bytes."""
    from fora_tpu.graph import io as jio
    from fora_tpu_torch.graph import io as tio
    n = 2_000_000
    src = np.array([0, 0, 9, 10, 99, 1_999_999, 123_456], np.int64)
    dst = np.array([0, 1_999_999, 10, 9, 100_000, 0, 7], np.int64)
    for name, g in (("mixed", from_edges(src, dst, n)),
                    ("empty", from_edges(np.zeros(0, np.int64),
                                         np.zeros(0, np.int64), 5))):
        tio.save_dataset(g, str(tmp_path / "t"), name)
        jio.save_dataset(g, str(tmp_path / "j"), name)
        assert (tmp_path / "t" / name / "graph.txt").read_bytes() == \
            (tmp_path / "j" / name / "graph.txt").read_bytes(), name


def test_detect_weighted_and_bad_lines(tmp_path):
    from fora_tpu.graph import io as jio
    from fora_tpu_torch.graph import io as tio
    cases = {"u": "# c\n0 1\n\n1 2\n", "w": "0 1 0.5\n1 2 2\n",
             "mixed": "0 1\n1 2 0.5\n"}
    for name, text in cases.items():
        _write_graph(tmp_path / name, text)
        p = tmp_path / name / "graph.txt"
        if name == "mixed":
            for mod in (tio, jio):
                with pytest.raises(ValueError, match="mixed column"):
                    mod._detect_weighted(p)
        else:
            assert tio._detect_weighted(p) == jio._detect_weighted(p) == \
                (name == "w")
    u = tio.parse_edges_numpy(tmp_path / "u" / "graph.txt", False)
    assert u[0].tolist() == [0, 1] and u[1].tolist() == [1, 2] and u[2] is None
    w = tio.parse_edges_numpy(tmp_path / "w" / "graph.txt", True)
    assert w[2].dtype == np.float32 and w[2].tolist() == [0.5, 2.0]
    (tmp_path / "a").mkdir()
    (tmp_path / "a" / "attribute.txt").write_text("n=3\n")
    with pytest.raises(ValueError, match="attribute"):
        tio.load_attribute(tmp_path / "a")


@pytest.mark.parametrize("graph", ["er", "weighted"])
def test_exact_topk_and_power_batch_match_jax(graph):
    """exact_ppr_power_batch and exact_topk (the CLI's gen-exact-topk and
    sweep oracle) against fora_tpu's: vectors within 1e-12; top-k values
    equal, ids equal apart from exact ties."""
    g = generators.erdos_renyi(300, 2400, seed=4)
    if graph == "weighted":
        src = np.repeat(np.arange(g.n), g.out_deg)
        w = np.random.default_rng(1).uniform(0.1, 5.0, g.m)
        g = from_edges(src, g.out_indices, g.n, w=w.astype(np.float32))
    sources = queries.generate_sources(g, 5, seed=3)
    got = exact.exact_ppr_power_batch(g, sources, device="cpu")
    want = jax_exact.exact_ppr_power_batch(g, sources, threads=1)
    assert got.dtype == np.float64 and got.shape == (g.n, 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    ids, vals = exact.exact_topk_many(g, sources, 20, device="cpu", batch=2)
    for b, s in enumerate(sources):
        i1, v1 = exact.exact_topk(g, int(s), 20, device="cpu")
        np.testing.assert_allclose(v1, vals[b], rtol=0, atol=1e-14)
        ji, jv = jax_exact.exact_topk(g, int(s), 20)
        np.testing.assert_allclose(v1, jv, rtol=0, atol=1e-12)
        sep = np.abs(np.diff(jv)) > 1e-9
        keep = np.concatenate([sep, [True]]) & np.concatenate([[True], sep])
        np.testing.assert_array_equal(i1[keep], ji[keep])
        np.testing.assert_array_equal(ids[b][keep], ji[keep])
