"""The whole slice: fora_tpu_torch's TopkRunner against fora_tpu's on the
smoke graph and its FORA+ index, start level pinned.

Per query the two must agree on ids, values, bounds, ``accepted`` and the
levels used.  Tie rule (value descending, node id ascending) is shared;
float order differs (rtol 1e-5 on values and bounds), and a query whose
k-th value sits within 1e-5 relative of a level's threshold (1 + eps) delta
may accept at another level in either package, so such queries are
exempt from the exact comparison.
"""

import jax
import numpy as np
import pytest
import torch

from fora_tpu import index as jax_index
from fora_tpu.algo import topk as jax_topk
from fora_tpu.config import ForaConfig
from fora_tpu.eval import metrics
from fora_tpu.eval import queries as qio
from fora_tpu.graph import to_device as jax_to_device
from fora_tpu.graph.csr import CSRGraph
from fora_tpu_torch import ForaConfig as TorchForaConfig
from fora_tpu_torch import index as tidx
from fora_tpu_torch.algo.topk import TopkRunner, delta_schedule
from fora_tpu_torch.graph import to_device

torch.set_num_threads(2)

SMOKE_IDX = "bench_data_smoke/rmat12x8s7.idx.e0.5"
SMOKE_EXACT = "bench_data_smoke/rmat12x8s7.exact4.d1975b620f.k50.npz"
K, EPS, STRIDE = 50, 0.5, 8.0


def _smoke():
    z = np.load("bench_data_smoke/rmat12x8s7.npz")
    g = CSRGraph(**{k: z[k] for k in CSRGraph._fields if k in z.files})
    rcfg = ForaConfig(epsilon=EPS, k=K).resolved(g.n, g.m)
    # the smoke exact file holds the top-50 of the first 4 of these
    return g, rcfg, qio.generate_sources(g, 64, seed=8)


def _runners(g, rcfg, hub_rows=256, stride=STRIDE):
    """JAX's runner on ``rcfg``; the port's on its own config, which
    resolves to the same numbers."""
    jr = jax_topk.TopkRunner(
        jax_to_device(g, merge_duplicate_edges=True, hub_rows=hub_rows),
        rcfg, k=K, index=jax_index.load(SMOKE_IDX, rcfg, graph=g),
        delta_stride=stride)
    trc = TorchForaConfig(epsilon=EPS, k=K).resolved(g.n, g.m)
    assert trc.__dict__ == rcfg.__dict__
    tr = TopkRunner(
        to_device(g, merge_duplicate_edges=True, hub_rows=hub_rows,
                  device="cpu"),
        trc, k=K, index=tidx.load(SMOKE_IDX, trc, graph=g, mmap=True),
        delta_stride=stride)
    return jr, tr


def _at_edge(values, deltas):
    kth = values[:, -1:].astype(np.float64)
    thr = (1 + EPS) * np.asarray(deltas)[None, :]
    return (np.abs(kth - thr) <= 1e-5 * thr).any(axis=1)


def _assert_agree(want, got, deltas):
    exempt = _at_edge(want.values, deltas) | _at_edge(got.values, deltas)
    ok = ~exempt
    assert ok.mean() > 0.9
    np.testing.assert_array_equal(got.node_ids[ok], want.node_ids[ok])
    np.testing.assert_array_equal(got.accepted[ok], want.accepted[ok])
    for f in ("values", "lower_bounds", "upper_bounds"):
        np.testing.assert_allclose(getattr(got, f)[ok], getattr(want, f)[ok],
                                   rtol=1e-5, atol=1e-12, err_msg=f)


def test_delta_schedule_matches_jax():
    g, rcfg, _ = _smoke()
    for stride in (2.0, 4.0, 8.0):
        assert delta_schedule(rcfg, K, stride) == \
            jax_topk.delta_schedule(rcfg, K, stride)


@pytest.mark.parametrize("start_level", [0, 1])
def test_query_pool_matches_jax(start_level):
    g, rcfg, sources = _smoke()
    src = sources[:32]
    jr, tr = _runners(g, rcfg)
    want = jr.query_pool(src, jax.random.key(1), batch=32,
                         start_level=start_level)
    got = tr.query_pool(src, batch=32, start_level=start_level)
    _assert_agree(want, got, tr.deltas)
    assert got.levels_used == want.levels_used
    assert [(s["level"], s["pending"], s["accepted"], s["width"])
            for s in tr.last_level_stats] == \
        [(s["level"], s["pending"], s["accepted"], s["width"])
         for s in jr.last_level_stats]
    # precision@50 on the smoke exact file's queries, within 0.01 of JAX's
    ex = np.load(SMOKE_EXACT)["ids"]
    p_t = metrics.batch_precision_at_k(got.node_ids[:4], ex)
    p_j = metrics.batch_precision_at_k(want.node_ids[:4], ex)
    assert abs(p_t - p_j) <= 0.01
    assert p_t >= 0.9


def test_deferred_flush_matches_jax():
    """Two pools with stragglers stashed and flushed together (bench.py's
    flow), hub split off; stride 2 leaves levels to defer to."""
    g, rcfg, sources = _smoke()
    jr, tr = _runners(g, rcfg, hub_rows=0, stride=2.0)
    key = jax.random.key(2)
    results = []
    for runner, is_jax in ((jr, True), (tr, False)):
        out = {}
        for pool in (sources[:16], sources[16:32]):
            res = (runner.query_pool(pool, key, batch=16, start_level=0,
                                     defer_below=12) if is_jax else
                   runner.query_pool(pool, batch=16, start_level=0,
                                     defer_below=12))
            for i, s in enumerate(pool):
                if not res.deferred[i]:
                    out[int(s)] = (res.node_ids[i], res.accepted[i])
        dsrcs, dres = (runner.flush_deferred(key, batch=16) if is_jax else
                       runner.flush_deferred(batch=16))
        assert dres is not None
        for i, s in enumerate(dsrcs):
            out[int(s)] = (dres.node_ids[i], dres.accepted[i])
        results.append(out)
    want, got = results
    assert sorted(want) == sorted(got)
    same = sum(np.array_equal(want[s][0], got[s][0]) for s in want)
    assert same == len(want)
    assert sum(got[s][1] for s in got) == sum(want[s][1] for s in want)


def test_query_matches_jax():
    g, rcfg, sources = _smoke()
    src = sources[32:40]
    jr, tr = _runners(g, rcfg)
    want = jr.query(src.astype(np.int32), jax.random.key(3))
    got = tr.query(src)
    _assert_agree(want, got, tr.deltas)
    assert got.levels_used == want.levels_used


def test_level_stats_roundtrip(tmp_path):
    g, rcfg, sources = _smoke()
    _, tr = _runners(g, rcfg)
    tr.query_pool(sources[:32], batch=32)
    path = tmp_path / "stats.json"
    tr.save_level_stats(path, "sha")
    _, fresh = _runners(g, rcfg)
    assert fresh.load_level_stats(path, "sha")
    assert fresh.auto_start_level == tr.auto_start_level
    assert not fresh.load_level_stats(path, "other-sha")
