"""The port's serving loop (``fora_tpu_torch.serve.ForaServer``): the six
cases of ``tests/test_serve.py`` (protocol, micro-batching, k clamp and
errors, backpressure, pipelined batchers, the precision sampler and its
stride), and a CPU ``TopkRunner`` answering from the server's worker
thread."""

import asyncio
import json
import threading
import time

import numpy as np
import pytest
import torch

from fora_tpu_torch.serve import ForaServer

torch.set_num_threads(2)


def _echo_query_fn(sources, seed):
    """Fake engine: top-3 'nodes' are source, source+1, source+2."""
    B = len(sources)
    ids = np.stack([sources + i for i in range(3)], axis=1)
    vals = np.tile(np.array([0.5, 0.3, 0.2], np.float32), (B, 1))
    return ids, vals


async def _roundtrip(port, requests):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    out = []
    for req in requests:
        writer.write((json.dumps(req) + "\n").encode())
        await writer.drain()
        out.append(json.loads(await reader.readline()))
    writer.close()
    return out


def test_server_roundtrip_and_batching():
    async def main():
        srv = ForaServer(_echo_query_fn, batch=4, k=3, max_wait_ms=10)
        port = await srv.start(port=0)
        results = await asyncio.gather(
            *[_roundtrip(port, [{"id": i, "source": 10 + i}])
              for i in range(6)])
        for i, [resp] in enumerate(results):
            assert resp["id"] == i
            assert resp["nodes"] == [10 + i, 11 + i, 12 + i]
            assert resp["scores"] == pytest.approx([0.5, 0.3, 0.2])
        stats = (await _roundtrip(port, [{"cmd": "stats"}]))[0]
        assert stats["queries"] == 6
        assert stats["batches"] <= 6
        await srv.stop()

    asyncio.run(main())


def test_server_k_clamp_and_errors():
    async def main():
        srv = ForaServer(_echo_query_fn, batch=2, k=3, max_wait_ms=1)
        port = await srv.start(port=0)
        [r1, r2, r3] = await _roundtrip(port, [
            {"id": "a", "source": 5, "k": 2},
            {"not_source": 1},
            {"id": "b", "source": 7, "k": 99},
        ])
        assert r1["nodes"] == [5, 6]
        assert "error" in r2
        assert len(r3["nodes"]) == 3      # clamped to server k
        await srv.stop()

    asyncio.run(main())


def test_server_backpressure_sheds_load():
    """A saturated engine with a bounded queue sheds excess requests with
    an explicit 'overloaded' error instead of queueing unboundedly."""
    def slow_fn(sources, seed):
        time.sleep(0.2)
        return _echo_query_fn(sources, seed)

    async def main():
        srv = ForaServer(slow_fn, batch=1, k=3, max_wait_ms=1,
                         inflight=1, max_pending=1,
                         admission_timeout_ms=30.0)
        port = await srv.start(port=0)
        results = await asyncio.gather(
            *[_roundtrip(port, [{"id": i, "source": i}])
              for i in range(8)])
        flat = [r for [r] in results]
        ok = [r for r in flat if "nodes" in r]
        shed = [r for r in flat if r.get("error") == "overloaded"]
        assert len(ok) + len(shed) == 8
        assert shed, "expected load shedding under saturation"
        stats = (await _roundtrip(port, [{"cmd": "stats"}]))[0]
        assert stats["shed"] == len(shed)
        assert stats["latency_ms_p50"] is not None
        await srv.stop()

    asyncio.run(main())


def test_server_pipelined_batchers():
    """Two in-flight batchers overlap calls: 4 sequential batches complete
    in about half the wall-clock time with inflight=2."""
    def slow_fn(sources, seed):
        time.sleep(0.15)
        return _echo_query_fn(sources, seed)

    async def run(inflight):
        srv = ForaServer(slow_fn, batch=2, k=3, max_wait_ms=1,
                         inflight=inflight, max_pending=64)
        port = await srv.start(port=0)
        t0 = time.monotonic()
        results = await asyncio.gather(
            *[_roundtrip(port, [{"id": i, "source": i}])
              for i in range(8)])
        dt = time.monotonic() - t0
        for i, [r] in enumerate(results):
            assert r["nodes"][0] == i
        await srv.stop()
        return dt

    async def main():
        seq = await run(1)
        pipe = await run(2)
        assert pipe < seq * 0.85, (seq, pipe)

    asyncio.run(main())


def test_server_precision_slo_sampling():
    """Every Nth scorable answer lands in the rolling precision window;
    stats reports the rolling mean."""
    exact = {s: np.array([s, s + 1, s + 2]) if s % 2 == 0
             else np.array([s, s + 1, 99999]) for s in range(10, 18)}

    async def main():
        srv = ForaServer(_echo_query_fn, batch=2, k=3, max_wait_ms=1,
                         slo_exact=exact, slo_sample_every=1)
        port = await srv.start(port=0)
        await asyncio.gather(
            *[_roundtrip(port, [{"id": i, "source": 10 + i}])
              for i in range(8)])
        # an unscorable source (no ground truth) is not sampled
        await _roundtrip(port, [{"id": "x", "source": 500}])
        stats = (await _roundtrip(port, [{"cmd": "stats"}]))[0]
        assert stats["slo_samples"] == 8
        assert stats["slo_k"] == 3
        assert stats["precision_at_k"] == pytest.approx(
            (4 * 1.0 + 4 * (2 / 3)) / 8, abs=1e-4)
        await srv.stop()

    asyncio.run(main())


def test_server_precision_slo_sampling_stride():
    """slo_sample_every=4 scores every 4th scorable answer only."""
    exact = {s: np.array([s, s + 1, s + 2]) for s in range(10, 26)}

    async def main():
        srv = ForaServer(_echo_query_fn, batch=2, k=3, max_wait_ms=1,
                         slo_exact=exact, slo_sample_every=4)
        port = await srv.start(port=0)
        for i in range(16):
            await _roundtrip(port, [{"id": i, "source": 10 + i}])
        stats = (await _roundtrip(port, [{"cmd": "stats"}]))[0]
        assert stats["slo_samples"] == 4
        assert stats["precision_at_k"] == pytest.approx(1.0)
        await srv.stop()

    asyncio.run(main())


def test_server_failed_batch_reports_internal_error():
    """A query_fn that raises fails its batch with "internal" and counts an
    error; the batcher lives on and answers the next request."""
    calls = []

    def flaky(sources, seed):
        calls.append(seed)
        if len(calls) == 1:
            raise RuntimeError("device lost")
        return _echo_query_fn(sources, seed)

    async def main():
        srv = ForaServer(flaky, batch=1, k=3, max_wait_ms=1, inflight=1)
        port = await srv.start(port=0)
        [r1, r2] = await _roundtrip(port, [{"id": 1, "source": 4},
                                           {"id": 2, "source": 9}])
        assert r1 == {"error": "internal"}
        assert r2["nodes"] == [9, 10, 11]
        stats = (await _roundtrip(port, [{"cmd": "stats"}]))[0]
        assert stats["errors"] == 1 and stats["queries"] == 1
        await srv.stop()

    asyncio.run(main())


def test_server_over_cpu_topk_runner():
    """A CPU TopkRunner under the server, as the CLI's serve action wires
    it (query_pool with an integer seed, inflight=1): query_fn runs on the
    server's worker thread, not the event loop's, and each answer equals
    the runner's own for that source."""
    from fora_tpu_torch import ForaConfig, TopkRunner, to_device
    from fora_tpu_torch.graph import generators
    from fora_tpu_torch.index import build_walk_index
    g = generators.rmat(9, 4096, seed=2)
    rcfg = ForaConfig(epsilon=0.5, k=5).resolved(g.n, g.m)
    dg = to_device(g, device="cpu")
    runner = TopkRunner(dg, rcfg, k=5, index=build_walk_index(dg, rcfg, 3),
                        delta_stride=4.0)
    threads = set()

    def query_fn(sources, seed):
        threads.add(threading.get_ident())
        res = runner.query_pool(np.asarray(sources), int(seed), batch=4,
                                start_level=0)
        return res.node_ids, res.values

    sources = [3, 17, 40, 99, 200]
    want = runner.query_pool(np.asarray(sources), 1, batch=4, start_level=0)

    async def main():
        srv = ForaServer(query_fn, batch=4, k=5, max_wait_ms=1, inflight=1)
        port = await srv.start(port=0)
        out = await _roundtrip(port, [{"id": i, "source": s}
                                      for i, s in enumerate(sources)])
        stats = (await _roundtrip(port, [{"cmd": "stats"}]))[0]
        await srv.stop()
        return out, stats

    out, stats = asyncio.run(main())
    assert threading.get_ident() not in threads and len(threads) == 1
    assert stats["errors"] == 0 and stats["queries"] == len(sources)
    for i, r in enumerate(out):
        assert r["id"] == i and len(r["nodes"]) == 5
        # the indexed path is deterministic: the same ids at any width
        assert r["nodes"] == want.node_ids[i].tolist()
        np.testing.assert_allclose(r["scores"], want.values[i], rtol=1e-5)
