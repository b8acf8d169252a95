"""The trace's reduction: busy time as the union of the device's
records in the stretch, kernels by short name, idle gaps named by the
innermost host op under them."""

import pytest

import pprbench_cases  # noqa: F401
from pprbench import trace


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_short_names():
    assert trace.short_name("(anonymous namespace)::gather_tasks_kernel<4, "
                            "32>((anonymous namespace)::Params)") == \
        "gather_tasks_kernel"
    assert trace.short_name("void raw_walk_kernel<false, false>(WalkArgs, "
                            "RawArgs)") == "raw_walk_kernel"
    assert trace.short_name("void at::native::elementwise_kernel<128, 2>"
                            "(int)") == "elementwise_kernel"


def test_summarize():
    events = [
        ev("user_annotation", trace.MARK, 0, 100),
        ev("gpu_user_annotation", trace.MARK, 10, 80),
        ev("kernel", "void gather_tasks_kernel<4>(P)", 10, 20),
        ev("kernel", "void gather_tasks_kernel<4>(P)", 25, 10),   # overlaps
        ev("gpu_memcpy", "Memcpy DtoH", 50, 10),
        ev("kernel", "void raw_walk_kernel<false>(A)", 95, 10),   # clipped
        ev("cpu_op", "aten::nonzero", 35, 20),
        ev("cuda_runtime", "cudaStreamSynchronize", 40, 5),
        ev("cpu_op", "aten::item", 60, 40),
    ]
    t = trace.summarize(events)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx((25 + 10 + 5) * 1e-6)
    assert t.kernel_s["gather_tasks_kernel"] == pytest.approx(30e-6)
    assert t.kernel_s["raw_walk_kernel"] == pytest.approx(5e-6)
    assert t.device_ops[0][0] == "gather_tasks_kernel"
    gaps = dict(t.idle_gaps)
    # [0, 10) no op, [35, 50) mid 42.5 under the sync, [60, 95) under item
    assert gaps["(no host op)"] == pytest.approx(10e-6)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(15e-6)
    assert gaps["aten::item"] == pytest.approx(35e-6)


def test_window_clip():
    events = [ev("user_annotation", trace.MARK, 0, 1000),
              ev("kernel", "k", 0, 50), ev("kernel", "k", 150, 50)]
    t = trace.summarize(events, (0.0, 100.0))
    assert t.busy_s == pytest.approx(50e-6)
    assert t.window_s == pytest.approx(100e-6)
