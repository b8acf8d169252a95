"""Timing on the card: CUDA events for kernels, a phase line for scripts.

Takes the place of ``fora_tpu/utils/profiling.py::measure``/``fence``.
A kernel's time is the elapsed time between two CUDA events around a run
of launches on the current stream, divided by the launch count; a phase's
time is the host clock around work that ends in a device synchronise.
"""

from __future__ import annotations

import time

import torch


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` launches after
    ``warmup`` launches."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


class Phase:
    """``with Phase("name") as ph:`` prints one line on exit: wall
    seconds (after a device synchronise) and the peak device memory
    allocated since entry.  ``ph.secs`` and ``ph.peak_bytes`` keep them."""

    def __init__(self, name: str):
        self.name = name
        self.secs = None
        self.peak_bytes = None

    def __enter__(self):
        torch.cuda.reset_peak_memory_stats()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        torch.cuda.synchronize()
        self.secs = time.perf_counter() - self._t0
        self.peak_bytes = torch.cuda.max_memory_allocated()
        status = "ok" if exc_type is None else f"FAILED ({exc_type.__name__})"
        print(f"[phase] {self.name}: {status} {self.secs:.3f} s, peak device "
              f"memory {self.peak_bytes / 2**30:.3f} GiB", flush=True)
        return False
