"""Timing on the card: CUDA events for kernels and for the stages of a
level (``StageClock``), a phase line for scripts.

Takes the place of ``fora_tpu/utils/profiling.py::measure``/``fence``.
A kernel's time is the elapsed time between two CUDA events around a run
of launches on the current stream, divided by the launch count; a phase's
time is the host clock around work that ends in a device synchronise.
``cuda_ms`` times the launches as called: a kernel shorter than its
wrapper's host work then reads the host's pace.  ``device_ms`` holds the
stream with a spin kernel while the host queues the launches, so the
events see the device's time alone.
"""

from __future__ import annotations

import contextlib
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


def device_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` launches after
    ``warmup``, with the host's enqueue hidden: a spin kernel
    (``torch.cuda._sleep``), sized at twice the host's time to queue the
    launches (at 2 GHz), runs before the first event while the host
    queues them.  ``fn`` must not synchronise."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host_s * 2e9) + 1_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


class StageClock:
    """Milliseconds per named stage of a run, summed over its repeats:
    CUDA events on a card (no synchronise until ``ms()``), the host clock
    on the CPU, nothing for ``device=None``."""

    def __init__(self, device):
        self._dev = None if device is None else torch.device(device)
        self._kind = None if device is None else self._dev.type
        self._marks = []     # (name, start, end)

    @contextlib.contextmanager
    def stage(self, name: str):
        if self._kind is None:
            yield
            return
        if self._kind == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            stream = torch.cuda.current_stream(self._dev)
            start.record(stream)
            yield
            end.record(stream)
        else:
            start = time.perf_counter()
            yield
            end = time.perf_counter()
        self._marks.append((name, start, end))

    def ms(self) -> dict:
        out = {}
        for name, start, end in self._marks:
            if self._kind == "cuda":
                end.synchronize()
                t = start.elapsed_time(end)
            else:
                t = (end - start) * 1e3
            out[name] = out.get(name, 0.0) + t
        return out


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
