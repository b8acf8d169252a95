"""The device trace of a stretch of the measured window (``--trace 1``).

``Tracer`` runs ``torch.profiler`` (host ops and the device's kernels,
copies and sets) over a stretch, exports the Chrome trace to a temporary
file, reads it back and deletes it.  From the device's records it takes
the seconds in which some operation ran (the union of their intervals,
clipped to the stretch), each kernel's device seconds by name, and the
idle gaps, each named by the innermost host operation under its midpoint
(what the host was doing while the device waited).
"""

from __future__ import annotations

import heapq
import json
import os
import re
import tempfile
from collections import defaultdict
from typing import NamedTuple, Optional

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
MARK = "pprbench.traced_stretch"
TOP = 10


class Trace(NamedTuple):
    busy_s: float          # union of the device's operations in the stretch
    window_s: float        # the stretch's length
    kernel_s: dict         # short kernel name -> device seconds
    device_ops: list       # [[name, seconds]] most time first, at most TOP
    idle_gaps: list        # [[host op, seconds]] most idle first


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters: ``void gather_tasks_kernel<...>(Params)`` ->
    ``gather_tasks_kernel``; namespaces dropped."""
    base = re.sub(r"^void\s+", "",
                  name.replace("(anonymous namespace)::", "").strip())
    base = re.split(r"[<(]", base, maxsplit=1)[0].strip()
    return base.split("::")[-1] or name


def _union(intervals, lo: float, hi: float) -> tuple:
    """(covered length, merged intervals) of ``intervals`` clipped to
    [lo, hi]."""
    merged = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def _gap_labels(gaps, host) -> dict:
    """Idle microseconds by the innermost host event covering each gap's
    midpoint (``host``: (start, end, name)); ``(no host op)`` where none
    does."""
    out = defaultdict(float)
    host = sorted(host)
    heap, i = [], 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (a + b)
        while i < len(host) and host[i][0] <= mid:
            s, e, name = host[i]
            heapq.heappush(heap, (e - s, e, name))
            i += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        out[heap[0][2] if heap else "(no host op)"] += b - a
    return out


def summarize(events: list, window_us: Optional[tuple] = None) -> Trace:
    """A ``Trace`` from Chrome-trace events; the stretch is the ``MARK``
    annotation's interval (``window_us`` where given)."""
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
    if window_us is None:
        marks = [e for e in complete if e.get("name") == MARK
                 and e.get("cat") == "user_annotation"]
        if marks:
            window_us = (float(marks[0]["ts"]),
                         float(marks[0]["ts"]) + float(marks[0]["dur"]))
    dev = [e for e in complete if e.get("cat") in DEVICE_CATS]
    if window_us is None:
        stamps = [float(e["ts"]) for e in complete] + \
            [float(e["ts"]) + float(e["dur"]) for e in complete]
        window_us = (min(stamps), max(stamps)) if stamps else (0.0, 0.0)
    lo, hi = window_us
    busy, merged = _union(((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                           for e in dev), lo, hi)
    by_name = defaultdict(float)
    for e in dev:
        a = max(float(e["ts"]), lo)
        b = min(float(e["ts"]) + float(e["dur"]), hi)
        if b > a:
            by_name[short_name(e["name"]) if e["cat"] == "kernel"
                    else e["cat"]] += (b - a) * 1e-6
    gaps, prev = [], lo
    for a, b in merged:
        if a > prev:
            gaps.append((prev, a))
        prev = b
    if hi > prev:
        gaps.append((prev, hi))
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in complete if e.get("cat") in HOST_CATS
            and e.get("name") != MARK]
    # the host's side of the stretch: the annotation as the host ran it
    idle = _gap_labels(gaps, host)

    def top(d, scale=1.0):
        return [[k, v * scale] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return Trace(busy_s=busy * 1e-6, window_s=(hi - lo) * 1e-6,
                 kernel_s=dict(by_name), device_ops=top(by_name),
                 idle_gaps=top(idle, 1e-6))


class Tracer:
    """``start()``/``stop()`` around a stretch of the window; ``stop``
    returns the stretch's ``Trace``.  Disabled, both do nothing and
    ``stop`` returns None."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._prof = None
        self._mark = None

    def start(self) -> None:
        if not self.enabled:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._mark = torch.profiler.record_function(MARK)
        self._mark.__enter__()

    def stop(self, window_s: Optional[float] = None) -> Optional[Trace]:
        """Ends the stretch; ``window_s`` clips it to its first seconds
        (the profiler may run on past them)."""
        if not self.enabled or self._prof is None:
            return None
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._mark.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json", prefix="pprbench-trace-")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self._prof = None
        span = None
        marks = [e for e in events if e.get("name") == MARK
                 and e.get("cat") == "user_annotation"]
        if marks and window_s is not None:
            t0 = float(marks[0]["ts"])
            span = (t0, t0 + 1e6 * window_s)
        return summarize(events, span)
