"""Named phase timers with an end-of-run report.

A copy of ``fora_tpu/utils/timers.py`` (``tests/test_torch_host.py``
holds the two equal) that fences through the port's ``profiling.fence``, a
device synchronise, where the original fences through JAX.  Plays the role
of the reference's static RAII ``Timer`` objects printed at exit [R:
mylib.h — reconstruction, SURVEY.md Sec. 5.1].
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Any, Dict, Optional


class Timers:
    def __init__(self):
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, block_on: Optional[Any] = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                from .profiling import fence
                fence(block_on)
            self.total[name] += time.perf_counter() - t0
            self.count[name] += 1

    def timed(self, name: str, fn, *args, **kwargs):
        """Run fn, fence on its result, record wall time; returns result."""
        from .profiling import fence
        t0 = time.perf_counter()
        out = fence(fn(*args, **kwargs))
        self.total[name] += time.perf_counter() - t0
        self.count[name] += 1
        return out

    def report(self) -> str:
        lines = ["---- timers ----"]
        for name in sorted(self.total):
            t, c = self.total[name], self.count[name]
            lines.append(f"{name:>24s}: total {t*1e3:10.2f} ms   "
                         f"count {c:6d}   avg {t/c*1e3:10.3f} ms")
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, float]:
        return dict(self.total)
