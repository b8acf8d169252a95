"""Profiling and roofline accounting on the card.

Port of ``fora_tpu/utils/profiling.py``: ``trace`` (40-47) wraps
``torch.profiler`` where the JAX package wraps ``jax.profiler``;
``SpmvRoofline`` (50-70) and ``measure`` (95-106) are carried over;
``fence`` (73-92) becomes a device synchronise, which on a CUDA card is a
completion fence (the relayed TPU runtime's early ACK that the JAX
version works around has no counterpart here).  ``device_hbm_bw`` (31-36)
knows the port's cards only: no TPU figure is carried, and an unknown card
raises rather than take a default.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from pathlib import Path
from typing import Optional

import torch

# device memory rate by device name (bytes/s), NVIDIA's data sheets
HBM_BW = {
    # H100 SXM5 80 GB (torch.cuda.get_device_name: "NVIDIA H100 80GB
    # HBM3"), HBM3 at 3.35 TB/s at its 700 W limit
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def device_hbm_bw(device=None) -> float:
    """Published memory rate of ``device`` (a CUDA device; the current one
    when None), by its name."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        raise ValueError(f"no device memory rate for {device}")
    kind = torch.cuda.get_device_name(device)
    for k, v in HBM_BW.items():
        if kind.lower().startswith(k.lower()):
            return v
    raise ValueError(f"no published memory rate for {kind!r} in HBM_BW")


@contextlib.contextmanager
def trace(logdir: str):
    """Record a torch.profiler trace around a block (the card's kernels
    where CUDA is available) and write it to ``logdir/trace.json``
    (Chrome/Perfetto format)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        Path(logdir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(logdir) / "trace.json"))


@dataclasses.dataclass
class SpmvRoofline:
    """Bytes accounting for one gather+segment_sum superstep over E edges
    with batch width B (f32 values, i32 indices)."""

    edges: int
    batch: int
    nodes: int

    @property
    def bytes_moved(self) -> int:
        # read: edge src+dst indices, gathered rows; write+read: accumulator
        return (self.edges * 8                      # indices
                + self.edges * self.batch * 4       # gathered contrib rows
                + 2 * self.nodes * self.batch * 4)  # accumulator update

    def light_speed_secs(self, bw: Optional[float] = None) -> float:
        return self.bytes_moved / (bw or device_hbm_bw())

    def efficiency(self, measured_secs: float,
                   bw: Optional[float] = None) -> float:
        return self.light_speed_secs(bw) / max(measured_secs, 1e-12)


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensors(v)
    elif isinstance(out, (tuple, list)):
        for v in out:
            yield from _tensors(v)


def fence(out):
    """Completion fence: synchronise every CUDA device that holds a tensor
    of ``out`` (tensors, or tuples, lists, dicts and NamedTuples of them);
    CPU tensors need none.  Returns ``out``."""
    for dev in {t.device for t in _tensors(out) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return out


def measure(fn, *args, reps: int = 3, warmup: int = 1) -> float:
    """Median wall time of a completed call (fenced, see ``fence``)."""
    for _ in range(warmup):
        fence(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fence(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
