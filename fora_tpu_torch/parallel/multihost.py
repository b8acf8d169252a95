"""The sharded engine across processes: the process group, the port's
transport over it, and results on the host.

Counterpart of ``fora_tpu/parallel/multihost.py``.  ``init`` (24-38 there)
starts ``torch.distributed`` over a TCP store at ``coordinator``, where
JAX starts ``jax.distributed``; ``shutdown`` ends it.  Each of P processes
then holds L of the G = P * L graph shards, process q shards q * L ..
q * L + L - 1 (``mesh.make_mesh``): the order of ``jax.devices()``, which
lists the devices process by process.  Every process builds the same
partition from a ``CSRGraph`` (as every JAX process builds the same global
numpy arrays), or opens its own shards' files of a store.

Each rank's shards lie on a card (by default card rank modulo the visible
cards), or on the CPU only where the caller asks for it (``device="cpu"``):
with no card and no such request ``init`` raises, as ``mesh.make_mesh``
does, and never falls back to the CPU.  The backend is NCCL where each
rank has a card of its own, and gloo on the CPU.  Ranks that share one
card (NCCL refuses two ranks on one GPU) run gloo: the caller passes
``backend="gloo"``.  Under NCCL ``init`` compares the ranks' cards
through the store before any collective and raises if two share one; it
never falls back to gloo.  Call ``shutdown()`` before a process exits: a
gloo process that exits with its group alive aborts.

``ProcessComm`` is the engines' transport: the collectives the sharded
engine needs (``all_gather``, ``all_reduce``, ``reduce_scatter``,
``all_to_all``), each one ``torch.distributed`` call on the tensors
themselves (gloo takes all four on CUDA tensors, so nothing is staged
through host memory), and ``agree``, the check that every process took
the same host decision.  ``gather_to_host`` (41-45 there) gives every
process a row-sharded result in shard order, as JAX's
``process_allgather(tiled=True)`` does.
"""

from __future__ import annotations

from datetime import timedelta
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT_S = 600

_comm: Optional["ProcessComm"] = None


class ProcessComm:
    """The process group as the sharded engine sees it: this process's
    ``rank`` of ``size``, the ``backend`` and the ``device`` that holds
    this process's shards, and the collectives over it.  Every collective
    is called by every process in the same order.  A collective takes a
    tensor on any device and returns on that device: NCCL runs on
    ``device``, gloo where the tensor lies."""

    def __init__(self, rank: int, size: int, backend: str,
                 device: torch.device):
        self.rank, self.size = rank, size
        self.backend, self.device = backend, torch.device(device)

    def _on(self, t: torch.Tensor) -> torch.Tensor:
        """``t``, contiguous, where the backend takes it."""
        return (t.to(self.device) if self.backend == "nccl" else t
                ).contiguous()

    def all_gather(self, t: torch.Tensor,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[size * t.shape[0], ...]: every process's ``t`` (one shape on
        all of them) stacked along rows in rank order, into ``out`` where
        given (contiguous; ``t`` may be its own rows, as NCCL's in-place
        all-gather takes them, and gloo gets a copy)."""
        shape = (self.size * t.shape[0],) + tuple(t.shape[1:])
        if out is not None and (tuple(out.shape) != shape
                                or not out.is_contiguous()
                                or out.device != self._on(t[:0]).device):
            raise ValueError(f"all_gather: out {tuple(out.shape)} on "
                             f"{out.device}, expected {shape} contiguous "
                             "where the backend runs")
        x = self._on(t)
        if out is not None and self.backend == "gloo":
            x = x.clone()
        got = torch.empty(shape, dtype=t.dtype, device=x.device) \
            if out is None else out
        dist.all_gather_into_tensor(got, x)
        return got if out is not None else got.to(t.device)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` summed (``op`` "sum") or its largest value taken ("max")
        over the processes, in place."""
        x = self._on(t)
        dist.all_reduce(x, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX}[op])
        if x is not t:
            t.copy_(x)
        return t

    def agree(self, what: str, value: int) -> None:
        """Raise unless every process passed the same int64 ``value``: one
        all-reduce of (value, -value) by max gives the largest and the
        smallest, and the error names both.  Every process calls it at the
        same point, so a process that decided otherwise fails here and
        does not leave the others waiting in a later collective."""
        x = torch.tensor([value, -value], dtype=torch.int64)
        hi, lo = (int(v) for v in self.all_reduce(x, "max"))
        if hi != -lo:
            raise RuntimeError(f"processes disagree on {what}: values from "
                               f"{-lo} to {hi} (rank {self.rank}: {value})")

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """Rows rank * R .. (rank + 1) * R - 1 (R = t.shape[0] / size) of
        the sum over the processes of ``t``."""
        if t.shape[0] % self.size:
            raise ValueError(f"reduce_scatter: {t.shape[0]} rows over "
                             f"{self.size} processes")
        x = self._on(t)
        out = torch.empty((t.shape[0] // self.size,) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, x)
        return out.to(t.device)

    def all_to_all(self, send: torch.Tensor, send_rows: Sequence[int],
                   recv_rows: Sequence[int]) -> torch.Tensor:
        """The rows of ``send``, ``send_rows[d]`` of them for process d in
        rank order, exchanged: [sum(recv_rows), ...], process s's
        ``recv_rows[s]`` rows in rank order."""
        send_rows, recv_rows = list(map(int, send_rows)), \
            list(map(int, recv_rows))
        x = self._on(send)
        out = torch.empty((sum(recv_rows),) + tuple(send.shape[1:]),
                          dtype=send.dtype, device=x.device)
        dist.all_to_all_single(out, x, recv_rows, send_rows)
        return out.to(send.device)


def _parse(coordinator: str) -> tuple:
    addr = coordinator.split("://", 1)[-1]
    host, _, port = addr.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator {coordinator!r}: expected host:port")
    return host, int(port)


def card_id(device: torch.device) -> str:
    """The UUID of ``device``: two processes (or two hosts) give alike only
    for the same card."""
    return str(torch.cuda.get_device_properties(device).uuid)


def shared_cards(ids: Sequence[str]) -> list:
    """The pairs (a, b), a < b, of ranks whose card names in ``ids`` are
    equal."""
    return [(a, b) for a in range(len(ids)) for b in range(a + 1, len(ids))
            if ids[a] == ids[b]]


def init(coordinator: str, num_processes: int, process_id: int, *,
         backend: Optional[str] = None, device=None) -> ProcessComm:
    """Start the process group: rank ``process_id`` of ``num_processes``
    over a TCP store at ``coordinator`` ("host:port", the port free on
    the host of rank 0, which serves the store).  ``device`` is the device
    of this process's shards: by default card ``process_id`` modulo the
    visible cards; with no card it raises unless the caller asks for the
    CPU (``device="cpu"``).  ``backend`` None is NCCL on a card and gloo
    on the CPU.  Under NCCL every rank must hold a card of its own: the
    ranks publish their card's name in the store, and a card named twice
    raises before any collective (pass backend="gloo" where ranks share a
    card).  Returns the group's ``ProcessComm`` (also ``comm()``)."""
    global _comm
    if _comm is not None:
        raise RuntimeError("init: a process group is already started; call "
                           "shutdown() first")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process {process_id} of {num_processes}")
    if backend not in (None, "nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("init: no CUDA device; pass device=\"cpu\" "
                               "(--device cpu) to run on the CPU")
        device = torch.device("cuda", process_id % torch.cuda.device_count())
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("NCCL needs each rank's shards on a CUDA device")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    host, port = _parse(coordinator)
    timeout = timedelta(seconds=TIMEOUT_S)
    store = dist.TCPStore(host, port, num_processes,
                          is_master=process_id == 0, timeout=timeout)
    if backend == "nccl":
        store.set(f"fora_card/{process_id}", card_id(device))
        ids = [store.get(f"fora_card/{q}").decode()
               for q in range(num_processes)]
        pairs = shared_cards(ids)
        if pairs:
            raise RuntimeError(
                f"NCCL refuses two ranks on one GPU: ranks {pairs} share a "
                f"card ({ids[pairs[0][0]]}); give each rank a card of its "
                "own, or pass backend='gloo'")
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes, timeout=timeout)
    _comm = ProcessComm(process_id, num_processes, backend, device)
    return _comm


def comm() -> Optional[ProcessComm]:
    """The started group's ``ProcessComm``, or None."""
    return _comm


def shutdown() -> None:
    """End the process group (``destroy_process_group``); nothing if none
    was started."""
    global _comm
    if _comm is not None:
        _comm = None
        dist.destroy_process_group()


def gather_to_host(x: Union[torch.Tensor, Sequence[torch.Tensor]]
                   ) -> np.ndarray:
    """A host numpy copy of ``x``: one tensor, or the shards' tensors (on
    any devices) concatenated along rows in shard order.  With a process
    group started, ``x`` is this process's part (its local shards' rows),
    and every process gets the whole array, the processes' parts in rank
    order (one ``all_gather``; every part of one shape)."""
    if isinstance(x, torch.Tensor):
        local = x.detach()
    else:
        local = torch.cat([t.detach().to(x[0].device) for t in x], dim=0)
    if _comm is None:
        return local.cpu().numpy()
    return _comm.all_gather(local).cpu().numpy()
