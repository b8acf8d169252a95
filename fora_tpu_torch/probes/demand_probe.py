"""K6-demand on the card: the package's single pass against its earlier
three-launch form and against other forms of the single pass, on the same
residues and timed the same way.

    python -m fora_tpu_torch.probes.demand_probe [--rounds 5] \
        [--device cuda:0]

The forms: the package's (``kernels.walk_demand``: its status words and
ticket zeroed by a ``cudaMemsetAsync`` before each launch); and from
``demand_forms.cu`` beside this file, the same kernel with its status
words told apart by a per-call epoch on a scratch kept from call to call,
never cleared (``epoch``, the package's tile and column group); that form
at tiles of 2^11, 2^12 and 2^14 entries (``tile<height>``, the height in
nodes at the residue's column group) and with column groups of at most 16
or 32 columns (``cols<width>``); with another depth of pipeline
(``other<width>`` at each column group's width: the pipeline two tiles
ahead where the package's is one; ``other_copy<width>`` its copy alone,
as ``copy`` below); without its look-back (``nolookback``, every tile's
prefix 0: wrong sums, timed only, to show what the look-back costs) and
without its scans too (``copy``); and the earlier form (``earlier``,
``demand_earlier.cu``: tile sums, their scan, then the tiles read again,
three launches).  The two sources are compiled alone (``build.
load_alone``) and called through ctypes; no entry point of the package
reaches this module.

Residues are made from a seed: a [524288, 64] pool residue (30% of the
entries positive, uniform in (0, 1)) and its column slices [:, :15] (the
raw pool's largest walk phase in ``chip_smoke.py`` phase 10 is a slice of
15 live columns of its 64) and [:, :1]; and four shards' [131072, 128]
residues, the shape of the sharded raw one-shot's demand in
``chip_smoke.py`` phase 9 (128 queries over four shards of 2^19 nodes),
as the list form's one launch against four calls of the earlier form and
the stack of their totals.  Every form is held torch.equal to
``ops.walk.walk_demand_plain`` and timed with ``utils.timing.device_ms``
in alternating rounds (medians), the package's and the earlier form's
also as called (``cuda_ms``).  The bound: r's distinct 32-byte sectors
read once and cum and total written once at the card's memory rate,
beside the byte formula (r's bytes in place of its sectors).  It needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import torch

from .. import kernels
from ..kernels import build
from ..ops import walk
from ..utils.profiling import device_hbm_bw
from ..utils.timing import cuda_ms, device_ms

HERE = Path(__file__).resolve().parent
N, POOL, SHARDS, SHARD_COLS = 1 << 19, 64, 4, 128
UNIT = 1000.0
TILES = (11, 12, 14)        # log2 of the entries of the other tiles timed
COLUMN_CAPS = (3, 4, 5)     # log2 of the widest column groups timed
EPOCHS = 1 << 30            # the epoch form's epochs: 1 .. 2^30 - 1

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# a form of demand_forms.cu: fora_walk_demand's arguments with the column
# group and tile (log2), the scratch's ticket base and epoch, and the
# tickets the launch took
FORM = [_P, _I, _LL, _LL, _I, _F, _I, _I, _P, _LL, ctypes.c_ulonglong,
        ctypes.c_uint, _P, _P, _I, ctypes.POINTER(_LL), _P]
FORMS = ("e8", "e16", "e32", "e64", "nolookback", "copy", "other",
         "other_copy")
SIGNATURES = {
    "earlier": {"fora_walk_demand_earlier": [_P, _LL, _LL, _I, _F, _P, _LL,
                                             _P, _P, _P]},
    "forms": {**{f"fora_walk_demand_{k}": FORM for k in FORMS},
              "fora_demand_occupancy": [_I, _P]}}
SOURCES = {"earlier": "demand_earlier.cu", "forms": "demand_forms.cu"}
_libs: dict = {}


def load_earlier() -> ctypes.CDLL:
    """The earlier form's library, built alone and kept for later
    calls."""
    if "earlier" not in _libs:
        _libs["earlier"] = build.load_alone(HERE / SOURCES["earlier"],
                                            SIGNATURES["earlier"])
    return _libs["earlier"]


def load_forms() -> dict:
    """{"earlier": the earlier form's library, "forms": demand_forms.cu's},
    each built alone (the two in parallel) and kept for later calls."""
    todo = [k for k in SOURCES if k not in _libs]
    with ThreadPoolExecutor(max(1, len(todo))) as ex:
        libs = {k: ex.submit(build.load_alone, HERE / SOURCES[k],
                             SIGNATURES[k]) for k in todo}
    _libs.update({k: v.result() for k, v in libs.items()})
    return dict(_libs)


def _p(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _raise_on(err: int, name: str):
    if err:
        raise RuntimeError(f"{name}: CUDA error {err}")


def earlier_demand(lib, r: torch.Tensor, unit: float):
    """The earlier form's (cum [n, Bc], total [Bc]) of ``r``: three
    launches over a [Bc, ceil(n / 256)] scratch of tile sums."""
    n, Bc = r.shape
    n_tiles = -(-n // 256)
    cum = torch.empty((Bc, n), dtype=torch.int32, device=r.device)
    total = torch.zeros(Bc, dtype=torch.int32, device=r.device)
    tile = torch.empty((Bc, n_tiles), dtype=torch.int32, device=r.device)
    _raise_on(lib.fora_walk_demand_earlier(
        _p(r), r.stride(0), n, Bc, unit, _p(tile), n_tiles, _p(cum),
        _p(total), _stream(r)), "fora_walk_demand_earlier")
    return cum.T, total


def earlier_shards(lib, rs: list, unit: float):
    """The earlier form a shard, then the stack of the totals: what the
    sharded walk phase ran before the list form."""
    ds = [earlier_demand(lib, x, unit) for x in rs]
    return [d[0] for d in ds], torch.stack([d[1] for d in ds])


def columns_log2(Bc: int, cap: int = kernels.DEMAND_COLUMNS_LOG2) -> int:
    """log2 of the column group: min(2^cap, 2^ceil(log2 Bc))."""
    return min(cap, max(0, (Bc - 1).bit_length()))


class EpochScratch:
    """The epoch form's ticket counter and status words, kept from call
    to call with the tickets handed out and the last epoch: zeroed when
    made, when it grows and when the epochs wrap, and never between
    calls.  One per form and stream."""

    def __init__(self):
        self.words: Optional[torch.Tensor] = None
        self.tickets = 0
        self.epoch = 0

    def take(self, need: int, device) -> int:
        """The epoch of the next launch, over at least ``need`` words."""
        if self.words is None or self.words.numel() < need:
            self.words = torch.zeros(max(need, 1 << 16), dtype=torch.int64,
                                     device=device)
            self.tickets, self.epoch = 0, 0
        elif self.epoch + 1 == EPOCHS:
            self.words.zero_()
            self.tickets, self.epoch = 0, 0
        self.epoch += 1
        return self.epoch


def form_demand(entry, rs: list, unit: float, scratch: EpochScratch,
                tile_entries_log2: int = kernels.DEMAND_TILE_LOG2,
                cw_log2: Optional[int] = None):
    """One launch of a form of ``demand_forms.cu`` over the shards ``rs``
    at tiles of 2^tile_entries_log2 entries and column groups of 2^cw_log2
    (by default the package's); (cum [G, n, Bc], total [G, Bc])."""
    G = len(rs)
    n, Bc = rs[0].shape
    cw_log2 = columns_log2(Bc) if cw_log2 is None else cw_log2
    tile_log2 = tile_entries_log2 - cw_log2
    cw = 1 << cw_log2
    need = 1 + G * -(-Bc // cw) * cw * -(-n // (1 << tile_log2))
    cum = torch.empty((G, Bc, n), dtype=torch.int32, device=rs[0].device)
    total = torch.empty((G, Bc), dtype=torch.int32, device=rs[0].device)
    epoch = scratch.take(need, rs[0].device)
    tickets = ctypes.c_longlong(0)
    with torch.cuda.device(rs[0].device):
        err = entry(kernels._table(rs), G, rs[0].stride(0), n, Bc, unit,
                    cw_log2, tile_log2, _p(scratch.words),
                    scratch.words.numel(), scratch.tickets, epoch, _p(cum),
                    _p(total), kernels.sm_count(rs[0].device),
                    ctypes.byref(tickets), _stream(rs[0]))
    scratch.tickets += tickets.value
    _raise_on(err, "a demand form")
    return cum.transpose(1, 2), total


def r_sectors(r: torch.Tensor) -> int:
    """Distinct 32-byte sectors of ``r``'s storage that its entries lie in
    (4-byte words, the storage 32-byte aligned)."""
    n, Bc = r.shape
    v = torch.arange(n, device=r.device)[:, None] * r.stride(0)
    b = torch.arange(Bc, device=r.device)[None, :] * r.stride(1)
    return int(torch.unique((r.storage_offset() + v + b) // 8).numel())


def bounds(rs: list) -> dict:
    """The least device time of the demand of ``rs``: r's sectors read
    once (``bound_ms``) or r's bytes (``bytes_bound_ms``), cum and total
    written once, at the card's published memory rate."""
    rate = device_hbm_bw(rs[0].device)
    n, Bc = rs[0].shape
    out = len(rs) * (n * Bc * 4 + Bc * 4)
    sec = sum(r_sectors(x) for x in rs) * 32
    return dict(bound_ms=(sec + out) / rate * 1e3,
                bytes_bound_ms=(len(rs) * n * Bc * 4 + out) / rate * 1e3,
                r_sector_bytes=sec)


def check(name: str, got, rs: list, unit: float) -> None:
    """Every shard's cum and total of ``got`` (cum [G, n, Bc] or a list,
    total [G, Bc]) torch.equal to the plain version's."""
    cums, totals = got
    for h, x in enumerate(rs):
        want = walk.walk_demand_plain(x, unit)
        if not (torch.equal(cums[h], want.cum)
                and torch.equal(totals[h], want.total)):
            raise SystemExit(f"demand probe: {name} differs from the plain "
                             f"version on shard {h} of {tuple(x.shape)}")


def forms_on(rs: list, unit: float, rounds: int = 5) -> dict:
    """Every form on the shards ``rs`` (one residue: a list of one), each
    checked, then timed: {"device": {form: median device ms}, "called":
    {"package", "earlier": median ms as called}, **bounds(rs)}.  With G >
    1 the earlier form is a call a shard and the stack of the totals."""
    libs = load_forms()
    lib = libs["forms"]
    n, Bc = rs[0].shape
    listed = len(rs) > 1
    cw_log2 = columns_log2(Bc)

    def form(name, **kw):
        fn, sc = getattr(lib, f"fora_walk_demand_{name}"), EpochScratch()
        return lambda: form_demand(fn, rs, unit, sc, **kw)
    fns = {"package": lambda: kernels.walk_demand(rs if listed else rs[0],
                                                  unit),
           "epoch": form("e32")}
    for e in TILES:
        fns[f"tile{1 << (e - cw_log2)}"] = form(f"e{1 << (e - 8)}",
                                               tile_entries_log2=e)
    for cap in COLUMN_CAPS:
        cl = columns_log2(Bc, cap)
        if cl != cw_log2:
            fns[f"cols{1 << cl}"] = form("e32", cw_log2=cl)
    for cap in COLUMN_CAPS:
        cl = columns_log2(Bc, cap)
        if cap > 3 and cl == columns_log2(Bc, cap - 1):
            continue
        for part in ("other", "other_copy"):
            fns[f"{part}{1 << cl}"] = form(part, cw_log2=cl)
    for part in ("nolookback", "copy"):
        fns[part] = form(part)
    fns["earlier"] = (
        (lambda: earlier_shards(libs["earlier"], rs, unit)) if listed
        else lambda: earlier_demand(libs["earlier"], rs[0], unit))
    for name, fn in fns.items():
        got = fn()
        torch.cuda.synchronize()
        if not listed and name in ("package", "earlier"):
            got = ([got[0]], got[1][None])
        if "copy" not in name and name != "nolookback":    # parts: timing only
            check(name, got, rs, unit)
    dev = {k: [] for k in fns}
    called = {"package": [], "earlier": []}
    for i in range(rounds):
        order = list(fns.items())
        for name, fn in order if i % 2 == 0 else order[::-1]:
            dev[name].append(device_ms(fn))
            if name in called:
                called[name].append(cuda_ms(fn))
    return {"device": {k: statistics.median(v) for k, v in dev.items()},
            "called": {k: statistics.median(v) for k, v in called.items()},
            **bounds(rs)}


def report(label: str, f: dict) -> None:
    d = f["device"]
    print(f"K6-demand {label}: package {d['package']:.4f} ms device, "
          f"{f['called']['package']:.4f} as called; earlier form "
          f"{d['earlier']:.4f} device, {f['called']['earlier']:.4f} as "
          f"called; bound {f['bound_ms']:.4f} ms by r's sectors "
          f"({f['r_sector_bytes']} bytes of r; {f['bound_ms'] / d['package']:.0%}"
          f" of it reached), {f['bytes_bound_ms']:.4f} by the byte formula "
          f"({f['bytes_bound_ms'] / d['package']:.0%})")
    print("  forms, device ms: " + ", ".join(
        f"{k} {v:.4f}" for k, v in d.items()))


def occupancy(tile_log2: int) -> int:
    """The demand kernel's resident blocks an SM at tiles of 2^tile_log2
    entries (the card's answer)."""
    out = ctypes.c_int(0)
    _raise_on(load_forms()["forms"].fora_demand_occupancy(
        tile_log2 - 8, ctypes.byref(out)), "fora_demand_occupancy")
    return out.value


def residues(dev, seed: int = 7) -> dict:
    """The probe's residues, made on ``dev`` from ``seed``."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def make(n, B):
        x = torch.rand((n, B), generator=g, device=dev)
        return torch.where(torch.rand((n, B), generator=g, device=dev) < 0.3,
                           x, 0.0)
    pool = make(N, POOL)
    return {"[524288, 15] (a slice of 64)": [pool[:, :15]],
            "[524288, 64]": [pool],
            "[524288, 1] (a slice of 64)": [pool[:, :1]],
            f"{SHARDS} shards' [{N // SHARDS}, {SHARD_COLS}], list form": [
                make(N // SHARDS, SHARD_COLS) for _ in range(SHARDS)]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--device", default="cuda:0")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("demand_probe needs a CUDA card")
    dev = torch.device(a.device)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0])
    load_forms()
    print("demand kernel blocks an SM by tile entries: " + ", ".join(
        f"{1 << e} {occupancy(e)}" for e in sorted(
            TILES + (kernels.DEMAND_TILE_LOG2,))))
    for label, rs in residues(dev).items():
        report(label, forms_on(rs, UNIT, a.rounds))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
