"""The index pack's earlier forms, on no path:

- the numpy packed-key branch that ``index/build.py::pack_index`` ran on
  the host before K7 (PRs 1-22), a copy of ``fora_tpu/index/build.py``'s
  numpy branch (436-458); ``chip_smoke.py`` phase 8 times it on the
  build's endpoints beside K7 and holds K7's arrays equal to it;
- K7-keys', K7-sort's and K7-merge's first forms (``pack_earlier.cu``: a
  warp a node over the host's cutoff table; a totals pass and three
  launches a sort pass; four merge launches with the run starts through
  device memory), built alone; phase 8 and the card's tests (``-k pack``)
  time them and hold the package's kernels to them.

    pack_index_numpy(endpoints, counts, out_deg, rcfg) -> WalkIndex
    earlier_pack_keys(ends, offsets, cut, dang, nb) -> keys
    earlier_sort(keys, alt, key_bits) -> (sorted tensor, passes run)
    earlier_merge(keys, free, nb) -> (src, dst, mult, bucket_counts)
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from ..config import ResolvedConfig
from ..index.build import (NUM_BUCKETS, WalkIndex, _bucket_per_entry,
                           _offsets, pack_tables, with_indptr)
from ..kernels import build

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    "fora_pack_keys_earlier": [_P, _P, _P, _LL, _P, _LL, _LL, _I, _P, _P],
    "fora_sort_keys_earlier": [_P, _P, _LL, _I, _P, _LL,
                               ctypes.POINTER(_I), _P],
    "fora_merge_count_earlier": [_P, _LL, _P, _P],
    "fora_merge_write_earlier": [_P, _LL, _I, _P, _LL, _P, _P, _P, _P, _P,
                                 _P],
}
TILE = 4096              # keys a block of the earlier forms takes
_libs: dict = {}


def pack_index_numpy(endpoints: np.ndarray, counts: np.ndarray,
                     out_deg: np.ndarray, rcfg: ResolvedConfig) -> WalkIndex:
    """The packed-key pack in numpy: one np.sort of int64 keys and a
    run-length merge by bincount (keys of 2 nb + 4 <= 63 bits)."""
    t = pack_tables(counts, out_deg)
    n, nb, nd, total = len(t.counts), t.nb, len(t.dang), t.total
    src32 = np.repeat(np.arange(n, dtype=np.int32), t.counts)
    bucket = _bucket_per_entry(t.counts, t.offsets, t.cut, total, src32)
    key = np.empty(total + nd, dtype=np.int64)
    km = key[:total]
    np.left_shift(bucket, 2 * nb, out=km)
    np.bitwise_or(km, np.asarray(endpoints).astype(np.int64) << nb, out=km)
    np.bitwise_or(km, src32.astype(np.int64), out=km)
    key[total:] = ((np.int64(NUM_BUCKETS - 1) << (2 * nb))
                   | (t.dang << nb) | t.dang)
    del bucket, src32
    key = np.sort(key)
    first = np.empty(len(key), dtype=bool)
    if len(key):
        first[0] = True
        first[1:] = key[1:] != key[:-1]
    group = np.cumsum(first) - 1
    mult = np.bincount(group).astype(np.float32)
    key = key[first]
    src = key & ((1 << nb) - 1)
    dst = (key >> nb) & ((1 << nb) - 1)
    bucket = (key >> (2 * nb)).astype(np.int8)
    return with_indptr(WalkIndex(
        edge_src=src.astype(np.int32), edge_dst=dst.astype(np.int32),
        bucket_offsets=_offsets(bucket), counts_cum=t.counts_cum,
        omega_unit_built=rcfg.omega_unit, rmax_built=rcfg.rmax,
        edge_mult=mult))


def load_earlier() -> ctypes.CDLL:
    """``pack_earlier.cu``'s library, built alone and kept for later
    calls."""
    if "earlier" not in _libs:
        _libs["earlier"] = build.load_alone(
            Path(__file__).resolve().parent / "pack_earlier.cu", SIGNATURES)
    return _libs["earlier"]


def _p(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _raise_on(err: int, name: str):
    if err:
        raise RuntimeError(f"{name}: CUDA error {err}")


def earlier_pack_keys(ends: torch.Tensor, offsets: torch.Tensor,
                      cut: torch.Tensor, dang: torch.Tensor,
                      nb: int) -> torch.Tensor:
    """The earlier K7-keys (``index/build.py::pack_keys_plain``'s
    arguments: ``offsets`` [n] and the host's ``cut`` table [n, 8], on one
    card): the keys, int64 [total + nd]."""
    total, n, nd = ends.shape[0], cut.shape[0], dang.shape[0]
    keys = torch.empty(total + nd, dtype=torch.int64, device=ends.device)
    with torch.cuda.device(ends.device):
        _raise_on(load_earlier().fora_pack_keys_earlier(
            _p(ends), _p(offsets), _p(cut), n, _p(dang), nd, total, nb,
            _p(keys), _stream(ends)), "fora_pack_keys_earlier")
    return keys


def earlier_sort(keys: torch.Tensor, alt: torch.Tensor,
                 key_bits: int) -> tuple:
    """The earlier K7-sort of ``keys`` between ``keys`` and ``alt`` (int64
    [L] on one card, L < 2^31): (the buffer holding the result, passes
    run)."""
    L = keys.shape[0]
    words = 8 * 256 + 256 * -(-L // TILE)
    scratch = torch.empty(words, dtype=torch.int32, device=keys.device)
    done = ctypes.c_int(0)
    with torch.cuda.device(keys.device):
        _raise_on(load_earlier().fora_sort_keys_earlier(
            _p(keys), _p(alt), L, key_bits, _p(scratch), words,
            ctypes.byref(done), _stream(keys)), "fora_sort_keys_earlier")
    return (alt if done.value % 2 else keys), done.value


def earlier_merge(keys: torch.Tensor, free: torch.Tensor, nb: int) -> tuple:
    """The earlier K7-merge of the sorted ``keys`` ([L] int64), each run's
    start in ``free`` (at least 4 L bytes): (src, dst [U] int32, mult [U]
    float32, bucket_counts [8] int64); synchronises once, to read U."""
    L, dev = keys.shape[0], keys.device
    heads = torch.empty(-(-L // TILE) + 1, dtype=torch.int32, device=dev)
    bucket_counts = torch.empty(NUM_BUCKETS, dtype=torch.int64, device=dev)
    lib = load_earlier()
    with torch.cuda.device(dev):
        _raise_on(lib.fora_merge_count_earlier(_p(keys), L, _p(heads),
                                               _stream(keys)),
                  "fora_merge_count_earlier")
        U = int(heads[-1])
        src = torch.empty(U, dtype=torch.int32, device=dev)
        dst = torch.empty(U, dtype=torch.int32, device=dev)
        mult = torch.empty(U, dtype=torch.float32, device=dev)
        _raise_on(lib.fora_merge_write_earlier(
            _p(keys), L, nb, _p(heads), U, _p(src), _p(dst), _p(free),
            _p(mult), _p(bucket_counts), _stream(keys)),
            "fora_merge_write_earlier")
    return src, dst, mult, bucket_counts
