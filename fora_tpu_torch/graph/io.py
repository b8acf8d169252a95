"""Dataset I/O honoring the reference's on-disk contract.

Port of ``fora_tpu/graph/io.py`` (28-116):

  <prefix>/<dataset>/graph.txt       one "src dst" pair per line, 0-indexed;
                                     an optional third column carries a
                                     positive per-edge weight (weighted
                                     graphs, auto-detected)
  <prefix>/<dataset>/attribute.txt   two lines: "n=<N>" and "m=<M>"

Packed CSR arrays are cached next to the dataset as ``csr_cache.npz``, in
the JAX package's format, so repeat runs skip parsing.  ``load_dataset``
parses with the kernel library's host parser (``kernels/csrc/graph_io.cu``,
the port's copy of ``fora_tpu/_native``'s) when the graph is for a CUDA
device, and with ``numpy.loadtxt`` when it is for the CPU; neither falls
back to the other.  ``save_dataset`` writes the same bytes as the JAX
package's, the unweighted lines by a vectorised writer.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path

import numpy as np
import torch

from ..kernels import build as kbuild
from .csr import CSRGraph, from_edges


def load_attribute(dataset_dir: Path) -> tuple[int, int]:
    n = m = None
    for line in (Path(dataset_dir) / "attribute.txt").read_text().splitlines():
        line = line.strip()
        if line.startswith("n="):
            n = int(line[2:])
        elif line.startswith("m="):
            m = int(line[2:])
    if n is None or m is None:
        raise ValueError(f"attribute.txt missing n=/m= in {dataset_dir}")
    return n, m


def _detect_weighted(path: Path, sample: int = 1024) -> bool:
    """True if graph.txt carries a third (weight) column.  Scans a sample
    of data lines, not just the first: a mixed-width file (some lines with
    weights, some without) is ambiguous and raises rather than silently
    dropping weights or crashing deep inside the parser."""
    widths = set()
    seen = 0
    with open(path) as f:
        for line in f:
            t = line.strip()
            if not t or t[0] in "#%":
                continue
            widths.add(min(len(t.split()), 3))
            seen += 1
            if seen >= sample:
                break
    if len(widths) > 1:
        raise ValueError(
            f"{path}: mixed column counts {sorted(widths)} in the first "
            f"{seen} data lines — weighted edge lists must carry the third "
            "column on every line")
    return widths == {3}


def parse_edges_numpy(path: Path, weighted: bool):
    """(src int64, dst int64, w f32 or None) by ``numpy.loadtxt``."""
    if weighted:
        e = np.loadtxt(path, dtype=np.float64, ndmin=2)
        return (e[:, 0].astype(np.int64), e[:, 1].astype(np.int64),
                e[:, 2].astype(np.float32))
    e = np.loadtxt(path, dtype=np.int64, ndmin=2)
    return e[:, 0], e[:, 1], None


def parse_edges_library(path: Path, weighted: bool):
    """The same arrays from ``fora_parse_edges`` in the kernel library
    (built first if needed; a missing ``nvcc`` raises): one pass counts,
    one fills.  Raises where the file cannot be read or a line is not 2
    (3 when ``weighted``) numbers."""
    lib = kbuild.library()
    cols = 3 if weighted else 2
    name = str(path).encode()
    count = lib.fora_parse_edges(name, cols, None, None, None, 0)
    if count >= 0:
        src = np.empty(count, np.int64)
        dst = np.empty(count, np.int64)
        w = np.empty(count, np.float32) if weighted else None

        def ptr(a):
            return None if a is None else ctypes.c_void_p(a.ctypes.data)
        count = lib.fora_parse_edges(name, cols, ptr(src), ptr(dst), ptr(w),
                                     len(src))
    if count == -1:
        raise OSError(f"cannot read {path}")
    if count < 0:
        raise ValueError(f"{path}: a data line is not {cols} numbers "
                         f"(fora_parse_edges returned {count})")
    return src, dst, w


def load_dataset(prefix: str, dataset: str, use_cache: bool = True, *,
                 device) -> CSRGraph:
    """Load <prefix>/<dataset>/graph.txt into packed CSR form for a graph
    on ``device`` (which picks the parser).  A third column in graph.txt is
    auto-detected as per-edge weights."""
    ddir = Path(prefix) / dataset
    cache = ddir / "csr_cache.npz"
    if use_cache and cache.exists() and \
            cache.stat().st_mtime >= (ddir / "graph.txt").stat().st_mtime:
        z = np.load(cache)
        return CSRGraph(**{k: z[k] for k in CSRGraph._fields if k in z.files})

    n, _ = load_attribute(ddir)
    path = ddir / "graph.txt"
    weighted = _detect_weighted(path)
    parse = (parse_edges_library if torch.device(device).type == "cuda"
             else parse_edges_numpy)
    src, dst, w = parse(path, weighted)
    g = from_edges(src, dst, n, w=w)
    if use_cache:
        try:
            np.savez(cache, **{k: v for k, v in g._asdict().items()
                               if v is not None})
        except OSError:
            pass  # read-only dataset dir: skip caching
    return g


def _decimal_rows(columns, chunk: int = 1 << 21):
    """Yield the bytes of rows "c0 c1 ...\\n" of non-negative int64
    columns, as "%d %d" formats them: each column's digits laid right-aligned
    in a [rows, width] byte array, separators appended, and the positions
    past each number's length dropped by one mask."""
    n = len(columns[0])
    for lo in range(0, n, chunk):
        parts, keep = [], []
        for j, col in enumerate(columns):
            x = np.asarray(col[lo: lo + chunk], np.int64)
            width = max(len(str(int(x.max()))), 1) if len(x) else 1
            digits = np.empty((len(x), width), np.uint8)
            ndig = np.ones(len(x), np.int64)
            rest = x.copy()
            for d in range(width - 1, -1, -1):
                digits[:, d] = rest % 10 + 48
                rest //= 10
            big = x.copy() // 10
            while big.any():
                ndig += big > 0
                big //= 10
            parts.append(digits)
            keep.append(np.arange(width)[None, :] >= width - ndig[:, None])
            sep = np.full((len(x), 1), 10 if j == len(columns) - 1 else 32,
                          np.uint8)
            parts.append(sep)
            keep.append(np.ones((len(x), 1), bool))
        yield np.concatenate(parts, axis=1)[np.concatenate(keep, axis=1)
                                            ].tobytes()


def save_dataset(g: CSRGraph, prefix: str, dataset: str) -> None:
    """Write a graph back out in the reference's format (fixtures, tests),
    byte for byte as ``fora_tpu``'s ``save_dataset``; weighted graphs emit
    the third (weight) column."""
    ddir = Path(prefix) / dataset
    os.makedirs(ddir, exist_ok=True)
    (ddir / "attribute.txt").write_text(f"n={g.n}\nm={g.m}\n")
    # out-CSR order: expand indptr to per-edge src
    src = np.repeat(np.arange(g.n, dtype=np.int64),
                    np.asarray(g.out_deg, dtype=np.int64))
    dst = np.asarray(g.out_indices, np.int64)
    if g.weighted:
        with open(ddir / "graph.txt", "w") as f:
            np.savetxt(f, np.column_stack(
                [src, dst, np.asarray(g.out_w, np.float64)]), fmt="%d %d %g")
        return
    with open(ddir / "graph.txt", "wb") as f:
        for block in _decimal_rows([src, dst]):
            f.write(block)
