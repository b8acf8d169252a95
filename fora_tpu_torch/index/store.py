"""Walk-index (de)serialization, format v2, byte-compatible with
``fora_tpu.index.store``: each package reads the other's index.

Port of ``fora_tpu/index/store.py`` (30-131), whose module imports
``jax.numpy``.  Layout: ``edge_src.npy``, ``edge_dst.npy``,
``counts_cum.npy``, ``edge_mult.npy`` and ``meta.json`` (config, bucket
offsets, optional graph content hash).  ``load`` also builds each
bucket's CSR by endpoint (``WalkIndex.dst_indptr``).
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..config import ResolvedConfig
from .build import WalkIndex, dedup_index, with_indptr

FORMAT_VERSION = 2


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)


def graph_fingerprint(g) -> str:
    """Content hash of the walk-relevant graph structure (out-CSR and
    weights) of a CSRGraph or DeviceGraph, equal to fora_tpu's."""
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(_host(g.out_indptr)).tobytes())
    h.update(np.ascontiguousarray(_host(g.out_indices)).tobytes())
    if getattr(g, "out_w", None) is not None:
        h.update(np.ascontiguousarray(_host(g.out_w)).tobytes())
    return h.hexdigest()


def save(index: WalkIndex, rcfg: ResolvedConfig, path: str,
         graph=None) -> None:
    """Write ``index`` under ``path``; ``graph`` (optional) records its
    content fingerprint so ``load`` can refuse a different graph."""
    d = Path(path)
    d.mkdir(parents=True, exist_ok=True)
    np.save(d / "edge_src.npy", np.asarray(index.edge_src))
    np.save(d / "edge_dst.npy", np.asarray(index.edge_dst))
    np.save(d / "counts_cum.npy", np.asarray(index.counts_cum))
    if index.edge_mult is not None:
        np.save(d / "edge_mult.npy", np.asarray(index.edge_mult))
    meta = {
        "format_version": FORMAT_VERSION,
        "n": rcfg.n, "m": rcfg.m,
        "alpha": rcfg.alpha, "epsilon": rcfg.epsilon, "delta": rcfg.delta,
        "pfail": rcfg.pfail, "rmax": index.rmax_built,
        "omega_unit": index.omega_unit_built,
        "bucket_offsets": [int(x) for x in index.bucket_offsets],
        "total_edges": int(index.total_edges),
    }
    if graph is not None:
        meta["graph_sha"] = graph_fingerprint(graph)
    (d / "meta.json").write_text(json.dumps(meta, indent=1))


def check_compatible(meta: dict, rcfg: ResolvedConfig, graph=None) -> None:
    """An index serves a config iff the graph matches and the index was
    built at least as fine (omega_unit no smaller)."""
    if meta["format_version"] != FORMAT_VERSION:
        raise ValueError(f"index format {meta['format_version']} != "
                         f"{FORMAT_VERSION}; rebuild the index")
    if (meta["n"], meta["m"]) != (rcfg.n, rcfg.m):
        raise ValueError("index built for a different graph "
                         f"(n,m)=({meta['n']},{meta['m']}) vs "
                         f"({rcfg.n},{rcfg.m})")
    if graph is not None and meta.get("graph_sha") is not None \
            and graph_fingerprint(graph) != meta["graph_sha"]:
        raise ValueError(
            "index built for a different graph (content fingerprint "
            "mismatch at equal (n, m) — edges or weights changed)")
    if abs(meta["alpha"] - rcfg.alpha) > 1e-12:
        raise ValueError("index alpha mismatch")
    if meta["omega_unit"] < rcfg.omega_unit * (1 - 1e-9):
        raise ValueError(
            "index too coarse for this config: built at "
            f"omega_unit={meta['omega_unit']:.3g}; query needs "
            f">= {rcfg.omega_unit:.3g}")


def load(path: str, rcfg: Optional[ResolvedConfig] = None,
         dedup: bool = True, graph=None, mmap: bool = False) -> WalkIndex:
    """Read an index (host arrays; ``mmap`` keeps the edge arrays as
    memory-mapped views).  An index saved without ``edge_mult.npy`` is
    merged on load when ``dedup``."""
    d = Path(path)
    meta = load_meta(path)
    if rcfg is not None:
        check_compatible(meta, rcfg, graph=graph)
    mult_f = d / "edge_mult.npy"

    def arr(f):
        return np.load(f, mmap_mode="r" if mmap else None)

    idx = WalkIndex(
        edge_src=arr(d / "edge_src.npy"),
        edge_dst=arr(d / "edge_dst.npy"),
        bucket_offsets=np.asarray(meta["bucket_offsets"], dtype=np.int64),
        counts_cum=arr(d / "counts_cum.npy"),
        omega_unit_built=meta["omega_unit"],
        rmax_built=meta["rmax"],
        edge_mult=arr(mult_f) if mult_f.exists() else None,
    )
    if dedup and idx.edge_mult is None:
        return dedup_index(idx)
    return with_indptr(idx)


def load_meta(path: str) -> dict:
    return json.loads((Path(path) / "meta.json").read_text())
