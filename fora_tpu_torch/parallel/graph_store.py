"""The shard-aware graph store: the partitioned graph on disk, one file per
(shard, array), so a shard's arrays load without the whole CSR.

Port of ``fora_tpu/parallel/graph_store.py`` (56-166), in the same file
format, so that each package loads a store that the other wrote.  Under
``<dataset dir>/graph-shards-G<G>/``, per shard s:

  shard_%04d.insrc.npy    [m_loc] i32   in-edge sources, global ids
  shard_%04d.indst.npy    [m_loc] i32   in-edge destinations, local ids
  shard_%04d.deg.npy      [n_loc] i32   out-degrees of the owned rows
  shard_%04d.needed.npy   [G, n_loc] u8 needed[t, i]: shard t's in-edges
                          read local row i (the routed exchange's mask;
                          the hier exchange derives its per-host mask)
  shard_%04d.windptr.npy  [n_loc+1] i32 the localized out-CSR slice
  shard_%04d.windices.npy [mo_loc] i32
  weighted graphs add     .inw.npy [m_loc] f32, .wsum.npy [n_loc] f32,
                          .aliasp.npy / .aliaso.npy [mo_loc]
  meta.json               shapes, graph_sha, format version 1

The arrays are those of ``partition.partition_rows`` and
``index.build_sharded._shard_csr``.  The store holds no hub split: the
sharded engine refuses ``hub_rows`` with a store, as the reference does
(ROADMAP C5).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np

from ..index.build_sharded import _shard_csr
from ..index.store import graph_fingerprint
from . import partition as part

GRAPH_STORE_FORMAT_VERSION = 1


def _store_dir(path, n_shards: int) -> Path:
    return Path(path) / f"graph-shards-G{n_shards}"


def save_sharded_graph(g, path: str, n_shards: int, *,
                       row_multiple: int = 8,
                       with_walk_side: bool = True) -> Path:
    """Partition ``g`` (a CSRGraph of either package, in RAM) and write the
    per-shard layout under ``<path>/graph-shards-G<G>/``; returns that
    directory."""
    pg = part.partition_rows(g, n_shards, row_multiple=row_multiple)
    needed = part.needed_masks(pg).reshape(n_shards, n_shards, pg.n_loc)
    d = _store_dir(path, n_shards)
    d.mkdir(parents=True, exist_ok=True)
    G, n_loc, m_loc = n_shards, pg.n_loc, pg.m_loc

    mo_loc = 0
    if with_walk_side:
        n_loc_w, windptr, windices, _deg, ap, ao = _shard_csr(
            g, G, row_multiple=row_multiple)
        if n_loc_w != n_loc:
            raise AssertionError(f"walk CSR n_loc={n_loc_w} != {n_loc}")
        mo_loc = windices.shape[1]

    for s in range(G):
        p = d / f"shard_{s:04d}"
        np.save(f"{p}.insrc.npy", pg.in_src_global[s * m_loc:(s + 1) * m_loc])
        np.save(f"{p}.indst.npy", pg.in_dst_local[s * m_loc:(s + 1) * m_loc])
        np.save(f"{p}.deg.npy", pg.out_deg_sharded[s * n_loc:(s + 1) * n_loc])
        np.save(f"{p}.needed.npy", needed[s].astype(np.uint8))
        if pg.weighted:
            np.save(f"{p}.inw.npy",
                    pg.in_w_sharded[s * m_loc:(s + 1) * m_loc])
            np.save(f"{p}.wsum.npy",
                    pg.out_wsum_sharded[s * n_loc:(s + 1) * n_loc])
        if with_walk_side:
            np.save(f"{p}.windptr.npy", windptr[s])
            np.save(f"{p}.windices.npy", windices[s])
            if pg.weighted:
                np.save(f"{p}.aliasp.npy", ap[s])
                np.save(f"{p}.aliaso.npy", ao[s])

    meta = {
        "graph_store_format_version": GRAPH_STORE_FORMAT_VERSION,
        "n": g.n, "m": g.m, "n_shards": G, "n_loc": n_loc, "m_loc": m_loc,
        "mo_loc": mo_loc, "row_multiple": row_multiple,
        "weighted": bool(pg.weighted), "with_walk_side": with_walk_side,
        "graph_sha": graph_fingerprint(g),
    }
    (d / "meta.json").write_text(json.dumps(meta, indent=1))
    return d


class ShardedGraphStore:
    """A per-shard graph on disk: metadata (n, m, n_loc, weighted,
    graph_sha) and, per shard, numpy mmap views of its arrays; no global
    array is read."""

    _EXT = {"in_src_global": "insrc", "in_dst_local": "indst",
            "out_deg": "deg", "needed": "needed",
            "in_w": "inw", "out_wsum": "wsum",
            "walk_indptr": "windptr", "walk_indices": "windices",
            "alias_prob": "aliasp", "alias_other": "aliaso"}

    def __init__(self, path: str, n_shards: int):
        self.dir = _store_dir(path, n_shards)
        mf = self.dir / "meta.json"
        if not mf.exists():
            raise FileNotFoundError(
                f"no {n_shards}-way sharded graph store at {self.dir}; "
                f"write one with save_sharded_graph(g, path, {n_shards})")
        self.meta = json.loads(mf.read_text())
        if (self.meta["graph_store_format_version"]
                != GRAPH_STORE_FORMAT_VERSION):
            raise ValueError(
                f"graph store format "
                f"{self.meta['graph_store_format_version']} != "
                f"{GRAPH_STORE_FORMAT_VERSION}; re-save")
        if self.meta["n_shards"] != n_shards:
            raise ValueError("shard-count mismatch")
        self.n = int(self.meta["n"])
        self.m = int(self.meta["m"])
        self.n_shards = n_shards
        self.n_loc = int(self.meta["n_loc"])
        self.m_loc = int(self.meta["m_loc"])
        self.mo_loc = int(self.meta["mo_loc"])
        self.weighted = bool(self.meta["weighted"])
        self.with_walk_side = bool(self.meta["with_walk_side"])
        self.graph_sha: Optional[str] = self.meta.get("graph_sha")
        self.row_multiple = int(self.meta["row_multiple"])

    def shard(self, s: int) -> dict:
        """mmap views of shard ``s``'s arrays, keyed as ``_EXT`` (the
        weighted and walk-side keys where the store has them)."""
        p = self.dir / f"shard_{s:04d}"
        keys = ["in_src_global", "in_dst_local", "out_deg", "needed"]
        if self.weighted:
            keys += ["in_w", "out_wsum"]
        if self.with_walk_side:
            keys += ["walk_indptr", "walk_indices"]
            if self.weighted:
                keys += ["alias_prob", "alias_other"]
        return {k: np.load(f"{p}.{self._EXT[k]}.npy", mmap_mode="r")
                for k in keys}

    def bytes_per_shard(self, s: int = 0) -> int:
        return sum(f.stat().st_size
                   for f in self.dir.glob(f"shard_{s:04d}.*.npy"))
