"""Inputs of the index pack (K7 and its plain version), shared by the CPU
test against the JAX package (``test_torch_pack.py``) and the card's
(``test_torch_kernels_cuda.py -k pack``): each case is (endpoints [total]
int32, counts [n] int64, out_deg [n]), with counts[v] = 0 exactly where
out_deg[v] = 0 (a dangling node, packed as one self-edge)."""

import numpy as np

SMOKE = "bench_data_smoke/rmat12x8s7.npz"


def _random(rng, counts, n, stay=0.2):
    """Endpoints uniform over the nodes, a share ``stay`` of them at their
    own start (walks concentrate so, and their keys repeat)."""
    starts = np.repeat(np.arange(len(counts)), counts)
    ends = rng.integers(0, n, int(counts.sum()))
    keep = rng.random(len(ends)) < stay
    ends[keep] = starts[keep]
    return ends.astype(np.int32)


def smoke(rcfg_counts):
    """The smoke graph's degrees and index counts (``rcfg_counts(deg)``),
    random endpoints."""
    deg = np.asarray(np.load(SMOKE)["out_deg"])
    counts = rcfg_counts(deg)
    return _random(np.random.default_rng(17), counts, len(deg)), counts, deg


def case(name: str):
    """One edge case by name (see NAMES)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "no_dangling":
        n = 1000
        deg = rng.integers(1, 40, n)
        counts = rng.integers(1, 60, n)
    elif name == "all_dangling":                 # total = 0, every key a self-edge
        n = 777
        deg = np.zeros(n, np.int64)
        counts = np.zeros(n, np.int64)
    elif name == "single_walk":                  # one walk a node (cut[v, q] = 1)
        n = 3000
        deg = rng.integers(0, 5, n)
        counts = (deg > 0).astype(np.int64)
    elif name == "long_runs":
        # runs of one key longer than a tile of K7 (4096 keys), across
        # tile boundaries: a node of 30,000 walks that all end at node 7,
        # and one of 9,000 ending at 3 or 4
        n = 600
        deg = rng.integers(0, 8, n)
        counts = np.where(deg > 0, rng.integers(1, 12, n), 0)
        deg[[5, 9]] = 50
        counts[[5, 9]] = [30000, 9000]
        ends = _random(rng, counts, n)
        off = np.concatenate([[0], np.cumsum(counts)])
        ends[off[5]:off[6]] = 7
        ends[off[9]:off[10]] = rng.choice([3, 4], 9000)
        return ends, counts, deg
    elif name == "constant_digit":
        # 512 nodes, one walk each ending below 128: every key is
        # 7 << 18 | dst << 9 | src with dst < 128, so bits 16-23 (the third
        # 8-bit digit) are the same in every key and K7-sort skips that pass
        n = 512
        deg = rng.integers(1, 9, n)
        counts = np.ones(n, np.int64)
        ends = rng.integers(0, 128, n).astype(np.int32)
        return ends, counts, deg
    elif name == "one_node":                     # n = 1: one node, 1-bit ids
        ends = np.zeros(40, np.int32)
        return ends, np.array([40], np.int64), np.array([3], np.int64)
    elif name == "gap_buckets":
        # 2 to 4 walks a node, so only buckets 0 (the second to fourth
        # walks) and 7 (the first, and the dangling self-edges) hold
        # edges: buckets 1-6 are empty between them
        n = 5000
        deg = rng.integers(0, 6, n)
        counts = np.where(deg > 0, rng.integers(2, 5, n), 0)
    elif name == "many_tiles":                   # 2^16 nodes, about 2.3 M keys
        n = 1 << 16
        deg = rng.integers(0, 30, n)
        counts = np.where(deg > 0, rng.integers(1, 70, n), 0)
    elif name == "hub_tiles":
        # one node of 20,000 walks, more than three of K7-keys' 4096-entry
        # tiles, among nodes of 1 to 20
        n = 3000
        deg = rng.integers(1, 30, n)
        counts = rng.integers(1, 21, n)
        counts[1234] = 20000
    elif name == "empty_run":
        # 5,000 dangling nodes in a row between two walked ones: a tile
        # of K7-keys that spans them spans more nodes than it stages
        n = 9000
        deg = rng.integers(1, 30, n)
        deg[2000:7000] = 0
        counts = np.where(deg > 0, rng.integers(1, 7, n), 0)
    elif name == "bench_size":
        # the card's only: 2^19 nodes (42-bit keys, 6 passes) and about
        # 24 M walks, the bench index build's size
        n = 1 << 19
        deg = rng.integers(0, 40, n)
        counts = np.where(deg > 0, rng.integers(1, 92, n), 0)
    else:
        raise KeyError(name)
    return _random(rng, counts, n), counts, deg


NAMES = ("no_dangling", "all_dangling", "single_walk", "long_runs",
         "constant_digit", "one_node", "gap_buckets", "many_tiles",
         "hub_tiles", "empty_run")
