"""The bytes FORA's kernels need, counted from the graph's sizes and the
pool driver's level records, and the published peaks they are held to.

Every count is of a form of the work, not of a kernel's launches: each
input byte read once and each output byte written once, whatever a
kernel reads again or however it splits its work.  A share is the least
time those bytes take at the device's published bandwidth over the
kernels' device time, so it cannot pass 100% unless the counts are too
high.

Two limits, since the level records carry no count of the active
frontier nor of a walk's hops:

* The gather's count is of the dense form of the push: every merged
  in-edge and the whole [n, width] residue on every superstep, which is
  what ``gather_tasks_kernel`` does today.  A push that touches only the
  active sources' edges needs fewer bytes, and its share by this count
  could pass 100%: such a push needs a counter of the active edges per
  superstep in the records, and a metric of its own.
* The walk's count is a loose lower bound: the start, the first hop and
  the endpoint of each walk, with the later hops left out.

* A push superstep (K1, ``gather_tasks_kernel``) on a block of ``width``
  columns: the row pointers by destination and the per-node threshold
  read, each merged in-edge's source id and multiplicity read, the pushed
  values of the nodes that have out-edges read, and the residue [n,
  width] read and written (masked, then summed into).
* An index level (K2, the same kernel) at depth q on a block: the row
  pointers of buckets q.., each index edge of those buckets (source id,
  multiplicity) and the inverse walk counts of the nodes that hold walks
  read, the residue of those nodes read, and a fresh [n, width]
  accumulator written.
* A raw walk phase (K6+K4, ``raw_walk_kernel``), per walk demanded: its
  start looked up (4 bytes), the two row pointers and the head of its
  first hop, taken with probability 1 - alpha (12 bytes; a walk starts at
  a node with residue, which the push leaves only on nodes with
  out-edges), and its weight added at its endpoint (4 bytes read, 4
  written).  The later hops are left out: the records do not say how many
  land on nodes without out-edges, where a walk stops reading, and the
  bytes of a hop that hits the L2 cache are not the device memory's, so a
  count of every hop's sectors could pass the bound.  The count is a
  lower bound of the bytes a walk moves.
"""

from __future__ import annotations

from typing import Optional

# Published HBM bandwidth, bytes/s, by ``torch.cuda.get_device_name()``:
# NVIDIA's H100 SXM data sheet, at the card's full power limit.
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}
NUM_BUCKETS = 8   # the index's prefix buckets (the FORA+ layout)


def peak_bytes_per_s(device_name: str) -> Optional[float]:
    return HBM_BYTES_PER_S.get(device_name)


def superstep_bytes(n: int, n_out: int, m_in: int, width: int) -> int:
    """K1's bytes for one push superstep on ``width`` columns: ``n``
    nodes, ``n_out`` of them with out-edges, ``m_in`` merged in-edges."""
    return 4 * (n + 1) + 4 * n + 8 * m_in + 4 * n_out * width \
        + 8 * n * width


def index_level_bytes(n: int, n_out: int, edges: int, buckets: int,
                      width: int) -> int:
    """K2's bytes for one index level on ``width`` columns over ``edges``
    index edges in ``buckets`` buckets."""
    return 4 * buckets * (n + 1) + 4 * n_out + 8 * edges \
        + 4 * n_out * width + 4 * n * width


def gather_bytes(records, n: int, n_out: int, m_in: int,
                 index_edges=None, depth_of=None) -> int:
    """K1 and K2's bytes over the level ``records`` (``last_level_stats``
    of ``TopkRunner``): each record's supersteps (summed over its blocks)
    at its width, and, in the indexed mode, one index level a block at
    the record's depth (``depth_of(record)``), whose buckets hold
    ``index_edges[q]`` edges from depth q on."""
    total = 0
    for st in records:
        total += st["supersteps"] * superstep_bytes(n, n_out, m_in,
                                                    st["width"])
        if index_edges is not None:
            q = depth_of(st)
            total += st["batches"] * index_level_bytes(
                n, n_out, index_edges[q], NUM_BUCKETS - q, st["width"])
    return total


def walk_bytes(records, alpha: float) -> float:
    """K6+K4's bytes for the walks the raw level ``records`` demand."""
    per_walk = 4 + 12 * (1.0 - alpha) + 8
    return per_walk * sum(st.get("walks_total", 0) for st in records)


def share(nbytes: float, device_s: float, device_name: str
          ) -> Optional[float]:
    """Percent of the roofline: the least time of ``nbytes`` at the
    device's published bandwidth over ``device_s``; None where there is
    nothing to read (no device time, no work, an unknown device)."""
    peak = peak_bytes_per_s(device_name)
    if peak is None or not device_s or device_s <= 0 or nbytes <= 0:
        return None
    return 100.0 * (nbytes / peak) / device_s
