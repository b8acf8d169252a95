#!/usr/bin/env python3
"""Drive fora_tpu_torch's top-k query paths and its CLI once on one NVIDIA
GPU.

    python3 chip_smoke.py                 # the checks below
    python3 chip_smoke.py --profile 10    # query-phase profile instead

The graph is bench.py's: RMAT n = 2^19, m = 2^23, seed 7, with the
duplicate-edge merge and a 131,072-row hub split; the queries are
bench.py's defaults (eps 0.5, k 50, delta = p_f = 1/n, alpha 0.2,
delta stride 8).  Phases, each printing its wall time and peak device
memory:

  1. device      refuse to run without CUDA; print the card and its
                 power limit (nvidia-smi)
  2. build       compile the CUDA kernels from fora_tpu_torch/kernels/csrc
                 into build/fora_tpu_torch/ (cached by source hash)
  3. kernels     K1 (push superstep, split and unsplit; two launches
                 bit-equal) and K4 (walks) against their plain PyTorch
                 versions on the card; K1's time beside its bound and
                 torch.sparse.mm over the same CSR (the yardstick); K4
                 against run_walks by total variation and, bit for bit,
                 against run_walks_philox (the kernel's Philox words in
                 plain PyTorch) on shapes (i) 2^22 walks from one source
                 and (ii) the index build's first launch (2^23 walks from
                 repeat(arange(n), index_counts)), each timed beside its
                 bound: the larger of the distinct 32-byte sectors that
                 each hop of the plain walk on the same starts reads, at
                 the L2's rate, and its Philox blocks at the rate that
                 philox_probe.cu measures; K4 swept over 2^14 .. 2^23
                 walks (from one source and from the index build's
                 starts) at 1, 2, 4, 8 and 16 walks per lane, each k
                 bit-equal to the plan's, the plan's k timed against the
                 fastest (the source of kernels/schedule.py::walk_plan);
                 the K1-back pre-pass (BiPPR)
                 on a backward push of 2048 targets, twice bit-equal to
                 its plain version; K4-hub (HubPPR's walks over the CLI's
                 default hub index, 256 hubs) against the plain hub walk
                 by total variation, and on shapes (i) and (ii) as K4;
                 K4's sharded form (the out-CSR as 4 shard slices, read
                 through a table of their pointers) and its plain form
                 bit-equal to run_walks_philox on the unsharded graph at
                 shape (i)
  4. index       build the FORA+ index on the card (K4 + host pack), save
                 it under bench_data/torch_smoke/, load it back with mmap
  5. queries     256 sources as two pools of 128 through
                 TopkRunner.query_pool(defer_below=64) and flush_deferred
  6. kernels     K2 (every index bucket alone, then the level in one
                 launch, twice bit-equal, against the per-bucket plain
                 loop and timed beside torch.sparse.mm over the level's
                 merged CSR) and K3 (split accept) against their plain
                 versions on a real level's state; K3 twice bit-equal, its
                 candidates per column (mean, largest) and the columns
                 that took its dense path (none may), the dense path alone
                 bit-equal to it, torch.topk of the sum as a yardstick
                 for the selection, and K3's passes by device time
  7. quality     precision@50 of the first 32 queries against the exact
                 oracle (float64 power iteration on the card; exact ties
                 at rank 50 go to the lowest node id); must be >= 0.95
  9. sharded     the graph-sharded indexed engine with G = 4 shards placed
                 by make_mesh (all on cuda:0 on a one-card machine): the
                 phase-1 host CSR and the phase-4 index partitioned, the
                 first pool's 128 sources through ShardedForaEngine.topk
                 (once to warm, once timed, counts reset just before and
                 read just after), P1 and P2 bit-equal to their plain
                 versions on a real superstep's and the walk phase's
                 buffers (P2's one pass, which the engine runs with every
                 shard on the card, bit-equal to its plain version, to the
                 ring's hop kernels and to their plain loop; both timed
                 beside torch.sum over the stacked partials; P1's and P2's
                 bounds of the function printed beside the ring's
                 traffic), the top-50 against the single-device indexed
                 result at the same depth, precision@50 of the first 32
                 queries against phase 7's exact top-50 (>= 0.95); then
                 the raw-walk one-shot (ShardedForaEngine without an
                 index: the push to rmax * out_deg, each shard's lanes
                 from its own residues walked over the out-CSR's shard
                 slices by K4's sharded form, P2, K3's selection) on the
                 same 128 sources at the final delta, once under dense
                 and once under routed (placement seconds, wall,
                 supersteps), routed against dense (values within rtol
                 1e-4, ids outside near-ties), precision@50 of the first
                 32 >= 0.95; K4's sharded form bit-equal to
                 run_walks_philox on a raw level's allocation from the
                 one-shot's residues (its first 16 sources), timed beside
                 K4's unsharded branch on the same starts and its bound;
                 on that allocation K6 (the demand, the lane expansion
                 and the accumulate) against its plain versions and timed
                 (printed), each shard's demand equal to the plain one,
                 the chunk's lanes over the shards' demands equal to the
                 concatenation's expansion, the accumulate into the
                 shards' partials held to a float64 sum (k6_accum_check)
  10. raw walk   the first 64 sources through TopkRunner(index=None)
                 .query_pool(batch=64, defer_below=32) and flush_deferred,
                 printing per level the walks demanded (largest column,
                 all columns) beside JAX's static lane count, lanes walked,
                 column chunks, supersteps and the ms of push, alloc,
                 walks (K4), accum and accept (K3); no column may
                 overflow; K4 against the plain run_walks by a two-sample
                 chi-square on one real level's allocation, and K4 and
                 K4-hub (phase 3's hub index) on that allocation, shape
                 (iii), timed beside their bounds, K4 bit-equal to
                 run_walks_philox; K6 on the pool's largest walk phase
                 (the pool run again, that phase's residue kept, every
                 lane of its demand in one chunk, as the pool walked it):
                 the demand's cum and totals and the expansion's starts
                 and weights torch.equal to the plain versions', the
                 accumulate of K4's endpoints held to a float64 sum
                 (k6_accum_check: each entry's count of adds exact, its
                 error within the bound of any f32 sum of that many
                 positive terms), each timed as called and in
                 device time beside its bound, the plain chain and the
                 library call (torch.cumsum of the int32 omega;
                 scatter_add_ over int64 endpoints); precision@50 of the
                 first 32 against phase 7's exact top-50 (>= 0.95)
  11. montecarlo the first 32 sources through make_montecarlo_fn (2^22
                 walks per query, K4, K6's accumulate of the constant
                 weight once per chunk): wall time, precision@50 (>= 0.95)
  12. P3         the gather probe's first case (fora_tpu_torch.probes.
                 gather_probe, B = 128): P3 against its plain version and
                 K1 on the same edges sorted by destination (rtol 1e-4,
                 atol 1e-5), and its rate lines; its bound of its function
                 (E x B x 4 bytes of row reads and of reductions) at the
                 card's rate of whole 512-byte rows from the L2
                 (l2_row_rate: kernels.row_reads, the row kernel of
                 sector_probe.cu, over a 4 MB buffer)
  15. sharded pool  ShardedTopkRunner with G = 4 shards from make_mesh on
                 the phase-1 host CSR and the phase-4 index: phase 5's 256
                 sources as pools of 128 through query_pool(defer_below=64)
                 and flush_deferred, once per exchange (dense, compact,
                 routed, hier with chips_per_host=2), each with its wall,
                 level runs, supersteps and the supersteps compacted
                 against those that fell back to dense; compact, routed
                 and hier bit-equal to dense (ids, values, levels,
                 supersteps); dense against phase 5's single-device pool
                 (ids equal outside near-ties, values within rtol 1e-4, at
                 most 1% of the queries answered at another level);
                 precision@50 of the first 32 against phase 7's oracle
                 (>= 0.95); the hub split (131,072 rows) against the same
                 pool without it; the compaction kernel and P3 against
                 their plain versions on two consecutive supersteps of
                 the final level that fit the capacity (the second the
                 largest), the first as the pool left the buffers, the
                 second after it, clearing only the own blocks and the
                 first's rows (the clear, one launch for the four
                 buffers): the compacted buffers
                 equal to the ring's on every needed row and zero
                 elsewhere; the compaction, P3 and the clear timed beside
                 their bounds, the clear as called no slower than its
                 library form (4 zero_ and 4 index_fill_, as called); a
                 torch.profiler run of the dense and the routed pool, each
                 with the device time of the memsets, the compaction, P3,
                 the clear, P2 and P1
                 (PROFILE_DIR/profile_sharded_pool_*.txt); the index
                 built again by build_walk_index_sharded (its walks over
                 the out-CSR's shard slices), every array equal to phase
                 4's; both sharded stores written (the index store from
                 that build) and read back, the store-backed routed pool
                 bit-equal to the in-RAM one; and
                 (run inside phase 13) the weighted graph and index
                 through the routed pool, precision@50 >= 0.95 against the
                 weighted oracle
  16. frontier   (run after phase 15) K5, the frontier-compacted push, on
                 phase 1's graph unmerged without the hub split (phase 9's
                 layout): the first 1, 8 and 32 of phase 5's sources at
                 the final delta's rmax, compact_edges=-1 (a cap of
                 2,097,152 active out-edges) and FRONTIER_SMALL_CAP (some
                 supersteps fall back to K1's gather; both branches must
                 be seen), each against the dense push (p and r within
                 rtol 1e-5 and the node's threshold, at least 1e-6: an
                 entry at its threshold may flip under K5's atomics;
                 supersteps equal or one apart); on the B = 32 compacted
                 superstep with the most active out-edges, K5's pre-pass
                 bit-equal to its plain version and to K1's pre-pass (p,
                 contrib, the masked r, status, the tasks with their
                 masks of non-zero chunks as a set) and K5 against the
                 float64 plain sum (rtol 1e-4, P3's: f32 atomics in no
                 fixed order into rows of tens of thousands of in-edges;
                 atol 1e-9),
                 each timed as called and in device time beside its bound
                 (K5's by the 32-byte sectors its function needs: the
                 non-zero ones of the pushing rows' contrib, those of r
                 that receive a non-zero add, read and written, and the
                 edge ids, row pointers and tasks), beside the earlier
                 form of both (probes/frontier_push_earlier.cu) and K5's
                 other grids (probes/frontier_push_forms.cu: a warp going
                 on to further tasks, 2 or 4 tasks side by side) on the
                 same state (probes/frontier_probe.py, device time, each
                 checked),
                 K1 dense on the same state and torch.sparse.mm of the
                 in-CSR; K5 likewise at B = 1 and 8; the whole push
                 compacted against dense per B (medians of 3, alternated)
                 and one compacted push per B under torch.profiler
                 (device busy and idle share beside its wall).
                 Node order: phase 1's graph in the identity, degree and
                 BFS orders (relabel_graph, merged, hub split), one
                 superstep's K1 gather at B = 128 per order beside its
                 bound; phase 4's index carried to the degree order by
                 relabel_index, phase 5's sources there and on the
                 identity order with sources mapped by perm, in phase 5's
                 pools and as its first pool alone: precision@50 mapped
                 back >= 0.95 in phase 5's pools against phase 7's exact
                 PPR ranked in the order's own ids (exact ties at rank 50
                 go to the lowest id of the order the query ran in),
                 within 0.01 of the identity order's in both, its push's
                 p within rtol 1e-5 (and the node's threshold) of the
                 identity order's
  13. weighted   bench.py's weighted graph (phase 1's edges, weights
                 exp2(U(-2, 2)) from default_rng(SEED + 31)) through the
                 port's from_edges(w=) and to_device (merge, hub split,
                 alias tables from the library's host builder, its seconds
                 printed); one weighted K1 superstep twice bit-equal and
                 against the float64 plain version; K4's alias branch on
                 2^22 walks from one source against the plain alias walk
                 (total variation below 0.01, where K4's uniform branch on
                 the same graph must read above it), and on shapes (i)
                 and (ii) as K4 (its bound with the alias-table reads, at
                 the rate for the out-CSR and alias tables together), its
                 shape (iii) in the weighted raw pool; the weighted FORA+
                 index
                 built, saved under bench_data/torch_smoke_w/ and loaded
                 with mmap; 256 sources in two pools of 128 as in phase 5;
                 precision@50 of the first 32 against the weighted oracle
                 (>= 0.95); then phases 10 and 11 on the weighted graph:
                 the raw-walk pool of 64 with its chi-square of K4's alias
                 branch on one level's allocation, and Monte Carlo, each
                 at the same gate; and K4-hub's alias branch against the
                 plain alias hub walk (total variation below 0.01, where
                 its uniform hops must read above it) and bit-equal to
                 run_walks_philox on shape (i); K4's sharded alias form
                 bit-equal to run_walks_philox at shape (i); and phase 9's
                 raw one-shot on the weighted graph (dense and routed,
                 precision@50 >= 0.95 against the weighted oracle, K4's
                 sharded alias form held and timed on its allocation)
  14. cli        bench.py's graph through fora_tpu_torch.cli as users run
                 it: save_dataset to bench_data/torch_smoke_cli/ and
                 load_dataset through the library parser (seconds of each;
                 the CSR equal to phase 1's), phase 5's 256 sources as the
                 query file, gen-exact-topk, build, batch-topk --with-idx
                 (pools of 128, defer 64, --eval-exact), query --algo
                 fwdpush and hubppr (the CLI's defaults: 256 hubs, a pool
                 entry per walk of a query) on the first 32, then
                 make_hubppr_fn with the JAX package's 2^15-entry pool,
                 printed, not gated (walks share pool entries: ROADMAP
                 C15), query --algo bippr on the first 16 against 2048
                 targets holding their exact top-50; precision@50 >=
                 0.95 for batch-topk and hubppr;
                 make_bippr_fn itself, where under 1% of the pairs with
                 exact PPR above delta may miss eps; then the serve action
                 in a subprocess (bench_data/torch_smoke_serve.py), 64
                 sequential requests (latency p50/p95/p99) and 8
                 concurrent clients of 32 (q/s, batches, sheds), every
                 reply with 50 nodes, no error, precision@50 >= 0.95;
                 the sharded forms: shard-graph --graph-shards 4, build
                 --index-shards 4 (both stores), batch-topk --graph-shards
                 4 --exchange routed reading both (precision@50 >= 0.95),
                 and the server again with --graph-shards 2, the same
                 requests and gates, its answers' overlap with the first
                 server's printed
  8. proof       every kernel of each path launched in its run (counts
                 reset just before each run, read just after): K1-K4 in
                 phases 4-5 with two K1 gathers per superstep and one K2
                 launch per level of each batch, K1-K3, P1 and P2 in
                 phase 9's timed run with one K2 launch per shard, P1 at
                 (G-1) G launches per superstep and P2's one pass once
                 (its hop kernel never with every shard on one card),
                 K1, K3 and K4 and no K2 in phase 10, K4 in phase 11, P3
                 in phase 12; K6's three kernels in the raw pools (phases
                 10 and 13, an accumulate per expansion) and the raw
                 one-shots (phases 9 and 13, the demand once per shard),
                 its accumulate alone in Monte Carlo (phases 11 and 13,
                 once per chunk) and the CLI's hubppr, K6 on no other
                 path, and no plain version of K6 in any of those runs
                 nor in any CLI action (``count_plain_k6``); in phase 13
                 K1-K3 and K4's alias branch
                 (index_walk_alias) in the indexed run, K1, K3 and the
                 alias branch in the raw pool, the alias branch in Monte
                 Carlo, never the uniform branch there and never the
                 alias branch before; in phase 14 K4 in build, K1-K3 in
                 batch-topk and in the server (its launch counts printed
                 at SIGTERM), K1 in fwdpush, the K1-back pre-pass, K1 and
                 K4 in bippr, K4-hub in hubppr and nowhere else, and
                 neither new kernel before phase 14, and the sharded
                 batch-topk and server on their kernels; in phase 15 per
                 exchange K2 and K3 once per shard per level run, P2's one
                 pass once per level run, K1 once per shard per
                 superstep, P1 on every superstep that took the ring, P3
                 once per shard per compacted superstep, the clear once on
                 each compacted superstep that follows a compacted one,
                 the compaction kernel on the compacted runs and none of
                 the three on dense or on any other path; in each raw
                 one-shot run (phases 9 and 13) K4's sharded form (its
                 alias form on the weighted graph only), K1, K3 once per
                 shard, P2's one pass once, P1 on the supersteps that took
                 the ring, P3 and the clear on routed's compacted ones, no
                 K2 and no unsharded walk branch; in the sharded index
                 build K4's sharded form once per 2^23 walks; K4's sharded
                 form on no other path; in phase 16's compacted pushes
                 K5's pre-pass, K5 and K1's gather (the supersteps that
                 fell back), never K1's pre-pass; K1-K3 in the relabelled
                 pool; K5 and its pre-pass on no other path; and neither
                 JAX nor the JAX package fora_tpu was imported, by this
                 process or the servers

It prints one JSON line of per-kernel results (launches, max abs error,
ms, plain ms, bound ms and what bounds it: each input read and each
output written once at the card's published memory rate
(fora_tpu_torch.utils.profiling.HBM_BW), or its f32 operations at 67
TFLOP/s; for K4 and its alias and hub branches the larger of the
distinct sectors each hop's walks read and their Philox blocks; library
ms: one PyTorch call computing the same function, or null; P3 has two
rows: row_scatter_add is the gather probe of phase 12 with phase 12's
launches, row_scatter_add_receive is the receive of one shard on phase
15's routed superstep with the routed pool's launches; P2 has two:
ring_reduce_scatter_hop is the ring's hop kernel, which no path runs
with every shard on one card (0 launches), reduce_scatter_onepass the
one pass that phase 9 runs; the rows timed on phase 15's superstep,
frontier_compact, row_scatter_add_receive and exchange_clear, also carry
device_ms, the kernel's time with the host's enqueue hidden, beside ms,
which like every ms of the line times the launches as called, and the
clear its library form's device time, library_device_ms;
index_walk_sharded and index_walk_sharded_alias, K4's sharded form on
the raw one-shot's allocation with the raw one-shot's launches (phases 9
and 13), carry unsharded_ms, K4's unsharded branch on the same starts;
frontier_prepass and frontier_push, K5's two launches, phase 16's
superstep at B = 32 with the launches of its compacted pushes, carry
device_ms and earlier_device_ms, the earlier form's device time on the
same state; walk_demand, expand_lanes and accumulate_endpoints, K6, are
phase 10's pool's largest walk phase with phase 10's launches and carry
device_ms: the demand's bound r read and cum written once, the
expansion's 8 bytes
a lane slot written and the distinct 32-byte sectors of cum and r at the
lanes' nodes, the accumulate's 8 bytes a lane read and the distinct
sectors of the output it touches, read and written), then,
only if every phase passed, the last line {"ok": true, "device": {...}}.
Any failure raises and exits non-zero.

``--profile PAIRS`` runs phases 1, 2 and 4, then times the query phase
with the hub split on and off in PAIRS alternating pairs, and phase 9's
sharded one-shot top-k against the single-device level at the same depth
in PAIRS more, and one phase-10 pool PAIRS times; it profiles one more
run of each with torch.profiler (device busy time, idle share,
per-kernel device time; full tables in PROFILE_DIR) and times each
shard's push gather against one single-device gather.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

NLOG2, EDGEF, SEED = 19, 16, 7
SHARDS = 4
HUB_ROWS = 131072
BATCH, POOL, QUERIES, DEFER = 128, 128, 256, 64
K, EPS, DSTRIDE, ACCEPT = 50, 0.5, 8.0, 1.0
EVAL_N = 32
MIN_PRECISION = 0.95
WALK_CHECK = 1 << 22                # K4's shape (i): walks from one source
INDEX_LAUNCH = 1 << 23              # shape (ii): the index build's launch
SWEEP_LOG2 = tuple(range(14, 24))   # K4's sweep: 2^14 .. 2^23 walks
SWEEP_KS = (1, 2, 4, 8, 16)         # and these walks per lane
ROOT = Path(__file__).resolve().parent
INDEX_DIR = ROOT / "bench_data" / "torch_smoke"
W_INDEX_DIR = ROOT / "bench_data" / "torch_smoke_w"
PROFILE_DIR = ROOT / "chiprun_out"
DEVICE = "cuda:0"
MAIN_KERNELS = ("push_prepass", "gather_scatter_add", "index_spmv",
                "topk_bounds", "index_walk")
SHARDED_KERNELS = ("push_prepass", "gather_scatter_add", "index_spmv",
                   "topk_bounds", "ring_all_gather_hop",
                   "reduce_scatter_onepass")
RAW_KERNELS = ("push_prepass", "gather_scatter_add", "index_walk",
               "topk_bounds")
WEIGHTED_KERNELS = ("push_prepass", "gather_scatter_add", "index_spmv",
                    "topk_bounds", "index_walk_alias")
RAW_QUERIES, RAW_BATCH, RAW_DEFER = 64, 64, 32
POOL_PAIRS = 5                      # phase 15: warm walls per exchange
RAW_CHECK_COLS = 16                 # phases 9, 13: K4's sharded form held
#                                     on the raw allocation of 16 queries
NUM_HUBS = 256                      # the CLI's --num-hubs default
JAX_POOL = 1 << 15                  # fora_tpu's default_pool_size cap
BIPPR_SOURCES, BIPPR_TARGETS = 16, 2048
CLI_DIR = ROOT / "bench_data" / "torch_smoke_cli"
CLI_DATASET = "rmat19"
SERVE_BATCH, SERVE_SEQ, SERVE_CLIENTS, SERVE_PER_CLIENT = 8, 64, 8, 32
SERVE_START_S = 300
MC_QUERIES, CHISQ_SOURCES, CHISQ_MIN_P = 32, 8, 1e-3
# the H100 SXM's published f32 peak outside the tensor cores at 700 W
# (NVIDIA's data sheet); hbm_rate() gives the device memory rate
F32_OPS_PER_S = 67e12
# the L2: 50 MB (the data sheet) in 32-byte sectors; NVIDIA publishes no
# rate for it, so sector_rate() measures one
L2_BYTES, SECTOR = 50e6, 32


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def hbm_rate() -> float:
    """The card's published device memory rate in bytes/s
    (fora_tpu_torch.utils.profiling.HBM_BW, by the card's name)."""
    from fora_tpu_torch.utils.profiling import device_hbm_bw
    return device_hbm_bw(DEVICE)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(moved: int, ops: float = 0.0) -> dict:
    """bound_ms and bound_by of a kernel that must move ``moved`` bytes
    (each input read once, each output written once) and do ``ops`` f32
    operations: the larger of the two times at the card's peaks."""
    t_bytes = moved / hbm_rate() * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (dict(bound_ms=t_bytes, bound_by="bytes") if t_bytes >= t_ops
            else dict(bound_ms=t_ops, bound_by="operations"))


def sector_rate(size_bytes: int, device) -> float:
    """Bytes per second at which the card serves scattered 32-byte sectors
    of a buffer of ``size_bytes``, measured with the hand-written read
    kernel of kernels/csrc/sector_probe.cu (64 independent reads a thread,
    past the L1): the best of 2^18, 2^20 and 2^22 threads, three timings
    each."""
    import torch
    from fora_tpu_torch import kernels
    from fora_tpu_torch.utils.timing import cuda_ms
    buf = torch.zeros(size_bytes // 4, dtype=torch.int32, device=device)
    rates = {}
    for log2 in (18, 20, 22):
        sectors = kernels.sector_reads(buf, threads=1 << log2)
        ms = min(cuda_ms(lambda: kernels.sector_reads(buf, threads=1 << log2))
                 for _ in range(3))
        rates[log2] = SECTOR * sectors / (ms * 1e-3)
    print("sector_probe over " + f"{size_bytes / 1e6:.1f} MB: " + ", ".join(
        f"2^{k} threads {v / 1e12:.3f} TB/s" for k, v in rates.items()))
    return max(rates.values())


def walk_bytes(graph, hub=None) -> int:
    """Bytes of what a walk reads: the out-CSR, the alias tables on a graph
    that has them, and a hub index's hub_id and pool where one is given."""
    return nbytes(graph.out_indptr, graph.out_indices, graph.alias_prob,
                  graph.alias_other, *((hub.hub_id, hub.pool) if hub else ()))


def walk_sector_rate(graph, hub=None) -> float:
    """The rate at which walk_bound() charges a scattered 32-byte sector:
    sector_rate() over a buffer of walk_bytes() when that fits the L2,
    device memory's published rate otherwise."""
    size = walk_bytes(graph, hub)
    if size <= L2_BYTES:
        return sector_rate(size, graph.device)
    return hbm_rate()


_philox_rates: dict = {}


def philox_rate(device) -> float:
    """Philox-4x32-10 blocks per second with every lane busy and no loads,
    measured once per device with the hand-written kernel of
    kernels/csrc/philox_probe.cu (256 blocks a thread): the best of 2^20
    and 2^22 threads, three timings each."""
    import torch
    from fora_tpu_torch import kernels
    from fora_tpu_torch.utils.timing import cuda_ms
    key = str(device)
    if key not in _philox_rates:
        out = torch.empty(1 << 22, dtype=torch.int32, device=device)
        rates = {}
        for log2 in (20, 22):
            part = out[:1 << log2]
            blocks = kernels.philox_blocks(part)
            ms = min(cuda_ms(lambda: kernels.philox_blocks(part))
                     for _ in range(3))
            rates[log2] = blocks / (ms * 1e-3)
        print("philox_probe: " + ", ".join(
            f"2^{k} threads {v / 1e9:.2f} G blocks/s"
            for k, v in rates.items()))
        _philox_rates[key] = max(rates.values())
    return _philox_rates[key]


def walk_bound(graph, start, gen, alpha, max_hops, rate, hub=None) -> dict:
    """K4's bound_ms: the larger of the time of what these walks must read
    and the time of the Philox-4x32-10 blocks they must draw.  The reads,
    each piece of data once per hop: a walk is a chain of reads that no
    layout coalesces, and walks that read the same sector in one hop share
    the read.  Per hop the
    function needs the row pointers indptr[cur], indptr[cur + 1] of every
    node the walks stand on (the degree is their difference) and, for every
    walk that moves, out_indices[slot]; on a graph with alias tables
    alias_prob[slot], then the one of out_indices[slot] and
    alias_other[slot] that the hop takes.  With a hub index (K4-hub) every
    walk that moves also reads hub_id[next], and a walk that lands on a hub
    reads one pool entry and stops.  Each is counted as the distinct
    32-byte sectors that hop's walks read.  The hops come from the plain
    lockstep walk on the same starts (run_walks' loop with counters; the
    hub walk's where ``hub`` is given); the starts are read and the
    endpoints written once, 4 bytes each, at device memory's rate.  The
    sectors come at ``rate`` (walk_sector_rate()).  The operations: one
    block for each walk (its length) and one for each hop, at
    philox_rate().  Printed beside it, not part of it: the time of each
    walk's own reads at the same rate, as if no two walks shared a
    sector (what a kernel that issues every walk's loads itself can only
    beat through its caches)."""
    import torch
    from fora_tpu_torch.ops.walk import geometric_lengths
    alias = graph.alias_prob is not None
    length = geometric_lengths(start.shape, alpha, max_hops, generator=gen)
    deg = graph.out_deg.long()
    indptr, indices = graph.out_indptr.long(), graph.out_indices.long()
    other = graph.alias_other.long() if alias else None
    per_sector = SECTOR // graph.out_indptr.element_size()
    cur = start.long()
    done = torch.zeros(start.shape, dtype=torch.bool, device=start.device)
    ptr_sectors = moved = landed = sectors = own_reads = 0

    def sectors_of(idx):
        return torch.unique(idx // per_sector).numel()
    for h in range(int(length.max())):
        u = torch.rand(start.shape, generator=gen, device=gen.device)
        d = deg[cur]
        going = (length > h) & ~done
        alive = going & (d > 0)
        nodes = torch.unique(cur[going])
        ptr_sectors += torch.unique(torch.cat(
            [nodes // per_sector, (nodes + 1) // per_sector])).numel()
        # each walk's own reads: its row pointers' sectors, then one
        # sector per table it reads
        own_reads += int(going.sum()) + int(
            (going & (cur % per_sector == per_sector - 1)).sum())
        moved += int(alive.sum())
        own_reads += int(alive.sum()) * (2 if alias else 1)
        j = torch.minimum((u * d.float()).long(), (d - 1).clamp_min(0))
        slot = (indptr[cur] + j).clamp_max(indices.shape[0] - 1)
        nxt = indices[slot]
        sectors += sectors_of(slot[alive])
        if alias:
            u2 = torch.rand(start.shape, generator=gen, device=gen.device)
            own = u2 < graph.alias_prob[slot]
            nxt = torch.where(own, nxt, other[slot])
            sectors += (sectors_of(slot[alive & own])
                        + sectors_of(slot[alive & ~own]))
        cur = torch.where(alive, nxt, cur)
        if hub is not None:
            hid = hub.hub_id[cur].long()
            at_hub = alive & (hid >= 0)
            landed += int(at_hub.sum())
            own_reads += int(alive.sum()) + int(at_hub.sum())
            done |= at_hub
            pj = (torch.rand(start.shape, generator=gen, device=gen.device)
                  * hub.pool_size).long().clamp_max(hub.pool_size - 1)
            sectors += (sectors_of(cur[alive])
                        + sectors_of((hid * hub.pool_size + pj)[at_hub]))
    csr = nbytes(graph.out_indptr, graph.out_indices)
    walked = walk_bytes(graph, hub)
    ends = 2 * nbytes(start) / hbm_rate()
    ms = (SECTOR * (ptr_sectors + sectors) / rate + ends) * 1e3
    source = (f"measured over {walked / 1e6:.1f} MB, sector_probe.cu"
              if walked <= L2_BYTES else "the data sheet")
    name = "K4" + ("-alias" if alias else "") + ("-hub" if hub else "")
    reads = ("edge-list" + (" and alias-table" if alias else "")
             + (", hub_id and pool" if hub is not None else ""))
    blocks = moved + start.numel()
    ops_ms = blocks / philox_rate(start.device) * 1e3
    by = "bytes" if ms >= ops_ms else "operations"
    own_ms = (SECTOR * own_reads / rate + ends) * 1e3
    print(f"{name} bound: {start.numel()} walks took "
          f"{moved} hops ({moved / start.numel():.3f} each)"
          + (f", {landed} of them stopped at a hub" if hub is not None
             else "")
          + f"; distinct {SECTOR}-byte sectors per hop: {ptr_sectors} of "
          f"row pointers and {sectors} of {reads} reads; the out-CSR is "
          f"{csr / 1e6:.1f} MB"
          + (f" (with what the walk reads {walked / 1e6:.1f} MB)"
             if walked != csr else "")
          + f", the L2 {L2_BYTES / 1e6:.0f} MB: scattered sectors at "
          f"{rate / 1e12:.3f} TB/s ({source}) -> {ms:.4f} ms; {blocks} "
          f"Philox blocks at {philox_rate(start.device) / 1e9:.2f} G/s "
          f"(philox_probe.cu) -> {ops_ms:.4f} ms; bound by {by}; the "
          f"walks' own reads, no sector shared between walks: {own_reads} "
          f"sectors -> {own_ms:.4f} ms")
    return dict(bound_ms=max(ms, ops_ms), bound_by=by)


def walk_branch(graph, hub=None) -> str:
    """K4's branch that ``graph`` (and a hub index) take."""
    return ("K4" + ("-alias" if graph.alias_prob is not None else "")
            + ("-hub" if hub is not None else ""))


def walk_shapes(graph, rcfg, shapes, rate, hub=None, exact=("i", "ii")
                ) -> dict:
    """One K4 branch (the alias branch on a graph with tables, K4-hub
    with ``hub``) through its public entry on each of ``shapes`` (label ->
    starts): bit-equal to ops.walk.run_walks_philox on the labels in
    ``exact`` (a walk that differs fails), timed with CUDA events beside
    walk_bound() at sector ``rate``; one line per shape.  Returns {label:
    {walks, ms, bound_ms, bound_by}}."""
    import torch
    from fora_tpu_torch.algo import hubppr
    from fora_tpu_torch.ops import walk
    from fora_tpu_torch.utils.timing import cuda_ms
    name = walk_branch(graph, hub)
    a, hops = rcfg.alpha, rcfg.max_walk_hops
    out = {}
    for label, start in shapes.items():
        def run():
            if hub is not None:
                return hubppr.hub_walks(graph, start, SEED, hub, alpha=a,
                                        max_hops=hops)
            return walk.walk_endpoints(graph, start, SEED, a, hops)
        got = run()
        line = ""
        if label in exact:
            want = walk.run_walks_philox(graph, start, SEED, a, hops, hub=hub)
            diff = int((got != want).sum())
            if diff:
                fail(f"{name} ({label}): {diff} of {start.numel()} walks "
                     f"differ from run_walks_philox")
            line = "; bit-equal to run_walks_philox"
            del want
        del got
        ms = cuda_ms(run)
        gen = torch.Generator(device=start.device).manual_seed(SEED)
        b = walk_bound(graph, start, gen, a, hops, rate, hub=hub)
        print(f"{name} ({label}) {start.numel()} walks: {ms:.4f} ms against "
              f"its bound {b['bound_ms']:.4f} ms by {b['bound_by']} "
              f"({b['bound_ms'] / ms:.0%} of it reached){line}")
        out[label] = dict(walks=start.numel(), ms=ms, **b)
    return out


def index_build_starts(graph, rcfg, count: int):
    """K4's shape (ii): the starts of the index build's first launch, the
    first ``count`` of repeat(arange(n), index_counts(out_deg, rcfg)),
    int32 on the graph's device."""
    import numpy as np
    import torch
    from fora_tpu_torch.index.build import index_counts
    starts = np.repeat(np.arange(graph.n, dtype=np.int32),
                       index_counts(graph.out_deg.cpu().numpy(), rcfg))
    return torch.from_numpy(starts[:count]).to(graph.device)


def walk_sweep(graph, rcfg, source) -> None:
    """K4 (uniform) at 2^14 .. 2^23 walks from one source and from the
    index build's starts, at each walks per lane of SWEEP_KS (forced
    through schedule.walk_grid): every k bit-equal to the plan's, since
    a walk's endpoint depends on no schedule (one that differs fails),
    timed with CUDA events; one line per size, the plan's k against the
    fastest.  The measurement that kernels/schedule.py::walk_plan
    follows."""
    import torch
    from fora_tpu_torch import kernels
    from fora_tpu_torch.kernels import schedule
    from fora_tpu_torch.utils.timing import cuda_ms
    a, hops = rcfg.alpha, rcfg.max_walk_hops
    sms = kernels.sm_count(graph.device)
    build_starts = index_build_starts(graph, rcfg, 1 << SWEEP_LOG2[-1])
    for log2 in SWEEP_LOG2:
        W = 1 << log2
        plan_k = schedule.walk_plan(W, sms).walks_per_lane
        for label, start in (
                ("one source", torch.full((W,), int(source),
                                          dtype=torch.int32,
                                          device=graph.device)),
                ("index build's starts", build_starts[:W])):
            def run(k):
                return kernels._index_walk(
                    start, graph.out_indptr, graph.out_indices, None, None,
                    SEED, a, hops, "index_walk",
                    plan=schedule.walk_grid(W, k))
            want = run(plan_k)
            ms = {}
            for k in SWEEP_KS:
                diff = int((run(k) != want).sum())
                if diff:
                    fail(f"K4 sweep ({label}, 2^{log2} walks): {diff} walks "
                         f"differ between k = {k} and k = {plan_k}")
                ms[k] = cuda_ms(lambda: run(k))
            best = min(ms, key=ms.get)
            print(f"K4 sweep ({label}) 2^{log2} walks: "
                  + ", ".join(f"k {k} {v:.4f}" for k, v in ms.items())
                  + f" ms; the plan's k = {plan_k} "
                  f"{ms[plan_k] / ms[best] - 1:+.1%} against k = {best}; "
                  f"every k bit-equal")


def plain_superstep(graph, p, r, thr, alpha):
    """One push superstep by the plain versions, in place on ``p`` and
    ``r`` (float32, or float64 for a reference in exact arithmetic's
    place); returns (p, r, flag)."""
    import torch
    from fora_tpu_torch.ops import gather, push
    contrib = torch.empty_like(r)
    flag = torch.zeros(1, dtype=torch.int32, device=r.device)
    push.push_prepass_plain(p, r, contrib, thr, graph.out_deg,
                            push.out_weight(graph), alpha)
    hub = graph.hub_split
    gather.gather_scatter_add_plain(
        r, contrib, graph.in_indptr, graph.in_src, edge_w=graph.in_w,
        thr=thr, mask=True, flag=None if hub else flag)
    if hub:
        gather.gather_scatter_add_plain(
            r, contrib.index_select(0, graph.hub_ids), graph.hub_indptr,
            graph.hub_src_local, edge_w=graph.hub_w, thr=thr, flag=flag)
    return p, r, int(flag.item())


def kernel_superstep(graph, p, r, thr, alpha):
    """The same superstep through K1's kernels; returns (p, r, flag)."""
    import torch
    from fora_tpu_torch.ops import push
    flag = torch.zeros(1, dtype=torch.int32, device=r.device)
    push.superstep(graph, push.PushState(p, r, 0), alpha=alpha, thr=thr,
                   flag=flag)
    return p, r, int(flag.item())


def sparse_csr(indptr, cols, vals, n_cols):
    """A torch CSR tensor over the given rows (the yardstick operand of
    torch.sparse.mm; the port never builds one)."""
    import warnings
    import torch
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return torch.sparse_csr_tensor(
            indptr, cols, vals, size=(indptr.shape[0] - 1, n_cols),
            check_invariants=False)


def sparse_mm(a, x):
    import warnings
    import torch
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return torch.sparse.mm(a, x)


def level_csr(buckets, depth, inv, n):
    """The index edges of buckets depth.. as one CSR by endpoint, each
    edge valued mult_e * inv_cnt[v_e]: what torch.sparse.mm needs to
    compute a level's walk phase in one call."""
    import torch
    rows, cols, vals = [], [], []
    for b in buckets[depth:]:
        if b is None:
            continue
        indptr, src, mult = b
        dev = indptr.device
        rows.append(torch.repeat_interleave(
            torch.arange(n, device=dev, dtype=torch.int32),
            torch.diff(indptr.long())))
        cols.append(src)
        v = inv[src.long()]
        vals.append(v if mult is None else mult * v)
    row = torch.cat(rows)
    order = torch.argsort(row, stable=True)
    crow = torch.searchsorted(row[order].contiguous(),
                              torch.arange(n + 1, device=row.device,
                                           dtype=torch.int32),
                              out_int32=True)
    return sparse_csr(crow, torch.cat(cols)[order].contiguous(),
                      torch.cat(vals)[order].contiguous(), n)


def close(name, got, want, rtol, atol):
    """Max |got - want|; fails unless |got - want| <= atol + rtol |want|."""
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    max_err = float(err.max()) if err.numel() else 0.0
    if bool(bad.any()):
        first = tuple(bad.nonzero()[0].tolist())
        fail(f"{name}: {int(bad.sum())} entries differ beyond rtol {rtol} "
             f"and atol (first at {first}: {float(got[first]):.6e} vs "
             f"{float(want[first]):.6e}; max abs err {max_err:.3e})")
    return max_err


def plain64(fn, values, chunk: int = 16):
    """``fn(values.double()).float()`` computed ``chunk`` columns at a
    time, so a float64 plain version of a gather stays within a few GiB."""
    import torch
    return torch.cat([fn(values[:, c:c + chunk].double()).float()
                      for c in range(0, values.shape[1], chunk)], dim=1)


def foreign_modules() -> set:
    """Loaded modules of JAX or of the JAX package ``fora_tpu``."""
    return {m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "fora_tpu")}


def build_index(g, dg, rcfg, path=INDEX_DIR):
    """The FORA+ index built on the card (K4 + host pack), saved under
    ``path`` and loaded back through mmap."""
    from fora_tpu_torch import index as tidx
    t0 = time.perf_counter()
    built = tidx.build_walk_index(dg, rcfg, SEED)
    walks = int(tidx.index_counts(g.out_deg, rcfg).sum())
    print(f"index: {walks} walks -> {built.total_edges} index edges in "
          f"{time.perf_counter() - t0:.1f} s")
    tidx.save(built, rcfg, str(path), graph=g)
    index = tidx.load(str(path), rcfg, graph=g, mmap=True)
    if index.total_edges != built.total_edges:
        fail("index reload: edge count differs")
    return index


def level_line(where, st, runner=None) -> str:
    """One level record of ``runner.last_level_stats``; a raw-walk level
    adds its walk counts, JAX's static lane count for the level
    (walk_lane_budget, capped at its 2^23 lanes) and per-stage ms."""
    line = (f"  {where} level {st['level']}: pending {st['pending']} width "
            f"{st['width']} batches {st['batches']} accepted "
            f"{st['accepted']} supersteps {st['supersteps']} {st['secs']} s")
    if "compacted" in st:
        line += (f"; exchange compacted {st['compacted']}, fell back to "
                 f"dense {st['fell_back']}")
    if "walks_max" in st:
        from fora_tpu_torch.ops.walk import walk_lane_budget
        rc = runner.rcfg.with_delta(st["delta"])
        static = walk_lane_budget(rc.omega_unit, rc.rmax, rc.m, rc.n,
                                  cap=1 << 23)
        ms = " ".join(f"{k} {v:.2f}" for k, v in st["ms"].items())
        line += (f"; walks demanded max {st['walks_max']} total "
                 f"{st['walks_total']} (JAX's static lanes {static}); lanes "
                 f"{st['lanes']} in {st['chunks']} chunks; overflow "
                 f"{st['overflow']}; ms {ms}")
    return line


def run_queries(runner, sources, log=print, pool=POOL, batch=BATCH,
                defer=DEFER, values=None):
    """bench.py's query phase: pools of ``pool`` through query_pool, then
    flush_deferred.  Returns ({source: top-k ids}, accepted, levels used,
    wall seconds, every level record); ``values``, a dict, gets each
    source's top-k values."""
    import torch
    results, n_acc, levels, stats = {}, 0, 0, []
    pools = [sources[i:i + pool] for i in range(0, len(sources), pool)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for pi, part in enumerate(pools):
        res = runner.query_pool(part, batch=batch, defer_below=defer)
        for i, s in enumerate(part):
            if not res.deferred[i]:
                results[int(s)] = res.node_ids[i]
                if values is not None:
                    values[int(s)] = res.values[i]
        n_acc += int(res.accepted.sum())
        levels = max(levels, res.levels_used)
        stats += runner.last_level_stats
        for st in runner.last_level_stats:
            log(level_line(f"pool {pi}", st, runner))
    dsrcs, dres = runner.flush_deferred(batch=batch)
    if dres is not None:
        for i, s in enumerate(dsrcs):
            results[int(s)] = dres.node_ids[i]
            if values is not None:
                values[int(s)] = dres.values[i]
        n_acc += int(dres.accepted.sum())
        levels = max(levels, dres.levels_used)
        stats += runner.last_level_stats
        for st in runner.last_level_stats:
            log(level_line(f"flush({len(dsrcs)})", st, runner))
    torch.cuda.synchronize()
    return results, n_acc, levels, time.perf_counter() - t0, stats


def profile_once(name, fn, need_trace: bool = True):
    """One run of ``fn`` under torch.profiler: wall, device busy time, idle
    share and the kernels by device time (full table in
    PROFILE_DIR/profile_<name>.txt); returns {device record: (ms,
    calls)}, empty where no trace was read.  Without ``need_trace`` a profiler
    that cannot start or read its trace is reported and passed over;
    ``fn`` itself always runs outside that allowance, so what it raises
    is raised."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    PROFILE_DIR.mkdir(exist_ok=True)
    try:
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.__enter__()
    except RuntimeError as e:
        if need_trace:
            raise
        print(f"profile {name}: the profiler did not start ({e})")
        prof = None
    try:
        wall = timed(fn)
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                ka = prof.key_averages()
            except RuntimeError as e:
                if need_trace:
                    raise
                print(f"profile {name}: no trace ({e})")
                prof = None
    if prof is None:
        return {}
    # the device's own records (kernels, copies); an aten op's device time
    # repeats its kernels' and is left out
    kernels = [e for e in ka if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    out = PROFILE_DIR / f"profile_{name}.txt"
    out.write_text(ka.table(sort_by="self_cuda_time_total", row_limit=30))
    print(f"profile {name}: profiled wall {wall * 1e3:.1f} ms, device busy "
          f"{busy_ms:.1f} ms, idle share {1 - busy_ms / (wall * 1e3):.3f} "
          f"({out.name})")
    for e in sorted(kernels, key=dev_us, reverse=True)[:8]:
        if dev_us(e) > 0:
            print(f"  {e.key[:60]}: {dev_us(e) / 1e3:.2f} ms, "
                  f"{e.count} calls")
    return {e.key: (dev_us(e) / 1e3, e.count) for e in kernels}


def timed(fn) -> float:
    """Wall seconds of ``fn()``, between two device synchronises."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def alternate(pairs, fns, label):
    """Each of ``fns`` (returning its own wall seconds) over ``pairs``
    alternating pairs, after one warm-up run each."""
    for fn in fns.values():
        fn()
    walls = {name: [] for name in fns}
    names = list(fns)
    for i in range(pairs):
        for name in (names if i % 2 == 0 else names[::-1]):
            walls[name].append(fns[name]())
    for name, w in walls.items():
        print(f"profile {name}: {label} wall over {len(w)} runs (s): "
              + " ".join(f"{x:.4f}" for x in w)
              + f"; median {statistics.median(w):.4f} mean "
              f"{statistics.mean(w):.4f}")


def profile_queries(pairs, layouts, make_runner, sources):
    """Query-phase wall time per graph layout over ``pairs`` alternating
    pairs, then one torch.profiler run per layout."""
    quiet = lambda *a: None   # noqa: E731
    alternate(pairs, {name: (lambda gr=graph: run_queries(
        make_runner(gr), sources, quiet)[3])
        for name, graph in layouts.items()}, "query")
    for name, graph in layouts.items():
        runner = make_runner(graph)
        profile_once(name, lambda: run_queries(runner, sources, quiet))


def profile_sharded(pairs, g, rcfg, index, sources, dev):
    """The sharded one-shot top-k against the single-device indexed level
    at the same depth (unmerged graph, no hub split) over ``pairs``
    alternating pairs; one torch.profiler run of each; then each shard's
    push gather against the single-device gather on the same spread-out
    state, with each shard's edge count and largest in-degree."""
    import numpy as np
    import torch
    from fora_tpu_torch import kernels
    from fora_tpu_torch.algo.fora import StagedForaPrograms
    from fora_tpu_torch.graph import to_device
    from fora_tpu_torch.ops import push, ring
    from fora_tpu_torch.ops.topk import topk_sum
    from fora_tpu_torch.parallel import ShardedForaEngine, make_mesh
    from fora_tpu_torch.utils.timing import cuda_ms

    eng = ShardedForaEngine(g, make_mesh(SHARDS), rcfg, k=K, index=index)
    dg_raw = to_device(g, device=dev)
    staged = StagedForaPrograms(dg_raw, rcfg, index)
    level = staged.lean_state_fn(eng.index_depth)
    src_t = torch.as_tensor(sources, dtype=torch.int32, device=dev)

    def one_device():
        st = push.init_state(g.n, src_t)
        p, _, contrib, _ = level(st.p, st.r, rcfg.rmax, rcfg.omega_unit)
        topk_sum(p, contrib, K)[1].cpu()

    fns = {f"sharded{SHARDS}": lambda: eng.topk(sources),
           "one_device": one_device}
    alternate(pairs, {name: (lambda f=fn: timed(f))
                      for name, fn in fns.items()},
              f"one-shot top-{K} of {len(sources)} queries")
    for name, fn in fns.items():
        profile_once(name, fn)

    ps, rs = eng.init_state(sources)
    eng.push(ps, rs, max_iters=3)
    pl = eng.placement
    bufs = pl.exchange.buffers(len(sources))
    pl.prepass(ps, rs, bufs, [sh.thr(eng.index_depth, rcfg.omega_unit)
                              for sh in pl.shards], rcfg.alpha)
    ring.ring_all_gather(bufs)
    acc = torch.zeros_like(rs[0])
    per = []
    for h, sh in enumerate(eng.shards):
        deg = np.diff(sh.in_indptr.cpu().numpy())
        ms = cuda_ms(lambda: kernels.gather_scatter_add(
            acc, bufs[h], sh.in_indptr, sh.in_src, sched=sh.in_sched))
        per.append(ms)
        print(f"  shard {h}: push gather {ms:.3f} ms over {int(deg.sum())} "
              f"edges, largest in-degree {int(deg.max())}")
    acc = torch.zeros((g.n, len(sources)), dtype=torch.float32, device=dev)
    deg = np.diff(dg_raw.in_indptr.cpu().numpy())
    one = cuda_ms(lambda: kernels.gather_scatter_add(
        acc, bufs[0], dg_raw.in_indptr, dg_raw.in_src,
        sched=dg_raw.in_sched))
    print(f"profile gather: {SHARDS} shard launches {sum(per):.3f} ms in all "
          f"against one launch {one:.3f} ms over {int(deg.sum())} edges "
          f"(largest in-degree {int(deg.max())})")


def two_sample_chisq(a, b, nbins: int) -> float:
    """p-value of the chi-square test that two samples of bin ids (equal
    sizes) come from one distribution; bins with fewer than 10 draws in
    both samples together are merged into one."""
    import numpy as np
    import torch
    from scipy import stats
    ca = torch.bincount(a, minlength=nbins).double().cpu().numpy()
    cb = torch.bincount(b, minlength=nbins).double().cpu().numpy()
    keep = ca + cb >= 10
    obs = np.stack([np.append(ca[keep], ca[~keep].sum()),
                    np.append(cb[keep], cb[~keep].sum())])
    obs = obs[:, obs.sum(axis=0) > 0]
    return float(stats.chi2_contingency(obs)[1])


def k4_vs_plain_on_level(runner, dg, sources, level):
    """K4 against the plain lockstep walk on one real level's allocation:
    push CHISQ_SOURCES one-hot residues to the level's rmax, allocate the
    measured demand (JAX's allocate_walks, no lane dropped), walk the
    flattened lanes both ways, and compare the (column, endpoint) counts
    of the valid lanes by a two-sample chi-square.  Returns (p-value,
    walks, K4 ms, plain ms, the flattened starts: K4's shape (iii))."""
    import torch
    from fora_tpu_torch.ops import push, walk
    from fora_tpu_torch.utils.timing import cuda_ms
    rc = runner.rcfg.with_delta(runner.deltas[level])
    src = torch.as_tensor(sources[:CHISQ_SOURCES], dtype=torch.int32,
                          device=dg.device)
    st = push.forward_push(dg, src, rmax=rc.rmax, alpha=rc.alpha,
                           max_iters=rc.max_push_iters)
    total = walk.walk_demand(st.r, rc.omega_unit).total
    alloc = walk.allocate_walks(st.r, rc.omega_unit, int(total.max()))
    if bool(alloc.overflow.any()):
        fail("allocate_walks dropped walks at the measured demand")
    start = alloc.start.view(-1)
    col = torch.arange(start.numel(), device=dg.device) % CHISQ_SOURCES
    valid = alloc.valid.view(-1)
    gen = torch.Generator(device=dg.device).manual_seed(SEED)
    ends_k = walk.walk_endpoints(dg, start, SEED, rc.alpha, rc.max_walk_hops)
    ends_p = walk.run_walks(dg, start, generator=gen, alpha=rc.alpha,
                            max_hops=rc.max_walk_hops)
    pv = two_sample_chisq((col * dg.n + ends_k)[valid],
                          (col * dg.n + ends_p)[valid],
                          CHISQ_SOURCES * dg.n)
    k_ms = cuda_ms(lambda: walk.walk_endpoints(dg, start, SEED, rc.alpha,
                                               rc.max_walk_hops), iters=3)
    p_ms = cuda_ms(lambda: walk.run_walks(dg, start, generator=gen,
                                          alpha=rc.alpha,
                                          max_hops=rc.max_walk_hops),
                   iters=2, warmup=0)
    return pv, int(valid.sum()), k_ms, p_ms, start


PLAIN_K6 = ("walk_demand_plain", "expand_lanes_plain",
            "expand_chunk_lanes_plain", "accumulate_endpoints_plain",
            "accumulate_chunk_endpoints_plain")
plain_k6_calls: dict = {}


def count_plain_k6() -> None:
    """Wrap K6's plain versions in fora_tpu_torch.ops.walk with call
    counters (``plain_k6_calls``), so that a path's run can show that it
    never took them on the card (the dispatchers look them up at call
    time)."""
    from fora_tpu_torch.ops import walk
    for name in PLAIN_K6:
        def counted(*a, _fn=getattr(walk, name), _name=name, **kw):
            plain_k6_calls[_name] = plain_k6_calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        setattr(walk, name, counted)


def no_plain_k6(label: str, before: dict) -> None:
    """Fails if a plain version of K6 ran since ``before`` (a copy of
    ``plain_k6_calls``)."""
    if plain_k6_calls != before:
        ran = {k: v - before.get(k, 0) for k, v in plain_k6_calls.items()
               if v != before.get(k, 0)}
        fail(f"{label}: K6's plain versions ran on the path: {ran}")


def sectors(idx) -> int:
    """Distinct 32-byte sectors among the 4-byte words at flat ``idx``."""
    import torch
    return int(torch.unique(idx // 8).numel())


def k6_demand_row(r, omega):
    """K6-demand on ``r``: cum and total torch.equal to the plain chain's;
    timed as called and in device time beside its bound (r read once, cum
    and total written once), the plain chain and torch.cumsum of the [B,
    n] int32 omega (the scan alone).  Returns (row, kernel demand, plain
    demand)."""
    import torch
    from fora_tpu_torch.ops import walk
    from fora_tpu_torch.utils.timing import cuda_ms, device_ms
    n, B = r.shape
    d = walk.walk_demand(r, omega)
    dp = walk.walk_demand_plain(r, omega)
    if not (torch.equal(d.cum, dp.cum) and torch.equal(d.total, dp.total)):
        fail("K6-demand: cum or total differs from the plain version's")
    om_t = dp.omega_v.T.contiguous()
    row = dict(max_abs_err=0.0,
               ms=cuda_ms(lambda: walk.walk_demand(r, omega)),
               device_ms=device_ms(lambda: walk.walk_demand(r, omega)),
               plain_ms=cuda_ms(lambda: walk.walk_demand_plain(r, omega),
                                iters=3),
               library_ms=cuda_ms(lambda: torch.cumsum(
                   om_t, dim=1, dtype=torch.int32)),
               **bound(2 * n * B * 4 + B * 4))
    return row, d, dp


def k6_expand_row(r, d, dp, W):
    """K6-expand of lanes 0 .. W - 1: start and weight torch.equal to the
    plain expansion's; timed as called and in device time beside its
    bound: 8 bytes a lane slot written, and the distinct 32-byte sectors
    of cum (at v and v - 1) and of r (at v) of the nodes the lanes start
    from, read once.  No library call maps lanes to nodes (null).
    Returns (row, start, weight)."""
    import torch
    from fora_tpu_torch.ops import walk
    from fora_tpu_torch.utils.timing import cuda_ms, device_ms
    n, B = r.shape
    start, weight = walk.expand_lanes(r, d, 0, W)
    ps, pw, _, _ = walk.expand_lanes_plain(r, dp, 0, W)
    if not (torch.equal(start, ps) and torch.equal(weight, pw)):
        fail(f"K6-expand: {int((start != ps).sum())} starts and "
             f"{int((weight != pw).sum())} weights differ from the plain "
             "expansion's")
    del ps, pw
    v, b = torch.nonzero(dp.omega_v > 0, as_tuple=True)
    read = sectors(torch.cat([b * n + v, b * n + (v - 1).clamp_min(0)])) + \
        sectors(v * r.stride(0) + b)
    row = dict(max_abs_err=0.0,
               ms=cuda_ms(lambda: walk.expand_lanes(r, d, 0, W)),
               device_ms=device_ms(lambda: walk.expand_lanes(r, d, 0, W)),
               plain_ms=cuda_ms(
                   lambda: walk.expand_lanes_plain(r, dp, 0, W), iters=2),
               library_ms=None,
               **bound(W * B * 8 + read * SECTOR + B * 4))
    return row, start, weight


def k6_accum_check(label, ends, weight, n, bounds=None, G=1) -> float:
    """K6-accum of ``weight`` at ``ends`` into a fresh [n, B] (with
    ``bounds``, its sharded form into G fresh partials, lanes from 0) held
    to the float64 plain sum.  Two gates: every entry's count of non-zero
    lanes, accumulated as 1.0s in f32 by the kernel, equals the plain
    count exactly (integers below 2^24: no lane lost, added or sent to
    another shard), and every entry's error is within the bound of any
    f32 sum of N positive terms in any order, |got - sum| <= gamma(N - 1)
    sum, gamma(k) = k u / (1 - k u), u = 2^-24 (the adds of the f32
    atomics come in no fixed order, and a walk's source takes tens of
    thousands of equal weights, whose roundings do not cancel).  Returns
    the max abs error."""
    import torch
    from fora_tpu_torch.ops import walk
    B = ends.shape[1]

    def run(w, dtype, plain):
        outs = [torch.zeros((n, B), dtype=dtype, device=ends.device)
                for _ in range(G)]
        if bounds is None:
            (walk.accumulate_endpoints_plain if plain
             else walk.accumulate_endpoints)(ends, w, n, outs[0])
        else:
            (walk.accumulate_chunk_endpoints_plain if plain
             else walk.accumulate_chunk_endpoints)(ends, w, outs, bounds, 0)
        return torch.stack(outs)
    got = run(weight, torch.float32, False)
    want = run(weight.double(), torch.float64, True)
    ones = (weight != 0).float()
    cnt = run(ones, torch.float32, False)
    cnt64 = run(ones.double(), torch.float64, True)
    if not torch.equal(cnt.double(), cnt64):
        fail(f"K6-accum ({label}): {int((cnt.double() != cnt64).sum())} "
             "entries count other lanes than the plain scatter-add")
    del cnt, ones
    u = 2.0 ** -24
    k = (cnt64 - 1).clamp_min(0) * u
    err = (got.double() - want).abs()
    bad = err > k / (1 - k) * want
    if bool(bad.any()):
        first = tuple(bad.nonzero()[0].tolist())
        fail(f"K6-accum ({label}): {int(bad.sum())} entries beyond the f32 "
             f"summation bound (first at {first}: {float(got[first]):.7e} "
             f"vs {float(want[first]):.7e} over {int(cnt64[first])} adds)")
    plain32 = run(weight, torch.float32, True).double()

    def rel(x):
        return float(((x - want).abs() / want.clamp_min(1e-30)).max())
    print(f"K6-accum ({label}): counts exact, every entry within the f32 "
          f"summation bound; max rel err {rel(got.double()):.2e} "
          f"(scatter_add_ in f32 on the same device: {rel(plain32):.2e}), "
          f"max adds to one entry {int(cnt64.max())}")
    return float(err.max())


def k6_accum_row(ends, weight, n, label):
    """K6-accum of ``weight`` at ``ends`` into a fresh [n, B], held to the
    float64 plain sum (k6_accum_check); timed as called and in device
    time beside its bound (8 bytes a lane read, and the distinct sectors
    of out that a non-zero lane touches, read and written) and beside
    scatter_add_ over the int64 endpoints (the call the path made
    before)."""
    import torch
    from fora_tpu_torch.ops import walk
    from fora_tpu_torch.utils.timing import cuda_ms, device_ms
    W, B = ends.shape
    err = k6_accum_check(label, ends, weight, n)
    nz = weight != 0
    touched = sectors(ends.long()[nz] * B
                      + torch.nonzero(nz, as_tuple=True)[1])
    out = torch.zeros((n, B), dtype=torch.float32, device=ends.device)
    e64 = ends.long()
    row = dict(max_abs_err=err,
               ms=cuda_ms(lambda: walk.accumulate_endpoints(ends, weight, n,
                                                            out=out)),
               device_ms=device_ms(lambda: walk.accumulate_endpoints(
                   ends, weight, n, out=out)),
               plain_ms=cuda_ms(lambda: walk.accumulate_endpoints_plain(
                   ends, weight, n, out=out), iters=3),
               library_ms=cuda_ms(lambda: out.scatter_add_(0, e64, weight)),
               **bound(W * B * 8 + 2 * touched * SECTOR))
    return row


def k6_line(name, row, label) -> None:
    lib = (f"; library {row['library_ms']:.4f} ms"
           if row["library_ms"] is not None else "")
    print(f"{name} ({label}): {row['ms']:.4f} ms as called, device "
          f"{row['device_ms']:.4f}; plain {row['plain_ms']:.4f} ms{lib}; "
          f"bound {row['bound_ms']:.4f} ms by {row['bound_by']} "
          f"({row['bound_ms'] / row['device_ms']:.0%} of it reached, "
          f"device)")


def k6_on_pool(dg, rcfg, sources):
    """K6's three kernels at the raw pool's own shapes: the pool of phase
    10 run again with a fresh runner, the residue (its live columns, a
    column slice as walk_phase takes it) of the walk phase that walked
    the most lanes kept, then its demand, every lane of it (one chunk, as
    the pool walked it) and K4's endpoints of those lanes.  Returns
    {kernel name: row}."""
    from fora_tpu_torch.algo.topk import TopkRunner
    from fora_tpu_torch.ops import walk
    runner = TopkRunner(dg, rcfg, k=K, index=None, delta_stride=DSTRIDE,
                        accept_slack=ACCEPT)
    orig, best = walk.walk_phase, {"lanes": -1}

    def capture(graph, r, omega_unit, seed, alpha, max_hops, live=None,
                clock=None):
        out = orig(graph, r, omega_unit, seed, alpha, max_hops, live=live,
                   clock=clock)
        if out[1].lanes > best["lanes"]:
            best.update(lanes=out[1].lanes, r=r.clone(), omega=omega_unit,
                        live=r.shape[1] if live is None else live)
        return out
    walk.walk_phase = capture
    try:
        run_queries(runner, sources[:RAW_QUERIES], lambda *a: None,
                    pool=RAW_QUERIES, batch=RAW_BATCH, defer=RAW_DEFER)
    finally:
        walk.walk_phase = orig
    r = best["r"][:, :best["live"]]
    rows = {}
    rows["walk_demand"], d, dp = k6_demand_row(r, best["omega"])
    W = -(-int(dp.total.max()) // walk.LANE_MULTIPLE) * walk.LANE_MULTIPLE
    label = (f"the raw pool's largest walk phase, r {tuple(r.shape)} of "
             f"{best['r'].shape[1]} columns, {W} x {r.shape[1]} lane "
             f"slots, {int(dp.total.sum())} walks")
    rows["expand_lanes"], start, weight = k6_expand_row(r, d, dp, W)
    del dp
    ends = walk.walk_endpoints(dg, start.view(-1), SEED, rcfg.alpha,
                               rcfg.max_walk_hops).view(start.shape)
    del start
    rows["accumulate_endpoints"] = k6_accum_row(ends, weight, dg.n, label)
    for name, row in rows.items():
        k6_line(name, row, label)
    return rows


def bippr_targets(n, seed, must=()):
    """BIPPR_TARGETS sorted node ids: ``must`` and a seeded sample of the
    other nodes."""
    import numpy as np
    must = np.unique(np.asarray(must, np.int64))
    rest = np.setdiff1d(np.arange(n), must)
    fill = np.random.default_rng(seed).choice(
        rest, BIPPR_TARGETS - len(must), replace=False)
    return np.sort(np.concatenate([must, fill]))


def check_backward_prepass(dg, rcfg, dev):
    """The K1-back pre-pass against its plain version on BiPPR's state at
    the bench's width: BIPPR_TARGETS seeded targets pushed back three
    supersteps at the default rmax_b (K1-back, K1 over the out-CSR), then
    the pre-pass twice and the plain one on that state, bit for bit.
    Returns its kernel row."""
    import torch
    from fora_tpu_torch import kernels
    from fora_tpu_torch.algo import bippr
    from fora_tpu_torch.utils.timing import cuda_ms
    rmax_b, _ = bippr.default_bippr_params(rcfg)
    st = bippr.backward_push(dg, bippr_targets(dg.n, SEED), rmax_b=rmax_b,
                             alpha=rcfg.alpha, max_iters=3)
    runs = []
    for _ in range(2):
        p, s = st.p.clone(), torch.full_like(st.r, float("nan"))
        kernels.backward_prepass(p, st.r, s, rmax_b, dg.out_deg, rcfg.alpha)
        runs.append((p, s))
    want_p, want_s = st.p.clone(), torch.empty_like(st.r)
    bippr.backward_prepass_plain(want_p, st.r, want_s, rmax_b, dg.out_deg,
                                 rcfg.alpha)
    for i, (p, s) in enumerate(runs):
        if not (torch.equal(p, want_p) and torch.equal(s, want_s)):
            fail(f"K1-back pre-pass: launch {i + 1} differs from plain")
    active = int((st.r > rmax_b).sum())
    del runs, want_s
    p, s = want_p, torch.empty_like(st.r)
    row = dict(
        max_abs_err=0.0,
        ms=cuda_ms(lambda: kernels.backward_prepass(
            p, st.r, s, rmax_b, dg.out_deg, rcfg.alpha)),
        plain_ms=cuda_ms(lambda: bippr.backward_prepass_plain(
            p, st.r, s, rmax_b, dg.out_deg, rcfg.alpha), iters=3),
        library_ms=None,
        # r read, p read and written, spread written, the degrees read; a
        # compare, a select, a multiply and an add per entry
        **bound(nbytes(st.r, s, dg.out_deg) + 2 * nbytes(p),
                4 * st.r.numel()))
    print(f"K1-back pre-pass at [{dg.n}, {BIPPR_TARGETS}] after "
          f"{st.iters} backward supersteps (rmax_b {rmax_b:.3g}, "
          f"{active} active entries): two launches bit-equal to plain; "
          f"{row['ms']:.4f} ms against its bound {row['bound_ms']:.4f} ms "
          f"({row['bound_ms'] / row['ms']:.0%} of it reached); plain "
          f"{row['plain_ms']:.4f} ms")
    return row


def hub_index_for(dg, rcfg):
    """The hub index that the CLI's --algo hubppr builds (NUM_HUBS hubs,
    the default pool for min(omega_unit + 1, 2^22) walks)."""
    from fora_tpu_torch.algo import hubppr
    num_walks = min(int(rcfg.omega_unit) + 1, WALK_CHECK)
    return hubppr.build_hub_index(
        dg, SEED, alpha=rcfg.alpha, num_hubs=NUM_HUBS,
        pool_size=hubppr.default_pool_size(rcfg, num_walks, NUM_HUBS))


def check_hub_walk(dg, rcfg, source, dev, hub, name, rate=None):
    """K4-hub: WALK_CHECK walks from ``source`` bit-equal to
    run_walks_philox with the hub index and against the plain hub walk on
    the same index, by the total variation over the plain walk's top-1000
    endpoints (limit 0.01).  On a weighted graph (alias tables) the hub
    walk with uniform hops (K4-hub's other branch) must read above the
    limit.  With ``rate``, shapes (i) and (ii) timed beside their bounds
    (walk_shapes); returns the row."""
    import dataclasses
    import torch
    from fora_tpu_torch.algo import hubppr
    from fora_tpu_torch.utils.timing import cuda_ms
    start = torch.full((WALK_CHECK,), int(source), dtype=torch.int32,
                       device=dev)
    hops = (rcfg.alpha, rcfg.max_walk_hops)

    def freq(ends):
        return torch.bincount(ends.long(), minlength=dg.n).double() \
            / WALK_CHECK
    gen = torch.Generator(device=dev).manual_seed(SEED)
    f_p = freq(hubppr.hub_walks_plain(dg, start, hub, generator=gen,
                                      alpha=hops[0], max_hops=hops[1]))
    f_k = freq(hubppr.hub_walks(dg, start, SEED, hub, alpha=hops[0],
                                max_hops=hops[1]))
    top = torch.argsort(f_p, descending=True)[:1000]
    tv = 0.5 * float((f_k[top] - f_p[top]).abs().sum())
    line = (f"{name}: {WALK_CHECK} walks from node {int(source)} over "
            f"{hub.num_hubs} hubs x {hub.pool_size} pool entries: total "
            f"variation {tv:.4f} against the plain hub walk over the "
            f"top-1000 endpoints (limit 0.01)")
    alias = dg.alias_prob is not None
    if alias:
        flat = dataclasses.replace(dg, alias_prob=None, alias_other=None)
        tv_u = 0.5 * float((freq(hubppr.hub_walks(
            flat, start, SEED, hub, alpha=hops[0], max_hops=hops[1]))[top]
            - f_p[top]).abs().sum())
        line += f"; K4-hub's uniform hops on the same graph read {tv_u:.4f}"
    print(line)
    if not tv < 0.01:
        fail(f"{name} endpoint distribution: total variation {tv:.4f}")
    if alias and not tv_u > 0.01:
        fail(f"{name}: the check cannot tell uniform hops from weighted "
             f"ones (the uniform branch reads {tv_u:.4f})")
    if rate is None:
        walk_shapes(dg, rcfg, {"i": start}, walk_sector_rate(dg, hub),
                    hub=hub)
        return None
    starts = {"i": start, "ii": index_build_starts(dg, rcfg, INDEX_LAUNCH)}
    res = walk_shapes(dg, rcfg, starts, rate, hub=hub)["i"]
    row = dict(
        max_abs_err=float((f_k[top] - f_p[top]).abs().max()),
        ms=res["ms"],
        plain_ms=cuda_ms(lambda: hubppr.hub_walks_plain(
            dg, start, hub, generator=gen, alpha=hops[0], max_hops=hops[1]),
            iters=3),
        library_ms=None, bound_ms=res["bound_ms"], bound_by=res["bound_by"])
    print(f"{name}: plain {row['plain_ms']:.4f} ms")
    return row


def run_raw(dg, rcfg, sources, exact_ids, name="raw", hub=None, k6=False):
    """Phase 10 (and 13's weighted pool, ``name`` its label in the
    output): the raw-walk runner over the first RAW_QUERIES sources (no
    plain version of K6 may run), then K4's shape (iii), the allocation of
    the deepest level it reached, for the graph's branch (bit-equal to
    run_walks_philox) and, with ``hub``, K4-hub (timed only); with ``k6``,
    K6's three kernels at the pool's shapes (k6_on_pool).  Returns its
    launch counts (reset just before the run, read just after) and K6's
    rows (or None)."""
    import numpy as np
    from fora_tpu_torch import kernels
    from fora_tpu_torch.algo.topk import TopkRunner
    from fora_tpu_torch.eval import metrics
    runner = TopkRunner(dg, rcfg, k=K, index=None, delta_stride=DSTRIDE,
                        accept_slack=ACCEPT)
    src = sources[:RAW_QUERIES]
    plain0 = dict(plain_k6_calls)
    kernels.reset_launch_counts()
    results, n_acc, levels, wall, stats = run_queries(
        runner, src, pool=RAW_QUERIES, batch=RAW_BATCH, defer=RAW_DEFER)
    counts = kernels.launch_counts()
    no_plain_k6(name, plain0)
    if len(results) != len(src):
        fail(f"{name}: {len(results)} of {len(src)} queries answered")
    over = sum(st["overflow"] for st in stats)
    walks = sum(st["walks_total"] for st in stats)
    lanes = sum(st["lanes"] for st in stats)
    print(f"{name}: {len(src)} queries in {wall:.3f} s -> "
          f"{len(src) / wall:.2f} "
          f"q/s; levels used {levels}; accepted {n_acc}/{len(src)}; "
          f"overflowing columns {over}; walks {walks}, lanes {lanes}")
    if over:
        fail(f"{name}: {over} columns overflowed their lanes")
    ms = {}
    for st in stats:
        for k, v in st["ms"].items():
            ms[k] = ms.get(k, 0.0) + v
    print(f"{name}: ms by stage over all levels: "
          + " ".join(f"{k} {v:.2f}" for k, v in ms.items()))
    level = max(st["level"] for st in stats)
    pv, walks, k_ms, p_ms, start = k4_vs_plain_on_level(runner, dg, src,
                                                        level)
    print(f"{name}: K4 vs plain run_walks on level {level}'s allocation of "
          f"{CHISQ_SOURCES} queries ({walks} walks): chi-square p-value "
          f"{pv:.4f} (limit {CHISQ_MIN_P}; conservative, both samples "
          f"walk from the same starts); {k_ms:.3f} ms vs plain "
          f"{p_ms:.3f} ms")
    if not pv > CHISQ_MIN_P:
        fail(f"{name}: K4 endpoints differ from plain (p = {pv:.2e})")
    walk_shapes(dg, runner.rcfg, {"iii": start}, walk_sector_rate(dg),
                exact=("iii",))
    if hub is not None:     # bit-equal at shapes (i) and (ii) in phase 3
        walk_shapes(dg, runner.rcfg, {"iii": start},
                    walk_sector_rate(dg, hub), hub=hub, exact=())
    del start
    k6_rows = k6_on_pool(dg, rcfg, src) if k6 else None
    pred = np.stack([results[int(s)] for s in src[:len(exact_ids)]])
    prec = metrics.batch_precision_at_k(pred, exact_ids)
    print(f"{name} precision@{K}: {prec:.4f} over {len(exact_ids)} queries "
          f"(limit {MIN_PRECISION})")
    if not prec >= MIN_PRECISION:
        fail(f"{name} precision@{K} {prec:.4f} < {MIN_PRECISION}")
    return counts, k6_rows


def run_montecarlo(dg, rcfg, sources, exact_ids, name="montecarlo"):
    """Phase 11 (and 13's weighted run, ``name`` its label): Monte Carlo
    top-k of the first MC_QUERIES sources.  Returns its launch counts."""
    import numpy as np
    import torch
    from fora_tpu_torch import kernels
    from fora_tpu_torch.algo.montecarlo import (make_montecarlo_fn,
                                                montecarlo_chunks)
    from fora_tpu_torch.eval import metrics
    from fora_tpu_torch.ops.topk import topk_nodes
    from fora_tpu_torch.ops.walk import lane_budget
    fn = make_montecarlo_fn(dg, rcfg)
    src = np.asarray(sources[:MC_QUERIES])
    chunks = len(montecarlo_chunks(fn.num_walks, len(src),
                                   lane_budget(dg.device)))
    plain0 = dict(plain_k6_calls)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = topk_nodes(fn(src, SEED), K)[1].cpu().numpy()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    no_plain_k6(name, plain0)
    prec = metrics.batch_precision_at_k(ids[:len(exact_ids)], exact_ids)
    print(f"{name}: {len(src)} queries x {fn.num_walks} walks in "
          f"{chunks} chunks: {wall:.3f} s -> {len(src) / wall:.2f} q/s; "
          f"precision@{K} {prec:.4f} (limit {MIN_PRECISION})")
    if not prec >= MIN_PRECISION:
        fail(f"{name} precision@{K} {prec:.4f} < {MIN_PRECISION}")
    if counts["accumulate_endpoints"] != chunks:
        fail(f"{name}: {counts['accumulate_endpoints']} launches of "
             f"K6-accum for {chunks} chunks, expected one each")
    return counts


def run_p3(dev):
    """Phase 12: the gather probe's first case.  Returns (kernel row,
    launch counts)."""
    from fora_tpu_torch import kernels
    from fora_tpu_torch.probes import gather_probe
    from fora_tpu_torch.utils.timing import cuda_ms
    kernels.reset_launch_counts()
    res = gather_probe.p3_case(gather_probe.WIDTHS[0], dev, cuda_ms)
    counts = kernels.launch_counts()
    print(f"P3: max abs err {res['err_plain']:.3e} vs plain, "
          f"{res['err_k1']:.3e} vs K1 on the edges sorted by destination "
          f"(rtol {gather_probe.RTOL}, atol {gather_probe.ATOL})")
    for line in res["lines"]:
        print(line)
    # the tile, the edge list and the accumulator (read and written) once,
    # an add per edge and column; the plain version is one index_add_ (over
    # the gathered rows), the library call itself
    B, E = res["B"], res["edges"]
    moved = 4 * (gather_probe.H * B + 2 * E + 2 * gather_probe.N_DST * B)
    old = bound(moved, E * B)
    # the bound of its function: every edge reads a whole row of the tile
    # and reduces it into acc, E x B x 4 bytes each, at the rate the card
    # reads whole rows from its L2 (the tile and acc stay there)
    rate = l2_row_rate(dev)
    fn_ms = 2 * E * B * 4 / rate * 1e3
    print(f"P3 probe: {res['ms']:.4f} ms; bound of its function (E x B x 4 "
          f"bytes of row reads and as many of reductions at the L2 rate "
          f"above) {fn_ms:.4f} ms, {fn_ms / res['ms']:.0%} of the time; "
          f"the tile, acc and indices once at the memory rate "
          f"{old['bound_ms']:.4f} ms")
    return dict(max_abs_err=res["err_plain"], ms=res["ms"],
                plain_ms=res["plain_ms"], library_ms=res["plain_ms"],
                fn_bound_ms=fn_ms, **old), counts


def weighted_graph(g):
    """bench.py's weighted row (FORA_BENCH_WEIGHTED=1): ``g``'s edges with
    log-uniform weights exp2(U(-2, 2)) drawn from default_rng(SEED + 31),
    packed by the port's from_edges."""
    import numpy as np
    from fora_tpu_torch.graph import from_edges
    rng = np.random.default_rng(SEED + 31)
    src = np.repeat(np.arange(g.n, dtype=np.int64),
                    np.asarray(g.out_deg, np.int64))
    w = np.exp2(rng.uniform(-2, 2, g.m)).astype(np.float32)
    return from_edges(src, np.asarray(g.out_indices, np.int64), g.n, w=w)


def run_weighted(g, rcfg, dev):
    """Phase 13: bench.py's weighted graph end to end, with phase 15's
    weighted sharded pool and phase 9's raw one-shot.  Returns (kernel row
    of K4's alias branch, launch counts of the indexed run, of the
    raw-walk pool, of Monte Carlo and of the sharded pool, the raw
    one-shot's launch counts and supersteps per exchange, the kernel row of
    K4's sharded alias form)."""
    import dataclasses
    import logging
    import numpy as np
    import torch
    from fora_tpu_torch import kernels
    from fora_tpu_torch.algo import exact
    from fora_tpu_torch.algo.topk import TopkRunner
    from fora_tpu_torch.eval import metrics
    from fora_tpu_torch.eval import queries as qio
    from fora_tpu_torch.graph import to_device
    from fora_tpu_torch.ops import push, walk
    from fora_tpu_torch.utils.timing import cuda_ms

    t0 = time.perf_counter()
    gw = weighted_graph(g)
    print(f"weighted: from_edges(w=...) {time.perf_counter() - t0:.1f} s")
    # to_device logs the seconds of the alias build it makes
    log = logging.getLogger("fora_tpu_torch.graph.csr")
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter("weighted: %(message)s"))
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    t0 = time.perf_counter()
    dgw = to_device(gw, merge_duplicate_edges=True, hub_rows=HUB_ROWS,
                    device=dev)
    torch.cuda.synchronize()
    log.removeHandler(handler)
    print(f"weighted: to_device (merge, hub split, alias tables) "
          f"{time.perf_counter() - t0:.1f} s; {dgw.m_in} merged in-edges")
    rate = walk_sector_rate(dgw)
    sources = qio.generate_sources(gw, QUERIES, seed=SEED + 1)
    src128 = torch.as_tensor(sources[:BATCH], dtype=torch.int32, device=dev)

    # K1: one weighted superstep on a spread-out frontier, twice from one
    # state (bit-equal), against the plain version in float64
    thr = push.node_threshold(dgw, rcfg.rmax)
    st = push.init_state(g.n, src128)
    for _ in range(4):
        st = push.superstep(dgw, st, alpha=rcfg.alpha, thr=thr)
    runs = [kernel_superstep(dgw, st.p.clone(), st.r.clone(), thr,
                             rcfg.alpha) for _ in range(2)]
    if not (torch.equal(runs[0][0], runs[1][0])
            and torch.equal(runs[0][1], runs[1][1])
            and runs[0][2] == runs[1][2]):
        fail("K1 weighted: two launches from one state differ")
    pp, pr, pf = plain_superstep(dgw, st.p.double(), st.r.double(), thr,
                                 rcfg.alpha)
    if runs[0][2] != pf:
        fail(f"K1 weighted: flag {runs[0][2]} != plain {pf}")
    k1_err = max(close("K1 weighted p", runs[0][0], pp.float(), 1e-5, 1e-7),
                 close("K1 weighted r", runs[0][1], pr.float(), 1e-5, 1e-7))
    print(f"K1 weighted superstep: two launches bit-equal; max abs err "
          f"{k1_err:.3e} against the float64 plain version")
    del st, runs, pp, pr

    # K4's alias branch: 2^22 walks from one source against the plain
    # alias walk, timed beside its bound
    start = torch.full((WALK_CHECK,), int(sources[0]), dtype=torch.int32,
                       device=dev)
    ends_k = walk.walk_endpoints(dgw, start, SEED, rcfg.alpha,
                                 rcfg.max_walk_hops)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ends_p = walk.run_walks(dgw, start, generator=gen, alpha=rcfg.alpha,
                            max_hops=rcfg.max_walk_hops)
    f_k = torch.bincount(ends_k.long(), minlength=g.n).double() / WALK_CHECK
    f_p = torch.bincount(ends_p.long(), minlength=g.n).double() / WALK_CHECK
    top = torch.argsort(f_p, descending=True)[:1000]
    tv = 0.5 * float((f_k[top] - f_p[top]).abs().sum())
    # what a kernel that ignored the weights would read: K4's uniform
    # branch on the same out-CSR
    ends_u = walk.walk_endpoints(
        dataclasses.replace(dgw, alias_prob=None, alias_other=None), start,
        SEED, rcfg.alpha, rcfg.max_walk_hops)
    f_u = torch.bincount(ends_u.long(), minlength=g.n).double() / WALK_CHECK
    tv_u = 0.5 * float((f_u[top] - f_p[top]).abs().sum())
    print(f"K4-alias: {WALK_CHECK} walks from node {int(sources[0])}: total "
          f"variation {tv:.4f} over the top-1000 endpoints (limit 0.01); "
          f"K4's uniform branch on the same graph reads {tv_u:.4f}")
    if not tv < 0.01:
        fail(f"K4-alias endpoint distribution: total variation {tv:.4f}")
    if not tv_u > 0.01:
        fail(f"K4-alias check cannot tell uniform hops from weighted ones: "
             f"the uniform branch reads {tv_u:.4f}")
    del ends_k, ends_p, ends_u
    # shapes (i) and (ii) bit-equal to run_walks_philox, timed beside
    # their bounds
    starts = {"i": start, "ii": index_build_starts(dgw, rcfg, INDEX_LAUNCH)}
    res = walk_shapes(dgw, rcfg, starts, rate)["i"]
    # K4's sharded form with alias hops at shape (i)
    from fora_tpu_torch.index.build_sharded import shard_out_csr
    sharded_walk_equal(shard_out_csr(gw, [dev] * SHARDS), dgw, rcfg, start,
                       "i")
    row = dict(
        max_abs_err=float((f_k[top] - f_p[top]).abs().max()),
        ms=res["ms"],
        plain_ms=cuda_ms(lambda: walk.run_walks(
            dgw, start, generator=gen, alpha=rcfg.alpha,
            max_hops=rcfg.max_walk_hops), iters=3),
        library_ms=None, bound_ms=res["bound_ms"], bound_by=res["bound_by"])
    print(f"K4-alias: plain {row['plain_ms']:.4f} ms")
    del start, starts, f_k, f_p, f_u
    # K4-hub's alias branch against the plain alias hub walk
    hub = hub_index_for(dgw, rcfg)
    check_hub_walk(dgw, rcfg, sources[0], dev, hub, "K4-hub alias")
    del hub

    # the main path: counts reset just before, read just after
    kernels.reset_launch_counts()
    index = build_index(gw, dgw, rcfg, W_INDEX_DIR)
    runner = TopkRunner(dgw, rcfg, k=K, index=index, delta_stride=DSTRIDE,
                        accept_slack=ACCEPT)
    results, n_acc, levels, wall, _ = run_queries(runner, sources)
    counts = kernels.launch_counts()
    if len(results) != QUERIES:
        fail(f"weighted: {len(results)} of {QUERIES} queries answered")
    print(f"weighted queries: {QUERIES} in {wall:.3f} s -> "
          f"{QUERIES / wall:.2f} q/s; levels used {levels}; accepted "
          f"{n_acc}/{QUERIES}")
    del runner

    # the weighted oracle: float64 power iteration with w/W transitions
    ev = sources[:EVAL_N]
    ex = exact.topk_ids(exact.exact_ppr_batch(gw, ev, device=dev), K)
    prec = metrics.batch_precision_at_k(
        np.stack([results[int(s)] for s in ev]), ex)
    print(f"weighted precision@{K}: {prec:.4f} over {EVAL_N} queries "
          f"against the weighted oracle (limit {MIN_PRECISION})")
    if not prec >= MIN_PRECISION:
        fail(f"weighted precision@{K} {prec:.4f} < {MIN_PRECISION}")
    # phase 15's weighted run: the same graph and index on shards
    sharded_counts = run_weighted_sharded(gw, rcfg, index, sources, ex)
    del index
    # phase 9's raw one-shot on the weighted graph (K4's sharded alias form)
    raw1_counts, raw1_steps, raw1_row = run_sharded_raw(
        gw, rcfg, sources[:POOL], ex, dgw, "weighted sharded raw")
    raw_counts, _ = run_raw(dgw, rcfg, sources, ex, name="weighted raw")
    mc_counts = run_montecarlo(dgw, rcfg, sources, ex,
                               name="weighted montecarlo")
    return (row, counts, raw_counts, mc_counts, sharded_counts, raw1_counts,
            raw1_steps, raw1_row)


def cli_argv(action, *extra) -> list:
    """fora_tpu_torch.cli's argv for ``action`` on phase 14's dataset, with
    the indexed layout's flags and the bench's configuration."""
    return [action, "--prefix", str(CLI_DIR), "--dataset", CLI_DATASET,
            "--device", DEVICE, "--epsilon", str(EPS), "--k", str(K),
            "--delta-stride", str(DSTRIDE), "--hub-rows", str(HUB_ROWS),
            "--seed", str(SEED), *extra]


def read_output(path) -> dict:
    """{source: top-k ids} of a CLI --output file."""
    import numpy as np
    rows = [json.loads(line) for line in Path(path).read_text().splitlines()]
    return {r["source"]: np.asarray(r["ids"]) for r in rows}


def output_precision(name, path, sources, exact_ids, gate=True) -> float:
    """precision@K of a CLI --output's answers for ``sources`` against
    ``exact_ids``; fails below MIN_PRECISION where ``gate``."""
    import numpy as np
    from fora_tpu_torch.eval import metrics
    got = read_output(path)
    missing = [int(s) for s in sources if int(s) not in got]
    if missing or any(len(got[int(s)]) != K for s in sources):
        fail(f"cli {name}: answers missing or short for {missing[:5]}")
    prec = metrics.batch_precision_at_k(
        np.stack([got[int(s)] for s in sources]), exact_ids)
    print(f"cli {name} precision@{K}: {prec:.4f} over {len(sources)} "
          f"queries" + (f" (limit {MIN_PRECISION})" if gate else ""))
    if gate and not prec >= MIN_PRECISION:
        fail(f"cli {name} precision@{K} {prec:.4f} < {MIN_PRECISION}")
    return prec


def run_cli_action(name, argv, counts) -> float:
    """One fora_tpu_torch.cli.main call in this process, its launch counts
    (reset just before, read just after) into ``counts[name]``; fails on a
    non-zero exit.  Returns its seconds."""
    import torch
    from fora_tpu_torch import cli, kernels
    plain0 = dict(plain_k6_calls)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts[name] = kernels.launch_counts()
    no_plain_k6(f"cli {name}", plain0)
    if rc != 0:
        fail(f"cli {name}: exit code {rc}")
    print(f"cli {name}: {secs:.2f} s")
    return secs


def run_cli(g, rcfg, sources, exact_ids, dev):
    """Phase 14: the port's CLI on bench.py's graph, as users run it.
    Returns the launch counts of each action and of the server."""
    import shutil
    import numpy as np
    import torch
    from fora_tpu_torch.algo import bippr, exact, hubppr
    from fora_tpu_torch.eval import metrics
    from fora_tpu_torch.eval import queries as qio
    from fora_tpu_torch.graph import io as gio
    from fora_tpu_torch.graph import to_device
    from fora_tpu_torch.ops.topk import topk_nodes

    ddir = CLI_DIR / CLI_DATASET
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    gio.save_dataset(g, str(CLI_DIR), CLI_DATASET)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    parsed = gio.load_dataset(str(CLI_DIR), CLI_DATASET, device=dev)
    load_s = time.perf_counter() - t0
    # graph.txt lists the edges in out-CSR order, not in phase 1's order of
    # generation, so each in-edge row holds its sources in another order
    def in_rows(x):
        order = np.lexsort((x.in_src, x.in_dst))
        return x.in_src[order], x.in_dst[order]
    for f in g._fields:
        a, b = getattr(parsed, f), getattr(g, f)
        if f == "in_src":
            a, b = np.stack(in_rows(parsed)), np.stack(in_rows(g))
        if (a is None) != (b is None) or (
                a is not None and not np.array_equal(a, b)):
            fail(f"cli: the parsed CSR's {f} differs from phase 1's")
    print(f"cli: save_dataset {save_s:.2f} s "
          f"({(ddir / 'graph.txt').stat().st_size / 1e6:.1f} MB of "
          f"graph.txt); load_dataset through the library parser (with "
          f"from_edges and csr_cache.npz) {load_s:.2f} s; the CSR "
          f"array-equal to phase 1's (each in-edge row's sources as a "
          f"sorted list)")
    del parsed
    qfile = str(ddir / f"{CLI_DATASET}.query")
    qio.save_queries(sources, qfile)
    counts = {}
    run_cli_action("gen-exact-topk", cli_argv("gen-exact-topk"), counts)
    ev = sources[:len(exact_ids)]
    files = np.stack([np.load(ddir / "exact" / f"{int(s)}.npz")["ids"][:K]
                      for s in ev])
    same = np.mean([len(set(a) & set(b)) / K
                    for a, b in zip(files, exact_ids)])
    print(f"cli gen-exact-topk: {len(sources)} files; their top-{K} of the "
          f"first {len(ev)} against phase 7's oracle: overlap {same:.4f}")
    if not same >= 0.99:
        fail(f"cli gen-exact-topk disagrees with phase 7's oracle ({same})")
    run_cli_action("shard-graph", cli_argv(
        "shard-graph", "--graph-shards", str(SHARDS)), counts)
    run_cli_action("build", cli_argv("build", "--index-shards", str(SHARDS)),
                   counts)
    for d in (ddir / f"graph-shards-G{SHARDS}",
              CLI_DIR / "index" / CLI_DATASET / f"shards-G{SHARDS}"):
        if not (d / "meta.json").exists():
            fail(f"cli: no store at {d}")
    out = CLI_DIR / "batch_topk.jsonl"
    run_cli_action("batch-topk", cli_argv(
        "batch-topk", "--with-idx", "--pool", str(POOL), "--defer",
        str(DEFER), "--batch", str(BATCH), "--eval-exact", "--output",
        str(out)), counts)
    if len(read_output(out)) != len(sources):
        fail("cli batch-topk: not every query answered")
    output_precision("batch-topk", out, ev, exact_ids)
    # the sharded pool through the CLI, reading both stores
    log_path = CLI_DIR / "batch_topk_sharded.log"
    out = CLI_DIR / "batch_topk_sharded.jsonl"
    import contextlib
    import io
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        run_cli_action("batch-topk sharded", cli_argv(
            "batch-topk", "--with-idx", "--pool", str(POOL), "--defer",
            str(DEFER), "--batch", str(BATCH), "--graph-shards", str(SHARDS),
            "--exchange", "routed", "--output", str(out)), counts)
    log_path.write_text(err.getvalue())
    for what in ("sharded graph store", "sharded index store"):
        if what not in err.getvalue():
            fail(f"cli batch-topk sharded: did not read the {what}")
    if len(read_output(out)) != len(sources):
        fail("cli batch-topk sharded: not every query answered")
    output_precision("batch-topk sharded", out, ev, exact_ids)

    # push-only, and HubPPR at the CLI's defaults (gated)
    qio.save_queries(ev, qfile)
    for name, gate in (("fwdpush", False), ("hubppr", True)):
        out = CLI_DIR / f"{name}.jsonl"
        run_cli_action(name, cli_argv("query", "--algo", name, "--batch",
                                      str(len(ev)), "--output", str(out)),
                       counts)
        output_precision(name, out, ev, exact_ids, gate)
    # beside it the JAX package's pool cap, printed: walks that reach a hub
    # share its pool's entries (ROADMAP C15)
    dg = to_device(g, hub_rows=HUB_ROWS, device=dev)
    fn = hubppr.make_hubppr_fn(dg, rcfg, SEED, num_hubs=NUM_HUBS,
                               pool_size=JAX_POOL)
    ids = topk_nodes(fn(ev, SEED), K)[1].cpu().numpy()
    print(f"hubppr with the JAX package's pool cap, {NUM_HUBS} hubs x "
          f"{JAX_POOL} entries, {fn.num_walks} walks a query: precision@{K} "
          f"{metrics.batch_precision_at_k(ids, exact_ids):.4f} (not gated)")
    del fn

    # BiPPR against a target set holding the first sources' exact top-K
    bsrc = ev[:BIPPR_SOURCES]
    targets = bippr_targets(g.n, SEED, exact_ids[:BIPPR_SOURCES].ravel())
    tfile = CLI_DIR / "targets.txt"
    tfile.write_text("".join(f"{int(t)}\n" for t in targets))
    qio.save_queries(bsrc, qfile)
    out = CLI_DIR / "bippr.jsonl"
    run_cli_action("bippr", cli_argv(
        "query", "--algo", "bippr", "--batch", str(len(bsrc)),
        "--target-file", str(tfile), "--output", str(out)), counts)
    output_precision("bippr", out, bsrc, exact_ids[:BIPPR_SOURCES], False)
    qio.save_queries(sources, qfile)

    # make_bippr_fn itself: the relative error of every pair above delta
    fn = bippr.make_bippr_fn(dg, rcfg, targets)
    first = timed(lambda: fn(bsrc, SEED))
    again = timed(lambda: fn(bsrc, SEED + 1))
    est = fn(bsrc, SEED).double()
    pi = exact.exact_ppr_batch(g, bsrc, device=dev)[
        torch.as_tensor(targets, device=dev)].T
    above = pi > rcfg.delta
    rel = ((est - pi).abs() / pi)[above]
    share = float((rel > EPS).double().mean())
    push_ms = (first - again) * 1e3
    print(f"bippr: {len(bsrc)} sources x {len(targets)} targets, rmax_b "
          f"{fn.rmax_b:.3g}, {fn.num_walks} walks per source; backward push "
          f"{fn.state.iters} supersteps in {push_ms:.1f} ms "
          f"({push_ms / max(fn.state.iters, 1):.2f} ms each: the first "
          f"call's wall less the second's); walk term {again * 1e3:.1f} ms;"
          f" {int(above.sum())} pairs with pi > delta = {rcfg.delta:.3g}: "
          f"max relative error {float(rel.max()):.4f}, share above eps = "
          f"{EPS} {share:.4f} (limit 0.01)")
    if not share < 0.01:
        fail(f"bippr: {share:.4f} of the pairs above delta miss eps")
    del fn, dg, est, pi
    torch.cuda.empty_cache()
    counts["serve"], served = run_server(sources, exact_ids)
    counts["serve sharded"], served_g = run_server(
        sources, exact_ids, ("--graph-shards", "2"), "serve sharded")
    same = np.mean([len(set(served[s]) & set(served_g[s])) / K
                    for s in served])
    print(f"serve sharded: the same {len(served)} requests; top-{K} "
          f"overlap with the one-device server's answers {same:.4f}")
    return counts


SERVE_LAUNCHER = '''"""Runs fora_tpu_torch's CLI with the given arguments
(chip_smoke.py phase 14 runs its serve action); on SIGTERM prints the
kernel launch counts and the loaded modules of JAX or fora_tpu, then
exits."""
import json
import os
import signal
import sys

sys.path.insert(0, sys.argv[1])
from fora_tpu_torch import cli, kernels  # noqa: E402


def report(signum, frame):
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "fora_tpu"))
    print("LAUNCHES " + json.dumps(kernels.launch_counts()), flush=True)
    print("FOREIGN " + json.dumps(loaded), flush=True)
    os._exit(0)


signal.signal(signal.SIGTERM, report)
sys.exit(cli.main(sys.argv[2:]))
'''


def run_server(sources, exact_ids, extra=(), name="serve"):
    """The CLI's serve action in a subprocess (SERVE_LAUNCHER, on a port the
    system picks): one client's SERVE_SEQ sequential requests after one
    warm-up, then SERVE_CLIENTS concurrent clients of SERVE_PER_CLIENT
    each.  Every reply must carry K nodes, the server count no error, and
    the first answers reach MIN_PRECISION.  ``extra`` adds CLI flags (the
    sharded server).  Returns the server's launch counts, printed by the
    launcher at SIGTERM, and {source: answered ids}."""
    import socket
    import threading
    import numpy as np
    from fora_tpu_torch.eval import metrics
    launcher = ROOT / "bench_data" / "torch_smoke_serve.py"
    launcher.write_text(SERVE_LAUNCHER)
    log = CLI_DIR / f"{name.replace(' ', '_')}.log"
    argv = cli_argv("serve", "--with-idx", "--port", "0", "--batch",
                    str(SERVE_BATCH), *extra)
    t0 = time.perf_counter()
    with open(log, "w") as err:
        proc = subprocess.Popen([sys.executable, str(launcher), str(ROOT)]
                                + argv, stdout=subprocess.PIPE, stderr=err,
                                text=True, cwd=str(ROOT))
    lines, up = [], threading.Event()

    def read():
        for line in proc.stdout:
            lines.append(line)
            if "serving on" in line:
                up.set()
        up.set()
    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        up.wait(SERVE_START_S)
        ready = [x for x in lines if "serving on" in x]
        if not ready:
            fail(f"{name}: no 'serving on' line in {SERVE_START_S} s (exit "
                 f"{proc.poll()}); {log.name}: "
                 f"{log.read_text()[-2000:]}")
        port = int(ready[0].rsplit(":", 1)[1])
        print(f"{name}: up in {time.perf_counter() - t0:.1f} s on port "
              f"{port} (--batch {SERVE_BATCH}, inflight 1)")

        def connect():
            sock = socket.create_connection(("127.0.0.1", port), 30)
            sock.settimeout(120)
            return sock, sock.makefile("rw")

        def ask(f, req):
            f.write(json.dumps(req) + "\n")
            f.flush()
            return json.loads(f.readline())
        sock, f = connect()
        replies = {}
        ask(f, {"id": "warm", "source": int(sources[0])})
        lat = []
        for i, s in enumerate(sources[:SERVE_SEQ]):
            t = time.perf_counter()
            replies[int(s)] = ask(f, {"id": i, "source": int(s)})
            lat.append(time.perf_counter() - t)
        seq = ask(f, {"cmd": "stats"})
        q = np.percentile(np.array(lat) * 1e3, [50, 95, 99])
        print(f"{name}: {SERVE_SEQ} sequential requests after one warm-up: "
              f"server latency p50 {seq['latency_ms_p50']} ms, p95 "
              f"{seq['latency_ms_p95']} ms, p99 {seq['latency_ms_p99']} ms "
              f"(its window holds the warm-up too); at the client p50 "
              f"{q[0]:.2f} ms, p95 {q[1]:.2f} ms, p99 {q[2]:.2f} ms")
        sock.close()

        got, errs = [], []

        def client(c):
            try:
                sk, fc = connect()
                part = sources[c * SERVE_PER_CLIENT:
                               (c + 1) * SERVE_PER_CLIENT]
                for i, s in enumerate(part):
                    got.append((int(s), ask(fc, {"id": i,
                                                 "source": int(s)})))
                sk.close()
            except Exception as e:   # reported below, and the phase fails
                errs.append(repr(e))
        t = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(SERVE_CLIENTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(300)
        wall = time.perf_counter() - t
        sock, f = connect()
        end = ask(f, {"cmd": "stats"})
        sock.close()
        n = SERVE_CLIENTS * SERVE_PER_CLIENT
        batches = end["batches"] - seq["batches"]
        per_batch = (end["queries"] - seq["queries"]) / max(batches, 1)
        print(f"{name}: {SERVE_CLIENTS} concurrent clients x "
              f"{SERVE_PER_CLIENT} requests: {len(got)} answered in "
              f"{wall:.3f} s -> {len(got) / wall:.2f} q/s; {batches} "
              f"batches ({per_batch:.2f} queries each); shed {end['shed']}; "
              f"errors {end['errors']}; latency p50 "
              f"{end['latency_ms_p50']} ms, p95 "
              f"{end['latency_ms_p95']} ms, p99 {end['latency_ms_p99']} ms "
              f"over every request served")
        if errs or len(got) != n:
            fail(f"{name}: {len(got)} of {n} concurrent answers; {errs[:3]}")
        every = list(replies.values()) + [r for _, r in got]
        if any(len(r.get("nodes", ())) != K for r in every):
            fail("serve: a reply without K nodes")
        if end["errors"] or end["shed"]:
            fail(f"{name}: {end['errors']} errors, {end['shed']} shed")
        ev = sources[:len(exact_ids)]
        served = {**dict(got), **replies}
        prec = metrics.batch_precision_at_k(
            np.stack([served[int(s)]["nodes"] for s in ev]), exact_ids)
        print(f"{name} precision@{K}: {prec:.4f} over {len(ev)} served "
              f"queries (limit {MIN_PRECISION})")
        if not prec >= MIN_PRECISION:
            fail(f"{name} precision@{K} {prec:.4f} < {MIN_PRECISION}")
    finally:
        if proc.poll() is None:
            proc.terminate()
        try:
            proc.wait(60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        reader.join(10)
    report = {x.split(" ", 1)[0]: json.loads(x.split(" ", 1)[1])
              for x in lines if x.startswith(("LAUNCHES ", "FOREIGN "))}
    if "LAUNCHES" not in report:
        fail(f"{name}: the server died before SIGTERM (exit "
             f"{proc.returncode}); {log.name}: {log.read_text()[-2000:]}")
    if report["FOREIGN"]:
        fail(f"the server imported JAX or fora_tpu: {report['FOREIGN'][:5]}")
    return report["LAUNCHES"], {s: r["nodes"] for s, r in served.items()}


def sorted_topk(vals, ids):
    """Each row ordered by value descending, then id ascending."""
    import numpy as np
    order = np.stack([np.lexsort((i, -v.astype(np.float64)))
                      for v, i in zip(vals, ids)])
    return (np.take_along_axis(vals, order, 1),
            np.take_along_axis(ids, order, 1))


def topk_agree(name, got_v, got_i, want_v, want_i, rtol):
    """Values within ``rtol``; ids equal wherever the reference's adjacent
    values differ by more than ``rtol`` (outside exact ties, which the two
    summation orders may put either way).  Returns the max abs error."""
    import numpy as np
    gv, gi = sorted_topk(got_v, got_i)
    wv, wi = sorted_topk(want_v, want_i)
    err = np.abs(gv.astype(np.float64) - wv)
    if not (err <= rtol * np.abs(wv)).all():
        fail(f"{name}: values differ beyond rtol {rtol} "
             f"(max abs err {err.max():.3e})")
    apart = np.abs(np.diff(wv.astype(np.float64), axis=1)) \
        > rtol * np.abs(wv[:, 1:])
    sep = np.ones(wv.shape, bool)
    sep[:, :-1] &= apart
    sep[:, 1:] &= apart
    bad = int((gi[sep] != wi[sep]).sum())
    if bad:
        fail(f"{name}: {bad} ids differ outside near-ties")
    print(f"{name}: values within rtol {rtol} (max abs err {err.max():.3e});"
          f" ids equal at {int(sep.sum())} of {sep.size} positions outside "
          f"near-ties")
    return float(err.max())


def run_sharded(g, rcfg, index, sources, dev, exact_ids):
    """Phase 9: the sharded engine over SHARDS shards from make_mesh.
    Returns (kernel rows for P1 and P2, launch counts of the timed run,
    its supersteps)."""
    import numpy as np
    import torch
    from fora_tpu_torch import kernels
    from fora_tpu_torch.algo.fora import StagedForaPrograms
    from fora_tpu_torch.eval import metrics
    from fora_tpu_torch.graph import to_device
    from fora_tpu_torch.ops import push, ring
    from fora_tpu_torch.ops.topk import topk_sum
    from fora_tpu_torch.parallel import ShardedForaEngine, make_mesh
    from fora_tpu_torch.utils.timing import cuda_ms

    mesh = make_mesh(SHARDS)
    t0 = time.perf_counter()
    eng = ShardedForaEngine(g, mesh, rcfg, k=K, index=index)
    torch.cuda.synchronize()
    part_secs = time.perf_counter() - t0
    pg = eng.pg
    print(f"sharded: devices {[str(d) for d in mesh]}; n_loc {pg.n_loc}, "
          f"m_loc {pg.m_loc}, e_loc_total {eng.e_loc_total}; partition and "
          f"placement {part_secs:.2f} s; index depth {eng.index_depth}")
    B = len(sources)
    eng.topk(sources)                                   # warm
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.topk(sources)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    print(f"sharded topk: {B} queries in {wall:.4f} s -> {B / wall:.2f} q/s;"
          f" {res.push_iters} supersteps; dense exchange "
          f"{eng.exchange_bytes(B)} bytes per shard per superstep "
          f"(exchange_bytes_model)")
    if not (np.isfinite(res.values).all() and res.values.shape == (B, K)):
        fail("sharded topk: values not finite or of the wrong shape")

    # P1 on a real superstep's buffers: three supersteps in, then one more
    # pre-pass writes each shard's own block (NaN elsewhere; the exchange
    # is dense, which zeroes nothing, so the NaN breaks no invariant)
    ps, rs = eng.init_state(sources)
    eng.push(ps, rs, max_iters=3)
    pl = eng.placement
    thr = [sh.thr(eng.index_depth, rcfg.omega_unit) for sh in pl.shards]
    bufs = [b.fill_(float("nan")) for b in pl.exchange.buffers(B)]
    pl.prepass(ps, rs, bufs, thr, rcfg.alpha)
    bufs_k = ring.ring_all_gather([b.clone() for b in bufs])
    bufs_p = ring.ring_all_gather_plain([b.clone() for b in bufs])
    p1_err = max(float((k - p).abs().max()) for k, p in zip(bufs_k, bufs_p))
    for h in range(SHARDS):
        if bool(torch.isnan(bufs_k[h]).any()):
            fail(f"P1: shard {h} has unfilled blocks")
        if not torch.equal(bufs_k[h], bufs_p[h]):
            fail(f"P1: shard {h} differs from plain")
        if not torch.equal(bufs_k[h], bufs_k[0]):
            fail(f"P1: shard {h} differs from shard 0")
    p1_ms = cuda_ms(lambda: ring.ring_all_gather(bufs_k))
    p1_plain = cuda_ms(lambda: ring.ring_all_gather_plain(bufs_p))
    # the yardstick: one torch.cat writing every shard's whole buffer from
    # the G blocks (G x G blocks where the ring copies G x (G - 1))
    n_loc = eng.n_loc
    blocks = [bufs_p[h][h * n_loc:(h + 1) * n_loc] for h in range(SHARDS)]
    p1_lib = cuda_ms(lambda: torch.cat(blocks * SHARDS, dim=0))
    del blocks
    print(f"P1: bit-equal to plain on a superstep's buffers; {p1_ms:.4f} ms "
          f"vs plain {p1_plain:.4f} ms per all-gather "
          f"({(SHARDS - 1) * SHARDS} hops); one torch.cat of every "
          f"buffer {p1_lib:.4f} ms")
    del bufs, bufs_k, bufs_p

    # P2 on the real walk phase's partials (a whole push first): the one
    # pass that the engine takes with every shard on one card, its plain
    # version, the ring's hop kernels (the cross-card path, called
    # directly) and their plain hop loop, all bit-equal
    ps, rs = eng.init_state(sources)
    it_ref = eng.push(ps, rs)
    xs = pl.walk_partials(rs, eng.index_depth)
    got = ring.ring_reduce_scatter(xs)
    one_plain = ring.reduce_scatter_onepass_plain(xs)
    hops, want = ring.ring_reduce_scatter_hops(xs), \
        ring.ring_reduce_scatter_plain(xs)
    p2_diff = max(float((k - p).abs().max()) for k, p in zip(got, one_plain))
    hop_diff = max(float((k - p).abs().max()) for k, p in zip(hops, want))
    for h in range(SHARDS):
        if not torch.equal(got[h], one_plain[h]):
            fail(f"P2 one pass: shard {h} differs from its plain version")
        if not (torch.equal(got[h], hops[h]) and torch.equal(got[h], want[h])):
            fail(f"P2 one pass: shard {h} differs from the ring's hops")
        if not torch.equal(hops[h], want[h]):
            fail(f"P2 hops: shard {h} differs from plain")
    total = torch.stack(xs).double().sum(dim=0)
    p2_err = max(float((got[h].double() - total[h * eng.n_loc:
                                                (h + 1) * eng.n_loc])
                       .abs().max()) for h in range(SHARDS))
    one_ms = cuda_ms(lambda: ring.reduce_scatter_onepass(xs))
    one_plain_ms = cuda_ms(lambda: ring.reduce_scatter_onepass_plain(xs))
    p2_ms = cuda_ms(lambda: ring.ring_reduce_scatter_hops(xs))
    p2_plain = cuda_ms(lambda: ring.ring_reduce_scatter_plain(xs))
    # the yardstick: one torch.sum over the stacked [G, n_pad, B] partials
    stacked = torch.stack(xs)
    p2_lib = cuda_ms(lambda: torch.sum(stacked, dim=0))
    del stacked
    print(f"P2: the one pass, its plain version, the ring's hop kernels and "
          f"their plain loop bit-equal on the walk phase's partials; max "
          f"abs err {p2_err:.3e} against a float64 sum; one pass "
          f"{one_ms:.4f} ms (plain {one_plain_ms:.4f} ms), hops "
          f"{p2_ms:.4f} ms (plain {p2_plain:.4f} ms) per reduce-scatter; "
          f"torch.sum over the stacked partials {p2_lib:.4f} ms")
    del xs, got, one_plain, hops, want, total

    # the single-device indexed level at the same depth, unmerged graph
    dg_raw = to_device(g, device=dev)
    staged = StagedForaPrograms(dg_raw, rcfg, index)
    st = push.init_state(g.n, torch.as_tensor(sources, dtype=torch.int32,
                                              device=dev))
    p, r, contrib, it_one = staged.lean_state_fn(eng.index_depth)(
        st.p, st.r, rcfg.rmax, rcfg.omega_unit)
    one_v, one_i = topk_sum(p, contrib, K)
    if it_one != res.push_iters or it_ref != res.push_iters:
        fail(f"supersteps: sharded {res.push_iters} (again {it_ref}), "
             f"single device {it_one}")
    topk_agree("sharded vs single device", res.values, res.node_ids,
               one_v.cpu().numpy(), one_i.cpu().numpy(), 1e-4)
    del dg_raw, staged, st, p, r, contrib

    prec = metrics.batch_precision_at_k(res.node_ids[:len(exact_ids)],
                                        exact_ids)
    print(f"sharded precision@{K}: {prec:.4f} over {len(exact_ids)} queries "
          f"(limit {MIN_PRECISION})")
    if not prec >= MIN_PRECISION:
        fail(f"sharded precision@{K} {prec:.4f} < {MIN_PRECISION}")
    # the bounds of the functions, each input read once and each output
    # written once: P1 reads the G own blocks and writes the G (G - 1)
    # foreign ones, G^2 blocks; P2 reads the G partials (G^2 blocks) and
    # writes G output blocks.  The ring's own traffic ((G - 1) G hops, P1
    # one block read and one written a hop, P2 two read and one written),
    # the yardstick before, is printed beside them
    hops, block = (SHARDS - 1) * SHARDS, eng.n_loc * B * 4
    p2_bound = bound((SHARDS + 1) * SHARDS * block, hops * block / 4)
    ring_ms = {"ring_all_gather_hop": bound(2 * hops * block)["bound_ms"],
               "ring_reduce_scatter_hop": bound(3 * hops * block)["bound_ms"]}
    rows = {"ring_all_gather_hop": dict(
                max_abs_err=p1_err, ms=p1_ms, plain_ms=p1_plain,
                library_ms=p1_lib, **bound(SHARDS * SHARDS * block)),
            "ring_reduce_scatter_hop": dict(
                max_abs_err=hop_diff, ms=p2_ms, plain_ms=p2_plain,
                library_ms=p2_lib, **p2_bound),
            "reduce_scatter_onepass": dict(
                max_abs_err=p2_diff, ms=one_ms, plain_ms=one_plain_ms,
                library_ms=p2_lib, **p2_bound)}
    for name, ms in ring_ms.items():
        print(f"{name}: bound of the function {rows[name]['bound_ms']:.4f} "
              f"ms; the ring's traffic at the same rate {ms:.4f} ms")
    return rows, counts, res.push_iters


def sharded_walk_equal(csr, graph, rcfg, start, label) -> None:
    """K4's sharded form (its alias form where the slices carry alias
    tables) through the public entry over the shard slices ``csr``, and
    its plain form (run_walks_philox over the slices), bit-equal to
    run_walks_philox on the unsharded ``graph`` on ``start``: a walk that
    differs fails."""
    from fora_tpu_torch.ops import walk
    a, hops = rcfg.alpha, rcfg.max_walk_hops
    name = "K4-sharded" + ("-alias" if csr.alias_prob is not None else "")
    want = walk.run_walks_philox(graph, start, SEED, a, hops)
    for form, got in (("kernel", walk.walk_endpoints(csr, start, SEED, a,
                                                      hops)),
                      ("plain form", walk.run_walks_philox(csr, start, SEED,
                                                           a, hops))):
        diff = int((got != want).sum())
        if diff:
            fail(f"{name} ({label}, {form}): {diff} of {start.numel()} walks "
                 f"differ from run_walks_philox on the unsharded graph")
    print(f"{name} ({label}) {start.numel()} walks over {len(csr.indptr)} "
          f"shard slices: the kernel and its plain form bit-equal to "
          f"run_walks_philox on the unsharded graph")


def raw_allocation(eng, rcfg, sources):
    """A raw level's allocation from the raw one-shot's residues: the
    push of ``sources`` on ``eng``, then every lane of the walk demand of
    the concatenated residues (lanes 0 .. the largest column's total, as
    one walk-phase chunk lays them out), int32 on the first shard's
    device.  K6 is held and timed on it (k6_demand_row, k6_expand_row on
    the concatenation; k6_accum_row on K4's endpoints of its lanes), and
    its sharded forms as the raw one-shot runs them: each shard's demand
    torch.equal to the plain version's, the chunk's lanes expanded over
    the shards' demands (expand_chunk_lanes) equal to the concatenation's
    expansion on every lane below its column's total (weight 0 past it),
    and the accumulate into the shards' partials
    (accumulate_chunk_endpoints) held to the float64 plain sum
    (k6_accum_check).  Returns the flat starts."""
    import torch
    from fora_tpu_torch.ops import walk
    from fora_tpu_torch.utils.timing import device_ms
    ps, rs = eng.init_state(sources)
    eng.push(ps, rs)
    r = torch.cat(rs)
    omega = rcfg.omega_unit
    label = f"phase 9's raw allocation, r {tuple(r.shape)}"
    rows = {}
    rows["walk_demand"], d, dp = k6_demand_row(r, omega)
    W, B = int(dp.total.max()), r.shape[1]
    label += f", {W} x {B} lane slots"
    rows["expand_lanes"], start, weight = k6_expand_row(r, d, dp, W)
    del d, dp
    n_loc = rs[0].shape[0]
    ds = [walk.walk_demand(x, omega) for x in rs]
    for h, (x, dh) in enumerate(zip(rs, ds)):
        want = walk.walk_demand_plain(x, omega)
        if not (torch.equal(dh.cum, want.cum)
                and torch.equal(dh.total, want.total)):
            fail(f"K6-demand: shard {h}'s cum or total differs from the "
                 "plain version's")
    tot = torch.stack([dh.total.long() for dh in ds])
    bounds = torch.cat([torch.zeros_like(tot[:1]), tot.cumsum(0)])
    s_start, s_weight = walk.expand_chunk_lanes(rs, ds, bounds, 0, W, n_loc)
    valid = torch.arange(W, device=r.device)[:, None] < bounds[-1][None, :]
    if not (torch.equal(s_start[valid], start[valid])
            and torch.equal(s_weight[valid], weight[valid])
            and not bool(s_weight[~valid].any())):
        fail("K6-expand's sharded form: the chunk's lanes over the shards' "
             "demands differ from the concatenation's expansion")
    del s_start, s_weight, valid
    ends = walk.walk_endpoints(eng.placement.walk, start.view(-1), SEED,
                               rcfg.alpha, rcfg.max_walk_hops).view(W, B)
    rows["accumulate_endpoints"] = k6_accum_row(ends, weight, r.shape[0],
                                                label)
    err = k6_accum_check(f"the shards' partials of {label}", ends, weight,
                         r.shape[0], bounds=bounds, G=len(rs))
    parts = [torch.zeros_like(r) for _ in rs]
    x_ms = device_ms(lambda: walk.expand_chunk_lanes(rs, ds, bounds, 0, W,
                                                     n_loc))
    a_ms = device_ms(lambda: walk.accumulate_chunk_endpoints(
        ends, weight, parts, bounds, 0))
    del parts
    del ends, weight
    for name, row in rows.items():
        k6_line(name, row, label)
    print(f"K6's sharded forms on {label}: {len(rs)} shards' demands equal "
          f"to the plain ones, the chunk's lanes over them to the "
          f"concatenation's; the accumulate into the shards' partials held "
          f"to float64 (max abs err {err:.3e}); device ms of the sharded "
          f"forms: expansion {x_ms:.4f}, accumulate {a_ms:.4f}")
    return start.view(-1)


def sharded_walk_row(eng, graph, rcfg, start, label) -> dict:
    """The kernel row of K4's sharded form on ``start`` over ``eng``'s
    shard slices: bit-equal as sharded_walk_equal() checks, timed as
    called beside its plain form and beside K4's unsharded branch on the
    same starts (what the table lookup costs), its bound walk_bound()'s
    over the same starts and the same sectors as K4's."""
    import torch
    from fora_tpu_torch.ops import walk
    from fora_tpu_torch.utils.timing import cuda_ms
    csr = eng.placement.walk
    a, hops = rcfg.alpha, rcfg.max_walk_hops
    sharded_walk_equal(csr, graph, rcfg, start, label)
    ms = cuda_ms(lambda: walk.walk_endpoints(csr, start, SEED, a, hops))
    k4_ms = cuda_ms(lambda: walk.walk_endpoints(graph, start, SEED, a, hops))
    plain_ms = cuda_ms(lambda: walk.run_walks_philox(csr, start, SEED, a,
                                                     hops), iters=1)
    gen = torch.Generator(device=start.device).manual_seed(SEED)
    b = walk_bound(graph, start, gen, a, hops, walk_sector_rate(graph))
    name = "K4-sharded" + ("-alias" if csr.alias_prob is not None else "")
    print(f"{name} ({label}) {start.numel()} walks: {ms:.4f} ms as called, "
          f"K4's unsharded branch on the same starts {k4_ms:.4f} ms "
          f"({ms / k4_ms - 1:+.1%}); plain form {plain_ms:.4f} ms; bound "
          f"{b['bound_ms']:.4f} ms by {b['bound_by']} "
          f"({b['bound_ms'] / ms:.0%} of it reached)")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
                unsharded_ms=k4_ms, **b)


def run_sharded_raw(g, rcfg, sources, exact_ids, graph, name):
    """The raw-walk one-shot: ShardedForaEngine without an index over
    SHARDS shards from make_mesh, once under dense and once under routed,
    ``sources`` at the final delta (the config's rmax and omega_unit);
    per exchange once to warm and once timed (counts reset just before,
    read just after), precision@50 of the first len(exact_ids) against
    ``exact_ids`` (>= MIN_PRECISION); routed against dense (the same
    supersteps and walks; values within rtol 1e-4, ids equal outside
    near-ties: the endpoints' scatter-add adds in no fixed order); then
    K4's sharded form held and timed
    on a raw level's allocation from the one-shot's residues (its first
    RAW_CHECK_COLS sources) against ``graph``, the unsharded device graph.
    Returns (launch counts per exchange, the exchange's supersteps per
    exchange, the kernel row of K4's sharded form)."""
    import numpy as np
    import torch
    from fora_tpu_torch import kernels
    from fora_tpu_torch.eval import metrics
    from fora_tpu_torch.parallel import ShardedForaEngine, make_mesh
    mesh = make_mesh(SHARDS)
    res, counts, steps = {}, {}, {}
    B = len(sources)
    for mode in ("dense", "routed"):
        t0 = time.perf_counter()
        eng = ShardedForaEngine(g, mesh, rcfg, k=K, exchange=mode)
        torch.cuda.synchronize()
        place_s = time.perf_counter() - t0
        eng.topk(sources, SEED)                     # warm
        xch = eng.exchange
        before = (xch.compacted, xch.fell_back, xch.cleared)
        plain0 = dict(plain_k6_calls)
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.topk(sources, SEED)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[mode] = kernels.launch_counts()
        no_plain_k6(f"{name} {mode}", plain0)
        steps[mode] = dict(zip(("compacted", "fell_back", "cleared"),
                               (xch.compacted - before[0],
                                xch.fell_back - before[1],
                                xch.cleared - before[2])),
                           supersteps=out.push_iters)
        if not (np.isfinite(out.values).all() and out.values.shape == (B, K)
                and not out.walk_overflow.any()):
            fail(f"{name} {mode}: values not finite, of the wrong shape, or "
                 f"walks dropped")
        prec = metrics.batch_precision_at_k(out.node_ids[:len(exact_ids)],
                                            exact_ids)
        print(f"{name} {mode}: placement (with the out-CSR's slices) "
              f"{place_s:.2f} s; {B} queries in {wall:.4f} s -> "
              f"{B / wall:.2f} q/s; {out.push_iters} supersteps "
              f"({steps[mode]['compacted']} compacted, "
              f"{steps[mode]['fell_back']} fell back); precision@{K} "
              f"{prec:.4f} over {len(exact_ids)} queries (limit "
              f"{MIN_PRECISION})")
        if not prec >= MIN_PRECISION:
            fail(f"{name} {mode} precision@{K} {prec:.4f} < {MIN_PRECISION}")
        res[mode] = out
        if mode == "dense":
            del eng
    # the same walks from the same residues (the push is bit-equal across
    # exchanges); only the order of the endpoints' float32 scatter-add
    # varies, over millions of walk weights a node, so the tolerance is
    # the one of the sharded-against-one-device check above
    a, b = res["dense"], res["routed"]
    if a.push_iters != b.push_iters:
        fail(f"{name}: routed took {b.push_iters} supersteps, dense "
             f"{a.push_iters}")
    topk_agree(f"{name} routed vs dense", b.values, b.node_ids, a.values,
               a.node_ids, 1e-4)
    start = raw_allocation(eng, rcfg, sources[:RAW_CHECK_COLS])
    row = sharded_walk_row(eng, graph, rcfg, start, "raw allocation of "
                           f"{RAW_CHECK_COLS} queries")
    del eng, start
    torch.cuda.empty_cache()
    return counts, steps, row


def l2_row_rate(dev) -> float:
    """Bytes/s at which the card serves scattered whole 512-byte rows (B =
    128 f32) of a 4 MB buffer, which stays in the L2: the row kernel of
    kernels/csrc/sector_probe.cu (64 rows a warp, past the L1), the best
    of 2^18, 2^20 and 2^22 threads, three timings each.  P3's bound of its
    function takes this rate for its row reads and its reductions."""
    import torch
    from fora_tpu_torch import kernels
    from fora_tpu_torch.utils.timing import cuda_ms
    buf = torch.zeros(8192 * 128, dtype=torch.float32, device=dev)
    rates = {}
    for log2 in (18, 20, 22):
        rows = kernels.row_reads(buf, threads=1 << log2)
        ms = min(cuda_ms(lambda: kernels.row_reads(buf, threads=1 << log2))
                 for _ in range(3))
        rates[log2] = 512 * rows / (ms * 1e-3)
    print("L2 rate for whole 512-byte rows over a 4 MB buffer: " + ", ".join(
        f"2^{k} threads {v / 1e12:.3f} TB/s" for k, v in rates.items()))
    return max(rates.values())


SHARDED_MODES = (("dense", {}), ("compact", {}), ("routed", {}),
                 ("hier", {"chips_per_host": 2}))


def pools_agree(name, got_ids, got_vals, want_ids, want_vals, sources,
                flip_share=0.01):
    """Two pools' answers: per query, values within rtol 1e-4 and the same
    ids wherever adjacent values differ by more than 1e-7; a query whose
    values differ beyond that was accepted at another level (a float-order
    flip at the acceptance edge, ROADMAP C2) and is counted: at most
    ``flip_share`` of the queries.  Returns (positions compared, flips)."""
    import numpy as np
    flips, compared = [], 0
    for s in sources:
        s = int(s)
        gv, wv = got_vals[s].astype(np.float64), want_vals[s].astype(
            np.float64)
        if not np.all(np.abs(gv - wv) <= 1e-4 * np.abs(wv) + 1e-12):
            flips.append(s)
            continue
        apart = np.abs(np.diff(wv)) > 1e-7
        sep = np.ones(len(wv), bool)
        sep[:-1] &= apart
        sep[1:] &= apart
        if not np.array_equal(got_ids[s][sep], want_ids[s][sep]):
            fail(f"{name}: query {s}: ids differ outside near-ties")
        compared += int(sep.sum())
    print(f"{name}: ids equal at {compared} positions outside near-ties, "
          f"values within rtol 1e-4; {len(flips)} of {len(sources)} "
          f"queries answered at another level (limit {flip_share:.0%})"
          + (f": {flips[:8]}" if flips else ""))
    if len(flips) > flip_share * len(sources):
        fail(f"{name}: {len(flips)} queries at another level")
    return compared, len(flips)


def sharded_pool(name, runner, sources):
    """Phase 5's pools through ``runner`` (counts reset just before, read
    just after).  Returns (ids, values, levels used, wall, level records,
    launch counts)."""
    from fora_tpu_torch import kernels
    vals = {}
    quiet = lambda *a: None   # noqa: E731
    kernels.reset_launch_counts()
    ids, n_acc, levels, wall, stats = run_queries(runner, sources, quiet,
                                                  values=vals)
    counts = kernels.launch_counts()
    if len(ids) != len(sources):
        fail(f"{name}: {len(ids)} of {len(sources)} queries answered")
    steps = sum(st["supersteps"] for st in stats)
    comp = sum(st["compacted"] for st in stats)
    back = sum(st["fell_back"] for st in stats)
    runs = sum(st["batches"] for st in stats)
    print(f"{name}: {len(sources)} queries in {wall:.3f} s -> "
          f"{len(sources) / wall:.2f} q/s; levels used {levels}; accepted "
          f"{n_acc}; {runs} level runs, {steps} supersteps: {comp} "
          f"compacted, {back} fell back to dense")
    return ids, vals, levels, wall, stats, counts


def compaction_rows(runner, rcfg, sources, dev):
    """The compaction kernel, the zeroing by rows and P3 against their
    plain versions on real supersteps of the first 128 sources' final
    level: two consecutive supersteps that fit the capacity, the second
    the one with the largest count, run by hand as ``push`` runs them.
    The first follows the level's superstep before it, as the pool left
    the buffers; the second follows that compacted one, so it zeroes only
    its own block and the first's rows, and a stale row would show.  On
    each, per shard and destination the same (id, row) pairs and counts
    as the plain compaction, and the compacted buffers
    equal to the ring's on every row the receiver reads and zero
    elsewhere.  Returns the kernel rows of the compaction, P3 and the
    clear, timed at the second superstep's shapes."""
    import numpy as np
    import torch
    from fora_tpu_torch import kernels
    from fora_tpu_torch.ops import exchange as xops
    from fora_tpu_torch.ops import ring
    from fora_tpu_torch.ops.gather import row_scatter_add_plain
    from fora_tpu_torch.utils.timing import cuda_ms, device_ms
    pl = runner._groups[0]
    xch = pl.exchange
    depth, _, omega = runner._levels[-1]
    thr = [sh.thr(depth, omega) for sh in pl.shards]
    G, n_loc, cap, D = xch.G, xch.n_loc, xch.cap, xch.D
    counts = [torch.zeros(D, dtype=torch.int32, device=dev)
              for _ in range(G)]

    def counts_of(ps, rs):
        """The next superstep's counts (its pre-pass on a copy of p, which
        it adds to in place, then the send side)."""
        bufs = xch.buffers(BATCH)
        pl.prepass([p.clone() for p in ps], rs, bufs, thr, rcfg.alpha)
        xch.send(bufs, counts)
        return np.stack([c.cpu().numpy() for c in counts])

    # the superstep with the largest count within the capacity whose
    # superstep before it fits too
    ps, rs = pl.init_state(sources[:BATCH])
    fits, most = [], []
    for i in range(rcfg.max_push_iters):
        c = counts_of(ps, rs)
        if pl.push(ps, rs, thr, rcfg.alpha, 1) == 0:
            break
        fits.append(xch.fits(c))
        most.append(int(c.max()))
    steps = [i for i in range(1, len(fits)) if fits[i] and fits[i - 1]]
    if not steps:
        fail("compaction check: no two consecutive supersteps of the level "
             "fit the capacity")
    step = max(steps, key=lambda i: most[i])
    ps, rs = pl.init_state(sources[:BATCH])
    for _ in range(step - 1):
        pl.push(ps, rs, thr, rcfg.alpha, 1)

    def superstep(first):
        """One superstep by hand, checked; returns its own blocks, the
        counts, the receive's slot ids and rows (shard 0) and the ids of
        the receive before it (every shard's)."""
        bufs = xch.buffers(BATCH)
        pl.prepass(ps, rs, bufs, thr, rcfg.alpha)
        xch.send(bufs, counts)
        cnt = np.stack([c.cpu().numpy() for c in counts])
        if not xch.fits(cnt):
            fail(f"compaction check: superstep {step + (not first)} "
                 f"overflowed")
        for h in range(G):
            block = bufs[h][h * n_loc:(h + 1) * n_loc]
            ids = torch.empty((D, cap), dtype=torch.int32, device=dev)
            rows = torch.empty((D, cap, BATCH), device=dev)
            pc = torch.empty(D, dtype=torch.int32, device=dev)
            xops.frontier_compact_plain(block, pl.shards[h].needed, cap,
                                        h * n_loc, xch.n_pad, ids, rows, pc)
            if not np.array_equal(pc.cpu().numpy(), cnt[h]):
                fail(f"compaction: shard {h} counts {cnt[h]} != plain "
                     f"{pc.cpu().numpy()}")
            for d in range(D):
                n = min(int(cnt[h, d]), cap)
                kid = xch.send_ids[h][d, :n].long()
                order = torch.argsort(kid)
                if not (torch.equal(kid[order], ids[d, :n].long())
                        and torch.equal(xch.send_rows[h][d, :n][order],
                                        rows[d, :n])
                        and bool((xch.send_ids[h][d, n:] == xch.n_pad)
                                 .all())):
                    fail(f"compaction: shard {h} destination {d} differs "
                         f"from plain")
        own = [bufs[h][h * n_loc:(h + 1) * n_loc].clone() for h in range(G)]
        recv = (xch.recv_ids[0].clone(), xch.recv_rows[0].clone())
        # None: the buffers are zeroed whole (after the ring)
        prev = (None if xch._written is None else
                [w.clone().view(-1) for w in xch._written])
        if not first and prev is None:
            fail("zeroing by rows: no receive's rows to zero after a "
                 "compacted superstep")
        dense = [b.clone() for b in bufs]
        ring.ring_all_gather(dense)
        zeroed = kernels.exchange_clear.launches
        xch.exchange(bufs, cnt)
        if kernels.exchange_clear.launches - zeroed != (prev is not None):
            fail(f"zeroing by rows: {kernels.exchange_clear.launches - zeroed}"
                 f" clears on superstep {step + (not first)}")
        for t in range(G):
            need = torch.cat([pl.shards[s].needed[xch._region(t)].bool()
                              if pl.shards[s].needed is not None else
                              torch.ones(n_loc, dtype=torch.bool, device=dev)
                              for s in range(G)])
            if not (torch.equal(bufs[t][need], dense[t][need])
                    and bool((bufs[t][~need] == 0).all())):
                fail(f"P3 receive (superstep {step + (not first)}): shard "
                     f"{t}'s buffer differs from the ring's")
        flags = [torch.zeros(1, dtype=torch.int32, device=dev)
                 for _ in range(G)]
        pl._gather(rs, bufs, thr, flags)
        return own, cnt, recv, prev

    superstep(True)
    own, cnt, (dst, tile), prev = superstep(False)
    print(f"compaction ({xch.mode}, cap {cap}): bit-equal to plain on "
          f"supersteps {step} and {step + 1} of the final level "
          f"({int(cnt.sum())} rows due over {G} x {D} pairs at the second, "
          f"largest {int(cnt.max())}); the compacted buffers equal the "
          f"ring's on every needed row and zero elsewhere, also after a "
          f"compacted superstep (zeroing by rows)")
    # timings at the second superstep, shard 0's launches.  ms, plain_ms
    # and library_ms time the launches as called (cuda_ms), as every row
    # of the line does; each kernel is shorter than its wrapper's host
    # work, so device_ms, its time with the host's enqueue hidden, is a
    # field of its own
    block0 = own[0]
    ids0 = torch.empty((D, cap), dtype=torch.int32, device=dev)
    rows0 = torch.empty((D, cap, BATCH), device=dev)
    cnt0 = torch.empty(D, dtype=torch.int32, device=dev)
    args = (block0, pl.shards[0].needed, cap, 0, xch.n_pad, ids0, rows0,
            cnt0)
    sent0 = int(np.minimum(cnt[0], cap).sum())
    comp = dict(
        max_abs_err=0.0,
        ms=cuda_ms(lambda: kernels.frontier_compact(*args)),
        device_ms=device_ms(lambda: kernels.frontier_compact(*args)),
        plain_ms=cuda_ms(lambda: xops.frontier_compact_plain(*args)),
        library_ms=None,   # no one PyTorch call compacts rows
        # the block and the masks read once, the rows sent and every id
        # slot written once
        **bound(nbytes(block0, pl.shards[0].needed)
                + sent0 * BATCH * 4 + D * cap * 4 + D * 4))
    src = xch.slot_src[dev]
    acc = torch.zeros((xch.n_pad, BATCH), device=dev)
    real = dst < xch.n_pad
    real_rows = int(real.sum())
    tile_real, dst_real = tile[real], dst[real].long()
    p3 = dict(
        max_abs_err=0.0,
        ms=cuda_ms(lambda: kernels.row_scatter_add(acc, tile, src, dst)),
        device_ms=device_ms(lambda: kernels.row_scatter_add(acc, tile, src,
                                                            dst)),
        plain_ms=cuda_ms(lambda: row_scatter_add_plain(acc, tile, src, dst)),
        library_ms=cuda_ms(lambda: acc.index_add_(0, dst_real, tile_real)),
        # the real rows read, their acc rows read and written, the slot
        # ids and sources read once
        **bound(3 * real_rows * BATCH * 4 + 2 * dst.numel() * 4))
    # the clear of the second superstep, every buffer, on the ids of the
    # first superstep's receive, as the second superstep's exchange ran
    # it.  The library's form is what it replaced: a zero_ of each own
    # block and an index_fill_ over each buffer's real ids
    del acc
    bufs = [torch.ones((xch.n_pad, BATCH), device=dev) for _ in range(G)]
    reals = [p[(p >= 0) & (p < xch.n_pad)].long() for p in prev]
    got = [b.clone() for b in bufs]
    kernels.exchange_clear(got, n_loc, prev)
    want = [b.clone() for b in bufs]
    xops.exchange_clear_plain(want, n_loc, prev)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        fail("the exchange's clear differs from its plain version")
    del got, want

    def library():
        for t in range(G):
            bufs[t][t * n_loc:(t + 1) * n_loc].zero_()
            bufs[t].index_fill_(0, reals[t], 0.0)
    # each own block written once, each real id's row outside it written
    # once, every slot id read once
    outside = sum(int(torch.unique(r[(r < t * n_loc) | (r >= (t + 1) * n_loc)])
                      .numel()) for t, r in enumerate(reals))
    clear = dict(
        max_abs_err=0.0,
        ms=cuda_ms(lambda: kernels.exchange_clear(bufs, n_loc, prev)),
        device_ms=device_ms(lambda: kernels.exchange_clear(bufs, n_loc,
                                                           prev)),
        plain_ms=cuda_ms(lambda: xops.exchange_clear_plain(bufs, n_loc,
                                                           prev)),
        library_ms=cuda_ms(library),
        library_device_ms=device_ms(library),
        **bound((G * n_loc + outside) * BATCH * 4
                + sum(p.numel() for p in prev) * 4))
    whole = device_ms(lambda: [b.zero_() for b in bufs])
    print(f"compaction kernel (shard 0, [{n_loc}, {BATCH}], {D} "
          f"destinations, {sent0} rows sent): {comp['ms']:.4f} ms as called "
          f"({comp['device_ms']:.4f} on the device), plain "
          f"{comp['plain_ms']:.4f} ms, bound {comp['bound_ms']:.4f} ms; P3 "
          f"receive (shard 0, {dst.numel()} slots, {real_rows} real): "
          f"{p3['ms']:.4f} ms ({p3['device_ms']:.4f}), plain "
          f"{p3['plain_ms']:.4f} ms, index_add_ over the real rows "
          f"{p3['library_ms']:.4f} ms, bound {p3['bound_ms']:.4f} ms; the "
          f"clear ({G} buffers, own blocks of {n_loc} rows and "
          f"{sum(p.numel() for p in prev)} slots, {outside} real rows "
          f"outside them), one launch: {clear['ms']:.4f} ms as called "
          f"({clear['device_ms']:.4f} on the device), plain "
          f"{clear['plain_ms']:.4f} ms, its library form ({G} zero_ and {G} "
          f"index_fill_) {clear['library_ms']:.4f} ms "
          f"({clear['library_device_ms']:.4f}), bound "
          f"{clear['bound_ms']:.4f} ms; the whole buffers' zero_ "
          f"{whole:.4f} ms (on the device)")
    if clear["ms"] > clear["library_ms"]:
        fail(f"the exchange's clear as called ({clear['ms']:.4f} ms) is "
             f"slower than its library form ({clear['library_ms']:.4f} ms)")
    del ps, rs, bufs, tile_real, own
    return comp, p3, clear


# the exchange's kernels in a profile, by a part of their device record's
# name: the buffer zeroing (PyTorch's fill kernel, which zero_ launches,
# and memset records), the compaction, P3, the clear and P2
EXCHANGE_RECORDS = (("memset", ("FillFunctor", "Memset")),
                    ("compaction", ("compact_kernel",)),
                    ("P3", ("row_scatter_add_kernel",)),
                    ("clear", ("exchange_clear_kernel",)),
                    ("P2 one pass", ("reduce_scatter_onepass_kernel",)),
                    ("P1", ("ring_copy4_kernel",)))


def exchange_line(mode, prof) -> None:
    """Print a pool profile's device time of the exchange's kernels."""
    if not prof:
        print(f"sharded pool {mode}: no profile, so no memset time")
        return
    parts = []
    for label, keys in EXCHANGE_RECORDS:
        hit = [v for k, v in prof.items() if any(x in k for x in keys)]
        parts.append(f"{label} {sum(v[0] for v in hit):.2f} ms "
                     f"({sum(v[1] for v in hit)} calls)")
    print(f"sharded pool {mode}, device time: " + ", ".join(parts))


def run_sharded_pool(g, rcfg, index, sources, dev, exact_ids, single):
    """Phase 15: the sharded refinement pool with SHARDS shards on the
    mesh's devices, once per exchange, phase 5's pools.  ``single`` is
    phase 5's (ids, values).  The store-backed pool reads an index built
    by build_walk_index_sharded, held array-equal to ``index`` (phase 4's
    build_walk_index at the same seed).  Returns (kernel rows of the
    compaction, P3 and the clear, launch counts per run, level records
    per run, launch counts of the sharded build)."""
    import shutil
    import numpy as np
    import torch
    from fora_tpu_torch import index as tidx
    from fora_tpu_torch import kernels
    from fora_tpu_torch.eval import metrics
    from fora_tpu_torch.parallel import (ShardedGraphStore, ShardedTopkRunner,
                                         make_mesh, save_sharded_graph)
    mesh = make_mesh(SHARDS)
    print(f"sharded pool: devices {[str(d) for d in mesh]}")

    def runner(graph, idx, **kw):
        t0 = time.perf_counter()
        r = ShardedTopkRunner(graph, mesh, rcfg, idx, k=K,
                              delta_stride=DSTRIDE, accept_slack=ACCEPT,
                              **kw)
        torch.cuda.synchronize()
        print(f"  placement {kw or ''}: {time.perf_counter() - t0:.2f} s")
        return r

    out, launches, stats, runs = {}, {}, {}, {}
    for mode, kw in SHARDED_MODES:
        runs[mode] = runner(g, index, exchange=mode, **kw)
        res = sharded_pool(f"sharded pool {mode}", runs[mode], sources)
        out[mode] = res
        launches[mode], stats[mode] = res[5], res[4]
    # warm walls, the exchanges alternated; one profiled pool of dense and
    # of routed (the idle share that the host's loop over the shards and
    # its one status read per superstep leave)
    quiet = lambda *a: None   # noqa: E731
    alternate(POOL_PAIRS, {f"sharded pool {mode}": (
        lambda r=r: timed(lambda: run_queries(r, sources, quiet)))
        for mode, r in runs.items()}, f"{len(sources)} queries")
    for mode in ("dense", "routed"):
        prof = profile_once(f"sharded_pool_{mode}",
                            lambda r=runs[mode]: run_queries(r, sources,
                                                             quiet),
                            need_trace=False)
        exchange_line(mode, prof)
    comp, p3, clear = compaction_rows(runs["routed"], rcfg, sources, dev)
    del runs
    torch.cuda.empty_cache()
    ids0, vals0, lev0 = out["dense"][:3]
    for mode, _ in SHARDED_MODES[1:]:
        ids, vals, lev = out[mode][:3]
        same = all(np.array_equal(ids[s], ids0[s])
                   and np.array_equal(vals[s].view(np.uint32),
                                      vals0[s].view(np.uint32))
                   for s in ids0)
        if not (same and lev == lev0 and ids.keys() == ids0.keys()):
            fail(f"sharded pool {mode}: not bit-equal to dense")
        if not sum(st["compacted"] for st in stats[mode]):
            fail(f"sharded pool {mode}: no superstep was compacted")
        if [st["supersteps"] for st in stats[mode]] != \
                [st["supersteps"] for st in stats["dense"]]:
            fail(f"sharded pool {mode}: supersteps differ from dense")
    print("sharded pool: compact, routed and hier bit-equal to dense (ids, "
          "values, levels used, supersteps of every level)")
    pools_agree("sharded pool dense vs phase 5's single-device pool", ids0,
                vals0, single[0], single[1], sources)
    ev = sources[:len(exact_ids)]
    prec = metrics.batch_precision_at_k(np.stack([ids0[int(s)] for s in ev]),
                                        exact_ids)
    print(f"sharded pool precision@{K}: {prec:.4f} over {len(ev)} queries "
          f"(limit {MIN_PRECISION})")
    if not prec >= MIN_PRECISION:
        fail(f"sharded pool precision@{K} {prec:.4f} < {MIN_PRECISION}")

    # the hub split on shards, against the same run without it
    run = runner(g, index, hub_rows=HUB_ROWS)
    hub = sharded_pool("sharded pool dense, hub split", run, sources)
    launches["hub"] = hub[5]
    pools_agree("sharded hub split vs without", hub[0], hub[1], ids0, vals0,
                sources)
    del run
    # the sharded index build: the walks over the out-CSR's shard slices
    # (K4's sharded form), every array equal to phase 4's index
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    sidx = tidx.build_walk_index_sharded(g, mesh, rcfg, SEED)
    build_s = time.perf_counter() - t0
    build_counts = kernels.launch_counts()
    walks = int(tidx.index_counts(g.out_deg, rcfg).sum())
    for f in ("edge_src", "edge_dst", "bucket_offsets", "counts_cum",
              "edge_mult"):
        if not np.array_equal(np.asarray(getattr(sidx, f)),
                              np.asarray(getattr(index, f))):
            fail(f"sharded index build: {f} differs from phase 4's index")
    print(f"sharded index build: {walks} walks over {SHARDS} shard slices "
          f"in {build_s:.1f} s ({build_counts['index_walk_sharded']} launches "
          f"of K4's sharded form); every array equal to phase 4's "
          f"build_walk_index at seed {SEED}")
    # store-backed: both stores written (the index store from the sharded
    # build), then read through mmap
    sdir = ROOT / "bench_data" / "torch_smoke_stores"
    shutil.rmtree(sdir, ignore_errors=True)
    t0 = time.perf_counter()
    save_sharded_graph(g, str(sdir), SHARDS)
    tidx.save_sharded(sidx, rcfg, str(sdir / "index"), SHARDS, graph=g)
    del sidx
    save_s = time.perf_counter() - t0
    run = runner(ShardedGraphStore(str(sdir), SHARDS),
                 tidx.ShardedIndexStore(str(sdir / "index"), SHARDS, rcfg),
                 exchange="routed")
    st = sharded_pool("sharded pool routed from the stores", run, sources)
    ids, vals, lev = out["routed"][:3]
    if not (st[2] == lev and all(
            np.array_equal(st[0][s], ids[s])
            and np.array_equal(st[1][s].view(np.uint32),
                               vals[s].view(np.uint32)) for s in ids)):
        fail("sharded pool from the stores: not bit-equal to the in-RAM run")
    print(f"sharded stores: written in {save_s:.1f} s; the store-backed "
          f"pool bit-equal to the in-RAM one")
    del run
    shutil.rmtree(sdir, ignore_errors=True)
    torch.cuda.empty_cache()
    return comp, p3, clear, launches, stats, build_counts


def run_weighted_sharded(gw, rcfg, index, sources, exact_ids):
    """Phase 15 on phase 13's weighted graph and index: the sharded pool
    (routed) at precision@50 >= MIN_PRECISION against the weighted
    oracle.  Returns its launch counts."""
    import numpy as np
    import torch
    from fora_tpu_torch.eval import metrics
    from fora_tpu_torch.parallel import ShardedTopkRunner, make_mesh
    run = ShardedTopkRunner(gw, make_mesh(SHARDS), rcfg, index, k=K,
                            delta_stride=DSTRIDE, accept_slack=ACCEPT,
                            exchange="routed")
    ids, _, _, _, _, counts = sharded_pool("weighted sharded pool routed",
                                           run, sources)
    ev = sources[:len(exact_ids)]
    prec = metrics.batch_precision_at_k(np.stack([ids[int(s)] for s in ev]),
                                        exact_ids)
    print(f"weighted sharded pool precision@{K}: {prec:.4f} over {len(ev)} "
          f"queries against the weighted oracle (limit {MIN_PRECISION})")
    if not prec >= MIN_PRECISION:
        fail(f"weighted sharded precision@{K} {prec:.4f} < {MIN_PRECISION}")
    del run
    torch.cuda.empty_cache()
    return counts


FRONTIER_BATCHES = (1, 8, 32)       # phase 16: K5's batch widths
FRONTIER_SMALL_CAP = 1 << 16        # a cap at which some supersteps fall back
RELABEL_ORDERS = ("identity", "degree", "bfs")


def k5_bound(graph, c, tasks, nt) -> dict:
    """K5's bound on this state, the same whatever implements it: the
    32-byte sectors of the pushing rows' ``contrib`` that hold a non-zero,
    the sectors of ``r`` that receive a non-zero add (read and written),
    the out-edge ids, two row pointers a pushing row and 8 bytes (row,
    range) a task; an f32 add per out-edge and non-zero entry of its
    row.  Also returns the counts."""
    import torch
    B = c.shape[1]
    dev = c.device
    rows = torch.unique(tasks[:nt, 0].long())
    nz = c[rows] != 0
    ri, ci = nz.nonzero(as_tuple=True)
    c_sectors = int(torch.unique((rows[ri] * B + ci) // 8).numel())
    d = graph.out_deg[rows].long()
    E = int(d.sum())
    src = torch.repeat_interleave(torch.arange(rows.numel(), device=dev), d)
    first = graph.out_indptr[rows].long() - (torch.cumsum(d, 0) - d)
    u = graph.out_indices[torch.repeat_interleave(first, d)
                          + torch.arange(E, device=dev)].long()
    k = nz.sum(1)                   # non-zero entries of each pushing row
    kk = k[src]                     # of each out-edge's row
    P = int(kk.sum())
    pe = torch.repeat_interleave(torch.arange(E, device=dev), kk)
    at = (torch.cumsum(k, 0) - k)[src[pe]] + torch.arange(P, device=dev) \
        - torch.repeat_interleave(torch.cumsum(kk, 0) - kk, kk)
    r_sectors = int(torch.unique((u[pe] * B + ci[at]) // 8).numel())
    moved = (SECTOR * c_sectors + 2 * SECTOR * r_sectors + 4 * E
             + 8 * rows.numel() + 8 * nt)
    return dict(**bound(moved, P), c_sectors=c_sectors, r_sectors=r_sectors,
                adds=P)


def k5_rows(graph, p0, r0, rmax, alpha, dev, forms):
    """K5's pre-pass and K5 on one real superstep's state: each against its
    plain version, timed as called and in device time beside its bound,
    beside the earlier form and K5's other grids (``forms``, from
    probes/frontier_probe.py), K1's dense gather on the same state and
    torch.sparse.mm of the in-CSR.  Returns (pre-pass row, K5 row, printed
    facts)."""
    import torch
    from fora_tpu_torch import kernels
    from fora_tpu_torch.ops import push
    from fora_tpu_torch.probes.frontier_probe import forms_on_state
    from fora_tpu_torch.utils.timing import cuda_ms, device_ms
    n, B = r0.shape
    thr = push.node_threshold(graph, rmax)
    wsum = push.out_weight(graph)
    T = push.TASK_EDGES
    tasks = torch.empty((push.task_rows(n, graph.m), push.TASK_FIELDS),
                        dtype=torch.int32, device=dev)
    status = torch.zeros(3, dtype=torch.int32, device=dev)
    p, r, c = p0.clone(), r0.clone(), torch.empty_like(r0)
    kernels.frontier_prepass(p, r, c, thr, graph.out_deg, graph.out_indptr,
                             wsum, alpha, tasks, status, T, graph.m)
    pp, pr, pc = p0.clone(), r0.clone(), torch.empty_like(r0)
    ptasks, pstatus = torch.empty_like(tasks), torch.zeros_like(status)
    push.frontier_prepass_plain(pp, pr, pc, thr, graph.out_deg,
                                graph.out_indptr, wsum, alpha, ptasks,
                                pstatus)
    kp, kc = p0.clone(), torch.empty_like(r0)
    kernels.push_prepass(kp, r0, kc, thr, graph.out_deg, wsum, alpha)
    if not (torch.equal(p, pp) and torch.equal(c, pc) and torch.equal(p, kp)
            and torch.equal(c, kc) and torch.equal(r, pr)):
        fail("K5 pre-pass: p, contrib or the masked r differ from the plain "
             "version or from K1's pre-pass")
    if status.tolist() != pstatus.tolist():
        fail(f"K5 pre-pass: status {status.tolist()} != plain "
             f"{pstatus.tolist()}")
    more, edges, nt = status.tolist()
    # (row, first edge, mask, edges), sorted: the plain version's set
    if not torch.equal(torch.unique(tasks[:nt], dim=0),
                       torch.unique(ptasks[:nt], dim=0)):
        fail("K5 pre-pass: its tasks or their masks differ from the plain "
             "version's")
    active = int((r0 > thr[:, None]).sum())
    row_active = torch.zeros(n, dtype=torch.bool, device=dev)
    row_active[tasks[:nt, 0].long()] = True
    # K5 against the float64 plain sum and the float32 one
    got = r.clone()
    kernels.frontier_push(got, c, tasks, nt, graph.out_indices)
    want = push.active_edge_segment_sum_plain(
        r.double(), c.double(), graph.in_src, graph.in_dst, row_active).float()
    # rtol 1e-4 (P3's, the other f32 atomic scatter): a hub row takes tens
    # of thousands of adds in an order that changes from run to run, and
    # such a float32 sum lay 1.1e-05 from the float64 one on an H100
    err = close("K5 vs plain (float64)", got, want, 1e-4, 1e-9)
    diff = (got - want).abs()
    rel = float((diff / want.abs().clamp_min(1e-30)).masked_fill(
        diff <= 1e-9, 0.0).max())
    want32 = push.active_edge_segment_sum_plain(
        r.clone(), c, graph.in_src, graph.in_dst, row_active)
    err32 = float((want32 - want).abs().max())
    # timings: every launch of the pre-pass on its own fresh copy of the
    # state (it masks r in place), into scratch outputs
    c_t, tasks_t, status_t = torch.empty_like(c), torch.empty_like(tasks), \
        torch.empty_like(status)

    def on_copies(calls, fn):
        copies = iter([(p0.clone(), r0.clone()) for _ in range(calls)])
        return lambda: fn(*next(copies))

    def prepass_k(cp, cr):
        kernels.frontier_prepass(cp, cr, c_t, thr, graph.out_deg,
                                 graph.out_indptr, wsum, alpha, tasks_t,
                                 status_t, T, graph.m)

    def prepass_p(cp, cr):
        push.frontier_prepass_plain(cp, cr, c_t, thr, graph.out_deg,
                                    graph.out_indptr, wsum, alpha, tasks_t,
                                    status_t)
    pre_ms = cuda_ms(on_copies(12, prepass_k))
    pre_dev = device_ms(on_copies(22, prepass_k))
    pre_plain = cuda_ms(on_copies(5, prepass_p), iters=3)
    k1pre_ms = cuda_ms(lambda: kernels.push_prepass(
        kp, r0, kc, thr, graph.out_deg, wsum, alpha))
    k1pre_dev = device_ms(lambda: kernels.push_prepass(
        kp, r0, kc, thr, graph.out_deg, wsum, alpha))
    del c_t, tasks_t, status_t
    # the earlier form and K5 with a warp a task on the same state
    other = forms_on_state(graph, p0, r0, thr, wsum, alpha, forms, rounds=3)
    # tasks read once below; r, thr, deg, wsum read and contrib written
    # once; p read and written and r written where an entry is active
    pre_row = dict(
        max_abs_err=0.0, ms=pre_ms, device_ms=pre_dev, plain_ms=pre_plain,
        library_ms=None, earlier_device_ms=other["prepass"]["earlier"],
        **bound(nbytes(r0, c, thr, graph.out_deg, wsum) + 12 * active
                + 8 * nt, 5 * r0.numel()))
    scratch = r.clone()

    def k5():
        kernels.frontier_push(scratch, c, tasks, nt, graph.out_indices)

    def k1():
        kernels.gather_scatter_add(scratch, c, graph.in_indptr, graph.in_src,
                                   sched=graph.in_sched)
    ones = torch.ones(graph.in_src.shape[0], dtype=torch.float32, device=dev)
    csr = sparse_csr(graph.in_indptr, graph.in_src, ones, n)
    lib_err = close("K5: torch.sparse.mm vs plain", sparse_mm(csr, c) + r,
                    want, 1e-4, 1e-7)
    sel = row_active[graph.in_src.long()]
    touched = int(torch.unique(graph.in_dst[sel]).numel())
    rows_act = int(row_active.sum())
    kb = k5_bound(graph, c, tasks, nt)
    k5_row = dict(
        max_abs_err=err, ms=cuda_ms(k5), device_ms=device_ms(k5),
        plain_ms=cuda_ms(lambda: push.active_edge_segment_sum_plain(
            scratch, c, graph.in_src, graph.in_dst, row_active), iters=3),
        library_ms=cuda_ms(lambda: sparse_mm(csr, c)),
        earlier_device_ms=other["push"]["earlier"],
        bound_ms=kb["bound_ms"], bound_by=kb["bound_by"])
    facts = dict(edges=edges, tasks=nt, rows=rows_act, touched=touched,
                 active=active, err32=err32, lib_err=lib_err, rel=rel,
                 k1_ms=cuda_ms(k1), k1_device_ms=device_ms(k1),
                 k1pre_ms=k1pre_ms, k1pre_dev=k1pre_dev, other=other,
                 bound=kb)
    return pre_row, k5_row, facts


def timed_push(graph, src, rmax, alpha, cap):
    """(seconds, PushState) of one whole push from ``src`` with
    ``compact_edges=cap``, synchronised at both ends."""
    import torch
    from fora_tpu_torch.ops import push
    st = push.init_state(graph.n, src)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = push.forward_push_from(graph, st, rmax=rmax, alpha=alpha,
                                 compact_edges=cap)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def forms_line(B, f) -> None:
    """Print K5 and its pre-pass against the earlier form on one state."""
    o, kb, lu = f["other"], f["bound"], f["other"]["lanes"]
    print(f"K5 B={B} forms on the same state, device ms (medians of 3, "
          f"alternated): pre-pass {o['prepass']['this']:.4f}, earlier "
          f"{o['prepass']['earlier']:.4f} (K1's pre-pass "
          f"{f['k1pre_dev']:.4f}); K5 {o['push']['this']:.4f}, earlier "
          f"{o['push']['earlier']:.4f}, other grids: a warp going on to "
          f"further tasks {o['push']['persistent']:.4f}, 2 tasks side by "
          f"side {o['push']['packed2']:.4f}, 4 {o['push']['packed4']:.4f}; "
          f"K5's bound {kb['bound_ms']:.4f}"
          f" ({kb['bound_by']}: {kb['c_sectors']} contrib and "
          f"{kb['r_sectors']} r sectors, {kb['adds']} adds); mask bits "
          f"{lu['bits']:.2f} a task (span {lu['span']}), lanes used "
          f"{lu['lanes']:.3f}, tasks of <= 32 edges {lu['short']:.3f}")


def run_frontier(g, rcfg, rmax, sources, dev):
    """Phase 16, K5: the compacted push on phase 9's layout (unmerged, no
    hub split) at B = 1, 8 and 32, at the default cap and a small one,
    against the dense push; K5 and its pre-pass on one real superstep's
    state, beside their earlier form; one compacted push per B under
    torch.profiler.  Returns (pre-pass row, K5 row, launches of the
    compacted pushes)."""
    import torch
    from fora_tpu_torch import kernels
    from fora_tpu_torch.graph import to_device
    from fora_tpu_torch.ops import push
    from fora_tpu_torch.probes.frontier_probe import load_forms, snapshot
    graph = to_device(g, device=dev)
    cap = push.default_edge_cap(graph.m_in)
    print(f"K5: phase 1's graph unmerged without the hub split, m_in "
          f"{graph.m_in}, default cap {cap}, small cap "
          f"{FRONTIER_SMALL_CAP}; rmax {rmax:.4e} (the final delta's)")
    srcs = {B: torch.as_tensor(sources[:B], dtype=torch.int32, device=dev)
            for B in FRONTIER_BATCHES}
    dense = {B: timed_push(graph, s, rmax, rcfg.alpha, 0)[1]
             for B, s in srcs.items()}
    slack = push.node_threshold(graph, rmax).clamp_min(1e-6)[:, None]
    # the path: every compacted push, counts reset just before, read after
    kernels.reset_launch_counts()
    push.superstep_counts.reset()
    seen = {}
    for B, s in srcs.items():
        for c in (-1, FRONTIER_SMALL_CAP):
            c0, d0 = (push.superstep_counts.compacted,
                      push.superstep_counts.dense)
            _, st = timed_push(graph, s, rmax, rcfg.alpha, c)
            comp = push.superstep_counts.compacted - c0
            fell = push.superstep_counts.dense - d0
            seen[B, c] = (st.iters, comp, fell)
            if abs(st.iters - dense[B].iters) > 1:
                fail(f"K5 B={B} cap {c}: {st.iters} supersteps, dense "
                     f"{dense[B].iters}")
            perr = close(f"K5 push p B={B} cap {c}", st.p, dense[B].p, 1e-5,
                         slack)
            rerr = close(f"K5 push r B={B} cap {c}", st.r, dense[B].r, 1e-5,
                         slack)
            print(f"K5 push B={B} cap {c}: {st.iters} supersteps ({comp} "
                  f"compacted, {fell} dense), dense push {dense[B].iters}; "
                  f"p max abs err {perr:.3e}, r {rerr:.3e} (rtol 1e-5, atol "
                  f"the node's threshold, at least 1e-6)")
            del st
    launches = kernels.launch_counts()
    if not (any(v[1] for v in seen.values())
            and any(v[2] for (_, c), v in seen.items()
                    if c == FRONTIER_SMALL_CAP)):
        fail(f"K5: not both branches seen at the small cap: {seen}")
    t0 = time.perf_counter()
    forms = load_forms()
    print(f"K5's earlier form and other grids built in "
          f"{time.perf_counter() - t0:.1f} s")
    # K5 and its pre-pass on one real superstep's state (B = 32, the
    # compacted superstep with the most active out-edges)
    snap_cap = cap or FRONTIER_SMALL_CAP   # a graph under 2^16 edges: 0
    best, counts = snapshot(graph, srcs[32], rmax, rcfg.alpha, snap_cap)
    print(f"K5 B=32: active out-edges per superstep {counts}")
    p0, r0, edges, step = best
    pre_row, k5_row, f = k5_rows(graph, p0, r0, rmax, rcfg.alpha, dev,
                                 forms)
    print(f"K5 on superstep {step} at B = 32: {f['edges']} active out-edges "
          f"in {f['tasks']} tasks from {f['rows']} rows ({f['active']} "
          f"active entries), {f['touched']} rows touched; max abs err "
          f"{k5_row['max_abs_err']:.3e} against the float64 plain sum, "
          f"largest relative {f['rel']:.3e} (the float32 plain sum's "
          f"{f['err32']:.3e}; torch.sparse.mm's "
          f"{f['lib_err']:.3e}); K5 {k5_row['ms']:.4f} ms as called, "
          f"{k5_row['device_ms']:.4f} device, bound {k5_row['bound_ms']:.4f}"
          f" ({k5_row['bound_by']}); K1 dense on the same state "
          f"{f['k1_ms']:.4f} ms as called, {f['k1_device_ms']:.4f} device; "
          f"torch.sparse.mm of the in-CSR {k5_row['library_ms']:.4f} ms")
    print(f"K5 pre-pass at B = 32: {pre_row['ms']:.4f} ms as called, "
          f"{pre_row['device_ms']:.4f} device, bound {pre_row['bound_ms']:.4f}"
          f"; K1's pre-pass on the same state {f['k1pre_ms']:.4f} ms; "
          f"bit-equal to it and to the plain version, tasks and masks "
          f"equal to the plain version's as a set")
    forms_line(32, f)
    del p0, r0, best
    # per B: K5 on its own largest compacted superstep, and the whole push
    # compacted against dense, alternated (dense, compact, compact, dense),
    # then one compacted push under torch.profiler
    for B, s in srcs.items():
        if B != 32:
            best, counts = snapshot(graph, s, rmax, rcfg.alpha, snap_cap)
            _, row, fb = k5_rows(graph, best[0], best[1], rmax, rcfg.alpha,
                                 dev, forms)
            print(f"K5 B={B}: active out-edges per superstep {counts}; on "
                  f"superstep {best[3]} ({fb['edges']} edges; largest "
                  f"relative error {fb['rel']:.3e}) K5 "
                  f"{row['ms']:.4f} ms as called, {row['device_ms']:.4f} "
                  f"device, bound {row['bound_ms']:.4f}; K1 dense "
                  f"{fb['k1_ms']:.4f} / {fb['k1_device_ms']:.4f}; "
                  f"torch.sparse.mm {row['library_ms']:.4f}")
            forms_line(B, fb)
            del best
        walls = {"dense": [], "compact": []}
        for c in (0, -1, -1, 0, 0, -1):
            walls["dense" if c == 0 else "compact"].append(
                timed_push(graph, s, rmax, rcfg.alpha, c)[0])
        d, k = (statistics.median(walls[x]) * 1e3
                for x in ("dense", "compact"))
        print(f"whole push B={B}: dense {d:.3f} ms, compacted (cap {cap}) "
              f"{k:.3f} ms (medians of 3, alternated): {d / k:.2f}x")
        profile_once(f"frontier_push_b{B}",
                     lambda: timed_push(graph, s, rmax, rcfg.alpha, -1))
    return pre_row, k5_row, launches


def run_relabel(g, rcfg, index, sources, dev, exact_ids, x):
    """Phase 16, node order: phase 1's graph in each of RELABEL_ORDERS,
    merged with the hub split as phase 4 lays it out; one superstep's K1
    gather at B = 128 per order beside its bound; phase 4's index carried
    to the degree order by relabel_index, and phase 5's sources run there
    and on the identity order with sources mapped by perm, as phase 5 runs
    them and as its first pool alone: precision@50 mapped back >=
    MIN_PRECISION as phase 5 runs them, and within 0.01 of the identity
    order's in both.  ``x`` is phase 7's exact PPR of the first EVAL_N
    sources ([n, EVAL_N]) and ``exact_ids`` its top-50 in phase 1's ids:
    the oracle breaks exact ties at rank 50 by lowest id (ROADMAP C8), so
    each order is scored against the top-50 in its own ids, mapped back
    (a source with fewer than 50 nodes of non-zero PPR ties at 0, where
    the lowest ids of one order are other nodes than those of another).
    Returns the launches of the degree order's run as phase 5's."""
    import numpy as np
    import torch
    from fora_tpu_torch import kernels
    from fora_tpu_torch.algo import exact
    from fora_tpu_torch.algo.topk import TopkRunner
    from fora_tpu_torch.eval import metrics
    from fora_tpu_torch.graph import relabel, to_device
    from fora_tpu_torch.ops import push
    from fora_tpu_torch.utils.timing import cuda_ms
    src0 = np.asarray(sources[:BATCH])
    graphs, perms = {}, {}
    for name in RELABEL_ORDERS:
        t0 = time.perf_counter()
        perm = (np.arange(g.n, dtype=np.int32) if name == "identity"
                else getattr(relabel, f"{name}_order")(g))
        t1 = time.perf_counter()
        gg = g if name == "identity" else relabel.relabel_graph(g, perm)
        dg = to_device(gg, merge_duplicate_edges=True, hub_rows=HUB_ROWS,
                       device=dev)
        t2 = time.perf_counter()
        src = torch.as_tensor(perm[src0], dtype=torch.int32, device=dev)
        thr = push.node_threshold(dg, rcfg.rmax)
        st = push.init_state(g.n, src)
        for _ in range(4):   # phase 3's spread-out state
            st = push.superstep(dg, st, alpha=rcfg.alpha, thr=thr)
        contrib = torch.empty_like(st.r)
        kernels.push_prepass(st.p.clone(), st.r, contrib, thr, dg.out_deg,
                             push.out_weight(dg), rcfg.alpha)
        hub_vals = contrib.index_select(0, dg.hub_ids)
        acc = torch.zeros_like(st.r)

        def gather_k():
            kernels.gather_scatter_add(acc, contrib, dg.in_indptr, dg.in_src,
                                       edge_w=dg.in_w, sched=dg.in_sched)
            kernels.gather_scatter_add(acc, hub_vals, dg.hub_indptr,
                                       dg.hub_src_local, edge_w=dg.hub_w,
                                       sched=dg.hub_sched)
        ms = [cuda_ms(gather_k) for _ in range(3)]
        b = bound(nbytes(contrib, hub_vals) + 2 * nbytes(acc)
                  + nbytes(dg.in_indptr, dg.in_src, dg.in_w, dg.hub_indptr,
                           dg.hub_src_local, dg.hub_w),
                  2 * dg.m_in * BATCH)
        hub_rows = dg.hub_ids.cpu().numpy()
        print(f"K1 gather, {name} order: {min(ms):.4f} ms (three runs of 10: "
              + ", ".join(f"{x:.4f}" for x in ms) + f"), bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}); {dg.m_in} merged "
              f"in-edges; hub rows span ids {hub_rows.min()}..{hub_rows.max()}"
              f"; order {t1 - t0:.1f} s, relabel and layout {t2 - t1:.1f} s")
        graphs[name], perms[name] = dg, perm
        del st, contrib, hub_vals, acc
    # the degree order's pool: the index relabelled, sources mapped
    perm = perms["degree"]
    inv = relabel.invert(perm)
    t0 = time.perf_counter()
    ridx = relabel.relabel_index(index, perm)
    print(f"relabel_index: {ridx.total_edges} index edges in "
          f"{time.perf_counter() - t0:.1f} s")
    # phase 5's sources as phase 5 runs them (pools of POOL, then the
    # flush) and its first pool alone, on both orders, sources mapped by
    # perm and answers mapped back
    ev = [int(s) for s in sources[:EVAL_N]]
    inv_t = torch.as_tensor(inv, dtype=torch.long, device=dev)
    oracle = {"identity": exact_ids,
              "degree": inv[exact.topk_ids(x[inv_t], K)]}
    runs = {}
    for setup, part in (("phase 5", sources), ("first pool", sources[:POOL])):
        srcs = [int(s) for s in part]
        for name, idx, p in (("identity", index, perms["identity"]),
                             ("degree", ridx, perm)):
            runner = TopkRunner(graphs[name], rcfg, k=K, index=idx,
                                delta_stride=DSTRIDE, accept_slack=ACCEPT)
            if (setup, name) == ("phase 5", "degree"):
                kernels.reset_launch_counts()
            res, _, levels, wall, _ = run_queries(
                runner, p[np.asarray(srcs)], lambda *a: None)
            if (setup, name) == ("phase 5", "degree"):
                launches = kernels.launch_counts()
            back = {s: (inv[res[int(p[s])]] if name == "degree"
                        else res[s]) for s in srcs}
            pred = np.stack([back[s] for s in ev])
            prec = metrics.batch_precision_at_k(pred, oracle[name])
            runs[setup, name] = (back, prec)
            print(f"{setup} ({len(srcs)} sources) on the {name} order: "
                  f"{wall:.3f} s (one cold run), levels {levels}, "
                  f"precision@{K} {prec:.4f} over {EVAL_N} queries against "
                  f"the oracle in its own ids, mapped back ("
                  f"{metrics.batch_precision_at_k(pred, exact_ids):.4f} "
                  f"against phase 7's, whose ties at rank {K} follow phase "
                  f"1's ids)")
        a, b = runs[setup, "degree"], runs[setup, "identity"]
        same = np.mean([np.array_equal(a[0][s], b[0][s]) for s in srcs])
        print(f"{setup}: the degree order's top-{K} ids equal to the "
              f"identity order's for {same:.3f} of the queries; precision "
              f"{a[1]:.4f} against {b[1]:.4f}")
        if abs(a[1] - b[1]) > 0.01:
            fail(f"relabelled pool ({setup}): precision@{K} {a[1]:.4f}, the "
                 f"identity order's {b[1]:.4f}")
    prec = runs["phase 5", "degree"][1]
    if not prec >= MIN_PRECISION:
        fail(f"relabelled pool: precision@{K} {prec:.4f} < {MIN_PRECISION}")
    # the push on the degree order against identity's, mapped back
    s_id = torch.as_tensor(src0, dtype=torch.int32, device=dev)
    st_id = push.forward_push(graphs["identity"], s_id, rmax=rcfg.rmax,
                              alpha=rcfg.alpha, max_iters=rcfg.max_push_iters)
    st_dg = push.forward_push(graphs["degree"],
                              torch.as_tensor(perm[src0], dtype=torch.int32,
                                              device=dev),
                              rmax=rcfg.rmax, alpha=rcfg.alpha,
                              max_iters=rcfg.max_push_iters)
    back = st_dg.p[torch.as_tensor(perm, dtype=torch.long, device=dev)]
    slack = push.node_threshold(graphs["identity"], rcfg.rmax).clamp_min(
        1e-6)[:, None]
    perr = close("relabelled push p vs identity", back, st_id.p, 1e-5, slack)
    print(f"degree order push: {st_dg.iters} supersteps (identity "
          f"{st_id.iters}), p mapped back max abs err {perr:.3e} (rtol 1e-5, "
          f"atol the node's threshold)")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=int, default=0, metavar="PAIRS",
                    help="profile the query phase, hub split on and off, "
                         "instead of the checks")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    import numpy as np

    preloaded = foreign_modules()
    from fora_tpu_torch import ForaConfig
    from fora_tpu_torch import index as tidx
    from fora_tpu_torch import kernels
    from fora_tpu_torch.algo import bounds, exact
    from fora_tpu_torch.algo.topk import TopkRunner
    from fora_tpu_torch.eval import metrics
    from fora_tpu_torch.eval import queries as qio
    from fora_tpu_torch.graph import generators, to_device
    from fora_tpu_torch.index.build_sharded import shard_out_csr
    from fora_tpu_torch.kernels import build as kbuild
    from fora_tpu_torch.kernels import select
    from fora_tpu_torch.ops import gather, push, walk
    from fora_tpu_torch.utils.timing import Phase, cuda_ms

    dev = torch.device(DEVICE)
    rows = {}   # kernel name -> {max_abs_err, ms, plain_ms}
    count_plain_k6()

    # ---- 1. device -----------------------------------------------------
    with Phase("device"):
        kind = torch.cuda.get_device_name(0)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        print(f"device: {kind}; torch {torch.__version__} cuda "
              f"{torch.version.cuda}; count {torch.cuda.device_count()}")
        print(smi.splitlines()[0])

    # ---- 2. build ------------------------------------------------------
    with Phase("build"):
        lib_path = kbuild.build()
        kbuild.library()
        built = ("cached" if kbuild.last_build_secs is None
                 else f"{kbuild.last_build_secs:.1f} s")
        print(f"build: {lib_path} ({built})")
        log = lib_path.parent / "nvcc.log"
        for line in log.read_text().splitlines():
            if "Used" in line or "Compiling entry" in line:
                print("  ptxas:", line.split("ptxas info    :")[-1].strip())

    # ---- graph (host) ----------------------------------------------------
    with Phase("graph"):
        t0 = time.perf_counter()
        g = generators.rmat(NLOG2, (1 << NLOG2) * EDGEF, seed=SEED)
        print(f"graph: RMAT n={g.n} m={g.m} generated in "
              f"{time.perf_counter() - t0:.1f} s")
        rcfg = ForaConfig(epsilon=EPS, k=K).resolved(g.n, g.m)
        dg = to_device(g, merge_duplicate_edges=True, hub_rows=HUB_ROWS,
                       device=dev)
        dg_flat = to_device(g, merge_duplicate_edges=True, hub_rows=0,
                            device=dev)
        sources = qio.generate_sources(g, QUERIES, seed=SEED + 1)
        print(f"device graph: {dg.m_in} merged in-edges "
              f"({dg.in_src.shape[0]} tail + {dg.hub_dst.shape[0]} hub)")

    if args.profile:
        with Phase("index build"):
            index = build_index(g, dg, rcfg)

        def make_runner(graph):
            return TopkRunner(graph, rcfg, k=K, index=index,
                              delta_stride=DSTRIDE, accept_slack=ACCEPT)
        profile_queries(args.profile, {f"hub{HUB_ROWS}": dg, "flat": dg_flat},
                        make_runner, sources)
        profile_sharded(args.profile, g, rcfg, index, sources[:POOL], dev)
        raw = TopkRunner(dg, rcfg, k=K, index=None, delta_stride=DSTRIDE,
                         accept_slack=ACCEPT)

        def raw_pool():
            run_queries(raw, sources[:RAW_QUERIES], lambda *a: None,
                        pool=RAW_QUERIES, batch=RAW_BATCH, defer=RAW_DEFER)
        alternate(args.profile, {"raw": lambda: timed(raw_pool)},
                  f"pool of {RAW_QUERIES} raw-walk queries")
        profile_once("raw", raw_pool)
        return 0

    # ---- 3. K1 and K4 against their plain versions -----------------------
    with Phase("kernels K1 K1-back K4 K4-hub"):
        src128 = torch.as_tensor(sources[:BATCH], dtype=torch.int32,
                                 device=dev)
        thr = push.node_threshold(dg, rcfg.rmax)
        st = push.init_state(g.n, src128)
        for _ in range(4):   # a spread-out frontier, not the one-hot start
            st = push.superstep(dg, st, alpha=rcfg.alpha, thr=thr)

        k1_err = 0.0
        results = {}
        for name, graph in (("split", dg), ("unsplit", dg_flat)):
            kp, kr, kf = kernel_superstep(graph, st.p.clone(), st.r.clone(),
                                          thr, rcfg.alpha)
            pp, pr, pf = plain_superstep(graph, st.p.clone(), st.r.clone(),
                                         thr, rcfg.alpha)
            if kf != pf:
                fail(f"K1 {name}: flag {kf} != plain {pf}")
            k1_err = max(k1_err,
                         close(f"K1 {name} p", kp, pp, 1e-5, 1e-7),
                         close(f"K1 {name} r", kr, pr, 1e-5, 1e-7))
            results[name] = (kp, kr, kf)
        close("K1 split vs unsplit p", results["split"][0],
              results["unsplit"][0], 1e-5, 1e-7)
        close("K1 split vs unsplit r", results["split"][1],
              results["unsplit"][1], 1e-5, 1e-7)
        del results
        # whole pushes from the one-hot start: split and unsplit converge
        # after the same number of supersteps
        iters = {}
        for name, graph in (("split", dg), ("unsplit", dg_flat)):
            s = push.forward_push(graph, src128, rmax=rcfg.rmax,
                                  alpha=rcfg.alpha,
                                  max_iters=rcfg.max_push_iters)
            iters[name] = (s.iters, s.p, s.r)
        if iters["split"][0] != iters["unsplit"][0]:
            fail(f"K1: split push took {iters['split'][0]} supersteps, "
                 f"unsplit {iters['unsplit'][0]}")
        # over a whole push the two summation orders can put an entry on
        # either side of its threshold in some superstep, which moves up to
        # one threshold's worth of mass at that node (thr = rmax * deg:
        # under 1e-6 for most nodes, more for the largest out-degrees)
        slack = thr.clamp_min(1e-6)[:, None]
        close("K1 push p", iters["split"][1], iters["unsplit"][1], 1e-5, slack)
        close("K1 push r", iters["split"][2], iters["unsplit"][2], 1e-5, slack)
        print(f"K1: superstep matches plain (split, unsplit), max abs err "
              f"{k1_err:.3e}; full push {iters['split'][0]} supersteps "
              f"both ways")
        del iters

        # timings at B = 128 on the spread-out state (scratch outputs)
        p_s, contrib_s = st.p.clone(), torch.empty_like(st.r)
        wsum = push.out_weight(dg)
        rows["push_prepass"] = dict(
            max_abs_err=k1_err,
            ms=cuda_ms(lambda: kernels.push_prepass(
                p_s, st.r, contrib_s, thr, dg.out_deg, wsum, rcfg.alpha)),
            plain_ms=cuda_ms(lambda: push.push_prepass_plain(
                p_s, st.r, contrib_s, thr, dg.out_deg, wsum, rcfg.alpha)),
            library_ms=None,
            # p read and written, r read, contrib written; 5 f32 operations
            # per entry (compare, alpha r, add, (1 - alpha) r, divide)
            **bound(2 * nbytes(p_s) + nbytes(st.r, contrib_s, thr,
                                               dg.out_deg, wsum),
                    5 * st.r.numel()))
        acc = torch.zeros_like(st.r)
        hub_vals = contrib_s.index_select(0, dg.hub_ids)

        def gather_k():
            kernels.gather_scatter_add(acc, contrib_s, dg.in_indptr,
                                       dg.in_src, edge_w=dg.in_w,
                                       sched=dg.in_sched)
            kernels.gather_scatter_add(acc, hub_vals, dg.hub_indptr,
                                       dg.hub_src_local, edge_w=dg.hub_w,
                                       sched=dg.hub_sched)

        def gather_p():
            gather.gather_scatter_add_plain(acc, contrib_s, dg.in_indptr,
                                            dg.in_src, edge_w=dg.in_w)
            gather.gather_scatter_add_plain(acc, hub_vals, dg.hub_indptr,
                                            dg.hub_src_local, edge_w=dg.hub_w)

        # determinism: the masked, flagged split gather twice from one state
        runs = []
        for _ in range(2):
            a = st.r.clone()
            f = torch.zeros(1, dtype=torch.int32, device=dev)
            kernels.gather_scatter_add(a, contrib_s, dg.in_indptr, dg.in_src,
                                       edge_w=dg.in_w, thr=thr, mask=True,
                                       sched=dg.in_sched)
            kernels.gather_scatter_add(a, hub_vals, dg.hub_indptr,
                                       dg.hub_src_local, edge_w=dg.hub_w,
                                       thr=thr, flag=f, sched=dg.hub_sched)
            runs.append((a, int(f.item())))
        if not (torch.equal(runs[0][0], runs[1][0])
                and runs[0][1] == runs[1][1]):
            fail("K1: two launches from one state differ")
        del runs, a
        # the yardstick: torch.sparse.mm (cuSPARSE SpMM) over the merged
        # CSR by destination without the hub split, the same sum
        csr = sparse_csr(dg_flat.in_indptr, dg_flat.in_src, dg_flat.in_w,
                         g.n)
        flat_want = gather.gather_scatter_add_plain(
            torch.zeros_like(acc), contrib_s, dg_flat.in_indptr,
            dg_flat.in_src, edge_w=dg_flat.in_w)
        lib_err = close("K1 torch.sparse.mm vs plain",
                        sparse_mm(csr, contrib_s), flat_want, 1e-4, 1e-7)
        edges = dg.m_in
        rows["gather_scatter_add"] = dict(
            max_abs_err=k1_err, ms=cuda_ms(gather_k),
            plain_ms=cuda_ms(gather_p, iters=3),
            library_ms=cuda_ms(lambda: sparse_mm(csr, contrib_s)),
            # both operands read once, acc read and written once, the two
            # CSRs and their weights read once; a multiply and an add per
            # edge and column
            **bound(nbytes(contrib_s, hub_vals) + 2 * nbytes(acc)
                    + nbytes(dg.in_indptr, dg.in_src, dg.in_w, dg.hub_indptr,
                             dg.hub_src_local, dg.hub_w),
                    2 * edges * BATCH))
        flat_ms = cuda_ms(lambda: kernels.gather_scatter_add(
            acc, contrib_s, dg_flat.in_indptr, dg_flat.in_src,
            edge_w=dg_flat.in_w, sched=dg_flat.in_sched))
        k1 = rows["gather_scatter_add"]
        print(f"K1 gather at B = {BATCH}: {k1['ms']:.4f} ms (split: tail and "
              f"hub launches), {flat_ms:.4f} ms unsplit; torch.sparse.mm "
              f"over the unsplit CSR {k1['library_ms']:.4f} ms (max abs err "
              f"{lib_err:.3e} vs plain); bound {k1['bound_ms']:.4f} ms "
              f"(split); two launches bit-equal")
        del p_s, contrib_s, acc, hub_vals, st, csr, flat_want

        # K4: 2^22 walks from one source, kernel vs plain run_walks by
        # total variation
        k4_rate = walk_sector_rate(dg)
        start = torch.full((WALK_CHECK,), int(sources[0]), dtype=torch.int32,
                           device=dev)
        ends_k = walk.walk_endpoints(dg, start, SEED, rcfg.alpha,
                                     rcfg.max_walk_hops)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        ends_p = walk.run_walks(dg, start, generator=gen, alpha=rcfg.alpha,
                                max_hops=rcfg.max_walk_hops)
        f_k = torch.bincount(ends_k.long(), minlength=g.n).double() / WALK_CHECK
        f_p = torch.bincount(ends_p.long(), minlength=g.n).double() / WALK_CHECK
        top = torch.argsort(f_p, descending=True)[:1000]
        tv = 0.5 * float((f_k[top] - f_p[top]).abs().sum())
        walk_err = float((f_k[top] - f_p[top]).abs().max())
        print(f"K4: {WALK_CHECK} walks from node {int(sources[0])}: total "
              f"variation {tv:.4f} over the top-1000 endpoints (limit 0.01)")
        if not tv < 0.01:
            fail(f"K4 endpoint distribution: total variation {tv:.4f}")
        # shapes (i) and (ii) bit-equal to run_walks_philox, timed beside
        # their bounds; the sweep of walks per lane
        del ends_k, ends_p, f_k, f_p
        starts = {"i": start, "ii": index_build_starts(dg, rcfg,
                                                       INDEX_LAUNCH)}
        k4 = walk_shapes(dg, rcfg, starts, k4_rate)["i"]
        # K4's sharded form at shape (i): the out-CSR as SHARDS slices
        sharded_walk_equal(shard_out_csr(g, [dev] * SHARDS), dg, rcfg, start,
                           "i")
        walk_sweep(dg, rcfg, sources[0])
        rows["index_walk"] = dict(
            max_abs_err=walk_err, ms=k4["ms"],
            plain_ms=cuda_ms(lambda: walk.run_walks(
                dg, start, generator=gen, alpha=rcfg.alpha,
                max_hops=rcfg.max_walk_hops), iters=3),
            library_ms=None, bound_ms=k4["bound_ms"],
            bound_by=k4["bound_by"])
        del start, starts

        # K1-back (BiPPR's pre-pass) on BiPPR's state; K4-hub on the hub
        # index that the CLI's --algo hubppr builds (kept for phase 10)
        rows["backward_prepass"] = check_backward_prepass(dg, rcfg, dev)
        hub = hub_index_for(dg, rcfg)
        rows["index_walk_hub"] = check_hub_walk(
            dg, rcfg, sources[0], dev, hub, "K4-hub",
            rate=walk_sector_rate(dg, hub))

    # ---- 4.-5. the main path: index build and queries ------------------
    kernels.reset_launch_counts()
    with Phase("index build"):
        index = build_index(g, dg, rcfg)
    with Phase("queries"):
        runner = TopkRunner(dg, rcfg, k=K, index=index, delta_stride=DSTRIDE,
                            accept_slack=ACCEPT)
        single_vals = {}
        results, n_acc, levels, elapsed, stats = run_queries(
            runner, sources, values=single_vals)
        if len(results) != QUERIES:
            fail(f"{len(results)} of {QUERIES} queries answered")
        print(f"queries: {QUERIES} in {elapsed:.3f} s -> "
              f"{QUERIES / elapsed:.2f} q/s; levels used {levels}; "
              f"accepted {n_acc}/{QUERIES}")
    launches = kernels.launch_counts()

    # ---- 6. K2 and K3 against their plain versions -----------------------
    with Phase("kernels K2 K3"):
        level = len(runner.deltas) - 1
        depth, rmax, omega = runner._levels[level]
        staged = runner._staged
        p, r = runner._init_pool_state(src128)
        p, r, contrib, _ = staged.lean_state_fn(depth)(p, r, rmax, omega)
        inv = staged._inv_cnt(depth)
        # the plain sums run in float64, 16 columns at a time (plain64):
        # index_add_'s order on the card changes from run to run, and a
        # float32 sum of a long row in two orders can differ by more than
        # rtol 1e-5; the float32 plain level is held up beside it below
        inv64 = inv.double()
        mult64 = None if staged._mult is None else staged._mult.double()
        k2_err, n_buckets = 0.0, 0
        for q, bucket in enumerate(staged._buckets):
            if bucket is None:
                continue
            indptr, src, mult = bucket
            got = kernels.index_spmv(torch.zeros_like(r), r, indptr, src,
                                     mult, inv)
            m64 = None if mult is None else mult.double()
            want = plain64(lambda v: gather.gather_scatter_add_plain(
                torch.zeros_like(v), v, indptr, src, edge_w=m64,
                src_w=inv64), r)
            k2_err = max(k2_err, close(f"K2 bucket {q}", got, want, 1e-5,
                                       1e-9))
            n_buckets += 1
        # the level in one launch against the per-bucket plain loop
        args = (r, staged._indptr[depth:], staged._seg_off[depth:],
                staged._src, staged._mult, inv)
        sched = staged.level_schedule(depth)

        def level_k():
            return gather.index_spmv_level(*args, sched=sched)

        got, again = level_k(), level_k()
        want = plain64(lambda v: gather.index_spmv_level_plain(
            v, *args[1:4], mult64, inv64), r)
        k2_err = max(k2_err, close("K2 level", got, want, 1e-5, 1e-9))
        if not torch.equal(got, again):
            fail("K2: two launches of the level differ")
        want32 = gather.index_spmv_level_plain(*args)
        err32 = (want32 - want).abs()
        rel32 = err32 / want.abs().clamp_min(1e-30)
        rel32[err32 <= 1e-9] = 0.0
        at = divmod(int(rel32.argmax()), rel32.shape[1])
        relk = (got[at] - want[at]).abs() / want[at].abs().clamp_min(1e-30)
        print(f"K2: the float32 plain level against the float64 one: "
              f"{int((err32 > 1e-9 + 1e-5 * want.abs()).sum())} entries beyond "
              f"rtol 1e-5, atol 1e-9; largest relative error "
              f"{float(rel32[at]):.3e} at row {at[0]} column {at[1]} "
              f"({float(want32[at]):.6e} vs {float(want[at]):.6e}); the "
              f"kernel's there {float(relk):.3e}")
        del want32, err32, rel32
        print(f"K2: {n_buckets} buckets one by one and the level at depth "
              f"{depth} in one launch match plain, max abs err "
              f"{k2_err:.3e}; two level launches bit-equal")
        csr = level_csr(staged._buckets, depth, inv, g.n)
        lib_err = close("K2 torch.sparse.mm vs plain", sparse_mm(csr, r),
                        want, 1e-4, 1e-9)
        level_edges = csr.values().numel()
        lvl = [b for b in staged._buckets[depth:] if b is not None]
        rows["index_spmv"] = dict(
            max_abs_err=k2_err, ms=cuda_ms(level_k),
            plain_ms=cuda_ms(lambda: gather.index_spmv_level_plain(*args),
                             iters=3),
            library_ms=cuda_ms(lambda: sparse_mm(csr, r)),
            # r read and acc written once, every bucket's CSR, sources and
            # multiplicities and inv_cnt read once; two multiplies and an
            # add per edge and column
            **bound(nbytes(r, got, inv, *[t for b in lvl for t in b]),
                    3 * level_edges * r.shape[1]))
        k2 = rows["index_spmv"]
        print(f"K2 level at depth {depth} ({level_edges} edges in "
              f"{len(lvl)} buckets, {sched.n_tasks} tasks): {k2['ms']:.4f} "
              f"ms, torch.sparse.mm {k2['library_ms']:.4f} ms (max abs err "
              f"{lib_err:.3e} vs plain), bound {k2['bound_ms']:.4f} ms")
        del csr, got, again, want, args, inv64, mult64

        t = bounds.union_bound_t(rcfg.n, len(runner.deltas), rcfg.pfail)

        def accept_k():
            return bounds.topk_with_bounds_split(p, contrib, omega, K, t, EPS)

        got = accept_k()
        sel = kernels.topk_bounds_stats()
        again = accept_k()
        want = bounds.topk_with_bounds_split_plain(p, contrib, omega, K, t,
                                                   EPS)
        if not torch.equal(got[1], want[1]):
            fail("K3: top-k ids differ from plain")
        if not torch.equal(got[6], want[6]):
            fail("K3: accept differs from plain")
        k3_err = max(close(f"K3 {nm}", got[i], want[i], 1e-6, 0.0)
                     for i, nm in ((0, "vals"), (2, "lb"), (3, "ub"),
                                   (4, "lbk"), (5, "ub_excluded")))
        if not all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                   for a, b in zip(got, again)):
            fail("K3: two launches on one state differ")
        print(f"K3: ids and accept equal, max abs err {k3_err:.3e}; "
              f"{int(got[6].sum())}/{BATCH} accept at level {level}; two "
              f"launches bit-equal")
        cand = sel["candidates"]
        print(f"K3 selection at [{p.shape[0]}, {p.shape[1]}], k = {K}: "
              f"candidates per column mean {cand.mean():.1f}, largest "
              f"{int(cand.max())}, smallest {int(cand.min())} (capacity "
              f"{select.SEGMENT}); {sel['dense_columns']} columns took the "
              f"dense path")
        if sel["dense_columns"]:
            fail(f"K3: {sel['dense_columns']} columns took the dense path "
                 f"on the bench graph's final level")
        # the dense path alone on the same state (every column), and the
        # selection's yardstick: torch.topk of the sum, no bounds
        s2 = float(np.float32(2.0 * t) * bounds._c(omega))
        dense = kernels.topk_bounds(p, contrib, K, s2, 1.0 + EPS, stride=0)
        if kernels.topk_bounds_stats()["dense_columns"] != BATCH:
            fail("K3: the forced dense path did not take every column")
        if not all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                   for a, b in zip(got, dense)):
            fail("K3: the dense path differs from the selection")
        dense_ms = cuda_ms(lambda: kernels.topk_bounds(
            p, contrib, K, s2, 1.0 + EPS, stride=0))
        lib_v, lib_i = torch.topk(p + contrib, K + 1, dim=0)
        if not torch.equal(lib_v[:K].T.contiguous(), got[0]):
            fail("K3: torch.topk's values differ")
        topk_ms = cuda_ms(lambda: torch.topk(p + contrib, K + 1, dim=0))
        rows["topk_bounds"] = dict(
            max_abs_err=k3_err, ms=cuda_ms(accept_k),
            plain_ms=cuda_ms(lambda: bounds.topk_with_bounds_split_plain(
                p, contrib, omega, K, t, EPS), iters=3),
            library_ms=None,   # no one PyTorch call selects with bounds
            # p and contrib read once, the [B, k] results written once; an
            # add per entry
            **bound(nbytes(p, contrib, *got), p.numel()))
        k3 = rows["topk_bounds"]
        print(f"K3 at B = {BATCH}: {k3['ms']:.4f} ms; its dense path alone "
              f"{dense_ms:.4f} ms (bit-equal); bound {k3['bound_ms']:.4f} "
              f"ms; the selection's yardstick torch.topk(p + contrib, "
              f"{K + 1}, dim=0), without ids' tie order or bounds, "
              f"{topk_ms:.4f} ms")
        # K3's passes by device time, ten calls (for the record only: a
        # machine whose profiler cannot trace the card still passes)
        profile_once("k3", lambda: [accept_k() for _ in range(10)],
                     need_trace=False)
        del dense, lib_v, lib_i, again
        del p, r, contrib, got, want

    # ---- 7. quality ------------------------------------------------------
    with Phase("quality"):
        ev = sources[:EVAL_N]
        x = exact.exact_ppr_batch(g, ev, device=dev)
        ex = exact.topk_ids(x, K)
        pred = np.stack([results[int(s)] for s in ev])
        prec = metrics.batch_precision_at_k(pred, ex)
        # the exact top-k is ambiguous where rank k ties with nodes below it
        kth = x.T.gather(1, torch.as_tensor(ex[:, -1:], device=dev))
        tied = int(((x.T >= kth).sum(dim=1) > K).sum())
        print(f"precision@{K}: {prec:.4f} over {EVAL_N} queries "
              f"(limit {MIN_PRECISION}); {tied} of them have an exact tie "
              f"across rank {K}")
        if not prec >= MIN_PRECISION:
            fail(f"precision@{K} {prec:.4f} < {MIN_PRECISION}")

    # ---- 9. the graph-sharded engine -------------------------------------
    with Phase("sharded"):
        sharded_rows, sharded_launches, sh_iters = run_sharded(
            g, rcfg, index, sources[:POOL], dev, ex[:EVAL_N])
        rows.update(sharded_rows)
        raw1_launches, raw1_steps, rows["index_walk_sharded"] = \
            run_sharded_raw(g, rcfg, sources[:POOL], ex[:EVAL_N], dg,
                            "sharded raw")

    # ---- 10.-12. raw walk, Monte Carlo, P3 --------------------------------
    with Phase("raw walk"):
        raw_launches, k6_rows = run_raw(dg, rcfg, sources, ex[:EVAL_N],
                                        hub=hub, k6=True)
        rows.update(k6_rows)
        del hub
    with Phase("montecarlo"):
        mc_launches = run_montecarlo(dg, rcfg, sources, ex[:EVAL_N])
    with Phase("P3"):
        rows["row_scatter_add"], p3_launches = run_p3(dev)

    # ---- 15. the sharded refinement pool -----------------------------------
    with Phase("sharded pool"):
        (rows["frontier_compact"], rows["row_scatter_add_receive"],
         rows["exchange_clear"], pool_launches, pool_stats,
         build_launches) = run_sharded_pool(g, rcfg, index, sources, dev,
                                            ex[:EVAL_N],
                                            (results, single_vals))

    # ---- 16. K5, the frontier-compacted push, and node order ---------------
    with Phase("frontier push"):
        (rows["frontier_prepass"], rows["frontier_push"],
         k5_launches) = run_frontier(g, rcfg, runner._levels[-1][1], sources,
                                     dev)
    with Phase("relabel"):
        relabel_launches = run_relabel(g, rcfg, index, sources, dev,
                                       ex[:EVAL_N], x)

    # ---- 13. weighted graphs ---------------------------------------------
    del dg, dg_flat, index, runner, staged, results, x, lvl, inv, sched
    torch.cuda.empty_cache()
    with Phase("weighted"):
        (rows["index_walk_alias"], w_launches, w_raw_launches,
         w_mc_launches, w_pool_launches, w_raw1_launches, w_raw1_steps,
         rows["index_walk_sharded_alias"]) = run_weighted(g, rcfg, dev)

    # ---- 14. the CLI and the server ----------------------------------------
    torch.cuda.empty_cache()
    with Phase("cli"):
        cli_launches = run_cli(g, rcfg, sources, ex[:EVAL_N], dev)

    # ---- 8. proof that each path ran on its kernels ------------------------
    hops = (SHARDS - 1) * SHARDS
    print(f"launches in phases 4-5: {launches}")
    for name in MAIN_KERNELS:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the main path")
    # K1: a tail and a hub gather per superstep (no fix-up launch); K2 and
    # K3: one launch per level of each batch
    level_runs = sum(st["batches"] for st in stats)
    if launches["gather_scatter_add"] != 2 * launches["push_prepass"]:
        fail(f"K1: {launches['gather_scatter_add']} gathers for "
             f"{launches['push_prepass']} supersteps, expected two each")
    if launches["index_spmv"] != level_runs:
        fail(f"K2: {launches['index_spmv']} launches for {level_runs} "
             f"level runs, expected one each")
    print(f"launches in phase 9's timed run ({sh_iters} supersteps): "
          f"{sharded_launches}")
    for name in SHARDED_KERNELS:
        if sharded_launches[name] <= 0:
            fail(f"kernel {name} was not launched on the sharded path")
    print(f"launches in phase 10: {raw_launches}")
    for name in RAW_KERNELS:
        if raw_launches[name] <= 0:
            fail(f"kernel {name} was not launched on the raw-walk path")
    if raw_launches["index_spmv"]:
        fail("the raw-walk path launched the index SpMV")
    print(f"launches in phase 11: {mc_launches}")
    if mc_launches["index_walk"] <= 0:
        fail("K4 was not launched on the Monte Carlo path")
    # K6: the raw pools run the demand once per walk phase and the
    # expansion and the accumulate once per chunk; Monte Carlo and HubPPR
    # the accumulate alone (once per chunk: run_montecarlo checks the
    # count); the raw one-shots' counts are checked with theirs below; no
    # path without a walk phase runs any of them
    k6 = ("walk_demand", "expand_lanes", "accumulate_endpoints")
    for label, c in (("phase 10's raw pool", raw_launches),
                     ("phase 13's weighted raw pool", w_raw_launches)):
        if min(c[x] for x in k6) <= 0 or \
                c["expand_lanes"] != c["accumulate_endpoints"]:
            fail(f"{label}: K6 launches {[c[x] for x in k6]}, expected "
                 "some of each, one accumulate per expansion")
    for label, c in (("phase 11's Monte Carlo", mc_launches),
                     ("phase 13's Monte Carlo", w_mc_launches),
                     ("phase 14's hubppr", cli_launches["hubppr"])):
        if c["accumulate_endpoints"] <= 0 or c["walk_demand"] or \
                c["expand_lanes"]:
            fail(f"{label}: K6 launches {[c[x] for x in k6]}, expected the "
                 "accumulate alone")
    if any(c[x] for x in k6 for c in (
            launches, sharded_launches, p3_launches, w_launches,
            w_pool_launches, build_launches, k5_launches, relabel_launches,
            *pool_launches.values(),
            *[v for a, v in cli_launches.items() if a != "hubppr"])):
        fail("K6 ran on a path without a walk phase")
    print(f"launches in phase 12: {p3_launches}")
    if p3_launches["row_scatter_add"] <= 0:
        fail("P3 was not launched by the gather probe")
    # phase 13: the weighted index build and pools, the weighted raw-walk
    # pool and Monte Carlo each run K4's alias branch and never its
    # uniform one; no earlier phase ran the alias branch
    print(f"launches in phase 13 (index build and pools): {w_launches}")
    print(f"launches in phase 13 (raw-walk pool): {w_raw_launches}")
    print(f"launches in phase 13 (Monte Carlo): {w_mc_launches}")
    for name in WEIGHTED_KERNELS:
        if w_launches[name] <= 0:
            fail(f"kernel {name} was not launched on the weighted path")
    for name in ("push_prepass", "gather_scatter_add", "topk_bounds",
                 "index_walk_alias"):
        if w_raw_launches[name] <= 0:
            fail(f"kernel {name} was not launched on the weighted raw path")
    if w_mc_launches["index_walk_alias"] <= 0:
        fail("K4's alias branch was not launched by weighted Monte Carlo")
    if any(c["index_walk"] for c in (w_launches, w_raw_launches,
                                     w_mc_launches)):
        fail("a weighted path launched K4's uniform branch")
    if any(c["index_walk_alias"] or c["index_walk_sharded_alias"]
           for c in (launches, sharded_launches, raw_launches, mc_launches,
                     p3_launches, *raw1_launches.values(), build_launches,
                     *pool_launches.values())):
        fail("K4's alias branch was launched on an unweighted path")
    # the raw one-shot (phase 9, and on the weighted graph in phase 13):
    # K4's sharded form (its alias form on the weighted graph, never the
    # other one nor an unsharded branch), K1, K3's selection once per
    # shard, P2's one pass once, no K2; P1 on every superstep that took
    # the ring; under routed the compaction, P3 once per shard per
    # compacted superstep and the clear once per compacted superstep that
    # follows a compacted one
    for label, runs, steps, walk_name, other in (
            ("phase 9", raw1_launches, raw1_steps, "index_walk_sharded",
             "index_walk_sharded_alias"),
            ("phase 13", w_raw1_launches, w_raw1_steps,
             "index_walk_sharded_alias", "index_walk_sharded")):
        for mode, c in runs.items():
            st = steps[mode]
            print(f"launches in {label}'s raw one-shot ({mode}, "
                  f"{st['supersteps']} supersteps, {st['compacted']} "
                  f"compacted, {st['fell_back']} fell back): {c}")
            ring_steps = (st["supersteps"] if mode == "dense"
                          else st["fell_back"])
            want = {walk_name: None, "push_prepass": None,
                    "gather_scatter_add": None, "topk_bounds": SHARDS,
                    "reduce_scatter_onepass": 1, "index_spmv": 0,
                    "index_walk": 0, "index_walk_alias": 0, other: 0,
                    "ring_reduce_scatter_hop": 0,
                    "ring_all_gather_hop": hops * ring_steps,
                    "row_scatter_add": SHARDS * st["compacted"],
                    "exchange_clear": st["cleared"],
                    "walk_demand": SHARDS, "expand_lanes": None,
                    "accumulate_endpoints": None}
            for name, n in want.items():
                if (c[name] <= 0) if n is None else (c[name] != n):
                    fail(f"{label}'s raw one-shot ({mode}): {c[name]} "
                         f"launches of {name}, expected "
                         f"{'some' if n is None else n}")
            if (mode == "dense") != (c["frontier_compact"] == 0):
                fail(f"{label}'s raw one-shot ({mode}): "
                     f"{c['frontier_compact']} compactions")
    # the sharded index build (phase 15): K4's sharded form once per
    # chunk of 2^23 walks, no other walk branch
    print(f"launches in phase 15's sharded index build: {build_launches}")
    chunks = -(-int(tidx.index_counts(g.out_deg, rcfg).sum()) // (1 << 23))
    if build_launches["index_walk_sharded"] != chunks or any(
            build_launches[n] for n in ("index_walk", "index_walk_alias",
                                        "index_walk_sharded_alias")):
        fail(f"sharded index build: {build_launches['index_walk_sharded']} "
             f"launches of K4's sharded form for {chunks} chunks, or "
             f"another walk branch ran")
    # phase 15: per exchange, K1-K3 and P2 on every level run (K2 and K3
    # once per shard, P2's one pass once: every shard is on the one card,
    # so the ring's hops never run), P1 on the supersteps that took the
    # ring, the compaction, P3 and the clear on the compacted runs only (P3
    # once per shard per compacted superstep, the clear once on each that
    # follows a compacted one, in one launch for the four buffers)
    for mode, c in list(pool_launches.items()) + [("weighted routed",
                                                   w_pool_launches)]:
        print(f"launches in phase 15 ({mode}): {c}")
        for name in SHARDED_KERNELS[:4] + ("reduce_scatter_onepass",):
            if c[name] <= 0:
                fail(f"kernel {name} was not launched by the sharded pool "
                     f"({mode})")
    for mode, c in pool_launches.items():
        st = pool_stats.get(mode)
        if st is None:
            continue
        runs = sum(x["batches"] for x in st)
        steps = sum(x["supersteps"] for x in st)
        comp = sum(x["compacted"] for x in st)
        back = sum(x["fell_back"] for x in st)
        cleared = sum(x["cleared"] for x in st)
        ring_steps = steps if mode == "dense" else back
        want = {"topk_bounds": SHARDS * runs, "index_spmv": SHARDS * runs,
                "reduce_scatter_onepass": runs, "ring_reduce_scatter_hop": 0,
                "ring_all_gather_hop": hops * ring_steps,
                "gather_scatter_add": SHARDS * steps,
                "row_scatter_add": SHARDS * comp,
                "exchange_clear": cleared}
        for name, n in want.items():
            if c[name] != n:
                fail(f"phase 15 {mode}: {c[name]} launches of {name}, "
                     f"expected {n} ({runs} level runs, {steps} supersteps, "
                     f"{comp} compacted)")
        if (mode == "dense") != (c["frontier_compact"] == 0):
            fail(f"phase 15 {mode}: {c['frontier_compact']} compactions")
        if (mode == "dense") != (cleared == 0):
            fail(f"phase 15 {mode}: {cleared} supersteps cleared by rows "
                 f"of {comp} compacted")
        print(f"phase 15 {mode}: K3 and K2 once per shard per level run "
              f"({runs}), P1 on the {ring_steps} supersteps that took the "
              f"ring, P3 on the {comp} compacted ones"
              + (" (no superstep fell back, so P1 did not run)"
                 if mode != "dense" and not back else ""))
    if any(c["frontier_compact"] or c["row_scatter_add"]
           or c["exchange_clear"]
           for c in (launches, sharded_launches, raw_launches, mc_launches,
                     raw1_launches["dense"], w_raw1_launches["dense"],
                     build_launches)):
        fail("the compaction, P3 or the clear ran on a path without a "
             "compacted exchange")
    if any(c["ring_reduce_scatter_hop"] for c in (
            sharded_launches, w_pool_launches, *pool_launches.values(),
            *raw1_launches.values(), *w_raw1_launches.values(),
            *cli_launches.values())):
        fail("P2's hop kernel ran with every shard on one card")
    if any(c["index_walk_sharded"] or c["index_walk_sharded_alias"]
           for c in (launches, sharded_launches, raw_launches, mc_launches,
                     p3_launches, w_launches, w_raw_launches, w_mc_launches,
                     w_pool_launches, *pool_launches.values(),
                     *cli_launches.values())):
        fail("K4's sharded form ran on a path without the out-CSR's "
             "shard slices")
    # phase 14: each CLI action and the server ran its kernels; BiPPR's
    # pre-pass and K4-hub ran on no path before it, K4-hub only in hubppr
    for name, c in cli_launches.items():
        print(f"launches in phase 14 ({name}): {c}")
    need = {"build": ("index_walk",),
            "batch-topk": MAIN_KERNELS[:4], "serve": MAIN_KERNELS[:4],
            "batch-topk sharded": MAIN_KERNELS[:4] + (
                "reduce_scatter_onepass", "frontier_compact"),
            "serve sharded": MAIN_KERNELS[:4] + (
                "ring_all_gather_hop", "reduce_scatter_onepass"),
            "fwdpush": ("push_prepass", "gather_scatter_add"),
            "hubppr": ("index_walk", "index_walk_hub"),
            "bippr": ("backward_prepass", "gather_scatter_add",
                      "index_walk")}
    for action, names in need.items():
        for name in names:
            if cli_launches[action][name] <= 0:
                fail(f"kernel {name} was not launched by the CLI's {action}")
    earlier = (launches, sharded_launches, raw_launches, mc_launches,
               p3_launches, w_launches, w_raw_launches, w_mc_launches,
               w_pool_launches, *pool_launches.values())
    if any(c["index_walk_hub"] or c["backward_prepass"] for c in earlier):
        fail("K4-hub or the K1-back pre-pass ran on a path before phase 14")
    if any(c["index_walk_hub"] for a, c in cli_launches.items()
           if a != "hubppr"):
        fail("K4-hub was launched outside HubPPR")
    if sharded_launches["ring_all_gather_hop"] != hops * sh_iters:
        fail(f"P1: {sharded_launches['ring_all_gather_hop']} launches, "
             f"expected {hops} per superstep x {sh_iters}")
    if sharded_launches["reduce_scatter_onepass"] != 1:
        fail(f"P2: {sharded_launches['reduce_scatter_onepass']} launches of "
             f"the one pass, expected 1")
    if sharded_launches["index_spmv"] != SHARDS:
        fail(f"K2: {sharded_launches['index_spmv']} sharded launches, "
             f"expected one per shard")
    # phase 16: the compacted pushes ran K5's pre-pass and K5, and K1's
    # gather on the supersteps that fell back, never K1's pre-pass; the
    # relabelled pool ran K1-K3; no other path ran K5 or its pre-pass
    print(f"launches in phase 16's compacted pushes: {k5_launches}")
    for name in ("frontier_prepass", "frontier_push", "gather_scatter_add"):
        if k5_launches[name] <= 0:
            fail(f"kernel {name} was not launched by the compacted pushes")
    if k5_launches["push_prepass"]:
        fail("a compacted push launched K1's pre-pass")
    print(f"launches in phase 16's relabelled pool: {relabel_launches}")
    for name in MAIN_KERNELS[:4]:
        if relabel_launches[name] <= 0:
            fail(f"kernel {name} was not launched by the relabelled pool")
    if any(c["frontier_prepass"] or c["frontier_push"]
           for c in (*earlier, relabel_launches, *raw1_launches.values(),
                     *w_raw1_launches.values(), build_launches,
                     *cli_launches.values())):
        fail("K5 or its pre-pass ran on a path other than the compacted "
             "push")
    loaded = sorted(foreign_modules() - preloaded)
    if loaded:
        fail(f"the port imported JAX or fora_tpu: {loaded[:5]}")
    meta = {
        "push_prepass": ("push_prepass.cu", "fora_tpu/ops/push.py:315"),
        "backward_prepass": ("push_prepass.cu",
                             "fora_tpu/algo/bippr.py:66"),
        "gather_scatter_add": ("gather_scatter.cu",
                               "fora_tpu/ops/push.py:142"),
        "index_spmv": ("gather_scatter.cu", "fora_tpu/algo/fora.py:352"),
        "topk_bounds": ("topk_bounds.cu", "fora_tpu/algo/bounds.py:112"),
        "index_walk": ("walk.cu", "fora_tpu/ops/walk.py:159"),
        "index_walk_alias": ("walk.cu", "fora_tpu/ops/walk.py:212"),
        "index_walk_hub": ("walk.cu", "fora_tpu/algo/hubppr.py:143"),
        "ring_all_gather_hop": ("ring.cu", "fora_tpu/ops/ring.py:107"),
        "ring_reduce_scatter_hop": ("ring.cu", "fora_tpu/ops/ring.py:32"),
        # P2 again, in one launch where the shards share a card
        "reduce_scatter_onepass": ("ring.cu", "fora_tpu/ops/ring.py:32"),
        "row_scatter_add": ("row_scatter.cu",
                            "scripts/pallas_gather_probe.py:43"),
        # P3 again, as the routed exchange's receive (JAX's
        # ``full.at[recv_ids].add`` there)
        "row_scatter_add_receive": ("row_scatter.cu",
                                    "fora_tpu/parallel/sharded.py:204"),
        "frontier_compact": ("exchange.cu",
                             "fora_tpu/parallel/sharded.py:177"),
        # the zeroed buffer of the routed receive (JAX's ``jnp.zeros`` of
        # every row before ``full.at[recv_ids].add``)
        "exchange_clear": ("row_scatter.cu",
                           "fora_tpu/parallel/sharded.py:203"),
        # the row-sharded lockstep walk (its alias hop at 259)
        "index_walk_sharded": ("walk.cu", "fora_tpu/ops/walk.py:225"),
        "index_walk_sharded_alias": ("walk.cu", "fora_tpu/ops/walk.py:259"),
        # K5: the compacted branch's O(m) activity mask and count (its
        # pre-pass), and active_edge_segment_sum's gather (K5 itself)
        "frontier_prepass": ("frontier_push.cu",
                             "fora_tpu/ops/push.py:298"),
        "frontier_push": ("frontier_push.cu", "fora_tpu/ops/push.py:283"),
        # K6: allocate_walks' demand and cumsum, its lane -> node map by
        # scatter + cummax with the weights' take_along_axis, and the
        # endpoints' segment_sum (phase 10's largest walk phase)
        "walk_demand": ("walk_alloc.cu", "fora_tpu/ops/walk.py:57"),
        "expand_lanes": ("walk_alloc.cu", "fora_tpu/ops/walk.py:63"),
        "accumulate_endpoints": ("walk_alloc.cu",
                                 "fora_tpu/ops/walk.py:323"),
    }
    out = []
    for name, (src_file, replaces) in meta.items():
        row = rows[name]
        n = (launches[name] if name in MAIN_KERNELS else
             p3_launches[name] if name == "row_scatter_add" else
             pool_launches["routed"]["row_scatter_add"]
             if name == "row_scatter_add_receive" else
             pool_launches["routed"][name]
             if name in ("frontier_compact", "exchange_clear") else
             raw1_launches["dense"][name] if name == "index_walk_sharded" else
             w_raw1_launches["dense"][name]
             if name == "index_walk_sharded_alias" else
             w_launches[name] if name == "index_walk_alias" else
             cli_launches["bippr"][name] if name == "backward_prepass" else
             cli_launches["hubppr"][name] if name == "index_walk_hub" else
             k5_launches[name] if name.startswith("frontier_p") else
             raw_launches[name] if name in k6 else
             sharded_launches[name])
        out.append({"name": name, "route": "cuda",
                    "source": f"fora_tpu_torch/kernels/csrc/{src_file}",
                    "replaces": replaces, "launches": n,
                    "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                    "plain_ms": row["plain_ms"],
                    "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                    "library_ms": row["library_ms"],
                    **{k: row[k] for k in ("device_ms", "library_device_ms",
                                           "unsharded_ms", "earlier_device_ms")
                       if k in row}})
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
