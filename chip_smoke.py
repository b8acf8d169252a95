#!/usr/bin/env python3
"""Drive fora_tpu_torch's top-k query paths and its CLI once on one NVIDIA
GPU.

    python3 chip_smoke.py                 # the checks below
    python3 chip_smoke.py --profile 10    # query-phase profile instead

The graph of phases 3-17 is RMAT n = 2^19, m = 2^23, seed 7 (bench.py's
graph cut to FORA_BENCH_NLOG2 = 19; bench.py's own, 2^22 x 16, is phase
18's), with the duplicate-edge merge and a 131,072-row hub split; the
queries are bench.py's defaults (eps 0.5, k 50, delta = p_f = 1/n, alpha
0.2, delta stride 8).  Phases, each printing its wall time and peak
device memory:

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
  4. index       build the FORA+ index on the card (K4 through
                 run_walk_chunks, then K7's pack on the card, its merge
                 counting each bucket's row pointers, and the copy back),
                 save it under bench_data/torch_smoke/, load it back with
                 mmap; the build's split (walks, keys, sort, merge, the
                 edge arrays' copy back, indptr the pointers' copy)
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
  8. pack       K7 (kernels/csrc/pack.cu) on phase 4's endpoints, walked
                 again: K7-keys, K7-sort and K7-merge each torch.equal to
                 its plain version (index/build.py's *_plain), K7-sort at
                 every digit width and K7-sort and K7-merge to their
                 earlier forms (probes/pack_earlier.cu), the merge's row
                 pointers to with_indptr's; each timed as called and by
                 device time (one profiled pack; one profiled run of the
                 earlier forms and the other widths) beside its bound
                 (the sort's also at 6 passes), its plain version, its
                 earlier form and its library call (torch.sort,
                 unique_consecutive; torch.unique(keys, sorted=True,
                 return_counts=True) for the sort and merge together), the
                 passes K7-sort ran; the copy back pageable and pinned
                 (first use and cached, in turns); the host numpy pack
                 (probes/pack_earlier.py, the form before K7) timed on the
                 same endpoints, both indexes sha256-equal to phase 4's;
                 then the build again with a checkpoint, preempted in its
                 third chunk's walk and resumed: two chunks loaded, the
                 index sha256-equal to phase 4's; K7 in key-range windows:
                 K7-keys' count form (the key space by its top 14 bits)
                 and window form (a window of the plan) torch.equal to
                 their plain versions, each timed as called and by
                 device time beside its bound, and pack_index in 4 forced
                 windows sha256-equal to phase 4's index, its wall beside
                 the pack in one sort
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
                 slices by K6+K4's sharded form, P2, K3's selection) on the
                 same 128 sources at the final delta, once under dense
                 and once under routed (placement seconds, wall,
                 supersteps), routed against dense (values within rtol
                 1e-4, ids outside near-ties), precision@50 of the first
                 32 >= 0.95; K6-demand's list form on the one-shot's
                 own residues (every query, four shards: one launch,
                 each shard torch.equal to the plain demand, timed
                 beside the earlier form a shard and the stack of the
                 totals); K4's sharded form bit-equal to
                 run_walks_philox on a raw level's allocation from the
                 one-shot's residues (its first 16 sources), timed beside
                 K4's unsharded branch on the same starts and its bound;
                 on that allocation K6 (the demand, the lane expansion
                 and the accumulate) against its plain versions and timed
                 (printed; the demand beside its earlier three-launch
                 form), the shards' demands in one launch of the list
                 form, each torch.equal to the plain one (its launch
                 count printed, timed beside the earlier form a shard and
                 the stack of the totals), the chunk's lanes over the
                 shards' demands equal to the
                 concatenation's expansion, the accumulate into the
                 shards' partials held to a float64 sum (k6_accum_check);
                 and K6+K4's sharded form, one launch for the chunk,
                 against that chain (raw_walk_row: endpoints bit-equal to
                 K4's on every lane below its column's demand, no other
                 lane walked, the contribution by f32_gate against the
                 float64 sum of the chain's weights at its endpoints, its
                 counts of adds exact), timed as called and in device
                 time beside the chain's three launches' device time and
                 its bound (raw_walk_bound)
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
                 demand's earlier form (probes/demand_earlier.cu) equal
                 too and timed beside it, the
                 accumulate of K4's endpoints held to a float64 sum
                 (k6_accum_check: each entry's count of adds exact, its
                 error within the bound of any f32 sum of that many
                 positive terms), each timed as called and in
                 device time beside its bound, the plain chain and the
                 library call (torch.cumsum of the int32 omega;
                 scatter_add_ over int64 endpoints); K6+K4 on the same
                 chunk held to that chain and timed as in phase 9;
                 precision@50 of the first 32 against phase 7's exact
                 top-50 (>= 0.95)
  11. montecarlo the first 32 sources through make_montecarlo_fn (2^22
                 walks per query, K6+K4-src once per chunk of the
                 constant plan, source_chunks): wall time, chunks,
                 precision@50 (>= 0.95); then K6+K4-src on that chunk held
                 to the chain K4 -> K6-accum it replaced (endpoints
                 bit-equal on every walk, also to its plain version; the
                 sums by the f32 gate, counts exact) and timed beside it,
                 its plain version and its bound (source_walk_bound),
                 K6-accum there beside its bound and scatter_add_; the
                 same for its hub branch on HubPPR's chunk (phase 3's
                 hub index, the CLI's default pool)
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
                 bit-equal to the in-RAM one; K4-xp (the walks of the
                 build across processes) on that whole build (its
                 chunks of 2^23 walks at seed SEED, one window) over
                 MP_PROCS processes of two shards simulated on the card
                 (probes/index_xp_probe.py::run_build: xp_chunk_rounds
                 over local_exchange), each launch of either form (the
                 own-start form in round 0, the inbox form after it) held
                 to index_walk_xp_plain (counts, each destination's
                 records (w, cur, h | len << 16, 0) as a set, the
                 endpoints), every walk ending in one process where K4's
                 sharded form ends it, its rounds the longest chunk's,
                 timed (as called and in device time) beside K4's
                 sharded form on the same chunks, the earlier per-chunk
                 forms (probes/index_xp_forms.cu, which must be slower)
                 and its bound (K4's walk bound plus 16 bytes a record
                 written and read), and the same on phase 13's weighted
                 graph (alias hops, run inside phase 13); and
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
  17. multiprocess  (run after phase 16) ShardedForaEngine across
                 processes: both sharded stores of phase 1's graph (phase
                 9's layout) and phase 4's index written, and each of
                 MP_PROCS = 2 worker processes on the one card (gloo, both
                 on cuda:0; fora_tpu_torch.parallel.multihost_driver, run
                 with python -m, OMP_NUM_THREADS=4) given only its own 2
                 shards' files; the first MP_SOURCES = 32 of phase 9's
                 sources (all 128 took the phase to 127 s) through phase
                 9's one-process engine (the reference); K6+K4-xp on the
                 raw one-shot's first walk chunk (at SEED)
                 over two processes simulated here (ops.walk's
                 xp_chunk_rounds and local_exchange), each launch of
                 either form (the own-lane form in round 0, the inbox
                 form after it) held to raw_walk_xp_plain (counts, each
                 destination's records (w, cur, h | len << 16, weight)
                 as a set, the endpoints of the walks that end there
                 equal; partials within rtol 1e-4), every endpoint over
                 the rounds K6+K4's sharded form's bit for bit, timed
                 (its launches as called and in device time) beside
                 K6+K4's sharded form on the chunk, the earlier kernel
                 (probes/xp_walk_forms.cu, its own rounds, its endpoints
                 equal too; the redesign must be faster) and its bound
                 (raw_walk_bound plus 16 bytes a record written and
                 read); the same on phase 13's weighted graph (alias
                 hops; run inside phase 13, which builds it); then the
                 workers (every collective on CUDA tensors under gloo),
                 the indexed one-shot (warm, then timed) against the
                 reference under test_torch_sharded.py's rule with equal
                 supersteps, every worker's answer equal, the raw
                 one-shot (warm, then timed; its first chunk's endpoints,
                 gathered from both workers, torch.equal to K6+K4's
                 sharded form's; precision@50 >= 0.95), gather_to_host,
                 the walls, rounds
                 and the records and bytes handed over per round; beside
                 them two NCCL ranks on the one card, refused in
                 multihost.init; in the gloo world also the indexed
                 one-shot with hier (chips_per_host 2: a host is a
                 process; bit-equal to the world's dense one-shot with
                 equal supersteps, against the reference under the same
                 rule) and the refinement pool of the 32 sources as one
                 pool of width 32 (phase 5's defer and stride; warm, then
                 timed) with each of MP_POOL_MODES (dense, compact,
                 routed, hier): every compacted pool bit-equal to the
                 dense one (ids, values, bounds, acceptance, levels and
                 supersteps), the dense pool against phase 15's
                 one-process ShardedTopkRunner on the same sources
                 (pools_agree) and at precision@50 >= 0.95; each run's
                 compaction (L a superstep and one more a push), P3 (L a
                 compacted superstep), clear (one a superstep cleared by
                 rows), P1 hops, K2 and K3 counted against its exchange's
                 counts, some superstep compacted in each compacted run;
                 the walls, supersteps compacted and fallen back, and the
                 rows and bytes across the process boundary per superstep
                 beside the dense exchange's printed; then a world of one
                 process over NCCL holding the four shards: the indexed
                 answer the reference's bit for bit, the raw chunk's
                 endpoints equal again, the routed pool the one-process
                 runner's bit for bit.  Both worlds also build the FORA+
                 index across their processes MP_BUILDS times
                 (multihost_driver's "build" job at phase 4's seed and
                 chunk: each worker generates phase 1's graph, places
                 only its own shards' out-CSR slices and walks with K4-xp
                 over one
                 window of the build's chunks, its records handed over in
                 rounds, one max all-reduce of the endpoints): every
                 worker's arrays equal (sha256) to phase 4's
                 build_walk_index and phase 15's one-process sharded
                 build, in phase 15's rounds over gloo (the longest
                 chunk's) and one over NCCL, the gloo world's first saved
                 as a sharded store from which its indexed one-shot
                 answers as from phase 4's index bit for bit; each
                 build's wall, its split (placing, the launches, the
                 counts' all-gather, the all-to-all, the endpoints'
                 all-reduce, the pack) and the walls' spread, rounds and
                 records per round printed; K4-xp's two forms launched
                 there (the inbox form only where records crossed) and on
                 no path within one process.  A worker
                 that fails or passes MP_WORKER_S is killed and the phase
                 fails
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
  18. bench scale  (run last) the main path at bench.py's own scale:
                 its graph, RMAT 2^22 x 16, seed 7 (made by a process of
                 its own while phases 3-14 run, under
                 bench_data/torch_smoke_big/), merged with the hub split;
                 the index built on the card (one window), saved and
                 loaded back with mmap; bench.py's 512 sources in pools of
                 128, fresh and warm, one warm pass profiled (idle share);
                 precision@50 over bench.py's 128 scored sources against
                 the float64 oracle with its spread and a bootstrap 95%
                 interval, >= 0.95 for the build's seed and one more; then
                 the index at the smallest integer rmax_scale whose walks
                 pass 1.1 x 2^30, packed by K7 on the card in key-range
                 windows (no host pack: each window-form launch a window),
                 its bucket multiplicities equal to its tables', (bucket,
                 dst, src) strictly increasing, its pointers
                 with_indptr's, sha256-equal to the same endpoints packed
                 in windows of half the keys; one pool of 128 queries from
                 it, precision over 32 printed (no gate)
  8. proof       every kernel of each path launched in its run (counts
                 reset just before each run, read just after): K1-K4 in
                 phases 4-5 with two K1 gathers per superstep and one K2
                 launch per level of each batch, K1-K3, P1 and P2 in
                 phase 9's timed run with one K2 launch per shard, P1 at
                 (G-1) G launches per superstep and P2's one pass once
                 (its hop kernel never with every shard on one card),
                 K1, K3 and K6+K4 and no K2 in phase 10, K6+K4-src in
                 phase 11,
                 P3 in phase 12; the demand and K6+K4 (once per walk
                 chunk) in the raw pools (phases 10 and 13) and the raw
                 one-shots (phases 9 and 13, the demand once: every
                 shard's in one launch),
                 and there no K6-expand, K6-accum or K4 launch of their
                 own; K6+K4-src alone in Monte Carlo (phases 11 and 13,
                 once per chunk) and in the CLI's hubppr queries (its
                 pool's K4 launches and its query chunks as its constant
                 plans give them, printed); K6, K6+K4 and K6+K4-src on no
                 other path, K6-expand and K6-accum on none, and no plain
                 version of K6 or K6+K4 in any of those runs nor in any
                 CLI action (``count_plain_k6``); in phase 13 K1-K3 and
                 K4's alias branch (index_walk_alias) in the indexed run,
                 K1, K3 and K6+K4 in the raw pool, K6+K4-src in Monte
                 Carlo, never K4's uniform branch there and never the
                 alias branch before; in phase 14 K4 in build, K1-K3 in
                 batch-topk and in the server (its launch counts printed
                 at SIGTERM), K1 in fwdpush, the K1-back pre-pass, K1 and
                 K4 in bippr, K4 and K6+K4-src in hubppr, K4-hub on no
                 path, and
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
                 K2 and no K4 branch; in the sharded index build K4's
                 sharded form once per 2^23 walks; K4's sharded form on
                 no other path; in phase 16's compacted pushes
                 K5's pre-pass, K5 and K1's gather (the supersteps that
                 fell back), never K1's pre-pass; K1-K3 in the relabelled
                 pool; K5 and its pre-pass on no other path; in phase 17's
                 workers (counts reset just before each timed call, read
                 just after) K1 and K3 per local shard, P1 among the local
                 shards, P2's one pass once in the indexed run, the demand
                 once and both forms of K6+K4-xp in the raw run,
                 K6+K4-xp on no path within one process; K7 in one
                 sort (each of its three wrappers once) in phase 4's
                 build, neither of K7-keys' count and window forms there,
                 and in phase 18's past-2^30 build the count form, the
                 window form, K7-sort and K7-merge once a window, no
                 one-sort K7-keys; and neither
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
15's routed superstep with the routed pool's launches (the compaction,
P3's receive and the clear carry multiprocess_launches, their launches
in phase 17's compacted runs across processes, summed over the
workers); P2 has two:
ring_reduce_scatter_hop is the ring's hop kernel, which no path runs
with every shard on one card (0 launches), reduce_scatter_onepass the
one pass that phase 9 runs; the rows timed on phase 15's superstep,
frontier_compact, row_scatter_add_receive and exchange_clear, also carry
device_ms, the kernel's time with the host's enqueue hidden, beside ms,
which like every ms of the line times the launches as called, and the
clear its library form's device time, library_device_ms;
index_walk_sharded and index_walk_sharded_alias, K4's sharded form on
the raw one-shot's allocation with the sharded index build's launches
(phase 15; no path runs the alias form since K6+K4), carry
unsharded_ms, K4's unsharded branch on the same starts;
frontier_prepass and frontier_push, K5's two launches, phase 16's
superstep at B = 32 with the launches of its compacted pushes, carry
device_ms and earlier_device_ms, the earlier form's device time on the
same state; walk_demand, expand_lanes and accumulate_endpoints, K6, are
phase 10's pool's largest walk phase with phase 10's launches (the
accumulate's Monte Carlo's, phase 11, 0 since K6+K4-src; its montecarlo_*
keys are its time, bound and library call on phase 11's chunk) and carry
device_ms: the demand's bound r's distinct 32-byte sectors read and cum
written once (bytes_bound_ms the byte formula, r's bytes), beside its
earlier three-launch form's earlier_ms and earlier_device_ms on the same
residue, and its sharded_* keys the list form's one launch on phase 9's
one-shot residues, four shards of every query (sharded_earlier_*: the
earlier form a shard and the stack of the totals), the expansion's 8 bytes a lane slot
written and the distinct 32-byte sectors of cum and r at the lanes'
nodes, the accumulate's 8 bytes a lane read and the distinct sectors of
the output it touches, read and written; raw_walk, K6+K4, is the same
walk phase with phase 10's launches, and carries device_ms,
chain_device_ms (the device time of the three launches it replaced on
the same chunk) and sharded_* (its sharded form on phase 9's
allocation), its bound K4's walk bound plus the sectors of cum and r at
the lanes' nodes and of the output, read and written; source_walk,
K6+K4-src, is phase 11's chunk with phase 11's launches, and carries
device_ms, chain_device_ms (K4 and K6-accum on the same chunk), alias_*
(phase 13's weighted chunk) and hub_* (HubPPR's chunk), its bound K4's
walk bound without a start or endpoint array plus the sectors of the
output, read and written); raw_walk_xp, K6+K4-xp, is phase 17's first
raw chunk over two simulated processes (ms its launches as called,
device_ms theirs in device time, plain_ms raw_walk_xp_plain's, its bound
K6+K4's on the chunk's walks plus 16 bytes a record written and read) with
the launches of both its forms in the workers' raw run summed, and carries
forms (each form's launches on the chunk, device ms and walks: the
own-lane form raw_walk_xp, the inbox form raw_walk_xp_inbox),
earlier_device_ms (the earlier kernel on the same chunk),
sharded_device_ms (K6+K4's sharded form on it) and alias_* (the same on
phase 13's weighted graph)); index_walk_xp, K4-xp, is phase 15's whole
index build over two simulated processes (ms, device_ms and plain_ms as
raw_walk_xp's, its bound K4's walk bound on the build's chunks plus 16
bytes a record written and read) with the launches of both its forms in
phase 17's first build across the gloo workers summed, and carries forms
(the own-start form index_walk_xp, the inbox form index_walk_xp_inbox),
rounds, earlier_device_ms and earlier_forms (the earlier per-chunk
forms), sharded_device_ms (K4's sharded form on the same chunks) and
alias_* (phase 13's weighted graph)); pack_key_counts and
pack_keys_window, K7-keys' count and window forms, are phase 8's
(the count over phase 4's endpoints by the top 14 key bits, a window of
4; their bounds the endpoints, offsets and dangling ids read, the bins
or the window's keys written) with the launches of phase 18's past-2^30
build, the window form carrying window_keys, windowed_pack_s (phase 4's
endpoints packed in 4 windows), one_sort_pack_s (phase 8's pack in one
sort) and build_pack_s (phase 4's build's pack)), then,
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
import contextlib
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
PACK_KERNELS = ("pack_keys", "sort_keys", "merge_keys")    # K7, a build's
WINDOW_KERNELS = ("pack_key_counts", "pack_keys_window")    # K7 in windows
CKPT_DIR = ROOT / "bench_data" / "torch_smoke_ckpt"        # phase 8
SHARDED_KERNELS = ("push_prepass", "gather_scatter_add", "index_spmv",
                   "topk_bounds", "ring_all_gather_hop",
                   "reduce_scatter_onepass")
RAW_KERNELS = ("push_prepass", "gather_scatter_add", "raw_walk",
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
    return dict(bound_ms=max(ms, ops_ms), bound_by=by, bytes_ms=ms,
                ops_ms=ops_ms)


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


def build_index(g, dg, rcfg, path=INDEX_DIR, log=None, seed=SEED):
    """The FORA+ index built on the card (K4, then K7's pack) from
    ``seed``, saved under ``path`` and loaded back through mmap; ``log``
    gets the build's split (``split_s``), which is printed."""
    from fora_tpu_torch import index as tidx
    torch_sync()
    t0 = time.perf_counter()
    built = tidx.build_walk_index(dg, rcfg, seed, log=log)
    wall = time.perf_counter() - t0
    walks = int(tidx.index_counts(g.out_deg, rcfg).sum())
    print(f"index: {walks} walks -> {built.total_edges} index edges in "
          f"{wall:.4f} s" + ("" if log is None else "; split, s: " + ", ".join(
              f"{k} {v:.4f}" for k, v in log["split_s"].items())))
    if log is not None:
        log["wall_s"] = wall
    tidx.save(built, rcfg, str(path), graph=g)
    index = tidx.load(str(path), rcfg, graph=g, mmap=True)
    if index.total_edges != built.total_edges:
        fail("index reload: edge count differs")
    return index


def torch_sync() -> None:
    import torch
    torch.cuda.synchronize()


def _device_ms_by(prof: dict, *names) -> float:
    """Device ms of the profiled kernels whose name holds one of
    ``names`` (a template's name with its arguments, ``name<``)."""
    return sum(ms for key, (ms, _) in prof.items()
               if any(n + "(" in key or n + "<" in key or key.endswith(n)
                      for n in names))


def empty_host_cache() -> bool:
    """Release PyTorch's cached pinned host blocks (so that the next
    pinned allocation pays its first use); False where this PyTorch has
    no call for it."""
    import torch
    acc = getattr(torch, "accelerator", None)
    fn = getattr(acc, "empty_host_cache", None) or getattr(
        torch._C, "_host_emptyCache", None)
    if fn is None:
        return False
    fn()
    return True


def copy_back_rows(packed) -> dict:
    """The pack's copy back of ``packed`` (merge_keys' five tensors) to
    the host, seconds: pageable (``.cpu()``, what PR 23 ran) and pinned
    with the pinned blocks' first use (the host cache emptied before) and
    cached, in turns (pageable, first use, cached, cached, first use,
    pageable); each result equal to the pageable copy's."""
    from fora_tpu_torch.index import build as ib
    import numpy as np
    xs = list(packed)
    want = ib.host_arrays(xs, pinned=False)
    times = {"pageable": [], "pinned_first_use": [], "pinned_cached": []}
    isolated = True
    for kind in ("pageable", "pinned_first_use", "pinned_cached",
                 "pinned_cached", "pinned_first_use", "pageable"):
        if kind == "pinned_first_use":
            isolated &= empty_host_cache()
        torch_sync()
        t0 = time.perf_counter()
        got = ib.host_arrays(xs, pinned=kind != "pageable")
        times[kind].append(time.perf_counter() - t0)
        if not all(np.array_equal(a, b) for a, b in zip(got, want)):
            fail(f"the {kind} copy back differs from the pageable one")
        del got
    mb = sum(x.numel() * x.element_size() for x in xs) / 1e6
    print(f"copy back of {mb:.1f} MB, s: " + "; ".join(
        f"{k} {', '.join(f'{v:.4f}' for v in vs)}" for k, vs in times.items())
        + ("" if isolated else " (no call empties the pinned cache here: "
           "first use not isolated)") + f"; the pack copies "
        f"{'pinned' if ib.PINNED_COPY_BACK else 'pageable'}")
    return dict(times, first_use_isolated=isolated, megabytes=mb)


def run_pack(g, dg, rcfg, index, build_log, dev) -> dict:
    """Phase 8: K7 on phase 4's endpoints (walked again by the build's own
    loop, ``index_endpoints``): each kernel torch.equal to its plain
    version and to its earlier form (``probes/pack_earlier.cu``), K7-keys
    with the sort's digit counts (the build's form: equal to the count
    launch's) and without them, K7-sort with those counts handed in and
    without, and at the other digit widths, the merge's row pointers to
    ``with_indptr``'s; each timed as called (``cuda_ms``; K7-sort's as a
    copy of the keys and the sort, less the copy alone) and by device time
    (one profiled pack; one profiled run of K7-keys without the counts and
    the sort with its count launch; one of the earlier forms and the other
    widths), beside its bound (each K7-keys form's by what it reads), its
    plain version, its earlier form and its library call; the copy back
    pageable and pinned; the host numpy pack (the form before K7) on the
    same endpoints; then the build checkpointed, preempted in its third
    chunk's walk and resumed.  Returns K7's kernel rows."""
    import shutil
    import numpy as np
    import torch
    from fora_tpu_torch import index as tidx
    from fora_tpu_torch import kernels
    from fora_tpu_torch.index import build as ib
    from fora_tpu_torch.parallel.multihost_driver import index_digest
    from fora_tpu_torch.probes.pack_earlier import (earlier_merge,
                                                    earlier_pack_keys,
                                                    earlier_sort,
                                                    pack_index_numpy)
    from fora_tpu_torch.utils.timing import cuda_ms, device_ms
    want = index_digest(index)
    ends, counts, deg = ib.index_endpoints(dg, dg, rcfg, SEED, dev)
    t = ib.pack_tables(counts, deg)
    plain_args = (ends, *ib._device_tables(t, dev), t.nb)   # offsets [n], cut
    offsets1, dang = ib._card_tables(t, dev)               # offsets [n + 1]
    keys_args = (ends, offsets1, dang, t.nb)
    L, nb, bits, n = t.keys, t.nb, 2 * t.nb + 4, len(t.counts)
    digits = kernels.sort_digit_bits(bits)
    others = [d for d in kernels.SORT_DIGIT_WIDTHS if d != digits]
    # K7-keys with the sort's digit counts (the build's form), without
    # them, and its earlier form
    totals = kernels.digit_totals(bits, dev)
    keys = kernels.pack_keys(*keys_args, totals=totals)
    if not torch.equal(keys, ib.pack_keys_plain(*plain_args)):
        fail("K7-keys differs from pack_keys_plain")
    if not torch.equal(kernels.pack_keys(*keys_args), keys):
        fail("K7-keys without the digit counts differs from with them")
    if not torch.equal(earlier_pack_keys(*plain_args), keys):
        fail("K7-keys differs from its earlier form")
    if not torch.equal(totals, kernels.digit_counts(keys, bits)):
        fail("K7-keys' digit counts differ from K7-sort's count launch's")
    # K7-sort (in place between two buffers, so each timed call sorts a
    # fresh copy of the keys) with K7-keys' counts handed in and without,
    # at every digit width, and its earlier form
    work, alt = keys.clone(), torch.empty_like(keys)
    ordered = kernels.sort_keys(work, alt, bits, totals=totals)
    passes = kernels.sort_keys.last_passes
    sorted_p = ib.sort_keys_plain(keys)
    if not torch.equal(ordered, sorted_p):
        fail("K7-sort differs from sort_keys_plain")
    counted = kernels.sort_keys(keys.clone(), torch.empty_like(keys), bits)
    if not torch.equal(counted, sorted_p):
        fail("K7-sort with its own count launch differs from "
             "sort_keys_plain")
    del counted
    spare = alt if ordered is work else work
    # w2 and a2 take every later sort, so ordered and spare stay as they are
    w2, a2 = keys.clone(), torch.empty_like(keys)
    width_passes = {digits: passes}
    for d in others:
        if not torch.equal(kernels.sort_keys(w2.copy_(keys), a2, bits,
                                             digit_bits=d), sorted_p):
            fail(f"K7-sort at {d}-bit digits differs from sort_keys_plain")
        width_passes[d] = kernels.sort_keys.last_passes
    old_sorted, old_passes = earlier_sort(w2.copy_(keys), a2, bits)
    if not torch.equal(old_sorted, sorted_p):
        fail("K7-sort's earlier form differs from sort_keys_plain")
    # K7-merge, and its row pointers against with_indptr's
    merged = kernels.merge_keys(ordered, nb, n)
    for a, b, what in zip(merged, ib.merge_keys_plain(sorted_p, nb, n),
                          ("edge_src", "edge_dst", "edge_mult",
                           "bucket_counts", "indptr")):
        if not torch.equal(a, b):
            fail(f"K7-merge's {what} differs from merge_keys_plain")
    for a, b, what in zip(merged, earlier_merge(ordered, spare, nb),
                          ("edge_src", "edge_dst", "edge_mult",
                           "bucket_counts")):
        if not torch.equal(a, b):
            fail(f"K7-merge's {what} differs from its earlier form's")
    U = merged[0].numel()
    off = np.zeros(ib.NUM_BUCKETS + 1, np.int64)
    np.cumsum(merged[3].cpu().numpy(), out=off[1:])
    host_ptr = merged[4].cpu().numpy()
    ref_ptr = ib.with_indptr(ib.WalkIndex(
        edge_src=merged[0].cpu().numpy(), edge_dst=merged[1].cpu().numpy(),
        bucket_offsets=off, counts_cum=t.counts_cum, omega_unit_built=1.0,
        rmax_built=1.0)).dst_indptr
    if not all(np.array_equal(host_ptr[q], r) if r is not None
               else not host_ptr[q].any() for q, r in enumerate(ref_ptr)):
        fail("K7-merge's row pointers differ from with_indptr's")
    print(f"K7: {t.total} endpoints + {len(t.dang)} dangling self-edges -> "
          f"{L} keys of {bits} bits, sort passes run at each digit width "
          f"(of those its bits make; the others' digit the same in every "
          f"key): " + ", ".join(f"{d} bits {p} of {-(-bits // d)}"
                               for d, p in width_passes.items())
          + f"; {U} unique edges, pointers [8, {n + 1}]; "
          f"each kernel torch.equal to its plain version and its earlier "
          f"form, K7-keys with and without the digit counts (equal to the "
          f"count launch's), K7-sort with them handed in and without, the "
          f"pointers to with_indptr's")

    def sort_k(d=digits, handed=True):
        w2.copy_(keys)
        kernels.sort_keys(w2, a2, bits, digit_bits=d,
                          totals=totals if handed and d == digits else None)

    def sort_old():
        w2.copy_(keys)
        earlier_sort(w2, a2, bits)
    copy_ms = cuda_ms(lambda: w2.copy_(keys))
    ptr_bytes = 4 * ib.NUM_BUCKETS * (n + 1)
    rows = {
        "pack_keys": dict(
            ms=cuda_ms(lambda: kernels.pack_keys(*keys_args, totals=totals)),
            device_ms=device_ms(lambda: kernels.pack_keys(*keys_args,
                                                          totals=totals)),
            unfused_ms=cuda_ms(lambda: kernels.pack_keys(*keys_args)),
            unfused_device_ms=device_ms(lambda: kernels.pack_keys(
                *keys_args)),
            earlier_ms=cuda_ms(lambda: earlier_pack_keys(*plain_args)),
            earlier_device_ms=device_ms(lambda: earlier_pack_keys(
                *plain_args)),
            plain_ms=cuda_ms(lambda: ib.pack_keys_plain(*plain_args),
                             iters=3),
            library_ms=None,
            # the earlier form read the host's cut table too
            earlier_bound_ms=bound(nbytes(*plain_args[:4]) + 8 * L)[
                "bound_ms"],
            # the endpoints, the [n + 1] offsets and the dangling ids read,
            # the keys written (the digit counts: a few KB)
            **bound(nbytes(ends, offsets1, dang) + 8 * L)),
        "sort_keys": dict(
            ms=cuda_ms(sort_k) - copy_ms,
            counted_ms=cuda_ms(lambda: sort_k(handed=False)) - copy_ms,
            digit_bits=digits,
            width_ms={d: cuda_ms(lambda d=d: sort_k(d)) - copy_ms
                      for d in others},
            earlier_ms=cuda_ms(sort_old) - copy_ms,
            plain_ms=cuda_ms(lambda: ib.sort_keys_plain(keys), iters=3),
            library_ms=cuda_ms(lambda: torch.sort(keys), iters=3),
            unique_ms=cuda_ms(lambda: torch.unique(
                keys, sorted=True, return_counts=True), iters=3),
            passes=passes, width_passes=width_passes,
            # each pass run reads and writes every key; PR 23's form, at
            # 6 passes, beside it
            bound_6_passes_ms=bound(16 * L * 6)["bound_ms"],
            **bound(16 * L * passes)),
        "merge_keys": dict(
            ms=cuda_ms(lambda: kernels.merge_keys(ordered, nb, n)),
            earlier_ms=cuda_ms(lambda: earlier_merge(ordered, spare, nb)),
            plain_ms=cuda_ms(lambda: ib.merge_keys_plain(ordered, nb, n),
                             iters=3),
            library_ms=cuda_ms(lambda: torch.unique_consecutive(
                ordered, return_counts=True), iters=3),
            # the sorted keys read, src, dst and mult of each unique edge,
            # the bucket counts and the buckets' row pointers written
            **bound(8 * L + 12 * U + 64 + ptr_bytes)),
    }
    for r in rows.values():
        r["max_abs_err"] = 0.0
    rows["pack_keys"]["copy_back_s"] = copy_back_rows(merged)
    # one pack on the card, profiled: each kernel's device time; then the
    # earlier forms and the other digit width, profiled
    copy = ends.clone()
    prof = profile_once("pack", lambda: ib.pack_index(
        copy, counts, deg, rcfg, free_endpoints=True), need_trace=False)
    if not prof:
        print("K7: no profiler trace; device times not measured")

    def unfused():
        kernels.pack_keys(*keys_args)
        sort_k(handed=False)
    prof_unfused = profile_once("pack_unfused", unfused, need_trace=False)

    def earlier_and_widths():
        earlier_pack_keys(*plain_args)
        sort_old()
        earlier_merge(ordered, spare, nb)
        for d in others:
            sort_k(d)
    prof_old = profile_once("pack_earlier", earlier_and_widths,
                            need_trace=False)
    sort_names = ("radix_histogram_kernel", "onesweep_kernel")
    rows["sort_keys"]["device_ms"] = None if not prof else _device_ms_by(
        prof, *sort_names)
    rows["sort_keys"]["device_split_ms"] = {
        k: _device_ms_by(prof, k) for k in sort_names}
    rows["sort_keys"]["counted_device_ms"] = (
        None if not prof_unfused else _device_ms_by(prof_unfused,
                                                    *sort_names))
    rows["sort_keys"]["count_device_ms"] = (
        None if not prof_unfused else _device_ms_by(
            prof_unfused, f"radix_histogram_kernel<{digits}>"))
    rows["sort_keys"]["width_device_ms"] = {
        d: None if not prof_old else _device_ms_by(
            prof_old, f"radix_histogram_kernel<{d}>", f"onesweep_kernel<{d}>")
        for d in others}
    rows["sort_keys"]["earlier_device_ms"] = None if not prof_old else (
        _device_ms_by(prof_old, "radix_totals_kernel", "radix_hist_kernel",
                      "radix_scan_kernel", "radix_scatter_kernel"))
    rows["merge_keys"]["device_ms"] = None if not prof else _device_ms_by(
        prof, "merge_kernel", "merge_pointers_kernel")
    rows["merge_keys"]["device_split_ms"] = {
        k: _device_ms_by(prof, k)
        for k in ("merge_kernel", "merge_pointers_kernel")}
    rows["merge_keys"]["earlier_device_ms"] = None if not prof_old else (
        _device_ms_by(prof_old, "merge_count_kernel", "merge_scan_kernel",
                      "merge_write_kernel", "merge_mult_kernel"))
    rows["pack_keys"]["profiled_device_ms"] = _device_ms_by(
        prof, "pack_keys_kernel")
    rows["pack_keys"]["profiled_unfused_device_ms"] = _device_ms_by(
        prof_unfused, "pack_keys_kernel")
    rows["pack_keys"]["profiled_earlier_device_ms"] = _device_ms_by(
        prof_old, "pack_keys_earlier_kernel")

    def fmt(x):
        return "not measured" if x is None else f"{x:.4f}"
    for name, r in rows.items():
        dms, lib = r["device_ms"], r["library_ms"]
        print(f"{name}: {r['ms']:.4f} ms as called, {fmt(dms)} device"
              + (f" ({', '.join(f'{k} {v:.4f}' for k, v in r['device_split_ms'].items())})"
                 if "device_split_ms" in r else "")
              + f", bound {r['bound_ms']:.4f} by {r['bound_by']}, plain "
              f"{r['plain_ms']:.4f}, library "
              f"{'none' if lib is None else f'{lib:.4f}'}"
              + (f"; earlier form {r['earlier_ms']:.4f} as called, "
                 f"{fmt(r['earlier_device_ms'])} device"
                 if "earlier_ms" in r else ""))
    r = rows["sort_keys"]
    both = rows["sort_keys"]["ms"] + rows["merge_keys"]["ms"]
    print("sort_keys at the other digit widths: " + "; ".join(
        f"{d} bits {r['width_ms'][d]:.4f} ms as called, "
        f"{fmt(r['width_device_ms'][d])} device, {width_passes[d]} passes"
        for d in others)
          + f"; at {digits}: {r['ms']:.4f}, {passes} passes; bound at 6 "
          f"passes {r['bound_6_passes_ms']:.4f}; the sort and the merge "
          f"{both:.4f} ms against torch.unique(keys, sorted=True, "
          f"return_counts=True) {r['unique_ms']:.4f}")
    k = rows["pack_keys"]
    fused, apart = k["profiled_device_ms"], (
        k["profiled_unfused_device_ms"] + (r["count_device_ms"] or 0.0))
    print(f"K7-keys by device time: with the digit counts (the build's "
          f"form) {k['device_ms']:.4f} ms (profiled {fused:.4f}), without "
          f"{k['unfused_device_ms']:.4f} (profiled "
          f"{k['profiled_unfused_device_ms']:.4f}), the earlier form "
          f"{k['earlier_device_ms']:.4f} (profiled "
          f"{k['profiled_earlier_device_ms']:.4f}); bound "
          f"{k['bound_ms']:.4f} by {k['bound_by']} (the earlier form's, "
          f"with the cut table, {k['earlier_bound_ms']:.4f}); profiled, the "
          f"counts in K7-keys {fused:.4f} against K7-keys without them and "
          f"the sort's count launch {apart:.4f} "
          f"({fmt(r['count_device_ms'])}); K7-sort with the counts handed "
          f"in {r['ms']:.4f} ms as called, {fmt(r['device_ms'])} device, "
          f"with its own count launch {r['counted_ms']:.4f}, "
          f"{fmt(r['counted_device_ms'])}")
    del keys, work, alt, ordered, spare, merged, sorted_p, copy, w2, a2
    del old_sorted, totals
    # the whole pack on the card as the build calls it, and the host numpy
    # pack (the form before K7) on the same endpoints
    torch_sync()
    t0 = time.perf_counter()
    card = ib.pack_index(ends.clone(), counts, deg, rcfg, free_endpoints=True)
    card_s = time.perf_counter() - t0
    ends_h = ends.cpu().numpy()
    t0 = time.perf_counter()
    host = pack_index_numpy(ends_h, counts, deg, rcfg)
    host_s = time.perf_counter() - t0
    if index_digest(card) != want or index_digest(host) != want:
        fail("K7's or the host numpy pack's index differs from phase 4's")
    print(f"pack: on the card (K7 and the copy back of the arrays and "
          f"pointers) "
          f"{card_s:.4f} s; the host numpy pack (probes/pack_earlier.py) "
          f"{host_s:.4f} s on the same endpoints; both sha256-equal to "
          f"phase 4's index; phase 4's build {build_log['wall_s']:.4f} s, "
          f"split, s: " + ", ".join(f"{k} {v:.4f}" for k, v
                                    in build_log["split_s"].items())
          + f" (keys: the tables' upload and K7-keys, "
          f"{build_log['split_s']['keys']:.4f})")
    rows["pack_keys"].update(host_numpy_pack_s=host_s, card_pack_s=card_s,
                             build_keys_s=build_log["split_s"]["keys"])
    del card, host, ends_h
    rows.update(run_pack_windows(ends, counts, deg, rcfg, index, want,
                                 card_s, build_log, dev))
    del ends
    # the build checkpointed, preempted in the third chunk's walk, resumed
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    real, calls = ib.walk_endpoints, [0]

    def preempted(*a, **kw):
        calls[0] += 1
        if calls[0] == 3:
            raise RuntimeError("preempted")
        return real(*a, **kw)
    ib.walk_endpoints = preempted
    try:
        tidx.build_walk_index(dg, rcfg, SEED, checkpoint_dir=str(CKPT_DIR))
        fail("the preempted build did not stop")
    except RuntimeError as e:
        if "preempted" not in str(e):
            raise
    finally:
        ib.walk_endpoints = real
    files = sorted(p.name for p in CKPT_DIR.glob("chunk_*.npy"))
    seen = []
    torch_sync()
    t0 = time.perf_counter()
    resumed = tidx.build_walk_index(
        dg, rcfg, SEED, checkpoint_dir=str(CKPT_DIR),
        progress=lambda i, n, cached: seen.append(cached))
    resumed_s = time.perf_counter() - t0
    if files != ["chunk_000000.npy", "chunk_000001.npy"] or \
            seen != [True, True] + [False] * (len(seen) - 2) or \
            index_digest(resumed) != want:
        fail(f"checkpointed build: files {files} after the preemption, "
             f"chunks cached {seen}, or the resumed index differs from "
             f"phase 4's")
    shutil.rmtree(CKPT_DIR)
    print(f"checkpointed build: preempted in chunk 2's walk with {files} "
          f"saved; resumed in {resumed_s:.4f} s (chunks cached {seen}), "
          f"sha256-equal to phase 4's index")
    return rows


PACK_WINDOWS = 4                    # phase 8: phase 4's pack in 4 windows


@contextlib.contextmanager
def sort_cap(keys: int):
    """K7-sort's key limit (``kernels.SORT_MAX_KEYS``, which the pack reads
    at each call) lowered to ``keys``: a pack of more keys goes in
    key-range windows of at most ``keys``."""
    from fora_tpu_torch import kernels
    saved = kernels.SORT_MAX_KEYS
    kernels.SORT_MAX_KEYS = keys
    try:
        yield
    finally:
        kernels.SORT_MAX_KEYS = saved


def run_pack_windows(ends, counts, deg, rcfg, index, want, card_s,
                     build_log, dev) -> dict:
    """Phase 8, K7 in key-range windows: K7-keys' count form (the whole key
    space by its top 14 bits) and window form (a window of the plan) on
    phase 4's endpoints, torch.equal to their plain versions (the window's
    keys as a multiset, its digit counts to the count launch's), each timed
    as called and by device time (the window form, which synchronises once
    to check its count, from a profile of ten calls) beside its bound;
    then ``pack_index`` in PACK_WINDOWS forced windows, sha256-equal to
    phase 4's index (its pointers too), its wall beside the pack in one
    sort (``card_s``, phase 8's, and phase 4's build's pack, all of
    ``build_log``'s split but the walk).  Returns the two forms' kernel
    rows."""
    import numpy as np
    import torch
    from fora_tpu_torch import kernels
    from fora_tpu_torch.index import build as ib
    from fora_tpu_torch.parallel.multihost_driver import index_digest
    from fora_tpu_torch.utils.timing import cuda_ms, device_ms
    t = ib.pack_tables(counts, deg)
    bits = 2 * t.nb + 4
    top = max(bits - 14, 0)
    plain_args = (ends, *ib._device_tables(t, dev), t.nb)
    keys_args = (ends, *ib._card_tables(t, dev), t.nb)
    plain = ib.pack_keys_plain(*plain_args)
    span = (0, 1 << bits, top)
    bins = kernels.pack_key_counts(*keys_args, *span)
    if not torch.equal(bins, ib.pack_key_counts_plain(plain, *span)):
        fail("K7-keys' count form differs from its plain version")
    cap = (t.keys - 1) // (PACK_WINDOWS - 1)
    plan = ib.plan_windows(lambda lo, hi, sh: kernels.pack_key_counts(
        *keys_args, lo, hi, sh).cpu().numpy(), t.nb, cap)
    lo, hi, length = plan[1]
    totals = kernels.digit_totals(bits, dev)
    wkeys = kernels.pack_keys_window(*keys_args, lo, hi, length,
                                     totals=totals)
    wplain = ib.pack_keys_window_plain(plain, lo, hi)
    if not torch.equal(torch.sort(wkeys).values, torch.sort(wplain).values) \
            or not torch.equal(totals, kernels.digit_counts(wkeys, bits)):
        fail("K7-keys' window form differs from its plain version")
    del plain, wplain
    window = lambda: kernels.pack_keys_window(  # noqa: E731
        *keys_args, lo, hi, length, totals=totals)
    prof = profile_once("pack_window_form", lambda: [window()
                                                     for _ in range(10)],
                        need_trace=False)
    # each reads the endpoints, the [n + 1] offsets and the dangling ids;
    # the count form writes its 2^14 bins, the window form its keys
    rows = {
        "pack_key_counts": dict(
            ms=cuda_ms(lambda: kernels.pack_key_counts(*keys_args, *span)),
            device_ms=device_ms(lambda: kernels.pack_key_counts(*keys_args,
                                                                *span)),
            plain_ms=cuda_ms(lambda: ib.pack_key_counts_plain(
                ib.pack_keys_plain(*plain_args), *span), iters=3),
            library_ms=None, max_abs_err=0.0,
            **bound(nbytes(*keys_args[:3]) + nbytes(bins))),
        "pack_keys_window": dict(
            ms=cuda_ms(window),
            device_ms=(_device_ms_by(prof, "pack_keys_kernel<9, 2>",
                                     "pack_keys_kernel<8, 2>") / 10
                       if prof else 0.0) or None,
            plain_ms=cuda_ms(lambda: ib.pack_keys_window_plain(
                ib.pack_keys_plain(*plain_args), lo, hi), iters=3),
            library_ms=None, max_abs_err=0.0, window_keys=length,
            **bound(nbytes(*keys_args[:3]) + 8 * length)),
    }
    del wkeys, totals, keys_args, plain_args
    log = {}
    torch_sync()
    t0 = time.perf_counter()
    with sort_cap(cap):
        win = ib.pack_index(ends.clone(), counts, deg, rcfg,
                            free_endpoints=True, log=log)
    win_s = time.perf_counter() - t0
    if log["windows"] != PACK_WINDOWS or index_digest(win) != want or any(
            (a is None) != (b is None) or (a is not None and
                                           not np.array_equal(a, b))
            for a, b in zip(win.dst_indptr, index.dst_indptr)):
        fail(f"K7 in {log['windows']} windows: the index differs from phase "
             f"4's")
    build_pack_s = sum(v for k, v in build_log["split_s"].items()
                       if k != "walk")
    rows["pack_keys_window"].update(windowed_pack_s=win_s,
                                    one_sort_pack_s=card_s,
                                    build_pack_s=build_pack_s)

    def fmt(x):
        return "not measured" if x is None else f"{x:.4f}"
    for name, r in rows.items():
        print(f"{name}: {r['ms']:.4f} ms as called, {fmt(r['device_ms'])} "
              f"device, bound {r['bound_ms']:.4f} by {r['bound_by']}, plain "
              f"{r['plain_ms']:.4f}, library none")
    print(f"K7 in {PACK_WINDOWS} key-range windows of at most {cap} keys "
          f"({[w[2] for w in plan]}): {win_s:.4f} s (the pack in one sort "
          f"{card_s:.4f} s; phase 4's build's pack {build_pack_s:.4f} s); "
          f"split, s: " + ", ".join(
              f"{k} {v:.4f}" for k, v in log["split_s"].items())
          + "; sha256-equal to phase 4's index, the pointers equal; the "
          "count form and the window form torch.equal to their plain "
          "versions")
    return rows


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
    """bench.py's query phase (``runner.query_pools``): pools of ``pool``
    through query_pool, then flush_deferred.  Returns ({source: top-k
    ids}, accepted, levels used, wall seconds, every level record);
    ``values``, a dict, gets each source's top-k values."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, stats = runner.query_pools(sources, batch=batch, pool=pool,
                                    defer_below=defer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_flush = int(res.deferred.sum())
    for st in stats:
        where = (f"pool {st['pool']}" if st["pool"] != "flush" else
                 f"flush({n_flush})")
        log(level_line(where, st, runner))
    results = {int(s): res.node_ids[i] for i, s in enumerate(sources)}
    if values is not None:
        values.update((int(s), res.values[i]) for i, s in enumerate(sources))
    return (results, int(res.accepted.sum()), res.levels_used, wall,
            stats)


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
    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    # a kernel's record may come back typed as the host's: a record with
    # device time and no host time is the device's all the same
    kernels = [e for e in ka if e.device_type == DeviceType.CUDA or (
        e.self_cpu_time_total == 0 and dev_us(e) > 0)]
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
            "accumulate_chunk_endpoints_plain", "raw_walk_chunk_plain",
            "raw_walk_xp_plain", "source_walk_chunk_plain")
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
    """K6-demand on ``r``: cum and total torch.equal to the plain chain's
    (and the earlier three-launch form's, probes/demand_earlier.cu, to
    both); timed as called and in device time beside that earlier form
    on the same residue, its bound (r's distinct 32-byte sectors read
    once, cum and total written once; ``bytes_bound_ms`` the byte formula,
    r's bytes in place of its sectors), the plain chain and torch.cumsum
    of the [B, n] int32 omega (the scan alone).  Returns (row, kernel
    demand, plain demand)."""
    import numpy as np
    import torch
    from fora_tpu_torch.ops import walk
    from fora_tpu_torch.probes import demand_probe
    from fora_tpu_torch.utils.timing import cuda_ms, device_ms
    d = walk.walk_demand(r, omega)
    dp = walk.walk_demand_plain(r, omega)
    if not (torch.equal(d.cum, dp.cum) and torch.equal(d.total, dp.total)):
        fail("K6-demand: cum or total differs from the plain version's")
    lib = demand_probe.load_earlier()
    unit = float(np.float32(omega))
    e_cum, e_total = demand_probe.earlier_demand(lib, r, unit)
    if not (torch.equal(e_cum, dp.cum) and torch.equal(e_total, dp.total)):
        fail("K6-demand's earlier form differs from the plain version")
    del e_cum, e_total
    om_t = dp.omega_v.T.contiguous()
    b = demand_probe.bounds([r])
    row = dict(max_abs_err=0.0,
               ms=cuda_ms(lambda: walk.walk_demand(r, omega)),
               device_ms=device_ms(lambda: walk.walk_demand(r, omega)),
               earlier_ms=cuda_ms(
                   lambda: demand_probe.earlier_demand(lib, r, unit)),
               earlier_device_ms=device_ms(
                   lambda: demand_probe.earlier_demand(lib, r, unit)),
               plain_ms=cuda_ms(lambda: walk.walk_demand_plain(r, omega),
                                iters=3),
               library_ms=cuda_ms(lambda: torch.cumsum(
                   om_t, dim=1, dtype=torch.int32)),
               bound_ms=b["bound_ms"], bound_by="bytes",
               bytes_bound_ms=b["bytes_bound_ms"])
    return row, d, dp


def demand_list_check(rs, omega, label) -> dict:
    """K6-demand's list form on the shards' residues ``rs`` as the sharded
    walk phase calls it (ops.walk.walk_demands): one launch (it fails
    otherwise), each shard's cum and total torch.equal to its plain
    demand; timed (device and as called) beside the earlier form a shard
    and the stack of the totals, what the phase ran before.  Returns
    {"ms", "device_ms", "earlier_ms", "earlier_device_ms", "bound_ms",
    "launches"}."""
    import numpy as np
    import torch
    from fora_tpu_torch import kernels
    from fora_tpu_torch.ops import walk
    from fora_tpu_torch.probes import demand_probe
    from fora_tpu_torch.utils.timing import cuda_ms, device_ms
    k = kernels.walk_demand.launches
    ds, total = walk.walk_demands(rs, omega)
    launched = kernels.walk_demand.launches - k
    for h, (x, dh) in enumerate(zip(rs, ds)):
        want = walk.walk_demand_plain(x, omega)
        if not (torch.equal(dh.cum, want.cum)
                and torch.equal(dh.total, want.total)
                and torch.equal(total[h], want.total)):
            fail(f"K6-demand's list form: shard {h}'s cum or total differs "
                 f"from the plain version's ({label})")
    if launched != 1:
        fail(f"K6-demand's list form: {launched} launches for {len(rs)} "
             f"shards, expected 1 ({label})")
    lib = demand_probe.load_earlier()
    unit = float(np.float32(omega))
    out = dict(ms=cuda_ms(lambda: walk.walk_demands(rs, omega)),
               device_ms=device_ms(lambda: walk.walk_demands(rs, omega)),
               earlier_ms=cuda_ms(
                   lambda: demand_probe.earlier_shards(lib, rs, unit)),
               earlier_device_ms=device_ms(
                   lambda: demand_probe.earlier_shards(lib, rs, unit)),
               bound_ms=demand_probe.bounds(rs)["bound_ms"],
               launches=launched)
    print(f"K6-demand's list form ({label}): {len(rs)} shards' demands in "
          f"{launched} launch, each torch.equal to its plain demand; "
          f"{out['ms']:.4f} ms as called, {out['device_ms']:.4f} device, "
          f"against the earlier form a shard and the stack of the totals "
          f"({3 * len(rs)} launches) {out['earlier_ms']:.4f} as called, "
          f"{out['earlier_device_ms']:.4f} device; bound "
          f"{out['bound_ms']:.4f} ms by bytes")
    return out


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
    to the float64 plain sum by f32_gate (the lanes' weights replaced by
    1.0s give each entry's count of adds).  Returns the max abs error."""
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
    del ones
    err = f32_gate(f"K6-accum ({label})", got, want, cnt, cnt64)
    plain32 = run(weight, torch.float32, True).double()

    def rel(x):
        return float(((x - want).abs() / want.clamp_min(1e-30)).max())
    print(f"K6-accum ({label}): counts exact, every entry within the f32 "
          f"summation bound; max rel err {rel(got.double()):.2e} "
          f"(scatter_add_ in f32 on the same device: {rel(plain32):.2e}), "
          f"max adds to one entry {int(cnt64.max())}")
    return err


def f32_gate(label, got, want, cnt, cnt64) -> float:
    """A kernel's f32 sums ``got`` held to the float64 sums ``want`` of
    the same terms: every entry's count of non-zero terms, summed by the
    kernel as 1.0s in f32 (``cnt``), equals the float64 count ``cnt64``
    exactly (integers below 2^24: no term lost, added twice or sent to
    another entry), and every entry's error is within the bound of any
    f32 sum of N positive terms in any order, |got - sum| <= gamma(N - 1)
    sum, gamma(k) = k u / (1 - k u), u = 2^-24 (atomics add in no fixed
    order, and a walk's source takes tens of thousands of equal weights,
    whose roundings do not cancel).  Returns the max abs error."""
    import torch
    if not torch.equal(cnt.double(), cnt64):
        fail(f"{label}: {int((cnt.double() != cnt64).sum())} entries count "
             "other terms than the float64 sum")
    u = 2.0 ** -24
    k = (cnt64 - 1).clamp_min(0) * u
    err = (got.double() - want).abs()
    bad = err > k / (1 - k) * want
    if bool(bad.any()):
        first = tuple(bad.nonzero()[0].tolist())
        fail(f"{label}: {int(bad.sum())} entries beyond the f32 summation "
             f"bound (first at {first}: {float(got[first]):.7e} vs "
             f"{float(want[first]):.7e} over {int(cnt64[first])} adds)")
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
    earlier = (f"; earlier form {row['earlier_ms']:.4f} ms as called, "
               f"device {row['earlier_device_ms']:.4f}"
               if "earlier_ms" in row else "")
    formula = (f"; the byte formula's bound {row['bytes_bound_ms']:.4f} ms"
               if "bytes_bound_ms" in row else "")
    print(f"{name} ({label}): {row['ms']:.4f} ms as called, device "
          f"{row['device_ms']:.4f}{earlier}; plain {row['plain_ms']:.4f} "
          f"ms{lib}; bound {row['bound_ms']:.4f} ms by {row['bound_by']} "
          f"({row['bound_ms'] / row['device_ms']:.0%} of it reached, "
          f"device){formula}")


def demand_sectors(rs, omegas) -> int:
    """Distinct 32-byte sectors of each shard's cum (at v and v - 1, its
    [Bc, n] layout) and r (at v) over the nodes v that own lanes
    (omega_v > 0): what a chunk's lanes must read to find their start
    and weight, each once."""
    import torch
    total = 0
    for r, om in zip(rs, omegas):
        v, b = torch.nonzero(om > 0, as_tuple=True)
        n = r.shape[0]
        total += sectors(torch.cat([b * n + v, b * n + (v - 1).clamp_min(0)]))
        total += sectors(v * r.stride(0) + b)
    return total


def raw_walk_row(label, launch, fresh, ones, chain, chain_ends, weight,
                 valid, plain, plain_weight, bound, shard=None) -> dict:
    """K6+K4 on a chunk against the chain that ran before it on the same
    chunk and against its plain version.  ``launch(outs, ends)`` is one
    K6+K4 launch into the chunk's outputs (``fresh()`` zeroed ones, a
    list), ``ones(outs)`` the same launch on residues replaced by their
    omega_v (every weight 1.0, so each entry sums its count of adds);
    ``chain`` maps the chain's three launches (K6-expand, K4, K6-accum) to
    functions, ``chain_ends`` and ``weight`` are its [W, Bc] endpoints and
    weights, ``valid`` the lanes below their column's demand, ``shard``
    (sharded) each lane's shard; ``plain(outs, ends)`` runs
    raw_walk_chunk_plain on the same chunk (searchsorted starts,
    run_walks_philox, scatter_add_), ``plain_weight`` its lanes' weights
    (expand_chunk_lanes_plain's).  The gates: K6+K4's endpoints (its
    ``ends`` output) equal the chain's and the plain version's on every
    valid lane and it walks no other lane; its contribution passes
    f32_gate against the float64 sum of the chain's weights at the chain's
    endpoints and against that of the plain version's weights at its
    endpoints, its counts exact.  Timed as called and in device time
    beside the chain's launches' device times and their sum, the plain
    version and ``bound`` (raw_walk_bound's); no library call walks
    (null)."""
    import torch
    from fora_tpu_torch.utils.timing import cuda_ms, device_ms
    W, Bc = chain_ends.shape
    dev = chain_ends.device
    ends = torch.full((W, Bc), -1, dtype=torch.int32, device=dev)
    outs = fresh()
    launch(outs, ends)
    got = torch.stack(outs)
    G = len(outs)
    n = outs[0].shape[0]
    pends = torch.full_like(ends, -1)
    plain(fresh(), pends)
    for name, want_ends in (("the chain", chain_ends),
                            ("the plain version", pends)):
        differ = int((ends[valid] != want_ends[valid]).sum())
        extra = int((ends[~valid] != -1).sum())
        if differ or extra:
            fail(f"K6+K4 ({label}): {differ} of {int(valid.sum())} endpoints "
                 f"differ from {name}'s, {extra} lanes past the demand "
                 "walked")
    if bool((pends[~valid] != -1).any()):
        fail(f"raw_walk_chunk_plain ({label}): an endpoint kept for a lane "
             "past the demand")
    del ends
    cols = torch.arange(Bc, device=dev)[None, :]

    def sums64(e, w):
        """The float64 sums of ``w`` at ``e`` on the valid lanes, and the
        counts of their terms, [G, n, Bc]."""
        flat = torch.where(valid, e, 0).long() * Bc + cols
        if shard is not None:
            flat += shard * (n * Bc)
        flat = flat[valid]
        want = torch.zeros(G * n * Bc, dtype=torch.float64, device=dev)
        want.index_add_(0, flat, w[valid].double())
        cnt64 = torch.zeros_like(want)
        cnt64.index_add_(0, flat, torch.ones(flat.shape[0],
                                             dtype=torch.float64, device=dev))
        return want.view(G, n, Bc), cnt64.view(G, n, Bc)
    c = fresh()
    ones(c)
    cnt = torch.stack(c)
    del c
    err = 0.0
    for name, (e, w) in (("the chain", (chain_ends, weight)),
                         ("the plain version", (pends, plain_weight))):
        want, cnt64 = sums64(e, w)
        err = max(err, f32_gate(f"K6+K4 ({label}) against {name}", got,
                                want, cnt, cnt64))
        del want, cnt64
    del cnt, got, pends
    outs = fresh()
    row = dict(max_abs_err=err,
               ms=cuda_ms(lambda: launch(outs, None)),
               device_ms=device_ms(lambda: launch(outs, None)),
               plain_ms=cuda_ms(lambda: plain(outs, None), iters=1,
                                warmup=1),
               library_ms=None, **bound)
    parts = {k: device_ms(f) for k, f in chain.items()}
    row["chain_device_ms"] = sum(parts.values())
    print(f"K6+K4 ({label}): endpoints bit-equal to the chain's and the "
          f"plain version's on {int(valid.sum())} walked lanes, none past the "
          f"demand; counts exact, every entry within the f32 summation bound "
          f"of both float64 sums (max abs err {err:.3e}); {row['ms']:.4f} ms "
          f"as called, device {row['device_ms']:.4f}; the chain "
          f"{row['chain_device_ms']:.4f} ms device (" + ", ".join(
              f"{k} {v:.4f}" for k, v in parts.items())
          + f"); plain {row['plain_ms']:.4f} ms; bound "
          f"{row['bound_ms']:.4f} ms by {row['bound_by']} "
          f"({row['bound_ms'] / row['device_ms']:.0%} of it reached, "
          "device)")
    return row


def raw_walk_bound(graph, starts, rcfg, demand_sectors_, out_sectors,
                   rate, extra_bytes: int = 0) -> dict:
    """K6+K4's bound on a chunk: walk_bound()'s reads and Philox blocks of
    the walks from ``starts`` (the walked lanes' start nodes, global ids,
    over the unsharded ``graph``), plus the sectors a chunk's lanes must
    read to find their starts and weights (demand_sectors()) and the
    sectors of the output its walks add into, read and written, and
    ``extra_bytes`` (K6+K4-xp's records), at the device memory's rate;
    the larger of the bytes' and the operations' times."""
    import torch
    gen = torch.Generator(device=starts.device).manual_seed(SEED)
    b = walk_bound(graph, starts, gen, rcfg.alpha, rcfg.max_walk_hops, rate)
    extra = ((demand_sectors_ + 2 * out_sectors) * SECTOR + extra_bytes) \
        / hbm_rate() * 1e3
    t_bytes = b["bytes_ms"] + extra
    print(f"K6+K4 bound: K4's walks {b['bytes_ms']:.4f} ms of reads, "
          f"{b['ops_ms']:.4f} ms of Philox blocks; {demand_sectors_} sectors "
          f"of cum and r at the lanes' nodes and {out_sectors} of the output, "
          f"read and written, and {extra_bytes} bytes more, {extra:.4f} ms")
    return (dict(bound_ms=t_bytes, bound_by="bytes") if t_bytes >= b["ops_ms"]
            else dict(bound_ms=b["ops_ms"], bound_by="operations"))


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
    ends = walk.walk_endpoints(dg, start.view(-1), SEED, rcfg.alpha,
                               rcfg.max_walk_hops).view(start.shape)
    rows["accumulate_endpoints"] = k6_accum_row(ends, weight, dg.n, label)
    for name, row in rows.items():
        k6_line(name, row, label)
    rows["raw_walk"] = fused_on_pool(dg, rcfg, r, d, dp, W, start, weight,
                                     ends, label)
    return rows


def fused_on_pool(dg, rcfg, r, d, dp, W, start, weight, ends, label):
    """K6+K4 on the raw pool's largest walk phase (one chunk, lanes 0 .. W
    - 1, walks keyed as the chain's under SEED), held to the chain on it
    (raw_walk_row: ``start``, ``weight`` and ``ends`` are the chain's)."""
    import torch
    from fora_tpu_torch.ops import walk
    a, hops = rcfg.alpha, rcfg.max_walk_hops
    B = r.shape[1]
    dev = r.device
    valid = torch.arange(W, device=dev)[:, None] < d.total[None, :]
    om = dp.omega_v.float()
    bounds = torch.stack([torch.zeros_like(dp.total, dtype=torch.int64),
                          dp.total.long()])
    acc = torch.zeros((dg.n, B), dtype=torch.float32, device=dev)

    def fresh():
        return [torch.zeros((dg.n, B), dtype=torch.float32, device=dev)]
    chain = {"K6-expand": lambda: walk.expand_lanes(r, d, 0, W),
             "K4": lambda: walk.walk_endpoints(dg, start.view(-1), SEED, a,
                                               hops),
             "K6-accum": lambda: walk.accumulate_endpoints(ends, weight,
                                                           dg.n, out=acc)}
    cols = torch.arange(B, device=dev)[None, :].expand(W, B)
    out_sectors = sectors((ends.long() * B + cols)[valid])
    bound = raw_walk_bound(dg, start[valid], rcfg,
                           demand_sectors([r], [dp.omega_v]), out_sectors,
                           walk_sector_rate(dg))
    return raw_walk_row(
        label,
        lambda outs, e: walk.raw_walk_chunk(dg, r, d, 0, W, SEED, a, hops,
                                            outs[0], ends=e),
        fresh,
        lambda outs: walk.raw_walk_chunk(dg, om, d, 0, W, SEED, a, hops,
                                         outs[0]),
        chain, ends, weight, valid,
        lambda outs, e: walk.raw_walk_chunk_plain(dg, [r], [dp], bounds, 0, W,
                                                  0, SEED, a, hops, outs,
                                                  ends=e),
        walk.expand_chunk_lanes_plain([r], [dp], bounds, 0, W, 0)[1], bound)


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
    K6's three kernels and K6+K4 at the pool's shapes (k6_on_pool).
    Returns its launch counts (reset just before the run, read just
    after; "chunks" the walk phases' chunks) and K6's rows (or None)."""
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
    counts["chunks"] = sum(st["chunks"] for st in stats)
    print(f"{name}: {len(src)} queries in {wall:.3f} s -> "
          f"{len(src) / wall:.2f} "
          f"q/s; levels used {levels}; accepted {n_acc}/{len(src)}; "
          f"overflowing columns {over}; walks {walks}, lanes {lanes} in "
          f"{counts['chunks']} chunks")
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


# K6+K4-src's rows by branch ("uniform", "alias", "hub"), filled by
# source_walk_row
source_rows: dict = {}
# K6-demand's list form on phase 9's one-shot residues ("sharded"), by
# run_sharded_raw
demand_rows: dict = {}


def source_walk_row(dg, rcfg, sources, label, hub=None, plain=True):
    """K6+K4-src on one chunk of a source-rooted path (the first
    MC_QUERIES ``sources``, min(omega_unit + 1, 2^22) walks each, seed
    SEED; with ``hub`` HubPPR's hub branch) against the chain it replaced,
    K4 (K4-alias, K4-hub) on sources.repeat(rows) -> K6-accum of the
    constant weight 1 / rows, on the same chunk.  The gates: every walk's
    endpoint (the kernel's ``ends``) equal to K4's, and with ``plain`` to
    source_walk_chunk_plain's; the kernel's sums and K6-accum's pass
    f32_gate against the float64 sums of the f32 weight at K4's endpoints,
    each entry's count of adds exact (weight 1.0).  Timed as called and in
    device time beside the chain's launches and their sum, the plain
    version (with ``plain``) and source_walk_bound; K6-accum at this shape
    too, beside its bound (4 bytes an endpoint read, the distinct sectors
    of out read and written) and the library call scatter_add_ over the
    int64 endpoints.  Stores {"row": K6+K4-src's row, "accum": K6-accum's}
    under the branch's name in source_rows."""
    import numpy as np
    import torch
    from fora_tpu_torch.algo import hubppr
    from fora_tpu_torch.ops import walk
    from fora_tpu_torch.utils.timing import cuda_ms, device_ms
    a, hops = rcfg.alpha, rcfg.max_walk_hops
    W = min(int(rcfg.omega_unit) + 1, WALK_CHECK)
    src = torch.as_tensor(np.asarray(sources[:MC_QUERIES]),
                          dtype=torch.int32, device=dg.device)
    B, n, dev = src.shape[0], dg.n, dg.device
    weight = 1.0 / W
    start = src.repeat(W)

    def k4():
        if hub is None:
            return walk.walk_endpoints(dg, start, SEED, a, hops)
        return hubppr.hub_walks(dg, start, SEED, hub, alpha=a, max_hops=hops)

    def fresh():
        return torch.zeros((n, B), dtype=torch.float32, device=dev)

    def launch(w, out, ends=None):
        walk.source_walk_chunk(dg, src, W, SEED, a, hops, w, out, hub=hub,
                               ends=ends)
    chain = k4().view(W, B)
    ends = torch.full_like(chain, -1)
    got = fresh()
    launch(weight, got, ends)
    differ = int((ends != chain).sum())
    if differ:
        fail(f"K6+K4-src ({label}): {differ} of {W * B} endpoints differ "
             f"from {walk_branch(dg, hub)}'s")
    del ends
    if plain:
        pends = torch.full_like(chain, -1)
        walk.source_walk_chunk_plain(dg, src, W, SEED, a, hops, weight,
                                     fresh(), hub=hub, ends=pends)
        if not torch.equal(pends, chain):
            fail(f"source_walk_chunk_plain ({label}): "
                 f"{int((pends != chain).sum())} endpoints differ")
        del pends
    e64 = chain.long()
    want = torch.zeros((n, B), dtype=torch.float64, device=dev)
    want.scatter_add_(0, e64, torch.full((W, B), float(np.float32(weight)),
                                         dtype=torch.float64, device=dev))
    cnt64 = torch.zeros_like(want).scatter_add_(
        0, e64, torch.ones((W, B), dtype=torch.float64, device=dev))
    cnt = fresh()
    launch(1.0, cnt)
    err = f32_gate(f"K6+K4-src ({label})", got, want, cnt, cnt64)
    acc, acc_cnt = fresh(), fresh()
    walk.accumulate_endpoints(chain, weight, n, out=acc)
    walk.accumulate_endpoints(chain, 1.0, n, out=acc_cnt)
    acc_err = f32_gate(f"K6-accum ({label})", acc, want, acc_cnt, cnt64)
    home = int(cnt64[src.long(), torch.arange(B, device=dev)].sum())
    del want, cnt, cnt64, acc, acc_cnt, got
    cols = torch.arange(B, device=dev)[None, :]
    out_sectors = sectors(e64 * B + cols)
    out = fresh()
    row = dict(max_abs_err=err, ms=cuda_ms(lambda: launch(weight, out)),
               device_ms=device_ms(lambda: launch(weight, out)),
               plain_ms=cuda_ms(lambda: walk.source_walk_chunk_plain(
                   dg, src, W, SEED, a, hops, weight, out, hub=hub),
                   iters=1, warmup=1) if plain else None,
               library_ms=None,
               **source_walk_bound(dg, start, rcfg, out_sectors, hub))
    parts = {walk_branch(dg, hub): device_ms(k4, iters=5),
             "K6-accum": device_ms(lambda: walk.accumulate_endpoints(
                 chain, weight, n, out=out), iters=5)}
    row["chain_device_ms"] = sum(parts.values())
    wfull = torch.full((W, B), weight, dtype=torch.float32, device=dev)
    accum = dict(max_abs_err=acc_err,
                 ms=cuda_ms(lambda: walk.accumulate_endpoints(
                     chain, weight, n, out=out), iters=5),
                 device_ms=parts["K6-accum"],
                 plain_ms=cuda_ms(lambda: walk.accumulate_endpoints_plain(
                     chain, weight, n, out), iters=3),
                 library_ms=cuda_ms(lambda: out.scatter_add_(0, e64, wfull),
                                    iters=3),
                 **bound(W * B * 4 + 2 * out_sectors * SECTOR))
    del wfull, e64
    plain_txt = (f"; plain {row['plain_ms']:.4f} ms (bit-equal)"
                 if plain else "")
    print(f"K6+K4-src ({label}, {B} sources x {W} walks, {home} of them "
          f"end at their source): endpoints bit-equal to "
          f"{walk_branch(dg, hub)}'s on every walk; counts exact, every "
          f"entry within the f32 summation bound (max abs err {err:.3e}); "
          f"{row['ms']:.4f} ms as called, device {row['device_ms']:.4f}; the "
          f"chain {row['chain_device_ms']:.4f} ms device (" + ", ".join(
              f"{k} {v:.4f}" for k, v in parts.items()) + f"){plain_txt}; "
          f"bound {row['bound_ms']:.4f} ms by {row['bound_by']} "
          f"({row['bound_ms'] / row['device_ms']:.0%} of it reached, "
          "device)")
    print(f"K6-accum ({label}): {accum['ms']:.4f} ms as called, device "
          f"{accum['device_ms']:.4f}; plain {accum['plain_ms']:.4f} ms; "
          f"library (scatter_add_) {accum['library_ms']:.4f} ms; bound "
          f"{accum['bound_ms']:.4f} ms by {accum['bound_by']} "
          f"({accum['bound_ms'] / accum['device_ms']:.0%} of it reached, "
          f"device; {out_sectors} sectors of out)")
    source_rows[walk_branch(dg, hub)] = {"row": row, "accum": accum}


def source_walk_bound(graph, start, rcfg, out_sectors, hub=None) -> dict:
    """K6+K4-src's bound on a chunk: walk_bound()'s reads and Philox
    blocks of the walks from ``start`` (sources.repeat(rows)), without
    its start array read and endpoints written (the kernel holds neither),
    plus the ``out_sectors`` distinct sectors of the output its walks add
    into, read and written, at the device memory's rate; the larger of
    the bytes' and the operations' times."""
    import torch
    gen = torch.Generator(device=start.device).manual_seed(SEED)
    b = walk_bound(graph, start, gen, rcfg.alpha, rcfg.max_walk_hops,
                   walk_sector_rate(graph, hub), hub=hub)
    hbm = hbm_rate()
    arrays = 2 * nbytes(start) / hbm * 1e3
    extra = 2 * out_sectors * SECTOR / hbm * 1e3
    t_bytes = b["bytes_ms"] - arrays + extra
    print(f"K6+K4-src bound: K4's walks {b['bytes_ms'] - arrays:.4f} ms of "
          f"reads (no start or endpoint array), {b['ops_ms']:.4f} ms of "
          f"Philox blocks; {out_sectors} sectors of the output, read and "
          f"written, {extra:.4f} ms")
    return (dict(bound_ms=t_bytes, bound_by="bytes") if t_bytes >= b["ops_ms"]
            else dict(bound_ms=b["ops_ms"], bound_by="operations"))


def run_montecarlo(dg, rcfg, sources, exact_ids, name="montecarlo"):
    """Phase 11 (and 13's weighted run, ``name`` its label): Monte Carlo
    top-k of the first MC_QUERIES sources, its chunks counted from the
    constant plan (source_chunks), then K6+K4-src on its chunk
    (source_walk_row).  Returns its launch counts."""
    import numpy as np
    import torch
    from fora_tpu_torch import kernels
    from fora_tpu_torch.algo.montecarlo import (make_montecarlo_fn,
                                                source_chunks)
    from fora_tpu_torch.eval import metrics
    from fora_tpu_torch.ops.topk import topk_nodes
    fn = make_montecarlo_fn(dg, rcfg)
    src = np.asarray(sources[:MC_QUERIES])
    chunks = len(source_chunks(fn.num_walks, len(src), dg.device))
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
    walks = ("index_walk", "index_walk_alias", "index_walk_hub",
             "accumulate_endpoints")
    if counts["source_walk"] != chunks or any(counts[k] for k in walks):
        fail(f"{name}: {counts['source_walk']} launches of K6+K4-src for "
             f"{chunks} chunks, expected one each, and "
             f"{[counts[k] for k in walks]} of {walks}, expected none")
    print(f"{name}: K6+K4-src once per chunk ({chunks}), no K4 branch or "
          "K6-accum of its own")
    source_walk_row(dg, rcfg, sources, f"{name}'s chunk")
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
    K4's sharded alias form, K6+K4-xp's row on the weighted raw chunk)."""
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
    raw1_counts, raw1_steps, raw1_row, _ = run_sharded_raw(
        gw, rcfg, sources[:POOL], ex, dgw, "weighted sharded raw")
    # phase 17's check of K6+K4-xp (its alias hops) on this graph, and
    # phase 15's of K4-xp
    xp_row = xp_simulation(gw, rcfg, sources[:MP_SOURCES], dgw, dev,
                           "weighted")[0]
    ixp_row = index_xp_simulation(gw, dgw, rcfg, dev, "weighted")
    raw_counts, _ = run_raw(dgw, rcfg, sources, ex, name="weighted raw")
    mc_counts = run_montecarlo(dgw, rcfg, sources, ex,
                               name="weighted montecarlo")
    return (row, counts, raw_counts, mc_counts, sharded_counts, raw1_counts,
            raw1_steps, raw1_row, xp_row, ixp_row)


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
    # the build checkpoints under <index dir>/.build_ckpt: a stale one (of
    # another seed) is discarded, and the directory is gone after the save
    ckpt = CLI_DIR / "index" / CLI_DATASET / ".build_ckpt"
    ckpt.mkdir(parents=True, exist_ok=True)
    (ckpt / "manifest.json").write_text(json.dumps({"seed": -1}))
    run_cli_action("build", cli_argv("build", "--index-shards", str(SHARDS)),
                   counts)
    if ckpt.exists():
        fail(f"cli build: its checkpoint {ckpt} was not removed")
    print("cli build: a stale checkpoint discarded, the walk chunks "
          "checkpointed, the directory removed after the save")
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
    # HubPPR's chunks, from the constant plans: the pool's K4 launches
    # (pool_chunk_hubs hubs each) and the queries' K6+K4-src launches (one
    # batch of len(ev) sources)
    from fora_tpu_torch.algo.montecarlo import source_chunks
    num_walks = min(int(rcfg.omega_unit) + 1, WALK_CHECK)
    P = hubppr.default_pool_size(rcfg, num_walks, NUM_HUBS)
    per = hubppr.pool_chunk_hubs(P, dev)
    pool_chunks = -(-NUM_HUBS // per)
    query_chunks = len(source_chunks(num_walks, len(ev), dev))
    c = counts["hubppr"]
    print(f"cli hubppr: the pool of {NUM_HUBS} hubs x {P} entries in "
          f"{pool_chunks} chunks of {per} hubs (K4 launched "
          f"{c['index_walk']} times); {len(ev)} queries x {num_walks} walks "
          f"in {query_chunks} chunk(s) (K6+K4-src launched "
          f"{c['source_walk']} times)")
    if c["index_walk"] != pool_chunks or c["source_walk"] != query_chunks:
        fail("cli hubppr: its launches do not match its chunk plans")
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


def raw_allocation(eng, rcfg, sources, graph):
    """A raw level's allocation from the raw one-shot's residues: the
    push of ``sources`` on ``eng``, then every lane of the walk demand of
    the concatenated residues (lanes 0 .. the largest column's total, as
    one walk-phase chunk lays them out), int32 on the first shard's
    device.  K6 is held and timed on it (k6_demand_row, k6_expand_row on
    the concatenation; k6_accum_row on K4's endpoints of its lanes), and
    its sharded forms as the raw one-shot runs them: the shards' demands
    in one launch of the list form, each torch.equal to the plain
    version's (demand_list_check, timed beside the earlier form a shard),
    the chunk's lanes expanded over
    the shards' demands (expand_chunk_lanes) equal to the concatenation's
    expansion on every lane below its column's total (weight 0 past it),
    and the accumulate into the shards' partials
    (accumulate_chunk_endpoints) held to the float64 plain sum
    (k6_accum_check); then K6+K4's sharded form, one launch for the
    chunk, held to that chain (raw_walk_row; its bound over ``graph``, the
    unsharded device graph).  Returns (the flat starts, K6+K4's row)."""
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
    demand_list_check(rs, omega, label)
    ds, tot = walk.walk_demands(rs, omega)
    tot = tot.long()
    bounds = torch.cat([torch.zeros_like(tot[:1]), tot.cumsum(0)])
    s_start, s_weight = walk.expand_chunk_lanes(rs, ds, bounds, 0, W, n_loc)
    lane = torch.arange(W, device=r.device)[:, None]
    valid = lane < bounds[-1][None, :]
    if not (torch.equal(s_start[valid], start[valid])
            and torch.equal(s_weight[valid], weight[valid])
            and not bool(s_weight[~valid].any())):
        fail("K6-expand's sharded form: the chunk's lanes over the shards' "
             "demands differ from the concatenation's expansion")
    del s_weight
    csr = eng.placement.walk
    a, hops = rcfg.alpha, rcfg.max_walk_hops
    ends = walk.walk_endpoints(csr, start.view(-1), SEED, a, hops).view(W, B)
    rows["accumulate_endpoints"] = k6_accum_row(ends, weight, r.shape[0],
                                                label)
    err = k6_accum_check(f"the shards' partials of {label}", ends, weight,
                         r.shape[0], bounds=bounds, G=len(rs))
    parts = [torch.zeros_like(r) for _ in rs]
    x_ms = device_ms(lambda: walk.expand_chunk_lanes(rs, ds, bounds, 0, W,
                                                     n_loc))
    a_ms = device_ms(lambda: walk.accumulate_chunk_endpoints(
        ends, weight, parts, bounds, 0))
    for name, row in rows.items():
        k6_line(name, row, label)
    print(f"K6's sharded forms on {label}: {len(rs)} shards' demands equal "
          f"to the plain ones, the chunk's lanes over them to the "
          f"concatenation's; the accumulate into the shards' partials held "
          f"to float64 (max abs err {err:.3e}); device ms of the sharded "
          f"forms: expansion {x_ms:.4f}, accumulate {a_ms:.4f}")
    # K6+K4's sharded form on the same chunk, against that chain (its
    # endpoints on the valid lanes are the ones K4 gave on ``start``)
    oms = [walk.walk_demand_plain(x, omega).omega_v for x in rs]
    shard = (lane[None] >= bounds[1:-1][:, None, :]).sum(0)
    cols = torch.arange(B, device=r.device)[None, :]
    out_sectors = sectors(((shard * r.shape[0] + ends.long()) * B + cols)
                          [valid])
    bound = raw_walk_bound(graph, start[valid], rcfg,
                           demand_sectors(rs, oms), out_sectors,
                           walk_sector_rate(graph))
    ones_r = [x.float() for x in oms]
    del oms
    chain = {"K6-expand (sharded)": lambda: walk.expand_chunk_lanes(
                 rs, ds, bounds, 0, W, n_loc),
             "K4 (sharded)": lambda: walk.walk_endpoints(
                 csr, s_start.view(-1), SEED, a, hops),
             "K6-accum (sharded)": lambda: walk.accumulate_chunk_endpoints(
                 ends, weight, parts, bounds, 0)}
    fused = raw_walk_row(
        f"sharded, {label}",
        lambda outs, e: walk.raw_walk_sharded_chunk(
            csr, rs, ds, bounds, 0, W, SEED, a, hops, outs, ends=e),
        lambda: [torch.zeros_like(r) for _ in rs],
        lambda outs: walk.raw_walk_sharded_chunk(
            csr, ones_r, ds, bounds, 0, W, SEED, a, hops, outs),
        chain, ends, weight, valid,
        lambda outs, e: walk.raw_walk_chunk_plain(csr, rs, ds, bounds, 0, W,
                                                  n_loc, SEED, a, hops, outs,
                                                  ends=e),
        walk.expand_chunk_lanes_plain(rs, ds, bounds, 0, W, n_loc)[1], bound,
        shard=shard)
    del parts, ends, weight, s_start, shard, valid, lane, ones_r
    return start.view(-1), fused


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
    K6-demand's list form held to the plain demand and timed on the
    one-shot's own residues (demand_list_check: every source, the shape
    its walk phase gives the demand; phase 9's numbers kept in
    demand_rows), and K4's sharded form held and timed
    on a raw level's allocation from the one-shot's residues (its first
    RAW_CHECK_COLS sources) against ``graph``, the unsharded device graph.
    Returns (launch counts per exchange, the exchange's supersteps and
    the walk phase's chunks per exchange, the kernel row of K4's sharded
    form, K6+K4's row on that allocation)."""
    import numpy as np
    import torch
    from fora_tpu_torch import kernels
    from fora_tpu_torch.eval import metrics
    from fora_tpu_torch.parallel import ShardedForaEngine, make_mesh
    from fora_tpu_torch.parallel import sharded as psh
    mesh = make_mesh(SHARDS)
    res, counts, steps = {}, {}, {}
    B = len(sources)
    orig, chunks = psh.sharded_walk_phase, []

    def counted(*a, **kw):      # the walk phases' chunks, for the counts
        out = orig(*a, **kw)
        chunks.append(out[1].chunks)
        return out
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
        chunks.clear()
        psh.sharded_walk_phase = counted
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = eng.topk(sources, SEED)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            psh.sharded_walk_phase = orig
        counts[mode] = kernels.launch_counts()
        no_plain_k6(f"{name} {mode}", plain0)
        steps[mode] = dict(zip(("compacted", "fell_back", "cleared"),
                               (xch.compacted - before[0],
                                xch.fell_back - before[1],
                                xch.cleared - before[2])),
                           supersteps=out.push_iters, chunks=sum(chunks))
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
    # K6-demand's list form at the one-shot's own shape: the shards'
    # residues of all B sources, as its walk phase takes them
    ps, rs = eng.init_state(sources)
    eng.push(ps, rs)
    demand_rows.setdefault("sharded", demand_list_check(
        rs, rcfg.omega_unit, f"{name}'s one-shot, {len(rs)} shards' r "
        f"{tuple(rs[0].shape)}"))
    del ps, rs
    start, fused = raw_allocation(eng, rcfg, sources[:RAW_CHECK_COLS],
                                  graph)
    row = sharded_walk_row(eng, graph, rcfg, start, "raw allocation of "
                           f"{RAW_CHECK_COLS} queries")
    del eng, start
    torch.cuda.empty_cache()
    return counts, steps, row, fused


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
    per run, launch counts of the sharded build, the sha256 of its
    index's arrays)."""
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
    slog = {}
    t0 = time.perf_counter()
    sidx = tidx.build_walk_index_sharded(g, mesh, rcfg, SEED, log=slog)
    build_s = time.perf_counter() - t0
    build_counts = kernels.launch_counts()
    if any(build_counts[k] != 1 for k in PACK_KERNELS):
        fail(f"sharded index build: K7 launches "
             f"{[build_counts[k] for k in PACK_KERNELS]}, expected one each")
    from fora_tpu_torch.parallel.multihost_driver import index_digest
    digest = index_digest(sidx)
    walks = int(tidx.index_counts(g.out_deg, rcfg).sum())
    for f in ("edge_src", "edge_dst", "bucket_offsets", "counts_cum",
              "edge_mult"):
        if not np.array_equal(np.asarray(getattr(sidx, f)),
                              np.asarray(getattr(index, f))):
            fail(f"sharded index build: {f} differs from phase 4's index")
    print(f"sharded index build: {walks} walks over {SHARDS} shard slices "
          f"in {build_s:.4f} s ({build_counts['index_walk_sharded']} launches "
          f"of K4's sharded form, the pack on the card by K7); split, s: "
          + ", ".join(f"{k} {v:.4f}" for k, v in slog["split_s"].items())
          + f"; every array equal to phase 4's build_walk_index at seed "
          f"{SEED}")
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
    return comp, p3, clear, launches, stats, build_counts, digest


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


# ---- phase 17: the sharded one-shot across processes ------------------------

MP_PROCS = 2                        # phase 17: worker processes on the card
# the sources of phase 17's one-shots: the first 32 of phase 9's (all 128
# took the phase to 127 s: gloo moves a superstep's 134 MB in about 0.29 s)
MP_SOURCES = 32
MP_WORKER_S = 420                   # a world's time limit
MP_BUILDS = ("build", "build_2", "build_3")     # phase 17's builds a world
MP_DIR = ROOT / "bench_data" / "torch_smoke_mp"
# the exchanges of phase 17's pools across processes, dense first
MP_POOL_MODES = ("dense", "compact", "routed", "hier")


def sharded_rule_agree(name, got_v, got_i, want_v, want_i) -> float:
    """tests/test_torch_sharded.py's rule: values within rtol 1e-5 / atol
    1e-7, ids equal wherever the reference's adjacent values differ by more
    than 1e-7.  Returns the max abs error."""
    import numpy as np
    gv, gi = sorted_topk(got_v, got_i)
    wv, wi = sorted_topk(want_v, want_i)
    err = np.abs(gv.astype(np.float64) - wv)
    if not (err <= 1e-7 + 1e-5 * np.abs(wv)).all():
        fail(f"{name}: values beyond rtol 1e-5 / atol 1e-7 (max abs err "
             f"{err.max():.3e})")
    apart = np.abs(np.diff(wv.astype(np.float64), axis=1)) > 1e-7
    sep = np.ones(wv.shape, bool)
    sep[:, :-1] &= apart
    sep[:, 1:] &= apart
    bad = int((gi[sep] != wi[sep]).sum())
    if bad:
        fail(f"{name}: {bad} ids differ where adjacent values differ by "
             f"more than 1e-7")
    print(f"{name}: values within rtol 1e-5 / atol 1e-7 (max abs err "
          f"{err.max():.3e}); ids equal at {int(sep.sum())} of {sep.size} "
          f"positions outside ties of 1e-7")
    return float(err.max())


def xp_records(box, cnt, d):
    """Destination d's records of an outbox, sorted by walk key."""
    import torch
    rec = box[d, :int(cnt[d])]
    return rec[torch.argsort(rec[:, 0].long() & 0xFFFFFFFF)]


def xp_simulation(g, rcfg, sources, graph, dev, label):
    """K6+K4-xp on the raw one-shot's first walk chunk as phase 17's
    workers walk it (``probes/xp_walk_probe.py::first_chunk``: the
    one-process engine on SHARDS shards pushes ``sources``, the shards'
    demands and the plan give the first chunk and its seed); K6+K4's
    sharded form walks it (the reference: its endpoints and device time);
    then MP_PROCS processes of SHARDS / MP_PROCS shards are simulated by a
    loop on the card, each launch of K6+K4-xp (the own-lane form in round
    0, the inbox form after it) held to raw_walk_xp_plain on the same own
    lanes and inbox (counts equal, each destination's records (w, cur, h |
    len << 16, weight) equal as a set, the endpoints of the walks that end
    there equal, the partials within rtol 1e-4: f32 atomics in no fixed
    order) and its records handed on.  Every lane's endpoint over the
    rounds must be the reference's bit for bit.  The earlier kernel
    (probes/xp_walk_forms.cu) walks the chunk's rounds again, its
    endpoints the reference's too, for its device time.  Returns
    (K6+K4-xp's kernel row: ms the chunk's launches as called, device_ms
    their device time (each launch again on scratch outputs), forms each
    form's launches and times, plain_ms the plain version's launches,
    sharded_device_ms K6+K4's sharded form on the chunk,
    earlier_device_ms the earlier kernel's launches, bound K6+K4's on the
    chunk's walks plus 16 bytes a record written and read; the reference
    endpoints [W, Bc]; the chunk (c0, c1, lo, hi))."""
    import torch
    from fora_tpu_torch.ops import walk
    from fora_tpu_torch.probes import xp_walk_probe as xpp
    from fora_tpu_torch.utils.timing import device_ms
    c = xpp.first_chunk(g, rcfg, sources, dev, SEED)
    W, Bc, n_loc, lo = c["W"], c["Bc"], c["n_loc"], c["lo"]
    n_pad = SHARDS * n_loc
    ref, one_ms, ref_sum = xpp.reference(c)
    P, L = MP_PROCS, SHARDS // MP_PROCS
    parts = [torch.zeros((n_pad, Bc), device=dev) for _ in range(P)]
    ends = [torch.full((W, Bc), -1, dtype=torch.int32, device=dev)
            for _ in range(P)]
    err = 0.0
    ms = {"kernel": 0.0, "plain": 0.0}
    per = []                 # per launch: (round, process, walks, device ms)

    def timed(fn):
        s, e = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        s.record()
        fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e)

    def launch(q, r, inbox, box, cnt):
        nonlocal err
        got = {}
        for form in ("kernel", "plain"):
            x = (box, cnt) if form == "kernel" else (torch.empty_like(box),
                                                     torch.empty_like(cnt))
            e = torch.full((W, Bc), -1, dtype=torch.int32, device=dev)
            args = xpp.launch_args(c, q, P, r, inbox, *x,
                                   torch.zeros((n_pad, Bc), device=dev))
            fn = (walk.raw_walk_xp_chunk if form == "kernel"
                  else walk.raw_walk_xp_plain)
            ms[form] += timed(lambda: fn(*args, ends=e))
            got[form] = (*x, args[12], e)
        (box, cnt, part, e), (pbox, pcnt, ppart, pe) = got.values()
        if box.shape[1]:
            scratch = xpp.launch_args(c, q, P, r, inbox,
                                      torch.empty_like(box),
                                      torch.empty_like(cnt),
                                      torch.zeros_like(part))
            per.append((r, q, box.shape[1], device_ms(
                lambda: walk.raw_walk_xp_chunk(*scratch), iters=3,
                warmup=1)))
        if not torch.equal(cnt, pcnt) or int(cnt[q]) != 0:
            fail(f"K6+K4-xp {label}: counts {cnt.tolist()} against the "
                 f"plain version's {pcnt.tolist()} (process {q}, round {r})")
        for d in range(P):
            if not torch.equal(xp_records(box, cnt, d),
                               xp_records(pbox, pcnt, d)):
                fail(f"K6+K4-xp {label}: process {q}'s records for {d} "
                     f"differ from the plain version's (round {r})")
        if not torch.equal(e, pe):
            fail(f"K6+K4-xp {label}: process {q}'s endpoints differ from "
                 f"the plain version's (round {r})")
        err = max(err, close(f"K6+K4-xp {label} process {q} round {r}",
                             part, ppart, 1e-4, 1e-7))
        parts[q] += part
        ends[q] = torch.maximum(ends[q], e)
    own = {q: walk.own_lanes(c["bnp"][q * L:q * L + L + 1], lo, W)[0]
           for q in range(P)}
    counts = walk.xp_chunk_rounds(launch, walk.local_exchange, own, P, dev)
    rounds, sent = len(counts), [int(m.sum()) for m in counts]
    if int(sum((x >= 0).int() for x in ends).max()) > 1 or \
            not torch.equal(torch.stack(ends).max(0).values, ref):
        fail(f"K6+K4-xp {label}: the simulated processes' endpoints differ "
             f"from K6+K4's sharded form's")
    err = max(err, close(f"K6+K4-xp {label} partials against K6+K4's "
                         f"sharded form", sum(parts), ref_sum, 1e-4, 1e-7))
    walked = int((ref >= 0).sum())
    now = xpp.summary(per)
    # the earlier kernel on the same chunk, its own rounds
    earlier = xpp.run_rounds(c, P, xpp.form_caller(xpp.load_forms(),
                                                   "earlier"))
    if not torch.equal(earlier["ends"], ref):
        fail(f"K6+K4-xp's earlier kernel {label}: endpoints differ from "
             f"K6+K4's sharded form's")
    before = xpp.summary(earlier["per"])
    print(f"K6+K4-xp {label} by launch: round 0 (own-lane form) " + ", ".join(
        f"process {q} {w} walks {d:.4f} ms" for r, q, w, d in per if r == 0)
        + f"; rounds 1-{rounds - 1} (inbox form): {now['launches'] - P} "
        f"launches, {now['later_walks']} walks handed on, "
        f"{now['later_ms']:.4f} ms device (the 8 largest " + ", ".join(
            f"{d:.4f}" for d in sorted((x[3] for x in per if x[0] > 0),
                                       reverse=True)[:8])
        + f"); walk segments a walk {sum(x[2] for x in per) / walked:.3f}; "
        f"the earlier kernel: round 0 {before['round0_ms']:.4f} + rounds "
        f"{before['later_ms']:.4f} = {before['total_ms']:.4f} ms device in "
        f"{before['launches']} launches")
    # the bound: K6+K4's on the chunk's walks, plus 16 bytes a record
    # written by its sender and read by its receiver
    rsc, dsc, bounds = c["rs"], c["ds"], c["bounds"]
    start, _ = walk.expand_chunk_lanes(rsc, dsc, bounds, lo, W, n_loc)
    lane = lo + torch.arange(W, device=dev)[:, None]
    valid = lane < bounds[-1][None, :]
    cols = torch.arange(Bc, device=dev)[None, :]
    out_idx = torch.cat([((q * n_pad + x.long()) * Bc + cols)[x >= 0]
                         for q, x in enumerate(ends)])
    oms = [walk.walk_demand_plain(x, rcfg.omega_unit).omega_v for x in rsc]
    rec_bytes = 2 * 16 * sum(sent)
    forms = {"raw_walk_xp": dict(launches=P, device_ms=now["round0_ms"],
                                 walks=now["round0_walks"]),
             "raw_walk_xp_inbox": dict(launches=now["launches"] - P,
                                       device_ms=now["later_ms"],
                                       walks=now["later_walks"])}
    row = dict(max_abs_err=err, ms=ms["kernel"], device_ms=now["total_ms"],
               plain_ms=ms["plain"], library_ms=None, forms=forms,
               sharded_device_ms=one_ms, earlier_device_ms=before["total_ms"],
               **raw_walk_bound(graph, start[valid], rcfg,
                                demand_sectors(rsc, oms), sectors(out_idx),
                                walk_sector_rate(graph), rec_bytes))
    print(f"K6+K4-xp {label} on the raw one-shot's first chunk ({W} x {Bc} "
          f"lane slots, {walked} walks, {MP_PROCS} simulated processes of "
          f"{L} shards): {rounds} rounds, records handed over per round "
          f"{sent}; every launch held to raw_walk_xp_plain (counts, records "
          f"as sets with their length field, endpoints equal; partials "
          f"within rtol 1e-4, max abs err {err:.3e}), every endpoint K6+K4's "
          f"sharded form's bit for bit; {now['launches']} launches "
          f"{ms['kernel']:.4f} ms as called, device {now['total_ms']:.4f} "
          f"ms (own-lane form {now['round0_ms']:.4f}, inbox form "
          f"{now['later_ms']:.4f}), against the earlier kernel's "
          f"{before['total_ms']:.4f} "
          f"({before['total_ms'] / now['total_ms']:.2f}x) "
          f"and K6+K4's sharded form on the chunk {one_ms:.4f} ms device "
          f"({now['total_ms'] / one_ms:.2f}x); plain {ms['plain']:.4f} ms; "
          f"bound {row['bound_ms']:.4f} ms by {row['bound_by']} "
          f"({100 * row['bound_ms'] / now['total_ms']:.1f}% of the device "
          f"time; records {rec_bytes / hbm_rate() * 1e3:.4f} ms of it)")
    if not now["total_ms"] < before["total_ms"]:
        fail(f"K6+K4-xp {label}: {now['total_ms']:.4f} ms device, not "
             f"faster than the earlier kernel's {before['total_ms']:.4f}")
    chunk = c["chunk"]
    del parts, ends, ref_sum, start, valid, lane, oms, c
    return row, ref, chunk


def index_xp_simulation(g, graph, rcfg, dev, label) -> dict:
    """K4-xp on the whole index build (its walks in chunks of INDEX_LAUNCH
    at seed SEED, those of build_walk_index and the sharded builds; one
    window of schedule.build_windows) with SHARDS shards over MP_PROCS
    processes simulated by a loop on the card
    (``probes/index_xp_probe.py::run_build``: xp_chunk_rounds over
    local_exchange): each launch (the own-start form in round 0, the inbox
    form after it) held to index_walk_xp_plain on the same own starts and
    inbox (counts equal, each destination's records (w, cur, h | len <<
    16, 0) equal as a set, the endpoints equal, -1 at the own walks that
    left) and its records handed on; each walk must end in exactly one
    process, where K4's sharded form (``walk_endpoints`` over the slices,
    the one-process sharded build's walk) ends it on its chunk, bit for
    bit.  The earlier per-chunk forms (probes/index_xp_forms.cu, a round
    loop a chunk) walk the build again, their endpoints K4's sharded
    form's too, and the package's forms must take less device time.
    ``graph`` is ``g`` on the card (the bound's).  Returns K4-xp's kernel
    row: ms the launches as called, device_ms their device time (each
    launch again on scratch outputs), forms each form's launches, walks
    and device ms, rounds, plain_ms the plain version's launches,
    sharded_device_ms K4's sharded form on the chunks, earlier_device_ms
    and earlier_forms the earlier forms', its bound K4's walk bound on
    each chunk plus 16 bytes a record written and read."""
    import torch
    from fora_tpu_torch.ops import walk
    from fora_tpu_torch.probes import index_xp_probe as ixp
    from fora_tpu_torch.utils.timing import cuda_ms
    s = ixp.setup(g, rcfg, dev, SEED, INDEX_LAUNCH)
    ref, one_ms = ixp.reference(s)
    P, L = MP_PROCS, SHARDS // MP_PROCS
    plain = {"ms": 0.0}

    def check(q, r, args):
        (csr, start, w0, wlo, cl, shard0, G, seed, alpha, hops, inbox, box,
         cnt, e) = args
        pbox, pcnt = torch.empty_like(box), torch.zeros_like(cnt)
        pe = torch.full_like(e, -1)
        plain["ms"] += cuda_ms(lambda: walk.index_walk_xp_plain(
            csr, start, w0, wlo, cl, shard0, G, seed, alpha, hops, inbox,
            pbox, pcnt, pe), iters=1, warmup=0)
        if not torch.equal(cnt[:P], pcnt[:P]) or int(cnt[q]) != 0:
            fail(f"K4-xp {label}: counts {cnt.tolist()} against the plain "
                 f"version's {pcnt.tolist()} (process {q}, round {r})")
        for d in range(P):
            if not torch.equal(xp_records(box, cnt, d),
                               xp_records(pbox, pcnt, d)):
                fail(f"K4-xp {label}: process {q}'s records for {d} differ "
                     f"from the plain version's (round {r})")
        if not torch.equal(e, pe):
            fail(f"K4-xp {label}: process {q}'s endpoints differ from the "
                 f"plain version's (round {r})")
    forms = ixp.load_forms()
    got = ixp.run_build(s, P, ixp.form_caller(forms, "package"),
                        check=check)
    if not got["once"] or not torch.equal(got["ends"], ref):
        fail(f"K4-xp {label}: the simulated processes' endpoints differ from "
             f"K4's sharded form's, or a walk ended in no process or two")
    now = ixp.summary(got["per"])
    # the earlier per-chunk forms on the same build, their own rounds
    old = ixp.run_build(s, P, ixp.form_caller(forms, "earlier"),
                        per_chunk=True)
    if not old["once"] or not torch.equal(old["ends"], ref):
        fail(f"K4-xp's earlier forms {label}: endpoints differ from K4's "
             f"sharded form's")
    before = ixp.summary(old["per"])
    if got["rounds"] != [max(old["rounds"])]:
        fail(f"K4-xp {label}: {got['rounds']} rounds over the build's window,"
             f" not its longest chunk's of {old['rounds']}")
    sent = [x for w in got["sent"] for x in w]
    # the bound: K4's walk bound on each chunk, plus 16 bytes a record
    # written by its sender and read by its receiver
    bytes_ms = ops_ms = 0.0
    for i, lo in enumerate(range(0, s["total"], INDEX_LAUNCH)):
        gen = torch.Generator(device=dev).manual_seed(SEED + i)
        b = walk_bound(graph, s["starts"][lo:lo + INDEX_LAUNCH], gen,
                       rcfg.alpha, rcfg.max_walk_hops, walk_sector_rate(graph))
        bytes_ms += b["bytes_ms"]
        ops_ms += b["ops_ms"]
    rec_ms = 2 * 16 * sum(sent) / hbm_rate() * 1e3
    by = "bytes" if bytes_ms + rec_ms >= ops_ms else "operations"
    bound_ms = max(bytes_ms + rec_ms, ops_ms)
    row = dict(max_abs_err=0.0, ms=now["called_ms"],
               device_ms=now["total_ms"], plain_ms=plain["ms"],
               library_ms=None, bound_ms=bound_ms, bound_by=by,
               sharded_device_ms=one_ms, rounds=got["rounds"],
               earlier_device_ms=before["total_ms"],
               earlier_forms={"rounds": old["rounds"],
                              "round0_ms": before["round0_ms"],
                              "later_ms": before["later_ms"],
                              "launches": before["launches"]},
               forms={"index_walk_xp": dict(
                   launches=now["round0_launches"],
                   device_ms=now["round0_ms"], walks=now["round0_walks"]),
                   "index_walk_xp_inbox": dict(
                   launches=now["later_launches"],
                   device_ms=now["later_ms"], walks=now["later_walks"])})
    print(f"K4-xp {label} on the whole index build ({s['total']} walks in "
          f"chunks of {INDEX_LAUNCH}, one window; {P} simulated processes "
          f"of {L} shards): {got['rounds']} rounds (the earlier forms' "
          f"per chunk {old['rounds']}), records handed over per round "
          f"{sent}; every launch held to index_walk_xp_plain (counts, "
          f"records as sets, endpoints equal), every endpoint K4's sharded "
          f"form's bit for bit; {now['launches']} launches "
          f"{now['called_ms']:.4f} ms as called, device "
          f"{now['total_ms']:.4f} ms (own-start form {now['round0_ms']:.4f} "
          f"over {now['round0_walks']} walks in {now['round0_launches']}, "
          f"inbox form {now['later_ms']:.4f} over {now['later_walks']} "
          f"records in {now['later_launches']}); the earlier forms "
          f"{before['total_ms']:.4f} ms device (own-start "
          f"{before['round0_ms']:.4f}, inbox {before['later_ms']:.4f}, "
          f"{before['launches']} launches; "
          f"{before['total_ms'] / now['total_ms']:.2f}x); K4's sharded form "
          f"on the same chunks {one_ms:.4f} ms device "
          f"({now['total_ms'] / one_ms:.2f}x); plain {plain['ms']:.4f} ms; "
          f"bound {bound_ms:.4f} ms by {by} "
          f"({100 * bound_ms / now['total_ms']:.1f}% of the device time, the "
          f"earlier forms' {100 * bound_ms / before['total_ms']:.1f}%; "
          f"records {rec_ms:.4f} ms of it)")
    for k, (r, q, w, d, c) in enumerate(
            (x[1], x[2], x[3], x[4], x[5]) for x in got["per"]):
        if r < 3 or k >= len(got["per"]) - 2:
            print(f"  round {r} process {q}: {w} walks in, {d:.4f} ms "
                  f"device, {c:.4f} ms as called")
    if not now["total_ms"] < before["total_ms"]:
        fail(f"K4-xp {label}: {now['total_ms']:.4f} ms device, not faster "
             f"than the earlier forms' {before['total_ms']:.4f}")
    del s, ref, got, old
    return row


def start_world(procs, backend, specs, out) -> list:
    """``procs`` workers of fora_tpu_torch.parallel.multihost_driver on
    DEVICE over ``backend``, worker q with ``specs[q]`` and its output in
    ``out/worker<q>.log``, started (not waited for)."""
    import os
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS="4")
    ps = []
    for q in range(procs):
        (out / f"spec{q}.json").write_text(json.dumps(specs[q]))
        with open(out / f"worker{q}.log", "w") as log:
            p = subprocess.Popen(
                [sys.executable, "-m",
                 "fora_tpu_torch.parallel.multihost_driver", "--coordinator",
                 f"localhost:{port}", "--processes", str(procs), "--rank",
                 str(q), "--backend", backend, "--device", DEVICE, "--spec",
                 str(out / f"spec{q}.json"), "--out", str(out)],
                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
        p.log = out / f"worker{q}.log"
        ps.append(p)
    return ps


def finish_world(ps, t0: float, timeout: float = MP_WORKER_S,
                 grace: float = 15.0) -> tuple:
    """(exit codes, output tails) of a world's workers.  Past ``timeout``
    seconds from ``t0``, or ``grace`` seconds after a worker failed (the
    others would wait in a collective), every worker still running is
    killed (its code then non-zero)."""
    failed_at = None
    while any(p.poll() is None for p in ps):
        now = time.perf_counter()
        if failed_at is None and any(p.poll() not in (None, 0) for p in ps):
            failed_at = now
        if now - t0 > timeout or (failed_at is not None
                                  and now - failed_at > grace):
            for p in ps:
                if p.poll() is None:
                    p.kill()
            break
        time.sleep(0.1)
    codes = [p.wait() for p in ps]
    tails = [p.log.read_text()[-2500:] for p in ps]
    return codes, tails


def world_records(name, out, codes, tails) -> list:
    """The workers' records of a world that must have succeeded."""
    if any(codes):
        fail(f"phase 17 {name}: worker exit codes {codes}:\n" + "\n".join(
            f"rank {q}: {t}" for q, t in enumerate(tails) if codes[q]))
    return [json.loads((out / f"rank{q}.json").read_text())
            for q in range(len(codes))]


def mp_exchange_kw(mode: str, L: int) -> dict:
    """A worker job's exchange keys: hier's host is a process (L chips)."""
    if mode == "dense":
        return {}
    return {"exchange": mode, **({"chips_per_host": L} if mode == "hier"
                                 else {})}


def mp_pool_job(name, root, src, mode, L) -> dict:
    """A worker job: the refinement pool of ``src`` as one pool of width
    len(src) (phase 5's defer and stride), warm, then timed."""
    return {"name": name, "graph": {"store": str(root)},
            "index": {"store": str(root / "index")}, "k": K,
            "sources": src, "runner": "pool", "pool": len(src),
            "batch": len(src), "defer_below": DEFER, "delta_stride": DSTRIDE,
            "accept_slack": ACCEPT, "repeat": 2, **mp_exchange_kw(mode, L)}


def mp_exchange_gates(label, rec, L, runs: int) -> None:
    """One worker's timed run of a job across processes: the compaction
    (L a superstep, one more a push: it runs ahead of the status read),
    P3 (L a compacted superstep), the clear (one a superstep cleared by
    rows) and P1's hops (L (L - 1) a superstep that took the ring) as the
    exchange's counts say, over ``runs`` pushes; a compacted exchange
    compacted some supersteps, the dense one none."""
    c, steps = rec["launches"], rec["supersteps"]
    comp, back = rec["compacted"], rec["fell_back"]
    dense = rec["exchange"] == "dense"
    want = {"frontier_compact": 0 if dense else L * (steps + runs),
            "row_scatter_add": L * comp, "exchange_clear": rec["cleared"],
            "ring_all_gather_hop": L * (L - 1) * (steps if dense else back),
            "index_spmv": L * runs, "topk_bounds": L * runs}
    bad = {k: (c[k], v) for k, v in want.items() if c[k] != v}
    if bad or (comp > 0) == dense or comp + back != (0 if dense else steps):
        fail(f"phase 17 {label}: {steps} supersteps, {comp} compacted, "
             f"{back} fell back; launches (got, expected) {bad}")


def mp_bytes_line(label, recs) -> str:
    """What crossed the process boundary per superstep, summed over the
    workers, beside what the dense exchange sends there."""
    rows = [sum(x) for x in zip(*(r["sent_rows"] for r in recs))]
    sent = [sum(x) for x in zip(*(r["sent_bytes"] for r in recs))]
    dense = [sum(x) for x in zip(*(r["dense_bytes"] for r in recs))]
    if not sent:
        return f"{label}: no superstep"
    return (f"{label}: rows across the process boundary per superstep "
            f"{rows}; bytes per superstep mean {statistics.mean(sent):.0f} "
            f"(max {max(sent)}, total {sum(sent)}) against the dense "
            f"exchange's {statistics.mean(dense):.0f} (total {sum(dense)}): "
            f"{sum(sent) / sum(dense):.4f} of it")


def run_multiprocess(g, rcfg, index, sources, exact_ids, graph, dev,
                     build_digest, build_rounds):
    """Phase 17: ShardedForaEngine.topk with its SHARDS shards over
    MP_PROCS worker processes on the one card (gloo, both on cuda:0;
    fora_tpu_torch.parallel.multihost_driver) from both sharded stores of
    phase 1's graph and phase 4's index, each worker given only its own
    shards' files: the indexed one-shot of ``sources`` (warm, then timed)
    against phase 9's one-process engine on them (test_torch_sharded.py's
    rule, equal supersteps), the raw one-shot of ``sources`` at SEED (its
    first chunk's endpoints torch.equal to K6+K4's sharded form's,
    precision@50 against phase 7's oracle ``exact_ids``; warm, then
    timed), gather_to_host; K6+K4-xp held to its plain version and timed
    on that chunk first (xp_simulation); then a world of one process over
    NCCL holding the four shards (the indexed answer the one-process
    engine's bit for bit, the raw chunk's endpoints equal again), and,
    beside the gloo world, two NCCL ranks on the one card, which must fail
    in multihost.init.  The gloo world also runs the indexed one-shot with
    hier (chips_per_host L: a host is a process), bit-equal to its dense
    one-shot, and the refinement pool of ``sources`` (one pool, warm, then
    timed) with each of MP_POOL_MODES: every compacted pool bit-equal to
    the dense one, the dense one against the one-process
    ShardedTopkRunner's (pools_agree) and at precision@50 >= 0.95; the NCCL
    world runs the routed pool too, bit-equal to the one-process runner's.
    Both worlds build the FORA+ index across their processes at phase 4's
    seed and chunk, MP_BUILDS times (multihost_driver's "build" job:
    each worker generates phase 1's graph, places only its shards' slices and walks
    with K4-xp over one window of the build's chunks), every worker's
    arrays equal (their sha256) to phase 4's index and to phase 15's
    one-process sharded build (``build_digest``), in ``build_rounds``
    rounds over gloo (phase 15's, the longest chunk's) and one over NCCL,
    the gloo world's first written as a sharded store from which its
    indexed one-shot must answer as from phase 4's index, bit for bit.  Every worker's launches are
    reset just before its timed call and read just after.  Returns
    (K6+K4-xp's kernel row, the gloo world's raw run's launches summed over
    its workers, the compaction's, P3's and the clear's summed over its
    compacted runs, and its build's launches summed over its workers)."""
    import os
    import shutil
    import numpy as np
    import torch
    from fora_tpu_torch import index as tidx
    from fora_tpu_torch.eval import metrics
    from fora_tpu_torch.parallel import multihost, save_sharded_graph
    from fora_tpu_torch.parallel import (ShardedForaEngine,
                                         ShardedTopkRunner, make_mesh)
    from fora_tpu_torch.parallel.multihost_driver import index_digest
    want_digest = index_digest(index)
    if build_digest != want_digest:
        fail("phase 15's sharded build's arrays differ from phase 4's index")
    # phase 9's one-process engine on the same sources: the reference
    one = ShardedForaEngine(g, make_mesh(SHARDS), rcfg, k=K, index=index)
    one.topk(sources)                                   # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref_res = one.topk(sources)
    torch.cuda.synchronize()
    ref_wall = time.perf_counter() - t0
    del one
    # phase 15's one-process pool on the same sources as the workers run
    # it: one pool, warm (it learns its start level), then timed
    one = ShardedTopkRunner(g, make_mesh(SHARDS), rcfg, index, k=K,
                            delta_stride=DSTRIDE, accept_slack=ACCEPT,
                            exchange="routed")
    quiet = lambda *a: None   # noqa: E731
    nq = len(sources)
    run_queries(one, sources, quiet, pool=nq, batch=nq)
    ref_pool_vals = {}
    ref_pool, _, _, ref_pool_wall, _ = run_queries(
        one, sources, quiet, pool=nq, batch=nq, values=ref_pool_vals)
    del one
    shutil.rmtree(MP_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    stores = MP_DIR / "stores"
    save_sharded_graph(g, str(stores), SHARDS)
    tidx.save_sharded(index, rcfg, str(stores / "index"), SHARDS, graph=g)
    P, L = MP_PROCS, SHARDS // MP_PROCS
    for q in range(P):      # only the process's own shards' files
        mine = MP_DIR / f"rank{q}"
        for sub in (f"graph-shards-G{SHARDS}", f"index/shards-G{SHARDS}"):
            (mine / sub).mkdir(parents=True)
            shutil.copy(stores / sub / "meta.json", mine / sub / "meta.json")
            for s in range(q * L, (q + 1) * L):
                for f in (stores / sub).glob(f"shard_{s:04d}.*"):
                    os.link(f, mine / sub / f.name)
    print(f"multiprocess: both sharded stores written ({SHARDS} shards) and "
          f"each of {P} processes given its {L} shards' files in "
          f"{time.perf_counter() - t0:.1f} s")
    row, ref_ends, (c0, c1, lo, hi) = xp_simulation(
        g, rcfg, sources, graph, dev, "uniform")
    torch.cuda.empty_cache()
    src = [int(s) for s in sources]

    def spec(root, extra):
        indexed = {"name": "indexed", "graph": {"store": str(root)},
                   "index": {"store": str(root / "index")}, "k": K,
                   "sources": src, "repeat": 2}
        return {"shards": SHARDS, "jobs": [
            indexed,
            {"name": "raw", "graph": {"store": str(root)}, "index": None,
             "k": K, "sources": src, "seed": SEED, "repeat": 2,
             "ends": True}] + [dict(indexed, **x) for x in extra]}
    t0 = time.perf_counter()
    refused = start_world(2, "nccl", [{"shards": SHARDS, "jobs": []}] * 2,
                          MP_DIR / "out_refused")
    out = MP_DIR / "out_gloo"
    # the index built across the workers at phase 4's seed and chunk, then
    # the indexed one-shot from the sharded store that rank 0 writes
    build = {"name": "build", "runner": "build", "epsilon": EPS,
             "graph": {"rmat": [NLOG2, (1 << NLOG2) * EDGEF, SEED]},
             "seed": SEED, "chunk_lanes": INDEX_LAUNCH}
    built_store = MP_DIR / "built_index"
    gloo = start_world(P, "gloo", [spec(MP_DIR / f"rank{q}", [
        {"name": "hier", **mp_exchange_kw("hier", L)}] + [
        mp_pool_job(f"pool_{m}", MP_DIR / f"rank{q}", src, m, L)
        for m in MP_POOL_MODES] + [
        dict(build, store=str(built_store)),
        {"name": "built", "index": {"store": str(built_store)},
         "repeat": 1}] + [dict(build, name=b) for b in MP_BUILDS[1:]])
        for q in range(P)], out)
    recs = world_records("gloo", out, *finish_world(gloo, t0))
    world_s = time.perf_counter() - t0
    codes, tails = finish_world(refused, t0)
    # rank 0 serves the store, so it reads both cards' names whatever the
    # other rank does once it has raised
    if not all(codes) or "NCCL refuses two ranks on one GPU" not in tails[0]:
        fail(f"phase 17: two NCCL ranks on one card were not refused in "
             f"init (exit codes {codes}): {tails}")
    print(f"multiprocess: two NCCL ranks on the one card refused in "
          f"multihost.init, before any collective: "
          f"{tails[0].strip().splitlines()[-1]}")
    for q, rec in enumerate(recs):
        if not rec["gather"] or rec["modules"]:
            fail(f"phase 17 rank {q}: gather_to_host {rec['gather']}, "
                 f"imported {rec['modules'][:5]}")
    print("multiprocess gloo: all_gather, all_reduce, reduce_scatter and "
          "all_to_all called on the CUDA tensors themselves (nothing "
          "staged through host memory); gather_to_host of the shards' row "
          "ids equal on every process; no module of jax or fora_tpu in a "
          "worker")
    arrs = [np.load(out / f"rank{q}.npz") for q in range(P)]
    for q in range(1, P):
        for key in arrs[0].files:
            if not np.array_equal(arrs[q][key], arrs[0][key]):
                fail(f"phase 17: rank {q}'s {key} differs from rank 0's")
    steps = ref_res.push_iters
    for q, rec in enumerate(recs):
        job = rec["jobs"]["indexed"]
        c = job["launches"]
        want = {"index_spmv": L, "topk_bounds": L,
                "reduce_scatter_onepass": 1 if L > 1 else 0,
                "push_prepass": L * steps, "gather_scatter_add": L * steps,
                "ring_all_gather_hop": L * (L - 1) * steps,
                "raw_walk_xp": 0, "raw_walk_xp_inbox": 0}
        if job["supersteps"] != steps or job["shards"] != list(
                range(q * L, (q + 1) * L)) or any(
                c[k] != v for k, v in want.items()):
            fail(f"phase 17 indexed, rank {q}: supersteps "
                 f"{job['supersteps']} (phase 9 {steps}), shards "
                 f"{job['shards']}, launches {c} (expected {want})")
    sharded_rule_agree("multiprocess indexed vs the one-process engine",
                       arrs[0]["indexed.values"], arrs[0]["indexed.ids"],
                       ref_res.values, ref_res.node_ids)
    ends = np.load(out / "raw.ends.npy")
    if ends.shape != tuple(ref_ends.shape) or not torch.equal(
            torch.from_numpy(ends).to(dev), ref_ends):
        fail(f"phase 17 raw: the first chunk's endpoints {ends.shape} "
             f"differ from K6+K4's sharded form's "
             f"{tuple(ref_ends.shape)}")
    raw = [rec["jobs"]["raw"] for rec in recs]
    xp = {k: sum(r["launches"][k] for r in raw) for k in raw[0]["launches"]}
    for q, r in enumerate(raw):
        c = r["launches"]
        if c["raw_walk_xp"] <= 0 or c["raw_walk_xp_inbox"] <= 0 or \
                c["raw_walk"] or c["walk_demand"] != 1 \
                or c["index_spmv"] or c["topk_bounds"] != L:
            fail(f"phase 17 raw, rank {q}: launches {c}")
    prec = metrics.batch_precision_at_k(arrs[0]["raw.ids"], exact_ids)
    if not prec >= MIN_PRECISION:
        fail(f"phase 17 raw precision@{K} {prec:.4f} < {MIN_PRECISION}")
    nb = len(src)
    print(f"multiprocess gloo, {P} processes of {L} shards on one card "
          f"(time-sliced: correctness and the protocol's overhead, not "
          f"scaling): world {world_s:.1f} s (start, stores, both jobs); "
          f"indexed {len(src)} queries "
          f"{recs[0]['jobs']['indexed']['wall_s']:.4f} s "
          f"timed (phase 9's engine in one process {ref_wall:.4f} s), "
          f"{steps} supersteps; raw {nb} queries "
          f"{recs[0]['jobs']['raw']['wall_s']:.4f} s timed, "
          f"{raw[0]['supersteps']} supersteps, precision@{K} {prec:.4f} over "
          f"{len(exact_ids)}; the first chunk's endpoints ({ends.shape[0]} x "
          f"{ends.shape[1]}, lanes {lo} .. {hi - 1} of columns {c0} .. "
          f"{c1 - 1}) equal to K6+K4's sharded form's; K6+K4-xp launches "
          f"(own-lane form, inbox form) " + str(
              [(r["launches"]["raw_walk_xp"],
                r["launches"]["raw_walk_xp_inbox"]) for r in raw]))
    for i, nr in enumerate(raw[0]["rounds"]):
        per = [(sum(r["sent"][i][j] for r in raw)) for j in range(nr)]
        print(f"  chunk {i}: {nr} rounds; records handed over per round "
              f"{per}; bytes {[16 * x for x in per]}; and per round one "
              f"all-gather of {P} x {P + 1} int32 counts")
    # the hier one-shot: JAX's multi-host bench form, bit-equal to the
    # dense one-shot of the same world
    a0 = arrs[0]
    hier = [rec["jobs"]["hier"] for rec in recs]
    if not (np.array_equal(a0["hier.ids"], a0["indexed.ids"])
            and np.array_equal(a0["hier.values"].view(np.uint32),
                               a0["indexed.values"].view(np.uint32))
            and hier[0]["supersteps"] == steps):
        fail(f"phase 17 hier: not bit-equal to the dense one-shot of the "
             f"world ({hier[0]['supersteps']} supersteps, dense {steps})")
    for q, r in enumerate(hier):
        mp_exchange_gates(f"hier one-shot, rank {q}", r, L, 1)
    sharded_rule_agree("multiprocess hier vs the one-process engine",
                       a0["hier.values"], a0["hier.ids"], ref_res.values,
                       ref_res.node_ids)
    print(f"multiprocess gloo hier one-shot (chips_per_host {L}: a host is "
          f"a process; time-sliced, not scaling): {hier[0]['wall_s']:.4f} s "
          f"timed against the dense one-shot's "
          f"{recs[0]['jobs']['indexed']['wall_s']:.4f}; {steps} supersteps, "
          f"{hier[0]['compacted']} compacted, {hier[0]['fell_back']} fell "
          f"back, {hier[0]['cleared']} cleared by rows; bit-equal to the "
          f"dense one-shot")
    print("  " + mp_bytes_line("hier one-shot", hier))
    print("  " + mp_bytes_line("dense one-shot",
                               [rec["jobs"]["indexed"] for rec in recs]))
    # the pools: each compacted one bit-equal to the dense one, the dense
    # one against the one-process runner and the oracle
    mp_xch = {k: 0 for k in ("frontier_compact", "row_scatter_add",
                             "exchange_clear")}
    for r in hier:
        for k in mp_xch:
            mp_xch[k] += r["launches"][k]
    pool = {m: [rec["jobs"][f"pool_{m}"] for rec in recs]
            for m in MP_POOL_MODES}
    for m in MP_POOL_MODES:
        for q, r in enumerate(pool[m]):
            runs = sum(st["batches"] for st in r["levels"])
            mp_exchange_gates(f"pool {m}, rank {q}", r, L, runs)
            if m != "dense":
                for k in mp_xch:
                    mp_xch[k] += r["launches"][k]
        if m != "dense":
            same = all(np.array_equal(a0[f"pool_{m}.{f}"],
                                      a0[f"pool_dense.{f}"])
                       for f in ("ids", "values", "lb", "ub", "accepted"))
            d0, r0 = pool["dense"][0], pool[m][0]
            if not same or r0["levels_used"] != d0["levels_used"] or [
                    st["supersteps"] for st in r0["levels"]] != [
                    st["supersteps"] for st in d0["levels"]]:
                fail(f"phase 17 pool {m}: not bit-equal to the dense pool of "
                     f"the world")
        r0 = pool[m][0]
        print(f"multiprocess gloo pool {m} ({nb} queries in one pool, width "
              f"{nb}; time-sliced, not scaling): {r0['wall_s']:.4f} s warm "
              f"(rank 0; rank 1 {pool[m][1]['wall_s']:.4f}), levels used "
              f"{r0['levels_used']}, {len(r0['levels'])} level runs, "
              f"{r0['supersteps']} supersteps: {r0['compacted']} compacted, "
              f"{r0['fell_back']} fell back, {r0['cleared']} cleared by rows"
              + ("" if m == "dense" else "; bit-equal to the dense pool"))
        print("  " + mp_bytes_line(f"pool {m}", pool[m]))
    ids = {int(s): a0["pool_dense.ids"][i] for i, s in enumerate(src)}
    vals = {int(s): a0["pool_dense.values"][i] for i, s in enumerate(src)}
    pools_agree("multiprocess pool dense vs the one-process pool", ids, vals,
                ref_pool, ref_pool_vals, src)
    prec = metrics.batch_precision_at_k(a0["pool_dense.ids"][:len(
        exact_ids)], exact_ids)
    print(f"multiprocess pool precision@{K}: {prec:.4f} over "
          f"{len(exact_ids)} queries (limit {MIN_PRECISION}); the "
          f"one-process pool {ref_pool_wall:.4f} s warm")
    if not prec >= MIN_PRECISION:
        fail(f"phase 17 pool precision@{K} {prec:.4f} < {MIN_PRECISION}")
    ixp = mp_build_checks("gloo", recs, out, rcfg, want_digest, L,
                          build_rounds, a0, steps)
    # a world of one process over NCCL, holding every shard
    t0 = time.perf_counter()
    out = MP_DIR / "out_nccl"
    one = world_records("nccl", out, *finish_world(start_world(
        1, "nccl", [spec(stores, [mp_pool_job(
            "pool_routed", stores, src, "routed", SHARDS)] + [
            dict(build, name=b) for b in MP_BUILDS])], out), t0))[0]
    mp_build_checks("nccl", [one], out, rcfg, want_digest, SHARDS, [1])
    a = np.load(out / "rank0.npz")
    if not (np.array_equal(a["indexed.ids"], ref_res.node_ids)
            and np.array_equal(a["indexed.values"].view(np.uint32),
                               ref_res.values.view(np.uint32))
            and one["jobs"]["indexed"]["supersteps"] == steps):
        fail("phase 17: the NCCL world of one process differs from the "
             "one-process engine's answer")
    if not np.array_equal(np.load(out / "raw.ends.npy"), ends):
        fail("phase 17: the NCCL world's raw endpoints differ")
    rp = one["jobs"]["pool_routed"]
    mp_exchange_gates("NCCL pool routed", rp, SHARDS,
                      sum(st["batches"] for st in rp["levels"]))
    if not all(np.array_equal(a["pool_routed.ids"][i], ref_pool[int(s)])
               and np.array_equal(a["pool_routed.values"][i].view(np.uint32),
                                  ref_pool_vals[int(s)].view(np.uint32))
               for i, s in enumerate(src)):
        fail("phase 17: the NCCL world's routed pool differs from the "
             "one-process runner's")
    print(f"multiprocess nccl routed pool: {rp['wall_s']:.4f} s warm "
          f"(the one-process runner {ref_pool_wall:.4f}), "
          f"{rp['supersteps']} supersteps, {rp['compacted']} compacted; "
          f"bit-equal to the one-process runner's")
    print(f"multiprocess nccl, one process of {SHARDS} shards: world "
          f"{time.perf_counter() - t0:.1f} s; indexed "
          f"{one['jobs']['indexed']['wall_s']:.4f} s, bit-equal to the "
          f"one-process engine's answer; raw "
          f"{one['jobs']['raw']['wall_s']:.4f} s, "
          f"{one['jobs']['raw']['rounds']} rounds, the first chunk's "
          f"endpoints equal")
    shutil.rmtree(MP_DIR, ignore_errors=True)
    return row, xp, mp_xch, ixp


def mp_build_checks(name, recs, out, rcfg, want_digest, L, rounds,
                    arrays=None, steps=None) -> dict:
    """Phase 17's index built across a world's processes MP_BUILDS times
    (``recs`` its workers' records): rank 0's saved index and every
    worker's arrays (their sha256) equal to ``want_digest`` (phase 4's),
    each worker's own L shards' slices placed, the build one window in
    ``rounds`` rounds, its launches K4-xp's two forms only (the inbox form
    only where records crossed), and, where ``arrays`` (rank 0's npz) is
    given, the indexed one-shot from the store the first build wrote
    bit-equal to the one from phase 4's index after ``steps`` supersteps.
    Prints each build's wall and its split (placing, K4-xp's launches,
    the counts' all-gather and host read, the all-to-all, the endpoints'
    all-reduce, the pack; the launches' CUDA events), the walls' spread,
    the rounds and records per round.  Returns the launches of K4-xp's
    forms in the first build, summed over the workers."""
    import numpy as np
    from fora_tpu_torch import index as tidx
    from fora_tpu_torch.parallel.multihost_driver import index_digest
    P = len(recs)
    if index_digest(tidx.load(str(out / "build.index"), rcfg)) != \
            want_digest:
        fail(f"phase 17 {name} build: rank 0's saved index differs from "
             f"phase 4's")
    other = ("index_walk", "index_walk_alias", "index_walk_sharded",
             "index_walk_sharded_alias", "raw_walk_xp", "raw_walk_xp_inbox")
    walls = []
    for job in MP_BUILDS:
        bl = [rec["jobs"][job] for rec in recs]
        if any(b["digest"] != want_digest for b in bl):
            fail(f"phase 17 {name} {job}: the index built across {P} "
                 f"processes differs from phase 4's (and phase 15's)")
        for q, b in enumerate(bl):
            c = b["launches"]
            crossed = sum(map(sum, b["received"])) > 0
            if c["index_walk_xp"] <= 0 or (c["index_walk_xp_inbox"] > 0) \
                    != crossed or any(c[k] for k in other) or \
                    any(c[k] != 1 for k in PACK_KERNELS) or \
                    b["shards"] != list(range(q * L, (q + 1) * L)) or \
                    b["rounds"] != rounds or len(b["windows"]) != 1:
                fail(f"phase 17 {name} {job}, rank {q}: shards "
                     f"{b['shards']}, rounds {b['rounds']} (want {rounds}),"
                     f" windows {b['windows']}, launches {c}")
        walls.append(max(b["wall_s"] for b in bl))
        split = {k: [round(b["split_s"][k], 4) for b in bl]
                 for k in bl[0]["split_s"]}
        print(f"  {name} {job}: wall {walls[-1]:.4f} s (per rank "
              f"{[round(b['wall_s'], 4) for b in bl]}); split per rank, s: "
              f"{split}; K4-xp launches' device time per rank (CUDA events) "
              f"{[round(b['walk_device_ms'], 4) for b in bl]} ms")
    bl = [rec["jobs"]["build"] for rec in recs]
    if arrays is not None:
        w = [rec["jobs"]["built"] for rec in recs]
        if not (np.array_equal(arrays["built.ids"], arrays["indexed.ids"])
                and np.array_equal(arrays["built.values"].view(np.uint32),
                                   arrays["indexed.values"].view(np.uint32))
                and all(x["supersteps"] == steps for x in w)):
            fail(f"phase 17 {name}: the indexed one-shot from the built "
                 f"store differs from the one from phase 4's index")
    per = [[sum(b["sent"][i][j] for b in bl) for j in range(nr)]
           for i, nr in enumerate(bl[0]["rounds"])]
    forms = {k: sum(b["launches"][k] for b in bl)
             for k in ("index_walk_xp", "index_walk_xp_inbox")}
    print(f"multiprocess {name} build across {P} processes of {L} shards "
          f"(phase 4's seed and chunk; each worker placing only its "
          f"{L} slices, {bl[0]['slice_edges']} edges each), "
          f"{len(MP_BUILDS)} builds: walls {[round(x, 4) for x in walls]} s "
          f"(min {min(walls):.4f}, median {sorted(walls)[len(walls) // 2]:.4f}"
          f", max {max(walls):.4f}), {bl[0]['total_edges']} index edges; "
          f"every worker's arrays equal to phase 4's build_walk_index and "
          f"phase 15's one-process sharded build; K4-xp launches (own-start, "
          f"inbox) "
          f"{[(b['launches']['index_walk_xp'], b['launches']['index_walk_xp_inbox']) for b in bl]}"
          + ("; the indexed one-shot from the store it wrote bit-equal to "
             "phase 4's" if arrays is not None else ""))
    for i, nr in enumerate(bl[0]["rounds"]):
        print(f"  build window {bl[0]['windows'][i]}: {nr} rounds; records "
              f"handed over per round {per[i]}; K4-xp launches (own-start, "
              f"inbox) per rank {[b['forms'][i] for b in bl]}")
    return forms


# ---- phase 18: the main path at bench.py's own scale --------------------------

BIG_NLOG2 = 22                      # bench.py's graph: RMAT 2^22 x 16, seed 7
BIG_QUERIES, BIG_EVAL = 512, 128    # bench.py's queries and scored sources
BIG_SEEDS = (SEED, SEED + 1000)     # the index's seeds: the build's, one more
BIG_DIR = ROOT / "bench_data" / "torch_smoke_big"
BIG_GRAPH = BIG_DIR / f"rmat{BIG_NLOG2}x{EDGEF}s{SEED}.npz"
WIDE_WALKS = 1.1 * 2**30            # the build past K7-sort's 2^30 keys
WIDE_EVAL = 32                      # its pool's scored sources
BOOTSTRAP = 10_000


def start_big_graph() -> subprocess.Popen:
    """Phase 18's graph (bench.py's: RMAT 2^22 x 16, seed 7, by the port's
    generator) made by a process of its own, at the lowest priority (nice
    19), while phases 3-14 run: numpy takes minutes over it.  It writes
    BIG_GRAPH by rename; the process is stopped at exit."""
    import atexit
    BIG_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BIG_GRAPH.with_name(BIG_GRAPH.stem + ".part.npz")
    code = ("import os, sys, numpy as np\n"
            "os.nice(19)\n"
            "from fora_tpu_torch.graph import generators\n"
            f"g = generators.rmat({BIG_NLOG2}, {EDGEF << BIG_NLOG2}, "
            f"seed={SEED})\n"
            "np.savez(sys.argv[1], **{k: v for k, v in g._asdict().items() "
            "if v is not None})\n"
            "os.replace(sys.argv[1], sys.argv[2])\n")
    proc = subprocess.Popen([sys.executable, "-c", code, str(tmp),
                             str(BIG_GRAPH)], cwd=ROOT)
    proc.started = time.perf_counter()

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    atexit.register(stop)
    return proc


def precision_spread(label, pred, ex, rng) -> float:
    """The mean per-query precision@K of ``pred`` against the exact ``ex``
    ([B, K] each), printed with its first 32's, min, 5th percentile, median
    and a bootstrap 95% interval of the mean (BOOTSTRAP resamples of the
    queries)."""
    import numpy as np
    per = np.array([len(set(p.tolist()) & set(e.tolist())) / K
                    for p, e in zip(pred, ex)])
    lo, hi = np.percentile(rng.choice(per, (BOOTSTRAP, len(per))).mean(
        axis=1), [2.5, 97.5])
    print(f"precision@{K} {label}: {per.mean():.4f} over {len(per)} queries "
          f"(the first {EVAL_N}: {per[:EVAL_N].mean():.4f}); per query min "
          f"{per.min():.2f}, 5th percentile {np.percentile(per, 5):.2f}, "
          f"median {np.median(per):.2f}; bootstrap 95% interval of the mean "
          f"[{lo:.4f}, {hi:.4f}]")
    return float(per.mean())


def index_sha(idx) -> str:
    """One sha256 of an index's arrays and its buckets' row pointers."""
    import hashlib
    import numpy as np
    h = hashlib.sha256()
    for a in (idx.edge_src, idx.edge_dst, idx.edge_mult, idx.bucket_offsets,
              idx.counts_cum, *[p for p in idx.dst_indptr if p is not None]):
        h.update(np.ascontiguousarray(a).data)
    return h.hexdigest()


def check_wide(idx, t, dev) -> None:
    """The past-2^30 index against what its pack tables say: each bucket's
    multiplicities summed equal to the keys the tables put in it, (bucket,
    dst, src) strictly increasing over the whole index (on the card, 2^27
    edges at a time), and the buckets' row pointers equal to
    ``with_indptr``'s."""
    import numpy as np
    import torch
    from fora_tpu_torch.index import build as ib
    cut = np.concatenate([t.cut, np.zeros((len(t.counts), 1), np.int64)], 1)
    want = (cut[:, :-1] - cut[:, 1:]).sum(axis=0)
    want[-1] += len(t.dang)
    off = np.asarray(idx.bucket_offsets)
    got = [float(np.asarray(idx.edge_mult[off[q]:off[q + 1]]).sum(
        dtype=np.float64)) for q in range(ib.NUM_BUCKETS)]
    if got != [float(w) for w in want]:
        fail(f"past-2^30 index: bucket multiplicities {got}, the tables "
             f"{want.tolist()}")
    bounds = torch.as_tensor(off[1:-1], device=dev)
    prev, step, E = -1, 1 << 27, idx.total_edges
    for a in range(0, E, step):
        b = min(E, a + step)
        q = torch.bucketize(torch.arange(a, b, device=dev), bounds, right=True)
        k = (q << (2 * t.nb)) | (torch.from_numpy(
            np.asarray(idx.edge_dst[a:b])).to(dev).long() << t.nb) | \
            torch.from_numpy(np.asarray(idx.edge_src[a:b])).to(dev).long()
        if not (int(k[0]) > prev and bool((k[1:] > k[:-1]).all())):
            fail(f"past-2^30 index: (bucket, dst, src) not strictly "
                 f"increasing in edges {a} .. {b}")
        prev = int(k[-1])
    ref = ib.with_indptr(idx._replace(dst_indptr=None)).dst_indptr
    for q, (p, r) in enumerate(zip(idx.dst_indptr, ref)):
        if (p is None) != (r is None) or (p is not None and
                                          not np.array_equal(p, r)):
            fail(f"past-2^30 index: bucket {q}'s row pointers differ from "
                 "with_indptr's")


def plain_key_chunks(ends, t, dev, step: int = 1 << 27):
    """``pack_keys_plain``'s keys of the pool ``ends`` (on the card), by
    runs of nodes of about ``step`` pool entries (node ids added back),
    then the dangling nodes' self-edges: the plain K7-keys at a size whose
    int64 temporaries do not fit at once."""
    import numpy as np
    from fora_tpu_torch.index import build as ib
    offsets, cut, dang = ib._device_tables(t, dev)
    n = len(t.counts)
    vs = np.unique(np.append(np.searchsorted(
        t.offsets, np.arange(0, t.total, step)), n)).tolist()
    ends_at = t.offsets.tolist() + [t.total]
    for v0, v1 in zip(vs[:-1], vs[1:]):
        o0, o1 = ends_at[v0], ends_at[v1]
        yield ib.pack_keys_plain(ends[o0:o1], offsets[v0:v1] - o0,
                                 cut[v0:v1], dang[:0], t.nb) + v0
    yield ib.pack_keys_plain(ends[:0], offsets[:0], cut[:0], dang, t.nb)


def hold_wide_windows(ends, t, cap, dev) -> list:
    """The past-2^30 pack's forms at its own shapes against the plain
    chain: the count form's top-level bins equal to
    ``pack_key_counts_plain`` summed over ``plain_key_chunks``; then, in
    each window of the plan at ``cap`` keys, the window form's keys equal,
    sorted, to the plain keys in [lo, hi) sorted, its digit counts to the
    count launch's, K7-sort's output to that sorted order and K7-merge's
    five arrays to ``merge_keys_plain``'s.  Returns the plan."""
    import torch
    from fora_tpu_torch import kernels
    from fora_tpu_torch.index import build as ib
    bits = 2 * t.nb + 4
    tables = ib._card_tables(t, dev)
    span = (0, 1 << bits,
            max(bits - (kernels.KEY_COUNT_BINS.bit_length() - 1), 0))
    bins = kernels.pack_key_counts(ends, *tables, t.nb, *span)
    want = sum(ib.pack_key_counts_plain(k, *span)
               for k in plain_key_chunks(ends, t, dev))
    if not torch.equal(bins, want):
        fail("phase 18: K7-keys' count form differs from its plain version "
             "over the past-2^30 pool")
    del bins, want
    plan = ib.plan_windows(lambda lo, hi, sh: kernels.pack_key_counts(
        ends, *tables, t.nb, lo, hi, sh).cpu().numpy(), t.nb, cap)
    n = len(t.counts)
    for i, (lo, hi, length) in enumerate(plan):
        want = torch.sort(torch.cat([
            ib.pack_keys_window_plain(k, lo, hi)
            for k in plain_key_chunks(ends, t, dev)])).values
        totals = kernels.digit_totals(bits, dev)
        keys = kernels.pack_keys_window(ends, *tables, t.nb, lo, hi, length,
                                        totals=totals)
        if not torch.equal(torch.sort(keys).values, want) or \
                not torch.equal(totals, kernels.digit_counts(keys, bits)):
            fail(f"phase 18: K7-keys' window form differs from its plain "
                 f"version in window {i} [{lo}, {hi}) of the past-2^30 pool")
        keys = kernels.sort_keys(keys, torch.empty_like(keys), bits,
                                 totals=totals)
        if not torch.equal(keys, want):
            fail(f"phase 18: K7-sort differs from torch.sort in window {i} "
                 "of the past-2^30 pool")
        del totals
        got = kernels.merge_keys(keys, t.nb, n)
        del keys
        for a, b in zip(got, ib.merge_keys_plain(want, t.nb, n)):
            if not torch.equal(a, b):
                fail(f"phase 18: K7-merge differs from its plain version in "
                     f"window {i} of the past-2^30 pool")
        del got, want
        torch.cuda.empty_cache()
    return plan


def run_bench_scale(gen, dev) -> dict:
    """Phase 18: the main path at bench.py's own scale.  bench.py's graph
    (RMAT 2^22 x 16, seed 7; made by ``gen``) merged with a 131,072-row hub
    split; eps 0.5, k 50, delta = p_f = 1/n, alpha 0.2, delta stride 8,
    defer 64.  The index built on the card at the build's seed, saved under
    BIG_DIR and loaded back through mmap; its 512 sources answered in pools
    of 128, fresh and warm, one warm pass profiled; precision@50 over the
    128 scored sources against the float64 oracle, its spread and a
    bootstrap interval, for that index and one built at a second seed,
    each >= MIN_PRECISION.  Then the index at the smallest integer
    rmax_scale whose walks pass 1.1 x 2^30, packed by K7 on the card in
    key-range windows (no host pack), held to its tables and sha256-equal
    to the same endpoints packed in windows of half the keys, whose
    windows are each held against the plain chain on the card
    (``hold_wide_windows``); one pool of
    128 queries from it, its precision over 32 printed (no gate).  Returns
    the launches of that build."""
    import numpy as np
    import torch
    from fora_tpu_torch import ForaConfig
    from fora_tpu_torch import index as tidx
    from fora_tpu_torch import kernels
    from fora_tpu_torch.algo import exact
    from fora_tpu_torch.algo.topk import TopkRunner
    from fora_tpu_torch.eval import queries as qio
    from fora_tpu_torch.graph import to_device
    from fora_tpu_torch.graph.csr import CSRGraph
    from fora_tpu_torch.index import build as ib
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    if gen.wait() != 0:
        fail(f"phase 18: the graph's process exited with {gen.returncode}")
    waited = time.perf_counter() - t0
    z = np.load(BIG_GRAPH)
    g = CSRGraph(**{k: z[k] for k in CSRGraph._fields if k in z.files})
    del z
    rcfg = ForaConfig(epsilon=EPS, k=K).resolved(g.n, g.m)
    t1 = time.perf_counter()
    dg = to_device(g, merge_duplicate_edges=True, hub_rows=HUB_ROWS,
                   device=dev)
    print(f"bench-scale graph: RMAT n={g.n} m={g.m} made in "
          f"{time.perf_counter() - gen.started:.1f} s beside phases 3-14 "
          f"(waited {waited:.1f} s for it); to_device "
          f"{time.perf_counter() - t1:.1f} s, {dg.m_in} merged in-edges")
    sources = qio.generate_sources(g, BIG_QUERIES, seed=SEED + 1)
    ev = sources[:BIG_EVAL]
    t1 = time.perf_counter()
    x = exact.exact_ppr_batch(g, ev, device=dev)
    ex = exact.topk_ids(x, K)
    kth = x.T.gather(1, torch.as_tensor(ex[:, -1:], device=dev))
    tied = int(((x.T >= kth).sum(dim=1) > K).sum())
    del x, kth
    torch.cuda.empty_cache()
    print(f"exact oracle: {BIG_EVAL} sources in "
          f"{time.perf_counter() - t1:.1f} s; {tied} with an exact tie "
          f"across rank {K}")
    rng = np.random.default_rng(SEED)
    keys = int(ib.pack_tables(tidx.index_counts(g.out_deg, rcfg),
                              g.out_deg).keys)
    for seed in BIG_SEEDS:
        log = {}
        kernels.reset_launch_counts()
        if seed == BIG_SEEDS[0]:
            index = build_index(g, dg, rcfg, path=BIG_DIR / "index", log=log,
                                seed=seed)
        else:
            torch_sync()
            t1 = time.perf_counter()
            index = tidx.build_walk_index(dg, rcfg, seed, log=log)
            log["wall_s"] = time.perf_counter() - t1
        c = kernels.launch_counts()
        if log["windows"] != 1 or any(c[n] != 1 for n in PACK_KERNELS) or \
                c["pack_key_counts"] or c["pack_keys_window"]:
            fail(f"phase 18 build at seed {seed}: {log['windows']} windows, "
                 f"K7 launches {[c[n] for n in PACK_KERNELS]}, expected one "
                 "sort")
        print(f"index at seed {seed}: {keys} keys in {log['windows']} "
              f"window, {index.total_edges} edges, built in "
              f"{log['wall_s']:.4f} s; split, s: " + ", ".join(
                  f"{k} {v:.4f}" for k, v in log["split_s"].items()))
        runner = TopkRunner(dg, rcfg, k=K, index=index, delta_stride=DSTRIDE,
                            accept_slack=ACCEPT)
        if seed == BIG_SEEDS[0]:
            kernels.reset_launch_counts()
            res, n_acc, levels, fresh, stats = run_queries(
                runner, sources, lambda *a: None)
            c = kernels.launch_counts()
            if len(res) != BIG_QUERIES or any(c[n] <= 0 for n in
                                              MAIN_KERNELS[:4]):
                fail(f"phase 18: {len(res)} of {BIG_QUERIES} answered, "
                     f"launches {c}")
            warm = run_queries(runner, sources, lambda *a: None)[3]
            steps = sum(st["supersteps"] for st in stats)
            print(f"queries: {BIG_QUERIES} in pools of {POOL}, fresh "
                  f"{fresh:.3f} s ({BIG_QUERIES / fresh:.2f} q/s), warm "
                  f"{warm:.3f} s ({BIG_QUERIES / warm:.2f} q/s); levels "
                  f"used {levels}, accepted {n_acc}/{BIG_QUERIES}, "
                  f"{steps} supersteps, {len(stats)} level runs")
            profile_once("bench_scale_pool", lambda: run_queries(
                runner, sources, lambda *a: None), need_trace=False)
        else:
            res = run_queries(runner, ev, lambda *a: None)[0]
        pred = np.stack([res[int(s)] for s in ev])
        mean = precision_spread(f"at index seed {seed}", pred, ex, rng)
        if not mean >= MIN_PRECISION:
            fail(f"phase 18: precision@{K} {mean:.4f} < {MIN_PRECISION} over "
                 f"{BIG_EVAL} at index seed {seed}")
        del runner, index, res
        torch.cuda.empty_cache()
    launches = run_wide(g, dg, sources, ex, dev)
    print(f"phase 18 peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    return launches


def run_wide(g, dg, sources, ex, dev) -> dict:
    """Phase 18's build past 2^30 keys (see run_bench_scale); returns its
    launches."""
    import numpy as np
    import torch
    from fora_tpu_torch import ForaConfig
    from fora_tpu_torch import index as tidx
    from fora_tpu_torch import kernels
    from fora_tpu_torch.algo.topk import TopkRunner
    from fora_tpu_torch.index import build as ib

    def cfg(scale):
        return ForaConfig(epsilon=EPS, k=K, rmax_scale=scale).resolved(g.n,
                                                                       g.m)
    scale = next(s for s in range(1, 64)
                 if tidx.index_counts(g.out_deg, cfg(s)).sum() > WIDE_WALKS)
    wcfg = cfg(scale)
    t = ib.pack_tables(tidx.index_counts(g.out_deg, wcfg), g.out_deg)
    # nothing of the pack may run on the host
    host = ("_pack_plain", "_plain_windows", "_pack_legacy",
            "pack_index_plain", "with_indptr")
    saved = {n: getattr(ib, n) for n in host}

    def refuse(name):
        def f(*a, **kw):
            fail(f"phase 18: the past-2^30 pack called {name} on the host")
        return f
    digests, logs = [], []
    for half in (False, True):
        log = {}
        walk_s = 0.0
        if half:
            # the same endpoints, walked again; the windows of half the keys
            # held against the plain chain before they are packed
            cap = logs[0]["window_keys"] // 2
            torch_sync()
            t1 = time.perf_counter()
            with ib._splitter(log, dev)("walk"):
                ends, counts, deg = ib.index_endpoints(dg, dg, wcfg, SEED,
                                                       dev)
            walk_s = time.perf_counter() - t1
            plan = hold_wide_windows(ends, t, cap, dev)
            held = time.perf_counter() - t1 - walk_s
        for n in host:
            setattr(ib, n, refuse(n))
        kernels.reset_launch_counts()
        torch_sync()
        t1 = time.perf_counter()
        try:
            if not half:
                idx = tidx.build_walk_index(dg, wcfg, SEED, log=log)
            else:
                with sort_cap(cap):
                    idx = ib.pack_index(ends, counts, deg, wcfg, log=log,
                                        free_endpoints=True)
                del ends
        finally:
            for n, f in saved.items():
                setattr(ib, n, f)
        wall = time.perf_counter() - t1 + walk_s
        c = kernels.launch_counts()
        if half and (log["window_keys"] != cap or
                     log["windows"] != len(plan)):
            fail(f"phase 18: {log['windows']} windows of at most "
                 f"{log['window_keys']} keys packed, {len(plan)} of {cap} "
                 "held")
        if log["windows"] < 2 or c["pack_keys_window"] != log["windows"] or \
                c["pack_keys"] or c["pack_key_counts"] < 1 or \
                c["sort_keys"] != log["windows"] or \
                c["merge_keys"] != log["windows"]:
            fail(f"phase 18: the past-2^30 pack in {log['windows']} "
                 f"windows launched {c}")
        if not half:
            launches = c
            t2 = time.perf_counter()
            check_wide(idx, t, dev)
            checked = time.perf_counter() - t2
        t2 = time.perf_counter()
        digests.append(index_sha(idx))
        hashed = time.perf_counter() - t2
        logs.append(log)
        print(f"past-2^30 index (rmax_scale {scale}"
              + (", windows of half the keys" if half else "")
              + f"): {t.keys} keys of {2 * t.nb + 4} bits in "
              f"{log['windows']} windows of at most {log['window_keys']} "
              f"keys, {idx.total_edges} edges, built in {wall:.2f} s; "
              f"launches: count form {c['pack_key_counts']}, window form "
              f"{c['pack_keys_window']}, sort {c['sort_keys']}, merge "
              f"{c['merge_keys']}; split, s: " + ", ".join(
                  f"{k} {v:.4f}" for k, v in log["split_s"].items())
              + f"; sha256 {hashed:.1f} s"
              + (f"; its windows held against the plain chain in {held:.1f} "
                 "s" if half else f"; checked in {checked:.1f} s"))
        if half:
            break
        del idx
    if digests[0] != digests[1] or logs[1]["windows"] <= logs[0]["windows"]:
        fail(f"phase 18: the past-2^30 index in {logs[0]['windows']} "
             f"windows differs from the same endpoints in "
             f"{logs[1]['windows']}")
    print(f"past-2^30 index: sha256-equal in {logs[0]['windows']} and "
          f"{logs[1]['windows']} windows; the bucket multiplicities equal "
          "the tables', (bucket, dst, src) strictly increasing, the "
          "pointers with_indptr's; the count form's bins and, in each of "
          f"the {logs[1]['windows']} windows, the window form, K7-sort and "
          "K7-merge equal to the plain chain")
    runner = TopkRunner(dg, wcfg, k=K, index=idx, delta_stride=DSTRIDE,
                        accept_slack=ACCEPT)
    res, _, _, wall, _ = run_queries(runner, sources[:POOL], lambda *a: None)
    pred = np.stack([res[int(s)] for s in sources[:WIDE_EVAL]])
    per = [len(set(p.tolist()) & set(e.tolist())) / K
           for p, e in zip(pred, ex[:WIDE_EVAL])]
    print(f"past-2^30 index: a pool of {POOL} queries in {wall:.3f} s; "
          f"precision@{K} over the first {WIDE_EVAL} {np.mean(per):.4f} (no "
          f"gate: precision falls as rmax_scale rises)")
    del runner, idx
    torch.cuda.empty_cache()
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
        # K6+K4-xp's earlier kernel (probes/xp_walk_forms.cu, phase 17's
        # yardstick) and K4-xp's earlier forms (probes/index_xp_forms.cu,
        # phase 15's) compile beside the package's sources
        import threading
        from fora_tpu_torch.probes import index_xp_probe, xp_walk_probe
        forms_build = [threading.Thread(target=m.load_forms)
                       for m in (xp_walk_probe, index_xp_probe)]
        for t in forms_build:
            t.start()
        lib_path = kbuild.build()
        kbuild.library()
        for t in forms_build:
            t.join()
        built = ("cached" if kbuild.last_build_secs is None
                 else f"{kbuild.last_build_secs:.1f} s")
        print(f"build: {lib_path} ({built})")
        log = lib_path.parent / "nvcc.log"
        for line in log.read_text().splitlines():
            if "Used" in line or "Compiling entry" in line:
                print("  ptxas:", line.split("ptxas info    :")[-1].strip())

    # phase 18's graph, made by a process of its own beside phases 3-14
    big_graph = None if args.profile else start_big_graph()

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
    build_log = {}
    with Phase("index build"):
        index = build_index(g, dg, rcfg, log=build_log)
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

    # ---- 8. K7, the pack on the card --------------------------------------
    with Phase("pack K7"):
        rows.update(run_pack(g, dg, rcfg, index, build_log, dev))

    # ---- 9. the graph-sharded engine -------------------------------------
    with Phase("sharded"):
        sharded_rows, sharded_launches, sh_iters = run_sharded(
            g, rcfg, index, sources[:POOL], dev, ex[:EVAL_N])
        rows.update(sharded_rows)
        (raw1_launches, raw1_steps, rows["index_walk_sharded"],
         fused9) = run_sharded_raw(g, rcfg, sources[:POOL], ex[:EVAL_N], dg,
                                   "sharded raw")

    # ---- 10.-12. raw walk, Monte Carlo, P3 --------------------------------
    with Phase("raw walk"):
        raw_launches, k6_rows = run_raw(dg, rcfg, sources, ex[:EVAL_N],
                                        hub=hub, k6=True)
        rows.update(k6_rows)
        rows["raw_walk"].update({"sharded_" + k: fused9[k] for k in (
            "ms", "device_ms", "chain_device_ms", "plain_ms", "bound_ms",
            "max_abs_err")})
    with Phase("montecarlo"):
        mc_launches = run_montecarlo(dg, rcfg, sources, ex[:EVAL_N])
        # HubPPR's chunk on phase 3's hub index (the CLI's default pool)
        source_walk_row(dg, rcfg, sources, "HubPPR's chunk", hub=hub)
        del hub
    with Phase("P3"):
        rows["row_scatter_add"], p3_launches = run_p3(dev)

    # ---- 15. the sharded refinement pool -----------------------------------
    with Phase("sharded pool"):
        (rows["frontier_compact"], rows["row_scatter_add_receive"],
         rows["exchange_clear"], pool_launches, pool_stats,
         build_launches, build_digest) = run_sharded_pool(
             g, rcfg, index, sources, dev, ex[:EVAL_N],
             (results, single_vals))
        # K4-xp, the walks of the build across processes, on the whole
        # build over two simulated processes
        rows["index_walk_xp"] = index_xp_simulation(g, dg, rcfg, dev,
                                                    "uniform")

    # ---- 16. K5, the frontier-compacted push, and node order ---------------
    with Phase("frontier push"):
        (rows["frontier_prepass"], rows["frontier_push"],
         k5_launches) = run_frontier(g, rcfg, runner._levels[-1][1], sources,
                                     dev)
    with Phase("relabel"):
        relabel_launches = run_relabel(g, rcfg, index, sources, dev,
                                       ex[:EVAL_N], x)

    # ---- 17. the sharded one-shot across processes --------------------------
    with Phase("multiprocess"):
        rows["raw_walk_xp"], xp_launches, mp_xch, ixp_launches = \
            run_multiprocess(g, rcfg, index, sources[:MP_SOURCES],
                             ex[:EVAL_N], dg, dev, build_digest,
                             rows["index_walk_xp"]["rounds"])
        for name, key in (("frontier_compact", "frontier_compact"),
                          ("row_scatter_add_receive", "row_scatter_add"),
                          ("exchange_clear", "exchange_clear")):
            rows[name]["multiprocess_launches"] = mp_xch[key]

    # ---- 13. weighted graphs ---------------------------------------------
    del dg, dg_flat, index, runner, staged, results, x, lvl, inv, sched
    torch.cuda.empty_cache()
    with Phase("weighted"):
        (rows["index_walk_alias"], w_launches, w_raw_launches,
         w_mc_launches, w_pool_launches, w_raw1_launches, w_raw1_steps,
         rows["index_walk_sharded_alias"], w_xp_row,
         w_ixp_row) = run_weighted(g, rcfg, dev)
    rows["raw_walk_xp"].update({"alias_" + k: v for k, v in w_xp_row.items()
                                if k not in ("library_ms", "bound_by")})
    rows["index_walk_xp"].update({"alias_" + k: v
                                  for k, v in w_ixp_row.items()
                                  if k not in ("library_ms", "bound_by")})

    # ---- 14. the CLI and the server ----------------------------------------
    torch.cuda.empty_cache()
    with Phase("cli"):
        cli_launches = run_cli(g, rcfg, sources, ex[:EVAL_N], dev)

    # ---- 18. the main path at bench.py's own scale ---------------------------
    # (the 2^19 graphs and indexes on the card were freed before phase 13)
    torch.cuda.empty_cache()
    with Phase("bench scale"):
        wide_launches = run_bench_scale(big_graph, dev)

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
    # K7: phase 4's build packed on the card in one sort, once each, with
    # no count or window form
    for name in PACK_KERNELS:
        if launches[name] != 1:
            fail(f"K7's {name}: {launches[name]} launches in phase 4's "
                 "build, expected 1")
    for name in WINDOW_KERNELS:
        if launches[name]:
            fail(f"K7-keys' {name}: {launches[name]} launches in phase 4's "
                 "build, which fits one sort")
    print(f"launches in phase 18's past-2^30 build: {wide_launches}")
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
    if mc_launches["source_walk"] <= 0:
        fail("K6+K4-src was not launched on the Monte Carlo path")
    # K6 and K6+K4: the raw pools run the demand once per walk phase and
    # K6+K4 once per chunk, and no K6-expand, K6-accum or K4 launch of
    # their own; Monte Carlo and HubPPR's queries K6+K4-src alone (once
    # per chunk: run_montecarlo and run_cli check the counts); the raw
    # one-shots' counts are checked with theirs below; no path without a
    # walk phase runs any of them, and K6-expand and K6-accum run on no
    # path
    k6 = ("walk_demand", "expand_lanes", "accumulate_endpoints", "raw_walk",
          "source_walk")
    for label, c, k4 in (("phase 10's raw pool", raw_launches, "index_walk"),
                         ("phase 13's weighted raw pool", w_raw_launches,
                          "index_walk_alias")):
        if c["walk_demand"] <= 0 or c["raw_walk"] != c["chunks"] or \
                c["expand_lanes"] or c["accumulate_endpoints"] or c[k4] or \
                c["source_walk"]:
            fail(f"{label}: launches {[c[x] for x in k6 + (k4,)]} of "
                 f"{k6 + (k4,)}, expected the demand, K6+K4 once for each "
                 f"of {c['chunks']} chunks and none of the others")
        print(f"{label}: K6+K4 once per chunk ({c['chunks']}), the demand "
              f"{c['walk_demand']} times, no K6-expand, K6-accum or {k4}")
    for label, c in (("phase 11's Monte Carlo", mc_launches),
                     ("phase 13's Monte Carlo", w_mc_launches),
                     ("phase 14's hubppr", cli_launches["hubppr"])):
        if c["source_walk"] <= 0 or c["walk_demand"] or \
                c["expand_lanes"] or c["raw_walk"] or \
                c["accumulate_endpoints"] or c["index_walk_hub"]:
            fail(f"{label}: K6 launches {[c[x] for x in k6]} and "
                 f"{c['index_walk_hub']} of K4-hub, expected K6+K4-src "
                 "alone")
    if any(c[x] for x in k6 for c in (
            launches, sharded_launches, p3_launches, w_launches,
            w_pool_launches, build_launches, k5_launches, relabel_launches,
            *pool_launches.values(),
            *[v for a, v in cli_launches.items() if a != "hubppr"])):
        fail("K6 or K6+K4 ran on a path without a walk phase")
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
                 "raw_walk"):
        if w_raw_launches[name] <= 0:
            fail(f"kernel {name} was not launched on the weighted raw path")
    if w_mc_launches["source_walk"] <= 0:
        fail("K6+K4-src was not launched by weighted Monte Carlo")
    if any(c["index_walk"] for c in (w_launches, w_raw_launches,
                                     w_mc_launches)):
        fail("a weighted path launched K4's uniform branch")
    if any(c["index_walk_alias"] or c["index_walk_sharded_alias"]
           for c in (launches, sharded_launches, raw_launches, mc_launches,
                     p3_launches, *raw1_launches.values(), build_launches,
                     *pool_launches.values())):
        fail("K4's alias branch was launched on an unweighted path")
    # the raw one-shot (phase 9, and on the weighted graph in phase 13):
    # K6+K4's sharded form once per chunk of its walk phase (its alias
    # branch on the weighted graph) and the demand once (every shard's in
    # one launch of the list form), no K4
    # branch, K6-expand or K6-accum of their own; K1, K3's selection once
    # per shard, P2's one pass once, no K2; P1 on every superstep that
    # took the ring; under routed the compaction, P3 once per shard per
    # compacted superstep and the clear once per compacted superstep that
    # follows a compacted one
    for label, runs, steps in (("phase 9", raw1_launches, raw1_steps),
                               ("phase 13", w_raw1_launches, w_raw1_steps)):
        for mode, c in runs.items():
            st = steps[mode]
            print(f"launches in {label}'s raw one-shot ({mode}, "
                  f"{st['supersteps']} supersteps, {st['compacted']} "
                  f"compacted, {st['fell_back']} fell back, "
                  f"{st['chunks']} walk chunks): {c}")
            ring_steps = (st["supersteps"] if mode == "dense"
                          else st["fell_back"])
            want = {"raw_walk": st["chunks"], "push_prepass": None,
                    "gather_scatter_add": None, "topk_bounds": SHARDS,
                    "reduce_scatter_onepass": 1, "index_spmv": 0,
                    "index_walk": 0, "index_walk_alias": 0,
                    "index_walk_sharded": 0, "index_walk_sharded_alias": 0,
                    "ring_reduce_scatter_hop": 0,
                    "ring_all_gather_hop": hops * ring_steps,
                    "row_scatter_add": SHARDS * st["compacted"],
                    "exchange_clear": st["cleared"],
                    "walk_demand": 1, "expand_lanes": 0,
                    "accumulate_endpoints": 0, "source_walk": 0}
            if st["chunks"] <= 0:
                fail(f"{label}'s raw one-shot ({mode}): no walk chunk")
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
    need = {"build": ("index_walk",) + PACK_KERNELS,
            "batch-topk": MAIN_KERNELS[:4], "serve": MAIN_KERNELS[:4],
            "batch-topk sharded": MAIN_KERNELS[:4] + (
                "reduce_scatter_onepass", "frontier_compact"),
            "serve sharded": MAIN_KERNELS[:4] + (
                "ring_all_gather_hop", "reduce_scatter_onepass"),
            "fwdpush": ("push_prepass", "gather_scatter_add"),
            "hubppr": ("index_walk", "source_walk"),
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
    # phase 17: K6+K4-xp in the raw run across processes, on no other path
    print(f"launches in phase 17's raw one-shot across {MP_PROCS} processes "
          f"(summed): {xp_launches}")
    for name in ("raw_walk_xp", "raw_walk_xp_inbox"):
        if xp_launches[name] <= 0:
            fail(f"K6+K4-xp's {name} was not launched by the raw one-shot "
                 f"across processes")
    if any(c["raw_walk_xp"] or c["raw_walk_xp_inbox"] for c in (
            *earlier, relabel_launches, *raw1_launches.values(),
            *w_raw1_launches.values(), build_launches, k5_launches,
            *cli_launches.values())):
        fail("K6+K4-xp ran on a path within one process")
    # phase 17: K4-xp in the index build across processes, on no other path
    print(f"launches in phase 17's index build across {MP_PROCS} processes "
          f"(summed): {ixp_launches}")
    for name in ("index_walk_xp", "index_walk_xp_inbox"):
        if ixp_launches[name] <= 0:
            fail(f"K4-xp's {name} was not launched by the index build "
                 f"across processes")
    if any(c["index_walk_xp"] or c["index_walk_xp_inbox"] for c in (
            *earlier, relabel_launches, *raw1_launches.values(),
            *w_raw1_launches.values(), build_launches, k5_launches,
            *cli_launches.values())):
        fail("K4-xp ran on a path within one process")
    loaded = sorted(foreign_modules() - preloaded)
    if loaded:
        fail(f"the port imported JAX or fora_tpu: {loaded[:5]}")
    # K6+K4-src's row is Monte Carlo's chunk, with its alias branch on the
    # weighted one and its hub branch on HubPPR's; K6-accum's carries its
    # time at Monte Carlo's shape, where the paths called it before
    rows["source_walk"] = dict(source_rows["K4"]["row"])
    for pre, key in (("alias_", "K4-alias"), ("hub_", "K4-hub")):
        rows["source_walk"].update(
            {pre + k: v for k, v in source_rows[key]["row"].items()
             if k in ("ms", "device_ms", "chain_device_ms", "plain_ms",
                      "bound_ms", "max_abs_err")})
    rows["accumulate_endpoints"].update(
        {"montecarlo_" + k: v for k, v in source_rows["K4"]["accum"].items()})
    # K6-demand's row is phase 10's largest walk phase; its list form on
    # phase 9's one-shot residues (four shards, every query) beside the
    # earlier form a shard and the stack
    rows["walk_demand"].update(
        {"sharded_" + k: v for k, v in demand_rows["sharded"].items()})
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
        # K6+K4: the lane -> node map and weight, the walks and the
        # endpoints' segment_sum in one launch (phase 10's largest walk
        # phase; its sharded form on phase 9's allocation in sharded_*)
        "raw_walk": ("walk.cu", "fora_tpu/ops/walk.py:63, 159, 323"),
        # K6+K4-src: Monte Carlo's source-rooted walks and their endpoints'
        # segment_sum in one launch (phase 11's chunk; its alias branch on
        # phase 13's, its hub branch on HubPPR's chunk in alias_* and hub_*)
        "source_walk": ("walk.cu", "fora_tpu/algo/montecarlo.py:34-49, "
                                   "fora_tpu/algo/hubppr.py:183-193"),
        # K6+K4-xp: the row-sharded lockstep walk across processes, a psum
        # a hop (phase 17's first raw chunk over two simulated processes;
        # its launches the workers' raw run's)
        "raw_walk_xp": ("walk.cu", "fora_tpu/ops/walk.py:225-266"),
        # K4-xp: the index build's row-sharded lockstep walk across
        # processes, a psum a hop (phase 15's whole build over two
        # simulated processes, its alias hops on phase 13's; its launches
        # phase 17's first build across the gloo workers)
        "index_walk_xp": ("walk.cu", "fora_tpu/ops/walk.py:269"),
        # K7: the index pack's keys, radix sort and run-length merge with
        # the unpack, host C++ in the JAX package (phase 8's endpoints;
        # its launches phase 4's build)
        "pack_keys": ("pack.cu", "fora_tpu/_native/radix_sort.cpp:137, 179"),
        "sort_keys": ("pack.cu", "fora_tpu/_native/radix_sort.cpp:53"),
        "merge_keys": ("pack.cu",
                       "fora_tpu/_native/radix_sort.cpp:117, 157, 205"),
        # K7-keys' count and window forms: the same keys, a window's at a
        # time, for an index past one sort (phase 8's endpoints; their
        # launches phase 18's past-2^30 build)
        "pack_key_counts": ("pack.cu", "fora_tpu/_native/radix_sort.cpp:179"),
        "pack_keys_window": ("pack.cu",
                             "fora_tpu/_native/radix_sort.cpp:137, 179"),
    }
    out = []
    for name, (src_file, replaces) in meta.items():
        row = rows[name]
        n = (launches[name] if name in MAIN_KERNELS + PACK_KERNELS else
             wide_launches[name] if name in WINDOW_KERNELS else
             p3_launches[name] if name == "row_scatter_add" else
             pool_launches["routed"]["row_scatter_add"]
             if name == "row_scatter_add_receive" else
             pool_launches["routed"][name]
             if name in ("frontier_compact", "exchange_clear") else
             build_launches[name] if name == "index_walk_sharded" else
             w_raw1_launches["dense"][name]
             if name == "index_walk_sharded_alias" else
             w_launches[name] if name == "index_walk_alias" else
             cli_launches["bippr"][name] if name == "backward_prepass" else
             cli_launches["hubppr"][name] if name == "index_walk_hub" else
             k5_launches[name] if name.startswith("frontier_p") else
             mc_launches[name] if name in ("accumulate_endpoints",
                                           "source_walk") else
             xp_launches[name] + xp_launches["raw_walk_xp_inbox"]
             if name == "raw_walk_xp" else
             ixp_launches[name] + ixp_launches["index_walk_xp_inbox"]
             if name == "index_walk_xp" else
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
                                           "unsharded_ms", "earlier_ms",
                                           "earlier_device_ms",
                                           "bytes_bound_ms",
                                           "chain_device_ms", "forms",
                                           "rounds", "earlier_forms",
                                           "multiprocess_launches",
                                           "passes", "unique_ms",
                                           "profiled_device_ms",
                                           "host_numpy_pack_s",
                                           "card_pack_s", "digit_bits",
                                           "device_split_ms", "width_ms",
                                           "width_device_ms",
                                           "width_passes",
                                           "bound_6_passes_ms",
                                           "copy_back_s", "unfused_ms",
                                           "unfused_device_ms",
                                           "earlier_bound_ms",
                                           "profiled_unfused_device_ms",
                                           "profiled_earlier_device_ms",
                                           "counted_ms", "window_keys",
                                           "windowed_pack_s",
                                           "one_sort_pack_s",
                                           "build_pack_s",
                                           "counted_device_ms",
                                           "count_device_ms",
                                           "build_keys_s")
                       if k in row},
                    **{k: v for k, v in row.items()
                       if k.startswith(("sharded_", "montecarlo_", "alias_",
                                        "hub_"))}})
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
