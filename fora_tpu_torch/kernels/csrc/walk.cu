// K4 · index_walk: endpoints of alpha-terminating random walks, uniform hops
// or (on a weighted graph) alias-table hops, run from a queue of walks that
// each warp owns.
//
// Replaces fora_tpu/ops/walk.py::run_walks_scheduled (159-222) with
// geometric_lengths (89-99), the XLA-lowered walk that builds the FORA+
// index, and its alias branch (212-218; run_walks 115-116, 128-132).  On the
// TPU the walks advance in lockstep, sorted by their pre-drawn length so
// that hop h runs on a shrinking static prefix (hop_widths), with a
// fallback to the plain lockstep walk when a prefix overflows.  Neither the
// sort nor a launch per hop exists here: the walk state stays in registers.
//
// Per walk w:
//   len = min(floor(log(u0) / log(1 - alpha)), max_hops),  u0 in (0, 1]
//   repeat len times: d = indptr[cur + 1] - indptr[cur]
//                     stop at a dangling node (d == 0 absorbs)
//                     slot = indptr[cur] + min(floor(u_h * d), d - 1)
//                     uniform: cur = out_indices[slot]
//                     alias:   cur = u2_h < alias_prob[slot] ? out_indices[slot]
//                                                            : alias_other[slot]
// Random numbers: Philox-4x32-10 (philox.cuh) keyed by (seed low word, w),
// with (hop, seed high word) as the counter; u0 is block 0's first word, u_h
// block h+1's first and u2_h its second, so the alias hop costs no second
// Philox call.  Nothing in the stream depends on the thread that runs the
// walk, so the endpoint of walk w is a function of (seed, w, start[w]) alone:
// ops/walk.py::run_walks_philox draws the same bits in plain PyTorch, and the
// card's tests and chip_smoke.py hold this kernel to it bit for bit.  The
// endpoints match JAX's in distribution only; JAX draws threefry bits.
//
// The hub branch (kHub, HubPPR's query walks) replaces
// fora_tpu/algo/hubppr.py::hub_walks (143-180): every node a hop reaches is
// looked up in hub_id; at a hub (hid >= 0) the walk ends at one entry of that
// hub's pool of precomputed endpoints,
//   cur = pool[hid * P + min(floor(u3_h * P), P - 1)],
// with u3_h the third word of the hop's Philox block.  The start node never
// substitutes (only a hop's landing is looked up).  On a weighted graph the
// hop is the alias hop: the JAX function hops uniformly there (ROADMAP C14).
//
// What bounds it on the H100: each hop's loads (row pointers, then the
// edge list; the alias tables; hub_id), which every walk issues for itself,
// against a bound that counts each 32-byte sector once per hop however many
// walks read it (chip_smoke.py::walk_bound, which prints beside it the time
// of the walks' own reads, as if no two shared a sector).  Not the Philox
// rounds: one block a walk and one a hop take a fifth of the time at the
// rate that philox_probe.cu measures.  Nor idle lanes alone: one walk per
// thread, run to its own length, left a warp waiting for its longest walk
// (32 Geometric(0.2) lengths have a largest member of about 17.7 hops
// against a mean of 4); the queue below keeps the lanes busy, and gains far
// less than lane use alone would (PERF.md).
// The design:
//  * A warp owns a contiguous range of 32 k walks (k walks per lane, from
//    kernels/schedule.py::walk_plan: 4 where the walks fill the card, 2 or
//    1 where they would not).  Each lane holds one live walk in registers
//    (w, cur, h, len); a lane whose walk ends writes the endpoint and takes
//    the next walk of the range: one __ballot_sync of the lanes that need a
//    walk, each takes used + popc(mask & lanes below it).  No atomics, no
//    sync across warps; a warp exits when its range is done and the grid is
//    not persistent, so finished blocks make room for new ones.
//  * A lookahead: the range's next 32 walks' starts and lengths (block 0
//    and a logf each) computed by all 32 lanes at once and handed out by
//    __shfl_sync, so no step pays for a Philox block and a logf on the few
//    lanes that refill while the others wait.  A walk of length 0 ends in
//    the refill.
//  * The degree is indptr[cur + 1] - indptr[cur], two loads issued together
//    (out_deg is not read), and the hop's Philox block is computed while
//    they are in flight.  The hub branch looks up the node a hop reached
//    right after the hop.  The alias hop reads alias_prob[slot] and then
//    only the table it picks.
//  * Endpoints are staged in shared memory, a warp's range of 32 k ints (4
//    KiB a block at k = 4), and written out coalesced when the range is
//    done.
// Each of these beat its alternative on the H100 (PERF.md): endpoints
// written to out[w] as each walk ends; the alias hop's three loads issued
// together (one round trip, one more sector); the hub lookup issued with the
// next hop's row pointers, with one more lookup after the final hop.
//
// The sharded form (kSharded, index_walk_sharded_kernel) replaces
// fora_tpu/ops/walk.py::sharded_lockstep_walk (225-266) and
// sharded_lockstep_walk_scheduled (269-320): the walks of the sharded raw
// one-shot and of the sharded index build, over an out-CSR split into G row
// slices (index/build_sharded.py::_shard_csr): per shard s a localized
// indptr_s [n_loc + 1], its edges indices_s and, weighted, alias_prob_s /
// alias_other_s.  On the TPU every shard holds only its slice, the walk
// state is replicated, and each hop the owner of a walk's row samples it and
// one psum combines the shards.  Here the kernel takes a table of the G
// slices' pointers and a hop reads the owner's slice itself:
//   s = cur / n_loc,  row = cur - s * n_loc,
//   d = indptr_s[row + 1] - indptr_s[row],  slot = indptr_s[row] + j,
//   cur = indices_s[slot]  (alias: alias_prob_s[slot], then one table).
// Everything else is the hop above: the same Philox words, length and
// dangling rules and the same walk queue, so a walk's endpoint is the one
// index_walk_kernel gives on the unsharded graph, bit for bit.  On one card
// every slice lies in one memory and the table replaces the psum.  Across
// cards the table would hold peer-mapped slices (kernels.enable_peer_access);
// that form waits for a machine with several cards and is not tested.  The
// table is copied into shared memory by constant indices (a dynamic index
// into the kernel's parameters would copy them to local memory).
//
// K6+K4 (raw_walk_kernel<kAlias, kSharded>) is one chunk of the raw walk
// phase in one launch: the lane -> node map and weight of
// fora_tpu/ops/walk.py::allocate_walks (63-80), the walks of
// run_walks_scheduled (159) and the endpoints' segment_sum of
// accumulate_endpoints (323-329).  It computes what the chain K6-expand
// (walk_alloc.cu) -> K4 -> K6-accum computes on the same chunk: lane l of
// column b starts at the first v with cum[v] > l, weighs r[v, b] / omega_v
// (an IEEE division) and draws as walk t * Bc + b of the chain's [rows,
// Bc] start array, so every endpoint is the chain's bit for bit; only the
// order of the f32 adds differs.  The chain moved 12-20 bytes a lane
// through three launches and lost its time to latency: 19 dependent
// probes a lane in the expansion and a scattered RED a lane in the
// accumulate.  Here:
//  * A warp owns a tile of one column, 32 k consecutive lanes (k from
//    raw_walk_plan: 16 for uniform hops where the walks fill the card,
//    against K4's 4; alias hops keep 4, PERF.md), and runs walk_range's
//    queue over them; lanes past the column's demand (the chain's
//    padding, weight 0) are not walked.
//  * The refill's lookahead lane searches its lane's start node.  The
//    lanes of a column are non-decreasing in node, so the search gallops
//    forward from the node of the previous batch's last lane: a hub's run
//    of lanes costs one probe, and the batch's probes share their path in
//    the L1.  Only a tile's first lane, and a lane that enters the next
//    shard, search in full: the first by the whole warp, 32 probes a step
//    (4 dependent loads for 2^19 nodes, where one lane's bisection takes
//    19).  The weight is read there, beside cum[v - 1].
//  * A walk that ends adds its weight where it ends (no [rows, Bc] array
//    of starts, weights or endpoints).  A warp's walks all belong to one
//    column, and a fifth of them have no hop: a refill that hands out a
//    hub's run ends about 6 of its 32 walks on one node, so those lanes
//    group by endpoint (__match_any_sync), sum in lane order, and the
//    lowest issues one RED.  After a hop, where endpoints rarely meet in
//    one step, each walk issues its own RED (grouping there cost more
//    than it saved on the H100).
//  * Sharded: a lane finds its shard from the running totals bounds [G +
//    1, Bc], starts at its node + h * n_loc, hops over the slice table and
//    adds into its shard's partial.
// What bounds it: K4's hop loads and Philox blocks, plus the sectors of cum
// and r at the lanes' nodes and of the output it adds into
// (chip_smoke.py::raw_walk_bound).  No [W, B] array, so no bytes a lane.
//
// K6+K4-xp is K6+K4's sharded form in one process of several: the raw
// one-shot's walk phase with its G graph shards spread over P processes of
// L shards each (process q holds shards q L .. q L + L - 1, and so the rows
// q L n_loc .. (q + 1) L n_loc - 1).  It replaces fora_tpu/ops/walk.py::
// sharded_lockstep_walk (225-266), whose every lane advances one hop at a
// time on every shard, the owner's sample combined by one psum a hop (G
// W_loc B 4 bytes a hop).  Here a walk is handed to the process that owns
// its node instead, as a 16-byte record
//   (w, cur, h | len << 16, weight bits),  h < len <= max_hops < 2^15,
// and a chunk runs in rounds: round 0 walks the process's own lanes, each
// later round the records the others handed over in the round before.  So
// a launch has one source of walks, and each source is a form of its own,
// with its own launch bounds and plan (kernels/schedule.py::xp_walk_plan):
//  * The own-lane form (xp_own_kernel, round 0) is raw_walk_range itself,
//    sharded, with a leave branch: the lane search (lookahead and gallop),
//    the walks of no hop grouped by endpoint (add_grouped), the slice table
//    holding this process's L slices at their global shard index, every
//    end added into the process's one [n_pad, Bc] partial.
//  * The inbox form (xp_inbox_kernel, rounds >= 1) runs walk_range's queue
//    over a warp's 32 k records: a refill is one 16-byte load a lane, and
//    the length travels in the record, so no refill computes a Philox
//    block 0 or a logf.  No bounds, demand or residue is read.
// Each form runs 4 blocks an SM (kXpOwnBlocksPerSM, kXpInboxBlocksPerSM):
// the staged outbox's state and its out-of-line flush take 64 registers,
// and at K6+K4's 6 blocks (40 registers) both forms spill and run slower
// on the H100 (probes/xp_walk_probe.py; PERF.md).
// In both, a walk advances while its node lies in the process's rows; one
// that ends adds its weight at its endpoint (any row, column w % Bc) into
// the partial; one whose next hop starts at another process's node leaves.
// Leaving records go first into the block's stage in shared memory
// (XpStage: kStageRecords records, kWarpStage of them a warp's, split into
// a bin for each other process, each bin's count in shared memory beside
// it); the lanes that leave to one destination in a step are one group
// (__match_any_sync), whose leader reads the bin's count for all of it; a
// bin that cannot take the group's records takes its place in the outbox
// with one global atomic and goes out in contiguous 16-byte stores, and
// what the bins hold when the warp's walks are done goes out alike.  A
// warp owns its bins, so no warp waits for another and the counts need no
// atomic.  The earlier kernel took one global atomic a warp, step and
// destination on only P words (probes/xp_walk_forms.cu keeps it, and these
// forms with its per-group atomics, for probes/xp_walk_probe.py).  A hop's
// draw depends only on (seed, w, h) and the length on (seed, w), so every
// walk ends where K6+K4's sharded form ends it, bit for bit; only the order
// of the f32 adds differs.  The outbox holds, per destination, as many
// records as the launch has walks, so none is ever dropped: counts past it
// would mean a fault, and the host refuses them.
// What bounds it: K6+K4's bound on the process's walks, plus 16 bytes a
// record written here and read by the receiver (chip_smoke.py).
//
// K4-xp is K4's sharded form in one process of several: the index build's
// walks with the G graph shards spread over P processes of L each.  It
// replaces fora_tpu/ops/walk.py::sharded_lockstep_walk_scheduled (269-320,
// reached through fora_tpu/index/build_sharded.py::_sharded_walk_kernel,
// 84-95) and its plain twin sharded_lockstep_walk (225-266) over a mesh
// whose graph axis spans processes: every lane advances a hop at a time on
// every shard, the owner's sample combined by one psum a hop, so every
// process ends with every endpoint.  Here a walk is handed to the process
// that owns its node as K6+K4-xp hands it, a record (w, cur, h | len << 16,
// 0): an index walk carries no weight.  The rounds run over a window of
// whole chunks at once (kernels/schedule.py::build_windows), so the build
// pays the rounds of its longest chunk, not their sum: walk w (its number
// in the build's node-sorted starts) draws as walk w % chunk_lanes of chunk
// c = w / chunk_lanes at seed + c 2^32, as the one-process build draws it.
// The starts are sorted by node, so a process's own starts of a window are
// one run w0 .. w0 + W - 1.
//  * The own-start form (index_xp_own_kernel, round 0) is K4's walk_range
//    over that run; a walk that leaves writes -1 into its staged end
//    slot, so the range's coalesced write of its ends carries no stale
//    node.
//  * The inbox form (index_xp_inbox_kernel, rounds >= 1) is a grid of
//    resident blocks whose warps claim the inbox's records, 32 k at a time
//    (every warp's first claim its own, the later ones by one atomicAdd on
//    a cursor, k shrinking as the inbox drains), and go on from one claim
//    into the next: no wave of a round ends part-filled, and a round of a
//    few hundred records runs on a few warps.  A record has about 1.5
//    hops left, so refills come often: the next 32 records are loaded
//    while the current ones are handed out.  A walk carries no weight, so
//    the body keeps no weight, partial or column.
//  * The leave path: a leaving walk costs one ballot and one 16-byte store
//    into the warp's part of the block's stage (kWarpStage records), in
//    the order the walks leave, with no group match, no count in shared
//    memory and no fence; drain_stage, out of line, sends the stage out
//    with one global atomic a destination.  A walk leaves at most once a
//    launch, so in the own-start form (ranges of at most kWarpStage walks)
//    the stage holds a range's records and goes out when no lane holds a
//    walk: the form keeps to 32 registers and K4's 8 blocks an SM
//    (kIndexXpBlocksPerSM).  The inbox form sends its stage out whenever a
//    step could overfill it, a call while walks are live, and runs 4
//    (kIndexXpInboxBlocksPerSM; at 6 and 8 it spills and runs slower on
//    the H100, PERF.md).  A chunk's division of a walk's number is a
//    multiply and a shift (chunk_draw).
// A walk's draws depend only on (seed, w, h), so every endpoint is the one
// K4's sharded form gives walk w % chunk_lanes of its chunk, bit for bit;
// the host takes the window's endpoints from every process with one max
// all-reduce of its ends (-1 where a walk ended elsewhere).  What bounds
// it: K4's walk bound on the process's walks, plus 16 bytes a record
// written and read (chip_smoke.py).  probes/index_xp_forms.cu keeps the
// earlier per-chunk forms, these at other residencies, and the inbox form
// taking a claim at a time.
//
// K6+K4-src (source_walk_kernel<kAlias, kHub>) is K6+K4's source-rooted
// form: one chunk of Monte Carlo's walks (fora_tpu/algo/montecarlo.py::
// montecarlo_query_scheduled, 34-49: source-rooted walks and their
// endpoints' segment_sum) or of HubPPR's (fora_tpu/algo/hubppr.py::
// hubppr_query, 183-193, the hub branch) in one launch.  Walk t of column b starts at
// sources[b] and draws as walk t * B + b of K4 (K4-hub) on the chain's
// sources.repeat(rows) start array, so every endpoint is the chain K4 ->
// K6-accum's bit for bit; each walk adds one constant weight at its end.
// Every walk of a column starts at one node, and the alpha of them that
// stop before a hop, with those that come back, all end there:
//  * A warp's tile is 32 k consecutive walks of one column, as K6+K4's,
//    but the columns interleave: tile j of column b is warp j * B + b, so
//    the warps resident at one time spread over every column.  In K6+K4's
//    order (column by column) they all walk from one source at once, and
//    the card's adds pile onto that source's few out-neighbours: twice the
//    chain's time on the H100 (PERF.md).  The lookahead computes only
//    lengths: a walk's start is its source.
//  * A walk that ends at the source adds nothing: each lane counts them in
//    a register, and the warp adds count x weight with one RED when the
//    tile is done, one RED a tile on the source's word where the chain
//    issued one a walk.
//  * The other walks that end in one step group by endpoint
//    (__match_any_sync), and the lowest lane of each group adds the
//    group's count x weight with one RED.  A column's walks end near its
//    source, so one step's ends often share a node, and a RED whose lanes
//    share an address is served one lane at a time; without the groups the
//    kernel took as long as the chain (PERF.md).
// No [W, B] array of starts or endpoints; `ends` is for tests and checks.
// What bounds it: K4's hop loads and Philox blocks plus the sectors of the
// output it adds into (chip_smoke.py::source_walk_bound).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kBlockWarps = 8;
constexpr int kMaxShards = 32;
constexpr int kBlockThreads = 32 * kBlockWarps;
// a block's staged endpoints stay within the 48 KiB of dynamic shared memory
// that a launch gets without an attribute
constexpr int kMaxWalksPerLane = 48;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kTwoM24 = 1.0f / 16777216.0f;

struct WalkArgs {
  const int* start;
  int* out;
  const int* indptr;
  const int* indices;
  const float* alias_prob;
  const int* alias_other;
  const int* hub_id;
  const int* pool;
  uint32_t W;      // walks, below 2^32
  uint32_t range;  // walks a warp owns: 32 * walks per lane
  int pool_size;
  uint32_t seed_lo, seed_hi;
  float inv_log1m_alpha;
  int max_hops;
  int n_loc;       // rows of a shard slice (the sharded form)
  uint32_t w0;     // K4-xp's own-start form: the Philox key of its walk 0
};

// the sharded form's slices (alias tables null on an unweighted graph)
struct ShardTables {
  const int* indptr[kMaxShards];
  const int* indices[kMaxShards];
  const float* alias_prob[kMaxShards];
  const int* alias_other[kMaxShards];
};

// the out-CSR a hop reads: one CSR (tab null), or the slice table in shared
// memory
struct ShardView {
  const int* const* indptr;
  const int* const* indices;
  const float* const* alias_prob;
  const int* const* alias_other;
};

// K4's and K6+K4's walks never leave the card's rows (K6+K4-xp's
// StagedLeave below hands them to another process)
struct NoLeave {
  static constexpr bool kXp = false;
  __device__ __forceinline__ bool outside(int) const { return false; }
  __device__ __forceinline__ void put(bool, int, uint32_t, int, int, float, int) const {}
};

__device__ __forceinline__ float unit(uint32_t x) {  // [0, 1)
  return (float)(x >> 8) * kTwoM24;
}

// hops of the walk keyed w under the seed's high word seed_hi:
// min(floor(log(u0) / log(1 - alpha)), max_hops), u0 in (0, 1]
__device__ __forceinline__ int walk_length_at(const WalkArgs& a, uint32_t w, uint32_t seed_hi) {
  const uint4 r0 = philox4x32_10(make_uint4(0u, seed_hi, 0u, 0u), make_uint2(a.seed_lo, w));
  const float u0 = (float)((r0.x >> 8) + 1u) * kTwoM24;
  return (int)fminf(floorf(logf(u0) * a.inv_log1m_alpha), (float)a.max_hops);
}

// hops of walk w
__device__ __forceinline__ int walk_length(const WalkArgs& a, uint32_t w) {
  return walk_length_at(a, w, a.seed_hi);
}

// the pool entry that a walk arriving at hub `hid` ends at
__device__ __forceinline__ int pool_entry(const WalkArgs& a, int hid, float u3) {
  const int j = min((int)(u3 * (float)a.pool_size), a.pool_size - 1);
  return __ldg(a.pool + (long long)hid * a.pool_size + j);
}

// one hop of walk w (the Philox key, under the seed's high word seed_hi) at
// node cur, h of its len hops taken: the degree from the row pointers, two
// loads issued together, and the hop's Philox block while they are in
// flight; the sharded form reads the owner's slice.  Returns whether the
// walk has ended.
template <bool kAlias, bool kHub, bool kSharded>
__device__ __forceinline__ bool hop_at(const WalkArgs& a, const ShardView& tab, uint32_t w,
                                       uint32_t seed_hi, int& cur, int& h, int len) {
  const int* indptr = a.indptr;
  const int* indices = a.indices;
  const float* alias_prob = a.alias_prob;
  const int* alias_other = a.alias_other;
  int row = cur;
  if (kSharded) {
    const int s = cur / a.n_loc;
    row = cur - s * a.n_loc;
    indptr = tab.indptr[s];
    indices = tab.indices[s];
    if (kAlias) {
      alias_prob = tab.alias_prob[s];
      alias_other = tab.alias_other[s];
    }
  }
  const int p0 = __ldg(indptr + row), p1 = __ldg(indptr + row + 1);
  const uint4 r = philox4x32_10(make_uint4((uint32_t)(h + 1), seed_hi, 0u, 0u),
                                make_uint2(a.seed_lo, w));
  bool done = p1 == p0;  // a dangling node absorbs
  if (!done) {
    const int d = p1 - p0;
    const int slot = p0 + min((int)(unit(r.x) * (float)d), d - 1);
    if (kAlias) {  // pick the table first, then load only its entry
      const int* table = unit(r.y) < __ldg(alias_prob + slot) ? indices : alias_other;
      cur = __ldg(table + slot);
    } else {
      cur = __ldg(indices + slot);
    }
    done = ++h == len;
    if (kHub) {  // look up the node just reached
      const int hid = __ldg(a.hub_id + cur);
      if (hid >= 0) {  // arrival at a hub: a pool draw ends the walk
        cur = pool_entry(a, hid, unit(r.z));
        done = true;
      }
    }
  }
  return done;
}

// one hop of walk w under the seed
template <bool kAlias, bool kHub, bool kSharded>
__device__ __forceinline__ bool hop(const WalkArgs& a, const ShardView& tab, uint32_t w,
                                    int& cur, int& h, int len) {
  return hop_at<kAlias, kHub, kSharded>(a, tab, w, a.seed_hi, cur, h, len);
}

// the walks of this warp's range: the body of K4's kernels
template <bool kAlias, bool kHub, bool kSharded>
__device__ __forceinline__ void walk_range(const WalkArgs& a, const ShardView& tab) {
  extern __shared__ int staged_ends[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint64_t lo64 = ((uint64_t)blockIdx.x * kBlockWarps + warp) * a.range;
  if (lo64 >= a.W) return;  // the last block's spare warps own no walk
  const uint32_t lo = (uint32_t)lo64;
  const uint32_t count = a.W - lo < a.range ? a.W - lo : a.range;  // walks it owns
  int* const ends = staged_ends + warp * a.range;
  const unsigned below = (1u << lane) - 1u;
  // the lookahead, the same in every lane: walks lo + batch .. + filled - 1
  // of the range, `used` of them handed out; lane i holds walk batch + i's
  // start and length, computed by all 32 lanes at once
  uint32_t batch = 0, filled = 0, used = 0;
  int ahead_start = 0, ahead_len = 0;
  uint32_t w = 0;   // this lane's walk: its number, node, hops taken, length
  int cur = 0, h = 0, len = 0;
  bool idle = true; // the lane holds no walk

  for (;;) {
    // refill: the lanes without a walk take the next ones, in lane order
    for (;;) {
      const unsigned need = __ballot_sync(kFull, idle);
      if (need == 0) break;
      if (used == filled) {
        batch += filled;
        filled = used = 0;
        if (batch >= count) break;  // the range is handed out
        filled = min(32u, count - batch);
        if ((uint32_t)lane < filled) {
          ahead_start = __ldg(a.start + lo + batch + lane);
          ahead_len = walk_length(a, lo + batch + lane);
        }
      }
      const uint32_t src = used + __popc(need & below);
      const int take_start = __shfl_sync(kFull, ahead_start, src & 31);
      const int take_len = __shfl_sync(kFull, ahead_len, src & 31);
      if (idle && src < filled) {
        w = lo + batch + src;
        cur = take_start;
        len = take_len;
        h = 0;
        if (len > 0)
          idle = false;
        else
          ends[w - lo] = cur;  // no hop: the walk ends where it starts
      }
      used = min(filled, used + __popc(need));
    }
    if (__all_sync(kFull, idle)) break;
    if (idle) continue;
    if (hop<kAlias, kHub, kSharded>(a, tab, w, cur, h, len)) {
      ends[w - lo] = cur;
      idle = true;
    }
  }
  __syncwarp();  // the range's endpoints, coalesced
  for (uint32_t i = lane; i < count; i += 32) a.out[lo + i] = ends[i];
}

template <bool kAlias, bool kHub>
__global__ void __launch_bounds__(kBlockThreads, 2048 / kBlockThreads)
    index_walk_kernel(const WalkArgs a) {
  walk_range<kAlias, kHub, false>(a, ShardView{nullptr, nullptr, nullptr, nullptr});
}

template <bool kAlias>
__global__ void __launch_bounds__(kBlockThreads, 2048 / kBlockThreads)
    index_walk_sharded_kernel(const WalkArgs a, const ShardTables t) {
  __shared__ const int* indptr[kMaxShards];
  __shared__ const int* indices[kMaxShards];
  __shared__ const float* alias_prob[kMaxShards];
  __shared__ const int* alias_other[kMaxShards];
  if (threadIdx.x < kMaxShards) {
    const int* ip = nullptr;
    const int* ix = nullptr;
    const float* ap = nullptr;
    const int* ao = nullptr;
#pragma unroll
    for (int k = 0; k < kMaxShards; ++k) {
      if (k == (int)threadIdx.x) {
        ip = t.indptr[k];
        ix = t.indices[k];
        ap = t.alias_prob[k];
        ao = t.alias_other[k];
      }
    }
    indptr[threadIdx.x] = ip;
    indices[threadIdx.x] = ix;
    alias_prob[threadIdx.x] = ap;
    alias_other[threadIdx.x] = ao;
  }
  __syncthreads();
  walk_range<kAlias, false, true>(a, ShardView{indptr, indices, alias_prob, alias_other});
}

// ---- K6+K4: the raw walk phase's chunk, lanes to endpoint mass ------------

// blocks an SM in __launch_bounds__: at most 40 registers, no spill
// (kernels/schedule.py::RAW_BLOCKS_PER_SM).  probes/raw_walk_forms.cu keeps
// the forms at 4 and 8 blocks and the other choices of raw_walk_range
// below; PERF.md gives their times.
constexpr int kRawBlocksPerSM = 6;

// the chunk's pointer tables (one entry unsharded, G sharded): each shard's
// residue (a column slice), its demand (column b at cum + b * cum_ld) and
// its partial of the endpoint mass
struct RawTables {
  const float* r[kMaxShards];
  const int* cum[kMaxShards];
  float* out[kMaxShards];
};

struct RawView {
  const float* const* r;
  const int* const* cum;
  float* const* out;
};

struct RawArgs {
  const int* total;         // [Bc] walks of each column (unsharded)
  const long long* bounds;  // [G + 1, Bc] running sums of the shards' totals (sharded)
  int* ends;                // [rows, Bc] endpoints of the walked lanes, or null
  long long r_ld, cum_ld, out_ld, lane_lo;
  uint32_t rows;            // lane rows of the chunk: lanes lane_lo .. + rows - 1
  uint32_t tiles;           // warp tiles of a column: ceil(rows / range)
  int Bc, n, G;             // columns, rows of a residue, shards
  int shard0;               // K6+K4-xp: the global index of shard 0 here
};

template <typename T>
__device__ __forceinline__ T pick(const T (&t)[kMaxShards], int i) {
  T x = T();
#pragma unroll
  for (int k = 0; k < kMaxShards; ++k)
    if (k == i) x = t[k];
  return x;
}

// the first v with col[v] > x over col[0 .. n), n >= 1 (K6-expand's
// branchless search: ceil(log2 n) probes)
__device__ __forceinline__ int upper_bound(const int* col, int n, int x) {
  int pos = 0;
  for (int len = n; len > 1;) {
    const int half = len >> 1;
    if (__ldg(col + pos + half) <= x) pos += half;
    len -= half;
  }
  return pos + (__ldg(col + pos) <= x ? 1 : 0);
}

// upper_bound of one x for the whole warp (every lane passes the same x),
// given col[n - 1] > x: the 32 lanes probe 32 evenly spaced nodes of the
// range a step and a ballot keeps the one interval that holds the answer,
// so 2^19 nodes take 4 dependent loads, not 19
__device__ __forceinline__ int warp_upper_bound(const int* col, int n, int x, int lane) {
  int lo = 0, hi = n;  // the answer lies in [lo, hi)
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) >> 5;
    const int p = lo + lane * step;
    const unsigned le = __ballot_sync(kFull, p < hi && __ldg(col + p) <= x);
    const int k = __popc(le);  // probes at or below x: lanes 0 .. k - 1
    if (k == 0) return lo;
    const int next = lo + k * step;  // the first probe above x, if any
    lo += (k - 1) * step + 1;
    if (next < hi) hi = next + 1;
  }
  const int p = lo + lane;
  return lo + __popc(__ballot_sync(kFull, p < hi && __ldg(col + p) <= x));
}

// the same from a node p at or below the answer, given col[n - 1] > x:
// probes p, p + 1, p + 3, p + 7, ... until one passes x, then bisects the
// last step, so a lane on p's own node costs one probe
__device__ __forceinline__ int gallop(const int* col, int n, int p, int x) {
  if (__ldg(col + p) > x) return p;
  int lo = p, hi, step = 1;  // col[lo] <= x
  for (;;) {
    hi = lo + step;
    if (hi >= n - 1) {
      hi = n - 1;
      break;
    }
    if (__ldg(col + hi) > x) break;
    lo = hi;
    step <<= 1;
  }
  while (hi - lo > 1) {  // col[lo] <= x < col[hi]
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(col + mid) > x)
      hi = mid;
    else
      lo = mid;
  }
  return hi;
}

// A walk that ends in this step (``ending``) adds its weight at its
// endpoint in column b, a RED of its own.
template <bool kSharded>
__device__ __forceinline__ void add_alone(bool ending, int cur, int shard, float wt, uint32_t w,
                                          int b, const RawArgs& ra, const RawView& rv) {
  if (ra.ends != nullptr && ending) ra.ends[w] = cur;
  if (ending && wt != 0.0f)
    atomicAdd(rv.out[kSharded ? shard : 0] + (long long)cur * ra.out_ld + b, wt);
}

// The same, grouped: lanes that share an endpoint (and a shard) add their
// weights in lane order and the lowest of them issues one RED.  Every lane
// of the warp calls it.
template <bool kSharded>
__device__ __forceinline__ void add_grouped(bool ending, int cur, int shard, float wt,
                                            uint32_t w, int b, const RawArgs& ra,
                                            const RawView& rv, float* s_add, int lane) {
  if (ra.ends != nullptr && ending) ra.ends[w] = cur;
  const bool add = ending && wt != 0.0f;
  const unsigned mask = __ballot_sync(kFull, add);
  if (mask == 0) return;
  if (add) {
    const unsigned long long key =
        ((unsigned long long)(unsigned)(kSharded ? shard : 0) << 32) | (unsigned)cur;
    const unsigned peers = __match_any_sync(mask, key);
    s_add[lane] = wt;
    __syncwarp(mask);
    if (lane == __ffs(peers) - 1) {
      float sum = 0.0f;
      for (unsigned m = peers; m != 0; m &= m - 1) sum += s_add[__ffs(m) - 1];
      atomicAdd(rv.out[kSharded ? shard : 0] + (long long)cur * ra.out_ld + b, sum);
    }
  }
  __syncwarp();
}

// A warp's tile: column b, rows t0 .. t0 + range - 1 of the chunk, the rows
// whose lanes the column demands (padding lanes are not walked).  The queue
// is walk_range's; a refill's lookahead lane also finds its lane's start
// node and weight, and a walk that ends adds its weight: grouped by
// endpoint in the refill (the walks of no hop), alone after a hop.  With a
// Leave that hands walks over (K6+K4-xp), a walk that leaves the process's
// rows goes to it.
template <bool kAlias, bool kSharded, class Leave = NoLeave>
__device__ __forceinline__ void raw_walk_range(const WalkArgs& a, const RawArgs& ra,
                                               const ShardView& tab, const RawView& rv,
                                               const Leave& lv = Leave()) {
  __shared__ float s_add[kBlockWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint64_t tile = (uint64_t)blockIdx.x * kBlockWarps + warp;
  if (tile >= (uint64_t)ra.tiles * (uint64_t)ra.Bc) return;
  const int b = (int)(tile / ra.tiles);
  uint32_t t0 = (uint32_t)(tile - (uint64_t)b * ra.tiles) * a.range;
  if (Leave::kXp) {  // K6+K4-xp: the tiles start at the column's first lane here
    const uint64_t t = (uint64_t)t0 + (uint64_t)max(__ldg(ra.bounds + b) - ra.lane_lo, 0ll);
    if (t >= ra.rows) return;
    t0 = (uint32_t)t;
  }
  // the column's walks: lanes below total[b], or bounds[G, b] sharded
  const long long col_total =
      kSharded ? __ldg(ra.bounds + (long long)ra.G * ra.Bc + b) : (long long)__ldg(ra.total + b);
  const long long avail = col_total - ra.lane_lo - (long long)t0;
  if (avail <= 0) return;
  uint32_t count = min(a.range, ra.rows - t0);
  if (avail < (long long)count) count = (uint32_t)avail;
  float* const adds = s_add[warp];
  const unsigned below = (1u << lane) - 1u;
  // the search base, the same in every lane: the node (and shard) of the
  // last lane handed to the lookahead; the tile's first lane is searched in
  // full, by the whole warp, and every later lane of the column lies at or
  // past it
  int base_h = 0;
  const long long l0 = ra.lane_lo + t0;
  if (kSharded) {
    while (__ldg(ra.bounds + (long long)(base_h + 1) * ra.Bc + b) <= l0) ++base_h;
  }
  const int* col0 = rv.cum[base_h] + (long long)b * ra.cum_ld;
  const int x0 =
      (int)(l0 - (kSharded ? __ldg(ra.bounds + (long long)base_h * ra.Bc + b) : 0ll));
  int base_v = warp_upper_bound(col0, ra.n, x0, lane);
  uint32_t batch = 0, filled = 0, used = 0;
  int ahead_start = 0, ahead_len = 0, ahead_h = 0;
  float ahead_w = 0.0f;
  uint32_t w = 0;  // this lane's walk: its Philox key t * Bc + b, node, hops, length
  int cur = 0, h = 0, len = 0, shard = 0;
  float wt = 0.0f;  // its weight, r[v, b] / omega_v
  bool idle = true;

  for (;;) {
    for (;;) {
      const unsigned need = __ballot_sync(kFull, idle);
      if (need == 0) break;
      if (used == filled) {
        batch += filled;
        filled = used = 0;
        if (batch >= count) break;
        filled = min(32u, count - batch);
        int v = base_v, sh = base_h;
        if ((uint32_t)lane < filled) {
          const uint32_t t = t0 + batch + lane;
          const long long l = ra.lane_lo + t;
          long long first = 0;  // the lane's shard's first lane
          if (kSharded) {
            while (__ldg(ra.bounds + (long long)(sh + 1) * ra.Bc + b) <= l) ++sh;
            first = __ldg(ra.bounds + (long long)sh * ra.Bc + b);
          }
          const int x = (int)(l - first);
          const int* col = rv.cum[sh] + (long long)b * ra.cum_ld;
          v = sh == base_h ? gallop(col, ra.n, base_v, x) : upper_bound(col, ra.n, x);
          const int om = __ldg(col + v) - (v > 0 ? __ldg(col + v - 1) : 0);
          ahead_w = __ldg(rv.r[sh] + (long long)v * ra.r_ld + b) / (float)om;
          ahead_start = kSharded ? v + (Leave::kXp ? ra.shard0 + sh : sh) * a.n_loc : v;
          ahead_len = walk_length(a, t * (uint32_t)ra.Bc + (uint32_t)b);
          ahead_h = sh;
        }
        base_v = __shfl_sync(kFull, v, filled - 1);
        if (kSharded) base_h = __shfl_sync(kFull, sh, filled - 1);
      }
      const uint32_t src = used + __popc(need & below);
      const int take_start = __shfl_sync(kFull, ahead_start, src & 31);
      const int take_len = __shfl_sync(kFull, ahead_len, src & 31);
      const float take_w = __shfl_sync(kFull, ahead_w, src & 31);
      const int take_h = kSharded ? __shfl_sync(kFull, ahead_h, src & 31) : 0;
      bool ending = false;
      if (idle && src < filled) {
        w = (t0 + batch + src) * (uint32_t)ra.Bc + (uint32_t)b;
        cur = take_start;
        len = take_len;
        wt = take_w;
        shard = take_h;
        h = 0;
        if (len > 0)
          idle = false;
        else
          ending = true;  // no hop: the walk ends where it starts
      }
      // K6+K4-xp adds every walk into one partial (out[0])
      add_grouped<kSharded && !Leave::kXp>(ending, cur, shard, wt, w, b, ra, rv, adds, lane);
      used = min(filled, used + __popc(need));
    }
    if (__all_sync(kFull, idle)) break;
    const bool ending = !idle && hop<kAlias, false, kSharded>(a, tab, w, cur, h, len);
    add_alone<kSharded && !Leave::kXp>(ending, cur, shard, wt, w, b, ra, rv);
    if (ending) idle = true;
    if (Leave::kXp) {  // a walk whose next hop starts at another process's node
      const bool leave = !idle && lv.outside(cur);
      lv.put(leave, cur, w, h, len, wt, lane);
      if (leave) idle = true;
    }
  }
}

template <bool kAlias, bool kSharded>
__global__ void __launch_bounds__(kBlockThreads, kRawBlocksPerSM)
    raw_walk_kernel(const WalkArgs a, const RawArgs ra, const ShardTables t,
                    const RawTables rt) {
  __shared__ const int* indptr[kMaxShards];
  __shared__ const int* indices[kMaxShards];
  __shared__ const float* alias_prob[kMaxShards];
  __shared__ const int* alias_other[kMaxShards];
  __shared__ const float* res[kMaxShards];
  __shared__ const int* cum[kMaxShards];
  __shared__ float* out[kMaxShards];
  const int i = threadIdx.x;
  if (i < kMaxShards) {  // by constant indices: see the sharded form above
    if (kSharded) {
      indptr[i] = pick(t.indptr, i);
      indices[i] = pick(t.indices, i);
      alias_prob[i] = pick(t.alias_prob, i);
      alias_other[i] = pick(t.alias_other, i);
    }
    res[i] = pick(rt.r, i);
    cum[i] = pick(rt.cum, i);
    out[i] = pick(rt.out, i);
  }
  __syncthreads();
  raw_walk_range<kAlias, kSharded>(a, ra, ShardView{indptr, indices, alias_prob, alias_other},
                                   RawView{res, cum, out});
}

// ---- K6+K4-xp: the raw walk phase's chunk in one process of several -------

// blocks an SM in __launch_bounds__ of each form (kernels/schedule.py::
// XP_OWN_BLOCKS_PER_SM, XP_INBOX_BLOCKS_PER_SM; at most 64 registers)
constexpr int kXpOwnBlocksPerSM = 4;
constexpr int kXpInboxBlocksPerSM = 4;
// a record holds h | len << 16: lengths below 2^15
constexpr int kMaxXpHops = (1 << 15) - 1;
// a block's stage of leaving records, 16 KiB: 2 KiB a warp
constexpr int kStageRecords = 1024;

struct XpOut {
  int4* outbox;   // [P, cap] walks that leave, by destination process
  int* counts;    // [P] records written per destination (may pass cap: a fault)
  long long cap;
  int P, rank;
  int lo, rows;   // the process's rows: lo .. lo + rows - 1 (rows = L n_loc)
};

// a warp's part of the stage: a bin for each other process
constexpr int kWarpStage = kStageRecords / kBlockWarps;

struct XpStage {
  int4 rec[kStageRecords];            // warp w's bin j at rec + w * kWarpStage + j * bin_cap
  int fill[kBlockWarps][kMaxShards];  // records in warp w's bin j
};

// A bin's `count` records into a destination's outbox `dst` [cap] by the
// lanes of `peers`: their leader takes the records' place with one global
// atomic on the destination's count, then the lanes write them in
// contiguous 16-byte stores.  Called once a bin's worth of records, out of
// line: inlined, its warp-level operations stopped the kernel with an
// illegal instruction on the H100 (nvcc 12.8; PERF.md).
__device__ __noinline__ void flush_group(const int4* bin, int count, int* counter, int4* dst,
                                         long long cap, unsigned peers) {
  const int lane = threadIdx.x & 31, leader = __ffs(peers) - 1;
  const int m = __popc(peers), pos = __popc(peers & ((1u << lane) - 1u));
  int base = 0;
  if (lane == leader) base = atomicAdd(counter, count);
  base = __shfl_sync(peers, base, leader);
  for (int i = pos; i < count; i += m)
    if ((long long)base + i < cap) dst[base + i] = bin[i];
}

// The records of a group wider than its bin (P > 5), each lane's own
// `rec`, straight into the outbox `dst` [cap] with one global atomic; out
// of line as flush_group is.
__device__ __noinline__ void send_group(int4 rec, int* counter, int4* dst, long long cap,
                                        unsigned peers) {
  const int lane = threadIdx.x & 31, leader = __ffs(peers) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(counter, __popc(peers));
  base = __shfl_sync(peers, base, leader);
  const long long slot = (long long)base + __popc(peers & ((1u << lane) - 1u));
  if (slot < cap) dst[slot] = rec;
}

// The staged outbox: a leaving walk's record goes into its warp's bin for
// its destination in the block's stage, the bin's count in shared memory
// beside it; a bin that cannot take a group's records is flushed first,
// and drain() flushes what the warp's bins hold when its walks are done.
// A warp owns its bins, so no warp waits for another and the counts need
// no atomic.  Only the lanes that leave take part, grouped by destination
// as the earlier kernel grouped them.
struct StagedLeave {
  static constexpr bool kXp = true;
  using Shared = XpStage;
  XpStage* st;
  XpOut xo;
  int bin_cap;  // records a bin: kWarpStage / (P - 1)

  // before the block's first __syncthreads
  static __device__ __forceinline__ StagedLeave make(XpStage& st, const XpOut& xo) {
    if (threadIdx.x < kBlockWarps * kMaxShards) (&st.fill[0][0])[threadIdx.x] = 0;
    return StagedLeave{&st, xo, kWarpStage / max(xo.P - 1, 1)};
  }

  // a bin's `count` records into destination d's outbox
  __device__ __forceinline__ void flush(const int4* bin, int count, int d, unsigned peers) const {
    flush_group(bin, count, xo.counts + d, xo.outbox + (long long)d * xo.cap, xo.cap, peers);
  }

  __device__ __forceinline__ bool outside(int cur) const {
    return (unsigned)(cur - xo.lo) >= (unsigned)xo.rows;
  }

  // Every lane calls it; the lanes with `leave` hand their walk to the
  // process that owns cur, each destination's group into its bin.
  __device__ __forceinline__ void put(bool leave, int cur, uint32_t w, int h, int len, float wt,
                                      int lane) const {
    const unsigned leaving = __ballot_sync(kFull, leave);
    if (!leave) return;
    const int d = cur / xo.rows;
    const unsigned peers = __match_any_sync(leaving, d);
    const int leader = __ffs(peers) - 1, m = __popc(peers);
    const int j = d - (d > xo.rank ? 1 : 0);
    int4* const bin = st->rec + (threadIdx.x >> 5) * kWarpStage + j * bin_cap;
    volatile int* const fill = &st->fill[threadIdx.x >> 5][j];
    const int4 rec = make_int4((int)w, cur, h | (len << 16), __float_as_int(wt));
    const int pos = __popc(peers & ((1u << lane) - 1u));
    int f = 0;  // the bin's count, read by the group's leader for all of it
    if (lane == leader) f = *fill;
    f = __shfl_sync(peers, f, leader);
    if (f > 0 && f + m > bin_cap) {  // full: out with it
      flush(bin, f, d, peers);
      f = 0;
      __syncwarp(peers);
    }
    if (m > bin_cap) {  // a bin smaller than the group (P > 5): the group goes out itself
      send_group(rec, xo.counts + d, xo.outbox + (long long)d * xo.cap, xo.cap, peers);
    } else {
      bin[f + pos] = rec;
      f += m;
    }
    __threadfence_block();
    __syncwarp(peers);
    if (lane == leader) {
      *fill = f;
      __threadfence_block();
    }
  }

  // when the warp's walks are done: what its bins hold, written by one lane
  __device__ __forceinline__ void drain() const {
    if ((threadIdx.x & 31) != 0) return;
    __threadfence_block();
    const int warp = threadIdx.x >> 5;
    for (int j = 0; j < xo.P - 1; ++j) {
      const int f = ((volatile int*)st->fill[warp])[j];
      const int d = j + (j >= xo.rank ? 1 : 0);
      if (f > 0) flush(st->rec + warp * kWarpStage + j * bin_cap, f, d, 1u);
    }
  }
};


// the own-lane form: raw_walk_range over this process's lanes of the chunk
// (ra.G = L rows of bounds, ra.shard0 their first global shard), its L
// slices at their global index in the table, every end into rt.out[0]
template <bool kAlias, int kBlocks, class Leave>
__global__ void __launch_bounds__(kBlockThreads, kBlocks)
    xp_own_kernel(const WalkArgs a, const RawArgs ra, const ShardTables t, const RawTables rt,
                  const XpOut xo) {
  __shared__ const int* indptr[kMaxShards];
  __shared__ const int* indices[kMaxShards];
  __shared__ const float* alias_prob[kMaxShards];
  __shared__ const int* alias_other[kMaxShards];
  __shared__ const float* res[kMaxShards];
  __shared__ const int* cum[kMaxShards];
  __shared__ float* out[kMaxShards];
  __shared__ typename Leave::Shared stage;
  const int i = threadIdx.x;
  if (i < kMaxShards) {  // by constant indices: see the sharded form above
    indptr[i] = pick(t.indptr, i);
    indices[i] = pick(t.indices, i);
    alias_prob[i] = pick(t.alias_prob, i);
    alias_other[i] = pick(t.alias_other, i);
    res[i] = pick(rt.r, i);
    cum[i] = pick(rt.cum, i);
    out[i] = pick(rt.out, i);
  }
  const Leave lv = Leave::make(stage, xo);
  __syncthreads();
  raw_walk_range<kAlias, true, Leave>(a, ra, ShardView{indptr, indices, alias_prob, alias_other},
                                      RawView{res, cum, out}, lv);
  lv.drain();
}

struct XpIn {
  const int4* inbox;  // [n_in] walks handed over: (w, cur, h | len << 16, weight bits)
  long long n_in;
  float* out;         // [n_pad, Bc] this process's partial (row stride out_ld)
  long long out_ld;
  int* ends;          // [rows, Bc] endpoints of the walks that end here, or null
  int Bc;
};

// a walk of the inbox that ends adds its weight at its endpoint, column w %
// Bc (kMass; without it, as the earlier K4-xp inbox form that
// probes/index_xp_forms.cu keeps, a walk only writes ends[w])
template <bool kMass>
__device__ __forceinline__ void inbox_add(bool ending, int cur, uint32_t w, float wt,
                                          const XpIn& xi) {
  if (!ending) return;
  if (xi.ends != nullptr) xi.ends[w] = cur;
  if (kMass && wt != 0.0f)
    atomicAdd(xi.out + (long long)cur * xi.out_ld + w % (uint32_t)xi.Bc, wt);
}

// A warp's range of 32 k records, run through walk_range's queue: the
// lookahead is one 16-byte load a lane, the length comes with the record.
template <bool kAlias, bool kMass, class Leave>
__device__ __forceinline__ void xp_inbox_range(const WalkArgs& a, const XpIn& xi,
                                               const ShardView& tab, const Leave& lv) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long r0 = ((long long)blockIdx.x * kBlockWarps + warp) * a.range;
  if (r0 >= xi.n_in) return;
  const uint32_t count = (uint32_t)min((long long)a.range, xi.n_in - r0);
  const int4* const recs = xi.inbox + r0;
  const unsigned below = (1u << lane) - 1u;
  uint32_t batch = 0, filled = 0, used = 0;
  int4 ahead = make_int4(0, 0, 0, 0);  // lane i: record batch + i
  uint32_t w = 0;  // this lane's walk: its Philox key, node, hops taken, length, weight
  int cur = 0, h = 0, len = 0;
  float wt = 0.0f;
  bool idle = true;

  for (;;) {
    for (;;) {
      const unsigned need = __ballot_sync(kFull, idle);
      if (need == 0) break;
      if (used == filled) {
        batch += filled;
        filled = used = 0;
        if (batch >= count) break;
        filled = min(32u, count - batch);
        if ((uint32_t)lane < filled) ahead = __ldg(recs + batch + lane);
      }
      const uint32_t src = used + __popc(need & below);
      const int take_w = __shfl_sync(kFull, ahead.x, src & 31);
      const int take_cur = __shfl_sync(kFull, ahead.y, src & 31);
      const int take_hl = __shfl_sync(kFull, ahead.z, src & 31);
      const int take_wt = __shfl_sync(kFull, ahead.w, src & 31);
      bool ending = false;
      if (idle && src < filled) {
        w = (uint32_t)take_w;
        cur = take_cur;
        h = take_hl & 0xffff;
        len = take_hl >> 16;
        wt = __int_as_float(take_wt);
        if (h < len)
          idle = false;
        else
          ending = true;  // no hop left (no record of this kernel's)
      }
      inbox_add<kMass>(ending, cur, w, wt, xi);
      used = min(filled, used + __popc(need));
    }
    if (__all_sync(kFull, idle)) break;
    const bool ending = !idle && hop<kAlias, false, true>(a, tab, w, cur, h, len);
    inbox_add<kMass>(ending, cur, w, wt, xi);
    if (ending) idle = true;
    const bool leave = !idle && lv.outside(cur);
    lv.put(leave, cur, w, h, len, wt, lane);
    if (leave) idle = true;
  }
}

template <bool kAlias, bool kMass, int kBlocks, class Leave>
__global__ void __launch_bounds__(kBlockThreads, kBlocks)
    xp_inbox_kernel(const WalkArgs a, const XpIn xi, const ShardTables t, const XpOut xo) {
  __shared__ const int* indptr[kMaxShards];
  __shared__ const int* indices[kMaxShards];
  __shared__ const float* alias_prob[kMaxShards];
  __shared__ const int* alias_other[kMaxShards];
  __shared__ typename Leave::Shared stage;
  const int i = threadIdx.x;
  if (i < kMaxShards) {  // by constant indices: see the sharded form above
    indptr[i] = pick(t.indptr, i);
    indices[i] = pick(t.indices, i);
    alias_prob[i] = pick(t.alias_prob, i);
    alias_other[i] = pick(t.alias_other, i);
  }
  const Leave lv = Leave::make(stage, xo);
  __syncthreads();
  xp_inbox_range<kAlias, kMass>(a, xi, ShardView{indptr, indices, alias_prob, alias_other}, lv);
  lv.drain();
}

// ---- K4-xp: a window of the index build in one process of several -------

// blocks an SM in __launch_bounds__ of each form (kernels/schedule.py::
// INDEX_XP_BLOCKS_PER_SM, INDEX_XP_INBOX_BLOCKS_PER_SM)
constexpr int kIndexXpBlocksPerSM = 8;
constexpr int kIndexXpInboxBlocksPerSM = 4;

struct IndexXpArgs {
  int* ends;             // [n_ends] the window's endpoints: walk w's at w - wlo
  const int4* inbox;     // the inbox form's n_in records (w, cur, h | len << 16, 0)
  unsigned* cursor;      // the inbox form's claims so far: zero at the launch
  uint32_t n_in;
  uint32_t wlo;          // the window's first walk
  uint32_t chunk_lanes;  // walk w is walk w % chunk_lanes of chunk w / chunk_lanes
  uint32_t magic;        // w / chunk_lanes = (w * magic) >> shift for w < 2^31
  int shift;
  uint32_t claim_max;    // the inbox form's largest claim, in 32-record groups
};

// walk w's Philox key in its chunk c = w / chunk_lanes and the seed's high
// word of that chunk (chunk c draws from seed + c 2^32); the division by
// a multiply and a shift (kernels/schedule.py::chunk_divisor)
__device__ __forceinline__ uint32_t chunk_draw(const WalkArgs& a, const IndexXpArgs& xa,
                                               uint32_t w, uint32_t& hi) {
  const uint32_t c = (uint32_t)(((uint64_t)w * xa.magic) >> xa.shift);
  hi = a.seed_hi + c;
  return w - c * xa.chunk_lanes;
}

__device__ __forceinline__ bool xp_outside(const XpOut& xo, int cur) {
  return (unsigned)(cur - xo.lo) >= (unsigned)xo.rows;
}

// A warp's records staged in its part of the block's stage (`st`, n of
// them, each one walk's), out to their destinations' outboxes by the whole
// warp: per destination one global atomic for all of its records, then
// their 16-byte stores.  Called between a warp's batches, when none of its
// lanes holds a walk, so the call keeps no walk's state live; out of line,
// as every K6+K4-xp flush is (inlined, their warp-level operations stopped
// the kernel with an illegal instruction on the H100, nvcc 12.8).
__device__ __noinline__ void drain_stage(const int4* st, int n, const XpOut xo) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  __syncwarp();
  for (int d = 0; d < xo.P && n > 0; ++d) {
    if (d == xo.rank) continue;
    int cnt = n;  // with one other process, every record is its
    if (xo.P > 2) {
      cnt = 0;
      for (int i = lane; i - lane < n; i += 32)
        cnt += __popc(__ballot_sync(kFull, i < n && st[i].y / xo.rows == d));
    }
    if (cnt == 0) continue;
    int base = 0;
    if (lane == 0) base = atomicAdd(xo.counts + d, cnt);
    base = __shfl_sync(kFull, base, 0);
    int4* const dst = xo.outbox + (long long)d * xo.cap;
    for (int i = lane; i - lane < n; i += 32) {
      const int4 r = i < n ? st[i] : make_int4(0, 0, 0, 0);
      const bool mine = i < n && (xo.P == 2 || r.y / xo.rows == d);
      const unsigned m = __ballot_sync(kFull, mine);
      const long long slot = (long long)base + __popc(m & below);
      if (mine && slot < xo.cap) dst[slot] = r;
      base += __popc(m);
    }
  }
  __syncwarp();
}

// The own-start form's warp: K4's walk_range over its range of the own
// starts (walks a.w0 + lo .. of the window, at most kWarpStage), each walk
// drawing as walk w % chunk_lanes of its chunk.  A walk that leaves is
// staged (one ballot and a store: at most one a walk, so the warp's part
// of the stage holds them all) and writes -1 into its staged end, so the
// range's coalesced write of its ends carries no stale node; the stage
// goes out when the range is done.
template <bool kAlias>
__device__ __forceinline__ void index_xp_own_range(const WalkArgs& a, const IndexXpArgs& xa,
                                                   const ShardView& tab, const XpOut& xo,
                                                   int4* stage) {
  extern __shared__ int staged_ends[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint64_t lo64 = ((uint64_t)blockIdx.x * kBlockWarps + warp) * a.range;
  if (lo64 >= a.W) return;  // the last block's spare warps own no walk
  const uint32_t lo = (uint32_t)lo64;
  const uint32_t count = a.W - lo < a.range ? a.W - lo : a.range;
  const uint32_t w_lo = a.w0 + lo;  // the range's first walk
  int* const ends = staged_ends + warp * a.range;
  int4* const out = stage + warp * kWarpStage;
  const unsigned below = (1u << lane) - 1u;
  uint32_t batch = 0, filled = 0, used = 0;
  int ahead_start = 0, ahead_len = 0;
  uint32_t i = 0;  // this lane's walk w_lo + i: its node, hops taken, length
  int cur = 0, h = 0, len = 0, n_out = 0;
  bool idle = true;

  for (;;) {
    for (;;) {
      const unsigned need = __ballot_sync(kFull, idle);
      if (need == 0) break;
      if (used == filled) {
        batch += filled;
        filled = used = 0;
        if (batch >= count) break;
        filled = min(32u, count - batch);
        if ((uint32_t)lane < filled) {
          uint32_t hi;
          const uint32_t key = chunk_draw(a, xa, w_lo + batch + lane, hi);
          ahead_start = __ldg(a.start + lo + batch + lane);
          ahead_len = walk_length_at(a, key, hi);
        }
      }
      const uint32_t src = used + __popc(need & below);
      const int take_start = __shfl_sync(kFull, ahead_start, src & 31);
      const int take_len = __shfl_sync(kFull, ahead_len, src & 31);
      if (idle && src < filled) {
        i = batch + src;
        cur = take_start;
        len = take_len;
        h = 0;
        if (len > 0)
          idle = false;
        else
          ends[i] = cur;  // no hop: the walk ends where it starts
      }
      used = min(filled, used + __popc(need));
    }
    if (__all_sync(kFull, idle)) break;
    const uint32_t w = w_lo + i;
    bool ending = false;
    if (!idle) {
      uint32_t hi;
      const uint32_t key = chunk_draw(a, xa, w, hi);
      ending = hop_at<kAlias, false, true>(a, tab, key, hi, cur, h, len);
    }
    if (ending) {
      ends[i] = cur;
      idle = true;
    }
    const bool leave = !idle && xp_outside(xo, cur);
    const unsigned leaving = __ballot_sync(kFull, leave);
    if (leave) {
      out[n_out + __popc(leaving & below)] = make_int4((int)w, cur, h | (len << 16), 0);
      ends[i] = -1;  // it ends in another process
      idle = true;
    }
    n_out += __popc(leaving);
  }
  __syncwarp();  // the range's endpoints, coalesced
  int* const dst = xa.ends + (w_lo - xa.wlo);
  for (uint32_t k = lane; k < count; k += 32) dst[k] = ends[k];
  drain_stage(out, n_out, xo);
}

// the inbox form's next claim: 32 k records, 32 k what is left over the
// warps, k at least 1 and at most claim_max (kernels/schedule.py::
// inbox_claim)
__device__ __forceinline__ uint32_t inbox_claim(uint32_t seen, const IndexXpArgs& xa,
                                                uint32_t warps) {
  const uint32_t left = seen < xa.n_in ? xa.n_in - seen : 0u;
  return 32u * max(1u, min(left / (32u * warps), xa.claim_max));
}

// The inbox form's claims: every warp's first claim is its own, the
// first claim's size from warp g * first (no atomic, so a launch does not
// start with every warp's atomic on one word); later ones come from the
// cursor past them, one atomicAdd each: records r0 .. r0 + count - 1
// (count 0: none left).
__device__ __forceinline__ void claim_records(const IndexXpArgs& xa, uint32_t warps,
                                              uint32_t first, int lane, uint32_t& r0,
                                              uint32_t& count) {
  uint32_t base = 0, step = 0;
  if (lane == 0) {
    step = inbox_claim(warps * first + *(volatile unsigned*)xa.cursor, xa, warps);
    base = warps * first + atomicAdd(xa.cursor, step);
  }
  r0 = __shfl_sync(kFull, base, 0);
  step = __shfl_sync(kFull, step, 0);
  count = r0 < xa.n_in ? min(step, xa.n_in - r0) : 0u;
}

// The inbox form's warp, one of a grid of resident blocks: walk_range's
// queue over the records it claims, each claim 32 k records (after the
// first, from one atomicAdd on the cursor), k shrinking as the inbox
// drains.  The queue goes
// on from one claim into the next without waiting for the claim's last
// walk.  A record's length and hops taken come with it, so no refill
// computes a Philox block 0 or a logf; but a record has about 1.5 hops
// left, so the refills come often, and the next 32 records are loaded
// while the current ones are handed out (the next claim's first 32 with
// the claim's last batch).  A walk that ends writes ends[w
// - wlo] itself; one that leaves is staged, and the stage goes out
// whenever a step could overfill it (at most 32 records leave a step).
template <bool kAlias>
__device__ __forceinline__ void index_xp_inbox_range(const WalkArgs& a, const IndexXpArgs& xa,
                                                     const ShardView& tab, const XpOut& xo,
                                                     int4* stage) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const uint32_t warps = gridDim.x * kBlockWarps;
  int4* const out = stage + (threadIdx.x >> 5) * kWarpStage;
  const uint32_t first = inbox_claim(0, xa, warps);  // every warp's first claim
  // the warp's claim: records r0 .. r0 + count - 1
  uint32_t r0 = min((blockIdx.x * kBlockWarps + (threadIdx.x >> 5)) * first, xa.n_in);
  uint32_t count = min(first, xa.n_in - r0);
  uint32_t r1 = 0, count1 = 0;  // its next claim, taken with the claim's last batch
  uint32_t batch = 0, filled = 0, used = 0, next_n = 0;
  int4 ahead = make_int4(0, 0, 0, 0);  // lane i: the current batch's record i
  int4 next = make_int4(0, 0, 0, 0);   // lane i: the next batch's record i
  uint32_t w = 0;  // this lane's walk: its number, node, hops taken, length
  int cur = 0, h = 0, len = 0, n_out = 0;
  bool idle = true;
  for (;;) {
    for (;;) {
      const unsigned need = __ballot_sync(kFull, idle);
      if (need == 0) break;
      if (used == filled) {
        batch += filled;
        filled = used = 0;
        if (batch >= count) {  // the claim is handed out: go on into the next
          if (count1 == 0) break;
          r0 = r1;
          count = count1;
          batch = count1 = 0;
        }
        if (next_n > 0) {  // loaded while the last batch was handed out
          ahead = next;
          filled = next_n;
        } else {
          filled = min(32u, count - batch);
          if ((uint32_t)lane < filled) ahead = __ldg(xa.inbox + r0 + batch + lane);
        }
        // the batch after, loaded now: from this claim, or from the next
        // one, claimed here
        uint32_t from = r0 + batch + filled;
        next_n = batch + filled < count ? min(32u, count - batch - filled) : 0u;
        if (next_n == 0) {
          claim_records(xa, warps, first, lane, r1, count1);
          from = r1;
          next_n = min(32u, count1);
        }
        if ((uint32_t)lane < next_n) next = __ldg(xa.inbox + from + lane);
      }
      const uint32_t src = used + __popc(need & below);
      const int take_w = __shfl_sync(kFull, ahead.x, src & 31);
      const int take_cur = __shfl_sync(kFull, ahead.y, src & 31);
      const int take_hl = __shfl_sync(kFull, ahead.z, src & 31);
      if (idle && src < filled) {
        w = (uint32_t)take_w;
        cur = take_cur;
        h = take_hl & 0xffff;
        len = take_hl >> 16;
        if (h < len)
          idle = false;
        else
          xa.ends[w - xa.wlo] = cur;  // no hop left (no record of this kernel's)
      }
      used = min(filled, used + __popc(need));
    }
    if (__all_sync(kFull, idle)) break;
    bool ending = false;
    if (!idle) {
      uint32_t hi;
      const uint32_t key = chunk_draw(a, xa, w, hi);
      ending = hop_at<kAlias, false, true>(a, tab, key, hi, cur, h, len);
    }
    if (ending) {
      xa.ends[w - xa.wlo] = cur;
      idle = true;
    }
    const bool leave = !idle && xp_outside(xo, cur);
    const unsigned leaving = __ballot_sync(kFull, leave);
    if (leave) {
      out[n_out + __popc(leaving & below)] = make_int4((int)w, cur, h | (len << 16), 0);
      idle = true;
    }
    n_out += __popc(leaving);
    if (n_out > kWarpStage - 32) {
      drain_stage(out, n_out, xo);
      n_out = 0;
    }
  }
  drain_stage(out, n_out, xo);
}

// the slice table's copy in shared memory, by constant indices (see the
// sharded form above), then a form's warps with their part of the stage
#define INDEX_XP_PROLOGUE                                            \
  __shared__ const int* indptr[kMaxShards];                          \
  __shared__ const int* indices[kMaxShards];                         \
  __shared__ const float* alias_prob[kMaxShards];                    \
  __shared__ const int* alias_other[kMaxShards];                     \
  __shared__ int4 stage[kStageRecords];                              \
  const int i = threadIdx.x;                                         \
  if (i < kMaxShards) {                                              \
    indptr[i] = pick(t.indptr, i);                                   \
    indices[i] = pick(t.indices, i);                                 \
    alias_prob[i] = pick(t.alias_prob, i);                           \
    alias_other[i] = pick(t.alias_other, i);                         \
  }                                                                  \
  __syncthreads();                                                   \
  const ShardView tab{indptr, indices, alias_prob, alias_other}

// the own-start form (round 0): this process's own starts of the window
template <bool kAlias, int kBlocks>
__global__ void __launch_bounds__(kBlockThreads, kBlocks)
    index_xp_own_kernel(const WalkArgs a, const IndexXpArgs xa, const ShardTables t,
                        const XpOut xo) {
  INDEX_XP_PROLOGUE;
  index_xp_own_range<kAlias>(a, xa, tab, xo, stage);
}

// the inbox form (rounds >= 1): the records handed to this process
template <bool kAlias, int kBlocks>
__global__ void __launch_bounds__(kBlockThreads, kBlocks)
    index_xp_inbox_kernel(const WalkArgs a, const IndexXpArgs xa, const ShardTables t,
                          const XpOut xo) {
  INDEX_XP_PROLOGUE;
  index_xp_inbox_range<kAlias>(a, xa, tab, xo, stage);
}

// ---- K6+K4-src: walks from each column's source to endpoint mass ----------

struct SrcArgs {
  const int* sources;  // [B] the columns' sources
  float* out;          // [n, B] endpoint mass (row stride out_ld)
  int* ends;           // [rows, B] every walk's endpoint, or null
  long long out_ld;
  uint32_t rows;       // walks a column: t = 0 .. rows - 1
  uint32_t tiles;      // warp tiles of a column: ceil(rows / range)
  int B;
  float weight;        // what each walk adds at its endpoint
};

// A warp's tile: column b = tile % B, walks t0 .. t0 + range - 1 of it
// (t0 = tile / B * range), walk_range's queue with every start at the
// column's source; a walk that ends at the source is counted in `home`,
// the others that end in one step add by endpoint groups.
template <bool kAlias, bool kHub>
__device__ __forceinline__ void source_walk_range(const WalkArgs& a, const SrcArgs& sa) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint64_t tile = (uint64_t)blockIdx.x * kBlockWarps + warp;
  if (tile >= (uint64_t)sa.tiles * (uint64_t)sa.B) return;
  const int b = (int)(tile % (uint64_t)sa.B);
  const uint32_t t0 = (uint32_t)(tile / (uint64_t)sa.B) * a.range;
  const uint32_t count = min(a.range, sa.rows - t0);
  const int src = __ldg(sa.sources + b);
  float* const col = sa.out + b;
  const ShardView tab{nullptr, nullptr, nullptr, nullptr};
  const unsigned below = (1u << lane) - 1u;
  uint32_t batch = 0, filled = 0, used = 0;
  int ahead_len = 0;
  uint32_t w = 0;  // this lane's walk: its Philox key t * B + b, node, hops, length
  int cur = 0, h = 0, len = 0;
  unsigned home = 0;  // this lane's walks that ended at the source
  bool idle = true;

  for (;;) {
    for (;;) {
      const unsigned need = __ballot_sync(kFull, idle);
      if (need == 0) break;
      if (used == filled) {
        batch += filled;
        filled = used = 0;
        if (batch >= count) break;
        filled = min(32u, count - batch);
        if ((uint32_t)lane < filled)
          ahead_len = walk_length(a, (t0 + batch + lane) * (uint32_t)sa.B + (uint32_t)b);
      }
      const uint32_t k = used + __popc(need & below);
      const int take_len = __shfl_sync(kFull, ahead_len, k & 31);
      if (idle && k < filled) {
        w = (t0 + batch + k) * (uint32_t)sa.B + (uint32_t)b;
        cur = src;
        len = take_len;
        h = 0;
        if (len > 0) {
          idle = false;
        } else {  // no hop: the walk ends where it starts
          ++home;
          if (sa.ends != nullptr) sa.ends[w] = src;
        }
      }
      used = min(filled, used + __popc(need));
    }
    if (__all_sync(kFull, idle)) break;
    const bool ending = !idle && hop<kAlias, kHub, false>(a, tab, w, cur, h, len);
    if (ending && sa.ends != nullptr) sa.ends[w] = cur;
    const bool at_home = ending && cur == src;
    home += at_home ? 1u : 0u;
    const bool add = ending && !at_home;
    const unsigned adding = __ballot_sync(kFull, add);
    if (add) {
      const unsigned peers = __match_any_sync(adding, cur);
      if (lane == __ffs(peers) - 1)
        atomicAdd(col + (long long)cur * sa.out_ld, (float)__popc(peers) * sa.weight);
    }
    if (ending) idle = true;
  }
  home = __reduce_add_sync(kFull, home);
  if (lane == 0 && home != 0) atomicAdd(col + (long long)src * sa.out_ld, (float)home * sa.weight);
}

template <bool kAlias, bool kHub>
__global__ void __launch_bounds__(kBlockThreads, kRawBlocksPerSM)
    source_walk_kernel(const WalkArgs a, const SrcArgs sa) {
  source_walk_range<kAlias, kHub>(a, sa);
}

template <bool kAlias, bool kHub>
void launch(const WalkArgs& a, unsigned blocks, cudaStream_t s) {
  const size_t smem = (size_t)kBlockWarps * a.range * sizeof(int);
  index_walk_kernel<kAlias, kHub><<<blocks, kBlockThreads, smem, s>>>(a);
}

template <bool kAlias>
void launch_sharded(const WalkArgs& a, const ShardTables& t, unsigned blocks, cudaStream_t s) {
  const size_t smem = (size_t)kBlockWarps * a.range * sizeof(int);
  index_walk_sharded_kernel<kAlias><<<blocks, kBlockThreads, smem, s>>>(a, t);
}

template <bool kAlias, bool kSharded>
void launch_raw(const WalkArgs& a, const RawArgs& ra, const ShardTables& t, const RawTables& rt,
                unsigned blocks, cudaStream_t s) {
  raw_walk_kernel<kAlias, kSharded><<<blocks, kBlockThreads, 0, s>>>(a, ra, t, rt);
}

// the checks and arguments both entries share; 0 or a cudaError_t
int walk_args(WalkArgs* a, const int* start, int* out, long long W, unsigned long long seed,
              float inv_log1m_alpha, int max_hops, int walks_per_lane, long long blocks) {
  if (W >= (1ll << 32) || max_hops < 0) return (int)cudaErrorInvalidValue;
  if (walks_per_lane < 1 || walks_per_lane > kMaxWalksPerLane) return (int)cudaErrorInvalidValue;
  if (W > 0 && (blocks <= 0 || blocks > 0x7fffffffll ||
                blocks * kBlockWarps * 32 * walks_per_lane < W))
    return (int)cudaErrorInvalidValue;
  *a = WalkArgs{};
  a->start = start;
  a->out = out;
  a->W = (uint32_t)W;
  a->range = 32u * (uint32_t)walks_per_lane;
  a->seed_lo = (uint32_t)(seed & 0xffffffffull);
  a->seed_hi = (uint32_t)(seed >> 32);
  a->inv_log1m_alpha = inv_log1m_alpha;
  a->max_hops = max_hops;
  return 0;
}

// K6+K4's launch: its kernel's arguments, grid and stream
struct RawLaunch {
  WalkArgs a;
  RawArgs ra;
  ShardTables t;
  RawTables rt;
  bool alias, sharded;
  unsigned blocks;  // 0: no lane slot, nothing to launch
  cudaStream_t s;
};

// fora_raw_walk's checks and its launch's arguments; 0 or a cudaError_t
int raw_args(RawLaunch* L, const float* const* r, long long r_ld, const int* const* cum,
             long long cum_ld, const int* total, const long long* bounds,
             int G, long long n, int Bc, long long rows, long long lane_lo,
             int n_loc, float* const* out, long long out_ld, int* ends,
             const int* const* indptr, const int* const* indices,
             const float* const* alias_prob, const int* const* alias_other,
             unsigned long long seed, float inv_log1m_alpha, int max_hops,
             int walks_per_lane, long long tiles, long long blocks, void* stream) {
  if ((alias_prob == nullptr) != (alias_other == nullptr)) return (int)cudaErrorInvalidValue;
  if (n <= 0 || n > 0x7fffffffll || Bc < 0 || rows < 0 || lane_lo < 0 || G < 1 ||
      G > kMaxShards || (bounds == nullptr && (G != 1 || total == nullptr)) ||
      (bounds != nullptr && n_loc < 1) || r == nullptr || cum == nullptr || out == nullptr ||
      indptr == nullptr || indices == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long W = rows * (long long)Bc;
  WalkArgs a;
  const int bad = walk_args(&a, nullptr, nullptr, W, seed, inv_log1m_alpha, max_hops,
                            walks_per_lane, blocks);
  if (bad) return bad;
  *L = RawLaunch{};
  if (W <= 0) return 0;  // nothing to launch: L->blocks 0
  if (tiles < 1 || tiles * 32ll * walks_per_lane < rows || tiles * (long long)Bc > blocks * kBlockWarps)
    return (int)cudaErrorInvalidValue;
  const bool alias = alias_prob != nullptr;
  ShardTables& t = L->t;
  RawTables& rt = L->rt;
  for (int k = 0; k < G; ++k) {
    if (r[k] == nullptr || cum[k] == nullptr || out[k] == nullptr || indptr[k] == nullptr ||
        indices[k] == nullptr || (alias && (alias_prob[k] == nullptr || alias_other[k] == nullptr)))
      return (int)cudaErrorInvalidValue;
    rt.r[k] = r[k];
    rt.cum[k] = cum[k];
    rt.out[k] = out[k];
    t.indptr[k] = indptr[k];
    t.indices[k] = indices[k];
    if (alias) {
      t.alias_prob[k] = alias_prob[k];
      t.alias_other[k] = alias_other[k];
    }
  }
  a.indptr = indptr[0];
  a.indices = indices[0];
  a.alias_prob = alias ? alias_prob[0] : nullptr;
  a.alias_other = alias ? alias_other[0] : nullptr;
  a.n_loc = n_loc;
  RawArgs ra = {};
  ra.total = total;
  ra.bounds = bounds;
  ra.ends = ends;
  ra.r_ld = r_ld;
  ra.cum_ld = cum_ld;
  ra.out_ld = out_ld;
  ra.lane_lo = lane_lo;
  ra.rows = (uint32_t)rows;
  ra.tiles = (uint32_t)tiles;
  ra.Bc = Bc;
  ra.n = (int)n;
  ra.G = G;
  L->a = a;
  L->ra = ra;
  L->alias = alias;
  L->sharded = bounds != nullptr;
  L->blocks = (unsigned)blocks;
  L->s = reinterpret_cast<cudaStream_t>(stream);
  return 0;
}

// K6+K4-src's launch: its kernel's arguments, grid and stream
struct SrcLaunch {
  WalkArgs a;
  SrcArgs sa;
  bool alias, hub;
  unsigned blocks;  // 0: no walk, nothing to launch
  cudaStream_t s;
};

// fora_source_walk's checks and its launch's arguments; 0 or a cudaError_t
int source_args(SrcLaunch* L, const int* sources, int B, float* out, long long out_ld,
                long long n, int* ends, long long rows, const int* indptr, const int* indices,
                const float* alias_prob, const int* alias_other, const int* hub_id,
                const int* pool, int pool_size, unsigned long long seed, float inv_log1m_alpha,
                int max_hops, float weight, int walks_per_lane, long long tiles, long long blocks,
                void* stream) {
  if ((alias_prob == nullptr) != (alias_other == nullptr)) return (int)cudaErrorInvalidValue;
  if ((hub_id == nullptr) != (pool == nullptr)) return (int)cudaErrorInvalidValue;
  if (hub_id != nullptr && pool_size <= 0) return (int)cudaErrorInvalidValue;
  if (n <= 0 || n > 0x7fffffffll || B < 0 || rows < 0 || sources == nullptr || out == nullptr ||
      indptr == nullptr || indices == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long W = rows * (long long)B;
  WalkArgs a;
  const int bad = walk_args(&a, nullptr, nullptr, W, seed, inv_log1m_alpha, max_hops,
                            walks_per_lane, blocks);
  if (bad) return bad;
  *L = SrcLaunch{};
  if (W <= 0) return 0;  // nothing to launch: L->blocks 0
  if (tiles < 1 || tiles * 32ll * walks_per_lane < rows || tiles * (long long)B > blocks * kBlockWarps)
    return (int)cudaErrorInvalidValue;
  a.indptr = indptr;
  a.indices = indices;
  a.alias_prob = alias_prob;
  a.alias_other = alias_other;
  a.hub_id = hub_id;
  a.pool = pool;
  a.pool_size = pool_size;
  SrcArgs sa = {};
  sa.sources = sources;
  sa.out = out;
  sa.ends = ends;
  sa.out_ld = out_ld;
  sa.rows = (uint32_t)rows;
  sa.tiles = (uint32_t)tiles;
  sa.B = B;
  sa.weight = weight;
  L->a = a;
  L->sa = sa;
  L->alias = alias_prob != nullptr;
  L->hub = hub_id != nullptr;
  L->blocks = (unsigned)blocks;
  L->s = reinterpret_cast<cudaStream_t>(stream);
  return 0;
}

// K6+K4-xp's launch, either form: its kernel's arguments, grid and stream
struct XpLaunch {
  WalkArgs a;
  RawArgs ra;  // the own-lane form
  XpIn xi;     // the inbox form
  ShardTables t;
  RawTables rt;
  XpOut xo;
  bool alias;
  unsigned blocks;  // 0: nothing to launch
  cudaStream_t s;
};

// the checks and arguments both forms' entries share; 0 or a cudaError_t
int xp_args(XpLaunch* X, int L, int G, int P, int shard0, int n_loc, int Bc, float* out,
            long long out_ld, int* ends, int* outbox, long long cap, int* counts,
            const int* const* indptr, const int* const* indices, const float* const* alias_prob,
            const int* const* alias_other, unsigned long long seed, int walks_per_lane,
            long long blocks, void* stream) {
  if ((alias_prob == nullptr) != (alias_other == nullptr)) return (int)cudaErrorInvalidValue;
  if (L < 1 || P < 1 || G != P * L || G > kMaxShards || shard0 < 0 || shard0 % L ||
      shard0 + L > G || n_loc < 1 || (long long)G * n_loc >= 0x7fffffffll || Bc < 0 || cap < 0 ||
      walks_per_lane < 1 || walks_per_lane > kMaxWalksPerLane || blocks < 0 ||
      blocks > 0x7fffffffll || (cap > 0 && outbox == nullptr) ||
      counts == nullptr || indptr == nullptr || indices == nullptr)
    return (int)cudaErrorInvalidValue;
  *X = XpLaunch{};
  X->alias = alias_prob != nullptr;
  for (int k = 0; k < L; ++k) {  // the slices at their global shard index
    if (indptr[k] == nullptr || indices[k] == nullptr ||
        (X->alias && (alias_prob[k] == nullptr || alias_other[k] == nullptr)))
      return (int)cudaErrorInvalidValue;
    X->t.indptr[shard0 + k] = indptr[k];
    X->t.indices[shard0 + k] = indices[k];
    if (X->alias) {
      X->t.alias_prob[shard0 + k] = alias_prob[k];
      X->t.alias_other[shard0 + k] = alias_other[k];
    }
  }
  X->a.range = 32u * (uint32_t)walks_per_lane;
  X->a.seed_lo = (uint32_t)(seed & 0xffffffffull);
  X->a.seed_hi = (uint32_t)(seed >> 32);
  X->a.n_loc = n_loc;
  X->xo = XpOut{reinterpret_cast<int4*>(outbox), counts, cap, P, shard0 / L, shard0 * n_loc,
                L * n_loc};
  X->xi.out = out;
  X->xi.out_ld = out_ld;
  X->xi.ends = ends;
  X->xi.Bc = Bc;
  X->blocks = (unsigned)blocks;
  X->s = reinterpret_cast<cudaStream_t>(stream);
  return 0;
}

template <int kBlocks, class Leave>
void launch_xp_own(const XpLaunch& X) {
  if (X.alias)
    xp_own_kernel<true, kBlocks, Leave><<<X.blocks, kBlockThreads, 0, X.s>>>(X.a, X.ra, X.t, X.rt,
                                                                            X.xo);
  else
    xp_own_kernel<false, kBlocks, Leave><<<X.blocks, kBlockThreads, 0, X.s>>>(X.a, X.ra, X.t,
                                                                             X.rt, X.xo);
}

template <int kBlocks, class Leave, bool kMass = true>
void launch_xp_inbox(const XpLaunch& X) {
  if (X.alias)
    xp_inbox_kernel<true, kMass, kBlocks, Leave><<<X.blocks, kBlockThreads, 0, X.s>>>(
        X.a, X.xi, X.t, X.xo);
  else
    xp_inbox_kernel<false, kMass, kBlocks, Leave><<<X.blocks, kBlockThreads, 0, X.s>>>(
        X.a, X.xi, X.t, X.xo);
}

template <int kBlocks>
void launch_index_xp_own(const XpLaunch& X, const IndexXpArgs& xa) {
  const size_t smem = (size_t)kBlockWarps * X.a.range * sizeof(int);
  if (X.alias)
    index_xp_own_kernel<true, kBlocks><<<X.blocks, kBlockThreads, smem, X.s>>>(X.a, xa, X.t, X.xo);
  else
    index_xp_own_kernel<false, kBlocks><<<X.blocks, kBlockThreads, smem, X.s>>>(X.a, xa, X.t, X.xo);
}

template <int kBlocks>
void launch_index_xp_inbox(const XpLaunch& X, const IndexXpArgs& xa) {
  if (X.alias)
    index_xp_inbox_kernel<true, kBlocks><<<X.blocks, kBlockThreads, 0, X.s>>>(X.a, xa, X.t, X.xo);
  else
    index_xp_inbox_kernel<false, kBlocks><<<X.blocks, kBlockThreads, 0, X.s>>>(X.a, xa, X.t, X.xo);
}

// fora_raw_walk_xp's checks and arguments (the own-lane form); 0 or a
// cudaError_t
int xp_own_args(XpLaunch* X, const float* const* r, long long r_ld, const int* const* cum,
                long long cum_ld, const long long* bounds, int L, long long n, int Bc,
                long long rows, long long lane_lo, int n_loc, int shard0, int G, int P, float* out,
                long long out_ld, int* ends, int* outbox, long long cap, int* counts,
                const int* const* indptr, const int* const* indices,
                const float* const* alias_prob, const int* const* alias_other,
                unsigned long long seed, float inv_log1m_alpha, int max_hops, int walks_per_lane,
                long long tiles, long long blocks, void* stream) {
  const int bad = xp_args(X, L, G, P, shard0, n_loc, Bc, out, out_ld, ends, outbox, cap, counts,
                          indptr, indices, alias_prob, alias_other, seed, walks_per_lane, blocks,
                          stream);
  if (bad) return bad;
  if (n <= 0 || n > n_loc || rows < 0 || lane_lo < 0 || rows * (long long)Bc >= (1ll << 32) ||
      max_hops < 0 || max_hops > kMaxXpHops || tiles < 0 || tiles * (long long)Bc > blocks * kBlockWarps ||
      r == nullptr || cum == nullptr || bounds == nullptr || out == nullptr)
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < L; ++k) {
    if (r[k] == nullptr || cum[k] == nullptr) return (int)cudaErrorInvalidValue;
    X->rt.r[k] = r[k];
    X->rt.cum[k] = cum[k];
  }
  X->rt.out[0] = out;
  X->a.inv_log1m_alpha = inv_log1m_alpha;
  X->a.max_hops = max_hops;
  RawArgs& ra = X->ra;
  ra.bounds = bounds;
  ra.ends = ends;
  ra.r_ld = r_ld;
  ra.cum_ld = cum_ld;
  ra.out_ld = out_ld;
  ra.lane_lo = lane_lo;
  ra.rows = (uint32_t)rows;
  ra.tiles = (uint32_t)tiles;
  ra.Bc = Bc;
  ra.n = (int)n;
  ra.G = L;
  ra.shard0 = shard0;
  return 0;
}

// fora_raw_walk_xp_inbox's checks and arguments; 0 or a cudaError_t
int xp_inbox_args(XpLaunch* X, const int* inbox, long long n_in, int Bc, int n_loc, int shard0,
                  int L, int G, int P, float* out, long long out_ld, int* ends, int* outbox,
                  long long cap, int* counts, const int* const* indptr,
                  const int* const* indices, const float* const* alias_prob,
                  const int* const* alias_other, unsigned long long seed, int walks_per_lane,
                  long long blocks, void* stream) {
  const int bad = xp_args(X, L, G, P, shard0, n_loc, Bc, out, out_ld, ends, outbox, cap, counts,
                          indptr, indices, alias_prob, alias_other, seed, walks_per_lane, blocks,
                          stream);
  if (bad) return bad;
  const long long range = 32ll * walks_per_lane;
  if (n_in < 0 || (n_in > 0 && (inbox == nullptr || Bc < 1)) ||
      (n_in + range - 1) / range > blocks * kBlockWarps)
    return (int)cudaErrorInvalidValue;
  X->xi.inbox = reinterpret_cast<const int4*>(inbox);
  X->xi.n_in = n_in;
  return 0;
}

// the checks and arguments both K4-xp forms share: the window's ends
// [n_ends] from walk wlo, its chunks of chunk_lanes walks; 0 or a
// cudaError_t
int index_xp_args(XpLaunch* X, IndexXpArgs* xa, int* ends, long long wlo, long long n_ends,
                  long long chunk_lanes, unsigned long long magic, int shift, int L, int n_loc,
                  int shard0, int G, int P, int* outbox, long long cap, int* counts,
                  const int* const* indptr, const int* const* indices,
                  const float* const* alias_prob, const int* const* alias_other,
                  unsigned long long seed, int walks_per_lane, long long blocks, void* stream) {
  const int bad = xp_args(X, L, G, P, shard0, n_loc, 1, nullptr, 0, ends, outbox, cap, counts,
                          indptr, indices, alias_prob, alias_other, seed, walks_per_lane, blocks,
                          stream);
  if (bad) return bad;
  // a warp's batch fits its part of the stage; every walk number below 2^31
  if (ends == nullptr || wlo < 0 || n_ends < 0 || wlo + n_ends >= (1ll << 31) ||
      chunk_lanes < 1 || chunk_lanes >= (1ll << 31) || magic >= (1ull << 32) || shift < 31 ||
      shift > 62)
    return (int)cudaErrorInvalidValue;
  *xa = IndexXpArgs{};
  xa->ends = ends;
  xa->wlo = (uint32_t)wlo;
  xa->chunk_lanes = (uint32_t)chunk_lanes;
  xa->magic = (uint32_t)magic;
  xa->shift = shift;
  return 0;
}

// fora_index_walk_xp's checks and arguments (the own-start form)
int index_xp_own_args(XpLaunch* X, IndexXpArgs* xa, const int* start, long long W,
                      long long w0, int* ends, long long wlo, long long n_ends,
                      long long chunk_lanes, unsigned long long magic, int shift, int L,
                      int n_loc, int shard0, int G, int P,
                      int* outbox, long long cap, int* counts, const int* const* indptr,
                      const int* const* indices, const float* const* alias_prob,
                      const int* const* alias_other, unsigned long long seed,
                      float inv_log1m_alpha, int max_hops, int walks_per_lane, long long blocks,
                      void* stream) {
  const int bad = index_xp_args(X, xa, ends, wlo, n_ends, chunk_lanes, magic, shift, L, n_loc,
                                shard0, G, P, outbox, cap, counts, indptr, indices, alias_prob,
                                alias_other, seed, walks_per_lane, blocks, stream);
  if (bad) return bad;
  if (W < 0 || w0 < wlo || w0 + W > wlo + n_ends || max_hops > kMaxXpHops ||
      (W > 0 && start == nullptr) || 32 * walks_per_lane > kWarpStage)
    return (int)cudaErrorInvalidValue;
  WalkArgs a;
  const int bad_walk = walk_args(&a, start, nullptr, W, seed, inv_log1m_alpha, max_hops,
                                 walks_per_lane, blocks);
  if (bad_walk) return bad_walk;
  a.n_loc = n_loc;
  a.w0 = (uint32_t)w0;
  X->a = a;
  return 0;
}

// fora_index_walk_xp_inbox's checks and arguments: counts [P + 1], the
// claims' cursor at P
int index_xp_inbox_args(XpLaunch* X, IndexXpArgs* xa, const int* inbox, long long n_in,
                        int* ends, long long wlo, long long n_ends, long long chunk_lanes,
                        unsigned long long magic, int shift, int n_loc, int shard0, int L, int G,
                        int P, int* outbox, long long cap,
                        int* counts, const int* const* indptr, const int* const* indices,
                        const float* const* alias_prob, const int* const* alias_other,
                        unsigned long long seed, int walks_per_lane, long long blocks,
                        void* stream) {
  const int bad = index_xp_args(X, xa, ends, wlo, n_ends, chunk_lanes, magic, shift, L, n_loc,
                                shard0, G, P, outbox, cap, counts, indptr, indices, alias_prob,
                                alias_other, seed, walks_per_lane, blocks, stream);
  if (bad) return bad;
  if (n_in < 0 || n_in >= (1ll << 31) || (n_in > 0 && (inbox == nullptr || blocks < 1)))
    return (int)cudaErrorInvalidValue;
  xa->inbox = reinterpret_cast<const int4*>(inbox);
  xa->cursor = reinterpret_cast<unsigned*>(counts + P);
  xa->n_in = (uint32_t)n_in;
  xa->claim_max = (uint32_t)walks_per_lane;
  if (n_in == 0) X->blocks = 0;
  return 0;
}

}  // namespace

// alias_prob and alias_other are both null (uniform hops) or both set;
// hub_id and pool are both null (no hub lookup) or both set, pool [H, pool_size].
// The plan (kernels/schedule.py::walk_plan): `blocks` blocks of 256 threads,
// each warp owning 32 * walks_per_lane consecutive walks; they must cover W.
extern "C" int fora_index_walk(const int* start, int* out, long long W, const int* indptr,
                               const int* indices, const float* alias_prob,
                               const int* alias_other, const int* hub_id, const int* pool,
                               int pool_size, unsigned long long seed, float inv_log1m_alpha,
                               int max_hops, int walks_per_lane, long long blocks,
                               void* stream) {
  if ((alias_prob == nullptr) != (alias_other == nullptr)) return (int)cudaErrorInvalidValue;
  if ((hub_id == nullptr) != (pool == nullptr)) return (int)cudaErrorInvalidValue;
  if (hub_id != nullptr && pool_size <= 0) return (int)cudaErrorInvalidValue;
  WalkArgs a;
  const int bad = walk_args(&a, start, out, W, seed, inv_log1m_alpha, max_hops,
                            walks_per_lane, blocks);
  if (bad) return bad;
  if (W <= 0) return (int)cudaGetLastError();
  a.indptr = indptr;
  a.indices = indices;
  a.alias_prob = alias_prob;
  a.alias_other = alias_other;
  a.hub_id = hub_id;
  a.pool = pool;
  a.pool_size = pool_size;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const unsigned nb = (unsigned)blocks;
  const bool alias = alias_prob != nullptr, hub = hub_id != nullptr;
  if (alias && hub)
    launch<true, true>(a, nb, s);
  else if (alias)
    launch<true, false>(a, nb, s);
  else if (hub)
    launch<false, true>(a, nb, s);
  else
    launch<false, false>(a, nb, s);
  return (int)cudaGetLastError();
}

// The sharded form: G (1 .. 32) slices, host arrays of G device pointers
// each (alias_prob and alias_other both null, or both G pointers); node v
// lies in slice v / n_loc at row v % n_loc.  The plan as above.
extern "C" int fora_index_walk_sharded(const int* start, int* out, long long W,
                                       const int* const* indptr, const int* const* indices,
                                       const float* const* alias_prob,
                                       const int* const* alias_other, int G, int n_loc,
                                       unsigned long long seed, float inv_log1m_alpha,
                                       int max_hops, int walks_per_lane, long long blocks,
                                       void* stream) {
  if ((alias_prob == nullptr) != (alias_other == nullptr)) return (int)cudaErrorInvalidValue;
  if (G < 1 || G > kMaxShards || n_loc < 1 || indptr == nullptr || indices == nullptr)
    return (int)cudaErrorInvalidValue;
  WalkArgs a;
  const int bad = walk_args(&a, start, out, W, seed, inv_log1m_alpha, max_hops,
                            walks_per_lane, blocks);
  if (bad) return bad;
  if (W <= 0) return (int)cudaGetLastError();
  a.n_loc = n_loc;
  const bool alias = alias_prob != nullptr;
  ShardTables t = {};
  for (int k = 0; k < G; ++k) {
    if (indptr[k] == nullptr || indices[k] == nullptr) return (int)cudaErrorInvalidValue;
    t.indptr[k] = indptr[k];
    t.indices[k] = indices[k];
    if (alias) {
      if (alias_prob[k] == nullptr || alias_other[k] == nullptr)
        return (int)cudaErrorInvalidValue;
      t.alias_prob[k] = alias_prob[k];
      t.alias_other[k] = alias_other[k];
    }
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (alias)
    launch_sharded<true>(a, t, (unsigned)blocks, s);
  else
    launch_sharded<false>(a, t, (unsigned)blocks, s);
  return (int)cudaGetLastError();
}

// K6+K4: one chunk of the raw walk phase.  Row t of the chunk is lane
// lane_lo + t of each of the Bc columns; walk (t, b) draws with Philox key
// t * Bc + b, as K4 draws walk t * Bc + b of the chain's [rows, Bc] start
// array.  bounds == nullptr: G = 1, r[0] [n, Bc] (row stride r_ld), cum[0]
// (column b at cum[0] + b * cum_ld), total [Bc], the graph indptr[0] /
// indices[0] (and alias_prob[0] / alias_other[0] or null), out[0] [., Bc]
// (row stride out_ld); lane l of column b walks from the first v with
// cum[v] > l, for l < total[b], and adds r[v, b] / omega_v at its endpoint.
// Else G shards' r[h], cum[h] and out[h] alike, their out-CSR slices
// (rows h * n_loc ..) and bounds [G + 1, Bc] int64: lane l of column b is
// shard h's lane l - bounds[h, b] where bounds[h, b] <= l < bounds[h + 1,
// b], starts at its node + h * n_loc and adds into out[h]; lanes past
// bounds[G, b] are not walked.  ends, unless null, gets each walked lane's
// endpoint at t * Bc + b.  The plan (kernels/schedule.py::raw_walk_plan):
// `tiles` warp tiles of 32 * walks_per_lane rows per column, `blocks`
// blocks of 8 warps covering tiles * Bc.
extern "C" int fora_raw_walk(const float* const* r, long long r_ld, const int* const* cum,
                             long long cum_ld, const int* total, const long long* bounds,
                             int G, long long n, int Bc, long long rows, long long lane_lo,
                             int n_loc, float* const* out, long long out_ld, int* ends,
                             const int* const* indptr, const int* const* indices,
                             const float* const* alias_prob, const int* const* alias_other,
                             unsigned long long seed, float inv_log1m_alpha, int max_hops,
                             int walks_per_lane, long long tiles, long long blocks,
                             void* stream) {
  RawLaunch L;
  const int bad = raw_args(&L, r, r_ld, cum, cum_ld, total, bounds, G, n, Bc, rows, lane_lo,
                           n_loc, out, out_ld, ends, indptr, indices, alias_prob, alias_other,
                           seed, inv_log1m_alpha, max_hops, walks_per_lane, tiles, blocks,
                           stream);
  if (bad) return bad;
  if (L.blocks == 0) return (int)cudaGetLastError();
  if (L.alias && L.sharded)
    launch_raw<true, true>(L.a, L.ra, L.t, L.rt, L.blocks, L.s);
  else if (L.alias)
    launch_raw<true, false>(L.a, L.ra, L.t, L.rt, L.blocks, L.s);
  else if (L.sharded)
    launch_raw<false, true>(L.a, L.ra, L.t, L.rt, L.blocks, L.s);
  else
    launch_raw<false, false>(L.a, L.ra, L.t, L.rt, L.blocks, L.s);
  return (int)cudaGetLastError();
}

// K6+K4-xp's own-lane form: round 0 of a chunk of the raw walk phase in
// process `rank` = shard0 / L of P, which holds shards shard0 .. shard0 + L
// - 1 of G = P L (1 <= G <= 32): their residues r[k], demands cum[k] (as
// fora_raw_walk's) and out-CSR slices indptr[k] / indices[k] (and
// alias_prob[k] / alias_other[k], or both null), and bounds [L + 1, Bc],
// this process's rows of the chunk's running totals (lane l of column b is
// shard shard0 + k's where bounds[k, b] <= l < bounds[k + 1, b]).  Its own
// lanes in lane_lo .. lane_lo + rows - 1 walk as fora_raw_walk's sharded
// form walks them (walk t * Bc + b, max_hops below 2^15).  A walk that
// ends adds its weight into out [G * n_loc, Bc] (row stride out_ld) at its
// endpoint, column b, and writes ends[w] unless ends is null; a walk whose
// node leaves the process's rows before its last hop goes to outbox [P,
// cap, 4] int32 at destination cur / (L n_loc) as (w, cur, h | len << 16,
// weight bits), counts[d] (zeroed here by a cudaMemsetAsync) counting them;
// a count past cap means records were not written.  The plan
// (kernels/schedule.py::xp_walk_plan, its `own` form): `tiles` warp tiles of
// 32 * walks_per_lane own lanes per column (from the column's first lane
// here), `blocks` blocks of 8 warps covering tiles * Bc.
extern "C" int fora_raw_walk_xp(const float* const* r, long long r_ld, const int* const* cum,
                                long long cum_ld, const long long* bounds, int L, long long n,
                                int Bc, long long rows, long long lane_lo, int n_loc, int shard0,
                                int G, int P, float* out, long long out_ld, int* ends,
                                int* outbox, long long cap, int* counts,
                                const int* const* indptr, const int* const* indices,
                                const float* const* alias_prob, const int* const* alias_other,
                                unsigned long long seed, float inv_log1m_alpha, int max_hops,
                                int walks_per_lane, long long tiles, long long blocks,
                                void* stream) {
  XpLaunch X;
  const int bad = xp_own_args(&X, r, r_ld, cum, cum_ld, bounds, L, n, Bc, rows, lane_lo, n_loc,
                              shard0, G, P, out, out_ld, ends, outbox, cap, counts, indptr,
                              indices, alias_prob, alias_other, seed, inv_log1m_alpha, max_hops,
                              walks_per_lane, tiles, blocks, stream);
  if (bad) return bad;
  cudaMemsetAsync(counts, 0, sizeof(int) * P, X.s);
  if (X.blocks) launch_xp_own<kXpOwnBlocksPerSM, StagedLeave>(X);
  return (int)cudaGetLastError();
}

// K6+K4-xp's inbox form: a later round, the n_in records of `inbox` [n_in,
// 4] int32 (w, cur, h | len << 16, weight bits) that the other processes
// handed over, each walked on from where it stopped over the same slices,
// ended, added (column w % Bc) and handed on as fora_raw_walk_xp does.  The
// plan (xp_walk_plan's `inbox` form): 32 * walks_per_lane records a warp,
// `blocks` blocks of 8 warps covering them.
extern "C" int fora_raw_walk_xp_inbox(const int* inbox, long long n_in, int Bc, int n_loc,
                                      int shard0, int L, int G, int P, float* out,
                                      long long out_ld, int* ends, int* outbox, long long cap,
                                      int* counts, const int* const* indptr,
                                      const int* const* indices, const float* const* alias_prob,
                                      const int* const* alias_other, unsigned long long seed,
                                      int walks_per_lane, long long blocks, void* stream) {
  if (out == nullptr) return (int)cudaErrorInvalidValue;
  XpLaunch X;
  const int bad = xp_inbox_args(&X, inbox, n_in, Bc, n_loc, shard0, L, G, P, out, out_ld, ends,
                                outbox, cap, counts, indptr, indices, alias_prob, alias_other,
                                seed, walks_per_lane, blocks, stream);
  if (bad) return bad;
  cudaMemsetAsync(counts, 0, sizeof(int) * P, X.s);
  if (X.blocks) launch_xp_inbox<kXpInboxBlocksPerSM, StagedLeave>(X);
  return (int)cudaGetLastError();
}

// K4-xp's own-start form: round 0 of a window of the index build (whole
// chunks of chunk_lanes walks from walk wlo, n_ends walks) in process
// `rank` = shard0 / L of P, which holds shards shard0 .. shard0 + L - 1 of
// G = P L (1 <= G <= 32), their out-CSR slices indptr[k] / indices[k] (and
// alias_prob[k] / alias_other[k], or both null).  Its W own starts
// `start`, the window's walks w0 .. w0 + W - 1 (one run: the starts are
// sorted by node), walk as fora_index_walk_sharded walks walk w % chunk_lanes
// of chunk w / chunk_lanes at seed + (w / chunk_lanes) 2^32 (max_hops below
// 2^15), over the local slices: a walk that ends writes its endpoint at
// ends[w - wlo]; a walk whose node leaves the process's rows before its
// last hop writes -1 there and goes to outbox [P, cap, 4] int32 at
// destination cur / (L n_loc) as (w, cur, h | len << 16, 0), counts[d]
// counting them (zero at the launch).  The plan (kernels/schedule.py::
// index_xp_plan, its `own` form): K4's, `blocks` blocks of 8 warps of 32 *
// walks_per_lane walks.
extern "C" int fora_index_walk_xp(const int* start, long long W, long long w0, int* ends,
                                  long long wlo, long long n_ends, long long chunk_lanes,
                                  unsigned long long magic, int shift, int L, int n_loc,
                                  int shard0, int G, int P, int* outbox, long long cap,
                                  int* counts, const int* const* indptr,
                                  const int* const* indices, const float* const* alias_prob,
                                  const int* const* alias_other, unsigned long long seed,
                                  float inv_log1m_alpha, int max_hops, int walks_per_lane,
                                  long long blocks, void* stream) {
  XpLaunch X;
  IndexXpArgs xa;
  const int bad = index_xp_own_args(&X, &xa, start, W, w0, ends, wlo, n_ends, chunk_lanes,
                                    magic, shift, L, n_loc, shard0, G, P, outbox, cap, counts,
                                    indptr, indices, alias_prob, alias_other, seed,
                                    inv_log1m_alpha, max_hops, walks_per_lane, blocks, stream);
  if (bad) return bad;
  if (W > 0) launch_index_xp_own<kIndexXpBlocksPerSM>(X, xa);
  return (int)cudaGetLastError();
}

// K4-xp's inbox form: a later round, the n_in records of `inbox` [n_in, 4]
// int32 (w, cur, h | len << 16, 0) that the other processes handed over,
// each walked on from where it stopped over the same slices, its endpoint
// written at ends[w - wlo] or handed on as fora_index_walk_xp does.
// counts [P + 1] is zero at the launch: the P counts, then the cursor of
// the records claimed.  The plan (index_xp_plan's `inbox` form): `blocks`
// resident blocks of 8 warps, each claim what is left over the warps, at
// least 32 records and at most 32 * walks_per_lane.
extern "C" int fora_index_walk_xp_inbox(const int* inbox, long long n_in, int* ends,
                                        long long wlo, long long n_ends, long long chunk_lanes,
                                        unsigned long long magic, int shift, int n_loc,
                                        int shard0, int L, int G, int P, int* outbox,
                                        long long cap, int* counts, const int* const* indptr,
                                        const int* const* indices,
                                        const float* const* alias_prob,
                                        const int* const* alias_other, unsigned long long seed,
                                        int walks_per_lane, long long blocks, void* stream) {
  XpLaunch X;
  IndexXpArgs xa;
  const int bad = index_xp_inbox_args(&X, &xa, inbox, n_in, ends, wlo, n_ends, chunk_lanes,
                                      magic, shift, n_loc, shard0, L, G, P, outbox, cap, counts,
                                      indptr, indices, alias_prob, alias_other, seed,
                                      walks_per_lane, blocks, stream);
  if (bad) return bad;
  if (X.blocks) launch_index_xp_inbox<kIndexXpInboxBlocksPerSM>(X, xa);
  return (int)cudaGetLastError();
}

// K6+K4-src: one chunk of source-rooted walks.  Walk t (0 .. rows - 1) of
// column b (0 .. B - 1) starts at sources[b] and draws with Philox key t * B
// + b, as K4 draws walk t * B + b of the start array sources.repeat(rows);
// it hops over indptr / indices (alias_prob / alias_other both null, or
// both set: alias hops), ends at a pool entry where a hop lands on a hub
// (hub_id / pool both null, or both set, pool [H, pool_size]), and adds
// `weight` at its endpoint into out [n, B] (row stride out_ld).  ends,
// unless null, gets every endpoint at t * B + b.  The plan
// (kernels/schedule.py::raw_walk_plan): `tiles` warp tiles of 32 *
// walks_per_lane walks per column, `blocks` blocks of 8 warps covering
// tiles * B, tile j of column b the grid's warp j * B + b.
extern "C" int fora_source_walk(const int* sources, int B, float* out, long long out_ld,
                                long long n, int* ends, long long rows, const int* indptr,
                                const int* indices, const float* alias_prob,
                                const int* alias_other, const int* hub_id, const int* pool,
                                int pool_size, unsigned long long seed, float inv_log1m_alpha,
                                int max_hops, float weight, int walks_per_lane, long long tiles,
                                long long blocks, void* stream) {
  SrcLaunch L;
  const int bad = source_args(&L, sources, B, out, out_ld, n, ends, rows, indptr, indices,
                              alias_prob, alias_other, hub_id, pool, pool_size, seed,
                              inv_log1m_alpha, max_hops, weight, walks_per_lane, tiles, blocks,
                              stream);
  if (bad) return bad;
  if (L.blocks == 0) return (int)cudaGetLastError();
  const dim3 grid(L.blocks), block(kBlockThreads);
  if (L.alias && L.hub)
    source_walk_kernel<true, true><<<grid, block, 0, L.s>>>(L.a, L.sa);
  else if (L.alias)
    source_walk_kernel<true, false><<<grid, block, 0, L.s>>>(L.a, L.sa);
  else if (L.hub)
    source_walk_kernel<false, true><<<grid, block, 0, L.s>>>(L.a, L.sa);
  else
    source_walk_kernel<false, false><<<grid, block, 0, L.s>>>(L.a, L.sa);
  return (int)cudaGetLastError();
}
