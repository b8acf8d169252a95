// K6: the raw walk's lane allocation and endpoint accumulation, in three
// kernels.  On a card the raw pool and the sharded raw one-shot run the
// demand (1; the one-shot's shards in one launch) and then, per chunk,
// K6+K4 (walk.cu's raw_walk_kernel), which does the work of the expansion
// (2), K4 and the accumulate (3) in one launch.  Monte Carlo and HubPPR run K6+K4-src (walk.cu's
// source_walk_kernel), which does the accumulate's work in their walks'
// launch.  So the expansion and the accumulate run on no path: they stay as
// the earlier forms that the card's tests and chip_smoke.py hold K6+K4 and
// K6+K4-src against, the accumulate's sharded form for those checks too.
//
// Replaces fora_tpu/ops/walk.py::allocate_walks (48-86: omega_v, its int32
// cumsum over nodes, the lane -> node map by scatter + cummax, and the
// take_along_axis of r and omega_v for the weight) and accumulate_endpoints
// (323-329: a vmapped segment_sum), which XLA lowers on the TPU.  The plain
// versions in ops/walk.py (walk_demand_plain, expand_lanes_plain over
// _lane_nodes, expand_chunk_lanes_plain, accumulate_endpoints_plain,
// accumulate_chunk_endpoints_plain) compute the same functions and stay as
// the CPU path and the reference.
//
// 1. walk_demand: per shard g (1-32) and column b of r_g [n, Bc] (rows of
//    stride ld, columns contiguous: a column slice of a [n, B] residue)
//      omega_v = r_v > 0 ? ceil(r_v * omega_unit) : 0    (f32 product, no FMA)
//      cum[g, b, v] = sum_{u <= v} omega_u (int32),  total[g, b] = cum[g, b, n - 1]
//    Bound: bytes, r's 32-byte sectors read once and cum written once (at
//    [524288, 64] 268 MB, 0.08 ms at 3.35 TB/s; a slice of one column of
//    64 reads 8 times its bytes).  One launch, a single pass with
//    decoupled look-back (Merrill and Garland, "Single-pass Parallel Prefix
//    Scan with Decoupled Look-back", 2016).  The columns fall into groups
//    of cw = min(8, 2^ceil(log2 Bc)) (a 32-byte sector of a row); a chain
//    is a (shard, column group), cut into tiles of 8192 entries, TN = 8192
//    / cw nodes (1024 at 8 columns: taller tiles, shorter chains).  Blocks
//    are persistent, as many as the card holds at once.  A block takes
//    tickets from an atomic counter, which name a tile and its chain with
//    the tiles in order (ticket k: tile k / chains of chain k % chains),
//    so every tile it waits on belongs to a block that is already running
//    (by blockIdx, a block could wait on a tile not yet resident, and
//    deadlock).  While it works on one tile, the next ticket's tile is on
//    its way into a second shared-memory buffer by cp.async (coalesced: a
//    warp's copies cover cw neighbouring columns of 32 / cw neighbouring
//    nodes, laid out [column][node]).  Each
//    thread scans a run of 32 nodes of one column serially; the runs' sums
//    are scanned per column across the block (shuffles, then 8 warps'
//    totals), so every thread works at every width.  The block publishes
//    each column's tile sum (flag A; tile 0 its inclusive prefix, flag P),
//    looks back with all its threads (thread (c, q) reads column c of 4
//    predecessors, a window of 1024 / cw tiles a step; the window is cut
//    at the nearest unpublished word of any column and summed below it up
//    to each column's nearest P, so a step never reads a word twice), and
//    publishes its inclusive prefix; then it writes cum, 128 bytes a warp
//    store, and the chain's last tile writes total.
//    Status: one 64-bit word a (chain, tile, column), the flag (2 bits;
//    0 unpublished) and the int32 value, written and read whole (relaxed,
//    gpu scope), so a value never comes without its flag.  The ticket
//    counter and the words are a scratch that the caller allocates for
//    the call (kernels.walk_demand: from the caching allocator on the
//    launch's stream, so no other launch holds it meanwhile) and that the
//    entry point zeroes by a cudaMemsetAsync on that stream before the
//    kernel: nothing lives from one call to the next, so two streams or
//    two host threads never share a word.  (Words told apart by a
//    per-call epoch, never cleared, saved about 2 us a call and needed a
//    scratch kept per stream; probes/demand_forms.cu keeps that form.)
//    The sums are integers, so the look-back's order changes no bit: cum
//    and total are the plain cumsum's.  probes/demand_earlier.cu keeps the
//    earlier three-launch form (tile sums, their scan, the tiles read
//    again) and probes/demand_probe.py times it and the other forms tried
//    beside this one.
//
// 2. expand_lanes: for each row t of start/weight [rows, Bc] and column b,
//    the lane l = lane_lo + t:
//      node v = the first v with cum[b, v] > min(l, total[b] - 1)
//      weight = l < total[b] ? r[v, b] / (float)(cum[b, v] - cum[b, v - 1]) : 0
//    (an IEEE division); a lane at or past the total takes the column's last
//    node with omega > 0, an empty column node 0 (_lane_nodes' convention).
//    The sharded form expands a chunk of the sharded raw walk in one launch:
//    G shards' residues and demands (a table of pointers), and bounds [G +
//    1, Bc], the running sums of the shards' totals, so lane l of column b
//    is shard h's lane l - bounds[h, b] where bounds[h, b] <= l < bounds[h +
//    1, b], its node + h * n_loc; a lane past bounds[G, b] takes node 0,
//    weight 0.  (A launch a shard over the rows that hold its lanes visited
//    nearly the whole chunk each time, G times the lanes: 64 ms of the raw
//    one-shot's 390 on the H100, PERF.md.)
//    Bound: the 8 bytes a lane slot written, and the reads of cum and r at
//    the lanes' nodes, bounded below by their distinct 32-byte sectors.
//    The design: each thread runs 8 independent searches (a branchless
//    upper bound: every search of a launch takes ceil(log2 n) probes, so
//    the 8 chains and the 32 lanes stay in step and 8 loads a thread are in
//    flight).  A warp searches 32 neighbouring lanes of one column, whose
//    probes share their path through cum and meet in the L1 (hub nodes own
//    millions of lanes, which a search per lane does not mind).  The
//    results go through shared memory, so the writes run along the rows of
//    [rows, Bc] across columns, coalesced.
//
// 3. accumulate_endpoints: out[ends[t, b] * out_ld + b] += weight[t, b] for
//    every lane with a non-zero weight (the padding lanes carry 0), weight a
//    [W, Bc] array or one scalar; in the sharded form into the partial of
//    the shard whose lanes (bounds, as above) hold row t, and nowhere past
//    bounds[G, b], one launch a chunk.  f32 atomics (RED: the result is
//    unused), so the order of the adds varies from run to run.  Bound: 8
//    bytes a lane read, plus the distinct sectors of out it touches, read
//    and written.  A warp takes 32 neighbouring entries of [W, Bc]: one lane
//    row across columns where Bc >= 32, so its adds to one hot endpoint
//    fall into neighbouring words of one row of out; each thread has 4
//    lanes' loads in flight before its adds.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;           // every kernel's block
constexpr int kWarps = kThreads / 32;
constexpr int kExpandTile = 2048;       // lane slots of an expansion tile
constexpr int kSegs = kExpandTile / kThreads;   // searches a thread runs at once
constexpr int kAccUnroll = 4;           // lanes a thread loads before its adds
constexpr int kMaxShards = 32;
constexpr unsigned kFull = 0xffffffffu;
// The demand's tile, 32 entries a thread (8192 a tile), and its widest
// column group, 8 columns (probes/demand_forms.cu times other sizes)
constexpr int kDemandEntries = 32;
constexpr int kDemandTileLog2 = 13;
constexpr int kDemandColumnsLog2 = 3;

__device__ __forceinline__ int omega_of(float r, float unit) {
  return r > 0.0f ? (int)ceilf(__fmul_rn(r, unit)) : 0;
}

// A demand status word: flag << 32 | value (flag 0: unpublished).
constexpr unsigned long long kAggregate = 1ull << 32, kPrefix = 2ull << 32;

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(w) : "l"(p) : "memory");
  return w;
}

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long flag,
                                             int value) {
  const unsigned long long w = flag | (unsigned)value;
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(w) : "memory");
}

// The block's look-back shared state, per column of the group.
struct LookBack {
  int wsum[kWarps][32];     // a warp's sum of its lanes' runs, up to its nearest P
  int wflag[kWarps][32];    // 1: a P in the warp's runs
  int wmin[kWarps];         // a warp's nearest unpublished word
  int excl[32];             // the tile's exclusive prefix so far
  int done[32];             // the column met an inclusive prefix
  int ctl;                  // the tiles consumed, or -1: every column done
};

// Every thread's share of one look-back step for tile t > 0 of a chain
// whose words are st[tile * cw + column]: the window is the W = 256 / cw *
// 4 tiles below top (128 at 8 columns, 1024 at one); thread (c, q) =
// (thread % cw, thread / cw) reads column c of the 4 tiles top - 4 q - m
// (m < 4, its loads in flight together).  The window is cut
// at the nearest unpublished word a of any column (a block-wide minimum);
// below it each column sums its words up to its nearest inclusive prefix
// (flag P), the lanes of a column combining their runs in order by
// ballots and warp 0 the warps' in order.  Returns a, the tiles consumed
// (0: read the window again; W: none unpublished), or -1 when every
// column met its P (lb.excl then holds the exclusive prefixes).
__device__ int look_back_step(const unsigned long long* st, long long top, int cw_log2,
                              LookBack& lb) {
  constexpr int kR = 4;
  const int cw = 1 << cw_log2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = threadIdx.x & (cw - 1), q = threadIdx.x >> cw_log2;
  const bool was_done = lb.done[c] != 0;
  unsigned long long w[kR];
#pragma unroll
  for (int m = 0; m < kR; ++m)
    if (!was_done && top - q * kR - m >= 0)
      w[m] = load_status(st + (top - q * kR - m) * cw + c);
  unsigned flag[kR];
  int val[kR], near = 0x7fffffff;
#pragma unroll
  for (int m = 0; m < kR; ++m) {
    flag[m] = 2;
    val[m] = 0;
    if (!was_done && top - q * kR - m >= 0) {
      flag[m] = (unsigned)(w[m] >> 32) & 3u;
      val[m] = (int)(unsigned)w[m];
    }
    if (flag[m] == 0 && near == 0x7fffffff) near = q * kR + m;
  }
  near = __reduce_min_sync(kFull, near);
  if (lane == 0) lb.wmin[warp] = near;
  __syncthreads();
  int a = (kThreads >> cw_log2) * kR;
#pragma unroll
  for (int v = 0; v < kWarps; ++v) a = min(a, lb.wmin[v]);
  int sum = 0;
  bool prefix = was_done;
#pragma unroll
  for (int m = 0; m < kR; ++m) {
    if (prefix || q * kR + m >= a) continue;
    sum += val[m];
    prefix = flag[m] == 2;
  }
  // the lanes of column c in this warp are c, c + cw, ... in run order
  unsigned colmask = 0;
  for (int i = c; i < 32; i += cw) colmask |= 1u << i;
  const unsigned mine = __ballot_sync(kFull, prefix) & colmask;
  const int first = mine ? __ffs(mine) - 1 : 32;       // the nearest P's lane
  int x = lane <= first ? sum : 0;
  for (int off = cw; off < 32; off <<= 1) x += __shfl_xor_sync(kFull, x, off);
  if (lane < cw) {
    lb.wsum[warp][lane] = x;
    lb.wflag[warp][lane] = mine != 0;
  }
  __syncthreads();
  if (warp == 0) {
    int tot = 0;
    bool found = lane >= cw || lb.done[lane] != 0;
    const bool old = found;
    for (int v = 0; v < kWarps && !found; ++v) {
      tot += lb.wsum[v][lane];
      found = lb.wflag[v][lane] != 0;
    }
    if (!old) {
      lb.excl[lane] += tot;
      lb.done[lane] = found;
    }
    const bool all = __all_sync(kFull, found);
    if (lane == 0) lb.ctl = all ? -1 : a;
  }
  __syncthreads();
  return lb.ctl;
}

struct DemandTable {          // per shard: its residue
  const float* r[kMaxShards];
};

// One tile of kE * 256 entries (kE = kDemandEntries): TN = kE * 256 / cw
// nodes of a chain's cw columns, copied by cp.async into ``buf`` as
// [column][node] (runs of kE nodes padded by a word), entries past n or
// Bc zero.  Thread (c, q) =
// (thread % cw, thread / cw) copies column c of nodes q + j * 256 / cw (j
// < kE): a warp's copy covers cw neighbouring columns of 32 / cw
// neighbouring nodes.  No register holds the data in flight.
__device__ __forceinline__ void copy_tile(const DemandTable& tab, long long ld, long long n,
                                          int Bc, int cw_log2, int col_groups,
                                          long long chains, long long k, int pitch,
                                          float* buf) {
  constexpr int kE = kDemandEntries, RP = kE + 1;
  const int cw = 1 << cw_log2;
  const int Q = kThreads >> cw_log2;
  const long long t = k / chains, chain = k % chains;
  const int c = threadIdx.x & (cw - 1), q = threadIdx.x >> cw_log2;
  const int b = (int)(chain % col_groups) * cw + c;
  const long long v0 = t * (kE * kThreads >> cw_log2) + q;
  const float* p = tab.r[chain / col_groups] + (b < Bc ? v0 * ld + b : 0);
  const unsigned dst = (unsigned)__cvta_generic_to_shared(buf + c * pitch);
#pragma unroll
  for (int j = 0; j < kE; ++j) {
    const int i = q + j * Q;
    const bool ok = b < Bc && v0 + (long long)j * Q < n;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                     dst + (unsigned)(((i / kE) * RP + i % kE) * sizeof(float))),
                 "l"(ok ? p + (long long)j * Q * ld : p), "r"(ok ? 4 : 0)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Persistent blocks over tickets.  A block holds two tickets: the tile it
// scans, looks back and writes, and the next, whose copy into the other
// buffer is in flight meanwhile; a ticket's atomic is issued at the start
// of a tile and its value needed only after the tile's scan.  The tile
// ahead has published nothing while the block finishes the first, whose
// predecessors have all published their sums (a tile publishes its sum
// before it waits), so no tile waits on one that cannot go on.  In a
// tile, thread (c, q) scans its run q of column c serially (omega from
// the copied r), the block scans the runs' sums per column (shuffles over
// the lanes of a column, then the warps' totals), the run's inclusive
// sums go back in place, and after the look-back they become cum, 128
// bytes a warp store.  The padding word of a run keeps both the copy's
// and the scan's accesses free of bank conflicts.  ticket and status come
// zeroed.
__global__ void __launch_bounds__(kThreads) demand_kernel(
    const DemandTable tab, long long ld, long long n, int Bc, int cw_log2, int col_groups,
    long long chains, long long n_tiles, float unit, unsigned long long* __restrict__ ticket,
    unsigned long long* __restrict__ status, int* __restrict__ cum, int* __restrict__ total) {
  constexpr int kE = kDemandEntries, RP = kE + 1;
  extern __shared__ float s_buf[];     // 2 x [cw][TN / kE runs of kE + 1] + 32 / cw
  __shared__ int s_wt[kWarps][32];     // a warp's sum of its runs, per column
  __shared__ LookBack lb;
  __shared__ unsigned long long s_k[4];    // tickets, a slot a tile in turn
  const int cw = 1 << cw_log2;
  const int tile_log2 = kDemandTileLog2 - cw_log2;
  const int pitch = (kThreads >> cw_log2) * RP + (32 >> cw_log2);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = threadIdx.x & (cw - 1), q = threadIdx.x >> cw_log2;
  const unsigned long long tiles = (unsigned long long)(chains * n_tiles);
  if (threadIdx.x == 0) s_k[0] = atomicAdd(ticket, 1ull);
  __syncthreads();
  unsigned long long k = s_k[0];      // the tile to scan, its copy in flight
  if (k < tiles)
    copy_tile(tab, ld, n, Bc, cw_log2, col_groups, chains, (long long)k, pitch, s_buf);
  else
    asm volatile("cp.async.commit_group;" ::: "memory");
  for (int it = 0;; ++it) {
    if (k >= tiles) return;
    float* buf = s_buf + (it & 1) * cw * pitch;
    int* tile = reinterpret_cast<int*>(buf);
    const long long t = (long long)(k / (unsigned long long)chains);
    const long long chain = (long long)(k % (unsigned long long)chains);
    const int g = (int)(chain / col_groups);
    const int col0 = (int)(chain % col_groups) << cw_log2;
    const long long v0 = t << tile_log2;
    unsigned long long taken = 0;
    if (threadIdx.x == 0) taken = atomicAdd(ticket, 1ull);
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();
    // thread (c, q)'s run: its sum of omega, its offset in the tile, then
    // its inclusive sums from the offset in place (omega read twice from
    // shared memory, so no register holds the run)
    const float* run = buf + c * pitch + q * RP;
    int* irun = tile + c * pitch + q * RP;
    int sum = 0;
#pragma unroll 8
    for (int j = 0; j < kE; ++j) sum += omega_of(run[j], unit);
    // the lanes of column c in a warp are c, c + cw, ... in run order
    int incl = sum;
    for (int d = cw; d < 32; d <<= 1) {
      const int z = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += z;
    }
    if (lane >= 32 - cw) s_wt[warp][c] = incl;
    __syncthreads();
    int off = incl - sum;
#pragma unroll
    for (int v = 0; v < kWarps; ++v)
      if (v < warp) off += s_wt[v][c];
#pragma unroll 8
    for (int j = 0; j < kE; ++j) {
      off += omega_of(run[j], unit);
      irun[j] = off;
    }
    int agg = 0;
    if (threadIdx.x < cw) {
#pragma unroll
      for (int v = 0; v < kWarps; ++v) agg += s_wt[v][threadIdx.x];
    }
    unsigned long long* st = status + chain * n_tiles * cw;
    if (threadIdx.x == 0) s_k[it & 3] = taken;
    if (threadIdx.x < cw) {
      store_status(st + t * cw + threadIdx.x, t == 0 ? kPrefix : kAggregate, agg);
      lb.excl[threadIdx.x] = 0;
      lb.done[threadIdx.x] = t == 0;
    }
    __syncthreads();
    const unsigned long long kf = s_k[it & 3];
    if (kf < tiles)
      copy_tile(tab, ld, n, Bc, cw_log2, col_groups, chains, (long long)kf, pitch,
                s_buf + ((it + 1) & 1) * cw * pitch);
    else
      asm volatile("cp.async.commit_group;" ::: "memory");
    if (t > 0) {
      for (long long top = t - 1;;) {
        const int moved = look_back_step(st, top, cw_log2, lb);
        if (moved < 0) break;
        if (moved == 0) __nanosleep(64);
        top -= moved;
      }
      if (threadIdx.x < cw)
        store_status(st + t * cw + threadIdx.x, kPrefix, lb.excl[threadIdx.x] + agg);
    }
    if (threadIdx.x < cw && t == n_tiles - 1 && col0 + (int)threadIdx.x < Bc)
      total[(long long)g * Bc + col0 + threadIdx.x] = lb.excl[threadIdx.x] + agg;
    // (column, 32-node step) pairs, a warp store of 128 bytes each
    const int steps_log2 = tile_log2 - 5;
#pragma unroll 4
    for (int p = warp; p < (cw << steps_log2); p += kWarps) {
      const int cc = p >> steps_log2;
      const int i = ((p & ((1 << steps_log2) - 1)) << 5) + lane;
      const int b = col0 + cc;
      const long long v = v0 + i;
      if (b < Bc && v < n)
        cum[((long long)g * Bc + b) * n + v] =
            tile[cc * pitch + (i / kE) * RP + i % kE] + lb.excl[cc];
    }
    __syncthreads();
    k = kf;
  }
}

struct ShardTable {           // per shard: its residue and demand
  const float* r[kMaxShards];
  const int* cum[kMaxShards];
};

// A tile of (2048 / cw) rows x cw columns.  Segment g (0..63) of 32 lanes is
// column g % cw, rows (g / cw) * 32 .. + 31; thread (warp w, lane i) runs
// segments w, w + 8, ..., w + 56 at its lane i.  Row t is lane lane_lo + t;
// in the sharded form (kSharded) that lane of column b is shard h's lane
// l - bounds[h, b] where bounds[h, b] <= l < bounds[h + 1, b].
template <bool kSharded>
__global__ void __launch_bounds__(kThreads) expand_lanes_kernel(
    const ShardTable tab, long long r_ld, long long cum_ld, const int* __restrict__ total,
    const long long* __restrict__ bounds, int G, long long n, int Bc, int cw_log2,
    long long rows, long long lane_lo, int n_loc, int* __restrict__ start,
    float* __restrict__ weight) {
  // [row][column] with a pad column: TL * (cw + 1) <= 2 * kExpandTile
  __shared__ int s_node[2 * kExpandTile];
  __shared__ float s_w[2 * kExpandTile];
  __shared__ long long s_bound[kSharded ? kMaxShards + 1 : 1][32];
  const int cw = 1 << cw_log2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long t0 = (long long)blockIdx.x * (kExpandTile >> cw_log2);
  const int col0 = blockIdx.y * cw;
  if (kSharded) {
    for (int i = threadIdx.x; i < ((G + 1) << cw_log2); i += kThreads) {
      const int h = i >> cw_log2, c = i & (cw - 1);
      s_bound[h][c] = col0 + c < Bc ? bounds[(long long)h * Bc + col0 + c] : 0;
    }
    __syncthreads();
  }
  int x[kSegs], pos[kSegs], shard[kSegs];
  bool own[kSegs], search[kSegs], valid[kSegs];
  const int* col[kSegs];
#pragma unroll
  for (int k = 0; k < kSegs; ++k) {
    const int g = warp + kWarps * k;
    const int c = g & (cw - 1);
    const int b = col0 + c;
    const long long t = t0 + (long long)(g >> cw_log2) * 32 + lane;
    const long long l = lane_lo + t;
    own[k] = b < Bc && t < rows;
    int h = 0;
    long long lo = 0, tot = 0;
    if (own[k]) {
      if (kSharded) {
        while (h < G && s_bound[h + 1][c] <= l) ++h;
        if (h < G) {
          lo = s_bound[h][c];
          tot = s_bound[h + 1][c] - lo;
        }
      } else {
        tot = total[b];
      }
    }
    // unsharded: a lane past the total searches the last walk, weight 0;
    // sharded: a lane past every shard's lanes takes node 0, weight 0
    valid[k] = l - lo < tot;
    search[k] = own[k] && tot > 0 && (!kSharded || valid[k]);
    x[k] = (int)(valid[k] ? l - lo : tot - 1);
    shard[k] = h < G ? h : 0;
    col[k] = tab.cum[shard[k]] + (long long)(b < Bc ? b : 0) * cum_ld;
    pos[k] = 0;
  }
  // upper bound of x in cum[0 .. n): len shrinks alike for every search
  for (long long len = n; len > 1;) {
    const long long half = len >> 1;
#pragma unroll
    for (int k = 0; k < kSegs; ++k) {
      if (search[k] && col[k][pos[k] + half] <= x[k]) pos[k] += (int)half;
    }
    len -= half;
  }
#pragma unroll
  for (int k = 0; k < kSegs; ++k) {
    const int g = warp + kWarps * k;
    const int c = g & (cw - 1);
    const int row = (g >> cw_log2) * 32 + lane;
    int v = -1;
    float w = 0.0f;
    if (own[k]) {
      v = 0;
      if (search[k]) {
        v = pos[k] + (col[k][pos[k]] <= x[k] ? 1 : 0);
        if (valid[k]) {
          const int om = col[k][v] - (v > 0 ? col[k][v - 1] : 0);
          w = tab.r[shard[k]][(long long)v * r_ld + col0 + c] / (float)om;
        }
        v += shard[k] * n_loc;
      }
    }
    s_node[row * (cw + 1) + c] = v;
    s_w[row * (cw + 1) + c] = w;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kExpandTile; e += kThreads) {
    const int row = e >> cw_log2, c = e & (cw - 1);
    const int v = s_node[row * (cw + 1) + c];
    if (v < 0) continue;   // past the tile's rows or columns
    const long long i = (t0 + row) * Bc + col0 + c;
    start[i] = v;
    weight[i] = s_w[row * (cw + 1) + c];
  }
}

struct OutTable {             // per shard: its partial
  float* out[kMaxShards];
};

template <typename Index, bool kSharded>
__global__ void __launch_bounds__(kThreads) accumulate_endpoints_kernel(
    const int* __restrict__ ends, const float* __restrict__ weight, float wscalar, Index count,
    int Bc, const long long* __restrict__ bounds, int G, long long lane_lo, const OutTable tab,
    long long out_ld, long long n) {
  const Index stride = (Index)gridDim.x * kThreads * kAccUnroll;
  for (Index i0 = (Index)blockIdx.x * kThreads * kAccUnroll + threadIdx.x; i0 < count;
       i0 += stride) {
    int e[kAccUnroll];
    float w[kAccUnroll];
#pragma unroll
    for (int u = 0; u < kAccUnroll; ++u) {
      const Index i = i0 + (Index)u * kThreads;
      e[u] = i < count ? ends[i] : -1;
      w[u] = i < count ? (weight != nullptr ? weight[i] : wscalar) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kAccUnroll; ++u) {
      const Index i = i0 + (Index)u * kThreads;
      const Index t = i / (Index)Bc;
      const int b = (int)(i - t * (Index)Bc);
      bool add = w[u] != 0.0f && e[u] >= 0 && e[u] < n;
      float* out = tab.out[0];
      if (kSharded && add) {
        const long long l = lane_lo + (long long)t;
        int h = 0;
        while (h < G && bounds[(long long)(h + 1) * Bc + b] <= l) ++h;
        add = h < G;
        out = tab.out[h < G ? h : 0];
      }
      if (add) atomicAdd(out + (long long)e[u] * out_ld + b, w[u]);
    }
  }
}

int columns_log2(int Bc) {
  int k = 0;
  while (k < 5 && (1 << k) < Bc) ++k;
  return k;
}

}  // namespace

// G shards' r[g] [n, Bc] (row stride ld); cum [G, Bc, n] and total [G, Bc]
// int32.  scratch: at least 1 + G * ceil(Bc / cw) * cw * ceil(n / TN)
// words (cw = min(8, 2^ceil(log2 Bc)), TN = 8192 / cw), zeroed here on
// ``stream`` and then the ticket counter and the status words of the
// launch that follows on it; sms the card's SMs.
extern "C" int fora_walk_demand(const float* const* r, int G, long long ld, long long n, int Bc,
                                float unit, unsigned long long* scratch,
                                long long scratch_words, int* cum, int* total, int sms,
                                void* stream) {
  if (n < 0 || Bc < 0 || G < 1 || G > kMaxShards) return (int)cudaErrorInvalidValue;
  if (n == 0 || Bc == 0) return (int)cudaGetLastError();
  const int cw_log2 = columns_log2(Bc) < kDemandColumnsLog2 ? columns_log2(Bc)
                                                         : kDemandColumnsLog2;
  const int tile_log2 = kDemandTileLog2 - cw_log2;
  const int col_groups = (Bc + (1 << cw_log2) - 1) >> cw_log2;
  const long long n_tiles = (n + (1LL << tile_log2) - 1) >> tile_log2;
  const long long chains = (long long)G * col_groups;
  const long long words = 1 + chains * n_tiles * (1 << cw_log2);
  if (chains * n_tiles > 0x7fffffffLL || scratch_words < words)
    return (int)cudaErrorInvalidValue;
  DemandTable tab = {};
  for (int h = 0; h < G; ++h) tab.r[h] = r[h];
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  // the shared-memory limit and the blocks an SM holds, set and asked once
  // a card and column width (host calls that cost more than the launch)
  constexpr int kCards = 64;
  static int resident[kCards][kDemandColumnsLog2 + 1] = {};
  const size_t smem = 2 * ((size_t)(kThreads >> cw_log2) * (kDemandEntries + 1) +
                           (32 >> cw_log2)) * (1 << cw_log2) * sizeof(int);
  int card = 0;
  cudaError_t e = cudaGetDevice(&card);
  int per_sm = card < kCards ? resident[card][cw_log2] : 0;
  if (e == cudaSuccess && per_sm == 0) {
    if (smem > 48 * 1024)
      e = cudaFuncSetAttribute(demand_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, demand_kernel, kThreads, smem);
    if (e == cudaSuccess && card < kCards) resident[card][cw_log2] = per_sm;
  }
  if (e == cudaSuccess) e = cudaMemsetAsync(scratch, 0, (size_t)words * sizeof(*scratch), st);
  if (e != cudaSuccess) return (int)e;
  long long grid = (long long)(sms > 0 ? sms : 132) * (per_sm > 0 ? per_sm : 1);
  if (grid > chains * n_tiles) grid = chains * n_tiles;
  demand_kernel<<<(unsigned)grid, kThreads, smem, st>>>(tab, ld, n, Bc, cw_log2, col_groups,
                                                        chains, n_tiles, unit, scratch,
                                                        scratch + 1, cum, total);
  return (int)cudaGetLastError();
}

// start, weight [rows, Bc] contiguous; row t is lane lane_lo + t.  bounds ==
// nullptr: G = 1, r[0] and cum[0] (column b at cum[0] + b * cum_ld) and
// total; else G shards' r[h] and cum[h] alike and bounds [G + 1, Bc] int64
// (column b's lanes bounds[h, b] .. bounds[h + 1, b] - 1 are shard h's, its
// nodes + h * n_loc).  Every row is written.
extern "C" int fora_expand_lanes(const float* const* r, long long r_ld, const int* const* cum,
                                 long long cum_ld, const int* total, const long long* bounds,
                                 int G, long long n, int Bc, long long rows, long long lane_lo,
                                 int n_loc, int* start, float* weight, void* stream) {
  if (n <= 0 || Bc < 0 || rows < 0 || lane_lo < 0 || G < 1 || G > kMaxShards ||
      (bounds == nullptr && (G != 1 || total == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (rows == 0 || Bc == 0) return (int)cudaGetLastError();
  const int cw_log2 = columns_log2(Bc);
  const long long tiles = (rows + (kExpandTile >> cw_log2) - 1) / (kExpandTile >> cw_log2);
  const long long col_groups = (Bc + (1 << cw_log2) - 1) >> cw_log2;
  if (tiles > 0x7fffffffLL || col_groups > 65535 || n > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  ShardTable tab = {};
  for (int h = 0; h < G; ++h) {
    tab.r[h] = r[h];
    tab.cum[h] = cum[h];
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)tiles, (unsigned)col_groups);
  if (bounds != nullptr) {
    expand_lanes_kernel<true><<<grid, kThreads, 0, st>>>(tab, r_ld, cum_ld, nullptr, bounds, G,
                                                         n, Bc, cw_log2, rows, lane_lo, n_loc,
                                                         start, weight);
  } else {
    expand_lanes_kernel<false><<<grid, kThreads, 0, st>>>(tab, r_ld, cum_ld, total, nullptr, 1,
                                                          n, Bc, cw_log2, rows, lane_lo, 0,
                                                          start, weight);
  }
  return (int)cudaGetLastError();
}

// ends (and weight, unless nullptr: then every lane weighs wscalar) [W, Bc]
// contiguous; out[0] [n, Bc] with row stride out_ld.  With bounds [G + 1,
// Bc] int64, row t is lane lane_lo + t and adds into out[h] of the shard h
// whose lanes hold it (bounds[h, b] <= lane < bounds[h + 1, b]); lanes past
// bounds[G, b] add nowhere.
extern "C" int fora_accumulate_endpoints(const int* ends, const float* weight, float wscalar,
                                         long long W, int Bc, const long long* bounds, int G,
                                         long long lane_lo, float* const* out,
                                         long long out_ld, long long n, int sms,
                                         void* stream) {
  if (W < 0 || Bc < 0 || n < 0 || G < 1 || G > kMaxShards || (bounds == nullptr && G != 1))
    return (int)cudaErrorInvalidValue;
  const long long count = W * (long long)Bc;
  if (count == 0) return (int)cudaGetLastError();
  OutTable tab = {};
  for (int h = 0; h < G; ++h) tab.out[h] = out[h];
  const long long per_block = (long long)kThreads * kAccUnroll;
  long long blocks = (count + per_block - 1) / per_block;
  const long long cap = (long long)(sms > 0 ? sms : 132) * 16;
  if (blocks > cap) blocks = cap;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bool narrow = count + per_block * blocks < 0x7fffffffLL;
#define FORA_ACC(INDEX, SHARDED)                                                           \
  accumulate_endpoints_kernel<INDEX, SHARDED><<<(unsigned)blocks, kThreads, 0, st>>>(     \
      ends, weight, wscalar, (INDEX)count, Bc, bounds, G, lane_lo, tab, out_ld, n)
  if (bounds != nullptr) {
    if (narrow) FORA_ACC(unsigned, true); else FORA_ACC(long long, true);
  } else {
    if (narrow) FORA_ACC(unsigned, false); else FORA_ACC(long long, false);
  }
#undef FORA_ACC
  return (int)cudaGetLastError();
}
