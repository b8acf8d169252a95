// Other forms of K6-demand's single pass, for
// fora_tpu_torch/probes/demand_probe.py: the package's kernel
// (kernels/csrc/walk_alloc.cu) as it was tried, with its tile size (2048
// to 16384 entries), its widest column group, its pipeline depth and its
// clearing as knobs.  Here the status words carry an epoch and the ticket
// counter is never reset: the caller keeps one scratch, zeroes it once,
// and passes each launch a new epoch and the tickets handed out before
// (the package instead clears the words it reads with a cudaMemsetAsync
// before each launch, and keeps no scratch between calls).  Two parts
// time pieces of the kernel and give wrong sums: kMode 1 skips the
// look-back (every tile's prefix 0), kMode 2 the scans too (cum gets
// omega).  No entry point of the package loads this file: the probe
// compiles it alone.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxShards = 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int omega_of(float r, float unit) {
  return r > 0.0f ? (int)ceilf(__fmul_rn(r, unit)) : 0;
}

// A demand status word: epoch << 34 | flag << 32 | value.
constexpr unsigned long long kAggregate = 1ull << 32, kPrefix = 2ull << 32;

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(w) : "l"(p) : "memory");
  return w;
}

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned epoch,
                                             unsigned long long flag, int value) {
  const unsigned long long w = ((unsigned long long)epoch << 34) | flag | (unsigned)value;
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
                              unsigned epoch, LookBack& lb) {
  constexpr int kR = 4, R = kR;
  const int cw = 1 << cw_log2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = threadIdx.x & (cw - 1), q = threadIdx.x >> cw_log2;
  const bool was_done = lb.done[c] != 0;
  unsigned long long w[kR];
#pragma unroll
  for (int m = 0; m < kR; ++m)
    if (m < R && !was_done && top - q * R - m >= 0)
      w[m] = load_status(st + (top - q * R - m) * cw + c);
  unsigned flag[kR];
  int val[kR], near = 0x7fffffff;
#pragma unroll
  for (int m = 0; m < kR; ++m) {
    flag[m] = 2;
    val[m] = 0;
    if (m < R && !was_done && top - q * R - m >= 0) {
      const unsigned hi = (unsigned)(w[m] >> 32);
      flag[m] = (hi >> 2) == epoch ? (hi & 3u) : 0u;
      val[m] = (int)(unsigned)w[m];
    }
    if (flag[m] == 0 && near == 0x7fffffff) near = q * R + m;
  }
  near = __reduce_min_sync(kFull, near);
  if (lane == 0) lb.wmin[warp] = near;
  __syncthreads();
  int a = (kThreads >> cw_log2) * R;
#pragma unroll
  for (int v = 0; v < kWarps; ++v) a = min(a, lb.wmin[v]);
  int sum = 0;
  bool prefix = was_done;
#pragma unroll
  for (int m = 0; m < kR; ++m) {
    if (m >= R || prefix || q * R + m >= a) continue;
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

// One tile of kE * 256 entries: TN = kE * 256 / cw nodes of a chain's cw
// columns, copied by cp.async into ``buf`` as [column][node] (runs of kE
// nodes padded by a word), entries past n or Bc zero.  Thread (c, q) =
// (thread % cw, thread / cw) copies column c of nodes q + j * 256 / cw (j
// < kE): a warp's copy covers cw neighbouring columns of 32 / cw
// neighbouring nodes.  No register holds the data in flight.
template <int kE>
__device__ __forceinline__ void copy_tile(const DemandTable& tab, long long ld, long long n,
                                          int Bc, int cw_log2, int col_groups,
                                          long long chains, long long k, int pitch,
                                          float* buf) {
  constexpr int RP = kE + 1;
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

// Persistent blocks over tickets.  A block holds kStages tickets: the tile
// it scans, looks back and writes, and the next kStages - 1, whose copies
// into the other buffers (one a stage) are in flight meanwhile; a ticket's
// atomic is issued at the start of a tile and its value needed only after
// the tile's scan.  The tiles ahead have published nothing while the block
// finishes the first, whose predecessors have all published their sums (a
// tile publishes its sum before it waits), so no tile waits on one that
// cannot go on.  In a tile, thread (c, q) scans its run q of column c
// serially (omega from the copied r), the block scans the runs' sums per
// column (shuffles over the lanes of a column, then the warps' totals),
// the run's inclusive sums go back in place, and after the look-back they
// become cum, 128 bytes a warp store.  The padding word of a run keeps
// both the copy's and the scan's accesses free of bank conflicts.  kMode
// 0: the demand.  The others time parts of it (wrong sums): 1 skips the
// look-back (each tile's prefix 0), 2 also the scans (cum gets omega).
template <int kMode, int kE, int kStages>
__global__ void __launch_bounds__(kThreads) demand_kernel(
    const DemandTable tab, long long ld, long long n, int Bc, int cw_log2, int col_groups,
    long long chains, long long n_tiles, float unit, unsigned long long* __restrict__ ticket,
    unsigned long long ticket_base, unsigned long long* __restrict__ status, unsigned epoch,
    int* __restrict__ cum, int* __restrict__ total) {
  static_assert(kStages == 2 || kStages == 3, "one or two tiles ahead");
  extern __shared__ float s_buf[];     // kStages x [cw][TN / kE runs of kE + 1] + 32 / cw
  __shared__ int s_wt[kWarps][32];     // a warp's sum of its runs, per column
  __shared__ LookBack lb;
  __shared__ unsigned long long s_k[4];    // tickets, a slot a tile in turn
  constexpr int RP = kE + 1;
  const int cw = 1 << cw_log2;
  const int tile_log2 = __ffs(kE * kThreads) - 1 - cw_log2;
  const int pitch = (kThreads >> cw_log2) * RP + (32 >> cw_log2);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = threadIdx.x & (cw - 1), q = threadIdx.x >> cw_log2;
  const unsigned long long tiles = (unsigned long long)(chains * n_tiles);
  if (threadIdx.x == 0)
    for (int i = 0; i < kStages - 1; ++i) s_k[i] = atomicAdd(ticket, 1ull) - ticket_base;
  __syncthreads();
  // k[0] the tile to scan, k[1 ..] the tiles ahead, their copies in flight
  unsigned long long k[kStages - 1];
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    k[i] = s_k[i];
    if (k[i] < tiles)
      copy_tile<kE>(tab, ld, n, Bc, cw_log2, col_groups, chains, (long long)k[i], pitch,
                    s_buf + i * cw * pitch);
    else
      asm volatile("cp.async.commit_group;" ::: "memory");
  }
  for (int it = 0;; ++it) {
    if (k[0] >= tiles) return;
    const int slot = it % kStages;
    float* buf = s_buf + slot * cw * pitch;
    int* tile = reinterpret_cast<int*>(buf);
    const long long t = (long long)(k[0] / (unsigned long long)chains);
    const long long chain = (long long)(k[0] % (unsigned long long)chains);
    const int g = (int)(chain / col_groups);
    const int col0 = (int)(chain % col_groups) << cw_log2;
    const long long v0 = t << tile_log2;
    unsigned long long taken = 0;
    if (threadIdx.x == 0) taken = atomicAdd(ticket, 1ull);
    // every copy but the newest kStages - 2 done: this tile's
    if (kStages == 3)
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    else
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
    if (kMode == 2) off = 0;
#pragma unroll 8
    for (int j = 0; j < kE; ++j) {
      const int om = omega_of(run[j], unit);
      off += kMode < 2 ? om : 0;
      irun[j] = kMode < 2 ? off : om;
    }
    int agg = 0;
    if (threadIdx.x < cw) {
#pragma unroll
      for (int v = 0; v < kWarps; ++v) agg += s_wt[v][threadIdx.x];
    }
    unsigned long long* st = status + chain * n_tiles * cw;
    if (threadIdx.x == 0) s_k[it & 3] = taken - ticket_base;
    if (threadIdx.x < cw) {
      if (kMode == 0)
        store_status(st + t * cw + threadIdx.x, epoch, t == 0 ? kPrefix : kAggregate, agg);
      lb.excl[threadIdx.x] = 0;
      lb.done[threadIdx.x] = t == 0;
    }
    __syncthreads();
    const unsigned long long kf = s_k[it & 3];
    if (kf < tiles)
      copy_tile<kE>(tab, ld, n, Bc, cw_log2, col_groups, chains, (long long)kf, pitch,
                    s_buf + ((it + kStages - 1) % kStages) * cw * pitch);
    else
      asm volatile("cp.async.commit_group;" ::: "memory");
    if (kMode == 0 && t > 0) {
      for (long long top = t - 1;;) {
        const int moved = look_back_step(st, top, cw_log2, epoch, lb);
        if (moved < 0) break;
        if (moved == 0) __nanosleep(64);
        top -= moved;
      }
      if (threadIdx.x < cw)
        store_status(st + t * cw + threadIdx.x, epoch, kPrefix, lb.excl[threadIdx.x] + agg);
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
#pragma unroll
    for (int i = 0; i < kStages - 2; ++i) k[i] = k[i + 1];
    k[kStages - 2] = kf;
  }
}

// The package's tile, 32 entries a thread (8192 a tile), and pipeline:
// two tiles in shared memory, one scanned and one on its way.
constexpr int kDemandEntries = 32;
constexpr int kDemandStages = 2;

size_t demand_smem(int kE, int cw_log2, int stages) {
  return (size_t)stages * ((size_t)(kThreads >> cw_log2) * (kE + 1) + (32 >> cw_log2)) *
         (1 << cw_log2) * sizeof(int);
}

template <int kMode, int kE, int kStages>
int launch_demand_e(const DemandTable& tab, long long ld, long long n, int Bc, int cw_log2,
                    int col_groups, long long chains, long long n_tiles, float unit,
                    unsigned long long* scratch, unsigned long long ticket_base,
                    unsigned epoch, int* cum, int* total, int sms, long long* tickets,
                    cudaStream_t st) {
  // the shared-memory limit and the blocks an SM holds, set and asked once
  // a card and column width (host calls that cost more than the launch)
  constexpr int kCards = 64;
  static int resident[kCards][6] = {};
  const size_t smem = demand_smem(kE, cw_log2, kStages);
  int card = 0;
  cudaError_t e = cudaGetDevice(&card);
  int per_sm = card < kCards ? resident[card][cw_log2] : 0;
  if (e == cudaSuccess && per_sm == 0) {
    if (smem > 48 * 1024)
      e = cudaFuncSetAttribute(demand_kernel<kMode, kE, kStages>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, demand_kernel<kMode, kE, kStages>, kThreads, smem);
    if (e == cudaSuccess && card < kCards) resident[card][cw_log2] = per_sm;
  }
  if (e != cudaSuccess) return (int)e;
  const long long tiles = chains * n_tiles;
  long long grid = (long long)(sms > 0 ? sms : 132) * (per_sm > 0 ? per_sm : 1);
  if (grid > tiles) grid = tiles;
  demand_kernel<kMode, kE, kStages><<<(unsigned)grid, kThreads, smem, st>>>(
      tab, ld, n, Bc, cw_log2, col_groups, chains, n_tiles, unit, scratch, ticket_base,
      scratch + 1, epoch, cum, total);
  e = cudaGetLastError();
  // each block's last kStages - 1 takes fail
  if (e == cudaSuccess) *tickets = tiles + (kStages - 1) * grid;
  return (int)e;
}

// kE entries a thread (8 .. 64): tile_log2 + cw_log2 = log2(kE * 256).
template <int kMode, int kE = kDemandEntries, int kStages = kDemandStages>
int launch_demand(const float* const* r, int G, long long ld, long long n, int Bc, float unit,
                  int cw_log2, int tile_log2, unsigned long long* scratch,
                  long long scratch_words, unsigned long long ticket_base, unsigned epoch,
                  int* cum, int* total, int sms, long long* tickets, void* stream) {
  *tickets = 0;
  if (n < 0 || Bc < 0 || G < 1 || G > kMaxShards || epoch == 0 || epoch >= (1u << 30) ||
      cw_log2 < 0 || cw_log2 > 5 || (kE << 8) != 1 << (tile_log2 + cw_log2))
    return (int)cudaErrorInvalidValue;
  if (n == 0 || Bc == 0) return (int)cudaGetLastError();
  const int col_groups = (Bc + (1 << cw_log2) - 1) >> cw_log2;
  const long long n_tiles = (n + (1LL << tile_log2) - 1) >> tile_log2;
  const long long chains = (long long)G * col_groups;
  if (chains * n_tiles > 0x7fffffffLL || scratch_words < 1 + chains * n_tiles * (1 << cw_log2))
    return (int)cudaErrorInvalidValue;
  DemandTable tab = {};
  for (int h = 0; h < G; ++h) tab.r[h] = r[h];
  return launch_demand_e<kMode, kE, kStages>(tab, ld, n, Bc, cw_log2, col_groups, chains,
                                             n_tiles, unit, scratch, ticket_base, epoch, cum,
                                             total, sms, tickets,
                                             reinterpret_cast<cudaStream_t>(stream));
}

}  // namespace

// G shards' r[g] [n, Bc] (row stride ld); cum [G, Bc, n] and total [G, Bc]
// int32; column groups of 2^cw_log2 (0 .. 5) and tiles of 2^tile_log2
// nodes, 2^(tile_log2 + cw_log2) = 256 * the form's entries a thread.
// scratch: the ticket counter, then the status words, scratch_words in
// all (at least 1 + G * ceil(Bc / cw) * cw * ceil(n / 2^tile_log2)), its
// words from earlier launches of other epochs or zero; ticket_base the
// tickets handed out before; epoch 1 .. 2^30 - 1, not used before on this
// scratch since it was zeroed; sms the card's SMs.  One launch on
// ``stream``; *tickets gets the tickets it takes, 0 if nothing launched.
#define FORA_DEMAND_FORM(NAME, MODE, KE, STAGES)                                         \
  extern "C" int NAME(const float* const* r, int G, long long ld, long long n, int Bc,     \
                      float unit, int cw_log2, int tile_log2, unsigned long long* scratch, \
                      long long scratch_words, unsigned long long ticket_base,            \
                      unsigned epoch, int* cum, int* total, int sms, long long* tickets,  \
                      void* stream) {                                                     \
    return launch_demand<MODE, KE, STAGES>(r, G, ld, n, Bc, unit, cw_log2, tile_log2,     \
                                           scratch, scratch_words, ticket_base, epoch,    \
                                           cum, total, sms, tickets, stream);             \
  }
// the tried kernel at tiles of 2048 to 16384 entries (e32: the package's
// tile); the look-back skipped, and the scan too; the pipeline two tiles
// ahead, and that form's copy alone
FORA_DEMAND_FORM(fora_walk_demand_e8, 0, 8, kDemandStages)
FORA_DEMAND_FORM(fora_walk_demand_e16, 0, 16, kDemandStages)
FORA_DEMAND_FORM(fora_walk_demand_e32, 0, 32, kDemandStages)
FORA_DEMAND_FORM(fora_walk_demand_e64, 0, 64, kDemandStages)
FORA_DEMAND_FORM(fora_walk_demand_nolookback, 1, kDemandEntries, kDemandStages)
FORA_DEMAND_FORM(fora_walk_demand_copy, 2, kDemandEntries, kDemandStages)
FORA_DEMAND_FORM(fora_walk_demand_other, 0, kDemandEntries, 3)
FORA_DEMAND_FORM(fora_walk_demand_other_copy, 2, kDemandEntries, 3)
#undef FORA_DEMAND_FORM

// The demand kernel's resident blocks an SM at kE = 2^e_log2 entries a
// thread (3 .. 6) and 32 columns, by
// cudaOccupancyMaxActiveBlocksPerMultiprocessor.
template <int kE>
int occupancy(int* blocks) {
  const size_t smem = demand_smem(kE, 5, kDemandStages);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(demand_kernel<0, kE, kDemandStages>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, demand_kernel<0, kE, kDemandStages>, kThreads, smem);
}

extern "C" int fora_demand_occupancy(int e_log2, int* blocks) {
  switch (e_log2) {
    case 3: return occupancy<8>(blocks);
    case 4: return occupancy<16>(blocks);
    case 5: return occupancy<32>(blocks);
    case 6: return occupancy<64>(blocks);
  }
  return (int)cudaErrorInvalidValue;
}
