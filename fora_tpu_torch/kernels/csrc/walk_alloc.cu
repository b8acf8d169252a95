// K6: the raw walk's lane allocation and endpoint accumulation, in three
// kernels.
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
// 1. walk_demand: per column b of r [n, Bc] (rows of stride ld, columns
//    contiguous: a column slice of a [n, B] residue)
//      omega_v = r_v > 0 ? ceil(r_v * omega_unit) : 0    (f32 product, no FMA)
//      cum[b, v] = sum_{u <= v} omega_u (int32),  total[b] = cum[b, n - 1]
//    Bound: bytes, r read once and cum written once (at [524288, 64] 268 MB,
//    0.08 ms at 3.35 TB/s).  r's columns are contiguous and the scan runs
//    along nodes, so a block reads a tile of 256 nodes x up to 32 columns
//    with coalesced loads (the lanes of a warp on neighbouring columns, or on
//    neighbouring nodes where fewer than 32 columns live), transposes it
//    through shared memory, and a warp scans one column 32 nodes at a time
//    (shuffles) and writes cum per column, 128 bytes a warp store.  The form
//    is reduce-then-scan: tile sums, one block a column scans them (a block
//    scan of shuffles), then the tiles are read again and scanned with their
//    offsets.  So r is read twice; a single pass with look-back is later work.
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

constexpr int kThreads = 256;           // every kernel's block but the scan's
constexpr int kWarps = kThreads / 32;
constexpr int kTileN = 256;             // nodes of a demand tile
constexpr int kScanThreads = 1024;      // the tile sums' scan: one block a column
constexpr int kExpandTile = 2048;       // lane slots of an expansion tile
constexpr int kSegs = kExpandTile / kThreads;   // searches a thread runs at once
constexpr int kAccUnroll = 4;           // lanes a thread loads before its adds
constexpr int kMaxShards = 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int omega_of(float r, float unit) {
  return r > 0.0f ? (int)ceilf(__fmul_rn(r, unit)) : 0;
}

__device__ __forceinline__ int warp_inclusive(int x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// Per (node tile, column group): each column's sum of omega over the tile.
// Thread k holds column k % cw and nodes k / cw + j * (256 / cw).
__global__ void __launch_bounds__(kThreads) demand_tile_kernel(
    const float* __restrict__ r, long long ld, long long n, int Bc, int cw_log2, float unit,
    int* __restrict__ tile_sum, long long n_tiles) {
  __shared__ int s_part[kWarps][32];
  const int cw = 1 << cw_log2;
  const int c = threadIdx.x & (cw - 1);
  const int step = kThreads >> cw_log2;
  const int b = blockIdx.y * cw + c;
  const long long v0 = (long long)blockIdx.x * kTileN;
  int s = 0;
  if (b < Bc) {
#pragma unroll 8
    for (int j = threadIdx.x >> cw_log2; j < kTileN; j += step) {
      const long long v = v0 + j;
      if (v < n) s += omega_of(r[v * ld + b], unit);
    }
  }
  // the lanes of one column differ in the bits from cw up
  for (int off = 16; off >= cw; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  const int lane = threadIdx.x & 31;
  if (lane < cw) s_part[threadIdx.x >> 5][lane] = s;
  __syncthreads();
  if (threadIdx.x < cw && b < Bc) {
    int t = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += s_part[w][threadIdx.x];
    tile_sum[(long long)b * n_tiles + blockIdx.x] = t;
  }
}

// One block a column: the tile sums become the tiles' exclusive offsets, in
// place, and total[b] their sum.
__global__ void __launch_bounds__(kScanThreads) demand_scan_kernel(int* __restrict__ tile_sum,
                                                                  long long n_tiles,
                                                                  int* __restrict__ total) {
  __shared__ int s_warp[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* row = tile_sum + (long long)blockIdx.x * n_tiles;
  int carry = 0;
  for (long long base = 0; base < n_tiles; base += kScanThreads) {
    const long long t = base + threadIdx.x;
    const int x = t < n_tiles ? row[t] : 0;
    const int incl = warp_inclusive(x, lane);
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) s_warp[lane] = warp_inclusive(s_warp[lane], lane);
    __syncthreads();
    if (t < n_tiles) row[t] = carry + (warp > 0 ? s_warp[warp - 1] : 0) + incl - x;
    carry += s_warp[31];
    __syncthreads();
  }
  if (threadIdx.x == 0) total[blockIdx.x] = carry;
}

// The tile again: omega into shared memory as [column][node], then warp w
// scans columns w, w + 8, ... 32 nodes at a time from the tile's offset.
__global__ void __launch_bounds__(kThreads) demand_cum_kernel(
    const float* __restrict__ r, long long ld, long long n, int Bc, int cw_log2, float unit,
    const int* __restrict__ tile_off, long long n_tiles, int* __restrict__ cum) {
  __shared__ int s[32][kTileN + 1];
  const int cw = 1 << cw_log2;
  const int c = threadIdx.x & (cw - 1);
  const int step = kThreads >> cw_log2;
  const int b = blockIdx.y * cw + c;
  const long long v0 = (long long)blockIdx.x * kTileN;
#pragma unroll 8
  for (int j = threadIdx.x >> cw_log2; j < kTileN; j += step) {
    const long long v = v0 + j;
    s[c][j] = (b < Bc && v < n) ? omega_of(r[v * ld + b], unit) : 0;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int cc = threadIdx.x >> 5; cc < cw; cc += kWarps) {
    const int bb = blockIdx.y * cw + cc;
    if (bb >= Bc) break;
    int carry = tile_off[(long long)bb * n_tiles + blockIdx.x];
    int* out = cum + (long long)bb * n;
#pragma unroll
    for (int seg = 0; seg < kTileN; seg += 32) {
      const int incl = warp_inclusive(s[cc][seg + lane], lane);
      const long long v = v0 + seg + lane;
      if (v < n) out[v] = carry + incl;
      carry += __shfl_sync(kFull, incl, 31);
    }
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

// cum [Bc, n] and total [Bc]; tile [Bc, n_tiles] scratch, n_tiles = ceil(n /
// 256).  Three launches on ``stream``.
extern "C" int fora_walk_demand(const float* r, long long ld, long long n, int Bc, float unit,
                                int* tile, long long n_tiles, int* cum, int* total,
                                void* stream) {
  if (n < 0 || Bc < 0 || n_tiles != (n + kTileN - 1) / kTileN)
    return (int)cudaErrorInvalidValue;
  if (n == 0 || Bc == 0) return (int)cudaGetLastError();
  const int cw_log2 = columns_log2(Bc);
  const long long col_groups = (Bc + (1 << cw_log2) - 1) >> cw_log2;
  if (n_tiles > 0x7fffffffLL || col_groups > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)n_tiles, (unsigned)col_groups);
  demand_tile_kernel<<<grid, kThreads, 0, st>>>(r, ld, n, Bc, cw_log2, unit, tile, n_tiles);
  demand_scan_kernel<<<Bc, kScanThreads, 0, st>>>(tile, n_tiles, total);
  demand_cum_kernel<<<grid, kThreads, 0, st>>>(r, ld, n, Bc, cw_log2, unit, tile, n_tiles, cum);
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
