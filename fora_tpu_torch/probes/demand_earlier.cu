// The earlier form of K6-demand, kept only so that
// fora_tpu_torch/probes/demand_probe.py (and chip_smoke.py's K6-demand
// rows) can time it beside kernels/csrc/walk_alloc.cu's single pass on the
// same residue.  No entry point of the package loads it: the probe
// compiles it alone.
//
// walk_demand: per column b of r [n, Bc] (rows of stride ld, columns
// contiguous: a column slice of a [n, B] residue)
//   omega_v = r_v > 0 ? ceil(r_v * omega_unit) : 0    (f32 product, no FMA)
//   cum[b, v] = sum_{u <= v} omega_u (int32),  total[b] = cum[b, n - 1]
// A block reads a tile of 256 nodes x up to 32 columns with coalesced
// loads (the lanes of a warp on neighbouring columns, or on neighbouring
// nodes where fewer than 32 columns live), transposes it through shared
// memory, and a warp scans one column 32 nodes at a time (shuffles) and
// writes cum per column, 128 bytes a warp store.  The form is
// reduce-then-scan in three launches: tile sums, one block a column scans
// them (a block scan of shuffles), then the tiles are read again and
// scanned with their offsets.  So r is read twice.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileN = 256;             // nodes of a demand tile
constexpr int kScanThreads = 1024;      // the tile sums' scan: one block a column
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

int columns_log2(int Bc) {
  int k = 0;
  while (k < 5 && (1 << k) < Bc) ++k;
  return k;
}

}  // namespace

// cum [Bc, n] and total [Bc]; tile [Bc, n_tiles] scratch, n_tiles = ceil(n /
// 256).  Three launches on ``stream``.
extern "C" int fora_walk_demand_earlier(const float* r, long long ld, long long n, int Bc,
                                        float unit, int* tile, long long n_tiles, int* cum,
                                        int* total, void* stream) {
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
