// The earlier forms of K7-keys, K7-sort and K7-merge (kernels/csrc/pack.cu
// before their redesigns), kept only so that chip_smoke.py's phase 8 and
// the card's tests (-k pack) can time them and hold the package's kernels
// to them on the same inputs.  No entry point of the package loads it: the
// probe (probes/pack_earlier.py) compiles it alone.
//
// K7-keys, earlier form: a warp a node (grid-stride), its lanes over the
// node's K_v = cut[v, 0] entries, each entry's bucket from the host's
// cutoff table cut [n, 8] (ceil(K_v 4^-q)); threads t < nd write the
// dangling nodes' self-edge keys.  At bench scale the 239 k dangling
// nodes' warps read a cut row and stop, and one warp walks the largest
// node's 1.3e5 entries alone.
// K7-sort, earlier form: a stable LSD radix sort over key_bits bits,
// 8-bit digits.  One launch counts every pass's digits over all keys
// (six __match_any_sync a key at 42-bit keys); its totals go to the host,
// and a pass whose digit is the same in every key is skipped.  Each pass
// run is three launches: a tile histogram (4096 keys a tile), one block a
// digit scanning its row of the digit-major, tile-minor counts, and a
// stable scatter (equal digits in a warp's 32 keys grouped by
// __match_any_sync, the warps' counts scanned in warp order) that stores
// a warp's keys straight into up to 32 digit runs.
// K7-merge, earlier form: run heads (key[i] != key[i - 1]) counted per
// tile, their scan (the host then reads U), the unique keys unpacked into
// edge_src / edge_dst at their rank with each run's start written into a
// scratch, the bucket sizes by atomics, then each run's length from the
// starts as the float32 multiplicity: four launches, the keys read twice.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kBuckets = 8;              // NUM_BUCKETS of index/build.py
constexpr int kDigitBits = 8;
constexpr int kRadix = 1 << kDigitBits;
constexpr int kMaxPasses = 8;            // keys of at most 64 bits
constexpr int kTileWarps = 8;
constexpr int kTileThreads = 32 * kTileWarps;
constexpr int kKeysPerLane = 16;
constexpr int kWarpKeys = 32 * kKeysPerLane;          // 512
constexpr int kTile = kTileWarps * kWarpKeys;         // 4096
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

// ---- K7-keys --------------------------------------------------------------

__global__ void pack_keys_earlier_kernel(const int* __restrict__ ends,
                                         const long long* __restrict__ offsets,
                                         const long long* __restrict__ cut, long long n,
                                         const long long* __restrict__ dang, long long nd,
                                         long long total, int nb, u64* __restrict__ keys) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long threads = (long long)gridDim.x * blockDim.x;
  for (long long d = t; d < nd; d += threads) {
    const u64 v = (u64)dang[d];
    keys[total + d] = ((u64)(kBuckets - 1) << (2 * nb)) | (v << nb) | v;
  }
  const int lane = threadIdx.x & 31;
  const long long warps = threads >> 5;
  for (long long v = t >> 5; v < n; v += warps) {
    const long long* cv = cut + v * kBuckets;
    const long long K = cv[0];
    if (K == 0) continue;
    long long c[kBuckets];
#pragma unroll
    for (int q = 1; q < kBuckets; ++q) c[q] = cv[q];
    const long long off = offsets[v];
    for (long long j = lane; j < K; j += 32) {
      int b = 0;
#pragma unroll
      for (int q = 1; q < kBuckets; ++q) b += j < c[q];   // cutoffs shrink with q
      keys[off + j] = ((u64)b << (2 * nb)) | ((u64)(unsigned)ends[off + j] << nb) | (u64)v;
    }
  }
}

// ---- K7-sort --------------------------------------------------------------

// every pass's digit counts over all keys: totals[p * 256 + d]
__global__ void radix_totals_kernel(const u64* __restrict__ keys, long long len, int passes,
                                    unsigned* __restrict__ totals) {
  __shared__ unsigned sh[kMaxPasses * kRadix];
  for (int i = threadIdx.x; i < passes * kRadix; i += blockDim.x) sh[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // b is the same in every lane of a warp, so whole warps take each step
  for (long long b = (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31); b < len;
       b += stride) {
    const long long i = b + lane;
    const bool valid = i < len;
    const u64 k = valid ? keys[i] : 0;
    for (int p = 0; p < passes; ++p) {
      const unsigned d = valid ? (unsigned)(k >> (p * kDigitBits)) & (kRadix - 1) : kRadix + lane;
      const unsigned peers = __match_any_sync(kFull, d);
      if (valid && lane == __ffs(peers) - 1) atomicAdd(&sh[p * kRadix + d], __popc(peers));
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < passes * kRadix; i += blockDim.x)
    if (sh[i]) atomicAdd(&totals[i], sh[i]);
}

// tile t's count of each digit: hist[d * T + t] (digit-major, tile-minor)
__global__ void __launch_bounds__(kTileThreads)
    radix_hist_kernel(const u64* __restrict__ keys, long long len, int shift, long long T,
                      unsigned* __restrict__ hist) {
  __shared__ unsigned sh[kRadix];
  sh[threadIdx.x] = 0;
  __syncthreads();
  const long long tile = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long wlo = tile * kTile + (long long)warp * kWarpKeys;
#pragma unroll 4
  for (int it = 0; it < kKeysPerLane; ++it) {
    const long long i = wlo + it * 32 + lane;
    const bool valid = i < len;
    const unsigned d = valid ? (unsigned)(keys[i] >> shift) & (kRadix - 1) : kRadix + lane;
    const unsigned peers = __match_any_sync(kFull, d);
    if (valid && lane == __ffs(peers) - 1) atomicAdd(&sh[d], __popc(peers));
  }
  __syncthreads();
  hist[(long long)threadIdx.x * T + tile] = sh[threadIdx.x];
}

// Block r: row r of ``rows`` ([R, T]) replaced by its exclusive prefix sums
// plus base_r = the sum of counts[0 .. r) (0 without counts); ends[r] (if
// given) gets base_r + the row's sum.  The sort's scan (a row a digit) and
// the merge's (one row of tile head counts), each a kernel of its own name.
__device__ __forceinline__ void scan_rows(unsigned* __restrict__ rows, long long T,
                                          const unsigned* __restrict__ counts,
                                          unsigned* __restrict__ ends) {
  __shared__ unsigned warp_sums[32];
  __shared__ unsigned carry;
  const int r = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  if (threadIdx.x == 0) {
    unsigned base = 0;
    if (counts != nullptr)
      for (int e = 0; e < r; ++e) base += counts[e];
    carry = base;
  }
  __syncthreads();
  unsigned* row = rows + (long long)r * T;
  for (long long c = 0; c < T; c += blockDim.x) {
    const long long i = c + threadIdx.x;
    const unsigned v = i < T ? row[i] : 0;
    unsigned x = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      unsigned s = lane < nwarps ? warp_sums[lane] : 0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned y = __shfl_up_sync(kFull, s, off);
        if (lane >= off) s += y;
      }
      if (lane < nwarps) warp_sums[lane] = s;
    }
    __syncthreads();
    const unsigned before = carry + (warp > 0 ? warp_sums[warp - 1] : 0);
    if (i < T) row[i] = before + x - v;
    const unsigned chunk = warp_sums[nwarps - 1];
    __syncthreads();
    if (threadIdx.x == 0) carry += chunk;
    __syncthreads();
  }
  if (ends != nullptr && threadIdx.x == 0) ends[r] = carry;
}

__global__ void __launch_bounds__(kScanThreads)
    radix_scan_kernel(unsigned* __restrict__ hist, long long T,
                      const unsigned* __restrict__ totals) {
  scan_rows(hist, T, totals, nullptr);
}

__global__ void __launch_bounds__(kScanThreads)
    merge_scan_kernel(unsigned* __restrict__ heads, long long T) {
  scan_rows(heads, T, nullptr, heads + T);
}

// the stable scatter of tile t: each key to offsets[d * T + t] + the keys of
// digit d in the tile's earlier warps + its rank among the warp's earlier
// keys of digit d
__global__ void __launch_bounds__(kTileThreads)
    radix_scatter_kernel(const u64* __restrict__ in, u64* __restrict__ out, long long len,
                         int shift, long long T, const unsigned* __restrict__ offsets) {
  __shared__ unsigned wcnt[kTileWarps][kRadix];
  for (int i = threadIdx.x; i < kTileWarps * kRadix; i += blockDim.x) (&wcnt[0][0])[i] = 0;
  __syncthreads();
  const long long tile = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1;
  const long long wlo = tile * kTile + (long long)warp * kWarpKeys;
  u64 key[kKeysPerLane];
  unsigned pos[kKeysPerLane];
#pragma unroll
  for (int it = 0; it < kKeysPerLane; ++it) {
    const long long i = wlo + it * 32 + lane;
    const bool valid = i < len;
    const u64 k = valid ? in[i] : 0;
    const unsigned d = valid ? (unsigned)(k >> shift) & (kRadix - 1) : kRadix + lane;
    const unsigned peers = __match_any_sync(kFull, d);
    const unsigned seen = valid ? wcnt[warp][d] : 0;
    __syncwarp();
    if (valid && lane == __ffs(peers) - 1) wcnt[warp][d] = seen + __popc(peers);
    __syncwarp();
    key[it] = k;
    pos[it] = seen + __popc(peers & lower);
  }
  __syncthreads();
  {
    const int d = threadIdx.x;    // a thread a digit: blockDim.x == kRadix
    unsigned run = offsets[(long long)d * T + tile];
#pragma unroll
    for (int w = 0; w < kTileWarps; ++w) {
      const unsigned c = wcnt[w][d];
      wcnt[w][d] = run;
      run += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int it = 0; it < kKeysPerLane; ++it) {
    const long long i = wlo + it * 32 + lane;
    if (i < len) {
      const unsigned d = (unsigned)(key[it] >> shift) & (kRadix - 1);
      out[wcnt[warp][d] + pos[it]] = key[it];
    }
  }
}

// ---- K7-merge -------------------------------------------------------------

__device__ __forceinline__ bool run_head(const u64* __restrict__ keys, long long i, long long len) {
  return i < len && (i == 0 || keys[i] != keys[i - 1]);
}

// tile t's count of run heads
__global__ void __launch_bounds__(kTileThreads)
    merge_count_kernel(const u64* __restrict__ keys, long long len, unsigned* __restrict__ heads) {
  __shared__ unsigned wsum[kTileWarps];
  const long long tile = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long wlo = tile * kTile + (long long)warp * kWarpKeys;
  unsigned cnt = 0;
#pragma unroll 4
  for (int it = 0; it < kKeysPerLane; ++it)
    cnt += __popc(__ballot_sync(kFull, run_head(keys, wlo + it * 32 + lane, len)));
  if (lane == 0) wsum[warp] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned s = 0;
    for (int w = 0; w < kTileWarps; ++w) s += wsum[w];
    heads[tile] = s;
  }
}

// each run head i, of rank u among the heads: edge_src[u], edge_dst[u] its
// key unpacked, run_start[u] = i, its bucket counted
__global__ void __launch_bounds__(kTileThreads)
    merge_write_kernel(const u64* __restrict__ keys, long long len, int nb,
                       const unsigned* __restrict__ tile_base, int* __restrict__ src,
                       int* __restrict__ dst, int* __restrict__ run_start,
                       u64* __restrict__ bucket_counts) {
  __shared__ unsigned wsum[kTileWarps];
  __shared__ u64 bsh[kBuckets];
  if (threadIdx.x < kBuckets) bsh[threadIdx.x] = 0;
  const long long tile = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1;
  const long long wlo = tile * kTile + (long long)warp * kWarpKeys;
  unsigned cnt = 0;
#pragma unroll 4
  for (int it = 0; it < kKeysPerLane; ++it)
    cnt += __popc(__ballot_sync(kFull, run_head(keys, wlo + it * 32 + lane, len)));
  if (lane == 0) wsum[warp] = cnt;
  __syncthreads();
  unsigned u0 = tile_base[tile];
  for (int w = 0; w < warp; ++w) u0 += wsum[w];
  const u64 mask = (1ull << nb) - 1;
  unsigned bc[kBuckets];
#pragma unroll
  for (int q = 0; q < kBuckets; ++q) bc[q] = 0;
  for (int it = 0; it < kKeysPerLane; ++it) {
    const long long i = wlo + it * 32 + lane;
    const bool head = run_head(keys, i, len);
    const unsigned ballot = __ballot_sync(kFull, head);
    if (head) {
      const unsigned u = u0 + __popc(ballot & lower);
      const u64 k = keys[i];
      src[u] = (int)(k & mask);
      dst[u] = (int)((k >> nb) & mask);
      run_start[u] = (int)i;
      const unsigned b = (unsigned)(k >> (2 * nb));
#pragma unroll
      for (int q = 0; q < kBuckets; ++q) bc[q] += b == (unsigned)q;
    }
    u0 += __popc(ballot);
  }
#pragma unroll
  for (int q = 0; q < kBuckets; ++q) {
    const unsigned s = __reduce_add_sync(kFull, bc[q]);
    if (lane == 0 && s) atomicAdd(&bsh[q], (u64)s);
  }
  __syncthreads();
  if (threadIdx.x < kBuckets && bsh[threadIdx.x])
    atomicAdd(&bucket_counts[threadIdx.x], bsh[threadIdx.x]);
}

// each run's length as its float32 multiplicity
__global__ void merge_mult_kernel(const int* __restrict__ run_start, long long U, long long len,
                                  float* __restrict__ mult) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x; u < U; u += stride) {
    const long long end = u + 1 < U ? (long long)run_start[u + 1] : len;
    mult[u] = __ll2float_rn(end - run_start[u]);
  }
}

long long tiles(long long len) { return (len + kTile - 1) / kTile; }

unsigned grid_for(long long threads, long long cap) {
  long long b = (threads + 255) / 256;
  if (b > cap) b = cap;
  return (unsigned)(b > 0 ? b : 1);
}

}  // namespace

// K7-keys: keys [total + nd] u64 from ends [total] int32, offsets [n] and
// cut [n, 8] int64 (cut[v, 0] = K_v), dang [nd] int64
extern "C" int fora_pack_keys_earlier(const int* ends, const long long* offsets,
                                      const long long* cut, long long n, const long long* dang,
                                      long long nd, long long total, int nb, u64* keys,
                                      void* stream) {
  if (n < 0 || nd < 0 || total < 0 || nb < 1 || 2 * nb + 4 > 63) return (int)cudaErrorInvalidValue;
  if (total + nd == 0) return (int)cudaGetLastError();
  long long threads = n * 32 > nd ? n * 32 : nd;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  pack_keys_earlier_kernel<<<grid_for(threads, 1LL << 16), 256, 0, st>>>(
      ends, offsets, cut, n, dang, nd, total, nb, keys);
  return (int)cudaGetLastError();
}

// K7-sort: keys [len] sorted ascending over their low key_bits bits, in
// ``keys`` or ``alt`` (the same size): *passes_done scatters ran, an odd
// count leaves the result in ``alt``.  ``scratch`` holds 8 * 256 + 256 *
// ceil(len / 4096) u32 words (the totals, then the tile histograms).
// Synchronises the stream once, to read the digit totals.
extern "C" int fora_sort_keys_earlier(u64* keys, u64* alt, long long len, int key_bits, unsigned* scratch,
                              long long scratch_words, int* passes_done, void* stream) {
  if (len < 0 || key_bits < 1 || key_bits > 64 || passes_done == nullptr ||
      len >= (1LL << 32) ||
      scratch_words < (long long)kMaxPasses * kRadix + (long long)kRadix * tiles(len))
    return (int)cudaErrorInvalidValue;
  *passes_done = 0;
  if (len <= 1) return (int)cudaGetLastError();
  const int passes = (key_bits + kDigitBits - 1) / kDigitBits;
  const long long T = tiles(len);
  if (T > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  unsigned* totals = scratch;
  unsigned* hist = scratch + kMaxPasses * kRadix;
  cudaError_t err = cudaMemsetAsync(totals, 0, sizeof(unsigned) * passes * kRadix, st);
  if (err != cudaSuccess) return (int)err;
  radix_totals_kernel<<<grid_for(len, 132LL * 8), 256, 0, st>>>(keys, len, passes, totals);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  unsigned host[kMaxPasses * kRadix];
  err = cudaMemcpyAsync(host, totals, sizeof(unsigned) * passes * kRadix,
                        cudaMemcpyDeviceToHost, st);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaStreamSynchronize(st)) != cudaSuccess) return (int)err;
  u64* cur = keys;
  u64* nxt = alt;
  for (int p = 0; p < passes; ++p) {
    bool constant = false;   // every key shares this pass's digit
    for (int d = 0; d < kRadix && !constant; ++d) constant = host[p * kRadix + d] == (unsigned)len;
    if (constant) continue;
    const int shift = p * kDigitBits;
    radix_hist_kernel<<<(unsigned)T, kTileThreads, 0, st>>>(cur, len, shift, T, hist);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    radix_scan_kernel<<<kRadix, kScanThreads, 0, st>>>(hist, T, totals + p * kRadix);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    radix_scatter_kernel<<<(unsigned)T, kTileThreads, 0, st>>>(cur, nxt, len, shift, T, hist);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    u64* tmp = cur;
    cur = nxt;
    nxt = tmp;
    ++*passes_done;
  }
  return (int)cudaGetLastError();
}

// K7-merge, first half: heads [ceil(len / 4096) + 1] u32, heads[t] the
// unique keys before tile t, heads[T] their number U
extern "C" int fora_merge_count_earlier(const u64* keys, long long len, unsigned* heads, void* stream) {
  if (len < 0 || len >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const long long T = tiles(len);
  if (T == 0) return (int)cudaMemsetAsync(heads, 0, sizeof(unsigned), st);
  merge_count_kernel<<<(unsigned)T, kTileThreads, 0, st>>>(keys, len, heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_scan_kernel<<<1, kScanThreads, 0, st>>>(heads, T);
  return (int)cudaGetLastError();
}

// K7-merge, second half: the U unique keys unpacked into src / dst [U]
// int32, each run's start into run_start [U] int32 (scratch), its length
// into mult [U] f32, and bucket_counts [8] u64 the bucket sizes
extern "C" int fora_merge_write_earlier(const u64* keys, long long len, int nb, const unsigned* heads,
                                long long U, int* src, int* dst, int* run_start, float* mult,
                                u64* bucket_counts, void* stream) {
  if (len < 0 || U < 0 || U > len || nb < 1 || 2 * nb + 4 > 63) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(bucket_counts, 0, sizeof(u64) * kBuckets, st);
  if (err != cudaSuccess || U == 0) return (int)err;
  const long long T = tiles(len);
  merge_write_kernel<<<(unsigned)T, kTileThreads, 0, st>>>(keys, len, nb, heads, src, dst,
                                                           run_start, bucket_counts);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  merge_mult_kernel<<<grid_for(U, 132LL * 16), 256, 0, st>>>(run_start, U, len, mult);
  return (int)cudaGetLastError();
}
