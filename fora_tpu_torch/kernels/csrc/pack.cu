// K7 · the FORA+ index pack on the card: the walk endpoints of an index
// build turned into the bucketed, endpoint-sorted, multiplicity-merged edge
// list and each bucket's row pointers by endpoint, without a trip of the
// endpoints through the host.
//
// Replaces fora_tpu/_native/radix_sort.cpp, host C++ threads that the JAX
// package's pack_index (fora_tpu/index/build.py:402-432) calls, and the
// count of each bucket's row pointers by endpoint that K2 walks (this
// package's index/build.py::with_indptr on the host; the JAX package's
// index SpMV segment-sums and needs none):
//   K7-keys  pack_keys_kernel      <- fora_pack_keys (:179, body pack_range :137)
//            every pool entry j of node v gets the packed key
//              bucket(j) << 2nb | endpoint << nb | v,
//              bucket(j) = #{q >= 1 : j < cut[v, q]}
//            (cut is the host's table of ceil(K_v 4^-q), read and not
//            recomputed, so float64 ceil cannot disagree), and the dangling
//            nodes' self-edges (7 << 2nb | d << nb | d) follow at total + i.
//   K7-sort  radix_histogram_kernel, onesweep_kernel
//                                  <- fora_sort_unique_u64's sort (:53-115)
//            a stable LSD radix sort over key_bits = 2nb + 4 bits, onesweep
//            (Adinets and Merrill, "Onesweep: A Faster Least Significant
//            Digit Radix Sort for GPUs", 2022): one launch counts every
//            pass's digits in one read of the keys (its totals go to the
//            host, and a pass whose digit is the same in every key is
//            skipped, as radix_sort.cpp:20-23 does), then one launch a pass
//            run, between two ping-pong buffers.
//   K7-merge merge_kernel, merge_pointers_kernel
//                                  <- the run-length merge (:117-132) and
//            fora_unpack_keys (:205, body unpack_range :157): one pass over
//            the sorted keys writes the unique keys unpacked into edge_src /
//            edge_dst at their rank, each one's run length as the float32
//            multiplicity, the bucket offsets and the rank at each (bucket,
//            endpoint) that has a key; a second, small launch fills every
//            bucket's [n + 1] row pointers by endpoint from them, relative
//            to the bucket, and writes the bucket sizes.
// Sorted order of a multiset of keys and its run-length merge do not depend
// on the algorithm, so the arrays equal the host branches' bit for bit.
//
// What bounds it on the H100: bytes.  K7-keys reads the endpoints once and
// writes 8 bytes a key.  K7-sort reads every key once for the counts, then
// reads and writes every key once a pass it does not skip.  K7-merge reads
// the sorted keys once and writes 12 bytes a unique edge and 4 (n + 1)
// bytes a bucket (the pointers), which its second launch reads and writes
// once more.
//
// K7-sort's design.  The counts: a warp reads 32 neighbouring keys at a
// time; in each pass the lanes whose digit equals their left neighbour's
// join its run, and each run's first lane adds the run's length to the
// block's shared-memory counter (keys arrive in pool order, so a node's
// source digits and its buckets come in runs: one add a run, not a key,
// and no __match_any_sync).  A pass: persistent blocks take 4096-key
// tiles from an atomic ticket, so every tile a block waits on belongs to a
// block that is already running (by blockIdx, a block could wait on a tile
// never scheduled).  A tile's keys are ranked by digit in shared memory,
// stably: each warp takes its 512 keys 32 at a time, the lanes of one
// digit found by __match_any_sync (one a key and pass; a ballot a digit
// bit measured 1.5-7% slower), the warps' counts then scanned in warp
// order.  The tile publishes each digit's count with flag A at once,
// scatters its keys into shared memory in digit order, then looks back
// (decoupled look-back, Merrill and Garland 2016: each thread its digits,
// summing the words of the tiles before down to the nearest inclusive
// prefix, flag P), publishes its inclusive prefixes, and writes each
// digit's run out contiguously from shared memory, neighbouring threads to
// neighbouring addresses.  Status: one 32-bit word a (tile, digit), the
// flag in the top two bits and a 30-bit count, so at most 2^30 - 1 keys;
// the words and the ticket are zeroed before each pass by one
// cudaMemsetAsync (as K6-demand's are: no epoch tag, nothing kept from one
// call or pass to the next).  Digits of 8, 9 or 11 bits (a template; 3
// blocks an SM at 8 and 9): kernels.sort_digit_bits takes 9 where that
// saves a pass (42-bit keys at bench scale: 5 passes, not 6), else 8; 11
// (4 passes, 2048 counters a tile, one block an SM) was the slowest.
//
// K7-merge's design.  The same tiles and tickets, one 64-bit status word a
// tile.  A block holds two tickets: it merges one tile from shared memory
// while the next tile's keys, and the keys just before and after it, come
// in by cp.async.  A tile's run heads (key[i] != key[i - 1]) are counted
// by ballots, warp 0 looks back 32 tiles a step for the heads before the
// tile, and then every head writes its unpacked key at its rank u.  Its
// multiplicity is the distance to the next head: within a warp's 32 keys
// from the ballot, else the next chunk's or warp's first head, and for the
// tile's last head the first place past the tile whose key differs (a
// gallop and a 32-way search over the sorted keys, so a run across many
// tiles costs a few loads).  The pointers: with x = bucket * (n + 1) +
// endpoint, the flattened [8, n + 1] pointers hold at x the number of
// unique keys whose x is below, which is the rank of the first key at the
// first x at or after it that any key has.  So the pass writes only that:
// a key whose x differs from the key before's writes its rank at its x,
// and the first such key of each 4096-place tile of a row also into that
// tile's word.  The second launch, a block a tile, fills every place from
// the next rank at or after it (a backward scan in shared memory; past the
// tile, the next tile's word that holds one, or U) and subtracts its row's
// offset, 16.8 MB read and written at bench scale.  (Writing every place
// in the pass, each key the places before it, cost 0.32 ms of 0.71 on
// phase 8's keys: 1.15 M keys own the 4.2 M places, so their lanes ran 32
// places a chunk and some warps millions.)  The places hold absolute
// ranks because the bucket offsets are known only once every tile has
// counted its heads; carrying the open bucket's offset through the
// look-back would cost a wider status word and a segmented scan.  The
// offsets come from the heads whose bucket differs from the key
// before's.  No run start goes to device memory and back: the sorted keys
// are read once.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kBuckets = 8;              // NUM_BUCKETS of index/build.py
constexpr int kThreads = 256;            // a block of K7-sort's passes and of K7-merge
constexpr int kWarps = kThreads / 32;
constexpr int kKeysPerLane = 16;
constexpr int kWarpKeys = 32 * kKeysPerLane;          // 512
constexpr int kTile = kWarps * kWarpKeys;             // 4096
constexpr int kHistThreads = 1024;
constexpr int kPlaceTileLog2 = 12;
constexpr int kPlaceTile = 1 << kPlaceTileLog2;   // places a block of K7-merge's second launch takes
constexpr int kHistKeysInFlight = 4;     // keys a lane of the counts loads at once
constexpr unsigned kFull = 0xffffffffu;
// K7-sort's status word: flag (0 unpublished, A the tile's count, P the
// inclusive prefix) in the top two bits, a 30-bit count
constexpr unsigned kSortA = 1u << 30, kSortP = 2u << 30, kSortCount = (1u << 30) - 1;
// K7-merge's: the same flags over a 62-bit count
constexpr u64 kMergeA = 1ull << 62, kMergeP = 2ull << 62, kMergeCount = (1ull << 62) - 1;

__device__ __forceinline__ unsigned load_relaxed(const unsigned* p) {
  unsigned w;
  asm volatile("ld.relaxed.gpu.u32 %0, [%1];" : "=r"(w) : "l"(p) : "memory");
  return w;
}

__device__ __forceinline__ void store_relaxed(unsigned* p, unsigned w) {
  asm volatile("st.relaxed.gpu.u32 [%0], %1;" ::"l"(p), "r"(w) : "memory");
}

__device__ __forceinline__ u64 load_relaxed(const u64* p) {
  u64 w;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(w) : "l"(p) : "memory");
  return w;
}

__device__ __forceinline__ void store_relaxed(u64* p, u64 w) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(w) : "memory");
}

// the exclusive prefix of x over the block's threads in order (every
// thread calls it; warp_sums is [kWarps] of shared memory)
__device__ __forceinline__ unsigned block_exclusive(unsigned x, unsigned* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  unsigned before = 0;
  for (int w = 0; w < warp; ++w) before += warp_sums[w];
  __syncthreads();
  return before + incl - x;
}

// ---- K7-keys --------------------------------------------------------------

// A warp per node v (grid-stride), its lanes over v's K_v = cut[v, 0]
// entries; threads t < nd write the dangling nodes' self-edge keys.
__global__ void pack_keys_kernel(const int* __restrict__ ends,
                                 const long long* __restrict__ offsets,
                                 const long long* __restrict__ cut, long long n,
                                 const long long* __restrict__ dang, long long nd, long long total,
                                 int nb, u64* __restrict__ keys) {
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

// every pass's digit counts over all keys: totals[p * R + d]
template <int kBits>
__global__ void __launch_bounds__(kHistThreads)
    radix_histogram_kernel(const u64* __restrict__ keys, long long len, int passes,
                           unsigned* __restrict__ totals) {
  constexpr int R = 1 << kBits;
  constexpr int U = kHistKeysInFlight;
  extern __shared__ unsigned sh_hist[];   // [passes][R]
  for (int i = threadIdx.x; i < passes * R; i += blockDim.x) sh_hist[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (kHistThreads / 32);
  const long long warp = (long long)blockIdx.x * (kHistThreads / 32) + (threadIdx.x >> 5);
  for (long long b = warp * 32 * U; b < len; b += warps * 32 * U) {
    u64 k[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = b + u * 32 + lane;
      k[u] = i < len ? keys[i] : 0;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long c = b + u * 32;     // the same in every lane
      if (c >= len) break;
      const int valid = (int)min(32LL, len - c);
      for (int p = 0; p < passes; ++p) {
        const unsigned d = (unsigned)(k[u] >> (p * kBits)) & (R - 1);
        const unsigned left = __shfl_up_sync(kFull, d, 1);
        const bool head = lane < valid && (lane == 0 || d != left);
        const unsigned heads = __ballot_sync(kFull, head);
        if (head) {
          const unsigned above = heads & ~((2u << lane) - 1u);
          const int end = above ? __ffs(above) - 1 : valid;
          atomicAdd(&sh_hist[p * R + d], (unsigned)(end - lane));
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < passes * R; i += blockDim.x)
    if (sh_hist[i]) atomicAdd(&totals[i], sh_hist[i]);
}

// A pass's dynamic shared memory: the tile's keys in digit order, each
// warp's count (then tile place) of each digit, each digit's output base
// less its tile start, and its first place in the output.
template <int kBits>
struct SortSmem {
  static constexpr int R = 1 << kBits;
  static constexpr size_t stage = 0;                                   // u64 [kTile]
  static constexpr size_t wcnt = stage + sizeof(u64) * kTile;          // u16 [kWarps][R]
  static constexpr size_t gbase = wcnt + sizeof(unsigned short) * kWarps * R;   // int [R]
  static constexpr size_t dbase = gbase + sizeof(int) * R;             // u32 [R]
  static constexpr size_t bytes = dbase + sizeof(unsigned) * R;
};

// One pass of the digit at ``shift``: in -> out, stable.  totals is the
// pass's row of the counts; ticket and status come zeroed.  Thread t owns
// the digits t D .. t D + D - 1 (D = R / kThreads).
template <int kBits>
__global__ void __launch_bounds__(kThreads, kBits <= 9 ? 3 : 1)
    onesweep_kernel(const u64* __restrict__ in, u64* __restrict__ out, long long len, int shift,
                    long long T, const unsigned* __restrict__ totals, unsigned* __restrict__ ticket,
                    unsigned* __restrict__ status) {
  using S = SortSmem<kBits>;
  constexpr int R = S::R, D = R / kThreads;
  static_assert(D >= 1 && D * kThreads == R, "a thread owns whole digits");
  extern __shared__ __align__(16) unsigned char smem[];
  u64* stage = reinterpret_cast<u64*>(smem + S::stage);
  unsigned short* wcnt = reinterpret_cast<unsigned short*>(smem + S::wcnt);
  int* gbase = reinterpret_cast<int*>(smem + S::gbase);
  unsigned* dbase = reinterpret_cast<unsigned*>(smem + S::dbase);
  __shared__ unsigned warp_sums[kWarps];
  __shared__ unsigned long long s_tile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1;
  const int d0 = threadIdx.x * D;
  {   // each digit's first place in the output: the totals' exclusive prefix
    unsigned v[D], s = 0;
#pragma unroll
    for (int j = 0; j < D; ++j) s += v[j] = totals[d0 + j];
    unsigned run = block_exclusive(s, warp_sums);
#pragma unroll
    for (int j = 0; j < D; ++j) {
      dbase[d0 + j] = run;
      run += v[j];
    }
  }
  unsigned short* mine = wcnt + warp * R;
  for (;;) {
    if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1u);
    for (int i = lane; i < R / 2; i += 32) reinterpret_cast<unsigned*>(mine)[i] = 0;
    __syncthreads();
    const long long t = (long long)s_tile;
    if (t >= T) return;
    const long long wlo = t * kTile + (long long)warp * kWarpKeys;
    u64 key[kKeysPerLane];
    unsigned rank[kKeysPerLane];
#pragma unroll
    for (int it = 0; it < kKeysPerLane; ++it) {
      const long long i = wlo + it * 32 + lane;
      key[it] = i < len ? in[i] : 0;
    }
    // each key's rank among the warp's earlier keys of its digit
#pragma unroll
    for (int it = 0; it < kKeysPerLane; ++it) {
      const bool valid = wlo + it * 32 + lane < len;
      const unsigned d = (unsigned)(key[it] >> shift) & (R - 1);
      const unsigned peers = __match_any_sync(kFull, valid ? d : (unsigned)R + lane);
      const unsigned seen = valid ? mine[d] : 0u;
      __syncwarp();
      if (valid && lane == 31 - __clz(peers)) mine[d] = (unsigned short)(seen + __popc(peers));
      __syncwarp();
      rank[it] = seen + __popc(peers & lower);
    }
    __syncthreads();
    // the tile's count of each owned digit, published at once
    unsigned cnt[D], s = 0;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      unsigned c = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) c += wcnt[w * R + d0 + j];
      cnt[j] = c;
      s += c;
      store_relaxed(status + t * R + d0 + j, (t == 0 ? kSortP : kSortA) | c);
    }
    // each digit's start in the tile, and each warp's keys' start in it
    unsigned tstart[D];
    {
      unsigned run = block_exclusive(s, warp_sums);
#pragma unroll
      for (int j = 0; j < D; ++j) {
        tstart[j] = run;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const unsigned c = wcnt[w * R + d0 + j];
          wcnt[w * R + d0 + j] = (unsigned short)run;
          run += c;
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int it = 0; it < kKeysPerLane; ++it)
      if (wlo + it * 32 + lane < len)
        stage[mine[(unsigned)(key[it] >> shift) & (R - 1)] + rank[it]] = key[it];
    // look back: the keys of each owned digit in the tiles before
    unsigned ex[D];
#pragma unroll
    for (int j = 0; j < D; ++j) ex[j] = 0;
    if (t > 0) {
      long long at[D];
#pragma unroll
      for (int j = 0; j < D; ++j) at[j] = t - 1;
      unsigned open = (1u << D) - 1;
      while (open) {
        unsigned w[D];
#pragma unroll
        for (int j = 0; j < D; ++j)
          if ((open >> j) & 1u) w[j] = load_relaxed(status + at[j] * R + d0 + j);
#pragma unroll
        for (int j = 0; j < D; ++j) {
          if (!((open >> j) & 1u)) continue;
          const unsigned f = w[j] & ~kSortCount;
          if (f == 0) continue;              // not published yet: read it again
          ex[j] += w[j] & kSortCount;
          if (f == kSortP) open &= ~(1u << j);
          else --at[j];
        }
      }
#pragma unroll
      for (int j = 0; j < D; ++j) store_relaxed(status + t * R + d0 + j, kSortP | (ex[j] + cnt[j]));
    }
#pragma unroll
    for (int j = 0; j < D; ++j) gbase[d0 + j] = (int)(dbase[d0 + j] + ex[j]) - (int)tstart[j];
    __syncthreads();
    const int here = (int)min((long long)kTile, len - t * kTile);
    for (int p = threadIdx.x; p < here; p += kThreads) {
      const u64 key_p = stage[p];
      out[(long long)gbase[(unsigned)(key_p >> shift) & (R - 1)] + p] = key_p;
    }
    __syncthreads();
  }
}

// ---- K7-merge -------------------------------------------------------------

// The first place j >= from (from < len) whose key differs from tail =
// keys[from - 1], or len: the keys are sorted, so the places whose key
// equals tail are one run.  A gallop (lane l reads from - 1 + 2^l), then
// 32-way searches of the bracket: a few loads for a run of any length.
// Every lane of the warp calls it and gets the answer.
__device__ long long run_end(const u64* __restrict__ keys, long long len, long long from,
                             u64 tail) {
  const int lane = threadIdx.x & 31;
  const long long probe = from - 1 + (1LL << lane);
  const unsigned g = __ballot_sync(kFull, probe >= len || keys[probe] != tail);
  const int l = __ffs(g) - 1;               // lane 31's probe is past len < 2^31
  long long lo = l == 0 ? from : from + (1LL << (l - 1));
  long long hi = min(len, from - 1 + (1LL << l));
  while (lo < hi) {                         // keys[lo - 1] == tail, the answer in [lo, hi]
    const long long step = (hi - lo + 31) / 32;
    const long long q = lo + lane * step;
    const unsigned b = __ballot_sync(kFull, q < hi && keys[q] != tail);
    if (b) {
      const int f = __ffs(b) - 1;
      hi = lo + f * step;
      if (f) lo += (f - 1) * step + 1;
    } else {
      lo += min(31LL, (hi - 1 - lo) / step) * step + 1;
    }
  }
  return lo;
}

// A tile of K7-merge in shared memory: slot 1 the key before the tile,
// slots 2 .. kTile + 1 its keys, slot kTile + 2 the key after it (slot 0
// pads the keys to 16 bytes).
constexpr int kMergeSlots = kTile + 4;
constexpr size_t kMergeSmem = 2 * sizeof(u64) * kMergeSlots;

// Tile t's keys copied into ``buf`` by cp.async (16 bytes a copy, past
// len zero), the keys before and after it too, as one group.
__device__ __forceinline__ void copy_merge_tile(const u64* __restrict__ keys, int len, int t,
                                                u64* buf) {
  const int lo = t * kTile;
  const unsigned dst = (unsigned)__cvta_generic_to_shared(buf + 2);
#pragma unroll
  for (int j = 0; j < kTile / 2 / kThreads; ++j) {
    const int c = j * kThreads + threadIdx.x;          // a pair of keys
    const int i = lo + 2 * c;
    const int bytes = i + 1 < len ? 16 : i < len ? 8 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst + 16 * c),
                 "l"(keys + (bytes ? i : 0)), "r"(bytes)
                 : "memory");
  }
  if (threadIdx.x < 2) {
    const int i = threadIdx.x == 0 ? lo - 1 : lo + kTile;
    const bool ok = i >= 0 && i < len;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(
                     (unsigned)__cvta_generic_to_shared(buf + (threadIdx.x == 0 ? 1 : kTile + 2))),
                 "l"(keys + (ok ? i : 0)), "r"(ok ? 8 : 0)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// One pass over the sorted keys (see the file's head).  ptr [8 n1] gets
// the rank of the first key at each place that has one, first_of_tile
// [8][ceil(n1 / 4096)] that of each place tile's first, offs [9] the
// bucket offsets; ticket and status come zeroed, ptr and first_of_tile
// all -1.  len < 2^31, so
// places in the keys and ranks are 32-bit; P holds a place in the
// pointers (unsigned while 8 n1 fits 32 bits).  A block holds two
// tickets: the tile it merges, from shared memory, and the next, whose
// copy into the other buffer is in flight meanwhile (a tile waits only on
// tiles before it, which are merged first, so no ticket held ahead stops
// one).
template <typename P>
__global__ void __launch_bounds__(kThreads)
    merge_kernel(const u64* __restrict__ keys, int len, int nb, long long n1, int T,
                 u64* __restrict__ ticket, u64* __restrict__ status, int* __restrict__ src,
                 int* __restrict__ dst, float* __restrict__ mult, int* __restrict__ ptr,
                 int* __restrict__ first_of_tile, long long* __restrict__ offs) {
  extern __shared__ __align__(16) u64 merge_buf[];     // [2][kMergeSlots]
  __shared__ unsigned s_heads[kWarps];     // a warp's run heads
  __shared__ int s_first[kWarps];          // its first head's place, or -1
  __shared__ int s_last[kWarps];           // its last head's place, or -1
  __shared__ unsigned s_last_u[kWarps];    // and rank
  __shared__ unsigned s_excl;              // the heads before the tile
  __shared__ unsigned long long s_k[2];    // tickets, a slot a tile in turn
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1;
  const unsigned mask = (1u << nb) - 1;    // nb <= 29
  const unsigned tiles_per_row = (unsigned)((n1 + kPlaceTile - 1) >> kPlaceTileLog2);
  if (threadIdx.x == 0) s_k[0] = atomicAdd(ticket, 1ull);
  __syncthreads();
  unsigned long long k = s_k[0];
  if (k < (unsigned long long)T) copy_merge_tile(keys, len, (int)k, merge_buf);
  for (int round = 0;; ++round) {
    if (k >= (unsigned long long)T) return;
    const int t = (int)k;
    u64* buf = merge_buf + (round & 1) * kMergeSlots;
    if (threadIdx.x == 0) s_k[(round + 1) & 1] = atomicAdd(ticket, 1ull);
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();
    k = s_k[(round + 1) & 1];
    if (k < (unsigned long long)T)
      copy_merge_tile(keys, len, (int)k, merge_buf + ((round + 1) & 1) * kMergeSlots);
    const int tlo = t * kTile;
    const int wlo = warp * kWarpKeys;       // in the tile
    unsigned hb[kKeysPerLane];
    unsigned heads = 0;
#pragma unroll
    for (int it = 0; it < kKeysPerLane; ++it) {
      const int j = wlo + it * 32 + lane;
      const int i = tlo + j;
      hb[it] = __ballot_sync(kFull, i < len && (i == 0 || buf[2 + j] != buf[1 + j]));
      heads += __popc(hb[it]);
    }
    if (lane == 0) s_heads[warp] = heads;
    __syncthreads();
    if (warp == 0) {
      const unsigned c = __reduce_add_sync(kFull, lane < kWarps ? s_heads[lane] : 0u);
      if (lane == 0) store_relaxed(status + t, (t == 0 ? kMergeP : kMergeA) | c);
      u64 ex = 0;
      if (t > 0) {
        for (int top = t - 1;; top -= 32) {
          const int at = top - lane;
          u64 w = at >= 0 ? load_relaxed(status + at) : kMergeP;
          while (!__all_sync(kFull, (w & ~kMergeCount) != 0))
            if ((w & ~kMergeCount) == 0) w = load_relaxed(status + at);
          const unsigned pm = __ballot_sync(kFull, (w & ~kMergeCount) == kMergeP);
          const int near = pm ? __ffs(pm) - 1 : 32;
          u64 v = lane <= near ? (w & kMergeCount) : 0;
#pragma unroll
          for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
          ex += v;
          if (pm) break;
        }
        if (lane == 0) store_relaxed(status + t, kMergeP | (ex + c));
      }
      if (lane == 0) s_excl = (unsigned)ex;
    }
    __syncthreads();
    unsigned u0 = s_excl;
    for (int w = 0; w < warp; ++w) u0 += s_heads[w];
    int first = -1, last = -1;              // the warp's heads so far
    unsigned last_u = 0;
#pragma unroll
    for (int it = 0; it < kKeysPerLane; ++it) {
      const int c0 = tlo + wlo + it * 32;
      if (c0 >= len) break;                 // the same in every lane
      const int j = wlo + it * 32 + lane;
      const int i = tlo + j;
      const bool valid = i < len;
      const unsigned h = hb[it];
      const unsigned u = u0 + __popc(h & lower);
      const unsigned u_end = u0 + __popc(h);
      const u64 key = buf[2 + j], left = buf[1 + j];
      const unsigned bq = (unsigned)(key >> (2 * nb));
      const unsigned ep = (unsigned)(key >> nb) & mask;
      const unsigned b_left = (unsigned)(left >> (2 * nb));
      const unsigned ep_left = (unsigned)(left >> nb) & mask;
      const P px = (P)bq * (P)n1 + (P)ep;
      const P x_left = (P)b_left * (P)n1 + (P)ep_left;
      if ((h >> lane) & 1u) {
        src[u] = (int)((unsigned)key & mask);
        dst[u] = (int)ep;
        const unsigned above = h & ~((2u << lane) - 1u);
        if (above) mult[u] = (float)(__ffs(above) - 1 - lane);
        // the bucket offsets: a head whose bucket differs from the key
        // before opens every bucket up to its own
        if (i == 0 || bq != b_left)
          for (unsigned q = i == 0 ? 0u : b_left + 1; q <= bq; ++q) offs[q] = u;
      }
      if (i == len - 1)
        for (unsigned q = bq + 1; q <= kBuckets; ++q) offs[q] = u_end;
      if (h) {
        const int f = c0 + __ffs(h) - 1;
        if (last >= 0 && lane == 0) mult[last_u] = (float)(f - last);
        if (first < 0) first = f;
        last = c0 + 31 - __clz(h);
        last_u = u_end - 1;
      }
      // the pointers: a key whose place (bucket, endpoint) differs from
      // the key before's writes its rank there, and the first such key of
      // a 4096-place tile of its row also in first_of_tile
      if (valid && (i == 0 || px != x_left)) {
        ptr[px] = (int)u;
        if (i == 0 || bq != b_left || (ep >> kPlaceTileLog2) != (ep_left >> kPlaceTileLog2))
          first_of_tile[bq * tiles_per_row + (ep >> kPlaceTileLog2)] = (int)u;
      }
      u0 = u_end;
    }
    if (lane == 0) {
      s_first[warp] = first;
      s_last[warp] = last;
      s_last_u[warp] = last_u;
    }
    __syncthreads();
    if (warp == 0) {
      // each warp's last head's run ends at the next warp's first head, the
      // tile's last at the first place past the tile whose key differs
      const int tile_hi = min(len, tlo + kTile);
      long long after = tile_hi;
      if (tile_hi < len) {
        const u64 tail = buf[1 + kTile];
        bool any = false;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) any |= s_last[w] >= 0;
        if (any && buf[2 + kTile] == tail) after = run_end(keys, len, tile_hi, tail);
      }
      if (lane < kWarps && s_last[lane] >= 0) {
        long long next = after;
        for (int w = kWarps - 1; w > lane; --w)
          if (s_first[w] >= 0) next = s_first[w];
        mult[s_last_u[lane]] = (float)(next - s_last[lane]);
      }
    }
    __syncthreads();
  }
}

// Place tile blockIdx.x of row blockIdx.y of the pointers: each place
// gets the rank at the first place at or after it that holds one (in the
// tile, by a backward scan in shared memory; past the tile, the first
// later tile's first, or U), less the row's offset; and the bucket sizes.
__global__ void __launch_bounds__(kThreads)
    merge_pointers_kernel(int* __restrict__ ptr, long long n1,
                          const int* __restrict__ first_of_tile,
                          const long long* __restrict__ offs,
                          long long* __restrict__ bucket_counts) {
  constexpr int kPer = kPlaceTile / kThreads;            // 16 places a thread
  __shared__ int s_place[kPlaceTile + kPlaceTile / kPer];   // a pad word a run
  __shared__ int s_next[kWarps];
  __shared__ int s_carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = blockIdx.y;
  const long long lo = (long long)blockIdx.x * kPlaceTile;
  const int here = (int)min((long long)kPlaceTile, n1 - lo);
  int* row = ptr + q * n1 + lo;
  for (int i = threadIdx.x; i < kPlaceTile; i += kThreads)
    s_place[i + i / kPer] = i < here ? row[i] : -1;
  // the rank past the tile: the first later tile's first, else U
  if (warp == 0) {
    const long long tiles = (long long)gridDim.x * gridDim.y;
    long long j = (long long)q * gridDim.x + blockIdx.x + 1;
    int carry = (int)offs[kBuckets];
    for (;; j += 32) {
      const bool in = j + lane < tiles;
      const unsigned b = __ballot_sync(kFull, in && first_of_tile[j + lane] >= 0);
      if (b) {
        carry = first_of_tile[j + __ffs(b) - 1];
        break;
      }
      if (!__any_sync(kFull, j + lane + 32 < tiles)) break;
    }
    if (lane == 0) s_carry = carry;
  }
  __syncthreads();
  // each thread's run of kPer places: its first rank, then the block's
  // suffix of those (the first rank after each run)
  int* run = s_place + threadIdx.x * (kPer + 1);
  int mine = -1;
#pragma unroll
  for (int j = kPer - 1; j >= 0; --j)
    if (run[j] >= 0) mine = run[j];
  int after = mine;       // the first rank in this run or a later one of the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_down_sync(kFull, after, o);
    if (lane + o < 32 && after < 0) after = y;
  }
  if (lane == 0) s_next[warp] = after;
  __syncthreads();
  int next = __shfl_down_sync(kFull, after, 1);          // after this run, in the warp
  if (lane == 31) next = -1;
  for (int w = warp + 1; w < kWarps && next < 0; ++w) next = s_next[w];
  if (next < 0) next = s_carry;
  const int off = (int)offs[q];
#pragma unroll
  for (int j = kPer - 1; j >= 0; --j) {
    if (run[j] >= 0) next = run[j];
    run[j] = next - off;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < here; i += kThreads) row[i] = s_place[i + i / kPer];
  if (blockIdx.x == 0 && threadIdx.x == 0) bucket_counts[q] = offs[q + 1] - offs[q];
}

long long tiles(long long len) { return (len + kTile - 1) / kTile; }

unsigned grid_for(long long threads, long long cap) {
  long long b = (threads + 255) / 256;
  if (b > cap) b = cap;
  return (unsigned)(b > 0 ? b : 1);
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

// persistent blocks of ``kernel``: as many as the card holds at once, at
// most ``work``
template <typename K>
unsigned resident_grid(K kernel, size_t smem, long long work) {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem) !=
      cudaSuccess)
    return 0;
  long long g = (long long)per_sm * sm_count();
  if (g > work) g = work;
  return (unsigned)g;
}

template <typename P>
cudaError_t launch_merge(const u64* keys, long long len, int nb, long long n1, long long T,
                         u64* ticket, u64* status, int* src, int* dst, float* mult, int* indptr,
                         int* first_of_tile, long long* offs, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(merge_kernel<P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kMergeSmem);
  if (err != cudaSuccess) return err;
  const unsigned grid = resident_grid(merge_kernel<P>, kMergeSmem, T);
  if (grid == 0) return cudaErrorInvalidConfiguration;
  merge_kernel<P><<<grid, kThreads, kMergeSmem, st>>>(keys, (int)len, nb, n1, (int)T, ticket,
                                                      status, src, dst, mult, indptr,
                                                      first_of_tile, offs);
  return cudaGetLastError();
}

template <int kBits>
int sort_with(u64* keys, u64* alt, long long len, int key_bits, unsigned* scratch,
              long long scratch_words, int* passes_done, cudaStream_t st) {
  constexpr int R = 1 << kBits;
  constexpr int kMaxPasses = (64 + kBits - 1) / kBits;
  const long long T = tiles(len);
  if (len < 0 || len > (long long)kSortCount || key_bits < 1 || key_bits > 64 ||
      passes_done == nullptr || scratch_words < (long long)kMaxPasses * R + 2 + R * T)
    return (int)cudaErrorInvalidValue;
  *passes_done = 0;
  if (len <= 1) return (int)cudaGetLastError();
  const int passes = (key_bits + kBits - 1) / kBits;
  unsigned* totals = scratch;
  unsigned* ticket = scratch + kMaxPasses * R;
  unsigned* status = ticket + 2;
  cudaError_t err = cudaMemsetAsync(totals, 0, sizeof(unsigned) * passes * R, st);
  if (err != cudaSuccess) return (int)err;
  const size_t hist_smem = sizeof(unsigned) * passes * R;
  if ((err = cudaFuncSetAttribute(radix_histogram_kernel<kBits>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)hist_smem)) != cudaSuccess)
    return (int)err;
  radix_histogram_kernel<kBits><<<2 * sm_count(), kHistThreads, hist_smem, st>>>(
      keys, len, passes, totals);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  static thread_local unsigned host[kMaxPasses * R];
  err = cudaMemcpyAsync(host, totals, sizeof(unsigned) * passes * R, cudaMemcpyDeviceToHost, st);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaStreamSynchronize(st)) != cudaSuccess) return (int)err;
  const size_t smem = SortSmem<kBits>::bytes;
  if ((err = cudaFuncSetAttribute(onesweep_kernel<kBits>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
      cudaSuccess)
    return (int)err;
  const unsigned grid = resident_grid(onesweep_kernel<kBits>, smem, T);
  if (grid == 0) return (int)cudaErrorInvalidConfiguration;
  u64* cur = keys;
  u64* nxt = alt;
  for (int p = 0; p < passes; ++p) {
    bool constant = false;   // every key shares this pass's digit
    for (int d = 0; d < R && !constant; ++d) constant = host[p * R + d] == (unsigned)len;
    if (constant) continue;
    if ((err = cudaMemsetAsync(ticket, 0, sizeof(unsigned) * (2 + R * T), st)) != cudaSuccess)
      return (int)err;
    onesweep_kernel<kBits><<<grid, kThreads, smem, st>>>(cur, nxt, len, p * kBits, T,
                                                         totals + p * R, ticket, status);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    u64* tmp = cur;
    cur = nxt;
    nxt = tmp;
    ++*passes_done;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// K7-keys: keys [total + nd] u64 from ends [total] int32, offsets [n] and
// cut [n, 8] int64 (cut[v, 0] = K_v), dang [nd] int64
extern "C" int fora_pack_keys(const int* ends, const long long* offsets, const long long* cut,
                              long long n, const long long* dang, long long nd, long long total,
                              int nb, u64* keys, void* stream) {
  if (n < 0 || nd < 0 || total < 0 || nb < 1 || 2 * nb + 4 > 63) return (int)cudaErrorInvalidValue;
  if (total + nd == 0) return (int)cudaGetLastError();
  long long threads = n * 32 > nd ? n * 32 : nd;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  pack_keys_kernel<<<grid_for(threads, 1LL << 16), 256, 0, st>>>(ends, offsets, cut, n, dang, nd,
                                                                 total, nb, keys);
  return (int)cudaGetLastError();
}


// K7-sort: keys [len] (len < 2^30) sorted ascending over their low
// key_bits bits with digits of digit_bits (8 or 11) bits, in ``keys`` or
// ``alt`` (the same size): *passes_done passes ran, an odd count leaves the
// result in ``alt``.  ``scratch`` holds ceil(64 / digit_bits) R + 2 + R
// ceil(len / 4096) u32 words (R = 2^digit_bits: the totals, the ticket,
// the tiles' status words).  Synchronises the stream once, to read the
// digit totals.
extern "C" int fora_sort_keys(u64* keys, u64* alt, long long len, int key_bits, int digit_bits,
                              unsigned* scratch, long long scratch_words, int* passes_done,
                              void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (digit_bits == 8)
    return sort_with<8>(keys, alt, len, key_bits, scratch, scratch_words, passes_done, st);
  if (digit_bits == 9)
    return sort_with<9>(keys, alt, len, key_bits, scratch, scratch_words, passes_done, st);
  if (digit_bits == 11)
    return sort_with<11>(keys, alt, len, key_bits, scratch, scratch_words, passes_done, st);
  return (int)cudaErrorInvalidValue;
}

// K7-merge: the run-length merge of the sorted keys [len] (len < 2^31,
// 16-byte aligned) of nb-bit ids of n nodes: the U unique keys unpacked
// into src / dst [>= U] int32, their run lengths into mult [>= U] f32,
// bucket_counts [8] int64 the bucket sizes, indptr [8, n + 1] int32 each
// bucket's row pointers by endpoint (an empty bucket's zeros), *unique =
// U.  ``scratch`` holds 2 (1 + ceil(len / 4096) + 9) + 8 ceil((n + 1) /
// 4096) u32 words (the ticket, the tiles' status words and the bucket
// offsets, 64 bits each; each place tile's first rank).  Two launches;
// synchronises the stream once, to read U.
extern "C" int fora_merge_keys(const u64* keys, long long len, int nb, long long n,
                               unsigned* scratch, long long scratch_words, int* src, int* dst,
                               float* mult, int* indptr, long long* bucket_counts,
                               long long* unique, void* stream) {
  const long long T = tiles(len);
  const long long n1 = n + 1;
  const long long tiles_per_row = (n1 + kPlaceTile - 1) / kPlaceTile;
  if (len < 0 || len >= (1LL << 31) || n < 1 || nb < 1 || 2 * nb + 4 > 63 ||
      n > (1LL << nb) || unique == nullptr || ((uintptr_t)keys & 15) != 0 ||
      scratch_words < 2 * (1 + T + 9) + kBuckets * tiles_per_row)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  *unique = 0;
  if (len == 0) {
    if ((err = cudaMemsetAsync(indptr, 0, sizeof(int) * kBuckets * n1, st)) != cudaSuccess)
      return (int)err;
    return (int)cudaMemsetAsync(bucket_counts, 0, sizeof(long long) * kBuckets, st);
  }
  u64* ticket = reinterpret_cast<u64*>(scratch);
  u64* status = ticket + 1;
  long long* offs = reinterpret_cast<long long*>(ticket + 1 + T);
  int* first_of_tile = reinterpret_cast<int*>(offs + 9);
  if ((err = cudaMemsetAsync(ticket, 0, sizeof(u64) * (1 + T), st)) != cudaSuccess ||
      (err = cudaMemsetAsync(first_of_tile, 0xff, sizeof(int) * kBuckets * tiles_per_row,
                             st)) != cudaSuccess ||
      (err = cudaMemsetAsync(indptr, 0xff, sizeof(int) * kBuckets * n1, st)) != cudaSuccess)
    return (int)err;
  if (kBuckets * n1 <= 0xffffffffLL)
    err = launch_merge<unsigned>(keys, len, nb, n1, T, ticket, status, src, dst, mult, indptr,
                                 first_of_tile, offs, st);
  else
    err = launch_merge<u64>(keys, len, nb, n1, T, ticket, status, src, dst, mult, indptr,
                            first_of_tile, offs, st);
  if (err != cudaSuccess) return (int)err;
  merge_pointers_kernel<<<dim3((unsigned)tiles_per_row, kBuckets), kThreads, 0, st>>>(
      indptr, n1, first_of_tile, offs, bucket_counts);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  err = cudaMemcpyAsync(unique, offs + kBuckets, sizeof(long long), cudaMemcpyDeviceToHost, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaStreamSynchronize(st);
}
