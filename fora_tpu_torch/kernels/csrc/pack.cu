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
//              bucket(j) = #{q in 1..7 : j < cut_q(K_v)},
//            cut_q(K) = ceil(K 4^-q) = (K + 4^q - 1) >> 2q, which for
//            integers is j 4^q < K; the host's float64 table of the same
//            cutoffs (index/build.py::pack_tables) agrees exactly, since
//            4^-q is a power of two (tests/test_torch_pack.py holds the
//            two equal), so the kernel reads only K_v = offsets[v + 1] -
//            offsets[v].  The dangling nodes' self-edges (7 << 2nb | d <<
//            nb | d) follow at total + i.  Optionally, in the same pass,
//            every K7-sort pass's digit counts over the keys.
//            Two more forms of the same tile walk pack an index too large
//            for one sort (past K7-sort's 2^30 - 1 keys, or past the card's
//            memory) in key-range windows: the count form writes no key and
//            counts the keys in [lo, hi) by (key - lo) >> shift into at most
//            2^14 bins; the window form writes only the keys in [lo, hi),
//            compacted, with their digit counts (index/build.py plans the
//            windows over the counts and sorts and merges each alone).
//   K7-sort  radix_histogram_kernel, onesweep_kernel
//                                  <- fora_sort_unique_u64's sort (:53-115)
//            a stable LSD radix sort over key_bits = 2nb + 4 bits, onesweep
//            (Adinets and Merrill, "Onesweep: A Faster Least Significant
//            Digit Radix Sort for GPUs", 2022): one launch counts every
//            pass's digits in one read of the keys, or K7-keys hands them
//            in (its totals go to the host, and a pass whose digit is the
//            same in every key is skipped, as radix_sort.cpp:20-23 does),
//            then one launch a pass run, between two ping-pong buffers.
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
// What bounds it on the H100: bytes.  K7-keys reads the endpoints and the
// [n + 1] offsets once and writes 8 bytes a key (its count form writes only
// its bins, its window form 8 bytes a key of the window).  K7-sort reads every key
// once for the counts (unless K7-keys counted them), then reads and writes
// every key once a pass it does not skip.  K7-merge reads
// the sorted keys once and writes 12 bytes a unique edge and 4 (n + 1)
// bytes a bucket (the pointers), which its second launch reads and writes
// once more.
//
// K7-keys' design.  Work goes by pool entries, not by nodes (a warp a node
// left the 239 k dangling nodes' warps idle at bench scale and one warp
// walking a hub of 1.3e5 entries, 10% of the bound).  A block of 512
// threads takes 4096-entry tiles, each thread two runs of four neighbouring
// entries (one 16-byte load of endpoints, two 16-byte stores of keys a
// run); each block takes a contiguous range of tiles.  A tile stages the
// offsets (as 32-bit ints) from the node of its first entry on, 512 a
// step, until one is past its last entry, and each thread finds its first
// entry's node by a binary search of the stage (the last v with offsets[v]
// <= i, which passes over empty nodes), its others by moving on from
// there.  The node of a tile's last entry (a warp's 32-way search of the
// stage) is where the next tile's stage starts, so only a block's first
// tile searches the offsets in device memory, and the next tile's first
// stage step and endpoints load while a tile packs.  A tile spanning more
// nodes than the stage holds (a run of thousands of empty nodes) searches
// the offsets in device memory instead.  A hub costs what its entries
// cost.  The bucket is two clz and a compare (entry_bucket), not seven
// 64-bit tests (on an H100, phase 8's keys: 0.258 ms with a 64-bit stage
// and those tests, 0.245 with the loads ahead, 0.143 with both 32-bit and
// the loads ahead; what cost was instructions a key).  The dangling
// self-edges are tiles of their own after the entries'.  The
// digit counts, where asked for: the passes of source-id digits alone a
// node at a time (the node's entries in the tile, one add), the others
// each (run, entry) round of a warp, 32 keys: where fewer than 4 of the
// pass's bits are endpoint bits a run of equal digits among neighbouring
// lanes adds once (as the count launch does), else each key adds; the
// block's shared counters go to the totals once a block.
//
// The windows.  A packed key is bucket << 2nb | endpoint << nb | source, so
// a range of key values is a contiguous slice of the finished index, and
// the windows' merged arrays in key order are the index (their buckets'
// row pointers and sizes add up).  The count form and the window form are
// the tile walk above with another end: a key outside [lo, hi) is dropped.
// The count form adds each key to its bin in shared memory (an add a key;
// the bins go to device memory once a block).  The window form reserves a
// run's in-range keys by the block's exclusive scan and one atomic add on
// a cursor, so the keys land in no order, which K7-sort that follows does
// not mind; it counts their digits an add a key and pass, as the counts
// of in-range keys come in no runs.  Simple forms: an index needs them
// only past 2^30 keys.
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

// Passes p_lo .. passes - 1 of the key of every lane below ``valid`` (the
// same in every lane of the warp, which all call it) added into hist
// [passes][R].  A pass in ``runs``: a run of equal digits among
// neighbouring lanes adds once, by its first lane (keys in pool order come
// in runs of a node's source digits and buckets); any other pass (digits
// of random endpoint bits): each lane its own add.
template <int kBits>
__device__ __forceinline__ void count_digits(u64 key, int valid, int p_lo, int passes,
                                             unsigned runs, unsigned* hist) {
  constexpr int R = 1 << kBits;
  const int lane = threadIdx.x & 31;
  for (int p = p_lo; p < passes; ++p) {
    const unsigned d = (unsigned)(key >> (p * kBits)) & (R - 1);
    if (!((runs >> p) & 1u)) {
      if (lane < valid) atomicAdd(&hist[p * R + d], 1u);
      continue;
    }
    const unsigned left = __shfl_up_sync(kFull, d, 1);
    const bool head = lane < valid && (lane == 0 || d != left);
    const unsigned heads = __ballot_sync(kFull, head);
    if (head) {
      const unsigned above = heads & ~((2u << lane) - 1u);
      const int end = above ? __ffs(above) - 1 : valid;
      atomicAdd(&hist[p * R + d], (unsigned)(end - lane));
    }
  }
}

// the block's shared counters [passes][R] added into the totals
__device__ __forceinline__ void flush_counts(const unsigned* hist, int words,
                                             unsigned* __restrict__ totals) {
  for (int i = threadIdx.x; i < words; i += blockDim.x)
    if (hist[i]) atomicAdd(&totals[i], hist[i]);
}

// ---- K7-keys --------------------------------------------------------------

constexpr int kKeysThreads = 512;
constexpr int kKeysTile = 8 * kKeysThreads;       // 4096 entries: two runs of 4 a thread
constexpr int kKeysRun = kKeysTile / 2;
// offsets a tile stages, 512 a step: at most 4608 (4097 cover a tile with
// no empty node among its nodes)
constexpr int kStageSteps = 9;
constexpr int kStageMax = kStageSteps * kKeysThreads;
// K7-keys' forms: every key written (one window), the count form, the
// window form (see the file's head)
enum { kWrite = 0, kCount = 1, kWindow = 2 };
constexpr int kCountBins = 1 << 14;   // the count form's bins at most, 64 KB of shared memory

// The keys the count and window forms take, those k with k - lo < span
// (unsigned); the count form's key k adds to bin (k - lo) >> shift, the
// window form's go to keys [capacity] from a cursor.
struct KeyRange {
  u64 lo, span;
  int shift;
  unsigned* cursor;
  long long capacity;
};

// The window form: this thread's c keys get places at .. at + c - 1 of the
// window, by the block's exclusive scan of c and one atomic add on the
// cursor a block (scan: [kKeysThreads / 32 + 1] of shared memory; every
// thread of the block calls it).
__device__ __forceinline__ long long reserve(unsigned c, unsigned* scan, unsigned* cursor) {
  const unsigned before = block_exclusive(c, scan);
  if (threadIdx.x == kKeysThreads - 1) scan[kKeysThreads / 32] = atomicAdd(cursor, before + c);
  __syncthreads();
  const long long at = (long long)scan[kKeysThreads / 32] + before;
  __syncthreads();                          // read before the next reservation writes it
  return at;
}

// The count and window forms' end of N keys of this thread (those whose
// ``live`` bit is set): the count form adds each in the range to its bin
// (hist), the window form writes them at the places the block reserves and
// adds each pass's digit into hist [passes][2^kBits].  Every thread of the
// block calls it.
template <int kBits, int kMode, int N>
__device__ __forceinline__ void take_keys(const u64 (&key)[N], unsigned live, int passes,
                                          const KeyRange& range, u64* __restrict__ keys,
                                          unsigned* hist, unsigned* scan) {
  unsigned in = 0;
#pragma unroll
  for (int u = 0; u < N; ++u)
    if (((live >> u) & 1u) && key[u] - range.lo < range.span) in |= 1u << u;
  if constexpr (kMode == kCount) {
#pragma unroll
    for (int u = 0; u < N; ++u)
      if ((in >> u) & 1u) atomicAdd(&hist[(key[u] - range.lo) >> range.shift], 1u);
  } else {
    long long at = reserve(__popc(in), scan, range.cursor);
#pragma unroll
    for (int u = 0; u < N; ++u) {
      if (!((in >> u) & 1u)) continue;
      if (at < range.capacity) keys[at] = key[u];
      ++at;
      if constexpr (kBits > 0) {
        constexpr int R = 1 << kBits;
        for (int p = 0; p < passes; ++p)
          atomicAdd(&hist[p * R + ((unsigned)(key[u] >> (p * kBits)) & (R - 1))], 1u);
      }
    }
  }
}

// The first index in [lo, hi) of the ascending a whose value is above x,
// or hi.
template <typename T>
__device__ __forceinline__ int first_above(const T* a, int lo, int hi, T x) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] > x) hi = mid;
    else lo = mid + 1;
  }
  return lo;
}

// The same by a whole warp, 32 probes a step (every lane gets the answer).
template <typename T>
__device__ int warp_first_above(const T* a, int lo, int hi, T x) {
  const int lane = threadIdx.x & 31;
  while (lo < hi) {                         // the answer in [lo, hi]
    const int step = (hi - lo + 31) / 32;
    const int q = lo + lane * step;
    const unsigned b = __ballot_sync(kFull, q < hi && a[q] > x);
    if (b) {
      const int f = __ffs(b) - 1;
      hi = lo + f * step;
      if (f) lo += (f - 1) * step + 1;
    } else {
      lo += min(31, (hi - 1 - lo) / step) * step + 1;
    }
  }
  return lo;
}

// bucket(j) of an entry j of a node of K entries, 0 <= j < K < 2^31:
// #{q in 1..7 : j < ceil(K 4^-q)}, i.e. #{q : j 4^q < K}, i.e. min(7, s /
// 2) for the largest s with j 2^s < K: the bit lengths' difference sh, or
// sh - 1 where j 2^sh (of K's bit length) is not below K
__device__ __forceinline__ unsigned entry_bucket(unsigned j, unsigned K) {
  if (j == 0) return kBuckets - 1;
  const int sh = __clz(j) - __clz(K);
  const int s = (j << sh) < K ? sh : sh - 1;
  return min(kBuckets - 1, s >> 1);
}

// A run of four entries' endpoints from i on (the ones at or past total
// read as 0): one 16-byte load where ends is 16-byte aligned (vec).
__device__ __forceinline__ int4 load_run(const int* __restrict__ ends, long long i,
                                         long long total, bool vec) {
  if (vec && i + 3 < total) return *reinterpret_cast<const int4*>(ends + i);
  int4 x;
  x.x = i < total ? ends[i] : 0;
  x.y = i + 1 < total ? ends[i + 1] : 0;
  x.z = i + 2 < total ? ends[i + 2] : 0;
  x.w = i + 3 < total ? ends[i + 3] : 0;
  return x;
}

// One tile of K7-keys from its nodes' offsets a (a[k] the first entry of
// node v_base + k, a[0] <= tlo, a[a_hi - 1] > last): the stage (int) or
// the offsets in device memory (long long).  The source-digit passes a
// node at a time (node k holds min(a[k + 1], last + 1) - max(a[k], tlo)
// of the tile's entries), then each thread's two runs of four: the first
// entry's node by a search of a, the next ones by moving on from it.  The
// count and window forms end each run in take_keys instead.
template <int kBits, int kMode, typename T>
__device__ __forceinline__ void pack_tile(const T* a, int a_hi, long long v_base, long long tlo,
                                          long long last, const int4 (&e)[2], long long total,
                                          int nb, int passes, int sources, unsigned runs,
                                          const KeyRange& range, u64* __restrict__ keys,
                                          unsigned* hist, unsigned* scan) {
  constexpr int R = kBits > 0 ? 1 << kBits : 1;
  if constexpr (kBits > 0 && kMode == kWrite) {
    for (int k = 1 + threadIdx.x; sources > 0 && k < a_hi; k += kKeysThreads) {
      const long long lo = a[k - 1];
      if (lo > last) break;
      const long long c = min((long long)a[k], last + 1) - max(lo, tlo);
      const u64 v = (u64)(v_base + k - 1);
      if (c > 0)
        for (int p = 0; p < sources; ++p)
          atomicAdd(&hist[p * R + ((unsigned)(v >> (p * kBits)) & (R - 1))], (unsigned)c);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long i = tlo + r * kKeysRun + 4 * threadIdx.x;
    const int ep[4] = {e[r].x, e[r].y, e[r].z, e[r].w};
    int k = 0;                              // the node's place in a
    long long start = 0, end = LLONG_MIN;   // and its entries
    u64 key[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      key[u] = 0;
      if (i + u >= total) continue;
      if (i + u >= end) {                   // past the node: search on from it
        k = min(first_above<T>(a, k + 1, a_hi, (T)(i + u)), a_hi - 1);
        start = a[k - 1];
        end = a[k];
      }
      key[u] = ((u64)entry_bucket((unsigned)(i + u - start), (unsigned)(end - start)) << (2 * nb)) |
               ((u64)(unsigned)ep[u] << nb) | (u64)(v_base + k - 1);
    }
    if constexpr (kMode != kWrite) {
      const long long left = total - i;       // the run's keys below total
      take_keys<kBits, kMode, 4>(key, left >= 4 ? 15u : left > 0 ? (1u << left) - 1u : 0u, passes,
                                 range, keys, hist, scan);
      continue;
    }
    if (i + 3 < total) {
      ulonglong2* out = reinterpret_cast<ulonglong2*>(keys + i);
      out[0] = make_ulonglong2(key[0], key[1]);
      out[1] = make_ulonglong2(key[2], key[3]);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i + u < total) keys[i + u] = key[u];
    }
    if constexpr (kBits > 0) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        // lane l's key is entry c0 + 4 l: the lanes below valid hold one
        const long long c0 = tlo + r * kKeysRun + 4 * (threadIdx.x & ~31u) + u;
        count_digits<kBits>(key[u], (int)max(0LL, min(32LL, (total - c0 + 3) / 4)), sources,
                            passes, runs, hist);
      }
    }
  }
}

// K7-keys (see the file's head); total < 2^31 - 1, so offsets fit 32 bits.
// Tiles 0 .. Te - 1 are the entries', Te .. Te + Td - 1 the dangling
// self-edges'; block b takes the contiguous range [b W / G, (b + 1) W / G)
// of the W = Te + Td, and loads the next tile's endpoints and first stage
// step while it packs one (the dangling keys spread evenly over every
// block instead took the counting form 0.253 ms against 0.233 in one run
// on an H100).  kBits > 0: each pass's digit counts of kBits
// bits, over every key, added into totals [passes][2^kBits] (zeroed by the
// caller): the passes below ``sources`` (digits of the source id alone) a
// node at a time, the others a key at a time, by runs where ``runs`` has
// the pass.  vec: ends is 16-byte aligned.  kMode: kWrite writes every
// key at its place; kCount and kWindow take the keys in ``range`` (see
// take_keys).  ``words``: the shared counters, added into totals at the
// end (kCount: its bins).
template <int kBits, int kMode>
__global__ void __launch_bounds__(kKeysThreads, 2)
    pack_keys_kernel(const int* __restrict__ ends, const long long* __restrict__ offsets,
                     long long n, const long long* __restrict__ dang, long long nd,
                     long long total, int nb, bool vec, int passes, int sources, unsigned runs,
                     KeyRange range, int words, u64* __restrict__ keys,
                     unsigned* __restrict__ totals) {
  extern __shared__ __align__(16) unsigned char keys_smem[];
  int* stage = reinterpret_cast<int*>(keys_smem);                // [kStageMax]
  unsigned* hist = reinterpret_cast<unsigned*>(stage + kStageMax);  // [words]
  unsigned* scan = hist + words;            // kWindow: [kKeysThreads / 32 + 1]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (words > 0) {
    for (int i = threadIdx.x; i < words; i += kKeysThreads) hist[i] = 0;
    __syncthreads();
  }
  const long long Te = (total + kKeysTile - 1) / kKeysTile;
  const long long W = Te + (nd + kKeysTile - 1) / kKeysTile;
  const long long t_lo = blockIdx.x * W / gridDim.x, t_hi = (blockIdx.x + 1) * W / gridDim.x;
  const long long te_hi = min(t_hi, Te);
  // the offsets from v on, one stage step: this thread's slot
  auto stage_step = [&](long long v, int c) {
    const long long idx = v + c * kKeysThreads + threadIdx.x;
    return idx <= n ? (int)offsets[idx] : INT_MAX;
  };
  long long v_base = 0;                     // the node of the tile's first entry
  int4 e[2];
  int s0 = 0;                               // this thread's slot of the first stage step
  if (t_lo < te_hi) {
    v_base = warp_first_above<long long>(offsets, 0, (int)(n + 1), t_lo * kKeysTile) - 1;
    for (int r = 0; r < 2; ++r)
      e[r] = load_run(ends, t_lo * kKeysTile + r * kKeysRun + 4 * threadIdx.x, total, vec);
    s0 = stage_step(v_base, 0);
  }
  for (long long t = t_lo; t < te_hi; ++t) {
    const long long tlo = t * kKeysTile;
    const long long last = min(total, tlo + kKeysTile) - 1;
    // the stage: offsets[v_base ..], until one is past the tile's last entry
    int staged = 0;
    for (int c = 0; c < kStageSteps; ++c) {
      const int val = c == 0 ? s0 : stage_step(v_base, c);
      stage[c * kKeysThreads + threadIdx.x] = val;
      if (__syncthreads_or(val > last)) {
        staged = (c + 1) * kKeysThreads;
        break;
      }
    }
    // the node of the tile's last entry starts the next tile's stage, whose
    // first step and endpoints load while this tile packs (where the stage
    // does not reach, the offsets in device memory)
    const long long* g = offsets + v_base;
    const int g_hi = (int)(n + 1 - v_base);
    const long long v_next =
        v_base - 1 +
        (staged ? min(warp_first_above<int>(stage, 1, staged, (int)last), staged - 1)
                : min(warp_first_above<long long>(g, 1, g_hi, last), g_hi - 1));
    int4 e_next[2] = {make_int4(0, 0, 0, 0), make_int4(0, 0, 0, 0)};
    int s_next = 0;
    if (t + 1 < te_hi) {
      for (int r = 0; r < 2; ++r)
        e_next[r] = load_run(ends, tlo + kKeysTile + r * kKeysRun + 4 * threadIdx.x, total, vec);
      s_next = stage_step(v_next, 0);
    }
    if (staged)
      pack_tile<kBits, kMode, int>(stage, staged, v_base, tlo, last, e, total, nb, passes,
                                   sources, runs, range, keys, hist, scan);
    else
      pack_tile<kBits, kMode, long long>(g, g_hi, v_base, tlo, last, e, total, nb, passes,
                                         sources, runs, range, keys, hist, scan);
    v_base = v_next;
    e[0] = e_next[0];
    e[1] = e_next[1];
    s0 = s_next;
    __syncthreads();                        // the stage is read before the next tile fills it
  }
  const u64 deep = (u64)(kBuckets - 1) << (2 * nb);   // the dangling keys' bucket
  for (long long t = max(t_lo, Te); t < t_hi; ++t) {
    const long long dlo = (t - Te) * kKeysTile;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const long long c0 = dlo + s * kKeysThreads + warp * 32;
      const long long d = c0 + lane;
      u64 key = 0;
      if (d < nd) {
        const u64 v = (u64)dang[d];
        key = deep | (v << nb) | v;
        if constexpr (kMode == kWrite) keys[total + d] = key;
      }
      if constexpr (kMode != kWrite) {
        const u64 one[1] = {key};
        take_keys<kBits, kMode, 1>(one, d < nd ? 1u : 0u, passes, range, keys, hist, scan);
      } else if constexpr (kBits > 0) {
        count_digits<kBits>(key, (int)max(0LL, min(32LL, nd - c0)), 0, passes, runs, hist);
      }
    }
  }
  if (words > 0) {
    __syncthreads();
    flush_counts(hist, words, totals);
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
      count_digits<kBits>(k[u], (int)min(32LL, len - c), 0, passes, ~0u, sh_hist);
    }
  }
  __syncthreads();
  flush_counts(sh_hist, passes * R, totals);
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
unsigned resident_grid(K kernel, size_t smem, long long work, int threads = kThreads) {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) !=
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

// every pass's digit counts of the keys into totals [passes][2^kBits] (one
// launch of radix_histogram_kernel; the totals zeroed first)
template <int kBits>
cudaError_t count_with(const u64* keys, long long len, int passes, unsigned* totals,
                       cudaStream_t st) {
  const size_t hist_smem = sizeof(unsigned) * passes * (1 << kBits);
  cudaError_t err = cudaMemsetAsync(totals, 0, hist_smem, st);
  if (err != cudaSuccess) return err;
  if ((err = cudaFuncSetAttribute(radix_histogram_kernel<kBits>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)hist_smem)) != cudaSuccess)
    return err;
  radix_histogram_kernel<kBits><<<2 * sm_count(), kHistThreads, hist_smem, st>>>(
      keys, len, passes, totals);
  return cudaGetLastError();
}

// ``counted``: the digit totals K7-keys took (or nullptr: one count launch
// takes them)
template <int kBits>
int sort_with(u64* keys, u64* alt, long long len, int key_bits, unsigned* scratch,
              long long scratch_words, const unsigned* counted, int* passes_done,
              cudaStream_t st) {
  constexpr int R = 1 << kBits;
  constexpr int kMaxPasses = (64 + kBits - 1) / kBits;
  const long long T = tiles(len);
  if (len < 0 || len > (long long)kSortCount || key_bits < 1 || key_bits > 64 ||
      passes_done == nullptr || scratch_words < (long long)kMaxPasses * R + 2 + R * T)
    return (int)cudaErrorInvalidValue;
  *passes_done = 0;
  if (len <= 1) return (int)cudaGetLastError();
  const int passes = (key_bits + kBits - 1) / kBits;
  const unsigned* totals = counted ? counted : scratch;
  unsigned* ticket = scratch + kMaxPasses * R;
  unsigned* status = ticket + 2;
  cudaError_t err;
  if (!counted && (err = count_with<kBits>(keys, len, passes, scratch, st)) != cudaSuccess)
    return (int)err;
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

// One launch of K7-keys' form kMode: ``words`` shared counters (the digit
// counts, or kCount's bins) zeroed in ``totals`` first, and kWindow's
// cursor.
template <int kBits, int kMode>
cudaError_t launch_pack_keys(const int* ends, const long long* offsets, long long n,
                             const long long* dang, long long nd, long long total, int nb,
                             u64* keys, unsigned* totals, int passes, int words,
                             const KeyRange& range, cudaStream_t st) {
  const size_t smem = sizeof(int) * kStageMax + sizeof(unsigned) * words +
                      (kMode == kWindow ? sizeof(unsigned) * (kKeysThreads / 32 + 1) : 0);
  cudaError_t err;
  if (words > 0 && (err = cudaMemsetAsync(totals, 0, sizeof(unsigned) * words, st)) != cudaSuccess)
    return err;
  if (kMode == kWindow &&
      (err = cudaMemsetAsync(range.cursor, 0, sizeof(unsigned), st)) != cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(pack_keys_kernel<kBits, kMode>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
      cudaSuccess)
    return err;
  const long long work = (total + kKeysTile - 1) / kKeysTile + (nd + kKeysTile - 1) / kKeysTile;
  const unsigned grid = resident_grid(pack_keys_kernel<kBits, kMode>, smem, work, kKeysThreads);
  if (grid == 0) return cudaErrorInvalidConfiguration;
  const bool vec = ((uintptr_t)ends & 15) == 0;
  // the passes of source digits alone, then the ones with fewer than 4
  // endpoint bits (runs pay there); the other forms count key by key
  const int sources = kBits > 0 && kMode == kWrite ? nb / kBits : 0;
  unsigned runs = 0;
  for (int p = 0; kBits > 0 && kMode == kWrite && p < passes; ++p) {
    const int ep_bits = min((p + 1) * kBits, 2 * nb) - max(p * kBits, nb);
    if (ep_bits < 4) runs |= 1u << p;
  }
  pack_keys_kernel<kBits, kMode><<<grid, kKeysThreads, smem, st>>>(
      ends, offsets, n, dang, nd, total, nb, vec, passes, sources, runs, range, words, keys,
      totals);
  return cudaGetLastError();
}

// the keys of K7-keys' inputs checked: ids of nb bits, keys of 2 nb + 4
bool keys_inputs_ok(long long n, long long nd, long long total, int nb) {
  return n >= 0 && nd >= 0 && total >= 0 && total < INT_MAX && nb >= 1 && 2 * nb + 4 <= 63;
}

}  // namespace

// K7-keys: keys [total + nd] u64 (16-byte aligned) from ends [total]
// int32 (total < 2^31 - 1), offsets [n + 1] int64 (node v's entries at offsets[v] ..
// offsets[v + 1] - 1, offsets[n] = total) and dang [nd] int64.  With
// ``totals`` (else nullptr and digit_bits 0), each of the ceil((2 nb + 4)
// / digit_bits) K7-sort passes' digit counts over the keys into totals
// [passes][2^digit_bits] u32, zeroed here first.
extern "C" int fora_pack_keys(const int* ends, const long long* offsets, long long n,
                              const long long* dang, long long nd, long long total, int nb,
                              u64* keys, unsigned* totals, int digit_bits, void* stream) {
  if (!keys_inputs_ok(n, nd, total, nb) || ((uintptr_t)keys & 15) != 0 ||
      (totals == nullptr) != (digit_bits == 0))
    return (int)cudaErrorInvalidValue;
  if (total + nd == 0) return (int)cudaGetLastError();
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int passes = digit_bits ? (2 * nb + 4 + digit_bits - 1) / digit_bits : 0;
  const int words = digit_bits ? passes << digit_bits : 0;
  const KeyRange all{0, ~0ull, 0, nullptr, 0};
  cudaError_t err;
  if (digit_bits == 0)
    err = launch_pack_keys<0, kWrite>(ends, offsets, n, dang, nd, total, nb, keys, totals, 0, 0,
                                      all, st);
  else if (digit_bits == 8)
    err = launch_pack_keys<8, kWrite>(ends, offsets, n, dang, nd, total, nb, keys, totals,
                                      passes, words, all, st);
  else if (digit_bits == 9)
    err = launch_pack_keys<9, kWrite>(ends, offsets, n, dang, nd, total, nb, keys, totals,
                                      passes, words, all, st);
  else if (digit_bits == 11)
    err = launch_pack_keys<11, kWrite>(ends, offsets, n, dang, nd, total, nb, keys, totals,
                                       passes, words, all, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

// K7-keys' count form: of the keys fora_pack_keys would write (its inputs
// as there), those k in [lo, hi) counted by bin (k - lo) >> shift into
// bins [ceil((hi - lo) / 2^shift)] u32 (at most 2^14 bins), zeroed here
// first; no key is written.
extern "C" int fora_pack_key_counts(const int* ends, const long long* offsets, long long n,
                                    const long long* dang, long long nd, long long total,
                                    int nb, u64 lo, u64 hi, int shift, unsigned* bins,
                                    void* stream) {
  if (!keys_inputs_ok(n, nd, total, nb) || lo >= hi || hi > (1ull << (2 * nb + 4)) ||
      shift < 0 || shift > 62 || ((hi - lo - 1) >> shift) >= (u64)kCountBins)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int words = (int)((hi - lo - 1) >> shift) + 1;
  if (total + nd == 0) return (int)cudaMemsetAsync(bins, 0, sizeof(unsigned) * words, st);
  const KeyRange range{lo, hi - lo, shift, nullptr, 0};
  return (int)launch_pack_keys<0, kCount>(ends, offsets, n, dang, nd, total, nb, nullptr, bins,
                                          0, words, range, st);
}

// K7-keys' window form: the keys in [lo, hi) of those fora_pack_keys would
// write (its inputs as there) into keys [capacity], compacted, in no order;
// *cursor (u32) ends at their number (a key past capacity is dropped, so
// the caller compares the two).  With ``totals`` (else nullptr and
// digit_bits 0) each K7-sort pass's digit counts over them, as there.
extern "C" int fora_pack_keys_window(const int* ends, const long long* offsets, long long n,
                                     const long long* dang, long long nd, long long total,
                                     int nb, u64 lo, u64 hi, u64* keys, long long capacity,
                                     unsigned* cursor, unsigned* totals, int digit_bits,
                                     void* stream) {
  if (!keys_inputs_ok(n, nd, total, nb) || lo >= hi || hi > (1ull << (2 * nb + 4)) ||
      capacity < 0 || cursor == nullptr || (totals == nullptr) != (digit_bits == 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int passes = digit_bits ? (2 * nb + 4 + digit_bits - 1) / digit_bits : 0;
  const int words = digit_bits ? passes << digit_bits : 0;
  const KeyRange range{lo, hi - lo, 0, cursor, capacity};
  cudaError_t err;
  if (total + nd == 0) {
    if (words > 0 && (err = cudaMemsetAsync(totals, 0, sizeof(unsigned) * words, st)) !=
                         cudaSuccess)
      return (int)err;
    return (int)cudaMemsetAsync(cursor, 0, sizeof(unsigned), st);
  }
  if (digit_bits == 0)
    err = launch_pack_keys<0, kWindow>(ends, offsets, n, dang, nd, total, nb, keys, totals, 0,
                                       0, range, st);
  else if (digit_bits == 8)
    err = launch_pack_keys<8, kWindow>(ends, offsets, n, dang, nd, total, nb, keys, totals,
                                       passes, words, range, st);
  else if (digit_bits == 9)
    err = launch_pack_keys<9, kWindow>(ends, offsets, n, dang, nd, total, nb, keys, totals,
                                       passes, words, range, st);
  else if (digit_bits == 11)
    err = launch_pack_keys<11, kWindow>(ends, offsets, n, dang, nd, total, nb, keys, totals,
                                        passes, words, range, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

// The digit counts K7-sort's count launch takes: each of the ceil(key_bits
// / digit_bits) passes' digit counts over keys [len] into totals
// [passes][2^digit_bits] u32 (zeroed here first): radix_histogram_kernel
// alone, which fora_sort_keys launches where it is handed no counts.
extern "C" int fora_digit_counts(const u64* keys, long long len, int key_bits, int digit_bits,
                                 unsigned* totals, void* stream) {
  if (len < 0 || key_bits < 1 || key_bits > 64) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int passes = digit_bits > 0 ? (key_bits + digit_bits - 1) / digit_bits : 0;
  if (digit_bits == 8) return (int)count_with<8>(keys, len, passes, totals, st);
  if (digit_bits == 9) return (int)count_with<9>(keys, len, passes, totals, st);
  if (digit_bits == 11) return (int)count_with<11>(keys, len, passes, totals, st);
  return (int)cudaErrorInvalidValue;
}


// K7-sort: keys [len] (len < 2^30) sorted ascending over their low
// key_bits bits with digits of digit_bits (8 or 11) bits, in ``keys`` or
// ``alt`` (the same size): *passes_done passes ran, an odd count leaves the
// result in ``alt``.  ``scratch`` holds ceil(64 / digit_bits) R + 2 + R
// ceil(len / 4096) u32 words (R = 2^digit_bits: the totals, the ticket,
// the tiles' status words).  ``counted``: each pass's digit totals of the
// keys, [ceil(key_bits / digit_bits)][R] u32, as fora_pack_keys or
// fora_digit_counts leave them (the count launch is then skipped), or
// nullptr.  Synchronises the stream once, to read the digit totals.
extern "C" int fora_sort_keys(u64* keys, u64* alt, long long len, int key_bits, int digit_bits,
                              unsigned* scratch, long long scratch_words,
                              const unsigned* counted, int* passes_done, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (digit_bits == 8)
    return sort_with<8>(keys, alt, len, key_bits, scratch, scratch_words, counted, passes_done,
                        st);
  if (digit_bits == 9)
    return sort_with<9>(keys, alt, len, key_bits, scratch, scratch_words, counted, passes_done,
                        st);
  if (digit_bits == 11)
    return sort_with<11>(keys, alt, len, key_bits, scratch, scratch_words, counted, passes_done,
                         st);
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
