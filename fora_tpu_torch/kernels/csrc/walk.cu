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

__device__ __forceinline__ float unit(uint32_t x) {  // [0, 1)
  return (float)(x >> 8) * kTwoM24;
}

// hops of walk w: min(floor(log(u0) / log(1 - alpha)), max_hops), u0 in (0, 1]
__device__ __forceinline__ int walk_length(const WalkArgs& a, uint32_t w) {
  const uint4 r0 = philox4x32_10(make_uint4(0u, a.seed_hi, 0u, 0u), make_uint2(a.seed_lo, w));
  const float u0 = (float)((r0.x >> 8) + 1u) * kTwoM24;
  return (int)fminf(floorf(logf(u0) * a.inv_log1m_alpha), (float)a.max_hops);
}

// the pool entry that a walk arriving at hub `hid` ends at
__device__ __forceinline__ int pool_entry(const WalkArgs& a, int hid, float u3) {
  const int j = min((int)(u3 * (float)a.pool_size), a.pool_size - 1);
  return __ldg(a.pool + (long long)hid * a.pool_size + j);
}

// the walks of this warp's range: the body of both kernels
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
    // one hop of this lane's walk: the degree from the row pointers, two
    // loads issued together, and the hop's Philox block while they are in
    // flight; the sharded form reads the owner's slice
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
    const uint4 r = philox4x32_10(make_uint4((uint32_t)(h + 1), a.seed_hi, 0u, 0u),
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
    if (done) {
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
