// Other forms of K4-xp (kernels/csrc/walk.cu), kept only so that
// probes/index_xp_probe.py and chip_smoke.py phase 15 can time them beside
// the package's on the same simulated build; no entry point of the package
// loads them.
//  * fora_index_walk_xp_earlier / fora_index_walk_xp_inbox_earlier: the
//    earlier forms, as they were, run one chunk at a time (a round loop a
//    chunk, walk i of the chunk keyed w0 + i at the chunk's seed).  The
//    own-start form is K4's walk_range with the StagedLeave policy, the
//    inbox form K6+K4-xp's xp_inbox_kernel without the endpoint mass, both
//    at 4 blocks an SM (64 registers), a grid sized by launch (schedule.py::
//    xp_walk_plan's inbox form) and the counts zeroed by a cudaMemsetAsync.
//  * fora_index_walk_xp_form / fora_index_walk_xp_inbox_form: the
//    package's two forms at another residency (`form` blocks an SM: 4, 6
//    or 8), and inbox form 18: at 8 blocks, a claim of at most kWarpStage
//    records at a time, walked to its last before the stage goes out (a
//    call with no walk live, so the kernel keeps to 32 registers), where
//    the package's streams its claims, its drain a call while walks are
//    live, and takes 4 blocks, without the next batch loaded ahead.
#include "../kernels/csrc/walk.cu"

namespace {

namespace earlier {

// K4's walk_range with a Leave policy, as the earlier own-start form ran
// it: walk w draws with key a.w0 + w, and a walk whose next hop starts at
// another process's node leaves, its staged end -1.
template <bool kAlias, bool kHub, bool kSharded, class Leave = NoLeave>
__device__ __forceinline__ void walk_range_leave(const WalkArgs& a, const ShardView& tab,
                                           const Leave& lv = Leave()) {
  extern __shared__ int staged_ends[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint64_t lo64 = ((uint64_t)blockIdx.x * kBlockWarps + warp) * a.range;
  if (lo64 >= a.W) return;  // the last block's spare warps own no walk
  const uint32_t lo = (uint32_t)lo64;
  const uint32_t count = a.W - lo < a.range ? a.W - lo : a.range;  // walks it owns
  int* const ends = staged_ends + warp * a.range;
  const unsigned below = (1u << lane) - 1u;
  const uint32_t key0 = Leave::kXp ? a.w0 : 0u;  // walk w's Philox key: key0 + w
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
          ahead_len = walk_length(a, key0 + lo + batch + lane);
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
    if (!Leave::kXp) {
      if (idle) continue;
      if (hop<kAlias, kHub, kSharded>(a, tab, w, cur, h, len)) {
        ends[w - lo] = cur;
        idle = true;
      }
    } else {  // every lane reaches put(), which groups the leaving lanes
      const bool ending = !idle && hop<kAlias, kHub, kSharded>(a, tab, key0 + w, cur, h, len);
      if (ending) {
        ends[w - lo] = cur;
        idle = true;
      }
      const bool leave = !idle && lv.outside(cur);
      lv.put(leave, cur, key0 + w, h, len, 0.0f, lane);
      if (leave) {
        ends[w - lo] = -1;  // it ends in another process
        idle = true;
      }
    }
  }
  __syncwarp();  // the range's endpoints, coalesced
  for (uint32_t i = lane; i < count; i += 32) a.out[lo + i] = ends[i];
}


constexpr int kBlocksPerSM = 4;

template <bool kAlias>
__global__ void __launch_bounds__(kBlockThreads, kBlocksPerSM)
    index_walk_xp_kernel(const WalkArgs a, const ShardTables t, const XpOut xo) {
  __shared__ const int* indptr[kMaxShards];
  __shared__ const int* indices[kMaxShards];
  __shared__ const float* alias_prob[kMaxShards];
  __shared__ const int* alias_other[kMaxShards];
  __shared__ XpStage stage;
  const int i = threadIdx.x;
  if (i < kMaxShards) {
    indptr[i] = pick(t.indptr, i);
    indices[i] = pick(t.indices, i);
    alias_prob[i] = pick(t.alias_prob, i);
    alias_other[i] = pick(t.alias_other, i);
  }
  const StagedLeave lv = StagedLeave::make(stage, xo);
  __syncthreads();
  walk_range_leave<kAlias, false, true, StagedLeave>(
      a, ShardView{indptr, indices, alias_prob, alias_other}, lv);
  lv.drain();
}

int index_xp_args(XpLaunch* X, const int* start, long long W, long long w0, int* ends, int L,
                  int n_loc, int shard0, int G, int P, int* outbox, long long cap, int* counts,
                  const int* const* indptr, const int* const* indices,
                  const float* const* alias_prob, const int* const* alias_other,
                  unsigned long long seed, float inv_log1m_alpha, int max_hops,
                  int walks_per_lane, long long blocks, void* stream) {
  const int bad = xp_args(X, L, G, P, shard0, n_loc, 1, nullptr, 0, ends, outbox, cap, counts,
                          indptr, indices, alias_prob, alias_other, seed, walks_per_lane, blocks,
                          stream);
  if (bad) return bad;
  if (W < 0 || w0 < 0 || w0 + W >= (1ll << 32) || max_hops > kMaxXpHops || ends == nullptr ||
      (W > 0 && start == nullptr))
    return (int)cudaErrorInvalidValue;
  WalkArgs a;
  const int bad_walk = walk_args(&a, start, ends + w0, W, seed, inv_log1m_alpha, max_hops,
                                 walks_per_lane, blocks);
  if (bad_walk) return bad_walk;
  a.n_loc = n_loc;
  a.w0 = (uint32_t)w0;
  X->a = a;
  return 0;
}

}  // namespace earlier

// The inbox form taking a claim at a time: a warp claims 32 k records (at
// most kWarpStage) with one atomicAdd on the cursor, walks them to their
// last through walk_range's queue, sends its stage out (a call with no
// walk live), and claims again until the inbox is claimed.
template <bool kAlias>
__device__ __forceinline__ void index_xp_claims_range(const WalkArgs& a, const IndexXpArgs& xa,
                                                     const ShardView& tab, const XpOut& xo,
                                                     int4* stage) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const uint32_t warps = gridDim.x * kBlockWarps;
  int4* const out = stage + (threadIdx.x >> 5) * kWarpStage;
  for (;;) {
    uint32_t r0 = 0, step = 0;  // the claim: records r0 .. r0 + count - 1
    if (lane == 0) {
      step = inbox_claim(*(volatile unsigned*)xa.cursor, xa, warps);
      r0 = atomicAdd(xa.cursor, step);
    }
    r0 = __shfl_sync(kFull, r0, 0);
    step = __shfl_sync(kFull, step, 0);
    if (r0 >= xa.n_in) return;
    const uint32_t count = min(step, xa.n_in - r0);
    uint32_t batch = 0, filled = 0, used = 0;
    int4 ahead = make_int4(0, 0, 0, 0);  // lane i: record r0 + batch + i
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
          if (batch >= count) break;
          filled = min(32u, count - batch);
          if ((uint32_t)lane < filled) ahead = __ldg(xa.inbox + r0 + batch + lane);
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
    }
    drain_stage(out, n_out, xo);
  }
}

constexpr int kClaimsBlocksPerSM = 8;

template <bool kAlias>
__global__ void __launch_bounds__(kBlockThreads, kClaimsBlocksPerSM)
    index_xp_claims_kernel(const WalkArgs a, const IndexXpArgs xa, const ShardTables t,
                           const XpOut xo) {
  INDEX_XP_PROLOGUE;
  index_xp_claims_range<kAlias>(a, xa, tab, xo, stage);
}

}  // namespace

// the earlier own-start form: round 0 of one chunk, the W own starts walks
// w0 .. w0 + W - 1 of the chunk's ends [W_chunk] at the chunk's seed
// (fora_index_walk_xp's arguments as they were)
extern "C" int fora_index_walk_xp_earlier(const int* start, long long W, long long w0, int* ends,
                                          int L, int n_loc, int shard0, int G, int P,
                                          int* outbox, long long cap, int* counts,
                                          const int* const* indptr, const int* const* indices,
                                          const float* const* alias_prob,
                                          const int* const* alias_other, unsigned long long seed,
                                          float inv_log1m_alpha, int max_hops,
                                          int walks_per_lane, long long blocks, void* stream) {
  XpLaunch X;
  const int bad = earlier::index_xp_args(&X, start, W, w0, ends, L, n_loc, shard0, G, P, outbox,
                                         cap, counts, indptr, indices, alias_prob, alias_other,
                                         seed, inv_log1m_alpha, max_hops, walks_per_lane,
                                         blocks, stream);
  if (bad) return bad;
  cudaMemsetAsync(counts, 0, sizeof(int) * P, X.s);
  if (W > 0) {
    const size_t smem = (size_t)kBlockWarps * X.a.range * sizeof(int);
    if (X.alias)
      earlier::index_walk_xp_kernel<true><<<X.blocks, kBlockThreads, smem, X.s>>>(X.a, X.t, X.xo);
    else
      earlier::index_walk_xp_kernel<false><<<X.blocks, kBlockThreads, smem, X.s>>>(X.a, X.t,
                                                                                   X.xo);
  }
  return (int)cudaGetLastError();
}

// the earlier inbox form: a later round of one chunk, the records' w the
// chunk's, their ends at ends[w] (fora_index_walk_xp_inbox's arguments as
// they were)
extern "C" int fora_index_walk_xp_inbox_earlier(const int* inbox, long long n_in, int* ends,
                                                int n_loc, int shard0, int L, int G, int P,
                                                int* outbox, long long cap, int* counts,
                                                const int* const* indptr,
                                                const int* const* indices,
                                                const float* const* alias_prob,
                                                const int* const* alias_other,
                                                unsigned long long seed, int walks_per_lane,
                                                long long blocks, void* stream) {
  if (ends == nullptr) return (int)cudaErrorInvalidValue;
  XpLaunch X;
  const int bad = xp_inbox_args(&X, inbox, n_in, 1, n_loc, shard0, L, G, P, nullptr, 0, ends,
                                outbox, cap, counts, indptr, indices, alias_prob, alias_other,
                                seed, walks_per_lane, blocks, stream);
  if (bad) return bad;
  cudaMemsetAsync(counts, 0, sizeof(int) * P, X.s);
  if (X.blocks) launch_xp_inbox<earlier::kBlocksPerSM, StagedLeave, false>(X);
  return (int)cudaGetLastError();
}

// the package's own-start form at `blocks` an SM (4, 6 or 8), after the
// form number: fora_index_walk_xp's arguments
extern "C" int fora_index_walk_xp_form(int form, const int* start, long long W, long long w0,
                                       int* ends, long long wlo, long long n_ends,
                                       long long chunk_lanes, unsigned long long magic,
                                       int shift, int L, int n_loc, int shard0,
                                       int G, int P, int* outbox, long long cap, int* counts,
                                       const int* const* indptr, const int* const* indices,
                                       const float* const* alias_prob,
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
  if (W > 0) {
    if (form == 4)
      launch_index_xp_own<4>(X, xa);
    else if (form == 6)
      launch_index_xp_own<6>(X, xa);
    else if (form == 8)
      launch_index_xp_own<8>(X, xa);
    else
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// the package's inbox form at `blocks` an SM (4, 6 or 8), after the form
// number: fora_index_walk_xp_inbox's arguments
extern "C" int fora_index_walk_xp_inbox_form(int form, const int* inbox, long long n_in,
                                             int* ends, long long wlo, long long n_ends,
                                             long long chunk_lanes, unsigned long long magic,
                                             int shift, int n_loc, int shard0, int L, int G,
                                             int P, int* outbox, long long cap,
                                             int* counts, const int* const* indptr,
                                             const int* const* indices,
                                             const float* const* alias_prob,
                                             const int* const* alias_other,
                                             unsigned long long seed, int walks_per_lane,
                                             long long blocks, void* stream) {
  XpLaunch X;
  IndexXpArgs xa;
  if (form == 18 && 32 * walks_per_lane > kWarpStage) return (int)cudaErrorInvalidValue;
  const int bad = index_xp_inbox_args(&X, &xa, inbox, n_in, ends, wlo, n_ends, chunk_lanes,
                                      magic, shift, n_loc, shard0, L, G, P, outbox, cap, counts,
                                      indptr, indices, alias_prob, alias_other, seed,
                                      walks_per_lane, blocks, stream);
  if (bad) return bad;
  if (X.blocks) {
    if (form == 4)
      launch_index_xp_inbox<4>(X, xa);
    else if (form == 6)
      launch_index_xp_inbox<6>(X, xa);
    else if (form == 8)
      launch_index_xp_inbox<8>(X, xa);
    else if (form == 18 && X.alias)
      index_xp_claims_kernel<true><<<X.blocks, kBlockThreads, 0, X.s>>>(X.a, xa, X.t, X.xo);
    else if (form == 18)
      index_xp_claims_kernel<false><<<X.blocks, kBlockThreads, 0, X.s>>>(X.a, xa, X.t, X.xo);
    else
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
