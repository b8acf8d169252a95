// Other forms of K6+K4-xp (kernels/csrc/walk.cu), kept only so that
// probes/xp_walk_probe.py and chip_smoke.py phase 17 can time them beside
// the package's on the same chunk; no entry point of the package loads them.
//  * fora_raw_walk_xp_earlier: the earlier kernel, as it was.  One launch takes
//    both sources of walks (own lanes and an inbox of 16-byte records (w,
//    cur, h, weight bits), so a refill recomputes the walk's length: a
//    Philox block 0 and a logf), 56 registers at 4 blocks an SM, the walks
//    of no hop added alone, and every leaving group's slot from one global
//    atomic on its destination's count.  Its plan is
//    xp_walk_probe.py::earlier_plan.
//  * fora_raw_walk_xp_form / fora_raw_walk_xp_inbox_form: the package's two
//    forms with one choice changed (form numbers as they take them):
//      1 direct: no stage, the earlier per-group global atomic on the
//        destination's count instead (the outbox's atomics, measured);
//      2, 3: the staged form at other launch bounds (own-lane form: 6 and 5
//        blocks an SM; inbox form: 8 and 6).
#include "../kernels/csrc/walk.cu"

namespace {

namespace earlier {

// blocks an SM in __launch_bounds__: the two sources of walks and the
// outbox take more registers than K6+K4's 40 (56 on the H100)
constexpr int kXpBlocksPerSM = 4;

struct XpArgs {
  const long long* bounds;  // [L + 1, Bc] this process's rows of the chunk's running totals
  const int4* inbox;        // [n_in] walks handed over: (w, cur, h, weight bits)
  int4* outbox;             // [P, cap] walks that leave, by destination process
  int* counts;              // [P] records written per destination (may pass cap: a fault)
  int* ends;                // [rows, Bc] endpoints of the walks that end here, or null
  float* out;               // [n_pad, Bc] this process's partial (row stride out_ld)
  long long r_ld, cum_ld, out_ld, lane_lo, n_in, cap;
  uint32_t rows;            // lane rows of the chunk: lanes lane_lo .. + rows - 1
  uint32_t tiles;           // warp tiles of a column's own lanes
  int Bc, n, L, shard0, rank, proc_rows;  // proc_rows = L * n_loc
};

// A warp's tile: a column's own lanes (tile < tiles * Bc: column tile /
// tiles, from the column's first own lane in the chunk) or inbox records
// (range of them a warp).  walk_range's queue; the lookahead lane searches
// an own lane's start and weight as raw_walk_range does, or reads a record.
template <bool kAlias>
__device__ __forceinline__ void xp_walk_range(const WalkArgs& a, const XpArgs& xa,
                                              const ShardView& tab, const RawView& rv) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint64_t tile = (uint64_t)blockIdx.x * kBlockWarps + warp;
  const uint64_t own_tiles = (uint64_t)xa.tiles * (uint64_t)xa.Bc;
  const bool from_inbox = tile >= own_tiles;
  const unsigned below = (1u << lane) - 1u;
  int b = 0, base_v = 0, base_h = 0;
  uint32_t t0 = 0, count = 0;
  long long r0 = 0;
  if (!from_inbox) {
    b = (int)(tile / xa.tiles);
    const long long first = max(__ldg(xa.bounds + b), xa.lane_lo);
    const long long last = min(__ldg(xa.bounds + (long long)xa.L * xa.Bc + b),
                               xa.lane_lo + (long long)xa.rows);
    const long long l0 = first + (long long)(tile - (uint64_t)b * xa.tiles) * a.range;
    if (l0 >= last) return;
    t0 = (uint32_t)(l0 - xa.lane_lo);
    count = (uint32_t)min((long long)a.range, last - l0);
    while (__ldg(xa.bounds + (long long)(base_h + 1) * xa.Bc + b) <= l0) ++base_h;
    const int* col0 = rv.cum[base_h] + (long long)b * xa.cum_ld;
    base_v = warp_upper_bound(col0, xa.n,
                              (int)(l0 - __ldg(xa.bounds + (long long)base_h * xa.Bc + b)), lane);
  } else {
    r0 = (long long)(tile - own_tiles) * a.range;
    if (r0 >= xa.n_in) return;
    count = (uint32_t)min((long long)a.range, xa.n_in - r0);
  }
  uint32_t batch = 0, filled = 0, used = 0;
  uint32_t ahead_w = 0;
  int ahead_start = 0, ahead_len = 0, ahead_h = 0;
  float ahead_wt = 0.0f;
  uint32_t w = 0;  // this lane's walk: its Philox key, node, hops, length, weight
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
        if (!from_inbox) {
          int v = base_v, sh = base_h;
          if ((uint32_t)lane < filled) {
            const uint32_t t = t0 + batch + lane;
            const long long l = xa.lane_lo + t;
            while (__ldg(xa.bounds + (long long)(sh + 1) * xa.Bc + b) <= l) ++sh;
            const int x = (int)(l - __ldg(xa.bounds + (long long)sh * xa.Bc + b));
            const int* col = rv.cum[sh] + (long long)b * xa.cum_ld;
            v = sh == base_h ? gallop(col, xa.n, base_v, x) : upper_bound(col, xa.n, x);
            const int om = __ldg(col + v) - (v > 0 ? __ldg(col + v - 1) : 0);
            ahead_wt = __ldg(rv.r[sh] + (long long)v * xa.r_ld + b) / (float)om;
            ahead_start = v + (xa.shard0 + sh) * a.n_loc;
            ahead_w = t * (uint32_t)xa.Bc + (uint32_t)b;
            ahead_len = walk_length(a, ahead_w);
            ahead_h = 0;
          }
          base_v = __shfl_sync(kFull, v, filled - 1);
          base_h = __shfl_sync(kFull, sh, filled - 1);
        } else if ((uint32_t)lane < filled) {
          const int4 rec = xa.inbox[r0 + batch + lane];
          ahead_w = (uint32_t)rec.x;
          ahead_start = rec.y;
          ahead_h = rec.z;
          ahead_wt = __int_as_float(rec.w);
          ahead_len = walk_length(a, ahead_w);
        }
      }
      const uint32_t src = used + __popc(need & below);
      const uint32_t take_w = __shfl_sync(kFull, ahead_w, src & 31);
      const int take_start = __shfl_sync(kFull, ahead_start, src & 31);
      const int take_len = __shfl_sync(kFull, ahead_len, src & 31);
      const int take_h = __shfl_sync(kFull, ahead_h, src & 31);
      const float take_wt = __shfl_sync(kFull, ahead_wt, src & 31);
      if (idle && src < filled) {
        w = take_w;
        cur = take_start;
        len = take_len;
        h = take_h;
        wt = take_wt;
        if (h < len) {
          idle = false;
        } else {  // no hop left: the walk ends where it is
          if (xa.ends != nullptr) xa.ends[w] = cur;
          if (wt != 0.0f) atomicAdd(xa.out + (long long)cur * xa.out_ld + w % (uint32_t)xa.Bc, wt);
        }
      }
      used = min(filled, used + __popc(need));
    }
    if (__all_sync(kFull, idle)) break;
    bool ended = false, leave = false;
    if (!idle) {
      ended = hop<kAlias, false, true>(a, tab, w, cur, h, len);
      leave = !ended && cur / xa.proc_rows != xa.rank;
    }
    if (ended) {
      if (xa.ends != nullptr) xa.ends[w] = cur;
      if (wt != 0.0f) atomicAdd(xa.out + (long long)cur * xa.out_ld + w % (uint32_t)xa.Bc, wt);
    }
    const unsigned leaving = __ballot_sync(kFull, leave);
    if (leave) {  // one slot counter a destination, one atomic per group
      const int dest = cur / xa.proc_rows;
      const unsigned peers = __match_any_sync(leaving, dest);
      const int leader = __ffs(peers) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(xa.counts + dest, __popc(peers));
      base = __shfl_sync(peers, base, leader);
      const long long slot = (long long)base + __popc(peers & below);
      if (slot < xa.cap)
        xa.outbox[(long long)dest * xa.cap + slot] = make_int4((int)w, cur, h, __float_as_int(wt));
    }
    if (ended || leave) idle = true;
  }
}

template <bool kAlias>
__global__ void __launch_bounds__(kBlockThreads, kXpBlocksPerSM)
    xp_walk_kernel(const WalkArgs a, const XpArgs xa, const ShardTables t, const RawTables rt) {
  __shared__ const int* indptr[kMaxShards];
  __shared__ const int* indices[kMaxShards];
  __shared__ const float* alias_prob[kMaxShards];
  __shared__ const int* alias_other[kMaxShards];
  __shared__ const float* res[kMaxShards];
  __shared__ const int* cum[kMaxShards];
  const int i = threadIdx.x;
  if (i < kMaxShards) {  // by constant indices: see the sharded form above
    indptr[i] = pick(t.indptr, i);
    indices[i] = pick(t.indices, i);
    alias_prob[i] = pick(t.alias_prob, i);
    alias_other[i] = pick(t.alias_other, i);
    res[i] = pick(rt.r, i);
    cum[i] = pick(rt.cum, i);
  }
  __syncthreads();
  xp_walk_range<kAlias>(a, xa, ShardView{indptr, indices, alias_prob, alias_other},
                        RawView{res, cum, nullptr});
}

}  // namespace earlier

// The earlier outbox: each warp's lanes that leave to one destination take
// their slots with one global atomic on its count, and write their records
// where they are
struct DirectLeave {
  static constexpr bool kXp = true;
  struct Shared {
    int unused;
  };
  XpOut xo;

  static __device__ __forceinline__ DirectLeave make(Shared&, const XpOut& xo) {
    return DirectLeave{xo};
  }

  __device__ __forceinline__ bool outside(int cur) const {
    return (unsigned)(cur - xo.lo) >= (unsigned)xo.rows;
  }

  __device__ __forceinline__ void put(bool leave, int cur, uint32_t w, int h, int len, float wt,
                                      int lane) const {
    const unsigned leaving = __ballot_sync(kFull, leave);
    if (!leave) return;
    const int dest = cur / xo.rows;
    const unsigned peers = __match_any_sync(leaving, dest);
    const int leader = __ffs(peers) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(xo.counts + dest, __popc(peers));
    base = __shfl_sync(peers, base, leader);
    const long long slot = (long long)base + __popc(peers & ((1u << lane) - 1u));
    if (slot < xo.cap)
      xo.outbox[(long long)dest * xo.cap + slot] =
          make_int4((int)w, cur, h | (len << 16), __float_as_int(wt));
  }

  __device__ __forceinline__ void drain() const {}
};

int launch_own_form(int form, const XpLaunch& X) {
  switch (form) {
    case 1:
      launch_xp_own<kXpOwnBlocksPerSM, DirectLeave>(X);
      break;
    case 2:
      launch_xp_own<6, StagedLeave>(X);
      break;
    case 3:
      launch_xp_own<5, StagedLeave>(X);
      break;

    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int launch_inbox_form(int form, const XpLaunch& X) {
  switch (form) {
    case 1:
      launch_xp_inbox<kXpInboxBlocksPerSM, DirectLeave>(X);
      break;
    case 2:
      launch_xp_inbox<8, StagedLeave>(X);
      break;
    case 3:
      launch_xp_inbox<6, StagedLeave>(X);
      break;

    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// K6+K4-xp: one launch of a chunk of the raw walk phase in process `rank` =
// shard0 / L of P, which holds shards shard0 .. shard0 + L - 1 of G = P L
// (1 <= G <= 32): their residues r[k], demands cum[k] (as fora_raw_walk's)
// and out-CSR slices indptr[k] / indices[k] (and alias_prob[k] /
// alias_other[k], or both null), and bounds [L + 1, Bc], this process's
// rows of the chunk's running totals (lane l of column b is shard shard0 +
// k's where bounds[k, b] <= l < bounds[k + 1, b]).  Its own lanes in lane_lo
// .. lane_lo + rows - 1 walk as fora_raw_walk's sharded form walks them (walk
// t * Bc + b), then the n_in records of `inbox` [n_in, 4] int32 (w, cur, h,
// weight bits) from where they stopped.  A walk that ends adds its weight
// into out [G * n_loc, Bc] (row stride out_ld) at its endpoint, column w %
// Bc, and writes ends[w] unless ends is null; a walk whose node leaves the
// process's rows before its last hop goes to outbox [P, cap, 4] int32 at
// destination cur / (L n_loc), counts[d] (zeroed here by a
// cudaMemsetAsync) counting them; a count past cap means records were not
// written.  The plan (xp_walk_probe.py::earlier_plan): `tiles` warp tiles
// of 32 * walks_per_lane own lanes per column, then ceil(n_in / (32 *
// walks_per_lane)) tiles of records, `blocks` blocks of 8 warps covering
// them.
extern "C" int fora_raw_walk_xp_earlier(const float* const* r, long long r_ld,
                                const int* const* cum, long long cum_ld, const long long* bounds, int L, long long n,
                                int Bc, long long rows, long long lane_lo, int n_loc, int shard0,
                                int G, int P, float* out, long long out_ld, int* ends,
                                const int* inbox, long long n_in, int* outbox, long long cap,
                                int* counts, const int* const* indptr, const int* const* indices,
                                const float* const* alias_prob, const int* const* alias_other,
                                unsigned long long seed, float inv_log1m_alpha, int max_hops,
                                int walks_per_lane, long long tiles, long long blocks,
                                void* stream) {
  if ((alias_prob == nullptr) != (alias_other == nullptr)) return (int)cudaErrorInvalidValue;
  if (L < 1 || P < 1 || G != P * L || G > kMaxShards || shard0 < 0 || shard0 % L ||
      shard0 + L > G || n_loc < 1 || n <= 0 || n > n_loc || Bc < 0 || rows < 0 || lane_lo < 0 ||
      n_in < 0 || cap < 0 || (long long)G * n_loc >= 0x7fffffffll || rows * (long long)Bc >= (1ll << 32) ||
      max_hops < 0 || walks_per_lane < 1 || walks_per_lane > kMaxWalksPerLane || tiles < 0 ||
      blocks < 0 || blocks > 0x7fffffffll || r == nullptr || cum == nullptr || bounds == nullptr ||
      out == nullptr || (cap > 0 && outbox == nullptr) || counts == nullptr || indptr == nullptr ||
      indices == nullptr || (n_in > 0 && inbox == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long range = 32ll * walks_per_lane;
  const long long in_tiles = (n_in + range - 1) / range;
  if (tiles * (long long)Bc + in_tiles > blocks * kBlockWarps)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaMemsetAsync(counts, 0, sizeof(int) * P, s);
  if (blocks == 0) return (int)cudaGetLastError();
  const bool alias = alias_prob != nullptr;
  ShardTables t = {};
  RawTables rt = {};
  for (int k = 0; k < L; ++k) {
    if (r[k] == nullptr || cum[k] == nullptr || indptr[k] == nullptr || indices[k] == nullptr ||
        (alias && (alias_prob[k] == nullptr || alias_other[k] == nullptr)))
      return (int)cudaErrorInvalidValue;
    rt.r[k] = r[k];
    rt.cum[k] = cum[k];
    t.indptr[shard0 + k] = indptr[k];
    t.indices[shard0 + k] = indices[k];
    if (alias) {
      t.alias_prob[shard0 + k] = alias_prob[k];
      t.alias_other[shard0 + k] = alias_other[k];
    }
  }
  WalkArgs a = {};
  a.range = (uint32_t)range;
  a.seed_lo = (uint32_t)(seed & 0xffffffffull);
  a.seed_hi = (uint32_t)(seed >> 32);
  a.inv_log1m_alpha = inv_log1m_alpha;
  a.max_hops = max_hops;
  a.n_loc = n_loc;
  earlier::XpArgs xa = {};
  xa.bounds = bounds;
  xa.inbox = reinterpret_cast<const int4*>(inbox);
  xa.outbox = reinterpret_cast<int4*>(outbox);
  xa.counts = counts;
  xa.ends = ends;
  xa.out = out;
  xa.r_ld = r_ld;
  xa.cum_ld = cum_ld;
  xa.out_ld = out_ld;
  xa.lane_lo = lane_lo;
  xa.n_in = n_in;
  xa.cap = cap;
  xa.rows = (uint32_t)rows;
  xa.tiles = (uint32_t)tiles;
  xa.Bc = Bc;
  xa.n = (int)n;
  xa.L = L;
  xa.shard0 = shard0;
  xa.rank = shard0 / L;
  xa.proc_rows = L * n_loc;
  if (alias)
    earlier::xp_walk_kernel<true><<<(unsigned)blocks, kBlockThreads, 0, s>>>(a, xa, t, rt);
  else
    earlier::xp_walk_kernel<false><<<(unsigned)blocks, kBlockThreads, 0, s>>>(a, xa, t, rt);
  return (int)cudaGetLastError();
}

// fora_raw_walk_xp's arguments after the form (1-3, as above)
extern "C" int fora_raw_walk_xp_form(int form, const float* const* r, long long r_ld,
                                     const int* const* cum, long long cum_ld,
                                     const long long* bounds, int L, long long n, int Bc,
                                     long long rows, long long lane_lo, int n_loc, int shard0,
                                     int G, int P, float* out, long long out_ld, int* ends,
                                     int* outbox, long long cap, int* counts,
                                     const int* const* indptr, const int* const* indices,
                                     const float* const* alias_prob,
                                     const int* const* alias_other, unsigned long long seed,
                                     float inv_log1m_alpha, int max_hops, int walks_per_lane,
                                     long long tiles, long long blocks, void* stream) {
  if (form < 1 || form > 3) return (int)cudaErrorInvalidValue;
  XpLaunch X;
  const int bad = xp_own_args(&X, r, r_ld, cum, cum_ld, bounds, L, n, Bc, rows, lane_lo, n_loc,
                              shard0, G, P, out, out_ld, ends, outbox, cap, counts, indptr,
                              indices, alias_prob, alias_other, seed, inv_log1m_alpha, max_hops,
                              walks_per_lane, tiles, blocks, stream);
  if (bad) return bad;
  cudaMemsetAsync(counts, 0, sizeof(int) * P, X.s);
  return X.blocks ? launch_own_form(form, X) : (int)cudaGetLastError();
}

// fora_raw_walk_xp_inbox's arguments after the form (1-3, as above)
extern "C" int fora_raw_walk_xp_inbox_form(int form, const int* inbox, long long n_in, int Bc,
                                           int n_loc, int shard0, int L, int G, int P,
                                           float* out, long long out_ld, int* ends, int* outbox,
                                           long long cap, int* counts, const int* const* indptr,
                                           const int* const* indices,
                                           const float* const* alias_prob,
                                           const int* const* alias_other,
                                           unsigned long long seed, int walks_per_lane,
                                           long long blocks, void* stream) {
  if (form < 1 || form > 3) return (int)cudaErrorInvalidValue;
  XpLaunch X;
  const int bad = xp_inbox_args(&X, inbox, n_in, Bc, n_loc, shard0, L, G, P, out, out_ld, ends,
                                outbox, cap, counts, indptr, indices, alias_prob, alias_other,
                                seed, walks_per_lane, blocks, stream);
  if (bad) return bad;
  cudaMemsetAsync(counts, 0, sizeof(int) * P, X.s);
  return X.blocks ? launch_inbox_form(form, X) : (int)cudaGetLastError();
}
