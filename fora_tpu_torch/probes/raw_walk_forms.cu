// Other forms of K6+K4 (kernels/csrc/walk.cu, raw_walk_kernel), kept only so
// that probes/raw_walk_probe.py can time them beside the package's on the
// same chunk; no entry point of the package loads them.  Each differs from
// the package's in one choice (form numbers as fora_raw_walk_form takes them):
//   1 lane_search: a tile's first lane bisected by each lane alone (19
//     dependent probes at 2^19 nodes), not by the warp's 32 probes a step;
//   2 blocks4, 3 blocks8: 4 or 8 blocks an SM in __launch_bounds__ (at most
//     64 or 32 registers), not 6;
//   4 group_every: every step's ending walks grouped by endpoint, not only
//     the refill's (the walks of no hop);
//   5 group_none: a RED a walk, none grouped.
// form_range is raw_walk_range with those two choices as template
// arguments; the probe holds every form's endpoints bit-equal to the
// package's.
#include "../kernels/csrc/walk.cu"

namespace {

// kGroup: 0 no walk grouped, 1 the refill's, 2 every step's
template <bool kAlias, bool kSharded, bool kWarpSearch, int kGroup>
__device__ __forceinline__ void form_range(const WalkArgs& a, const RawArgs& ra,
                                           const ShardView& tab, const RawView& rv) {
  __shared__ float s_add[kBlockWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint64_t tile = (uint64_t)blockIdx.x * kBlockWarps + warp;
  if (tile >= (uint64_t)ra.tiles * (uint64_t)ra.Bc) return;
  const int b = (int)(tile / ra.tiles);
  const uint32_t t0 = (uint32_t)(tile - (uint64_t)b * ra.tiles) * a.range;
  // the column's walks: lanes below total[b], or bounds[G, b] sharded
  const long long col_total =
      kSharded ? __ldg(ra.bounds + (long long)ra.G * ra.Bc + b) : (long long)__ldg(ra.total + b);
  const long long avail = col_total - ra.lane_lo - (long long)t0;
  if (avail <= 0) return;
  uint32_t count = min(a.range, ra.rows - t0);
  if (avail < (long long)count) count = (uint32_t)avail;
  float* const adds = s_add[warp];
  const unsigned below = (1u << lane) - 1u;
  // the search base, the same in every lane: the node (and shard) of the
  // last lane handed to the lookahead; the tile's first lane is searched in
  // full (kWarpSearch: by the whole warp; else by each lane alone), and
  // every later lane of the column lies at or past it
  int base_h = 0;
  const long long l0 = ra.lane_lo + t0;
  if (kSharded) {
    while (__ldg(ra.bounds + (long long)(base_h + 1) * ra.Bc + b) <= l0) ++base_h;
  }
  const int* col0 = rv.cum[base_h] + (long long)b * ra.cum_ld;
  const int x0 =
      (int)(l0 - (kSharded ? __ldg(ra.bounds + (long long)base_h * ra.Bc + b) : 0ll));
  int base_v = kWarpSearch ? warp_upper_bound(col0, ra.n, x0, lane) : upper_bound(col0, ra.n, x0);
  uint32_t batch = 0, filled = 0, used = 0;
  int ahead_start = 0, ahead_len = 0, ahead_h = 0;
  float ahead_w = 0.0f;
  uint32_t w = 0;  // this lane's walk: its Philox key t * Bc + b, node, hops, length
  int cur = 0, h = 0, len = 0, shard = 0;
  float wt = 0.0f;  // its weight, r[v, b] / omega_v
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
        int v = base_v, sh = base_h;
        if ((uint32_t)lane < filled) {
          const uint32_t t = t0 + batch + lane;
          const long long l = ra.lane_lo + t;
          long long first = 0;  // the lane's shard's first lane
          if (kSharded) {
            while (__ldg(ra.bounds + (long long)(sh + 1) * ra.Bc + b) <= l) ++sh;
            first = __ldg(ra.bounds + (long long)sh * ra.Bc + b);
          }
          const int x = (int)(l - first);
          const int* col = rv.cum[sh] + (long long)b * ra.cum_ld;
          v = sh == base_h ? gallop(col, ra.n, base_v, x) : upper_bound(col, ra.n, x);
          const int om = __ldg(col + v) - (v > 0 ? __ldg(col + v - 1) : 0);
          ahead_w = __ldg(rv.r[sh] + (long long)v * ra.r_ld + b) / (float)om;
          ahead_start = kSharded ? v + sh * a.n_loc : v;
          ahead_len = walk_length(a, t * (uint32_t)ra.Bc + (uint32_t)b);
          ahead_h = sh;
        }
        base_v = __shfl_sync(kFull, v, filled - 1);
        if (kSharded) base_h = __shfl_sync(kFull, sh, filled - 1);
      }
      const uint32_t src = used + __popc(need & below);
      const int take_start = __shfl_sync(kFull, ahead_start, src & 31);
      const int take_len = __shfl_sync(kFull, ahead_len, src & 31);
      const float take_w = __shfl_sync(kFull, ahead_w, src & 31);
      const int take_h = kSharded ? __shfl_sync(kFull, ahead_h, src & 31) : 0;
      bool ending = false;
      if (idle && src < filled) {
        w = (t0 + batch + src) * (uint32_t)ra.Bc + (uint32_t)b;
        cur = take_start;
        len = take_len;
        wt = take_w;
        shard = take_h;
        h = 0;
        if (len > 0)
          idle = false;
        else
          ending = true;  // no hop: the walk ends where it starts
      }
      if (kGroup >= 1)
        add_grouped<kSharded>(ending, cur, shard, wt, w, b, ra, rv, adds, lane);
      else
        add_alone<kSharded>(ending, cur, shard, wt, w, b, ra, rv);
      used = min(filled, used + __popc(need));
    }
    if (__all_sync(kFull, idle)) break;
    const bool ending = !idle && hop<kAlias, false, kSharded>(a, tab, w, cur, h, len);
    if (kGroup == 2)
      add_grouped<kSharded>(ending, cur, shard, wt, w, b, ra, rv, adds, lane);
    else
      add_alone<kSharded>(ending, cur, shard, wt, w, b, ra, rv);
    if (ending) idle = true;
  }
}

template <bool kAlias, bool kSharded, bool kWarpSearch, int kGroup, int kBlocks>
__global__ void __launch_bounds__(kBlockThreads, kBlocks)
    form_kernel(const WalkArgs a, const RawArgs ra, const ShardTables t,
                    const RawTables rt) {
  __shared__ const int* indptr[kMaxShards];
  __shared__ const int* indices[kMaxShards];
  __shared__ const float* alias_prob[kMaxShards];
  __shared__ const int* alias_other[kMaxShards];
  __shared__ const float* res[kMaxShards];
  __shared__ const int* cum[kMaxShards];
  __shared__ float* out[kMaxShards];
  const int i = threadIdx.x;
  if (i < kMaxShards) {  // by constant indices: see the sharded form above
    if (kSharded) {
      indptr[i] = pick(t.indptr, i);
      indices[i] = pick(t.indices, i);
      alias_prob[i] = pick(t.alias_prob, i);
      alias_other[i] = pick(t.alias_other, i);
    }
    res[i] = pick(rt.r, i);
    cum[i] = pick(rt.cum, i);
    out[i] = pick(rt.out, i);
  }
  __syncthreads();
  form_range<kAlias, kSharded, kWarpSearch, kGroup>(
      a, ra, ShardView{indptr, indices, alias_prob, alias_other}, RawView{res, cum, out});
}

template <bool kAlias, bool kSharded>
int launch_form(int form, const RawLaunch& L) {
  const dim3 grid(L.blocks), block(kBlockThreads);
  switch (form) {
    case 1:
      form_kernel<kAlias, kSharded, false, 1, kRawBlocksPerSM><<<grid, block, 0, L.s>>>(L.a, L.ra, L.t, L.rt);
      break;
    case 2:
      form_kernel<kAlias, kSharded, true, 1, 4><<<grid, block, 0, L.s>>>(L.a, L.ra, L.t, L.rt);
      break;
    case 3:
      form_kernel<kAlias, kSharded, true, 1, 8><<<grid, block, 0, L.s>>>(L.a, L.ra, L.t, L.rt);
      break;
    case 4:
      form_kernel<kAlias, kSharded, true, 2, kRawBlocksPerSM><<<grid, block, 0, L.s>>>(L.a, L.ra, L.t, L.rt);
      break;
    case 5:
      form_kernel<kAlias, kSharded, true, 0, kRawBlocksPerSM><<<grid, block, 0, L.s>>>(L.a, L.ra, L.t, L.rt);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// fora_raw_walk's arguments after the form (1-5, as above)
extern "C" int fora_raw_walk_form(int form, const float* const* r, long long r_ld,
                                  const int* const* cum, long long cum_ld, const int* total,
                                  const long long* bounds, int G, long long n, int Bc,
                                  long long rows, long long lane_lo, int n_loc,
                                  float* const* out, long long out_ld, int* ends,
                                  const int* const* indptr, const int* const* indices,
                                  const float* const* alias_prob,
                                  const int* const* alias_other, unsigned long long seed,
                                  float inv_log1m_alpha, int max_hops, int walks_per_lane,
                                  long long tiles, long long blocks, void* stream) {
  if (form < 1 || form > 5) return (int)cudaErrorInvalidValue;
  RawLaunch L;
  const int bad = raw_args(&L, r, r_ld, cum, cum_ld, total, bounds, G, n, Bc, rows, lane_lo,
                           n_loc, out, out_ld, ends, indptr, indices, alias_prob, alias_other,
                           seed, inv_log1m_alpha, max_hops, walks_per_lane, tiles, blocks,
                           stream);
  if (bad) return bad;
  if (L.blocks == 0) return (int)cudaGetLastError();
  if (L.alias && L.sharded) return launch_form<true, true>(form, L);
  if (L.alias) return launch_form<true, false>(form, L);
  if (L.sharded) return launch_form<false, true>(form, L);
  return launch_form<false, false>(form, L);
}
