// Other forms of K6+K4-src (kernels/csrc/walk.cu, source_walk_kernel), kept
// only so that probes/mc_walk_probe.py can time them beside the package's on
// the same chunk; no entry point of the package loads them.  The package's
// form interleaves the columns across warp tiles, counts the walks that end
// at the source and adds the other walks that end in one step by endpoint
// groups (__match_any_sync), at 6 blocks an SM.  The others (form numbers
// as fora_source_walk_form takes them):
//   1 no_count: no count and no groups after a hop; the walks of no hop,
//     which end in the refill, added by one RED for the refill's group (as
//     K6+K4 groups them), every other walk a RED of its own;
//   2 alone: the count, and every other walk a RED of its own (no groups);
//   3 none: no count and no group, a RED a walk (the chain's adds, fused);
//   4 column_major: 2 in K6+K4's tile order, column by column (tile j of
//     column b is warp b * tiles + j), so the resident warps share one
//     source (this kernel's first form);
//   5 column_major_group: the package's adds in K6+K4's tile order;
//   6 table: 2, with each warp adding its tile's other walks into a table
//     of 256 slots in shared memory (node -> count, 4 linear probes, a RED
//     where they all hold other nodes), one RED a slot when the tile is
//     done;
//   7 blocks8, 8 blocks4: 2 at 8 or 4 blocks an SM in __launch_bounds__.
// form_range is source_walk_range with those choices as template
// arguments; the probe holds every form's endpoints bit-equal to K4's.
#include "../kernels/csrc/walk.cu"

namespace {

constexpr int kSlotBits = 8;
constexpr int kSlots = 1 << kSlotBits;

// kCount: walks at the source counted; kGroup: 0 no walk grouped, 1 the
// refill's (the walks of no hop), 2 also those that end after a hop;
// kInterleave: tile j of column b is warp j * B + b (else b * tiles + j);
// kTable: the other walks through a shared table a warp
template <bool kAlias, bool kHub, bool kCount, int kGroup, bool kInterleave, bool kTable>
__device__ __forceinline__ void form_range(const WalkArgs& a, const SrcArgs& sa) {
  __shared__ int t_key[kTable ? kBlockWarps : 1][kSlots];
  __shared__ unsigned t_cnt[kTable ? kBlockWarps : 1][kSlots];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint64_t tile = (uint64_t)blockIdx.x * kBlockWarps + warp;
  if (tile >= (uint64_t)sa.tiles * (uint64_t)sa.B) return;
  const int b = kInterleave ? (int)(tile % (uint64_t)sa.B) : (int)(tile / sa.tiles);
  const uint32_t t0 = (uint32_t)(kInterleave ? tile / (uint64_t)sa.B
                                             : tile - (uint64_t)b * sa.tiles) *
                      a.range;
  const uint32_t count = min(a.range, sa.rows - t0);
  const int src = __ldg(sa.sources + b);
  float* const col = sa.out + b;
  const ShardView tab{nullptr, nullptr, nullptr, nullptr};
  int* const key = t_key[kTable ? warp : 0];
  unsigned* const cnt = t_cnt[kTable ? warp : 0];
  if (kTable) {
    for (int i = lane; i < kSlots; i += 32) {
      key[i] = -1;
      cnt[i] = 0;
    }
    __syncwarp();
  }
  const unsigned below = (1u << lane) - 1u;
  uint32_t batch = 0, filled = 0, used = 0;
  int ahead_len = 0;
  uint32_t w = 0;
  int cur = 0, h = 0, len = 0;
  unsigned home = 0;
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
        if ((uint32_t)lane < filled)
          ahead_len = walk_length(a, (t0 + batch + lane) * (uint32_t)sa.B + (uint32_t)b);
      }
      const uint32_t k = used + __popc(need & below);
      const int take_len = __shfl_sync(kFull, ahead_len, k & 31);
      bool ending = false;
      if (idle && k < filled) {
        w = (t0 + batch + k) * (uint32_t)sa.B + (uint32_t)b;
        cur = src;
        len = take_len;
        h = 0;
        if (len > 0) {
          idle = false;
        } else {
          ending = true;
          if (sa.ends != nullptr) sa.ends[w] = src;
        }
      }
      if (kCount) {
        home += ending ? 1u : 0u;
      } else if (kGroup >= 1) {  // every such walk ends at the source
        const unsigned group = __ballot_sync(kFull, ending);
        if (lane == __ffs(group) - 1)
          atomicAdd(col + (long long)src * sa.out_ld, (float)__popc(group) * sa.weight);
      } else if (ending) {
        atomicAdd(col + (long long)src * sa.out_ld, sa.weight);
      }
      used = min(filled, used + __popc(need));
    }
    if (__all_sync(kFull, idle)) break;
    const bool ending = !idle && hop<kAlias, kHub, false>(a, tab, w, cur, h, len);
    if (ending && sa.ends != nullptr) sa.ends[w] = cur;
    const bool counted = kCount && ending && cur == src;
    home += counted ? 1u : 0u;
    bool add = ending && !counted;
    if (kTable && add) {
      const unsigned hash = ((unsigned)cur * 2654435761u) >> (32 - kSlotBits);
      for (int p = 0; p < 4 && add; ++p) {
        const int slot = (int)((hash + (unsigned)p) & (kSlots - 1));
        const int old = atomicCAS(key + slot, -1, cur);
        if (old == -1 || old == cur) {
          atomicAdd(cnt + slot, 1u);
          add = false;
        }
      }
    }
    if (kGroup == 2) {
      const unsigned mask = __ballot_sync(kFull, add);
      if (add) {
        const unsigned peers = __match_any_sync(mask, cur);
        if (lane == __ffs(peers) - 1)
          atomicAdd(col + (long long)cur * sa.out_ld, (float)__popc(peers) * sa.weight);
      }
    } else if (add) {
      atomicAdd(col + (long long)cur * sa.out_ld, sa.weight);
    }
    if (ending) idle = true;
  }
  if (kCount) {
    home = __reduce_add_sync(kFull, home);
    if (lane == 0 && home != 0)
      atomicAdd(col + (long long)src * sa.out_ld, (float)home * sa.weight);
  }
  if (kTable) {
    __syncwarp();
    for (int i = lane; i < kSlots; i += 32)
      if (cnt[i] != 0) atomicAdd(col + (long long)key[i] * sa.out_ld, (float)cnt[i] * sa.weight);
  }
}

template <bool kAlias, bool kHub, bool kCount, int kGroup, bool kInterleave, bool kTable,
          int kBlocks>
__global__ void __launch_bounds__(kBlockThreads, kBlocks)
    form_kernel(const WalkArgs a, const SrcArgs sa) {
  form_range<kAlias, kHub, kCount, kGroup, kInterleave, kTable>(a, sa);
}

template <bool kAlias, bool kHub>
int launch_form(int form, const SrcLaunch& L) {
  const dim3 grid(L.blocks), block(kBlockThreads);
  constexpr int kB = kRawBlocksPerSM;
  switch (form) {
    case 1:
      form_kernel<kAlias, kHub, false, 1, true, false, kB><<<grid, block, 0, L.s>>>(L.a, L.sa);
      break;
    case 2:
      form_kernel<kAlias, kHub, true, 0, true, false, kB><<<grid, block, 0, L.s>>>(L.a, L.sa);
      break;
    case 3:
      form_kernel<kAlias, kHub, false, 0, true, false, kB><<<grid, block, 0, L.s>>>(L.a, L.sa);
      break;
    case 4:
      form_kernel<kAlias, kHub, true, 0, false, false, kB><<<grid, block, 0, L.s>>>(L.a, L.sa);
      break;
    case 5:
      form_kernel<kAlias, kHub, true, 2, false, false, kB><<<grid, block, 0, L.s>>>(L.a, L.sa);
      break;
    case 6:
      form_kernel<kAlias, kHub, true, 0, true, true, kB><<<grid, block, 0, L.s>>>(L.a, L.sa);
      break;
    case 7:
      form_kernel<kAlias, kHub, true, 0, true, false, 8><<<grid, block, 0, L.s>>>(L.a, L.sa);
      break;
    case 8:
      form_kernel<kAlias, kHub, true, 0, true, false, 4><<<grid, block, 0, L.s>>>(L.a, L.sa);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// fora_source_walk's arguments after the form (1-8, as above)
extern "C" int fora_source_walk_form(int form, const int* sources, int B, float* out,
                                     long long out_ld, long long n, int* ends, long long rows,
                                     const int* indptr, const int* indices,
                                     const float* alias_prob, const int* alias_other,
                                     const int* hub_id, const int* pool, int pool_size,
                                     unsigned long long seed, float inv_log1m_alpha,
                                     int max_hops, float weight, int walks_per_lane,
                                     long long tiles, long long blocks, void* stream) {
  if (form < 1 || form > 8) return (int)cudaErrorInvalidValue;
  SrcLaunch L;
  const int bad = source_args(&L, sources, B, out, out_ld, n, ends, rows, indptr, indices,
                              alias_prob, alias_other, hub_id, pool, pool_size, seed,
                              inv_log1m_alpha, max_hops, weight, walks_per_lane, tiles, blocks,
                              stream);
  if (bad) return bad;
  if (L.blocks == 0) return (int)cudaGetLastError();
  if (L.alias && L.hub) return launch_form<true, true>(form, L);
  if (L.alias) return launch_form<true, false>(form, L);
  if (L.hub) return launch_form<false, true>(form, L);
  return launch_form<false, false>(form, L);
}
