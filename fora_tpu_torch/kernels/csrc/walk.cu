// K4 · index_walk: endpoints of alpha-terminating random walks, one thread
// per walk, uniform hops or (on a weighted graph) alias-table hops.
//
// Replaces fora_tpu/ops/walk.py::run_walks_scheduled (159-222) with
// geometric_lengths (89-99), the XLA-lowered walk that builds the FORA+
// index, and its alias branch (212-218; run_walks 115-116, 128-132).  On the
// TPU the walks advance in lockstep, sorted by their pre-drawn length so
// that hop h runs on a shrinking static prefix (hop_widths), with a
// fallback to the plain lockstep walk when a prefix overflows.  A GPU
// thread runs its own walk to its own length instead, so neither the sort
// nor the fallback exists here.
//
// Per walk w (its lane):
//   len = min(floor(log(u0) / log(1 - alpha)), max_hops),  u0 in (0, 1]
//   repeat len times: stop at a dangling node (deg == 0 absorbs);
//                     slot = out_indptr[cur] + min(floor(u_h * deg), deg - 1)
//                     uniform: cur = out_indices[slot]
//                     alias:   cur = u2_h < alias_prob[slot] ? out_indices[slot]
//                                                            : alias_other[slot]
// Random numbers: Philox-4x32-10 written into the kernel, keyed by
// (seed low word, lane), with (hop, seed high word) as the counter; u_h is
// the block's first word and u2_h its second, so the alias hop costs no
// second Philox call.  The endpoints match JAX's in distribution only; JAX
// draws threefry bits.
//
// The hub branch (kHub, HubPPR's query walks) replaces
// fora_tpu/algo/hubppr.py::hub_walks (143-180): after every hop the walk
// takes, it looks its new node up in hub_id; at a hub (hid >= 0) the walk
// ends at one entry of that hub's pool of precomputed endpoints,
//   cur = pool[hid * P + min(floor(u3_h * P), P - 1)],
// with u3_h the third word of the hop's Philox block.  The start node never
// substitutes (the lookup follows a hop).  On a weighted graph the hop is the
// alias hop: the JAX function hops uniformly there (ROADMAP C14).
//
// What bounds it on the H100: latency of the dependent loads per hop
// (deg[cur], out_indptr[cur], then out_indices[slot]; the alias hop reads
// alias_prob[slot] and then only the one of out_indices[slot] and
// alias_other[slot] that it takes; the hub branch reads hub_id[cur] after
// each hop and one pool entry at a hub), about 1/alpha = 5 hops per walk.
// Design: millions of independent walks in flight hide that latency; the
// Philox rounds are a few dozen integer multiplies per hop.  Each branch is
// a separate instantiation, so weighted graphs and hub lookups cost the
// plain walk nothing.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += W0;
    k.y += W1;
  }
  return c;
}

template <bool kAlias, bool kHub>
__global__ void index_walk_kernel(const int* __restrict__ start, int* __restrict__ out,
                                  long long W, const int* __restrict__ indptr,
                                  const int* __restrict__ indices, const int* __restrict__ deg,
                                  const float* __restrict__ alias_prob,
                                  const int* __restrict__ alias_other,
                                  const int* __restrict__ hub_id, const int* __restrict__ pool,
                                  int pool_size, uint32_t seed_lo, uint32_t seed_hi,
                                  float inv_log1m_alpha, int max_hops) {
  const long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  const uint2 key = make_uint2(seed_lo, (uint32_t)w);
  const float two_m24 = 1.0f / 16777216.0f;
  const uint4 r0 = philox4x32_10(make_uint4(0u, seed_hi, 0u, 0u), key);
  const float u0 = (float)((r0.x >> 8) + 1u) * two_m24;  // (0, 1]
  const int len = (int)fminf(floorf(logf(u0) * inv_log1m_alpha), (float)max_hops);
  int cur = start[w];
  for (int h = 0; h < len; ++h) {
    const int d = deg[cur];
    if (d == 0) break;  // dangling absorbs
    const uint4 r = philox4x32_10(make_uint4((uint32_t)(h + 1), seed_hi, 0u, 0u), key);
    const float u = (float)(r.x >> 8) * two_m24;  // [0, 1)
    const int slot = indptr[cur] + min((int)(u * (float)d), d - 1);
    if (kAlias) {
      const float u2 = (float)(r.y >> 8) * two_m24;  // [0, 1)
      // pick the table first, so that only the chosen entry is loaded
      const int* table = u2 < alias_prob[slot] ? indices : alias_other;
      cur = table[slot];
    } else {
      cur = indices[slot];
    }
    if (kHub) {
      const int hid = hub_id[cur];
      if (hid >= 0) {  // arrival at a hub: one pool draw ends the walk
        const float u3 = (float)(r.z >> 8) * two_m24;  // [0, 1)
        const int j = min((int)(u3 * (float)pool_size), pool_size - 1);
        cur = pool[(long long)hid * pool_size + j];
        break;
      }
    }
  }
  out[w] = cur;
}

template <bool kAlias, bool kHub>
void launch_walk(unsigned blocks, cudaStream_t s, const int* start, int* out, long long W,
                 const int* indptr, const int* indices, const int* deg, const float* alias_prob,
                 const int* alias_other, const int* hub_id, const int* pool, int pool_size,
                 uint32_t lo, uint32_t hi, float inv_log1m_alpha, int max_hops) {
  index_walk_kernel<kAlias, kHub><<<blocks, 256, 0, s>>>(
      start, out, W, indptr, indices, deg, alias_prob, alias_other, hub_id, pool, pool_size, lo,
      hi, inv_log1m_alpha, max_hops);
}

}  // namespace

// alias_prob and alias_other are both null (uniform hops) or both set;
// hub_id and pool are both null (no hub lookup) or both set, pool [H, pool_size].
extern "C" int fora_index_walk(const int* start, int* out, long long W, const int* indptr,
                               const int* indices, const int* deg, const float* alias_prob,
                               const int* alias_other, const int* hub_id, const int* pool,
                               int pool_size, unsigned long long seed, float inv_log1m_alpha,
                               int max_hops, void* stream) {
  if ((alias_prob == nullptr) != (alias_other == nullptr)) return (int)cudaErrorInvalidValue;
  if ((hub_id == nullptr) != (pool == nullptr)) return (int)cudaErrorInvalidValue;
  if (hub_id != nullptr && pool_size <= 0) return (int)cudaErrorInvalidValue;
  if (W <= 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((W + 255) / 256);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const uint32_t lo = (uint32_t)(seed & 0xffffffffull), hi = (uint32_t)(seed >> 32);
  const bool alias = alias_prob != nullptr, hub = hub_id != nullptr;
  if (alias && hub)
    launch_walk<true, true>(blocks, s, start, out, W, indptr, indices, deg, alias_prob,
                            alias_other, hub_id, pool, pool_size, lo, hi, inv_log1m_alpha,
                            max_hops);
  else if (alias)
    launch_walk<true, false>(blocks, s, start, out, W, indptr, indices, deg, alias_prob,
                             alias_other, nullptr, nullptr, 0, lo, hi, inv_log1m_alpha, max_hops);
  else if (hub)
    launch_walk<false, true>(blocks, s, start, out, W, indptr, indices, deg, nullptr, nullptr,
                             hub_id, pool, pool_size, lo, hi, inv_log1m_alpha, max_hops);
  else
    launch_walk<false, false>(blocks, s, start, out, W, indptr, indices, deg, nullptr, nullptr,
                              nullptr, nullptr, 0, lo, hi, inv_log1m_alpha, max_hops);
  return (int)cudaGetLastError();
}
