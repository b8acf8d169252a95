// P3 · row_scatter_add: per-edge row accumulate over an unsorted edge list.
//
//   for every edge e:  acc[dst[e], :] += tile[src[e], :]        (f32, B wide)
//   (an edge whose dst lies outside acc's rows is skipped: a pad slot)
//
// Replaces the Pallas kernel scripts/pallas_gather_probe.py::kernel (43-56),
// the TPU probe that asks whether an accumulate over a tile and an
// accumulator resident in on-chip memory (VMEM, indices in SMEM, 2048
// edges per grid step in a sequential fori_loop) beats the full-graph
// gather.  On the TPU the grid runs in order on one core, so the adds need
// no atomics; here blocks run in parallel on 132 SMs and two edges may hit
// one acc row at once, so every add is an atomic reduction into acc in
// device memory.  The order of the adds is therefore not deterministic:
// two runs may differ in the last bits of an f32 sum.
//
// What bounds it on the H100: the atomic adds, B / 4 per edge, each a
// read-modify-write resolved in L2; the row reads are float4 loads.  At
// the probe's shapes the tile (8192 x 128 f32, 4 MB) and acc (4096 x 128
// f32, 2 MB) stay resident in the 50 MB L2, the closest analogue of the
// TPU's VMEM residency, so device memory is touched once.
// Design: a group of T lanes per edge (T the power of two that covers the
// row's float4 chunks, at most 32), so B = 32 still fills whole warps with
// four edges each; each lane loads float4 chunks of the source row and
// adds each with one float4 atomicAdd (Hopper's vector atomic, compiled to
// a fire-and-forget reduction since the result is unused); rows whose
// width or address is not a multiple of 4 floats take scalar atomicAdds.
// The TPU's scalar prefetch and 2048-edge chunking have no counterpart:
// each group reads its own two indices.
// On the sharded push this is the receive of the compact, routed and hier
// exchanges (fora_tpu/parallel/sharded.py:144-146, 165-167, 203-205:
// full.at[ids].add(rows) into a zeroed buffer).  JAX sends the pad id n_pad
// for every unused slot and adds all of them into one spare row; here a pad
// fails the dst < rows test and costs no atomic, so every real id, unique
// in a receive, adds its row to 0.0 once and the buffer equals the dense
// exchange's rows bit for bit.
//
// exchange_clear: before a compacted receive, for every buffer t of a launch
//   buf_t[own0_t .. own0_t + own_rows) = 0        (its own block)
//   buf_t[ids_t[e], :] = 0 for every e whose id lies in buf_t's rows
//                                                  (a pad slot skipped)
// The compacted exchange's receive needs a buffer that is zero on every row
// it does not receive; zeroing the whole [n_pad, B] buffer costs 268 MB of
// stores a shard at bench.py's shapes, where what was written since it was
// last zero is the shard's own block (the pre-pass rewrites it every
// superstep) and the rows of the previous receive (at most G * cap;
// ops/exchange.py keeps track of which they are).  JAX zeroes a new buffer
// for each receive (fora_tpu/parallel/sharded.py:144, 165, 203).  One launch
// clears every buffer of a card: a table of (buffer, ids, own block) in the
// kernel's parameters, each block row of the grid (blockIdx.y) one buffer,
// picked from the table by constant indices so that the table stays out of
// local memory; the G own-block zero_() calls and the G launches over the
// ids that it replaces each paid the host's work of a call for a few
// microseconds of device time.  Bound by bytes: the own blocks and B * 4
// bytes a real id stored, the ids read.  Design: the own block as float4
// stores in a grid-stride loop, then the ids in P3's lane groups, each
// storing one row as float4 zeros (scalar stores where B or an address is
// not a multiple of 4 floats); an id inside the own block is skipped (that
// row is zeroed already), and a repeated id stores twice without conflict.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <bool VEC4>
__global__ void row_scatter_add_kernel(float* __restrict__ acc, const float* __restrict__ tile,
                                       const int* __restrict__ src, const int* __restrict__ dst,
                                       long long E, long long rows, int B, int group_log2) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long e = t >> group_log2;
  if (e >= E) return;
  const int group = 1 << group_log2;
  const int lane = (int)(t & (group - 1));
  const long long d = dst[e];
  if (d < 0 || d >= rows) return;   // a pad slot
  const long long s = src[e];
  float* out = acc + d * B;
  if (VEC4) {
    const float4* row = reinterpret_cast<const float4*>(tile + s * B);
    for (int c = lane; c < (B >> 2); c += group) {
      const float4 v = __ldg(row + c);
      // sm_90's vector atomic: one 16-byte reduction instead of four
      atomicAdd(reinterpret_cast<float4*>(out) + c, v);
    }
  } else {
    const float* row = tile + s * B;
    for (int c = lane; c < B; c += group) atomicAdd(out + c, __ldg(row + c));
  }
}

constexpr int kMaxBuffers = 32;

struct ClearTable {
  float* buf[kMaxBuffers];
  const int* ids[kMaxBuffers];
  long long own0[kMaxBuffers];
};

// block row t = blockIdx.y: buffer t of the table; VEC4: B a multiple of 4
// and every buffer 16-byte aligned
template <bool VEC4>
__global__ void exchange_clear_kernel(const ClearTable tab, long long rows, int B,
                                      long long own_rows, long long n_ids, int group_log2) {
  const int t = blockIdx.y;
  float* buf = nullptr;
  const int* ids = nullptr;
  long long own0 = 0;
#pragma unroll
  for (int k = 0; k < kMaxBuffers; ++k) {
    if (k == t) {
      buf = tab.buf[k];
      ids = tab.ids[k];
      own0 = tab.own0[k];
    }
  }
  const int chunks = VEC4 ? B >> 2 : B;
  const long long own_units = own_rows * chunks;
  const long long units = own_units + (ids == nullptr ? 0 : n_ids << group_log2);
  const int group = 1 << group_log2;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x; u < units; u += stride) {
    if (u < own_units) {
      if (VEC4)
        reinterpret_cast<float4*>(buf + own0 * B)[u] = zero4;
      else
        buf[own0 * B + u] = 0.f;
      continue;
    }
    const long long v = u - own_units;
    const long long d = ids[v >> group_log2];
    if (d < 0 || d >= rows || (d >= own0 && d < own0 + own_rows)) continue;
    float* out = buf + d * B;
    for (int c = (int)(v & (group - 1)); c < chunks; c += group) {
      if (VEC4)
        reinterpret_cast<float4*>(out)[c] = zero4;
      else
        out[c] = 0.f;
    }
  }
}

// the lanes a row takes: the power of two that covers its chunks, at most 32
int group_log2_for(int chunks) {
  int g = 0;
  while ((1 << g) < chunks && g < 5) ++g;
  return g;
}

}  // namespace

constexpr int kClearThreads = 256;
constexpr long long kClearBlocks = 132LL * 16;  // grid-stride beyond 16 blocks per SM

// bufs: host array of nbuf (1 .. 32) device pointers to [rows, B] f32
// buffers; ids: nbuf pointers to n_ids int32 each (or null: no rows);
// own0: nbuf first rows of each buffer's own block of own_rows rows
extern "C" int fora_exchange_clear(float* const* bufs, const int* const* ids,
                                   const long long* own0, int nbuf, long long rows, int B,
                                   long long own_rows, long long n_ids, void* stream) {
  if (nbuf < 1 || nbuf > kMaxBuffers || bufs == nullptr || own0 == nullptr || B <= 0 ||
      rows < 0 || own_rows < 0 || n_ids < 0)
    return (int)cudaErrorInvalidValue;
  ClearTable tab = {};
  bool vec4 = B % 4 == 0;
  for (int k = 0; k < nbuf; ++k) {
    if (bufs[k] == nullptr || own0[k] < 0 || own0[k] + own_rows > rows)
      return (int)cudaErrorInvalidValue;
    tab.buf[k] = bufs[k];
    tab.ids[k] = ids == nullptr ? nullptr : ids[k];
    tab.own0[k] = own0[k];
    vec4 = vec4 && (reinterpret_cast<uintptr_t>(bufs[k]) & 15) == 0;
  }
  const int group_log2 = group_log2_for(vec4 ? B / 4 : B);
  const long long units = own_rows * (vec4 ? B / 4 : B) + (n_ids << group_log2);
  if (units == 0) return (int)cudaGetLastError();
  long long per_buf = kClearBlocks / nbuf;
  const long long want = (units + kClearThreads - 1) / kClearThreads;
  if (want < per_buf) per_buf = want;
  const dim3 grid((unsigned)(per_buf > 0 ? per_buf : 1), (unsigned)nbuf);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (vec4) {
    exchange_clear_kernel<true><<<grid, kClearThreads, 0, st>>>(tab, rows, B, own_rows, n_ids,
                                                                 group_log2);
  } else {
    exchange_clear_kernel<false><<<grid, kClearThreads, 0, st>>>(tab, rows, B, own_rows, n_ids,
                                                                  group_log2);
  }
  return (int)cudaGetLastError();
}

extern "C" int fora_row_scatter_add(float* acc, const float* tile, const int* src,
                                    const int* dst, long long E, long long rows, int B,
                                    void* stream) {
  if (E <= 0 || B <= 0) return (int)cudaGetLastError();
  const bool vec4 = (B % 4 == 0) && ((reinterpret_cast<uintptr_t>(acc) & 15) == 0) &&
                    ((reinterpret_cast<uintptr_t>(tile) & 15) == 0);
  const int group_log2 = group_log2_for(vec4 ? B / 4 : B);
  const int threads = 256;
  const long long blocks = ((E << group_log2) + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (vec4) {
    row_scatter_add_kernel<true><<<(unsigned)blocks, threads, 0, st>>>(acc, tile, src, dst, E,
                                                                       rows, B, group_log2);
  } else {
    row_scatter_add_kernel<false><<<(unsigned)blocks, threads, 0, st>>>(acc, tile, src, dst, E,
                                                                        rows, B, group_log2);
  }
  return (int)cudaGetLastError();
}
