// The frontier compaction: the send side of the compact, routed and hier
// frontier exchanges.
//
//   for every row i of contrib [n_loc, B] with some entry != 0, and every
//   destination d in 0..D-1 that needs it (needed[d, i], or all d when there
//   is no mask):
//     slot = counts[d]++;  if slot < cap: ids[d, slot] = row0 + i,
//                                         rows[d, slot, :] = contrib[i, :]
//   unused slots of ids hold pad_id; counts[d] ends as the number of rows
//   that were due to d, past cap included (the overflow test).
//
// Replaces what fora_tpu/parallel/sharded.py::_frontier_exchange computes
// in XLA on the sending shard (jnp.nonzero(act, size=cap, fill_value=n_loc)
// and the take of those rows, 125-131, 156-160, 177-182).  jnp.nonzero fills
// the slots in row order; here a warp claims a slot with one atomic per
// destination, so the slot order varies from run to run.  The receiver
// adds each row into a zeroed buffer at its id (P3, row_scatter.cu), every
// id at most once, so the buffer it ends with does not depend on the order.
//
// What bounds it on the H100: bytes.  Every row of contrib is read once
// (the test for a non-zero entry needs the whole row of an inactive one),
// the masks once, and each sent row is written once per destination.
// Design: one warp per row in a grid-stride loop; the lanes read the row as
// float4 (B / 4 chunks, a scalar loop where B or an address is not a
// multiple of 4 floats), __any_sync decides; lane d claims destination d's
// slot (D <= 32), __shfl_sync hands each slot to the warp, which writes the
// row.  A first kernel fills ids with pad_id and zeroes counts.  The ids and
// rows of destination d start at ids + d * id_stride and rows + d *
// row_stride, so a caller may lay every sender's block for one receiver
// side by side and the receiver reads them as one list.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void compact_init_kernel(int* __restrict__ ids, long long id_stride, int D, int cap,
                                    int pad_id, int* __restrict__ counts) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < (long long)D * cap) ids[(t / cap) * id_stride + t % cap] = pad_id;
  if (t < D) counts[t] = 0;
}

template <bool VEC4>
__global__ void compact_kernel(const float* __restrict__ contrib, long long n_loc, int B,
                               const uint8_t* __restrict__ needed, int D, int cap, long long row0,
                               int* __restrict__ ids, long long id_stride,
                               float* __restrict__ rows, long long row_stride,
                               int* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  const int width = VEC4 ? B >> 2 : B;
  for (long long i = warp; i < n_loc; i += n_warps) {
    bool nz = false;
    if (VEC4) {
      const float4* row = reinterpret_cast<const float4*>(contrib + i * B);
      for (int c = lane; c < width; c += 32) {
        const float4 v = row[c];
        nz |= (v.x != 0.0f) | (v.y != 0.0f) | (v.z != 0.0f) | (v.w != 0.0f);
      }
    } else {
      const float* row = contrib + i * B;
      for (int c = lane; c < width; c += 32) nz |= row[c] != 0.0f;
    }
    if (!__any_sync(0xffffffffu, nz)) continue;
    int slot = -1;
    if (lane < D && (needed == nullptr || needed[(long long)lane * n_loc + i])) {
      slot = atomicAdd(counts + lane, 1);
    }
    for (int d = 0; d < D; ++d) {
      const int s = __shfl_sync(0xffffffffu, slot, d);
      if (s < 0 || s >= cap) continue;
      float* out = rows + d * row_stride + (long long)s * B;
      if (VEC4) {
        const float4* row = reinterpret_cast<const float4*>(contrib + i * B);
        for (int c = lane; c < width; c += 32) reinterpret_cast<float4*>(out)[c] = row[c];
      } else {
        const float* row = contrib + i * B;
        for (int c = lane; c < width; c += 32) out[c] = row[c];
      }
      if (lane == 0) ids[d * id_stride + s] = (int)(row0 + i);
    }
  }
}

}  // namespace

extern "C" int fora_frontier_compact(const float* contrib, long long n_loc, int B,
                                     const uint8_t* needed, int D, int cap, long long row0,
                                     int pad_id, int* ids, long long id_stride, float* rows,
                                     long long row_stride, int* counts, int sms, void* stream) {
  if (D < 1 || D > 32 || cap < 1 || B < 1 || id_stride < cap ||
      row_stride < (long long)cap * B) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int threads = 256;
  const long long init = (long long)D * cap;
  compact_init_kernel<<<(unsigned)((init + threads - 1) / threads), threads, 0, st>>>(
      ids, id_stride, D, cap, pad_id, counts);
  if (n_loc > 0) {
    const bool vec4 = (B % 4 == 0) && ((reinterpret_cast<uintptr_t>(contrib) & 15) == 0) &&
                      ((reinterpret_cast<uintptr_t>(rows) & 15) == 0) && (row_stride % 4 == 0);
    // eight warps a block; enough blocks to fill the card eight times over,
    // fewer when the rows run out
    const long long want = (n_loc + 7) / 8;
    const long long cap_blocks = (long long)(sms > 0 ? sms : 132) * 8;
    const unsigned blocks = (unsigned)(want < cap_blocks ? want : cap_blocks);
    if (vec4) {
      compact_kernel<true><<<blocks, threads, 0, st>>>(contrib, n_loc, B, needed, D, cap, row0,
                                                       ids, id_stride, rows, row_stride, counts);
    } else {
      compact_kernel<false><<<blocks, threads, 0, st>>>(contrib, n_loc, B, needed, D, cap, row0,
                                                        ids, id_stride, rows, row_stride, counts);
    }
  }
  return (int)cudaGetLastError();
}
