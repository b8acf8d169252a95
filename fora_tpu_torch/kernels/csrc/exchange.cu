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
// the slots in row order; here each block claims its slots with one atomic
// per destination, so slots come out in row order within a block and in
// the order the blocks claim them across blocks, which varies from run to
// run.  The receiver adds each row into a zeroed buffer at its id (P3,
// row_scatter.cu), every id at most once, so the buffer it ends with does
// not depend on the order.
//
// What bounds it on the H100: bytes.  Every row of contrib is read once
// (the test for a non-zero entry needs the whole row of an inactive one),
// the masks once, and each sent row is written once per destination.
// Claiming a slot per row would put one atomic per active row on each of
// only D counters, serialised at the L2; a superstep past cap claims every
// row.  So the claims are made per block of rows.
// Design: a block takes a tile of kTile consecutive rows at a time, 32 a
// warp (two blocks an SM loop over the tiles, so one block's copies
// overlap the other's reads).  Each warp tests its rows, kTestUnroll at a
// time so that each lane has that many loads in flight, the lanes reading
// each row as float4 (B / 4 chunks, a scalar loop where B or an address
// is not a multiple of 4 floats), __any_sync deciding each.  Then lane j
// holds row j of the warp: per destination __ballot_sync gives the warp a
// bit mask of the rows due there, the warps' counts go to shared memory,
// and one thread per destination scans them and claims the block's whole
// count with one atomicAdd: n_loc / kTile atomics per destination.  Each
// warp then writes its rows at base + its warps' prefix + the rank of the
// row in its mask, kCopyUnroll rows at a time; slots past cap are
// dropped, while counts[d] still adds every row (the overflow test).  A first kernel fills ids with pad_id and
// zeroes counts.  The ids and rows of destination d start at ids + d *
// id_stride and rows + d * row_stride, so a caller may lay every sender's
// block for one receiver side by side and the receiver reads them as one
// list.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;           // a block: eight warps
constexpr int kTile = 32 * kWarps;  // its rows: 32 a warp
constexpr int kTestUnroll = 8;      // rows a warp tests at once
constexpr int kCopyUnroll = 4;      // rows a warp copies at once
constexpr unsigned kFull = 0xffffffffu;

__global__ void compact_init_kernel(int* __restrict__ ids, long long id_stride, int D, int cap,
                                    int pad_id, int* __restrict__ counts) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < (long long)D * cap) ids[(t / cap) * id_stride + t % cap] = pad_id;
  if (t < D) counts[t] = 0;
}

// bit u of the result: row r0 + u (u < kTestUnroll) has a non-zero entry;
// rows at or past n_loc test as zero.  Each lane's loads of the rows are
// issued together, then tested.
template <bool VEC4>
__device__ __forceinline__ unsigned rows_nonzero(const float* __restrict__ contrib, long long r0,
                                                 long long n_loc, int B, int lane) {
  long long row[kTestUnroll];
#pragma unroll
  for (int u = 0; u < kTestUnroll; ++u) row[u] = r0 + u < n_loc ? r0 + u : n_loc - 1;
  bool nz[kTestUnroll];
#pragma unroll
  for (int u = 0; u < kTestUnroll; ++u) nz[u] = false;
  if (VEC4) {
    for (int c = lane; c < (B >> 2); c += 32) {
      float4 v[kTestUnroll];
#pragma unroll
      for (int u = 0; u < kTestUnroll; ++u) {
        v[u] = reinterpret_cast<const float4*>(contrib + row[u] * B)[c];
      }
#pragma unroll
      for (int u = 0; u < kTestUnroll; ++u) {
        nz[u] |= (v[u].x != 0.0f) | (v[u].y != 0.0f) | (v[u].z != 0.0f) | (v[u].w != 0.0f);
      }
    }
  } else {
    for (int c = lane; c < B; c += 32) {
      float v[kTestUnroll];
#pragma unroll
      for (int u = 0; u < kTestUnroll; ++u) v[u] = contrib[row[u] * B + c];
#pragma unroll
      for (int u = 0; u < kTestUnroll; ++u) nz[u] |= v[u] != 0.0f;
    }
  }
  unsigned bits = 0;
#pragma unroll
  for (int u = 0; u < kTestUnroll; ++u) {
    if (__any_sync(kFull, nz[u]) && r0 + u < n_loc) bits |= 1u << u;
  }
  return bits;
}

template <bool VEC4>
__global__ void __launch_bounds__(kTile) compact_kernel(
    const float* __restrict__ contrib, long long n_loc, int B, const uint8_t* __restrict__ needed,
    int D, int cap, long long row0, int* __restrict__ ids, long long id_stride,
    float* __restrict__ rows, long long row_stride, int* __restrict__ counts) {
  __shared__ unsigned s_mask[kWarps][32];  // per warp and destination: its rows due there
  __shared__ int s_slot[kWarps][32];       // per warp and destination: its first slot
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long n_tiles = (n_loc + kTile - 1) / kTile;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long r0 = tile * kTile + (long long)warp * 32;  // the warp's row 0
    // 1. bit j of act: row r0 + j has a non-zero entry
    unsigned act = 0;
    if (r0 < n_loc) {
      for (int j0 = 0; j0 < 32; j0 += kTestUnroll) {
        act |= rows_nonzero<VEC4>(contrib, r0 + j0, n_loc, B, lane) << j0;
      }
    }
    // 2. per destination, the warp's rows due there (lane j: row r0 + j)
    const bool mine = (act >> lane) & 1u;
    for (int d = 0; d < D; ++d) {
      const bool due = mine && (needed == nullptr || needed[(long long)d * n_loc + r0 + lane]);
      const unsigned m = __ballot_sync(kFull, due);
      if (lane == 0) s_mask[warp][d] = m;
    }
    __syncthreads();
    // 3. one thread a destination: the warps' prefix and the block's claim
    if (threadIdx.x < D) {
      const int d = threadIdx.x;
      int total = 0;
      for (int w = 0; w < kWarps; ++w) {
        s_slot[w][d] = total;
        total += __popc(s_mask[w][d]);
      }
      const int base = total > 0 ? atomicAdd(counts + d, total) : 0;
      for (int w = 0; w < kWarps; ++w) s_slot[w][d] += base;
    }
    __syncthreads();
    // 4. the warp's rows at their slots, in row order, those below cap
    for (int d = 0; d < D; ++d) {
      unsigned m = s_mask[warp][d];
      int slot = s_slot[warp][d];
      while (m != 0 && slot < cap) {
        int js[kCopyUnroll];
        int k = 0;
#pragma unroll
        for (int u = 0; u < kCopyUnroll; ++u) {
          js[u] = 0;
          if (m != 0 && slot + u < cap) {
            js[u] = __ffs(m) - 1;
            m &= m - 1;
            k = u + 1;
          }
        }
        float* out = rows + d * row_stride + (long long)slot * B;
        if (VEC4) {
          for (int c = lane; c < (B >> 2); c += 32) {
            float4 v[kCopyUnroll];
#pragma unroll
            for (int u = 0; u < kCopyUnroll; ++u) {
              if (u < k) v[u] = reinterpret_cast<const float4*>(contrib + (r0 + js[u]) * B)[c];
            }
#pragma unroll
            for (int u = 0; u < kCopyUnroll; ++u) {
              if (u < k) reinterpret_cast<float4*>(out + (long long)u * B)[c] = v[u];
            }
          }
        } else {
          for (int c = lane; c < B; c += 32) {
            float v[kCopyUnroll];
#pragma unroll
            for (int u = 0; u < kCopyUnroll; ++u) {
              if (u < k) v[u] = contrib[(r0 + js[u]) * B + c];
            }
#pragma unroll
            for (int u = 0; u < kCopyUnroll; ++u) {
              if (u < k) out[(long long)u * B + c] = v[u];
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kCopyUnroll; ++u) {
          if (lane == u && u < k) ids[d * id_stride + slot + u] = (int)(row0 + r0 + js[u]);
        }
        slot += k;
      }
    }
    __syncthreads();  // s_mask and s_slot serve the next tile
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
    // two blocks an SM, each looping over tiles, so that one block's
    // copies overlap the other's reads
    const long long want = (n_loc + kTile - 1) / kTile;
    const long long cap_blocks = (long long)(sms > 0 ? sms : 132) * 2;
    const unsigned blocks = (unsigned)(want < cap_blocks ? want : cap_blocks);
    if (vec4) {
      compact_kernel<true><<<blocks, kTile, 0, st>>>(contrib, n_loc, B, needed, D, cap, row0,
                                                     ids, id_stride, rows, row_stride, counts);
    } else {
      compact_kernel<false><<<blocks, kTile, 0, st>>>(contrib, n_loc, B, needed, D, cap, row0,
                                                      ids, id_stride, rows, row_stride, counts);
    }
  }
  return (int)cudaGetLastError();
}
