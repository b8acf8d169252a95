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

}  // namespace

extern "C" int fora_row_scatter_add(float* acc, const float* tile, const int* src,
                                    const int* dst, long long E, long long rows, int B,
                                    void* stream) {
  if (E <= 0 || B <= 0) return (int)cudaGetLastError();
  const bool vec4 = (B % 4 == 0) && ((reinterpret_cast<uintptr_t>(acc) & 15) == 0) &&
                    ((reinterpret_cast<uintptr_t>(tile) & 15) == 0);
  const int chunks = vec4 ? B / 4 : B;
  int group_log2 = 0;
  while ((1 << group_log2) < chunks && group_log2 < 5) ++group_log2;
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
