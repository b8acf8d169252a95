// philox_probe: the rate at which the card computes Philox-4x32-10 blocks
// with every lane busy and no loads, for the operations term of the walk
// kernel's bound (K4 draws one block per walk and one per hop, walk.cu).
// A measuring instrument, on no query path.
//
// Every thread computes `per_thread` blocks of the walk's own function
// (philox.cuh), keyed as the walk keys them: (seed, thread) with (i, seed)
// as the counter, four independent blocks at a time so that the integer
// pipes, and not the latency of one chain of rounds, set the pace.  Only the
// first word of each block is kept, as the uniform hop keeps it; they are
// folded into `out` so that the work stays.
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int IN_FLIGHT = 4;

__global__ void philox_blocks_kernel(int* __restrict__ out, int per_thread, uint32_t seed) {
  const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t acc = 0;
  for (int i = 0; i < per_thread; i += IN_FLIGHT) {
#pragma unroll
    for (int j = 0; j < IN_FLIGHT; ++j)
      acc ^= philox4x32_10(make_uint4((uint32_t)(i + j), seed, 0u, 0u), make_uint2(seed, t)).x;
  }
  out[t] = (int)acc;
}

}  // namespace

// `blocks` blocks of 256 threads, each thread computing `per_thread` Philox
// blocks (a multiple of four); `out` holds blocks * 256 ints.
extern "C" int fora_philox_blocks(int* out, int per_thread, int blocks, unsigned seed,
                                  void* stream) {
  if (blocks <= 0 || per_thread <= 0 || per_thread % IN_FLIGHT) return (int)cudaErrorInvalidValue;
  philox_blocks_kernel<<<blocks, 256, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      out, per_thread, seed);
  return (int)cudaGetLastError();
}
