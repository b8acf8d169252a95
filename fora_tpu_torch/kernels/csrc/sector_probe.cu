// sector_probe: the rate at which the card serves scattered 32-byte
// sectors of a buffer, for the bound of a kernel whose reads no layout
// coalesces (K4, the walk), and scattered whole 512-byte rows, for the
// bound of a kernel that reads rows in any order (P3, the receive of the
// compacted frontier exchange).  Measuring instruments, on no query path.
//
// Every thread reads `reads` sectors of `buf` at addresses it draws itself
// (a multiplicative hash of thread and step, scaled to the buffer with
// __umulhi), one 4-byte word per sector, through __ldcg so that the L1 is
// bypassed and every read is served by the L2 or, where the buffer does not
// fit it, by device memory.  The addresses do not depend on what was read,
// so the loads of one thread overlap (eight in flight per thread): this is
// the most the memory system delivers for such reads, and a chain of
// dependent loads like a walk's can only be slower.  The words are summed
// into `out` so that the loads stay.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SECTOR_WORDS = 8;  // 32 bytes
constexpr int IN_FLIGHT = 8;

__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

__global__ void sector_reads_kernel(const int* __restrict__ buf, uint32_t n_sectors, int reads,
                                    int* __restrict__ out, uint32_t seed) {
  const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t state = mix(t ^ seed);
  int sum = 0;
  for (int i = 0; i < reads; i += IN_FLIGHT) {
    int got[IN_FLIGHT];
#pragma unroll
    for (int j = 0; j < IN_FLIGHT; ++j) {
      state = state * 0x9E3779B1u + 0x85EBCA6Bu;
      const uint32_t sector = __umulhi(mix(state), n_sectors);
      got[j] = __ldcg(buf + (size_t)sector * SECTOR_WORDS);
    }
#pragma unroll
    for (int j = 0; j < IN_FLIGHT; ++j) sum += got[j];
  }
  out[t] = sum;
}

// Every warp reads `reads` rows of 512 bytes (one float4 a lane) at row
// indices it draws itself, the same on every lane, through __ldcg, eight
// rows in flight; the lanes' words are summed into `out`.
__global__ void row_reads_kernel(const float4* __restrict__ buf, uint32_t n_rows, int reads,
                                 float* __restrict__ out, uint32_t seed) {
  const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t lane = threadIdx.x & 31;
  uint32_t state = mix((t >> 5) ^ seed);
  float sum = 0.0f;
  for (int i = 0; i < reads; i += IN_FLIGHT) {
    float4 got[IN_FLIGHT];
#pragma unroll
    for (int j = 0; j < IN_FLIGHT; ++j) {
      state = state * 0x9E3779B1u + 0x85EBCA6Bu;
      const uint32_t row = __umulhi(mix(state), n_rows);
      got[j] = __ldcg(buf + (size_t)row * 32 + lane);
    }
#pragma unroll
    for (int j = 0; j < IN_FLIGHT; ++j) sum += got[j].x + got[j].y + got[j].z + got[j].w;
  }
  out[t] = sum;
}

}  // namespace

// `blocks` blocks of 256 threads (8 warps), each warp reading `reads` rows
// of 512 bytes (a multiple of eight); `out` holds blocks * 256 floats.
extern "C" int fora_row_reads(const float* buf, long long n_rows, int reads, int blocks,
                              float* out, unsigned seed, void* stream) {
  if (blocks <= 0 || reads <= 0 || reads % IN_FLIGHT || n_rows <= 0 || n_rows > 0xffffffffll ||
      (reinterpret_cast<uintptr_t>(buf) & 15))
    return (int)cudaErrorInvalidValue;
  row_reads_kernel<<<blocks, 256, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(buf), (uint32_t)n_rows, reads, out, seed);
  return (int)cudaGetLastError();
}

// `blocks` blocks of 256 threads, each thread reading `reads` sectors (a
// multiple of eight); `out` holds blocks * 256 ints.
extern "C" int fora_sector_reads(const int* buf, long long n_sectors, int reads, int blocks,
                                 int* out, unsigned seed, void* stream) {
  if (blocks <= 0 || reads <= 0 || reads % IN_FLIGHT || n_sectors <= 0 ||
      n_sectors > 0xffffffffll)
    return (int)cudaErrorInvalidValue;
  sector_reads_kernel<<<blocks, 256, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      buf, (uint32_t)n_sectors, reads, out, seed);
  return (int)cudaGetLastError();
}
