// P1 · ring all-gather hop and P2 · ring reduce-scatter hop, in pull form.
//
//   P1, hop s, shard h:  bufs[h][blk]   = bufs[h-1][blk],          blk = (h-1-s) mod G
//   P2, hop s, shard h:  comm_h[(s+1)%2] = comm_{h-1}[s%2] + x_h[blk], blk = (h-s-2) mod G
//                        (hop 0 reads x_{h-1}[blk] in place of comm_{h-1}[0])
//
// Replaces the Pallas kernels of fora_tpu/ops/ring.py: _ring_all_gather_kernel
// (107-156) and _ring_reduce_scatter_kernel (32-104), which loop over the G-1
// hops inside one kernel and push each block to the right neighbour by
// remote DMA, ordered by DMA semaphores.  Here every hop of every shard is
// one launch on the RECEIVING shard's device: it reads the left neighbour's
// buffer through a plain device pointer (a peer pointer when the neighbour
// lives on another card, after cudaDeviceEnablePeerAccess) and writes only
// its own memory.  Ordering is outside the kernel (fora_tpu_torch/ops/ring.py):
// with every shard on one card the launches share one stream and stream
// order is the whole protocol; across cards, CUDA events order each hop
// after the neighbours' previous hop.  A kernel that spun on a flag set by
// a later launch would deadlock when all shards share one stream, so the
// persistent, flag-signalled form is left for a several-card machine.
//
// What bounds it on the H100: bytes.  A hop moves n_loc * B floats (P1: one
// read, one write; P2: two reads, one write), from device memory on one
// card or over NVLink across cards.  Design: a grid-stride loop of 16-byte
// (float4) loads and stores, consecutive threads on consecutive addresses,
// with a scalar loop for the tail and for buffers that are not 16-byte
// aligned.  The add is one f32 add in JAX's operand order (received partial
// + own block), so the result equals the plain PyTorch hop loop bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void ring_copy4_kernel(float4* __restrict__ dst, const float4* __restrict__ src,
                                  long long n4) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += stride) {
    dst[i] = src[i];
  }
}

__global__ void ring_add4_kernel(float4* __restrict__ out, const float4* __restrict__ recv,
                                 const float4* __restrict__ own, long long n4) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += stride) {
    const float4 a = recv[i];
    const float4 b = own[i];
    out[i] = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  }
}

// scalar elements [lo, n): the tail after the float4 part, or all of an
// unaligned call (lo = 0); recv == nullptr makes it a copy of own
__global__ void ring_scalar_kernel(float* __restrict__ out, const float* __restrict__ recv,
                                   const float* __restrict__ own, long long lo, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = lo + (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    out[i] = recv != nullptr ? recv[i] + own[i] : own[i];
  }
}

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;  // grid-stride beyond 16 blocks per SM

unsigned grid_for(long long units) {
  long long blocks = (units + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return (unsigned)(blocks > 0 ? blocks : 1);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// out = recv + own (recv == nullptr: out = own) over n floats
int ring_hop(float* out, const float* recv, const float* own, long long n, cudaStream_t st) {
  if (n <= 0) return (int)cudaGetLastError();
  const bool vec = aligned16(out) && aligned16(own) && (recv == nullptr || aligned16(recv));
  long long lo = 0;
  if (vec) {
    const long long n4 = n / 4;
    if (n4 > 0) {
      if (recv != nullptr) {
        ring_add4_kernel<<<grid_for(n4), kThreads, 0, st>>>(
            reinterpret_cast<float4*>(out), reinterpret_cast<const float4*>(recv),
            reinterpret_cast<const float4*>(own), n4);
      } else {
        ring_copy4_kernel<<<grid_for(n4), kThreads, 0, st>>>(
            reinterpret_cast<float4*>(out), reinterpret_cast<const float4*>(own), n4);
      }
    }
    lo = n4 * 4;
  }
  if (lo < n) {
    ring_scalar_kernel<<<grid_for(n - lo), kThreads, 0, st>>>(out, recv, own, lo, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// P1 hop: dst[i] = src[i] for i < n (src may be a peer pointer)
extern "C" int fora_ring_copy(float* dst, const float* src, long long n, void* stream) {
  return ring_hop(dst, nullptr, src, n, reinterpret_cast<cudaStream_t>(stream));
}

// P2 hop: out[i] = recv[i] + own[i] for i < n (recv may be a peer pointer)
extern "C" int fora_ring_add(float* out, const float* recv, const float* own, long long n,
                             void* stream) {
  return ring_hop(out, recv, own, n, reinterpret_cast<cudaStream_t>(stream));
}

// Let `device` read memory of `peer` through plain pointers.  Refuses
// (cudaErrorPeerAccessUnsupported) where the pair has no peer access;
// an already enabled pair is not an error.  Restores the current device.
extern "C" int fora_enable_peer_access(int device, int peer) {
  int can = 0;
  cudaError_t e = cudaDeviceCanAccessPeer(&can, device, peer);
  if (e != cudaSuccess) return (int)e;
  if (!can) return (int)cudaErrorPeerAccessUnsupported;
  int prev = 0;
  e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return (int)e;
  e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceEnablePeerAccess(peer, 0);
  if (e == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear the (non-sticky) error this call recorded
    e = cudaSuccess;
  }
  const cudaError_t e2 = cudaSetDevice(prev);
  return (int)(e != cudaSuccess ? e : e2);
}
