// P1 · ring all-gather hop and P2 · ring reduce-scatter hop, in pull form;
// and P2 in one pass where every shard sits on one card.
//
//   P1, hop s, shard h:  bufs[h][blk]   = bufs[h-1][blk],          blk = (h-1-s) mod G
//   P2, hop s, shard h:  comm_h[(s+1)%2] = comm_{h-1}[s%2] + x_h[blk], blk = (h-s-2) mod G
//                        (hop 0 reads x_{h-1}[blk] in place of comm_{h-1}[0])
//   P2, one pass:        out[h][i] = ((x_{h+1}[h][i] + x_{h+2}[h][i]) + ...) + x_{h+G}[h][i]
//                        for every shard h and element i of block h (shards mod G)
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
//
// The one pass.  The ring's G - 1 dependent hops exist because the TPU's
// shards sat on separate chips that reached only their neighbours.  With
// every shard on one card the G partials lie in one memory, and the hops
// only add traffic: 3 (G - 1) G blocks moved where the function needs G
// blocks read per output block and one written, (G + 1) G blocks in all.
// So one launch computes every shard's output block: block row h of the
// grid owns output block h, a grid-stride loop over its float4s reads the
// same float4 of each partial (the G loads issued together, up to
// kOnepassUnroll at a time), adds them in registers in the ring's own
// order (the partial of shard h + 1 first, then h + 2, ..., shard h's own
// last: the order the hops add in) and writes one float4.  So the result
// equals the hop loop's bit for bit.  The G partial pointers come in the
// kernel's parameters; each block puts them in shared memory in its
// summation order, picking each with constant indices only.  Bound by
// bytes; no reuse to stage, so no TMA.  A scalar kernel takes blocks that
// are not whole float4s or partials that are not 16-byte aligned.
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

constexpr int kMaxShards = 32;
constexpr int kOnepassUnroll = 4;

struct Partials {
  const float* x[kMaxShards];
};

// block row h = blockIdx.y: out[h * n_blk + i] for i < n_blk, the partials
// summed in the ring's order; VEC4: n_blk a multiple of 4, every pointer
// 16-byte aligned
template <bool VEC4>
__global__ void reduce_scatter_onepass_kernel(float* __restrict__ out, const Partials parts, int G,
                                              long long n_blk) {
  __shared__ const float* order[kMaxShards];
  const int h = blockIdx.y;
  if (threadIdx.x < G) {
    const int want = (h + 1 + (int)threadIdx.x) % G;
    const float* p = nullptr;
#pragma unroll
    for (int k = 0; k < kMaxShards; ++k) {
      if (k == want) p = parts.x[k];
    }
    order[threadIdx.x] = p;
  }
  __syncthreads();
  const long long base = (long long)h * n_blk;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long n = VEC4 ? n_blk >> 2 : n_blk;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    if (VEC4) {
      float4 acc = __ldg(reinterpret_cast<const float4*>(order[0] + base) + i);
      for (int j0 = 1; j0 < G; j0 += kOnepassUnroll) {
        float4 v[kOnepassUnroll];
#pragma unroll
        for (int u = 0; u < kOnepassUnroll; ++u) {
          v[u] = j0 + u < G ? __ldg(reinterpret_cast<const float4*>(order[j0 + u] + base) + i)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < kOnepassUnroll; ++u) {
          if (j0 + u < G) {
            acc.x += v[u].x;
            acc.y += v[u].y;
            acc.z += v[u].z;
            acc.w += v[u].w;
          }
        }
      }
      reinterpret_cast<float4*>(out + base)[i] = acc;
    } else {
      float acc = __ldg(order[0] + base + i);
      for (int j = 1; j < G; ++j) acc += __ldg(order[j] + base + i);
      out[base + i] = acc;
    }
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

// P2 with every shard on one card: out ([G * n_blk] floats) block h = the
// sum over shards of block h of the G partials xs[0..G-1] (each [G *
// n_blk] floats, a host array of device pointers), in the ring's order
extern "C" int fora_reduce_scatter_onepass(float* out, const float* const* xs, int G,
                                           long long n_blk, void* stream) {
  if (G < 2 || G > kMaxShards || n_blk < 0 || xs == nullptr) return (int)cudaErrorInvalidValue;
  if (n_blk == 0) return (int)cudaGetLastError();
  Partials parts = {};
  bool vec = aligned16(out) && n_blk % 4 == 0;
  for (int k = 0; k < G; ++k) {
    if (xs[k] == nullptr) return (int)cudaErrorInvalidValue;
    parts.x[k] = xs[k];
    vec = vec && aligned16(xs[k]);
  }
  const long long units = vec ? n_blk / 4 : n_blk;
  long long per_row = kMaxBlocks / G;
  const long long want = (units + kThreads - 1) / kThreads;
  if (want < per_row) per_row = want;
  const dim3 grid((unsigned)(per_row > 0 ? per_row : 1), (unsigned)G);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (vec) {
    reduce_scatter_onepass_kernel<true><<<grid, kThreads, 0, st>>>(out, parts, G, n_blk);
  } else {
    reduce_scatter_onepass_kernel<false><<<grid, kThreads, 0, st>>>(out, parts, G, n_blk);
  }
  return (int)cudaGetLastError();
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
