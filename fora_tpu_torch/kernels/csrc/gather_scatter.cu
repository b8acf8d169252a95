// K1/K2 · gather_scatter_add: destination-row CSR gather with a fused
// row mask and an "any row over threshold" flag.
//
//   acc[t, :] = (mask && acc[t, c] > thr[t] ? 0 : acc[t, c])
//             + sum_{e in [indptr[t], indptr[t+1])} values[src[e], :] * src_w[src[e]] * edge_w[e]
//   flag     |= any_c acc[t, c] > thr[t]          (after the add)
//
// Replaces the XLA-lowered gather + sorted scatter-add of
// fora_tpu/ops/push.py::gather_scatter_add (142-191) as used by the push
// superstep (_superstep, 315-362) and by the index bucket SpMV
// (fora_tpu/algo/fora.py::StagedForaPrograms.bucket_spmv, 352-362).  It
// computes the sum of the Pallas probe kernel
// scripts/pallas_gather_probe.py::kernel (43-56) on edges sorted by
// destination; the probe's unsorted per-edge form is P3 (row_scatter.cu).
//
// What bounds it on the H100: device-memory traffic of the random row
// gather, one B-wide f32 row (512 bytes at B = 128) per in-edge, plus the
// 4-byte source index per edge.  Design: one warp per destination row t;
// its lanes span the B columns (float4 per lane when B % 4 == 0), so every
// gathered row is one fully coalesced 512-byte read.  The sum lives in
// registers and is taken in edge order, with no atomics, so a run is
// deterministic.  Four edges are loaded ahead to keep several independent
// row reads in flight per warp.  The same warp reads and writes acc[t], so
// the mask is safe in place (the kernel reads `values`, never `acc`, of
// other rows).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int VEC>
struct Vec;

template <>
struct Vec<4> {
  using T = float4;
  __device__ static float4 load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  __device__ static void store(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
  }
  __device__ static float get(const float4& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  }
  __device__ static void set(float4& v, int i, float x) {
    if (i == 0) v.x = x; else if (i == 1) v.y = x; else if (i == 2) v.z = x; else v.w = x;
  }
};

template <>
struct Vec<1> {
  using T = float;
  __device__ static float load(const float* p) { return *p; }
  __device__ static void store(float* p, float v) { *p = v; }
  __device__ static float get(const float& v, int) { return v; }
  __device__ static void set(float& v, int, float x) { v = x; }
};

template <int VEC>
__global__ void gather_scatter_kernel(float* __restrict__ acc, const float* __restrict__ values,
                                      const int* __restrict__ indptr, const int* __restrict__ src,
                                      const float* __restrict__ edge_w,
                                      const float* __restrict__ src_w,
                                      const float* __restrict__ thr, int mask,
                                      int* __restrict__ flag, int n_rows, int B) {
  const int warps = blockDim.x >> 5;
  const long long t = (long long)blockIdx.x * warps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (t >= n_rows) return;  // whole warp leaves together: one row per warp
  const int lo = indptr[t];
  const int hi = indptr[t + 1];
  const float th = thr != nullptr ? thr[t] : 0.0f;
  bool over = false;

  for (int c0 = lane * VEC; c0 < B; c0 += 32 * VEC) {
    float sum[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) sum[i] = 0.0f;
    int e = lo;
    for (; e + 4 <= hi; e += 4) {
      int s[4];
      float w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[j] = src[e + j];  // same address in every lane: one broadcast load
        w[j] = src_w != nullptr ? src_w[s[j]] : 1.0f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        typename Vec<VEC>::T v = Vec<VEC>::load(values + (size_t)s[j] * B + c0);
        const float ew = edge_w != nullptr ? edge_w[e + j] : 1.0f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          // JAX's order: (values[s] * src_w[s]) * edge_w[e], then the add
          float x = Vec<VEC>::get(v, i);
          if (src_w != nullptr) x = x * w[j];
          if (edge_w != nullptr) x = x * ew;
          sum[i] = sum[i] + x;
        }
      }
    }
    for (; e < hi; ++e) {
      const int s = src[e];
      const float sw = src_w != nullptr ? src_w[s] : 1.0f;
      const float ew = edge_w != nullptr ? edge_w[e] : 1.0f;
      typename Vec<VEC>::T v = Vec<VEC>::load(values + (size_t)s * B + c0);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        float x = Vec<VEC>::get(v, i);
        if (src_w != nullptr) x = x * sw;
        if (edge_w != nullptr) x = x * ew;
        sum[i] = sum[i] + x;
      }
    }
    float* row = acc + (size_t)t * B + c0;
    typename Vec<VEC>::T a = Vec<VEC>::load(row);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float x = Vec<VEC>::get(a, i);
      if (mask && x > th) x = 0.0f;
      x = x + sum[i];
      over = over || (x > th);
      Vec<VEC>::set(a, i, x);
    }
    Vec<VEC>::store(row, a);
  }
  if (flag != nullptr) {
    // every lane of the warp reaches this point (lanes past B skip the loop)
    if (__any_sync(0xffffffffu, over) && lane == 0) *flag = 1;
  }
}

}  // namespace

extern "C" int fora_gather_scatter_add(float* acc, const float* values, const int* indptr,
                                       const int* src, const float* edge_w, const float* src_w,
                                       const float* thr, int mask, int* flag, int n_rows, int B,
                                       void* stream) {
  if (n_rows <= 0 || B <= 0) return (int)cudaGetLastError();
  const int threads = 256;  // 8 warps = 8 destination rows per block
  const int rows_per_block = threads / 32;
  const long long blocks = ((long long)n_rows + rows_per_block - 1) / rows_per_block;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bool vec4 = (B % 4 == 0) && ((reinterpret_cast<uintptr_t>(acc) & 15) == 0) &&
                    ((reinterpret_cast<uintptr_t>(values) & 15) == 0);
  if (vec4) {
    gather_scatter_kernel<4><<<(unsigned)blocks, threads, 0, st>>>(
        acc, values, indptr, src, edge_w, src_w, thr, mask, flag, n_rows, B);
  } else {
    gather_scatter_kernel<1><<<(unsigned)blocks, threads, 0, st>>>(
        acc, values, indptr, src, edge_w, src_w, thr, mask, flag, n_rows, B);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* fora_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
