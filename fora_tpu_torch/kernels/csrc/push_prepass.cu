// K1 pre-pass · push_prepass: the elementwise half of one push superstep.
//
//   active     = r > thr[v]
//   p         += active ? (dangling ? r : alpha * r) : 0          (in place)
//   contrib    = active && !dangling ? (1 - alpha) * r / max(wsum[v], 1e-30) : 0
//
// Replaces the elementwise head of fora_tpu/ops/push.py::_superstep
// (315-333), which XLA fused into its gather program.  It cannot be fused
// into the gather kernel (gather_scatter.cu): the gather reads `contrib`
// rows of other nodes, a grid-wide dependency, so the superstep is two
// launches on one stream.
//
// What bounds it on the H100: device-memory bandwidth, 16 bytes per element
// of the [n, B] state (read r and p, write p and contrib) plus the per-row
// thr/deg/wsum, which every thread of a row reads from L1/L2.  Design: one
// thread per element in a grid-stride loop, consecutive threads on
// consecutive columns of a row, so every access is coalesced.  Built with
// --fmad=false, so p + alpha * r rounds the product first, as XLA does.
//
// K1-back pre-pass · backward_prepass: the same half of one superstep of
// BiPPR's backward push (fora_tpu/algo/bippr.py::backward_push, 66-72),
// where a dangling node settles its whole residue and spreads it with
// (1 - alpha) / alpha (the absorbing-dangling convention):
//
//   active  = r > rmax_b
//   p      += active ? (dangling ? r : alpha * r) : 0                  (in place)
//   spread  = active ? (dangling ? c_dangling * r : c * r) : 0
//
// with c = 1 - alpha and c_dangling = (1 - alpha) / alpha as f32.  The
// gather half is K1's kernel over the out-CSR (gather_scatter.cu).  Same
// bound and layout as the forward pre-pass, without the per-row divide.
#include <cuda_runtime.h>

namespace {

__global__ void backward_prepass_kernel(float* __restrict__ p, const float* __restrict__ r,
                                        float* __restrict__ spread, float rmax_b,
                                        const int* __restrict__ deg, float alpha, float c,
                                        float c_dangling, long long total, int B) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    const long long v = i / B;
    const float rv = r[i];
    const float ar = rv > rmax_b ? rv : 0.0f;
    const bool dangling = deg[v] == 0;
    p[i] = p[i] + (dangling ? ar : alpha * ar);
    spread[i] = dangling ? c_dangling * ar : c * ar;
  }
}

__global__ void push_prepass_kernel(float* __restrict__ p, const float* __restrict__ r,
                                    float* __restrict__ contrib, const float* __restrict__ thr,
                                    const int* __restrict__ deg, const float* __restrict__ wsum,
                                    float alpha, float one_minus_alpha, long long total, int B) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    const long long v = i / B;
    const float rv = r[i];
    const float ar = rv > thr[v] ? rv : 0.0f;
    const bool dangling = deg[v] == 0;
    p[i] = p[i] + (dangling ? ar : alpha * ar);
    contrib[i] = dangling ? 0.0f : one_minus_alpha * ar / fmaxf(wsum[v], 1e-30f);
  }
}

}  // namespace

extern "C" int fora_push_prepass(float* p, const float* r, float* contrib, const float* thr,
                                 const int* deg, const float* wsum, float alpha,
                                 float one_minus_alpha, long long n, int B, void* stream) {
  const long long total = n * (long long)B;
  if (total <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond ~64 blocks per SM
  push_prepass_kernel<<<(unsigned)blocks, threads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      p, r, contrib, thr, deg, wsum, alpha, one_minus_alpha, total, B);
  return (int)cudaGetLastError();
}

extern "C" int fora_backward_prepass(float* p, const float* r, float* spread, float rmax_b,
                                     const int* deg, float alpha, float c, float c_dangling,
                                     long long n, int B, void* stream) {
  const long long total = n * (long long)B;
  if (total <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  backward_prepass_kernel<<<(unsigned)blocks, threads, 0,
                            reinterpret_cast<cudaStream_t>(stream)>>>(
      p, r, spread, rmax_b, deg, alpha, c, c_dangling, total, B);
  return (int)cudaGetLastError();
}
