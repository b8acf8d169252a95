// K3 · topk_bounds: per-column top-(k+1) of p + contrib with the Bernstein
// confidence-bound epilogue of the split accept.
//
// Replaces fora_tpu/algo/bounds.py::_topk_with_bounds_split (112-142) over
// fora_tpu/ops/topk.py::topk_rows_chunked (30-127), which XLA lowered to a
// scan of slab-wise lax.top_k plus a merge.  Per column b it returns
//   vals/idx [B, k]   the k largest p + contrib, ties by id ascending,
//   lb/ub [B, k]      p_at + Bernstein LB/UB of mu_hat = max(val - p_at, 0),
//   lbk [B]           min lb,
//   ub_excl [B]       Bernstein UB of the (k+1)-th value (0 when k >= n),
//   accept [B]        lbk * (1 + eps) >= ub_excl.
//
// Passes:
//   1. grid (column, slab): each block scores one column of a SEG-row slab
//      into shared memory, bitonic-sorts it by (value desc, id asc) and
//      writes the slab's top-kk candidates to scratch.
//   2. the same kernel on the candidate lists, SEG at a time, until one
//      list of kk per column is left (two more rounds at n = 2^19).
//   3. one block per column: p at the winners and the epilogue in f32,
//      exactly as bounds.py:57-71, 130-142 computes it.
//
// What bounds it on the H100: pass 1 reads p and contrib once, 8 bytes per
// element of [n, B], but the layout is node-major, so one column is a
// strided read (4 useful bytes per 32-byte sector).  The column index is
// the fast grid dimension, so the blocks of one slab run together and the
// sectors they share are served from L2 rather than device memory; a
// column-major layout for the accept is a later question.  The sort is
// shared-memory bound, SEG log^2 SEG / 2 compare-exchanges per slab.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int SEG = 4096;       // elements sorted by one block
constexpr int SORT_THREADS = 1024;
constexpr int NO_ID = 0x7fffffff;

__device__ __forceinline__ bool before(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// Scores a segment into shared memory, sorts it, writes the top kk.
// Dense mode (cand_v == nullptr): element j of segment `seg` is row
// seg * SEG + j of column b, scored p + contrib.  Candidate mode: element j
// is entry seg * SEG + j of column b's list of c_in candidates.
__global__ void segment_topk_kernel(const float* __restrict__ p,
                                    const float* __restrict__ contrib, int n, int B,
                                    const float* __restrict__ cand_v,
                                    const int* __restrict__ cand_i, int c_in,
                                    float* __restrict__ out_v, int* __restrict__ out_i, int kk,
                                    int n_seg) {
  __shared__ float sv[SEG];
  __shared__ int si[SEG];
  const int b = blockIdx.x;
  const int seg = blockIdx.y;
  for (int j = threadIdx.x; j < SEG; j += blockDim.x) {
    const long long g = (long long)seg * SEG + j;
    float v = -INFINITY;
    int id = NO_ID;
    if (cand_v == nullptr) {
      if (g < n) {
        const size_t off = (size_t)g * B + b;
        v = p[off] + contrib[off];
        id = (int)g;
      }
    } else if (g < c_in) {
      const size_t off = (size_t)b * c_in + g;
      v = cand_v[off];
      id = cand_i[off];
    }
    sv[j] = v;
    si[j] = id;
  }
  __syncthreads();
  for (int k = 2; k <= SEG; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < SEG; i += blockDim.x) {
        const int x = i ^ j;
        if (x > i) {
          const float va = sv[i], vb = sv[x];
          const int ia = si[i], ib = si[x];
          const bool swap = ((i & k) == 0) ? before(vb, ib, va, ia) : before(va, ia, vb, ib);
          if (swap) {
            sv[i] = vb; sv[x] = va;
            si[i] = ib; si[x] = ia;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int j = threadIdx.x; j < kk; j += blockDim.x) {
    const size_t off = ((size_t)b * n_seg + seg) * kk + j;
    out_v[off] = sv[j];
    out_i[off] = si[j];
  }
}

__device__ __forceinline__ float bernstein_ub(float mu, float s2) {
  const float root = (sqrtf(s2) + sqrtf(s2 + 4.0f * (mu + s2 / 3.0f))) * 0.5f;
  return root * root;
}

__global__ void bounds_epilogue_kernel(const float* __restrict__ cand_v,
                                       const int* __restrict__ cand_i, int kk,
                                       const float* __restrict__ p, int B, int k, float s2,
                                       float one_plus_eps, float* __restrict__ vals,
                                       int* __restrict__ idx, float* __restrict__ lb,
                                       float* __restrict__ ub, float* __restrict__ lbk,
                                       float* __restrict__ ub_excl,
                                       unsigned char* __restrict__ accept) {
  __shared__ float red[256];
  const int b = blockIdx.x;
  float lo = INFINITY;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const float v = cand_v[(size_t)b * kk + j];
    const int id = cand_i[(size_t)b * kk + j];
    const float pa = p[(size_t)id * B + b];
    const float mu = fmaxf(v - pa, 0.0f);
    const float ubm = bernstein_ub(mu, s2);
    const float lbm = fmaxf(mu - s2 / 3.0f - sqrtf(s2 * ubm), 0.0f);
    const float l = pa + lbm;
    vals[(size_t)b * k + j] = v;
    idx[(size_t)b * k + j] = id;
    lb[(size_t)b * k + j] = l;
    ub[(size_t)b * k + j] = pa + ubm;
    lo = fminf(lo, l);
  }
  red[threadIdx.x] = lo;
  __syncthreads();
  for (int s = blockDim.x >> 1; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] = fminf(red[threadIdx.x], red[threadIdx.x + s]);
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float m = red[0];
    const float ue = kk > k ? bernstein_ub(cand_v[(size_t)b * kk + k], s2) : 0.0f;
    lbk[b] = m;
    ub_excl[b] = ue;
    accept[b] = (m * one_plus_eps >= ue) ? 1 : 0;
  }
}

}  // namespace

extern "C" int fora_topk_segment() { return SEG; }

// scratch_v/scratch_i: two ping-pong halves of `half` elements each, where
// half >= B * ceil(n / SEG) * kk (the first pass's output).
extern "C" int fora_topk_bounds(const float* p, const float* contrib, int n, int B, int k, int kk,
                                float s2, float one_plus_eps, float* scratch_v, int* scratch_i,
                                long long half, float* vals, int* idx, float* lb, float* ub,
                                float* lbk, float* ub_excl, unsigned char* accept,
                                void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (n <= 0 || B <= 0 || k <= 0 || kk < k || kk > SEG) return (int)cudaErrorInvalidValue;
  int n_seg = (n + SEG - 1) / SEG;
  if ((long long)B * n_seg * kk > half) return (int)cudaErrorInvalidValue;
  float* cur_v = scratch_v;
  int* cur_i = scratch_i;
  segment_topk_kernel<<<dim3(B, n_seg), SORT_THREADS, 0, st>>>(p, contrib, n, B, nullptr, nullptr,
                                                              0, cur_v, cur_i, kk, n_seg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int c_in = n_seg * kk;
  int side = 0;
  while (n_seg > 1) {
    n_seg = (c_in + SEG - 1) / SEG;
    float* nxt_v = scratch_v + (side ^ 1) * half;
    int* nxt_i = scratch_i + (side ^ 1) * half;
    segment_topk_kernel<<<dim3(B, n_seg), SORT_THREADS, 0, st>>>(
        nullptr, nullptr, n, B, cur_v, cur_i, c_in, nxt_v, nxt_i, kk, n_seg);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    cur_v = nxt_v;
    cur_i = nxt_i;
    side ^= 1;
    c_in = n_seg * kk;
  }
  bounds_epilogue_kernel<<<B, 256, 0, st>>>(cur_v, cur_i, kk, p, B, k, s2, one_plus_eps, vals,
                                            idx, lb, ub, lbk, ub_excl, accept);
  return (int)cudaGetLastError();
}
