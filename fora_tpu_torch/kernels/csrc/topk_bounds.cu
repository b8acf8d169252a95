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
// The selection is a threshold and a filter, so that [n, B] is read once,
// coalesced, and only what survives is sorted ("before" = value descending,
// then id ascending; kk = k + 1):
//   1. threshold: tau_b = the kk-th largest score over every stride-th row
//      of column b (segment_topk_kernel, values only, over 1/stride of the
//      rows, plus merge rounds).  At least kk rows score >= tau_b, so the
//      true first kk all do.
//   2. filter (filter_kernel): one pass over the node-major [n, B] as a
//      flat array, 16 bytes per thread, neighbouring threads on
//      neighbouring addresses.  v = p + contrib is the same f32 add as in
//      pass 1 (the build keeps --fmad=false).  (v, id) is appended to column
//      b's list when v > tau_b, or v == tau_b and (tau_b != 0 or id < kk): a
//      zero at id >= kk has kk rows before it when no score is negative
//      (each of ids 0..kk-1 is positive or a zero with a lower id), and a
//      negative score beside tau_b == 0 sends the column to the dense path.
//      The append order varies from run to run; the result does not, since
//      step 3 orders unique (v, id) keys.
//   3. one block per column (candidates_kernel) brings the list's first kk
//      to the front in shared memory and runs the epilogue on them, in f32
//      exactly as bounds.py:57-71, 130-142 computes it.
//   4. a column whose list overflowed its capacity (or came out short) is
//      finished by the dense path: every SEG-row slab of the column
//      selected, the slabs' candidates merged, then the epilogue.  The
//      decision is made on the device from the column's counter; the dense
//      kernels always launch and their blocks return at once where no
//      column is listed.  Small inputs take the dense path by shape
//      (stride == 0).
//
// The selection inside a block (block_select_sorted) is a pruned bitonic
// network: chunks of K2 = 2^ceil(log2 kk) keys are sorted in alternating
// directions, then pairs of chunks are halved (one exchange at distance K2
// leaves the pair's first K2 in the lower chunk, log2 K2 stages sort it)
// until one chunk is left: about 35 L compare-exchanges for L = 4096, kk =
// 51, against 78 L for the full sort.  Stages at distance < 32 stay inside
// one warp's 32 keys and need no block barrier.
//
// What bounds it on the H100: bytes.  p and contrib are read once (8 bytes
// per entry of [n, B]); the sample re-reads 1/stride of the rows, by
// sectors.  The per-call state (counters, flags, the dense column list) is
// reset by the call's first kernel, so nothing carries over between calls.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int SEG = 4096;       // keys one block selects from; list capacity
constexpr int SORT_THREADS = 1024;
constexpr int FILTER_THREADS = 256;
constexpr int DENSE_SLOTS = 8;     // grid width of the dense pass behind a filter
constexpr int NO_ID = 0x7fffffff;

// state: [0] columns on the dense path, [1, 1+B) candidates per column,
// [1+B, 1+2B) per-column "needs the dense path" flag, [1+2B, 1+3B) the
// dense columns in the order they were found
__device__ __forceinline__ int* st_count(int* state) { return state + 1; }
__device__ __forceinline__ int* st_flag(int* state, int B) { return state + 1 + B; }
__device__ __forceinline__ int* st_cols(int* state, int B) { return state + 1 + 2 * B; }

template <bool IDS>
__device__ __forceinline__ bool before(float va, int ia, float vb, int ib) {
  if (IDS) return va > vb || (va == vb && ia < ib);
  return va > vb;
}

// Orders the keys at i < x: descending puts the one that comes before at i.
template <bool IDS>
__device__ __forceinline__ void cmpx(float* sv, int* si, int i, int x, bool desc) {
  const float va = sv[i], vb = sv[x];
  int ia = 0, ib = 0;
  if (IDS) {
    ia = si[i];
    ib = si[x];
  }
  const bool swap = desc ? before<IDS>(vb, ib, va, ia) : before<IDS>(va, ia, vb, ib);
  if (swap) {
    sv[i] = vb;
    sv[x] = va;
    if (IDS) {
      si[i] = ib;
      si[x] = ia;
    }
  }
}

// Thread t handles keys t, t + blockDim, ...: a stage at distance < 32 only
// touches keys of the warp's own aligned groups of 32.
__device__ __forceinline__ void stage_sync(int j, int j_next) {
  if (j >= 32 || j_next >= 32) __syncthreads(); else __syncwarp();
}

// Chunk c of K2 = 1 << lk keys lies at c * (K2 << r) in round r.
__device__ __forceinline__ int chunk_pos(int a, int lk, int r) {
  return ((a >> lk) << (lk + r)) | (a & ((1 << lk) - 1));
}

// Leaves the first K2 = 1 << lk of the L keys in sv (and si), by `before`,
// sorted at [0, K2).  L and K2 are powers of two, K2 <= L <= SEG; the rest of
// the array is scratch afterwards.  Called by the whole block after a
// __syncthreads(); ends with one.
template <bool IDS>
__device__ void block_select_sorted(float* sv, int* si, int L, int lk) {
  const int K2 = 1 << lk;
  // every chunk sorted, even chunks descending and odd ones ascending
  for (int k = 2; k <= K2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < L; i += blockDim.x) {
        const int x = i ^ j;
        if (x > i) cmpx<IDS>(sv, si, i, x, (i & k) == 0);
      }
      stage_sync(j, j > 1 ? (j >> 1) : (k < K2 ? k : 32));
    }
  }
  // a descending chunk and its ascending neighbour are one bitonic run
  int r = 0;
  for (int A = L; A > K2; A >>= 1, ++r) {
    for (int h = threadIdx.x; h < (A >> 1); h += blockDim.x) {
      const int a = ((h >> lk) << (lk + 1)) | (h & (K2 - 1));
      cmpx<IDS>(sv, si, chunk_pos(a, lk, r), chunk_pos(a + K2, lk, r), true);
    }
    __syncthreads();
    for (int j = K2 >> 1; j > 0; j >>= 1) {
      for (int h = threadIdx.x; h < (A >> 1); h += blockDim.x) {
        const int x = h ^ j;
        if (x > h)
          cmpx<IDS>(sv, si, chunk_pos(h, lk, r + 1), chunk_pos(x, lk, r + 1),
                    ((h >> lk) & 1) == 0);
      }
      stage_sync(j, j > 1 ? (j >> 1) : 32);
    }
  }
}

__device__ __forceinline__ int pow2_at_least(int c, int floor_pow2) {
  int L = floor_pow2;
  while (L < c) L <<= 1;
  return L;
}

// Selects the first kk keys of each segment of SEG keys and writes them to
// out_v/out_i[(b * n_seg + seg) * kk ...].
// Dense mode (cand_v == nullptr): key j of segment `seg` is row
// (seg * SEG + j) * stride of column b, scored p + contrib, n_keys =
// ceil(n / stride).  Candidate mode: key j is entry seg * SEG + j of column
// b's list of n_keys candidates.
// Columns: all B, or (dense_cols) the columns the state lists for the dense
// path, each block taking every gridDim.x-th of them.  `reset` (the sample
// pass, which runs first) zeroes the state.
template <bool IDS>
__global__ void __launch_bounds__(SORT_THREADS)
segment_topk_kernel(const float* __restrict__ p, const float* __restrict__ contrib, int n, int B,
                    int stride, const float* __restrict__ cand_v,
                    const int* __restrict__ cand_i, int n_keys, float* __restrict__ out_v,
                    int* __restrict__ out_i, int kk, int lk, int n_seg, int* state,
                    bool dense_cols, bool reset) {
  __shared__ float sv[SEG];
  __shared__ int si[IDS ? SEG : 1];
  const int seg = blockIdx.y;
  const int n_cols = dense_cols ? state[0] : B;
  const int first = seg * SEG;
  const int L = pow2_at_least(min(SEG, n_keys - first), 1 << lk);
  for (int jc = blockIdx.x; jc < n_cols; jc += gridDim.x) {
    const int b = dense_cols ? st_cols(state, B)[jc] : jc;
    for (int j = threadIdx.x; j < L; j += blockDim.x) {
      const int g = first + j;
      float v = -INFINITY;
      int id = NO_ID;
      if (g < n_keys) {
        if (cand_v == nullptr) {
          const long long row = (long long)g * stride;
          const size_t off = (size_t)row * B + b;
          v = p[off] + contrib[off];
          id = (int)row;
        } else {
          const size_t off = (size_t)b * n_keys + g;
          v = cand_v[off];
          if (IDS) id = cand_i[off];
        }
      }
      sv[j] = v;
      if (IDS) si[j] = id;
    }
    __syncthreads();
    block_select_sorted<IDS>(sv, si, L, lk);
    for (int j = threadIdx.x; j < kk; j += blockDim.x) {
      const size_t off = ((size_t)b * n_seg + seg) * kk + j;
      out_v[off] = sv[j];
      if (IDS) out_i[off] = si[j];
    }
    __syncthreads();
  }
  if (reset && seg == 0 && threadIdx.x == 0) {
    for (int b = blockIdx.x; b < B; b += gridDim.x) {
      st_count(state)[b] = 0;
      st_flag(state, B)[b] = 0;
    }
    if (blockIdx.x == 0) state[0] = 0;
  }
}

// The dense path for every column, by shape: no filter ran.
__global__ void all_dense_kernel(int* state, int B) {
  for (int b = blockIdx.x * blockDim.x + threadIdx.x; b < B; b += gridDim.x * blockDim.x) {
    st_count(state)[b] = 0;
    st_flag(state, B)[b] = 0;
    st_cols(state, B)[b] = b;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) state[0] = B;
}

template <int V>
__device__ __forceinline__ void load_vec(const float* __restrict__ base, size_t at, float (&out)[V]);
template <>
__device__ __forceinline__ void load_vec<4>(const float* __restrict__ base, size_t at,
                                            float (&out)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(base) + at);
  out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
}
template <>
__device__ __forceinline__ void load_vec<1>(const float* __restrict__ base, size_t at,
                                            float (&out)[1]) {
  out[0] = __ldg(base + at);
}

// One pass over [n, B] as a flat array of vectors of V floats: thread g of
// the grid owns column group g % (B / V) and rows g / (B / V), + RL, ...,
// so a warp's loads are contiguous and a thread's thresholds stay in
// registers.  V = 4 needs B % 4 == 0 and 16-byte aligned bases.  One row per
// thread and turn: more loads in flight per thread measured no faster.
template <int V>
__global__ void __launch_bounds__(FILTER_THREADS)
filter_kernel(const float* __restrict__ p, const float* __restrict__ contrib, int n, int B, int kk,
              const float* __restrict__ tau, int tau_stride, int cap, int* state,
              float* __restrict__ list_v, int* __restrict__ list_i) {
  const int G = B / V;
  const long long threads = (long long)gridDim.x * blockDim.x;
  const long long RL = threads / G;          // rows in flight over the grid
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= RL * G) return;
  const int cg = (int)(g % G);
  const int b0 = cg * V;
  float t[V];
#pragma unroll
  for (int e = 0; e < V; ++e) t[e] = tau[(size_t)(b0 + e) * tau_stride];
  int* count = st_count(state);
  int* flag = st_flag(state, B);
  for (long long r = g / G; r < n; r += RL) {
    float a[V], c[V];
    load_vec<V>(p, (size_t)r * G + cg, a);
    load_vec<V>(contrib, (size_t)r * G + cg, c);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float v = a[e] + c[e];
      if (v >= t[e]) {
        if (v > t[e] || t[e] != 0.0f || r < kk) {
          const int b = b0 + e;
          const int pos = atomicAdd(&count[b], 1);
          if (pos < cap) {
            list_v[(size_t)b * cap + pos] = v;
            list_i[(size_t)b * cap + pos] = (int)r;
          }
        }
      } else if (v < 0.0f && t[e] == 0.0f) {
        flag[b0 + e] = 1;   // the zero rule assumes no negative score
      }
    }
  }
}

__device__ __forceinline__ float bernstein_ub(float mu, float s2) {
  const float root = (sqrtf(s2) + sqrtf(s2 + 4.0f * (mu + s2 / 3.0f))) * 0.5f;
  return root * root;
}

// The accept's epilogue for column b on its first kk keys cv/ci (shared or
// global memory), by the whole block; `red` is 32 floats of shared memory.
__device__ void bounds_epilogue(const float* cv, const int* ci, int b, int kk,
                                const float* __restrict__ p, int B, int k, float s2,
                                float one_plus_eps, float* __restrict__ vals,
                                int* __restrict__ idx, float* __restrict__ lb,
                                float* __restrict__ ub, float* __restrict__ lbk,
                                float* __restrict__ ub_excl, unsigned char* __restrict__ accept,
                                float* red) {
  float lo = INFINITY;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const float v = cv[j];
    const int id = ci[j];
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
  // a minimum is the same in any order
  for (int s = 16; s > 0; s >>= 1) lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, s));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = lo;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = INFINITY;
    for (int w = 0; w < (int)((blockDim.x + 31) >> 5); ++w) m = fminf(m, red[w]);
    const float ue = kk > k ? bernstein_ub(cv[k], s2) : 0.0f;
    lbk[b] = m;
    ub_excl[b] = ue;
    accept[b] = (m * one_plus_eps >= ue) ? 1 : 0;
  }
  __syncthreads();
}

// Step 3: one block per column.  A list that overflowed, came out short of
// kk, or belongs to a flagged column is handed to the dense path instead.
__global__ void __launch_bounds__(SORT_THREADS)
candidates_kernel(const float* __restrict__ list_v, const int* __restrict__ list_i, int cap,
                  int* state, const float* __restrict__ p, int B, int k, int kk, int lk, float s2,
                  float one_plus_eps, float* __restrict__ vals, int* __restrict__ idx,
                  float* __restrict__ lb, float* __restrict__ ub, float* __restrict__ lbk,
                  float* __restrict__ ub_excl, unsigned char* __restrict__ accept) {
  __shared__ float sv[SEG];
  __shared__ int si[SEG];
  __shared__ float red[32];
  const int b = blockIdx.x;
  const int c = st_count(state)[b];
  if (c > cap || c < kk || st_flag(state, B)[b] != 0) {
    if (threadIdx.x == 0) st_cols(state, B)[atomicAdd(&state[0], 1)] = b;
    return;
  }
  const int L = pow2_at_least(c, 1 << lk);
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    sv[j] = j < c ? list_v[(size_t)b * cap + j] : -INFINITY;
    si[j] = j < c ? list_i[(size_t)b * cap + j] : NO_ID;
  }
  __syncthreads();
  block_select_sorted<true>(sv, si, L, lk);
  bounds_epilogue(sv, si, b, kk, p, B, k, s2, one_plus_eps, vals, idx, lb, ub, lbk, ub_excl,
                  accept, red);
}

// The epilogue of the dense columns, on their merged lists of kk.
__global__ void dense_epilogue_kernel(const float* __restrict__ cand_v,
                                      const int* __restrict__ cand_i, int kk, int* state,
                                      const float* __restrict__ p, int B, int k, float s2,
                                      float one_plus_eps, float* __restrict__ vals,
                                      int* __restrict__ idx, float* __restrict__ lb,
                                      float* __restrict__ ub, float* __restrict__ lbk,
                                      float* __restrict__ ub_excl,
                                      unsigned char* __restrict__ accept) {
  __shared__ float red[32];
  const int n_cols = state[0];
  for (int jc = blockIdx.x; jc < n_cols; jc += gridDim.x) {
    const int b = st_cols(state, B)[jc];
    bounds_epilogue(cand_v + (size_t)b * kk, cand_i + (size_t)b * kk, b, kk, p, B, k, s2,
                    one_plus_eps, vals, idx, lb, ub, lbk, ub_excl, accept, red);
  }
}

// Segment rounds until one list of kk per column is left in *cur_v/*cur_i
// (the two halves of the scratch take turns); the first round is dense mode
// over every stride-th row.
template <bool IDS>
cudaError_t select_rounds(const float* p, const float* contrib, int n, int B, int stride, int kk,
                          int lk, float* scratch_v, int* scratch_i, long long half, int* state,
                          bool dense_cols, bool reset, int grid_cols, const float** cur_v,
                          const int** cur_i, cudaStream_t st) {
  int n_keys = (int)(((long long)n + stride - 1) / stride);
  int n_seg = (n_keys + SEG - 1) / SEG;
  if (n_seg > 65535 || (long long)B * n_seg * kk > half) return cudaErrorInvalidValue;
  int side = 0;
  segment_topk_kernel<IDS><<<dim3(grid_cols, n_seg), SORT_THREADS, 0, st>>>(
      p, contrib, n, B, stride, nullptr, nullptr, n_keys, scratch_v, scratch_i, kk, lk, n_seg,
      state, dense_cols, reset);
  cudaError_t err = cudaGetLastError();
  while (err == cudaSuccess && n_seg > 1) {
    n_keys = n_seg * kk;
    n_seg = (n_keys + SEG - 1) / SEG;
    segment_topk_kernel<IDS><<<dim3(grid_cols, n_seg), SORT_THREADS, 0, st>>>(
        nullptr, nullptr, n, B, 1, scratch_v + side * half, scratch_i + side * half, n_keys,
        scratch_v + (side ^ 1) * half, scratch_i + (side ^ 1) * half, kk, lk, n_seg, state,
        dense_cols, false);
    err = cudaGetLastError();
    side ^= 1;
  }
  *cur_v = scratch_v + side * half;
  *cur_i = scratch_i + side * half;
  return err;
}

}  // namespace

extern "C" int fora_topk_segment() { return SEG; }

// scratch_v/scratch_i: two ping-pong halves of `half` elements each, where
// half >= B * ceil(n / SEG) * kk (the dense path's first round).
// stride: 0 sends every column down the dense path; >= 2 samples every
// stride-th row for the threshold and filters into list_v/list_i [B, cap],
// cap <= SEG.  state: 1 + 3 B ints, written by this call (state[0]: the
// number of columns that took the dense path; state[1 + b]: column b's
// candidate count).
extern "C" int fora_topk_bounds(const float* p, const float* contrib, int n, int B, int k, int kk,
                                float s2, float one_plus_eps, int stride, int cap,
                                float* scratch_v, int* scratch_i, long long half, float* list_v,
                                int* list_i, int* state, float* vals, int* idx, float* lb,
                                float* ub, float* lbk, float* ub_excl, unsigned char* accept,
                                void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (n <= 0 || B <= 0 || k <= 0 || kk < k || kk > SEG || kk > n) return (int)cudaErrorInvalidValue;
  if (stride == 1 || stride < 0 || (stride > 0 && (cap < 1 || cap > SEG)))
    return (int)cudaErrorInvalidValue;
  int lk = 1;
  while ((1 << lk) < kk) ++lk;
  const float* cur_v = nullptr;
  const int* cur_i = nullptr;
  cudaError_t err;
  int dense_grid = B;
  if (stride == 0) {
    all_dense_kernel<<<1, 256, 0, st>>>(state, B);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  } else {
    err = select_rounds<false>(p, contrib, n, B, stride, kk, lk, scratch_v, scratch_i, half, state,
                               false, true, B, &cur_v, &cur_i, st);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    const bool vec = B % 4 == 0 && (((uintptr_t)p | (uintptr_t)contrib) & 15) == 0;
    const int G = vec ? B / 4 : B;
    // 8 blocks of 256 threads fill an SM; at least one row in flight
    int blocks = sms * (2048 / FILTER_THREADS);
    if ((long long)blocks * FILTER_THREADS < G) blocks = (G + FILTER_THREADS - 1) / FILTER_THREADS;
    if (vec)
      filter_kernel<4><<<blocks, FILTER_THREADS, 0, st>>>(p, contrib, n, B, kk, cur_v + (kk - 1),
                                                         kk, cap, state, list_v, list_i);
    else
      filter_kernel<1><<<blocks, FILTER_THREADS, 0, st>>>(p, contrib, n, B, kk, cur_v + (kk - 1),
                                                         kk, cap, state, list_v, list_i);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    candidates_kernel<<<B, SORT_THREADS, 0, st>>>(list_v, list_i, cap, state, p, B, k, kk, lk, s2,
                                                  one_plus_eps, vals, idx, lb, ub, lbk, ub_excl,
                                                  accept);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    dense_grid = B < DENSE_SLOTS ? B : DENSE_SLOTS;
  }
  err = select_rounds<true>(p, contrib, n, B, 1, kk, lk, scratch_v, scratch_i, half, state, true,
                            false, dense_grid, &cur_v, &cur_i, st);
  if (err != cudaSuccess) return (int)err;
  dense_epilogue_kernel<<<dense_grid, 256, 0, st>>>(cur_v, cur_i, kk, state, p, B, k, s2,
                                                    one_plus_eps, vals, idx, lb, ub, lbk, ub_excl,
                                                    accept);
  return (int)cudaGetLastError();
}
