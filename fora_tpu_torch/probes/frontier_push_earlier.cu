// The earlier form of K5 and its pre-pass, kept only so that
// fora_tpu_torch/probes/frontier_probe.py (and chip_smoke.py's phase 16)
// can time it beside kernels/csrc/frontier_push.cu on the same state.
// No entry point of the package loads it: the probe compiles it alone.
// Tasks here are int2 (row, range); the pre-pass gives a lane a column of
// a row, and K5 adds every float4 chunk of a pushing row along each edge.
//
// K5 · the frontier-compacted push superstep: the forward push's gather
// restricted to the out-edges of the rows that push, for narrow batches
// whose frontier is sparse.
//
// Replaces fora_tpu/ops/push.py::active_edge_segment_sum (283-312) and the
// branch of _superstep that calls it (333-339), which XLA lowered to an
// O(m) per-edge activity mask, a jnp.nonzero compaction of up to e_cap
// active in-edges, and a sorted segment_sum over them under lax.cond
// (dense above e_cap).  On the TPU that layout lost to the dense superstep
// (push.py:412-416): the [m] mask is a per-element random gather.  Here the
// push is driven from the active rows instead, and walks their OUT-edges
// (the out-CSR the walk kernel already reads), so no pass touches all m
// edges.  Two launches a superstep:
//
// frontier_prepass (K5's pre-pass), over [n, B], one lane group per row:
//   active   = r > thr[v]
//   p       += active ? (dangling ? r : alpha r) : 0      (in place)
//   contrib  = active && !dangling ? (1 - alpha) r / max(wsum[v], 1e-30) : 0
//   r        = active ? 0 : r                            (in place: the mask)
// the same f32 arithmetic as K1's pre-pass (push_prepass.cu), so p and
// contrib are bit-equal to it; and, for the host's one read a superstep,
//   status[0] = 1 if any entry was active (the loop's "go on")
//   status[1] = the out-edges of the rows with a non-zero contrib (JAX's
//               cnt, the in-edges whose source row pushes, on the unmerged
//               graph where a row's in-edges elsewhere are its out-edges)
//   status[2] = the tasks appended: each such row v appends ceil(deg(v) /
//               task_edges) tasks (v, j), j-th range of task_edges of its
//               out-edges, so a hub row's edges spread over many warps.
// A lane group takes kSubRows rows at once (their loads in flight
// together), and a block appends the tasks of its pass with one atomicAdd
// (a scan of the task counts across its lanes, then across its warps in
// shared memory), so the list is compact and its order varies from run to
// run; the out-edges and the "any active" flag each warp adds once, when
// its loop ends.  One counter must not become a queue of atomics: the
// first form, an atomicAdd on two counters per active row, took 3.8x K1's
// pre-pass at B = 32, one per warp pass 2.0x.  status is zeroed by the
// launcher (cudaMemsetAsync).
//
// frontier_push (K5), one warp per task (v, j):
//   r[u, :] += contrib[v, :]   for each out-edge v -> u of the task's range
// with f32 atomics (float4 where the rows allow it: sm_90's vector
// atomic), 32 / T edges at a time, T lanes per edge (the power of two that
// covers the row's chunks, at most 32), as P3 (row_scatter.cu) lays its
// lanes.  Two pushes of one row into one destination may meet, so the
// order of the adds, and the last bits of a sum, vary from run to run; the
// plain version (ops/push.py::active_edge_segment_sum_plain) adds in
// destination order.
//
// What bounds it on the H100: bytes.  The pre-pass moves K1's pre-pass's
// 16 bytes per entry (r and p read, contrib written, p written where
// active) plus r's active entries; the scatter reads the active rows'
// out-edge ids and contrib rows and reads and writes each touched r row
// (the atomics resolve in the L2), which for a sparse frontier is far less
// than K1's pass over all m in-edges.  Where the active out-edges exceed the
// cap, the superstep takes K1's gather (gather_scatter.cu) over every
// in-edge on the masked r instead; the host decides from status, read once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

constexpr int kSubRows = 8;   // row slots a lane group takes per pass
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
    frontier_prepass_kernel(float* __restrict__ p, float* __restrict__ r,
                            float* __restrict__ contrib, const float* __restrict__ thr,
                            const int* __restrict__ deg, const float* __restrict__ wsum,
                            float alpha, float one_minus_alpha, long long n, int B,
                            int group_log2, int task_edges, int2* __restrict__ tasks,
                            int* __restrict__ status) {
  __shared__ int warp_tasks[kWarps];
  __shared__ int block_pos;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int group = 1 << group_log2;
  const int slots = 32 >> group_log2;   // rows a warp takes at once
  const int slot = lane >> group_log2;  // this lane's row among them
  const int c0 = lane & (group - 1);    // its first column
  const long long warp_rows = (long long)slots * kSubRows;
  const long long block_rows = warp_rows * kWarps;
  const unsigned gmask = group == 32 ? kFull : ((1u << group) - 1u) << (slot << group_log2);
  bool warp_active = false;
  int edges = 0;   // this lane's rows' out-edges, summed over the passes
  // the loop's bound depends on the block alone, so every ballot, shuffle
  // and barrier below has the whole block
  for (long long base = blockIdx.x * block_rows; base < n; base += gridDim.x * block_rows) {
    const long long wbase = base + w * warp_rows;
    int d[kSubRows];
    bool speaks[kSubRows];
    int k = 0;   // tasks this lane appends in this pass
#pragma unroll
    for (int s = 0; s < kSubRows; ++s) {
      const long long v = wbase + (long long)s * slots + slot;
      bool any_active = false, any_contrib = false;
      d[s] = 0;
      if (v < n) {
        d[s] = deg[v];
        const float t = thr[v];
        const bool dangling = d[s] == 0;
        const float wv = fmaxf(wsum[v], 1e-30f);
        for (int c = c0; c < B; c += group) {
          const long long i = v * B + c;
          const float rv = r[i];
          const bool act = rv > t;
          const float ar = act ? rv : 0.0f;
          const float cv = dangling ? 0.0f : one_minus_alpha * ar / wv;
          contrib[i] = cv;
          if (act) {
            p[i] = p[i] + (dangling ? ar : alpha * ar);
            r[i] = 0.0f;
          }
          any_active |= act;
          any_contrib |= cv != 0.0f;
        }
      }
      // every lane takes both ballots (a ballot behind a branch that some
      // lanes skip is undefined); the row's first lane speaks for it
      warp_active |= __ballot_sync(kFull, any_active) != 0;
      const unsigned con = __ballot_sync(kFull, any_contrib);
      speaks[s] = c0 == 0 && (con & gmask) != 0;
      if (speaks[s]) {
        k += (d[s] + task_edges - 1) / task_edges;
        edges += d[s];
      }
    }
    int incl = k;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) warp_tasks[w] = incl;
    __syncthreads();
    if (threadIdx.x == 0) {
      int sum = 0;
      for (int j = 0; j < kWarps; ++j) {
        const int t = warp_tasks[j];
        warp_tasks[j] = sum;
        sum += t;
      }
      block_pos = sum ? atomicAdd(status + 2, sum) : 0;
    }
    __syncthreads();
    int pos = block_pos + warp_tasks[w] + incl - k;
#pragma unroll
    for (int s = 0; s < kSubRows; ++s) {
      if (!speaks[s]) continue;
      const int v = (int)(wbase + (long long)s * slots + slot);
      for (int j = 0; j * task_edges < d[s]; ++j) tasks[pos++] = make_int2(v, j);
    }
    __syncthreads();   // warp_tasks and block_pos are the next pass's
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) edges += __shfl_xor_sync(kFull, edges, off);
  if (lane == 0) {
    if (warp_active) status[0] = 1;
    if (edges) atomicAdd(status + 1, edges);
  }
}

template <bool VEC4>
__global__ void frontier_push_kernel(float* __restrict__ r, const float* __restrict__ contrib,
                                     const int2* __restrict__ tasks, long long n_tasks,
                                     const int* __restrict__ indptr,
                                     const int* __restrict__ indices, int task_edges, int B,
                                     int group_log2) {
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (w >= n_tasks) return;   // the whole warp
  const int lane = threadIdx.x & 31;
  const int2 task = tasks[w];
  const long long v = task.x;
  const long long e0 = (long long)indptr[v] + (long long)task.y * task_edges;
  long long e1 = indptr[v + 1];
  if (e0 + task_edges < e1) e1 = e0 + task_edges;
  const int group = 1 << group_log2;
  const int c0 = lane & (group - 1);
  const int chunks = VEC4 ? B >> 2 : B;
  for (long long e = e0 + (lane >> group_log2); e < e1; e += 32 >> group_log2) {
    const long long u = indices[e];
    if (VEC4) {
      const float4* row = reinterpret_cast<const float4*>(contrib + v * B);
      float4* out = reinterpret_cast<float4*>(r + u * B);
      for (int c = c0; c < chunks; c += group) atomicAdd(out + c, __ldg(row + c));
    } else {
      const float* row = contrib + v * B;
      float* out = r + u * B;
      for (int c = c0; c < chunks; c += group) atomicAdd(out + c, __ldg(row + c));
    }
  }
}

// the lanes a row takes: the power of two that covers its chunks, at most 32
int group_log2_for(int chunks) {
  int g = 0;
  while ((1 << g) < chunks && g < 5) ++g;
  return g;
}

}  // namespace

// tasks: room for n + m / task_edges + 1 int2 entries; status: 3 int32
extern "C" int fora_frontier_prepass(float* p, float* r, float* contrib, const float* thr,
                                     const int* deg, const float* wsum, float alpha,
                                     float one_minus_alpha, long long n, int B, int task_edges,
                                     int* tasks, int* status, void* stream) {
  if (n < 0 || B <= 0 || task_edges <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(status, 0, 3 * sizeof(int), st);
  if (err != cudaSuccess || n == 0) return (int)err;
  const int group_log2 = group_log2_for(B);
  const long long rows_per_block = (long long)kWarps * (32 >> group_log2) * kSubRows;
  long long blocks = (n + rows_per_block - 1) / rows_per_block;
  if (blocks > 132LL * 32) blocks = 132LL * 32;   // grid-stride beyond 32 blocks per SM
  frontier_prepass_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      p, r, contrib, thr, deg, wsum, alpha, one_minus_alpha, n, B, group_log2, task_edges,
      reinterpret_cast<int2*>(tasks), status);
  return (int)cudaGetLastError();
}

extern "C" int fora_frontier_push(float* r, const float* contrib, const int* tasks,
                                  long long n_tasks, const int* indptr, const int* indices,
                                  int task_edges, int B, void* stream) {
  if (B <= 0 || task_edges <= 0 || n_tasks < 0) return (int)cudaErrorInvalidValue;
  if (n_tasks == 0) return (int)cudaGetLastError();
  const bool vec4 = (B % 4 == 0) && ((reinterpret_cast<uintptr_t>(r) & 15) == 0) &&
                    ((reinterpret_cast<uintptr_t>(contrib) & 15) == 0);
  const int group_log2 = group_log2_for(vec4 ? B / 4 : B);
  const long long blocks = (n_tasks + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int2* t = reinterpret_cast<const int2*>(tasks);
  if (vec4) {
    frontier_push_kernel<true><<<(unsigned)blocks, kThreads, 0, st>>>(
        r, contrib, t, n_tasks, indptr, indices, task_edges, B, group_log2);
  } else {
    frontier_push_kernel<false><<<(unsigned)blocks, kThreads, 0, st>>>(
        r, contrib, t, n_tasks, indptr, indices, task_edges, B, group_log2);
  }
  return (int)cudaGetLastError();
}
