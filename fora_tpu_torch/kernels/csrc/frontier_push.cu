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
// frontier_prepass (K5's pre-pass), over [n, B]:
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
//               task_edges) tasks int4 (v, first, mask, edges): `edges`
//               of its out-edges from `first` (indptr[v] + j task_edges for
//               the j-th), so a hub row's edges spread over many warps and
//               K5 needs no row pointer; and the row's mask of non-zero
//               units: bit i set where contrib[v, i*span .. (i+1)*span)
//               holds a non-zero (mask_span below: span 4, a float4 chunk,
//               where B is a multiple of 4 up to 128; one column where B is
//               not a multiple of 4 up to 32; wider rows group their chunks
//               or columns so that 32 bits cover the row).
// prepass_narrow_kernel (rows of at most 32 units) gives a lane one unit (a
// float4 where B is a multiple of 4, else one column) of each of 2 (float4)
// or 8 (column) rows a pass, the row's lanes side by side: every load of a
// pass (the residues; each row's thr, deg and wsum once, by one lane,
// handed to the row's lanes by shuffles; then p where an entry is active)
// goes out before any store, and the row's mask is a ballot of its lanes.
// A warp stages the rows it speaks for in shared memory, and the block
// appends their tasks together after its warps have taken 256 rows each:
// two barriers and one atomicAdd, none in between, so the list is compact
// and its order varies from run to run.  One counter must not become a
// queue of atomics: an atomicAdd a row or a warp pass was 3.7x and 2.1x
// K1's pre-pass (PERF.md).  A block adds its out-edges and a warp its "any
// active" flag once, when its loop ends.  Wider rows take a warp a row
// (prepass_wide_kernel).  status is zeroed by the launcher
// (cudaMemsetAsync).
//
// frontier_push (K5), a warp a task (v, first, mask, edges):
//   r[u, :] += contrib[v, :]   for each out-edge v -> u of the task's range
// where contrib[v] is non-zero only: the warp lays its lanes over (edge,
// set bit of the mask) pairs, 2^ceil(log2 popc(mask)) lanes an edge, so a
// row with one non-zero chunk adds 32 edges an instruction.  A lane loads
// its chunk of contrib[v] once a task, the ids of 8 of its edges at once,
// then adds the chunk with f32 atomics (float4 where the rows allow it:
// sm_90's vector atomic): a hub row's 1,024-edge task would otherwise wait
// out one load a step.  The adds it skips are +0.0 into residues that are
// >= 0, so the sum is the same function as adding every chunk; two pushes
// into one destination may meet, so the order of the adds, and the last
// bits of a sum, vary from run to run.  The plain version
// (ops/push.py::active_edge_segment_sum_plain) adds in destination order.
//
// What bounds it on the H100: bytes.  The pre-pass moves K1's pre-pass's
// 16 bytes per entry where an entry is active and 8 elsewhere (r read,
// contrib written), plus the rows' thr, deg and wsum; the scatter reads
// the active rows' out-edge ids, tasks and non-zero contrib chunks and
// reads and writes the 32-byte sectors of r that receive a non-zero add
// (the atomics resolve in the L2), which for a sparse frontier is far
// less than K1's pass over all m in-edges.  Where the active out-edges
// exceed the cap, the superstep takes K1's gather (gather_scatter.cu) over
// every in-edge on the masked r instead; the host decides from status,
// read once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// rows a lane takes in a pass of prepass_narrow_kernel, their loads in
// flight together
__host__ __device__ constexpr int narrow_sub_rows(int W) { return W == 4 ? 2 : 8; }
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// W consecutive floats, loaded and stored as one access (a float4 for W = 4)
template <int W>
struct alignas(4 * W) Unit {
  float f[W];
};

template <int W>
__device__ __forceinline__ Unit<W> load_unit(const float* p) {
  Unit<W> u;
  if constexpr (W == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    u.f[0] = x.x;
    u.f[1] = x.y;
    u.f[2] = x.z;
    u.f[3] = x.w;
  } else {
    u.f[0] = *p;
  }
  return u;
}

template <int W>
__device__ __forceinline__ void store_unit(float* p, const Unit<W>& u) {
  if constexpr (W == 4)
    *reinterpret_cast<float4*>(p) = make_float4(u.f[0], u.f[1], u.f[2], u.f[3]);
  else
    *p = u.f[0];
}

template <int W>
__device__ __forceinline__ Unit<W> zero_unit() {
  Unit<W> u;
#pragma unroll
  for (int f = 0; f < W; ++f) u.f[f] = 0.0f;
  return u;
}

// One unit of a row through the pre-pass: contrib out, p and r updated in
// place where an entry is active (K1's arithmetic); returns whether some
// contrib entry is non-zero.
template <int W>
__device__ __forceinline__ bool prepass_unit(Unit<W>& rv, Unit<W>& pv, Unit<W>& cv, float t,
                                             bool dangling, float wv, float alpha,
                                             float one_minus_alpha) {
  bool nz = false;
#pragma unroll
  for (int f = 0; f < W; ++f) {
    const bool act = rv.f[f] > t;
    const float ar = act ? rv.f[f] : 0.0f;
    cv.f[f] = dangling ? 0.0f : one_minus_alpha * ar / wv;
    pv.f[f] = pv.f[f] + (dangling ? ar : alpha * ar);
    rv.f[f] = act ? 0.0f : rv.f[f];
    nz |= cv.f[f] != 0.0f;
  }
  return nz;
}

template <int W>
__device__ __forceinline__ bool any_above(const Unit<W>& rv, float t) {
  bool a = false;
#pragma unroll
  for (int f = 0; f < W; ++f) a |= rv.f[f] > t;
  return a;
}

// A warp stages the rows it speaks for, (row, deg, mask), in its own part
// of shared memory, kStage rows at most, and the block appends their tasks
// together once its warps have taken kStage rows each (flush_tasks): two
// barriers and one atomicAdd for all of them, none in between.
constexpr int kStage = 256;

__device__ __forceinline__ int tasks_of(int d, int task_edges) {
  return (d + task_edges - 1) / task_edges;
}

__device__ __forceinline__ int warp_incl_sum(int x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  return x;
}

// Stage this lane's row (row, d, mask) if it speaks; `staged` (the warp's
// count, the same in every lane) grows by the warp's speakers.
__device__ __forceinline__ void stage_row(int4* stage, int& staged, bool speaks, long long v,
                                          int d, unsigned mask) {
  const unsigned who = __ballot_sync(kFull, speaks);
  if (speaks)
    stage[staged + __popc(who & ((1u << (threadIdx.x & 31)) - 1u))] =
        make_int4((int)v, d, (int)mask, 0);
  staged += __popc(who);
}

// The block's staged rows into tasks (row, first edge, mask, edges), one
// for each task_edges of a row's out-edges: every thread calls it with its
// warp's stage and count.  The rows' first out-edges (indptr) are loaded
// before the barriers, so the loads overlap them.
__device__ __forceinline__ void flush_tasks(const int4* stage, int staged, int* cnt, int* pos,
                                            const int* __restrict__ indptr, int task_edges,
                                            int4* __restrict__ tasks, int* counter) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  __syncwarp();
  int k = 0;
  for (int i = lane; i < staged; i += 32) k += tasks_of(stage[i].y, task_edges);
  const int first0 = lane < staged ? indptr[stage[lane].x] : 0;
  k = __shfl_sync(kFull, warp_incl_sum(k), 31);
  if (lane == 0) cnt[w] = k;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int j = 0; j < kWarps; ++j) {
      const int t = cnt[j];
      cnt[j] = sum;
      sum += t;
    }
    *pos = sum ? atomicAdd(counter, sum) : 0;
  }
  __syncthreads();
  int at = *pos + cnt[w];
  for (int i0 = 0; i0 < staged; i0 += 32) {
    const int i = i0 + lane;
    int4 e = make_int4(0, 0, 0, 0);
    int first = first0;
    if (i < staged) {
      e = stage[i];
      if (i0) first = indptr[e.x];
    }
    const int kt = i < staged ? tasks_of(e.y, task_edges) : 0;
    const int incl = warp_incl_sum(kt);
    for (int j = 0, q = at + incl - kt; j < kt; ++j, ++q)
      tasks[q] = make_int4(e.x, first + j * task_edges, e.z,
                           min(task_edges, e.y - j * task_edges));
    at += __shfl_sync(kFull, incl, 31);
  }
  __syncwarp();
}

// The block's out-edges and the warps' "any active" into status, once.
__device__ __forceinline__ void finish(int edges, bool warp_active, int* sums, int* status) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) edges += __shfl_xor_sync(kFull, edges, off);
  if (lane == 0) {
    sums[threadIdx.x >> 5] = edges;
    if (warp_active) status[0] = 1;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int j = 0; j < kWarps; ++j) sum += sums[j];
    if (sum) atomicAdd(status + 1, sum);
  }
}

// Rows of at most 32 units (W floats each): 2^G lanes a row, 32 >> G rows
// a warp takes side by side, kSub such groups a pass.  At most 64
// registers, so that 4 blocks share an SM (a lane holding 8 float4 rows
// took 151 registers and left one block an SM).  No barrier between
// flushes.
template <int W, int G>
__global__ void __launch_bounds__(kThreads, 4)
    prepass_narrow_kernel(float* __restrict__ p, float* __restrict__ r,
                          float* __restrict__ contrib, const float* __restrict__ thr,
                          const int* __restrict__ deg, const int* __restrict__ indptr,
                          const float* __restrict__ wsum, float alpha, float one_minus_alpha,
                          long long n, int B, int task_edges, int4* __restrict__ tasks,
                          int* __restrict__ status) {
  constexpr int kSub = narrow_sub_rows(W);
  constexpr int kGroup = 1 << G;             // lanes a row takes
  constexpr int kSlots = 32 >> G;            // rows side by side in a warp
  constexpr int kRows = kSlots * kSub;       // rows a warp takes a pass
  constexpr int kHeld = (kRows + 31) / 32;   // rows whose thr/deg/wsum a lane loads
  constexpr int kFlush = kStage / kRows;     // passes between flushes
  constexpr unsigned kGroupBits = kGroup == 32 ? kFull : (1u << kGroup) - 1u;
  __shared__ int4 stage[kWarps][kStage];
  __shared__ int cnt[kWarps];
  __shared__ int pos;
  __shared__ int sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int slot = lane >> G;   // this lane's row among the warp's side-by-side rows
  const int c = lane & (kGroup - 1);   // its unit of the row
  const bool mine = c * W < B;
  const long long block_rows = (long long)kRows * kWarps;
  bool warp_active = false;
  int edges = 0;    // out-edges of the rows this lane speaks for
  int staged = 0;   // rows the warp staged since the last flush
  int passes = 0;   // passes since the last flush
  // the loop's bound depends on the block alone, so every ballot, shuffle
  // and barrier below has the whole block
  for (long long base = blockIdx.x * block_rows; base < n; base += gridDim.x * block_rows) {
    const long long wbase = base + (long long)w * kRows;
    // every load of the pass first: each row's thr, deg and wsum by one
    // lane (lane q % 32 for the warp's q-th row) ...
    float th[kHeld], wh[kHeld];
    int dh[kHeld];
#pragma unroll
    for (int j = 0; j < kHeld; ++j) {
      const int q = lane + 32 * j;
      const long long v = wbase + q;
      const bool in = q < kRows && v < n;
      th[j] = in ? thr[v] : 0.0f;
      dh[j] = in ? deg[v] : 0;
      wh[j] = in ? wsum[v] : 1.0f;
    }
    // ... the residues ...
    Unit<W> rv[kSub];
    bool ok[kSub];
#pragma unroll
    for (int s = 0; s < kSub; ++s) {
      const long long v = wbase + s * kSlots + slot;
      ok[s] = mine && v < n;
      rv[s] = ok[s] ? load_unit<W>(r + v * B + c * W) : zero_unit<W>();
    }
    float t[kSub], wv[kSub];
    int d[kSub];
#pragma unroll
    for (int s = 0; s < kSub; ++s) {
      const int j = (s * kSlots) >> 5;   // constant once unrolled
      if (kSlots == 32) {   // the lane loaded its own rows
        t[s] = th[j];
        d[s] = dh[j];
        wv[s] = wh[j];
      } else {
        const int holder = (s * kSlots + slot) & 31;
        t[s] = __shfl_sync(kFull, th[j], holder);
        d[s] = __shfl_sync(kFull, dh[j], holder);
        wv[s] = __shfl_sync(kFull, wh[j], holder);
      }
    }
    // ... then p where a unit has an active entry
    bool act[kSub];
    Unit<W> pv[kSub];
#pragma unroll
    for (int s = 0; s < kSub; ++s) {
      const long long v = wbase + s * kSlots + slot;
      act[s] = ok[s] && any_above<W>(rv[s], t[s]);
      pv[s] = act[s] ? load_unit<W>(p + v * B + c * W) : zero_unit<W>();
    }
    // the stores, and each row's ballots (every lane takes every ballot)
#pragma unroll
    for (int s = 0; s < kSub; ++s) {
      const long long v = wbase + s * kSlots + slot;
      Unit<W> cv;
      const bool nz = prepass_unit<W>(rv[s], pv[s], cv, t[s], d[s] == 0,
                                      fmaxf(wv[s], 1e-30f), alpha, one_minus_alpha);
      if (ok[s]) store_unit<W>(contrib + v * B + c * W, cv);
      if (act[s]) {
        store_unit<W>(p + v * B + c * W, pv[s]);
        store_unit<W>(r + v * B + c * W, rv[s]);
      }
      warp_active |= __ballot_sync(kFull, act[s]) != 0;
      const unsigned mask = (__ballot_sync(kFull, ok[s] && nz) >> (slot << G)) & kGroupBits;
      const bool speaks = c == 0 && mask;   // the row's first lane speaks for it
      if (speaks) edges += d[s];
      stage_row(stage[w], staged, speaks, v, d[s], mask);
    }
    if (++passes == kFlush) {
      flush_tasks(stage[w], staged, cnt, &pos, indptr, task_edges, tasks, status + 2);
      staged = passes = 0;
    }
  }
  if (passes) flush_tasks(stage[w], staged, cnt, &pos, indptr, task_edges, tasks, status + 2);
  finish(edges, warp_active, sums, status);
}

// Rows of more than 32 units: a warp a row, its lanes over the row's
// units; a mask bit covers `span` floats.
template <int W>
__global__ void __launch_bounds__(kThreads)
    prepass_wide_kernel(float* __restrict__ p, float* __restrict__ r, float* __restrict__ contrib,
                        const float* __restrict__ thr, const int* __restrict__ deg,
                        const int* __restrict__ indptr, const float* __restrict__ wsum,
                        float alpha, float one_minus_alpha, long long n, int B, int span,
                        int task_edges, int4* __restrict__ tasks, int* __restrict__ status) {
  __shared__ int4 stage[kWarps][kStage];
  __shared__ int cnt[kWarps];
  __shared__ int pos;
  __shared__ int sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  bool warp_active = false;
  int edges = 0, staged = 0, passes = 0;
  for (long long base = (long long)blockIdx.x * kWarps; base < n;
       base += (long long)gridDim.x * kWarps) {
    const long long v = base + w;
    unsigned mask = 0;
    int d = 0;
    if (v < n) {   // the whole warp
      float t = 0.0f, wv = 1.0f;
      if (lane == 0) {
        t = thr[v];
        d = deg[v];
        wv = wsum[v];
      }
      t = __shfl_sync(kFull, t, 0);
      d = __shfl_sync(kFull, d, 0);
      wv = fmaxf(__shfl_sync(kFull, wv, 0), 1e-30f);
      bool any = false;
      unsigned bits = 0;
      for (int u = lane * W; u < B; u += 32 * W) {
        Unit<W> rv = load_unit<W>(r + v * B + u), cv;
        const bool a = any_above<W>(rv, t);
        Unit<W> pv = a ? load_unit<W>(p + v * B + u) : zero_unit<W>();
        if (prepass_unit<W>(rv, pv, cv, t, d == 0, wv, alpha, one_minus_alpha))
          bits |= 1u << (u / span);
        store_unit<W>(contrib + v * B + u, cv);
        if (a) {
          store_unit<W>(p + v * B + u, pv);
          store_unit<W>(r + v * B + u, rv);
        }
        any |= a;
      }
      warp_active |= __any_sync(kFull, any);
      mask = __reduce_or_sync(kFull, bits);
    }
    const bool speaks = lane == 0 && mask;
    if (speaks) edges += d;
    stage_row(stage[w], staged, speaks, v, d, mask);
    if (++passes == kStage) {
      flush_tasks(stage[w], staged, cnt, &pos, indptr, task_edges, tasks, status + 2);
      staged = passes = 0;
    }
  }
  if (passes) flush_tasks(stage[w], staged, cnt, &pos, indptr, task_edges, tasks, status + 2);
  finish(edges, warp_active, sums, status);
}

constexpr int kUnroll = 8;   // K5: out-edge ids a lane loads at once

// K5's work on one task (v, first, mask, edges), by the calling warp: its
// lanes over (edge, set bit of the mask) pairs, 2^ceil(log2 popc(mask))
// lanes an edge; a mask bit covers `span` floats (a multiple of W), W = 4
// for float4 atomics.  No warp-wide operation, so lanes may leave early.
template <int W>
__device__ __forceinline__ void push_task(float* __restrict__ r,
                                          const float* __restrict__ contrib, const int4 task,
                                          const int* __restrict__ indices, int B, int span) {
  const int lane = threadIdx.x & 31;
  const unsigned mask = (unsigned)task.z;
  const int nb = __popc(mask);
  const int lg = nb <= 1 ? 0 : 32 - __clz(nb - 1);   // lanes an edge: 2^lg >= nb
  const int slot = lane & ((1 << lg) - 1);
  if (slot >= nb) return;
  unsigned m = mask;
  for (int i = 0; i < slot; ++i) m &= m - 1;   // the slot-th set bit
  const int c0 = (__ffs(m) - 1) * span;
  const int c1 = min(c0 + span, B);
  const float* src = contrib + (long long)task.x * B;
  const int* ids = indices + task.y;
  const int ne = task.w;
  const int step = 32 >> lg;
  if (span == W) {   // one unit a lane, loaded once a task
    const Unit<W> val = load_unit<W>(src + c0);
    // kUnroll edges' ids in flight before their adds
    for (int e0 = lane >> lg; e0 < ne; e0 += kUnroll * step) {
      int u[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k)
        u[k] = e0 + k * step < ne ? __ldg(ids + e0 + k * step) : -1;
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (u[k] < 0) break;
        float* out = r + (long long)u[k] * B + c0;
        if constexpr (W == 4)
          atomicAdd(reinterpret_cast<float4*>(out),
                    make_float4(val.f[0], val.f[1], val.f[2], val.f[3]));
        else
          atomicAdd(out, val.f[0]);
      }
    }
  } else {
    for (int e = lane >> lg; e < ne; e += step) {
      float* out = r + (long long)__ldg(ids + e) * B;
      for (int cc = c0; cc < c1; cc += W) {
        if constexpr (W == 4)
          atomicAdd(reinterpret_cast<float4*>(out + cc),
                    __ldg(reinterpret_cast<const float4*>(src + cc)));
        else
          atomicAdd(out + cc, __ldg(src + cc));
      }
    }
  }
}

// K5: a warp a task.  A warp that went on to further tasks (w, w + warps,
// ... over the blocks the card holds at once) or that took several short
// tasks side by side was slower on the H100 (probes/frontier_probe.py
// times both forms, probes/frontier_push_forms.cu).
template <int W>
__global__ void __launch_bounds__(kThreads)
    frontier_push_kernel(float* __restrict__ r, const float* __restrict__ contrib,
                         const int4* __restrict__ tasks, long long n_tasks,
                         const int* __restrict__ indices, int B, int span) {
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (w >= n_tasks) return;   // the whole warp
  push_task<W>(r, contrib, tasks[w], indices, B, span);
}

// floats a mask bit covers: a float4 chunk where B is a multiple of 4, else
// a column, times the chunks or columns a bit must take for 32 bits to
// cover the row
int mask_span(int B) {
  const int unit = B % 4 == 0 ? 4 : 1;
  const int units = B / unit;
  return (units + 31) / 32 * unit;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// the grid: enough blocks for `work` items at `per_block` a block, at most
// what the card holds resident at once
template <auto Kernel>
long long grid_for(long long work, long long per_block) {
  static const int resident = [] {
    int b = 1;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, Kernel, kThreads, 0);
    return b < 1 ? 1 : b;
  }();
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long need = (work + per_block - 1) / per_block;
  const long long most = (long long)sms * resident;
  return need < most ? need : most;
}

// the pre-pass's arguments, as the launchers pass them on
struct PrepassArgs {
  float* p;
  float* r;
  float* contrib;
  const float* thr;
  const int* deg;
  const int* indptr;
  const float* wsum;
  float alpha, one_minus_alpha;
  long long n;
  int B, task_edges;
  int4* tasks;
  int* status;
};

template <int W, int G>
void launch_narrow(const PrepassArgs& a, cudaStream_t st) {
  constexpr auto kernel = prepass_narrow_kernel<W, G>;
  const long long blocks =
      grid_for<kernel>(a.n, (long long)(32 >> G) * narrow_sub_rows(W) * kWarps);
  kernel<<<(unsigned)blocks, kThreads, 0, st>>>(a.p, a.r, a.contrib, a.thr, a.deg, a.indptr,
                                                 a.wsum, a.alpha, a.one_minus_alpha, a.n, a.B,
                                                 a.task_edges, a.tasks, a.status);
}

template <int W>
void launch_narrow_g(int g, const PrepassArgs& a, cudaStream_t st) {
  switch (g) {
    case 0: return launch_narrow<W, 0>(a, st);
    case 1: return launch_narrow<W, 1>(a, st);
    case 2: return launch_narrow<W, 2>(a, st);
    case 3: return launch_narrow<W, 3>(a, st);
    case 4: return launch_narrow<W, 4>(a, st);
    default: return launch_narrow<W, 5>(a, st);
  }
}

template <int W>
void launch_wide(const PrepassArgs& a, int span, cudaStream_t st) {
  constexpr auto kernel = prepass_wide_kernel<W>;
  const long long blocks = grid_for<kernel>(a.n, kWarps);
  kernel<<<(unsigned)blocks, kThreads, 0, st>>>(a.p, a.r, a.contrib, a.thr, a.deg, a.indptr,
                                                 a.wsum, a.alpha, a.one_minus_alpha, a.n, a.B,
                                                 span, a.task_edges, a.tasks, a.status);
}

template <int W>
void launch_push(float* r, const float* contrib, const int4* tasks, long long n_tasks,
                 const int* indices, int B, int span, cudaStream_t st) {
  const long long blocks = (n_tasks + kWarps - 1) / kWarps;
  frontier_push_kernel<W><<<(unsigned)blocks, kThreads, 0, st>>>(r, contrib, tasks, n_tasks,
                                                                  indices, B, span);
}

}  // namespace

// deg and indptr: the out-CSR's degrees and row pointers; tasks: room for
// n + m / task_edges + 1 int4 entries, 16-byte aligned; status: 3 int32
extern "C" int fora_frontier_prepass(float* p, float* r, float* contrib, const float* thr,
                                     const int* deg, const int* indptr, const float* wsum,
                                     float alpha, float one_minus_alpha, long long n, int B,
                                     int task_edges, int* tasks, int* status, void* stream) {
  if (n < 0 || B <= 0 || task_edges <= 0 || !aligned16(tasks))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(status, 0, 3 * sizeof(int), st);
  if (err != cudaSuccess || n == 0) return (int)err;
  const PrepassArgs a{p,     r, contrib, thr,        deg, indptr, wsum, alpha, one_minus_alpha,
                      n,     B, task_edges, reinterpret_cast<int4*>(tasks), status};
  const int span = mask_span(B);
  const bool vec = B % 4 == 0 && aligned16(p) && aligned16(r) && aligned16(contrib);
  if (span == 1 || (span == 4 && vec)) {   // a unit a lane: at most 32 a row
    int g = 0;
    while ((1 << g) < B / span) ++g;
    if (span == 4)
      launch_narrow_g<4>(g, a, st);
    else
      launch_narrow_g<1>(g, a, st);
  } else if (vec) {
    launch_wide<4>(a, span, st);
  } else {
    launch_wide<1>(a, span, st);
  }
  return (int)cudaGetLastError();
}

// tasks: the pre-pass's; indices: the out-CSR's column ids
extern "C" int fora_frontier_push(float* r, const float* contrib, const int* tasks,
                                  long long n_tasks, const int* indices, int B, void* stream) {
  if (B <= 0 || n_tasks < 0 || n_tasks / kWarps >= 0x7fffffffLL || !aligned16(tasks))
    return (int)cudaErrorInvalidValue;
  if (n_tasks == 0) return (int)cudaGetLastError();
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int4* t = reinterpret_cast<const int4*>(tasks);
  const int span = mask_span(B);
  if (span % 4 == 0 && aligned16(r) && aligned16(contrib))
    launch_push<4>(r, contrib, t, n_tasks, indices, B, span, st);
  else
    launch_push<1>(r, contrib, t, n_tasks, indices, B, span, st);
  return (int)cudaGetLastError();
}
