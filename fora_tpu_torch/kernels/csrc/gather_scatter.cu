// K1/K2 · gather_scatter_add: destination-row CSR gather with a fused
// row mask and an "any row over threshold" flag.
//
//   acc[t, :] = (accumulate ? (mask && acc[t, c] > thr[t] ? 0 : acc[t, c]) : 0)
//             + sum over the row's edges e of values[src[e], :] * src_w[src[e]] * edge_w[e]
//   flag     |= any_c acc[t, c] > thr[t]          (after the add)
//
// Replaces the XLA-lowered gather + sorted scatter-add of
// fora_tpu/ops/push.py::gather_scatter_add (142-191) as used by the push
// superstep (_superstep, 315-362) and by the index walk phase
// (fora_tpu/algo/fora.py::StagedForaPrograms.bucket_spmv / walk_contrib,
// 352-362, 524-541).  It computes the sum of the Pallas probe kernel
// scripts/pallas_gather_probe.py::kernel (43-56) on edges sorted by
// destination; the probe's unsorted per-edge form is P3 (row_scatter.cu).
//
// A row's edges are the concatenation of its ranges in S segments: one
// CSR for K1 (the push gather), one per index bucket for a level of K2,
// whose buckets' edge arrays lie end to end (segment s starts at
// seg_off[s]), so a level is one launch that writes acc once.
//
// What bounds it on the H100: the data's floor is the random row gather,
// one B-wide f32 row (512 bytes at B = 128) per edge, much of it from L2,
// against 3.35 TB/s.  The first design (one warp per whole row) lasted as
// long as its longest row's chain of dependent loads, 25,050 edges on the
// bench graph; this one is held by each task's short chain of dependent
// loads (task, row pointers, sources, rows, acc) times the tasks an SM
// must run, so it gains from more warps in flight.  Design:
//   - work comes as edge-balanced tasks (kernels/schedule.py), one warp per
//     task, at most task_edges edges each; a split row's tasks write
//     partial sums to scratch slots and the row's last task to finish (a
//     per-row counter) adds them in task order and finishes the row, so the
//     result is deterministic and acc sees no atomics;
//   - a warp loads 32 edges' sources and weights with one coalesced load
//     each (across a row's segments too) and hands them out by
//     __shfl_sync, then issues its row loads (ld.global.nc) two per lane
//     before the first add; the card rewarded more warps (48 per SM, 40
//     registers) over more loads per warp (8 or 16, 79 or 117 registers);
//   - the lanes span the B columns (float4 per lane when B % 4 == 0); a
//     narrow row leaves lanes over, so the warp splits into 32 / L groups of
//     L lanes that each take every (32 / L)-th edge, and the groups' sums
//     are combined in a fixed butterfly.
// The warp that finishes a row reads and writes only acc[t], so the mask is
// safe in place (the kernel reads `values`, never `acc`, of other rows).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int kThreads = 256;    // 8 warps = 8 tasks per block
constexpr int kMinBlocks = 6;    // blocks per SM: 48 warps, at most 40 registers
constexpr int kRowLoads = 2;     // row loads in flight per lane

template <int VEC>
struct Vec;

template <>
struct Vec<4> {
  using T = float4;
  __device__ static float4 zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static float4 ldg(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static float4 ldcg(const float* p) {
    return __ldcg(reinterpret_cast<const float4*>(p));
  }
  __device__ static float4 load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  __device__ static void store(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
  }
  __device__ static void stcg(float* p, float4 v) { __stcg(reinterpret_cast<float4*>(p), v); }
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
  __device__ static float zero() { return 0.f; }
  __device__ static float ldg(const float* p) { return __ldg(p); }
  __device__ static float ldcg(const float* p) { return __ldcg(p); }
  __device__ static float load(const float* p) { return *p; }
  __device__ static void store(float* p, float v) { *p = v; }
  __device__ static void stcg(float* p, float v) { __stcg(p, v); }
  __device__ static float get(const float& v, int) { return v; }
  __device__ static void set(float& v, int, float x) { v = x; }
};

struct Params {
  float* acc;
  const float* values;
  const int* indptr;   // [S, n_rows + 1]
  const int* seg_off;  // [S] edge offset of each segment, or null (0)
  int S;
  const int* src;
  const float* edge_w;
  const float* src_w;
  const float* thr;
  int mask;
  int accumulate;
  int* flag;
  const int4* tasks;   // [T] (row, first, end, slot)
  long long n_tasks;
  float* partial;      // [P, B]
  const int* slot_row;
  const int* split_ptr;
  int* counters;
  int n_rows;
  int B;
};

// The edges of one row over its S segments: lane s < S holds segment s's
// end as an offset into the row's edges (`cum`, inclusive prefix sum of
// the segment lengths) and the edge id of the row's offset 0 in it
// (`base`), so that offset v of the row is edge v + base[s] for the first
// s with v < cum[s].
struct RowSegments {
  int cum;
  int base;
};

__device__ __forceinline__ RowSegments row_segments(const Params& p, int t, int lane) {
  int len = 0, base = 0;
  if (lane < p.S) {
    const int* ip = p.indptr + (size_t)lane * (p.n_rows + 1);
    const int a = ip[t];
    len = ip[t + 1] - a;
    base = (p.seg_off != nullptr ? p.seg_off[lane] : 0) + a;
  }
  int cum = len;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int x = __shfl_up_sync(FULL, cum, d);
    if (lane >= d) cum += x;
  }
  return RowSegments{cum, base - (cum - len)};
}

// Edge id of the row's offset v (all lanes take part).
__device__ __forceinline__ int edge_of(const Params& p, const RowSegments& rs, int v) {
  if (p.S == 1) return v + __shfl_sync(FULL, rs.base, 0);
  int e = -1;
  for (int s = 0; s < p.S; ++s) {
    const int c = __shfl_sync(FULL, rs.cum, s);
    const int b = __shfl_sync(FULL, rs.base, s);
    if (e < 0 && v < c) e = v + b;
  }
  return e;
}

// Adds the row's edges at offsets [first, end) into `sum` (this lane's VEC
// columns from c0; lane group g takes offsets g, g + G, ... of each batch
// of 32).
template <int VEC, int L>
__device__ __forceinline__ void add_edges(float (&sum)[VEC], const Params& p,
                                          const RowSegments& rs, int first, int end, int c0,
                                          bool col_ok, int lane, int g) {
  constexpr int G = 32 / L;           // edge groups per warp
  constexpr int U = L < kRowLoads ? L : kRowLoads;
  for (int vb = first; vb < end; vb += 32) {
    const int ne = min(32, end - vb);
    const int e = edge_of(p, rs, vb + lane);
    int s_l = 0;
    float sw_l = 1.0f, ew_l = 1.0f;
    if (lane < ne) {
      s_l = __ldg(p.src + e);   // 32 sources, one coalesced load per segment
      if (p.edge_w != nullptr) ew_l = __ldg(p.edge_w + e);
      if (p.src_w != nullptr) sw_l = __ldg(p.src_w + s_l);
    }
    for (int j0 = 0; j0 < ne; j0 += U * G) {
      typename Vec<VEC>::T v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u * G + g;
        const int s = __shfl_sync(FULL, s_l, j & 31);
        v[u] = (j < ne && col_ok) ? Vec<VEC>::ldg(p.values + (size_t)s * p.B + c0)
                                  : Vec<VEC>::zero();
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u * G + g;
        const float sw = __shfl_sync(FULL, sw_l, j & 31);
        const float ew = __shfl_sync(FULL, ew_l, j & 31);
        if (j < ne) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            // JAX's order: (values[s] * src_w[s]) * edge_w[e], then the add
            float x = Vec<VEC>::get(v[u], i);
            if (p.src_w != nullptr) x = x * sw;
            if (p.edge_w != nullptr) x = x * ew;
            sum[i] = sum[i] + x;
          }
        }
      }
    }
  }
}

// acc[t, c0:c0+VEC] = (masked) acc + sum; `over` records an entry above thr.
template <int VEC>
__device__ __forceinline__ void finish(const Params& p, int t, int c0, const float (&sum)[VEC],
                                       float th, bool& over) {
  float* row = p.acc + (size_t)t * p.B + c0;
  typename Vec<VEC>::T a = p.accumulate ? Vec<VEC>::load(row) : Vec<VEC>::zero();
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    float x = Vec<VEC>::get(a, i);
    if (p.mask && x > th) x = 0.0f;
    x = x + sum[i];
    over = over || (x > th);
    Vec<VEC>::set(a, i, x);
  }
  Vec<VEC>::store(row, a);
}

template <int VEC, int L>
__global__ void __launch_bounds__(kThreads, kMinBlocks) gather_tasks_kernel(const Params p) {
  const int warps = blockDim.x >> 5;
  const long long task = (long long)blockIdx.x * warps + (threadIdx.x >> 5);
  if (task >= p.n_tasks) return;   // whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int g = lane / L, cl = lane % L;
  const int4 tk = p.tasks[task];
  const int t = tk.x, first = tk.y, end = tk.z, slot = tk.w;
  const float th = p.thr != nullptr ? p.thr[t] : 0.0f;
  const int passes = (p.B + L * VEC - 1) / (L * VEC);
  const RowSegments rs = row_segments(p, t, lane);
  bool over = false;

  for (int pass = 0; pass < passes; ++pass) {
    const int c0 = (pass * L + cl) * VEC;
    const bool col_ok = c0 < p.B;
    float sum[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) sum[i] = 0.0f;
    add_edges<VEC, L>(sum, p, rs, first, end, c0, col_ok, lane, g);
    // the groups' sums, combined in one fixed order (a + b == b + a, so
    // every lane ends with the same bits)
#pragma unroll
    for (int m = L; m < 32; m <<= 1) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) sum[i] = sum[i] + __shfl_xor_sync(FULL, sum[i], m);
    }
    if (g == 0 && col_ok) {
      if (slot < 0) {
        finish<VEC>(p, t, c0, sum, th, over);
      } else {
        typename Vec<VEC>::T x;
#pragma unroll
        for (int i = 0; i < VEC; ++i) Vec<VEC>::set(x, i, sum[i]);
        Vec<VEC>::stcg(p.partial + (size_t)slot * p.B + c0, x);
      }
    }
  }

  if (slot >= 0) {
    // publish this partial; the row's last task adds all of them in order
    __threadfence();
    __syncwarp();
    const int r = p.slot_row[slot];
    const int s0 = p.split_ptr[r], s1 = p.split_ptr[r + 1];
    int last = 0;
    if (lane == 0) last = atomicAdd(p.counters + r, 1) == s1 - s0 - 1;
    last = __shfl_sync(FULL, last, 0);
    if (last) {
      __threadfence();
      if (lane == 0) p.counters[r] = 0;   // ready for the next launch
      for (int c0 = lane * VEC; c0 < p.B; c0 += 32 * VEC) {
        float sum[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) sum[i] = 0.0f;
        for (int sl = s0; sl < s1; ++sl) {
          // L2 reads: the partials were written by other SMs
          typename Vec<VEC>::T x = Vec<VEC>::ldcg(p.partial + (size_t)sl * p.B + c0);
#pragma unroll
          for (int i = 0; i < VEC; ++i) sum[i] = sum[i] + Vec<VEC>::get(x, i);
        }
        finish<VEC>(p, t, c0, sum, th, over);
      }
    }
  }
  if (p.flag != nullptr) {
    // every lane of the warp reaches this point
    if (__any_sync(FULL, over) && lane == 0) *p.flag = 1;
  }
}

template <int VEC>
cudaError_t launch(const Params& p, unsigned blocks, int threads, int lanes, cudaStream_t st) {
  switch (lanes) {
    case 1: gather_tasks_kernel<VEC, 1><<<blocks, threads, 0, st>>>(p); break;
    case 2: gather_tasks_kernel<VEC, 2><<<blocks, threads, 0, st>>>(p); break;
    case 4: gather_tasks_kernel<VEC, 4><<<blocks, threads, 0, st>>>(p); break;
    case 8: gather_tasks_kernel<VEC, 8><<<blocks, threads, 0, st>>>(p); break;
    case 16: gather_tasks_kernel<VEC, 16><<<blocks, threads, 0, st>>>(p); break;
    default: gather_tasks_kernel<VEC, 32><<<blocks, threads, 0, st>>>(p); break;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int fora_gather_scatter_add(float* acc, const float* values, const int* indptr, int S,
                                       const int* seg_off, const int* src, const float* edge_w,
                                       const float* src_w, const float* thr, int mask,
                                       int accumulate, int* flag, const int* tasks,
                                       long long n_tasks, float* partial, const int* slot_row,
                                       const int* split_ptr, int* counters, int n_rows, int B,
                                       void* stream) {
  if (n_tasks <= 0 || B <= 0) return (int)cudaGetLastError();
  const int threads = kThreads;
  const long long blocks = (n_tasks + threads / 32 - 1) / (threads / 32);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  Params p{acc,     values,   indptr,    seg_off,  S,        src,      edge_w,
           src_w,   thr,      mask,      accumulate, flag,   reinterpret_cast<const int4*>(tasks),
           n_tasks, partial,  slot_row,  split_ptr, counters, n_rows,  B};
  const bool vec4 = (B % 4 == 0) && ((reinterpret_cast<uintptr_t>(acc) & 15) == 0) &&
                    ((reinterpret_cast<uintptr_t>(values) & 15) == 0) &&
                    ((reinterpret_cast<uintptr_t>(partial) & 15) == 0);
  const int cols = vec4 ? B / 4 : B;   // vector columns of a row
  int lanes = 1;
  while (lanes < cols && lanes < 32) lanes <<= 1;
  return (int)(vec4 ? launch<4>(p, (unsigned)blocks, threads, lanes, st)
                    : launch<1>(p, (unsigned)blocks, threads, lanes, st));
}

extern "C" const char* fora_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
