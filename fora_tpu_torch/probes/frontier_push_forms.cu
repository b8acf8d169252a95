// Other grids of K5 (kernels/csrc/frontier_push.cu), kept only so that
// probes/frontier_probe.py (and chip_smoke.py's phase 16) can time them
// beside the package's on the same state; no entry point of the package
// loads them.  Both give a warp several tasks where the package's K5 gives
// it one:
//   persistent: the blocks the card holds at once, each warp taking tasks
//     w, w + warps, ... one after another (push_task, the package's body);
//   packed: a warp takes TPW consecutive tasks side by side, its lanes over
//     their (edge, lane slot) pairs laid end to end, so that short tasks
//     fill its lanes.
#include "../kernels/csrc/frontier_push.cu"

namespace {

template <int W>
__global__ void __launch_bounds__(kThreads)
    persistent_kernel(float* __restrict__ r, const float* __restrict__ contrib,
                      const int4* __restrict__ tasks, long long n_tasks,
                      const int* __restrict__ indices, int B, int span) {
  const long long warps = (long long)gridDim.x * kWarps;
  for (long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); w < n_tasks; w += warps)
    push_task<W>(r, contrib, tasks[w], indices, B, span);
}

template <int W, int TPW>
__global__ void __launch_bounds__(kThreads)
    packed_kernel(float* __restrict__ r, const float* __restrict__ contrib,
                  const int4* __restrict__ tasks, long long n_tasks,
                  const int* __restrict__ indices, int B, int span) {
  const int lane = threadIdx.x & 31;
  const long long t0 = ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * TPW;
  if (t0 >= n_tasks) return;   // the whole warp
  // lane i < TPW holds task t0 + i: its lanes an edge (2^lg), row and first edge
  int lg = 0, pairs = 0;
  unsigned mask = 0;
  long long row = 0, first = 0;
  if (lane < TPW && t0 + lane < n_tasks) {
    const int4 task = tasks[t0 + lane];
    mask = (unsigned)task.z;
    const int nb = __popc(mask);
    lg = nb <= 1 ? 0 : 32 - __clz(nb - 1);
    row = task.x;
    first = task.y;
    pairs = task.w << lg;
  }
  int incl = pairs;
#pragma unroll
  for (int off = 1; off < TPW; off <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  const int excl = incl - pairs;
  const int total = __shfl_sync(kFull, incl, TPW - 1);
  for (int base = 0; base < total; base += 32) {
    const int q = base + lane;
    int i = 0;   // the task holding slot q: the first whose inclusive sum passes q
#pragma unroll
    for (int step = TPW / 2; step > 0; step >>= 1)
      if (__shfl_sync(kFull, incl, i + step - 1) <= q) i += step;
    const int ex = __shfl_sync(kFull, excl, i);
    const int lgi = __shfl_sync(kFull, lg, i);
    const unsigned mi = __shfl_sync(kFull, mask, i);
    const long long fi = __shfl_sync(kFull, first, i);
    const long long ri = __shfl_sync(kFull, row, i);
    if (q >= total) continue;
    const int local = q - ex;
    const int slot = local & ((1 << lgi) - 1);
    if (slot >= __popc(mi)) continue;
    unsigned m = mi;
    for (int k = 0; k < slot; ++k) m &= m - 1;
    const int c0 = (__ffs(m) - 1) * span;
    const int c1 = min(c0 + span, B);
    const float* src = contrib + ri * B;
    float* out = r + (long long)__ldg(indices + fi + (local >> lgi)) * B;
    for (int cc = c0; cc < c1; cc += W) {
      if constexpr (W == 4)
        atomicAdd(reinterpret_cast<float4*>(out + cc),
                  __ldg(reinterpret_cast<const float4*>(src + cc)));
      else
        atomicAdd(out + cc, __ldg(src + cc));
    }
  }
}

template <template <int> class Launch>
int launch_form(float* r, const float* contrib, const int* tasks, long long n_tasks,
                const int* indices, int B, void* stream) {
  if (B <= 0 || n_tasks < 0 || !aligned16(tasks))
    return (int)cudaErrorInvalidValue;
  if (n_tasks == 0) return (int)cudaGetLastError();
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int4* t = reinterpret_cast<const int4*>(tasks);
  const int span = mask_span(B);
  if (span % 4 == 0 && aligned16(r) && aligned16(contrib))
    Launch<4>::run(r, contrib, t, n_tasks, indices, B, span, st);
  else
    Launch<1>::run(r, contrib, t, n_tasks, indices, B, span, st);
  return (int)cudaGetLastError();
}

template <int W>
struct Persistent {
  static void run(float* r, const float* contrib, const int4* t, long long n_tasks,
                  const int* indices, int B, int span, cudaStream_t st) {
    constexpr auto kernel = persistent_kernel<W>;
    const long long blocks = grid_for<kernel>(n_tasks, kWarps);
    kernel<<<(unsigned)blocks, kThreads, 0, st>>>(r, contrib, t, n_tasks, indices, B, span);
  }
};

template <int TPW>
struct Packed {
  template <int W>
  struct By {
    static void run(float* r, const float* contrib, const int4* t, long long n_tasks,
                    const int* indices, int B, int span, cudaStream_t st) {
      const long long warps = (n_tasks + TPW - 1) / TPW;
      packed_kernel<W, TPW><<<(unsigned)((warps + kWarps - 1) / kWarps), kThreads, 0, st>>>(
          r, contrib, t, n_tasks, indices, B, span);
    }
  };
};

}  // namespace

// the arguments of fora_frontier_push
extern "C" int fora_frontier_push_persistent(float* r, const float* contrib, const int* tasks,
                                             long long n_tasks, const int* indices, int B,
                                             void* stream) {
  return launch_form<Persistent>(r, contrib, tasks, n_tasks, indices, B, stream);
}

extern "C" int fora_frontier_push_packed2(float* r, const float* contrib, const int* tasks,
                                          long long n_tasks, const int* indices, int B,
                                          void* stream) {
  return launch_form<Packed<2>::By>(r, contrib, tasks, n_tasks, indices, B, stream);
}

extern "C" int fora_frontier_push_packed4(float* r, const float* contrib, const int* tasks,
                                          long long n_tasks, const int* indices, int B,
                                          void* stream) {
  return launch_form<Packed<4>::By>(r, contrib, tasks, n_tasks, indices, B, stream);
}
