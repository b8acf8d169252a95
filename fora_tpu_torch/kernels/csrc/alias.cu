// Walker/Vose alias tables over the rows of a CSR: host code, no kernel.
//
// A copy of fora_tpu/_native/graph_io.cpp::fora_build_alias (211-260),
// compiled into this library so that the port loads nothing of the JAX
// package; graph/alias.py::build_alias_library calls it through ctypes and
// graph/alias.py::build_alias is the numpy copy of the same construction.
// For each row [indptr[v], indptr[v+1]) it fills per-slot (prob, other) such
// that taking slot j uniformly, then cols[j] with probability prob[j] and
// other[j] otherwise, draws cols in proportion to w.  O(m) in all, float64
// scaled weights, two index stacks reused across rows; a slot left on a
// stack at the end (float rounding included) keeps prob 1 and its own
// destination, which the caller fills in before the call.
//
// It runs once per graph on the host when a weighted graph is laid out on
// the card: at the bench's scale (RMAT 2^19 nodes, 2^23 edges) the same
// loop in Python takes tens of seconds.
#include <stdint.h>
#include <stdlib.h>

extern "C" int fora_build_alias(const int64_t* indptr, const int32_t* cols, const float* w,
                                long long n, float* prob, int32_t* other) {
  int64_t max_deg = 0;
  for (int64_t v = 0; v < n; ++v) {
    const int64_t d = indptr[v + 1] - indptr[v];
    if (d > max_deg) max_deg = d;
  }
  const size_t cap = static_cast<size_t>(max_deg > 0 ? max_deg : 1);
  int64_t* small = static_cast<int64_t*>(malloc(sizeof(int64_t) * cap));
  int64_t* large = static_cast<int64_t*>(malloc(sizeof(int64_t) * cap));
  double* p = static_cast<double*>(malloc(sizeof(double) * cap));
  if (!small || !large || !p) {
    free(small);
    free(large);
    free(p);
    return -1;
  }
  for (int64_t v = 0; v < n; ++v) {
    const int64_t lo = indptr[v], hi = indptr[v + 1];
    const int64_t d = hi - lo;
    if (d == 0) continue;
    double sum = 0.0;
    for (int64_t i = 0; i < d; ++i) sum += w[lo + i];
    int64_t ns = 0, nl = 0;
    for (int64_t i = 0; i < d; ++i) {
      p[i] = w[lo + i] / sum * static_cast<double>(d);
      prob[lo + i] = 1.0f;
      other[lo + i] = cols[lo + i];
      if (p[i] < 1.0)
        small[ns++] = i;
      else
        large[nl++] = i;
    }
    while (ns > 0 && nl > 0) {
      const int64_t s = small[--ns];
      const int64_t l = large[--nl];
      prob[lo + s] = static_cast<float>(p[s]);
      other[lo + s] = cols[lo + l];
      p[l] = (p[l] + p[s]) - 1.0;
      if (p[l] < 1.0)
        small[ns++] = l;
      else
        large[nl++] = l;
    }
  }
  free(small);
  free(large);
  free(p);
  return 0;
}
