// Philox-4x32-10 (Salmon et al., SC 2011; Random123's philox4x32 with ten
// rounds), the counter-based generator of the walk kernel (walk.cu) and of
// the probe that measures its rate (philox_probe.cu).  Random123's known
// answers hold for it (tests/test_torch_walk_philox.py checks the plain
// PyTorch copy, ops/walk.py::philox4x32_10, against them).
#pragma once
#include <stdint.h>

static __device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += W0;
    k.y += W1;
  }
  return c;
}
