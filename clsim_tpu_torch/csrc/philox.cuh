// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC11; Random123's philox4x32 with 10 rounds): the random numbers of the
// propagation kernel (propagate.cuh) and of the probe kernels (probes.cu).
// Its plain version is clsim_tpu_torch/probes.py::philox4x32_10_plain.

#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const unsigned int lo0 = 0xD2511F53u * c.x;
    const unsigned int hi0 = __umulhi(0xD2511F53u, c.x);
    const unsigned int lo1 = 0xCD9E8D57u * c.z;
    const unsigned int hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}
