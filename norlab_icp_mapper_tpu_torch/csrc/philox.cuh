// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC'11) for the step filters' keyed draws: the ten rounds of one block,
// shared by every kernel of philox.cu so that they compute the same words.
// The arithmetic is that of ops/philox.py::philox_plain, bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace philox {

constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;  // round multipliers
constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;  // key increments

// The four words of the block at counter (c0, c1, c2, c3) under the key
// (k0, k1).
__device__ __forceinline__ uint4 block(uint32_t c0, uint32_t c1, uint32_t c2,
                                       uint32_t c3, uint32_t k0,
                                       uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += W0;
      k1 += W1;
    }
    const uint32_t hi0 = __umulhi(M0, c0), lo0 = M0 * c0;
    const uint32_t hi1 = __umulhi(M1, c2), lo1 = M1 * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

// A word as a uniform in [0, 1): its top 24 bits times 2^-24 (exact in f32).
__device__ __forceinline__ float unit(uint32_t w) {
  return (float)(w >> 8) * (1.0f / 16777216.0f);
}

}  // namespace philox
