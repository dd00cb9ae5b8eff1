// Philox4x32-10 uniforms for the ICP solve's step filters, for Hopper
// (sm_90a).
//
// It replaces no Pallas kernel: the JAX package draws a matcher pass's
// step-filter uniforms as uniform(fold_in(key, it)) inside its
// lax.while_loop (icp/engine.py:585, parallel/sharded_map.py:692).  The port
// keys a counter-based generator (Salmon et al., SC'11) by the draw source's
// seed and counts it by (row / 4, it, solve, call), reading `it` and `solve`
// from device memory, so a CUDA graph replays fresh draws at every pass and
// every solve with no host involved.  Layout and arithmetic are those of
// ops/philox.py::philox_plain, bit for bit: word row % 4 of the block, as
// (word >> 8) * 2^-24.
//
// Bound on this card: bytes (4 written per row; ~30 integer operations per
// row), and at the solve's 49,152 rows the launch.  One thread computes one
// block of four rows in registers and writes them.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;

__global__ void philox_uniform_kernel(uint32_t k0, uint32_t k1,
                                      const long long* __restrict__ solve,
                                      const int* __restrict__ it,
                                      uint32_t call, int n,
                                      float* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = b * 4;
  if (row >= n) return;
  uint32_t c0 = (uint32_t)b;
  uint32_t c1 = (uint32_t)(*it);
  uint32_t c2 = (uint32_t)(unsigned long long)(*solve);
  uint32_t c3 = call;
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
  const uint32_t w[4] = {c0, c1, c2, c3};
  const float scale = 1.0f / 16777216.0f;
  if (row + 3 < n) {
    float4 v = make_float4((float)(w[0] >> 8) * scale,
                           (float)(w[1] >> 8) * scale,
                           (float)(w[2] >> 8) * scale,
                           (float)(w[3] >> 8) * scale);
    reinterpret_cast<float4*>(out)[b] = v;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (row + j < n) out[row + j] = (float)(w[j] >> 8) * scale;
    }
  }
}

}  // namespace

// k0, k1  the key: the seed's low and high 32-bit words
// solve   int64 on the device: the draw source's solve index (mod 2^32)
// it      int32 on the device: the loop's iteration counter
// call    the draw's place among one pass's draws
// out     f32[n]
// Returns 0 or a cudaError_t from the launch.  Launches on `stream`, does not
// synchronise, allocates nothing.
extern "C" int philox_uniform_launch(unsigned int k0, unsigned int k1,
                                     const void* solve, const void* it,
                                     unsigned int call, int n, void* out,
                                     void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + 3) / 4;
  const int threads = 256;
  const int grid = (blocks + threads - 1) / threads;
  philox_uniform_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      k0, k1, (const long long*)solve, (const int*)it, call, n, (float*)out);
  return (int)cudaGetLastError();
}
