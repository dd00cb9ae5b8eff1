// Philox4x32-10 draws for the ICP solve's step filters, for Hopper (sm_90a).
//
// It replaces no Pallas kernel: the JAX package draws a matcher pass's
// step-filter uniforms as uniform(fold_in(key, it)) inside its
// lax.while_loop and compares them with the filter's probability
// (icp/engine.py:585, parallel/sharded_map.py:692).  The port keys a
// counter-based generator (philox.cuh) by the draw source's seed and counts
// it by (row / 4, it, solve, call), reading `it` and `solve` from device
// memory, so a CUDA graph replays fresh draws at every pass and every solve
// with no host involved.  Layout and arithmetic are those of
// ops/philox.py::philox_plain, bit for bit: word row % 4 of the block, as
// (word >> 8) * 2^-24.
//
// Two kernels:
//   philox_uniform_kernel  the uniforms themselves, one thread per block of
//                          four rows (float4 stores); what `prio15` and any
//                          other draw of a step chain read.
//   philox_keep_kernel     a RandomSampling filter's keep bit, one thread per
//                          row of the solve: row j of the solve is original
//                          row rows[j] (the sweep sorted the reading), so the
//                          draw is that row's and no permutation is needed;
//                          keep[j] = mask[j] && u < prob, compared in f32.
//                          Each thread runs the ten rounds of its row's block
//                          for one word of it: arithmetic is free next to
//                          the launch.
//
// Bound on this card: bytes (uniform: 4 written per row; keep: 8 + 1 read
// and 1 written per row) and, at the solve's 49,152 rows, the launch.
#include "philox.cuh"

namespace {

__global__ void philox_uniform_kernel(uint32_t k0, uint32_t k1,
                                      const long long* __restrict__ solve,
                                      const int* __restrict__ it,
                                      uint32_t call, int n,
                                      float* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = b * 4;
  if (row >= n) return;
  const uint4 w = philox::block((uint32_t)b, (uint32_t)(*it),
                                (uint32_t)(unsigned long long)(*solve), call,
                                k0, k1);
  if (row + 3 < n) {
    reinterpret_cast<float4*>(out)[b] =
        make_float4(philox::unit(w.x), philox::unit(w.y),
                    philox::unit(w.z), philox::unit(w.w));
  } else {
    const uint32_t v[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (row + j < n) out[row + j] = philox::unit(v[j]);
    }
  }
}

__global__ void philox_keep_kernel(uint32_t k0, uint32_t k1,
                                   const long long* __restrict__ solve,
                                   const int* __restrict__ it, uint32_t call,
                                   float prob, const bool* __restrict__ mask,
                                   const long long* __restrict__ rows, int n,
                                   bool* __restrict__ keep) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const long long r = rows ? rows[j] : (long long)j;
  const uint4 w = philox::block((uint32_t)(r >> 2), (uint32_t)(*it),
                                (uint32_t)(unsigned long long)(*solve), call,
                                k0, k1);
  const int q = (int)(r & 3);
  const uint32_t word = q == 0 ? w.x : q == 1 ? w.y : q == 2 ? w.z : w.w;
  keep[j] = mask[j] && (philox::unit(word) < prob);
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

// k0 .. call  as philox_uniform_launch
// prob    the keep probability, f32
// mask    bool[n]: the rows still valid
// rows    int64[n] or null: the original row of each row, in [0, n) (null:
//         j itself)
// keep    bool[n]: mask[j] && draw(rows[j]) < prob
// Returns 0 or a cudaError_t from the launch.  Launches on `stream`, does not
// synchronise, allocates nothing.
extern "C" int philox_keep_launch(unsigned int k0, unsigned int k1,
                                  const void* solve, const void* it,
                                  unsigned int call, float prob,
                                  const void* mask, const void* rows, int n,
                                  void* keep, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int grid = (n + threads - 1) / threads;
  philox_keep_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      k0, k1, (const long long*)solve, (const int*)it, call, prob,
      (const bool*)mask, (const long long*)rows, n, (bool*)keep);
  return (int)cudaGetLastError();
}
