// Shared pieces of the kernels: the two sorted-sweep kernels (sweep_knn.cu,
// radius_pca.cu) and the brute-force search (knn_brute.cu), which uses the
// distance and the staging below with the whole reference array as its window.
//
// Schedule, common to the two sweeps: queries and references are sorted by x.  One
// thread owns one query; a block owns `blockDim.x` consecutive sorted
// queries and a contiguous window [start[b], end[b]) of the sorted
// references that the wrapper computed for it (every reference within the
// radius of any of the block's queries lies inside).  The block streams its
// window through shared memory in tiles of SWEEP_TR references; every thread
// reads every staged reference (a broadcast read, no bank conflict).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define SWEEP_TR 256  // references staged per shared-memory tile

// Squared distance, subtract first, every product and sum rounded to f32 on
// its own: the intrinsics stop nvcc from contracting `s + d*d` into an FMA.
// Eager PyTorch (the plain version) and XLA on the CPU do not contract, so
// with this form kernel and plain version agree bit for bit and a pair
// within an ulp of r^2 falls on the same side of the gate in both.
template <int D>
__device__ __forceinline__ float sweep_dist2(const float* __restrict__ q,
                                             const float* __restrict__ r) {
  float d0 = __fsub_rn(r[0], q[0]);
  float s = __fmul_rn(d0, d0);
#pragma unroll
  for (int a = 1; a < D; ++a) {
    float d = __fsub_rn(r[a], q[a]);
    s = __fadd_rn(s, __fmul_rn(d, d));
  }
  return s;
}

// Cooperative copy of `cnt` references (row-major [cnt, D], contiguous in
// global memory, so the copy is coalesced) into the shared tile.
template <int D>
__device__ __forceinline__ void sweep_stage(float* tile,
                                            const float* __restrict__ ref,
                                            int base, int cnt) {
  const float* src = ref + (size_t)base * D;
  for (int t = threadIdx.x; t < cnt * D; t += blockDim.x) tile[t] = src[t];
}
