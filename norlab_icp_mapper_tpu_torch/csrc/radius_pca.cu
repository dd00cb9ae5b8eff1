// Radius-neighbourhood moments on the sorted-sweep schedule, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_pca_fused_kernel` of the JAX package's
// ops/pca.py.  For every query: over all references within radius r in the
// block's window of the x-sorted references, the count, the sum of x and the
// upper triangle of the sum of x x^T -- 10 rows at D=3
// (1, x, y, z, xx, yy, zz, xy, xz, yz), 6 at D=2 (1, x, y, xx, yy, xy).
//
// One thread per query keeps its moment sums in registers and adds a
// reference's moments when d^2 <= r^2.  The TPU kernel's 0/1 gate matrix
// and its `M @ W` matmul (rows padded to 16 for the matrix unit) are not
// carried over: the gate is a predicate, the sums are per-thread adds.
// The distance is rounded exactly like the plain version's (see
// sweep_common.cuh), so the counts agree exactly; the sums are taken in
// window order and may contract into FMAs, so they agree with the plain
// version's matrix product to f32 summation error only.
//
// Bound on this card: operations (the same pair test as sweep_knn plus the
// adds of the pairs that pass); output is n_moments floats per query.
#include "sweep_common.cuh"

namespace {

template <int D>
__global__ void radius_pca_kernel(const float* __restrict__ q,
                                  const uint8_t* __restrict__ qmask,
                                  const float* __restrict__ ref,
                                  const int* __restrict__ start,
                                  const int* __restrict__ end, float r2,
                                  int n, float* __restrict__ out) {
  constexpr int NM = 1 + D + D * (D + 1) / 2;
  __shared__ float tile[SWEEP_TR * D];
  const int b = blockIdx.x;
  const int i = b * blockDim.x + threadIdx.x;
  const bool valid = (i < n) && (qmask[i < n ? i : 0] != 0);

  float qv[D];
#pragma unroll
  for (int a = 0; a < D; ++a) qv[a] = valid ? q[(size_t)i * D + a] : 0.0f;

  float acc[NM];
#pragma unroll
  for (int t = 0; t < NM; ++t) acc[t] = 0.0f;

  const int s0 = start[b];
  const int e0 = end[b];
  for (int base = s0; base < e0; base += SWEEP_TR) {
    const int cnt = min(SWEEP_TR, e0 - base);
    __syncthreads();
    sweep_stage<D>(tile, ref, base, cnt);
    __syncthreads();
    if (valid) {
      for (int j = 0; j < cnt; ++j) {
        const float* r = &tile[j * D];
        const float d2 = sweep_dist2<D>(qv, r);
        if (d2 <= r2) {
          acc[0] += 1.0f;
#pragma unroll
          for (int a = 0; a < D; ++a) {
            acc[1 + a] += r[a];
            acc[1 + D + a] += r[a] * r[a];
          }
          int m = 1 + 2 * D;
#pragma unroll
          for (int a = 0; a < D; ++a) {
#pragma unroll
            for (int c = a + 1; c < D; ++c) {
              acc[m] += r[a] * r[c];
              ++m;
            }
          }
        }
      }
    }
  }

  if (i < n) {
#pragma unroll
    for (int t = 0; t < NM; ++t) out[(size_t)t * n + i] = acc[t];
  }
}

}  // namespace

// q      f32[n, dim]   queries in sweep (ascending-x) order, row-major
// qmask  u8[n]         1 = valid query (an invalid query gets zeros)
// ref    f32[m, dim]   x-sorted references, row-major
// start, end  i32[n_blocks]  reference window of each block of `block`
//                            consecutive queries (end <= number of valid refs)
// out    f32[n_moments, n]
// Returns 0, a cudaError_t from the launch, or -1 for an unsupported dim.
// Launches on `stream`, does not synchronise, allocates nothing.
extern "C" int radius_pca_launch(const void* q, const void* qmask,
                                 const void* ref, const void* start,
                                 const void* end, float r2, int n,
                                 int n_blocks, int block, int dim, void* out,
                                 void* stream) {
  if (n_blocks <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dim == 3) {
    radius_pca_kernel<3><<<n_blocks, block, 0, s>>>(
        (const float*)q, (const uint8_t*)qmask, (const float*)ref,
        (const int*)start, (const int*)end, r2, n, (float*)out);
  } else if (dim == 2) {
    radius_pca_kernel<2><<<n_blocks, block, 0, s>>>(
        (const float*)q, (const uint8_t*)qmask, (const float*)ref,
        (const int*)start, (const int*)end, r2, n, (float*)out);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}
