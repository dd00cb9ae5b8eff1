// Sorted-sweep radius-capped k nearest neighbours, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fused_kernel` of the JAX package's
// ops/nn_sweep.py.  For every query: the k nearest references within radius
// r among the block's window of the x-sorted references, as exact f32
// squared distances and indices into the SORTED reference array, ascending
// by distance, ties by lowest index; +inf / -1 where there is none.
//
// One thread per query keeps its k best (distance, index) pairs sorted in
// registers (k <= 6, fully unrolled, no dynamic indexing).  The TPU kernel's
// packed integer keys, planar [8, N] layout and 1e9 sentinels are not
// carried over: registers hold the list, references are row-major, and the
// wrapper clips every window to the valid references.
//
// Bound on this card: operations.  A pair costs D subtractions, D products,
// D-1 sums and a compare in f32; the window of a block is read once from L2
// or device memory and then served from shared memory, so bytes are far
// below the operation time at the path's shapes (see PERF.md).
#include "sweep_common.cuh"

namespace {

template <int D, int K>
__global__ void sweep_knn_kernel(const float* __restrict__ q,
                                 const uint8_t* __restrict__ qmask,
                                 const float* __restrict__ ref,
                                 const int* __restrict__ start,
                                 const int* __restrict__ end, float r2, int n,
                                 float* __restrict__ out_d,
                                 int* __restrict__ out_i) {
  __shared__ float tile[SWEEP_TR * D];
  const int b = blockIdx.x;
  const int i = b * blockDim.x + threadIdx.x;
  const bool valid = (i < n) && (qmask[i < n ? i : 0] != 0);

  float qv[D];
#pragma unroll
  for (int a = 0; a < D; ++a) qv[a] = valid ? q[(size_t)i * D + a] : 0.0f;

  float bd[K];
  int bi[K];
#pragma unroll
  for (int t = 0; t < K; ++t) {
    bd[t] = __int_as_float(0x7f800000);  // +inf
    bi[t] = -1;
  }

  const int s0 = start[b];
  const int e0 = end[b];
  for (int base = s0; base < e0; base += SWEEP_TR) {
    const int cnt = min(SWEEP_TR, e0 - base);
    __syncthreads();  // previous tile fully consumed
    sweep_stage<D>(tile, ref, base, cnt);
    __syncthreads();
    if (valid) {
      for (int j = 0; j < cnt; ++j) {
        const float d2 = sweep_dist2<D>(qv, &tile[j * D]);
        // strict `<` against the current worst: references arrive in
        // ascending index, so an equal distance never displaces an earlier
        // (lower) index -- the tie rule of argmin
        if (d2 <= r2 && d2 < bd[K - 1]) {
          float cd = d2;
          int ci = base + j;
          bool carrying = false;  // once placed, shift the rest down
#pragma unroll
          for (int t = 0; t < K; ++t) {
            const bool sw = carrying || (cd < bd[t]);
            if (sw) {
              const float td = bd[t];
              const int ti = bi[t];
              bd[t] = cd;
              bi[t] = ci;
              cd = td;
              ci = ti;
              carrying = true;
            }
          }
        }
      }
    }
  }

  if (i < n) {
#pragma unroll
    for (int t = 0; t < K; ++t) {
      out_d[(size_t)i * K + t] = bd[t];
      out_i[(size_t)i * K + t] = bi[t];
    }
  }
}

template <int D, int K>
int launch(const float* q, const uint8_t* qmask, const float* ref,
           const int* start, const int* end, float r2, int n, int n_blocks,
           int block, float* out_d, int* out_i, cudaStream_t stream) {
  sweep_knn_kernel<D, K><<<n_blocks, block, 0, stream>>>(
      q, qmask, ref, start, end, r2, n, out_d, out_i);
  return (int)cudaGetLastError();
}

template <int D>
int dispatch_k(int k, const float* q, const uint8_t* qmask, const float* ref,
               const int* start, const int* end, float r2, int n,
               int n_blocks, int block, float* out_d, int* out_i,
               cudaStream_t stream) {
  switch (k) {
    case 1: return launch<D, 1>(q, qmask, ref, start, end, r2, n, n_blocks, block, out_d, out_i, stream);
    case 2: return launch<D, 2>(q, qmask, ref, start, end, r2, n, n_blocks, block, out_d, out_i, stream);
    case 3: return launch<D, 3>(q, qmask, ref, start, end, r2, n, n_blocks, block, out_d, out_i, stream);
    case 4: return launch<D, 4>(q, qmask, ref, start, end, r2, n, n_blocks, block, out_d, out_i, stream);
    case 5: return launch<D, 5>(q, qmask, ref, start, end, r2, n, n_blocks, block, out_d, out_i, stream);
    case 6: return launch<D, 6>(q, qmask, ref, start, end, r2, n, n_blocks, block, out_d, out_i, stream);
    default: return -2;
  }
}

}  // namespace

// q      f32[n, dim]   queries in sweep (ascending-x) order, row-major
// qmask  u8[n]         1 = valid query
// ref    f32[m, dim]   x-sorted references, row-major
// start, end  i32[n_blocks]  reference window of each block of `block`
//                            consecutive queries (end <= number of valid refs)
// out_d  f32[n, k], out_i i32[n, k]
// Returns 0, a cudaError_t from the launch, or -1/-2 for an unsupported
// dim / k.  Launches on `stream`, does not synchronise, allocates nothing.
extern "C" int sweep_knn_launch(const void* q, const void* qmask,
                                const void* ref, const void* start,
                                const void* end, float r2, int n,
                                int n_blocks, int block, int dim, int k,
                                void* out_d, void* out_i, void* stream) {
  if (n_blocks <= 0) return 0;
  const float* qf = (const float*)q;
  const uint8_t* qm = (const uint8_t*)qmask;
  const float* rf = (const float*)ref;
  const int* st = (const int*)start;
  const int* en = (const int*)end;
  float* od = (float*)out_d;
  int* oi = (int*)out_i;
  cudaStream_t s = (cudaStream_t)stream;
  if (dim == 3) return dispatch_k<3>(k, qf, qm, rf, st, en, r2, n, n_blocks, block, od, oi, s);
  if (dim == 2) return dispatch_k<2>(k, qf, qm, rf, st, en, r2, n, n_blocks, block, od, oi, s);
  return -1;
}
