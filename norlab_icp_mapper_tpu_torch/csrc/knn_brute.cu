// Brute-force k nearest neighbours over all query x reference pairs, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of the JAX package's
// ops/nn_pallas.py (launched by `_knn_planar`, wrapped by `knn_pallas`).  For
// every valid query: the k references with the smallest squared distance, as
// exact f32 squared distances and reference indices, ascending by distance,
// ties by lowest index; +inf / -1 where there are fewer than k references,
// and for an invalid query.
//
// One thread per query, a block of 128 queries; the block streams ALL packed
// references through shared memory in tiles of SWEEP_TR, every thread reads
// every staged reference (a broadcast read).  This is the sorted sweep's
// inner loop with the window [0, n_ref) and no radius gate.  Each thread
// keeps its K best (distance, index) pairs sorted in registers: K is a
// template bucket (1, 4, 8, 16, 32) that holds the caller's k, the insertion
// is a fully unrolled carry chain, so the list is never indexed by a runtime
// value and stays out of local memory.  The first k of the K entries are
// written.
//
// Not carried over from the TPU kernel: the planar [8, N] layout, the 1e9
// sentinel coordinates (the wrapper packs the valid references to the front
// and hands over their count, so the kernel never sees an invalid one), the
// ranking by the shifted distance |r|^2 - 2 q.r from a matrix product (the
// distance is subtract-first, `sweep_dist2`, bit-identical to the plain
// version), and the k rounds of min-extraction over a concatenated block.
//
// Bound on this card: operations.  A pair costs D subtractions, D products,
// D-1 sums and a compare in f32 (9 at D=3); queries, references and the 12 k
// output bytes per query are read and written once, which is far below the
// operation time at the path's shapes (see PERF.md).
#include "sweep_common.cuh"

namespace {

template <int D, int K>
__global__ void knn_brute_kernel(const float* __restrict__ q,
                                 const uint8_t* __restrict__ qmask,
                                 const float* __restrict__ ref,
                                 const int* __restrict__ ref_ids,
                                 const long long* __restrict__ n_ref_ptr,
                                 int n, int k, float* __restrict__ out_d,
                                 long long* __restrict__ out_i) {
  __shared__ float tile[SWEEP_TR * D];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = (i < n) && (qmask == nullptr || qmask[i < n ? i : 0] != 0);

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

  // a block without a valid query (the padded tail of a buffer) reads nothing
  const int m = __syncthreads_or(valid) ? (int)(*n_ref_ptr) : 0;
  for (int base = 0; base < m; base += SWEEP_TR) {
    const int cnt = min(SWEEP_TR, m - base);
    __syncthreads();  // previous tile fully consumed
    sweep_stage<D>(tile, ref, base, cnt);
    __syncthreads();
    if (valid) {
      for (int j = 0; j < cnt; ++j) {
        const float d2 = sweep_dist2<D>(qv, &tile[j * D]);
        // strict `<` against the current worst: references arrive in
        // ascending index, so an equal distance never displaces an earlier
        // (lower) index
        if (d2 < bd[K - 1]) {
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
      if (t < k) {
        out_d[(size_t)i * k + t] = bd[t];
        long long id = -1;
        if (bi[t] >= 0) id = ref_ids != nullptr ? ref_ids[bi[t]] : bi[t];
        out_i[(size_t)i * k + t] = id;
      }
    }
  }
}

template <int D, int K>
int launch(const float* q, const uint8_t* qmask, const float* ref,
           const int* ref_ids, const long long* n_ref, int n, int k,
           float* out_d, long long* out_i, cudaStream_t stream) {
  const int block = 128;
  const int n_blocks = (n + block - 1) / block;
  knn_brute_kernel<D, K><<<n_blocks, block, 0, stream>>>(
      q, qmask, ref, ref_ids, n_ref, n, k, out_d, out_i);
  return (int)cudaGetLastError();
}

template <int D>
int dispatch_k(const float* q, const uint8_t* qmask, const float* ref,
               const int* ref_ids, const long long* n_ref, int n, int k,
               float* out_d, long long* out_i, cudaStream_t stream) {
  if (k < 1) return -2;
  if (k == 1) return launch<D, 1>(q, qmask, ref, ref_ids, n_ref, n, k, out_d, out_i, stream);
  if (k <= 4) return launch<D, 4>(q, qmask, ref, ref_ids, n_ref, n, k, out_d, out_i, stream);
  if (k <= 8) return launch<D, 8>(q, qmask, ref, ref_ids, n_ref, n, k, out_d, out_i, stream);
  if (k <= 16) return launch<D, 16>(q, qmask, ref, ref_ids, n_ref, n, k, out_d, out_i, stream);
  if (k <= 32) return launch<D, 32>(q, qmask, ref, ref_ids, n_ref, n, k, out_d, out_i, stream);
  return -2;
}

}  // namespace

// q        f32[n, dim]  queries, row-major
// qmask    u8[n]        1 = valid query; NULL = all valid
// ref      f32[m, dim]  references with the valid ones packed to the front,
//                       in their original order
// ref_ids  i32[m]       original index of each packed reference; NULL = the
//                       packed position is the index
// n_ref    i64[1]       number of packed (valid) references, on the device
// out_d    f32[n, k], out_i i64[n, k]
// Returns 0, a cudaError_t from the launch, or -1/-2 for an unsupported
// dim / k.  Launches on `stream`, does not synchronise, allocates nothing.
extern "C" int knn_brute_launch(const void* q, const void* qmask,
                                const void* ref, const void* ref_ids,
                                const void* n_ref, int n, int dim, int k,
                                void* out_d, void* out_i, void* stream) {
  if (n <= 0) return 0;
  const float* qf = (const float*)q;
  const uint8_t* qm = (const uint8_t*)qmask;
  const float* rf = (const float*)ref;
  const int* ids = (const int*)ref_ids;
  const long long* nr = (const long long*)n_ref;
  float* od = (float*)out_d;
  long long* oi = (long long*)out_i;
  cudaStream_t s = (cudaStream_t)stream;
  if (dim == 3) return dispatch_k<3>(qf, qm, rf, ids, nr, n, k, od, oi, s);
  if (dim == 2) return dispatch_k<2>(qf, qm, rf, ids, nr, n, k, od, oi, s);
  return -1;
}
