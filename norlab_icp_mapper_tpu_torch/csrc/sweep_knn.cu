// Sorted-sweep radius-capped k nearest neighbours, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fused_kernel` of the JAX package's
// ops/nn_sweep.py.  For every query: the k nearest references within radius
// r among the block's window of the x-sorted references, as exact f32
// squared distances and ORIGINAL reference indices, ascending by distance,
// ties by lowest sorted position; +inf / -1 where there is none.
//
// Bound on this card: operations, and among them instruction dispatch (a pair
// costs 3 subtractions, 3 products, 2 sums and its ranking, each its own
// instruction; see sweep_common.cuh), and on top of that the windows'
// unequal lengths: with one block per window the kernel ended with its
// longest window.  What the design does about it:
//   * The pair loop of sweep_common.cuh: sorted references packed as float4
//     (centred x, y, z and the bits of the original index, so no gather
//     through the sort order afterwards), SWEEP_Q queries per thread,
//     cp.async staging in a two-deep ring, ranking by groups.  The radius
//     gate d2 <= r2 stays: at k = 1 on the final minimum, at k > 1 on every
//     candidate.
//   * Work units of equal length: a block of PAIR_THREADS * SWEEP_Q
//     consecutive sorted queries has a window [start[b], end[b]) of at most
//     W references; it is cut into S chunks of `chunk` references, the grid
//     is blocks x S (a size known on the host), the S blocks of a window
//     form a thread-block cluster and merge their lists in distributed
//     shared memory (chunks ascend, insertion is strict `<`: the tie rule
//     holds across chunk borders).  A chunk beyond its window's end is
//     empty.  Blocks then differ by at most `chunk` references.
//   * Sorted queries have their invalid rows at the end, and the wrapper
//     gives a block without a valid query an empty window: no list of valid
//     queries is needed.
// Tensor cores are not used; sweep_common.cuh says why.  Not carried over
// from the TPU kernel: the packed integer keys, the planar [8, N] layout and
// the 1e9 sentinels.
#include "sweep_common.cuh"

namespace cg = cooperative_groups;

#define SWEEP_TILE 512  // references per stage of the ring (8 KB)
#define SWEEP_Q 2       // queries per thread

namespace {

template <int D, int K>
__global__ void __launch_bounds__(PAIR_THREADS)
sweep_knn_kernel(const float* __restrict__ q,
                 const uint8_t* __restrict__ qmask,
                 const float4* __restrict__ ref4,
                 const int* __restrict__ start, const int* __restrict__ end,
                 float r2, int n, int chunk, float* __restrict__ out_d,
                 long long* __restrict__ out_i) {
  constexpr int Q = SWEEP_Q;
  constexpr int SLOTS = PAIR_THREADS * Q;  // queries per block
  constexpr int RING_BYTES = PAIR_STAGES * SWEEP_TILE * 16;
  constexpr int LIST_BYTES = K * SLOTS * 8;
  // the ring of staged tiles; after the search the same bytes hold the
  // block's partial lists for the merge
  __shared__ __align__(16) unsigned char
      smem[LIST_BYTES > RING_BYTES ? LIST_BYTES : RING_BYTES];

  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / S;
  const int tid = threadIdx.x;

  int row[Q];
  bool valid[Q];
  float qv[Q][D];
#pragma unroll
  for (int a = 0; a < Q; ++a) {
    row[a] = b * SLOTS + a * PAIR_THREADS + tid;
    valid[a] = row[a] < n && qmask[row[a] < n ? row[a] : 0] != 0;
#pragma unroll
    for (int c = 0; c < D; ++c)
      qv[a][c] = valid[a] ? q[(size_t)row[a] * D + c] : 0.0f;
  }

  float bd[Q][K];
  int bi[Q][K];  // K == 1: sorted position of the group that holds the best
#pragma unroll
  for (int a = 0; a < Q; ++a) {
#pragma unroll
    for (int t = 0; t < K; ++t) {
      bd[a][t] = PAIR_INF;
      bi[a][t] = -1;
    }
  }

  // this block's chunk of the window
  const int s0 = start[b];
  const int e0 = end[b];
  const int r0 = min(e0, s0 + rank * chunk);
  const int r1 = min(e0, r0 + chunk);
  float gate[Q];
#pragma unroll
  for (int a = 0; a < Q; ++a) gate[a] = r2;
  pair_search_range<D, K, Q, SWEEP_TILE>(reinterpret_cast<float4*>(smem),
                                         ref4, r0, r1, gate, qv, bd, bi);

  if (S > 1) {
    pair_merge_cluster<K, Q>(cluster, smem, bd, bi);
    if (rank != 0) return;
  }

#pragma unroll
  for (int a = 0; a < Q; ++a) {
    if (row[a] >= n) continue;
    if constexpr (K == 1) {
      float d = PAIR_INF;
      int id = -1;
      if (valid[a] && bd[a][0] <= r2) {
        d = bd[a][0];
        id = pair_first_at<D>(ref4, bi[a][0], e0, qv[a], d);
      }
      out_d[row[a]] = d;
      out_i[row[a]] = id;
    } else {
#pragma unroll
      for (int t = 0; t < K; ++t) {
        out_d[(size_t)row[a] * K + t] = valid[a] ? bd[a][t] : PAIR_INF;
        out_i[(size_t)row[a] * K + t] = valid[a] ? bi[a][t] : -1;
      }
    }
  }
}

template <int D, int K>
int launch(const float* q, const uint8_t* qmask, const float4* ref4,
           const int* start, const int* end, float r2, int n, int n_blocks,
           int chunks, int chunk, float* out_d, long long* out_i,
           cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n_blocks * chunks), 1, 1);
  cfg.blockDim = dim3(PAIR_THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)chunks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err =
      cudaLaunchKernelEx(&cfg, sweep_knn_kernel<D, K>, q, qmask, ref4, start,
                         end, r2, n, chunk, out_d, out_i);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int D>
int dispatch_k(int k, const float* q, const uint8_t* qmask, const float4* ref4,
               const int* start, const int* end, float r2, int n,
               int n_blocks, int chunks, int chunk, float* out_d,
               long long* out_i, cudaStream_t stream) {
#define SWEEP_LAUNCH(KK)                                                   \
  case KK:                                                                 \
    return launch<D, KK>(q, qmask, ref4, start, end, r2, n, n_blocks,      \
                         chunks, chunk, out_d, out_i, stream)
  switch (k) {
    SWEEP_LAUNCH(1);
    SWEEP_LAUNCH(2);
    SWEEP_LAUNCH(3);
    SWEEP_LAUNCH(4);
    SWEEP_LAUNCH(5);
    SWEEP_LAUNCH(6);
    default:
      return -2;
  }
#undef SWEEP_LAUNCH
}

}  // namespace

// Queries per block: the wrapper computes one window per this many
// consecutive sorted queries.
extern "C" int sweep_knn_block_queries() { return PAIR_THREADS * SWEEP_Q; }

// q      f32[n, dim]   queries in sweep (ascending-x) order, row-major
// qmask  u8[n]         1 = valid query
// ref4   f32[m, 4]     x-sorted references: x, y, z (0 at dim 2), bits of
//                      the original index
// start, end  i32[n_blocks]  reference window of each block of
//                      sweep_knn_block_queries() consecutive queries
//                      (end <= number of valid refs)
// chunks 1, 2, 4 or 8: blocks per window (a cluster); chunk: references per
//                      block, a multiple of 16 with chunks * chunk >= the
//                      longest window
// out_d  f32[n, k], out_i i64[n, k]  (original reference indices)
// Returns 0, a cudaError_t from the launch, or -1/-2/-3 for an unsupported
// dim / k / chunking.  Launches on `stream`, does not synchronise,
// allocates nothing.
extern "C" int sweep_knn_launch(const void* q, const void* qmask,
                                const void* ref4, const void* start,
                                const void* end, float r2, int n,
                                int n_blocks, int chunks, int chunk, int dim,
                                int k, void* out_d, void* out_i,
                                void* stream) {
  if (n_blocks <= 0) return 0;
  if ((chunks != 1 && chunks != 2 && chunks != 4 && chunks != 8) ||
      chunk <= 0 || chunk % PAIR_GROUP != 0)
    return -3;
  const float* qf = (const float*)q;
  const uint8_t* qm = (const uint8_t*)qmask;
  const float4* rf = (const float4*)ref4;
  const int* st = (const int*)start;
  const int* en = (const int*)end;
  float* od = (float*)out_d;
  long long* oi = (long long*)out_i;
  cudaStream_t s = (cudaStream_t)stream;
  if (dim == 3)
    return dispatch_k<3>(k, qf, qm, rf, st, en, r2, n, n_blocks, chunks,
                         chunk, od, oi, s);
  if (dim == 2)
    return dispatch_k<2>(k, qf, qm, rf, st, en, r2, n, n_blocks, chunks,
                         chunk, od, oi, s);
  return -1;
}
