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
// Bound on this card: operations, and among them instruction dispatch.  A pair
// costs 3 subtractions, 3 products and 2 sums, each its own instruction (the
// distance is subtract-first and unfused so that it is bit-identical to the
// plain version), plus its ranking; bytes (queries, references and 12 k
// output bytes per query, each once) are far below that.  What the design
// does about it (the pair loop itself is described in sweep_common.cuh):
//   * References come packed as float4 (x, y, z, bits of the original index)
//     with the valid ones in front and their count in device memory: one
//     128-bit shared-memory load per reference, no gather of indices at the
//     end, never an invalid reference in the loop.
//   * A thread keeps Q queries and their lists in registers (Q = 4 at k = 1,
//     fewer for longer lists) and uses every loaded reference Q times.
//   * Only valid queries get a thread: the kernel takes the query rows with
//     the valid ones in front (a list, or the reference pack itself when a
//     cloud is searched against itself) and their count in device memory;
//     thread t serves the t-th of them and writes to that query's own row.
//     The rows behind the count are filled with +inf / -1, except with
//     `list_only`, where the list holds only the rows to search (the grid
//     search's fallback, knn_grid.cu) and no other row is touched.
//   * With Q queries per thread there are few threads, so the references are
//     cut into S contiguous ascending ranges and a thread-block cluster of S
//     blocks shares one query tile: block s searches range s, leaves its
//     partial lists in its shared memory, and block 0 merges them through
//     distributed shared memory.  Ranges ascend and the merge inserts with
//     strict `<` in range order, so the tie rule (lower index first) holds
//     across range borders.  S is a host-side integer chosen by the wrapper.
//   * Tiles of KNN_TILE references arrive by cp.async in a two-deep ring.
//   * At k > 1 a cloud searched against itself first searches the one tile
//     that holds the block's own points; the k-th distance found there gates
//     the search proper (see the kernel), which cuts the insertions that
//     scan order causes by an order of magnitude.
//   * Lists live in registers in template buckets K (1, 4, 8, 12, 16, 32);
//     the first k entries are written.  Nothing is indexed by a runtime
//     value, so nothing goes to local memory.
// Tensor cores are not used; sweep_common.cuh says why.
//
// Not carried over from the TPU kernel: the planar [8, N] layout, the 1e9
// sentinel coordinates, the ranking by the shifted distance |r|^2 - 2 q.r
// from a matrix product, and the k rounds of min-extraction over a
// concatenated block.
#include "sweep_common.cuh"

namespace cg = cooperative_groups;

#define KNN_TILE 1024  // references per stage of the ring (16 KB)

namespace {

// Queries per thread for a list bucket (timed on the card: more queries per
// thread at k = 1 or fewer anywhere change the times by less than their
// spread).
template <int K>
struct QueriesPerThread {
  static constexpr int value = K == 1 ? 4 : (K <= 12 ? 2 : 1);
};

template <int D, int K, int Q>
__global__ void __launch_bounds__(PAIR_THREADS)
knn_brute_kernel(const float* __restrict__ q, int q_stride, int q_dim,
                 const int* __restrict__ qlist, int rows_in_lane3,
                 const long long* __restrict__ n_q_ptr,
                 const float4* __restrict__ ref4,
                 const long long* __restrict__ n_ref_ptr, int n, int k,
                 int list_only, float* __restrict__ out_d,
                 long long* __restrict__ out_i) {
  constexpr int SLOTS = PAIR_THREADS * Q;  // queries per block
  constexpr int RING_BYTES = PAIR_STAGES * KNN_TILE * 16;
  constexpr int LIST_BYTES = K * SLOTS * 8;
  // the ring of staged tiles; after the search the same bytes hold the
  // block's partial lists for the merge
  __shared__ __align__(16) unsigned char
      smem[LIST_BYTES > RING_BYTES ? LIST_BYTES : RING_BYTES];

  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tile_q = blockIdx.x / S;
  const int tid = threadIdx.x;

  const long long nq_ll = n_q_ptr != nullptr ? *n_q_ptr : (long long)n;
  const int n_q = (int)(nq_ll < (long long)n ? nq_ll : (long long)n);

  // this thread's queries: slot = position among the valid-first rows
  int row[Q];
  bool valid[Q];
  float qv[Q][D];
#pragma unroll
  for (int a = 0; a < Q; ++a) {
    const int slot = tile_q * SLOTS + a * PAIR_THREADS + tid;
    valid[a] = slot < n_q;
    row[a] = -1;
    if (slot < n) {
      if (rows_in_lane3)
        row[a] = __float_as_int(q[(size_t)slot * q_stride + 3]);
      else
        row[a] = qlist != nullptr ? qlist[slot] : slot;
    }
    const int src = rows_in_lane3 ? slot : row[a];
#pragma unroll
    for (int c = 0; c < D; ++c)
      qv[a][c] =
          (valid[a] && c < q_dim) ? q[(size_t)src * q_stride + c] : 0.0f;
  }

  // a tile without a valid query: every block of its cluster takes this
  // branch, block 0 fills the rows
  if (tile_q * SLOTS >= n_q) {
    if (rank == 0 && !list_only) {
#pragma unroll
      for (int a = 0; a < Q; ++a) {
        if (row[a] >= 0) {
          for (int t = 0; t < k; ++t) {
            out_d[(size_t)row[a] * k + t] = PAIR_INF;
            out_i[(size_t)row[a] * k + t] = -1;
          }
        }
      }
    }
    return;
  }

  float bd[Q][K];
  int bi[Q][K];  // K == 1: packed position of the group that holds the best
#pragma unroll
  for (int a = 0; a < Q; ++a) {
#pragma unroll
    for (int t = 0; t < K; ++t) {
      bd[a][t] = PAIR_INF;
      bi[a][t] = -1;
    }
  }

  // this block's range of the packed references (a range beyond the count
  // is empty)
  const int m = (int)(*n_ref_ptr);
  int per = (m + S - 1) / S;
  per = (per + PAIR_GROUP - 1) & ~(PAIR_GROUP - 1);
  const int r0 = min(m, rank * per);
  const int r1 = min(m, r0 + per);
  float gate[Q];
#pragma unroll
  for (int a = 0; a < Q; ++a) gate[a] = PAIR_INF;
  float4* ring = reinterpret_cast<float4*>(smem);
  if constexpr (K > 1) {
    // The points of a cloud lie in scan order, so a query's neighbours in
    // space are mostly its neighbours in the array, and every approach of
    // the scan towards the query refills its list (1,244 insertions per
    // query were counted at k = 10 on a 101k-point map, 13 times what a
    // random order gives).  A cloud searched against itself therefore first
    // searches the one tile that holds the block's own points: the k-th
    // distance found there bounds the final one, and with it as a gate the
    // search proper (ascending as ever, from empty lists, so the tie rule is
    // untouched) inserts only what lies inside that ball.
    if (rows_in_lane3) {
      const int o0 = (tile_q * SLOTS) / KNN_TILE * KNN_TILE;
      pair_search_range<D, K, Q, KNN_TILE>(ring, ref4, o0,
                                           min(m, o0 + KNN_TILE), gate, qv,
                                           bd, bi);
#pragma unroll
      for (int a = 0; a < Q; ++a) {
        gate[a] = bd[a][K - 1];
#pragma unroll
        for (int t = 0; t < K; ++t) {
          bd[a][t] = PAIR_INF;
          bi[a][t] = -1;
        }
      }
    }
  }
  pair_search_range<D, K, Q, KNN_TILE>(ring, ref4, r0, r1, gate, qv, bd, bi);

  if (S > 1) {
    pair_merge_cluster<K, Q>(cluster, smem, bd, bi);
    if (rank != 0) return;
  }

#pragma unroll
  for (int a = 0; a < Q; ++a) {
    if (row[a] < 0 || (list_only && !valid[a])) continue;
    if constexpr (K == 1) {
      int id = -1;
      if (valid[a]) id = pair_first_at<D>(ref4, bi[a][0], m, qv[a], bd[a][0]);
      out_d[row[a]] = valid[a] ? bd[a][0] : PAIR_INF;
      out_i[row[a]] = id;
    } else {
#pragma unroll
      for (int t = 0; t < K; ++t) {
        if (t < k) {
          out_d[(size_t)row[a] * k + t] = valid[a] ? bd[a][t] : PAIR_INF;
          out_i[(size_t)row[a] * k + t] = valid[a] ? bi[a][t] : -1;
        }
      }
    }
  }
}

template <int D, int K>
int launch(const float* q, int q_stride, int q_dim, const int* qlist,
           int rows_in_lane3,
           const long long* n_q, const float4* ref4, const long long* n_ref,
           int n, int k, int splits, int list_only, float* out_d,
           long long* out_i, cudaStream_t stream) {
  constexpr int Q = QueriesPerThread<K>::value;
  const int tiles = (n + PAIR_THREADS * Q - 1) / (PAIR_THREADS * Q);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles * splits), 1, 1);
  cfg.blockDim = dim3(PAIR_THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err =
      cudaLaunchKernelEx(&cfg, knn_brute_kernel<D, K, Q>, q, q_stride, q_dim,
                         qlist, rows_in_lane3, n_q, ref4, n_ref, n, k,
                         list_only, out_d, out_i);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int D>
int dispatch_k(const float* q, int q_stride, int q_dim, const int* qlist,
               int rows_in_lane3, const long long* n_q, const float4* ref4,
               const long long* n_ref, int n, int k, int splits,
               int list_only, float* out_d, long long* out_i,
               cudaStream_t stream) {
#define KNN_LAUNCH(KK)                                                      \
  return launch<D, KK>(q, q_stride, q_dim, qlist, rows_in_lane3, n_q, ref4, \
                       n_ref, n, k, splits, list_only, out_d, out_i, stream)
  if (k < 1) return -2;
  if (k == 1) KNN_LAUNCH(1);
  if (k <= 4) KNN_LAUNCH(4);
  if (k <= 8) KNN_LAUNCH(8);
  if (k <= 12) KNN_LAUNCH(12);
  if (k <= 16) KNN_LAUNCH(16);
  if (k <= 32) KNN_LAUNCH(32);
#undef KNN_LAUNCH
  return -2;
}

}  // namespace

// q         f32, row i at q + i * q_stride: the queries' coordinates
// qlist     i32[n]   query rows with the valid ones in front, in their
//                    original order; NULL = row i is slot i
// rows_in_lane3      1: q is the reference pack itself (f32[n, 4]); slot i
//                    is its i-th row and that row's fourth lane is the
//                    query's row in the output (a cloud against itself)
// n_q       i64[1]   number of valid queries, on the device; NULL = n
// ref4      f32[m, 4] packed references: x, y, z (0 at dim 2), bits of the
//                    original index; the valid ones in front, order kept
// n_ref     i64[1]   number of valid references, on the device
// splits    1, 2, 4 or 8: blocks per cluster = ranges of the references
// list_only 1: qlist holds only the rows to search (n_q of them, read from
//                    the device); rows behind the count are not written
// out_d     f32[n, k], out_i i64[n, k]
// Returns 0, a cudaError_t from the launch, or -1/-2/-3 for an unsupported
// dim / k / splits.  Launches on `stream`, does not synchronise, allocates
// nothing.
extern "C" int knn_brute_launch(const void* q, int q_stride, const void* qlist,
                                int rows_in_lane3, const void* n_q,
                                const void* ref4, const void* n_ref, int n,
                                int dim, int k, int splits, int list_only,
                                void* out_d, void* out_i, void* stream) {
  if (n <= 0) return 0;
  if (splits != 1 && splits != 2 && splits != 4 && splits != 8) return -3;
  const float* qf = (const float*)q;
  const int* ql = (const int*)qlist;
  const long long* nq = (const long long*)n_q;
  const float4* rf = (const float4*)ref4;
  const long long* nr = (const long long*)n_ref;
  float* od = (float*)out_d;
  long long* oi = (long long*)out_i;
  cudaStream_t s = (cudaStream_t)stream;
  // a 2-D cloud runs through the 3-D kernel: its packed z and the
  // queries' z are 0, and adding +0 to the sum changes no bit of it
  if (dim == 3 || dim == 2)
    return dispatch_k<3>(qf, q_stride, rows_in_lane3 ? 3 : dim, ql,
                         rows_in_lane3, nq, rf, nr, n, k, splits, list_only,
                         od, oi, s);
  return -1;
}
