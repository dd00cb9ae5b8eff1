// Radius-neighbourhood PCA in one launch, from x-sorted points to normals, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_pca_fused_kernel` of the JAX package's
// ops/pca.py, and on this card also what XLA fused around it under jit: the
// window search, the un-sort, the covariance from the moments and the
// closed-form eigensolve.  For every valid query: over all references within
// radius r in its tile's window of the x-sorted references, the count, the
// mean, the covariance, its eigenvalues ascending and the unit eigenvector of
// the smallest (the surface normal), written to the query's ORIGINAL row.
//
// Bound on this card: operations, and among them instruction dispatch: 8
// unfused arithmetic steps and a compare per pair (sweep_common.cuh), plus 13
// for a pair inside the radius.  The outputs are 4 (1 + 3 D + D D) bytes per
// query and the window of a block is read once.  Two things stood between
// the first form of this kernel and that bound.  The kernel was a twelfth of
// the phase it served: eager PyTorch spent the rest in some 180 small
// launches around it.  And a map's 81 k valid queries are only 2.4 warps per
// scheduler at two queries a thread: the loop waits on its own latencies
// (4 % of the pairs pass the gate, each lane at other references, so a warp
// walks most accumulation bodies with one or two lanes).  The design:
//   * One launch from sorted points to normals; see the epilogue below.
//   * The pair loop of sweep_common.cuh: references packed as float4
//     (centred x, y, z, bits of the original index), cp.async staging in a
//     two-deep ring, the distance gate bit for bit the plain version's.
//   * PCA_S lanes per query: the PCA_S neighbours of a warp hold the same
//     query, each takes every PCA_S-th reference of the tile, and their
//     partial sums meet by warp shuffles.  Sums can be split where sorted
//     lists could not, and it gives the schedulers PCA_S times the warps.
//   * Per-query centred moments: the sums are of d = r - q, which the
//     distance test already holds, so cov = S(d d^T)/n - (S d/n)(S d/n)^T
//     cancels at |d| <= r instead of at the cloud's extent.
//   * Queries come packed like the references (valid first, sorted by x, the
//     original row in the fourth lane; for a cloud against itself the
//     reference pack is the query pack): threads exist for valid queries
//     only and write straight to the original row, so nothing is padded,
//     gathered or un-sorted around the launch.
//   * A block finds its own window: four binary searches over the packed x
//     give the tile's range [lo, min(hi, lo + W)) and the part of it the
//     block's own queries can reach; the first block of a tile counts the
//     tile in `overflow` when hi - lo > W.  Same windows and same count as
//     the wrapper's sweep_windows, which the plain version uses.
//   * The epilogue stays in registers: mean, covariance, sym_eig.cuh, and
//     the filter's rule for neighbourhoods of fewer than `min_cnt` points.
// Not carried over from the TPU kernel: the 0/1 gate matrix and its M @ W
// product (rows padded to 16 for the matrix unit), the planar [8, N] layout,
// the 1e9 sentinels, the block-aligned window superset.  Tensor cores are not
// used: 4 % of the pairs pass the gate, so the dense product would do 26
// times the multiply-adds of the sparse sum, and it can only sum
// reference-only rows, which is the cancelling form.
#include "sweep_common.cuh"
#include "sym_eig.cuh"

#define PCA_TILE 512  // references per stage of the ring (8 KB)
#define PCA_S 4       // lanes per query
#define PCA_BLOCK_QUERIES (PAIR_THREADS / PCA_S)

namespace {

template <int D>
__global__ void __launch_bounds__(PAIR_THREADS)
radius_pca_kernel(const float4* __restrict__ qpack, int n_qrows,
                  const long long* __restrict__ n_q_ptr,
                  const float4* __restrict__ ref4,
                  const long long* __restrict__ n_ref_ptr,
                  const float* __restrict__ center, float r, float r2,
                  int q_tile, int W, float min_cnt, int n_rows,
                  float* __restrict__ out_cnt, float* __restrict__ out_mean,
                  float* __restrict__ out_cov, float* __restrict__ out_evals,
                  float* __restrict__ out_normal, int* __restrict__ overflow) {
  constexpr int B = PCA_BLOCK_QUERIES;
  constexpr int NM = 1 + D + D * (D + 1) / 2;
  __shared__ __align__(16) float4 ring[PAIR_STAGES * PCA_TILE];
  __shared__ int bound[4];

  const int tid = threadIdx.x;
  const long long nq_ll = *n_q_ptr;
  const int n_q = (int)(nq_ll < (long long)n_qrows ? nq_ll : (long long)n_qrows);
  const int s0 = blockIdx.x * B;  // the block's first sorted query
  if (s0 >= n_q) return;          // valid queries come first
  const int m = (int)(*n_ref_ptr);

  // the windows: threads 0 / 1 the tile's [x_first - r, x_last + r) by the
  // left bound, threads 2 / 3 the block's, closed on the right
  if (tid < 4) {
    const bool of_tile = tid < 2;
    const int first = of_tile ? (s0 / q_tile) * q_tile : s0;
    const int last = min(first + (of_tile ? q_tile : B), n_q) - 1;
    const bool upper = (tid & 1) != 0;
    const float x = qpack[upper ? last : first].x;
    const float v = upper ? __fadd_rn(x, r) : __fsub_rn(x, r);
    bound[tid] = pair_bound_x(ref4, m, v, tid == 3);
  }
  __syncthreads();
  const int lo = bound[0];
  const int hi = bound[1];
  if (tid == 0 && s0 % q_tile == 0 && hi - lo > W) atomicAdd(overflow, 1);
  const int t_end = min(hi, lo + W);
  const int w0 = max(bound[2], lo);
  const int w1 = max(min(bound[3], t_end), w0);

  // PCA_S neighbouring lanes share a query
  const int slot = s0 + tid / PCA_S;
  const int sub = tid % PCA_S;
  const bool valid = slot < n_q;
  // a spare lane's query lies at x = +inf: no pair passes its gate
  const float4 p =
      valid ? qpack[slot] : make_float4(PAIR_INF, 0.0f, 0.0f, 0.0f);
  const int row = __float_as_int(p.w);
  float qv[1][D];
  qv[0][0] = p.x;
  qv[0][1] = p.y;
  if (D == 3) qv[0][D - 1] = p.z;
  float acc[1][NM];
#pragma unroll
  for (int t = 0; t < NM; ++t) acc[0][t] = 0.0f;

  pair_moments_range<D, 1, PCA_S, PCA_TILE>(ring, ref4, w0, w1, sub, r2, qv,
                                            acc);
#pragma unroll
  for (int t = 0; t < NM; ++t) {
#pragma unroll
    for (int o = 1; o < PCA_S; o <<= 1)
      acc[0][t] += __shfl_xor_sync(0xffffffffu, acc[0][t], o);
  }
  if (sub != 0 || !valid || row < 0 || row >= n_rows) return;

  const float cnt = acc[0][0];
  const float safe = fmaxf(cnt, 1.0f);
  float s[D];
  float A[D][D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    s[c] = acc[0][1 + c] / safe;
    A[c][c] = acc[0][1 + D + c] / safe - s[c] * s[c];
  }
  int t = 1 + 2 * D;
#pragma unroll
  for (int c = 0; c < D; ++c) {
#pragma unroll
    for (int e = c + 1; e < D; ++e) {
      A[c][e] = acc[0][t] / safe - s[c] * s[e];
      A[e][c] = A[c][e];
      ++t;
    }
  }
  float ev[D];
  float v[D];
  sym_eig_smallest_dev<D>(A, ev, v);
  // fewer neighbours than the filter asks for: a unit normal along the last
  // axis instead of the direction of a rank-deficient covariance
  const bool few = cnt < min_cnt;
  const size_t o = (size_t)row;
  out_cnt[o] = cnt;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    // back in the caller's frame; zero where nothing was in range
    out_mean[o * D + c] =
        cnt > 0.0f ? __fadd_rn(__fadd_rn(qv[0][c], s[c]), center[c]) : 0.0f;
    out_evals[o * D + c] = ev[c];
    out_normal[o * D + c] = few ? (c == D - 1 ? 1.0f : 0.0f) : v[c];
#pragma unroll
    for (int e = 0; e < D; ++e) out_cov[(o * D + c) * D + e] = A[c][e];
  }
}

}  // namespace

// Queries per block: q_tile must be a multiple of it.
extern "C" int radius_pca_block_queries() { return PCA_BLOCK_QUERIES; }

// qpack   f32[n_qrows, 4]  queries: centred x, y, z (0 at dim 2), bits of the
//                          original row; the valid ones first, ascending x
// n_q     i64[1]           number of valid queries, on the device
// ref4    f32[m, 4]        references, packed and sorted the same way (the
//                          same array as qpack for a cloud against itself)
// n_ref   i64[1]           number of valid references, on the device
// center  f32[dim]         what was subtracted from both clouds (added back
//                          to the mean)
// r, r2                    the radius and its square, both rounded to f32
// q_tile, W                sorted queries per tile and the cap on a tile's
//                          window (a tile with more candidates counts in
//                          `overflow` and sees the first W)
// min_cnt                  neighbourhoods of fewer points get a unit normal
//                          along the last axis
// cnt f32[n_rows], mean f32[n_rows, dim], cov f32[n_rows, dim, dim],
// evals f32[n_rows, dim], normal f32[n_rows, dim]: written at the original
//                          row of every valid query; other rows untouched
// overflow i32[1]          incremented once per overflowing tile
// Returns 0, a cudaError_t from the launch, -1 for an unsupported dim, -2
// where q_tile is not a multiple of the block's queries.  Launches on
// `stream`, does not synchronise, allocates nothing.
extern "C" int radius_pca_launch(const void* qpack, int n_qrows,
                                 const void* n_q, const void* ref4,
                                 const void* n_ref, const void* center,
                                 float r, float r2, int q_tile, int W,
                                 int min_cnt, int n_rows, int dim, void* cnt,
                                 void* mean, void* cov, void* evals,
                                 void* normal, void* overflow, void* stream) {
  if (n_qrows <= 0) return 0;
  if (dim != 2 && dim != 3) return -1;
  if (q_tile <= 0 || q_tile % PCA_BLOCK_QUERIES != 0) return -2;
  const int grid = (n_qrows + PCA_BLOCK_QUERIES - 1) / PCA_BLOCK_QUERIES;
  auto kernel = dim == 3 ? radius_pca_kernel<3> : radius_pca_kernel<2>;
  kernel<<<grid, PAIR_THREADS, 0, (cudaStream_t)stream>>>(
      (const float4*)qpack, n_qrows, (const long long*)n_q,
      (const float4*)ref4, (const long long*)n_ref, (const float*)center, r,
      r2, q_tile, W, (float)min_cnt, n_rows, (float*)cnt, (float*)mean,
      (float*)cov, (float*)evals, (float*)normal, (int*)overflow);
  return (int)cudaGetLastError();
}
