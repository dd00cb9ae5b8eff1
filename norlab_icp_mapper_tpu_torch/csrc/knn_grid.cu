// Exact 1-NN of the ICP matcher without maxDist through a uniform cell grid,
// for Hopper (sm_90a).
//
// It replaces no Pallas kernel.  The JAX package searches the unbounded
// matcher by brute force (ops/nn_pallas.py `_kernel`, ported as
// knn_brute.cu), because the TPU had no tool better suited to it; the
// reference mapper asks a libnabo kd-tree.  On the card a query's nearest
// map point lies among the few hundred points of the cells around it, so
// this kernel visits those cells and stops as soon as no cell it has not
// visited can hold a point as near.  Its answer is the brute-force answer
// bit for bit: the same subtract-first f32 squared distance (pair_dist2 of
// sweep_common.cuh) and, among equal distances, the lowest original index.
//
// The grid (built by ops/nn_grid.py::build_grid_pack, once per change of
// the map): the finite valid references sorted by cell, row-major with x
// fastest, as f32[m, 4] (x, y, z, bits of the original index), and
// cell_start[c] the position of cell c's first reference; cell of a point
// p on axis a = clamp(floor(fl(fl(p_a - lo_a) * inv_h)), 0, dims_a - 1).
//
// The search of one query.  Its cell c; then Chebyshev shells s = 0, 1, ...
// around c: the cells with max_a |cell_a - c_a| = s.  A shell's cells are
// rows along x: a row whose y or z offset is s is the contiguous run
// x in [c_x - s, c_x + s], any other row only its two end cells; a run of
// cells along x is a run of the sorted references.  The running best is
// one 64-bit key, (bits of d2 << 32) | original index: d2 >= 0, so the
// order of the keys is the order of (d2, index), the tie rule of the
// brute-force search, and a minimum of keys needs no second pass.
//
// Stopping rule and its margin.  After shell s every unvisited reference r
// lies in a cell beyond the visited block on some axis a, on a side where
// the grid has cells (when no such side remains, every reference has been
// seen).  If its cell index is K >= c_a + s + 1 then, with h' = 1 / inv_h
// and u = 2^-24, fl(fl(r_a - lo_a) * inv_h) >= K gives
// r_a - lo_a >= K h' (1 - 2.0001 u): cells are monotone in the coordinate
// (f32 subtraction and a product by a positive constant are), and clamping
// keeps that.  Likewise K <= c_a - s - 1 gives r_a - lo_a < (c_a - s) h'
// (1 + 2.0001 u).  So |r_a - q_a| >= B, the distance from q to the nearest
// face of the visited block that has cells beyond it, computed here as
// fl(fl(K * h) - fl(q_a - lo_a)) (or the mirror), up to an error of at
// most 6u (E + |q - lo|) with E = the largest extent + 2h (the grid's
// `span`): K h <= E; h differs from h' by u; three roundings of terms no
// larger than E + |q - lo|.  The margin 2^-20 (span + max_a |q_a - lo_a|)
// = 16u (...) covers it; B' = fl(B - margin) is then a true lower bound on
// |r - q|.  The computed d2 of any pair is at least (1 - u)^5 times the
// true one (each of the differences, squares and two sums of non-negative
// terms rounds once), and fl(fl(B' B') (1 - 2^-20)) lies below
// B'^2 (1 - 5u) after its own two roundings.  So `best < that` (strict)
// proves that no unvisited reference reaches `best` or ties it; on
// equality the next shell is visited, since a tie with a lower index may
// wait there.  B' must be at least 1e-18, so that B'^2 is a normal f32 and
// the relative bounds hold.
//
// Exact fallback.  A query that has not stopped after GRID_SHELL_CAP shells
// (far from the map, beside an empty region), or whose coordinates are not
// finite, is appended to `fb_list` under the atomic count `fb_count`, and
// its row is not written: the wrapper then runs knn_brute.cu on the listed
// rows (list_only), against the whole pack in its original order.  A
// reference with a coordinate that is not finite is left out of the grid;
// the brute-force search never returns one either.
//
// Bound on this card: the gathers.  The arithmetic is a few dozen pairs a
// query; the bytes every implementation must move are the queries, their
// row list and the results (tens of microseconds at 3.35 TB/s for a scan),
// and the sorted map (~6 MB) and the cell table (4 MB at 2^20 cells) stay
// in the 50 MB L2 across passes.  What limits the kernel is how many of
// its dependent loads (a row's bounds, then the row's references) are in
// flight.  What the design does about it:
//   * GRID_LANES threads serve one query.  For a chunk of up to LANES rows
//     of a shell, lane j loads the bounds of row j (one latency for the chunk);
//     the chunk's ranges are then walked together, the lanes taking every
//     LANES-th reference of their concatenation, so that the lanes of a
//     query read consecutive 16-byte references (one cache line for eight)
//     and a 40,000-row scan keeps ~10,000 warps busy instead of ~1,300.
//   * The lanes join their keys by a butterfly of shuffles after each
//     shell, so every lane takes the same stopping decision.
//   * Valid queries only: the slots are the query rows with the valid ones
//     in front and their count on the device (as knn_brute.cu takes them);
//     a slot past the count writes +inf / -1 and leaves.
//   * The valid-query count and the fallbacks are added to `stats` (two
//     int64, the solve's counters) with one atomic per launch and one per
//     fallback.
#include "sweep_common.cuh"

#define GRID_THREADS 128  // threads per block
// Chosen on an H100 at the default cell's shape (PERF.md): 4, 8 and 16
// lanes and caps of 3 to 6 shells ran within their spread of one another;
// a cap of 2 sent 4-137 queries a pass to the fallback, ~1 ms each pass.
#define GRID_LANES 8      // threads per query
#define GRID_SHELL_CAP 4  // shells searched before the fallback

namespace {

// grid parameters as build_grid_pack packs them
struct Grid {
  float lo[3], h, inv_h, span;
  int dims[3];
};

__device__ __forceinline__ Grid load_grid(const float* __restrict__ gf,
                                          const int* __restrict__ gi) {
  Grid g;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    g.lo[a] = gf[a];
    g.dims[a] = gi[a];
  }
  g.h = gf[3];
  g.inv_h = gf[4];
  g.span = gf[5];
  return g;
}

constexpr unsigned long long KEY_NONE = (0x7f800000ull << 32) | 0xffffffffull;
constexpr float ONE_MINUS = 0.99999904632568359375f;  // 1 - 2^-20, exact
constexpr float MARGIN = 9.5367431640625e-07f;        // 2^-20, exact

// Row `r` of shell `s` around cell `c`: its (up to two) ranges of sorted
// references, [a0, b0) and [a1, b1), empty where the row leaves the grid.
__device__ __forceinline__ void shell_row(const int* __restrict__ cell_start,
                                          const Grid& g, const int (&c)[3],
                                          int s, int r, int& a0, int& b0,
                                          int& a1, int& b1) {
  a0 = b0 = a1 = b1 = 0;
  const int w = 2 * s + 1;
  if (r >= w * w) return;
  const int dz = r / w - s, dy = r % w - s;
  const int y = c[1] + dy, z = c[2] + dz;
  if (y < 0 || y >= g.dims[1] || z < 0 || z >= g.dims[2]) return;
  const int base = (z * g.dims[1] + y) * g.dims[0];
  const int nx = g.dims[0];
  if (dy == s || dy == -s || dz == s || dz == -s) {
    const int x0 = max(c[0] - s, 0), x1 = min(c[0] + s, nx - 1);
    a0 = cell_start[base + x0];
    b0 = cell_start[base + x1 + 1];
  } else {
    if (c[0] - s >= 0) {
      a0 = cell_start[base + c[0] - s];
      b0 = cell_start[base + c[0] - s + 1];
    }
    if (c[0] + s <= nx - 1) {
      a1 = cell_start[base + c[0] + s];
      b1 = cell_start[base + c[0] + s + 1];
    }
  }
}

// This lane's share of [a, b): the references whose place in the
// concatenation of the chunk's ranges is lane modulo LANES (`pos` is the
// place of a).
template <int LANES>
__device__ __forceinline__ void scan_range(const float4* __restrict__ ref4,
                                           int a, int b, int& pos, int lane,
                                           const float (&qv)[3],
                                           unsigned long long& key) {
  int i = a + ((lane - pos) & (LANES - 1));
  pos += b - a;
  for (; i < b; i += LANES) {
    const float4 r = ref4[i];
    const float d = pair_dist2<3>(qv, r);
    const unsigned long long k =
        ((unsigned long long)__float_as_uint(d) << 32) |
        (unsigned long long)(unsigned)__float_as_int(r.w);
    key = k < key ? k : key;
  }
}

template <int LANES, int SHELL_CAP>
__global__ void __launch_bounds__(GRID_THREADS)
knn_grid_kernel(const float* __restrict__ q, int q_dim,
                const int* __restrict__ qlist,
                const long long* __restrict__ n_q_ptr,
                const float4* __restrict__ ref4,
                const int* __restrict__ cell_start,
                const float* __restrict__ gf, const int* __restrict__ gi,
                int n, float* __restrict__ out_d,
                long long* __restrict__ out_i, int* __restrict__ fb_list,
                unsigned long long* __restrict__ fb_count,
                unsigned long long* __restrict__ stats) {
  static_assert(LANES >= 1 && LANES <= 32 && (LANES & (LANES - 1)) == 0,
                "LANES is a power of two up to a warp");
  const long long nq_ll = n_q_ptr != nullptr ? *n_q_ptr : (long long)n;
  const int n_q = (int)(nq_ll < (long long)n ? nq_ll : (long long)n);
  if (stats != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(&stats[0], (unsigned long long)n_q);

  const int t = blockIdx.x * GRID_THREADS + threadIdx.x;
  const int slot = t / LANES;  // the same for the lanes of a query
  const int lane = t & (LANES - 1);
  if (slot >= n) return;
  const int row = qlist != nullptr ? qlist[slot] : slot;
  if (slot >= n_q) {
    if (lane == 0) {
      out_d[row] = PAIR_INF;
      out_i[row] = -1;
    }
    return;
  }
  const unsigned group =
      (LANES == 32) ? 0xffffffffu
                    : (((1u << LANES) - 1u) << ((threadIdx.x & 31) & ~(LANES - 1)));

  float qv[3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    qv[a] = a < q_dim ? q[(size_t)row * q_dim + a] : 0.0f;
  bool resolved = false;
  unsigned long long key = KEY_NONE;
  if (isfinite(qv[0]) && isfinite(qv[1]) && isfinite(qv[2])) {
    const Grid g = load_grid(gf, gi);
    float rel[3];
    int c[3];
    float far = 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      rel[a] = __fsub_rn(qv[a], g.lo[a]);
      float cf = floorf(__fmul_rn(rel[a], g.inv_h));
      cf = fminf(fmaxf(cf, 0.0f), (float)(g.dims[a] - 1));
      c[a] = (int)cf;
      far = fmaxf(far, fabsf(rel[a]));
    }
    const float margin = __fmul_rn(__fadd_rn(g.span, far), MARGIN);
#pragma unroll 1
    for (int s = 0; s <= SHELL_CAP && !resolved; ++s) {
      const int w = 2 * s + 1;
      int pos = 0;
#pragma unroll 1
      for (int r0 = 0; r0 < w * w; r0 += LANES) {
        int a0, b0, a1, b1;
        shell_row(cell_start, g, c, s, r0 + lane, a0, b0, a1, b1);
        const int rows = min(LANES, w * w - r0);
#pragma unroll 1
        for (int j = 0; j < rows; ++j) {
          const int ra0 = __shfl_sync(group, a0, j, LANES);
          const int rb0 = __shfl_sync(group, b0, j, LANES);
          const int ra1 = __shfl_sync(group, a1, j, LANES);
          const int rb1 = __shfl_sync(group, b1, j, LANES);
          scan_range<LANES>(ref4, ra0, rb0, pos, lane, qv, key);
          scan_range<LANES>(ref4, ra1, rb1, pos, lane, qv, key);
        }
      }
#pragma unroll
      for (int off = LANES / 2; off > 0; off >>= 1) {
        const unsigned long long o = __shfl_xor_sync(group, key, off, LANES);
        key = o < key ? o : key;
      }
      // the lower bound on the distance to every unvisited reference
      bool covered = true;
      float bound = PAIR_INF;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        if (c[a] - s - 1 >= 0) {
          covered = false;
          bound = fminf(bound, __fsub_rn(rel[a],
                                         __fmul_rn((float)(c[a] - s), g.h)));
        }
        if (c[a] + s + 1 <= g.dims[a] - 1) {
          covered = false;
          bound = fminf(bound, __fsub_rn(__fmul_rn((float)(c[a] + s + 1), g.h),
                                         rel[a]));
        }
      }
      const float best = __uint_as_float((unsigned)(key >> 32));
      const float b = __fsub_rn(bound, margin);
      resolved = covered ||
                 (b >= 1e-18f &&
                  best < __fmul_rn(__fmul_rn(b, b), ONE_MINUS));
    }
  }
  if (lane != 0) return;
  if (!resolved) {
    const unsigned long long at = atomicAdd(fb_count, 1ull);
    fb_list[at] = row;
    if (stats != nullptr) atomicAdd(&stats[1], 1ull);
    return;
  }
  const float best = __uint_as_float((unsigned)(key >> 32));
  const bool found = best < PAIR_INF;
  out_d[row] = found ? best : PAIR_INF;
  out_i[row] = found ? (long long)(int)(unsigned)(key & 0xffffffffull) : -1;
}

template <int LANES, int SHELL_CAP>
int launch(const float* q, int q_dim, const int* qlist, const long long* n_q,
           const float4* ref4, const int* cell_start, const float* gf,
           const int* gi, int n, float* out_d, long long* out_i, int* fb_list,
           unsigned long long* fb_count, unsigned long long* stats,
           cudaStream_t stream) {
  const long long threads = (long long)n * LANES;
  const unsigned blocks = (unsigned)((threads + GRID_THREADS - 1) / GRID_THREADS);
  knn_grid_kernel<LANES, SHELL_CAP><<<blocks, GRID_THREADS, 0, stream>>>(
      q, q_dim, qlist, n_q, ref4, cell_start, gf, gi, n, out_d, out_i,
      fb_list, fb_count, stats);
  return (int)cudaGetLastError();
}

}  // namespace

// q          f32[n, q_dim]  the queries (q_dim 2 or 3; z = 0 at 2)
// qlist      i32[n]         query rows, the valid ones in front; NULL = row i
//                           is slot i
// n_q        i64[1]         number of valid queries, on the device; NULL = n
// ref4       f32[m, 4]      the grid's references sorted by cell
// cell_start i32[C + 1]     first sorted position of each cell
// gf         f32[8]         lo x, y, z, h, inv_h, span
// gi         i32[4]         dims x, y, z
// out_d      f32[n], out_i i64[n]: written for every row but the fallback's
// fb_list    i32[n], fb_count u64[1] (zero before the launch): the fallback
// stats      u64[2] or NULL: += valid queries, += fallbacks
// Returns 0, a cudaError_t from the launch, or -1 for an unsupported
// q_dim.  Launches on `stream`, does not synchronise, allocates nothing.
extern "C" int knn_grid_launch(const void* q, int q_dim, const void* qlist,
                               const void* n_q, const void* ref4,
                               const void* cell_start, const void* gf,
                               const void* gi, int n, void* out_d,
                               void* out_i, void* fb_list, void* fb_count,
                               void* stats, void* stream) {
  if (n <= 0) return 0;
  if (q_dim != 2 && q_dim != 3) return -1;
  return launch<GRID_LANES, GRID_SHELL_CAP>(
      (const float*)q, q_dim, (const int*)qlist, (const long long*)n_q,
      (const float4*)ref4, (const int*)cell_start, (const float*)gf,
      (const int*)gi, n, (float*)out_d, (long long*)out_i, (int*)fb_list,
      (unsigned long long*)fb_count, (unsigned long long*)stats,
      (cudaStream_t)stream);
}
