// Point-to-point ICP on Hopper (sm_90a): from the matched pairs to the rigid
// increment.  Two kernels:
//
//   p2p_step   the weighted pairs (p [N, D], q [N, k, D], w [N, k]) reduced
//              to one-pass moments in float64 -- sum w, sum w p, sum w q,
//              sum w p q^T, sum w |p - q|^2 -- and, in the same launch, the
//              increment and the rms from them.  Each block reduces its rows
//              (a grid-stride loop, then warp shuffles and the block's warps
//              in a fixed order) and writes its partial moments; the last
//              block to take a ticket sums the partials in block order,
//              resets the ticket (the kernel stays graph-replayable) and
//              solves.  No float atomics, so the sums are deterministic.
//              With the solve off it writes the moments only: the sharded
//              solve sums them over the ranks (all_reduce) in between.
//   kabsch     the solve alone, from the centred cross-covariance H and the
//              two weighted means, or from the moments (the sharded solve
//              after its all_reduce).
//
// Moments in float64: centred f32 sums cancel badly at the 60 m coordinates
// of a hall, and one pass over the pairs needs no grid sync.  From them, in
// float64: wsum = max(sum w, 1e-9), mu = sum / wsum, H = S_pq - S_p S_q^T /
// wsum, rms = sqrt(sum w |p - q|^2 / wsum); then, in float32, R = argmax
// tr(R H) over proper rotations:
//   3-D  Horn's quaternion, the top eigenvector of the symmetric 4x4 N(H),
//        by SWEEPS cyclic Jacobi sweeps; R written from the unit quaternion
//        with its diagonal as 1 - 2(y^2 + z^2) (accurate near the identity);
//   2-D  cos/sin of atan2(H01 - H10, H00 + H11) as the normalised pair.
//   t = mu_q - R mu_p.
//
// It replaces no Pallas kernel: the JAX package reduces the pairs and takes
// jnp.linalg.svd of H inside its lax.while_loop (icp/engine.py:547-560,
// parallel/sharded_map.py:790-806), which XLA computes.  torch.linalg.svd /
// det on a CUDA tensor make the host wait, so they cannot sit in the port's
// solve graph.
//
// Bound on this card: p2p_step reads (D + k(D + 1)) floats a row, once
// (1.4 MB for the 49,152-row reading at k = 1, 0.4 us at 3.35 TB/s), and
// does some 30k float64 operations per thousand rows; what it costs the
// solve is the launch and the last block's serial tail (the partials' sum,
// the Jacobi sweeps).  Every float operation is rounded on its own
// (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn / __fsqrt_rn and their
// __d*_rn twins, so nvcc contracts nothing into an FMA) and taken in the
// order of ops/kabsch.py's plain versions: each pair's terms and the solve
// agree bit for bit with them; the moments' sums differ only in their
// order.
#include <cuda_runtime.h>

namespace {

constexpr int SWEEPS = 5;  // ops/kabsch.py::SWEEPS

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float dvd(float a, float b) {
  return __fdiv_rn(a, b);
}

__device__ void rotation_2d(const float* H, float R[3][3]) {
  const float a = add(H[0], H[3]);
  const float b = sub(H[1], H[2]);
  const float r = __fsqrt_rn(add(mul(a, a), mul(b, b)));
  const bool flat = r == 0.f;
  const float c = flat ? 1.f : dvd(a, r);
  const float s = flat ? 0.f : dvd(b, r);
  R[0][0] = c;
  R[0][1] = -s;
  R[1][0] = s;
  R[1][1] = c;
}

__device__ void rotation_3d(const float* H, float R[3][3]) {
  const float xx = H[0], xy = H[1], xz = H[2];
  const float yx = H[3], yy = H[4], yz = H[5];
  const float zx = H[6], zy = H[7], zz = H[8];
  float N[4][4];
  N[0][0] = add(add(xx, yy), zz);
  N[0][1] = sub(yz, zy);
  N[0][2] = sub(zx, xz);
  N[0][3] = sub(xy, yx);
  N[1][1] = sub(sub(xx, yy), zz);
  N[1][2] = add(xy, yx);
  N[1][3] = add(zx, xz);
  N[2][2] = sub(sub(yy, xx), zz);
  N[2][3] = add(yz, zy);
  N[3][3] = sub(sub(zz, xx), yy);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < i; ++j) N[i][j] = N[j][i];
  }
  float V[4][4];  // V[col][row]
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int r = 0; r < 4; ++r) V[c][r] = (r == c) ? 1.f : 0.f;
  }
  const int P[6] = {0, 0, 0, 1, 1, 2};
  const int Q[6] = {1, 2, 3, 2, 3, 3};
#pragma unroll 1
  for (int sweep = 0; sweep < SWEEPS; ++sweep) {
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const int p = P[k], q = Q[k];
      const float apq = N[p][q], app = N[p][p], aqq = N[q][q];
      const float tau = dvd(sub(aqq, app), add(apq, apq));
      const float sgn = (tau >= 0.f) ? 1.f : -1.f;
      float t =
          dvd(sgn, add(fabsf(tau), __fsqrt_rn(add(1.f, mul(tau, tau)))));
      if (apq == 0.f) t = 0.f;
      const float c = dvd(1.f, __fsqrt_rn(add(1.f, mul(t, t))));
      const float s = mul(t, c);
      const float tapq = mul(t, apq);
      N[p][p] = sub(app, tapq);
      N[q][q] = add(aqq, tapq);
      N[p][q] = 0.f;
      N[q][p] = 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (r == p || r == q) continue;
        const float arp = N[r][p], arq = N[r][q];
        const float np_ = sub(mul(c, arp), mul(s, arq));
        const float nq_ = add(mul(s, arp), mul(c, arq));
        N[r][p] = np_;
        N[p][r] = np_;
        N[r][q] = nq_;
        N[q][r] = nq_;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float vrp = V[p][r], vrq = V[q][r];
        V[p][r] = sub(mul(c, vrp), mul(s, vrq));
        V[q][r] = add(mul(s, vrp), mul(c, vrq));
      }
    }
  }
  // the column of the largest eigenvalue (the first on ties)
  float best = N[0][0];
  float w[4] = {V[0][0], V[0][1], V[0][2], V[0][3]};
#pragma unroll
  for (int col = 1; col < 4; ++col) {
    if (N[col][col] > best) {
      best = N[col][col];
#pragma unroll
      for (int r = 0; r < 4; ++r) w[r] = V[col][r];
    }
  }
  const float nrm = __fsqrt_rn(
      add(add(add(mul(w[0], w[0]), mul(w[1], w[1])), mul(w[2], w[2])),
          mul(w[3], w[3])));
  const float qw = dvd(w[0], nrm), qx = dvd(w[1], nrm);
  const float qy = dvd(w[2], nrm), qz = dvd(w[3], nrm);
  const float xx2 = mul(qx, qx), yy2 = mul(qy, qy), zz2 = mul(qz, qz);
  const float xy2 = mul(qx, qy), xz2 = mul(qx, qz), yz2 = mul(qy, qz);
  const float wx = mul(qw, qx), wy = mul(qw, qy), wz = mul(qw, qz);
  R[0][0] = sub(1.f, mul(2.f, add(yy2, zz2)));
  R[0][1] = mul(2.f, sub(xy2, wz));
  R[0][2] = mul(2.f, add(xz2, wy));
  R[1][0] = mul(2.f, add(xy2, wz));
  R[1][1] = sub(1.f, mul(2.f, add(xx2, zz2)));
  R[1][2] = mul(2.f, sub(yz2, wx));
  R[2][0] = mul(2.f, sub(xz2, wy));
  R[2][1] = mul(2.f, add(yz2, wx));
  R[2][2] = sub(1.f, mul(2.f, add(xx2, yy2)));
}

// the increment [R t; 0 1] of one problem into o[(D+1)^2]
template <int D>
__device__ void solve_one(const float* h, const float* mu_p,
                          const float* mu_q, float* o) {
  float R[3][3];
  if constexpr (D == 3) {
    rotation_3d(h, R);
  } else {
    rotation_2d(h, R);
  }
#pragma unroll
  for (int r = 0; r < D; ++r) {
    float acc = mul(R[r][0], mu_p[0]);
#pragma unroll
    for (int c = 1; c < D; ++c) acc = add(acc, mul(R[r][c], mu_p[c]));
#pragma unroll
    for (int c = 0; c < D; ++c) o[r * (D + 1) + c] = R[r][c];
    o[r * (D + 1) + D] = sub(mu_q[r], acc);
  }
#pragma unroll
  for (int c = 0; c < D; ++c) o[D * (D + 1) + c] = 0.f;
  o[D * (D + 1) + D] = 1.f;
}

// number of moments: sum w, sum w p, sum w q, sum w p q^T, sum w |p - q|^2
template <int D>
__host__ __device__ constexpr int n_moments() {
  return 1 + 2 * D + D * D + 1;
}

// H, the means and the rms of the moments m, in float64, then rounded to
// float32 (ops/kabsch.py::_from_moments)
template <int D>
__device__ void from_moments(const double* m, float* h, float* mu_p,
                             float* mu_q, float* rms) {
  const double s = m[0];
  const double wsum = s < 1e-9 ? 1e-9 : s;  // NaN stays NaN, as clamp
#pragma unroll
  for (int i = 0; i < D; ++i) {
    mu_p[i] = __double2float_rn(__ddiv_rn(m[1 + i], wsum));
    mu_q[i] = __double2float_rn(__ddiv_rn(m[1 + D + i], wsum));
#pragma unroll
    for (int j = 0; j < D; ++j)
      h[i * D + j] = __double2float_rn(__dsub_rn(
          m[1 + 2 * D + i * D + j],
          __ddiv_rn(__dmul_rn(m[1 + i], m[1 + D + j]), wsum)));
  }
  *rms = __double2float_rn(
      __dsqrt_rn(__ddiv_rn(m[n_moments<D>() - 1], wsum)));
}

// one thread per problem: from (H, mu_p, mu_q), or from the moments
template <int D>
__global__ void kabsch_kernel(const float* __restrict__ H,
                              const float* __restrict__ mu_p,
                              const float* __restrict__ mu_q,
                              const double* __restrict__ moments, int n,
                              float* __restrict__ out,
                              float* __restrict__ rms) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float h[D * D], mp[D], mq[D];
  if (moments != nullptr) {
    from_moments<D>(moments + (size_t)i * n_moments<D>(), h, mp, mq,
                    rms + i);
  } else {
#pragma unroll
    for (int k = 0; k < D * D; ++k) h[k] = H[(size_t)i * D * D + k];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      mp[k] = mu_p[(size_t)i * D + k];
      mq[k] = mu_q[(size_t)i * D + k];
    }
  }
  solve_one<D>(h, mp, mq, out + (size_t)i * (D + 1) * (D + 1));
}

constexpr int P2P_THREADS = 256;
constexpr int P2P_MAX_BLOCKS = 132;  // one per SM of an H100 SXM

__device__ __forceinline__ double dmul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double dadd(double a, double b) {
  return __dadd_rn(a, b);
}

// A pair's terms, in the plain version's order, added to acc (the row's
// share of the moments).
template <int D>
__device__ __forceinline__ void add_pair(const float* p, const float* q,
                                         float wf, double* acc) {
  const double w = (double)wf;
  double wp[D], qd[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    wp[i] = dmul(w, (double)p[i]);
    qd[i] = (double)q[i];
  }
  acc[0] = dadd(acc[0], w);
#pragma unroll
  for (int i = 0; i < D; ++i) {
    acc[1 + i] = dadd(acc[1 + i], wp[i]);
    acc[1 + D + i] = dadd(acc[1 + D + i], dmul(w, qd[i]));
#pragma unroll
    for (int j = 0; j < D; ++j)
      acc[1 + 2 * D + i * D + j] =
          dadd(acc[1 + 2 * D + i * D + j], dmul(wp[i], qd[j]));
  }
  double e = 0.0;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    const double dx = __dsub_rn((double)p[i], qd[i]);
    e = i == 0 ? dmul(dx, dx) : dadd(e, dmul(dx, dx));
  }
  acc[n_moments<D>() - 1] = dadd(acc[n_moments<D>() - 1], dmul(w, e));
}

// The moments of the pairs (and, with `solve`, the increment and rms).
// partials: [gridDim.x, M] float64 scratch; ticket: one zeroed counter the
// kernel leaves zeroed; moments: [M] float64 out.
template <int D>
__global__ void __launch_bounds__(P2P_THREADS)
    p2p_step_kernel(const float* __restrict__ p, const float* __restrict__ q,
                    const float* __restrict__ w, int n, int k,
                    double* partials, unsigned int* ticket, double* moments,
                    int solve, float* __restrict__ dT,
                    float* __restrict__ rms) {
  constexpr int M = n_moments<D>();
  constexpr int WARPS = P2P_THREADS / 32;
  __shared__ double warp_sums[WARPS][M];
  __shared__ double total[M];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  double acc[M];
#pragma unroll
  for (int m = 0; m < M; ++m) acc[m] = 0.0;
  for (int row = blockIdx.x * P2P_THREADS + threadIdx.x; row < n;
       row += gridDim.x * P2P_THREADS) {
    const float* pr = p + (size_t)row * D;
    for (int j = 0; j < k; ++j)
      add_pair<D>(pr, q + ((size_t)row * k + j) * D, w[(size_t)row * k + j],
                  acc);
  }
  // the block's sum: a fixed shuffle tree in each warp, then the warps in
  // order
#pragma unroll
  for (int m = 0; m < M; ++m) {
    double v = acc[m];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = dadd(v, __shfl_down_sync(0xffffffffu, v, off));
    if (lane == 0) warp_sums[warp][m] = v;
  }
  __syncthreads();
  if (threadIdx.x < M) {
    double v = warp_sums[0][threadIdx.x];
    for (int i = 1; i < WARPS; ++i) v = dadd(v, warp_sums[i][threadIdx.x]);
    partials[(size_t)blockIdx.x * M + threadIdx.x] = v;
    __threadfence();  // the partial is visible before the ticket is taken
  }
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: moment m summed by warp m % WARPS, lane l over blocks
  // l, l + 32, ... in order, then the same shuffle tree
  for (int m = warp; m < M; m += WARPS) {
    double v = 0.0;
    for (int b = lane; b < (int)gridDim.x; b += 32)
      v = b == lane ? __ldcg(partials + (size_t)b * M + m)
                    : dadd(v, __ldcg(partials + (size_t)b * M + m));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = dadd(v, __shfl_down_sync(0xffffffffu, v, off));
    if (lane == 0) {
      total[m] = v;
      moments[m] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  *ticket = 0u;  // every other block has taken its ticket
  if (!solve) return;
  float h[D * D], mp[D], mq[D];
  from_moments<D>(total, h, mp, mq, rms);
  solve_one<D>(h, mp, mq, dT);
}

int p2p_grid(int n) {
  const int g = (n + P2P_THREADS - 1) / P2P_THREADS;
  return g < 1 ? 1 : (g > P2P_MAX_BLOCKS ? P2P_MAX_BLOCKS : g);
}

}  // namespace

// H     f32[n, dim, dim]  centred weighted cross-covariance sum w (p-mp)(q-mq)^T
// mu_p  f32[n, dim]       weighted mean of the moved reading points
// mu_q  f32[n, dim]       weighted mean of their matches
// out   f32[n, dim+1, dim+1]  the increment [R t; 0 1]
// Returns 0, a cudaError_t from the launch, or -1 for an unsupported dim.
// Launches on `stream`, does not synchronise, allocates nothing.
extern "C" int kabsch_launch(const void* H, const void* mu_p,
                             const void* mu_q, int n, int dim, void* out,
                             void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int block = 32;
  const int grid = (n + block - 1) / block;
  if (dim == 3) {
    kabsch_kernel<3><<<grid, block, 0, s>>>((const float*)H,
                                            (const float*)mu_p,
                                            (const float*)mu_q, nullptr, n,
                                            (float*)out, nullptr);
  } else if (dim == 2) {
    kabsch_kernel<2><<<grid, block, 0, s>>>((const float*)H,
                                            (const float*)mu_p,
                                            (const float*)mu_q, nullptr, n,
                                            (float*)out, nullptr);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}

// The solve from moments: m f64[n, 1 + 2 dim + dim^2 + 1] (as p2p_step
// writes them) -> out f32[n, dim+1, dim+1], rms f32[n].  Returns as above.
extern "C" int kabsch_moments_launch(const void* m, int n, int dim,
                                     void* out, void* rms, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int block = 32;
  const int grid = (n + block - 1) / block;
  if (dim == 3) {
    kabsch_kernel<3><<<grid, block, 0, s>>>(nullptr, nullptr, nullptr,
                                            (const double*)m, n, (float*)out,
                                            (float*)rms);
  } else if (dim == 2) {
    kabsch_kernel<2><<<grid, block, 0, s>>>(nullptr, nullptr, nullptr,
                                            (const double*)m, n, (float*)out,
                                            (float*)rms);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}

// The blocks p2p_step_launch uses for n rows (the rows of its partials).
extern "C" int p2p_step_blocks(int n) { return p2p_grid(n); }

// p f32[n, dim], q f32[n, k, dim], w f32[n, k]; partials f64[blocks, M]
// scratch (blocks = p2p_step_blocks(n)); ticket u32[1], zero before the
// launch and zero after it; moments f64[M] out; with `solve`, dT
// f32[dim+1, dim+1] and rms f32[1] out.  Returns as above.
extern "C" int p2p_step_launch(const void* p, const void* q, const void* w,
                               int n, int k, int dim, void* partials,
                               void* ticket, void* moments, int solve,
                               void* dT, void* rms, void* stream) {
  if (n < 0 || k < 1) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = p2p_grid(n);
  if (dim == 3) {
    p2p_step_kernel<3><<<grid, P2P_THREADS, 0, s>>>(
        (const float*)p, (const float*)q, (const float*)w, n, k,
        (double*)partials, (unsigned int*)ticket, (double*)moments, solve,
        (float*)dT, (float*)rms);
  } else if (dim == 2) {
    p2p_step_kernel<2><<<grid, P2P_THREADS, 0, s>>>(
        (const float*)p, (const float*)q, (const float*)w, n, k,
        (double*)partials, (unsigned int*)ticket, (double*)moments, solve,
        (float*)dT, (float*)rms);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}
