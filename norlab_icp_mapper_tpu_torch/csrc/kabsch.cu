// Weighted Kabsch for Hopper (sm_90a): the rigid increment of one
// point-to-point ICP step from the centred cross-covariance H and the two
// weighted means.
//
// It replaces no Pallas kernel: the JAX package takes jnp.linalg.svd of H
// inside its lax.while_loop (icp/engine.py:547-560, parallel/sharded_map.py:
// 790-806), which XLA computes.  torch.linalg.svd / det on a CUDA tensor make
// the host wait, so they cannot sit in the port's solve graph; this kernel
// computes the same rotation, R = argmax tr(R H) over proper rotations:
//   3-D  Horn's quaternion, the top eigenvector of the symmetric 4x4 N(H),
//        by SWEEPS cyclic Jacobi sweeps; R written from the unit quaternion
//        with its diagonal as 1 - 2(y^2 + z^2) (accurate near the identity);
//   2-D  cos/sin of atan2(H01 - H10, H00 + H11) as the normalised pair.
//   t = mu_q - R mu_p.
//
// Bound on this card: the launch.  One thread solves one problem in
// registers (~3k f32 operations, (D^2 + 2D) floats in, (D+1)^2 out); the
// solve asks for one problem per iteration.  Every operation is rounded on
// its own (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn / __fsqrt_rn, so
// nvcc contracts nothing into an FMA) and taken in the order of
// ops/kabsch.py::kabsch_plain, so kernel and plain version agree bit for bit.
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

template <int D>
__global__ void kabsch_kernel(const float* __restrict__ H,
                              const float* __restrict__ mu_p,
                              const float* __restrict__ mu_q, int n,
                              float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float h[D * D];
#pragma unroll
  for (int k = 0; k < D * D; ++k) h[k] = H[(size_t)i * D * D + k];
  float R[3][3];
  if constexpr (D == 3) {
    rotation_3d(h, R);
  } else {
    rotation_2d(h, R);
  }
  float* o = out + (size_t)i * (D + 1) * (D + 1);
#pragma unroll
  for (int r = 0; r < D; ++r) {
    float acc = mul(R[r][0], mu_p[(size_t)i * D]);
#pragma unroll
    for (int c = 1; c < D; ++c)
      acc = add(acc, mul(R[r][c], mu_p[(size_t)i * D + c]));
#pragma unroll
    for (int c = 0; c < D; ++c) o[r * (D + 1) + c] = R[r][c];
    o[r * (D + 1) + D] = sub(mu_q[(size_t)i * D + r], acc);
  }
#pragma unroll
  for (int c = 0; c < D; ++c) o[D * (D + 1) + c] = 0.f;
  o[D * (D + 1) + D] = 1.f;
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
                                            (const float*)mu_q, n,
                                            (float*)out);
  } else if (dim == 2) {
    kabsch_kernel<2><<<grid, block, 0, s>>>((const float*)H,
                                            (const float*)mu_p,
                                            (const float*)mu_q, n,
                                            (float*)out);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}
