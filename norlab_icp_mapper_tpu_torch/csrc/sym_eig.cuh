// Closed-form eigensolve of one symmetric 3x3 or 2x2 matrix in registers:
// eigenvalues ascending and the unit eigenvector of the smallest one.
//
// Formula for formula what ops/eigen.py computes in tensor operations (its
// plain version): 3x3 by the trace shift and the trigonometric (Cardano)
// roots, the eigenvector as the largest column of (A - l1 I)(A - l2 I), the
// first of equal columns as argmax picks it, +z for an isotropic matrix;
// 2x2 by the angle form.  Used as the epilogue of radius_pca.cu and as the
// body of sym_eig.cu.  acosf / cosf / sinf / atan2f are the accurate library
// forms (no fast-math); they differ from PyTorch's by ulps, and nvcc may
// contract a product and a sum into an FMA, so results agree with the plain
// version to rounding, not bit for bit.
#pragma once

#include <cuda_runtime.h>

// A is read in full (row-major), as the plain version reads it.
__device__ __forceinline__ void sym_eig3_smallest_dev(const float (&A)[3][3],
                                                      float (&ev)[3],
                                                      float (&v)[3]) {
  const float q = (A[0][0] + A[1][1] + A[2][2]) / 3.0f;
  float B[3][3];
  float p2 = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      B[i][j] = A[i][j] - (i == j ? q : 0.0f);
      p2 += B[i][j] * B[i][j];
    }
  }
  p2 = p2 / 6.0f;
  const float p = sqrtf(fmaxf(p2, 1e-30f));
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) B[i][j] = B[i][j] / p;
  }
  const float det = B[0][0] * (B[1][1] * B[2][2] - B[1][2] * B[2][1]) -
                    B[0][1] * (B[1][0] * B[2][2] - B[1][2] * B[2][0]) +
                    B[0][2] * (B[1][0] * B[2][1] - B[1][1] * B[2][0]);
  const float r = fminf(fmaxf(det / 2.0f, -1.0f), 1.0f);
  const float phi = acosf(r) / 3.0f;
  const float l2 = q + 2.0f * p * cosf(phi);                        // largest
  const float l0 = q + 2.0f * p * cosf(phi + 2.0943951023931953f);  // smallest
  const float l1 = 3.0f * q - l0 - l2;
  ev[0] = l0;
  ev[1] = l1;
  ev[2] = l2;

  // C = (A - l1 I)(A - l2 I): its columns span the eigenspace of l0
  float C[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int t = 0; t < 3; ++t)
        s += (A[i][t] - (i == t ? l1 : 0.0f)) * (A[t][j] - (t == j ? l2 : 0.0f));
      C[i][j] = s;
    }
  }
  float n2[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    n2[j] = C[0][j] * C[0][j] + C[1][j] * C[1][j] + C[2][j] * C[2][j];
  // first maximum on ties
  int best = 0;
  if (n2[1] > n2[best]) best = 1;
  if (n2[2] > n2[best]) best = 2;
  float c0 = C[0][0], c1 = C[1][0], c2 = C[2][0];
  if (best == 1) {
    c0 = C[0][1];
    c1 = C[1][1];
    c2 = C[2][1];
  } else if (best == 2) {
    c0 = C[0][2];
    c1 = C[1][2];
    c2 = C[2][2];
  }
  const float vn = sqrtf(c0 * c0 + c1 * c1 + c2 * c2);
  const bool degenerate = (vn < 1e-12f) || (p < 1e-12f);
  const float den = fmaxf(vn, 1e-30f);
  v[0] = degenerate ? 0.0f : c0 / den;
  v[1] = degenerate ? 0.0f : c1 / den;
  v[2] = degenerate ? 1.0f : c2 / den;
}

__device__ __forceinline__ void sym_eig2_smallest_dev(const float (&A)[2][2],
                                                      float (&ev)[2],
                                                      float (&v)[2]) {
  const float a = A[0][0];
  const float b = A[0][1];
  const float c = A[1][1];
  const float tr = a + c;
  const float d = sqrtf(fmaxf((a - c) * (a - c) + 4.0f * b * b, 0.0f));
  ev[0] = (tr - d) / 2.0f;
  ev[1] = (tr + d) / 2.0f;
  // principal (largest) direction; the normal is perpendicular to it
  const float theta = 0.5f * atan2f(2.0f * b, a - c);
  v[0] = -sinf(theta);
  v[1] = cosf(theta);
}

template <int D>
__device__ __forceinline__ void sym_eig_smallest_dev(const float (&A)[D][D],
                                                     float (&ev)[D],
                                                     float (&v)[D]) {
  if constexpr (D == 3)
    sym_eig3_smallest_dev(A, ev, v);
  else
    sym_eig2_smallest_dev(A, ev, v);
}
