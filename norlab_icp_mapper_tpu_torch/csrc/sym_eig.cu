// Batched closed-form eigensolve of symmetric 3x3 / 2x2 matrices, for Hopper
// (sm_90a): eigenvalues ascending and the eigenvector of the smallest.
//
// It replaces no Pallas kernel: in the JAX package the closed forms of
// ops/eigen.py are tensor operations that XLA fuses under jit.  Eager PyTorch
// runs each of those ~60 operations as a launch of its own over the whole
// batch, so the port gives them one kernel: sym_eig.cuh, the epilogue of
// radius_pca.cu, with one thread per matrix.
//
// Bound on this card: bytes (D*D floats read, 2 D floats written per matrix,
// against some 150 operations).  One thread reads its matrix, solves in
// registers and writes; nothing is staged.
#include "sym_eig.cuh"

namespace {

template <int D>
__global__ void sym_eig_kernel(const float* __restrict__ cov, int n,
                               float* __restrict__ evals,
                               float* __restrict__ normal) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float A[D][D];
#pragma unroll
  for (int a = 0; a < D; ++a) {
#pragma unroll
    for (int b = 0; b < D; ++b) A[a][b] = cov[(size_t)i * D * D + a * D + b];
  }
  float ev[D];
  float v[D];
  sym_eig_smallest_dev<D>(A, ev, v);
#pragma unroll
  for (int a = 0; a < D; ++a) {
    evals[(size_t)i * D + a] = ev[a];
    normal[(size_t)i * D + a] = v[a];
  }
}

}  // namespace

// cov     f32[n, dim, dim]  row-major, symmetric
// evals   f32[n, dim]       ascending
// normal  f32[n, dim]       unit eigenvector of evals[:, 0]
// Returns 0, a cudaError_t from the launch, or -1 for an unsupported dim.
// Launches on `stream`, does not synchronise, allocates nothing.
extern "C" int sym_eig_smallest_launch(const void* cov, int n, int dim,
                                       void* evals, void* normal,
                                       void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int block = 128;
  const int grid = (n + block - 1) / block;
  if (dim == 3) {
    sym_eig_kernel<3><<<grid, block, 0, s>>>((const float*)cov, n,
                                             (float*)evals, (float*)normal);
  } else if (dim == 2) {
    sym_eig_kernel<2><<<grid, block, 0, s>>>((const float*)cov, n,
                                             (float*)evals, (float*)normal);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}
