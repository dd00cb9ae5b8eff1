// The ICP loop on the card: a WHILE loop inside a CUDA graph, the counterpart
// of `jax.lax.while_loop`, and the kernel that commits one iteration of it.
//
// The ICP solve of the JAX package is one device program whose iteration
// loop is `lax.while_loop(cond, body, state)` (icp/engine.py::_icp_solve).
// On the card the same loop is a conditional WHILE node of a CUDA graph
// (CUDA 12.4 and later): the node's body graph runs as long as its condition
// handle holds 1, and the body's last kernel sets the handle from the loop
// state, so the host reads nothing between iterations.
//
// torch exposes conditional IF nodes only (CUDAGraph.begin_capture_to_if_node),
// so this file builds the WHILE node inside a capture that torch started:
//
//   graph_while_begin  (on torch's capturing stream)
//     cudaStreamGetCaptureInfo          -> the graph being captured
//     cudaGraphConditionalHandleCreate  -> the loop's condition handle
//     set_while_condition kernel        -> condition = !done && it < max_iter
//     cudaGraphAddNode (WHILE)          -> after everything captured so far
//     cudaStreamUpdateCaptureDependencies -> later work waits for the loop
//     cudaStreamBeginCaptureToGraph     -> the body stream now records into
//                                          the node's body graph
//   ... the caller runs the body on the body stream; its last iteration's
//       loop_commit sets the condition ...
//   graph_while_end    (on the body stream)
//     cudaStreamEndCapture
//
// loop_commit is one iteration's commit of the loop state (the end of the
// JAX body, icp/engine.py:599-621): T <- dT T, the step's translation norm
// and rotation angle rolled into the differential checker's window, the
// window means against the thresholds once `it + 1 >= smooth`, the bound
// checker on the new T, the identity minimizer's stop, and the masked writes
// `where(active, new, old)` with active = !done && it < max_iter, so that an
// iteration after the stop changes no bit; then it += active and, on the
// body's last iteration, the WHILE condition.  Eager, the same commit took
// about 35 launches of 0-d to 4x4 tensors.
//
// Bound on this card: the launch.  The state is under 200 bytes and the
// arithmetic a few hundred f32 operations; one warp does it (16 lanes the
// 4x4 product, lane 0 the rest).  Every operation is rounded as the plain
// version (ops/graph_loop.py::loop_commit_plain) rounds it on the card, in
// its order: the norms and the window means spelled out, each operation
// rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn /
// __fsqrt_rn: nvcc contracts nothing into an FMA); the 4x4 product with the
// fused multiply-adds of torch.matmul's (product_entry).  So kernel and
// plain version agree bit for bit; acosf / atan2f are CUDA's, as torch.acos
// / torch.atan2 on a CUDA tensor call them.
#include <cuda_runtime.h>

namespace {

__global__ void set_while_condition(cudaGraphConditionalHandle handle,
                                    const int* it, const unsigned char* done,
                                    int max_iter) {
  cudaGraphSetConditional(handle, (*done == 0 && *it < max_iter) ? 1u : 0u);
}

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

// Entry (i, j) of dT T, from row i of dT and column j of T (stride H), as
// torch.matmul computes it on the card for these shapes (cuBLAS, measured
// on every entry of 3,000 products each): for 4 x 4 the fused pairs
// fma(a1, b1, a0 b0) + fma(a3, b3, a2 b2), for 3 x 3 the fused chain
// fma(a2, b2, fma(a1, b1, a0 b0)).  So the solve's T stays the one that
// `dT @ T` gave (loop_commit_plain's product).
template <int H>
__device__ __forceinline__ float product_entry(const float* r, const float* c) {
  if constexpr (H == 4) {
    return add(__fmaf_rn(r[1], c[H], mul(r[0], c[0])),
               __fmaf_rn(r[3], c[3 * H], mul(r[2], c[2 * H])));
  } else {
    return __fmaf_rn(r[2], c[2 * H], __fmaf_rn(r[1], c[H], mul(r[0], c[0])));
  }
}

// |t| of the translation column of an H x H transform (row-major)
__device__ float trans_norm(const float* M, int H) {
  const int d = H - 1;
  float acc = mul(M[d], M[d]);
  for (int i = 1; i < d; ++i) acc = add(acc, mul(M[i * H + d], M[i * H + d]));
  return __fsqrt_rn(acc);
}

// the rotation angle of the transform's rotation block, as the JAX
// package's _rot_angle (icp/engine.py:388-393)
__device__ float rot_angle(const float* M, int H) {
  if (H == 3) return fabsf(atan2f(M[1 * H + 0], M[0]));
  const float tr = add(add(M[0], M[H + 1]), M[2 * H + 2]);
  float c = __fdiv_rn(sub(tr, 1.f), 2.f);
  c = c < -1.f ? -1.f : (c > 1.f ? 1.f : c);  // NaN stays NaN, as clamp
  return acosf(c);
}

struct Commit {
  const float* dT;             // [H, H] the iteration's increment
  float* T;                    // [H, H] state
  int* it;                     // state
  unsigned char* done;         // state (bool)
  float* hist;                 // [S, 2] state: rows of (|t|, angle)
  const float* overlap_new;    // 0-d
  float* overlap;              // state
  const float* rms_new;        // 0-d, or null: rms not written
  float* rms;                  // state, or null
  const long long* ovf_new;    // 0-d, or null: nothing added
  long long* ovf;              // state, or null
  int hist_rows, max_iter, identity;
  int diff_on, smooth_len;
  float min_t, min_r;
  int bound_on;
  float max_rot, max_trans;
  cudaGraphConditionalHandle handle;
  int set_condition;           // 1 on a WHILE body's last iteration
};

template <int H>
__global__ void loop_commit_kernel(Commit a) {
  __shared__ float Tn[H * H];
  const int lane = threadIdx.x;
  // every lane reads the state before any lane writes it
  const bool active = *a.done == 0 && *a.it < a.max_iter;
  float t_old = 0.f;
  if (lane < H * H) {
    const int i = lane / H, j = lane % H;
    Tn[lane] = product_entry<H>(a.dT + i * H, a.T + j);
    t_old = a.T[lane];
  }
  __syncwarp();
  if (lane < H * H) a.T[lane] = active ? Tn[lane] : t_old;
  if (lane != 0) return;

  const int it = *a.it;
  const float s_t = trans_norm(a.dT, H);
  const float s_r = rot_angle(a.dT, H);
  bool new_done = a.identity != 0;
  if (a.diff_on) {
    // the window means of the rolled history, step first
    float m_t = s_t, m_r = s_r;
    for (int r = 1; r < a.hist_rows; ++r) {
      m_t = add(m_t, a.hist[2 * (r - 1)]);
      m_r = add(m_r, a.hist[2 * (r - 1) + 1]);
    }
    m_t = __fdiv_rn(m_t, (float)a.hist_rows);
    m_r = __fdiv_rn(m_r, (float)a.hist_rows);
    new_done = new_done || ((it + 1 >= a.smooth_len) && (m_t < a.min_t) &&
                            (m_r < a.min_r));
  }
  if (a.bound_on) {
    new_done = new_done || (rot_angle(Tn, H) > a.max_rot) ||
               (trans_norm(Tn, H) > a.max_trans);
  }
  const bool done_out = active ? new_done : (*a.done != 0);
  const int it_out = it + (active ? 1 : 0);
  if (active) {
    for (int r = a.hist_rows - 1; r > 0; --r) {
      a.hist[2 * r] = a.hist[2 * (r - 1)];
      a.hist[2 * r + 1] = a.hist[2 * (r - 1) + 1];
    }
    a.hist[0] = s_t;
    a.hist[1] = s_r;
    *a.overlap = *a.overlap_new;
    if (a.rms != nullptr) *a.rms = *a.rms_new;
    if (a.ovf != nullptr) *a.ovf += *a.ovf_new;
  }
  *a.done = done_out ? 1 : 0;
  *a.it = it_out;
  if (a.set_condition)
    cudaGraphSetConditional(a.handle,
                            (!done_out && it_out < a.max_iter) ? 1u : 0u);
}

cudaError_t capture_info(cudaStream_t s, cudaStreamCaptureStatus* status,
                         cudaGraph_t* graph, const cudaGraphNode_t** deps,
                         size_t* n_deps) {
#if CUDART_VERSION >= 13000
  return cudaStreamGetCaptureInfo(s, status, nullptr, graph, deps, nullptr,
                                  n_deps);
#else
  return cudaStreamGetCaptureInfo(s, status, nullptr, graph, deps, n_deps);
#endif
}

}  // namespace

// Returns 0 or a cudaError_t; -1 if `capture_stream` is not capturing.
extern "C" int graph_while_begin(void* capture_stream, void* body_stream,
                                 const void* it, const void* done,
                                 int max_iter,
                                 unsigned long long* handle_out) {
  cudaStream_t cs = (cudaStream_t)capture_stream;
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = capture_info(cs, &status, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive) return -1;

  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return (int)err;
  // the loop's first test, as `lax.while_loop` makes it before the body
  set_while_condition<<<1, 1, 0, cs>>>(handle, (const int*)it,
                                       (const unsigned char*)done, max_iter);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = capture_info(cs, &status, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;

  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps, &params);
#else
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
#endif
  if (err != cudaSuccess) return (int)err;
  cudaGraph_t body = params.conditional.phGraph_out[0];
#if CUDART_VERSION >= 13000
  err = cudaStreamUpdateCaptureDependencies(cs, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaStreamUpdateCaptureDependencies(cs, &node, 1,
                                            cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamBeginCaptureToGraph((cudaStream_t)body_stream, body,
                                      nullptr, nullptr, 0,
                                      cudaStreamCaptureModeThreadLocal);
  if (err != cudaSuccess) return (int)err;
  *handle_out = (unsigned long long)handle;
  return 0;
}

// Ends the body's capture (its last loop_commit has set the condition).
// Returns 0 or a cudaError_t.
extern "C" int graph_while_end(void* body_stream) {
  cudaGraph_t body;
  return (int)cudaStreamEndCapture((cudaStream_t)body_stream, &body);
}

// One iteration's commit (see loop_commit_kernel); `dim` 2 or 3.  Launches
// one warp on `stream`, does not synchronise, allocates nothing.  Returns 0,
// a cudaError_t from the launch, or -1 for an unsupported dim or history.
extern "C" int loop_commit_launch(
    const void* dT, void* T, void* it, void* done, void* hist, int hist_rows,
    const void* overlap_new, void* overlap, const void* rms_new, void* rms,
    const void* ovf_new, void* ovf, int dim, int max_iter, int identity,
    int diff_on, float min_t, float min_r, int smooth_len, int bound_on,
    float max_rot, float max_trans, unsigned long long handle,
    int set_condition, void* stream) {
  if (hist_rows < 1) return -1;
  Commit a;
  a.dT = (const float*)dT;
  a.T = (float*)T;
  a.it = (int*)it;
  a.done = (unsigned char*)done;
  a.hist = (float*)hist;
  a.overlap_new = (const float*)overlap_new;
  a.overlap = (float*)overlap;
  a.rms_new = (const float*)rms_new;
  a.rms = (float*)rms;
  a.ovf_new = (const long long*)ovf_new;
  a.ovf = (long long*)ovf;
  a.hist_rows = hist_rows;
  a.max_iter = max_iter;
  a.identity = identity;
  a.diff_on = diff_on;
  a.smooth_len = smooth_len;
  a.min_t = min_t;
  a.min_r = min_r;
  a.bound_on = bound_on;
  a.max_rot = max_rot;
  a.max_trans = max_trans;
  a.handle = (cudaGraphConditionalHandle)handle;
  a.set_condition = set_condition;
  cudaStream_t s = (cudaStream_t)stream;
  if (dim == 3) {
    loop_commit_kernel<4><<<1, 32, 0, s>>>(a);
  } else if (dim == 2) {
    loop_commit_kernel<3><<<1, 32, 0, s>>>(a);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}
