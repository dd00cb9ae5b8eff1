// A WHILE loop inside a CUDA graph: the counterpart of `jax.lax.while_loop`.
//
// The ICP solve of the JAX package is one device program whose iteration
// loop is `lax.while_loop(cond, body, state)` (icp/engine.py::_icp_solve).
// On the card the same loop is a conditional WHILE node of a CUDA graph
// (CUDA 12.4 and later): the node's body graph runs as long as its condition
// handle holds 1, and a kernel at the end of the body sets the handle from
// the loop state, so the host reads nothing between iterations.
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
//   ... the caller runs the body on the body stream ...
//   graph_while_end    (on the body stream)
//     set_while_condition kernel        -> the body's last node
//     cudaStreamEndCapture
//
// There is nothing to compute here; the cost of the loop on the card is one
// one-thread kernel per iteration and the node's own scheduling.
#include <cuda_runtime.h>

namespace {

__global__ void set_while_condition(cudaGraphConditionalHandle handle,
                                    const int* it, const unsigned char* done,
                                    int max_iter) {
  cudaGraphSetConditional(handle, (*done == 0 && *it < max_iter) ? 1u : 0u);
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

// Ends the body: the condition kernel, then the end of the body's capture.
// Returns 0 or a cudaError_t.
extern "C" int graph_while_end(void* body_stream, unsigned long long handle,
                               const void* it, const void* done,
                               int max_iter) {
  cudaStream_t bs = (cudaStream_t)body_stream;
  set_while_condition<<<1, 1, 0, bs>>>((cudaGraphConditionalHandle)handle,
                                       (const int*)it,
                                       (const unsigned char*)done, max_iter);
  cudaError_t launch = cudaGetLastError();
  cudaGraph_t body;
  // the capture is ended whatever happened, so the stream is usable again
  cudaError_t err = cudaStreamEndCapture(bs, &body);
  if (launch != cudaSuccess) return (int)launch;
  return (int)err;
}
