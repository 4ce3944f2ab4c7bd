// CUDA-graph IF nodes for a stream capture, for the bh step's
// data-dependent branches (nbodyax_torch/physics/graph_if.py).
//
// Counterpart of nbodyax's lax.cond tiers (nbodyax/physics/barneshut.py,
// _tiered and _tiered_completion): XLA compiles a cond into the program;
// here a capture records the branch's work into the body graph of a
// conditional node, and at replay a one-thread kernel reads the predicate
// (a bool on the card) and sets the node's condition, so the branch runs or
// not with no host read. Needs CUDA 12.4 or newer in the driver and the
// runtime. Not a compute kernel: it replaces no TPU kernel and moves one
// byte a branch.
//
// nbodyax_if_begin(stream, body_stream, pred) adds, to the graph that
// `stream` is capturing, the predicate kernel and an IF node after the
// stream's current dependencies, makes the node the stream's only
// dependency, and starts capturing `body_stream` into the node's body
// graph. nbodyax_if_end(body_stream, &nodes) ends that body capture and
// gives the body's node count; nbodyax_capture_nodes(stream, &nodes) the
// node count so far of the graph `stream` is capturing. Each returns a
// cudaError_t (0 on success).

#include <cuda_runtime.h>

#if CUDART_VERSION >= 13000
#define NBX_CAPTURE_INFO(s, st, id, g, deps, n) \
  cudaStreamGetCaptureInfo(s, st, id, g, deps, nullptr, n)
#define NBX_ADD_NODE(node, g, deps, n, params) \
  cudaGraphAddNode(node, g, deps, nullptr, n, params)
#define NBX_SET_DEPS(s, deps, n) \
  cudaStreamUpdateCaptureDependencies(s, deps, nullptr, n, \
                                      cudaStreamSetCaptureDependencies)
#else
#define NBX_CAPTURE_INFO(s, st, id, g, deps, n) \
  cudaStreamGetCaptureInfo(s, st, id, g, deps, n)
#define NBX_ADD_NODE(node, g, deps, n, params) \
  cudaGraphAddNode(node, g, deps, n, params)
#define NBX_SET_DEPS(s, deps, n) \
  cudaStreamUpdateCaptureDependencies(s, deps, n, \
                                      cudaStreamSetCaptureDependencies)
#endif

__global__ void nbodyax_set_condition(cudaGraphConditionalHandle handle,
                                      const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

extern "C" int nbodyax_if_begin(void* stream, void* body_stream,
                                const void* pred) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  unsigned long long id;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t ndeps;
  cudaError_t err = NBX_CAPTURE_INFO(s, &status, &id, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive)
    return cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  nbodyax_set_condition<<<1, 1, 0, s>>>(handle,
                                        static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the kernel is now the stream's dependency: the node goes after it
  err = NBX_CAPTURE_INFO(s, &status, &id, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = NBX_ADD_NODE(&node, graph, deps, ndeps, &params);
  if (err != cudaSuccess) return err;
  err = NBX_SET_DEPS(s, &node, 1);
  if (err != cudaSuccess) return err;
  return cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body_stream),
      params.conditional.phGraph_out[0], nullptr, nullptr, 0,
      cudaStreamCaptureModeThreadLocal);
}

extern "C" int nbodyax_if_end(void* body_stream, size_t* nodes) {
  cudaGraph_t body;
  cudaError_t err =
      cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &body);
  if (err != cudaSuccess) return err;
  return cudaGraphGetNodes(body, nullptr, nodes);
}

extern "C" int nbodyax_capture_nodes(void* stream, size_t* nodes) {
  cudaStreamCaptureStatus status;
  unsigned long long id;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t ndeps;
  cudaError_t err = NBX_CAPTURE_INFO(static_cast<cudaStream_t>(stream),
                                     &status, &id, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive)
    return cudaErrorStreamCaptureImplicit;
  return cudaGraphGetNodes(graph, nullptr, nodes);
}
