// Device-side loops inside a CUDA-graph capture: conditional nodes.
//
// The port's counterpart of lax.while_loop / lax.cond for a loop whose
// condition is a device boolean. utils/device_loop.py drives it while a
// stream is being captured into a CUDA graph:
//
//   photon_graph_cond_begin(outer, body, flag, kind, ...)
//     1. makes a conditional handle in the graph the outer stream captures
//        into,
//     2. captures, on the outer stream, a one-thread kernel that sets the
//        handle from *flag (the loop's first test),
//     3. adds a conditional node after the outer stream's capture
//        dependencies, a WHILE node (kind 0: its body runs again while the
//        handle is non-zero) or an IF node (kind 1: at most once), and makes
//        it the outer stream's only dependency, so what the outer stream
//        captures next runs after the loop,
//     4. starts capturing the body stream into the node's body graph.
//   The caller then issues the loop body on the body stream.
//   photon_graph_cond_end(body, handle, flag, kind, ...)
//     for a WHILE node captures the same one-thread kernel at the end of the
//     body (the next test, from the body's new *flag), then ends the body's
//     capture and returns the body graph's node count.
//
// A loop nested in a body is captured the same way, with that body's stream
// as its outer stream and another stream as its body. Bodies are captured in
// thread-local mode, as utils/device_loop.py captures the whole graph: only
// this thread's unsafe calls invalidate the capture, not another thread's
// (a serving queue, an ingest worker). Nothing here waits for
// the card: every call only builds the graph. Needs CUDA 12.4 or later
// (conditional nodes, cudaStreamBeginCaptureToGraph).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

__global__ void set_conditional_kernel(cudaGraphConditionalHandle handle,
                                       const bool* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

int capture_info(cudaStream_t stream, cudaGraph_t* graph,
                 const cudaGraphNode_t** deps, size_t* num_deps) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph,
                                             deps, nullptr, num_deps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph,
                                             deps, num_deps);
#endif
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive) {
    return static_cast<int>(cudaErrorStreamCaptureInvalidated);
  }
  return 0;
}

}  // namespace

extern "C" {

// kind 0: WHILE node, 1: IF node. *handle_out receives the conditional
// handle that photon_graph_cond_end needs.
int photon_graph_cond_begin(void* outer_stream, void* body_stream,
                            const void* flag, int kind,
                            unsigned long long* handle_out) {
  cudaStream_t outer = static_cast<cudaStream_t>(outer_stream);
  cudaStream_t body = static_cast<cudaStream_t>(body_stream);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t num_deps = 0;
  int rc = capture_info(outer, &graph, &deps, &num_deps);
  if (rc != 0) return rc;
  cudaGraphConditionalHandle handle;
  cudaError_t err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  set_conditional_kernel<<<1, 1, 0, outer>>>(
      handle, static_cast<const bool*>(flag));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rc = capture_info(outer, &graph, &deps, &num_deps);
  if (rc != 0) return rc;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type =
      kind == 0 ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, num_deps, &params);
#else
  err = cudaGraphAddNode(&node, graph, deps, num_deps, &params);
#endif
  if (err != cudaSuccess) return static_cast<int>(err);
#if CUDART_VERSION >= 13000
  err = cudaStreamUpdateCaptureDependencies(
      outer, &node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
  err = cudaStreamUpdateCaptureDependencies(outer, &node, 1,
                                            cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamBeginCaptureToGraph(body, params.conditional.phGraph_out[0],
                                      nullptr, nullptr, 0,
                                      cudaStreamCaptureModeThreadLocal);
  if (err != cudaSuccess) return static_cast<int>(err);
  *handle_out = static_cast<unsigned long long>(handle);
  return 0;
}

// Ends the body's capture; *nodes_out receives the body graph's node count
// (a nested conditional node counts once here, its own body at its end).
int photon_graph_cond_end(void* body_stream, unsigned long long handle,
                          const void* flag, int kind, size_t* nodes_out) {
  cudaStream_t body = static_cast<cudaStream_t>(body_stream);
  if (kind == 0) {
    set_conditional_kernel<<<1, 1, 0, body>>>(
        static_cast<cudaGraphConditionalHandle>(handle),
        static_cast<const bool*>(flag));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaGraph_t graph;
  cudaError_t err = cudaStreamEndCapture(body, &graph);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGraphGetNodes(graph, nullptr, nodes_out));
}

// The node count of a graph's top level (conditional bodies not included).
int photon_graph_node_count(void* graph, size_t* nodes_out) {
  return static_cast<int>(cudaGraphGetNodes(static_cast<cudaGraph_t>(graph),
                                            nullptr, nodes_out));
}

}  // extern "C"
