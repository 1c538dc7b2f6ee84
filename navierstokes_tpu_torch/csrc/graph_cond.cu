// CUDA graph conditional "if" nodes inside a stream capture (sm_90a).
//
// The captured monolithic step (models/step_graphs.py) runs every FGMRES
// iteration under an if node on the solve's flag `active`, and inside it
// every iteration of the preconditioner's inner BiCGStab under an if node
// on that loop's flag: JAX's `lax.while_loop` (navierstokes_tpu/solvers/
// krylov.py:132,159,227) as a fixed unroll of guarded iterations.  The
// torch of the card's host has no API for conditional nodes, so the port
// adds them here, called through kernels/conditional.py:
//
//   nst_if_begin(stream, flag, body_stream): on the graph that `stream`
//     is capturing into, create a conditional handle, capture the kernel
//     `set_condition` that sets it from the device flag, add an if node
//     after it, make the node the capture's only dependency, and begin
//     capturing `body_stream` into the node's body graph;
//   nst_if_end(body_stream): end that body's capture;
//   nst_stream_create(out): a body stream, outside torch's stream pool.
//
// Nested bodies work the same way: the parent stream is then the outer
// body's stream, capturing into the outer body graph.  The one kernel,
// set_condition, reads one byte and sets the handle; an if node whose
// flag is down costs that kernel and the node, not its body.

#include <cuda_runtime.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const bool* __restrict__ flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

cudaError_t capture_info(cudaStream_t s, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* ndeps) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t e = cudaStreamGetCaptureInfo(s, &status, nullptr, graph, deps,
                                           nullptr, ndeps);
#else
  cudaError_t e = cudaStreamGetCaptureInfo(s, &status, nullptr, graph, deps,
                                           ndeps);
#endif
  if (e != cudaSuccess) return e;
  return status == cudaStreamCaptureStatusActive
             ? cudaSuccess
             : cudaErrorStreamCaptureInvalidated;
}

}  // namespace

extern "C" {

int nst_if_begin(void* stream, const bool* flag, void* body_stream,
                 int* step) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *step = 0;                       // an error left by an earlier call
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t ndeps;
  *step = 1;
  e = capture_info(s, &graph, &deps, &ndeps);
  if (e != cudaSuccess) return e;
  cudaGraphConditionalHandle handle;
  *step = 2;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (e != cudaSuccess) return e;
  *step = 3;
  set_condition<<<1, 1, 0, s>>>(handle, flag);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  *step = 4;
  e = capture_info(s, &graph, &deps, &ndeps);     // now: set_condition
  if (e != cudaSuccess) return e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  *step = 5;
#if CUDART_VERSION >= 13000
  e = cudaGraphAddNode(&node, graph, deps, nullptr, ndeps, &params);
  if (e != cudaSuccess) return e;
  *step = 6;
  e = cudaStreamUpdateCaptureDependencies(s, &node, nullptr, 1,
                                          cudaStreamSetCaptureDependencies);
#else
  e = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (e != cudaSuccess) return e;
  *step = 6;
  e = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                          cudaStreamSetCaptureDependencies);
#endif
  if (e != cudaSuccess) return e;
  *step = 7;
  return cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body_stream), params.conditional.phGraph_out[0],
      nullptr, nullptr, 0, cudaStreamCaptureModeRelaxed);
}

// A stream of its own for capturing bodies: torch's streams come from a
// pool of a few per device, and one of them may be the stream whose
// capture the body belongs to.
int nst_stream_create(void** out) {
  cudaStream_t s;
  cudaError_t e = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  *out = s;
  return e;
}

int nst_if_end(void* body_stream) {
  cudaGraph_t body;
  return cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &body);
}

}  // extern "C"
