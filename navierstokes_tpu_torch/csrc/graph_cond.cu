// CUDA graph conditional *while* nodes inside a stream capture, and the
// loop predicate that drives them (sm_90a).
//
// The counterpart of JAX's `lax.while_loop` (navierstokes_tpu/solvers/
// krylov.py:132,159,227,270): the captured step (models/step_graphs.py)
// runs each Krylov loop, BiCGStab, CG and a restart cycle of FGMRES, as one
// while node whose body is one iteration, and the preconditioner's inner
// BiCGStab as a while node nested in FGMRES's body.  The body runs exactly
// as many times as the loop iterates; no body is skipped and no iteration
// runs masked.  The torch of the card's host has no API for conditional
// nodes, so the port adds them here, called through kernels/conditional.py:
//
//   nst_while_begin(stream, flag, body_stream, tally, handle, step): on the
//     graph that `stream` is capturing into, create a conditional handle,
//     capture `set_condition` from the loop's flag (JAX's first test of
//     `cond_fun`: a loop whose flag is already down runs no body), add a
//     while node after it, make the node the capture's only dependency, and
//     begin capturing `body_stream` into the node's body graph;
//   nst_while_end(body_stream): end the body's capture; the body's last
//     launch, the loop's predicate, has set the handle again;
//   nst_set_condition_f32/_f64(stream, handle, use_handle, res, target,
//     stag, k, maxiter, active, tally): the predicate launch itself;
//   nst_stream_create(out): a body stream, outside torch's stream pool.
//
// `set_condition` is the loop's predicate, JAX's `cond_fun`: one thread
// reads the device scalars the loop's stop rule reads, ||r|| (`res`)
// against `target`, the breakdown flag `stag` (null for CG) and the count
// `k` against `maxiter`, writes `active` and, inside a graph, sets the
// node's handle from it.  With `res` null it reads `active` instead (the
// test before the node).  FGMRES's body ends in its Givens kernel
// (csrc/arnoldi_lsq.cu), which sets the handle itself.  Eager steps
// launch it without a handle, so a plain step launches what its graph
// launches.  `tally` (null, or
// three int64 per node) counts on the device the evaluations, those that
// let the body run, and the bodies that ran with the flag already down
// (zero under while semantics).
//
// It replaces no Pallas kernel.  Its bound is one node per evaluation, not
// bytes: it reads at most 26 bytes and writes one.

#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void set_condition(cudaGraphConditionalHandle handle,
                              int use_handle, const T* __restrict__ res,
                              const T* __restrict__ target,
                              const bool* __restrict__ stag,
                              const long long* __restrict__ k,
                              long long maxiter, bool* __restrict__ active,
                              long long* __restrict__ tally) {
  const bool was = *active;
  bool up = was;
  if (res != nullptr) {
    up = (*res > *target) && !(stag != nullptr && *stag) && (*k < maxiter);
    *active = up;
  }
  if (use_handle) cudaGraphSetConditional(handle, up ? 1u : 0u);
  if (tally != nullptr) {
    tally[0] += 1;
    tally[1] += up ? 1 : 0;
    // a body's predicate sees the flag the body ran under: only this
    // kernel writes a BiCGStab or CG loop's flag
    tally[2] += (res != nullptr && !was) ? 1 : 0;
  }
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

template <typename T>
int launch(void* stream, unsigned long long handle, int use_handle,
           const void* res, const void* target, const bool* stag,
           const long long* k, long long maxiter, bool* active,
           long long* tally) {
  set_condition<T><<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<cudaGraphConditionalHandle>(handle), use_handle,
      static_cast<const T*>(res), static_cast<const T*>(target), stag, k,
      maxiter, active, tally);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int nst_set_condition_f32(void* stream, unsigned long long handle,
                          int use_handle, const void* res,
                          const void* target, const bool* stag,
                          const long long* k, long long maxiter,
                          bool* active, long long* tally) {
  return launch<float>(stream, handle, use_handle, res, target, stag, k,
                       maxiter, active, tally);
}

int nst_set_condition_f64(void* stream, unsigned long long handle,
                          int use_handle, const void* res,
                          const void* target, const bool* stag,
                          const long long* k, long long maxiter,
                          bool* active, long long* tally) {
  return launch<double>(stream, handle, use_handle, res, target, stag, k,
                        maxiter, active, tally);
}

int nst_while_begin(void* stream, bool* flag, void* body_stream,
                    long long* tally, unsigned long long* handle_out,
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
  *handle_out = static_cast<unsigned long long>(handle);
  *step = 3;
  set_condition<float><<<1, 1, 0, s>>>(handle, 1, nullptr, nullptr, nullptr,
                                       nullptr, 0, flag, tally);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  *step = 4;
  e = capture_info(s, &graph, &deps, &ndeps);     // now: set_condition
  if (e != cudaSuccess) return e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
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

int nst_while_end(void* body_stream) {
  cudaGraph_t body;
  return cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &body);
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

}  // extern "C"
