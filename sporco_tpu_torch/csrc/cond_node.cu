// An IF node of a CUDA graph made while a stream captures it, for the
// device loop's conditional blocks (ops/device_loop.py `when`).
//
// cond_if_begin adds to the graph that `parent` is capturing:
//   - a one-thread kernel that sets the node's condition from a device
//     bool (`set_cond`: the value read when the graph runs, not when it
//     is captured);
//   - an IF node after it, whose body graph `child` then captures: the
//     work issued to `child` until cond_if_end runs only where the bool
//     was true.
// The parent's capture continues after the node.  Counterpart of the JAX
// package's lax.cond inside a while_loop; torch exposes no such node in
// its Python API at the version the port runs on.
#include <cuda_runtime.h>

namespace {

__global__ void set_cond(cudaGraphConditionalHandle handle,
                         const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

extern "C" {

// Returns 0 or a cudaError_t; on error the parent's capture is left as
// it was where the error came before the node was added.
int cond_if_begin(cudaStream_t parent, cudaStream_t child,
                  const bool* pred) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(parent, &status, nullptr,
                                             &graph, &deps, &ndeps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive)
    return cudaErrorStreamCaptureInvalidated;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_cond<<<1, 1, 0, parent>>>(handle, pred);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the dependencies now end with the kernel just captured
  err = cudaStreamGetCaptureInfo(parent, &status, nullptr, &graph, &deps,
                                 &ndeps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (err != cudaSuccess) return err;
  cudaGraph_t body = params.conditional.phGraph_out[0];
  err = cudaStreamUpdateCaptureDependencies(
      parent, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  return cudaStreamBeginCaptureToGraph(child, body, nullptr, nullptr, 0,
                                       cudaStreamCaptureModeThreadLocal);
}

int cond_if_end(cudaStream_t child) {
  cudaGraph_t body;
  return cudaStreamEndCapture(child, &body);
}

// Before any capture: the runtime and the set_cond kernel loaded (not
// lazily, inside a capture, at its first launch).
int cond_init(void) {
  cudaFuncAttributes attr;
  return cudaFuncGetAttributes(&attr, set_cond);
}

// A stream of the loop's own for the bodies (not one of torch's pool,
// which the captures' side streams are drawn from).
int cond_stream_create(cudaStream_t* out) {
  return cudaStreamCreateWithFlags(out, cudaStreamNonBlocking);
}

}  // extern "C"
