// The conditional nodes of a CUDA graph made while a stream captures it,
// for the device loop's conditional blocks and inner loops
// (ops/device_loop.py `when`, `while_`).
//
// cond_if_begin and cond_while_begin add to the graph that `parent` is
// capturing:
//   - a one-thread kernel that sets the node's condition from a device
//     bool (`set_cond`: the value read when the graph runs, not when it
//     is captured);
//   - a conditional node after it, IF or WHILE, whose body graph `child`
//     then captures: the work issued to `child` until cond_if_end or
//     cond_while_end runs where the bool was true (IF), or again and
//     again while the bool holds (WHILE: cond_while_end launches
//     `set_cond` from the bool as the body's last work, so the body sets
//     its own condition for the next pass, as the CUDA runtime requires).
// The parent's capture continues after the node.  Counterparts of the
// JAX package's lax.cond and lax.while_loop inside its compiled
// iteration; torch exposes no such node in its Python API at the version
// the port runs on.
#include <cuda_runtime.h>

namespace {

__global__ void set_cond(cudaGraphConditionalHandle handle,
                         const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

// the handles of the WHILE nodes whose bodies this thread is capturing,
// innermost last (cond_while_end sets the innermost one's condition)
constexpr int kMaxDepth = 64;
thread_local cudaGraphConditionalHandle while_handles[kMaxDepth];
thread_local int while_depth = 0;

int begin_node(cudaStream_t parent, cudaStream_t child, const bool* pred,
               cudaGraphConditionalNodeType type,
               cudaGraphConditionalHandle* out) {
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
  params.conditional.type = type;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (err != cudaSuccess) return err;
  cudaGraph_t body = params.conditional.phGraph_out[0];
  err = cudaStreamUpdateCaptureDependencies(
      parent, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  err = cudaStreamBeginCaptureToGraph(child, body, nullptr, nullptr, 0,
                                      cudaStreamCaptureModeThreadLocal);
  if (err != cudaSuccess) return err;
  *out = handle;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Each returns 0 or a cudaError_t; on error the parent's capture is left
// as it was where the error came before the node was added.  A begin
// that returned 0 is matched by its end, which always ends the body's
// capture.
int cond_if_begin(cudaStream_t parent, cudaStream_t child,
                  const bool* pred) {
  cudaGraphConditionalHandle handle;
  return begin_node(parent, child, pred, cudaGraphCondTypeIf, &handle);
}

int cond_if_end(cudaStream_t child) {
  cudaGraph_t body;
  return cudaStreamEndCapture(child, &body);
}

int cond_while_begin(cudaStream_t parent, cudaStream_t child,
                     const bool* pred) {
  if (while_depth >= kMaxDepth) return cudaErrorInvalidValue;
  cudaGraphConditionalHandle handle;
  int err = begin_node(parent, child, pred, cudaGraphCondTypeWhile,
                       &handle);
  if (err != cudaSuccess) return err;
  while_handles[while_depth++] = handle;
  return cudaSuccess;
}

// `pred` is the bool the body rewrote: the node runs the body again
// while it holds.
int cond_while_end(cudaStream_t child, const bool* pred) {
  cudaError_t err = cudaErrorInvalidValue;
  if (while_depth > 0) {
    cudaGraphConditionalHandle handle = while_handles[--while_depth];
    set_cond<<<1, 1, 0, child>>>(handle, pred);
    err = cudaGetLastError();
  }
  cudaGraph_t body;
  cudaError_t end = cudaStreamEndCapture(child, &body);
  return err != cudaSuccess ? err : end;
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
