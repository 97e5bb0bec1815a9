// Conditional CUDA graphs assembled from captured segments, with a plain C
// interface (shud_tpu_torch/solver/graph.py binds it with ctypes).
//
// The JAX solver runs a whole window inside one lax.while_loop
// (shud_tpu/solver/bdf.py:389), its Newton loop inside another (:201).
// The port captures the pieces of one solver step with torch.cuda.graph
// (each a cudaGraph_t of PyTorch's kernels and the port's own) and builds
// the window from copies of them here: a graph of S steps, each inside an
// IF conditional node on "the window is still active", with Newton
// iterations 2..n inside nested IF nodes on "the last update was above the
// Newton tolerance".  A conditional node's condition is set on the device
// by a one-thread kernel (set_condition) that reads a bool the previous
// piece wrote, so no host decides anything while the graph runs.
//
// Every entry point returns a cudaError_t as int; the caller raises.

#include <cuda_runtime.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

int deps_of(void* dep, cudaGraphNode_t* out) {
  *out = static_cast<cudaGraphNode_t>(dep);
  return dep != nullptr ? 1 : 0;
}

}  // namespace

extern "C" {

int shud_graph_create(void** graph) {
  cudaGraph_t g = nullptr;
  cudaError_t err = cudaGraphCreate(&g, 0);
  *graph = g;
  return static_cast<int>(err);
}

int shud_graph_destroy(void* graph) {
  return static_cast<int>(cudaGraphDestroy(static_cast<cudaGraph_t>(graph)));
}

// a copy of *child* in *graph*, after *dep* (null: a root node)
int shud_graph_add_child(void* graph, void* dep, void* child, void** node) {
  cudaGraphNode_t d, n = nullptr;
  const int nd = deps_of(dep, &d);
  cudaError_t err = cudaGraphAddChildGraphNode(
      &n, static_cast<cudaGraph_t>(graph), nd ? &d : nullptr, nd,
      static_cast<cudaGraph_t>(child));
  *node = n;
  return static_cast<int>(err);
}

// after *dep*: a kernel that sets a new handle's condition from *pred, then
// an IF node on it; *body is the graph the node runs when the bool is true
int shud_graph_add_if(void* graph, void* dep, const bool* pred, void** body,
                      void** node) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  cudaGraphConditionalHandle handle;
  cudaError_t err = cudaGraphConditionalHandleCreate(&handle, g, 0, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&handle, &pred};
  cudaKernelNodeParams kp = {};
  kp.func = reinterpret_cast<void*>(&set_condition);
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  kp.kernelParams = args;
  cudaGraphNode_t d, setter;
  const int nd = deps_of(dep, &d);
  err = cudaGraphAddKernelNode(&setter, g, nd ? &d : nullptr, nd, &kp);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = handle;
  cp.conditional.type = cudaGraphCondTypeIf;
  cp.conditional.size = 1;
  cudaGraphNode_t n;
  err = cudaGraphAddNode(&n, g, &setter, 1, &cp);
  if (err != cudaSuccess) return static_cast<int>(err);
  *body = cp.conditional.phGraph_out[0];
  *node = n;
  return 0;
}

int shud_graph_instantiate(void* graph, void** exec) {
  cudaGraphExec_t e = nullptr;
  cudaError_t err =
      cudaGraphInstantiate(&e, static_cast<cudaGraph_t>(graph), 0);
  *exec = e;
  return static_cast<int>(err);
}

int shud_graph_launch(void* exec, cudaStream_t stream) {
  return static_cast<int>(
      cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec), stream));
}

int shud_graph_exec_destroy(void* exec) {
  return static_cast<int>(
      cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec)));
}

}  // extern "C"
