// Conditional CUDA graphs assembled from captured segments, with a plain C
// interface (shud_tpu_torch/solver/graph.py binds it with ctypes).
//
// The JAX driver runs an output interval as one jit: a lax.scan over the
// interval's windows (shud_tpu/driver/fused.py:81-395), each window's solve
// a lax.while_loop over steps (shud_tpu/solver/bdf.py:389) with its Newton
// loop inside another (:201).  The port captures each piece of that program
// with torch.cuda.graph (each a cudaGraph_t of PyTorch's kernels and the
// port's own) and builds the program from copies of them here: WHILE
// conditional nodes for the window and step loops, IF nodes for Newton
// iterations 2..n.  A conditional node's condition is set on the device by
// a one-thread kernel (set_condition) that reads a bool a piece wrote: once
// before the node, and for a WHILE node again as the last node of its body,
// so no host decides anything while the graph runs.  WHILE nodes need CUDA
// 12.3 or later.
//
// A stamp node (stamp, one thread) reads the device's nanosecond clock
// (%globaltimer) between two pieces and adds the time since the previous
// stamp into one entry of an int64 buffer, whose last entry keeps the
// reading: IntervalGraph's device time of each window's head, solve and
// tail.  No JAX counterpart: it replaces none of JAX's kernels and is only
// in the graph when the port's tracing is on.
//
// Every entry point returns a cudaError_t as int; the caller raises.

#include <cuda_runtime.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

// sums[slot] += now - sums[last]; sums[last] = now
__global__ void stamp(long long* sums, int slot, int last) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const long long t = static_cast<long long>(now);
  sums[slot] += t - sums[last];
  sums[last] = t;
}

int deps_of(void* dep, cudaGraphNode_t* out) {
  *out = static_cast<cudaGraphNode_t>(dep);
  return dep != nullptr ? 1 : 0;
}

// after *dep* (null: a root node): a kernel node that sets *handle* from
// *pred
cudaError_t add_setter(cudaGraph_t g, void* dep,
                       cudaGraphConditionalHandle handle, const bool* pred,
                       cudaGraphNode_t* setter) {
  void* args[] = {&handle, &pred};
  cudaKernelNodeParams kp = {};
  kp.func = reinterpret_cast<void*>(&set_condition);
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  kp.kernelParams = args;
  cudaGraphNode_t d;
  const int nd = deps_of(dep, &d);
  return cudaGraphAddKernelNode(setter, g, nd ? &d : nullptr, nd, &kp);
}

// after *dep*: the setter of a new handle, then a conditional node of
// *type* on it; *body is the graph the node runs
cudaError_t add_conditional(cudaGraph_t g, void* dep, const bool* pred,
                            cudaGraphConditionalNodeType type,
                            cudaGraphConditionalHandle* handle,
                            cudaGraph_t* body, cudaGraphNode_t* node) {
  cudaError_t err = cudaGraphConditionalHandleCreate(handle, g, 0, 0);
  if (err != cudaSuccess) return err;
  cudaGraphNode_t setter;
  err = add_setter(g, dep, *handle, pred, &setter);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = *handle;
  cp.conditional.type = type;
  cp.conditional.size = 1;
  err = cudaGraphAddNode(node, g, &setter, 1, &cp);
  if (err != cudaSuccess) return err;
  *body = cp.conditional.phGraph_out[0];
  return cudaSuccess;
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

// after *dep*: an IF node run when *pred is true; *body is its graph
int shud_graph_add_if(void* graph, void* dep, const bool* pred, void** body,
                      void** node) {
  cudaGraphConditionalHandle handle;
  cudaGraph_t b = nullptr;
  cudaGraphNode_t n = nullptr;
  cudaError_t err = add_conditional(static_cast<cudaGraph_t>(graph), dep,
                                    pred, cudaGraphCondTypeIf, &handle, &b,
                                    &n);
  *body = b;
  *node = n;
  return static_cast<int>(err);
}

// after *dep*: a WHILE node whose body runs as long as *pred is true.  The
// caller ends the body with shud_graph_add_condition(body, last, *handle,
// pred), which reads *pred again after each pass
int shud_graph_add_while(void* graph, void* dep, const bool* pred,
                         void** body, void** node,
                         unsigned long long* handle) {
  cudaGraphConditionalHandle h = 0;
  cudaGraph_t b = nullptr;
  cudaGraphNode_t n = nullptr;
  cudaError_t err = add_conditional(static_cast<cudaGraph_t>(graph), dep,
                                    pred, cudaGraphCondTypeWhile, &h, &b, &n);
  *body = b;
  *node = n;
  *handle = h;
  return static_cast<int>(err);
}

// after *dep* in *graph*: set *handle* from *pred
int shud_graph_add_condition(void* graph, void* dep, unsigned long long handle,
                             const bool* pred, void** node) {
  cudaGraphNode_t n = nullptr;
  cudaError_t err = add_setter(static_cast<cudaGraph_t>(graph), dep, handle,
                               pred, &n);
  *node = n;
  return static_cast<int>(err);
}

// after *dep* in *graph*: a stamp into entry *slot* of *sums*, whose entry
// *last* holds the previous reading
int shud_graph_add_stamp(void* graph, void* dep, long long* sums, int slot,
                         int last, void** node) {
  void* args[] = {&sums, &slot, &last};
  cudaKernelNodeParams kp = {};
  kp.func = reinterpret_cast<void*>(&stamp);
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  kp.kernelParams = args;
  cudaGraphNode_t d, n = nullptr;
  const int nd = deps_of(dep, &d);
  cudaError_t err = cudaGraphAddKernelNode(
      &n, static_cast<cudaGraph_t>(graph), nd ? &d : nullptr, nd, &kp);
  *node = n;
  return static_cast<int>(err);
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

// the nodes of *graph* by type (a captured piece's: what one replay of it
// runs on the device): out[0] kernels, out[1] copies, out[2] memsets,
// out[3] any other node
int shud_graph_node_types(void* graph, unsigned long long* out) {
  auto g = static_cast<cudaGraph_t>(graph);
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &n);
  for (int k = 0; k < 4; ++k) out[k] = 0;
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n];
  err = cudaGraphGetNodes(g, nodes, &n);
  for (size_t i = 0; err == cudaSuccess && i < n; ++i) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[i], &type);
    const int k = type == cudaGraphNodeTypeKernel ? 0
                  : type == cudaGraphNodeTypeMemcpy ? 1
                  : type == cudaGraphNodeTypeMemset ? 2 : 3;
    out[k] += 1;
  }
  delete[] nodes;
  return static_cast<int>(err);
}

}  // extern "C"
