// What a captured call launched: the kernel nodes and all nodes of a CUDA
// graph (torch.cuda.CUDAGraph(keep_graph=True).raw_cuda_graph()), for the
// launch counts of chip_smoke.py, the `gpu` tests and kernel_probe.py.
#include <cuda_runtime.h>

#include <vector>

extern "C" int vstar_graph_kernel_nodes(void* graph, long long* kernels, long long* nodes) {
  auto g = static_cast<cudaGraph_t>(graph);
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &n);
  if (err != cudaSuccess) return (int)err;
  std::vector<cudaGraphNode_t> all(n);
  if (n > 0 && (err = cudaGraphGetNodes(g, all.data(), &n)) != cudaSuccess) return (int)err;
  long long k = 0;
  for (cudaGraphNode_t node : all) {
    cudaGraphNodeType type;
    if ((err = cudaGraphNodeGetType(node, &type)) != cudaSuccess) return (int)err;
    k += type == cudaGraphNodeTypeKernel;
  }
  *kernels = k;
  *nodes = (long long)n;
  return 0;
}
