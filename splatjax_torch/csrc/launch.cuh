// Host-side launch of the tile rasterizers (K2, K3, K4): one block, or one
// thread-block cluster, per tile; and the attributes of a compiled kernel.
#pragma once

#include <cuda_runtime.h>

namespace {

// The kernel attributes a launch of ``kernel`` in clusters of CLUSTER
// blocks with ``dyn_bytes`` of dynamic shared memory needs: a
// non-portable cluster size past 8, and dynamic shared memory that may
// take the block past 48 KB with its static shared memory.
template <int CLUSTER, class Kernel>
cudaError_t opt_in(Kernel kernel, int dyn_bytes) {
  if (dyn_bytes > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn_bytes);
    if (err != cudaSuccess) return err;
  }
  if constexpr (CLUSTER > 8) {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return cudaSuccess;
}

// The launch configuration of ``blocks`` blocks of ``threads`` threads in
// clusters of CLUSTER blocks; ``attr`` holds the cluster dimension.
template <int CLUSTER>
cudaLaunchConfig_t cluster_config(unsigned blocks, int threads,
                                  int dyn_bytes, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CLUSTER;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = dyn_bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Launches ``kernel`` on ``blocks`` blocks of ``threads`` threads with
// ``dyn_bytes`` of dynamic shared memory, in clusters of CLUSTER blocks
// when CLUSTER > 1. Returns the launch's cudaError_t.
template <int CLUSTER, class Kernel, class... Args>
int launch_tiles(Kernel kernel, unsigned blocks, int threads, int dyn_bytes,
                 cudaStream_t stream, Args... args) {
  const cudaError_t err = opt_in<CLUSTER>(kernel, dyn_bytes);
  if (err != cudaSuccess) return (int)err;
  if constexpr (CLUSTER == 1) {
    kernel<<<blocks, threads, dyn_bytes, stream>>>(args...);
    return (int)cudaGetLastError();
  } else {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        cluster_config<CLUSTER>(blocks, threads, dyn_bytes, stream, &attr);
    const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
    const cudaError_t last = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : last);
  }
}

// Of ``kernel`` launched as launch_tiles<CLUSTER> launches it: registers a
// thread, local memory (spills) bytes a thread, the largest block it can
// launch (cudaFuncGetAttributes), the blocks of ``threads`` threads an SM
// holds at once, and the clusters the device holds at once (0 for one
// block per tile).
template <int CLUSTER, class Kernel>
int kernel_attributes(Kernel kernel, int threads, int dyn_bytes, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = opt_in<CLUSTER>(kernel, dyn_bytes);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  int per_sm = 0, clusters = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, dyn_bytes);
  }
  if constexpr (CLUSTER > 1) {
    cudaLaunchAttribute cattr;
    const cudaLaunchConfig_t cfg =
        cluster_config<CLUSTER>(CLUSTER, threads, dyn_bytes, 0, &cattr);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    }
  }
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = attr.maxThreadsPerBlock;
  out[3] = per_sm;
  out[4] = clusters;
  return 0;
}

}  // namespace
