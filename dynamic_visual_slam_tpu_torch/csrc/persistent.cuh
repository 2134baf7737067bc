// Grid size of a persistent kernel, shared by the port's CUDA sources.
#pragma once

#include <cuda_runtime.h>

// Blocks of a persistent grid: as many as fit on the SMs at once, at most
// one a work item; -1 when the device cannot be queried.
template <typename Kernel>
inline int persistent_blocks(Kernel kernel, int threads, long long work) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0) != cudaSuccess)
    return -1;
  const long long cap = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  return static_cast<int>(work < cap ? work : cap);
}
