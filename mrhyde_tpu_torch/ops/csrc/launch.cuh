// What the kernel files' launchers share: the error a launch returns where
// a block's shared memory passes the card's limit, and the size of a
// persistent kernel's grid (the blocks the card holds at once). Included by
// the element-tile engine (elem_engine.cuh), the module-set kernels
// (set_node.cuh, set_elem.cuh) and the thermal node kernels
// (fused_p1_thermal.cu).

#pragma once

#include <cuda_runtime.h>

namespace {

// what a launch returns where a block's shared memory passes the card's
// limit per block, or one element's layout does not fit it (the wrappers
// raise on it)
constexpr int kErrSharedMemory = -1;

// the blocks of one persistent kernel the card holds at once, for a device
// and a shared-memory size: each launch site keeps its own (per host
// thread)
struct Resident {
  int dev = -1;
  long long smem = -1;
  int blocks = 0;
};

template <class Kernel>
int query_resident(Kernel kernel, int threads, size_t smem, Resident& r) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev == r.dev && (long long)smem == r.smem) return 0;
  int optin = 0, sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (smem > (size_t)optin) return kErrSharedMemory;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  const cudaError_t err = (cudaError_t)cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  r.blocks = sms * (per_sm > 0 ? per_sm : 1);
  r.dev = dev;
  r.smem = (long long)smem;
  return 0;
}

}  // namespace
