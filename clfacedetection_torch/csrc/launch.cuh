// Shared memory of the card, for the kernels that size their blocks at
// launch (haar_tail.cu, haar_tail2.cu).
#pragma once

#include <cuda_runtime.h>

// One kernel's shared-memory limits on the current device, read on the
// first launch on that device, when the kernel's dynamic shared-memory
// limit is also raised to the most a block may take.  Keep one per kernel
// (instantiation): later launches on the same device call only
// cudaGetDevice.
struct ClfdSmem {
  int dev = -1;
  int block = 0;     // the most dynamic shared memory a block may take
  int fixed = 0;     // the kernel's static shared memory
  int sm = 0;        // an SM's shared memory
  int reserved = 0;  // what the card keeps for each resident block

  cudaError_t ready(const void* kernel) {
    int d = 0;
    cudaError_t e = cudaGetDevice(&d);
    if (e != cudaSuccess || d == dev) return e;
    cudaFuncAttributes fa;
    int optin = 0;
    if ((e = cudaFuncGetAttributes(&fa, kernel)) ||
        (e = cudaDeviceGetAttribute(
             &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, d)) ||
        (e = cudaDeviceGetAttribute(
             &sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, d)) ||
        (e = cudaDeviceGetAttribute(
             &reserved, cudaDevAttrReservedSharedMemoryPerBlock, d)))
      return e;
    // a block's static and dynamic shared memory together fit `optin`
    fixed = (int)fa.sharedSizeBytes;
    block = optin - fixed;
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, block);
    if (e == cudaSuccess) dev = d;
    return e;
  }
};
