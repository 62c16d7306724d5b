// Shared memory of the card, for the kernels that size their blocks at
// launch (haar_tail.cu, haar_tail2.cu, tail_rows.cu).
#pragma once

#include <atomic>

#include <cuda_runtime.h>

// A kernel's shared-memory limits on one device.
struct ClfdSmemLimits {
  int block = 0;     // the most dynamic shared memory a block may take
  int fixed = 0;     // the kernel's static shared memory
  int sm = 0;        // an SM's shared memory
  int reserved = 0;  // what the card keeps for each resident block
};

// Setups done by every ClfdSmem of the process (clfd_smem_setups in
// launch.cu reads it): one per kernel and device.
inline std::atomic<int> clfd_smem_setup_count{0};

// One kernel's limits by device ordinal, each read on the first launch on
// that device, when the kernel's dynamic shared-memory limit on it is also
// raised to the most a block may take.  Keep one per kernel
// (instantiation): later launches on a device that is set up, whichever
// device launched last, call only cudaGetDevice.  Two host threads that
// set up one device at once both read the same limits.
struct ClfdSmem {
  static constexpr int kMaxDevices = 64;
  ClfdSmemLimits limits[kMaxDevices];
  std::atomic<bool> done[kMaxDevices] = {};

  // The current device's limits into `out`.
  cudaError_t ready(const void* kernel, ClfdSmemLimits* out) {
    int d = 0;
    cudaError_t e = cudaGetDevice(&d);
    if (e != cudaSuccess) return e;
    if (d < 0 || d >= kMaxDevices) return cudaErrorInvalidDevice;
    if (!done[d].load(std::memory_order_acquire)) {
      ClfdSmemLimits l;
      cudaFuncAttributes fa;
      int optin = 0;
      if ((e = cudaFuncGetAttributes(&fa, kernel)) ||
          (e = cudaDeviceGetAttribute(
               &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, d)) ||
          (e = cudaDeviceGetAttribute(
               &l.sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, d)) ||
          (e = cudaDeviceGetAttribute(
               &l.reserved, cudaDevAttrReservedSharedMemoryPerBlock, d)))
        return e;
      // a block's static and dynamic shared memory together fit `optin`
      l.fixed = (int)fa.sharedSizeBytes;
      l.block = optin - l.fixed;
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, l.block);
      if (e != cudaSuccess) return e;
      limits[d] = l;
      done[d].store(true, std::memory_order_release);
      clfd_smem_setup_count.fetch_add(1);
    }
    *out = limits[d];
    return cudaSuccess;
  }
};
