// Dynamic shared memory above 48 KB, allowed once per kernel and device.
#pragma once

#include <cuda_runtime.h>

#include <stddef.h>

// Lets `kernel` take `bytes` of dynamic shared memory on the current
// device.  `granted` (one array per kernel, zero-initialised) holds the
// largest size set on each device, so the attribute is set on a kernel's
// first launch on a device and when a launch needs more, not on every
// launch.
constexpr int kSmemAttrDevices = 64;

inline cudaError_t allow_dynamic_smem(const void* kernel, size_t bytes,
                                      size_t* granted) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool known = dev >= 0 && dev < kSmemAttrDevices;
  if (known && granted[dev] >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e == cudaSuccess && known) granted[dev] = bytes;
  return e;
}
