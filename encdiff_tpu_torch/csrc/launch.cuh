// Host helpers of the launch code of attention_core.cu and groupnorm_silu.cu:
// the device's limit of opt-in shared memory, read once per device, and a
// kernel's opt-in to it, made once per device. The state is kept per device
// under a lock: ctypes drops the GIL, so threads may launch at once.

#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace kernel_launch {

constexpr int kDevices = 64;

// The current device and the most dynamic shared memory a block may opt
// into on it. Returns 0 or a CUDA error.
inline int device_optin(int* dev_out, long long* optin) {
  static std::mutex lock;
  static int cached[kDevices];  // 0: not read yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kDevices) return (int)cudaErrorInvalidValue;
  std::lock_guard<std::mutex> hold(lock);
  if (cached[dev] == 0) {
    int o = 0;
    err = cudaDeviceGetAttribute(&o, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    cached[dev] = o;
  }
  *dev_out = dev;
  *optin = cached[dev];
  return 0;
}

// Lets Kernel take up to `optin` bytes of dynamic shared memory on device
// `dev` (from device_optin), once per device. Returns 0 or a CUDA error.
template <auto Kernel>
int opt_in(int dev, long long optin) {
  static std::mutex lock;
  static bool done[kDevices];
  std::lock_guard<std::mutex> hold(lock);
  if (!done[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)optin);
    if (err != cudaSuccess) return (int)err;
    done[dev] = true;
  }
  return 0;
}

}  // namespace kernel_launch
