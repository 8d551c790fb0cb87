// Dynamic shared memory for the kernels' C entry points, without a runtime
// query before every launch: the device's opt-in limit is read once per
// device, and a kernel's cudaFuncAttributeMaxDynamicSharedMemorySize is set
// only when a launch needs more than that kernel was last allowed on the
// current device. At the model's small shapes a kernel runs for a few µs,
// so the host path of a launch is kept to the launch itself.

#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <map>
#include <mutex>
#include <utility>

namespace smem_attr {

constexpr size_t kDefault = 48 * 1024;   // usable without the attribute
constexpr int kDevices = 64;             // cached; others query each time

// the current device's opt-in shared memory per block, in bytes
inline cudaError_t optin_limit(int* bytes) {
  static std::atomic<int> cached[kDevices];   // 0: not read yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int v = dev < kDevices ? cached[dev].load(std::memory_order_relaxed) : 0;
  if (v == 0) {
    err = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
    if (err != cudaSuccess) return err;
    if (dev < kDevices) cached[dev].store(v, std::memory_order_relaxed);
  }
  *bytes = v;
  return cudaSuccess;
}

// let `kernel` launch with `bytes` of dynamic shared memory on the current
// device
template <typename Kernel>
cudaError_t allow(Kernel* kernel, size_t bytes) {
  if (bytes <= kDefault) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, size_t> allowed;
  std::lock_guard<std::mutex> lock(mu);
  size_t& have = allowed[{(const void*)kernel, dev}];
  if (bytes <= have) return cudaSuccess;
  err = cudaFuncSetAttribute((const void*)kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess) have = bytes;
  return err;
}

}  // namespace smem_attr
