// A kernel's dynamic shared-memory limit, raised once per device.
//
// A block may use more than 48 KB of dynamic shared memory only after
// cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
// bytes) on the device that launches it. That call costs host time on every
// launch if it is repeated, so a launch keeps one SmemLimit per kernel (a
// function-local static in its launch template, one per template instance)
// and calls raise() before each launch: it sets the attribute the first
// time a device needs at least `bytes`, and returns at once while the limit
// already granted there covers the request. A failed call is not
// remembered: every later launch tries again and returns the error.

#pragma once

#include <cuda_runtime.h>

#include <atomic>

struct SmemLimit {
  static constexpr int kDevices = 64;
  std::atomic<int> granted[kDevices]{};     // bytes granted on each device

  cudaError_t raise(const void* kernel, int bytes) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const bool tracked = dev >= 0 && dev < kDevices;
    if (tracked && granted[dev].load(std::memory_order_relaxed) >= bytes) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess && tracked) {
      int prev = granted[dev].load(std::memory_order_relaxed);
      while (prev < bytes && !granted[dev].compare_exchange_weak(prev, bytes)) {
      }
    }
    return err;
  }
};
