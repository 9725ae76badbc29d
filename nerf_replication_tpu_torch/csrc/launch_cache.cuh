// Host side of a persistent kernel's launch, shared by the kernels that
// stage their weights in dynamic shared memory (nerf_mlp_tile.cuh's 8x256
// MLP kernels, fused_ngp.cu).

#pragma once

#include <cuda_runtime.h>

namespace nerf {

// What a persistent kernel's launches keep of each device: its
// SM count and the dynamic shared-memory limit already raised for the
// kernel, so that a launch asks the runtime for neither again.
struct LaunchCache {
  static constexpr int kMaxDevices = 64;
  int sms[kMaxDevices] = {};
  int raised[kMaxDevices] = {};
};

// Before a launch of `kernel` with `smem` bytes of dynamic shared memory on
// the current device: raises the kernel's limit to that unless the cache
// says it was, and gives the device's SM count. Returns a CUDA error code.
template <typename Kernel>
cudaError_t prepare_launch(LaunchCache& cache, Kernel kernel, size_t smem,
                           int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= LaunchCache::kMaxDevices) return cudaErrorInvalidDevice;
  if (cache.sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&cache.sms[dev],
                                 cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  if (cache.raised[dev] < static_cast<int>(smem)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    cache.raised[dev] = static_cast<int>(smem);
  }
  *sms = cache.sms[dev];
  return cudaSuccess;
}

}  // namespace nerf
