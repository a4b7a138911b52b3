// DeviceScope: makes `device` current for a launch and restores the caller's
// device; shared by the kernels' plain C entry points.
#pragma once

#include <cuda_runtime.h>

namespace {

struct DeviceScope {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceScope(int device) {
    int cur = 0;
    err = cudaGetDevice(&cur);
    if (err == cudaSuccess && cur != device) {
      err = cudaSetDevice(device);
      prev = cur;
    }
  }
  ~DeviceScope() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

}  // namespace
