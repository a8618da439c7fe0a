// The device guard every plain C entry point of the port's kernels
// takes before it launches (sw_forward.cu, join.cu).
#pragma once

#include <cuda_runtime.h>

namespace kslam {

// Makes `device` current for a launch and gives the caller back its own
// current device afterwards: PyTorch's "cuda" means the current device,
// so a launch on another card of a mesh must not change it.
struct DeviceGuard {
  int prev = -1;
  cudaError_t err;
  explicit DeviceGuard(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

}  // namespace kslam
