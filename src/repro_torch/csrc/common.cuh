// Shared helpers of the port's CUDA kernels (built with nvcc for sm_90a).
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

constexpr int kThreads = 256;  // threads per block of the row-parallel kernels

inline unsigned grid_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace repro
