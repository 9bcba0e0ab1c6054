// Shared helpers of the port's kernels. Each .cu file under csrc/ is built
// on its own into a shared library with a plain C interface and loaded
// with ctypes (deap_tpu_torch/_build.py); every exported launcher returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* dtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Enough blocks to cover `work` items at `threads` per block, capped for
// grid-stride loops.
static inline int grid_for(long long work, int threads, int cap) {
  long long blocks = (work + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  return static_cast<int>(blocks < cap ? blocks : cap);
}

// uint32 bits -> U[0, 1) float32 from the top 24 bits, exactly as
// deap_tpu/ops/kernels.py::_u01 (an int32 route, times 2^-24: exact).
__device__ __forceinline__ float u01(uint32_t bits) {
  return static_cast<float>(static_cast<int>(bits >> 8)) * (1.0f / 16777216.0f);
}

// The integer form of u01(bits) < p: u01(bits) < p exactly where
// (bits >> 8) < u01_threshold(p), since u01 is (bits >> 8) 2^-24 with no
// rounding and p 2^24 is exact in float32 (NaN and p <= 0 never hit, p >= 1
// always does).
__device__ __forceinline__ uint32_t u01_threshold(float p) {
  if (!(p > 0.0f)) return 0u;
  if (p >= 1.0f) return 1u << 24;
  return static_cast<uint32_t>(ceilf(p * 16777216.0f));
}

// uint32 with bits [0, clip(k, 0, 32)) set (deap_tpu/ops/packed.py::_bits_below).
__device__ __forceinline__ uint32_t bits_below(int k) {
  if (k >= 32) return 0xFFFFFFFFu;
  if (k <= 0) return 0u;
  return (1u << k) - 1u;
}
