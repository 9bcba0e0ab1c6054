// A measuring kernel, not on any path of the port: the clocks of one
// dependent shared-memory load, the unit of J2's chain floor (one ant's
// walk, csrc/ant_rollout.cu, is a chain of such loads). chip_smoke.py
// builds it beside the kernels (it is not in _build.SOURCES).
//
// One thread follows `loads` dependent loads around a cycle of 1024 words
// (a stride of 33, so every load is a new bank) and reports the clocks
// they took.

#include "common.cuh"

namespace {

__global__ void shared_chase_kernel(int loads, long long* clocks, int* sink) {
  __shared__ int next[1024];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x)
    next[i] = (i + 33) & 1023;
  __syncthreads();
  if (threadIdx.x != 0) return;
  int p = 0;
  const long long t0 = clock64();
#pragma unroll 8
  for (int i = 0; i < loads; ++i) p = next[p];
  const long long t1 = clock64();
  clocks[0] = t1 - t0;
  sink[0] = p;
}

}  // namespace

// clocks int64[1] out: the clocks of `loads` dependent shared-memory loads
// of one thread; sink int32[1] out. One launch on `stream`.
extern "C" int shared_chase(int loads, void* clocks, void* sink,
                            void* stream) {
  if (loads < 1) return static_cast<int>(cudaErrorInvalidValue);
  shared_chase_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      loads, static_cast<long long*>(clocks), static_cast<int*>(sink));
  return static_cast<int>(cudaGetLastError());
}
