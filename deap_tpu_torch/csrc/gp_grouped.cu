// K9 gp_grouped_dispatch: opcode-major GP evaluation.
//
// Replaces deap_tpu/ops/kernels.py::gp_grouped_dispatch (the Pallas
// fused gather-dispatch-scatter of gp/interpreter.py mode='grouped').
// The plain version is deap_tpu_torch/ops/kernels.py::
// gp_grouped_dispatch_plain, the JAX package's chunk loop.
//
// For every instruction row r of the schedule, with branch
// b = chunk_ops[r / chunk] and device op ops.code[b]:
//     buf[n_args + r, p] = op(x_0, ..., x_{ar-1}) for every point p,
//     x_j = src_isc[r, j] ? src_const[r, j] : buf[src_idx[r, j], p].
// The constant REPLACES the gathered value (a select, so a NaN or inf in
// a gathered row never leaks through the constant path), and operand
// slots past the op's arity are not read. The ops are the closed table
// of deap_tpu_torch/gp/pset.py::DEVICE_OPS, with IEEE division and
// cosf/sinf: this file must not be built with --use_fast_math.
//
// Bound on the H100: bytes. Each non-constant operand row read once,
// each instruction row (pad rows too) written once, the schedule arrays
// read once, at 3.35 TB/s; a few flops per element.
//
// Ordering. The TPU kernel runs its chunks as grid steps, in order, so
// a chunk may read the rows of any earlier chunk. CUDA blocks run in no
// order. The schedule sorts instructions by (depth desc, opcode) and a
// child is strictly deeper than its parent, so each depth level is a
// contiguous run of chunks that reads only argument rows and rows of
// earlier levels. The launcher therefore launches once per level, on one
// stream, in order; within a level every (row, point) is independent.
// The pad chunks at the end read only argument row 0 and share the last
// launch. Threads are laid out point-fastest, so a warp shares one row
// (one opcode) when P >= 32 and its loads and stores coalesce; many
// levels hold a few chunks only, so parallelism comes from rows x
// points, not from chunks.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BRANCHES = 16;

// The device op of each branch, passed by value with the launch (kernel
// parameters sit in constant memory), so no table is uploaded per call.
// It is read only at constant indices (code_of): indexing it with a
// variable would copy it to every thread's local memory.
struct BranchOps {
  int code[MAX_BRANCHES];
};

__device__ __forceinline__ int code_of(const BranchOps& ops, int b) {
  int code = -1;  // a bad branch
#pragma unroll
  for (int i = 0; i < MAX_BRANCHES; ++i) code = (i == b) ? ops.code[i] : code;
  return code;
}

__device__ __forceinline__ int op_arity(int code) {
  switch (code) {
    case 0: case 5: case 6: case 7: case 10: return 1;
    case 1: case 2: case 3: case 4: case 8: case 9: case 11: return 2;
    case 12: return 3;
    default: return 0;
  }
}

__device__ __forceinline__ float apply_op(int code, float a, float b,
                                          float c) {
  switch (code) {
    case 0: return a;                             // identity
    case 1: return a + b;                         // add
    case 2: return a - b;                         // sub
    case 3: return a * b;                         // mul
    case 4: return b == 0.0f ? 1.0f : a / b;      // protectedDiv
    case 5: return -a;                            // neg
    case 6: return cosf(a);                       // cos
    case 7: return sinf(a);                       // sin
    case 8: return a * b;                         // and
    case 9: {                                     // or: min(a + b, 1),
      const float s = a + b;                      // NaN propagates
      return s > 1.0f ? 1.0f : s;
    }
    case 10: return 1.0f - a;                     // not
    case 11: return fabsf(a - b);                 // xor
    case 12: return a > 0.5f ? b : c;             // if_then_else
    default: return __int_as_float(0x7fc00000);   // a bad branch: NaN
  }
}

__global__ void __launch_bounds__(THREADS)
gp_level_kernel(float* __restrict__ buf, const int* __restrict__ chunk_ops,
                const __grid_constant__ BranchOps ops,
                const int* __restrict__ src_idx,
                const float* __restrict__ src_const,
                const uint8_t* __restrict__ src_isc, int n_args, int nrows,
                int P, int max_ar, int chunk, long long row_begin,
                long long row_end) {
  const long long work = (row_end - row_begin) * P;
  for (long long e = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
       e < work; e += static_cast<long long>(gridDim.x) * THREADS) {
    const long long k = e / P;
    const int p = static_cast<int>(e - k * P);
    const long long r = row_begin + k;
    const int code = code_of(ops, chunk_ops[r / chunk]);
    const int ar = op_arity(code);
    float x[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (j >= ar || j >= max_ar) continue;
      const long long s = r * max_ar + j;
      if (src_isc[s]) {
        x[j] = src_const[s];
      } else {
        const int row = src_idx[s];
        // the schedule keeps every index in range; a bad one gives NaN
        // instead of a read out of bounds
        x[j] = (row >= 0 && row < nrows)
                   ? buf[static_cast<long long>(row) * P + p]
                   : __int_as_float(0x7fc00000);
      }
    }
    buf[(n_args + r) * P + p] = apply_op(code, x[0], x[1], x[2]);
  }
}

}  // namespace

// levels[0..nlevels] are chunk indices: level l covers chunks
// [levels[l], levels[l+1]). branch_ops[0..nbranches) are host ints, the
// device op of each branch. One launch per level, in order, on `stream`.
extern "C" int gp_grouped_dispatch(void* buf, const void* chunk_ops,
                                   const int* branch_ops, const void* src_idx,
                                   const void* src_const, const void* src_isc,
                                   const int* levels, int nlevels, int n_args,
                                   int nrows, int P, int max_ar, int chunk,
                                   int nbranches, void* stream) {
  if (P < 1 || chunk < 1 || max_ar < 1 || nlevels < 1 || nbranches < 1 ||
      nbranches > MAX_BRANCHES)
    return static_cast<int>(cudaErrorInvalidValue);
  BranchOps ops;
  for (int b = 0; b < MAX_BRANCHES; ++b)
    ops.code[b] = b < nbranches ? branch_ops[b] : -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int l = 0; l < nlevels; ++l) {
    const long long r0 = static_cast<long long>(levels[l]) * chunk;
    const long long r1 = static_cast<long long>(levels[l + 1]) * chunk;
    const dim3 grid(grid_for((r1 - r0) * P, THREADS, 1 << 30));
    gp_level_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<float*>(buf), static_cast<const int*>(chunk_ops), ops,
        static_cast<const int*>(src_idx),
        static_cast<const float*>(src_const),
        static_cast<const uint8_t*>(src_isc), n_args, nrows, P, max_ar, chunk,
        r0, r1);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
