// Tournament selection of n parents plus the gather of their packed rows.
//
// Replaces deap_tpu/ops/packed.py::sel_tournament_gather_packed (Pallas
// body _selgather_body / _tournament_idx, bits-input path). The plain
// version is deap_tpu_torch/ops/packed.py::sel_tournament_gather_packed_plain.
// Aspirant t of child slot j is draws[t, j] % n (the modulo bias is part
// of the stream); a strictly greater fitness replaces the best so far, so
// the first-drawn aspirant wins ties.
//
// Bound on the H100: bytes — the draws, the parents' rows and the output
// rows, plus tournsize random 4-byte fitness reads per child.
//
// Design: one thread per child slot runs its tournament, 4 aspirants at a
// time (philox.cuh::tournament, which the Philox path shares): their draw
// loads issued together (coalesced across the warp), then their fitness
// loads together (the 400 KB fitness vector), then the compares in draw
// order, so a tournament of up to 4 waits two round trips before its row
// copy instead of two an aspirant. The winners' rows are then copied whole
// (copy_rows): as uint4 where W % 4 == 0 and both row arrays are 16-byte
// aligned (W 4 at L 100: a warp's store writes its 32 children's 512
// contiguous bytes in one instruction), else warp by warp: the warp's 32
// winners are shared by shuffles and its lanes walk (child, word) over the
// warp's 32 W contiguous output words, so each store instruction writes 32
// contiguous words. The TPU kernel's lane-major [W, n] layout existed only
// to keep VMEM dense and is not used here.
//
// The Philox path (selgather_hw_kernel, replacing _selgather_kernel_hw of
// deap_tpu/ops/packed.py) draws child j's aspirants in registers from the
// key (csrc/philox.cuh::hw_tournament: (j, t / 4, 0, kTournament), one
// call for each 4 aspirants, their fitness loads issued together); its
// plain version is the bits-input plain version fed
// ops/philox.py::hw_tournament_bits. Bound there: bytes of the parents'
// and output rows and the fitness reads. What is left above a copy of the
// output's bytes is the dependent round trips: the winner's row can be
// loaded only once its fitness loads are back. Loading every aspirant's
// row with its fitness (W 4) reads 3 rows a child and ran slower; an L2
// prefetch of each child's own fitness word and row, issued under its
// draws, shortened a call after an L2 flush but lengthened one that finds
// its inputs in L2, as the packed loop does (PERF.md §6).
#include "common.cuh"
#include "philox.cuh"

namespace {

// Child j's row := row `best` of g, for the block's children (every thread
// of the block calls it; `valid` is j < n).
template <bool kVec4>
__device__ __forceinline__ void copy_rows(const uint32_t* __restrict__ g,
                                          uint32_t* __restrict__ out,
                                          uint32_t best, int j, bool valid,
                                          int n, int W) {
  if constexpr (kVec4) {
    if (!valid) return;
    const uint4* src = reinterpret_cast<const uint4*>(
        g + static_cast<size_t>(best) * W);
    uint4* dst = reinterpret_cast<uint4*>(out + static_cast<size_t>(j) * W);
    for (int w = 0; w < W / 4; ++w) dst[w] = src[w];
  } else {
    const int lane = threadIdx.x & 31;
    const int j0 = j - lane;  // the warp's first child
    const int words = min(32, n - j0) * W;
    uint32_t* dst = out + static_cast<size_t>(j0) * W;
    // word f = lane + 32 i of the warp's output is word f % W of child
    // f / W, advanced by 32 without a division a step
    int child = lane / W, w = lane - child * W;
    const int dchild = 32 / W, dw = 32 - dchild * W;
    for (int f = 0; f < words; f += 32) {  // the same trip count a lane
      const uint32_t src = __shfl_sync(0xffffffffu, best, child & 31);
      if (f + lane < words) dst[f + lane] = g[static_cast<size_t>(src) * W + w];
      child += dchild;
      w += dw;
      if (w >= W) {
        w -= W;
        ++child;
      }
    }
  }
}

// Aspirants 4 call .. 4 call + 3 of child j, draws[t, j] % n (those past
// tournsize read as fitness 0 and never compared): the draw loads issued
// together, then the fitness loads together.
__device__ __forceinline__ Aspirants loaded_aspirants(
    const float* __restrict__ fit, const uint32_t* __restrict__ draws, int j,
    int call, int n, int tournsize) {
  const uint32_t un = static_cast<uint32_t>(n);
  uint32_t d[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int t = 4 * call + k;
    d[k] = t < tournsize ? draws[static_cast<size_t>(t) * n + j] : 0u;
  }
  Aspirants a = {{d[0] % un, d[1] % un, d[2] % un, d[3] % un}, {}};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    a.fit[k] = 4 * call + k < tournsize ? fit[a.idx[k]] : 0.0f;
  return a;
}

template <bool kVec4>
__global__ void __launch_bounds__(256)
selgather_kernel(const uint32_t* __restrict__ g, const float* __restrict__ fit,
                 const uint32_t* __restrict__ draws, uint32_t* __restrict__ out,
                 int n, int W, int tournsize) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = j < n;
  if (!kVec4 && j - (threadIdx.x & 31) >= n) return;  // a whole warp past n
  uint32_t best = 0u;
  if (valid) {
    best = tournament(loaded_aspirants(fit, draws, j, 0, n, tournsize),
                      tournsize, [&](int call) {
                        return loaded_aspirants(fit, draws, j, call, n,
                                                tournsize);
                      });
  }
  copy_rows<kVec4>(g, out, best, j, valid, n, W);
}

template <bool kVec4>
__global__ void __launch_bounds__(256)
selgather_hw_kernel(const uint32_t* __restrict__ g,
                    const float* __restrict__ fit,
                    const uint32_t* __restrict__ key_ptr,
                    uint32_t* __restrict__ out, int n, int W, int tournsize) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = j < n;
  if (!kVec4 && j - (threadIdx.x & 31) >= n) return;  // a whole warp past n
  uint32_t best = 0u;
  if (valid) {
    best = hw_tournament(fit, j, 0u, n, tournsize,
                         round_keys(load_key(key_ptr)));
  }
  copy_rows<kVec4>(g, out, best, j, valid, n, W);
}

// uint4 rows where every row starts 16-byte aligned in both arrays
bool vec4_rows(const void* g, const void* out, int W) {
  return W % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

}  // namespace

extern "C" int selgather_packed(const void* g, const void* fit,
                                const void* draws, void* out, int n, int W,
                                int tournsize, void* stream) {
  const int threads = 256;
  const int blocks = grid_for(n, threads, 1 << 30);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* gp = static_cast<const uint32_t*>(g);
  const auto* fp = static_cast<const float*>(fit);
  const auto* dp = static_cast<const uint32_t*>(draws);
  auto* op = static_cast<uint32_t*>(out);
  if (vec4_rows(g, out, W)) {
    selgather_kernel<true><<<blocks, threads, 0, st>>>(gp, fp, dp, op, n, W,
                                                       tournsize);
  } else {
    selgather_kernel<false><<<blocks, threads, 0, st>>>(gp, fp, dp, op, n, W,
                                                        tournsize);
  }
  return static_cast<int>(cudaGetLastError());
}

// The Philox path: key is uint32[2] on the card.
extern "C" int selgather_packed_hw(const void* g, const void* fit,
                                   const void* key, void* out, int n, int W,
                                   int tournsize, void* stream) {
  const int threads = 256;
  const int blocks = grid_for(n, threads, 1 << 30);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* gp = static_cast<const uint32_t*>(g);
  const auto* fp = static_cast<const float*>(fit);
  const auto* kp = static_cast<const uint32_t*>(key);
  auto* op = static_cast<uint32_t*>(out);
  if (vec4_rows(g, out, W)) {
    selgather_hw_kernel<true><<<blocks, threads, 0, st>>>(gp, fp, kp, op, n,
                                                          W, tournsize);
  } else {
    selgather_hw_kernel<false><<<blocks, threads, 0, st>>>(gp, fp, kp, op, n,
                                                           W, tournsize);
  }
  return static_cast<int>(cudaGetLastError());
}
