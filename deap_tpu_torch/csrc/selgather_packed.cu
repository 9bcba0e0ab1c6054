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
// Design: one thread per child slot; the draws are read coalesced, the
// fitness lookups hit the 400 KB fitness vector (L2-resident at 100k),
// and the winner's W words are copied row-major. The TPU kernel's
// lane-major [W, n] layout existed only to keep VMEM dense and is not
// used here.
//
// The Philox path (selgather_hw_kernel, replacing _selgather_kernel_hw of
// deap_tpu/ops/packed.py) draws child j's aspirants in registers from the
// key (csrc/philox.cuh: (j, t / 4, 0, kTournament), one call for a
// tournament of up to 4); its plain version is the bits-input plain
// version fed ops/philox.py::hw_tournament_bits. Bound there: bytes of the
// parents' and output rows and the fitness reads.
#include "common.cuh"
#include "philox.cuh"

namespace {

__global__ void __launch_bounds__(256)
selgather_kernel(const uint32_t* __restrict__ g, const float* __restrict__ fit,
                 const uint32_t* __restrict__ draws, uint32_t* __restrict__ out,
                 int n, int W, int tournsize) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const uint32_t un = static_cast<uint32_t>(n);
  uint32_t best = draws[j] % un;
  float best_fit = fit[best];
  for (int t = 1; t < tournsize; ++t) {
    const uint32_t idx = draws[static_cast<size_t>(t) * n + j] % un;
    const float f = fit[idx];
    if (f > best_fit) {
      best = idx;
      best_fit = f;
    }
  }
  const uint32_t* src = g + static_cast<size_t>(best) * W;
  uint32_t* dst = out + static_cast<size_t>(j) * W;
  for (int w = 0; w < W; ++w) dst[w] = src[w];
}

__global__ void __launch_bounds__(256)
selgather_hw_kernel(const uint32_t* __restrict__ g,
                    const float* __restrict__ fit,
                    const uint32_t* __restrict__ key_ptr,
                    uint32_t* __restrict__ out, int n, int W, int tournsize) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const uint32_t best =
      hw_tournament(fit, j, 0u, n, tournsize, round_keys(load_key(key_ptr)));
  const uint32_t* src = g + static_cast<size_t>(best) * W;
  uint32_t* dst = out + static_cast<size_t>(j) * W;
  for (int w = 0; w < W; ++w) dst[w] = src[w];
}

}  // namespace

extern "C" int selgather_packed(const void* g, const void* fit,
                                const void* draws, void* out, int n, int W,
                                int tournsize, void* stream) {
  const int threads = 256;
  const int blocks = grid_for(n, threads, 1 << 30);
  selgather_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(g), static_cast<const float*>(fit),
      static_cast<const uint32_t*>(draws), static_cast<uint32_t*>(out), n, W,
      tournsize);
  return static_cast<int>(cudaGetLastError());
}

// The Philox path: key is uint32[2] on the card.
extern "C" int selgather_packed_hw(const void* g, const void* fit,
                                   const void* key, void* out, int n, int W,
                                   int tournsize, void* stream) {
  const int threads = 256;
  const int blocks = grid_for(n, threads, 1 << 30);
  selgather_hw_kernel<<<blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(g), static_cast<const float*>(fit),
      static_cast<const uint32_t*>(key), static_cast<uint32_t*>(out), n, W,
      tournsize);
  return static_cast<int>(cudaGetLastError());
}
