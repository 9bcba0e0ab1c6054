// One OneMax generation on byte (bool) or float32 genomes: adjacent-pair
// two-point crossover, flip-bit mutation, sum-of-genes fitness.
//
// Replaces deap_tpu/ops/kernels.py::fused_variation_eval (Pallas body
// _variation_body, bits-input path _fused_kernel_bits, plumbing
// run_fused_kernel). The plain version is
// deap_tpu_torch/ops/kernels.py::fused_variation_eval_plain. Random bits
// come in as uint32 streams in the TPU kernel's input layout without its
// padding: pairbits [n, 4] (the even row of each pair supplies both rows'
// crossover draws), rowbits [n, 1], genebits [n, L].
//
// The draw rules are the packed kernel's (csrc/packed_variation.cu): an
// odd last row never mates; p1 = 1 + int(u * L), p2 = 1 + int(u * (L-1))
// bumped past p1, segment [min, max); a gene flips where u < indpb in a
// row with rowu < mutpb; a float gene flips as 1 - x.
//
// Bound on the H100: bytes. The gene-bit stream is 4 bytes per gene, 4x a
// byte genome; a row that does not mutate needs none of it.
//
// Design: one warp per row, its lanes over the genes (L 100 is 4 strided
// passes), so the row, its partner and its gene bits are read coalesced.
// The partner row is read only where the pair mates and the gene bits only
// where the row mutates, so the kernel moves only the bytes this
// generation's draws need. The fitness is a warp sum of per-lane sums:
// exact for 0/1 genes in any order.
#include "common.cuh"

namespace {

__device__ __forceinline__ uint8_t flip(uint8_t x) { return x == 0; }
__device__ __forceinline__ float flip(float x) { return 1.0f - x; }
__device__ __forceinline__ float value(uint8_t x) { return x ? 1.0f : 0.0f; }
__device__ __forceinline__ float value(float x) { return x; }

template <typename T>
__global__ void __launch_bounds__(256)
fused_variation_eval_kernel(const T* __restrict__ g,
                            const uint32_t* __restrict__ pairbits,
                            const uint32_t* __restrict__ rowbits,
                            const uint32_t* __restrict__ genebits,
                            T* __restrict__ out, float* __restrict__ fit, int n,
                            int L, float cxpb, float mutpb, float indpb) {
  const int lane = threadIdx.x & 31;
  const int warps = (gridDim.x * blockDim.x) >> 5;
  // r is the same for every lane of a warp, so the warp stays converged
  for (int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; r < n;
       r += warps) {
    const uint32_t* pb = pairbits + static_cast<size_t>(r & ~1) * 4;
    const bool do_cx = (r | 1) < n && u01(pb[0]) < cxpb;
    int lo = 0, hi = 0;
    if (do_cx) {
      const int p1 = 1 + static_cast<int>(u01(pb[1]) * static_cast<float>(L));
      int p2 = 1 + static_cast<int>(u01(pb[2]) * static_cast<float>(L - 1));
      if (p2 >= p1) p2 += 1;
      lo = min(p1, p2);
      hi = max(p1, p2);
    }
    const bool do_mut = u01(rowbits[r]) < mutpb;
    const size_t base = static_cast<size_t>(r) * L;
    const T* mate = g + static_cast<size_t>(r ^ 1) * L;
    float sum = 0.0f;
    for (int c = lane; c < L; c += 32) {
      T x = (do_cx && c >= lo && c < hi) ? mate[c] : g[base + c];
      if (do_mut && u01(genebits[base + c]) < indpb) x = flip(x);
      out[base + c] = x;
      sum += value(x);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    }
    if (lane == 0) fit[r] = sum;
  }
}

template <typename T>
int launch(const void* g, const void* pairbits, const void* rowbits,
           const void* genebits, void* out, void* fit, int n, int L,
           float cxpb, float mutpb, float indpb, void* stream) {
  const int threads = 256;  // 8 rows per block
  const int blocks = grid_for(static_cast<long long>(n) * 32, threads,
                              132 * 64);
  fused_variation_eval_kernel<T><<<blocks, threads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(g), static_cast<const uint32_t*>(pairbits),
      static_cast<const uint32_t*>(rowbits),
      static_cast<const uint32_t*>(genebits), static_cast<T*>(out),
      static_cast<float*>(fit), n, L, cxpb, mutpb, indpb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Genomes of bool (one byte, 0 or 1).
extern "C" int fused_variation_eval_u8(const void* g, const void* pairbits,
                                       const void* rowbits,
                                       const void* genebits, void* out,
                                       void* fit, int n, int L, float cxpb,
                                       float mutpb, float indpb,
                                       void* stream) {
  return launch<uint8_t>(g, pairbits, rowbits, genebits, out, fit, n, L, cxpb,
                         mutpb, indpb, stream);
}

// Genomes of float32.
extern "C" int fused_variation_eval_f32(const void* g, const void* pairbits,
                                        const void* rowbits,
                                        const void* genebits, void* out,
                                        void* fit, int n, int L, float cxpb,
                                        float mutpb, float indpb,
                                        void* stream) {
  return launch<float>(g, pairbits, rowbits, genebits, out, fit, n, L, cxpb,
                       mutpb, indpb, stream);
}
