// One OneMax generation on bit-packed genomes (32 genes per uint32 word):
// adjacent-pair two-point crossover, flip-bit mutation, popcount fitness.
//
// Replaces deap_tpu/ops/packed.py::fused_variation_eval_packed (Pallas
// body _packed_body, bits-input path _packed_kernel_bits). The plain
// version is deap_tpu_torch/ops/packed.py::fused_variation_eval_packed_plain.
// Random bits come in as uint32 streams in the TPU kernel's input layout:
// pairbits [n, 4] (the even row of each pair supplies both rows' draws),
// rowbits [n, 1], genebits [n, 32 W] with bit plane b of word j in
// column b * W + j.
//
// Bound on the H100: bytes. The gene-bit stream is 32 uint32 per word,
// 16x the genomes; a row that does not mutate (mutpb) needs none of it,
// and a row that does needs the L planes of its real genes.
//
// Design: one thread per row. The row's words stay in registers; the
// crossover segment of each word is the mask bits_below(hi - 32 j) &
// ~bits_below(lo - 32 j); flip words are assembled from the 32 bit-plane
// columns by shifts and ors (the TPU folded them with two MXU matmuls, a
// TPU workaround that gives the same bits) from the planes of genes below
// L only, so the tail beyond L never flips;
// fitness is __popc summed. The partner row (r ^ 1) is read only when the
// pair mates and the gene bits only when the row mutates, so the kernel
// moves only the bytes this generation's draws need.
//
// The Philox path (packed_variation_hw_kernel, replacing _packed_kernel_hw
// of deap_tpu/ops/packed.py) makes the draws in registers from the key
// (csrc/philox.cuh, g = 0): each thread one pair+row call for its own row,
// the odd row of a pair taking the crossover words from its even
// neighbour's lane by a shuffle, and 8 gene calls per word of a row that
// mutates (fewer for the last word: only genes below L). Its plain version
// is the bits-input plain version fed ops/philox.py::hw_packed_bits. Bound
// there: bytes of the rows in and out (no draw touches memory).
#include "common.cuh"
#include "philox.cuh"

namespace {

__global__ void __launch_bounds__(256)
packed_variation_kernel(const uint32_t* __restrict__ g,
                        const uint32_t* __restrict__ pairbits,
                        const uint32_t* __restrict__ rowbits,
                        const uint32_t* __restrict__ genebits,
                        uint32_t* __restrict__ out, float* __restrict__ fit,
                        int n, int W, int L, float cxpb, float mutpb,
                        float indpb) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const uint32_t* pb = pairbits + static_cast<size_t>(r & ~1) * 4;
  const bool has_partner = (r | 1) < n;  // an odd last row never mates
  const bool do_cx = has_partner && u01(pb[0]) < cxpb;
  int lo = 0, hi = 0;
  if (do_cx) {
    // p1 ~ U{1..L}, p2 ~ U{1..L-1} bumped past p1; f32 products as on the TPU
    const int p1 = 1 + static_cast<int>(u01(pb[1]) * static_cast<float>(L));
    int p2 = 1 + static_cast<int>(u01(pb[2]) * static_cast<float>(L - 1));
    if (p2 >= p1) p2 += 1;
    lo = min(p1, p2);
    hi = max(p1, p2);
  }
  const bool do_mut = u01(rowbits[r]) < mutpb;
  const uint32_t* self = g + static_cast<size_t>(r) * W;
  const uint32_t* mate = g + static_cast<size_t>(r ^ 1) * W;
  const uint32_t* gb = genebits + static_cast<size_t>(r) * 32 * W;
  uint32_t* dst = out + static_cast<size_t>(r) * W;
  int count = 0;
  for (int j = 0; j < W; ++j) {
    const int start = 32 * j;
    uint32_t child = self[j];
    if (do_cx) {
      const uint32_t seg = bits_below(hi - start) & ~bits_below(lo - start);
      child = (child & ~seg) | (mate[j] & seg);
    }
    if (do_mut) {
      // only the planes of real genes: bits past gene L never flip
      const int nb = min(32, L - start);
      uint32_t flip = 0u;
#pragma unroll 8
      for (int b = 0; b < nb; ++b) {
        flip |= static_cast<uint32_t>(u01(gb[b * W + j]) < indpb) << b;
      }
      child ^= flip;
    }
    dst[j] = child;
    count += __popc(child);
  }
  fit[r] = static_cast<float>(count);
}

__global__ void __launch_bounds__(256)
packed_variation_hw_kernel(const uint32_t* __restrict__ g,
                           const uint32_t* __restrict__ key_ptr,
                           uint32_t* __restrict__ out, float* __restrict__ fit,
                           int n, int W, int L, float cxpb, float mutpb,
                           float indpb) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const uint2 key = load_key(key_ptr);
  // blockDim.x is a multiple of 32, so the rows of a pair sit in lanes
  // (2k, 2k + 1) of one warp; every lane draws before any leaves
  const uint4 own = draw(static_cast<uint32_t>(r), 0u, 0u, kPairRow, key);
  const int even = (threadIdx.x & 31) & ~1;
  const uint32_t cx_word = __shfl_sync(0xffffffffu, own.x, even);
  const uint32_t u1 = __shfl_sync(0xffffffffu, own.y, even);
  const uint32_t u2 = __shfl_sync(0xffffffffu, own.z, even);
  if (r >= n) return;
  const bool do_cx = (r | 1) < n && u01(cx_word) < cxpb;
  int lo = 0, hi = 0;
  if (do_cx) cut_segment(u1, u2, L, &lo, &hi);
  const bool do_mut = u01(own.w) < mutpb;
  const uint32_t gene_below = u01_threshold(indpb);
  const uint32_t* self = g + static_cast<size_t>(r) * W;
  const uint32_t* mate = g + static_cast<size_t>(r ^ 1) * W;
  uint32_t* dst = out + static_cast<size_t>(r) * W;
  int count = 0;
  for (int j = 0; j < W; ++j) {
    const int start = 32 * j;
    uint32_t child = self[j];
    if (do_cx) {
      const uint32_t seg = bits_below(hi - start) & ~bits_below(lo - start);
      child = (child & ~seg) | (mate[j] & seg);
    }
    if (do_mut) child ^= hw_flip_word(r, j, 0u, L, gene_below, key);
    dst[j] = child;
    count += __popc(child);
  }
  fit[r] = static_cast<float>(count);
}

}  // namespace

extern "C" int packed_variation(const void* g, const void* pairbits,
                                const void* rowbits, const void* genebits,
                                void* out, void* fit, int n, int W, int L,
                                float cxpb, float mutpb, float indpb,
                                void* stream) {
  const int threads = 256;
  const int blocks = grid_for(n, threads, 1 << 30);
  packed_variation_kernel<<<blocks, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(g), static_cast<const uint32_t*>(pairbits),
      static_cast<const uint32_t*>(rowbits),
      static_cast<const uint32_t*>(genebits), static_cast<uint32_t*>(out),
      static_cast<float*>(fit), n, W, L, cxpb, mutpb, indpb);
  return static_cast<int>(cudaGetLastError());
}

// The Philox path: key is uint32[2] on the card.
extern "C" int packed_variation_hw(const void* g, const void* key, void* out,
                                   void* fit, int n, int W, int L, float cxpb,
                                   float mutpb, float indpb, void* stream) {
  const int threads = 256;
  const int blocks = grid_for(n, threads, 1 << 30);
  packed_variation_hw_kernel<<<blocks, threads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(g), static_cast<const uint32_t*>(key),
      static_cast<uint32_t*>(out), static_cast<float*>(fit), n, W, L, cxpb,
      mutpb, indpb);
  return static_cast<int>(cudaGetLastError());
}
