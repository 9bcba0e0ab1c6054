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
// (csrc/philox.cuh, g = 0): each row one pair+row call, the odd row of a
// pair taking the crossover words from its even neighbour's lane by a
// shuffle, and ceil(L / 4) gene calls for a row that mutates (the 4 flip
// bits of call q at genes 4q .. 4q + 3, the genes past L clear). Its plain
// version is the bits-input plain version fed
// ops/philox.py::hw_packed_bits. Bound on the H100: the integer multiplies
// of the Philox calls (40 each; 1.42 us at n 100k, L 100, mutpb 0.2),
// above the bytes of the rows in and out (no draw touches memory).
//
// Its design is K5-hw's tile (csrc/tile_worklist.cuh): a block of 256
// rows, one thread per row. The first design gave each mutating row's
// thread its own 25 gene calls in series; ~20% of rows mutate, so almost
// every warp held one and paid 1 + 25 call slots, 4.3x the issue the work
// needs. The tile lists its mutating rows in shared memory and spreads
// their gene calls over all 256 threads (~5 a thread at L 100). The row
// loads as uint4 (W % 4 == 0, aligned) before the gene calls, so the load
// is in flight while they run, and the partner's words come from the
// adjacent lane by a shuffle instead of a second read from memory.
// On an H100 (700 W) it takes ~11.6 us at n 100k, L 100 (16.7 before),
// after an L2 flush, where a torch copy of the same 1.6 MB genomes takes
// ~9.4 us: the cold genome bytes, not the Philox calls, hold it.
#include "common.cuh"
#include "philox.cuh"
#include "tile_worklist.cuh"

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

constexpr int kTile = 256;     // rows of a tile (a block), one a thread
constexpr int kFlipWords = 8;  // flip words of a work-list chunk (256 genes)

__global__ void __launch_bounds__(kTile)
packed_variation_hw_kernel(const uint32_t* __restrict__ g,
                           const uint32_t* __restrict__ key_ptr,
                           uint32_t* __restrict__ out, float* __restrict__ fit,
                           int n, int W, int L, float cxpb, float mutpb,
                           float indpb) {
  // flip words of the tile's rows, word-major (conflict-free reads)
  __shared__ uint32_t flips[kFlipWords * kTile];
  __shared__ int slots[kTile];
  __shared__ int warp_counts[kTile / 32];
  const RoundKeys key = round_keys(load_key(key_ptr));
  const int tid = threadIdx.x;
  const uint32_t row0 = static_cast<uint32_t>(blockIdx.x) * kTile;
  const int r = static_cast<int>(row0) + tid;
  const bool valid = r < n;
  const int calls = (L + 3) >> 2;  // gene calls of a mutating row
  // rows of whole uint4s, aligned: one 16-byte load or store a row chunk
  const bool vec4 = W % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  // row r's pair+row call: words 0-2 of the even row decide the pair's
  // crossover (the rows of a pair sit in lanes 2k, 2k + 1 of one warp),
  // word 3 this row's mutation; every lane draws, valid or not
  const uint4 own = draw(static_cast<uint32_t>(r), 0u, 0u, kPairRow, key);
  const int even = (tid & 31) & ~1;
  const uint32_t cx = __shfl_sync(0xffffffffu, own.x, even);
  const uint32_t u1 = __shfl_sync(0xffffffffu, own.y, even);
  const uint32_t u2 = __shfl_sync(0xffffffffu, own.z, even);
  const bool do_cx = (r | 1) < n && (cx >> 8) < u01_threshold(cxpb);
  int lo = 0, hi = 0;
  if (do_cx) cut_segment(u1, u2, L, &lo, &hi);
  const bool mut = valid && (own.w >> 8) < u01_threshold(mutpb);
  const uint32_t gene_below = u01_threshold(indpb);
  const int mutants = compact_mutants<kTile>(mut, slots, warp_counts);
  const uint32_t* self = g + static_cast<size_t>(r) * W;
  uint32_t* dst = out + static_cast<size_t>(r) * W;
  int count = 0;
  for (int w0 = 0; w0 < W; w0 += kFlipWords) {
    // this chunk's words load while the gene calls run
    uint32_t x[kFlipWords];
    load_words<kFlipWords>(self, w0, W, valid, vec4, x);
#pragma unroll
    for (int k = 0; k < kFlipWords; ++k)
      if (mut) flips[k * kTile + tid] = 0u;
    __syncthreads();  // the list and the cleared words are in place
    tile_gene_calls<kTile, kFlipWords>(slots, mutants, w0, calls, row0, 0u,
                                       L, gene_below, key, flips);
    __syncthreads();  // the flip words are complete
    // the partner's words come from the adjacent lane
    count += cross_flip_words<kTile, kFlipWords>(x, w0, W, do_cx, lo, hi,
                                                 mut, flips);
    store_words<kFlipWords>(dst, w0, W, valid, vec4, x);
    // each thread cleared and read only its own flip words, and the next
    // chunk's writes to them follow its first barrier: none here
  }
  if (valid) fit[r] = static_cast<float>(count);
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
  packed_variation_hw_kernel<<<grid_for(n, kTile, 1 << 30), kTile, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(g), static_cast<const uint32_t*>(key),
      static_cast<uint32_t*>(out), static_cast<float*>(fit), n, W, L, cxpb,
      mutpb, indpb);
  return static_cast<int>(cudaGetLastError());
}
