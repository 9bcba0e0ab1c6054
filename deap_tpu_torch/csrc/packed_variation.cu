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
// Design (packed_variation_kernel): the first design gave each row's
// thread its own gene loop: ~20% of rows mutate, so nearly every warp
// (1 - 0.8^32) walked 4 words x 32 planes of scalar loads, 8 in flight,
// its lanes' rows 512 B apart (each load instruction touching ~6 sectors,
// each row's sectors read again for each of its W words): ~13 dependent
// round trips a warp, not the ~12.4 MB the draws need. Now a warp, a row
// a lane, loads its rows and their draws together, takes the ballot of
// its mutating rows, and walks them kRows (4) at a time: lane l loads
// words l W .. l W + 3 of a row's genebits (one uint4 where W % 4 == 0 and
// aligned), the draws of plane l of the row's 4 words, so the warp reads
// the row's 512 contiguous bytes in one instruction, all of them needed,
// and the row's flip word k is the warp's ballot of word k below the gene
// rate (plane l past gene L never flips), kept by the row's own lane. No
// shared memory, no block barrier, no atomics; the partner's words come
// from the adjacent lane by a shuffle (tile_worklist.cuh::cross_words),
// both rows of a pair reading the even row's pair words (one sector).
// Genomes of more than 4 words go in chunks of 4 (their words then
// strided by W in genebits), so any W and L work. K3-hw's tile work list
// (compact_mutants, a block barrier) measured slower here: without
// Philox calls to spread there is nothing for the other warps to share.
// On an NVIDIA H100 80GB HBM3 (700 W) it takes 14.50-14.53 us at n 100k,
// L 100 after an L2 flush (25.50-25.63 for the first design, in turns;
// port_profile.py --kernel-times), where a torch copy of the same 1.6 MB
// genomes takes ~10.5 us: the mutating rows' ~10 MB of genebits, read
// after the round trip of the draws that pick them, hold it.
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

constexpr int kTile = 256;     // rows of a tile (a block), one a thread
constexpr int kFlipWords = 8;  // flip words of a work-list chunk (256 genes)
constexpr int kRows = 4;   // mutating rows a warp loads at once (bits body)
constexpr int kChunk = 4;  // the bits body's chunk: a uint4 of a row

__global__ void __launch_bounds__(kTile, 4)
packed_variation_kernel(const uint32_t* __restrict__ g,
                        const uint32_t* __restrict__ pairbits,
                        const uint32_t* __restrict__ rowbits,
                        const uint32_t* __restrict__ genebits,
                        uint32_t* __restrict__ out, float* __restrict__ fit,
                        int n, int W, int L, float cxpb, float mutpb,
                        float indpb) {
  const int r = blockIdx.x * kTile + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool valid = r < n;
  // rows of whole uint4s, aligned: one 16-byte load or store a row chunk
  const bool vec4 = W % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  // a lane's chunk of gene words as one uint4: whole uint4s, aligned
  const bool gvec4 =
      W % 4 == 0 && reinterpret_cast<uintptr_t>(genebits) % 16 == 0;
  const uint32_t* self = g + static_cast<size_t>(r) * W;
  // the row's first chunk and its draws load together: its mutation gate
  // and the pair's crossover words (the even row's, for both rows)
  uint32_t x[kChunk];
  load_words<kChunk>(self, 0, W, valid, vec4, x);
  const bool has_pair = (r | 1) < n;  // an odd last row never mates
  uint32_t cx = 0u, u1 = 0u, u2 = 0u, rb = 0u;
  if (has_pair) {
    const uint32_t* pb = pairbits + static_cast<size_t>(r & ~1) * 4;
    cx = __ldcs(pb);
    u1 = __ldcs(pb + 1);
    u2 = __ldcs(pb + 2);
  }
  if (valid) rb = __ldcs(rowbits + r);
  const bool do_cx = has_pair && (cx >> 8) < u01_threshold(cxpb);
  int lo = 0, hi = 0;
  if (do_cx) cut_segment(u1, u2, L, &lo, &hi);
  const bool mut = valid && (rb >> 8) < u01_threshold(mutpb);
  const uint32_t gene_below = u01_threshold(indpb);
  // the warp's mutating rows (the same mask in every lane)
  const unsigned mutants = __ballot_sync(0xffffffffu, mut);
  const size_t row_words = static_cast<size_t>(32) * W;
  const uint32_t* genes = genebits + static_cast<size_t>(r - lane) * row_words;
  uint32_t* dst = out + static_cast<size_t>(r) * W;
  int count = 0;
  for (int w0 = 0; w0 < W; w0 += kChunk) {
    if (w0 > 0) load_words<kChunk>(self, w0, W, valid, vec4, x);
    const int kw = min(kChunk, W - w0);
    // the chunk's flip words of this lane's row, from the walk below
    uint32_t flip[kChunk] = {0u, 0u, 0u, 0u};
    // the warp walks its mutating rows kRows at a time: lane l loads words
    // l W + w0 .. + kw - 1 of a row's genebits, the draws of plane l of the
    // chunk's words (the warp reads the row's 32 kw words at once, one
    // uint4 a lane where gvec4), so flip word k of the row is the warp's
    // ballot of word k below the gene rate (plane l past gene L never
    // flips), kept by the row's own lane
    for (unsigned left = mutants; left;) {
      int owner[kRows];
      uint32_t v[kRows][kChunk];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        owner[j] = left ? __ffs(left) - 1 : -1;
        left &= left - 1u;
        const uint32_t* p = genes + owner[j] * row_words + lane * W + w0;
        if (owner[j] >= 0 && gvec4) {
          const uint4 q = __ldcs(reinterpret_cast<const uint4*>(p));
          v[j][0] = q.x;
          v[j][1] = q.y;
          v[j][2] = q.z;
          v[j][3] = q.w;
        } else {
#pragma unroll
          for (int k = 0; k < kChunk; ++k)
            v[j][k] = owner[j] >= 0 && k < kw ? __ldcs(p + k) : 0u;
        }
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          const unsigned word = __ballot_sync(
              0xffffffffu,
              32 * (w0 + k) + lane < L && (v[j][k] >> 8) < gene_below);
          if (lane == owner[j] && k < kw) flip[k] = word;
        }
      }
    }
    // the partner's words come from the adjacent lane
    count += cross_words<kChunk>(x, w0, W, do_cx, lo, hi,
                                 [&](int k) { return flip[k]; });
    store_words<kChunk>(dst, w0, W, valid, vec4, x);
  }
  if (valid) fit[r] = static_cast<float>(count);
}

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
  packed_variation_kernel<<<grid_for(n, kTile, 1 << 30), kTile, 0,
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
