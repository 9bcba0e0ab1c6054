// The tile work list of the packed Philox paths: K3-hw
// (packed_variation.cu::packed_variation_hw_kernel) and K5-hw
// (evolve_packed.cu::evolve_hw_kernel) share it; the bits bodies of K3
// and K5 share its row helpers (load_words, cross_words, store_words).
//
// A tile is a block of kTile rows, one thread per row. Only the rows that
// mutate (~mutpb of them) make gene calls, ceil(L / 4) each, so a thread
// that made its own row's calls would leave most of its warp idle. The
// tile lists its mutating rows in shared memory (a ballot in each warp, a
// scan of the warps' counts) and spreads the (row, gene call) items over
// all its threads, call-major, so adjacent threads OR into different
// rows' flip words. A call gives 4 flip bits at a fixed place in its
// row's flip word, and OR commutes, so the result is bitwise the same
// whatever the order of the items.
//
// Flip words go in chunks of kFlipWords words (8 gene calls a word), so
// any L works: flips[k * kTile + t] is word w0 + k of listed row t.
#pragma once

#include "philox.cuh"

// Mutating rows of a tile, compacted: thread t of each warp writes its
// slot in the tile's list (ballot within the warp, a scan of the warps'
// counts across the block). Returns the list's length; the block has
// passed a barrier, and `slots` is complete after the caller's next one.
template <int kTile>
__device__ __forceinline__ int compact_mutants(bool mut, int* slots,
                                               int* warp_counts) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, mut);
  if (lane == 0) warp_counts[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int k = 0; k < kTile / 32; ++k) {
    const int v = warp_counts[k];
    before += k < warp ? v : 0;
    total += v;
  }
  if (mut) slots[before + __popc(ballot & ((1u << lane) - 1u))] = tid;
  return total;
}

// The gene calls of flip-word chunk w0 of the tile's `mutants` listed
// rows (row coordinate row0 + slot's thread, generation g), spread over
// the tile's threads: call q of the chunk for every listed row, then call
// q + 1, each OR-ing its 4 flip bits (genes past L clear) into the row's
// flip word. Needs the list and the cleared flip words in place (a
// barrier before), and a barrier after before the words are read.
template <int kTile, int kFlipWords>
__device__ __forceinline__ void tile_gene_calls(
    const int* slots, int mutants, int w0, int calls, uint32_t row0,
    uint32_t g, int L, uint32_t gene_below, const RoundKeys& key,
    uint32_t* flips) {
  const int tid = threadIdx.x;
  const int q0 = 8 * w0;
  const int chunk_calls = min(calls - q0, 8 * kFlipWords);
  const int items = mutants * chunk_calls;
  // item i is (call i / mutants, slot i % mutants), walked in steps of
  // kTile without a division per item: adjacent threads take different
  // rows, so their ORs go to different words
  int q = tid / max(mutants, 1), slot = tid - q * mutants;
  const int dq = kTile / max(mutants, 1);
  const int dslot = kTile - dq * mutants;
  for (int i = tid; i < items; i += kTile) {
    const int t = slots[slot];
    const int call = q0 + q;
    const uint4 f = draw(row0 + static_cast<uint32_t>(t),
                         static_cast<uint32_t>(call), g, kGenes, key);
    const uint32_t bits = flip_bits4(f, gene_below) &
                          bits_below(L - 4 * call);  // genes past L clear
    if (bits)
      atomicOr(&flips[((call >> 3) - w0) * kTile + t],
               bits << (4 * (call & 7)));
    slot += dslot;
    q += dq;
    if (slot >= mutants) {
      slot -= mutants;
      ++q;
    }
  }
}

// Words w0 .. w0 + kFlipWords - 1 of `row` into x (0 past W or where
// !valid), as uint4 where vec4 (W % 4 == 0 and the rows 16-byte
// aligned). Issued before the gene calls, so the loads are in flight
// while the calls run.
template <int kFlipWords>
__device__ __forceinline__ void load_words(const uint32_t* row, int w0,
                                           int W, bool valid, bool vec4,
                                           uint32_t* x) {
#pragma unroll
  for (int k = 0; k < kFlipWords; k += 4) {
    const uint32_t* p = row + w0 + k;
    if (vec4) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (valid && w0 + k < W) v = *reinterpret_cast<const uint4*>(p);
      x[k] = v.x;
      x[k + 1] = v.y;
      x[k + 2] = v.z;
      x[k + 3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        x[k + j] = valid && w0 + k + j < W ? p[j] : 0u;
    }
  }
}

// The chunk's children in place in x: the pair's segment [lo, hi) from
// the partner's words (the adjacent lane's x, by a shuffle) where do_cx,
// then each word XOR flip(k), its flip word; returns their popcount. Every
// lane of the warp calls it (W is the same for the whole block).
template <int kWords, typename Flip>
__device__ __forceinline__ int cross_words(uint32_t* x, int w0, int W,
                                           bool do_cx, int lo, int hi,
                                           Flip flip) {
  int count = 0;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    if (w0 + k >= W) break;
    const uint32_t y = __shfl_xor_sync(0xffffffffu, x[k], 1);
    uint32_t v = x[k];
    if (do_cx) {
      const int start = 32 * (w0 + k);
      const uint32_t seg = bits_below(hi - start) & ~bits_below(lo - start);
      v = (v & ~seg) | (y & seg);
    }
    v ^= flip(k);
    x[k] = v;
    count += __popc(v);
  }
  return count;
}

// cross_words with the flip words of the tile's list (flips[k * kTile +
// thread], read only where mut).
template <int kTile, int kFlipWords>
__device__ __forceinline__ int cross_flip_words(uint32_t* x, int w0, int W,
                                                bool do_cx, int lo, int hi,
                                                bool mut,
                                                const uint32_t* flips) {
  return cross_words<kFlipWords>(x, w0, W, do_cx, lo, hi, [&](int k) {
    return mut ? flips[k * kTile + threadIdx.x] : 0u;
  });
}

// Words w0 .. of x into `row` (those below W, where valid), as uint4
// where vec4.
template <int kFlipWords>
__device__ __forceinline__ void store_words(uint32_t* row, int w0, int W,
                                            bool valid, bool vec4,
                                            const uint32_t* x) {
#pragma unroll
  for (int k = 0; k < kFlipWords; k += 4) {
    uint32_t* p = row + w0 + k;
    if (vec4) {
      if (valid && w0 + k < W)
        *reinterpret_cast<uint4*>(p) =
            make_uint4(x[k], x[k + 1], x[k + 2], x[k + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (valid && w0 + k + j < W) p[j] = x[k + j];
    }
  }
}
