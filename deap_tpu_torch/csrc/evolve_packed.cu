// ngen whole OneMax generations on bit-packed genomes in one launch:
// tournament selection, adjacent-pair two-point crossover, flip-bit
// mutation, popcount fitness, the population resident on the card.
//
// Replaces deap_tpu/ops/packed.py::evolve_packed (Pallas body _evolve_body
// with _tournament_idx, bits-input path _evolve_kernel_bits). The plain
// version is deap_tpu_torch/ops/packed.py::evolve_packed_plain, a loop of
// the K4 and K3 plain versions. Random bits come in lane-major, as the TPU
// kernel takes them: sel [ngen, t, n], pair [ngen, 3, n], row [ngen, 1, n],
// gene [ngen, 32 W, n] with bit plane b of word w in row b W + w, so
// consecutive threads read consecutive lanes.
//
// Per generation g and child lane c: aspirant t is sel[g, t, c] % n and a
// strictly greater fitness wins (the first drawn wins ties); the pair of
// lanes (2p, 2p+1) takes lane 2p's crossover draws (an odd last lane never
// mates); lane c mutates with its own row and gene bits.
//
// Bound on the H100: bytes of the draws. The population (1.6 MB at pop
// 100k, W 4) and the fitness (0.4 MB) stay in the 50 MB L2 between
// generations; a generation reads t + 1 draw words per lane, three per
// mating pair and L per mutating lane (the planes of real genes). That
// count (PERF.md's bound, 150.52 us for a 50-generation call at pop 100k,
// L 100, tournament 3, mutpb 0.2) is in 4-byte words, but the card reads
// 32-byte sectors of 8 lanes, and at mutpb 0.2 a sector of a gene plane
// holds a mutating lane with probability 1 - 0.8^8 = 0.832: the sectors a
// generation must fetch are ~36 MB (33.3 of them gene planes), ~1.8 GB a
// call, ~540 us at 3.35 TB/s (chip_smoke.py prints this sector floor).
//
// Design (evolve_kernel): K5-hw's grid. A thread per child in tiles of
// 256 children, a block a tile, on a resident cooperative grid; the tiles
// loop when n exceeds what the card holds at once. The population and the
// fitness are double-buffered in device memory: a generation reads only
// the buffers the previous one finished (the input tensors for the first),
// through plain loads, never the read-only cache. The first design (a
// thread per pair, a serial chain of scalar gene loads, 8 in flight, 1740
// us a call) waited on round trips; this one keeps the planes streaming:
// - A warp's ring in shared memory. A warp copies its 32 lanes of each
//   gene plane (128 contiguous bytes) with cp.async, 16 bytes a lane (8
//   lanes a plane, 4 planes a group, 2 groups in flight; 4 bytes a lane
//   where n % 4 != 0), and reads each group from shared memory as it
//   lands. Whole planes, for every warp with a mutating lane: predicating
//   the loads on the lane's own mutation (the sector floor) measured
//   slower, and so did deeper rings, register batches of 16-32 planes and
//   4-byte copies a lane. The planes go into L2 evict-first (a
//   generation's ~40 MB would otherwise push the population out).
// - The planes never wait for the population. A grid barrier in two
//   halves (grid_arrive, grid_wait; a count the wrapper zeroes): after a
//   block writes its children it arrives, then streams the next item's
//   planes into its flip words while the other blocks finish, and only
//   then waits. The next item's first planes are issued before this
//   item's tournament (its row word is loaded an item ahead), and its
//   draws load while this item breeds.
// - Coalescing. Adjacent threads hold adjacent lanes: a warp reads each
//   sel and row word as 128 contiguous bytes; both lanes of a pair read the
//   even lane's pair words (one sector); the partner's parent words come
//   by a shuffle (tile_worklist.cuh::cross_words); the tournament's first
//   4 fitness loads go out together.
// - Flip words stay in registers (4 words a chunk); a genome of more than
//   4 words streams its later chunks after its first, in line.
// On an NVIDIA H100 80GB HBM3 (700 W) a 50-generation call at pop 100k,
// L 100, tournament 3 takes 842-845 us after an L2 flush (1730-1733 for
// the first design, in turns; port_profile.py --kernel-times), 1.56x its
// sector floor, where a read-only torch pass over the call's 2.7 GB of
// draws takes ~908 us: the planes' bytes, read whole, hold it.
//
// The Philox path (evolve_hw_kernel, replacing _evolve_kernel_hw of
// deap_tpu/ops/packed.py) takes no draw tensors: each child makes its
// draws in registers from the key (csrc/philox.cuh, counter word g = the
// generation inside this call): its tournament calls, its pair+row call
// (the even child's words 0-2 decide the pair's crossover, each child's
// word 3 its mutation) and, where it mutates, ceil(L / 4) gene calls. Its
// plain version is the bits-input plain version fed
// ops/philox.py::hw_evolve_bits. Bound on the H100: the integer multiplies
// of the Philox calls (40 each; 83.79 us for a 50-generation call at pop
// 100k, L 100, tournament 3).
//
// Its design answers the three things that held the first one (a thread
// per pair, 50k threads in 196 blocks):
// - Divergent gene calls. Only ~20% of children mutate, so a thread that
//   made its own child's 25 gene calls left most of its warp idle. A tile
//   (a block of 256 children) lists its mutating children in shared memory
//   (a ballot in each warp, a scan of the warps' counts), then spreads the
//   (child, gene call) items over all its threads, call-major, so adjacent
//   threads OR into different children's flip words; a call gives 4 flip
//   bits at a fixed place, and OR commutes, so the result is bitwise the
//   plain version's whatever the order. The list and its walk are
//   csrc/tile_worklist.cuh, which K3-hw shares.
// - A lopsided grid. A thread per child; a pair's children sit in adjacent
//   lanes and take the even lane's crossover words and the partner
//   parent's words by shuffles. At pop 100k the 391 tiles are resident at
//   once (5 blocks an SM fit), 2.96 a SM.
// - The barrier. grid.sync() stays, measured: chip_smoke.py times this
//   kernel on this grid with no child (evolve_packed_hw_barrier). Fewer,
//   larger blocks (one an SM) make the barrier alone cheaper but the call
//   slower: one block's warps then wait for each other at every tile
//   barrier, where independent blocks on an SM overlap their phases.
// The first tournament call's fitness loads issue before the pair+row call
// and are waited on only after the list's first barrier, the parent rows
// load as uint4 while the gene calls run, the key's round keys are
// computed once (csrc/philox.cuh::RoundKeys) rather than in every call, and
// a draw is tested against an integer threshold (u01_threshold), which is
// exact.
// On an H100 (700 W) a 50-generation call at pop 100k takes ~413 us, ~20%
// of its bound. Its phase clock (-DDTT_K5_PHASES, port_profile.py
// --kernel-times) puts a block's generation at ~28% draws and tournament
// loads, ~25% gene calls and ~35% at the grid barrier, about half of that
// the barrier itself (~1.5 us a generation) and half the wait for slower
// blocks: the chain of dependent steps, not the multiplies, bounds it.
#include <cooperative_groups.h>

#include "common.cuh"
#include "philox.cuh"
#include "tile_worklist.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 256;     // children of a tile (a block), both paths
constexpr int kFlipWords = 8;  // flip words of a work-list chunk (256 genes)
constexpr int kWords = 4;      // the bits body's chunk: a uint4 of a row
constexpr int kAspirants = 4;  // aspirant words loaded ahead of an item
constexpr int kWarps = kTile / 32;
constexpr int kRing = 8;            // gene planes in a warp's ring
constexpr int kAhead = kRing / 4;   // copy groups (4 planes each) in flight

// One child's draws of one generation: its row word, its pair's three
// words (the even lane's), its first kAspirants aspirant words.
struct Draws {
  uint32_t row, cx, u1, u2;
  uint32_t sel[kAspirants];
};

// Child c's draws of generation g (none where !valid), streamed: read
// once, kept out of the way of the population in L2.
__device__ __forceinline__ Draws load_draws(const uint32_t* sel,
                                            const uint32_t* pair,
                                            const uint32_t* row, int g,
                                            int c, size_t lanes, bool valid,
                                            int tournsize) {
  Draws d = {};
  if (!valid) return d;
  const size_t gen = static_cast<size_t>(g);
  d.row = __ldcs(row + gen * lanes + c);
  const uint32_t* p = pair + gen * 3 * lanes + (c & ~1);
  d.cx = __ldcs(p);
  d.u1 = __ldcs(p + lanes);
  d.u2 = __ldcs(p + 2 * lanes);
  const uint32_t* s = sel + gen * tournsize * lanes + c;
#pragma unroll
  for (int k = 0; k < kAspirants; ++k)
    if (k < tournsize) d.sel[k] = __ldcs(s + k * lanes);
  return d;
}

// Asynchronous copies from device memory into shared memory (cp.async,
// sm_80+), in commit groups; a thread waits for its own. The gene planes
// are read once: they go into L2 marked evict-first, so a generation's
// ~40 MB of planes do not push the population and the fitness (~4 MB,
// read again by the next generation) out of the 50 MB L2.
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}
__device__ __forceinline__ void copy16(uint32_t* dst, const uint32_t* src) {
  const uint32_t to = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::"r"(
          to),
      "l"(src), "l"(evict_first())
      : "memory");
}

__device__ __forceinline__ void copy4(uint32_t* dst, const uint32_t* src) {
  const uint32_t to = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile(
      "cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 4, %2;\n" ::"r"(
          to),
      "l"(src), "l"(evict_first())
      : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` of this thread's latest groups are in
// flight.
template <int pending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

// Copy group j of a warp's gene planes of chunk w0 into `slot`, 4 planes
// of its ring: planes q = 4 j .. 4 j + 3 of the chunk (gene 32 w0 + q,
// genes below L only, P of them), each the warp's 32 lanes of that plane
// (from lane c0). `wide`: 8 lanes a plane, 16 bytes each (n % 4 == 0,
// gene 16-byte aligned); else each lane its own 4 bytes of each plane.
// Commits a group either way, so the warp's lanes count the same groups.
__device__ __forceinline__ void issue_planes(uint32_t (*slot)[32],
                                             const uint32_t* gene,
                                             size_t lanes, int n, int W,
                                             int w0, int P, int j, int c0,
                                             bool wide) {
  const int lane = threadIdx.x & 31;
  if (4 * j < P) {
    if (wide) {
      const int i = lane >> 3, at = 4 * (lane & 7);
      const int q = 4 * j + i, g = 32 * w0 + q;
      if (q < P && c0 + at < n)
        copy16(&slot[i][at],
               gene + static_cast<size_t>((g & 31) * W + (g >> 5)) * lanes +
                   c0 + at);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = 4 * j + i, g = 32 * w0 + q;
        if (q < P && c0 + lane < n)
          copy4(&slot[i][lane],
                gene + static_cast<size_t>((g & 31) * W + (g >> 5)) * lanes +
                    c0 + lane);
      }
    }
  }
  copy_commit();
}

// The flip words of chunk w0 (kWords words from word w0, genes 32 w0 ..)
// of a warp's lanes from c0 (this lane mutating where mut): its P gene
// planes (none where no lane of the warp mutates) stream through the
// warp's ring, kAhead copy groups of 4 planes in flight (start_planes
// issues the first kAhead), each group read as it lands (read_planes), the
// bits of genes below the gene rate set. Every lane of the warp calls
// them with the same P.
__device__ __forceinline__ void start_planes(uint32_t (*ring)[32],
                                             const uint32_t* gene,
                                             size_t lanes, int n, int W,
                                             int w0, int P, int c0,
                                             bool wide) {
#pragma unroll
  for (int j = 0; j < kAhead; ++j)
    issue_planes(ring + 4 * j, gene, lanes, n, W, w0, P, j, c0, wide);
}

__device__ __forceinline__ void read_planes(uint32_t (*ring)[32],
                                            const uint32_t* gene,
                                            size_t lanes, int n, int W,
                                            int w0, int P, int c0, bool mut,
                                            uint32_t below, bool wide,
                                            uint32_t (&flip)[kWords]) {
  const int lane = threadIdx.x & 31;
  const int groups = (P + 3) / 4;
  for (int j = 0; j < groups; ++j) {
    uint32_t(*slot)[32] = ring + 4 * (j % kAhead);
    copy_wait<kAhead - 1>();  // group j has landed
    __syncwarp();             // the warp's copies of it too
    uint32_t bits = 0u;       // genes 32 w0 + 4 j .. + 3
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (mut && 4 * j + i < P && (slot[i][lane] >> 8) < below)
        bits |= 1u << i;
    __syncwarp();  // every lane has read the slot before it refills
    issue_planes(slot, gene, lanes, n, W, w0, P, j + kAhead, c0, wide);
#pragma unroll
    for (int k = 0; k < kWords; ++k)
      if (j >> 3 == k) flip[k] |= bits << (4 * j & 31);
  }
}

// A grid barrier in two halves (all blocks resident, cooperative launch),
// as cooperative_groups' grid.sync() is made: a block arrives once its
// threads' writes are done; its thread 0 then waits for the count of
// arrivals to reach `target`. In between, a block may do work that reads
// nothing the other blocks write.
__device__ __forceinline__ void grid_arrive(unsigned* arrived) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(arrived, 1u);
  }
}

__device__ __forceinline__ void grid_wait(const unsigned* arrived,
                                          unsigned target) {
  if (threadIdx.x == 0) {
    while (*reinterpret_cast<const volatile unsigned*>(arrived) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kTile, 3)
evolve_kernel(const uint32_t* __restrict__ pop0, const float* __restrict__ fit0,
              const uint32_t* __restrict__ sel, const uint32_t* __restrict__ pair,
              const uint32_t* __restrict__ row, const uint32_t* __restrict__ gene,
              uint32_t* pops, float* fits, unsigned* arrived, int n, int W,
              int L, int ngen, int tournsize, float cxpb, float mutpb,
              float indpb) {
  // each warp's ring of gene planes in flight: kRing planes of its lanes
  __shared__ uint32_t rings[kWarps][kRing][32];
  const int tid = threadIdx.x;
  const int tiles = (n + kTile - 1) / kTile;
  uint32_t(*ring)[32] = rings[tid >> 5];
  const size_t lanes = static_cast<size_t>(n);
  const size_t plane_words = static_cast<size_t>(32) * W * lanes;
  const uint32_t un = static_cast<uint32_t>(n);
  const bool wide = n % 4 == 0 && reinterpret_cast<uintptr_t>(gene) % 16 == 0;
  // rows of whole uint4s, aligned: one 16-byte load or store a row chunk
  const bool vec4 = W % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(pop0) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(pops) % 16 == 0;
  const uint32_t cx_below = u01_threshold(cxpb);
  const uint32_t mut_below = u01_threshold(mutpb);
  const uint32_t gene_below = u01_threshold(indpb);
  // the planes of chunk w0 at mutating lanes of the warp
  auto planes = [=](int w0, bool mut) {
    return __any_sync(0xffffffffu, mut)
               ? max(0, min(L, 32 * (w0 + kWords)) - 32 * w0)
               : 0;
  };
  // the block's first item (generation 0, tile blockIdx.x): its draws,
  // and the row word of the item after it
  int c = blockIdx.x * kTile + tid;
  Draws d = load_draws(sel, pair, row, 0, c, lanes, c < n, tournsize);
  bool mut = c < n && (d.row >> 8) < mut_below;
  int P = planes(0, mut);
  start_planes(ring, gene, lanes, n, W, 0, P, c - (tid & 31), wide);
  uint32_t row_next = 0u;
  {
    int t = blockIdx.x + gridDim.x, g = 0;
    if (t >= tiles) {
      t = blockIdx.x;
      ++g;
    }
    if (g < ngen && t * kTile + tid < n)
      row_next = __ldcs(row + static_cast<size_t>(g) * lanes + t * kTile +
                        tid);
  }
  uint32_t flip[kWords] = {0u, 0u, 0u, 0u};
  read_planes(ring, gene, lanes, n, W, 0, P, c - (tid & 31), mut, gene_below,
              wide, flip);
  for (int gen = 0; gen < ngen; ++gen) {
    const int prev = (gen - 1) & 1;
    const uint32_t* src = gen == 0 ? pop0 : pops + prev * lanes * W;
    const float* fsrc = gen == 0 ? fit0 : fits + prev * lanes;
    uint32_t* dst = pops + (gen & 1) * lanes * W;
    float* fdst = fits + (gen & 1) * lanes;
    const uint32_t* gsel =
        sel + static_cast<size_t>(gen) * tournsize * lanes;
    // the tile index is the same for the whole block, so every thread
    // reaches each shuffle and barrier
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      c = tile * kTile + tid;
      const bool valid = c < n;
      // the next item (the next tile of this generation, else the first of
      // the next) and the one after it
      int next_tile = tile + static_cast<int>(gridDim.x), next_gen = gen;
      if (next_tile >= tiles) {
        next_tile = blockIdx.x;
        ++next_gen;
      }
      int after_tile = next_tile + static_cast<int>(gridDim.x),
          after_gen = next_gen;
      if (after_tile >= tiles) {
        after_tile = blockIdx.x;
        ++after_gen;
      }
      const int nc = next_tile * kTile + tid;
      const bool next_valid = next_gen < ngen && nc < n;
      // the next item's first gene planes: they start streaming while this
      // one breeds (where its flip words take one chunk; else after this
      // item's later chunks, which use the ring first); its row word landed
      // during the last item
      const bool next_mut = next_valid && (row_next >> 8) < mut_below;
      const int next_P = planes(0, next_mut);
      const uint32_t* next_gene =
          gene + static_cast<size_t>(next_gen) * plane_words;
      if (W <= kWords)
        start_planes(ring, next_gene, lanes, n, W, 0, next_P, nc - (tid & 31),
                     wide);
      const Draws nd = load_draws(sel, pair, row, next_gen, nc, lanes,
                                  next_valid, tournsize);
      row_next = 0u;
      if (after_gen < ngen && after_tile * kTile + tid < n)
        row_next = __ldcs(row + static_cast<size_t>(after_gen) * lanes +
                          after_tile * kTile + tid);
      const bool do_cx = (c | 1) < n && (d.cx >> 8) < cx_below;
      int lo = 0, hi = 0;
      if (do_cx) cut_segment(d.u1, d.u2, L, &lo, &hi);
      // the tournament: the first kAspirants fitness loads together, then
      // the rest kAspirants at a time; a strictly greater fitness wins
      size_t parent = 0;
      if (valid) {
        uint32_t best = 0u;
        float best_fit = 0.0f;
        for (int t0 = 0; t0 < tournsize; t0 += kAspirants) {
          uint32_t idx[kAspirants];
          float f[kAspirants];
#pragma unroll
          for (int k = 0; k < kAspirants; ++k)
            idx[k] = t0 == 0 ? d.sel[k] % un
                     : t0 + k < tournsize
                         ? __ldcs(gsel + (t0 + k) * lanes + c) % un
                         : 0u;
#pragma unroll
          for (int k = 0; k < kAspirants; ++k)
            f[k] = t0 + k < tournsize ? fsrc[idx[k]] : 0.0f;
#pragma unroll
          for (int k = 0; k < kAspirants; ++k) {
            if (t0 + k < tournsize && (t0 + k == 0 || f[k] > best_fit)) {
              best = idx[k];
              best_fit = f[k];
            }
          }
        }
        parent = best;
      }
      int count = 0;
      for (int w0 = 0; w0 < W; w0 += kWords) {
        if (w0 > 0) {  // the chunks past the first stream here
          const uint32_t* gene_now =
              gene + static_cast<size_t>(gen) * plane_words;
          const int Pw = planes(w0, mut);
#pragma unroll
          for (int k = 0; k < kWords; ++k) flip[k] = 0u;
          start_planes(ring, gene_now, lanes, n, W, w0, Pw, c - (tid & 31),
                       wide);
          read_planes(ring, gene_now, lanes, n, W, w0, Pw, c - (tid & 31),
                      mut, gene_below, wide, flip);
        }
        uint32_t x[kWords];
        load_words<kWords>(src + parent * W, w0, W, valid, vec4, x);
        count += cross_words<kWords>(x, w0, W, do_cx, lo, hi,
                                     [&](int k) { return flip[k]; });
        store_words<kWords>(dst + static_cast<size_t>(c) * W, w0, W, valid,
                            vec4, x);
      }
      if (valid) fdst[c] = static_cast<float>(count);
      // the block's last tile of a generation that another follows
      const bool last = next_gen > gen && next_gen < ngen;
      if (last) grid_arrive(arrived);
      // the next item's flip words: its planes need nothing of this
      // generation, so they stream while the other blocks finish it
      if (W > kWords)
        start_planes(ring, next_gene, lanes, n, W, 0, next_P, nc - (tid & 31),
                     wide);
#pragma unroll
      for (int k = 0; k < kWords; ++k) flip[k] = 0u;
      read_planes(ring, next_gene, lanes, n, W, 0, next_P, nc - (tid & 31),
                  next_mut, gene_below, wide, flip);
      // generation gen is finished before gen + 1 selects
      if (last) grid_wait(arrived, (gen + 1) * gridDim.x);
      d = nd;
      mut = next_valid && (d.row >> 8) < mut_below;
    }
  }
}

// The phase clock of the Philox path, built only with -DDTT_K5_PHASES
// (port_profile.py --kernel-times): thread 0 of each block adds the SM
// clocks since its last mark to the phase it ends, so the totals split a
// block's generations into 0 the first tournament call and its loads'
// issue, the pair+row call and the list's ballot up to its first barrier,
// 1 the winner (the wait for the fitness loads), the list and the parent
// loads' issue, 2 the gene calls, 3 thread 0's crossover, flips and
// stores, 4 the grid barrier (with the wait for the block's and the
// grid's slower threads).
constexpr int kPhases = 5;
#ifdef DTT_K5_PHASES
__device__ unsigned long long k5_phase_clocks[kPhases];
#define K5_MARK(phase)                                                   \
  if (threadIdx.x == 0) {                                                \
    const long long now = clock64();                                     \
    atomicAdd(&k5_phase_clocks[phase],                                   \
              static_cast<unsigned long long>(now - mark));              \
    mark = now;                                                          \
  }
#else
#define K5_MARK(phase)
#endif

__global__ void __launch_bounds__(kTile)
evolve_hw_kernel(const uint32_t* __restrict__ pop0,
                 const float* __restrict__ fit0,
                 const uint32_t* __restrict__ key_ptr, uint32_t* pops,
                 float* fits, int n, int W, int L, int ngen, int tournsize,
                 float cxpb, float mutpb, float indpb) {
  // flip words of the tile's children, word-major (conflict-free reads)
  __shared__ uint32_t flips[kFlipWords * kTile];
  __shared__ int slots[kTile];
  __shared__ int warp_counts[kTile / 32];
  cg::grid_group grid = cg::this_grid();
  const RoundKeys key = round_keys(load_key(key_ptr));
  const int tid = threadIdx.x;
  const int tiles = (n + kTile - 1) / kTile;
  const int calls = (L + 3) >> 2;  // gene calls of a mutating child
  const size_t lanes = static_cast<size_t>(n);
  // rows of whole uint4s, aligned: one 16-byte load or store a row chunk
  const bool vec4 = W % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(pop0) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(pops) % 16 == 0;
  const uint32_t cx_below = u01_threshold(cxpb);
  const uint32_t mut_below = u01_threshold(mutpb);
  const uint32_t gene_below = u01_threshold(indpb);
#ifdef DTT_K5_PHASES
  long long mark = clock64();
#endif
  for (int gen = 0; gen < ngen; ++gen) {
    const int prev = (gen - 1) & 1;
    const uint32_t* src = gen == 0 ? pop0 : pops + prev * lanes * W;
    const float* fsrc = gen == 0 ? fit0 : fits + prev * lanes;
    uint32_t* dst = pops + (gen & 1) * lanes * W;
    float* fdst = fits + (gen & 1) * lanes;
    const uint32_t g = static_cast<uint32_t>(gen);
    // the tile index is the same for the whole block, so every thread
    // reaches each barrier and each shuffle
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int c = tile * kTile + tid;
      const bool valid = c < n;
      const uint32_t uc = static_cast<uint32_t>(c);
      // the first tournament call's fitness loads, then child c's pair+row
      // call while they are in flight: words 0-2 of the even child decide
      // the pair's crossover, word 3 this child's mutation
      const Aspirants first =
          aspirants(fsrc, uc, 0, g, n, tournsize, valid, key);
      const uint4 d = draw(uc, 0u, g, kPairRow, key);
      const int even = (threadIdx.x & 31) & ~1;
      const uint32_t cx = __shfl_sync(0xffffffffu, d.x, even);
      const uint32_t u1 = __shfl_sync(0xffffffffu, d.y, even);
      const uint32_t u2 = __shfl_sync(0xffffffffu, d.z, even);
      const bool do_cx = (c | 1) < n && (cx >> 8) < cx_below;
      int lo = 0, hi = 0;
      if (do_cx) cut_segment(u1, u2, L, &lo, &hi);
      const bool mut = valid && (d.w >> 8) < mut_below;
      const int mutants = compact_mutants<kTile>(mut, slots, warp_counts);
      K5_MARK(0);
      // the winner after the list's barrier, so the fitness loads' latency
      // overlaps the block's wait there
      const size_t parent =
          valid ? hw_tournament(first, fsrc, uc, g, n, tournsize, key) : 0u;
      int count = 0;
      for (int w0 = 0; w0 < W; w0 += kFlipWords) {
        // this chunk's parent words load while the gene calls run
        uint32_t x[kFlipWords];
        load_words<kFlipWords>(src + parent * W, w0, W, valid, vec4, x);
#pragma unroll
        for (int k = 0; k < kFlipWords; ++k)
          if (mut) flips[k * kTile + tid] = 0u;
        __syncthreads();  // the list and the cleared words are in place
        K5_MARK(1);
        tile_gene_calls<kTile, kFlipWords>(
            slots, mutants, w0, calls, static_cast<uint32_t>(tile * kTile),
            g, L, gene_below, key, flips);
        __syncthreads();  // the flip words are complete
        K5_MARK(2);
        // the partner's parent words come from the adjacent lane
        count += cross_flip_words<kTile, kFlipWords>(x, w0, W, do_cx, lo, hi,
                                                     mut, flips);
        store_words<kFlipWords>(dst + static_cast<size_t>(c) * W, w0, W,
                                valid, vec4, x);
        // each thread cleared and read only its own flip words, and the
        // next writes to the list follow two more barriers: none here
        K5_MARK(3);
      }
      if (valid) fdst[c] = static_cast<float>(count);
    }
    grid.sync();  // generation gen is finished before gen + 1 selects
    K5_MARK(4);
  }
}

// The cooperative grid of `kernel`: `needed` blocks of `threads`, at most
// as many as the card holds at once. Sets *blocks and *per_sm (blocks an
// SM holds); returns a CUDA error code.
int resident_grid(const void* kernel, int needed, int threads, int* blocks,
                  int* per_sm) {
  int device = 0, sms = 0, cooperative = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&cooperative, cudaDevAttrCooperativeLaunch,
                               device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!cooperative) return static_cast<int>(cudaErrorNotSupported);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                      threads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (*per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  *blocks = needed < *per_sm * sms ? needed : *per_sm * sms;
  return 0;
}

// Launch `kernel` cooperatively with `args` on its resident grid.
int launch_resident(const void* kernel, void** args, int needed, int threads,
                    void* stream) {
  int blocks = 0, per_sm = 0;
  const int err = resident_grid(kernel, needed, threads, &blocks, &per_sm);
  if (err) return err;
  const cudaError_t launched = cudaLaunchCooperativeKernel(
      kernel, dim3(blocks), dim3(threads), args, 0,
      static_cast<cudaStream_t>(stream));
  if (launched != cudaSuccess) return static_cast<int>(launched);
  return static_cast<int>(cudaGetLastError());
}

// Launch the Philox path on its grid at n children with `args`.
int launch_hw(void** args, int n, void* stream) {
  return launch_resident(reinterpret_cast<const void*>(evolve_hw_kernel),
                         args, grid_for(n, kTile, 1 << 30), kTile, stream);
}

}  // namespace

// pops [2, n, W] and fits [2, n] are the double buffers; generation g
// writes buffer g & 1, so the result is buffer (ngen - 1) & 1.
// arrived is one zeroed uint32 (the grid barrier's count of arrivals).
extern "C" int evolve_packed(const void* pop0, const void* fit0,
                             const void* sel, const void* pair,
                             const void* row, const void* gene, void* pops,
                             void* fits, void* arrived, int n, int W, int L,
                             int ngen, int tournsize, float cxpb, float mutpb,
                             float indpb, void* stream) {
  const uint32_t* pop0_ = static_cast<const uint32_t*>(pop0);
  const float* fit0_ = static_cast<const float*>(fit0);
  const uint32_t* sel_ = static_cast<const uint32_t*>(sel);
  const uint32_t* pair_ = static_cast<const uint32_t*>(pair);
  const uint32_t* row_ = static_cast<const uint32_t*>(row);
  const uint32_t* gene_ = static_cast<const uint32_t*>(gene);
  uint32_t* pops_ = static_cast<uint32_t*>(pops);
  float* fits_ = static_cast<float*>(fits);
  unsigned* arrived_ = static_cast<unsigned*>(arrived);
  void* args[] = {&pop0_, &fit0_, &sel_, &pair_, &row_, &gene_, &pops_,
                  &fits_, &arrived_, &n, &W, &L, &ngen, &tournsize, &cxpb,
                  &mutpb, &indpb};
  return launch_resident(reinterpret_cast<const void*>(evolve_kernel), args,
                         grid_for(n, kTile, 1 << 30), kTile, stream);
}

// The Philox path: key is uint32[2] on the card; the same double buffers.
extern "C" int evolve_packed_hw(const void* pop0, const void* fit0,
                                const void* key, void* pops, void* fits,
                                int n, int W, int L, int ngen, int tournsize,
                                float cxpb, float mutpb, float indpb,
                                void* stream) {
  const uint32_t* pop0_ = static_cast<const uint32_t*>(pop0);
  const float* fit0_ = static_cast<const float*>(fit0);
  const uint32_t* key_ = static_cast<const uint32_t*>(key);
  uint32_t* pops_ = static_cast<uint32_t*>(pops);
  float* fits_ = static_cast<float*>(fits);
  void* args[] = {&pop0_, &fit0_, &key_, &pops_, &fits_, &n, &W, &L,
                  &ngen, &tournsize, &cxpb, &mutpb, &indpb};
  return launch_hw(args, n, stream);
}

// The grid of the Philox path at n children: out[0] blocks, out[1] the
// blocks an SM holds, out[2] tiles of kTile children (a tile a block).
extern "C" int evolve_packed_hw_grid(int n, int* out) {
  out[2] = grid_for(n, kTile, 1 << 30);
  return resident_grid(reinterpret_cast<const void*>(evolve_hw_kernel),
                       out[2], kTile, &out[0], &out[1]);
}

// The Philox path's barrier alone: evolve_hw_kernel on the grid of a call
// at n children, given no child to breed, so each of its ngen generations
// is one grid.sync() and the loop around it. Its time over ngen, less that
// of ngen 0, is the barrier's cost per generation.
extern "C" int evolve_packed_hw_barrier(const void* key, int n, int ngen,
                                        void* stream) {
  const uint32_t* pop0_ = nullptr;
  const float* fit0_ = nullptr;
  const uint32_t* key_ = static_cast<const uint32_t*>(key);
  uint32_t* pops_ = nullptr;
  float* fits_ = nullptr;
  int none = 0, one = 1;
  float zero = 0.0f;
  void* args[] = {&pop0_, &fit0_, &key_, &pops_, &fits_, &none, &one, &one,
                  &ngen, &one, &zero, &zero, &zero};
  return launch_hw(args, n, stream);
}

#ifdef DTT_K5_PHASES
// The phase clocks' totals since the last reset: out[kPhases]; reset != 0
// clears them after the read.
extern "C" int evolve_packed_hw_phases(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, k5_phase_clocks,
                                         sizeof(k5_phase_clocks));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[kPhases] = {};
    err = cudaMemcpyToSymbol(k5_phase_clocks, zero, sizeof(zero));
  }
  return static_cast<int>(err);
}
#endif
