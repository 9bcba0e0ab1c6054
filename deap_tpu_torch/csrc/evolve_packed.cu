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
// mating pair and L per mutating lane (the planes of real genes).
//
// Design: a persistent cooperative kernel (cudaLaunchCooperativeKernel),
// sized to the blocks the card holds at once, loops grid-stride over the
// pairs of children, and calls grid.sync() once per generation. The
// population and the fitness are double-buffered in device memory: a
// generation reads only the buffers the previous one finished (the input
// tensors for the first), so selection sees the whole previous generation.
// The thread of pair p selects both parents, gathers their words, crosses
// them, mutates each child (reading gene bits only where it mutates) and
// writes both children and their popcounts. Buffers written inside the
// kernel are read through plain loads, never the read-only cache.
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

constexpr int kThreads = 256;  // the bits body: one thread per pair of lanes
constexpr int kTile = 256;     // the Philox path: children of a tile (a block)
constexpr int kFlipWords = 8;  // flip words of a work-list chunk (256 genes)

// Winning population index of lane c's tournament.
__device__ __forceinline__ uint32_t tournament(const float* fit,
                                               const uint32_t* sel,
                                               size_t lanes, int c, int n,
                                               int tournsize) {
  const uint32_t un = static_cast<uint32_t>(n);
  uint32_t best = sel[c] % un;
  float best_fit = fit[best];
  for (int t = 1; t < tournsize; ++t) {
    const uint32_t idx = sel[t * lanes + c] % un;
    const float f = fit[idx];
    if (f > best_fit) {
      best = idx;
      best_fit = f;
    }
  }
  return best;
}

// Flip word w of lane c: bit b set where plane b of word w is below indpb,
// for the nb bits of the word that hold genes (the planes past gene L are
// never read).
__device__ __forceinline__ uint32_t flip_word(const uint32_t* gene,
                                              size_t lanes, int W, int w,
                                              int nb, int c, float indpb) {
  uint32_t flip = 0u;
#pragma unroll 8
  for (int b = 0; b < nb; ++b) {
    flip |= static_cast<uint32_t>(
                u01(gene[static_cast<size_t>(b * W + w) * lanes + c]) < indpb)
            << b;
  }
  return flip;
}

__global__ void __launch_bounds__(kThreads)
evolve_kernel(const uint32_t* __restrict__ pop0, const float* __restrict__ fit0,
              const uint32_t* __restrict__ sel, const uint32_t* __restrict__ pair,
              const uint32_t* __restrict__ row, const uint32_t* __restrict__ gene,
              uint32_t* pops, float* fits, int n, int W, int L, int ngen,
              int tournsize, float cxpb, float mutpb, float indpb) {
  cg::grid_group grid = cg::this_grid();
  const size_t lanes = static_cast<size_t>(n);
  const int npairs = (n + 1) / 2;
  for (int gen = 0; gen < ngen; ++gen) {
    const int prev = (gen - 1) & 1;
    const uint32_t* src = gen == 0 ? pop0 : pops + prev * lanes * W;
    const float* fsrc = gen == 0 ? fit0 : fits + prev * lanes;
    uint32_t* dst = pops + (gen & 1) * lanes * W;
    float* fdst = fits + (gen & 1) * lanes;
    const uint32_t* gsel = sel + static_cast<size_t>(gen) * tournsize * lanes;
    const uint32_t* gpair = pair + static_cast<size_t>(gen) * 3 * lanes;
    const uint32_t* grow = row + static_cast<size_t>(gen) * lanes;
    const uint32_t* ggene = gene + static_cast<size_t>(gen) * 32 * W * lanes;
    for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < npairs;
         p += gridDim.x * blockDim.x) {
      const int a = 2 * p, b = a + 1;
      const bool has_b = b < n;
      const size_t pa = tournament(fsrc, gsel, lanes, a, n, tournsize);
      const size_t pb = has_b ? tournament(fsrc, gsel, lanes, b, n, tournsize)
                              : pa;
      const bool do_cx = has_b && u01(gpair[a]) < cxpb;
      int lo = 0, hi = 0;
      if (do_cx) {
        const int p1 =
            1 + static_cast<int>(u01(gpair[lanes + a]) * static_cast<float>(L));
        int p2 = 1 + static_cast<int>(u01(gpair[2 * lanes + a]) *
                                      static_cast<float>(L - 1));
        if (p2 >= p1) p2 += 1;
        lo = min(p1, p2);
        hi = max(p1, p2);
      }
      const bool mut_a = u01(grow[a]) < mutpb;
      const bool mut_b = has_b && u01(grow[b]) < mutpb;
      int count_a = 0, count_b = 0;
      for (int w = 0; w < W; ++w) {
        const int start = 32 * w;
        uint32_t xa = src[pa * W + w];
        uint32_t xb = src[pb * W + w];
        if (do_cx) {
          const uint32_t seg = bits_below(hi - start) & ~bits_below(lo - start);
          const uint32_t ya = (xa & ~seg) | (xb & seg);
          xb = (xb & ~seg) | (xa & seg);
          xa = ya;
        }
        const int nb = min(32, L - start);
        if (mut_a) xa ^= flip_word(ggene, lanes, W, w, nb, a, indpb);
        dst[static_cast<size_t>(a) * W + w] = xa;
        count_a += __popc(xa);
        if (has_b) {
          if (mut_b) xb ^= flip_word(ggene, lanes, W, w, nb, b, indpb);
          dst[static_cast<size_t>(b) * W + w] = xb;
          count_b += __popc(xb);
        }
      }
      fdst[a] = static_cast<float>(count_a);
      if (has_b) fdst[b] = static_cast<float>(count_b);
    }
    grid.sync();  // generation gen is finished before gen + 1 selects
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
extern "C" int evolve_packed(const void* pop0, const void* fit0,
                             const void* sel, const void* pair,
                             const void* row, const void* gene, void* pops,
                             void* fits, int n, int W, int L, int ngen,
                             int tournsize, float cxpb, float mutpb,
                             float indpb, void* stream) {
  const uint32_t* pop0_ = static_cast<const uint32_t*>(pop0);
  const float* fit0_ = static_cast<const float*>(fit0);
  const uint32_t* sel_ = static_cast<const uint32_t*>(sel);
  const uint32_t* pair_ = static_cast<const uint32_t*>(pair);
  const uint32_t* row_ = static_cast<const uint32_t*>(row);
  const uint32_t* gene_ = static_cast<const uint32_t*>(gene);
  uint32_t* pops_ = static_cast<uint32_t*>(pops);
  float* fits_ = static_cast<float*>(fits);
  void* args[] = {&pop0_, &fit0_, &sel_, &pair_, &row_, &gene_, &pops_,
                  &fits_, &n, &W, &L, &ngen, &tournsize, &cxpb, &mutpb,
                  &indpb};
  return launch_resident(reinterpret_cast<const void*>(evolve_kernel), args,
                         grid_for((n + 1) / 2, kThreads, 1 << 30), kThreads,
                         stream);
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
