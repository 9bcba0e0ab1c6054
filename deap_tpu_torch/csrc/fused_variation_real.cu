// One real-valued eaSimple generation: adjacent-pair blend crossover,
// Box-Muller Gaussian mutation, Rastrigin or sphere evaluation.
//
// Replaces deap_tpu/ops/kernels_real.py::fused_variation_eval_real (Pallas
// body _real_body, bits-input path _real_kernel_bits, and the Philox path
// below for _real_kernel_hw). The plain version is
// deap_tpu_torch/ops/kernels_real.py::fused_variation_eval_real_plain.
// Random bits come in as uint32 streams: pairbits [n, 4] (word 0 of the
// even row decides crossover for the pair), rowbits [n, 1], and genebits
// [n, 4 L] holding four planes per row in columns [p L, (p+1) L): the
// blend gamma (read from the pair's even row), the mutation gate, and the
// Box-Muller u1 and u2.
//
// Per gene:
//   gamma = fma(1 + 2 alpha, u, -alpha)
//   child = fma(gamma, partner, (1 - gamma) * self)    where the pair mates
//   child = child + (gate < indpb && rowu < mutpb ? mu + sigma * z : 0)
//   z = sqrt(-2 log1p(-u1)) cos(2 pi u2)
// The two fma are explicit (__fmaf_rn), as XLA computes the JAX kernel on
// the CPU. Every other product that meets an add is written with the
// round-to-nearest intrinsics (__fmul_rn, __fadd_rn, __fsub_rn), which
// nvcc never contracts into an fma, so each rounds on its own as in the
// plain version. log1pf, sqrtf and cosf are the accurate library
// functions, never the fast __cosf/__logf intrinsics. Both paths below
// compute these lines through the same helpers (gamma_of, blend,
// normal_step, add_term) in one kernel template.
//
// Fitness order: lane l of a row sums the terms of genes l, l + 32, ...
// in that order from 0.0f, then the 32 lanes' sums are added in the
// butterfly of __shfl_xor_sync at offsets 16, 8, 4, 2, 1 (another order
// than the plain version's sum, hence FIT_RTOL). Both paths keep this
// order, so their fitness is bitwise the same on the same draws.
//
// Bound on the H100: bytes. Genomes in and children out are 8 bytes per
// gene; a mating pair reads one gamma plane (4 bytes per gene), a
// mutating row its gate plane, and a mutated gene its two normal draws.
// The transcendental work (cos per gene for Rastrigin, log1p/sqrt/cos per
// mutated gene) is well under the float32 rate.
//
// Both paths run one kernel, real_tile_kernel, on a draw source: the bits
// path (LoadedDraws) loads the words a decision needs from the streams;
// the Philox path (PhiloxDraws, replacing _real_kernel_hw of
// deap_tpu/ops/kernels_real.py, which draws with the TPU core's
// generator) makes them in registers by philox4x32_10 (csrc/philox.cuh,
// g = 0) from the key and reads no draw tensor: the kPairRow call of row r
// (word 0 of the even row's gates the pair's crossover, with (r | 1) < n;
// word 3 of each row's own gates its mutation), word c % 4 of the
// kRealGamma call c / 4 of the even row where the pair mates, word c % 4 of
// the kGenes call c / 4 where the row mutates, and words 0-1 of the
// kRealNormal call c where that gate fires. Its plain version is the
// bits-input plain version fed deap_tpu_torch/ops/philox.py::hw_real_bits.
// Bound there: bytes of the genomes in and out and the fitness out (the
// Philox calls' integer multiplies come to a sixth of that).
//
// The tile: a block owns a tile of rows (the Philox path 64 rows over 256
// threads, the bits path 16 over 64), in chunks of 32 gene columns, so
// that no row waits for another's chain of dependent draws (a warp a row,
// the bits path before, waited on its row words, then its gamma and gate
// planes, then u1 and u2, one row after another):
// - thread (warp w, lane l) holds columns c0 + l of 4 pairs, w, w + W, ...
//   (W warps; both rows of each, so the genomes are read once and the
//   partner comes from registers);
// - phase A: thread t takes row t's pair and row words (the Philox call,
//   or the loads of the row word and, for an even row, the pair word),
//   then every thread issues its genes' loads, so the chain of draws
//   starts first and the genes load under it. Loaded words are used only
//   after the genes' loads are issued (a load's first use waits for it);
//   the Philox path decides at once, which keeps the genes' loads from
//   queueing ahead of the key's (deciding after them slowed K6-hw). The
//   mating pairs and the mutating rows go on shared lists
//   (tile_worklist.cuh::compact_mutants);
// - phase B, over all the block's threads, one list of items of 4 columns:
//   the gate words of each mutating row and, on the Philox path, the gamma
//   words of each mating pair (once a pair, not once a row) into shared
//   gamma; on the bits path the thread that crosses a mating pair's column
//   loads its gamma word, in the same round trip. The Philox path appends
//   each gated gene to a shared (row, column) list and, after a barrier,
//   makes one kRealNormal call per listed gene (the list's order follows
//   shared-memory atomics, and no result depends on it: each item writes
//   its own gene's step). The bits path reads the u1 and u2 words of the
//   item's 4 columns in the same round trip as its gate words (at L 30
//   these 32-byte sectors are about the ones the gated genes' words alone
//   would fetch) and writes the steps itself.
//   Steps are +0.0 elsewhere;
// - phase C: each thread crosses its two rows' genes with the pair's gamma,
//   adds the step, stores the children and adds each term to its lane's
//   sum;
// - the rows a warp holds are summed by one transposed butterfly
//   (warp_row_sums), bitwise the order above.
// L above 32 takes the same tile in chunks (kWide), the lane sums carried
// across them. The Philox path's tile: tiles of 128 rows, of 32,
// 512-thread blocks, a persistent grid prefetching the next tile, round
// keys kept in registers and the crossed genes evaluated during the normal
// calls all ran slower on the H100 (PERF.md §6). On the bits path, tiles
// of 128 x 32 and 256 x 64 ran slower than 64 x 16; reading u1 and u2
// only for the gated genes, after the gates, cost a round trip and ran
// slower; items that made each mating pair's gamma once, as the Philox
// path does, ran no faster than the crossing thread's own load (PERF.md
// §6).
#include "common.cuh"
#include "philox.cuh"
#include "tile_worklist.cuh"

namespace {

constexpr float kTwoPi = 6.283185307179586f;
enum Eval { kNone = 0, kRastrigin = 1, kSphere = 2 };

__device__ __forceinline__ float gamma_of(float gamma_scale, uint32_t bits,
                                          float alpha) {
  return __fmaf_rn(gamma_scale, u01(bits), -alpha);
}

__device__ __forceinline__ float blend(float gamma, float mate, float x) {
  return __fmaf_rn(gamma, mate, (1.0f - gamma) * x);
}

// mu + sigma z from the Box-Muller words (u1, u2)
__device__ __forceinline__ float normal_step(uint32_t b1, uint32_t b2,
                                             float mu, float sigma) {
  const float u1 = u01(b1);
  const float u2 = u01(b2);
  const float z = sqrtf(-2.0f * log1pf(-u1)) * cosf(kTwoPi * u2);
  return __fadd_rn(mu, __fmul_rn(sigma, z));
}

__device__ __forceinline__ float add_term(float sum, float x, int eval) {
  if (eval == kRastrigin) {
    return sum + __fsub_rn(__fmul_rn(x, x), __fmul_rn(10.0f, cosf(kTwoPi * x)));
  }
  if (eval == kSphere) return __fadd_rn(sum, __fmul_rn(x, x));
  return sum;
}

__device__ __forceinline__ float row_fitness(float sum, int L, int eval) {
  return eval == kRastrigin ? 10.0f * static_cast<float>(L) + sum : sum;
}

// ------------------------------------------------------------ the tile ----

constexpr int kChunk = 32;               // columns, a lane each
constexpr int kChunkCalls = kChunk / 4;  // items of 4 columns

struct RealParams {
  int n, L;
  float cxpb, mutpb, indpb, gamma_scale, alpha, mu, sigma;
  int eval;
};

template <int kRows, int kWarps, bool kGatedList, bool kGammaItems>
struct alignas(16) RealTile {
  float step[kRows][kChunk];          // mu + sigma z where gated, else +0.0
  // the pair's blend factor, if it mates, where items make it
  float gamma[kGammaItems ? kRows / 2 : 1][kChunk];
  // row << 5 | column of gated genes, where the normal draws take a list
  uint16_t gated[kGatedList ? kRows * kChunk : 1];
  int pair_slots[kRows];              // even rows of the mating pairs
  int mut_slots[kRows];               // the mutating rows
  int warp_counts[2][kWarps];
  int gated_count;
  bool mates[kRows / 2];
};

// The gated genes `bits` of item q of tile row t onto the tile's list.
template <class Tile>
__device__ __forceinline__ void push_gated(Tile& s, int t, int q,
                                           uint32_t bits) {
  if (!bits) return;
  int at = atomicAdd(&s.gated_count, __popc(bits));
  for (; bits; bits &= bits - 1u) {
    s.gated[at++] = static_cast<uint16_t>(t << 5 | (4 * q + __ffs(bits) - 1));
  }
}

// The Philox draw source: every word made in registers from the key.
struct PhiloxDraws {
  static constexpr bool kGatedList = true;  // normal calls from the list
  static constexpr bool kDecideFirst = true;  // made, not loaded
  static constexpr bool kGammaItems = true;  // a call a pair's 4 columns
  const uint32_t* key_ptr;
  uint2 key;

  __device__ __forceinline__ void load() { key = load_key(key_ptr); }
  // (word 0 of the pair, word 3 of the row) of row r's kPairRow call
  __device__ __forceinline__ uint2 row(int r) const {
    const uint4 d = draw(static_cast<uint32_t>(r), 0u, 0u, kPairRow, key);
    return make_uint2(d.x, d.w);
  }
  // gamma words 4 call .. 4 call + 3 of even row r
  __device__ __forceinline__ uint4 gamma4(int r, int call) const {
    return draw(static_cast<uint32_t>(r), static_cast<uint32_t>(call), 0u,
                kRealGamma, key);
  }
  // the gates of columns 4 call .. of row r (tile slot t, item q of the
  // chunk): its gated genes go on the tile's list
  template <class Tile>
  __device__ __forceinline__ void gates(Tile& s, int t, int r, int q,
                                        int call, int L, uint32_t below,
                                        float, float) const {
    const uint4 d = draw(static_cast<uint32_t>(r), static_cast<uint32_t>(call),
                         0u, kGenes, key);
    push_gated(s, t, q, flip_bits4(d, below) & bits_below(L - 4 * call));
  }
  // Box-Muller words (u1, u2) of gene c of row r
  __device__ __forceinline__ uint2 normal(int r, int c) const {
    const uint4 d = draw(static_cast<uint32_t>(r), static_cast<uint32_t>(c),
                         0u, kRealNormal, key);
    return make_uint2(d.x, d.y);
  }
};

// The bits source: the words a decision needs, loaded from the streams
// (pairbits [n, 4], rowbits [n, 1], genebits [n, 4 L]).
struct LoadedDraws {
  static constexpr bool kGatedList = false;  // steps written by the gates
  static constexpr bool kDecideFirst = false;  // loaded with the genes
  // the thread that crosses a mating pair's gene loads its gamma word (in
  // the round trip of the gates), so the items are the gates alone
  static constexpr bool kGammaItems = false;
  const uint32_t* pairbits;
  const uint32_t* rowbits;
  const uint32_t* genebits;
  int L;

  __device__ __forceinline__ void load() {}
  // (the pair word, read by the even row only, and the row word) of row r
  __device__ __forceinline__ uint2 row(int r) const {
    return make_uint2((r & 1) ? 0u : pairbits[static_cast<size_t>(r) * 4],
                      rowbits[r]);
  }
  // words 4 call .. of plane p of row r, where `live` has their bit (4
  // call < L; 0 past L)
  __device__ __forceinline__ uint4 words4(int r, int p, int call,
                                          uint32_t live) const {
    const uint32_t* w =
        genebits + (4 * static_cast<size_t>(r) + p) * L + 4 * call;
    return make_uint4(live & 1u ? w[0] : 0u, live & 2u ? w[1] : 0u,
                      live & 4u ? w[2] : 0u, live & 8u ? w[3] : 0u);
  }
  __device__ __forceinline__ uint32_t gamma(int r, int c) const {
    return genebits[4 * static_cast<size_t>(r) * L + c];
  }
  // the gates of columns 4 call .. of row r and the steps of its gated
  // genes into the tile's step row t, u1 and u2 read with the gates
  template <class Tile>
  __device__ __forceinline__ void gates(Tile& s, int t, int r, int q,
                                        int call, int, uint32_t below,
                                        float mu, float sigma) const {
    const uint32_t live = bits_below(L - 4 * call);
    const uint4 gate = words4(r, 1, call, live);
    const uint4 u1 = words4(r, 2, call, live);
    const uint4 u2 = words4(r, 3, call, live);
    for (uint32_t b = flip_bits4(gate, below) & live; b; b &= b - 1u) {
      const int k = __ffs(b) - 1;
      const uint32_t w1 = k == 0 ? u1.x : k == 1 ? u1.y : k == 2 ? u1.z : u1.w;
      const uint32_t w2 = k == 0 ? u2.x : k == 1 ? u2.y : k == 2 ? u2.z : u2.w;
      s.step[t][4 * q + k] = normal_step(w1, w2, mu, sigma);
    }
  }
};

// Columns c of rows 2 p and 2 p + 1 for the warp's pairs p (0 past the
// genome or the population).
template <int kPairs, int kWarps>
__device__ __forceinline__ void load_pairs(const float* __restrict__ g,
                                           int row0, int n, int L, int c,
                                           int warp, float* x0, float* x1) {
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int r = row0 + 2 * (warp + kWarps * k);
    const size_t at = static_cast<size_t>(r) * L + c;
    x0[k] = c < L && r < n ? g[at] : 0.0f;
    x1[k] = c < L && r + 1 < n ? g[at + L] : 0.0f;
  }
}

// The sums of kN rows a lane holds (kN a power of two, at most 16), each
// over the warp's 32 lanes: the butterfly at offsets 16, 8, 4, 2, 1, with
// the rows handed out on the way (transposed): at each of the first
// log2(kN) offsets a lane keeps half its rows, those of its side of the
// offset, and adds the partner lane's copy of them, so one shuffle moves
// two rows' halves. Every row meets the same lanes in the same order as
// in a butterfly of its own (an add commutes), in kN - 1 + 5 - log2(kN)
// shuffles instead of 5 kN. Returns row lane / (32 / kN)'s sum.
template <int kN, int kOff = 16>
__device__ __forceinline__ float warp_row_sums(float* v, int lane) {
  if constexpr (kN == 1) {
    float s = v[0];
#pragma unroll
    for (int off = kOff; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
    }
    return s;
  } else {
    const bool upper = (lane & kOff) != 0;
#pragma unroll
    for (int j = 0; j < kN / 2; ++j) {
      const float keep = upper ? v[j + kN / 2] : v[j];
      const float send = upper ? v[j] : v[j + kN / 2];
      v[j] = keep + __shfl_xor_sync(0xffffffffu, send, kOff);
    }
    return warp_row_sums<kN / 2, kOff / 2>(v, lane);
  }
}

template <class Draws, int kThreads, int kTileRows, bool kWide,
          int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
real_tile_kernel(const float* __restrict__ g, Draws draws,
                 float* __restrict__ out, float* __restrict__ fit,
                 RealParams prm) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kPairsPerWarp = kTileRows / 2 / kWarps;  // pairs w + kWarps k
  static_assert(kPairsPerWarp >= 1 && kPairsPerWarp <= 8 &&
                    (kPairsPerWarp & (kPairsPerWarp - 1)) == 0 &&
                    kTileRows <= kThreads,
                "a warp holds 1, 2, 4 or 8 pairs; a thread a row's words");
  __shared__ RealTile<kTileRows, kWarps, Draws::kGatedList,
                      Draws::kGammaItems> s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * kTileRows;
  const int n = prm.n, L = prm.L, eval = prm.eval;
  draws.load();
  const int chunks = kWide ? (L + kChunk - 1) / kChunk : (L > 0 ? 1 : 0);
  const int calls = (L + 3) >> 2;
  const uint32_t gate_below = u01_threshold(prm.indpb);

  // phase A: the pair and row words, the genes' loads and the decisions,
  // then the lists of mating pairs and mutating rows. Loaded words are
  // used only after the genes' loads are issued (a load's first use waits
  // for it); made words are used at once, which keeps the genes' loads
  // from queueing ahead of the key's.
  bool mates = false, mut = false;
  uint2 d = make_uint2(0u, 0u);
  const auto decide = [&] {
    const int r = row0 + tid;
    mut = u01(d.y) < prm.mutpb;
    mates = (tid & 1) == 0 && (r | 1) < n && u01(d.x) < prm.cxpb;
  };
  const bool has_row = tid < kTileRows && row0 + tid < n;
  if (has_row) {
    d = draws.row(row0 + tid);
    if constexpr (Draws::kDecideFirst) decide();
  }
  float x0[kPairsPerWarp], x1[kPairsPerWarp];
  load_pairs<kPairsPerWarp, kWarps>(g, row0, n, L, lane, warp, x0, x1);
  if constexpr (!Draws::kDecideFirst) {
    if (has_row) decide();
  }
  if (tid < kTileRows && (tid & 1) == 0) s.mates[tid >> 1] = mates;
  for (int i = tid; i < kTileRows * kChunk; i += kThreads) {
    (&s.step[0][0])[i] = 0.0f;
  }
  if (tid == 0) s.gated_count = 0;
  const int n_pairs =
      compact_mutants<kThreads>(mates, s.pair_slots, s.warp_counts[0]);
  const int n_mut =
      compact_mutants<kThreads>(mut, s.mut_slots, s.warp_counts[1]);
  __syncthreads();

  float sum[2 * kPairsPerWarp];
#pragma unroll
  for (int j = 0; j < 2 * kPairsPerWarp; ++j) sum[j] = 0.0f;

  for (int w0 = 0; w0 < chunks; ++w0) {
    const int c0 = w0 * kChunk;
    if (w0 > 0) {
      load_pairs<kPairsPerWarp, kWarps>(g, row0, n, L, c0 + lane, warp, x0,
                                        x1);
    }
    const int q0 = w0 * kChunkCalls;
    const int chunk_calls = min(calls - q0, kChunkCalls);

    // the gamma words of the thread's mating pairs, where it loads them
    uint32_t gw[kPairsPerWarp];
    if constexpr (!Draws::kGammaItems) {
#pragma unroll
      for (int k = 0; k < kPairsPerWarp; ++k) {
        const int p = warp + kWarps * k;
        gw[k] = s.mates[p] && c0 + lane < L
                    ? draws.gamma(row0 + 2 * p, c0 + lane) : 0u;
      }
    }

    // phase B: the gamma words, once a mating pair (where items make
    // them), then the gates of the mutating rows, as one list of items
    // over the block's threads
    const int gamma_items = Draws::kGammaItems ? n_pairs * kChunkCalls : 0;
    for (int i = tid; i < gamma_items + n_mut * kChunkCalls; i += kThreads) {
      const bool is_gamma = i < gamma_items;
      const int item = is_gamma ? i : i - gamma_items;
      const int q = item & (kChunkCalls - 1);
      if (q >= chunk_calls) continue;
      const int t = (is_gamma ? s.pair_slots : s.mut_slots)[item / kChunkCalls];
      const int call = q0 + q;
      if constexpr (Draws::kGammaItems) {
        if (is_gamma) {
          const uint4 d = draws.gamma4(row0 + t, call);
          *reinterpret_cast<float4*>(&s.gamma[t >> 1][4 * q]) =
              make_float4(gamma_of(prm.gamma_scale, d.x, prm.alpha),
                          gamma_of(prm.gamma_scale, d.y, prm.alpha),
                          gamma_of(prm.gamma_scale, d.z, prm.alpha),
                          gamma_of(prm.gamma_scale, d.w, prm.alpha));
          continue;
        }
      }
      draws.gates(s, t, row0 + t, q, call, L, gate_below, prm.mu, prm.sigma);
    }
    __syncthreads();

    if constexpr (Draws::kGatedList) {  // one normal draw a gated gene
      const int n_gated = s.gated_count;
      for (int i = tid; i < n_gated; i += kThreads) {
        const int e = s.gated[i], t = e >> 5, col = e & (kChunk - 1);
        const uint2 u = draws.normal(row0 + t, c0 + col);
        s.step[t][col] = normal_step(u.x, u.y, prm.mu, prm.sigma);
      }
      __syncthreads();
      if (tid == 0) s.gated_count = 0;  // every thread has read it
    }

    // phase C: cross, mutate, store, sum
    const int c = c0 + lane;
#pragma unroll
    for (int k = 0; k < kPairsPerWarp; ++k) {
      const int p = warp + kWarps * k;
      const int r = row0 + 2 * p;
      float y0 = x0[k], y1 = x1[k];
      if (s.mates[p]) {
        float gm;
        if constexpr (Draws::kGammaItems) {
          gm = s.gamma[p][lane];
        } else {
          gm = gamma_of(prm.gamma_scale, gw[k], prm.alpha);
        }
        const float a = blend(gm, y1, y0);
        y1 = blend(gm, y0, y1);
        y0 = a;
      }
      // + 0.0 where nothing mutates, as the TPU kernel adds
      y0 = y0 + s.step[2 * p][lane];
      y1 = y1 + s.step[2 * p + 1][lane];
      if (kWide && w0 + 1 < chunks) {  // this thread's slots, for the next
        s.step[2 * p][lane] = 0.0f;
        s.step[2 * p + 1][lane] = 0.0f;
      }
      if (c < L) {
        const size_t at = static_cast<size_t>(r) * L + c;
        if (r < n) {
          out[at] = y0;
          sum[2 * k] = add_term(sum[2 * k], y0, eval);
        }
        if (r + 1 < n) {
          out[at + L] = y1;
          sum[2 * k + 1] = add_term(sum[2 * k + 1], y1, eval);
        }
      }
    }
    if (w0 + 1 < chunks) __syncthreads();  // gamma, the list, the steps
  }

  if (eval == kNone) return;
  // the warp's rows: value 2 k + h is row 2 (warp + kWarps k) + h
  constexpr int kRows = 2 * kPairsPerWarp, kLanes = 32 / kRows;
  const float total = warp_row_sums<kRows>(sum, lane);
  const int j = lane / kLanes;
  const int r = row0 + 2 * (warp + kWarps * (j >> 1)) + (j & 1);
  if (lane % kLanes == 0 && r < n) fit[r] = row_fitness(total, L, eval);
}

// Tiles of kTileRows rows, kThreads threads a tile, the launch bounds
// asking for 1024 threads an SM (768 above 32 columns).
template <class Draws, int kThreads, int kTileRows>
int launch_tiles(const void* g, Draws draws, void* out, void* fit,
                 const RealParams& prm, void* stream) {
  const int blocks = grid_for(prm.n, kTileRows, 1 << 30);  // a block a tile
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* gp = static_cast<const float*>(g);
  float* op = static_cast<float*>(out);
  float* fp = static_cast<float*>(fit);
  if (prm.L <= kChunk) {
    real_tile_kernel<Draws, kThreads, kTileRows, false, 1024 / kThreads>
        <<<blocks, kThreads, 0, st>>>(gp, draws, op, fp, prm);
  } else {
    real_tile_kernel<Draws, kThreads, kTileRows, true, 768 / kThreads>
        <<<blocks, kThreads, 0, st>>>(gp, draws, op, fp, prm);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fused_variation_real(const void* g, const void* pairbits,
                                    const void* rowbits, const void* genebits,
                                    void* out, void* fit, int n, int L,
                                    float cxpb, float mutpb, float indpb,
                                    float gamma_scale, float alpha, float mu,
                                    float sigma, int eval, void* stream) {
  if (eval < kNone || eval > kSphere) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const LoadedDraws draws{static_cast<const uint32_t*>(pairbits),
                          static_cast<const uint32_t*>(rowbits),
                          static_cast<const uint32_t*>(genebits), L};
  const RealParams prm{n, L, cxpb, mutpb, indpb, gamma_scale, alpha, mu,
                       sigma, eval};
  return launch_tiles<LoadedDraws, 64, 16>(g, draws, out, fit, prm, stream);
}

// The Philox path: the key is uint32[2] in device memory.
extern "C" int fused_variation_real_hw(const void* g, const void* key,
                                       void* out, void* fit, int n, int L,
                                       float cxpb, float mutpb, float indpb,
                                       float gamma_scale, float alpha,
                                       float mu, float sigma, int eval,
                                       void* stream) {
  if (eval < kNone || eval > kSphere) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PhiloxDraws draws{static_cast<const uint32_t*>(key), {}};
  const RealParams prm{n, L, cxpb, mutpb, indpb, gamma_scale, alpha, mu,
                       sigma, eval};
  return launch_tiles<PhiloxDraws, 256, 64>(g, draws, out, fit, prm, stream);
}
