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
// functions, never the fast __cosf/__logf intrinsics. Both kernels below
// compute these lines through the same helpers (gamma_of, blend,
// normal_step, add_term).
//
// Fitness order: lane l of a row sums the terms of genes l, l + 32, ...
// in that order from 0.0f, then the 32 lanes' sums are added in the
// butterfly of __shfl_xor_sync at offsets 16, 8, 4, 2, 1 (another order
// than the plain version's sum, hence FIT_RTOL). Both kernels keep this
// order, so their fitness is bitwise the same on the same draws.
//
// Bound on the H100: bytes. Genomes in and children out are 8 bytes per
// gene; a mating pair reads one gamma plane (4 bytes per gene), a
// mutating row its gate plane, and a mutated gene its two normal draws.
// The transcendental work (cos per gene for Rastrigin, log1p/sqrt/cos per
// mutated gene) is well under the float32 rate.
//
// The bits path (fused_variation_real_kernel): one warp per row, its lanes
// over the genes (L 30 fits one pass), so rows and planes are read
// coalesced; the partner row and the gamma plane are read only where the
// pair mates, the gate plane only where the row mutates and u1/u2 only
// where a gene mutates.
//
// The Philox path (real_hw_kernel, replacing _real_kernel_hw of
// deap_tpu/ops/kernels_real.py, which draws with the TPU core's generator)
// makes every draw in registers by philox4x32_10 (csrc/philox.cuh, g = 0)
// from the key and reads no draw tensor: the kPairRow call of row r (word
// 0 of the even row's gates the pair's crossover, with (r | 1) < n; word 3
// of each row's own gates its mutation), word c % 4 of the kRealGamma call
// c / 4 of the even row where the pair mates, word c % 4 of the kGenes call
// c / 4 where the row mutates, and words 0-1 of the kRealNormal call c
// where that gate fires. Its plain version is the bits-input plain version
// fed deap_tpu_torch/ops/philox.py::hw_real_bits. Bound there: bytes of
// the genomes in and out and the fitness out (the Philox calls' integer
// multiplies come to a sixth of that).
//
// Its design: a block of 256 threads owns a tile of kTileRows (64) rows,
// 32 pairs, in chunks of 32 gene columns, so that every lane of every
// Philox call is a distinct call the decisions need and no row waits for
// another:
// - thread (warp w, lane l) holds columns c0 + l of the pairs w, w + 8,
//   w + 16, w + 24 (both rows of each: 8 genes in registers);
// - phase A: thread t < 64 makes row t's kPairRow call, then issues its
//   genes' loads (the other threads issue theirs at once): loads issued
//   before the call queue the key's load behind the tile's genes, and the
//   key starts the block's chain of calls. The mating pairs and the
//   mutating rows go on shared lists (tile_worklist.cuh::compact_mutants);
// - phase B, over all 256 threads, one list of items: the 8 kRealGamma
//   calls of each mating pair (once a pair, not once a row) into shared
//   gamma, and the 8 kGenes calls of each mutating row, each appending its
//   gated genes to a shared (row, column) list; after a barrier, one
//   kRealNormal call per listed gene into a shared step array that is +0.0
//   elsewhere (the list's order follows shared-memory atomics, and no
//   result depends on it: each item writes its own gene's step);
// - phase C: each thread crosses its two rows' genes with the pair's gamma,
//   adds the step, stores the children and adds each term to its lane's
//   sum;
// - the 8 rows a warp holds are summed by one transposed butterfly
//   (warp_row_sums), bitwise the bits path's order.
// L above 32 takes the same tile in chunks (kWide), the lane sums carried
// across them. ptxas (sm_90a): 40 registers, no spill, 17,008 bytes of
// shared memory a block (steps 8 KB, gamma 4 KB, the gated list 4 KB), 6
// blocks an SM; kWide 62 registers. Tiles of 128 rows (16 genes a thread),
// of 32, 512-thread blocks, a persistent grid prefetching the next tile,
// round keys kept in registers and the crossed genes evaluated during the
// normal calls all ran slower on the H100 (PERF.md §6).
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

// ------------------------------------------------------- bits path ----

// The draws of one row, streamed in (pairbits [n, 4], rowbits [n, 1],
// genebits [n, 4 L]).
struct Bits {
  const uint32_t* pairbits;
  const uint32_t* rowbits;
  const uint32_t* genebits;
  int L;

  __device__ __forceinline__ uint2 row(int r) const {
    return make_uint2(pairbits[static_cast<size_t>(r & ~1) * 4], rowbits[r]);
  }
  __device__ __forceinline__ uint32_t gamma(int r, int c) const {
    return genebits[4 * static_cast<size_t>(r & ~1) * L + c];
  }
  __device__ __forceinline__ uint32_t gate(int r, int c) const {
    return genebits[4 * static_cast<size_t>(r) * L + L + c];
  }
  __device__ __forceinline__ uint2 normal(int r, int c) const {
    const uint32_t* planes = genebits + 4 * static_cast<size_t>(r) * L;
    return make_uint2(planes[2 * L + c], planes[3 * L + c]);
  }
};

__global__ void __launch_bounds__(256)
fused_variation_real_kernel(const float* __restrict__ g, Bits bits,
                            float* __restrict__ out, float* __restrict__ fit,
                            int n, int L, float cxpb, float mutpb,
                            float indpb, float gamma_scale, float alpha,
                            float mu, float sigma, int eval) {
  const int lane = threadIdx.x & 31;
  const int warps = (gridDim.x * blockDim.x) >> 5;
  // r is the same for every lane of a warp, so the warp stays converged
  for (int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; r < n;
       r += warps) {
    const uint2 words = bits.row(r);
    const bool do_cx = (r | 1) < n && u01(words.x) < cxpb;
    const bool do_mut = u01(words.y) < mutpb;
    const size_t base = static_cast<size_t>(r) * L;
    const float* mate = g + static_cast<size_t>(r ^ 1) * L;
    float sum = 0.0f;
    for (int c = lane; c < L; c += 32) {
      float x = g[base + c];
      if (do_cx) {
        x = blend(gamma_of(gamma_scale, bits.gamma(r, c), alpha), mate[c], x);
      }
      float step = 0.0f;
      if (do_mut && u01(bits.gate(r, c)) < indpb) {
        const uint2 u = bits.normal(r, c);
        step = normal_step(u.x, u.y, mu, sigma);
      }
      x = x + step;  // + 0.0 where nothing mutates, as the TPU kernel adds
      out[base + c] = x;
      sum = add_term(sum, x, eval);
    }
    if (eval == kNone) continue;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    }
    if (lane == 0) fit[r] = row_fitness(sum, L, eval);
  }
}

// ----------------------------------------------------- Philox path ----

constexpr int kTileRows = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTilePairs = kTileRows / 2;
constexpr int kPairsPerWarp = kTilePairs / kWarps;  // pairs w + 8 k
constexpr int kChunk = 32;                          // columns, a lane each
constexpr int kChunkCalls = kChunk / 4;             // gamma or gate calls

struct alignas(16) RealTile {
  float step[kTileRows][kChunk];      // mu + sigma z where gated, else +0.0
  float gamma[kTilePairs][kChunk];    // the pair's blend factor, if it mates
  uint16_t gated[kTileRows * kChunk]; // row << 5 | column of gated genes
  int pair_slots[kTileRows];          // even rows of the mating pairs
  int mut_slots[kTileRows];           // the mutating rows
  int warp_counts[2][kWarps];
  int gated_count;
  bool mates[kTilePairs];
};

// Columns c of rows 2 p and 2 p + 1 for the warp's pairs p (0 past the
// genome or the population).
template <int kPairs>
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

template <bool kWide>
__global__ void __launch_bounds__(kThreads, kWide ? 3 : 4)
real_hw_kernel(const float* __restrict__ g,
               const uint32_t* __restrict__ key_ptr, float* __restrict__ out,
               float* __restrict__ fit, int n, int L, float cxpb, float mutpb,
               float indpb, float gamma_scale, float alpha, float mu,
               float sigma, int eval) {
  __shared__ RealTile s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * kTileRows;
  const uint2 key = load_key(key_ptr);
  const int chunks = kWide ? (L + kChunk - 1) / kChunk : (L > 0 ? 1 : 0);
  const int calls = (L + 3) >> 2;
  const uint32_t gate_below = u01_threshold(indpb);

  // phase A: the pair+row calls, then the genes' loads (a thread without
  // a call issues them at once; one with a call after it, so the key's
  // load is not queued behind them), then the lists of mating pairs and
  // mutating rows
  bool mates = false, mut = false;
  if (tid < kTileRows && row0 + tid < n) {
    const int r = row0 + tid;
    const uint4 d = draw(static_cast<uint32_t>(r), 0u, 0u, kPairRow, key);
    mut = u01(d.w) < mutpb;
    mates = (tid & 1) == 0 && (r | 1) < n && u01(d.x) < cxpb;
  }
  if (tid < kTileRows && (tid & 1) == 0) s.mates[tid >> 1] = mates;
  float x0[kPairsPerWarp], x1[kPairsPerWarp];
  load_pairs<kPairsPerWarp>(g, row0, n, L, lane, warp, x0, x1);
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
      load_pairs<kPairsPerWarp>(g, row0, n, L, c0 + lane, warp, x0, x1);
    }
    const int q0 = w0 * kChunkCalls;
    const int chunk_calls = min(calls - q0, kChunkCalls);

    // phase B: the gamma calls, once a mating pair, then the gate calls of
    // the mutating rows, as one list of items over the block's threads;
    // a gate call puts its gated genes on the list of normal calls
    const int gamma_items = n_pairs * kChunkCalls;
    for (int i = tid; i < gamma_items + n_mut * kChunkCalls; i += kThreads) {
      const bool is_gamma = i < gamma_items;
      const int item = is_gamma ? i : i - gamma_items;
      const int q = item & (kChunkCalls - 1);
      if (q >= chunk_calls) continue;
      const int t = (is_gamma ? s.pair_slots : s.mut_slots)[item / kChunkCalls];
      const int call = q0 + q;
      const uint4 d = draw(static_cast<uint32_t>(row0 + t),
                           static_cast<uint32_t>(call), 0u,
                           is_gamma ? kRealGamma : kGenes, key);
      if (is_gamma) {
        *reinterpret_cast<float4*>(&s.gamma[t >> 1][4 * q]) =
            make_float4(gamma_of(gamma_scale, d.x, alpha),
                        gamma_of(gamma_scale, d.y, alpha),
                        gamma_of(gamma_scale, d.z, alpha),
                        gamma_of(gamma_scale, d.w, alpha));
        continue;
      }
      uint32_t bits =
          flip_bits4(d, gate_below) & bits_below(L - 4 * call);  // < L only
      if (bits) {
        int at = atomicAdd(&s.gated_count, __popc(bits));
        for (; bits; bits &= bits - 1u) {
          s.gated[at++] =
              static_cast<uint16_t>(t << 5 | (4 * q + __ffs(bits) - 1));
        }
      }
    }
    __syncthreads();

    // the normal calls, one a gated gene
    const int n_gated = s.gated_count;
    for (int i = tid; i < n_gated; i += kThreads) {
      const int e = s.gated[i], t = e >> 5, col = e & (kChunk - 1);
      const uint4 d = draw(static_cast<uint32_t>(row0 + t),
                           static_cast<uint32_t>(c0 + col), 0u, kRealNormal,
                           key);
      s.step[t][col] = normal_step(d.x, d.y, mu, sigma);
    }
    __syncthreads();
    if (tid == 0) s.gated_count = 0;  // every thread has read it

    // phase C: cross, mutate, store, sum
    const int c = c0 + lane;
#pragma unroll
    for (int k = 0; k < kPairsPerWarp; ++k) {
      const int p = warp + kWarps * k;
      const int r = row0 + 2 * p;
      float y0 = x0[k], y1 = x1[k];
      if (s.mates[p]) {
        const float gm = s.gamma[p][lane];
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
  const Bits bits{static_cast<const uint32_t*>(pairbits),
                  static_cast<const uint32_t*>(rowbits),
                  static_cast<const uint32_t*>(genebits), L};
  const int threads = 256;  // 8 rows per block
  const int blocks = grid_for(static_cast<long long>(n) * 32, threads,
                              132 * 64);
  fused_variation_real_kernel<<<blocks, threads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), bits, static_cast<float*>(out),
      static_cast<float*>(fit), n, L, cxpb, mutpb, indpb, gamma_scale, alpha,
      mu, sigma, eval);
  return static_cast<int>(cudaGetLastError());
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
  const int blocks = grid_for(n, kTileRows, 1 << 30);  // a block a tile
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* gp = static_cast<const float*>(g);
  const uint32_t* kp = static_cast<const uint32_t*>(key);
  float* op = static_cast<float*>(out);
  float* fp = static_cast<float*>(fit);
  if (L <= kChunk) {
    real_hw_kernel<false><<<blocks, kThreads, 0, st>>>(
        gp, kp, op, fp, n, L, cxpb, mutpb, indpb, gamma_scale, alpha, mu,
        sigma, eval);
  } else {
    real_hw_kernel<true><<<blocks, kThreads, 0, st>>>(
        gp, kp, op, fp, n, L, cxpb, mutpb, indpb, gamma_scale, alpha, mu,
        sigma, eval);
  }
  return static_cast<int>(cudaGetLastError());
}
