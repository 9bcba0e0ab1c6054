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
// functions, never the fast __cosf/__logf intrinsics.
//
// Bound on the H100: bytes. Genomes in and children out are 8 bytes per
// gene; a mating pair reads one gamma plane (4 bytes per gene), a
// mutating row its gate plane, and a mutated gene its two normal draws.
// The transcendental work (cos per gene for Rastrigin, log1p/sqrt/cos per
// mutated gene) is well under the float32 rate.
//
// Design: one warp per row, its lanes over the genes (L 30 fits one pass),
// so rows and planes are read coalesced; the partner row and the gamma
// plane are read only where the pair mates, the gate plane only where the
// row mutates and u1/u2 only where a gene mutates. The fitness is a warp
// sum, in another order than the plain version's sum.
//
// The Philox path (replacing _real_kernel_hw of
// deap_tpu/ops/kernels_real.py, which draws with the TPU core's generator)
// is the same kernel with every draw made in registers by philox4x32_10
// (csrc/philox.cuh, g = 0) from the key, and no draw tensor read: lane 0
// makes the pair+row call of the pair's even row (its word 0 gates the
// crossover), lane 1 the row's own (word 3 gates the mutation), shared by
// shuffles as in K2's Philox path; gene c takes word c % 4 of the
// kRealGamma call c / 4 of the even row where the pair mates, word c % 4 of
// the kGenes call c / 4 where the row mutates, and words 0-1 of the
// kRealNormal call c where its gate fires. Each lane makes the calls of its
// own gene: the four lanes of one call issue it together, one instruction
// stream for the warp. A warp is one row, so the odd row of a mating pair
// recomputes its pair's gamma calls (both rows make them). The plain
// version is the bits-input plain version fed
// deap_tpu_torch/ops/philox.py::hw_real_bits; the arithmetic after the
// draws is the bits path's, line for line, so the same tolerance holds.
// Bound there: bytes of the genomes in and out and the fitness out.
#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr float kTwoPi = 6.283185307179586f;
enum Eval { kNone = 0, kRastrigin = 1, kSphere = 2 };

// The draws of one row: streamed in (kHw false: pairbits [n, 4], rowbits
// [n, 1], genebits [n, 4 L]) or made by Philox from the key (kHw true).
template <bool kHw>
struct Draws {
  const uint32_t* pairbits;
  const uint32_t* rowbits;
  const uint32_t* genebits;
  uint2 key;
  int L;

  // (crossover word of the pair, mutation word of row r); every lane of
  // the warp calls it
  __device__ __forceinline__ uint2 row(int r, int lane) const {
    if constexpr (kHw) {
      const uint32_t i = static_cast<uint32_t>(lane == 1 ? r : (r & ~1));
      const uint4 own = draw(i, 0u, 0u, kPairRow, key);
      return make_uint2(__shfl_sync(0xffffffffu, own.x, 0),
                        __shfl_sync(0xffffffffu, own.w, 1));
    } else {
      return make_uint2(pairbits[static_cast<size_t>(r & ~1) * 4],
                        rowbits[r]);
    }
  }
  __device__ __forceinline__ uint32_t gamma(int r, int c) const {
    if constexpr (kHw) {
      return word_of(draw(static_cast<uint32_t>(r & ~1),
                          static_cast<uint32_t>(c >> 2), 0u, kRealGamma, key),
                     c & 3);
    } else {
      return genebits[4 * static_cast<size_t>(r & ~1) * L + c];
    }
  }
  __device__ __forceinline__ uint32_t gate(int r, int c) const {
    if constexpr (kHw) {
      return word_of(draw(static_cast<uint32_t>(r),
                          static_cast<uint32_t>(c >> 2), 0u, kGenes, key),
                     c & 3);
    } else {
      return genebits[4 * static_cast<size_t>(r) * L + L + c];
    }
  }
  // (u1, u2) words of gene c
  __device__ __forceinline__ uint2 normal(int r, int c) const {
    if constexpr (kHw) {
      const uint4 d = draw(static_cast<uint32_t>(r),
                           static_cast<uint32_t>(c), 0u, kRealNormal, key);
      return make_uint2(d.x, d.y);
    } else {
      const uint32_t* planes = genebits + 4 * static_cast<size_t>(r) * L;
      return make_uint2(planes[2 * L + c], planes[3 * L + c]);
    }
  }
};

template <bool kHw>
__global__ void __launch_bounds__(256)
fused_variation_real_kernel(const float* __restrict__ g, Draws<kHw> draws,
                            const uint32_t* __restrict__ key_ptr,
                            float* __restrict__ out, float* __restrict__ fit,
                            int n, int L, float cxpb, float mutpb,
                            float indpb, float gamma_scale, float alpha,
                            float mu, float sigma, int eval) {
  if constexpr (kHw) draws.key = load_key(key_ptr);
  const int lane = threadIdx.x & 31;
  const int warps = (gridDim.x * blockDim.x) >> 5;
  // r is the same for every lane of a warp, so the warp stays converged
  for (int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; r < n;
       r += warps) {
    const uint2 words = draws.row(r, lane);
    const bool do_cx = (r | 1) < n && u01(words.x) < cxpb;
    const bool do_mut = u01(words.y) < mutpb;
    const size_t base = static_cast<size_t>(r) * L;
    const float* mate = g + static_cast<size_t>(r ^ 1) * L;
    float sum = 0.0f;
    for (int c = lane; c < L; c += 32) {
      float x = g[base + c];
      if (do_cx) {
        const float gamma =
            __fmaf_rn(gamma_scale, u01(draws.gamma(r, c)), -alpha);
        x = __fmaf_rn(gamma, mate[c], (1.0f - gamma) * x);
      }
      float step = 0.0f;
      if (do_mut && u01(draws.gate(r, c)) < indpb) {
        const uint2 u = draws.normal(r, c);
        const float u1 = u01(u.x);
        const float u2 = u01(u.y);
        const float z = sqrtf(-2.0f * log1pf(-u1)) * cosf(kTwoPi * u2);
        step = __fadd_rn(mu, __fmul_rn(sigma, z));
      }
      x = x + step;  // + 0.0 where nothing mutates, as the TPU kernel adds
      out[base + c] = x;
      if (eval == kRastrigin) {
        sum += __fsub_rn(__fmul_rn(x, x), __fmul_rn(10.0f, cosf(kTwoPi * x)));
      } else if (eval == kSphere) {
        sum = __fadd_rn(sum, __fmul_rn(x, x));
      }
    }
    if (eval == kNone) continue;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    }
    if (lane == 0) {
      fit[r] = eval == kRastrigin ? 10.0f * static_cast<float>(L) + sum : sum;
    }
  }
}

template <bool kHw>
int launch(const float* g, Draws<kHw> draws, const uint32_t* key, float* out,
           float* fit, int n, int L, float cxpb, float mutpb, float indpb,
           float gamma_scale, float alpha, float mu, float sigma, int eval,
           void* stream) {
  if (eval < kNone || eval > kSphere) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = 256;  // 8 rows per block
  const int blocks = grid_for(static_cast<long long>(n) * 32, threads,
                              132 * 64);
  fused_variation_real_kernel<kHw><<<blocks, threads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      g, draws, key, out, fit, n, L, cxpb, mutpb, indpb, gamma_scale, alpha,
      mu, sigma, eval);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fused_variation_real(const void* g, const void* pairbits,
                                    const void* rowbits, const void* genebits,
                                    void* out, void* fit, int n, int L,
                                    float cxpb, float mutpb, float indpb,
                                    float gamma_scale, float alpha, float mu,
                                    float sigma, int eval, void* stream) {
  const Draws<false> draws{static_cast<const uint32_t*>(pairbits),
                           static_cast<const uint32_t*>(rowbits),
                           static_cast<const uint32_t*>(genebits),
                           make_uint2(0u, 0u), L};
  return launch<false>(static_cast<const float*>(g), draws, nullptr,
                       static_cast<float*>(out), static_cast<float*>(fit), n,
                       L, cxpb, mutpb, indpb, gamma_scale, alpha, mu, sigma,
                       eval, stream);
}

// The Philox path: the key is uint32[2] in device memory.
extern "C" int fused_variation_real_hw(const void* g, const void* key,
                                       void* out, void* fit, int n, int L,
                                       float cxpb, float mutpb, float indpb,
                                       float gamma_scale, float alpha,
                                       float mu, float sigma, int eval,
                                       void* stream) {
  const Draws<true> draws{nullptr, nullptr, nullptr, make_uint2(0u, 0u), L};
  return launch<true>(static_cast<const float*>(g), draws,
                      static_cast<const uint32_t*>(key),
                      static_cast<float*>(out), static_cast<float*>(fit), n,
                      L, cxpb, mutpb, indpb, gamma_scale, alpha, mu, sigma,
                      eval, stream);
}
