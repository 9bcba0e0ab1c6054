// Philox4x32-10 and the counter layout of the kernels' prng='hw' path.
//
// Replaces the TPU core's own generator (pltpu.prng_seed /
// pltpu.prng_random_bits) of the JAX package's hw bodies: _fused_kernel_hw
// (deap_tpu/ops/kernels.py), _packed_kernel_hw, _selgather_kernel_hw and
// _evolve_kernel_hw (deap_tpu/ops/packed.py), _real_kernel_hw
// (deap_tpu/ops/kernels_real.py). The plain version, which
// draws the same bits, is deap_tpu_torch/ops/philox.py::philox4x32_10; both
// hold this one written-out definition (Random123's Philox4x32 with 10
// rounds: multipliers 0xD2511F53 and 0xCD9E8D57, key bumps 0x9E3779B9 and
// 0xBB67AE85).
//
// The key (k0, k1) is two uint32 words in device memory, drawn by the
// wrapper from the caller's torch.Generator and read through a pointer (no
// host synchronise). A draw is one word of philox((i, j, g, tag), key):
// - kPairRow (row r, 0, g, 0): word 0 the crossover gate, words 1-2 the
//   cut points (read from the even row of each pair for both rows), word 3
//   row r's mutation gate;
// - kGenes (row r, i / 4, g, 1): word i % 4 is gene i's flip draw;
// - kTournament (child c, t / 4, g, 2): word t % 4 is aspirant t, % n;
// - kRealGamma (row r & ~1, i / 4, g, 3): word i % 4 is K6's blend draw of
//   gene i, one for both rows of a pair;
// - kRealNormal (row r, i, g, 4): words 0 and 1 are K6's Box-Muller u1 and
//   u2 of gene i.
// K6 takes its gene gates from kGenes, at the flip draws' coordinates.
// g is the generation inside one evolve_packed call, 0 elsewhere. A draw
// depends only on its coordinates, so a kernel makes just the draws its
// decisions need and block shapes may change without changing a result.
//
// Cost: 10 rounds of two 32x32-bit products, each a hi and a lo half: 40
// integer multiplies per call (IMAD.HI and IMAD on sm_90), plus the xors
// and the key bumps (none where the round keys are computed once,
// RoundKeys). There is one body, on round keys; the uint2 form computes
// them at the call.
#pragma once

#include "common.cuh"

enum : uint32_t {
  kPairRow = 0u,
  kGenes = 1u,
  kTournament = 2u,
  kRealGamma = 3u,
  kRealNormal = 4u
};

// The key's ten round keys (round r adds r bumps). A kernel that makes
// many calls computes them once and spares each call its key schedule.
struct RoundKeys {
  uint32_t x[10], y[10];
};

__device__ __forceinline__ RoundKeys round_keys(uint2 k) {
  RoundKeys rk;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    rk.x[r] = k.x + static_cast<uint32_t>(r) * 0x9E3779B9u;
    rk.y[r] = k.y + static_cast<uint32_t>(r) * 0xBB67AE85u;
  }
  return rk;
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, const RoundKeys& k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x[r], lo1, hi0 ^ c.w ^ k.y[r], lo0);
  }
  return c;
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
  return philox4x32_10(c, round_keys(k));
}

__device__ __forceinline__ uint4 draw(uint32_t i, uint32_t j, uint32_t g,
                                      uint32_t tag, const RoundKeys& key) {
  return philox4x32_10(make_uint4(i, j, g, tag), key);
}

__device__ __forceinline__ uint2 load_key(const uint32_t* key) {
  return make_uint2(key[0], key[1]);
}

__device__ __forceinline__ uint4 draw(uint32_t i, uint32_t j, uint32_t g,
                                      uint32_t tag, uint2 key) {
  return philox4x32_10(make_uint4(i, j, g, tag), key);
}

__device__ __forceinline__ uint32_t word_of(uint4 v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// The segment [lo, hi) of a mating pair from its cut-point words:
// p1 ~ U{1..L}, p2 ~ U{1..L-1} bumped past p1, float32 products as on the
// TPU.
__device__ __forceinline__ void cut_segment(uint32_t u1, uint32_t u2, int L,
                                            int* lo, int* hi) {
  const int p1 = 1 + static_cast<int>(u01(u1) * static_cast<float>(L));
  int p2 = 1 + static_cast<int>(u01(u2) * static_cast<float>(L - 1));
  if (p2 >= p1) p2 += 1;
  *lo = min(p1, p2);
  *hi = max(p1, p2);
}

// Tournament call `call` of child c in generation g: aspirants 4 call ..
// 4 call + 3, drawn % n (those past tournsize, or all where !valid, read
// as fitness 0), their fitness loads issued together before any compare.
// fit may be written by the calling kernel, so it is read through plain
// loads.
struct Aspirants {
  uint32_t idx[4];
  float fit[4];
};

__device__ __forceinline__ Aspirants aspirants(const float* fit, uint32_t c,
                                               int call, uint32_t g, int n,
                                               int tournsize, bool valid,
                                               const RoundKeys& key) {
  const uint32_t un = static_cast<uint32_t>(n);
  const uint4 d = draw(c, static_cast<uint32_t>(call), g, kTournament, key);
  Aspirants a = {{d.x % un, d.y % un, d.z % un, d.w % un}, {}};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    a.fit[k] = valid && 4 * call + k < tournsize ? fit[a.idx[k]] : 0.0f;
  return a;
}

// Winning population index of a tournament from its first 4 aspirants
// `first` and `next(call)`, the aspirants 4 call .. 4 call + 3 of each call
// after it: the first aspirant, then each later one with a strictly
// greater fitness (the first drawn wins ties). The Philox path and K4's
// bits body (selgather_packed.cu) feed it; a batch's fitness loads are
// issued together before any compare.
template <typename Next>
__device__ __forceinline__ uint32_t tournament(Aspirants a, int tournsize,
                                               Next next) {
  uint32_t best = a.idx[0];
  float best_fit = a.fit[0];
  for (int call = 0;;) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (4 * call + k < tournsize && a.fit[k] > best_fit) {
        best = a.idx[k];
        best_fit = a.fit[k];
      }
    }
    if (4 * ++call >= tournsize) return best;
    a = next(call);
  }
}

// Winning population index of child c's tournament in generation g, from
// its first call's aspirants `first` and the calls after it. A kernel that
// has work to do while the first call's loads are in flight makes that
// call itself (aspirants) and passes it.
__device__ __forceinline__ uint32_t hw_tournament(Aspirants first,
                                                  const float* fit,
                                                  uint32_t c, uint32_t g,
                                                  int n, int tournsize,
                                                  const RoundKeys& key) {
  return tournament(first, tournsize, [&](int call) {
    return aspirants(fit, c, call, g, n, tournsize, true, key);
  });
}

__device__ __forceinline__ uint32_t hw_tournament(const float* fit,
                                                  uint32_t c, uint32_t g,
                                                  int n, int tournsize,
                                                  const RoundKeys& key) {
  return hw_tournament(aspirants(fit, c, 0, g, n, tournsize, true, key), fit,
                       c, g, n, tournsize, key);
}

// The 4 flip bits of one gene call d: bit k set where word k draws below
// the gene rate, as (bits >> 8) < below with below = u01_threshold(indpb)
// (exactly u01(bits) < indpb).
__device__ __forceinline__ uint32_t flip_bits4(uint4 d, uint32_t below) {
  return static_cast<uint32_t>((d.x >> 8) < below) |
         static_cast<uint32_t>((d.y >> 8) < below) << 1 |
         static_cast<uint32_t>((d.z >> 8) < below) << 2 |
         static_cast<uint32_t>((d.w >> 8) < below) << 3;
}

// Flip word w of packed row r in generation g: bit b set where gene
// 32 w + b (< L) draws below the gene rate (below = u01_threshold(indpb));
// ceil(nb / 4) calls for the nb genes of the word, and the bits past gene
// L stay clear.
__device__ __forceinline__ uint32_t hw_flip_word(uint32_t r, int w, uint32_t g,
                                                 int L, uint32_t below,
                                                 uint2 key) {
  const int nb = min(32, L - 32 * w);
  uint32_t flip = 0u;
  for (int q = 0; q < nb; q += 4) {
    const uint4 d = draw(r, static_cast<uint32_t>((32 * w + q) >> 2), g,
                         kGenes, key);
    flip |= flip_bits4(d, below) << q;
  }
  return flip & bits_below(nb);
}

// The known-answer entry: out[4 t..] = philox(ctr[4 t..], key[2 t..]) for
// t < count, one thread each. Every library that includes this header has
// it, so each build's copy of the device function can be checked.
__global__ void philox_kat_kernel(const uint32_t* __restrict__ ctr,
                                  const uint32_t* __restrict__ key,
                                  uint32_t* __restrict__ out, int count) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= count) return;
  const uint4 c = make_uint4(ctr[4 * t], ctr[4 * t + 1], ctr[4 * t + 2],
                             ctr[4 * t + 3]);
  const uint4 v = philox4x32_10(c, make_uint2(key[2 * t], key[2 * t + 1]));
  out[4 * t] = v.x;
  out[4 * t + 1] = v.y;
  out[4 * t + 2] = v.z;
  out[4 * t + 3] = v.w;
}

extern "C" int philox_kat(const void* ctr, const void* key, void* out,
                          int count, void* stream) {
  const int threads = 128;
  philox_kat_kernel<<<grid_for(count, threads, 1 << 30), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(ctr), static_cast<const uint32_t*>(key),
      static_cast<uint32_t*>(out), count);
  return static_cast<int>(cudaGetLastError());
}
