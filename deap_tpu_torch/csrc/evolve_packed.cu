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
// deap_tpu/ops/packed.py) takes no draw tensors: the thread of pair p
// makes its draws in registers from the key (csrc/philox.cuh, counter word
// g = the generation inside this call): the two tournaments, one pair+row
// call for the even lane and one for the odd lane's mutation gate, and
// ceil(L / 4) gene calls for each lane that mutates. Its plain version is
// the bits-input plain version fed ops/philox.py::hw_evolve_bits. Bound
// there: the integer multiplies of the Philox calls (40 each).
#include <cooperative_groups.h>

#include "common.cuh"
#include "philox.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

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

__global__ void __launch_bounds__(kThreads)
evolve_hw_kernel(const uint32_t* __restrict__ pop0,
                 const float* __restrict__ fit0,
                 const uint32_t* __restrict__ key_ptr, uint32_t* pops,
                 float* fits, int n, int W, int L, int ngen, int tournsize,
                 float cxpb, float mutpb, float indpb) {
  cg::grid_group grid = cg::this_grid();
  const uint2 key = load_key(key_ptr);
  const size_t lanes = static_cast<size_t>(n);
  const int npairs = (n + 1) / 2;
  for (int gen = 0; gen < ngen; ++gen) {
    const int prev = (gen - 1) & 1;
    const uint32_t* src = gen == 0 ? pop0 : pops + prev * lanes * W;
    const float* fsrc = gen == 0 ? fit0 : fits + prev * lanes;
    uint32_t* dst = pops + (gen & 1) * lanes * W;
    float* fdst = fits + (gen & 1) * lanes;
    const uint32_t g = static_cast<uint32_t>(gen);
    for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < npairs;
         p += gridDim.x * blockDim.x) {
      const int a = 2 * p, b = a + 1;
      const bool has_b = b < n;
      const size_t pa = hw_tournament(fsrc, a, g, n, tournsize, key);
      const size_t pb =
          has_b ? hw_tournament(fsrc, b, g, n, tournsize, key) : pa;
      const uint4 da = draw(a, 0u, g, kPairRow, key);
      const bool do_cx = has_b && u01(da.x) < cxpb;
      int lo = 0, hi = 0;
      if (do_cx) cut_segment(da.y, da.z, L, &lo, &hi);
      const bool mut_a = u01(da.w) < mutpb;
      const bool mut_b = has_b && u01(draw(b, 0u, g, kPairRow, key).w) < mutpb;
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
        if (mut_a) xa ^= hw_flip_word(a, w, g, L, indpb, key);
        dst[static_cast<size_t>(a) * W + w] = xa;
        count_a += __popc(xa);
        if (has_b) {
          if (mut_b) xb ^= hw_flip_word(b, w, g, L, indpb, key);
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

// Launch `kernel` cooperatively with `args`: one thread per pair of
// lanes, at most as many blocks as the card holds at once.
int launch_resident(const void* kernel, void** args, int n, void* stream) {
  int device = 0, sms = 0, per_sm = 0, cooperative = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&cooperative, cudaDevAttrCooperativeLaunch,
                               device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!cooperative) return static_cast<int>(cudaErrorNotSupported);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  const int needed = grid_for((n + 1) / 2, kThreads, 1 << 30);
  const int blocks = needed < per_sm * sms ? needed : per_sm * sms;
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads),
                                    args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
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
                         n, stream);
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
  return launch_resident(reinterpret_cast<const void*>(evolve_hw_kernel),
                         args, n, stream);
}
