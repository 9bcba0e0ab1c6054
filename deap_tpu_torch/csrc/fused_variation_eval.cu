// One OneMax generation on byte (bool) or float32 genomes: adjacent-pair
// two-point crossover, flip-bit mutation, sum-of-genes fitness.
//
// Replaces deap_tpu/ops/kernels.py::fused_variation_eval (Pallas body
// _variation_body, bits-input path _fused_kernel_bits, plumbing
// run_fused_kernel). The plain version is
// deap_tpu_torch/ops/kernels.py::fused_variation_eval_plain. Random bits
// come in as uint32 streams in the TPU kernel's input layout without its
// padding: pairbits [n, 4] (the even row of each pair supplies both rows'
// crossover draws), rowbits [n, 1], genebits [n, L].
//
// The draw rules are the packed kernel's (csrc/packed_variation.cu): an
// odd last row never mates; p1 = 1 + int(u * L), p2 = 1 + int(u * (L-1))
// bumped past p1, segment [min, max); a gene flips where u < indpb in a
// row with rowu < mutpb; a float gene flips as 1 - x.
//
// Bound on the H100: bytes. The gene-bit stream is 4 bytes per gene, 4x a
// byte genome; a row that does not mutate needs none of it. The partner
// row is read only where the pair mates and the gene bits only where the
// row mutates, so the kernel moves only the bytes this generation's draws
// need.
//
// The first design (one warp per row, one gene per lane per pass, L 100
// in four passes of 1-byte loads, each after the row's draw loads, grid
// capped at 132 x 64 blocks) was bound by latency: too few bytes in
// flight, a chain of dependent round trips to device memory per row.
// Two variants now, chosen by the launcher (takes_vector), which tells
// the caller which one it launched:
// - vector, for L % 4 == 0 with the genomes (and children) 4-byte (bool)
//   or 16-byte (float32) aligned and the gene bits 16-byte aligned: lane
//   c of a warp owns genes 4c..4c+3, one uint32 word of a bool row or one
//   float4 of a float32 row (L 100: 25 lanes, one pass). It reads one
//   word of the row, one of the partner where the segment covers it and
//   one uint4 of gene bits where the row mutates; the segment and flip
//   masks are built per byte or per component. The grid is one wave of
//   resident warps, each walking rows; the draws of a warp's next row load
//   while it works on this one, so a row's loads all issue at once, with
//   no wait on its own draws. At n 100k, L 100 it runs at about 30% of
//   the byte bound. A torch copy of the genomes alone takes about half its
//   time, and the Philox variant below, which loads no draws, runs at that
//   copy's speed with crossover and mutation off: what the genome bytes
//   cost is near the floor, the rest is the draws' bytes and each row's
//   work (port_profile.py --kernel-times; PERF.md).
// - scalar, any other shape or alignment: one warp per row, its lanes
//   over the genes in strided passes (the first design).
// The fitness is a warp sum of per-lane sums: exact for 0/1 genes in any
// order.
//
// The Philox path (replacing _fused_kernel_hw of deap_tpu/ops/kernels.py)
// has the same two variants, its draws made in registers from the key
// (csrc/philox.cuh, g = 0) and no draw tensor read; in a row that mutates,
// one gene call gives the 4 genes of a vector lane (the scalar lane takes
// word c % 4 of call c / 4). Its plain version is the bits-input plain
// version fed ops/philox.py::hw_fused_bits. Bound there: bytes of the
// genomes in and out (no draw touches memory; 6.09 us at n 100k, L 100).
// - scalar: lane 0 of the row's warp makes the pair+row call of the pair's
//   even row, lane 1 that of the row itself, shared by shuffles.
// - vector: a warp per pair of rows, which answers what held the first
//   design (a warp per row, whose crossover decision waited on its own
//   Philox call before the partner's load could issue, with one row in
//   flight, 7 of 32 lanes idle at L 100 and the partner row read twice):
//   the words of both rows load together, the next two pairs' words load
//   while the warp works on this one, the pair+row calls of 16 pairs are
//   one call per lane made ahead, and each pair's rows are read once. The
//   per-pair work is kept lean (a segment per pair by shuffle, mutation
//   bits by one ballot, integer thresholds for the draws, a one-instruction
//   integer sum for bool rows), since with the genome bytes near a copy's
//   speed what is left is the instructions a pair costs. On an H100 (700
//   W) at n 100k, L 100 bool it takes ~20.4 us, 30% of the byte bound:
//   ~16.8 with crossover and mutation off, against ~15.5 for a torch copy
//   of the genomes (port_profile.py --kernel-times).
#include "common.cuh"
#include "philox.cuh"

namespace {

__device__ __forceinline__ uint8_t flip(uint8_t x) { return x == 0; }
__device__ __forceinline__ float flip(float x) { return 1.0f - x; }
__device__ __forceinline__ float value(uint8_t x) { return x ? 1.0f : 0.0f; }
__device__ __forceinline__ float value(float x) { return x; }

// The scalar variant.
template <typename T>
__global__ void __launch_bounds__(256)
fused_variation_eval_kernel(const T* __restrict__ g,
                            const uint32_t* __restrict__ pairbits,
                            const uint32_t* __restrict__ rowbits,
                            const uint32_t* __restrict__ genebits,
                            T* __restrict__ out, float* __restrict__ fit, int n,
                            int L, float cxpb, float mutpb, float indpb) {
  const int lane = threadIdx.x & 31;
  const int warps = (gridDim.x * blockDim.x) >> 5;
  // r is the same for every lane of a warp, so the warp stays converged
  for (int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; r < n;
       r += warps) {
    const uint32_t* pb = pairbits + static_cast<size_t>(r & ~1) * 4;
    const bool do_cx = (r | 1) < n && u01(pb[0]) < cxpb;
    int lo = 0, hi = 0;
    if (do_cx) {
      const int p1 = 1 + static_cast<int>(u01(pb[1]) * static_cast<float>(L));
      int p2 = 1 + static_cast<int>(u01(pb[2]) * static_cast<float>(L - 1));
      if (p2 >= p1) p2 += 1;
      lo = min(p1, p2);
      hi = max(p1, p2);
    }
    const bool do_mut = u01(rowbits[r]) < mutpb;
    const size_t base = static_cast<size_t>(r) * L;
    const T* mate = g + static_cast<size_t>(r ^ 1) * L;
    float sum = 0.0f;
    for (int c = lane; c < L; c += 32) {
      T x = (do_cx && c >= lo && c < hi) ? mate[c] : g[base + c];
      if (do_mut && u01(genebits[base + c]) < indpb) x = flip(x);
      out[base + c] = x;
      sum += value(x);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    }
    if (lane == 0) fit[r] = sum;
  }
}

// One word of 4 genes: a uint32 of 4 bool bytes, or a float4.
template <typename T> struct Word;
template <> struct Word<uint8_t> {
  using type = uint32_t;
  // genes [lo, hi) of the 4 from e0 come from y
  static __device__ __forceinline__ uint32_t segment(uint32_t x, uint32_t y,
                                                     int e0, int lo, int hi) {
    uint32_t m = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (e0 + b >= lo && e0 + b < hi) m |= 0xFFu << (8 * b);
    return (x & ~m) | (y & m);
  }
  // gene b flips (to x == 0) where its gene bits draw below the gene rate:
  // (bits >> 8) < below, below = u01_threshold(indpb) (exactly
  // u01(bits) < indpb)
  static __device__ __forceinline__ uint32_t mutate(uint32_t x, uint4 gb,
                                                    uint32_t below) {
    const uint32_t m = ((gb.x >> 8) < below ? 0xFFu : 0u) |
                       ((gb.y >> 8) < below ? 0xFF00u : 0u) |
                       ((gb.z >> 8) < below ? 0xFF0000u : 0u) |
                       ((gb.w >> 8) < below ? 0xFF000000u : 0u);
    const uint32_t flipped = __vcmpeq4(x, 0u) & 0x01010101u;
    return (x & ~m) | (flipped & m);
  }
  // a lane's share of a row sum, and the warp's total of the shares (an
  // integer count: exact in any order)
  using sum_type = unsigned;
  static __device__ __forceinline__ unsigned value(uint32_t x) {
    return __popc(__vcmpne4(x, 0u) & 0x01010101u);
  }
  static __device__ __forceinline__ float total(unsigned s) {
    return static_cast<float>(__reduce_add_sync(0xffffffffu, s));
  }
};
template <> struct Word<float> {
  using type = float4;
  static __device__ __forceinline__ float4 segment(float4 x, float4 y, int e0,
                                                   int lo, int hi) {
    float4 r;
    r.x = (e0 >= lo && e0 < hi) ? y.x : x.x;
    r.y = (e0 + 1 >= lo && e0 + 1 < hi) ? y.y : x.y;
    r.z = (e0 + 2 >= lo && e0 + 2 < hi) ? y.z : x.z;
    r.w = (e0 + 3 >= lo && e0 + 3 < hi) ? y.w : x.w;
    return r;
  }
  static __device__ __forceinline__ float4 mutate(float4 x, uint4 gb,
                                                  uint32_t below) {
    float4 r;
    r.x = (gb.x >> 8) < below ? 1.0f - x.x : x.x;
    r.y = (gb.y >> 8) < below ? 1.0f - x.y : x.y;
    r.z = (gb.z >> 8) < below ? 1.0f - x.z : x.z;
    r.w = (gb.w >> 8) < below ? 1.0f - x.w : x.w;
    return r;
  }
  using sum_type = float;
  static __device__ __forceinline__ float value(float4 x) {
    return ((x.x + x.y) + x.z) + x.w;
  }
  // the butterfly sum of the lanes' shares, in a fixed order
  static __device__ __forceinline__ float total(float s) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    return s;
  }
};

// A row's draws as loaded: pair words 0-2 of its pair's even row, its row
// word.
struct RowDraws {
  uint32_t cx, p1, p2, mut;
};

__device__ __forceinline__ RowDraws load_draws(
    const uint32_t* __restrict__ pairbits, const uint32_t* __restrict__ rowbits,
    int r, int n) {
  RowDraws d = {0xFFFFFFFFu, 0u, 0u, 0xFFFFFFFFu};  // no crossover, no mutation
  if (r < n) {
    const uint32_t* pb = pairbits + static_cast<size_t>(r & ~1) * 4;
    d.cx = pb[0];
    d.p1 = pb[1];
    d.p2 = pb[2];
    d.mut = rowbits[r];
  }
  return d;
}

template <typename T>
__global__ void __launch_bounds__(256)
fused_variation_eval_vector_kernel(const T* __restrict__ g,
                                   const uint32_t* __restrict__ pairbits,
                                   const uint32_t* __restrict__ rowbits,
                                   const uint32_t* __restrict__ genebits,
                                   T* __restrict__ out,
                                   float* __restrict__ fit, int n, int L,
                                   float cxpb, float mutpb, float indpb) {
  using W = typename Word<T>::type;
  const W* gw = reinterpret_cast<const W*>(g);
  const uint4* bw = reinterpret_cast<const uint4*>(genebits);
  W* ow = reinterpret_cast<W*>(out);
  const uint32_t gene_below = u01_threshold(indpb);
  const int words = L >> 2;
  const int lane = threadIdx.x & 31;
  const int warps = (gridDim.x * blockDim.x) >> 5;
  // r is the same for every lane of a warp, so the warp stays converged;
  // the draws of the warp's next row load while this row's genes do
  int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  RowDraws d = load_draws(pairbits, rowbits, r, n);
  for (; r < n; r += warps) {
    const RowDraws next = load_draws(pairbits, rowbits, r + warps, n);
    const bool do_cx = (r | 1) < n && u01(d.cx) < cxpb;
    int lo = 0, hi = 0;
    if (do_cx) {
      const int p1 = 1 + static_cast<int>(u01(d.p1) * static_cast<float>(L));
      int p2 = 1 + static_cast<int>(u01(d.p2) * static_cast<float>(L - 1));
      if (p2 >= p1) p2 += 1;
      lo = min(p1, p2);
      hi = max(p1, p2);
    }
    const bool do_mut = u01(d.mut) < mutpb;
    const W* row = gw + static_cast<size_t>(r) * words;
    const W* mate = gw + static_cast<size_t>(r ^ 1) * words;
    const uint4* bits = bw + static_cast<size_t>(r) * words;
    W* dst = ow + static_cast<size_t>(r) * words;
    typename Word<T>::sum_type sum = 0;
    for (int c = lane; c < words; c += 32) {
      const int e0 = 4 * c;
      W v = row[c];
      if (do_cx && lo < e0 + 4 && hi > e0)
        v = Word<T>::segment(v, mate[c], e0, lo, hi);
      if (do_mut) v = Word<T>::mutate(v, bits[c], gene_below);
      dst[c] = v;
      sum += Word<T>::value(v);
    }
    const float total = Word<T>::total(sum);
    if (lane == 0) fit[r] = total;
    d = next;
  }
}

// The vector variant's conditions: whole words per row, and every word
// (genomes, children, gene bits) aligned for its load or store.
template <typename T>
bool takes_vector(const void* g, const void* genebits, const void* out,
                  int L) {
  const uintptr_t align = 4 * sizeof(T);
  return L % 4 == 0 && reinterpret_cast<uintptr_t>(g) % align == 0 &&
         reinterpret_cast<uintptr_t>(out) % align == 0 &&
         reinterpret_cast<uintptr_t>(genebits) % 16 == 0;
}

template <typename T>
int launch(const void* g, const void* pairbits, const void* rowbits,
           const void* genebits, void* out, void* fit, int n, int L,
           float cxpb, float mutpb, float indpb, void* stream,
           int* vector) {
  const int threads = 256;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* pg = static_cast<const T*>(g);
  const uint32_t* pp = static_cast<const uint32_t*>(pairbits);
  const uint32_t* pr = static_cast<const uint32_t*>(rowbits);
  const uint32_t* pb = static_cast<const uint32_t*>(genebits);
  T* po = static_cast<T*>(out);
  float* pf = static_cast<float*>(fit);
  const bool vec = takes_vector<T>(g, genebits, out, L);
  if (vector != nullptr) *vector = vec;
  if (vec) {
    // as many warps as the card holds at once, each walking rows
    static int resident = 0;
    if (resident == 0) {
      int dev = 0, sms = 0, per_sm = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, fused_variation_eval_vector_kernel<T>, threads, 0);
      resident = sms * (per_sm > 0 ? per_sm : 1);
    }
    fused_variation_eval_vector_kernel<T>
        <<<grid_for(n, threads / 32, resident), threads, 0, s>>>(
            pg, pp, pr, pb, po, pf, n, L, cxpb, mutpb, indpb);
  } else {
    // 8 rows per block
    const int blocks = grid_for(static_cast<long long>(n) * 32, threads,
                                132 * 64);
    fused_variation_eval_kernel<T><<<blocks, threads, 0, s>>>(
        pg, pp, pr, pb, po, pf, n, L, cxpb, mutpb, indpb);
  }
  return static_cast<int>(cudaGetLastError());
}

// Lane 0's pair+row call of the pair's even row and lane 1's of row r,
// shared by shuffles: (crossover gate, cut 1, cut 2, row r's mutation word).
__device__ __forceinline__ uint4 hw_row_words(int r, int lane, uint2 key) {
  const uint32_t i = static_cast<uint32_t>(lane == 1 ? r : (r & ~1));
  const uint4 own = draw(i, 0u, 0u, kPairRow, key);
  return make_uint4(__shfl_sync(0xffffffffu, own.x, 0),
                    __shfl_sync(0xffffffffu, own.y, 0),
                    __shfl_sync(0xffffffffu, own.z, 0),
                    __shfl_sync(0xffffffffu, own.w, 1));
}

// The scalar variant of the Philox path.
template <typename T>
__global__ void __launch_bounds__(256)
fused_variation_eval_hw_kernel(const T* __restrict__ g,
                               const uint32_t* __restrict__ key_ptr,
                               T* __restrict__ out, float* __restrict__ fit,
                               int n, int L, float cxpb, float mutpb,
                               float indpb) {
  const uint2 key = load_key(key_ptr);
  const int lane = threadIdx.x & 31;
  const int warps = (gridDim.x * blockDim.x) >> 5;
  for (int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; r < n;
       r += warps) {
    const uint4 d = hw_row_words(r, lane, key);
    const bool do_cx = (r | 1) < n && u01(d.x) < cxpb;
    int lo = 0, hi = 0;
    if (do_cx) cut_segment(d.y, d.z, L, &lo, &hi);
    const bool do_mut = u01(d.w) < mutpb;
    const size_t base = static_cast<size_t>(r) * L;
    const T* mate = g + static_cast<size_t>(r ^ 1) * L;
    float sum = 0.0f;
    for (int c = lane; c < L; c += 32) {
      T x = (do_cx && c >= lo && c < hi) ? mate[c] : g[base + c];
      if (do_mut &&
          u01(word_of(draw(r, static_cast<uint32_t>(c >> 2), 0u, kGenes, key),
                      c & 3)) < indpb)
        x = flip(x);
      out[base + c] = x;
      sum += value(x);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    }
    if (lane == 0) fit[r] = sum;
  }
}

// The vector variant of the Philox path: a warp per pair of rows. Lane c
// holds word c of both rows (kSlots words of each, 32 apart, in chunks of
// 32 kSlots words), so a pair's rows are read once and both children are
// written by one warp. The warp walks its pairs with the words of the next
// two chunks loading while it works on this one; the pair+row calls of its
// next 16 pairs are one call per lane, made together, their decisions kept
// as a segment per pair and a ballot of mutation bits; a mutating row's
// gene calls are made before its words are touched.
template <typename T, int kSlots>
__global__ void __launch_bounds__(256)
fused_variation_eval_vector_hw_kernel(const T* __restrict__ g,
                                      const uint32_t* __restrict__ key_ptr,
                                      T* __restrict__ out,
                                      float* __restrict__ fit, int n, int L,
                                      float cxpb, float mutpb, float indpb) {
  using W = typename Word<T>::type;
  using S = typename Word<T>::sum_type;
  constexpr int kSpan = 32 * kSlots;  // words of a chunk
  const uint2 key = load_key(key_ptr);
  const uint32_t cx_below = u01_threshold(cxpb);
  const uint32_t mut_below = u01_threshold(mutpb);
  const uint32_t gene_below = u01_threshold(indpb);
  const int words = L >> 2;
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int warps = (gridDim.x * blockDim.x) >> 5;
  const int pairs = (n + 1) >> 1;
  const int chunks = (words + kSpan - 1) / kSpan;
  // from one of the warp's pairs to its next
  const size_t step = static_cast<size_t>(2 * warps) * words;
  // the next item to load: pair lp, chunk lch, row lrow (the same in every
  // lane); the warp's pairs are warp, warp + warps, ...
  int lp = warp, lch = 0;
  const W* lrow =
      reinterpret_cast<const W*>(g) + static_cast<size_t>(2 * warp) * words;
  auto load_next = [&](W* a, W* b) {
    if (lp < pairs) {
      const bool has_b = 2 * lp + 1 < n;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int c = lch * kSpan + 32 * s + lane;
        if (c < words) {
          a[s] = lrow[c];
          if (has_b) b[s] = lrow[words + c];
        }
      }
    }
    if (++lch == chunks) {
      lch = 0;
      lp += warps;
      lrow += step;
    }
  };
  W a0[kSlots], b0[kSlots], a1[kSlots], b1[kSlots];
  load_next(a0, b0);
  load_next(a1, b1);
  W* da = reinterpret_cast<W*>(out) + static_cast<size_t>(2 * warp) * words;
  // lane j's decisions for row j & 1 of the warp's pair k + j / 2 of a batch
  // of 16: the pair's segment [lo, hi) (empty without crossover) on its even
  // lane, every row's mutation as a bit of `muts`
  int lo_j = 0, hi_j = 0;
  unsigned muts = 0u;
  S sum_a = 0, sum_b = 0;
  for (int p = warp, ch = 0, k = 0; p < pairs;) {
    W a2[kSlots], b2[kSlots];
    load_next(a2, b2);
    if (ch == 0 && (k & 15) == 0) {
      const int row = 2 * (p + (lane >> 1) * warps) + (lane & 1);
      const uint4 d = draw(static_cast<uint32_t>(row), 0u, 0u, kPairRow, key);
      lo_j = hi_j = 0;
      if ((row | 1) < n && (d.x >> 8) < cx_below)
        cut_segment(d.y, d.z, L, &lo_j, &hi_j);
      muts = __ballot_sync(0xffffffffu, (d.w >> 8) < mut_below);
    }
    const int slot = 2 * (k & 15);
    const int lo = __shfl_sync(0xffffffffu, lo_j, slot);
    const int hi = __shfl_sync(0xffffffffu, hi_j, slot);
    const int ra = 2 * p;
    const bool has_b = ra + 1 < n;
    const bool mut_a = (muts >> slot) & 1u;
    const bool mut_b = has_b && ((muts >> (slot + 1)) & 1u);
    // the gene calls of the mutating rows, before the words are touched
    uint4 fa[kSlots], fb[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const uint32_t c = static_cast<uint32_t>(ch * kSpan + 32 * s + lane);
      if (mut_a) fa[s] = draw(static_cast<uint32_t>(ra), c, 0u, kGenes, key);
      if (mut_b)
        fb[s] = draw(static_cast<uint32_t>(ra + 1), c, 0u, kGenes, key);
    }
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int c = ch * kSpan + 32 * s + lane;
      if (c < words) {
        const int e0 = 4 * c;
        W va = a0[s], vb = b0[s];
        if (lo < e0 + 4 && hi > e0) {
          const W t = Word<T>::segment(va, vb, e0, lo, hi);
          vb = Word<T>::segment(vb, va, e0, lo, hi);
          va = t;
        }
        if (mut_a) va = Word<T>::mutate(va, fa[s], gene_below);
        da[c] = va;
        sum_a += Word<T>::value(va);
        if (has_b) {
          if (mut_b) vb = Word<T>::mutate(vb, fb[s], gene_below);
          da[words + c] = vb;
          sum_b += Word<T>::value(vb);
        }
      }
      a0[s] = a1[s];
      b0[s] = b1[s];
      a1[s] = a2[s];
      b1[s] = b2[s];
    }
    if (++ch == chunks) {
      const float fa_sum = Word<T>::total(sum_a);
      const float fb_sum = Word<T>::total(sum_b);
      if (lane == 0) fit[ra] = fa_sum;
      if (lane == 1 && has_b) fit[ra + 1] = fb_sum;
      sum_a = sum_b = 0;
      ch = 0;
      p += warps;
      ++k;
      da += step;
    }
  }
}

// Blocks of `threads` that the card holds at once for `kernel`.
int resident_blocks(const void* kernel, int threads) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  return sms * (per_sm > 0 ? per_sm : 1);
}

template <typename T>
int launch_hw(const void* g, const void* key, void* out, void* fit, int n,
              int L, float cxpb, float mutpb, float indpb, void* stream,
              int* vector) {
  const int threads = 256;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* pg = static_cast<const T*>(g);
  const uint32_t* pk = static_cast<const uint32_t*>(key);
  T* po = static_cast<T*>(out);
  float* pf = static_cast<float*>(fit);
  // no gene bits: only the genomes' alignment decides
  const bool vec = takes_vector<T>(g, nullptr, out, L);
  if (vector != nullptr) *vector = vec;
  if (vec) {
    // one slot of words per lane up to L 128, two above (chunks of 64
    // words past L 256); as many warps as the card holds, each walking
    // pairs
    const int pairs = (n + 1) / 2;
    if (L <= 128) {
      static const int resident = resident_blocks(
          reinterpret_cast<const void*>(
              fused_variation_eval_vector_hw_kernel<T, 1>),
          threads);
      fused_variation_eval_vector_hw_kernel<T, 1>
          <<<grid_for(pairs, threads / 32, resident), threads, 0, s>>>(
              pg, pk, po, pf, n, L, cxpb, mutpb, indpb);
    } else {
      static const int resident = resident_blocks(
          reinterpret_cast<const void*>(
              fused_variation_eval_vector_hw_kernel<T, 2>),
          threads);
      fused_variation_eval_vector_hw_kernel<T, 2>
          <<<grid_for(pairs, threads / 32, resident), threads, 0, s>>>(
              pg, pk, po, pf, n, L, cxpb, mutpb, indpb);
    }
  } else {
    const int blocks = grid_for(static_cast<long long>(n) * 32, threads,
                                132 * 64);
    fused_variation_eval_hw_kernel<T><<<blocks, threads, 0, s>>>(
        pg, pk, po, pf, n, L, cxpb, mutpb, indpb);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry sets *vector (when not null) to 1 where it launched the vector
// variant, else 0.

// Genomes of bool (one byte, 0 or 1).
extern "C" int fused_variation_eval_u8(const void* g, const void* pairbits,
                                       const void* rowbits,
                                       const void* genebits, void* out,
                                       void* fit, int n, int L, float cxpb,
                                       float mutpb, float indpb,
                                       void* stream, int* vector) {
  return launch<uint8_t>(g, pairbits, rowbits, genebits, out, fit, n, L, cxpb,
                         mutpb, indpb, stream, vector);
}

// Genomes of float32.
extern "C" int fused_variation_eval_f32(const void* g, const void* pairbits,
                                        const void* rowbits,
                                        const void* genebits, void* out,
                                        void* fit, int n, int L, float cxpb,
                                        float mutpb, float indpb,
                                        void* stream, int* vector) {
  return launch<float>(g, pairbits, rowbits, genebits, out, fit, n, L, cxpb,
                       mutpb, indpb, stream, vector);
}


// The Philox path, key uint32[2] on the card; *vector as above.
extern "C" int fused_variation_eval_hw_u8(const void* g, const void* key,
                                          void* out, void* fit, int n, int L,
                                          float cxpb, float mutpb,
                                          float indpb, void* stream,
                                          int* vector) {
  return launch_hw<uint8_t>(g, key, out, fit, n, L, cxpb, mutpb, indpb,
                            stream, vector);
}

extern "C" int fused_variation_eval_hw_f32(const void* g, const void* key,
                                           void* out, void* fit, int n, int L,
                                           float cxpb, float mutpb,
                                           float indpb, void* stream,
                                           int* vector) {
  return launch_hw<float>(g, key, out, fit, n, L, cxpb, mutpb, indpb, stream,
                          vector);
}
