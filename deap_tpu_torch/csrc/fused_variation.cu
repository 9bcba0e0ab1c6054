// Fused variation plane: selection gather + paired segment crossover +
// per-gene masked mutation, one pass over the children.
//
// Replaces deap_tpu/ops/kernels.py::fused_variation (Pallas body
// _fused_variation_kernel). Per output row r and gene c:
//   child = (cx[r] && lo[r] <= c < hi[r]) ? g[partner[r], c] : g[src[r], c]
//   if (mut[r] && mask[r, c]) child = flip(child) | child + arg | arg
// The plain version is deap_tpu_torch/ops/variation.py::apply_variation.
//
// Bound on the H100: bytes. Each child gene reads one parent gene and
// writes one gene; mutating rows also read their mask bytes (and, for
// add/set, the f32 arguments where the mask is set); the per-row scalars
// are a few bytes a row. There is no arithmetic to speak of. ea_simple's
// case (n 100k, L 100, bool, flip, mutpb 0.2) moves about 23 MB.
//
// The first design gave each gene a thread in a grid-stride loop: per
// one-byte gene a divide (e / L), reloads of up to five row scalars, a
// dependent one-byte load and a one-byte store, at 14% of the byte bound.
// This design (ops/kernels.py::_k1_plan plans its walk, and the CPU tests
// replay it):
// - a warp owns 32 child rows; each lane loads one row's scalars once,
//   coalesced, and the warp shares them by shuffles (no crossover is an
//   empty segment, so cx is folded into lo and hi);
// - genes move as units of W: four bool genes as one 32-bit word, four
//   float32 genes as one float4, where L % 4 == 0 and the pointers allow
//   it (W 4), else one gene a unit (W 1, any L). Children, mask and
//   argument rows are contiguous, so the warp walks its rows' units as one
//   flattened run: lane k takes unit k, coalesced, and steps by 32 units
//   with no divide;
// - the kernel waits on memory, and what sets its pace is the warps in
//   flight (measured: neither more units in flight a lane, nor L2
//   prefetches of the rows, nor sequential parents moved it; more warps
//   did, PERF.md). So each lane keeps only 2 words (1 float4) in flight,
//   ~40 registers, 48 warps an SM, and the wrapper cuts each batch's run
//   into as many slices, a warp each, as fill one such wave (2 at
//   ea_simple's 100k rows);
// - the segment choice is per unit: a unit inside the segment reads only
//   the partner's unit, one outside only src's, and only a unit that
//   straddles lo or hi reads both and blends them with a byte mask (bool)
//   or per lane (float4);
// - mask units are read only for mutating rows, arguments only for units
//   whose mask is set; bool flip is SIMD per byte (__vcmpne4 for a
//   nonzero mask byte, __vseteq4 for x == 0).
// Flip on a float genome is logical not (x == 0 -> 1, else 0), as
// apply_variation computes it; every result is bitwise the first
// design's.
#include "common.cuh"

namespace {

enum Kind { kFlip = 0, kAdd = 1, kSet = 2 };

constexpr int THREADS = 128;  // 4 warps a block
constexpr int ROWS = 32;      // child rows a warp: one row's scalars a lane
constexpr unsigned FULL = 0xffffffffu;

// Units each lane loads before it stores: 2 words, or 1 float4
constexpr int UNITS_IN_FLIGHT = 2;

__device__ __forceinline__ float to_f(uint8_t x) { return x ? 1.0f : 0.0f; }
__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ uint8_t from_f<uint8_t>(float v) {
  return v != 0.0f;  // float -> bool: nonzero (and NaN) is true
}
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }

__device__ __forceinline__ uint8_t flipped(uint8_t x) { return x == 0; }
__device__ __forceinline__ float flipped(float x) { return x == 0.0f ? 1.0f : 0.0f; }

// One gene's mutation; `a` is its argument (unused by flip).
template <int KIND, typename T>
__device__ __forceinline__ T mutated(T x, float a) {
  if (KIND == kFlip) return flipped(x);
  if (KIND == kAdd) return from_f<T>(to_f(x) + a);
  return from_f<T>(a);
}

// 0xFF in each of the bytes [0, k) of a word, k in [0, 4]
__device__ __forceinline__ uint32_t bytes_below(int k) {
  return k >= 4 ? 0xFFFFFFFFu : (1u << (8 * k)) - 1u;
}

// A unit of W genes of type T: its storage V, its mask bytes M and its
// arguments A, and how they load, blend and store. select(klo, khi) marks
// the unit's genes [klo, khi) (ALL: every gene), the ones blend takes from
// its second argument.
template <typename T, int W> struct Unit;

template <typename T> struct Unit<T, 1> {
  using V = T;
  using M = uint8_t;
  using A = float;
  static __device__ __forceinline__ V load(const T* p) { return __ldg(p); }
  static __device__ __forceinline__ M load_mask(const uint8_t* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ A load_arg(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ void store(T* p, V v) { *p = v; }
  static constexpr uint32_t ALL = 1u;
  static __device__ __forceinline__ uint32_t select(int klo, int khi) {
    return klo < khi;
  }
  static __device__ __forceinline__ V blend(V a, V b, uint32_t sel) {
    return sel ? b : a;
  }
  static __device__ __forceinline__ bool any(M m) { return m != 0; }
  template <int KIND>
  static __device__ __forceinline__ V mutate(V x, M m, A a) {
    return m ? mutated<KIND>(x, a) : x;
  }
};

// Four bool genes as one 32-bit word (byte j is gene j).
template <> struct Unit<uint8_t, 4> {
  using V = uint32_t;
  using M = uint32_t;
  using A = float4;
  static __device__ __forceinline__ V load(const uint8_t* p) {
    return __ldg(reinterpret_cast<const unsigned int*>(p));
  }
  static __device__ __forceinline__ M load_mask(const uint8_t* p) {
    return __ldg(reinterpret_cast<const unsigned int*>(p));
  }
  static __device__ __forceinline__ A load_arg(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void store(uint8_t* p, V v) {
    *reinterpret_cast<uint32_t*>(p) = v;
  }
  // 0xFF in the bytes of genes [klo, khi)
  static constexpr uint32_t ALL = 0xFFFFFFFFu;
  static __device__ __forceinline__ uint32_t select(int klo, int khi) {
    return bytes_below(khi) & ~bytes_below(klo);
  }
  static __device__ __forceinline__ V blend(V a, V b, uint32_t sel) {
    return (a & ~sel) | (b & sel);
  }
  static __device__ __forceinline__ bool any(M m) { return m != 0u; }
  template <int KIND>
  static __device__ __forceinline__ V mutate(V x, M m, A a) {
    if (KIND == kFlip) {
      const uint32_t on = __vcmpne4(m, 0u);  // 0xFF where the mask byte is set
      return (x & ~on) | (__vseteq4(x, 0u) & on);  // 1 where x == 0
    }
    const float arg[4] = {a.x, a.y, a.z, a.w};
    V r = x;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if ((m >> (8 * j)) & 0xFFu) {
        const uint8_t y = mutated<KIND>(static_cast<uint8_t>(x >> (8 * j)),
                                        arg[j]);
        r = (r & ~(0xFFu << (8 * j))) | (static_cast<uint32_t>(y) << (8 * j));
      }
    }
    return r;
  }
};

// Four float32 genes as one float4.
template <> struct Unit<float, 4> {
  using V = float4;
  using M = uint32_t;
  using A = float4;
  static __device__ __forceinline__ V load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ M load_mask(const uint8_t* p) {
    return __ldg(reinterpret_cast<const unsigned int*>(p));
  }
  static __device__ __forceinline__ A load_arg(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void store(float* p, V v) {
    *reinterpret_cast<float4*>(p) = v;
  }
  // bit j set for genes j in [klo, khi)
  static constexpr uint32_t ALL = 0xFu;
  static __device__ __forceinline__ uint32_t select(int klo, int khi) {
    return ((1u << khi) - 1u) & ~((1u << klo) - 1u);
  }
  static __device__ __forceinline__ V blend(V a, V b, uint32_t sel) {
    V r;
    r.x = (sel & 1u) ? b.x : a.x;
    r.y = (sel & 2u) ? b.y : a.y;
    r.z = (sel & 4u) ? b.z : a.z;
    r.w = (sel & 8u) ? b.w : a.w;
    return r;
  }
  static __device__ __forceinline__ bool any(M m) { return m != 0u; }
  template <int KIND>
  static __device__ __forceinline__ V mutate(V x, M m, A a) {
    V r;
    r.x = (m & 0xFFu) ? mutated<KIND>(x.x, a.x) : x.x;
    r.y = (m & 0xFF00u) ? mutated<KIND>(x.y, a.y) : x.y;
    r.z = (m & 0xFF0000u) ? mutated<KIND>(x.z, a.z) : x.z;
    r.w = (m & 0xFF000000u) ? mutated<KIND>(x.w, a.w) : x.w;
    return r;
  }
};

// How many of a unit's W genes, from its first gene c0, lie below the
// bound b: clamp(b - c0, 0, W), without overflow for any int32 b.
template <int W>
__device__ __forceinline__ int genes_below(int b, int c0) {
  return b <= c0 ? 0 : (b - c0 >= W ? W : b - c0);
}

// Warp w takes the batch of rows [32 (w / slices), +32) and the slice
// w % slices of its flattened run of units: units
// [slice * units_per_slice, +units_per_slice), unit k being gene unit
// k % U of row k / U (U = L / W units a row).
template <typename T, int W, int KIND>
__global__ void __launch_bounds__(THREADS)
fused_variation_kernel(const T* __restrict__ g, const int* __restrict__ src,
                       const int* __restrict__ partner,
                       const uint8_t* __restrict__ cx,
                       const int* __restrict__ lo, const int* __restrict__ hi,
                       const uint8_t* __restrict__ mut,
                       const uint8_t* __restrict__ mask,
                       const float* __restrict__ arg, T* __restrict__ out,
                       int n, int L, int slices, int units_per_slice) {
  using Un = Unit<T, W>;
  using V = typename Un::V;
  using M = typename Un::M;
  using A = typename Un::A;
  constexpr int D = (W == 4 && sizeof(T) == 4) ? UNITS_IN_FLIGHT / 2
                                                : UNITS_IN_FLIGHT;
  const int lane = threadIdx.x & 31;
  const int warp = static_cast<int>(
      (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) >> 5);
  const int batch = warp / slices;
  const int slice = warp - batch * slices;
  if (batch >= (n + ROWS - 1) / ROWS) return;  // the whole warp
  const int r0 = batch * ROWS;
  const int nb = min(ROWS, n - r0);

  // this lane's row of the batch: its scalars, loaded once
  int s_src = 0, s_par = 0, s_lo = 0, s_hi = 0, s_mut = 0;
  if (lane < nb) {
    const int r = r0 + lane;
    const int l = lo[r], h = hi[r];
    const bool c = cx[r] != 0;
    s_src = src[r];
    s_par = partner[r];
    s_lo = c ? l : 0;  // no crossover: the empty segment [0, 0)
    s_hi = c ? h : 0;
    s_mut = mut[r] != 0;
  }

  const int U = L / W;
  const int K = nb * U;
  const int kbeg = slice * units_per_slice;
  const int kend = min(kbeg + units_per_slice, K);
  // unit k of the run: row k / U, unit u = k % U; k steps by 32 units
  int k0 = kbeg + lane;
  int row = k0 / U;
  int u = k0 - row * U;
  const int qstep = 32 / U, rstep = 32 - qstep * U;
  // children, mask and arguments: rows contiguous, unit k at base + k W
  const size_t base = static_cast<size_t>(r0) * L;

  for (int kw = kbeg; kw < kend; kw += 32 * D) {  // warp-uniform
    V a[D], b[D];
    M m[D];
    uint32_t sel[D];  // the unit's genes from the partner
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int k = kw + 32 * d + lane;
      const int rs = __shfl_sync(FULL, s_src, row & 31);
      const int rp = __shfl_sync(FULL, s_par, row & 31);
      const int rl = __shfl_sync(FULL, s_lo, row & 31);
      const int rh = __shfl_sync(FULL, s_hi, row & 31);
      const int rm = __shfl_sync(FULL, s_mut, row & 31);
      const int c0 = u * W;
      sel[d] = Un::select(genes_below<W>(rl, c0), genes_below<W>(rh, c0));
      m[d] = 0;
      if (k < kend) {
        // a unit wholly in the segment reads the partner only, one outside
        // it src only, one across lo or hi both
        a[d] = Un::load(g + static_cast<long long>(sel[d] == Un::ALL ? rp : rs)
                        * L + c0);
        b[d] = (sel[d] != 0u && sel[d] != Un::ALL)
                   ? Un::load(g + static_cast<long long>(rp) * L + c0)
                   : a[d];
        if (rm) m[d] = Un::load_mask(mask + base + static_cast<size_t>(k) * W);
      }
      u += rstep;
      row += qstep;
      if (u >= U) {
        u -= U;
        ++row;
      }
    }
    A args[D] = {};
    if (KIND != kFlip) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int k = kw + 32 * d + lane;
        if (k < kend && Un::any(m[d]))
          args[d] = Un::load_arg(arg + base + static_cast<size_t>(k) * W);
      }
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int k = kw + 32 * d + lane;
      if (k < kend) {
        V child = Un::blend(a[d], b[d], sel[d]);
        if (Un::any(m[d])) child = Un::template mutate<KIND>(child, m[d], args[d]);
        Un::store(out + base + static_cast<size_t>(k) * W, child);
      }
    }
  }
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T>
int launch(const void* g, const void* src, const void* partner,
           const void* cx, const void* lo, const void* hi, const void* mut,
           const void* mask, const void* arg, void* out, int n, int L,
           int kind, int width, int slices, int units_per_slice,
           void* stream) {
  // the wrapper's plan (ops/kernels.py::_k1_plan): a slice per warp must
  // cover the longest batch's run
  if (n < 1 || L < 1 || slices < 1 || units_per_slice < 1 ||
      (width != 1 && width != 4) || L % width != 0 ||
      static_cast<long long>(slices) * units_per_slice <
          static_cast<long long>(n < ROWS ? n : ROWS) * (L / width))
    return static_cast<int>(cudaErrorInvalidValue);
  if (width == 4 && !(aligned(g, 4 * sizeof(T)) && aligned(out, 4 * sizeof(T))
                      && aligned(mask, 4) &&
                      (kind == kFlip || aligned(arg, 16))))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const long long warps =
      static_cast<long long>((n + ROWS - 1) / ROWS) * slices;
  if (warps > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (warps * 32 + THREADS - 1) / THREADS;
  void (*kernel)(const T*, const int*, const int*, const uint8_t*,
                 const int*, const int*, const uint8_t*, const uint8_t*,
                 const float*, T*, int, int, int, int);
#define DTT_K1(WIDTH)                                                    \
  switch (kind) {                                                        \
    case kFlip: kernel = fused_variation_kernel<T, WIDTH, kFlip>; break; \
    case kAdd: kernel = fused_variation_kernel<T, WIDTH, kAdd>; break;   \
    case kSet: kernel = fused_variation_kernel<T, WIDTH, kSet>; break;   \
    default: return static_cast<int>(cudaErrorInvalidValue);             \
  }
  if (width == 4) {
    DTT_K1(4)
  } else {
    DTT_K1(1)
  }
#undef DTT_K1
  kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(g), static_cast<const int*>(src),
      static_cast<const int*>(partner), static_cast<const uint8_t*>(cx),
      static_cast<const int*>(lo), static_cast<const int*>(hi),
      static_cast<const uint8_t*>(mut), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(arg), static_cast<T*>(out), n, L, slices,
      units_per_slice);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Genomes of bool (one byte, 0 or 1). `width` is the genes a unit (4 or
// 1), `slices` and `units_per_slice` cut each batch's run (the wrapper's
// ops/kernels.py::_k1_plan).
extern "C" int fused_variation_u8(const void* g, const void* src,
                                  const void* partner, const void* cx,
                                  const void* lo, const void* hi,
                                  const void* mut, const void* mask,
                                  const void* arg, void* out, int n, int L,
                                  int kind, int width, int slices,
                                  int units_per_slice, void* stream) {
  return launch<uint8_t>(g, src, partner, cx, lo, hi, mut, mask, arg, out,
                         n, L, kind, width, slices, units_per_slice, stream);
}

// Genomes of float32.
extern "C" int fused_variation_f32(const void* g, const void* src,
                                   const void* partner, const void* cx,
                                   const void* lo, const void* hi,
                                   const void* mut, const void* mask,
                                   const void* arg, void* out, int n, int L,
                                   int kind, int width, int slices,
                                   int units_per_slice, void* stream) {
  return launch<float>(g, src, partner, cx, lo, hi, mut, mask, arg, out, n,
                       L, kind, width, slices, units_per_slice, stream);
}
