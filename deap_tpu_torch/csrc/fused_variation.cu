// Fused variation plane: selection gather + paired segment crossover +
// per-gene masked mutation, one pass over the children.
//
// Replaces deap_tpu/ops/kernels.py::fused_variation (Pallas body
// _fused_variation_kernel). Per output row r and gene c:
//   child = (cx[r] && lo[r] <= c < hi[r]) ? g[partner[r], c] : g[src[r], c]
//   if (mut[r] && mask[r, c]) child = flip(child) | child + arg | arg
// The plain version is deap_tpu_torch/ops/variation.py::apply_variation.
//
// Bound on the H100: bytes. Per gene it reads one genome element, one mask
// byte (and one f32 argument for add/set) and writes one element; the
// per-row scalars are a few bytes per row. There is no arithmetic to
// speak of.
//
// Design: one thread per gene over the flattened [n, L] children in a
// grid-stride loop, so the mask, argument and output streams are read
// and written fully coalesced; the genome read of each gene comes from
// whichever parent row supplies it (self or partner), so each child gene
// reads one parent gene and no second row is staged. The TPU kernel
// copied both whole rows into VMEM and padded L to 128 lanes; neither is
// needed here. Flip on a float genome is logical not (x == 0 -> 1, else 0),
// as apply_variation computes it.
#include "common.cuh"

namespace {

enum Kind { kFlip = 0, kAdd = 1, kSet = 2 };

__device__ __forceinline__ float to_f(uint8_t x) { return x ? 1.0f : 0.0f; }
__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ uint8_t from_f<uint8_t>(float v) {
  return v != 0.0f;  // float -> bool: nonzero (and NaN) is true
}
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }

__device__ __forceinline__ uint8_t flipped(uint8_t x) { return x == 0; }
__device__ __forceinline__ float flipped(float x) { return x == 0.0f ? 1.0f : 0.0f; }

template <typename T, int KIND>
__global__ void __launch_bounds__(256)
fused_variation_kernel(const T* __restrict__ g, const int* __restrict__ src,
                       const int* __restrict__ partner,
                       const uint8_t* __restrict__ cx,
                       const int* __restrict__ lo, const int* __restrict__ hi,
                       const uint8_t* __restrict__ mut,
                       const uint8_t* __restrict__ mask,
                       const float* __restrict__ arg, T* __restrict__ out,
                       unsigned total, unsigned L) {
  // unsigned: total < 2^31 (the wrapper checks), so e + stride never wraps
  for (unsigned e = blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += gridDim.x * blockDim.x) {
    const unsigned r = e / L;
    const int c = static_cast<int>(e - r * L);
    const bool swap = cx[r] && c >= lo[r] && c < hi[r];
    const long long row = swap ? partner[r] : src[r];
    T child = g[row * L + c];
    if (mut[r] && mask[e]) {
      if (KIND == kFlip) {
        child = flipped(child);
      } else if (KIND == kAdd) {
        child = from_f<T>(to_f(child) + arg[e]);
      } else {
        child = from_f<T>(arg[e]);
      }
    }
    out[e] = child;
  }
}

template <typename T>
int launch(const void* g, const void* src, const void* partner,
           const void* cx, const void* lo, const void* hi, const void* mut,
           const void* mask, const void* arg, void* out, int n, int L,
           int kind, void* stream) {
  const int total = n * L;
  const int threads = 256;
  const int blocks = grid_for(total, threads, 132 * 32);
  void (*kernel)(const T*, const int*, const int*, const uint8_t*,
                 const int*, const int*, const uint8_t*, const uint8_t*,
                 const float*, T*, unsigned, unsigned);
  switch (kind) {
    case kFlip: kernel = fused_variation_kernel<T, kFlip>; break;
    case kAdd: kernel = fused_variation_kernel<T, kAdd>; break;
    case kSet: kernel = fused_variation_kernel<T, kSet>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(g), static_cast<const int*>(src),
      static_cast<const int*>(partner), static_cast<const uint8_t*>(cx),
      static_cast<const int*>(lo), static_cast<const int*>(hi),
      static_cast<const uint8_t*>(mut), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(arg), static_cast<T*>(out),
      static_cast<unsigned>(total), static_cast<unsigned>(L));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Genomes of bool (one byte, 0 or 1).
extern "C" int fused_variation_u8(const void* g, const void* src,
                                  const void* partner, const void* cx,
                                  const void* lo, const void* hi,
                                  const void* mut, const void* mask,
                                  const void* arg, void* out, int n, int L,
                                  int kind, void* stream) {
  return launch<uint8_t>(g, src, partner, cx, lo, hi, mut, mask, arg, out,
                         n, L, kind, stream);
}

// Genomes of float32.
extern "C" int fused_variation_f32(const void* g, const void* src,
                                   const void* partner, const void* cx,
                                   const void* lo, const void* hi,
                                   const void* mut, const void* mask,
                                   const void* arg, void* out, int n, int L,
                                   int kind, void* stream) {
  return launch<float>(g, src, partner, cx, lo, hi, mut, mask, arg, out, n,
                       L, kind, stream);
}
