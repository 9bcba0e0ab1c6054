// J3 and J4: the row passes of the exact non-domination sorts that the
// JAX package runs as one lax.scan each. Both carry the scan's order
// themselves: one block walks the rows in order, so no host round trip
// and no launch a row.
//
// J3 staircase_kernel replaces the scan of
// deap_tpu/mo/emo.py::nd_rank_staircase (M = 2). Its plain version is
// deap_tpu_torch/mo/emo.py::staircase_rows_plain. Rows arrive sorted
// lexicographically descending, as neg_f2 = -w1 and a head flag per row
// (the first of a group of identical rows). The state is one scalar per
// front found so far, its largest w1 kept negated: neg_m[0..F), ascending.
// A head's rank r is the count of fronts whose maximum covers it,
// searchsorted(neg_m, x, right=True); it then writes neg_m[r] = x (r == F
// opens a front). A row with x = +inf or NaN (w1 = -inf: an invalid row)
// counts every one of the JAX package's n slots, so its rank is n and its
// write goes to the dropped slot n. A row that is not a head takes the
// previous head's rank.
//
// J4 sweep_kernel replaces the scan of deap_tpu/mo/ndsort.py::
// nd_rank_sweep3 (M = 3); its plain version is deap_tpu_torch/mo/
// ndsort.py::sweep3_rows_plain. The gather and scatter tables Q and U
// int32[n, A*A] (A the bit length of n) of the Fenwick tree of Fenwick trees
// are built by torch beforehand; row i of a head takes r = max(state[Q[i,
// :]]), every row then scatters max(state, r + 1) into state[U[i, :]].
//
// Bound on the H100: neither kernel is near its bytes (J3 reads 5 bytes a
// row and writes 4; J4 reads 2 A*A int32 a row). Each is a serial chain
// of n dependent steps, so one SM works and its latency per step sets the
// time:
// - J3: one warp. Its 32 lanes search 32 pivots of the front maxima at a
//   time (each lane compares one, a ballot counts those <= x, the range
//   narrows to one stride), so a head costs ceil(log32 F) rounds of one
//   shared-memory load and a ballot. The maxima live in shared memory up
//   to `shared` slots (the card's 227 KB a block, 58,112 fronts) and in
//   device memory beyond, where the same warp reads back what its own
//   lane 0 wrote (ordered by __syncwarp). Rows come in as chunks of 32,
//   the next chunk's loads in flight while this one is walked, and each
//   chunk's ranks leave as one coalesced store.
// - J4: one block, a thread per table column (A*A <= 961 for n < 2^31).
//   A head row is one dependent load from the state (3.4 MB at n 100k:
//   L2), a block max and two barriers; every row's table entries are
//   loaded a row ahead.

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarp = 32;

__device__ __forceinline__ float front_max(const float* sm, const float* gm,
                                           int shared, int p) {
  return p < shared ? sm[p] : gm[p - shared];
}

__global__ void __launch_bounds__(kWarp)
staircase_kernel(const float* __restrict__ neg_f2,
                 const unsigned char* __restrict__ head, int n, int shared,
                 float* gm, int* __restrict__ ranks) {
  extern __shared__ float sm[];
  const int lane = threadIdx.x;
  int fronts = 0;  // F: the maxima neg_m[0..F) are written
  int r = 0;       // the last head's rank
  float xv = lane < n ? neg_f2[lane] : 0.0f;
  bool hv = lane < n && head[lane] != 0;
  for (int base = 0; base < n; base += kWarp) {
    const int next = base + kWarp + lane;
    float xn = 0.0f;
    bool hn = false;
    if (next < n) {
      xn = neg_f2[next];
      hn = head[next] != 0;
    }
    const unsigned heads = __ballot_sync(kFull, hv);
    const int rows = min(kWarp, n - base);
    int mine = 0;
    for (int j = 0; j < rows; ++j) {
      const float x = __shfl_sync(kFull, xv, j);
      if ((heads >> j) & 1u) {
        if (!(x < INFINITY)) {
          r = n;  // every slot covers it; the write goes to the dump
        } else {
          // count of neg_m[0..F) <= x: a range [lo, lo + len) still open,
          // 32 pivots a round at a stride of ceil(len / 32)
          int lo = 0, len = fronts;
          while (len > 0) {
            const int step = (len + kWarp - 1) / kWarp;
            const int p = lo + (lane + 1) * step - 1;
            const bool le = p < lo + len && front_max(sm, gm, shared, p) <= x;
            const int k = __popc(__ballot_sync(kFull, le));
            lo += k * step;
            len = min(step - 1, len - k * step);
          }
          r = lo;
          if (lane == 0) {
            if (r < shared) {
              sm[r] = x;
            } else {
              gm[r - shared] = x;
            }
          }
          fronts += r == fronts;
          __syncwarp();
        }
      }
      if (lane == j) mine = r;
    }
    if (base + lane < n) ranks[base + lane] = mine;
    xv = xn;
    hv = hn;
  }
}

__global__ void __launch_bounds__(1024)
sweep_kernel(const int* __restrict__ Q, const int* __restrict__ U,
             const unsigned char* __restrict__ head, int n, int cols,
             float* state, int* __restrict__ ranks) {
  __shared__ float warp_max[32];
  const int t = threadIdx.x;
  const int lane = t & (kWarp - 1), warp = t / kWarp;
  const int warps = blockDim.x / kWarp;
  const bool live = t < cols;
  int q = live ? Q[t] : 0, u = live ? U[t] : 0;
  bool h = head[0] != 0;
  float r = 0.0f;
  for (int i = 0; i < n; ++i) {
    int qn = 0, un = 0;
    bool hn = false;
    if (i + 1 < n) {
      const size_t row = static_cast<size_t>(i + 1) * cols;
      if (live) {
        qn = Q[row + t];
        un = U[row + t];
      }
      hn = head[i + 1] != 0;
    }
    // within a row only the dump slot repeats in U, so this row's writes
    // change no slot that another thread of it reads
    const float su = live ? state[u] : 0.0f;
    if (h) {
      float v = live ? state[q] : 0.0f;
      for (int o = kWarp / 2; o > 0; o /= 2)
        v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
      if (lane == 0) warp_max[warp] = v;
      __syncthreads();
      r = warp_max[0];
      for (int w = 1; w < warps; ++w) r = fmaxf(r, warp_max[w]);
    }
    if (t == 0) ranks[i] = static_cast<int>(r);
    if (live) state[u] = fmaxf(su, r + 1.0f);
    __syncthreads();
    q = qn;
    u = un;
    h = hn;
  }
}

}  // namespace

// neg_f2 float32[n] and head uint8[n] in lex-descending order; shared the
// front maxima kept in shared memory (1 <= shared <= n, at most 58,112),
// spill float32[n - shared] for the rest (unused when shared == n);
// ranks int32[n] out, in the same order. One launch on `stream`.
extern "C" int staircase_rows(const void* neg_f2, const void* head, int n,
                              int shared, void* spill, void* ranks,
                              void* stream) {
  if (n < 1 || n >= (1 << 30) || shared < 1 || shared > n)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = sizeof(float) * static_cast<size_t>(shared);
  cudaError_t err = cudaFuncSetAttribute(
      staircase_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  staircase_kernel<<<1, kWarp, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(neg_f2),
      static_cast<const unsigned char*>(head), n, shared,
      static_cast<float*>(spill), static_cast<int*>(ranks));
  return static_cast<int>(cudaGetLastError());
}

// Q, U int32[n, cols] (cols = A * A <= 1024) of flat state slots, head
// uint8[n], state float32 zeroed (every slot of Q and U inside it), ranks
// int32[n] out. One launch on `stream`.
extern "C" int sweep3_rows(const void* Q, const void* U, const void* head,
                           int n, int cols, void* state, void* ranks,
                           void* stream) {
  if (n < 1 || cols < 1 || cols > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (cols + kWarp - 1) / kWarp * kWarp;
  sweep_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(Q), static_cast<const int*>(U),
      static_cast<const unsigned char*>(head), n, cols,
      static_cast<float*>(state), static_cast<int*>(ranks));
  return static_cast<int>(cudaGetLastError());
}
