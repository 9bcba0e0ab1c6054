// Pareto-dominance reductions over all pairs, without the [n, n] matrix.
//
// K7 dominated_weight_sums replaces deap_tpu/ops/kernels.py::
// dominated_weight_sums (Pallas body _dom_counts_kernel):
//     out[i] = sum over j dominating row i of weights[j]
// K8 dominated_weight_maxes replaces deap_tpu/ops/kernels.py::
// dominated_weight_maxes (Pallas body _dom_maxes_kernel):
//     out[i] = max over j dominating queries[i] of weights[j], 0 if none
// The plain versions are deap_tpu_torch/ops/kernels.py::
// dominated_weight_sums_plain and dominated_weight_maxes_plain.
//
// j dominates i iff all_k(w[j,k] >= w[i,k]) and any_k(w[j,k] > w[i,k]),
// with IEEE compares (no fast math): a NaN row never dominates and is
// never dominated, and a row of -inf (an invalid individual) dominates
// nothing. Rows past n are skipped instead of padded, which gives the
// TPU kernels' result.
//
// Bound on the H100: operations. n_i * n_j pairs of 2 m float32 compares
// each, against a few MB of input.
//
// Design: one thread per query row, whose m values stay in registers
// (a template unrolls m <= 8; larger m loops over a local array). Each
// block stages [TJ] rows of w column by column (structure of arrays, the
// TPU's wp.T) and their weights in shared memory; every thread of the
// block reads the same staged row at once, a broadcast without bank
// conflicts. K7 adds in ascending j, so its sums are deterministic (and
// exact for integer weights below 2^24 in any order). K8 is called by
// the prefix chain reduction with a few hundred queries against up to
// 100k rows, so one block of queries alone would leave most SMs idle:
// it also splits j across blocks (gridDim.y) and combines the partial
// maxima with atomicMax on the int bits of the output, which the wrapper
// zeroes first. Non-negative floats order like their bits, so the
// combine is exact and order-free.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int TJ = 256;     // rows of w staged per tile
constexpr int MAX_M = 32;   // the wrappers refuse more objectives

// Stage rows [j0, j0 + cnt) of w (row-major [*, m]) as tile[k * TJ + r],
// and their weights. Global reads are consecutive in the row-major layout.
__device__ __forceinline__ void stage(const float* __restrict__ w,
                                      const float* __restrict__ weights,
                                      float* tile, float* tw, long long j0,
                                      int cnt, int m) {
  const float* src = w + j0 * m;
  for (int t = threadIdx.x; t < cnt * m; t += THREADS) {
    const int r = t / m;
    tile[(t - r * m) * TJ + r] = src[t];
  }
  for (int t = threadIdx.x; t < cnt; t += THREADS) tw[t] = weights[j0 + t];
}

template <int M>
__device__ __forceinline__ bool dominated_by(const float* tile, int r,
                                             const float* wi, int m) {
  bool ge = true, gt = false;
  if (M > 0) {
#pragma unroll
    for (int k = 0; k < M; ++k) {
      const float b = tile[k * TJ + r];
      ge &= b >= wi[k];
      gt |= b > wi[k];
    }
  } else {
    for (int k = 0; k < m; ++k) {
      const float b = tile[k * TJ + r];
      ge &= b >= wi[k];
      gt |= b > wi[k];
    }
  }
  return ge && gt;
}

template <int M>
__global__ void __launch_bounds__(THREADS)
dom_sums_kernel(const float* __restrict__ w, const float* __restrict__ weights,
                float* __restrict__ out, int n, int m_rt) {
  extern __shared__ float smem[];
  const int m = M > 0 ? M : m_rt;
  float* tile = smem;
  float* tw = smem + m * TJ;
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const bool active = i < n;
  float wi[M > 0 ? M : MAX_M];
  if (active)
    for (int k = 0; k < m; ++k) wi[k] = w[i * m + k];
  float acc = 0.0f;
  for (long long j0 = 0; j0 < n; j0 += TJ) {
    const int cnt = static_cast<int>(n - j0 < TJ ? n - j0 : TJ);
    __syncthreads();
    stage(w, weights, tile, tw, j0, cnt, m);
    __syncthreads();
    if (active) {
#pragma unroll 4
      for (int r = 0; r < cnt; ++r)
        acc += dominated_by<M>(tile, r, wi, m) ? tw[r] : 0.0f;
    }
  }
  if (active) out[i] = acc;
}

template <int M>
__global__ void __launch_bounds__(THREADS)
dom_maxes_kernel(const float* __restrict__ w, const float* __restrict__ weights,
                 const float* __restrict__ queries, float* __restrict__ out,
                 int n, int nq, int m_rt, int rows_per_split) {
  extern __shared__ float smem[];
  const int m = M > 0 ? M : m_rt;
  float* tile = smem;
  float* tw = smem + m * TJ;
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const bool active = i < nq;
  float wi[M > 0 ? M : MAX_M];
  if (active)
    for (int k = 0; k < m; ++k) wi[k] = queries[i * m + k];
  const long long jbeg = static_cast<long long>(blockIdx.y) * rows_per_split;
  const long long jend = jbeg + rows_per_split < n ? jbeg + rows_per_split : n;
  float best = 0.0f;
  for (long long j0 = jbeg; j0 < jend; j0 += TJ) {
    const int cnt = static_cast<int>(jend - j0 < TJ ? jend - j0 : TJ);
    __syncthreads();
    stage(w, weights, tile, tw, j0, cnt, m);
    __syncthreads();
    if (active) {
#pragma unroll 4
      for (int r = 0; r < cnt; ++r) {
        const float v = tw[r];
        if (v > best && dominated_by<M>(tile, r, wi, m)) best = v;
      }
    }
  }
  if (active && best > 0.0f)
    atomicMax(reinterpret_cast<int*>(out) + i, __float_as_int(best));
}

size_t smem_bytes(int m) { return sizeof(float) * static_cast<size_t>(m + 1) * TJ; }

}  // namespace

extern "C" int dominated_weight_sums(const void* w, const void* weights,
                                     void* out, int n, int m, void* stream) {
  if (m < 1 || m > MAX_M) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(grid_for(n, THREADS, 1 << 30));
  const size_t smem = smem_bytes(m);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pw = static_cast<const float*>(w);
  const float* pt = static_cast<const float*>(weights);
  float* po = static_cast<float*>(out);
  switch (m) {
#define DTT_SUMS(M) \
    case M: dom_sums_kernel<M><<<grid, THREADS, smem, s>>>(pw, pt, po, n, m); break;
    DTT_SUMS(1) DTT_SUMS(2) DTT_SUMS(3) DTT_SUMS(4)
    DTT_SUMS(5) DTT_SUMS(6) DTT_SUMS(7) DTT_SUMS(8)
#undef DTT_SUMS
    default: dom_sums_kernel<0><<<grid, THREADS, smem, s>>>(pw, pt, po, n, m);
  }
  return static_cast<int>(cudaGetLastError());
}

// `out` must hold nq zeros. Rows of w are split into `nsplit` ranges of
// whole tiles, one per gridDim.y.
extern "C" int dominated_weight_maxes(const void* w, const void* weights,
                                      const void* queries, void* out, int n,
                                      int nq, int m, int nsplit, void* stream) {
  if (m < 1 || m > MAX_M || nsplit < 1 || nsplit > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (n + TJ - 1) / TJ;
  const int per = (tiles + nsplit - 1) / nsplit;
  const int rows_per_split = per * TJ;
  const dim3 grid(grid_for(nq, THREADS, 1 << 30), (tiles + per - 1) / per);
  const size_t smem = smem_bytes(m);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pw = static_cast<const float*>(w);
  const float* pt = static_cast<const float*>(weights);
  const float* pq = static_cast<const float*>(queries);
  float* po = static_cast<float*>(out);
  switch (m) {
#define DTT_MAXES(M)                                                     \
    case M: dom_maxes_kernel<M><<<grid, THREADS, smem, s>>>(             \
        pw, pt, pq, po, n, nq, m, rows_per_split); break;
    DTT_MAXES(1) DTT_MAXES(2) DTT_MAXES(3) DTT_MAXES(4)
    DTT_MAXES(5) DTT_MAXES(6) DTT_MAXES(7) DTT_MAXES(8)
#undef DTT_MAXES
    default: dom_maxes_kernel<0><<<grid, THREADS, smem, s>>>(
        pw, pt, pq, po, n, nq, m, rows_per_split);
  }
  return static_cast<int>(cudaGetLastError());
}
