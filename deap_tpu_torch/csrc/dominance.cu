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
// each, against a few MB of input (K7 at n 100k, m 3: 6e10 compares).
//
// K7 design. The first design gave each thread one query row and, for
// every staged row j, loaded j's m values and its weight as m + 1 scalar
// broadcasts from shared memory: shared-load issue (about one warp
// instruction per SM clock) and the predicate logic around the compares
// held it at 30% of the compare bound. Now, for m <= 8:
// - each thread holds R query rows in registers (R 8 for m <= 4, 4 for
//   m 5-8), so one staged row is compared against R queries;
// - a staged row is V float4s, its m values then its weight
//   ({w0, w1, w2, weight} at m 3), read with V broadcast LDS.128s;
// - per pair one predicate chain: the OR of the m `>` then the AND of the
//   m `>=` (non-short-circuit bool ops), which compiles to 2 m chained
//   FSETPs and one predicated FADD (at m 3, 7.4 instructions per pair
//   with the loads). FSETP goes to the ALU pipe, which issues 64 lanes
//   per SM clock, not the 128 compares the bound counts (inferred from
//   the measured times, PERF.md; no profiler reads the pipes there), so
//   the chain caps the kernel near 50% of its compare bound;
// - so the wrapper cuts the pairs instead: it sorts the rows by objective
//   0, descending, rows with a NaN last, and gives each block of queries
//   a prune limit: only the rows at least as large in objective 0 as the
//   block's last query can dominate one of its queries, and the block
//   stages no row past it (about half the pairs at n 100k; the bound
//   counts only the pairs compared);
// - the rows j are split across gridDim.y into S ranges of whole tiles
//   (chosen by the wrapper, ops/kernels.py::_k7_splits), so n 50k and
//   100k give thousands of blocks although a block holds 128 R queries.
//   Each block writes its range's partial sums to row blockIdx.y of a
//   [S, n] scratch (the output itself when S = 1); a block whose range
//   starts past its prune limit returns at once, and a second kernel adds
//   each row's partials of the ranges below the limit.
// Summation order, for each query: within a range, the sorted order
// (descending objective 0, ties in row order); then the ranges in
// ascending order. No atomics, so the result is the same bits from run to
// run, and exact for integer weights while every partial and total stays
// below 2^24 in magnitude (so bitwise equal to the plain version there).
// Query rows past n are NaN, which no row dominates. m 9-32 takes the
// generic kernel: one query row per thread, the tile staged column by
// column (structure of arrays) and read by scalar broadcasts, with the
// same order, prune limit, split and combine.
//
// K8 dominated_weight_maxes (the prefix chain reduction's cross step: a
// few hundred queries against up to 100k ranked rows) had kept the first
// design: one query per thread, scalar staging, m + 1 shared loads a
// pair, at 10% of its compare bound. Now, for m <= 8, K7's register
// blocking:
// - each thread holds R query rows in registers (R 4 for m <= 4, 2 for
//   m 5-8: a block of 128 threads holds 512 or 256 queries, the prefix
//   reduction's block), and a staged row is V float4s, its m values then
//   its weight, read with V broadcast LDS.128s;
// - per pair one predicate chain, the OR of the m `>` then the AND of the
//   m `>=`, and a predicated fmaxf of the weight into the query's maximum
//   (the first design's `weight > best && dominated`, for weights >= 0);
// - the weight skip, hoisted to the thread: a row is compared only if its
//   weight exceeds the smallest maximum of the thread's live queries,
//   refreshed after each tile (a NaN query, or one past nq, is never
//   dominated and does not hold the skip back), so a warp steps over rows
//   that cannot raise any of its maxima;
// - the rows j are split across gridDim.y into S ranges of whole
//   32-row chunks (ops/kernels.py::_k8_splits), enough for a few blocks
//   an SM even when the queries fill one block (512 queries at 16k rows
//   as at 50k);
// - each block combines its maxima into the output with atomicMax on the
//   int bits (a fire-and-forget RED), which the wrapper zeroes first.
//   Non-negative floats order like their bits, so that combine is exact
//   and order-free, and the result is bitwise the plain version's.
// m 9-32 takes the generic kernel: one query per thread, the tile staged
// column by column and read by scalar broadcasts, with the same split and
// combine.
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

__device__ __forceinline__ bool dominated_by(const float* tile, int r,
                                             const float* wi, int m) {
  bool ge = true, gt = false;
  for (int k = 0; k < m; ++k) {
    const float b = tile[k * TJ + r];
    ge &= b >= wi[k];
    gt |= b > wi[k];
  }
  return ge && gt;
}

// Query rows per thread of K7 at m <= 4; a build may set another count
// (port_profile.py --k7-variants times them), which the wrapper must be
// told (ops/kernels.py::_k7_rows_per_thread).
#ifndef DTT_K7_ROWS
#define DTT_K7_ROWS 8
#endif

// K7's shape for m <= 8: V float4s per staged row (its m values, then
// its weight), R query rows per thread.
template <int M>
struct SumsShape {
  static constexpr int V = (M + 4) / 4;
  static constexpr int R = M <= 4 ? DTT_K7_ROWS : 4;
};

// Sum over the rows [blockIdx.y * rows_per_split, +rows_per_split) of w
// that dominate each of the block's 128 R query rows, into row blockIdx.y
// of dst ([gridDim.y, n]).
template <int M>
__global__ void __launch_bounds__(THREADS)
dom_sums_kernel(const float* __restrict__ w, const float* __restrict__ weights,
                const int* __restrict__ limit, float* __restrict__ dst, int n,
                int rows_per_split) {
  constexpr int V = SumsShape<M>::V;
  constexpr int R = SumsShape<M>::R;
  __shared__ float4 tile[TJ * V];
  // row indices below n fit an int, which keeps the loop's registers few
  const int jbeg = blockIdx.y * rows_per_split;
  const int jlim = min(jbeg + rows_per_split, limit[blockIdx.x]);
  if (jbeg >= jlim) return;  // past the prune limit: the sum skips this range
  const long long i0 =
      static_cast<long long>(blockIdx.x) * (THREADS * R) + threadIdx.x;
  float a[R][M];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const long long i = i0 + q * THREADS;
#pragma unroll
    for (int k = 0; k < M; ++k)
      a[q][k] = i < n ? w[i * M + k] : __int_as_float(0x7fc00000);  // NaN
  }
  float acc[R];
#pragma unroll
  for (int q = 0; q < R; ++q) acc[q] = 0.0f;
  for (int j0 = jbeg; j0 < jlim; j0 += TJ) {
    const int cnt = min(jlim - j0, TJ);
    __syncthreads();
    for (int t = threadIdx.x; t < cnt * V; t += THREADS) {
      const int r = t / V;
      const int v = t - r * V;
      const float* row = w + static_cast<long long>(j0 + r) * M;
      float e[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int k = 4 * v + c;
        e[c] = k < M ? row[k] : (k == M ? weights[j0 + r] : 0.0f);
      }
      tile[t] = make_float4(e[0], e[1], e[2], e[3]);
    }
    __syncthreads();
#pragma unroll 2
    for (int r = 0; r < cnt; ++r) {
      float b[4 * V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float4 t4 = tile[r * V + v];
        b[4 * v] = t4.x;
        b[4 * v + 1] = t4.y;
        b[4 * v + 2] = t4.z;
        b[4 * v + 3] = t4.w;
      }
#pragma unroll
      for (int q = 0; q < R; ++q) {
        // one predicate chain: OR of the m `>`, then AND of the m `>=`
        bool dom = b[0] > a[q][0];
#pragma unroll
        for (int k = 1; k < M; ++k) dom = dom | (b[k] > a[q][k]);
#pragma unroll
        for (int k = 0; k < M; ++k) dom = dom & (b[k] >= a[q][k]);
        if (dom) acc[q] += b[M];
      }
    }
  }
  float* out = dst + static_cast<long long>(blockIdx.y) * n;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const long long i = i0 + q * THREADS;
    if (i < n) out[i] = acc[q];
  }
}

// K7 for any m <= MAX_M: one query row per thread, scalar staging; the
// same split of j as dom_sums_kernel.
__global__ void __launch_bounds__(THREADS)
dom_sums_generic_kernel(const float* __restrict__ w,
                        const float* __restrict__ weights,
                        const int* __restrict__ limit,
                        float* __restrict__ dst, int n, int m,
                        int rows_per_split) {
  extern __shared__ float smem[];
  float* tile = smem;
  float* tw = smem + m * TJ;
  const long long jbeg = static_cast<long long>(blockIdx.y) * rows_per_split;
  const long long jlim = min(jbeg + rows_per_split,
                             static_cast<long long>(limit[blockIdx.x]));
  if (jbeg >= jlim) return;
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const bool active = i < n;
  float wi[MAX_M];
  if (active)
    for (int k = 0; k < m; ++k) wi[k] = w[i * m + k];
  float acc = 0.0f;
  for (long long j0 = jbeg; j0 < jlim; j0 += TJ) {
    const int cnt = static_cast<int>(jlim - j0 < TJ ? jlim - j0 : TJ);
    __syncthreads();
    stage(w, weights, tile, tw, j0, cnt, m);
    __syncthreads();
    if (active) {
#pragma unroll 4
      for (int r = 0; r < cnt; ++r)
        acc += dominated_by(tile, r, wi, m) ? tw[r] : 0.0f;
    }
  }
  if (active) dst[static_cast<long long>(blockIdx.y) * n + i] = acc;
}

// out[i] = the partial sums of row i over the ranges below its block's
// prune limit (the ranges a block of the sums kernel wrote), added in
// ascending order.
__global__ void __launch_bounds__(256)
sum_splits_kernel(const float* __restrict__ partial,
                  const int* __restrict__ limit, float* __restrict__ out,
                  int n, int rows_per_block, int rows_per_split) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= n) return;
  const int ranges =
      (limit[i / rows_per_block] + rows_per_split - 1) / rows_per_split;
  float s = partial[i];
  for (int k = 1; k < ranges; ++k)
    s += partial[static_cast<long long>(k) * n + i];
  out[i] = s;
}

// K8 splits the rows of w into ranges of whole chunks of this many rows
// (ops/kernels.py::_K8_SPLIT_ROWS)
constexpr int K8_CHUNK = 32;

// K8's shape for m <= 8: V float4s per staged row (its m values, then
// its weight), R query rows per thread (ops/kernels.py::
// _k8_rows_per_thread).
template <int M>
struct MaxesShape {
  static constexpr int V = (M + 4) / 4;
  static constexpr int R = M <= 4 ? 4 : 2;
};

// The largest weight among the rows [blockIdx.y * rows_per_split,
// +rows_per_split) of w that dominate each of the block's 128 R queries,
// combined into out with atomicMax.
template <int M>
__global__ void __launch_bounds__(THREADS)
dom_maxes_kernel(const float* __restrict__ w, const float* __restrict__ weights,
                 const float* __restrict__ queries, float* __restrict__ out,
                 int n, int nq, int rows_per_split) {
  constexpr int V = MaxesShape<M>::V;
  constexpr int R = MaxesShape<M>::R;
  __shared__ float4 tile[TJ * V];
  const int jbeg = blockIdx.y * rows_per_split;
  const int jend = min(jbeg + rows_per_split, n);
  const long long i0 =
      static_cast<long long>(blockIdx.x) * (THREADS * R) + threadIdx.x;
  const int lane = threadIdx.x & 31;
  float a[R][M];
  float best[R];
  bool live[R];  // a query some row may dominate
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const long long i = i0 + q * THREADS;
    bool nan = false;
#pragma unroll
    for (int k = 0; k < M; ++k) {
      a[q][k] = i < nq ? queries[i * M + k] : __int_as_float(0x7fc00000);
      nan |= a[q][k] != a[q][k];
    }
    best[q] = 0.0f;
    live[q] = !nan;
  }
  // the weight a row must exceed to raise one of this thread's maxima
  float skip = __int_as_float(0x7f800000);
#pragma unroll
  for (int q = 0; q < R; ++q)
    if (live[q]) skip = 0.0f;
  for (int j0 = jbeg; j0 < jend; j0 += TJ) {
    const int cnt = min(jend - j0, TJ);
    __syncthreads();
    for (int t = threadIdx.x; t < cnt * V; t += THREADS) {
      const int r = t / V;
      const int v = t - r * V;
      const float* row = w + static_cast<long long>(j0 + r) * M;
      float e[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int k = 4 * v + c;
        e[c] = k < M ? row[k] : (k == M ? weights[j0 + r] : 0.0f);
      }
      tile[t] = make_float4(e[0], e[1], e[2], e[3]);
    }
    __syncthreads();
    // the weight a row must exceed to raise a maximum of any lane's
    float wskip = skip;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      wskip = fminf(wskip, __shfl_xor_sync(0xffffffffu, wskip, off));
    for (int g0 = 0; g0 < cnt; g0 += 32) {
      // the weight skip, a group of 32 staged rows at a time: the warp
      // steps over them when none can raise any of its maxima
      float gmax = g0 + lane < cnt
                       ? reinterpret_cast<const float*>(tile)[(g0 + lane) * 4 * V + M]
                       : 0.0f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        gmax = fmaxf(gmax, __shfl_xor_sync(0xffffffffu, gmax, off));
      if (!(gmax > wskip)) continue;
      const int gend = min(g0 + 32, cnt);
#pragma unroll 2
      for (int r = g0; r < gend; ++r) {
        float b[4 * V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float4 t4 = tile[r * V + v];
          b[4 * v] = t4.x;
          b[4 * v + 1] = t4.y;
          b[4 * v + 2] = t4.z;
          b[4 * v + 3] = t4.w;
        }
#pragma unroll
        for (int q = 0; q < R; ++q) {
          // one predicate chain: OR of the m `>`, then AND of the m `>=`
          bool dom = b[0] > a[q][0];
#pragma unroll
          for (int k = 1; k < M; ++k) dom = dom | (b[k] > a[q][k]);
#pragma unroll
          for (int k = 0; k < M; ++k) dom = dom & (b[k] >= a[q][k]);
          if (dom) best[q] = fmaxf(best[q], b[M]);
        }
      }
    }
    skip = __int_as_float(0x7f800000);
#pragma unroll
    for (int q = 0; q < R; ++q)
      if (live[q]) skip = fminf(skip, best[q]);
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const long long i = i0 + q * THREADS;
    if (i < nq && best[q] > 0.0f)
      atomicMax(reinterpret_cast<int*>(out) + i, __float_as_int(best[q]));
  }
}

// K8 for any m <= MAX_M: one query per thread, scalar staging; the same
// split of j and combine as dom_maxes_kernel.
__global__ void __launch_bounds__(THREADS)
dom_maxes_generic_kernel(const float* __restrict__ w,
                         const float* __restrict__ weights,
                         const float* __restrict__ queries,
                         float* __restrict__ out, int n, int nq, int m,
                         int rows_per_split) {
  extern __shared__ float smem[];
  float* tile = smem;
  float* tw = smem + m * TJ;
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const bool active = i < nq;
  float wi[MAX_M];
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
        if (v > best && dominated_by(tile, r, wi, m)) best = v;
      }
    }
  }
  if (active && best > 0.0f)
    atomicMax(reinterpret_cast<int*>(out) + i, __float_as_int(best));
}

size_t smem_bytes(int m) { return sizeof(float) * static_cast<size_t>(m + 1) * TJ; }

}  // namespace

// w and weights hold the rows in descending order of objective 0, rows
// with a NaN last (the wrapper sorts them), and limit[b] is how many of
// them can dominate a query of block b (those at least as large in
// objective 0 as the block's last query, or n). Rows of w are split into
// `nsplit` ranges of whole tiles, one per gridDim.y; nsplit must be
// ceil(tiles / ceil(tiles / nsplit)), so that no range is empty. With
// nsplit > 1, `partial` holds nsplit * n floats of scratch; with nsplit 1
// it is not read. `out` is in the sorted order too.
extern "C" int dominated_weight_sums(const void* w, const void* weights,
                                     const void* limit, void* out,
                                     void* partial, int n, int m, int nsplit,
                                     void* stream) {
  const int tiles = (n + TJ - 1) / TJ;
  if (m < 1 || m > MAX_M || n < 1 || nsplit < 1 || nsplit > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per = (tiles + nsplit - 1) / nsplit;
  if ((tiles + per - 1) / per != nsplit)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows_per_split = per * TJ;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pw = static_cast<const float*>(w);
  const float* pt = static_cast<const float*>(weights);
  const int* pl = static_cast<const int*>(limit);
  float* po = static_cast<float*>(out);
  float* dst = nsplit == 1 ? po : static_cast<float*>(partial);
  int rows_per_block = THREADS;
  switch (m) {
#define DTT_SUMS(M)                                                      \
    case M: dom_sums_kernel<M><<<dim3(grid_for(n, THREADS * SumsShape<M>::R, \
                                               1 << 30), nsplit),        \
                                 THREADS, 0, s>>>(pw, pt, pl, dst, n,     \
                                                  rows_per_split);        \
      rows_per_block = THREADS * SumsShape<M>::R;                         \
      break;
    DTT_SUMS(1) DTT_SUMS(2) DTT_SUMS(3) DTT_SUMS(4)
    DTT_SUMS(5) DTT_SUMS(6) DTT_SUMS(7) DTT_SUMS(8)
#undef DTT_SUMS
    default:
      dom_sums_generic_kernel<<<dim3(grid_for(n, THREADS, 1 << 30), nsplit),
                                THREADS, smem_bytes(m), s>>>(
          pw, pt, pl, dst, n, m, rows_per_split);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return static_cast<int>(err);
  sum_splits_kernel<<<grid_for(n, 256, 1 << 30), 256, 0, s>>>(
      dst, pl, po, n, rows_per_block, rows_per_split);
  return static_cast<int>(cudaGetLastError());
}

// `out` must hold nq zeros. Rows of w are split into `nsplit` ranges of
// whole K8_CHUNK-row chunks, one per gridDim.y; nsplit must be
// ceil(chunks / ceil(chunks / nsplit)), so that no range is empty
// (ops/kernels.py::_k8_splits).
extern "C" int dominated_weight_maxes(const void* w, const void* weights,
                                      const void* queries, void* out, int n,
                                      int nq, int m, int nsplit, void* stream) {
  if (m < 1 || m > MAX_M || n < 1 || nq < 1 || nsplit < 1 || nsplit > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (n + K8_CHUNK - 1) / K8_CHUNK;
  const int per = (chunks + nsplit - 1) / nsplit;
  if ((chunks + per - 1) / per != nsplit)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows_per_split = per * K8_CHUNK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pw = static_cast<const float*>(w);
  const float* pt = static_cast<const float*>(weights);
  const float* pq = static_cast<const float*>(queries);
  float* po = static_cast<float*>(out);
  switch (m) {
#define DTT_MAXES(M)                                                     \
    case M: dom_maxes_kernel<M><<<dim3(grid_for(nq, THREADS *            \
                                                MaxesShape<M>::R,        \
                                                1 << 30), nsplit),       \
                                  THREADS, 0, s>>>(pw, pt, pq, po, n, nq, \
                                                   rows_per_split);       \
      break;
    DTT_MAXES(1) DTT_MAXES(2) DTT_MAXES(3) DTT_MAXES(4)
    DTT_MAXES(5) DTT_MAXES(6) DTT_MAXES(7) DTT_MAXES(8)
#undef DTT_MAXES
    default:
      dom_maxes_generic_kernel<<<dim3(grid_for(nq, THREADS, 1 << 30), nsplit),
                                 THREADS, smem_bytes(m), s>>>(
          pw, pt, pq, po, n, nq, m, rows_per_split);
  }
  return static_cast<int>(cudaGetLastError());
}
