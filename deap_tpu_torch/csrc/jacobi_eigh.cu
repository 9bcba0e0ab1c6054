// J1: batched symmetric eigendecomposition by fixed-sweep parallel Jacobi.
//
// jacobi_rounds_kernel runs every round of deap_tpu/ops/linalg.py::
// eigh_jacobi, an XLA function (not a Pallas kernel): the port's own kernel
// for it. Plain version: deap_tpu_torch/ops/linalg.py::eigh_jacobi_plain;
// the wrapper, ops/linalg.py::eigh_jacobi, sorts the spectrum afterwards.
//
// Algorithm, per matrix: A = 0.5 (C + C^T), V = I, then sweeps x (m - 1)
// rounds of the round-robin schedule (m = d rounded up to even; the
// wrapper passes the pairs, p | q << 16, ops/linalg.py::_round_robin_
// schedule). A round takes the m / 2 disjoint pairs (p, q) at once:
//   1. a thread per pair computes c and s from app, aqq, apq (the JAX
//      function's tau, t, c, s, with its `small` test: |apq| <= FLT_MIN or
//      a bye, p == q);
//   2. rows: a thread per (pair, column j) sets A[p,j] = c A[p,j] - s A[q,j]
//      and A[q,j] = c A[q,j] + s A[p,j] in place;
//   3. columns: a thread per (pair, row i) does the same to A[i,p], A[i,q]
//      and to V[i,p], V[i,q], and zeroes the rotated pivots A[q,p], A[p,q]
//      by a product with 0 (the plain version's pivot mask; the zero keeps
//      the sign of the value it replaces);
// a block barrier between the phases. A bye (b, b) takes the same
// arithmetic with c = 1, s = +0: 1 a + 0 a.
//
// Rounding: every product, sum, quotient and square root is an intrinsic
// rounded to nearest (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn,
// __fsqrt_rn), which nvcc never contracts into a fused multiply-add, in
// the plain version's order, so the kernel equals the plain version on
// the card bit for bit.
//
// Design. The rounds of one matrix are a chain of sweeps x (m - 1)
// dependent steps (891 at d 100), so one block owns a matrix and runs the
// whole chain in one launch, with no host wait; a batch is a grid of
// blocks. A and V live in dynamic shared memory, 2 d ld 4 bytes, with an
// odd row stride ld (d + 1 for an even d where it fits) so that a warp
// walking a column in phase 3 touches 32 banks; that fits up to d 170 in
// the 227 KB a block may opt into (cudaFuncSetAttribute before each
// launch). Above it the same kernel (kShared false) keeps A in the
// wrapper's workspace and V in the output, in device memory (L1 and L2
// hold them), and shares only the pair data. No tensor cores, TMA or
// clusters: the kernel is the simple first design.
//
// Bound on the H100: operations. Phases 2 and 3 do 3 d^2 / 2 pair updates
// of 2 products and a sum each per round (rows, A's columns, V's columns):
// sweeps x (m - 1) x 9 d^2 float32 operations, 8.0e7 at d 100, in one SM
// for one matrix (a batch spreads over min(batch, SMs) SMs).

#include <float.h>

#include "common.cuh"

namespace {

struct Pair {
  int p, q;
};

__device__ __forceinline__ Pair unpack(int pq) { return {pq & 0xFFFF, pq >> 16}; }

// torch.sign: 1, -1, or 0 (for +-0 and NaN)
__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// c * x + sp * y, each operation rounded on its own
__device__ __forceinline__ float rot(float c, float x, float sp, float y) {
  return __fadd_rn(__fmul_rn(c, x), __fmul_rn(sp, y));
}

template <bool kShared>
__global__ void __launch_bounds__(1024)
jacobi_rounds_kernel(const float* __restrict__ C, const int* __restrict__ pairs,
                     float* __restrict__ w_out, float* V_out, float* work, int d,
                     int n_rounds, int sweeps, int ld) {
  extern __shared__ float smem[];
  const int npairs = (d + 1) / 2;
  const long long mat = static_cast<long long>(blockIdx.x) * d * d;
  const float* Cm = C + mat;
  float *A, *V, *pc;
  if (kShared) {
    A = smem;
    V = smem + d * ld;
    pc = smem + 2 * d * ld;
  } else {
    A = work + mat;
    V = V_out + mat;
    pc = smem;
    ld = d;
  }
  float* ps = pc + npairs;
  int* ppq = reinterpret_cast<int*>(ps + npairs);

  for (int e = threadIdx.x; e < d * d; e += blockDim.x) {
    const int i = e / d, j = e - i * d;
    A[i * ld + j] = __fmul_rn(0.5f, __fadd_rn(Cm[i * d + j], Cm[j * d + i]));
    V[i * ld + j] = i == j ? 1.0f : 0.0f;
  }
  __syncthreads();

  const int items = npairs * d;
  int r = 0;
  for (int it = 0; it < sweeps * n_rounds; ++it) {
    // 1. the pair's rotation
    for (int k = threadIdx.x; k < npairs; k += blockDim.x) {
      const int pq = __ldg(pairs + r * npairs + k);
      const Pair x = unpack(pq);
      const float app = A[x.p * ld + x.p], aqq = A[x.q * ld + x.q];
      const float apq = A[x.p * ld + x.q];
      const bool small = fabsf(apq) <= FLT_MIN || x.p == x.q;
      const float tau = __fdiv_rn(__fsub_rn(aqq, app),
                                  small ? 1.0f : __fmul_rn(2.0f, apq));
      float t = __fdiv_rn(
          sign_of(tau),
          __fadd_rn(fabsf(tau), __fsqrt_rn(__fadd_rn(1.0f, __fmul_rn(tau, tau)))));
      if (tau == 0.0f) t = 1.0f;
      float c = __frcp_rn(__fsqrt_rn(__fadd_rn(1.0f, __fmul_rn(t, t))));
      const float s = small ? 0.0f : __fmul_rn(t, c);
      if (small) c = 1.0f;
      pc[k] = c;
      ps[k] = s;
      ppq[k] = pq;
    }
    __syncthreads();
    // 2. rows p and q of A
    for (int e = threadIdx.x; e < items; e += blockDim.x) {
      const int k = e / d, j = e - k * d;
      const Pair x = unpack(ppq[k]);
      const float c = pc[k], s = ps[k];
      const float ap = A[x.p * ld + j];
      if (x.p == x.q) {
        A[x.p * ld + j] = rot(c, ap, s, ap);
      } else {
        const float aq = A[x.q * ld + j];
        A[x.p * ld + j] = rot(c, ap, -s, aq);
        A[x.q * ld + j] = rot(c, aq, s, ap);
      }
    }
    __syncthreads();
    // 3. columns p and q of A (the rotated pivots zeroed) and of V
    for (int e = threadIdx.x; e < items; e += blockDim.x) {
      const int k = e / d, i = e - k * d;
      const Pair x = unpack(ppq[k]);
      const float c = pc[k], s = ps[k];
      const float bp = A[i * ld + x.p], vp = V[i * ld + x.p];
      if (x.p == x.q) {
        A[i * ld + x.p] = rot(c, bp, s, bp);
        V[i * ld + x.p] = rot(c, vp, s, vp);
      } else {
        const float bq = A[i * ld + x.q], vq = V[i * ld + x.q];
        A[i * ld + x.p] = __fmul_rn(rot(c, bp, -s, bq), i == x.q ? 0.0f : 1.0f);
        A[i * ld + x.q] = __fmul_rn(rot(c, bq, s, bp), i == x.p ? 0.0f : 1.0f);
        V[i * ld + x.p] = rot(c, vp, -s, vq);
        V[i * ld + x.q] = rot(c, vq, s, vp);
      }
    }
    __syncthreads();
    if (++r == n_rounds) r = 0;
  }

  for (int i = threadIdx.x; i < d; i += blockDim.x)
    w_out[static_cast<long long>(blockIdx.x) * d + i] = A[i * ld + i];
  if (kShared) {
    for (int e = threadIdx.x; e < d * d; e += blockDim.x) {
      const int i = e / d, j = e - i * d;
      V_out[mat + e] = V[i * ld + j];
    }
  }
}

}  // namespace

// C [nmat, d, d] float32 -> w [nmat, d] (the diagonal, unsorted) and V
// [nmat, d, d]; `pairs` int32 [n_rounds, (d + 1) / 2]; `work` [nmat, d, d]
// where ld is 0 (A and V in device memory), else unused; `smem` the
// dynamic shared bytes the wrapper computed (ops/linalg.py::_j1_plan).
extern "C" int jacobi_eigh(const void* C, const void* pairs, void* w, void* V,
                           void* work, int nmat, int d, int n_rounds,
                           int sweeps, int ld, int smem, int threads,
                           void* stream) {
  const int npairs = (d + 1) / 2;
  const int m = d + d % 2;
  const long long want = (ld ? 8LL * d * ld : 0LL) + 12LL * npairs;
  if (d < 2 || d > 32767 || nmat < 1 || n_rounds != m - 1 || sweeps < 0 ||
      (ld != 0 && ld < d) || smem != want || threads < 32 || threads > 1024 ||
      threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pC = static_cast<const float*>(C);
  const int* pp = static_cast<const int*>(pairs);
  float* pw = static_cast<float*>(w);
  float* pV = static_cast<float*>(V);
  float* pA = static_cast<float*>(work);
  cudaError_t err;
  if (ld) {
    err = cudaFuncSetAttribute(jacobi_rounds_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    jacobi_rounds_kernel<true><<<nmat, threads, smem, s>>>(pC, pp, pw, pV, pA, d,
                                                           n_rounds, sweeps, ld);
  } else {
    err = cudaFuncSetAttribute(jacobi_rounds_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    jacobi_rounds_kernel<false><<<nmat, threads, smem, s>>>(pC, pp, pw, pV, pA,
                                                            d, n_rounds, sweeps, d);
  }
  return static_cast<int>(cudaGetLastError());
}
