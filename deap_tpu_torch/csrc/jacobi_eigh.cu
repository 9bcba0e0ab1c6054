// J1: batched symmetric eigendecomposition by fixed-sweep parallel Jacobi.
//
// jacobi_rounds_kernel runs every round of deap_tpu/ops/linalg.py::
// eigh_jacobi, an XLA function (not a Pallas kernel): the port's own kernel
// for it. Plain version: deap_tpu_torch/ops/linalg.py::eigh_jacobi_plain;
// the wrapper, ops/linalg.py::eigh_jacobi, sorts the spectrum afterwards.
//
// Algorithm, per matrix: A = 0.5 (C + C^T), V = I, then sweeps x (m - 1)
// rounds of the round-robin schedule (m = d rounded up to even; ops/
// linalg.py::_round_robin_schedule). A round takes the m / 2 disjoint pairs
// (p, q) at once: each pair's c and s from app, aqq, apq (the JAX
// function's tau, t, c, s, with its `small` test: |apq| <= FLT_MIN or a
// bye, p == q); then every row pair, then every column pair of A rotated,
// the rotated pivots A[q,p], A[p,q] zeroed by a product with 0 (the plain
// version's pivot mask; the zero keeps the sign of the value it replaces);
// and V's column pairs rotated. A bye (b, b) takes the same arithmetic with
// c = 1 and +0 for both s terms: 1 a + 0 a.
//
// Rounding: every product, sum, quotient, reciprocal and square root is an
// intrinsic rounded to nearest (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn,
// __frcp_rn, __fsqrt_rn), which nvcc never contracts into a fused multiply-
// add, in the plain version's order, so the kernel equals the plain version
// on the card bit for bit. t = sign(tau) / x is taken as sign(tau) x
// rcp(x): x >= 1, so the correctly rounded 1 / x times +-1 or 0 is the
// correctly rounded quotient, NaN and infinity included. A 2x2 block's
// entries (below) take the same products and sums in the same order as the
// row pass then the column pass, so the order of the work is free.
//
// Design. The rounds of one matrix are a chain of sweeps x (m - 1)
// dependent steps (891 at d 100), so one block owns a matrix and runs the
// whole chain, and the sort of its spectrum, in one launch; a batch is a
// grid of blocks. The block's warps have three roles (ops/linalg.py::
// _j1_split):
//   - Pivot warps, a thread per pair (ceil(m/2 / 32) warps; above 960
//     pairs, 128 threads take the pairs in turn, each rotation from A after
//     the pass, its players from the round's number). Each walks its
//     pair's two players of the circle method in registers, and the players
//     partnering them one round earlier, so there is no schedule to read
//     and no division. While the pass of round r runs, it computes round
//     r + 1's rotation: the three entries of A after round r that it needs
//     (its two diagonal entries and its pivot) are each one output of a 2x2
//     block of round r, which it computes itself from the 12 entries of A
//     before round r that it read before the pass began, and round r's
//     rotations. So the correctly rounded chain of quotients and roots runs
//     beside the pass, not before it.
//   - Pass warps: ONE pass over A a round by 2x2 pair blocks, in place. The
//     block of row pair k and column pair l, A[{p_k, q_k} x {p_l, q_l}],
//     depends on that block alone, so a thread reads its four entries,
//     rotates the rows by pair k's (c, s), the columns by pair l's, and
//     writes them back. A thread keeps one column pair l (its c, s, p, q
//     loaded once a round) and walks the row pairs k = g, g + groups, ...; a
//     warp's lanes take consecutive l, so their k data are a broadcast.
//   - V warps: V's column pairs need only the round's (c, s, p, q), so they
//     run behind A, from a ring of the last one or two rounds' rotations. A
//     V warp's lanes take consecutive (pair, row pair) units, each one
//     float2 of the pair's two columns, 4 units in flight a thread.
// A round, per role: the pivot warps read their 12 entries, publish round
// r's rotations in a ring slot and arrive at Y; the pass warps wait at Y,
// make the pass and arrive at X; the pivot warps compute round r + 1's
// rotations and wait at X. Named barriers (barrier.arrive / barrier.sync,
// producer and consumer) carry each hand-over; each ring slot has a "full"
// barrier (pivot warps arrive, V warps wait; it also orders the V warps'
// rounds among themselves) and an "empty" one (V warps arrive, pivot warps
// wait before they overwrite the slot). Last, each eigenvalue's place in
// the ascending, stable order (torch.sort's) is counted, and w and V's
// columns are written in that order.
// Split (ops/linalg.py::_j1_splits: d from linalg.J1_SPLIT_MIN_D to 170,
// where every matrix's two blocks fit on the card at once): the SM's
// shared-memory accesses, not its arithmetic, set the round, and V takes
// a third of them, so a matrix gets two blocks on two SMs (a cooperative
// launch, each block asking for more than half an SM's shared memory):
// the first holds A and makes its rounds, and also writes each round's
// rotations to a log in device memory, publishing their count (a release
// store) every kLogBatch rounds; the second holds V^T and follows the log
// (acquire loads, then the batch copied into its shared memory, read past
// L1), and writes V in the order the first publishes last.
// Layout: V transposed (V^T[j][i] at j ldv + i, ldv = d rounded up to
// even), so a V lane's two rows are one float2; A row-major with row
// stride ld (odd, d + 1 for an even d where it fits: a pass warp's loads
// in a row hit the round's columns, about 1.9 wavefronts a load at d 100
// with ld 101 or 100 alike). Shared memory holds V^T, A and the ring up to
// d 170; above it (kShared false) V^T and A live in the wrapper's
// workspace in device memory (L1 and L2 hold them) and only the ring is
// shared.
//
// Bound on the H100: operations. A round does 3 d^2 / 2 pair updates of 2
// products and a sum each (rows, A's columns, V's columns): sweeps x
// (m - 1) x 9 d^2 float32 operations, 8.0e7 at d 100, in one SM for one
// matrix (a batch spreads over min(batch, SMs) SMs; a split over two a
// matrix, linalg.j1_sms). Shared memory is the
// nearer wall: A and V are each read and written once a round, 16 d^2
// bytes at 128 bytes a clock, 1,250 clocks a round at d 100; 32-bit
// accesses reach less of that rate, and one warp issues them far below
// it, so the roles' thread counts follow their shares of the accesses.

#include <float.h>

#include "common.cuh"

namespace {

// Named barriers: 0 is __syncthreads; X, Y and the pivot warps' own, then
// a "full" and an "empty" barrier for each of at most 2 ring slots. Their
// ids are constants: an SM has 64 named barriers, and a kernel that names
// one by a register is counted as using all 16 (4 blocks an SM); these 8
// leave room for 8, which a batch of small matrices needs.
constexpr int kBarX = 1, kBarY = 2, kBarPivot = 3, kBarFull = 4;
constexpr int kMaxSlots = 2, kBarEmpty = kBarFull + kMaxSlots;
// V warps: the (pair, row pair) units a thread has in flight
constexpr int kVUnits = 4;

// barrier.sync / barrier.arrive, not bar.*: their .aligned forms assume a
// warp's threads reach them together, which a divergent loop need not do
template <int kId>
__device__ __forceinline__ void bar_sync(int count) {
  asm volatile("barrier.sync %0, %1;" ::"n"(kId), "r"(count) : "memory");
}

template <int kId>
__device__ __forceinline__ void bar_arrive(int count) {
  asm volatile("barrier.arrive %0, %1;" ::"n"(kId), "r"(count) : "memory");
}

// a ring slot's barrier, its id a constant
template <int kFirst>
__device__ __forceinline__ void slot_sync(int slot, int count) {
  if (slot == 0)
    bar_sync<kFirst>(count);
  else
    bar_sync<kFirst + 1>(count);
}

template <int kFirst>
__device__ __forceinline__ void slot_arrive(int slot, int count) {
  if (slot == 0)
    bar_arrive<kFirst>(count);
  else
    bar_arrive<kFirst + 1>(count);
}

// a count in device memory, published by one block and read by another
__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// torch.sign: 1, -1, or 0 (for +-0 and NaN)
__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// c * x + sp * y, each operation rounded on its own
__device__ __forceinline__ float rot(float c, float x, float sp, float y) {
  return __fadd_rn(__fmul_rn(c, x), __fmul_rn(sp, y));
}

// a ring slot's pair: its (c, s) and p | q << 16
struct Rotation {
  int p, q;
  float c, s_lo, s_hi;  // the partner term's coefficient at p and at q
};

__device__ __forceinline__ Rotation rotation(float2 cs, int pq) {
  Rotation x;
  x.p = pq & 0xFFFF;
  x.q = pq >> 16;
  x.c = cs.x;
  x.s_hi = cs.y;
  x.s_lo = x.p == x.q ? cs.y : -cs.y;  // a bye: +0 at both
  return x;
}

// The pair's (c, s) from app, aqq, apq: the plain version's chain
__device__ __forceinline__ float2 pivot(float app, float aqq, float apq,
                                        bool bye) {
  const bool small = fabsf(apq) <= FLT_MIN || bye;
  const float tau =
      __fdiv_rn(__fsub_rn(aqq, app), small ? 1.0f : __fmul_rn(2.0f, apq));
  const float x =
      __fadd_rn(fabsf(tau), __fsqrt_rn(__fadd_rn(1.0f, __fmul_rn(tau, tau))));
  float t = __fmul_rn(sign_of(tau), __frcp_rn(x));
  if (tau == 0.0f) t = 1.0f;
  const float c = __frcp_rn(__fsqrt_rn(__fadd_rn(1.0f, __fmul_rn(t, t))));
  return small ? make_float2(1.0f, 0.0f) : make_float2(c, __fmul_rn(t, c));
}

// The player at a fixed position of the circle method, one round later:
// position 0 keeps player 0, the others' players step down, 1 to m - 1.
__device__ __forceinline__ int next_player(int x, int m) {
  return x == 0 ? 0 : (x == 1 ? m - 1 : x - 1);
}

// The player at position j in round r (rr = r mod (m - 1)): the walk of
// next_player, rr steps at once.
__device__ __forceinline__ int player_at(int j, int rr, int m) {
  if (j == 0) return 0;
  const int x = j - 1 - rr;
  return (x < 0 ? x + m - 1 : x) + 1;
}

// The position a player held one round earlier, from the one it holds now.
__device__ __forceinline__ int prev_position(int j, int m) {
  return j == 0 ? 0 : (j == 1 ? m - 1 : j - 1);
}

// One round of V's rotations: a thread's (pair, row pair) units, from
// (k0, h0) by steps of (dk, dh), each one float2 of the pair's two columns
// of V^T, kVUnits of them in flight.
__device__ __forceinline__ void v_round(float2* VT2, const float2* cs,
                                        const int* pq, int npairs, int half,
                                        int k0, int h0, int dk, int dh) {
  for (int k = k0, h = h0; k < npairs;) {
    Rotation x[kVUnits];
    int at[kVUnits];
    float2 vp[kVUnits], vq[kVUnits];
#pragma unroll
    for (int u = 0; u < kVUnits; ++u) {
      const int kk = min(k, npairs - 1);  // past the end: read, not written
      x[u] = rotation(cs[kk], pq[kk]);
      at[u] = k < npairs ? h : -1;
      vp[u] = VT2[x[u].p * half + h];
      vq[u] = VT2[x[u].q * half + h];
      h += dh;
      k += dk;
      if (h >= half) h -= half, ++k;
    }
#pragma unroll
    for (int u = 0; u < kVUnits; ++u) {
      if (at[u] >= 0) {
        const Rotation& y = x[u];
        VT2[y.p * half + at[u]] =
            make_float2(rot(y.c, vp[u].x, y.s_lo, vq[u].x),
                        rot(y.c, vp[u].y, y.s_lo, vq[u].y));
        VT2[y.q * half + at[u]] =
            make_float2(rot(y.c, vq[u].x, y.s_hi, vp[u].x),
                        rot(y.c, vq[u].y, y.s_hi, vp[u].y));
      }
    }
  }
}

// the rounds the V block of a split launch copies at a time
constexpr int kLogBatch = 8;

#ifdef DTT_J1_PHASES
// The phase clock, built only with -DDTT_J1_PHASES: the first pivot, pass
// and V threads each add the SM clocks of their own phases of every round
// (a split's V block: thread 0, its waits and its batches of rounds).
constexpr int kPhases = 8;
__device__ unsigned long long j1_phase_clocks[kPhases];
#define J1_MARK(who, phase)                                           \
  if (tid == (who)) {                                                 \
    const long long now = clock64();                                  \
    clocks[phase] += static_cast<unsigned long long>(now - mark);     \
    mark = now;                                                       \
  }
#else
#define J1_MARK(who, phase)
#endif

// kSplit: two blocks a matrix, on two SMs (a cooperative launch, so both
// are resident): block 2 i makes matrix i's rounds of A, publishing each
// round's rotations to `log` in device memory and their count to
// `ready[i]` (release); block 2 i + 1 rotates V's rows from that log
// (acquire), a batch of rounds at a time, and writes V in the order the
// first block publishes in `order` when its count passes the rounds.
template <bool kShared, bool kSplit>
__global__ void __launch_bounds__(1024)
jacobi_rounds_kernel(const float* __restrict__ C, float* __restrict__ w_out,
                     float* __restrict__ V_out, float* work, int d, int sweeps,
                     int ld, int n_pivot, int n_a, int groups, int slots,
                     float2* log_cs, int* log_pq, int* ready, int* order) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int m = d + (d & 1), npairs = m / 2;
  const int n_v = kSplit ? blockDim.x : blockDim.x - n_a;
  const int mi = kSplit ? blockIdx.x >> 1 : blockIdx.x;
  const bool v_block = kSplit && (blockIdx.x & 1);
  const long long mat = static_cast<long long>(mi) * d * d;
  const float* Cm = C + mat;
  // V^T's column stride: even, so a lane's two rows are one float2
  const int ldv = d + (d & 1), half = ldv / 2;
  float *A, *VT, *ring;
  if (kSplit) {  // each block holds its own matrix, then the rotations
    A = VT = smem;
    ring = smem + (v_block ? d * ldv : (d * ld + 1) & ~1);
  } else if (kShared) {
    VT = smem;
    A = VT + d * ldv;
    ring = A + ((d * ld + 1) & ~1);
  } else {
    VT = work + 2 * static_cast<long long>(blockIdx.x) * d * ldv;
    A = VT + d * ldv;
    ring = smem;
    ld = ldv;
  }
  const int total = sweeps * (m - 1);
  if (kSplit) {
    log_cs += static_cast<long long>(mi) * total * npairs;
    log_pq += static_cast<long long>(mi) * total * npairs;
  }
  float2* ring_cs = reinterpret_cast<float2*>(ring);
  int* ring_pq = reinterpret_cast<int*>(ring_cs + slots * npairs);
#ifdef DTT_J1_PHASES
  unsigned long long clocks[kPhases] = {};
  long long mark = clock64();
#endif

  for (int e = tid; !v_block && e < d * d; e += blockDim.x) {
    const int i = e / d, j = e - i * d;
    A[i * ld + j] = __fmul_rn(0.5f, __fadd_rn(Cm[i * d + j], Cm[j * d + i]));
  }
  for (int e = tid; (!kSplit || v_block) && e < d * ldv; e += blockDim.x) {
    const int j = e / ldv, i = e - j * ldv;  // an odd d's row d: 0
    VT[e] = i == j ? 1.0f : 0.0f;
  }
  __syncthreads();

  const int handshake = n_pivot + n_v;
  if (v_block) {
    // ----------------------------------------------- a split's V block --
    // V's rounds from the log, kLogBatch rounds copied into shared memory
    // once the A block has published them, a block barrier between rounds
    float2* b_cs = reinterpret_cast<float2*>(ring);
    int* b_pq = reinterpret_cast<int*>(b_cs + kLogBatch * npairs);
    const int dk = n_v / half, dh = n_v - dk * half;
    const int k0 = tid / half, h0 = tid - k0 * half;
    float2* VT2 = reinterpret_cast<float2*>(VT);
    for (int r0 = 0; r0 < total; r0 += kLogBatch) {
      const int nb = min(kLogBatch, total - r0);
      if (tid == 0)
        while (load_acquire(ready + mi) < r0 + nb) __nanosleep(64);
      __syncthreads();
      J1_MARK(0, 6);
      for (int e = tid; e < nb * npairs; e += n_v) {
        b_cs[e] = __ldcg(log_cs + static_cast<long long>(r0) * npairs + e);
        b_pq[e] = __ldcg(log_pq + static_cast<long long>(r0) * npairs + e);
      }
      __syncthreads();
      for (int rr = 0; rr < nb; ++rr) {
        v_round(VT2, b_cs + rr * npairs, b_pq + rr * npairs, npairs, half, k0,
                h0, dk, dh);
        __syncthreads();
      }
      J1_MARK(0, 7);
    }
  } else if (!kSplit && tid < n_pivot && n_pivot < npairs) {
    // ------------------------------------ pivot warps, pairs in turn --
    // More pairs than pivot threads (d above 1,920; never split): a thread
    // takes the pairs k, k + n_pivot, ... one after another, each rotation
    // from A itself once the pass before it is done, its players from
    // their positions and the round, with no state a pair.
    for (int r = 0, slot = 0, rr = 0; r < total; ++r) {
      if (r >= slots) slot_sync<kBarEmpty>(slot, handshake);
      J1_MARK(0, 0);
      float2* cs_r = ring_cs + slot * npairs;
      int* pq_r = ring_pq + slot * npairs;
      for (int k = tid; k < npairs; k += n_pivot) {
        const int a = player_at(k, rr, m), b = player_at(m - 1 - k, rr, m);
        const int p = min(a, b), q = max(a, b) >= d ? p : max(a, b);
        cs_r[k] = pivot(A[p * ld + p], A[q * ld + q], A[p * ld + q], p == q);
        pq_r[k] = p | q << 16;
      }
      slot_arrive<kBarFull>(slot, handshake);
      bar_arrive<kBarY>(n_a);
      J1_MARK(0, 2);
      bar_sync<kBarX>(n_a);  // the pass of round r is done
      J1_MARK(0, 3);
      if (++slot == slots) slot = 0;
      if (++rr == m - 1) rr = 0;
    }
  } else if (tid < n_pivot) {
    // --------------------------------------------------- pivot warps --
    const int k = tid;
    const bool mine = k < npairs;
    // Walked a round at a time: the players of pair k (positions k and
    // m - 1 - k), and the players at the positions partnering, one round
    // earlier, the positions its players came from. So a pivot thread
    // knows, with no shared memory, which entries of A it will need.
    int a = k, b = m - 1 - k;
    const int pa = prev_position(k, m), pb = prev_position(m - 1 - k, m);
    const int ja = min(pa, m - 1 - pa), jb = min(pb, m - 1 - pb);
    int ya = m - 1 - pa, yb = m - 1 - pb;
    float2 cs = make_float2(1.0f, 0.0f);
    int pq = 0;
    if (mine && total > 0) {  // round 0's rotation, from A itself
      const int p = min(a, b), q = max(a, b) >= d ? p : max(a, b);
      cs = pivot(A[p * ld + p], A[q * ld + q], A[p * ld + q], p == q);
      pq = p | q << 16;
    }
    for (int r = 0, slot = 0; r < total; ++r) {
      const bool next = mine && r + 1 < total;
      // pair k of round r + 1: each player x, its round-r pair j and
      // partner y (itself after a bye); a bye of round r + 1 (an odd d's
      // dummy player d) takes its real player twice
      int x1 = 0, y1 = 0, j1 = 0, x2 = 0, y2 = 0, j2 = 0;
      float e[12];
      if (next) {
        a = next_player(a, m);
        b = next_player(b, m);
        x1 = a, y1 = ya < d ? ya : a, j1 = ja;
        x2 = b, y2 = yb < d ? yb : b, j2 = jb;
        if (x1 >= d) x1 = x2, y1 = y2, j1 = j2;
        if (x2 >= d) x2 = x1, y2 = y1, j2 = j1;
        if (x1 > x2) {
          const int x = x1, y = y1, j = j1;
          x1 = x2, y1 = y2, j1 = j2, x2 = x, y2 = y, j2 = j;
        }
        ya = next_player(ya, m);
        yb = next_player(yb, m);
        // A[x1, x1], A[x2, x2] and A[x1, x2] after round r, each an output
        // of a 2x2 block of round r: the block's four entries before it
        e[0] = A[x1 * ld + x1], e[1] = A[y1 * ld + x1];
        e[2] = A[x1 * ld + y1], e[3] = A[y1 * ld + y1];
        e[4] = A[x2 * ld + x2], e[5] = A[y2 * ld + x2];
        e[6] = A[x2 * ld + y2], e[7] = A[y2 * ld + y2];
        e[8] = A[x1 * ld + x2], e[9] = A[y1 * ld + x2];
        e[10] = A[x1 * ld + y2], e[11] = A[y1 * ld + y2];
      }
      if (!kSplit && r >= slots) slot_sync<kBarEmpty>(slot, handshake);
      J1_MARK(0, 0);
      float2* cs_r = ring_cs + slot * npairs;
      int* pq_r = ring_pq + slot * npairs;
      // a split publishes its log a batch of the V block's at a time
      const bool publish =
          kSplit && ((r + 1) % kLogBatch == 0 || r + 1 == total);
      if (mine) {
        cs_r[k] = cs;
        pq_r[k] = pq;
        if (kSplit) {
          log_cs[r * npairs + k] = cs;
          log_pq[r * npairs + k] = pq;
        }
      }
      if (publish) __threadfence();
      if (!kSplit) slot_arrive<kBarFull>(slot, handshake);
      bar_arrive<kBarY>(n_a);  // the pass may overwrite A
      J1_MARK(0, 1);
      bar_sync<kBarPivot>(n_pivot);  // the slot, to every pivot thread
      if (publish && tid == 0) store_release(ready + mi, r + 1);
      if (next) {
        // the rows by x's pair, then the column by its own (as the pass);
        // the partner term's coefficient: -s at a pair's lower player
        const float2 r1 = cs_r[j1], r2 = cs_r[j2];
        const float s1 = x1 < y1 ? -r1.y : r1.y, s2 = x2 < y2 ? -r2.y : r2.y;
        const float c1 = r1.x, c2 = r2.x;
        const float app = rot(c1, rot(c1, e[0], s1, e[1]), s1,
                              rot(c1, e[2], s1, e[3]));
        const float aqq = rot(c2, rot(c2, e[4], s2, e[5]), s2,
                              rot(c2, e[6], s2, e[7]));
        float apq = rot(c2, rot(c1, e[8], s1, e[9]), s2,
                        rot(c1, e[10], s1, e[11]));
        if (j1 == j2 && x1 != y1)  // d 2: the pair repeats, its pivot is 0
          apq = __fmul_rn(apq, 0.0f);
        cs = pivot(app, aqq, apq, x1 == x2);
        pq = x1 | x2 << 16;
      }
      J1_MARK(0, 2);
      bar_sync<kBarX>(n_a);  // the pass of round r is done
      J1_MARK(0, 3);
      if (++slot == slots) slot = 0;
    }
  } else if (tid < n_a) {
    // ---------------------------------------------------- pass warps --
    // column pair l, row pairs k = g, g + groups, ...; where the pass
    // threads are fewer than the pairs, the column pairs l, l + n_pass, ...
    const int t = tid - n_pivot, n_pass = n_a - n_pivot;
    const int g = t / npairs, l0 = t - g * npairs;
    const int l_step = min(n_pass, npairs);
    for (int r = 0, slot = 0; r < total; ++r) {
      bar_sync<kBarY>(n_a);
      J1_MARK(n_pivot, 4);
      const float2* cs = ring_cs + slot * npairs;
      const int* pq = ring_pq + slot * npairs;
      for (int l = l0; g < groups && l < npairs; l += l_step) {
        const Rotation y = rotation(cs[l], pq[l]);
        for (int k = g; k < npairs; k += groups) {
          const Rotation x = rotation(cs[k], pq[k]);
          float* rp = A + x.p * ld;
          float* rq = A + x.q * ld;
          const float a00 = rp[y.p], a01 = rp[y.q];
          const float a10 = rq[y.p], a11 = rq[y.q];
          // rows p_k, q_k by pair k
          const float b00 = rot(x.c, a00, x.s_lo, a10);
          const float b01 = rot(x.c, a01, x.s_lo, a11);
          const float b10 = rot(x.c, a10, x.s_hi, a00);
          const float b11 = rot(x.c, a11, x.s_hi, a01);
          // columns p_l, q_l by pair l
          const float o00 = rot(y.c, b00, y.s_lo, b01);
          float o01 = rot(y.c, b01, y.s_hi, b00);
          float o10 = rot(y.c, b10, y.s_lo, b11);
          const float o11 = rot(y.c, b11, y.s_hi, b10);
          if (k == l) {  // the pivots of a real pair, times 0
            const float keep = x.p == x.q ? 1.0f : 0.0f;
            o01 = __fmul_rn(o01, keep);
            o10 = __fmul_rn(o10, keep);
          }
          // a bye's block stores its entries twice, with the same value
          rp[y.p] = o00;
          rp[y.q] = o01;
          rq[y.p] = o10;
          rq[y.q] = o11;
        }
      }
      bar_arrive<kBarX>(n_a);
      J1_MARK(n_pivot, 5);
      if (++slot == slots) slot = 0;
    }
  } else if (!kSplit) {
    // ------------------------------------------------------- V warps --
    // a thread's units are (pair, row pair) = divmod(u, half) for u = v,
    // v + n_v, ...: walked by a fixed step, with no division in the loop; a
    // unit's rows 2h and 2h + 1 are one float2 of each of its two columns
    const int v = tid - n_a;
    const int dk = n_v / half, dh = n_v - dk * half;
    const int k0 = v / half, h0 = v - k0 * half;
    float2* VT2 = reinterpret_cast<float2*>(VT);
    for (int r = 0, slot = 0; r < total; ++r) {
      slot_sync<kBarFull>(slot, handshake);
      J1_MARK(n_a, 6);
      const float2* cs = ring_cs + slot * npairs;
      const int* pq = ring_pq + slot * npairs;
      v_round(VT2, cs, pq, npairs, half, k0, h0, dk, dh);
      if (r < total - slots) slot_arrive<kBarEmpty>(slot, handshake);
      J1_MARK(n_a, 7);
      if (++slot == slots) slot = 0;
    }
  }
  __syncthreads();

#ifdef DTT_J1_PHASES
  if (tid == 0 || tid == n_pivot || tid == n_a)
    for (int k = 0; k < kPhases; ++k) atomicAdd(&j1_phase_clocks[k], clocks[k]);
#endif
  // The spectrum ascending, stable, NaN last (torch.sort's order on the
  // card; the card's arithmetic makes only positive NaNs): each
  // eigenvalue's place is a count, and V's columns follow it.
  int* const place = reinterpret_cast<int*>(ring);  // the rotations are done
  for (int i = tid; !v_block && i < d; i += blockDim.x) {
    const float wi = A[i * ld + i];
    const bool nan_i = isnan(wi);
    int below = 0;
    for (int j = 0; j < d; ++j) {
      const float wj = A[j * ld + j];
      below += nan_i ? (!isnan(wj) || j < i) : (wj < wi || (wj == wi && j < i));
    }
    place[i] = below;
    w_out[static_cast<long long>(mi) * d + below] = wi;
    if (kSplit) {
      order[static_cast<long long>(mi) * d + i] = below;
      __threadfence();
    }
  }
  if (kSplit) {
    __syncthreads();
    if (!v_block) {  // the order, to the V block
      if (tid == 0) store_release(ready + mi, total + 1);
      return;
    }
    if (tid == 0)
      while (load_acquire(ready + mi) <= total) __nanosleep(64);
    __syncthreads();
    for (int i = tid; i < d; i += blockDim.x)
      place[i] = __ldcg(order + static_cast<long long>(mi) * d + i);
  }
  __syncthreads();
  for (int e = tid; e < d * d; e += blockDim.x) {
    const int j = e / d, i = e - j * d;
    V_out[mat + i * d + place[j]] = VT[j * ldv + i];
  }
}

}  // namespace

// C [nmat, d, d] float32 -> w [nmat, d] (the diagonal, ascending) and V
// [nmat, d, d] (its columns in w's order); `work` [nmat, 2, d, d + d % 2]
// where ld is 0 (V^T and A in device memory), else unused; `smem` the
// dynamic shared bytes, n_pivot the pivot threads (fewer than the pairs:
// the pairs in turn, never in a split), n_a the pivot and pass threads,
// n_v the V threads, `groups` the pass threads a column pair, `slots` the
// ring's depth, as ops/linalg.py::_j1_pivots, _j1_layout and _j1_split
// computed them. Where `split` is not 0 (ops/linalg.py::_j1_splits), a
// cooperative launch of two blocks a matrix of max(n_a, n_v) threads:
// `log` (float2 then int32, [nmat, rounds, pairs] each), `ready` [nmat]
// zeroed and `order` [nmat, d] are its device workspace.
extern "C" int jacobi_eigh(const void* C, void* w, void* V, void* work,
                           int nmat, int d, int sweeps, int ld, int smem,
                           int n_pivot, int n_a, int n_v, int groups,
                           int slots, int split, void* log, void* ready,
                           void* order, void* stream) {
  const int npairs = (d + d % 2) / 2;
  const long long ldv = d + d % 2, ring = 12LL * npairs * slots;
  const long long need =
      split ? 4LL * (d * ldv > d * ld + 1 ? d * ldv : d * ld + 1) +
                  12LL * npairs * kLogBatch
            : (ld ? 4LL * (d * ldv + ((static_cast<long long>(d) * ld + 1) & ~1LL))
                  : 0LL) + ring;
  const int threads = split ? (n_a > n_v ? n_a : n_v) : n_a + n_v;
  if (d < 2 || d > 32767 || nmat < 1 || sweeps < 0 || (ld != 0 && ld < d) ||
      (split ? smem < need || ld == 0 || slots != 1 : smem != need) ||
      slots < 1 || slots > kMaxSlots || n_a % 32 != 0 || n_v % 32 != 0 ||
      n_v < 32 || n_pivot % 32 != 0 || n_pivot < 32 ||
      n_pivot > 32 * ((npairs + 31) / 32) || (split && n_pivot < npairs) ||
      n_a < n_pivot + 32 || threads > 1024 || groups < 1 ||
      (groups > 1 && static_cast<long long>(groups) * npairs > n_a - n_pivot))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pC = static_cast<const float*>(C);
  float* pw = static_cast<float*>(w);
  float* pV = static_cast<float*>(V);
  float* pA = static_cast<float*>(work);
  float2* log_cs = static_cast<float2*>(log);
  int* log_pq = reinterpret_cast<int*>(
      log_cs + static_cast<long long>(nmat) * sweeps * (2 * npairs - 1) * npairs);
  int* p_ready = static_cast<int*>(ready);
  int* p_order = static_cast<int*>(order);
  cudaError_t err;
  if (split) {
    auto kernel = jacobi_rounds_kernel<true, true>;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    void* args[] = {&pC,     &pw,     &pV,    &pA,     &d,
                    &sweeps, &ld,     &n_pivot, &n_a,  &groups,
                    &slots,  &log_cs, &log_pq, &p_ready, &p_order};
    return static_cast<int>(cudaLaunchCooperativeKernel(
        reinterpret_cast<void*>(kernel), dim3(2 * nmat), dim3(threads), args,
        smem, s));
  }
  if (ld) {
    err = cudaFuncSetAttribute(jacobi_rounds_kernel<true, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    jacobi_rounds_kernel<true, false><<<nmat, threads, smem, s>>>(
        pC, pw, pV, pA, d, sweeps, ld, n_pivot, n_a, groups, slots, log_cs,
        log_pq, p_ready, p_order);
  } else {
    err = cudaFuncSetAttribute(jacobi_rounds_kernel<false, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    jacobi_rounds_kernel<false, false><<<nmat, threads, smem, s>>>(
        pC, pw, pV, pA, d, sweeps, d, n_pivot, n_a, groups, slots, log_cs,
        log_pq, p_ready, p_order);
  }
  return static_cast<int>(cudaGetLastError());
}

#ifdef DTT_J1_PHASES
// The phase clock (-DDTT_J1_PHASES, port_profile.py --kernel-times): the
// phases' names, comma-separated, and their totals since the last reset
// read into out[kPhases]; reset != 0 clears them after the read.
extern "C" const char* jacobi_eigh_phase_names() {
  return "reads_wait_slot,publish,pivots,wait_pass,wait_pivots,pass,v_wait,"
         "v_rotate";
}

extern "C" int jacobi_eigh_phases(unsigned long long* out, int reset) {
  cudaError_t err =
      cudaMemcpyFromSymbol(out, j1_phase_clocks, sizeof(j1_phase_clocks));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[kPhases] = {};
    err = cudaMemcpyToSymbol(j1_phase_clocks, zero, sizeof(zero));
  }
  return static_cast<int>(err);
}
#endif
