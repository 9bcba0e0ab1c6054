// J3 and J4: the row passes of the exact non-domination sorts that the
// JAX package runs as one lax.scan each. Both carry the scan's order
// themselves: one block walks the rows in order, so no host round trip
// and no launch a row. Both walk the rows in chunks: every row of a chunk
// searches the state as it stood at the chunk's start, all at once, and a
// short in-register chain then adds what the chunk's own earlier rows
// wrote. A chunk costs one search of the state and one chain of at most
// 31 shuffles, not a dependent round trip a row.
//
// J3 staircase_kernel replaces the scan of
// deap_tpu/mo/emo.py::nd_rank_staircase (emo.py:274, the scan at
// :318-332; M = 2). Its plain version is
// deap_tpu_torch/mo/emo.py::staircase_rows_plain. Rows arrive sorted
// lexicographically descending, as neg_f2 = -w1 and a head flag per row
// (the first of a group of identical rows). The state is one scalar per
// front found so far, its largest w1 kept negated: neg_m[0..F),
// ascending. A head's rank r is the count of fronts whose maximum covers
// it, searchsorted(neg_m, x, right=True); it then writes neg_m[r] = x
// (r == F opens a front). A write only lowers a slot, so the maxima stay
// sorted. A row with x = +inf or NaN (w1 = -inf: an invalid row) counts
// every one of the JAX package's n slots, so its rank is n and it writes
// nothing. A row that is not a head takes the previous head's rank.
//
// J4 sweep_kernel replaces the scan of deap_tpu/mo/ndsort.py::
// nd_rank_sweep3 (ndsort.py:102; M = 3); its plain version is
// deap_tpu_torch/mo/ndsort.py::sweep3_rows_plain. The gather and scatter
// tables Q and U int32[n, A*A] (A the bit length of n) of the Fenwick tree
// of Fenwick trees are built by torch beforehand; row i of a head takes
// r = max(state[Q[i, :]]), every row then scatters max(state, r + 1)
// into state[U[i, :]]. Q pads with the slot F + 1, U with F: both are
// skipped here.
//
// Bound on the H100: bytes. J3 reads 5 bytes a row and writes 4 (0.27 us
// at 100k rows); J4 reads its two tables, 2 A*A int32 a row (69 us at
// 100k). The scan is a chain of n dependent steps, so one SM works and
// what a chunk waits for sets the time (port_profile.py --kernel-times
// splits a chunk's clocks by phase from a -DDTT_ND_PHASES build):
// - J3: one warp, a lane a row of a 32-row chunk, rows two chunks ahead
//   in flight. Each lane searches its x in neg_m as the chunk found it:
//   the pivots of 32 buckets of B = ceil(F / 32) maxima (one load,
//   compared by 32 shuffles) and then ceil(log2(B + 1)) loads inside its
//   bucket (a binary search of ceil(log2(F + 1)) dependent loads took
//   1.16-1.20x the time at 253-361 fronts), from shared memory alone
//   where every slot it reads lies there. Lane j then builds the mask of
//   the earlier lanes j' that write (a valid head) with x_j' <= x_j
//   (independent shuffles), and 31 steps of a shuffle and a fused add-max
//   give r_j = max(r0_j, 1 + max r_j'): the maxima as the chunk's writes
//   left them are the chunk-start ones lowered at slot r_j' to x_j', and
//   the count of them <= x_j is what r_j' + 1 adds. The maxima are kept as int32 order
//   keys, so every writer stores with atomicMin and a slot keeps its
//   smallest x, its last writer's (slots only fall). They live in shared
//   memory up to `shared` slots (the card's 227 KB a block, 58,112 fronts)
//   and in device memory beyond (read through L2 after the warp's atomics,
//   ordered by __syncwarp; every maximum there took 1.79-1.81x the time
//   at 253-361 fronts). Each chunk's ranks leave as one coalesced
//   store. Floor: the chain, 31 dependent shuffles a chunk, and the search.
// - J4: one block, a warp a row of a chunk of R rows (R = 32 where two
//   stages of the chunk's tables fit in shared memory: every table of
//   n < 2^21; fewer above). The chunk's rows of Q and U stream into shared
//   memory by one bulk copy (TMA) a table, a chunk ahead, started by a warp
//   that waits on the chain anyway. Row i' of the chunk counts for row i
//   when i' < i and U[i'] and Q[i] share a slot: each row ORs its bit into
//   an owner mask kept beside every state slot, at its U slots; each head
//   then gathers the state and the owner masks at its Q slots in one
//   8-byte load a slot (the state as the chunk found it, and which of the
//   chunk's rows write there), and the scatter clears the masks. One warp
//   moves each mask bit of a row that is not a head to its head (a
//   segmented doubling over the head flags; a bit before the chunk's
//   first head bounds the rank by carry + 1) and runs J3's chain over the
//   heads; the rest take their head's rank, carried across chunks. Every
//   row then scatter-maxes r + 1 into its U slots with atomicMax (max
//   commutes, so no order is needed; the state holds rank + 1 as int32,
//   exact where the plain version's float32 is, below 2^24). Four
//   barriers a chunk, the state and the masks in L2 (7.0 MB at 100k rows).
//   Floor: the chunk's scattered L2 traffic (its rows' U slots written
//   three times, their Q slots read once) and the chain.

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarp = 32;

#ifdef DTT_ND_PHASES
// The phase clock, built only with -DDTT_ND_PHASES: lane 0 of J3's warp and
// thread 0 of J4's block add the SM clocks of each phase of every chunk
// (nd_scan_phase_names) to device totals, [0] J3's and [1] J4's.
constexpr int kPhases = 6;
__device__ unsigned long long nd_phase_clocks[2][kPhases];
__device__ __forceinline__ long long sm_clock() {
#ifdef __CUDA_ARCH__
  return clock64();
#else
  return 0;  // the host pass compiles no call of it
#endif
}
struct PhaseClock {
  unsigned long long clocks[kPhases];
  long long mark;
  __device__ PhaseClock() : clocks{}, mark(sm_clock()) {}
  __device__ __forceinline__ void tick(int phase) {
    const long long now = sm_clock();
    clocks[phase] += static_cast<unsigned long long>(now - mark);
    mark = now;
  }
  __device__ __forceinline__ void save(int kernel) {
    if (threadIdx.x == 0)
      for (int k = 0; k < kPhases; ++k)
        atomicAdd(&nd_phase_clocks[kernel][k], clocks[k]);
  }
};
#else
struct PhaseClock {
  __device__ __forceinline__ void tick(int) {}
  __device__ __forceinline__ void save(int) {}
};
#endif

// Lanes 0..k (k < 32) of a 32-bit mask.
__device__ __forceinline__ unsigned lanes_upto(int k) {
  return k >= kWarp - 1 ? kFull : (2u << k) - 1u;
}

// The highest set lane of a nonzero mask.
__device__ __forceinline__ int last_lane(unsigned bits) {
  return kWarp - 1 - __clz(bits);
}

// The chunk's chain: lane i holds r = r0_i (its search against the
// chunk-start state) and `mask`, the earlier lanes whose writes count for
// it; after step k lane k's rank is final, so each step broadcasts it and
// every lane that depends on it takes max(r, r_k + 1) (one fused add and
// max). Straight line, 31 steps of a shuffle and a max, or none where no
// lane depends on another.
__device__ __forceinline__ int chunk_chain(int r, unsigned mask) {
  if (!__reduce_or_sync(kFull, mask)) return r;
#pragma unroll
  for (int k = 0; k < kWarp - 1; ++k) {
    const int rk = __shfl_sync(kFull, r, k);
    if ((mask >> k) & 1u) r = __viaddmax_s32(rk, 1, r);
  }
  return r;
}

// -------------------------------------------------------------- J3 ----

// The int32 key of a float32 that is not NaN: keys order as the floats
// do, -0.0 and +0.0 as one. The front maxima are kept as keys, so that
// every writer of a slot can store with atomicMin: the slot keeps its
// smallest x, its last writer's.
__device__ __forceinline__ int order_key(float x) {
  const int b = __float_as_int(x == 0.0f ? 0.0f : x);
  return b >= 0 ? b : b ^ 0x7FFFFFFF;
}
constexpr int kNoFront = 0x7F800000;  // order_key(+inf): a slot not opened

// The slots of the maxima for n rows: n fronts at most, and the 2 B past
// F that a search reads (B = ceil(F / 32) <= ceil(n / 32)).
__host__ __device__ constexpr int j3_slots(int n) {
  return n + 2 * ((n + kWarp - 1) / kWarp);
}

struct Stair {
  const float* neg_f2;
  int* sm;  // the first `shared` maxima
  int* gm;  // the rest
  int* ranks;
  int n, shared, lane;
  int fronts;  // F: the maxima neg_m[0..F) are written
  int carry;   // the last head's rank before the chunk
  PhaseClock clock;

  // slot q of the maxima: in shared memory below `shared`, else (through
  // L2) in device memory; kInShared where every slot read lies below it
  template <bool kInShared>
  __device__ __forceinline__ int max_at(int q) const {
    return kInShared || q < shared ? sm[q] : __ldcg(gm + (q - shared));
  }

  // the count of the maxima neg_m[0..F) <= key, F > 0. 32 buckets of
  // B = ceil(F / 32) maxima, a lane's pivot the last of its bucket (past F
  // the last maximum again): the buckets whose pivot is <= x lie wholly
  // below it, then a search inside the next one. It reads below F + 2 B,
  // so past F it finds unopened slots (kNoFront: above every key that
  // writes).
  template <bool kInShared>
  __device__ __forceinline__ int search(int key, int B) const {
    const int pivot = max_at<kInShared>(min((lane + 1) * B, fronts) - 1);
    int below = 0;
#pragma unroll
    for (int k = 0; k < kWarp; ++k)
      below += __shfl_sync(kFull, pivot, k) <= key;
    int r = min(below * B, fronts);
    for (int s = 1 << (kWarp - 1 - __clz(B)); s > 0; s >>= 1)
      r = max_at<kInShared>(r + s - 1) <= key ? r + s : r;
    return r;
  }

  // the chunk of 32 rows from `base`, lane's row x with its head flag
  __device__ __forceinline__ void chunk(int base, float x, bool hv) {
    const int rows = min(kWarp, n - base);
    const bool is_head = lane < rows && hv;
    const bool writes = is_head && x < INFINITY;
    const int key = order_key(x);
    clock.tick(0);
    // the search against the chunk-start maxima (a select a load costs
    // 1.11-1.12x where every slot it reads lies in shared memory)
    int r = 0;
    if (fronts > 0) {
      const int B = (fronts + kWarp - 1) / kWarp;
      r = fronts + 2 * B <= shared ? search<true>(key, B)
                                   : search<false>(key, B);
    }
    clock.tick(1);
    // the earlier writing lanes whose x is <= this lane's
    const unsigned writers = __ballot_sync(kFull, writes);
    unsigned mask = 0;
#pragma unroll
    for (int k = 0; k < kWarp; ++k)
      mask |= static_cast<unsigned>(__shfl_sync(kFull, x, k) <= x) << k;
    mask = writes ? mask & writers & ((1u << lane) - 1u) : 0u;
    clock.tick(2);
    r = chunk_chain(r, mask);
    clock.tick(3);
    if (is_head && !writes) r = n;  // every slot covers it; no write
    // a row that is not a head takes the last head's rank before it
    const unsigned heads = __ballot_sync(kFull, is_head);
    const unsigned upto = heads & lanes_upto(lane);
    const int from = __shfl_sync(kFull, r, upto ? last_lane(upto) : 0);
    if (lane < rows) ranks[base + lane] = upto ? from : carry;
    if (heads) carry = __shfl_sync(kFull, r, last_lane(heads));
    clock.tick(4);
    if (writes) {
      if (r < shared) {
        atomicMin(sm + r, key);
      } else {
        atomicMin(gm + (r - shared), key);
      }
    }
    fronts = max(fronts, __reduce_max_sync(kFull, writes ? r + 1 : 0));
    __syncwarp();
    clock.tick(5);
  }
};

__global__ void __launch_bounds__(kWarp)
staircase_kernel(const float* __restrict__ neg_f2,
                 const unsigned char* __restrict__ head, int n, int shared,
                 int* gm, int* __restrict__ ranks) {
  extern __shared__ int sm[];
  const int lane = threadIdx.x;
  for (int i = lane; i < shared; i += kWarp) sm[i] = kNoFront;
  for (int i = lane; i < j3_slots(n) - shared; i += kWarp) gm[i] = kNoFront;
  __syncwarp();
  Stair st{neg_f2, sm, gm, ranks, n, shared, lane, 0, 0, {}};
  // rows two chunks ahead are in flight while a pair of chunks is worked
  float xa = 0.0f, xb = 0.0f;
  unsigned char ha = 0, hb = 0;
  if (lane < n) {
    xa = neg_f2[lane];
    ha = head[lane];
  }
  if (kWarp + lane < n) {
    xb = neg_f2[kWarp + lane];
    hb = head[kWarp + lane];
  }
  for (int base = 0; base < n; base += 2 * kWarp) {
    const int next = base + 2 * kWarp + lane;
    float xc = 0.0f, xd = 0.0f;
    unsigned char hc = 0, hd = 0;
    if (next < n) {
      xc = neg_f2[next];
      hc = head[next];
    }
    if (next + kWarp < n) {
      xd = neg_f2[next + kWarp];
      hd = head[next + kWarp];
    }
    st.chunk(base, xa, ha != 0);
    if (base + kWarp < n) st.chunk(base + kWarp, xb, hb != 0);
    xa = xc;
    ha = hc;
    xb = xd;
    hb = hd;
  }
  st.clock.save(0);
}

// -------------------------------------------------------------- J4 ----

// Bulk copies from device memory into shared memory (the TMA unit), each
// stage's completion counted in bytes on an mbarrier.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Wait for the phase of `bar` of this parity; a copy that never lands
// traps (an error the wrapper reports) rather than hang the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  for (long long tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (tries > (1ll << 26)) __trap();
  }
}

// Stage chunk `c`'s rows of Q and U (contiguous: R * cols int32 each,
// starting on a 16-byte boundary since R % 4 == 0) into `dst` and
// `dst + per`, by one warp (`lane` its lane): lane 0 starts one bulk copy
// a table of their whole 16-byte units; the last chunk's odd tail (under
// 4 ints a table) is copied by plain loads.
__device__ __forceinline__ void stage_chunk(const int* Q, const int* U,
                                            int n, int cols, int R, int c,
                                            int* dst, int per, uint64_t* bar,
                                            int lane) {
  const int base = c * R;
  const int count = min(R, n - base) * cols;
  const size_t from = static_cast<size_t>(base) * cols;
  const int whole = count / 4 * 4;
  if (lane == 0) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_expect(bar, 2u * 4u * static_cast<uint32_t>(whole));
    if (whole > 0) {
      bulk_copy(dst, Q + from, 4u * whole, bar);
      bulk_copy(dst + per, U + from, 4u * whole, bar);
    }
  }
  const int i = whole + lane;
  if (i < count) {
    dst[i] = Q[from + i];
    dst[per + i] = U[from + i];
  }
}

// slots int32[F + 2][2]: the state (rank + 1 of the rows inserted there,
// 0 for none) and the owner mask of the current chunk's rows that write
// there (0 between chunks).
__global__ void __launch_bounds__(1024, 1)
sweep_kernel(const int* __restrict__ Q, const int* __restrict__ U,
             const unsigned char* __restrict__ head, int n, int cols, int F,
             int R, int* slots, int* __restrict__ ranks) {
  // [2 mbarriers][2 stages][Q | U][R * cols]
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int r0s[kWarp], rank_of[kWarp];
  __shared__ unsigned masks[kWarp];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  int* stage = reinterpret_cast<int*>(smem + 16);
  const int per = R * cols;
  const int tid = threadIdx.x;
  const int lane = tid & (kWarp - 1), row = tid / kWarp;
  const int chunks = (n + R - 1) / R;
  unsigned* owner = reinterpret_cast<unsigned*>(slots);
  const int2* pairs = reinterpret_cast<const int2*>(slots);
  if (tid == 0) {
    bar_init(bars);
    bar_init(bars + 1);
  }
  __syncthreads();
  if (row == 0) stage_chunk(Q, U, n, cols, R, 0, stage, per, bars, lane);
  int carry = 0;
  PhaseClock clock;
  for (int c = 0; c < chunks; ++c) {
    const int base = c * R;
    const int rows = min(R, n - base);
    const bool live = row < rows;
    const unsigned heads =
        __ballot_sync(kFull, lane < rows && head[base + lane] != 0);
    const bool h = live && ((heads >> row) & 1u);
    bar_wait(bars + (c & 1), (c >> 1) & 1);
    __syncthreads();  // chunk c staged; chunk c - 1's scatter done
    clock.tick(0);
    const int* q_row = stage + (c & 1) * 2 * per + row * cols;
    const int* u_row = q_row + per;
    const unsigned bit = 1u << row;
    // each row's bit at its U slots
    if (live) {
      for (int k = lane; k < cols; k += kWarp) {
        const int u = u_row[k];
        if (u != F) atomicOr(owner + 2 * static_cast<size_t>(u) + 1, bit);
      }
    }
    __syncthreads();
    clock.tick(1);
    // each head: the state as the chunk found it, and the chunk's rows
    // that write at its Q slots, one 8-byte load a slot
    if (h) {
      int v = 0;
      unsigned m = 0;
      for (int k = lane; k < cols; k += kWarp) {
        const int q = q_row[k];
        if (q != F + 1) {
          const int2 s = __ldcg(pairs + q);
          v = max(v, s.x);
          m |= static_cast<unsigned>(s.y);
        }
      }
      v = __reduce_max_sync(kFull, v);
      m = __reduce_or_sync(kFull, m);
      if (lane == 0) {
        r0s[row] = v;
        masks[row] = m & (bit - 1u);
      }
    }
    __syncthreads();
    clock.tick(2);
    if (row == 0) {
      const bool hj = (heads >> lane) & 1u;
      int r = hj ? r0s[lane] : 0;
      unsigned m = hj ? masks[lane] : 0u;
      // a row that is not a head has its head's rank: move each bit of m
      // down to its row's head (the rows in between are not heads), or
      // to `carry` before the chunk's first head
      unsigned down = ~heads;
      for (int s = 1; s < kWarp; s <<= 1) {
        m |= (m & down) >> s;
        down &= down << s;
      }
      if (m & ((heads & (0u - heads)) - 1u)) r = max(r, carry + 1);
      r = chunk_chain(r, m & heads);
      const unsigned upto = heads & lanes_upto(lane);
      const int from = __shfl_sync(kFull, r, upto ? last_lane(upto) : 0);
      const int mine = upto ? from : carry;
      if (heads) carry = __shfl_sync(kFull, r, last_lane(heads));
      rank_of[lane] = mine;
      if (lane < rows) ranks[base + lane] = mine;
      clock.tick(3);
    } else if (row == 1 && c + 1 < chunks) {
      // chunk c + 1 streams in while this one is worked (into the stage
      // chunk c - 1 used)
      stage_chunk(Q, U, n, cols, R, c + 1, stage + ((c + 1) & 1) * 2 * per,
                  per, bars + ((c + 1) & 1), lane);
    }
    __syncthreads();
    clock.tick(4);
    // every row: max(state, r + 1) at its U slots, its bits cleared
    if (live) {
      const int v = rank_of[row] + 1;
      for (int k = lane; k < cols; k += kWarp) {
        const int u = u_row[k];
        if (u == F) continue;
        const size_t at = 2 * static_cast<size_t>(u);
        atomicMax(slots + at, v);
        owner[at + 1] = 0u;
      }
    }
    clock.tick(5);
  }
  clock.save(1);
}

}  // namespace

// neg_f2 float32[n] and head uint8[n] in lex-descending order; shared the
// slots of the front maxima kept in shared memory (1 <= shared <=
// j3_slots(n), at most 58,112), spill int32[j3_slots(n) - shared] for the
// rest (unused when shared == j3_slots(n)); ranks int32[n] out, in the
// same order. One launch on `stream`.
extern "C" int staircase_rows(const void* neg_f2, const void* head, int n,
                              int shared, void* spill, void* ranks,
                              void* stream) {
  if (n < 1 || n >= (1 << 30) || shared < 1 || shared > j3_slots(n))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = sizeof(int) * static_cast<size_t>(shared);
  cudaError_t err = cudaFuncSetAttribute(
      staircase_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  staircase_kernel<<<1, kWarp, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(neg_f2),
      static_cast<const unsigned char*>(head), n, shared,
      static_cast<int*>(spill), static_cast<int*>(ranks));
  return static_cast<int>(cudaGetLastError());
}

// J4's dynamic shared memory for chunks of R rows of `cols` columns: the
// two mbarriers and two stages of the chunk's Q and U rows.
static size_t sweep_smem(int R, int cols) {
  return 16 + 16ull * R * cols;
}

// Rows a chunk of J4: 32 where its shared memory fits in the card's 227 KB
// (less the statics), else the most that do, a multiple of 4 (so every
// chunk starts on a 16-byte boundary).
static int sweep_chunk_rows(int cols) {
  int R = kWarp;
  while (R > 4 && sweep_smem(R, cols) > 232448 - 1024) R -= 4;
  return R;
}

// Q, U int32[n, cols] (cols = A * A <= 1024) of flat state slots, 16-byte
// aligned, with the pads F (U) and F + 1 (Q); head uint8[n]; slots
// int32[F + 2, 2] zeroed; ranks int32[n] out. One launch on `stream`.
extern "C" int sweep3_rows(const void* Q, const void* U, const void* head,
                           int n, int cols, int F, void* slots, void* ranks,
                           void* stream) {
  if (n < 1 || cols < 1 || cols > 1024 || F < 1 ||
      reinterpret_cast<uintptr_t>(Q) % 16 ||
      reinterpret_cast<uintptr_t>(U) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int R = sweep_chunk_rows(cols);
  const size_t bytes = sweep_smem(R, cols);
  cudaError_t err = cudaFuncSetAttribute(
      sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  sweep_kernel<<<1, kWarp * R, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(Q), static_cast<const int*>(U),
      static_cast<const unsigned char*>(head), n, cols, F, R,
      static_cast<int*>(slots), static_cast<int*>(ranks));
  return static_cast<int>(cudaGetLastError());
}

#ifdef DTT_ND_PHASES
// The phase clock (-DDTT_ND_PHASES, port_profile.py --kernel-times): the
// phases' names of J3 (kernel 0) or J4 (1), comma-separated, and both
// kernels' totals since the last reset read into out[2 * kPhases]; reset
// != 0 clears them after the read.
extern "C" const char* nd_scan_phase_names(int kernel) {
  return kernel == 0 ? "loads,search,mask,chain,ranks,stores"
                     : "wait,owners,gather,chain,chain_barrier,scatter";
}

extern "C" int nd_scan_phases(unsigned long long* out, int reset) {
  cudaError_t err =
      cudaMemcpyFromSymbol(out, nd_phase_clocks, sizeof(nd_phase_clocks));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[2][kPhases] = {};
    err = cudaMemcpyToSymbol(nd_phase_clocks, zero, sizeof(zero));
  }
  return static_cast<int>(err);
}
#endif
